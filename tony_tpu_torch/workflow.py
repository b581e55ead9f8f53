"""Workflow-scheduler adapter: scheduler job properties → a submittable job.

Reference: ``tony-azkaban/.../TonyJob.java`` — an Azkaban jobtype that
collects every job property under the ``tony.`` prefix into a generated
``tony.xml`` (:83-96) and assembles the CLI argument list for
``TonyClient`` (``getMainArguments`` :130-167, args enumerated in
``TonyJobArg.java``). The TPU analogue is scheduler-agnostic: any workflow
engine (Airflow operator, Azkaban jobtype shim, cron wrapper) that can
hand over a flat properties dict gets back a frozen config + argv, or can
submit directly in-process.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

from tony_tpu_torch.conf.config import TonyTpuConfig
from tony_tpu_torch.conf import keys as K

# Reference TonyJobArg.java: the workflow-level pass-through arguments.
PROP_EXECUTABLE = "executable"          # -executes
PROP_TASK_PARAMS = "task_params"        # -task_params
PROP_SRC_DIR = "src_dir"                # -src_dir
PROP_PYTHON_VENV = "python_venv"        # -python_venv
PROP_PYTHON_BINARY = "python_binary_path"
CONF_PREFIX = "tony."


@dataclasses.dataclass
class WorkflowJob:
    """The generated artifacts: what the scheduler actually launches."""
    conf: TonyTpuConfig
    conf_file: str                       # generated config path (json)
    argv: List[str]                      # `python -m tony_tpu_torch.cli ...`


def build_job(props: Dict[str, str], workdir: str,
              job_name: str = "workflow-job") -> WorkflowJob:
    """Convert scheduler props into a generated config file + CLI argv
    (reference ``TonyJob.getJobProps``→``tony.xml`` :83-96 +
    ``getMainArguments`` :130-167).

    Every ``tony.*`` property passes through to the config verbatim; the
    reference's dedicated CLI args map to their config keys."""
    conf = TonyTpuConfig()
    for k, v in sorted(props.items()):
        if k.startswith(CONF_PREFIX):
            conf.set(k, v)
    mapped = {
        PROP_EXECUTABLE: K.APPLICATION_EXECUTABLE,
        PROP_TASK_PARAMS: K.APPLICATION_TASK_PARAMS,
        PROP_SRC_DIR: K.SRC_DIR,
        PROP_PYTHON_VENV: K.PYTHON_VENV,
        PROP_PYTHON_BINARY: K.PYTHON_BINARY_PATH,
    }
    for prop, key in mapped.items():
        if props.get(prop):
            v = props[prop]
            if prop in (PROP_SRC_DIR, PROP_PYTHON_VENV) and \
                    not os.path.isabs(v) and os.path.exists(v):
                # Path props mean "relative to the scheduler's CWD" — pin
                # them before the conf file (written to workdir) would
                # re-anchor them to workdir at submit time.
                v = os.path.abspath(v)
            conf.set(key, v)
    if not conf.get(K.APPLICATION_NAME) or \
            conf.get(K.APPLICATION_NAME) == "tony-tpu":
        conf.set(K.APPLICATION_NAME, job_name)

    os.makedirs(workdir, exist_ok=True)
    conf_file = os.path.join(workdir, f"{job_name}.tony.json")
    with open(conf_file, "w", encoding="utf-8") as f:
        json.dump(conf.as_dict(), f, indent=2, sort_keys=True)

    argv = ["python", "-m", "tony_tpu_torch.cli", "submit",
            "--conf-file", conf_file, "--workdir", workdir]
    return WorkflowJob(conf=conf, conf_file=conf_file, argv=argv)


def run_job(props: Dict[str, str], workdir: str,
            job_name: str = "workflow-job",
            listener: Optional[object] = None) -> Tuple[int, str]:
    """In-process submit for engines that can host Python directly (the
    ``HadoopJavaJob`` embedding path): returns (exit_code, app_id)."""
    from tony_tpu_torch.client import TonyTpuClient

    job = build_job(props, workdir, job_name)
    client = TonyTpuClient(job.conf, workdir=workdir)
    if listener is not None:
        client.add_listener(listener)
    code = client.start()
    return code, client.app_id
