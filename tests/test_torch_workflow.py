"""The workflow-scheduler adapter through the port
(``tony_tpu_torch/workflow.py``): the two cases of
``tests/test_workflow.py``, a props dict in and a generated config and
argv out, then the job submitted in process. One named deviation: the
argv runs ``python -m tony_tpu_torch.cli submit`` where the reference's
runs ``tony_tpu.cli``. Plus parity: both packages' ``build_job`` write the
same config file from the same props."""

import json
import os
import sys

from tony_tpu_torch.conf.config import TonyTpuConfig
from tony_tpu_torch.conf import keys as K
from tony_tpu_torch.workflow import build_job, run_job

SCRIPTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts")


def test_build_job_generates_conf_and_argv(tmp_path):
    props = {
        "tony.worker.instances": "2",
        "tony.worker.command": "python train.py",
        "tony.application.framework": "pytorch",
        "executable": "train.py",
        "task_params": "--epochs 2",
        "src_dir": "/src",
        "unrelated.prop": "ignored",
    }
    job = build_job(props, str(tmp_path), job_name="nightly-train")
    # tony.* pass through; dedicated args map to their keys; noise dropped
    assert job.conf.get("tony.worker.instances") == 2  # typed coercion
    assert job.conf.get(K.APPLICATION_EXECUTABLE) == "train.py"
    assert job.conf.get(K.APPLICATION_TASK_PARAMS) == "--epochs 2"
    assert job.conf.get(K.SRC_DIR) == "/src"
    assert job.conf.get("unrelated.prop") is None
    assert job.conf.get(K.APPLICATION_NAME) == "nightly-train"
    # the generated file is a loadable config layer
    assert os.path.isfile(job.conf_file)
    loaded = json.load(open(job.conf_file))
    assert loaded["tony.worker.command"] == "python train.py"
    assert loaded["tony.worker.instances"] == 2
    reparsed = TonyTpuConfig.from_layers(config_file=job.conf_file)
    assert reparsed.get("tony.worker.instances") == 2
    # argv is a complete submit command pointing at the generated file
    assert job.argv[:4] == ["python", "-m", "tony_tpu_torch.cli", "submit"]
    assert job.conf_file in job.argv


def test_run_job_submits_in_process(tmp_path):
    props = {
        "tony.worker.instances": "1",
        "tony.worker.command":
            f"{sys.executable} {os.path.join(SCRIPTS, 'exit_0.py')}",
        "tony.history.location": str(tmp_path / "history"),
        "tony.task.registration-timeout-s": "60",
    }
    code, app_id = run_job(props, str(tmp_path / "wf"), job_name="wf-e2e")
    assert code == 0
    assert app_id


def test_build_job_writes_the_reference_config(tmp_path):
    from tony_tpu.workflow import build_job as j_build_job

    props = {
        "tony.worker.instances": "3",
        "tony.worker.command": "python train.py",
        "tony.application.framework": "pytorch",
        "executable": "train.py",
        "task_params": "--epochs 2",
        "unrelated.prop": "ignored",
    }
    ours = build_job(props, str(tmp_path / "port"), job_name="nightly")
    ref = j_build_job(props, str(tmp_path / "ref"), job_name="nightly")
    from tony_tpu.conf.config import TonyTpuConfig as JConfig

    with open(ours.conf_file) as f, open(ref.conf_file) as g:
        got, want = json.load(f), json.load(g)
    assert set(got) == set(want)
    # where the registries' defaults differ (the framework, set by the
    # props here, and the pool's preload: torch against jax), the port's
    # file holds the port's value
    port_defaults, ref_defaults = TonyTpuConfig(), JConfig()
    moved = {k for k in want if port_defaults.get(k) != ref_defaults.get(k)}
    assert moved == {K.APPLICATION_FRAMEWORK, K.POOL_PRELOAD}
    assert got[K.APPLICATION_FRAMEWORK] == "pytorch"
    assert got[K.POOL_PRELOAD] == "torch"
    assert {k: v for k, v in got.items() if k not in moved} == \
        {k: v for k, v in want.items() if k not in moved}
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    assert ours.argv[4:] == [a.replace(ref_dir, port_dir)
                             for a in ref.argv[4:]]
    assert ours.argv[2] == "tony_tpu_torch.cli"
    assert ref.argv[2] == "tony_tpu.cli"
