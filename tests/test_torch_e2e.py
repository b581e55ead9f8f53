"""End to end through the port's control plane: tony_tpu_torch's client →
its coordinator subprocess → its executor subprocesses → the user process,
on the local backend, with no card.

The scenarios of ``tests/test_e2e.py`` run through the port, with framework
``pytorch``: a three-worker gang whose user processes join a gloo group
through ``env://`` from the runtime's env (and whose events are the
reference stack's for the same job), a failing worker that fails the job
with a diagnosis, the CLI's submit / status / kill / history / events, and
the port's own trainer on a ``dp=2`` mesh of two submitted workers against
one process. The user scripts are written into ``tmp_path``.
"""

import collections
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from tony_tpu.client import TonyTpuClient as JClient
from tony_tpu.conf.config import TonyTpuConfig as JConfig
from tony_tpu.events import history as jhistory
from tony_tpu_torch import constants, tracing
from tony_tpu_torch.cli.main import main as cli_main
from tony_tpu_torch.client import TaskUpdateListener, TonyTpuClient
from tony_tpu_torch.conf import keys as K
from tony_tpu_torch.conf.config import TonyTpuConfig
from tony_tpu_torch.events import history

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# A module of the reference named in a command line.
REFERENCE_MODULE = re.compile(r"\btony_tpu(?!_torch)\.")

# Joins the gang through env:// and checks a three-rank all_reduce; prints
# the rendezvous env and the command lines of its ancestors up to the
# coordinator (the shell, the executor, the coordinator).
GANG_SCRIPT = r"""
import json, os
import torch
import torch.distributed as dist

torch.set_num_threads(1)
need = ["JOB_NAME", "TASK_INDEX", "TASK_NUM", "IS_CHIEF", "SESSION_ID",
        "TONY_JOB_NAME", "TONY_TASK_INDEX", "CLUSTER_SPEC", "RANK",
        "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "INIT_METHOD"]
missing = [k for k in need if not os.environ.get(k)]
assert not missing, missing
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
spec = json.loads(os.environ["CLUSTER_SPEC"])
assert world == len(spec["worker"]) == 3
assert rank == int(os.environ["TASK_INDEX"])
dist.init_process_group("gloo", init_method="env://")
x = torch.tensor([float(rank + 1)])
dist.all_reduce(x)
assert x.item() == world * (world + 1) / 2, x
dist.destroy_process_group()
cmds, pid = [], os.getppid()
while pid > 1 and not any(".coordinator" in c for c in cmds):
    with open(f"/proc/{pid}/cmdline", "rb") as f:
        cmds.append(f.read().replace(b"\0", b" ").decode())
    with open(f"/proc/{pid}/stat") as f:
        pid = int(f.read().rsplit(") ", 1)[1].split()[1])
print(json.dumps({"env": {k: os.environ.get(k) for k in
                          ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                           "LOCAL_WORLD_SIZE")},
                  "sum": x.item(), "ancestors": cmds}))
"""

# The port's trainer on a dp=2 mesh over the group joined from the
# runtime's env; publishes its telemetry before it exits, so the executor
# sees the first step.
TRAIN_SCRIPT = r"""
import json, os
import torch
torch.set_num_threads(1)
from tony_tpu_torch import telemetry, trainer
from tony_tpu_torch.models.transformer import TransformerConfig

r = trainer.measure(TransformerConfig.tiny(), batch=4, seq=16, steps=2,
                    warmup=0, device="cpu", mesh="dp=2")
telemetry.write_stats_once(os.environ["TONY_METRICS_FILE"])
print(json.dumps({"losses": r["losses"], "mesh": r["mesh"]}))
"""

TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 2, 4, 16
RTOL = 1e-5


class Recorder(TaskUpdateListener):
    def __init__(self):
        self.app_id = None
        self.updates = []
        self.finished = None

    def on_application_id_received(self, app_id):
        self.app_id = app_id

    def on_task_infos_updated(self, infos):
        self.updates.append(infos)

    def on_application_finished(self, status, report):
        self.finished = (status, report)


def _conf(cls, tmp_path, command, workers, extra=None):
    conf = cls()
    conf.set("tony.worker.instances", workers)
    conf.set("tony.worker.command", command)
    conf.set(K.APPLICATION_FRAMEWORK, "pytorch")
    conf.set(K.TASK_REGISTRATION_TIMEOUT_S, 60)
    conf.set(K.APPLICATION_TIMEOUT_S, 120)
    conf.set(K.HISTORY_LOCATION, str(tmp_path / "history"))
    # The reference tests' cadences: 100 ms polls.
    conf.set(K.CLIENT_POLL_INTERVAL_MS, 100)
    conf.set(K.COORDINATOR_MONITOR_INTERVAL_MS, 100)
    for k, v in (extra or {}).items():
        conf.set(k, v)
    return conf


def _script(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return f"{sys.executable} {path}"


def _submit(client_cls, conf, workdir):
    client = client_cls(conf, workdir=str(workdir))
    rec = Recorder()
    client.add_listener(rec)
    return client, rec, client.start()


def _task_stdout(client, task):
    path = os.path.join(client.job_dir, "tasks", task.replace(":", "_"),
                        "stdout.log")
    with open(path) as f:
        return f.read()


def _dump(client):
    out = []
    for root, _dirs, files in sorted(os.walk(client.job_dir)):
        for f in files:
            if f.endswith(".log"):
                with open(os.path.join(root, f), errors="replace") as fh:
                    out.append(f"--- {os.path.join(root, f)} ---\n"
                               f"{fh.read()[-3000:]}")
    return "\n".join(out)[-12000:]


@pytest.mark.timeout_s(150)
def test_e2e_gang_rendezvous_events_and_command_lines(tmp_path):
    """(a) three pytorch workers join one gloo group from the runtime's env
    and all_reduce; listeners and history say SUCCEEDED; the event stream
    is ordered and its types are the reference stack's for the same job;
    (e) the coordinator and executors the port spawned are its own."""
    command = _script(tmp_path, "gang.py", GANG_SCRIPT)
    conf = _conf(TonyTpuConfig, tmp_path, command, 3)
    client, rec, code = _submit(TonyTpuClient, conf, tmp_path / "work")
    assert code == 0, _dump(client)
    assert rec.app_id and rec.finished[0] == "SUCCEEDED"
    final = {f"{t['name']}:{t['index']}": t["status"]
             for t in rec.updates[-1]}
    assert final == {f"worker:{i}": "SUCCEEDED" for i in range(3)}
    root = str(tmp_path / "history")
    assert [j.status for j in history.list_jobs(root)
            if j.app_id == rec.app_id] == ["SUCCEEDED"]
    types = [e.type.value
             for e in history.read_job_events(root, rec.app_id)]
    assert types[0] == "APPLICATION_INITED"
    assert types[-1] == "APPLICATION_FINISHED"
    assert types.count("TASK_STARTED") == types.count("TASK_FINISHED") == 3

    for i in range(3):
        out = json.loads(_task_stdout(client, f"worker:{i}")
                         .strip().splitlines()[-1])
        assert out["env"] == {"RANK": str(i), "WORLD_SIZE": "3",
                              "LOCAL_RANK": str(i),
                              "LOCAL_WORLD_SIZE": "3"}
        assert out["sum"] == 6.0
        cmds = out["ancestors"]
        assert any("-m tony_tpu_torch.executor" in c for c in cmds), cmds
        assert any("-m tony_tpu_torch.coordinator" in c for c in cmds), cmds
        assert not any(REFERENCE_MODULE.search(c) for c in cmds), cmds

    # The reference stack, the same conf and script.
    jconf = _conf(JConfig, tmp_path / "ref", command, 3)
    jclient, jrec, jcode = _submit(JClient, jconf, tmp_path / "ref_work")
    assert jcode == 0, _dump(jclient)
    jtypes = [e.type.value for e in jhistory.read_job_events(
        str(tmp_path / "ref" / "history"), jrec.app_id)]
    assert collections.Counter(types) == collections.Counter(jtypes)


@pytest.mark.timeout_s(120)
def test_e2e_worker_failure_fails_job_with_diagnosis(tmp_path):
    """(b) a worker that exits 1 fails the job, and the coordinator writes
    the incident report."""
    conf = _conf(TonyTpuConfig, tmp_path,
                 f"{sys.executable} -c 'import sys; sys.exit(1)'", 2,
                 {K.APPLICATION_FAIL_ON_WORKER_FAILURE: True})
    client, rec, code = _submit(TonyTpuClient, conf, tmp_path / "work")
    assert code == constants.EXIT_FAILURE
    assert rec.finished[0] == "FAILED"
    root = str(tmp_path / "history")
    assert [j.status for j in history.list_jobs(root)] == ["FAILED"]
    job_dir = history.list_job_dirs(root)[rec.app_id]
    with open(os.path.join(job_dir, constants.INCIDENT_FILE)) as f:
        incident = json.load(f)
    assert incident["status"] == "FAILED"
    types = [e.type.value for e in history.read_job_events(root, rec.app_id)]
    assert "JOB_DIAGNOSED" in types
    assert cli_main(["diagnose", rec.app_id, "--history-root", root]) == 0


def _wait(pred, timeout_s=60):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and not pred():
        time.sleep(0.1)
    return pred()


@pytest.mark.timeout_s(150)
def test_e2e_cli_submit_status_kill_history_events(tmp_path, capsys):
    """(c) ``python -m tony_tpu_torch.cli submit`` runs a job to SUCCEEDED;
    ``history`` and ``events`` read it back; ``status`` reports a running
    job, ``kill`` ends it KILLED, and ``status`` then reads history."""
    hist, work = str(tmp_path / "history"), str(tmp_path / "work")
    polls = [f"--conf={K.CLIENT_POLL_INTERVAL_MS}=100",
             f"--conf={K.COORDINATOR_MONITOR_INTERVAL_MS}=100"]
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "tony_tpu_torch.cli", "submit",
         "--conf", f"tony.worker.command={sys.executable} -c 'print(7)'",
         "--instances", "1", "--workdir", work,
         "--conf", f"{K.HISTORY_LOCATION}={hist}"] + polls,
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "application finished: SUCCEEDED" in r.stdout
    app_id = re.search(r"submitted application (\S+)", r.stdout).group(1)

    assert cli_main(["history", "--history-root", hist]) == 0
    out = capsys.readouterr().out
    assert app_id in out and "SUCCEEDED" in out
    assert cli_main(["events", app_id, "--history-root", hist]) == 0
    out = capsys.readouterr().out
    assert "APPLICATION_INITED" in out and "APPLICATION_FINISHED" in out
    assert cli_main(["logs", app_id, "--history-root", hist]) == 0
    assert "7" in capsys.readouterr().out
    assert cli_main(["events", "app_nope", "--history-root", hist]) == 1

    conf = _conf(TonyTpuConfig, tmp_path,
                 f"{sys.executable} -c 'import time; time.sleep(120)'", 1,
                 {K.TASK_EXECUTOR_EXECUTION_TIMEOUT_S: 120})
    client = TonyTpuClient(conf, workdir=work)
    rec = Recorder()
    client.add_listener(rec)
    result = {}
    t = threading.Thread(target=lambda: result.update(code=client.start()),
                         daemon=True)
    t.start()
    try:
        assert _wait(lambda: rec.updates and any(
            x["status"] == "RUNNING" for x in rec.updates[-1]))
        capsys.readouterr()
        assert cli_main(["status", rec.app_id, "--workdir", work]) == 0
        out = capsys.readouterr().out
        assert "RUNNING" in out and "worker:0" in out
        assert cli_main(["kill", rec.app_id, "--workdir", work]) == 0
        t.join(timeout=60)
        assert not t.is_alive(), "client did not return after kill"
    finally:
        if t.is_alive():
            client.force_kill()
            t.join(timeout=60)
    assert rec.finished and rec.finished[0] == "KILLED"
    capsys.readouterr()
    assert cli_main(["status", rec.app_id, "--workdir", work,
                     "--history-root", hist]) == 0
    assert "KILLED" in capsys.readouterr().out
    assert cli_main(["kill", "app_nope", "--workdir", work]) == 1


@pytest.mark.timeout_s(180)
def test_e2e_port_trainer_on_submitted_gang(tmp_path):
    """(d) two submitted workers train a small decoder on a dp=2 mesh over
    the group they joined from the runtime's env: their losses are one
    process's within 1e-5 relative, and each worker's first step shows as
    an ``executor.first_step`` span in the job's trace."""
    import torch

    from tony_tpu_torch import trainer
    from tony_tpu_torch.models.transformer import TransformerConfig

    command = _script(tmp_path, "train.py", TRAIN_SCRIPT)
    conf = _conf(TonyTpuConfig, tmp_path, command, 2)
    client, rec, code = _submit(TonyTpuClient, conf, tmp_path / "work")
    assert code == 0, _dump(client)
    runs = [json.loads(_task_stdout(client, f"worker:{i}")
                       .strip().splitlines()[-1]) for i in range(2)]
    # A mesh of two ranks: the group is the gang's, not a one-rank one.
    assert [r["mesh"]["dp"] for r in runs] == [2, 2], runs

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = trainer.measure(TransformerConfig.tiny(), batch=TRAIN_BATCH,
                              seq=TRAIN_SEQ, steps=TRAIN_STEPS, warmup=0,
                              device="cpu")
    finally:
        torch.set_num_threads(threads)
    for r in runs:
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=RTOL)

    job_dir = history.list_job_dirs(str(tmp_path / "history"))[rec.app_id]
    records = tracing.load_records(
        os.path.join(job_dir, constants.TRACE_FILE))
    payload = tracing.to_trace_events(records)
    assert not payload["unclosedSpans"], payload["unclosedSpans"]
    firsts = {e["args"].get("task") for e in payload["traceEvents"]
              if e.get("ph") == "X" and e["name"] == "executor.first_step"}
    assert firsts == {"worker:0", "worker:1"}
    bd = tracing.cold_start_breakdown(records)
    assert bd["total_s"] > 0
    assert abs(sum(bd["phases"].values()) - bd["total_s"]) < 1e-3
