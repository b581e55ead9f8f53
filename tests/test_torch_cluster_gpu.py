"""The GPU host backend (tony_tpu_torch/cluster/gpu.py): atomic slice
leases, gang placement over hosts, host loss -> whole-job retry, capacity
denial, the ssh command lines, and the backend's choice in ``python -m
tony_tpu_torch.coordinator``.

The scenarios of ``tests/test_cluster_tpu.py`` through the port's client,
coordinator and executors, with framework ``pytorch``, plus the slice
scenarios of ``test_e2e.py``, ``test_e2e_faults.py`` and
``test_diagnosis.py``: a two-host LocalSim gang running the port's trainer
on the CPU over gloo, host loss (the fake provisioner's and the executor's
``host.loss`` fault site), and the diagnosis of a reclaimed host. The user
scripts are written into ``tmp_path``.
"""

import io
import json
import os
import sys
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from tony_tpu_torch import constants, trainer
from tony_tpu_torch.checkpoint.manager import MANIFEST_NAME
from tony_tpu_torch.cli.main import main as cli_main
from tony_tpu_torch.client import TonyTpuClient
from tony_tpu_torch.cluster.base import TaskLaunchSpec
from tony_tpu_torch.cluster.gpu import (HOST_LOST_EXIT, FakeSliceProvisioner,
                                        GpuHostBackend, SliceProvisionError)
from tony_tpu_torch.conf import keys as K
from tony_tpu_torch.conf.config import TonyTpuConfig
from tony_tpu_torch.events import history
from tony_tpu_torch.models.transformer import TransformerConfig

from test_torch_e2e import (RTOL, TRAIN_BATCH, TRAIN_SCRIPT, TRAIN_SEQ,
                            TRAIN_STEPS, Recorder, _dump)
from test_torch_e2e_recovery import check_artifacts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The identity and pytorch rendezvous env every gang member must see, the
# host env this backend exports, and none of libtpu's. Joins the gang's
# gloo group from the runtime's env and all_reduces across the hosts.
CHECK_ENV_SCRIPT = r"""
import os, sys
need = ["JOB_NAME", "TASK_INDEX", "TASK_NUM", "IS_CHIEF", "SESSION_ID",
        "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK",
        "TONY_HOST_ID", "TONY_HOST_LOCAL_ORDINAL"]
missing = [k for k in need if not os.environ.get(k)]
if missing:
    print(f"missing env: {missing}", file=sys.stderr)
    sys.exit(2)
foreign = [k for k in ("TPU_WORKER_ID", "TPU_WORKER_HOSTNAMES",
                       "CUDA_VISIBLE_DEVICES") if k in os.environ]
if foreign:
    print(f"foreign env: {foreign}", file=sys.stderr)
    sys.exit(3)
if os.path.basename(os.path.dirname(os.getcwd())) != os.environ["TONY_HOST_ID"]:
    print(f"ran outside its host dir: {os.getcwd()}", file=sys.stderr)
    sys.exit(4)
if os.environ.get("TONY_TEST_GLOO") == "1":
    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method="env://")
    x = torch.tensor([1.0])
    dist.all_reduce(x)
    assert x.item() == int(os.environ["WORLD_SIZE"]), x
    dist.destroy_process_group()
idx = os.environ["TASK_INDEX"]
print(f"env ok: task {os.environ['JOB_NAME']}:{idx} on "
      f"{os.environ['TONY_HOST_ID']}")
"""

SLEEP_5 = f"{sys.executable} -c 'import time; time.sleep(5)'"

# Checkpoint/resume through the port's CheckpointManager: one save per
# step, resume from the newest step after a restart; writes "start end w1"
# to TONY_TEST_RESULT so the test can tell a resumed epoch from a restart.
RESUME_SCRIPT = r"""
import os, time
import torch
from tony_tpu_torch.checkpoint import CheckpointManager

total = int(os.environ.get("TONY_TEST_STEPS", "4"))
step_sleep = float(os.environ.get("TONY_TEST_STEP_SLEEP", "0"))
with CheckpointManager(os.environ["TONY_CHECKPOINT_DIR"],
                       async_save=False) as mgr:
    state = {"step": torch.zeros((), dtype=torch.int64),
             "w": torch.arange(4, dtype=torch.float32)}
    if mgr.latest_step() is not None:
        state = mgr.restore(None, state)
    start = int(state["step"])
    for _ in range(start, total):
        state = {"step": state["step"] + 1, "w": state["w"] * 2.0}
        mgr.save(int(state["step"]), state, force=True)
        mgr.wait()
        time.sleep(step_sleep)
with open(os.environ["TONY_TEST_RESULT"], "w") as f:
    f.write(f"{start} {int(state['step'])} {float(state['w'][1])}\n")
"""


def _script(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return f"{sys.executable} {path}"


def make_conf(tmp_path, command, workers=2, extra=None):
    conf = TonyTpuConfig()
    conf.set("tony.worker.instances", workers)
    conf.set("tony.worker.command", command)
    conf.set(K.APPLICATION_FRAMEWORK, "pytorch")
    conf.set(K.TASK_REGISTRATION_TIMEOUT_S, 60)
    conf.set(K.APPLICATION_TIMEOUT_S, 120)
    conf.set(K.HISTORY_LOCATION, str(tmp_path / "history"))
    conf.set(K.CLIENT_POLL_INTERVAL_MS, 100)
    conf.set(K.COORDINATOR_MONITOR_INTERVAL_MS, 100)
    for k, v in (extra or {}).items():
        conf.set(k, v)
    return conf


def slice_conf(tmp_path, command, workers=2, n_hosts=2, inventory=0,
               extra=None):
    conf = make_conf(tmp_path, command, workers=workers, extra=extra)
    conf.set(K.APPLICATION_BACKEND, "gpu-host")
    conf.set(K.SLICE_PROVISIONER, "fake")
    conf.set(K.SLICE_NUM_HOSTS, n_hosts)
    if inventory:
        conf.set(K.SLICE_FAKE_INVENTORY, inventory)
    return conf


def submit(conf, tmp_path):
    client = TonyTpuClient(conf, workdir=str(tmp_path / "work"))
    rec = Recorder()
    client.add_listener(rec)
    code = client.start()
    return client, rec, code


def _task_dirs(tmp_path, app_id):
    return tmp_path / "work" / "jobs" / app_id / "tasks"


# ---------------------------------------------------------------------------
# Backend-level (no coordinator): lease + placement mechanics
# ---------------------------------------------------------------------------
def _spec(task_id):
    job, _, idx = task_id.partition(":")
    return TaskLaunchSpec(
        task_id=task_id, job_name=job, index=int(idx), command="true",
        env={constants.COORDINATOR_HOST: "127.0.0.1",
             constants.COORDINATOR_PORT: "1",
             constants.JOB_NAME: job, constants.TASK_INDEX: str(idx)})


def test_lease_is_atomic_all_or_nothing(tmp_path):
    prov = FakeSliceProvisioner(3, str(tmp_path))
    lease = prov.acquire(2)
    assert len(lease.hosts) == 2
    # Only 1 host left: a 2-host request must be denied whole, not split.
    with pytest.raises(SliceProvisionError):
        prov.acquire(2)
    prov.release(lease)
    assert len(prov.acquire(2).hosts) == 2


def test_round_robin_placement_and_host_env(tmp_path):
    prov = FakeSliceProvisioner(2, str(tmp_path / "hosts"))
    backend = GpuHostBackend(prov, 2, str(tmp_path / "work"),
                             python=sys.executable)
    try:
        handles = [backend.launch_task(_spec(f"worker:{i}"))
                   for i in range(4)]
    finally:
        backend.stop()
    hosts = [h.host.host_id for h in handles]
    assert hosts == ["fakehost-0", "fakehost-1"] * 2  # round-robin
    # per-host local ordinals count up independently on each host
    ordinals = [h.spec.env["TONY_HOST_LOCAL_ORDINAL"] for h in handles]
    assert ordinals == ["0", "0", "1", "1"]
    assert all(h.spec.env["TONY_HOST_ID"] == h.host.host_id
               for h in handles)
    # The GPU host contract: nothing of libtpu, and no card chosen here
    # (the user process picks its card by LOCAL_RANK).
    for h in handles:
        assert not {"TPU_WORKER_ID", "TPU_WORKER_HOSTNAMES",
                    "CUDA_VISIBLE_DEVICES"} & set(h.spec.env)


def test_coordinator_pool_task_runs_off_the_slice(tmp_path):
    """node-pool=coordinator tasks run OFF the slice (CPU jobtypes), on the
    coordinator's machine; a job's own env wins over the backend's."""
    prov = FakeSliceProvisioner(2, str(tmp_path / "hosts"))
    backend = GpuHostBackend(prov, 2, str(tmp_path / "work"),
                             python=sys.executable)
    try:
        off = _spec("ps:0")
        off.node_pool = "coordinator"
        h_off = backend.launch_task(off)
        custom = _spec("worker:0")
        custom.env["CUDA_VISIBLE_DEVICES"] = "1"
        h_on = backend.launch_task(custom)
    finally:
        backend.stop()
    assert h_off.host.host_id == "coordinator-host"
    assert h_off.spec.env["TONY_HOST_ID"] == "coordinator-host"
    assert h_on.host.host_id == "fakehost-0"
    assert h_on.spec.env["CUDA_VISIBLE_DEVICES"] == "1"   # user env wins


def test_host_loss_reports_all_its_tasks(tmp_path):
    prov = FakeSliceProvisioner(2, str(tmp_path / "hosts"))
    backend = GpuHostBackend(prov, 2, str(tmp_path / "work"),
                             python=sys.executable)
    try:
        for i in range(4):
            backend.launch_task(_spec(f"worker:{i}"))
        prov.fail_host("fakehost-0")
        deadline = time.time() + 10
        lost = {}
        while time.time() < deadline and len(lost) < 2:
            for tid, rc in backend.poll_completions():
                if rc == HOST_LOST_EXIT:
                    lost[tid] = rc
            time.sleep(0.05)
        # worker:0 and worker:2 were placed on fakehost-0
        assert set(lost) >= {"worker:0", "worker:2"}, lost
        assert backend.completion_domain("worker:0") == "PREEMPTION"
        assert backend.host_of("worker:2") == "fakehost-0"
    finally:
        backend.stop()


def test_releasing_broken_lease_re_leases_healthy_hosts(tmp_path):
    prov = FakeSliceProvisioner(3, str(tmp_path / "hosts"))
    backend = GpuHostBackend(prov, 2, str(tmp_path / "work"),
                             python=sys.executable)
    try:
        backend.launch_task(_spec("worker:0"))
        first = {h.host_id for h in backend.lease.hosts}
        prov.fail_host(sorted(first)[0])
        backend.launch_task(_spec("worker:1"))   # triggers re-lease
        second = {h.host_id for h in backend.lease.hosts}
        assert sorted(first)[0] not in second
        assert len(second) == 2
    finally:
        backend.stop()


def test_exclude_hosts_skips_the_failed_host(tmp_path):
    """Exclude-on-retry: a relaunched task avoids the host it failed on,
    unless every host of the lease is excluded (a launch beats none)."""
    prov = FakeSliceProvisioner(2, str(tmp_path / "hosts"))
    backend = GpuHostBackend(prov, 2, str(tmp_path / "work"),
                             python=sys.executable)
    try:
        avoid = _spec("worker:0")
        avoid.exclude_hosts = ["fakehost-0"]
        assert backend.launch_task(avoid).host.host_id == "fakehost-1"
        every = _spec("worker:1")
        every.exclude_hosts = ["fakehost-0", "fakehost-1"]
        assert backend.launch_task(every).host.host_id == "fakehost-0"
    finally:
        backend.stop()


def test_local_sim_channel_puts_the_repo_on_pythonpath(tmp_path):
    from tony_tpu_torch.cluster.gpu import LocalSimHostChannel

    ch = LocalSimHostChannel("h0", str(tmp_path))
    h = ch.exec_task("worker:0", [sys.executable, "-c",
                                  "import os; print(os.environ['PYTHONPATH'])"],
                     {}, str(tmp_path / "w"))
    deadline = time.time() + 30
    while ch.poll(h) is None and time.time() < deadline:
        time.sleep(0.05)
    assert ch.poll(h) == 0
    out = open(ch.log_paths(h)[0]).read().strip()
    assert out.split(os.pathsep)[0] == REPO


# ---------------------------------------------------------------------------
# Full-stack e2e through client -> coordinator -> gpu-host -> executors
# ---------------------------------------------------------------------------
@pytest.mark.timeout_s(150)
def test_e2e_gang_over_two_fake_hosts_succeeds(tmp_path):
    command = _script(tmp_path, "check_env.py", CHECK_ENV_SCRIPT)
    conf = slice_conf(tmp_path, command, workers=3, n_hosts=2,
                      extra={K.EXECUTION_ENV: "TONY_TEST_GLOO=1"})
    client, rec, code = submit(conf, tmp_path)
    assert code == 0, _dump(client)
    assert rec.finished[0] == "SUCCEEDED"
    # the gang really spanned both fake hosts (task dirs live under
    # <workdir>/jobs/<app_id>/tasks/<host_id>/)
    hostdirs = sorted(d for d in os.listdir(str(_task_dirs(tmp_path,
                                                           rec.app_id)))
                      if d.startswith("fakehost-"))
    assert hostdirs == ["fakehost-0", "fakehost-1"]
    check_artifacts(tmp_path / "history")


@pytest.mark.timeout_s(150)
def test_e2e_trainer_over_two_fake_hosts_matches_one_process(tmp_path):
    """The port's trainer on a dp=2 mesh over a two-host LocalSim gang
    (gloo through the pytorch runtime's env), against one process."""
    command = _script(tmp_path, "train.py", TRAIN_SCRIPT)
    conf = slice_conf(tmp_path, command, workers=2, n_hosts=2)
    client, rec, code = submit(conf, tmp_path)
    assert code == 0, _dump(client)
    tasks = _task_dirs(tmp_path, rec.app_id)
    runs = []
    for i in range(2):
        host = f"fakehost-{i}"
        with open(tasks / host / f"worker_{i}" / "stdout.log") as f:
            runs.append(json.loads(f.read().strip().splitlines()[-1]))
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
    check_artifacts(tmp_path / "history")


def test_e2e_capacity_denial_fails_job(tmp_path):
    """2-host slice from a 1-host inventory: the all-or-nothing lease is
    denied, the job fails cleanly (no partial gang, no hang)."""
    conf = slice_conf(tmp_path, f"{sys.executable} -c pass", workers=2,
                      n_hosts=2, inventory=1)
    client, rec, code = submit(conf, tmp_path)
    assert code == constants.EXIT_FAILURE
    assert rec.finished[0] == "FAILED"
    assert "launch" in (rec.finished[1].get("failure_reason") or "")


def test_e2e_host_loss_triggers_retry_and_recovers(tmp_path, monkeypatch):
    """Host dies mid-job -> its tasks report HOST_LOST_EXIT -> chief
    failure policy fails the session -> whole-job retry releases the
    broken lease, re-leases healthy hosts, epoch 1 succeeds."""
    monkeypatch.setenv(constants.TEST_SLICE_FAIL_HOST, "fakehost-0")
    conf = slice_conf(
        tmp_path, SLEEP_5, workers=2, n_hosts=2, inventory=3,
        extra={K.APPLICATION_RETRY_COUNT: 1})
    client, rec, code = submit(conf, tmp_path)
    assert code == 0, _dump(client)
    assert rec.finished[0] == "SUCCEEDED"
    assert int(rec.finished[1].get("attempt", 0)) == 1  # recovered on retry


def test_e2e_host_loss_fault_site_retries_the_gang(tmp_path):
    """The executor's ``host.loss`` fault site on a gpu-host gang: the
    first heartbeat SIGKILLs the user group and hard-exits the executor
    (no exit report), the epoch fails and the retry epoch succeeds."""
    conf = slice_conf(
        tmp_path, SLEEP_5, workers=1, n_hosts=1,
        extra={K.APPLICATION_RETRY_COUNT: 1,
               K.TASK_HEARTBEAT_INTERVAL_MS: 200,
               K.fault_key("host.loss"): "first:1,session:0"})
    client, rec, code = submit(conf, tmp_path)
    assert code == 0, _dump(client)
    assert rec.finished[0] == "SUCCEEDED"
    assert int(rec.finished[1].get("attempt", 0)) == 1


def test_e2e_preemption_retries_free_of_the_retry_budget(tmp_path,
                                                         monkeypatch):
    """A slice host dies mid-run (the preemption shape) with
    retry-count=0: the PREEMPTION domain draws on its own budget, the
    job still retries on a fresh lease and succeeds."""
    monkeypatch.setenv(constants.TEST_SLICE_FAIL_HOST, "fakehost-0")
    conf = slice_conf(tmp_path, SLEEP_5, workers=1, n_hosts=1,
                      inventory=2, extra={K.APPLICATION_RETRY_COUNT: 0})
    client, rec, code = submit(conf, tmp_path)
    assert code == 0, _dump(client)
    assert rec.finished[0] == "SUCCEEDED"
    assert rec.finished[1].get("session_id", 0) >= 1, \
        "host loss must have triggered a (free) retry epoch"
    evs = history.read_job_events(str(tmp_path / "history"), rec.app_id)
    domains = [e.payload.get("failure_domain") for e in evs
               if e.type == "TASK_FINISHED"]
    assert "PREEMPTION" in domains, domains


def test_e2e_preemption_diagnosed(tmp_path, monkeypatch, capsys):
    """A slice host reclaimed with ZERO retry budget: the job fails, and
    diagnose surfaces the backend's PREEMPTION attribution and blames the
    preempted task."""
    monkeypatch.setenv(constants.TEST_SLICE_FAIL_HOST, "fakehost-0")
    conf = slice_conf(tmp_path, SLEEP_5, workers=1, n_hosts=1,
                      inventory=2,
                      extra={K.APPLICATION_RETRY_COUNT: 0,
                             K.APPLICATION_PREEMPTION_RETRY_COUNT: 0})
    client, rec, code = submit(conf, tmp_path)
    assert code == constants.EXIT_FAILURE
    capsys.readouterr()
    assert cli_main(["diagnose", rec.app_id, "--history-root",
                     str(tmp_path / "history"), "--json"]) == 0
    inc = json.loads(capsys.readouterr().out)
    v = inc["verdict"]
    assert v["category"] == "PREEMPTION"
    assert v["blamed_task"] == "worker:0"
    assert any("PREEMPTION" in e for e in v["evidence"])


# ---------------------------------------------------------------------------
# Backend selection plumbing (coordinator __main__._make_backend)
# ---------------------------------------------------------------------------
def test_make_backend_dispatch(tmp_path):
    from tony_tpu_torch.cluster.local import LocalProcessBackend
    from tony_tpu_torch.cluster.gpu import StaticSshProvisioner
    from tony_tpu_torch.coordinator.__main__ import _make_backend

    conf = TonyTpuConfig()
    assert isinstance(_make_backend(conf, str(tmp_path)),
                      LocalProcessBackend)

    conf.set(K.APPLICATION_BACKEND, "gpu-host")
    conf.set(K.SLICE_PROVISIONER, "ssh")
    conf.set(K.SLICE_HOSTS, "gpu-a, gpu-b,gpu-c")
    conf.set(K.SLICE_NUM_HOSTS, 2)
    b = _make_backend(conf, str(tmp_path))
    assert isinstance(b, GpuHostBackend)
    assert isinstance(b.provisioner, StaticSshProvisioner)
    assert b.provisioner.targets == ["gpu-a", "gpu-b", "gpu-c"]
    assert b.n_hosts == 2

    conf.set(K.SLICE_PROVISIONER, "fake")
    b = _make_backend(conf, str(tmp_path))
    assert isinstance(b.provisioner, FakeSliceProvisioner)

    conf.set(K.SLICE_PROVISIONER, "bogus")
    with pytest.raises(ValueError, match="provisioner"):
        _make_backend(conf, str(tmp_path))
    conf.set(K.APPLICATION_BACKEND, "tpu-slice")
    with pytest.raises(ValueError, match="gpu-host"):
        _make_backend(conf, str(tmp_path))
    conf.set(K.APPLICATION_BACKEND, "bogus")
    with pytest.raises(ValueError, match="backend"):
        _make_backend(conf, str(tmp_path))


def test_ssh_provisioner_lease_bookkeeping(tmp_path):
    """StaticSshProvisioner: atomic grants from the fixed inventory, no
    double-lease, release frees hosts (no ssh traffic)."""
    from tony_tpu_torch.cluster.gpu import (SshHostChannel,
                                            StaticSshProvisioner)

    prov = StaticSshProvisioner(["a", "b", "c"])
    l1 = prov.acquire(2)
    assert [h.host_id for h in l1.hosts] == ["a", "b"]
    assert all(isinstance(h, SshHostChannel) for h in l1.hosts)
    with pytest.raises(SliceProvisionError):
        prov.acquire(2)          # only c is free
    l2 = prov.acquire(1)
    assert [h.host_id for h in l2.hosts] == ["c"]
    prov.release(l1)
    assert len(prov.acquire(2).hosts) == 2


def test_ssh_command_lines_are_the_references(tmp_path, monkeypatch):
    """The remote command lines the ssh channel sends (launch wrapper,
    kill rungs, log fetch) are the reference's, byte for byte."""
    from tony_tpu.cluster import tpu as ref_tpu
    from tony_tpu_torch.cluster import gpu

    def record(cls):
        sent = []

        class _Done:
            returncode = 0

            def wait(self, timeout=None):
                return 0

            def poll(self):
                return 0

            def kill(self):
                pass

        def fake_ssh(self, remote_cmd, **kw):
            sent.append(remote_cmd)
            return _Done()

        monkeypatch.setattr(cls, "_ssh", fake_ssh)
        return sent

    lines = []
    for mod in (ref_tpu, gpu):
        sent = record(mod.SshHostChannel)
        ch = mod.SshHostChannel("h", "user@h")
        h = ch.exec_task("worker:0", ["python3", "-m", "x", "a b"],
                         {"A": "1", "B": "two words"},
                         str(tmp_path / "w"))
        ch.kill(h, grace_s=0.0)
        ch._fetch_logs_locked(h)
        lines.append(sent)
    assert lines[0] == lines[1] and len(lines[0]) >= 4


@pytest.mark.timeout_s(150)
def test_e2e_heterogeneous_gang_coordinator_pool(tmp_path):
    """A CPU ps-style jobtype rides the coordinator's machine
    (node-pool=coordinator) while workers gang over the GPU hosts — one
    DAG, one rendezvous, no GPU host spent on a parameter server."""
    command = _script(tmp_path, "check_env.py", CHECK_ENV_SCRIPT)
    conf = slice_conf(tmp_path, command, workers=2, n_hosts=2)
    conf.set("tony.ps.instances", 1)
    conf.set("tony.ps.command", SLEEP_5)
    conf.set("tony.ps.node-pool", "coordinator")
    client, rec, code = submit(conf, tmp_path)
    assert code == 0, _dump(client)
    assert rec.finished[0] == "SUCCEEDED"
    workroot = _task_dirs(tmp_path, rec.app_id)
    dirs = sorted(os.listdir(str(workroot)))
    # ps on the coordinator host; workers spread over the slice
    assert "coordinator-host" in dirs
    assert os.listdir(str(workroot / "coordinator-host")) == ["ps_0"]
    assert {"fakehost-0", "fakehost-1"} <= set(dirs)


@pytest.mark.timeout_s(150)
def test_e2e_gang_over_stub_ssh_hosts(tmp_path, monkeypatch):
    """SshHostChannel end to end: a PATH-stubbed `ssh` runs each "remote"
    command locally in its own session, so the production plumbing —
    StaticSshProvisioner leases, the remote command line, exit-code
    mapping, per-host workdir layout and the log fetch — runs without
    remote hosts."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    stub = bin_dir / "ssh"
    stub.write_text(
        "#!/bin/bash\n"
        "args=()\n"
        "while (($#)); do case $1 in\n"
        "  -o) shift; shift || exit 97;;\n"
        "  -*) shift;;\n"
        "  *) args+=(\"$1\"); shift;;\n"
        "esac; done\n"
        f"export PYTHONPATH={REPO}\n"
        'exec setsid bash -c "${args[@]:1}"\n')
    os.chmod(str(stub), 0o755)
    monkeypatch.setenv(
        "PATH", str(bin_dir) + os.pathsep + os.environ["PATH"])

    command = _script(tmp_path, "check_env.py", CHECK_ENV_SCRIPT)
    conf = make_conf(tmp_path, command, workers=3)
    conf.set(K.APPLICATION_BACKEND, "gpu-host")
    conf.set(K.SLICE_PROVISIONER, "ssh")
    conf.set(K.SLICE_NUM_HOSTS, 2)
    conf.set(K.SLICE_HOSTS, "gpu-a,gpu-b")
    conf.set(K.SLICE_REMOTE_PYTHON, sys.executable)
    client, rec, code = submit(conf, tmp_path)
    assert code == 0, _dump(client)
    assert rec.finished[0] == "SUCCEEDED"
    workroot = _task_dirs(tmp_path, rec.app_id)
    hostdirs = sorted(d for d in os.listdir(str(workroot))
                      if d.startswith("gpu-"))
    assert hostdirs == ["gpu-a", "gpu-b"]
    assert all((workroot / h / t / "task.pid").exists()
               for h in hostdirs for t in os.listdir(str(workroot / h)))
    events = history.read_job_events(str(tmp_path / "history"), rec.app_id)
    finished = [e for e in events if e.type == "TASK_FINISHED"]
    assert len(finished) == 3
    for ev in finished:
        out, _err = ev.payload["logs"]
        assert "env ok: task worker:" in open(out).read()
    buf = io.StringIO()
    with redirect_stdout(buf):
        code = cli_main(["logs", rec.app_id,
                         "--history-root", str(tmp_path / "history")])
    assert code == 0
    assert "env ok: task worker:" in buf.getvalue()


@pytest.mark.timeout_s(150)
def test_e2e_preemption_resumes_from_checkpoint_on_fresh_lease(
        tmp_path, monkeypatch):
    """A slice host dies once step 1's checkpoint is durable (its manifest
    exists); the broken lease is released, a fresh lease is granted from
    spare inventory, and the retried epoch RESUMES from the checkpoint."""
    ckpt = tmp_path / "ckpt"
    monkeypatch.setenv(constants.TEST_SLICE_FAIL_HOST,
                       f"fakehost-0#{ckpt / '1' / MANIFEST_NAME}")
    result = tmp_path / "result.txt"
    command = _script(tmp_path, "train_with_resume.py", RESUME_SCRIPT)
    conf = slice_conf(
        tmp_path, command, workers=1, n_hosts=1, inventory=2,
        extra={K.APPLICATION_RETRY_COUNT: 2,
               K.APPLICATION_CHECKPOINT_DIR: str(ckpt)})
    conf.set(K.EXECUTION_ENV, f"TONY_TEST_RESULT={result}")
    conf.set(K.EXECUTION_ENV, "TONY_TEST_STEPS=4")
    conf.set(K.EXECUTION_ENV, "TONY_TEST_STEP_SLEEP=0.5")
    client, rec, code = submit(conf, tmp_path)
    assert code == 0, _dump(client)
    assert rec.finished[0] == "SUCCEEDED"
    assert int(rec.finished[1].get("attempt", 0)) >= 1   # retried
    start, end, w1 = result.read_text().split()
    assert int(start) >= 1, \
        f"retried epoch should RESUME (start >= 1), got {start}"
    assert int(end) == 4
    assert float(w1) == 2.0 ** 4        # w[1]=1 doubled once per step
