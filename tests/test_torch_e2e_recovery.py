"""Coordinator crash recovery through the port: the drills of
``tests/test_e2e_recovery.py`` run against ``python -m
tony_tpu_torch.coordinator`` and ``tony_tpu_torch.cli``.

SIGKILL the coordinator mid-training, restart it with ``--recover`` (raw,
and through ``cli recover``), and the job completes with zero extra retry
epochs and the same final step count and loss as an uninterrupted run:
the user processes never notice. A task that finishes during the outage
holds its result for the recovered coordinator.

The shared helpers live here, and ``test_torch_e2e_elastic.py`` and
``test_torch_e2e_migrate.py`` import them, as the reference's drills do.
The user scripts are written into ``tmp_path``; they import only the
port. Every drill that passes runs the port's ``invariants.check_tree``
over its tree, and the reference's checker must give the same verdicts
(``check_artifacts``).
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from tony_tpu.devtools import invariants as ref_invariants
from tony_tpu_torch import constants
from tony_tpu_torch.conf import keys as K
from tony_tpu_torch.conf.config import TonyTpuConfig
from tony_tpu_torch.devtools import invariants
from tony_tpu_torch.events import history
from tony_tpu_torch.events.events import EventType
from tony_tpu_torch.rpc.wire import RpcClient

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOTAL_STEPS = 40
STEP_SECONDS = 0.25

# Fixed-step training stand-in (tests/scripts/train_steps_with_recovery.py):
# deterministic "steps" (sleep + arithmetic), each step number appended to
# TONY_TEST_STEP_FILE.<task>, then "<steps> <loss>" to TONY_TEST_RESULT.
# The loss is a pure function of the step count, so an interrupted and an
# uninterrupted run agree bit for bit iff the user process was never
# disturbed.
STEPS_SCRIPT = r"""
import os
import sys
import time


def main():
    total = int(os.environ.get("TONY_TEST_TOTAL_STEPS", "30"))
    dt = float(os.environ.get("TONY_TEST_STEP_SECONDS", "0.25"))
    idx = os.environ.get("TASK_INDEX", "0")
    step_file = os.environ["TONY_TEST_STEP_FILE"] + "." + idx
    result_file = os.environ["TONY_TEST_RESULT"] + "." + idx
    loss = 100.0
    for step in range(1, total + 1):
        time.sleep(dt)
        loss = loss / (1.0 + 0.1 * step)
        with open(step_file, "a") as f:
            f.write(f"{step}\n")
    with open(result_file, "w") as f:
        f.write(f"{total} {loss:.12g}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
"""


def write_script(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def check_artifacts(root):
    """The port's ``check_tree`` over ``root``: every job dir is ok, and
    the reference's checker reads the same tree to the same verdicts
    over the same artifacts. Returns the port's reports."""
    reports = invariants.check_tree(str(root))
    assert reports, f"no job dir under {root}"
    bad = [r for r in reports if not r.ok]
    assert not bad, invariants.render_text(bad)
    ref = ref_invariants.check_tree(str(root))
    assert [(r.job_dir, r.ok, r.checked) for r in ref] == \
        [(r.job_dir, r.ok, r.checked) for r in reports], \
        ref_invariants.render_text(ref)
    return reports


def _expected_loss(total=TOTAL_STEPS):
    loss = 100.0
    for step in range(1, total + 1):
        loss = loss / (1.0 + 0.1 * step)
    return f"{loss:.12g}"


def _recovery_conf(tmp_path, workers=2, extra=None,
                   total_steps=TOTAL_STEPS, step_seconds=STEP_SECONDS):
    script = write_script(tmp_path, "train_steps_with_recovery.py",
                          STEPS_SCRIPT)
    conf = TonyTpuConfig()
    conf.set("tony.worker.instances", workers)
    conf.set("tony.worker.command", f"{sys.executable} {script}")
    conf.set(K.HISTORY_LOCATION, str(tmp_path / "history"))
    conf.set(K.TASK_REGISTRATION_TIMEOUT_S, 60)
    conf.set(K.APPLICATION_TIMEOUT_S, 150)
    conf.set(K.COORDINATOR_MONITOR_INTERVAL_MS, 100)
    conf.set(K.APPLICATION_NUM_CLIENTS_TO_WAIT, False)
    conf.set(K.APPLICATION_RETRY_COUNT, 1)       # budget must stay untouched
    # Recovery timings scaled for test wall-clock: fast loss detection,
    # fast transport failure, generous-enough grace windows.
    conf.set(K.TASK_HEARTBEAT_INTERVAL_MS, 200)
    conf.set(K.TASK_COORDINATOR_LOSS_HEARTBEATS, 2)
    conf.set(K.TASK_ORPHAN_DEADLINE_S, 60)
    conf.set(K.COORDINATOR_REREGISTRATION_GRACE_S, 45)
    conf.set(K.RPC_MAX_RETRIES, 2)
    conf.set(K.RPC_RETRY_SLEEP_S, 0.2)
    conf.set(K.RPC_CALL_TIMEOUT_S, 5.0)
    conf.set(K.EXECUTION_ENV,
             f"TONY_TEST_TOTAL_STEPS={total_steps},"
             f"TONY_TEST_STEP_SECONDS={step_seconds},"
             f"TONY_TEST_STEP_FILE={tmp_path / 'steps'},"
             f"TONY_TEST_RESULT={tmp_path / 'result'}")
    for k, v in (extra or {}).items():
        conf.set(k, v)
    return conf


def _job_layout(tmp_path, conf, app_id):
    """Client-compatible job dir layout (workdir/jobs/<app>/...), so
    ``cli recover`` finds everything where the client leaves it."""
    job_dir = tmp_path / "work" / "jobs" / app_id
    job_dir.mkdir(parents=True, exist_ok=True)
    frozen = conf.freeze(str(job_dir / constants.FINAL_CONFIG_FILE))
    return job_dir, frozen


def _spawn_coordinator(job_dir, frozen, app_id, history_root,
                       recover=False):
    cmd = [sys.executable, "-m", "tony_tpu_torch.coordinator",
           "--conf", frozen, "--app-id", app_id,
           "--history-root", history_root,
           "--workdir", str(job_dir / "tasks"),
           "--addr-file", str(job_dir / "coordinator.addr"),
           "--user", "recov"]
    if recover:
        cmd.append("--recover")
    env = dict(os.environ)
    env["PYTHONPATH"] = (REPO_ROOT + os.pathsep
                         + env.get("PYTHONPATH", "")).rstrip(os.pathsep)
    logf = open(job_dir / ("coordinator-recover.log" if recover
                           else "coordinator.log"), "ab")
    proc = subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT,
                            env=env)
    logf.close()
    return proc


def _connect(job_dir, timeout=30):
    addr_file = job_dir / "coordinator.addr"
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if addr_file.exists():
            addr = json.loads(addr_file.read_text())
            return RpcClient(addr["host"], addr["port"],
                             token=addr.get("token") or None,
                             max_retries=2, retry_sleep_s=0.1)
        time.sleep(0.05)
    raise AssertionError("coordinator address never appeared")


def _poll_report(rpc, until, timeout=60, what=""):
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        try:
            last = rpc.call("get_application_report")
        except Exception:  # noqa: BLE001 — coordinator mid-(re)start
            time.sleep(0.1)
            continue
        if until(last):
            return last
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}; last report: {last}")


def _dump_logs(job_dir):
    out = []
    for name in ("coordinator.log", "coordinator-recover.log"):
        p = job_dir / name
        if p.exists():
            out.append(f"--- {name} ---\n{p.read_text()[-4000:]}")
    tasks = job_dir / "tasks"
    if tasks.is_dir():
        for root, _dirs, files in sorted(os.walk(tasks)):
            for f in files:
                if f.endswith(".log"):
                    p = os.path.join(root, f)
                    with open(p) as fh:
                        out.append(f"--- {p} ---\n{fh.read()[-2000:]}")
    return "\n".join(out)[-12000:]


def _steps_progressed(tmp_path, at_least=3):
    f = tmp_path / "steps.0"
    return f.exists() and len(f.read_text().split()) >= at_least


def _await_exit(proc, job_dir, timeout=90):
    """Wait for the coordinator process to finish and assert success.

    With wait-for-client-finish off, a finished coordinator tears down
    at once, so observing a SUCCEEDED report over RPC is a race: the exit
    code and the finalized history file are the assertions of record."""
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        raise AssertionError(
            "recovered coordinator never finished\n" + _dump_logs(job_dir))
    assert rc == 0, _dump_logs(job_dir)


def _journal_epochs(hist_root, app_id):
    """Session ids of the epoch records in the write-ahead journal: the
    ground truth for 'zero extra retry epochs consumed'."""
    path = os.path.join(hist_root, "intermediate", app_id,
                        constants.JOURNAL_FILE)
    epochs = []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("t") == "epoch":
                epochs.append(rec["session"])
    return epochs


@pytest.mark.timeout_s(170)
def test_e2e_sigkill_coordinator_recover_resumes_same_run(tmp_path):
    """SIGKILL mid-job + --recover: the job completes, zero retry epochs
    consumed, step count and loss identical to an uninterrupted run,
    recovery visible in the history stream."""
    app_id = "app_recov_1"
    conf = _recovery_conf(tmp_path, workers=2)
    job_dir, frozen = _job_layout(tmp_path, conf, app_id)
    hist_root = str(tmp_path / "history")

    proc1 = _spawn_coordinator(job_dir, frozen, app_id, hist_root)
    try:
        rpc = _connect(job_dir)
        _poll_report(
            rpc, lambda r: all(t["status"] == "RUNNING"
                               for t in r.get("tasks", []))
            and len(r.get("tasks", [])) == 2,
            what="gang running", timeout=60)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline \
                and not _steps_progressed(tmp_path):
            time.sleep(0.1)
        assert _steps_progressed(tmp_path), _dump_logs(job_dir)
        rpc.close()

        # The crash: no teardown, no journal flush beyond what write-ahead
        # already guaranteed, executors keep training as orphans.
        proc1.send_signal(signal.SIGKILL)
        proc1.wait(timeout=10)
        (job_dir / "coordinator.addr").unlink()

        proc2 = _spawn_coordinator(job_dir, frozen, app_id, hist_root,
                                   recover=True)
        try:
            # Mid-run report while the training tail is still going:
            # zero extra retry epochs, untouched budgets, fenced identity.
            rpc = _connect(job_dir, timeout=30)
            report = _poll_report(
                rpc, lambda r: r.get("recovered") is True,
                timeout=30, what="recovered coordinator to serve reports")
            rpc.close()
            assert report["session_id"] == 0, _dump_logs(job_dir)
            assert report["attempt"] == 0
            assert report["retries_left"] == 1, \
                "recovery must not consume the transient retry budget"
            assert report["generation"] == 2
            _await_exit(proc2, job_dir)
        finally:
            if proc2.poll() is None:
                proc2.kill()
    finally:
        if proc1.poll() is None:
            proc1.kill()
    assert _journal_epochs(hist_root, app_id) == [0], \
        "zero extra retry epochs may be consumed"

    # Same final state as an uninterrupted run: every worker ran exactly
    # TOTAL_STEPS steps and landed on the deterministic loss.
    for i in range(2):
        result = (tmp_path / f"result.{i}").read_text().split()
        assert result[0] == str(TOTAL_STEPS), \
            f"worker {i} ended at step {result[0]}, not {TOTAL_STEPS}"
        assert result[1] == _expected_loss()
        steps = (tmp_path / f"steps.{i}").read_text().split()
        assert steps == [str(s) for s in range(1, TOTAL_STEPS + 1)], \
            f"worker {i} step sequence broken (restarted?): {steps[:5]}..."

    # History: finalized SUCCEEDED under the original started_ms, with
    # the recovery visible to operators in the event stream.
    jobs = [j for j in history.list_jobs(hist_root) if j.app_id == app_id]
    assert [j.status for j in jobs] == ["SUCCEEDED"]
    events = history.read_job_events(hist_root, app_id)
    types = [e.type for e in events]
    assert EventType.APPLICATION_INITED in types
    assert EventType.COORDINATOR_RECOVERED in types
    assert types[-1] == EventType.APPLICATION_FINISHED
    rec = [e for e in events
           if e.type == EventType.COORDINATOR_RECOVERED][0]
    assert rec.payload["generation"] == 2
    assert rec.payload["session_id"] == 0
    check_artifacts(tmp_path)


@pytest.mark.timeout_s(170)
def test_e2e_task_finishing_during_outage_still_counts(tmp_path):
    """A task whose user process finishes while the coordinator is down
    holds its result (re-resolve + retry inside the orphan deadline) and
    delivers it to the recovered coordinator: zero retry epochs, no
    re-run."""
    app_id = "app_recov_3"
    conf = _recovery_conf(tmp_path, workers=1, total_steps=8,
                          extra={K.TASK_ORPHAN_DEADLINE_S: 90})
    job_dir, frozen = _job_layout(tmp_path, conf, app_id)
    hist_root = str(tmp_path / "history")

    proc1 = _spawn_coordinator(job_dir, frozen, app_id, hist_root)
    try:
        rpc = _connect(job_dir)
        _poll_report(rpc, lambda r: any(t["status"] == "RUNNING"
                                        for t in r.get("tasks", [])),
                     what="task running", timeout=60)
        # RUNNING means registered, not training: the cluster spec may
        # still be on its way to the executor, and a kill then leaves it
        # at the barrier with no user process. Kill once a step is done.
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline \
                and not _steps_progressed(tmp_path, at_least=1):
            time.sleep(0.05)
        assert _steps_progressed(tmp_path, at_least=1), _dump_logs(job_dir)
        rpc.close()
        proc1.send_signal(signal.SIGKILL)
        proc1.wait(timeout=10)
        (job_dir / "coordinator.addr").unlink()

        # Let training COMPLETE with no coordinator anywhere: the result
        # file appears while the executor has nobody to report to.
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline \
                and not (tmp_path / "result.0").exists():
            time.sleep(0.2)
        assert (tmp_path / "result.0").exists(), _dump_logs(job_dir)
        time.sleep(1.0)          # well inside the outage window

        proc2 = _spawn_coordinator(job_dir, frozen, app_id, hist_root,
                                   recover=True)
        try:
            # The held result lands within seconds of recovery and the
            # coordinator exits almost at once: judge by exit code and
            # the journal, not by racing the report window.
            _await_exit(proc2, job_dir)
        finally:
            if proc2.poll() is None:
                proc2.kill()
    finally:
        if proc1.poll() is None:
            proc1.kill()
    assert _journal_epochs(hist_root, app_id) == [0], \
        "the held result must be re-adopted, not re-run in a retry epoch"
    jobs = [j for j in history.list_jobs(hist_root) if j.app_id == app_id]
    assert [j.status for j in jobs] == ["SUCCEEDED"]
    steps = (tmp_path / "steps.0").read_text().split()
    assert steps == [str(s) for s in range(1, 9)], \
        f"completed work was re-run: {steps}"
    check_artifacts(tmp_path)


@pytest.mark.timeout_s(170)
def test_e2e_injected_coordinator_crash_then_cli_recover(tmp_path):
    """tony.fault.coordinator-crash hard-kills the coordinator from inside
    its monitor loop (os._exit, the SIGKILL shape), and the port's
    ``cli recover`` brings the job home."""
    from tony_tpu_torch.cli.main import main as cli_main

    app_id = "app_recov_2"
    conf = _recovery_conf(tmp_path, workers=1, extra={
        # ~12th monitor iteration at 100 ms ≈ 1.2 s in: executors are
        # registered and training.
        K.FAULT_COORDINATOR_CRASH: "at:12",
    })
    job_dir, frozen = _job_layout(tmp_path, conf, app_id)
    hist_root = str(tmp_path / "history")

    proc1 = _spawn_coordinator(job_dir, frozen, app_id, hist_root)
    try:
        assert proc1.wait(timeout=90) == 137, \
            "fault site must hard-exit the coordinator with 137"
    finally:
        if proc1.poll() is None:
            proc1.kill()
    assert _steps_progressed(tmp_path, at_least=1), \
        "executors must be training when the crash fires\n" \
        + _dump_logs(job_dir)

    # The operator removes the injected fault before recovering (the
    # frozen config is the coordinator's only fault source), or the
    # recovered coordinator would faithfully crash again.
    cfg = json.loads(open(frozen).read())
    cfg.pop(K.FAULT_COORDINATOR_CRASH, None)
    with open(frozen, "w") as f:
        json.dump(cfg, f)

    code = cli_main(["recover", app_id,
                     "--workdir", str(tmp_path / "work")])
    assert code == 0, _dump_logs(job_dir)

    result = (tmp_path / "result.0").read_text().split()
    assert result[0] == str(TOTAL_STEPS)
    assert result[1] == _expected_loss()
    events = history.read_job_events(hist_root, app_id)
    types = [e.type for e in events]
    assert EventType.COORDINATOR_RECOVERED in types
    fins = [e for e in events if e.type == EventType.TASK_FINISHED]
    assert all(e.payload["session_id"] == 0 for e in fins), \
        "recovery must not burn a retry epoch"
    assert types[-1] == EventType.APPLICATION_FINISHED
    check_artifacts(tmp_path)
