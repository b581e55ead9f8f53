"""E2E drills for the port's warm executor pool
(``tony_tpu_torch/pool.py``) through the port's client and CLI: the four
drills of ``tests/test_e2e_pool.py`` — a warm resubmit under 2 s with the
adoption on the trace, an adoption failure that falls back cold, a kill
mid-lease that retries cold with no job failure, and the ``pool
start/status/stop`` CLI round trip — each with its own ``timeout_s`` as
there. Jobs are one-worker ``pytorch`` jobs on the local backend; the user
scripts are written into ``tmp_path`` and import the port's telemetry
only (no torch), so the drills measure the orchestration path.
"""

import os
import signal
import sys
import threading
import time

import pytest

from tony_tpu_torch import constants, tracing
from tony_tpu_torch.cli.main import main as cli_main
from tony_tpu_torch.client import TaskUpdateListener, TonyTpuClient
from tony_tpu_torch.conf import keys as K
from tony_tpu_torch.conf.config import TonyTpuConfig
from tony_tpu_torch.events import history
from tony_tpu_torch.pool import PoolClient, PoolDaemon

# One telemetry step (the anchor of executor.first_step), published before
# the process exits, which is sooner than the reporter's tick.
SCRIPTS = {
    "first_step_light.py": """
import os
import tony_tpu_torch  # noqa: F401  (starts the telemetry reporter)
from tony_tpu_torch import telemetry

with telemetry.step():
    pass
metrics_file = os.environ.get("TONY_METRICS_FILE", "")
if metrics_file:
    telemetry.write_stats_once(metrics_file)
print(f"first step done (pid {os.getpid()})")
""",
    "sleep_5.py": "import time\ntime.sleep(5)\n",
}


class Recorder(TaskUpdateListener):
    def __init__(self):
        self.app_id = None
        self.finished = None

    def on_application_id_received(self, app_id):
        self.app_id = app_id

    def on_application_finished(self, status, report):
        self.finished = (status, report)


def make_conf(tmp_path, script, workers=1, extra=None):
    """``tests/test_e2e.py``'s conf, framework ``pytorch``, the script
    written into ``tmp_path``."""
    path = tmp_path / script
    path.write_text(SCRIPTS[script])
    conf = TonyTpuConfig()
    conf.set("tony.worker.instances", workers)
    conf.set("tony.worker.command", f"{sys.executable} {path}")
    conf.set(K.APPLICATION_FRAMEWORK, "pytorch")
    conf.set(K.TASK_REGISTRATION_TIMEOUT_S, 60)
    conf.set(K.APPLICATION_TIMEOUT_S, 120)
    conf.set(K.HISTORY_LOCATION, str(tmp_path / "history"))
    conf.set(K.CLIENT_POLL_INTERVAL_MS, 100)
    conf.set(K.COORDINATOR_MONITOR_INTERVAL_MS, 100)
    for k, v in (extra or {}).items():
        conf.set(k, v)
    return conf


def submit(conf, tmp_path):
    client = TonyTpuClient(conf, workdir=str(tmp_path / "work"))
    rec = Recorder()
    client.add_listener(rec)
    code = client.start()
    return client, rec, code


def _wait_for(pred, timeout_s=60, interval_s=0.1, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(interval_s)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture
def warm_pool(tmp_path):
    """A live in-process pool daemon (workers are real subprocesses).
    preload='' — the drills measure the ORCHESTRATION path with a no-torch
    probe script; the torch preload runs on the card (chip_smoke.py)."""
    pool_dir = str(tmp_path / "pool")
    daemon = PoolDaemon(pool_dir, size=2, preload="", max_lease_age_s=600)
    t = threading.Thread(target=daemon.run, daemon=True)
    t.start()
    try:
        _wait_for(lambda: daemon.status()["ready"] >= 1, timeout_s=60,
                  what="a warm worker")
        yield pool_dir, daemon
    finally:
        daemon.request_stop()
        t.join(timeout=30)


def _ready_pids(daemon):
    return {w["pid"] for w in daemon.status()["workers"]
            if w["state"] == "ready"}


def _job_spans(history_root, app_id):
    job_dir = history.list_job_dirs(history_root)[app_id]
    records = tracing.load_records(
        os.path.join(job_dir, constants.TRACE_FILE))
    payload = tracing.to_trace_events(records)
    assert payload["unclosedSpans"] == []
    return records, [e for e in payload["traceEvents"]
                     if e.get("ph") == "X"]


def _pool_conf(tmp_path, pool_dir, script="first_step_light.py",
               extra=None):
    merged = {K.POOL_DIR: pool_dir,
              K.TASK_HEARTBEAT_INTERVAL_MS: 200}
    merged.update(extra or {})
    return make_conf(tmp_path, script, workers=1, extra=merged)


@pytest.mark.timeout_s(170)
def test_warm_pool_resubmit_under_2s_with_adoption_spans(tmp_path,
                                                         warm_pool):
    """THE acceptance drill: two back-to-back submits against a warm
    pool. The second job adopts a pre-warmed executor — its pid is one
    the pool held ready BEFORE the submit — and its span-derived
    submit→first-step latency is ≤ 2 s, with the adoption visible in the
    exported trace (pool.lease span + adopted executor.register)."""
    pool_dir, daemon = warm_pool
    history_root = str(tmp_path / "history")

    conf1 = _pool_conf(tmp_path, pool_dir)
    client1, rec1, code1 = submit(conf1, tmp_path)
    assert code1 == 0

    # job 1 consumed a worker; wait for the replenished fleet, then pin
    # the pids that count as "pooled" for job 2
    _wait_for(lambda: daemon.status()["ready"] >= 1, what="replenish")
    pooled_pids = _ready_pids(daemon)

    conf2 = _pool_conf(tmp_path, pool_dir)
    client2, rec2, code2 = submit(conf2, tmp_path)
    assert code2 == 0

    records, events = _job_spans(history_root, rec2.app_id)
    by_name = {}
    for e in events:
        by_name.setdefault(e["name"], []).append(e)

    # adoption is trace-visible: a successful pool.lease span under the
    # task lifecycle, granting one of the pre-submit warm pids
    lease = by_name["pool.lease"][0]
    assert "error" not in lease["args"]
    assert lease["args"]["pid"] in pooled_pids
    parents = {e["args"]["span"]: e for e in events}
    assert lease["args"]["parent"] in parents
    assert parents[lease["args"]["parent"]]["name"] == "task.lifecycle"
    # the adopted executor's register span says so
    reg = by_name["executor.register"][0]
    assert reg["args"].get("adopted") is True
    assert reg["args"].get("pool_worker") == lease["args"]["worker"]
    # and its run span carries the worker id (the pooled-pid reuse proof
    # from the executor's own side of the trace)
    assert by_name["executor.run"][0]["args"].get("pooled") \
        == lease["args"]["worker"]

    # the satellite's timing contract: user_process starts < 2 s after
    # client.submit...
    submit_start = by_name["client.submit"][0]["ts"]
    up_start = by_name["executor.user_process"][0]["ts"]
    assert (up_start - submit_start) / 1e6 < 2.0, \
        f"user_process started {(up_start - submit_start) / 1e6:.2f}s " \
        f"after submit"
    # ...and the acceptance criterion: span-derived submit→first-step
    # ≤ 2 s, with the phase decomposition summing exactly to it
    bd = tracing.cold_start_breakdown(records)
    assert bd["total_s"] <= 2.0, f"warm resubmit took {bd['total_s']}s"
    assert round(sum(bd["phases"].values()), 4) == round(bd["total_s"], 4)
    assert "pool.lease" in bd["span_durations"]


@pytest.mark.timeout_s(170)
def test_adoption_failure_falls_back_to_cold_spawn(tmp_path, warm_pool):
    """pool.adopt fault (leased executor dead on adoption): the lease is
    discarded at the daemon — never reused — and the job cold-spawns and
    SUCCEEDS. Pool trouble can cost speed, never the job."""
    pool_dir, daemon = warm_pool
    history_root = str(tmp_path / "history")

    conf = _pool_conf(tmp_path, pool_dir,
                      extra={K.FAULT_POOL_ADOPT: "first:1"})
    client, rec, code = submit(conf, tmp_path)
    assert code == 0

    _, events = _job_spans(history_root, rec.app_id)
    by_name = {}
    for e in events:
        by_name.setdefault(e["name"], []).append(e)
    # the failed adoption is on the timeline, with the error
    lease = by_name["pool.lease"][0]
    assert "dead on adoption" in lease["args"]["error"]
    assert lease["args"]["worker"]      # the span names the dirty worker
    # the executor that actually ran was a cold spawn
    assert "adopted" not in by_name["executor.register"][0]["args"]
    assert "pooled" not in by_name["executor.run"][0]["args"]
    # the granted-then-discarded worker is gone from the fleet (a dirty
    # lease is never re-pooled; the daemon replenishes with fresh spawns)
    discarded = lease["args"]["worker"]
    _wait_for(
        lambda: discarded not in {w["worker"]
                                  for w in daemon.status()["workers"]},
        what="discarded worker to leave the fleet")


@pytest.mark.timeout_s(170)
def test_mid_lease_kill_retries_cold_with_no_job_failure(tmp_path,
                                                         warm_pool):
    """SIGKILL the adopted executor while its task runs: the pooled pid
    dying without an exit report must read as a signal kill (137 →
    INFRA_TRANSIENT), the epoch retries, and — with the pool gone — the
    retry cold-spawns and the job still SUCCEEDS."""
    pool_dir, daemon = warm_pool
    conf = _pool_conf(tmp_path, pool_dir, script="sleep_5.py",
                      extra={K.APPLICATION_RETRY_COUNT: 1,
                             K.APPLICATION_TIMEOUT_S: 150})
    result = {}

    def _run():
        client, rec, code = submit(conf, tmp_path)
        result.update(app_id=rec.app_id, code=code,
                      finished=rec.finished)

    runner = threading.Thread(target=_run, daemon=True)
    runner.start()
    leased = _wait_for(
        lambda: [w for w in daemon.status()["workers"]
                 if w["state"] == "leased"],
        timeout_s=90, what="a leased worker")

    # MID-run, not mid-adoption: wait until the adopted executor has
    # actually started the user process (it drops user.pgid into the
    # task dir at spawn) — a kill during adoption would be absorbed by
    # the lease fallback and never produce the 137 this drill is about.
    def _user_running():
        jobs = os.path.join(str(tmp_path / "work"), "jobs")
        if not os.path.isdir(jobs):
            return False
        for app in os.listdir(jobs):
            pgid = os.path.join(jobs, app, "tasks", "worker_0",
                                constants.USER_PGID_FILE)
            if os.path.exists(pgid):
                return True
        return False

    _wait_for(_user_running, timeout_s=90, what="the user process")
    # kill the pool first so the retry epoch cannot re-adopt
    daemon.request_stop()
    _wait_for(lambda: not os.path.exists(
        os.path.join(pool_dir, constants.POOL_ADDR_FILE)),
        what="pool addr file removal")
    os.kill(leased[0]["pid"], signal.SIGKILL)

    runner.join(timeout=150)
    assert not runner.is_alive(), "job never finished after the kill"
    assert result["code"] == 0, result
    assert result["finished"][0] == "SUCCEEDED"

    # the kill is on the record as a retryable infra failure, not a
    # user error: one TASK_FINISHED with exit 137 before the success
    events = history.read_job_events(str(tmp_path / "history"),
                                     result["app_id"])
    from tony_tpu_torch.events.events import EventType

    finishes = [e for e in events if e.type == EventType.TASK_FINISHED]
    assert any(e.payload.get("exit_code") == 137
               and e.payload.get("failure_domain") == "INFRA_TRANSIENT"
               for e in finishes), [e.payload for e in finishes]
    assert finishes[-1].payload.get("exit_code") == 0


@pytest.mark.timeout_s(170)
def test_pool_cli_start_status_stop_round_trip(tmp_path, capsys):
    """`tony-tpu pool start` detaches a daemon and waits for its
    endpoint; `status` renders the fleet; `stop` shuts it down and
    removes the addr file; a second `stop` reports no reachable pool."""
    pool_dir = str(tmp_path / "pool")
    rc = cli_main(["pool", "start", "--dir", pool_dir, "--size", "1",
                   "--preload", ""])
    out = capsys.readouterr().out
    assert rc == 0 and "pool running" in out
    # idempotent start: reports the live pool instead of double-spawning
    rc = cli_main(["pool", "start", "--dir", pool_dir, "--size", "1",
                   "--preload", ""])
    out = capsys.readouterr().out
    assert rc == 0 and "already running" in out

    client = PoolClient(pool_dir)
    _wait_for(lambda: client.call("pool.status")["ready"] >= 1,
              what="a ready worker")
    client.close()
    rc = cli_main(["pool", "status", "--dir", pool_dir])
    out = capsys.readouterr().out
    assert rc == 0 and "ready=1" in out and "pid=" in out

    rc = cli_main(["pool", "stop", "--dir", pool_dir])
    assert rc == 0
    _wait_for(lambda: not os.path.exists(
        os.path.join(pool_dir, constants.POOL_ADDR_FILE)),
        what="pool shutdown")
    rc = cli_main(["pool", "status", "--dir", pool_dir])
    assert rc == 1
    assert "no reachable pool" in capsys.readouterr().err
