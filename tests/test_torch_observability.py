"""The two scenarios of ``tests/test_observability.py`` through the
port: one fault-injected (rpc.slow) job drives the live surface — the
portal's Prometheus exposition while the job RUNS, ``cli top --once``,
the status heartbeat-age column, the portal's live-job cache bypass — and
the exported Perfetto trace must be one stitched tree with zero unclosed
spans; ``cli trace`` on an unknown and on an untraced job. The user
script (``steps_for.py`` on the port's telemetry) lives in ``tmp_path``.
"""

import json
import os
import threading
import time
import urllib.request

import pytest

from tony_tpu_torch import constants
from tony_tpu_torch.cli.main import main as cli_main
from tony_tpu_torch.conf import keys as K
from tony_tpu_torch.portal import PortalServer
from tony_tpu_torch.rpc.wire import RpcClient

from torch_jobs import (EXIT_0_SCRIPT, STEPS_FOR_SCRIPT, make_conf,
                        submit)


def _wait_for(pred, timeout_s=60, interval_s=0.2, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(interval_s)
    raise AssertionError(f"timed out waiting for {what}")


def _coordinator_rpc(workdir, app_id):
    addr_file = os.path.join(workdir, "jobs", app_id, "coordinator.addr")
    if not os.path.exists(addr_file):
        return None
    with open(addr_file) as f:
        addr = json.load(f)
    return RpcClient(addr["host"], addr["port"],
                     token=addr.get("token") or None,
                     max_retries=2, retry_sleep_s=0.2)


@pytest.mark.timeout_s(170)
def test_live_metrics_top_status_and_golden_trace(tmp_path, capsys):
    """The acceptance drill: while a fault-injected job runs, the portal
    serves Prometheus exposition with per-task steps/s + heartbeat-age
    gauges and RPC latency histograms, `top` renders a live snapshot,
    and `status` shows the heartbeat-age column; after it finishes,
    `tony-tpu trace` exports one loadable Perfetto tree with zero
    unclosed spans."""
    extra = {
        K.TASK_HEARTBEAT_INTERVAL_MS: 200,
        K.METRICS_EXPORT_INTERVAL_S: 0.3,
        # deterministic latency injection: lands in the histograms and
        # trace spans without dropping a single frame
        K.FAULT_RPC_SLOW: "first:3,amt:0.02",
        K.EXECUTION_ENV:
            "TONY_TEST_STEPS=400,TONY_TELEMETRY_INTERVAL_S=0.2",
    }
    conf = make_conf(tmp_path, "steps_for.py", STEPS_FOR_SCRIPT, workers=2,
                     extra=extra)
    workdir = str(tmp_path / "work")
    history_root = str(tmp_path / "history")

    result = {}

    def _run():
        client, rec, code = submit(conf, tmp_path)
        result.update(app_id=rec.app_id, code=code)

    runner = threading.Thread(target=_run, daemon=True)
    runner.start()

    # -- while the job runs -------------------------------------------
    app_id = _wait_for(
        lambda: (os.listdir(os.path.join(workdir, "jobs"))[:1] or [None])[0]
        if os.path.isdir(os.path.join(workdir, "jobs")) else None,
        what="job dir")
    rpc = _wait_for(lambda: _coordinator_rpc(workdir, app_id),
                    what="coordinator address")
    try:
        snap = _wait_for(
            lambda: (lambda s: s if any("steps" in t for t in s["tasks"])
                     else None)(rpc.call("metrics.live")),
            timeout_s=90, what="steps in metrics.live")
        assert snap["app_id"] == app_id
        stepping = [t for t in snap["tasks"] if "steps" in t]
        assert stepping and any("heartbeat_age_s" in t
                                for t in snap["tasks"])

        # live Prometheus exposition on the portal, mid-run
        portal = PortalServer(history_root, port=0, mover_interval_s=3600,
                              purger_interval_s=3600)
        portal.start()
        try:
            def _scrape():
                with urllib.request.urlopen(f"{portal.url}/metrics",
                                            timeout=10) as r:
                    assert r.headers["Content-Type"].startswith(
                        "text/plain; version=0.0.4")
                    return r.read().decode()

            text = _wait_for(
                lambda: (lambda t: t if "tony_task_steps_per_sec{" in t
                         else None)(_scrape()),
                timeout_s=60, what="live exposition with steps/s")
            assert f'app="{app_id}"' in text
            assert "tony_task_heartbeat_age_seconds{" in text
            assert "tony_rpc_server_seconds_bucket{" in text
            assert "tony_rpc_client_seconds_bucket{" in text
            assert "tony_rpc_requests_total{" in text
            # merged families: one TYPE header per metric, grouped
            assert text.count("# TYPE tony_task_steps_per_sec gauge") == 1

            # live views bypass the TTL cache: two reads of a RUNNING
            # job's events observe growth within one TTL window
            n1 = len(portal._events(app_id) or [])
            _wait_for(lambda: len(portal._events(app_id) or []) >= n1
                      and portal._job_live(app_id), what="live events")
            assert portal._job_live(app_id)
        finally:
            portal.stop()

        # `tony-tpu top --once` renders the same registry
        rc = cli_main(["top", app_id, "--once", "--workdir", workdir])
        out = capsys.readouterr().out
        assert rc == 0
        assert "STEPS/S" in out and "HB AGE" in out
        assert "worker:0" in out

        # `tony-tpu status` heartbeat-age column, same beacon source
        rc = cli_main(["status", app_id, "--workdir", workdir,
                       "--history-root", history_root])
        out = capsys.readouterr().out
        assert rc == 0
        assert "hb=" in out
    finally:
        rpc.close()

    runner.join(timeout=120)
    assert not runner.is_alive(), "job did not finish"
    assert result["code"] == 0

    # -- after: the golden trace export -------------------------------
    out_path = str(tmp_path / "trace.json")
    rc = cli_main(["trace", app_id, "--history-root", history_root,
                   "--out", out_path])
    capsys.readouterr()
    assert rc == 0
    with open(out_path) as f:
        payload = json.load(f)          # loadable trace_events JSON
    assert payload["unclosedSpans"] == []
    events = payload["traceEvents"]
    assert isinstance(events, list) and events
    for e in events:
        assert "ph" in e and "pid" in e
        if e["ph"] == "X":
            assert e["dur"] >= 0 and e["ts"] > 0
    spans = [e for e in events if e["ph"] == "X"]
    names = {e["name"] for e in spans}
    # the stitched tree: submit → run → epoch → rendezvous → per-task
    # lifecycles → executor spans (incl. first step) → finish marker
    assert {"client.submit", "coordinator.run", "session.epoch",
            "gang.rendezvous", "task.lifecycle", "executor.register",
            "executor.user_process", "executor.first_step"} <= names
    assert "application.finished" in {e["name"] for e in events
                                      if e["ph"] == "i"}
    # ONE trace: every span carries the same trace id
    trace_ids = {e["args"]["trace"] for e in spans}
    assert len(trace_ids) == 1 and payload["traceId"] in trace_ids
    # both workers' lifecycles and executor trees are present
    assert {"worker:0", "worker:1"} <= {
        e["args"].get("task", "") for e in spans
        if e["name"] == "task.lifecycle"}
    # parent links resolve inside the tree (stitching, not orphan spans)
    ids = {e["args"]["span"] for e in spans}
    submit_span = next(e for e in spans if e["name"] == "client.submit")
    run_span = next(e for e in spans if e["name"] == "coordinator.run")
    assert run_span["args"]["parent"] == submit_span["args"]["span"]
    first_steps = [e for e in spans if e["name"] == "executor.first_step"]
    assert len(first_steps) == 2
    for fs in first_steps:
        assert fs["args"]["parent"] in ids
    # the span-derived submit→first-step latency is positive and sane
    dt_s = (max(fs["ts"] + fs["dur"] for fs in first_steps)
            - submit_span["ts"]) / 1e6
    assert 0 < dt_s < 120


@pytest.mark.timeout_s(120)
def test_trace_cli_on_unknown_and_untraced_jobs(tmp_path, capsys):
    rc = cli_main(["trace", "nope", "--history-root",
                   str(tmp_path / "empty")])
    assert rc == 1
    # a real job with tracing disabled has no span log, and trace says so
    conf = make_conf(tmp_path, "exit_0.py", EXIT_0_SCRIPT, workers=1,
                     extra={K.TRACE_ENABLED: False})
    client, rec, code = submit(conf, tmp_path)
    assert code == 0
    capsys.readouterr()
    rc = cli_main(["trace", rec.app_id, "--history-root",
                   str(tmp_path / "history")])
    err = capsys.readouterr().err
    assert rc == 1 and "no span log" in err
    # and the job dir holds no trace file at all (the off-switch is off)
    from tony_tpu_torch.events import history as hist
    job_dir = hist.list_job_dirs(str(tmp_path / "history"))[rec.app_id]
    assert not os.path.exists(os.path.join(job_dir, constants.TRACE_FILE))
