"""The port's on-demand profiling and its observers: ``cli profile``,
``cli top`` and ``cli bench diff`` (``tony_tpu_torch/cli/main.py``), the
coordinator's ``profile.start`` / ``profile.status`` and the capture at the
step boundary (``telemetry.py``, on ``torch.profiler``).

Twins of ``tests/test_profiling.py``'s coordinator, CLI and e2e tests:

1. the beacon round trip into Prometheus text, ``metrics.live``, the
   ``top`` frame and ``perf.json``, and ``profile.start``'s refusals, on
   the port's coordinator; the ``top`` frame is the reference CLI's for
   the same snapshot;
2. the bench regression gate: both packages' ``diff_bench`` give the same
   verdicts on the CI fixtures, and ``cli bench diff`` exits and prints as
   the reference's does;
3. a live ``cli profile`` of a one-worker job (the Chrome trace under
   ``<job_dir>/profile/ondemand-*``, ``TASK_PROFILED``, the portal's
   listing, ``top`` during the capture);
4. the slow drill: a two-worker job with an input stall, the capture on
   worker:1 while ``profile.capture`` is injected on worker:0, ``top``'s
   INPUT_BOUND verdict, ``perf.json`` and ``diagnose`` after.

The user script (``train_phases.py`` on the port's data iterator) lives in
``tmp_path``.
"""

import json
import os
import threading
import time
import urllib.request

import pytest

from tony_tpu import profiling as jprofiling
from tony_tpu.cli.main import _render_top as j_render_top
from tony_tpu.cli.main import main as j_cli_main
from tony_tpu_torch import constants
from tony_tpu_torch.cli.main import _render_top
from tony_tpu_torch.cli.main import main as cli_main
from tony_tpu_torch.conf import keys as K
from tony_tpu_torch.conf.config import TonyTpuConfig
from tony_tpu_torch.events import history
from tony_tpu_torch.events.events import EventType
from tony_tpu_torch.portal import PortalServer
from tony_tpu_torch.profiling import INPUT_BOUND, benchdiff, diff_bench

from torch_jobs import PHASES_SCRIPT, make_conf, submit, wait_for

pytestmark = pytest.mark.faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "benchmarks", "fixtures")


# ---------------------------------------------------------------------------
# 1. Coordinator: beacon round trip, the top frame, refusals
# ---------------------------------------------------------------------------
def _coord(tmp_path, **extra):
    from tony_tpu_torch.cluster.local import LocalProcessBackend
    from tony_tpu_torch.coordinator.coordinator import Coordinator

    conf = TonyTpuConfig()
    conf.set("tony.worker.instances", 2)
    conf.set("tony.worker.command", "true")
    for k, v in extra.items():
        conf.set(k, v)
    backend = LocalProcessBackend(str(tmp_path / "work"))
    return Coordinator(conf, "app_prof", backend,
                       str(tmp_path / "history"), user="t")


def _close(coord):
    coord.journal.close()
    coord.rpc._server.server_close()


_PHASE_BEACON = {
    "steps": 10, "age_s": 0.1,
    "phases": {"cum": {"data_wait": 2.0, "step_compute": 6.0,
                       "other": 0.5},
               "wall_s": 8.5, "steps": 10,
               "recent": {"data_wait": 0.2, "step_compute": 0.6,
                          "other": 0.05},
               "recent_wall_s": 0.85},
}


def test_beacon_roundtrip_prometheus_live_view_and_perf_json(tmp_path):
    coord = _coord(tmp_path)
    events = []
    coord.events.emit = events.append
    try:
        coord.register_worker_spec("worker:0", "h", 1, session_id=0)
        coord.register_worker_spec("worker:1", "h", 2, session_id=0)
        res = coord.profile_start(0, "")
        assert res["ok"] and res["task"] == "worker:0"
        assert res["steps"] == 5          # tony.profile.default-steps
        hb = coord.heartbeat("worker:0", session_id=0)
        assert hb["profile"]["id"] == res["id"]
        assert coord.heartbeat("worker:1", session_id=0) is True
        beacon = dict(_PHASE_BEACON)
        beacon["profile"] = {"id": res["id"], "status": "captured",
                             "dir": res["dir"], "steps": 5}
        coord.heartbeat("worker:0", session_id=0, progress=beacon)
        text = coord.metrics.render()
        assert ('tony_step_phase_seconds{app="app_prof",'
                'phase="data_wait",task="worker:0"} 2') in text
        assert ('tony_step_phase_seconds{app="app_prof",'
                'phase="step_compute",task="worker:0"} 6') in text
        live = coord.metrics_live()
        row = next(t for t in live["tasks"] if t["task"] == "worker:0")
        assert row["phases"]["data_wait"] == pytest.approx(0.2353,
                                                           abs=1e-3)
        assert live["perf"]["verdict"] == INPUT_BOUND
        frame = _render_top(live)
        assert "INPUT_BOUND" in frame and "PHASES" in frame
        assert "d" in frame and "C" in frame
        # the reference's renderer draws the same frame from the snapshot
        assert frame == j_render_top(live)
        profiled = [e for e in events
                    if e.type == EventType.TASK_PROFILED]
        assert len(profiled) == 1
        assert profiled[0].payload["status"] == "captured"
        coord.heartbeat("worker:0", session_id=0, progress=beacon)
        assert len([e for e in events
                    if e.type == EventType.TASK_PROFILED]) == 1
        assert coord.heartbeat("worker:0", session_id=0) is True
        st = coord.profile_status()
        assert st["requests"][0]["status"] == "captured"
        coord.final_status = coord.session.status
        coord._write_perf_report()
        doc = json.load(open(os.path.join(coord.job_dir,
                                          constants.PERF_FILE)))
        assert sum(doc["phases_s"].values()) == pytest.approx(
            doc["wall_s"], rel=0.05)
        assert doc["verdict"]["category"] == INPUT_BOUND
        from tony_tpu_torch import diagnosis

        incident = diagnosis.diagnose_job_dir(coord.job_dir,
                                              app_id="app_prof",
                                              provisional=True)
        assert incident["perf"]["verdict"] == INPUT_BOUND
        assert "INPUT_BOUND" in diagnosis.render_text(incident)
    finally:
        _close(coord)


def test_profile_start_refusal_shapes(tmp_path):
    coord = _coord(tmp_path, **{K.PROFILE_ENABLED: False})
    try:
        res = coord.profile_start(0, "")
        assert not res["ok"] and "disabled" in res["message"]
    finally:
        _close(coord)
    coord = _coord(tmp_path / "b", **{K.PROFILE_MAX_ARTIFACTS: 1})
    try:
        coord.register_worker_spec("worker:0", "h", 1, session_id=0)
        assert not coord.profile_start(0, "worker:9")["ok"]
        os.makedirs(os.path.join(coord.job_dir, "profile",
                                 "ondemand-000-old"))
        res = coord.profile_start(0, "")
        assert not res["ok"] and "max-artifacts" in res["message"]
    finally:
        _close(coord)


# ---------------------------------------------------------------------------
# 2. Bench regression gate: verdicts and the CLI against the reference's
# ---------------------------------------------------------------------------
_SYNTHETIC = [
    ({"value": 1.0, "detail": {"phase_probe": {"comms_fraction": 0.10}}},
     {"value": 1.0, "detail": {"phase_probe": {"comms_fraction": 0.30}}}),
    ({"value": 1.0, "detail": {"phase_probe": {"comms_fraction": 0.10}}},
     {"value": 1.0, "detail": {"phase_probe": {"comms_fraction": 0.02}}}),
    ({"value": 100.0, "detail": {"loss": 10.0, "params": 317, "batch": 4,
                                 "seq": 2048}},
     {"value": 100.0, "detail": {"loss": 99.0, "params": 1, "batch": 1,
                                 "seq": 1}}),
    ({"parsed": {"value": 100.0}}, {"value": 80.0}),
    ({"value": 100.0,
      "detail": {"tokenfile_train": {"tokens_per_sec": 5.0}}},
     {"value": 100.0}),
]
_FIXTURE_PAIRS = [(b, c) for b, c in (
    ("bench_base.json", "bench_ok.json"),
    ("bench_base.json", "bench_regressed.json"),
    ("bench_fleet_base.json", "bench_fleet_regressed.json"),
    ("bench_migrate_base.json", "bench_migrate_regressed.json"),
    ("bench_scale_base.json", "bench_scale_regressed.json"),
    ("bench_whatif_base.json", "bench_whatif_regressed.json"))]


@pytest.mark.parametrize("case", range(len(_SYNTHETIC)))
def test_bench_diff_verdicts_equal_the_reference_synthetic(case):
    base, cand = _SYNTHETIC[case]
    for tol in (0.10, 0.5):
        assert diff_bench(base, cand, tolerance=tol) == \
            jprofiling.diff_bench(base, cand, tolerance=tol)


@pytest.mark.parametrize("pair", _FIXTURE_PAIRS,
                         ids=[c for _, c in _FIXTURE_PAIRS])
def test_cli_bench_diff_equals_the_reference(pair, capsys):
    """``cli bench diff`` on the CI fixtures: the same exit code and the
    same report (text and ``--json``) as the reference's CLI."""
    base, cand = (os.path.join(FIXTURES, p) for p in pair)
    for extra in ([], ["--json"], ["--tolerance", "0.5"]):
        rc = cli_main(["bench", "diff", base, cand] + extra)
        out = capsys.readouterr().out
        jrc = j_cli_main(["bench", "diff", base, cand] + extra)
        jout = capsys.readouterr().out
        assert (rc, out) == (jrc, jout)
    if pair[1] == "bench_ok.json":
        assert rc == 0
    else:
        assert cli_main(["bench", "diff", base, cand]) == 1
        capsys.readouterr()


def test_bench_diff_fixture_pass_and_regression():
    base = json.load(open(os.path.join(FIXTURES, "bench_base.json")))
    ok = json.load(open(os.path.join(FIXTURES, "bench_ok.json")))
    bad = json.load(open(os.path.join(FIXTURES, "bench_regressed.json")))
    res_ok = diff_bench(base, ok)
    assert res_ok["regressions"] == [] and res_ok["compared"] > 10
    flagged = {r["metric"] for r in diff_bench(base, bad)["regressions"]}
    assert "detail.orchestration.submit_to_first_step_s" in flagged
    assert "detail.phase_probe.step_phases_s.data_wait" in flagged
    assert "detail.tokenfile_train.tokens_per_sec" in flagged
    assert "detail.phase_probe.comms_fraction" in flagged
    assert benchdiff.main([os.path.join(FIXTURES, "bench_base.json"),
                           os.path.join(FIXTURES, "bench_ok.json")]) == 0
    assert benchdiff.main([os.path.join(FIXTURES, "bench_base.json"),
                           os.path.join(FIXTURES,
                                        "bench_regressed.json")]) == 1


# ---------------------------------------------------------------------------
# 3. A live capture through the CLI (tier-1)
# ---------------------------------------------------------------------------
def test_trainer_reports_the_steps_a_capture_recorded(tmp_path):
    """``trainer.measure`` notes each step's host seconds and which steps
    ran under an on-demand capture: a request adopted before step 0 arms
    at step 0's boundary and records steps 1-3 (what ``chip_smoke.py``
    phase 16 prices the profiler's overhead by)."""
    from tony_tpu_torch import telemetry, trainer
    from tony_tpu_torch.models.transformer import TransformerConfig

    def reset():
        telemetry._reset_phase_state()
        telemetry._reset_profile_state()
        telemetry._steps.update(count=0, busy_s=0.0, flops=0.0, tokens=0.0,
                                first_start=0.0, last_end=0.0,
                                first_end_wall=0.0)

    reset()
    try:
        req, dest = str(tmp_path / "req.json"), str(tmp_path / "cap")
        with open(req, "w") as f:
            json.dump({"id": 1, "steps": 3, "dir": dest}, f)
        telemetry._poll_profile_request(req)
        r = trainer.measure(TransformerConfig.tiny(), batch=2, seq=16,
                            steps=6, warmup=1, device="cpu")
        assert r["profiled_steps"] == [1, 2, 3]
        assert len(r["step_s"]) == 6 and min(r["step_s"]) > 0
        assert telemetry.profile_state()["status"] == "captured"
        with open(os.path.join(dest, "trace.json")) as f:
            assert json.load(f)["traceEvents"]
    finally:
        reset()


def _start_job(tmp_path, workers, env, extra=None):
    conf = make_conf(tmp_path, "train_phases.py", PHASES_SCRIPT,
                     workers=workers,
                     extra={K.TASK_HEARTBEAT_INTERVAL_MS: 200,
                            K.METRICS_EXPORT_INTERVAL_S: 0.3,
                            K.EXECUTION_ENV: env, **(extra or {})})
    workdir = str(tmp_path / "work")
    result = {}

    def _run():
        _, rec, code = submit(conf, tmp_path)
        result.update(app_id=rec.app_id, code=code)

    runner = threading.Thread(target=_run, daemon=True)
    runner.start()
    jobs_dir = os.path.join(workdir, "jobs")
    app_id = wait_for(lambda: (os.listdir(jobs_dir)[:1] or [None])[0]
                      if os.path.isdir(jobs_dir) else None, what="job dir")
    wait_for(lambda: os.path.exists(os.path.join(jobs_dir, app_id,
                                                 "coordinator.addr")),
             what="coordinator address")
    return workdir, app_id, runner, result


def _portal_listing(history_root, app_id):
    portal = PortalServer(history_root, port=0, mover_interval_s=3600,
                          purger_interval_s=3600)
    portal.start()
    try:
        with urllib.request.urlopen(
                f"{portal.url}/profile/{app_id}?format=json",
                timeout=10) as r:
            return json.loads(r.read().decode())
    finally:
        portal.stop()


@pytest.mark.timeout_s(170)
def test_cli_profile_live_capture_listed_and_watched(tmp_path, capsys):
    """``cli profile --steps 3`` on a running one-worker job: the capture
    lands as a Chrome trace under ``<job_dir>/profile/ondemand-*`` without
    restarting the task, ``top --once`` renders while it is armed, the
    portal lists it at ``/profile/<app>``, and the finished job's history
    holds one ``TASK_PROFILED`` (captured)."""
    history_root = str(tmp_path / "history")
    workdir, app_id, runner, result = _start_job(
        tmp_path, 1, "TONY_TEST_STEPS=250,TONY_TEST_DATA_STALL_S=0.02,"
                     "TONY_TELEMETRY_INTERVAL_S=0.2")
    frames = []
    profiling = threading.Event()

    def _watch():
        while not profiling.is_set():
            frames.append(cli_main(["top", app_id, "--once",
                                    "--workdir", workdir]))
            time.sleep(0.2)

    watcher = threading.Thread(target=_watch, daemon=True)
    watcher.start()
    rc = cli_main(["profile", app_id, "--steps", "3", "--workdir",
                   workdir, "--timeout", "60"])
    profiling.set()
    watcher.join(timeout=30)
    assert not watcher.is_alive()
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "captured:" in out and "Perfetto" in out
    assert frames and set(frames) == {0}
    assert "STEPS/S" in out and "worker:0" in out
    job_dir = os.path.join(history_root, "intermediate", app_id)
    captured = out.split("captured: ", 1)[1].splitlines()[0].strip()
    assert os.path.dirname(captured) == os.path.join(job_dir, "profile")
    assert os.path.basename(captured).startswith("ondemand-")
    with open(os.path.join(captured, "trace.json")) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    listed = _portal_listing(history_root, app_id)
    assert [t["name"] for t in listed] == [os.path.basename(captured)]

    runner.join(timeout=120)
    assert not runner.is_alive(), "job did not finish"
    assert result["code"] == 0
    evs = history.read_job_events(history_root, app_id)
    profiled = [e for e in evs if e.type == "TASK_PROFILED"]
    assert len(profiled) == 1
    assert profiled[0].payload["status"] == "captured"
    # the capture restarted nothing: one task ran, once
    assert [e.type for e in evs].count("TASK_FINISHED") == 1


# ---------------------------------------------------------------------------
# 4. Slow e2e: live capture + INPUT_BOUND flip, through the real CLI
# ---------------------------------------------------------------------------
@pytest.mark.slow
@pytest.mark.timeout_s(170)
def test_e2e_profile_live_job_and_input_bound_verdict(tmp_path, capsys):
    """``tests/test_profiling.py``'s acceptance drill through the port: a
    2-task job with an injected 50 ms/step input stall; ``cli profile``
    captures 3 steps from worker:1 while an injected profile.capture
    failure on worker:0 degrades cleanly, ``top`` shows INPUT_BOUND live,
    and at finish perf.json's phase totals sum to within 5% of wall with
    the INPUT_BOUND verdict in ``diagnose``."""
    history_root = str(tmp_path / "history")
    workdir, app_id, runner, result = _start_job(
        tmp_path, 2, "TONY_TEST_STEPS=400,TONY_TEST_DATA_STALL_S=0.05,"
                     "TONY_TELEMETRY_INTERVAL_S=0.2",
        extra={K.FAULT_PROFILE_CAPTURE: "first:1,task:worker:0"})
    job_dir = os.path.join(history_root, "intermediate", app_id)

    rc = cli_main(["profile", app_id, "--steps", "3",
                   "--task", "worker:1", "--workdir", workdir,
                   "--timeout", "60"])
    out = capsys.readouterr()
    assert rc == 0, f"profile failed: {out.out}\n{out.err}"
    assert "captured:" in out.out
    ondemand = [d for d in os.listdir(os.path.join(job_dir, "profile"))
                if d.startswith("ondemand-")]
    assert ondemand, "artifact must land under <job_dir>/profile"
    art = os.path.join(job_dir, "profile", ondemand[0])
    assert sum(len(fs) for _, _, fs in os.walk(art)) > 0
    assert any(t["name"].startswith("ondemand-")
               for t in _portal_listing(history_root, app_id))

    rc = cli_main(["profile", app_id, "--steps", "2",
                   "--task", "worker:0", "--workdir", workdir,
                   "--timeout", "60"])
    out = capsys.readouterr()
    assert rc == 1 and "FAILED" in out.err
    assert "injected fault at profile.capture" in out.err

    def _top_verdict():
        if cli_main(["top", app_id, "--workdir", workdir,
                     "--once"]) != 0:
            capsys.readouterr()
            return None
        frame = capsys.readouterr().out
        return frame if "INPUT_BOUND" in frame else None

    frame = wait_for(_top_verdict, timeout_s=60,
                     what="INPUT_BOUND in top")
    assert "perf: INPUT_BOUND" in frame

    runner.join(timeout=120)
    assert not runner.is_alive(), "job did not finish"
    assert result["code"] == 0, f"job failed: {result}"

    doc = json.load(open(os.path.join(job_dir, constants.PERF_FILE)))
    assert sum(doc["phases_s"].values()) == pytest.approx(
        doc["wall_s"], rel=0.05)
    assert doc["verdict"]["category"] == INPUT_BOUND
    assert doc["fractions"]["data_wait"] > 0.15

    assert cli_main(["diagnose", app_id, "--history-root",
                     history_root, "--fresh"]) == 0
    out = capsys.readouterr()
    assert "perf advisory: INPUT_BOUND" in out.out
