"""Fleet observability unit matrix: the goodput ledger's
sum-to-wall discipline (incl. the preempted + grow-back and retry
shapes), warm/cold start classification off the span tree, the
fleet-diagnosis rule-engine golden matrix (all 6 verdicts), decision
ring bounds + transition dedup, the `fleet explain` surfaces (RPC
shape, offline journal replay, CLI rendering), fleet-trace-id adoption
by the client, the single-shot terminal-accounting helper, and the
``fleet.ledger`` / ``fleet.explain`` fault sites. Everything
tier-1-safe: daemons tick by hand over a fake runner, no subprocesses.
Select with ``pytest -m faults``.
"""

import json
import os

import pytest

from tony_tpu_torch import constants, faults
from tony_tpu_torch.conf import keys as K
from tony_tpu_torch.events.events import Event, EventType, read_events
from tony_tpu_torch.fleet import diagnose as fdiagnose
from tony_tpu_torch.fleet import journal as fj
from tony_tpu_torch.fleet import ledger as fledger
from tony_tpu_torch.fleet.daemon import FleetDaemon, QUEUED, RUNNING

pytestmark = pytest.mark.faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.uninstall()
    yield
    faults.uninstall()


# ---------------------------------------------------------------------------
# registry parity
# ---------------------------------------------------------------------------
def test_obs_fault_sites_conf_keys_events_series_registered():
    from tony_tpu_torch.metrics import SERIES

    for site in ("fleet.ledger", "fleet.explain"):
        assert site in faults.SITES
    assert K.fault_key("fleet.ledger") == "tony.fault.fleet-ledger"
    assert K.fault_key("fleet.explain") == "tony.fault.fleet-explain"
    from tony_tpu_torch.conf.config import TonyTpuConfig

    conf = TonyTpuConfig()
    assert conf.get_int(K.FLEET_DECISION_RING, 0) == 64
    assert float(conf.get(K.FLEET_LEDGER_INTERVAL_S)) == 5.0
    assert conf.get(K.INTERNAL_FLEET_TRACE_ID) == ""
    assert hasattr(EventType, "FLEET_JOB_HELD")
    for fam in ("tony_fleet_goodput_fraction",
                "tony_fleet_phase_seconds"):
        assert fam in SERIES


# ---------------------------------------------------------------------------
# goodput ledger: sum-to-wall across the shapes
# ---------------------------------------------------------------------------
def _fold(**kw):
    base = dict(job_id="fj-0001", tenant="teamA", hosts_requested=8,
                state=fj.STATE_FINISHED)
    base.update(kw)
    return fj.JobFold(**base)


def _phase_sum(led):
    return sum(led["phases_s"].values())


def test_ledger_journal_only_partition_queued_plus_train():
    led = fledger.compute_job_ledger(_fold(
        submitted_ms=1_000_000, granted_ms=1_005_000,
        finished_ms=1_035_000, hosts=8,
        host_events=[(1_005_000, 8)]))
    assert led["wall_s"] == pytest.approx(35.0)
    assert led["phases_s"]["queued"] == pytest.approx(5.0)
    assert led["phases_s"]["train"] == pytest.approx(30.0)
    assert _phase_sum(led) == pytest.approx(led["wall_s"], abs=0.01)
    # 8 hosts for 30s granted
    assert led["held_chip_s"] == pytest.approx(240.0)
    assert led["goodput_fraction"] == pytest.approx(1.0)
    assert fledger.sum_to_wall_error(led) == 0.0


def test_ledger_never_granted_books_whole_wall_as_queued():
    led = fledger.compute_job_ledger(
        _fold(state="QUEUED", submitted_ms=1_000_000),
        now_ms=1_030_000)
    assert led["provisional"]
    assert led["phases_s"]["queued"] == pytest.approx(30.0)
    assert led["held_chip_s"] == 0.0
    assert led["goodput_fraction"] is None


def _write_job_artifacts(job_dir, app_id="app_x"):
    """A job dir with every artifact the ledger reads: span tree (cold
    start anchors), GANG_RESIZED events (shrink = preempted, grow =
    resize_drain), perf.json (ckpt_stall) and a session journal with a
    retry-epoch reset."""
    os.makedirs(job_dir, exist_ok=True)
    trace = [
        {"ev": "X", "trace": "feedf00d", "span": "s1", "parent": "",
         "name": "client.submit", "svc": "client", "task": "",
         "ts_us": 1_005_500_000, "dur_us": 25_000_000, "args": {}},
        {"ev": "X", "trace": "feedf00d", "span": "s2", "parent": "s1",
         "name": "executor.first_step", "svc": "executor",
         "task": "worker:0", "ts_us": 1_006_000_000,
         "dur_us": 1_000_000, "args": {}},
    ]
    with open(os.path.join(job_dir, constants.TRACE_FILE), "w") as f:
        for rec in trace:
            f.write(json.dumps(rec) + "\n")
    evs = [
        Event(EventType.GANG_RESIZED,
              {"phase": "completed", "from": 8, "to": 4,
               "duration_s": 2.0}, timestamp_ms=1_015_000),
        Event(EventType.GANG_RESIZED,
              {"phase": "completed", "from": 4, "to": 8,
               "duration_s": 1.0}, timestamp_ms=1_025_000),
    ]
    with open(os.path.join(job_dir, f"{app_id}-x{constants.EVENTS_SUFFIX}"),
              "w") as f:
        for ev in evs:
            f.write(ev.to_json() + "\n")
    with open(os.path.join(job_dir, constants.PERF_FILE), "w") as f:
        json.dump({"phases_s": {"ckpt_stall": 3.0, "step_compute": 9.0},
                   "wall_s": 12.0}, f)
    with open(os.path.join(job_dir, constants.JOURNAL_FILE), "w") as f:
        f.write(json.dumps({"t": "epoch", "session": 0,
                            "ts": 1_005_000}) + "\n")
        f.write(json.dumps({"t": "epoch", "session": 1,
                            "ts": 1_010_000}) + "\n")


def test_ledger_preempt_growback_retry_shape_sums_to_wall(tmp_path):
    job_dir = str(tmp_path / "job")
    _write_job_artifacts(job_dir)
    fold = _fold(
        submitted_ms=1_000_000, granted_ms=1_005_000,
        finished_ms=1_035_000, hosts=8, app_id="app_x",
        host_events=[(1_005_000, 8), (1_015_000, 4), (1_025_000, 8)])
    led = fledger.compute_job_ledger(fold, job_dir=job_dir)
    ph = led["phases_s"]
    assert led["start_kind"] == "cold"
    assert ph["queued"] == pytest.approx(5.0)
    assert ph["provision"] == pytest.approx(0.5)       # grant→submit span
    assert ph["cold_start"] == pytest.approx(1.5)      # →first_step end
    assert ph["warm_start"] == 0.0
    assert ph["retry_recompute"] == pytest.approx(3.0)  # →last reset
    assert ph["ckpt_stall"] == pytest.approx(3.0)
    assert ph["preempted"] == pytest.approx(2.0)       # 8→4 drain
    assert ph["resize_drain"] == pytest.approx(1.0)    # 4→8 grow-back
    assert _phase_sum(led) == pytest.approx(led["wall_s"], abs=0.01)
    assert fledger.sum_to_wall_error(led) == 0.0
    # chip-seconds: 8*10 + 4*10 + 8*10 over the granted 30s
    assert led["held_chip_s"] == pytest.approx(200.0)
    assert led["lost_preempted_chip_s"] == pytest.approx(40.0)
    assert 0 < led["goodput_fraction"] < 1


def test_ledger_warm_start_classified_from_adoption_span(tmp_path):
    job_dir = str(tmp_path / "job")
    os.makedirs(job_dir)
    with open(os.path.join(job_dir, constants.TRACE_FILE), "w") as f:
        f.write(json.dumps(
            {"ev": "X", "trace": "t", "span": "s9", "parent": "",
             "name": "pool.lease", "svc": "coordinator",
             "task": "worker:0", "ts_us": 1_005_100_000,
             "dur_us": 100_000, "args": {"worker": "w-1"}}) + "\n")
        f.write(json.dumps(
            {"ev": "X", "trace": "t", "span": "s2", "parent": "",
             "name": "executor.first_step", "svc": "executor",
             "task": "worker:0", "ts_us": 1_006_000_000,
             "dur_us": 500_000, "args": {}}) + "\n")
    led = fledger.compute_job_ledger(
        _fold(submitted_ms=1_000_000, granted_ms=1_005_000,
              finished_ms=1_020_000, hosts=1,
              host_events=[(1_005_000, 1)]),
        job_dir=job_dir)
    assert led["start_kind"] == "warm"
    assert led["phases_s"]["warm_start"] > 0
    assert led["phases_s"]["cold_start"] == 0.0
    assert _phase_sum(led) == pytest.approx(led["wall_s"], abs=0.01)


def test_ledger_rollup_tenants_and_warm_fraction():
    warm = {"tenant": "a", "held_chip_s": 100.0,
            "lost_preempted_chip_s": 0.0, "start_kind": "warm",
            "chip_seconds": {"train": 90.0, "warm_start": 10.0},
            "phases_s": {"train": 90.0, "warm_start": 10.0}}
    cold = {"tenant": "a", "held_chip_s": 100.0,
            "lost_preempted_chip_s": 5.0, "start_kind": "cold",
            "chip_seconds": {"train": 50.0, "cold_start": 50.0},
            "phases_s": {"train": 50.0, "cold_start": 50.0}}
    other = {"tenant": "b", "held_chip_s": 10.0,
             "lost_preempted_chip_s": 0.0, "start_kind": "cold",
             "chip_seconds": {"train": 10.0},
             "phases_s": {"train": 10.0}}
    roll = fledger.rollup([warm, cold, other])
    assert roll["tenants"]["a"]["goodput_fraction"] == \
        pytest.approx(0.7)
    assert roll["tenants"]["a"]["warm_start_fraction"] == \
        pytest.approx(0.5)
    assert roll["tenants"]["b"]["goodput_fraction"] == \
        pytest.approx(1.0)
    fleet = roll["fleet"]
    assert fleet["jobs"] == 3
    assert fleet["goodput_fraction"] == pytest.approx(150.0 / 210.0,
                                                      abs=1e-4)
    assert fleet["lost_preempted_chip_s"] == pytest.approx(5.0)


def test_sum_to_wall_error_flags_a_leak():
    bad = {"wall_s": 100.0, "phases_s": {"queued": 10.0, "train": 60.0}}
    assert fledger.sum_to_wall_error(bad) > 0


# ---------------------------------------------------------------------------
# fleet-diagnosis rule engine: golden matrix, all 6 verdicts
# ---------------------------------------------------------------------------
def _bundle(**kw):
    base = {
        "fleet_dir": "/f", "quotas": {}, "tenants_used": {},
        "queue": [], "median_grant_wait_s": 1.0,
        "grants_total": 10, "preemptions_total": 0,
        "preempts_per_job": {}, "ledger": {"tenants": {}, "fleet": {}},
        "pool_dir": "",
    }
    base.update(kw)
    return base


def _verdict(bundle):
    return fdiagnose.build_incident(bundle)["verdict"]


def test_verdict_starvation_names_job_and_blockers():
    v = _verdict(_bundle(queue=[{
        "job": "fj-0009", "tenant": "a", "hosts": 4, "wait_s": 120.0,
        "last_decision": {"action": "capacity",
                          "reason": "4 hosts do not fit (0 free)",
                          "blocking": ["fj-0001"], "free": 0}}]))
    assert v["category"] == fdiagnose.STARVATION
    assert any("fj-0009" in e for e in v["evidence"])
    assert any("fj-0001" in e for e in v["evidence"])


def test_verdict_quota_saturated_wins_over_starvation_for_quota_holds():
    v = _verdict(_bundle(
        quotas={"capped": 2}, tenants_used={"capped": 2},
        queue=[{"job": "fj-0005", "tenant": "capped", "hosts": 2,
                "wait_s": 500.0,
                "last_decision": {"action": "quota",
                                  "reason": "tenant 'capped' at quota "
                                            "(2/2 hosts)",
                                  "blocking": ["fj-0003"],
                                  "free": 4}}]))
    assert v["category"] == fdiagnose.QUOTA_SATURATED
    assert any("capped" in e for e in v["evidence"])


def test_verdict_fragmentation_when_free_hosts_do_not_pack():
    v = _verdict(_bundle(queue=[{
        "job": "fj-0007", "tenant": "a", "hosts": 4, "wait_s": 5.0,
        "last_decision": {"action": "capacity",
                          "reason": "fragmentation: 5 free host(s) "
                                    "exist but do not pack",
                          "blocking": ["fj-0002"], "free": 5}}]))
    assert v["category"] == fdiagnose.FRAGMENTATION
    assert any("5" in e for e in v["evidence"])


def test_verdict_preempt_storm_on_churn():
    v = _verdict(_bundle(preemptions_total=6, grants_total=10,
                         preempts_per_job={"fj-0001": 4}))
    assert v["category"] == fdiagnose.PREEMPT_STORM
    assert any("fj-0001" in e for e in v["evidence"])


def test_verdict_pool_cold_only_with_a_configured_pool():
    ledger = {"tenants": {}, "fleet": {"warm_starts": 1,
                                       "cold_starts": 9,
                                       "warm_start_fraction": 0.1,
                                       "goodput_fraction": 0.9}}
    v = _verdict(_bundle(pool_dir="/warm", ledger=ledger))
    assert v["category"] == fdiagnose.POOL_COLD
    # same cold fraction with NO pool configured: not a pool problem
    v2 = _verdict(_bundle(pool_dir="", ledger=ledger))
    assert v2["category"] == fdiagnose.FLEET_HEALTHY


def test_verdict_fleet_healthy_carries_goodput_evidence():
    doc = fdiagnose.build_incident(_bundle(
        ledger={"tenants": {}, "fleet": {"goodput_fraction": 0.93,
                                         "held_chip_s": 1000.0}}))
    v = doc["verdict"]
    assert v["category"] == fdiagnose.FLEET_HEALTHY
    assert any("0.93" in e for e in v["evidence"])
    assert doc["goodput_fraction"] == 0.93
    assert fdiagnose.render_text(doc).startswith(
        "fleet verdict: FLEET_HEALTHY")


def test_rule_engine_categories_cover_the_contract():
    assert set(fdiagnose.CATEGORY_PRECEDENCE) == {
        "SICK_SLICE", "FLAKY_HOST",
        "STARVATION", "QUOTA_SATURATED", "FRAGMENTATION",
        "PREEMPT_STORM", "POOL_COLD", "SLO_BREACH", "FLEET_HEALTHY"}


def test_broken_rule_degrades_never_dies(monkeypatch):
    def boom(bundle):
        raise RuntimeError("rule exploded")
    monkeypatch.setattr(fdiagnose, "_RULES",
                        [boom] + fdiagnose._RULES[1:])
    doc = fdiagnose.build_incident(_bundle())
    assert doc["verdict"]["category"] in fdiagnose.CATEGORY_PRECEDENCE


# ---------------------------------------------------------------------------
# daemon: decision ring, explain, terminal accounting, fault sites
# ---------------------------------------------------------------------------
class _FakeHandle:
    def __init__(self, pid):
        self.pid = pid
        self.exit = None

    def poll(self):
        return self.exit


class FakeRunner:
    def __init__(self):
        self.spawned = []
        self.resized = []
        self.killed = []
        self._next_pid = 2000

    def spawn(self, workdir, overrides):
        os.makedirs(workdir, exist_ok=True)
        self._next_pid += 1
        h = _FakeHandle(self._next_pid)
        self.spawned.append((workdir, overrides, h))
        return h

    def poll(self, handle):
        return handle.poll()

    def resize(self, workdir, size):
        self.resized.append((workdir, size))
        return True

    def kill(self, workdir):
        self.killed.append(workdir)
        return True

    def handle_for(self, job_id):
        for wd, _, h in self.spawned:
            if os.path.basename(wd) == job_id:
                return h
        raise AssertionError(f"{job_id} never spawned")


def _daemon(tmp_path, **kw):
    kw.setdefault("slices", 2)
    kw.setdefault("hosts_per_slice", 4)
    kw.setdefault("runner", FakeRunner())
    kw.setdefault("ledger_interval_s", 0.0)
    return FleetDaemon(str(tmp_path / "fleet"), **kw)


def _row(d, job):
    return next(r for r in d.status()["jobs"] if r["job"] == job)


def test_decision_ring_bounded_and_journal_deduped(tmp_path):
    d = _daemon(tmp_path, slices=1, hosts_per_slice=2,
                decision_ring=4)
    blocker = d.submit("t", 2, conf={})["job"]
    d.tick()
    held = d.submit("t", 2, conf={})["job"]
    for _ in range(6):
        d.tick()                  # same hold every tick: ONE record
    job = d.jobs[held]
    capacity_entries = [e for e in job.decisions
                        if e["action"] == "capacity"]
    assert len(capacity_entries) == 1
    assert blocker in capacity_entries[0]["blocking"]
    # force transitions past the ring bound: alternate the hold shape
    for i in range(8):
        job.decisions.append({"ts_ms": i, "action": "x",
                              "reason": f"r{i}", "blocking": [],
                              "free": 0})
    assert len(job.decisions) == 4            # deque maxlen honoured
    d._shutdown()
    # the journal carries each TRANSITION exactly once — the invariant
    # checker's fleet-decision dedup rule stays green
    from tony_tpu_torch.devtools import invariants

    rep = invariants.check_job_dir(d.fleet_dir)
    assert rep.ok, invariants.render_text([rep])


def test_held_column_and_fleet_job_held_event(tmp_path):
    d = _daemon(tmp_path, slices=1, hosts_per_slice=2)
    d.submit("t", 2, conf={})
    d.tick()
    held = d.submit("t", 2, conf={})["job"]
    d.tick()
    row = _row(d, held)
    assert row["state"] == QUEUED
    assert row["held"].startswith("capacity:")
    d._shutdown()
    evs = [e for e in read_events(os.path.join(
        d.fleet_dir, constants.FLEET_EVENTS_FILE))
        if e.type == EventType.FLEET_JOB_HELD]
    assert len(evs) == 1
    assert evs[0].payload["job"] == held
    assert evs[0].payload["action"] == "capacity"


def test_explain_rpc_shape_and_cli_rendering(tmp_path):
    d = _daemon(tmp_path, slices=1, hosts_per_slice=2)
    blocker = d.submit("t", 2, conf={})["job"]
    d.tick()
    held = d.submit("t", 2, conf={})["job"]
    d.tick()
    res = d.explain(held)
    assert res["ok"] and res["state"] == QUEUED
    assert res["decisions"][-1]["action"] == "capacity"
    assert blocker in res["decisions"][-1]["blocking"]
    assert res["milestones"][0]["what"].startswith("submitted")
    text = fdiagnose.render_explain(res)
    assert held in text and "capacity" in text \
        and f"blocking: {blocker}" in text
    assert not d.explain("nope")["ok"]
    # the blocker finishes → held grants; explain shows the closure
    d.runner.handle_for(blocker).exit = 0
    d.tick()
    d.tick()
    res = d.explain(held)
    assert res["state"] == RUNNING
    assert any(e["action"] == "granted" for e in res["decisions"])
    d._shutdown()
    # offline twin: journal replay yields the same causal story
    off = fdiagnose.offline_explain(d.fleet_dir, held)
    assert off["ok"] and off["offline"]
    assert any(dec["action"] == "capacity"
               for dec in off["decisions"])
    assert "capacity" in fdiagnose.render_explain(off)


def test_grant_injects_fleet_trace_context(tmp_path):
    d = _daemon(tmp_path)
    d.submit("t", 2, model="m", conf={})
    d.tick()
    _, overrides, _ = d.runner.spawned[0]
    assert overrides[K.INTERNAL_FLEET_TRACE_ID] == d.tracer.trace_id
    assert overrides[K.INTERNAL_FLEET_TRACE_PARENT]
    d._shutdown()


def test_client_adopts_fleet_trace_id():
    from tony_tpu_torch.client.client import TonyTpuClient
    from tony_tpu_torch.conf.config import TonyTpuConfig

    conf = TonyTpuConfig()
    conf.set(K.INTERNAL_FLEET_TRACE_ID, "feedc0ffee15dead")
    client = TonyTpuClient(conf, workdir="/tmp/unused")
    assert client._tracer.trace_id == "feedc0ffee15dead"
    # without the injection a fresh id is minted
    other = TonyTpuClient(TonyTpuConfig(), workdir="/tmp/unused")
    assert other._tracer.trace_id != "feedc0ffee15dead"


def test_finish_job_single_shot_accounting(tmp_path):
    d = _daemon(tmp_path)
    job = d.submit("t", 2, conf={})["job"]
    d.tick()
    assert d._finish_job(job, fj.STATE_FINISHED, 0) is True
    # second finish (cancel racing the poll tick) is a no-op
    assert d._finish_job(job, fj.STATE_CANCELLED, None) is False
    assert _row(d, job)["state"] == fj.STATE_FINISHED
    d.tick()                       # poll must not re-book it either
    d._shutdown()
    finished = [e for e in read_events(os.path.join(
        d.fleet_dir, constants.FLEET_EVENTS_FILE))
        if e.type == EventType.FLEET_JOB_FINISHED]
    assert len(finished) == 1
    # exactly one queue-wait observation (at the single grant)
    hist = d.metrics.histogram("tony_fleet_queue_wait_seconds")
    assert hist.snapshot()["count"] == 1
    # exactly one terminal journal record for the job
    recs = [json.loads(line) for line in open(os.path.join(
        d.fleet_dir, constants.FLEET_JOURNAL_FILE))]
    terminal = [r for r in recs if r.get("t") == fj.REC_FLEET_STATE
                and r.get("state") in fj.TERMINAL_STATES
                and r.get("job") == job]
    assert len(terminal) == 1


def test_cancel_and_spawn_failure_route_through_finish_job(tmp_path):
    d = _daemon(tmp_path, slices=1, hosts_per_slice=2)
    a = d.submit("t", 2, conf={})["job"]
    b = d.submit("t", 2, conf={})["job"]
    d.tick()
    assert d.cancel(b)["state"] == fj.STATE_CANCELLED
    d.runner.handle_for(a).exit = 1
    d.tick()
    d._shutdown()
    finished = [e for e in read_events(os.path.join(
        d.fleet_dir, constants.FLEET_EVENTS_FILE))
        if e.type == EventType.FLEET_JOB_FINISHED]
    assert sorted(e.payload["job"] for e in finished) == [a, b]


def test_ledger_exports_goodput_gauges_and_incident(tmp_path):
    d = _daemon(tmp_path)
    job = d.submit("teamA", 2, conf={})["job"]
    d.tick()
    d.runner.handle_for(job).exit = 0
    d.tick()
    prom = open(os.path.join(d.fleet_dir,
                             constants.FLEET_PROM_FILE)).read()
    assert "tony_fleet_goodput_fraction" in prom
    assert 'tony_fleet_phase_seconds{phase="train",tenant="teamA"}' \
        in prom
    snap = d.status()
    assert snap["ledger"]["fleet"]["jobs"] == 1
    assert snap["tenants"]["teamA"]["goodput"] is not None
    incident = json.load(open(os.path.join(
        d.fleet_dir, constants.FLEET_INCIDENT_FILE)))
    assert incident["verdict"]["category"] in \
        fdiagnose.CATEGORY_PRECEDENCE
    d._shutdown()


def test_fleet_ledger_fault_degrades_to_counters_only(tmp_path, caplog):
    faults.install(faults.FaultInjector({"fleet.ledger": "first:1"}))
    d = _daemon(tmp_path)
    job = d.submit("t", 2, conf={})["job"]
    d.tick()                       # ledger fold fires the fault
    assert d._ledger_degraded
    snap = d.status()
    assert snap["ledger"] is None  # counters-only
    prom = open(os.path.join(d.fleet_dir,
                             constants.FLEET_PROM_FILE)).read()
    assert "tony_fleet_goodput_fraction" not in prom
    assert "tony_fleet_grants_total" in prom       # counters survive
    # the tick never blocked: the job still runs and finishes
    d.runner.handle_for(job).exit = 0
    d.tick()
    assert _row(d, job)["state"] == fj.STATE_FINISHED
    d._shutdown()


def test_fleet_explain_fault_keeps_ring_and_event(tmp_path, caplog):
    faults.install(faults.FaultInjector({"fleet.explain": "first:1"}))
    d = _daemon(tmp_path, slices=1, hosts_per_slice=2)
    d.submit("t", 2, conf={})
    d.tick()
    held = d.submit("t", 2, conf={})["job"]
    d.tick()                       # decision write faulted
    # applied anyway: ring + held column carry the explainer
    assert d.jobs[held].decisions
    assert _row(d, held)["held"].startswith("capacity:")
    d._shutdown()
    # the journal is MISSING the faulted record (write failed) but the
    # event stream still carries the transition
    recs = [json.loads(line) for line in open(os.path.join(
        d.fleet_dir, constants.FLEET_JOURNAL_FILE))]
    assert not any(r.get("t") == fj.REC_FLEET_DECISION for r in recs)
    evs = [e for e in read_events(os.path.join(
        d.fleet_dir, constants.FLEET_EVENTS_FILE))
        if e.type == EventType.FLEET_JOB_HELD]
    assert len(evs) == 1


# ---------------------------------------------------------------------------
# invariants: the new fleet rules fire on crafted artifacts
# ---------------------------------------------------------------------------
def test_invariant_fleet_decision_duplicate_and_terminal(tmp_path):
    from tony_tpu_torch.devtools import invariants

    fleet_dir = str(tmp_path / "fleet")
    os.makedirs(fleet_dir)
    j = fj.FleetJournal(os.path.join(fleet_dir,
                                     constants.FLEET_JOURNAL_FILE))
    j.generation(1, 1, 4)
    j.submit("fj-0001", "t", 0, 2, 0, "", 1, {})
    j.decision("fj-0001", "capacity", "same reason", ["x"], 0)
    j.decision("fj-0001", "capacity", "same reason", ["x"], 0)
    j.grant("fj-0001", 2, {0: 2})
    j.state("fj-0001", fj.STATE_FINISHED, exit_code=0)
    j.decision("fj-0001", "capacity", "post-terminal hold", [], 0)
    j.close()
    rep = invariants.check_job_dir(fleet_dir)
    msgs = [v for v in rep.violations if v.rule == "fleet-decision"]
    assert len(msgs) == 2
    assert any("consecutive identical" in v.message for v in msgs)
    assert any("terminal state" in v.message for v in msgs)


def test_invariant_fleet_trace_stitch_mismatch(tmp_path):
    from tony_tpu_torch.devtools import invariants

    fleet_dir = str(tmp_path / "fleet")
    hist_dir = os.path.join(fleet_dir, "history", "intermediate",
                            "app_x")
    os.makedirs(hist_dir)
    j = fj.FleetJournal(os.path.join(fleet_dir,
                                     constants.FLEET_JOURNAL_FILE))
    j.generation(1, 1, 4)
    j.submit("fj-0001", "t", 0, 2, 0, "", 1, {})
    j.grant("fj-0001", 2, {0: 2})
    j.state("fj-0001", fj.STATE_RUNNING, app_id="app_x", pid=1)
    j.state("fj-0001", fj.STATE_FINISHED, app_id="app_x", exit_code=0)
    j.close()
    with open(os.path.join(fleet_dir, constants.TRACE_FILE), "w") as f:
        f.write(json.dumps({"ev": "X", "trace": "fleettrace000000",
                            "span": "a", "parent": "",
                            "name": "fleet.job", "svc": "fleet",
                            "task": "fj-0001", "ts_us": 1,
                            "dur_us": 1, "args": {}}) + "\n")
    # the job minted its OWN trace id: stitching broken
    with open(os.path.join(hist_dir, constants.TRACE_FILE), "w") as f:
        f.write(json.dumps({"ev": "X", "trace": "selfminted000000",
                            "span": "b", "parent": "",
                            "name": "client.submit", "svc": "client",
                            "task": "", "ts_us": 1, "dur_us": 1,
                            "args": {}}) + "\n")
    # a jhist marker so list_job_dirs indexes the dir
    open(os.path.join(hist_dir,
                      f"app_x-1-2-u-FINISHED{constants.EVENTS_SUFFIX}"),
         "w").close()
    rep = invariants.check_job_dir(fleet_dir)
    assert any(v.rule == "fleet-trace-stitch" for v in rep.violations)
    # matching ids pass
    with open(os.path.join(hist_dir, constants.TRACE_FILE), "w") as f:
        f.write(json.dumps({"ev": "X", "trace": "fleettrace000000",
                            "span": "b", "parent": "",
                            "name": "client.submit", "svc": "client",
                            "task": "", "ts_us": 1, "dur_us": 1,
                            "args": {}}) + "\n")
    rep2 = invariants.check_job_dir(fleet_dir)
    assert not any(v.rule == "fleet-trace-stitch"
                   for v in rep2.violations)


def test_daemon_trace_closes_all_spans_on_orderly_stop(tmp_path):
    from tony_tpu_torch import tracing

    d = _daemon(tmp_path, slices=1, hosts_per_slice=2)
    a = d.submit("t", 2, conf={})["job"]
    d.submit("t", 2, conf={})      # stays queued
    d.tick()
    d.runner.handle_for(a).exit = 0
    d.tick()
    d._shutdown()
    records = tracing.load_records(
        os.path.join(d.fleet_dir, constants.TRACE_FILE))
    payload = tracing.to_trace_events(records)
    assert payload["unclosedSpans"] == []
    names = {e["name"] for e in payload["traceEvents"]
             if e.get("ph") == "X"}
    assert {"fleet.queue", "fleet.job"} <= names


def test_bench_fleet_fixtures_gate_regressions():
    from tony_tpu_torch.profiling import benchdiff

    base = json.load(open(os.path.join(
        REPO, "benchmarks", "fixtures", "bench_fleet_base.json")))
    regressed = json.load(open(os.path.join(
        REPO, "benchmarks", "fixtures", "bench_fleet_regressed.json")))
    ok = benchdiff.diff_bench(base, base)
    assert not ok["regressions"]
    bad = benchdiff.diff_bench(base, regressed)
    names = {r["metric"] for r in bad["regressions"]}
    assert any("goodput_fraction" in n for n in names)
    assert any("queue_wait_p99_s" in n for n in names)
    assert any("preemptions_per_job" in n for n in names)
    assert any("warm_start_fraction" in n for n in names)


def test_benchdiff_fleet_directions():
    from tony_tpu_torch.profiling.benchdiff import _direction

    assert _direction(("detail", "mix", "fleet_goodput_fraction")) == \
        "higher"
    assert _direction(("detail", "mix", "warm_start_fraction")) == \
        "higher"
    assert _direction(("detail", "mix", "queue_wait_p50_s")) == "lower"
    assert _direction(("detail", "mix", "queue_wait_p99_s")) == "lower"
    assert _direction(("detail", "mix", "preemptions_per_job")) == \
        "lower"
