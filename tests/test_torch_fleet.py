"""Fast deterministic unit suite for the fleet scheduler
(tony_tpu_torch/fleet/): the stdlib policy engine (priority ordering, quota
accounting, bin-pack placement, preemption victim selection), the
write-ahead fleet journal (replay incl. torn tail), the daemon's
grant/preempt/restore/recover flows over a fake job runner, the
``fleet.grant`` / ``fleet.preempt`` fault sites, and the fleet-journal
invariant rules + checked-in fixtures. Everything tier-1-safe — the
daemon tests drive ``tick()`` by hand with no subprocesses; the 50-job
LocalSim drill lives in tests/test_e2e_fleet.py (slow). Select with
``pytest -m faults``.
"""

import json
import os
import types

import pytest

from tony_tpu_torch import constants, faults
from tony_tpu_torch.conf import keys as K
from tony_tpu_torch.events.events import EventType, read_events
from tony_tpu_torch.fleet import journal as fj
from tony_tpu_torch.fleet.daemon import (FleetDaemon, FleetError, _AdoptedHandle,
                                   QUEUED, RUNNING)
from tony_tpu_torch.fleet.policy import (CAPACITY_DENIED, GRANT, PREEMPT_WAIT,
                                   PRIORITY_HELD, QUOTA_DENIED, SHRINK,
                                   JobRequest, PolicyEngine, SlicePool,
                                   parse_quotas)

pytestmark = pytest.mark.faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.uninstall()
    yield
    faults.uninstall()


# ---------------------------------------------------------------------------
# Registry parity: fault sites, conf keys, event types, metric families
# ---------------------------------------------------------------------------
def test_fleet_fault_sites_registered():
    for site in ("fleet.grant", "fleet.preempt"):
        assert site in faults.SITES
    inj = faults.FaultInjector({"fleet.grant": "first:1",
                                "fleet.preempt": "first:1"})
    assert inj.fire("fleet.grant") and inj.fire("fleet.preempt")


def test_fleet_conf_keys_registered():
    from tony_tpu_torch.conf.config import TonyTpuConfig

    conf = TonyTpuConfig()
    assert conf.get(K.FLEET_DIR) == ""
    assert conf.get_int(K.FLEET_SLICES, 0) == 1
    assert conf.get_int(K.FLEET_HOSTS_PER_SLICE, 0) == 8
    assert conf.get(K.FLEET_QUOTAS) == ""
    assert float(conf.get(K.FLEET_TICK_INTERVAL_S)) == 0.5
    assert conf.get_int(K.FLEET_PREEMPT_MIN_HOSTS, 0) == 1
    # the fault keys resolve through the canonical site-name mapping
    assert K.fault_key("fleet.grant") == "tony.fault.fleet-grant"
    conf.set(K.FAULT_FLEET_GRANT, "first:1")
    assert faults.install_from_conf(conf) is True
    assert faults.fire("fleet.grant")


def test_fleet_event_types_and_metric_families_registered():
    from tony_tpu_torch.metrics import SERIES

    for name in ("FLEET_JOB_QUEUED", "FLEET_JOB_GRANTED",
                 "FLEET_JOB_PREEMPTED", "FLEET_QUOTA_DENIED",
                 "FLEET_JOB_FINISHED"):
        assert hasattr(EventType, name)
    for fam in ("tony_fleet_hosts", "tony_fleet_jobs",
                "tony_fleet_queue_depth", "tony_fleet_tenant_hosts",
                "tony_fleet_grants_total", "tony_fleet_preemptions_total",
                "tony_fleet_quota_denials_total",
                "tony_fleet_queue_wait_seconds"):
        assert fam in SERIES


# ---------------------------------------------------------------------------
# SlicePool: bin-pack placement
# ---------------------------------------------------------------------------
def test_subslice_jobs_best_fit_into_one_slice():
    pool = SlicePool(2, 4)
    pool.allocate({0: 2})                   # slice 0 has 2 free
    # best-fit: a 2-host gang takes the TIGHTER slice (0), not slice 1
    assert pool.place(2) == {0: 2}
    # a 3-host gang only fits slice 1
    assert pool.place(3) == {1: 3}
    # a sub-slice gang never spans slices even when the sum would fit
    pool.allocate({1: 3})                   # free: 2 + 1
    assert pool.free_total == 3
    assert pool.place(3) is None


def test_large_jobs_take_whole_slices_plus_best_fit_remainder():
    pool = SlicePool(3, 4)
    pool.allocate({2: 2})                   # slice 2 half-full
    got = pool.place(10)                    # 2 whole slices + 2 remainder
    assert got == {0: 4, 1: 4, 2: 2}
    pool.allocate(got)
    assert pool.free_total == 0
    pool.release(got)
    assert pool.free_total == 10


def test_shrink_vacates_whole_slices_before_fragmenting():
    pool = SlicePool(2, 4)
    placement = {0: 4, 1: 2}
    pool.allocate(placement)
    pool.shrink(placement, 3)
    # the half-full slice (1) is vacated ENTIRELY first, then slice 0 —
    # the freed capacity is one whole slice + 1, not 1+2 scattered
    assert placement == {0: 3}
    assert pool.free_total == 5
    assert pool.place(4) == {1: 4}       # a 4-gang now actually fits


# ---------------------------------------------------------------------------
# PolicyEngine: priorities, quotas, preemption, grow-back
# ---------------------------------------------------------------------------
def _engine(slices=2, hps=4, quotas=None):
    return PolicyEngine(slices, hps, quotas=quotas or {})


def test_priority_orders_the_queue_fifo_within_a_band():
    eng = _engine()
    eng.submit(JobRequest("lo", "t", priority=0, hosts=1, seq=1))
    eng.submit(JobRequest("hi", "t", priority=5, hosts=1, seq=2))
    eng.submit(JobRequest("hi2", "t", priority=5, hosts=1, seq=3))
    order = [r.job_id for r in eng.queued_order()]
    assert order == ["hi", "hi2", "lo"]
    plan = eng.schedule()
    assert [d.job_id for d in plan if d.action == GRANT] == \
        ["hi", "hi2", "lo"]


def test_quota_denied_tenant_queues_without_starving_others():
    eng = _engine(quotas={"capped": 2})
    eng.submit(JobRequest("a", "capped", hosts=2, seq=1))
    eng.submit(JobRequest("b", "capped", hosts=2, seq=2))
    eng.submit(JobRequest("c", "free", hosts=2, seq=3))
    plan = eng.schedule()
    # a grants (within quota), b is quota-denied, c grants BEHIND b
    assert [(d.action, d.job_id) for d in plan] == [
        (GRANT, "a"), (QUOTA_DENIED, "b"), (GRANT, "c")]
    eng.grant("a", plan[0].placement)
    eng.grant("c", plan[2].placement)
    # a releases → b's quota headroom returns → b grants
    eng.release("a")
    plan = eng.schedule()
    assert [(d.action, d.job_id) for d in plan] == [(GRANT, "b")]


def test_capacity_denied_head_of_line_holds_no_backfill():
    eng = _engine(1, 4)
    eng.submit(JobRequest("big", "t", priority=5, hosts=4, seq=1))
    eng.submit(JobRequest("small", "t", priority=0, hosts=1, seq=2))
    plan = eng.schedule()
    assert (plan[0].action, plan[0].job_id) == (GRANT, "big")
    eng.grant("big", plan[0].placement)
    eng.submit(JobRequest("big2", "t", priority=5, hosts=4, seq=3))
    plan = eng.schedule()
    # big2 can't fit and can't preempt (no floors): it holds the line —
    # the small job behind it is NOT backfilled into its wait, and the
    # explainer records WHO it is held behind (PRIORITY_HELD decision).
    assert [(d.action, d.job_id) for d in plan] == \
        [(CAPACITY_DENIED, "big2"), (PRIORITY_HELD, "small")]
    held = plan[1]
    assert held.blocking == ["big2"] and "head-of-line" in held.reason


def test_preemption_picks_lowest_priority_victims_respecting_floors():
    eng = _engine(2, 4)
    eng.submit(JobRequest("v1", "t", priority=1, hosts=4, min_hosts=2,
                          seq=1))
    eng.submit(JobRequest("v2", "t", priority=0, hosts=4, min_hosts=1,
                          seq=2))
    for d in eng.schedule():
        eng.grant(d.job_id, d.placement)
    eng.submit(JobRequest("hi", "t", priority=9, hosts=3, seq=3))
    plan = eng.schedule()
    shrinks = [d for d in plan if d.action == SHRINK]
    # the LOWEST-priority victim (v2) shrinks — exactly to its floor,
    # which frees enough on its slice; the higher-priority victim (v1)
    # is never disturbed (minimal-disturbance, placement-aware)
    assert [(d.job_id, d.hosts) for d in shrinks] == [("v2", 1)]
    assert shrinks[0].for_job == "hi"
    eng.shrink_applied("v2", 1)
    plan = eng.schedule()
    assert [(d.action, d.job_id) for d in plan] == [(GRANT, "hi")]
    assert eng.running("v1") == (4, {0: 4})


def test_preemption_refuses_geometrically_unsatisfiable_demands():
    """Quantity is not packability: two half-shrinkable victims on two
    slices can free 3+2 hosts, but a 4-host gang needs one WHOLE slice
    — the plan must preempt NOBODY rather than shrink victims for a
    grant that can never land."""
    eng = _engine(2, 4)
    eng.submit(JobRequest("v1", "t", priority=1, hosts=4, min_hosts=2,
                          seq=1))
    eng.submit(JobRequest("v2", "t", priority=0, hosts=4, min_hosts=1,
                          seq=2))
    for d in eng.schedule():
        eng.grant(d.job_id, d.placement)
    eng.submit(JobRequest("hi", "t", priority=9, hosts=4, seq=3))
    plan = eng.schedule()
    assert [(d.action, d.job_id) for d in plan] == \
        [(CAPACITY_DENIED, "hi")]


def test_equal_or_higher_priority_jobs_are_never_preempted():
    eng = _engine(1, 4)
    eng.submit(JobRequest("peer", "t", priority=5, hosts=4, min_hosts=1,
                          seq=1))
    plan = eng.schedule()
    eng.grant("peer", plan[0].placement)
    eng.submit(JobRequest("rival", "t", priority=5, hosts=2, seq=2))
    plan = eng.schedule()
    assert [(d.action, d.job_id) for d in plan] == \
        [(CAPACITY_DENIED, "rival")]


def test_grow_back_restores_shrunk_jobs_only_when_queue_is_empty():
    eng = _engine(1, 8)
    eng.submit(JobRequest("v", "t", priority=0, hosts=8, min_hosts=2,
                          seq=1))
    plan = eng.schedule()
    eng.grant("v", plan[0].placement)
    eng.shrink_applied("v", 2)
    eng.submit(JobRequest("w", "t", hosts=2, seq=2))
    assert eng.restore_candidates() == []   # queue first, loans later
    plan = eng.schedule()
    eng.grant("w", plan[0].placement)
    restores = eng.restore_candidates()
    assert [(j, h) for j, h, _ in restores] == [("v", 6)]


def test_parse_quotas():
    assert parse_quotas("a=8, b=4") == {"a": 8, "b": 4}
    assert parse_quotas("") == {}
    with pytest.raises(ValueError):
        parse_quotas("nonsense")


# ---------------------------------------------------------------------------
# Fleet journal: round trip + torn tail
# ---------------------------------------------------------------------------
def test_fleet_journal_replay_round_trip(tmp_path):
    path = str(tmp_path / constants.FLEET_JOURNAL_FILE)
    j = fj.FleetJournal(path)
    j.generation(1, 2, 4)
    j.submit("fj-0001", "teamA", 5, 4, 1, "flagship", 1,
             {"tony.worker.command": "true"})
    j.grant("fj-0001", 4, {0: 4})
    j.state("fj-0001", fj.STATE_SPAWNED, pid=4242)
    j.state("fj-0001", fj.STATE_RUNNING, app_id="app_x", pid=4242)
    j.submit("fj-0002", "teamB", 0, 2, 0, "", 2, {})
    j.preempt("fj-0001", 4, 1, "fj-0002", {0: 1})
    j.state("fj-0001", fj.STATE_RESTORED, hosts=4, placement={0: 4})
    j.state("fj-0001", fj.STATE_FINISHED, app_id="app_x", exit_code=0)
    j.close()
    st = fj.replay(path)
    assert st.generation == 1 and (st.slices, st.hosts_per_slice) == (2, 4)
    assert st.seq == 2 and not st.torn_tail
    a = st.jobs["fj-0001"]
    assert a.state == fj.STATE_FINISHED and a.exit_code == 0
    assert a.hosts == 4 and a.placement == {0: 4}   # RESTORED folded
    assert a.app_id == "app_x" and a.pid == 4242
    assert a.conf == {"tony.worker.command": "true"}
    b = st.jobs["fj-0002"]
    assert b.state == "QUEUED" and b.tenant == "teamB"
    assert [f.job_id for f in fj.queued_folds(st)] == ["fj-0002"]


def test_fleet_journal_torn_tail_replays_prefix(tmp_path):
    path = str(tmp_path / constants.FLEET_JOURNAL_FILE)
    j = fj.FleetJournal(path)
    j.generation(1, 1, 4)
    j.submit("fj-0001", "t", 0, 1, 0, "", 1, {})
    j.close()
    with open(path, "ab") as f:
        f.write(b'{"t":"fgrant","job":"fj-0001","hos')   # torn record
    st = fj.replay(path)
    assert st.torn_tail
    assert st.jobs["fj-0001"].state == "QUEUED"    # grant never acted on


def test_fleet_journal_missing_raises():
    with pytest.raises(fj.FleetJournalError):
        fj.replay("/nonexistent/fleet.journal.jsonl")


# ---------------------------------------------------------------------------
# Daemon flows over a fake runner (no subprocesses, tick() by hand)
# ---------------------------------------------------------------------------
class _FakeHandle:
    def __init__(self, pid):
        self.pid = pid
        self.exit = None

    def poll(self):
        return self.exit


class FakeRunner:
    """SubprocessJobRunner stand-in: records spawns/resizes, exits on
    command."""

    def __init__(self, resize_ok=True, migrate_ok=True):
        self.spawned = []          # (workdir, overrides, handle)
        self.resized = []          # (workdir, size)
        self.migrated = []         # (workdir, target node pool)
        self.killed = []
        self.resize_ok = resize_ok
        self.migrate_ok = migrate_ok
        self._next_pid = 1000

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
        return self.resize_ok

    def migrate(self, workdir, target):
        self.migrated.append((workdir, target))
        return self.migrate_ok

    def kill(self, workdir):
        self.killed.append(workdir)
        return True

    def handle_for(self, job_id):
        for wd, _, h in self.spawned:
            if os.path.basename(wd) == job_id:
                return h
        raise AssertionError(f"{job_id} never spawned")

    def fake_app(self, job_id):
        """Materialize the app dir a real client would create."""
        wd = next(wd for wd, _, _ in self.spawned
                  if os.path.basename(wd) == job_id)
        app_id = f"app_x_{job_id.replace('-', '_')}"
        os.makedirs(os.path.join(wd, "jobs", app_id), exist_ok=True)
        return app_id


def _daemon(tmp_path, **kw):
    kw.setdefault("slices", 2)
    kw.setdefault("hosts_per_slice", 4)
    kw.setdefault("runner", FakeRunner())
    return FleetDaemon(str(tmp_path / "fleet"), **kw)


def _job_row(daemon, job_id):
    return next(r for r in daemon.status()["jobs"] if r["job"] == job_id)


def test_daemon_grant_lifecycle_and_overrides(tmp_path):
    d = _daemon(tmp_path, pool_dir="/warm/pool")
    runner = d.runner
    res = d.submit("teamA", 2, min_hosts=1, model="flagship",
                   conf={"tony.worker.command": "true"})
    assert res["ok"] and res["state"] == QUEUED
    job = res["job"]
    d.tick()
    assert _job_row(d, job)["state"] == RUNNING
    _, overrides, handle = runner.spawned[0]
    # the fleet's injections: granted size, elasticity for preemptible
    # jobs, the shared warm pool and the fleet-wide history root; the
    # reference's per-model compile-cache mount has no counterpart (the
    # port compiles nothing at run time)
    assert overrides["tony.worker.instances"] == "2"
    assert overrides[K.ELASTIC_ENABLED] == "true"
    assert overrides[K.ELASTIC_MIN_TASKS] == "1"
    assert overrides[K.POOL_DIR] == "/warm/pool"
    assert K.JAX_COMPILE_CACHE_DIR not in overrides
    assert overrides[K.HISTORY_LOCATION] == d.history_root
    assert overrides["tony.worker.command"] == "true"
    handle.exit = 0
    d.tick()
    row = _job_row(d, job)
    assert row["state"] == fj.STATE_FINISHED and row["exit"] == 0
    # pool fully free again
    assert d.status()["pool"]["used"] == 0
    d._shutdown()
    evs = [e.type for e in read_events(
        os.path.join(d.fleet_dir, constants.FLEET_EVENTS_FILE))]
    assert EventType.FLEET_JOB_QUEUED in evs
    assert EventType.FLEET_JOB_GRANTED in evs
    assert EventType.FLEET_JOB_FINISHED in evs


def test_daemon_quota_denial_event_emitted_once(tmp_path):
    d = _daemon(tmp_path, quotas="capped=2")
    d.submit("capped", 2, conf={})
    res = d.submit("capped", 2, conf={})
    for _ in range(4):
        d.tick()
    row = _job_row(d, res["job"])
    assert row["state"] == QUEUED and "quota" in row["denial"]
    d._shutdown()
    evs = [e for e in read_events(
        os.path.join(d.fleet_dir, constants.FLEET_EVENTS_FILE))
        if e.type == EventType.FLEET_QUOTA_DENIED]
    assert len(evs) == 1               # per transition, not per tick


def test_daemon_rejects_over_quota_and_over_pool_requests(tmp_path):
    d = _daemon(tmp_path, quotas="capped=2")
    assert not d.submit("capped", 3, conf={})["ok"]     # > quota, ever
    assert not d.submit("t", 99, conf={})["ok"]         # > pool
    assert not d.submit("t", 2, min_hosts=3, conf={})["ok"]
    d._shutdown()


def test_daemon_preempts_via_elastic_resize_and_restores(tmp_path):
    d = _daemon(tmp_path)
    runner = d.runner
    v = d.submit("bulk", 8, min_hosts=2, priority=0,
                 conf={"tony.worker.command": "true"})["job"]
    d.tick()
    assert _job_row(d, v)["hosts"] == 8
    hi = d.submit("prod", 4, priority=10, conf={})["job"]
    d.tick()                       # plan: shrink victim (resize RPC)
    assert runner.resized[-1][1] == 4      # 8 → 4 reclaims exactly 4
    assert _job_row(d, v)["hosts"] == 4
    d.tick()                       # reclaimed hosts grant the demander
    assert _job_row(d, hi)["state"] == RUNNING
    # victim was resized, never killed
    assert runner.killed == []
    # demander finishes → queue empty → the loan is repaid (grow-back)
    runner.handle_for(hi).exit = 0
    d.tick()
    d.tick()
    assert runner.resized[-1] == (
        os.path.join(d.fleet_dir, "jobs", v), 8)
    assert _job_row(d, v)["hosts"] == 8
    d._shutdown()
    evs = [e for e in read_events(
        os.path.join(d.fleet_dir, constants.FLEET_EVENTS_FILE))
        if e.type == EventType.FLEET_JOB_PREEMPTED]
    assert len(evs) == 1 and evs[0].payload["for"] == hi


def test_fleet_grant_fault_requeues_never_loses_the_job(tmp_path):
    faults.install(faults.FaultInjector({"fleet.grant": "first:2"}))
    d = _daemon(tmp_path)
    job = d.submit("t", 1, conf={})["job"]
    d.tick()
    assert _job_row(d, job)["state"] == QUEUED     # grant failed, kept
    d.tick()
    d.tick()                                       # third attempt fires
    assert _job_row(d, job)["state"] == RUNNING
    d._shutdown()


def test_fleet_preempt_fault_defers_victim_untouched(tmp_path):
    faults.install(faults.FaultInjector({"fleet.preempt": "first:1"}))
    d = _daemon(tmp_path, slices=1)
    runner = d.runner
    v = d.submit("bulk", 4, min_hosts=1, conf={})["job"]
    d.tick()
    d.submit("prod", 2, priority=10, conf={})
    d.tick()                                       # preempt injected
    assert runner.resized == []                    # victim untouched
    assert _job_row(d, v)["hosts"] == 4
    d.tick()                                       # retried, lands
    assert runner.resized[-1][1] == 2
    d._shutdown()


# ---------------------------------------------------------------------------
# Live migration: defrag, slice evacuation, the operator RPC
# ---------------------------------------------------------------------------
def test_daemon_defrags_by_live_migration_nobody_shrinks(tmp_path):
    d = _daemon(tmp_path)
    runner = d.runner
    j1 = d.submit("t", 2, min_hosts=1, conf={})["job"]
    d.tick()
    j2 = d.submit("t", 2, min_hosts=1, conf={})["job"]
    d.tick()                       # slice 0 full
    j3 = d.submit("t", 2, min_hosts=1, conf={})["job"]
    d.tick()                       # j3 lands on slice 1
    runner.handle_for(j2).exit = 0
    d.tick()                       # 2+2 free, split across both slices
    big = d.submit("t2", 4, conf={})["job"]
    d.tick()                       # fragmentation cure: one live move
    # the youngest sub-slice job moved; its host count never changed
    assert runner.migrated == [
        (os.path.join(d.fleet_dir, "jobs", j3), "slice-0")]
    assert d.jobs[j3].placement == {0: 2}
    assert _job_row(d, j3)["hosts"] == 2
    # nobody shrank, nobody died for the repack
    assert runner.resized == [] and runner.killed == []
    d.tick()                       # merged hole grants the demander
    assert _job_row(d, big)["state"] == RUNNING
    assert _job_row(d, j1)["state"] == RUNNING
    d._shutdown()
    evs = [e for e in read_events(
        os.path.join(d.fleet_dir, constants.FLEET_EVENTS_FILE))
        if e.type == EventType.FLEET_JOB_MIGRATED]
    assert len(evs) == 1 and evs[0].payload["job"] == j3
    assert "defragmentation" in evs[0].payload["reason"]


def test_slice_preempt_notice_evacuates_elastic_jobs(tmp_path):
    d = _daemon(tmp_path)
    runner = d.runner
    mover = d.submit("t", 2, min_hosts=1, conf={})["job"]
    pinned = d.submit("t", 2, conf={})["job"]      # no shrink floor
    d.tick()                       # both land on slice 0 (best fit)
    assert d.jobs[mover].placement == {0: 2}
    assert d.jobs[pinned].placement == {0: 2}
    faults.install(faults.FaultInjector({"slice.preempt": "first:1"}))
    d.tick()                       # notice -> slice 0 dying -> evacuate
    assert d.status()["pool"]["dying"] == [0]
    # the elastic job moved off the dying slice BEFORE the reclaim
    assert runner.migrated == [
        (os.path.join(d.fleet_dir, "jobs", mover), "slice-1")]
    assert d.jobs[mover].placement == {1: 2}
    # the job without the elastic machinery stays: the ordinary
    # host-loss ladder absorbs it when the slice actually dies
    assert d.jobs[pinned].placement == {0: 2}
    d.tick()                       # dying is sticky, move is not redone
    assert len(runner.migrated) == 1
    assert d.status()["pool"]["dying"] == [0]
    d._shutdown()
    evs = [e for e in read_events(
        os.path.join(d.fleet_dir, constants.FLEET_EVENTS_FILE))
        if e.type == EventType.FLEET_JOB_MIGRATED]
    assert len(evs) == 1 and "preemption notice" in evs[0].payload["reason"]


def test_operator_migrate_validations_and_success(tmp_path):
    d = _daemon(tmp_path)
    runner = d.runner
    j1 = d.submit("t", 2, min_hosts=1, conf={})["job"]
    d.tick()                       # slice 0
    filler = d.submit("t", 4, conf={})["job"]
    d.tick()                       # slice 1 full
    queued = d.submit("t", 8, conf={})["job"]      # never fits now
    d.tick()

    assert "unknown job" in d.migrate("fj-9999", 1)["message"]
    assert "not RUNNING" in d.migrate(queued, 1)["message"]
    assert "outside the pool" in d.migrate(j1, 7)["message"]
    assert "already runs on slice 0" in d.migrate(j1, 0)["message"]
    res = d.migrate(j1, 1)         # slice 1 is full
    assert not res["ok"] and "free host(s)" in res["message"]
    assert runner.migrated == []   # every refusal is RPC-free

    runner.handle_for(filler).exit = 0
    d.tick()
    res = d.migrate(j1, 1)
    assert res["ok"] and res["source"] == 0 and res["target"] == 1
    assert res["placement"] == {"1": 2}
    assert d.jobs[j1].placement == {1: 2}
    assert runner.migrated[-1][1] == "slice-1"
    d._shutdown()


def test_operator_migrate_refused_by_coordinator_changes_nothing(tmp_path):
    d = _daemon(tmp_path, runner=FakeRunner(migrate_ok=False))
    j1 = d.submit("t", 2, min_hosts=1, conf={})["job"]
    d.tick()
    res = d.migrate(j1, 1)
    assert not res["ok"] and "refused the move" in res["message"]
    assert d.jobs[j1].placement == {0: 2}          # accounting untouched
    d._shutdown()
    recs = [json.loads(line) for line in open(
        os.path.join(d.fleet_dir, constants.FLEET_JOURNAL_FILE))]
    assert not [r for r in recs if r.get("t") == fj.REC_FLEET_MIGRATE]


def test_recover_replays_migrated_placement(tmp_path):
    fleet_dir = str(tmp_path / "fleet")
    d = _daemon(tmp_path)
    j1 = d.submit("t", 2, min_hosts=1, conf={})["job"]
    d.tick()
    assert d.migrate(j1, 1)["ok"]
    # SIGKILL shape: no shutdown; pin the journaled pid to a live one
    # so recovery adopts the running job instead of post-morteming it
    d.journal.close()
    jpath = os.path.join(fleet_dir, constants.FLEET_JOURNAL_FILE)
    recs = [json.loads(line) for line in open(jpath)]
    for r in recs:
        if r.get("t") == fj.REC_FLEET_STATE and r.get("pid"):
            r["pid"] = os.getpid()
    with open(jpath, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    d2 = FleetDaemon(fleet_dir, slices=2, hosts_per_slice=4,
                     runner=FakeRunner(), recover=True)
    row = _job_row(d2, j1)
    assert row["state"] == RUNNING and row["hosts"] == 2
    # the fold replays the MOVED placement — the job is accounted on
    # its destination slice, host count never drifted
    assert d2.jobs[j1].placement == {1: 2}
    assert d2.status()["pool"]["used"] == 2
    d2._shutdown()
    from tony_tpu_torch.devtools import invariants

    rep = invariants.check_job_dir(fleet_dir)
    assert rep.ok, invariants.render_text([rep])


def test_daemon_cancel_queued_and_running(tmp_path):
    d = _daemon(tmp_path, slices=1, hosts_per_slice=2)
    runner = d.runner
    a = d.submit("t", 2, conf={})["job"]
    b = d.submit("t", 2, conf={})["job"]
    d.tick()
    assert d.cancel(b)["state"] == fj.STATE_CANCELLED
    res = d.cancel(a)
    assert res["state"] == "CANCELLING"
    assert runner.killed == [os.path.join(d.fleet_dir, "jobs", a)]
    runner.handle_for(a).exit = 137
    d.tick()
    assert _job_row(d, a)["state"] == fj.STATE_CANCELLED
    assert not d.cancel(a)["ok"]                   # already terminal
    d._shutdown()


# ---------------------------------------------------------------------------
# Crash recovery: --recover resumes the same queue state
# ---------------------------------------------------------------------------
def test_recover_resumes_queue_adopts_running_respawns_granted(tmp_path):
    fleet_dir = str(tmp_path / "fleet")
    d = _daemon(tmp_path, slices=1, hosts_per_slice=4)
    running = d.submit("t", 2, conf={"k": "v"})["job"]
    d.tick()
    queued = d.submit("t", 4, conf={})["job"]      # can't fit: stays
    d.tick()
    # simulate a SIGKILL: no shutdown, just drop the daemon — but make
    # the recorded client pid a LIVE one so recovery adopts it
    d.journal.close()
    jpath = os.path.join(fleet_dir, constants.FLEET_JOURNAL_FILE)
    recs = [json.loads(line) for line in open(jpath)]
    for r in recs:
        if r.get("t") == fj.REC_FLEET_STATE and r.get("pid"):
            r["pid"] = os.getpid()
    # also a granted-but-never-spawned job: grant record, no spawn
    # high priority so the 4-host capacity-blocked job behind it does
    # not hold the line against its re-grant
    recs.append({"t": fj.REC_FLEET_SUBMIT, "job": "fj-9999",
                 "tenant": "t", "priority": 50, "hosts": 1,
                 "min_hosts": 0, "model": "", "seq": 99, "conf": {}})
    recs.append({"t": fj.REC_FLEET_GRANT, "job": "fj-9999", "hosts": 1,
                 "placement": {"0": 1}})
    with open(jpath, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")

    # without --recover: refuse (non-terminal journaled state)
    with pytest.raises(FleetError):
        FleetDaemon(fleet_dir, slices=1, hosts_per_slice=4,
                    runner=FakeRunner())
    r2 = FakeRunner()
    d2 = FleetDaemon(fleet_dir, slices=1, hosts_per_slice=4, runner=r2,
                     recover=True)
    assert d2.generation == d.generation + 1
    # the running job was adopted (pid alive), hosts re-accounted
    row = _job_row(d2, running)
    assert row["state"] == RUNNING and row["hosts"] == 2
    assert isinstance(d2.jobs[running].handle, _AdoptedHandle)
    # the queued job is still queued, with its original identity
    assert _job_row(d2, queued)["state"] == QUEUED
    # the granted-but-never-started job was re-queued and re-granted on
    # the first tick — zero lost grants
    d2.tick()
    assert _job_row(d2, "fj-9999")["state"] == RUNNING
    assert [os.path.basename(wd) for wd, _, _ in r2.spawned] == ["fj-9999"]
    # zero duplicated grants: the adopted job was NOT respawned
    d2._shutdown()
    # and the whole journal history passes `tony-tpu check`
    from tony_tpu_torch.devtools import invariants

    rep = invariants.check_job_dir(fleet_dir)
    assert rep.ok, invariants.render_text([rep])


def test_recover_marks_dead_unfinished_jobs_failed(tmp_path):
    fleet_dir = str(tmp_path / "fleet")
    d = _daemon(tmp_path)
    job = d.submit("t", 1, conf={})["job"]
    d.tick()
    # the app dir exists (client got that far) but the client pid is
    # dead and history never finalized → recovery post-mortems it
    d.runner.fake_app(job)
    d.journal.close()
    d2 = FleetDaemon(fleet_dir, slices=2, hosts_per_slice=4,
                     runner=FakeRunner(), recover=True)
    row = _job_row(d2, job)
    assert row["state"] == fj.STATE_FAILED
    assert d2.status()["pool"]["used"] == 0        # nothing re-accounted
    d2._shutdown()


# ---------------------------------------------------------------------------
# Invariant rules + checked-in fixtures (the CI check-smoke twins)
# ---------------------------------------------------------------------------
def test_fleet_fixture_golden_passes_and_bad_fails():
    from tony_tpu_torch.devtools import invariants

    golden = invariants.check_job_dir(
        os.path.join(REPO, "tests", "fixtures", "golden_fleetdir"))
    assert golden.ok, invariants.render_text([golden])
    bad = invariants.check_job_dir(
        os.path.join(REPO, "tests", "fixtures", "fleetdir_bad"))
    rules = {v.rule for v in bad.violations}
    assert rules == {"fleet-gen-monotonic", "fleet-unknown-job",
                     "fleet-double-grant", "fleet-terminal",
                     "fleet-capacity", "fleet-decision",
                     "health-quarantine-evidence",
                     "health-dangling-cordon", "alert-journal"}


def test_daemon_lifecycle_artifacts_pass_invariants(tmp_path):
    from tony_tpu_torch.devtools import invariants

    d = _daemon(tmp_path)
    runner = d.runner
    a = d.submit("t", 2, conf={})["job"]
    d.tick()
    runner.handle_for(a).exit = 0
    d.tick()
    d._shutdown()
    reports = invariants.check_tree(str(tmp_path))
    assert reports and all(r.ok for r in reports), \
        invariants.render_text(reports)


# ---------------------------------------------------------------------------
# RPC plane + CLI rendering
# ---------------------------------------------------------------------------
def test_fleet_rpc_round_trip_and_generation_fencing(tmp_path):
    from tony_tpu_torch.fleet.client import FleetClient

    d = _daemon(tmp_path)
    d.start()
    try:
        c = FleetClient(d.fleet_dir)
        res = c.submit("t1", 2, priority=3, model="m",
                       conf={"tony.worker.command": "true"})
        assert res["ok"]
        d.tick()
        st = c.status()
        assert st["generation"] == d.generation
        row = next(r for r in st["jobs"] if r["job"] == res["job"])
        assert row["state"] == RUNNING and row["tenant"] == "t1"
        assert c.cancel("nope")["ok"] is False
        c.close()
    finally:
        d.request_stop()
        d._shutdown()


def test_render_fleet_top_frame(tmp_path):
    from tony_tpu_torch.cli.main import _render_fleet_top

    d = _daemon(tmp_path, quotas="capped=2")
    d.submit("capped", 2, conf={})
    d.tick()
    frame = _render_fleet_top(d.status())
    assert "hosts: 2/8 used" in frame
    assert "capped=2/2" in frame
    assert "RUNNING" in frame
    d._shutdown()


def test_fleet_status_and_prom_files_are_the_portal_sources(tmp_path):
    """The portal's /fleet view reads the daemon's fleet.status.json and
    fleet.prom: both are written, the status file is the snapshot ``fleet
    status`` renders, and the port's portal (the fleet dir discovered from
    the history root inside it) serves them at /fleet, linked from the
    jobs index."""
    import urllib.request

    from tony_tpu_torch.portal.server import PortalServer

    d = _daemon(tmp_path)
    d.submit("t1", 2, conf={})
    d.tick()
    d._shutdown()
    with open(os.path.join(d.fleet_dir, constants.FLEET_STATUS_FILE)) as f:
        snap = json.load(f)
    assert snap["pool"]["total"] == 8
    assert snap["jobs"][0]["state"] == RUNNING
    assert snap["jobs"][0]["tenant"] == "t1"
    with open(os.path.join(d.fleet_dir, constants.FLEET_PROM_FILE)) as f:
        prom = f.read()
    assert "tony_fleet_hosts" in prom

    os.makedirs(d.history_root, exist_ok=True)
    srv = PortalServer(d.history_root, port=0)
    assert srv.fleet_dir == d.fleet_dir
    srv.start()
    try:
        with urllib.request.urlopen(f"{srv.url}/fleet?format=json") as r:
            assert json.load(r) == snap
        with urllib.request.urlopen(f"{srv.url}/fleet") as r:
            body = r.read().decode()
        assert "tony_fleet_hosts" in body and "t1" in body
        with urllib.request.urlopen(srv.url) as r:
            assert "/fleet" in r.read().decode()
    finally:
        srv.stop()


def test_policy_self_check_runs_clean():
    from tony_tpu_torch.fleet import policy

    policy._self_check()


# ---------------------------------------------------------------------------
# Simultaneous-crash window: daemon SIGKILLed between a victim's preempt
# resize RPC and the journal record of it. --recover must reconcile the
# victim's ACTUAL gang size (from its own session journal) instead of
# double-granting the reclaimed hosts — or losing them forever.
# ---------------------------------------------------------------------------
def _sigkill_daemon_with_live_pids(d, fleet_dir):
    """The SIGKILL shape: drop the daemon with no shutdown, then pin
    every journaled client pid to a live one so recovery adopts."""
    d.journal.close()
    jpath = os.path.join(fleet_dir, constants.FLEET_JOURNAL_FILE)
    recs = [json.loads(line) for line in open(jpath)]
    for r in recs:
        if r.get("t") == fj.REC_FLEET_STATE and r.get("pid"):
            r["pid"] = os.getpid()
    with open(jpath, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")


def _write_victim_session_journal(workdir, app_id, members_applied):
    """Materialize the victim coordinator's own write-ahead journal
    showing a resize that LANDED (phase applied) while the fleet daemon
    was dead."""
    from tony_tpu_torch.coordinator import journal as cjournal

    job_dir = os.path.join(workdir, "jobs", app_id)
    os.makedirs(job_dir, exist_ok=True)
    vj = cjournal.SessionJournal(
        os.path.join(job_dir, constants.JOURNAL_FILE))
    vj.generation(1)
    vj.app(app_id, 0, "t")
    vj.resize("worker", 1, members_applied, "start", 0, "fleet preempt")
    vj.resize("worker", 1, members_applied, "applied", 0, "fleet preempt")
    vj.close()


def test_recover_completes_unjournaled_preempt_shrink(tmp_path):
    """The resize RPC landed (victim shrank 4->2) but the daemon died
    before journaling the preempt: recovery must free the 2 reclaimed
    hosts and journal the completed shrink — the waiting demander's
    grant then proceeds with no double-booking."""
    fleet_dir = str(tmp_path / "fleet")
    d = _daemon(tmp_path, slices=1, hosts_per_slice=4)
    victim = d.submit("t", 4, min_hosts=1, conf={})["job"]
    d.tick()
    assert _job_row(d, victim)["state"] == RUNNING
    _sigkill_daemon_with_live_pids(d, fleet_dir)
    # the victim's own journal says the gang settled at 2 members
    wd = os.path.join(fleet_dir, "jobs", victim)
    app_id = "app_x_" + victim.replace("-", "_")
    _write_victim_session_journal(wd, app_id, [0, 1])

    r2 = FakeRunner()
    d2 = FleetDaemon(fleet_dir, slices=1, hosts_per_slice=4, runner=r2,
                     recover=True)
    row = _job_row(d2, victim)
    assert row["state"] == RUNNING and row["hosts"] == 2
    assert d2.status()["pool"]["used"] == 2          # NOT 4: hosts freed
    # the completed shrink was journaled write-ahead for the NEXT crash
    recs = [json.loads(line) for line in open(
        os.path.join(fleet_dir, constants.FLEET_JOURNAL_FILE))]
    pre = [r for r in recs if r.get("t") == fj.REC_FLEET_PREEMPT
           and r.get("job") == victim]
    assert pre and pre[-1]["to"] == 2
    # a demander can now be granted the reclaimed hosts — no livelock,
    # no double-grant (pool: 2 used by victim + 2 to the demander)
    dem = d2.submit("t2", 2, conf={})["job"]
    d2.tick()
    assert _job_row(d2, dem)["state"] == RUNNING
    assert d2.status()["pool"]["used"] == 4
    d2._shutdown()
    from tony_tpu_torch.devtools import invariants

    rep = invariants.check_job_dir(fleet_dir)
    assert rep.ok, invariants.render_text([rep])


def test_recover_books_unjournaled_grow_back(tmp_path):
    """The mirror window on the restore path: the grow-back resize
    landed (2->4) but the daemon died before grow_applied/journal —
    recovery must book the extra hosts so they cannot be double-granted."""
    fleet_dir = str(tmp_path / "fleet")
    d = _daemon(tmp_path, slices=1, hosts_per_slice=4)
    victim = d.submit("t", 2, min_hosts=1, conf={})["job"]
    d.tick()
    _sigkill_daemon_with_live_pids(d, fleet_dir)
    wd = os.path.join(fleet_dir, "jobs", victim)
    app_id = "app_x_" + victim.replace("-", "_")
    _write_victim_session_journal(wd, app_id, [0, 1, 2, 3])

    d2 = FleetDaemon(fleet_dir, slices=1, hosts_per_slice=4,
                     runner=FakeRunner(), recover=True)
    row = _job_row(d2, victim)
    assert row["state"] == RUNNING and row["hosts"] == 4
    assert d2.status()["pool"]["used"] == 4
    # a 2-host submit must now WAIT instead of double-granting hosts
    # the grown gang actually occupies
    dem = d2.submit("t2", 2, conf={})["job"]
    d2.tick()
    assert _job_row(d2, dem)["state"] != RUNNING
    d2._shutdown()


def test_recover_mid_drain_resize_completes_via_retry(tmp_path):
    """Daemon dies while the victim is STILL draining (resize start
    journaled by the victim, no applied yet): recovery keeps the
    conservative journaled accounting, and the preempt retries against
    the (now idempotent) resize RPC instead of livelocking."""
    fleet_dir = str(tmp_path / "fleet")
    d = _daemon(tmp_path, slices=1, hosts_per_slice=4)
    victim = d.submit("t", 4, min_hosts=1, conf={})["job"]
    d.tick()
    _sigkill_daemon_with_live_pids(d, fleet_dir)
    wd = os.path.join(fleet_dir, "jobs", victim)
    app_id = "app_x_" + victim.replace("-", "_")
    from tony_tpu_torch.coordinator import journal as cjournal

    job_dir = os.path.join(wd, "jobs", app_id)
    os.makedirs(job_dir, exist_ok=True)
    vj = cjournal.SessionJournal(
        os.path.join(job_dir, constants.JOURNAL_FILE))
    vj.generation(1)
    vj.app(app_id, 0, "t")
    vj.resize("worker", 1, [0, 1], "start", 0, "fleet preempt")   # in flight
    vj.close()

    d2 = FleetDaemon(fleet_dir, slices=1, hosts_per_slice=4,
                     runner=FakeRunner(), recover=True)
    # conservative: the journaled grant stands until the drain lands
    row = _job_row(d2, victim)
    assert row["state"] == RUNNING and row["hosts"] == 4
    assert d2.status()["pool"]["used"] == 4
    d2._shutdown()


def test_resize_rpc_idempotent_at_size():
    """resize_application to the CURRENT size answers ok (no-op), not a
    refusal: at-least-once delivery retries must converge."""
    from tony_tpu_torch.coordinator.elastic import ElasticManager

    class _T:
        def __init__(self, i):
            self.job_name = "worker"
            self.index = i
            self.task_id = f"worker:{i}"
            self.status = types.SimpleNamespace(terminal=False)

    class _S:
        def all_tasks(self):
            return [_T(0), _T(1)]

    from tony_tpu_torch.conf.config import TonyTpuConfig

    conf = TonyTpuConfig()
    conf.set(K.ELASTIC_ENABLED, "true")
    el = ElasticManager(conf)
    el.established = True
    assert el.at_size(2, _S())
    assert not el.at_size(3, _S())
