"""Fast deterministic unit suite for the fleet host-health subsystem
(tony_tpu_torch/fleet/health.py + its daemon/pool/backend wiring): the
failure-attribution score (decay, suspect expiry), the quarantine state
machine incl. probation backoff, the REC_FLEET_HEALTH journal
round-trip (last-wins fold, torn tail), the placement filter, the
preflight-probe self-repair loop, exclude-on-retry at the coordinator
and the tpu-slice backend, sick-slice correlation, SIGKILL + --recover
resuming the cordon set, and the warm pool discarding workers on
cordoned hosts. Everything tier-1-safe — daemon tests drive ``tick()``
by hand over a fake runner. The flaky-host goodput drill against a
quarantine-off twin is the one slow test at the bottom. Select the fast
half with ``pytest -m faults``.
"""

import json
import os
import sys
import types

import pytest

from tony_tpu_torch import constants, faults
from tony_tpu_torch.conf import keys as K
from tony_tpu_torch.events.events import EventType, read_events
from tony_tpu_torch.fleet import health as fhealth
from tony_tpu_torch.fleet import journal as fj
from tony_tpu_torch.fleet.daemon import GRANTED, QUEUED, RUNNING, FleetDaemon

from test_torch_fleet import FakeRunner, _daemon, _job_row

pytestmark = pytest.mark.faults


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.uninstall()
    yield
    faults.uninstall()


# ---------------------------------------------------------------------------
# Registry parity: fault sites, conf family, event types, series
# ---------------------------------------------------------------------------
def test_health_fault_sites_registered():
    for site in ("host.flaky", "health.probe"):
        assert site in faults.SITES
    inj = faults.FaultInjector({"health.probe": "task:s0h0,first:1"})
    assert inj.fire("health.probe", task_id="s0h0")
    assert not inj.fire("health.probe", task_id="s0h1")  # pinned per host
    assert not inj.fire("health.probe", task_id="s0h0")  # first:1 spent


def test_health_conf_family_registered_with_defaults():
    from tony_tpu_torch.conf.config import TonyTpuConfig

    conf = TonyTpuConfig()
    assert conf.get_bool(K.HEALTH_ENABLED, False) is True
    assert float(conf.get(K.HEALTH_HALF_LIFE_S)) == 300.0
    assert float(conf.get(K.HEALTH_SUSPECT_THRESHOLD)) == 1.0
    assert float(conf.get(K.HEALTH_QUARANTINE_THRESHOLD)) == 3.0
    assert float(conf.get(K.HEALTH_QUARANTINE_S)) == 120.0
    assert conf.get_int(K.HEALTH_PROBATION_PRIORITY, -1) == 0
    assert conf.get_int(K.HEALTH_BLAST_N, 0) == 2
    assert float(conf.get(K.HEALTH_BLAST_WINDOW_S)) == 120.0


def test_health_event_types_registered():
    assert EventType.FLEET_HOST_QUARANTINED.value == "FLEET_HOST_QUARANTINED"
    assert EventType.FLEET_HOST_RESTORED.value == "FLEET_HOST_RESTORED"
    assert EventType.FLEET_SLICE_CORDONED.value == "FLEET_SLICE_CORDONED"


# ---------------------------------------------------------------------------
# HostBook: score, state machine, canaries (no daemon)
# ---------------------------------------------------------------------------
def test_score_decays_and_suspect_expires():
    book = fhealth.HostBook(2, 4, fhealth.HealthConfig(half_life_s=10.0))
    # a single straggler flag (weight 0.5) accumulates silently
    assert book.record_failure("s0h0", "straggler", "fj-1", now=1.0) == []
    assert book.hosts["s0h0"].state == fhealth.HEALTHY
    recs = book.record_failure("s0h0", "straggler", "fj-1", now=1.0)
    assert recs and recs[-1]["state"] == fhealth.SUSPECT
    # two half-lives later the score has decayed to ~0.25 — tick()
    # restores the host and says why in the journal-ready record
    recs, sick = book.tick(now=21.0)
    assert not sick
    assert book.hosts["s0h0"].state == fhealth.HEALTHY
    assert book.hosts["s0h0"].score < 0.3
    assert recs[-1]["host"] == "s0h0" and recs[-1]["state"] == fhealth.HEALTHY


def test_quarantine_rolls_to_probation_and_backoff_doubles_cooldown():
    book = fhealth.HostBook(1, 4, fhealth.HealthConfig(
        half_life_s=1e9, quarantine_threshold=1.5, quarantine_s=10.0))
    book.record_failure("s0h1", "INFRA_TRANSIENT", "fj-1", now=1.0)
    recs = book.record_failure("s0h1", "INFRA_TRANSIENT", "fj-2", now=2.0)
    assert recs[-1]["state"] == fhealth.QUARANTINED
    assert recs[-1]["was_free"] is True        # free slot cordons NOW
    assert "s0h1" not in book.free_hosts(0)
    # cooldown not yet served: still behind the fence
    book.tick(now=5.0)
    assert book.hosts["s0h1"].state == fhealth.QUARANTINED
    # cooldown expired: probation, awaiting a canary
    recs, _ = book.tick(now=12.5)
    assert book.hosts["s0h1"].state == fhealth.PROBATION
    assert "awaiting canary" in recs[-1]["reason"]
    # a probationer that fails again waits TWICE as long
    recs = book.record_failure("s0h1", "INFRA_TRANSIENT", "fj-3", now=13.0)
    assert recs[-1]["state"] == fhealth.QUARANTINED
    assert book.hosts["s0h1"].cooldown_s == 20.0


def test_user_error_is_never_attributed():
    book = fhealth.HostBook(1, 2)
    with pytest.raises(AssertionError):
        book.record_failure("s0h0", "USER_ERROR", "fj-1", now=1.0)
    # evidence ledger stays empty — a user bug says nothing about the host
    assert book.hosts["s0h0"].evidence == []


def test_probation_canary_rides_low_priority_and_resolves_on_release():
    cfg = fhealth.HealthConfig(quarantine_s=1.0, probation_priority=0,
                               half_life_s=1e9)
    book = fhealth.HostBook(1, 4, cfg)
    book.cordon("s0h0", "probe failed", now=1.0, kind="probe")
    book.tick(now=3.0)
    assert book.hosts["s0h0"].state == fhealth.PROBATION
    # a high-priority gang never carries the canary
    hosts, canaries = book.assign("fj-hi", {0: 2}, priority=5, now=3.0)
    assert "s0h0" not in hosts and canaries == []
    book.release("fj-hi", now=3.1)
    # a preemptible gang swaps in AT MOST one probationer per slice
    hosts, canaries = book.assign("fj-lo", {0: 2}, priority=0, now=3.5)
    assert "s0h0" in hosts
    assert len(canaries) == 1 and canaries[0]["canary"] is True
    # clean canary: fully restored, back in the free pool
    _, recs = book.release("fj-lo", now=4.0, failed=False)
    assert book.hosts["s0h0"].state == fhealth.HEALTHY
    assert "s0h0" in book.free_hosts(0)
    assert any(r["host"] == "s0h0" and r["state"] == fhealth.HEALTHY
               for r in recs)


def test_failed_canary_requarantines_with_backoff():
    cfg = fhealth.HealthConfig(quarantine_s=1.0, probation_priority=0,
                               half_life_s=1e9)
    book = fhealth.HostBook(1, 4, cfg)
    book.cordon("s0h0", "probe failed", now=1.0, kind="probe")
    book.tick(now=3.0)
    hosts, _ = book.assign("fj-c", {0: 2}, priority=0, now=3.5)
    assert "s0h0" in hosts
    newly, recs = book.release("fj-c", now=4.0, failed=True)
    assert book.hosts["s0h0"].state == fhealth.QUARANTINED
    assert book.hosts["s0h0"].cooldown_s == 2.0      # doubled
    assert newly == {0: 1}                           # slot leaves service
    assert "s0h0" not in book.free_hosts(0)


def test_sick_slice_correlation_cordons_the_whole_slice():
    cfg = fhealth.HealthConfig(half_life_s=1e9, suspect_threshold=0.9,
                               blast_n=2, blast_window_s=60.0)
    book = fhealth.HostBook(2, 4, cfg)
    # two DISTINCT hosts of slice 0 go suspect inside the window
    book.record_failure("s0h0", "INFRA_TRANSIENT", "fj-1", now=1.0,
                        ts_ms=1000)
    book.record_failure("s0h1", "INFRA_TRANSIENT", "fj-2", now=2.0,
                        ts_ms=2000)
    recs, sick = book.tick(now=3.0)
    assert sick == [0] and book.sick_slices == [0]
    cordoned = set(book.cordoned_names())
    assert {"s0h0", "s0h1", "s0h2", "s0h3"} <= cordoned
    assert not any(h.startswith("s1") for h in cordoned)  # blast stays local
    assert book.free_hosts(0) == []
    # every slice-cordon record is self-evidencing
    for rec in recs:
        if rec.get("state") == fhealth.QUARANTINED:
            assert rec["evidence"], rec


# ---------------------------------------------------------------------------
# Journal round-trip: write-ahead fhealth records, last-wins, torn tail
# ---------------------------------------------------------------------------
def test_health_journal_roundtrip_last_wins_and_torn_tail(tmp_path):
    path = str(tmp_path / constants.FLEET_JOURNAL_FILE)
    j = fj.FleetJournal(path)
    j.health({"host": "s0h2", "slice": 0, "state": fhealth.QUARANTINED,
              "score": 3.2, "reason": "score over threshold",
              "manual": False, "cooldown_s": 120.0,
              "evidence": [{"ts": 1, "kind": "INFRA_TRANSIENT",
                            "job": "fj-1"}]})
    j.health({"host": "s0h2", "slice": 0, "state": fhealth.PROBATION,
              "score": 3.2, "reason": "cooldown expired",
              "manual": False, "cooldown_s": 120.0, "evidence": []})
    j.health({"host": "s1h0", "slice": 1, "state": fhealth.QUARANTINED,
              "score": 0.0, "reason": "operator cordon", "manual": True,
              "cooldown_s": 120.0,
              "evidence": [{"ts": 2, "kind": "manual", "job": ""}]})
    j.close()
    st = fj.replay(path)
    assert st.health["s0h2"]["state"] == fhealth.PROBATION  # last wins
    assert st.health["s1h0"]["manual"] is True
    # a torn tail (SIGKILL mid-append) replays as the clean prefix
    with open(path, "ab") as f:
        f.write(b'{"t": "fhealth", "host": "s1h3", "sta')
    st2 = fj.replay(path)
    assert st2.health["s0h2"]["state"] == fhealth.PROBATION
    assert "s1h3" not in st2.health
    # folding into a fresh book restores state + cordon accounting
    book = fhealth.HostBook(2, 4)
    for host in st2.health:
        book.apply_record(st2.health[host], now=1.0)
    assert book.hosts["s0h2"].state == fhealth.PROBATION
    assert book.hosts["s1h0"].state == fhealth.QUARANTINED
    assert book.resync_free() == {0: 1, 1: 1}
    assert "s0h2" not in book.free_hosts(0)


# ---------------------------------------------------------------------------
# Daemon wiring: placement filter, probe self-repair, recover
# ---------------------------------------------------------------------------
def test_operator_cordon_filters_placement_and_uncordon_restores(tmp_path):
    d = _daemon(tmp_path)
    res = d.cordon("s0h0", reason="smoke on the PSU")
    assert res["ok"] and res["was_free"]
    assert d.status()["pool"]["cordoned"] == 1
    assert d.status()["health"]["cordoned"] == ["s0h0"]
    # a 4-host gang no longer fits on slice 0 (3 free) — it lands whole
    # on slice 1, never touching the cordoned host
    jid = d.submit("t", 4, conf={})["job"]
    d.tick()
    job = d.jobs[jid]
    assert job.state == RUNNING
    assert "s0h0" not in job.host_ids
    assert all(h.startswith("s1") for h in job.host_ids)
    # a manual cordon never auto-expires — ticks don't touch it
    d.tick()
    assert d.book.hosts["s0h0"].state == fhealth.QUARANTINED
    assert d.uncordon("s0h0")["ok"]
    assert d.status()["pool"]["cordoned"] == 0
    assert d.book.hosts["s0h0"].state == fhealth.HEALTHY
    d._shutdown()
    evs = [e.type for e in read_events(
        os.path.join(d.fleet_dir, constants.FLEET_EVENTS_FILE))]
    assert EventType.FLEET_HOST_QUARANTINED in evs
    assert EventType.FLEET_HOST_RESTORED in evs


def test_preflight_probe_failure_self_repairs_the_grant(tmp_path):
    faults.install(faults.FaultInjector({"health.probe": "task:s0h0,first:1"}))
    d = _daemon(tmp_path)
    jid = d.submit("t", 2, min_hosts=1, conf={})["job"]
    d.tick()
    job = d.jobs[jid]
    # the grant self-repaired: the probe cordoned s0h0 and a spare was
    # substituted — the job never saw the failure
    assert job.state == RUNNING and len(job.host_ids) == 2
    assert "s0h0" not in job.host_ids
    h = d.book.hosts["s0h0"]
    assert h.state == fhealth.QUARANTINED
    assert any(e["kind"] == "probe" for e in h.evidence)
    d._shutdown()
    # write-ahead: the probe cordon is journaled, and before the grant
    recs = [json.loads(line) for line in open(
        os.path.join(d.fleet_dir, constants.FLEET_JOURNAL_FILE))]
    probe_at = next(i for i, r in enumerate(recs)
                    if r.get("t") == fj.REC_FLEET_HEALTH
                    and r.get("host") == "s0h0")
    grant_at = next(i for i, r in enumerate(recs)
                    if r.get("t") == fj.REC_FLEET_GRANT)
    assert probe_at < grant_at


def test_preflight_probe_passes_on_a_healthy_host(tmp_path):
    assert fhealth.preflight_probe("s0h0", str(tmp_path / "probe")) is None
    assert not os.listdir(tmp_path / "probe")   # scratch file cleaned up


def test_sigkilled_daemon_recovers_the_same_cordon_set(tmp_path):
    fleet_dir = str(tmp_path / "fleet")
    d = _daemon(tmp_path)
    assert d.cordon("s0h0", reason="ops")["ok"]
    assert d.cordon("s1h2", reason="flaky fan")["ok"]
    # SIGKILL shape: no shutdown, just the journal handle dropped
    d.journal.close()
    d2 = FleetDaemon(fleet_dir, slices=2, hosts_per_slice=4,
                     runner=FakeRunner(), recover=True)
    assert d2.book.cordoned_names() == ["s0h0", "s1h2"]
    assert d2.status()["pool"]["cordoned"] == 2
    assert d2.book.hosts["s0h0"].manual is True   # survives as manual
    assert "s0h0" not in d2.book.free_hosts(0)
    # the recovered cordon still shapes placement
    jid = d2.submit("t", 4, conf={})["job"]
    d2.tick()
    assert "s0h0" not in d2.jobs[jid].host_ids
    d2._shutdown()


# ---------------------------------------------------------------------------
# Exclude-on-retry: coordinator bookkeeping + backend rotation skip
# ---------------------------------------------------------------------------
def test_coordinator_records_infra_hosts_but_never_user_error():
    from tony_tpu_torch.coordinator.coordinator import Coordinator
    from tony_tpu_torch.coordinator.session import FailureDomain

    fake = types.SimpleNamespace(
        backend=types.SimpleNamespace(host_of=lambda tid: "hostA"),
        _failed_hosts={})
    Coordinator._record_failed_host(fake, "worker:0",
                                    FailureDomain.USER_ERROR)
    assert fake._failed_hosts == {}       # a code bug blacklists nothing
    Coordinator._record_failed_host(fake, "worker:0",
                                    FailureDomain.INFRA_TRANSIENT)
    Coordinator._record_failed_host(fake, "worker:0",
                                    FailureDomain.INFRA_TRANSIENT)
    assert fake._failed_hosts == {"worker:0": ["hostA"]}  # deduped


def test_backend_rotation_skips_excluded_hosts_best_effort(tmp_path):
    from tony_tpu_torch.cluster.base import TaskLaunchSpec
    from tony_tpu_torch.cluster.gpu import FakeSliceProvisioner, GpuHostBackend

    def spec(i, exclude=()):
        return TaskLaunchSpec(
            task_id=f"worker:{i}", job_name="worker", index=i,
            command="true", exclude_hosts=tuple(exclude),
            env={constants.COORDINATOR_HOST: "127.0.0.1",
                 constants.COORDINATOR_PORT: "1",
                 constants.JOB_NAME: "worker", constants.TASK_INDEX: str(i)})

    prov = FakeSliceProvisioner(2, str(tmp_path / "hosts"))
    backend = GpuHostBackend(prov, 2, str(tmp_path / "work"),
                              python=sys.executable)
    try:
        # the retry that already failed on fakehost-0 is steered off it
        h = backend.launch_task(spec(0, exclude=["fakehost-0"]))
        assert h.host.host_id == "fakehost-1"
        # every lease host excluded: the plain rotation wins — a
        # relaunch beats no launch
        h2 = backend.launch_task(
            spec(1, exclude=["fakehost-0", "fakehost-1"]))
        assert h2.host.host_id in ("fakehost-0", "fakehost-1")
    finally:
        backend.stop()


# ---------------------------------------------------------------------------
# Warm pool: workers on cordoned hosts are never leased, discarded on sight
# ---------------------------------------------------------------------------
def _pool_worker(tmp_path, wid, host, pid):
    from tony_tpu_torch.pool import ADOPTED_FILE, READY_FILE, _Worker

    wdir = str(tmp_path / "workers" / wid)
    os.makedirs(wdir, exist_ok=True)
    with open(os.path.join(wdir, READY_FILE), "w") as f:
        json.dump({"pid": pid, "preloaded": [], "host": host}, f)
    with open(os.path.join(wdir, ADOPTED_FILE), "w") as f:
        json.dump({"pid": pid}, f)
    popen = types.SimpleNamespace(poll=lambda: None, pid=pid,
                                  returncode=None)
    return _Worker(wid, wdir, popen)


def test_pool_lease_discards_workers_on_cordoned_hosts(tmp_path):
    from tony_tpu_torch.pool import PoolDaemon, PoolError

    fhealth.write_cordon_file(
        str(tmp_path / constants.FLEET_CORDON_FILE),
        {"s0h1": fhealth.QUARANTINED})
    # fake pids near pid_max: _kill_worker's killpg cannot hit anything
    w1 = _pool_worker(tmp_path, "w1", "s0h1", 3999991)
    w2 = _pool_worker(tmp_path, "w2", "s1h0", 3999992)
    d = PoolDaemon(str(tmp_path), size=2, preload="")
    d._workers[w1.id] = w1
    d._workers[w2.id] = w2
    res = d.lease("worker:0", {}, str(tmp_path / "t"))
    assert res["worker_id"] == "w2"        # the healthy host wins
    assert "w1" not in d._workers          # sick worker discarded on sight
    # only cordoned warmth left: the refusal names the discard so the
    # caller's cold-spawn fallback is explainable
    w3 = _pool_worker(tmp_path, "w3", "s0h1", 3999993)
    d._workers[w3.id] = w3
    with pytest.raises(PoolError, match="health-cordoned.*s0h1"):
        d.lease("worker:1", {}, str(tmp_path / "t2"))
    assert "w3" not in d._workers


def test_pool_lease_ignores_absent_or_torn_cordon_file(tmp_path):
    from tony_tpu_torch.pool import PoolDaemon

    w = _pool_worker(tmp_path, "w1", "s0h1", 3999994)
    d = PoolDaemon(str(tmp_path), size=1, preload="")
    d._workers[w.id] = w
    # no fleet, no cordon file: nothing is cordoned
    assert d.lease("worker:0", {}, str(tmp_path / "t"))["worker_id"] == "w1"
    w.leased_to = ""
    # a torn file reads as empty, not as "everything cordoned"
    with open(tmp_path / constants.FLEET_CORDON_FILE, "w") as f:
        f.write('{"schema": 1, "hos')
    assert d.lease("worker:1", {}, str(tmp_path / "t2"))["worker_id"] == "w1"


# ---------------------------------------------------------------------------
# Slow: the flaky-host goodput drill vs a quarantine-off twin
# ---------------------------------------------------------------------------
class _DrillHandle:
    def __init__(self, pid):
        self.pid = pid
        self.returncode = None

    def poll(self):
        return self.returncode


class _DrillRunner:
    """FakeRunner variant whose handles expose ``returncode`` so the
    daemon's host.flaky drill feed can terminalize killed jobs."""

    def __init__(self):
        self.spawned = []
        self.killed = []
        self._next_pid = 2000

    def spawn(self, workdir, overrides):
        os.makedirs(workdir, exist_ok=True)
        self._next_pid += 1
        h = _DrillHandle(self._next_pid)
        self.spawned.append((workdir, overrides, h))
        return h

    def poll(self, handle):
        return handle.poll()

    def resize(self, workdir, size):
        return True

    def migrate(self, workdir, target):
        return True

    def kill(self, workdir):
        self.killed.append(workdir)
        return True


@pytest.mark.slow
def test_flaky_host_drill_quarantine_beats_disabled_twin(tmp_path):
    """20-job mix against a host that kills everything placed on it:
    with quarantine on, the fleet eats ~2 failures, cordons s0h0, and
    every later grant routes around it (journal-proven); the twin with
    quarantine effectively off keeps feeding jobs to the bad host and
    finishes measurably fewer of them in the same tick budget."""

    def drill(root, quarantine_threshold):
        faults.uninstall()
        faults.install(faults.FaultInjector(
            {"host.flaky": "task:s0h0,prob:1.0"}))
        # threshold 1e9 = attribution and kills still run, but the
        # cordon never fires (enabled=False would also disable the
        # drill feed itself, which would not be a fair twin)
        hcfg = fhealth.HealthConfig(half_life_s=3600.0,
                                    quarantine_threshold=quarantine_threshold,
                                    quarantine_s=3600.0)
        runner = _DrillRunner()
        d = FleetDaemon(str(root), slices=2, hosts_per_slice=4,
                        runner=runner, tick_s=0.05, health_conf=hcfg)
        submitted = 0
        age = {}
        try:
            for _ in range(60):
                with d._lock:
                    alive = sum(1 for j in d.jobs.values()
                                if j.state in (QUEUED, GRANTED, RUNNING))
                while submitted < 20 and alive < 6:
                    d.submit(f"tenant-{submitted % 3}", 2, min_hosts=1,
                             conf={})
                    submitted += 1
                    alive += 1
                d.tick()
                # survivors complete clean after two ticks of running —
                # unless the flaky drill killed them first
                with d._lock:
                    running = [(j.req.job_id, j.handle)
                               for j in d.jobs.values()
                               if j.state == RUNNING and j.handle]
                for jid, handle in running:
                    age[jid] = age.get(jid, 0) + 1
                    if age[jid] >= 2 and handle.returncode is None:
                        handle.returncode = 0
        finally:
            d._shutdown()
        rows = d.status()["jobs"]
        clean = sum(1 for r in rows
                    if r["state"] == fj.STATE_FINISHED and r["exit"] == 0)
        recs = [json.loads(line) for line in open(
            os.path.join(str(root), constants.FLEET_JOURNAL_FILE))]
        return d, runner, clean, recs

    d_on, run_on, clean_on, recs_on = drill(tmp_path / "on",
                                            quarantine_threshold=2.0)
    d_off, run_off, clean_off, recs_off = drill(tmp_path / "off",
                                                quarantine_threshold=1e9)

    # the health-on fleet cordoned the seeded host...
    assert d_on.book.hosts["s0h0"].state in fhealth.CORDONED_STATES
    cordon_at = next(i for i, r in enumerate(recs_on)
                     if r.get("t") == fj.REC_FLEET_HEALTH
                     and r.get("host") == "s0h0"
                     and r.get("state") == fhealth.QUARANTINED)
    # ...and journal-proven: ZERO post-quarantine grants touch it, while
    # placements kept flowing around it
    after = [r for r in recs_on[cordon_at:]
             if r.get("t") == fj.REC_FLEET_GRANT]
    assert after, "fleet wedged after the cordon"
    assert not [r for r in after if "s0h0" in (r.get("host_ids") or [])]
    # no USER_ERROR ever entered the evidence ledger
    for r in recs_on:
        if r.get("t") == fj.REC_FLEET_HEALTH:
            assert not [e for e in (r.get("evidence") or [])
                        if e.get("kind") == "USER_ERROR"]

    # the twin never cordoned, kept placing onto the bad host, and paid
    assert d_off.book.cordoned_names() == []
    assert [r for r in recs_off if r.get("t") == fj.REC_FLEET_GRANT
            and "s0h0" in (r.get("host_ids") or [])]
    assert len(run_off.killed) > len(run_on.killed)
    assert clean_on > clean_off
