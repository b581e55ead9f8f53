"""Execute chaos schedules against the in-process control plane.

Four suites, all subprocess-free so a 200-schedule sweep fits in
minutes, and all REAL control-plane code paths — real RPC frames over
real TCP, real write-ahead journals on real disk, real policy engine:

``e2e``
    One :class:`Coordinator` over a virtual gang (executor/virtual.py):
    4 beat-only tasks self-finish after ``run_s`` through the ordinary
    result path while the schedule storms transport, disk and hosts.
``migrate``
    The e2e substrate, plus a live ``migrate_application`` issued the
    moment the gang establishes — the storm lands on a gang mid-move.
``fleet``
    One :class:`FleetDaemon` over an in-process fake job runner: a
    seeded multi-tenant workload (submits, completions) ticks through
    grant/preempt storms, slice reclaims and journal disk faults.
``health``
    The fleet substrate with ONE seeded flaky host (``host.flaky``
    pinned by name) plus probe/journal noise: the ladder demands the
    failure-attribution ledger quarantines the host, every later grant
    routes around it (journal-proven), fresh jobs still drain, and no
    USER_ERROR ever enters the evidence ledger.

The runner OWNS the global fault injector for the run's duration
(install before, uninstall in finally) and climbs the oracle ladder
afterwards. A schedule that stalls past its deadline is itself a
ladder violation — a chaos storm may fail a job, but it must never
wedge the control plane.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Optional

from tony_tpu_torch import constants, faults
from tony_tpu_torch.chaos import oracle
from tony_tpu_torch.chaos.oracle import Outcome, Violation
from tony_tpu_torch.chaos.schedule import Schedule, fault_seed

log = logging.getLogger(__name__)

#: wall-clock budget per schedule: generous enough for a full retry
#: ladder (seeded backoff), tight enough that a wedged run is a finding.
DEADLINE_S = 90.0


# ---------------------------------------------------------------------------
# e2e / migrate: coordinator over a virtual gang
# ---------------------------------------------------------------------------
def _coord_conf(workers: int = 4, run_s: float = 1.0):
    from tony_tpu_torch.conf import keys as K
    from tony_tpu_torch.conf.config import TonyTpuConfig

    conf = TonyTpuConfig()
    conf.set("tony.worker.instances", workers)
    conf.set("tony.worker.command", "virtual")
    conf.set(K.SCALE_VIRTUAL_EXECUTORS, True)
    conf.set(K.SCALE_VIRTUAL_RUN_S, run_s)
    conf.set(K.TASK_HEARTBEAT_INTERVAL_MS, 150)
    conf.set(K.COORDINATOR_MONITOR_INTERVAL_MS, 50)
    conf.set(K.APPLICATION_NUM_CLIENTS_TO_WAIT, False)
    conf.set(K.DIAGNOSIS_ENABLED, False)
    # Elastic on: host.loss storms shrink-and-continue (the production
    # absorption path) instead of burning a whole epoch per death.
    conf.set(K.ELASTIC_ENABLED, True)
    conf.set(K.ELASTIC_MIN_TASKS, 1)
    conf.set(K.ELASTIC_DRAIN_GRACE_S, 5)
    conf.set(K.ELASTIC_BARRIER_TIMEOUT_S, 20)
    return conf


def _run_coordinator_suite(schedule: Schedule, workdir: str,
                           migrate: bool) -> Outcome:
    from tony_tpu_torch.cluster.local import VirtualExecutorBackend
    from tony_tpu_torch.coordinator.coordinator import Coordinator

    app_id = f"chaos_{schedule.suite}_{schedule.index:06d}"
    conf = _coord_conf()
    backend = VirtualExecutorBackend.from_conf(
        conf, os.path.join(workdir, "work"))
    history = os.path.join(workdir, "history")
    outcome = Outcome()
    crash: list = []

    coord = Coordinator(conf, app_id, backend, history, user="chaos")

    def _run() -> None:
        try:
            coord.run()
        except BaseException as e:  # noqa: BLE001 — a crash IS a finding
            crash.append(e)

    runner = threading.Thread(target=_run, daemon=True,
                              name=f"chaos-coord-{schedule.index}")
    runner.start()
    deadline = time.monotonic() + DEADLINE_S
    try:
        if migrate:
            # Fire the move the moment the gang establishes; if the
            # storm kills establishment first, the migrate is skipped —
            # the schedule still exercised the launch path.
            while time.monotonic() < deadline:
                if coord.session.status.value in ("FAILED", "KILLED",
                                                  "SUCCEEDED"):
                    break
                if coord.elastic.established \
                        and not coord.elastic.resizing:
                    try:
                        coord.migrate_application("slice-1",
                                                  reason="chaos drill")
                    except Exception as e:  # noqa: BLE001
                        log.info("chaos migrate refused: %s", e)
                    break
                time.sleep(0.05)
        while time.monotonic() < deadline:
            if not runner.is_alive():
                break
            time.sleep(0.05)
    finally:
        stalled = runner.is_alive()
        if stalled:
            try:
                coord.request_stop("chaos deadline")
            except Exception:  # noqa: BLE001
                pass
            runner.join(timeout=15)
        if runner.is_alive():
            outcome.violations.append(Violation(
                "verdict", f"run wedged: coordinator still alive "
                           f"{DEADLINE_S:.0f}s past launch and deaf to "
                           f"request_stop"))
            # last-resort teardown so the sweep can continue
            try:
                coord.rpc._server.server_close()
            except Exception:  # noqa: BLE001
                pass
        try:
            backend.stop()
        except Exception:  # noqa: BLE001
            pass

    status = coord.session.status.value
    domain = (coord.session.failure_domain.value
              if coord.session.failure_domain else "")
    outcome.status = status
    outcome.failure_domain = domain
    if crash:
        outcome.detail = f"coordinator crashed: {crash[0]!r}"
        if status not in ("SUCCEEDED", "FAILED", "KILLED"):
            outcome.violations.append(Violation(
                "verdict", f"coordinator thread died on unhandled "
                           f"{crash[0]!r} with the session left "
                           f"{status}"))
    return outcome


# ---------------------------------------------------------------------------
# fleet: daemon over an in-process runner
# ---------------------------------------------------------------------------
class _ChaosHandle:
    def __init__(self, pid: int) -> None:
        self.pid = pid
        self.exit: Optional[int] = None

    def poll(self) -> Optional[int]:
        return self.exit


class _ChaosRunner:
    """SubprocessJobRunner stand-in (the tests' FakeRunner shape): no
    processes, handles exit on command — the chaos workload script
    completes jobs between ticks."""

    def __init__(self) -> None:
        self.handles = {}
        self._next_pid = 40000

    def spawn(self, workdir: str, overrides: dict) -> _ChaosHandle:
        os.makedirs(workdir, exist_ok=True)
        self._next_pid += 1
        h = _ChaosHandle(self._next_pid)
        self.handles[os.path.basename(workdir)] = h
        return h

    def poll(self, handle: _ChaosHandle) -> Optional[int]:
        return handle.poll()

    def resize(self, workdir: str, size: int) -> bool:
        return True

    def migrate(self, workdir: str, target: str) -> bool:
        return True

    def kill(self, workdir: str) -> bool:
        h = self.handles.get(os.path.basename(workdir))
        if h is not None and h.exit is None:
            h.exit = 143
        return True


def _run_fleet_suite(schedule: Schedule, workdir: str) -> Outcome:
    import random

    from tony_tpu_torch.fleet.daemon import FleetDaemon, RUNNING
    from tony_tpu_torch.utils.durable import DurableWriteError

    outcome = Outcome()
    fleet_dir = os.path.join(workdir, "fleet")
    runner = _ChaosRunner()
    daemon = FleetDaemon(fleet_dir, slices=2, hosts_per_slice=4,
                         quotas="", runner=runner, tick_s=0.05)
    # The WORKLOAD is seeded like the faults: same schedule, same
    # submit/complete script, tick for tick.
    rng = random.Random(f"workload:{fault_seed(schedule.seed, schedule.index)}")
    submits = [("tenant-" + str(rng.randint(0, 2)),
                rng.choice((1, 2, 4)), rng.randint(0, 2))
               for _ in range(rng.randint(3, 6))]
    ticks = 40
    journal_dead = False
    try:
        for tick_no in range(ticks):
            if daemon.journal.dead is not None:
                journal_dead = True
                break
            while submits and rng.random() < 0.4:
                tenant, hosts, prio = submits.pop()
                daemon.submit(tenant, hosts, priority=prio,
                              min_hosts=1, conf={})
            try:
                daemon.tick()
            except DurableWriteError:
                journal_dead = True
                break
            except Exception as e:  # noqa: BLE001 — run() survives these
                if daemon.journal.dead is not None:
                    journal_dead = True
                    break
                log.info("chaos fleet tick error (absorbed): %s", e)
            # Complete a running job now and then: churn admits the
            # next queued tenant and exercises release accounting.
            if rng.random() < 0.2:
                with daemon._lock:
                    running = [j for j in daemon.jobs.values()
                               if j.state == RUNNING]
                if running:
                    victim = rng.choice(running)
                    h = runner.handles.get(victim.req.job_id)
                    if h is not None and h.exit is None:
                        h.exit = 0
    finally:
        try:
            daemon._shutdown()
        except Exception:  # noqa: BLE001
            pass

    if journal_dead:
        # The documented degrade: stop loudly, point at --recover.
        outcome.status = "FAILED"
        outcome.failure_domain = "INFRA_TRANSIENT"
        outcome.detail = f"fleet journal dead: {daemon.journal.dead}"
    else:
        outcome.status = "SUCCEEDED"
        # Accounting must balance: pool used == sum of RUNNING grants.
        st = daemon.status()
        booked = sum(j["hosts"] for j in st["jobs"]
                     if j["state"] == RUNNING)
        if st["pool"]["used"] != booked:
            outcome.violations.append(Violation(
                "verdict", f"pool accounting skew: used="
                           f"{st['pool']['used']} but RUNNING grants "
                           f"book {booked}"))
    return outcome


# ---------------------------------------------------------------------------
# health: daemon over an in-process runner with one seeded flaky host
# ---------------------------------------------------------------------------
def _flaky_host_of(schedule: Schedule) -> str:
    for inj in schedule.injections:
        if inj.site == "host.flaky":
            for part in inj.spec.split(","):
                if part.startswith("task:"):
                    return part[len("task:"):]
    return ""


def _run_health_suite(schedule: Schedule, workdir: str) -> Outcome:
    """The flaky-host drill: the schedule pins ``host.flaky`` to one
    host; the ladder demands (a) the ledger quarantines that host, (b)
    every grant journaled after the cordon routes around it, (c) jobs
    submitted after the cordon still drain, and (d) no USER_ERROR ever
    enters the evidence ledger — an infra-only storm must never be
    pinned on the user."""
    import random

    from tony_tpu_torch.fleet import health as fhealth
    from tony_tpu_torch.fleet import journal as fjournal
    from tony_tpu_torch.fleet.daemon import GRANTED, QUEUED, RUNNING, \
        FleetDaemon
    from tony_tpu_torch.utils.durable import DurableWriteError

    outcome = Outcome()
    flaky = _flaky_host_of(schedule)
    fleet_dir = os.path.join(workdir, "fleet")
    runner = _ChaosRunner()
    # Tight thresholds so the drill converges inside the tick budget:
    # two attributed kills quarantine the host; the long half-life and
    # cooldown keep the cordon from decaying or re-admitting mid-run.
    hcfg = fhealth.HealthConfig(half_life_s=3600.0,
                                suspect_threshold=1.0,
                                quarantine_threshold=2.0,
                                quarantine_s=3600.0)
    daemon = FleetDaemon(fleet_dir, slices=2, hosts_per_slice=4,
                         quotas="", runner=runner, tick_s=0.05,
                         health_conf=hcfg)
    rng = random.Random(
        f"workload:{fault_seed(schedule.seed, schedule.index)}")
    # Saturating workload: until the cordon lands, keep enough
    # shrink-to-fit 2-host gangs in flight that EVERY free host (the
    # flaky one included) hosts work each round — attribution becomes
    # a matter of ticks, not placement luck. Small gangs on purpose: a
    # 4-host gang cannot pack once each slice carries a cordon, and
    # the policy's head-of-line hold would then (correctly, but
    # uninterestingly for THIS drill) wedge the queue behind it.
    journal_dead = False

    def _tick() -> bool:
        """One daemon tick; False when the journal died."""
        nonlocal journal_dead
        if daemon.journal.dead is not None:
            journal_dead = True
            return False
        try:
            daemon.tick()
        except DurableWriteError:
            journal_dead = True
            return False
        except Exception as e:  # noqa: BLE001 — run() survives these
            if daemon.journal.dead is not None:
                journal_dead = True
                return False
            log.info("chaos health tick error (absorbed): %s", e)
        return True

    def _complete_some(p: float) -> None:
        with daemon._lock:
            running = [j for j in daemon.jobs.values()
                       if j.state == RUNNING]
        if running and rng.random() < p:
            victim = rng.choice(running)
            hnd = runner.handles.get(victim.req.job_id)
            if hnd is not None and hnd.exit is None:
                hnd.exit = 0

    def _cordoned() -> bool:
        with daemon._lock:
            h = daemon.book.hosts.get(flaky)
            return h is not None and h.state in (
                fhealth.QUARANTINED, fhealth.PROBATION)

    try:
        # Phase 1: saturate until the ledger cordons the flaky host.
        for _ in range(80):
            if _cordoned():
                break
            with daemon._lock:
                alive = sum(1 for j in daemon.jobs.values()
                            if j.state in (QUEUED, GRANTED, RUNNING))
            while alive < 6:
                daemon.submit("tenant-" + str(rng.randint(0, 2)), 2,
                              priority=rng.randint(0, 1), min_hosts=1,
                              conf={})
                alive += 1
            if not _tick():
                break
            _complete_some(0.3)
        # Phase 2: the drain probe — fresh work submitted AFTER the
        # cordon must still grant, minus the bad host. Top priority so
        # it outranks whatever phase 1 left queued.
        if not journal_dead and _cordoned():
            daemon.submit("tenant-drain", 2, priority=3, min_hosts=1,
                          conf={})
            daemon.submit("tenant-drain", 2, priority=3, min_hosts=1,
                          conf={})
            for _ in range(40):
                if not _tick():
                    break
                _complete_some(0.5)
    finally:
        try:
            daemon._shutdown()
        except Exception:  # noqa: BLE001
            pass

    if journal_dead:
        outcome.status = "FAILED"
        outcome.failure_domain = "INFRA_TRANSIENT"
        outcome.detail = f"fleet journal dead: {daemon.journal.dead}"
        return outcome
    outcome.status = "SUCCEEDED"

    # Journal-proven ladder: fold the record stream in order.
    from tony_tpu_torch.devtools.invariants import _iter_journal_records
    recs, _ = _iter_journal_records(
        os.path.join(fleet_dir, constants.FLEET_JOURNAL_FILE))
    cordon_at = None        # record index of the first flaky quarantine
    grants_after = 0
    for idx, rec in recs:
        t = rec.get("t")
        if t == fjournal.REC_FLEET_HEALTH:
            for ev in rec.get("evidence") or []:
                if ev.get("kind") == "USER_ERROR":
                    outcome.violations.append(Violation(
                        "verdict",
                        f"record {idx}: USER_ERROR entered the health "
                        f"evidence ledger for {rec.get('host')} — user "
                        f"bugs must never cordon hardware"))
            if rec.get("host") == flaky \
                    and rec.get("state") == fhealth.QUARANTINED \
                    and cordon_at is None:
                cordon_at = idx
        elif t == fjournal.REC_FLEET_GRANT and cordon_at is not None:
            grants_after += 1
            if flaky in (rec.get("host_ids") or []):
                outcome.violations.append(Violation(
                    "verdict",
                    f"record {idx}: grant of {rec.get('job')} placed "
                    f"on {flaky} AFTER its quarantine at record "
                    f"{cordon_at} — placements must route around a "
                    f"cordoned host"))
    if cordon_at is None:
        outcome.violations.append(Violation(
            "verdict",
            f"seeded flaky host {flaky} was never quarantined — the "
            f"failure-attribution ledger missed the drill's storm"))
    elif grants_after == 0:
        outcome.violations.append(Violation(
            "verdict",
            f"no grant landed after {flaky}'s quarantine at record "
            f"{cordon_at} — the fleet wedged instead of draining "
            f"around the bad host"))
    return outcome


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------
def run_schedule(schedule: Schedule, workdir: str) -> Outcome:
    """Execute one schedule in a fresh workdir and climb the ladder."""
    os.makedirs(workdir, exist_ok=True)
    gates = oracle.snapshot_gates()
    injector = schedule.injector()
    faults.install(injector)
    try:
        if schedule.suite in ("e2e", "migrate"):
            outcome = _run_coordinator_suite(
                schedule, workdir, migrate=(schedule.suite == "migrate"))
        elif schedule.suite == "fleet":
            outcome = _run_fleet_suite(schedule, workdir)
        elif schedule.suite == "health":
            outcome = _run_health_suite(schedule, workdir)
        else:
            raise ValueError(f"unknown chaos suite {schedule.suite!r}")
    finally:
        faults.uninstall()

    oracle.check_verdict(outcome.status, outcome.failure_domain,
                         outcome.violations)
    oracle.check_artifacts(workdir, outcome.violations)
    app_id = f"chaos_{schedule.suite}_{schedule.index:06d}"
    oracle.check_orphans(app_id, outcome.violations,
                         timeout_s=2.0)
    oracle.check_gates(gates, outcome.violations)
    return outcome
