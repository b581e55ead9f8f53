"""Fleet daemon: the persistent cluster scheduler process.

``tony-tpu fleet start`` (or ``python -m tony_tpu_torch.fleet serve``) runs one
of these per cluster. It owns a pool of slices of GPU hosts (LocalSim hosts in
drills), accepts submissions over the ordinary token-authed RPC plane
(``fleet.submit`` / ``fleet.status`` / ``fleet.cancel`` / ``fleet.stop``,
generation-fenced like every other surface), lets the stdlib policy
engine (``fleet/policy.py``) decide who runs where, and carries out the
decisions:

- a **grant** spawns the granted job through the ordinary single-job
  stack — one ``python -m tony_tpu_torch.cli submit`` client subprocess
  per job, with the fleet's injections on its conf: granted gang size, elastic knobs for
  preemptible jobs and the shared warm executor pool (``tony.pool.dir``)
  so every tenant's resubmit rides the warm path (the reference's
  per-model compile-cache mount has no counterpart: the port compiles
  nothing at run time);
- a **preemption** shrinks the victim through its coordinator's elastic
  resize RPC (``coordinator/elastic.py`` drain→remesh — the absorb path:
  no kill, no epoch burned) and hands the reclaimed hosts to the
  higher-priority demander;
- a **grow-back** restores shrunk victims once the queue drains;
- a **migration** moves a running job between slices through its
  coordinator's live-migration op (``coordinator/migrate.py``
  drain→async-snapshot→relaunch — no kill, no epoch burned): planned by
  the policy engine to cure FRAGMENTATION holds, triggered proactively
  by a slice-preemption notice (the ``slice.preempt`` fault site in
  drills, the queued-resource reclaim feed — ``cluster/gcloud.py``
  ``reclaim_notices`` — in production), or requested by the operator
  via ``tony-tpu fleet migrate <job> <slice>``.

Every decision is write-ahead journaled (``fleet/journal.py``) so a
SIGKILLed daemon restarted with ``--recover`` resumes the same queue
state, re-adopts still-running jobs by their recorded pid (the client
subprocesses are session leaders and survive the daemon), and re-spawns
granted-but-never-started jobs — zero duplicated or lost grants.
Scheduler state surfaces as FLEET_* events, the ``tony_fleet_*`` metric
families (``<fleet_dir>/fleet.prom``), an atomically replaced
``fleet.status.json`` (the portal's /fleet source), and ``tony-tpu
fleet top``.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import subprocess
import sys
import threading
import time
from typing import Any, Deque, Dict, List, Optional

from tony_tpu_torch import constants, faults, tracing
from tony_tpu_torch import alerts as falerts
from tony_tpu_torch.conf import keys as K
from tony_tpu_torch.devtools.race import guarded
from tony_tpu_torch.events.events import Event, EventHandler, EventType
from tony_tpu_torch.fleet import health as fhealth
from tony_tpu_torch.fleet import journal as fjournal
from tony_tpu_torch.fleet import ledger as fledger
from tony_tpu_torch.fleet.policy import (GRANT, HOLD_ACTIONS, MIGRATE,
                                   QUOTA_DENIED, SHRINK, Decision,
                                   JobRequest, PolicyEngine,
                                   parse_quotas)
from tony_tpu_torch.metrics import MetricsRegistry
from tony_tpu_torch.utils.durable import DurableWriteError, atomic_write

log = logging.getLogger(__name__)

#: daemon-side job states (journal STATE_* plus the pre-grant ones)
QUEUED = "QUEUED"
GRANTED = "GRANTED"
RUNNING = "RUNNING"

#: queue-wait histogram buckets (seconds): submit→grant waits live in
#: the seconds-to-minutes range, not the sub-ms RPC-latency range the
#: default buckets cover — without these, any wait past 10s saturates
#: the top bucket and p99 reads as a flat 10.0.
QUEUE_WAIT_BUCKETS_S = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 20.0,
                        40.0, 60.0, 120.0, 300.0, 600.0, 1800.0)


class FleetError(RuntimeError):
    pass


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


class _FleetJob:
    def __init__(self, req: JobRequest, conf: Dict[str, str],
                 workdir: str, decision_ring: int = 64) -> None:
        self.req = req
        self.conf = conf
        self.workdir = workdir
        self.state = QUEUED
        self.hosts = 0
        self.placement: Dict[int, int] = {}
        #: concrete host identities the grant landed on (fleet/health.py
        #: names, task-index order) — the failure-attribution target map
        self.host_ids: List[str] = []
        self.app_id = ""
        self.pid = 0
        self.exit_code: Optional[int] = None
        self.handle: Optional[Any] = None
        self.submitted_mono = time.monotonic()
        self.wait_s: Optional[float] = None    # queue wait, set at grant
        self.denial = ""                       # last quota/capacity note
        self.cancelled = False
        # --- observability (ledger + explainer + trace) ----------------
        # Wall-clock anchors for the goodput ledger (ms; the journal
        # records carry the same clock, so offline re-folds agree).
        self.submitted_ms = int(time.time() * 1000)
        self.granted_ms = 0
        self.finished_ms = 0
        self.host_events: List[Any] = []       # [(ts_ms, hosts)]
        # Bounded hold-reason transition ring behind `fleet explain`.
        self.decisions: Deque[Dict[str, Any]] = collections.deque(
            maxlen=max(2, int(decision_ring)))
        self.queue_span: Any = tracing.NULL_SPAN
        self.job_span: Any = tracing.NULL_SPAN


class _AdoptedHandle:
    """Popen-shaped handle over a RECOVERED job's client process: not
    our child (the previous daemon life spawned it), so liveness is a
    signal-0 probe and the outcome comes from the job's finalized
    history file — the same adopt-a-foreign-process shape as the pool
    backend's _LeasedProc."""

    def __init__(self, pid: int, history_root: str, job: "_FleetJob"):
        self.pid = pid
        self.history_root = history_root
        self.job = job
        self.returncode: Optional[int] = None

    def poll(self) -> Optional[int]:
        if self.returncode is not None:
            return self.returncode
        if _pid_alive(self.pid):
            return None
        status = self._history_status()
        self.returncode = 0 if status == "SUCCEEDED" else 1
        return self.returncode

    def _history_status(self) -> str:
        from tony_tpu_torch.events import history

        app_id = self.job.app_id or _discover_app(self.job.workdir) or ""
        if not app_id:
            return ""
        job_dir = history.list_job_dirs(self.history_root).get(app_id)
        if not job_dir:
            return ""
        path = history.find_history_file(job_dir)
        if not path:
            return ""
        meta = history.parse_metadata(os.path.basename(path))
        return meta.status if meta is not None else ""


def _discover_app(job_workdir: str) -> Optional[str]:
    """The app id of the single job submitted from ``job_workdir`` (the
    client creates ``jobs/<app_id>/`` there); newest wins if a re-grant
    ever left a sibling."""
    jobs_dir = os.path.join(job_workdir, "jobs")
    try:
        entries = sorted(os.listdir(jobs_dir))
    except OSError:
        return None
    return entries[-1] if entries else None


class SubprocessJobRunner:
    """Carries fleet decisions out against the real single-job stack:
    spawn = one ``tony-tpu submit`` client subprocess (session leader —
    it survives a daemon SIGKILL), resize/kill = RPCs against the job's
    coordinator address file. Tests substitute a fake with the same
    surface."""

    def __init__(self, python: str = sys.executable) -> None:
        self.python = python

    def spawn(self, job_workdir: str,
              overrides: Dict[str, str]) -> subprocess.Popen:
        os.makedirs(job_workdir, exist_ok=True)
        cmd = [self.python, "-m", "tony_tpu_torch.cli", "submit",
               "--workdir", job_workdir]
        for k in sorted(overrides):
            cmd += ["--conf", f"{k}={overrides[k]}"]
        env = dict(os.environ)
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = (repo_root + os.pathsep +
                             env.get("PYTHONPATH", "")).rstrip(os.pathsep)
        clog = open(os.path.join(job_workdir, "client.log"), "ab")
        popen = subprocess.Popen(cmd, stdout=clog,
                                 stderr=subprocess.STDOUT, env=env,
                                 start_new_session=True)
        clog.close()
        return popen

    def poll(self, handle: Any) -> Optional[int]:
        return handle.poll()

    def _coordinator_rpc(self, job_workdir: str) -> Optional[Any]:
        app_id = _discover_app(job_workdir)
        if app_id is None:
            return None
        addr_path = os.path.join(job_workdir, "jobs", app_id,
                                 "coordinator.addr")
        try:
            with open(addr_path, encoding="utf-8") as f:
                addr = json.load(f)
        except (OSError, ValueError):
            return None
        from tony_tpu_torch.rpc.wire import RpcClient

        return RpcClient(addr["host"], int(addr["port"]),
                         token=addr.get("token") or None,
                         max_retries=2, retry_sleep_s=0.2,
                         connect_timeout_s=5.0, call_timeout_s=15.0,
                         peer="coordinator")

    def resize(self, job_workdir: str, size: int) -> bool:
        """Elastic resize (shrink = preempt-to-reclaim, grow =
        grow-back restore) via the job's own resize_application RPC."""
        rpc = self._coordinator_rpc(job_workdir)
        if rpc is None:
            return False
        try:
            res = rpc.call("resize_application", size=int(size), job="")
            return bool(isinstance(res, dict) and res.get("ok"))
        except Exception as e:  # noqa: BLE001 — a dead victim is a no
            log.warning("fleet resize of %s to %d failed: %s",
                        job_workdir, size, e)
            return False
        finally:
            rpc.close()

    def migrate(self, job_workdir: str, target: str) -> bool:
        """Live migration (defrag repack / slice evacuation) via the
        job's own migrate_application RPC — the coordinator's
        drain→move→reshard op, no epoch burned. A refusal (op already
        in flight, unreachable) is a no; the daemon retries next
        tick."""
        rpc = self._coordinator_rpc(job_workdir)
        if rpc is None:
            return False
        try:
            res = rpc.call("migrate_application", target=str(target),
                           job="")
            return bool(isinstance(res, dict) and res.get("ok"))
        except Exception as e:  # noqa: BLE001 — a dead mover is a no
            log.warning("fleet migrate of %s to %r failed: %s",
                        job_workdir, target, e)
            return False
        finally:
            rpc.close()

    def kill(self, job_workdir: str) -> bool:
        rpc = self._coordinator_rpc(job_workdir)
        if rpc is None:
            return False
        try:
            rpc.call("kill_application")
            return True
        except Exception as e:  # noqa: BLE001
            log.warning("fleet kill of %s failed: %s", job_workdir, e)
            return False
        finally:
            rpc.close()


class _FleetService:
    """RPC surface (rpc/wire.py namespacing: ``fleet.submit`` etc.)."""

    def __init__(self, daemon: "FleetDaemon") -> None:
        self._d = daemon

    def fleet__submit(self, tenant: str, hosts: int, priority: int = 0,
                      min_hosts: int = 0, model: str = "",
                      conf: Optional[dict] = None) -> dict:
        return self._d.submit(str(tenant), int(hosts),
                              priority=int(priority or 0),
                              min_hosts=int(min_hosts or 0),
                              model=str(model or ""),
                              conf=dict(conf or {}))

    def fleet__status(self) -> dict:
        return self._d.status()

    def fleet__cancel(self, job: str) -> dict:
        return self._d.cancel(str(job))

    def fleet__explain(self, job: str) -> dict:
        return self._d.explain(str(job))

    def fleet__migrate(self, job: str, target: int) -> dict:
        return self._d.migrate(str(job), int(target))

    def fleet__cordon(self, host: str, reason: str = "") -> dict:
        return self._d.cordon(str(host), reason=str(reason or ""))

    def fleet__uncordon(self, host: str) -> dict:
        return self._d.uncordon(str(host))

    def fleet__health(self) -> dict:
        return self._d.health_status()

    def fleet__alerts(self) -> dict:
        return self._d.alerts_status()

    def fleet__prom(self) -> dict:
        # Live tony_fleet_* exposition for the portal's /fleet view —
        # the file twin (fleet.prom) only refreshes on the export
        # cadence, so a running daemon answers from the registry.
        return {"text": self._d.metrics.render()}

    def fleet__stop(self) -> bool:
        self._d.request_stop()
        return True


@guarded
class FleetDaemon:
    #: tonyrace registry (devtools/race.py + the guarded-by lint): the
    #: job map, the policy-engine feed (_seq) and the goodput-ledger
    #: caches are shared between the scheduler tick and the
    #: fleet.submit/cancel/status/explain RPC threads — every touch
    #: holds the daemon lock. The scalars are single-writer throttle/
    #: degrade flags (atomic rebinds; a stale read costs one tick).
    GUARDED_BY = {
        "jobs": "_lock",
        "_seq": "_lock",
        "_ledgers": "_lock",
        "_ledger_rollup": "_lock",
        "_grant_waits": "_lock",
        "_preempts_per_job": "_lock",
        "_dying_slices": "_lock",
        "book": "_lock",
        "_health_offsets": "_lock",
        "_ledger_degraded": None,
        "_ledger_next_mono": None,
        "_explain_warned": None,
        "_alerts_degraded": None,
        "_started": None,
    }

    def __init__(self, fleet_dir: str, slices: int = 1,
                 hosts_per_slice: int = 8, quotas: str = "",
                 pool_dir: str = "",
                 tick_s: float = 0.5, recover: bool = False,
                 runner: Optional[Any] = None,
                 reclaim_probe: Optional[Any] = None,
                 python: str = sys.executable,
                 decision_ring: int = 64,
                 ledger_interval_s: float = 5.0,
                 health_conf: Optional[fhealth.HealthConfig] = None
                 ) -> None:
        self.fleet_dir = os.path.abspath(os.path.expanduser(fleet_dir))
        os.makedirs(self.fleet_dir, exist_ok=True)
        self.slices = max(1, int(slices))
        self.hosts_per_slice = max(1, int(hosts_per_slice))
        self.quotas = parse_quotas(quotas)
        self.pool_dir = pool_dir
        self.tick_s = max(0.05, float(tick_s))
        self.decision_ring = max(2, int(decision_ring))
        self.ledger_interval_s = max(0.0, float(ledger_interval_s))
        self.history_root = os.path.join(self.fleet_dir, "history")
        self.runner = runner if runner is not None \
            else SubprocessJobRunner(python)
        self.engine = PolicyEngine(self.slices, self.hosts_per_slice,
                                   self.quotas)
        self.jobs: Dict[str, _FleetJob] = {}
        self._seq = 0
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._started = False
        # Goodput ledger (fleet/ledger.py): per-job folds + rollup,
        # refreshed on a throttle; a fold failure (fleet.ledger fault
        # site) degrades the fleet to counters-only, never a dead tick.
        self._ledgers: Dict[str, Dict[str, Any]] = {}
        self._ledger_rollup: Optional[Dict[str, Any]] = None
        self._ledger_degraded = False
        self._ledger_next_mono = 0.0
        self._explain_warned = False
        self._grant_waits: List[float] = []
        self._preempts_per_job: Dict[str, int] = {}
        # Slice-preemption notices: slices the provider has marked for
        # reclaim. Remembered for the daemon's life and evacuated
        # proactively; ``reclaim_probe`` is an optional callable
        # returning dying slice indices (production: the queued-resource
        # reclaim feed, cluster/gcloud.py reclaim_notices).
        self.reclaim_probe = reclaim_probe
        self._dying_slices: set = set()
        # Host health (fleet/health.py): the per-host failure-attribution
        # ledger + quarantine state machine, kept in lockstep with the
        # policy engine's count accounting. Per-job event-stream tail
        # offsets feed the attribution loop incrementally.
        self.health_cfg = health_conf or fhealth.HealthConfig()
        self.book = fhealth.HostBook(self.slices, self.hosts_per_slice,
                                     self.health_cfg)
        self._health_offsets: Dict[str, int] = {}
        # Alerting (tony_tpu_torch/alerts/): the fleet-scope pack, evaluated
        # each scheduler tick behind the fleet.ledger-style degrade
        # contract (fault site "alerts.eval"); transitions journal
        # write-ahead as REC_FLEET_ALERT and, like cordons, a firing
        # alert survives daemon lives via `fleet start --recover`.
        self.alerts = falerts.AlertEngine(falerts.default_fleet_pack())
        self._alerts_degraded = False

        journal_path = os.path.join(self.fleet_dir,
                                    constants.FLEET_JOURNAL_FILE)
        replayed: Optional[fjournal.FleetReplayState] = None
        if os.path.exists(journal_path):
            replayed = fjournal.replay(journal_path)
            live = [f for f in replayed.jobs.values()
                    if f.state not in fjournal.TERMINAL_STATES]
            if live and not recover:
                raise FleetError(
                    f"fleet dir {self.fleet_dir} holds journaled state "
                    f"for {len(live)} non-terminal job(s) — start with "
                    f"--recover to resume it, or point --dir elsewhere")
        # Generation: strictly monotonic across daemon lives (journal-
        # persisted, fences zombie daemons out of the RPC plane).
        self.generation = (replayed.generation if replayed else 0) + 1
        self.journal = fjournal.FleetJournal(journal_path)
        self.journal.generation(self.generation, self.slices,
                                self.hosts_per_slice,
                                quotas=self.quotas)
        # Fleet-wide trace (tony_tpu_torch/tracing.py): queue spans, job
        # lifetimes, preempt/restore instants — and the trace id every
        # grant injects into its job so `tony-tpu trace --fleet`
        # renders the whole pool on one timeline. A recovered daemon
        # rejoins the original trace id (same contract as a recovered
        # coordinator) and closes the dead life's dangling spans.
        trace_path = os.path.join(self.fleet_dir, constants.TRACE_FILE)
        self.tracer = tracing.Tracer(
            trace_id=tracing.existing_trace_id(trace_path) or None,
            service="fleet", path=trace_path)
        if replayed is not None and recover:
            self._close_stale_spans(trace_path)

        self.metrics = MetricsRegistry()
        self._counters_path = os.path.join(self.fleet_dir,
                                           constants.FLEET_COUNTERS_FILE)
        self.metrics.load_counters(self._counters_path)
        self.events = EventHandler(self.fleet_dir,
                                   constants.FLEET_EVENTS_FILE,
                                   on_emit=self._count_event)
        # The writer thread runs from construction (not start()): every
        # scheduler decision is evented, including ones taken before the
        # RPC plane is up (recovery re-folds, embedded/test daemons).
        self.events.start()
        import secrets

        self.token = secrets.token_hex(16)
        from tony_tpu_torch.rpc.wire import RpcServer

        self.rpc = RpcServer(_FleetService(self), host="127.0.0.1",
                             port=0, token=self.token,
                             generation=self.generation)
        if replayed is not None and recover:
            self._recover(replayed)
            if replayed.alerts:
                self.alerts.seed(replayed.alerts)

    def _close_stale_spans(self, trace_path: str) -> None:
        """A SIGKILLed daemon life leaves its queue/job spans open (B
        with no E). The recovering life owns the log: close them with a
        recovered marker so the fleet export stays zero-unclosed, then
        open fresh spans for the jobs it re-adopts."""
        opens: Dict[str, bool] = {}
        for rec in tracing.load_records(trace_path):
            span = str(rec.get("span", "") or "")
            if rec.get("ev") == "B":
                opens[span] = True
            elif rec.get("ev") == "E":
                opens.pop(span, None)
        now = tracing.now_us()
        self.tracer.write_records([
            {"ev": "E", "span": span, "ts_us": now,
             "args": {"recovered": True,
                      "note": "closed by the recovering daemon"}}
            for span in opens])

    # -- recovery ---------------------------------------------------------
    def _recover(self, st: fjournal.FleetReplayState) -> None:
        """Rebuild queue + accounting from the replayed journal: queued
        jobs re-enqueue in submission order; running jobs are re-adopted
        by their recorded client pid; granted-but-never-started jobs
        re-spawn against their journaled grant; finished jobs keep their
        verdicts for the status surface. Runs before the RPC plane is up,
        but the map/engine mutations take the lock anyway — the
        guarded-by discipline has no single-threaded carve-outs."""
        with self._lock:
            self._seq = st.seq
            # Health fold FIRST (last-wins per host): states land before
            # adoption re-books hosts, so a cordoned-while-assigned host
            # is re-booked to its job and stays cordoned-pending. Free-
            # list membership is resynced after the job loop below.
            now = time.monotonic()
            for rec in st.health.values():
                self.book.apply_record(rec, now)
        for fold in sorted(st.jobs.values(), key=lambda f: f.seq):
            req = JobRequest(fold.job_id, fold.tenant,
                             priority=fold.priority,
                             hosts=fold.hosts_requested,
                             min_hosts=fold.min_hosts, model=fold.model,
                             seq=fold.seq)
            job = _FleetJob(req, fold.conf,
                            os.path.join(self.fleet_dir, "jobs",
                                         fold.job_id),
                            decision_ring=self.decision_ring)
            job.app_id = fold.app_id
            job.pid = fold.pid
            job.exit_code = fold.exit_code
            # Ledger anchors + explain ring survive the daemon: the
            # journal is their write-ahead home, the fold re-seeds them.
            job.submitted_ms = fold.submitted_ms or job.submitted_ms
            job.granted_ms = fold.granted_ms
            job.finished_ms = fold.finished_ms
            job.host_events = list(fold.host_events)
            job.decisions.extend(fold.decisions)
            if fold.decisions:
                # Restore the dedup fence: the recovered life must not
                # re-journal the hold reason it already recorded.
                job.denial = str(fold.decisions[-1].get("reason", ""))
            with self._lock:
                self.jobs[fold.job_id] = job
            if fold.state in fjournal.TERMINAL_STATES:
                job.state = fold.state
                continue
            if fold.state == "QUEUED":
                with self._lock:
                    self.engine.submit(req)
                job.queue_span = self.tracer.start_span(
                    "fleet.queue", task=fold.job_id,
                    attrs={"tenant": fold.tenant, "recovered": True,
                           "priority": fold.priority,
                           "hosts": fold.hosts_requested})
                continue
            # GRANTED / SPAWNED / RUNNING: the grant stands — decide
            # between adopt, respawn, and post-mortem.
            app_id = fold.app_id or _discover_app(job.workdir)
            if fold.pid and _pid_alive(fold.pid):
                with self._lock:
                    self.engine.force_grant(req, fold.hosts,
                                            fold.placement)
                    job.host_ids = self.book.adopt(
                        fold.job_id, dict(fold.placement),
                        fold.host_ids)
                job.state = RUNNING
                job.hosts = fold.hosts
                job.placement = dict(fold.placement)
                job.handle = _AdoptedHandle(fold.pid, self.history_root,
                                            job)
                job.job_span = self.tracer.start_span(
                    "fleet.job", task=fold.job_id,
                    attrs={"tenant": fold.tenant, "hosts": fold.hosts,
                           "app_id": app_id or "", "recovered": True})
                log.info("fleet recover: adopted running job %s "
                         "(client pid %d, app %s)", fold.job_id,
                         fold.pid, app_id or "?")
                # Simultaneous-crash window: the daemon can die BETWEEN
                # a victim's resize RPC and the journal record of it
                # (_apply_preempt lands the resize first, then the
                # accounting). The victim kept draining while we were
                # down — its own write-ahead journal knows the size the
                # gang actually reached, and the books must agree with
                # the gang, not with our torn decision.
                self._reconcile_adopted_size(job, fold, app_id)
            elif app_id:
                # The client is gone but the job got as far as an app
                # dir: read its outcome from history (an unfinished
                # app with a dead client is a crashed job).
                job.app_id = app_id
                handle = _AdoptedHandle(fold.pid or 1, self.history_root,
                                        job)
                status = handle._history_status()
                exit_code = 0 if status == "SUCCEEDED" else 1
                state = fjournal.STATE_FINISHED if exit_code == 0 \
                    else fjournal.STATE_FAILED
                self.journal.state(fold.job_id, state, app_id=app_id,
                                   exit_code=exit_code)
                job.state = state
                job.exit_code = exit_code
                job.finished_ms = int(time.time() * 1000)
                log.info("fleet recover: job %s finished %s while the "
                         "daemon was down", fold.job_id, state)
            else:
                # Granted (journaled write-ahead) but the spawn never
                # produced an app: carry the grant out now — this is
                # the zero-LOST-grants half of the recovery contract
                # (the fgen record above licenses the re-grant).
                with self._lock:
                    self.engine.submit(req)
                job.state = QUEUED
                job.queue_span = self.tracer.start_span(
                    "fleet.queue", task=fold.job_id,
                    attrs={"tenant": fold.tenant, "recovered": True,
                           "regrant": True})
                log.info("fleet recover: re-queued granted-but-never-"
                         "started job %s", fold.job_id)
        # Resume the identical cordon set: drop cordoned hosts out of
        # the free identity lists and mirror the delta into the pool's
        # count accounting (hosts re-booked to adopted jobs are in-use,
        # not free — they cordon at release, the deferred sweep).
        with self._lock:
            for i, n in self.book.resync_free().items():
                for _ in range(n):
                    self.engine.pool.cordon_free(i)
            self._refresh_cordoned_names_locked()
            cordoned = self.book.cordoned_names()
        if cordoned:
            log.warning("fleet recover: resumed health cordon set %s",
                        cordoned)

    def _victim_gang_size(self, job: "_FleetJob",
                          app_id: Optional[str]) -> Optional[int]:
        """The member count an adopted victim's gang ACTUALLY settled
        at, replayed from the victim coordinator's own write-ahead
        journal (its jobs/<app>/session.journal.jsonl). None = unknown
        or still in flight — the caller must then keep the journaled
        (conservative, never-double-grant) accounting."""
        if not app_id:
            return None
        path = os.path.join(job.workdir, "jobs", app_id,
                            constants.JOURNAL_FILE)
        from tony_tpu_torch.coordinator import journal as cjournal

        try:
            st = cjournal.replay(path)
        except Exception:  # noqa: BLE001 — an unreadable victim journal
            return None    # is an unknown, not a recovery failure
        if st.inflight_job:
            # A resize is STILL draining inside the victim: nothing has
            # landed, so the journaled size is the truthful one for now;
            # the ordinary preempt retry completes it (the resize RPC is
            # idempotent about already-at-size).
            return None
        if not st.applied_members:
            return None        # never resized: journaled size stands
        members = next(iter(st.applied_members.values()))
        return len(members)

    def _reconcile_adopted_size(self, job: "_FleetJob",
                                fold: fjournal.JobFold,
                                app_id: Optional[str]) -> None:
        """Complete (or supersede) a resize whose accounting the crash
        window swallowed: the victim's actual gang size wins over the
        journaled grant. A shrink that landed un-journaled frees the
        reclaimed hosts NOW (the demander's grant was equally torn, so
        nothing was double-booked); an un-journaled grow books the
        extra hosts so the pool cannot grant them twice."""
        actual = self._victim_gang_size(job, app_id)
        if actual is None or actual == fold.hosts or actual <= 0:
            return
        job_id = fold.job_id
        if actual < fold.hosts:
            with self._lock:
                placement = self.engine.shrink_applied(job_id, actual)
                job.hosts = actual
                job.placement = placement
                job.host_events.append((int(time.time() * 1000), actual))
                self._reconcile_hosts_locked(job, placement)
            self.journal.preempt(job_id, fold.hosts, actual, "",
                                 placement)
            log.warning(
                "fleet recover: %s gang is at %d host(s) but the journal "
                "granted %d — completing the in-flight shrink the crash "
                "window hid (reclaimed hosts freed, preempt journaled)",
                job_id, actual, fold.hosts)
        else:
            with self._lock:
                delta = self.engine.pool.place(actual - fold.hosts)
                if delta is None:
                    # The pool cannot cover the difference — the books
                    # are over-subscribed either way; keep the journaled
                    # size and say so loudly rather than corrupt the
                    # accounting.
                    log.error(
                        "fleet recover: %s gang is at %d host(s) but "
                        "only %d are journaled and the pool cannot "
                        "cover the difference — accounting left at the "
                        "journaled size", job_id, actual, fold.hosts)
                    return
                placement = self.engine.grow_applied(job_id, delta)
                job.hosts = actual
                job.placement = placement
                job.host_events.append((int(time.time() * 1000), actual))
                self._reconcile_hosts_locked(job, placement)
            self.journal.state(job_id, fjournal.STATE_RESTORED,
                               hosts=actual, placement=placement)
            log.warning(
                "fleet recover: %s gang is at %d host(s) but the journal "
                "granted %d — booking the un-journaled grow so the pool "
                "cannot double-grant those hosts", job_id, actual,
                fold.hosts)

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        self._started = True
        self.rpc.start()
        host, port = self.rpc.address
        atomic_write(
            os.path.join(self.fleet_dir, constants.FLEET_ADDR_FILE),
            json.dumps({"host": host, "port": port, "token": self.token,
                        "pid": os.getpid(),
                        "generation": self.generation}).encode("utf-8"),
            mode=0o600)
        log.info("fleet daemon up at %s:%d (generation %d, %d slice(s) "
                 "x %d hosts, quotas %s)", host, port, self.generation,
                 self.slices, self.hosts_per_slice, self.quotas or "none")

    def run(self) -> int:
        self.start()
        rc = 0
        try:
            while not self._stop_evt.wait(self.tick_s):
                if self.journal.dead is not None:
                    # A submit/RPC handler hit the dead disk first.
                    log.critical(
                        "fleet journal is DEAD (%s) — stopping the "
                        "daemon; restart with `fleet start --recover` "
                        "once the disk is healthy", self.journal.dead)
                    rc = 1
                    break
                try:
                    self.tick()
                except DurableWriteError as e:
                    # The write-ahead journal died (ENOSPC/EIO): STOP.
                    # A daemon that keeps scheduling against a journal
                    # that cannot write ahead makes decisions `--recover`
                    # can never see — worse than being down. Running jobs
                    # are left alone (tenant-owned session leaders); the
                    # committed journal prefix stays replayable.
                    log.critical(
                        "fleet journal is DEAD (%s) — stopping the "
                        "daemon; restart with `fleet start --recover` "
                        "once the disk is healthy", e)
                    rc = 1
                    break
                except Exception:  # noqa: BLE001 — the daemon must live
                    if self.journal.dead is not None:
                        log.critical(
                            "fleet journal is DEAD (%s) — stopping the "
                            "daemon; restart with `fleet start "
                            "--recover` once the disk is healthy",
                            self.journal.dead)
                        rc = 1
                        break
                    log.exception("fleet tick failed")
        finally:
            self._shutdown()
        return rc

    def request_stop(self) -> None:
        self._stop_evt.set()

    def _shutdown(self) -> None:
        # Running jobs are NOT killed: they belong to their tenants and
        # their client/coordinator processes are independent session
        # leaders — the same leave-leased-work-alone posture as the
        # pool daemon's shutdown.
        self._export()
        try:
            os.unlink(os.path.join(self.fleet_dir,
                                   constants.FLEET_ADDR_FILE))
        except OSError:
            pass
        if self._started:
            # Stopping a never-serving TCP server deadlocks in
            # shutdown(); unit tests drive tick() without start().
            self.rpc.stop()
        # Final name == in-progress name: the fleet stream is append-only
        # across daemon lives, never finalized like a job's jhist.
        self.events.stop(constants.FLEET_EVENTS_FILE)
        # Close every span this life still holds open (queued jobs at
        # daemon stop, jobs still running when the operator stops the
        # daemon) so an orderly stop leaves zero unclosed spans.
        with self._lock:
            jobs = list(self.jobs.values())
        for job in jobs:
            job.queue_span.end(daemon_stopped=True)
            job.queue_span = tracing.NULL_SPAN
            job.job_span.end(daemon_stopped=True)
            job.job_span = tracing.NULL_SPAN
        self.tracer.close()
        self.journal.close()

    def _count_event(self, ev: Event) -> None:
        self.metrics.counter("tony_events_total",
                             {"type": ev.type.value},
                             help="job-history events emitted, "
                                  "by type").inc()

    # -- RPC behaviour ----------------------------------------------------
    def submit(self, tenant: str, hosts: int, priority: int = 0,
               min_hosts: int = 0, model: str = "",
               conf: Optional[Dict[str, str]] = None) -> dict:
        if self.journal.dead is not None:
            # Sticky-dead journal: appends silently no-op from here on,
            # so an ack would promise crash-survival the write-ahead
            # log can no longer give. Refuse until --recover.
            return {"ok": False,
                    "message": f"fleet journal is dead "
                               f"({self.journal.dead}); the daemon is "
                               f"stopping — resubmit after `fleet "
                               f"start --recover`"}
        if not tenant:
            return {"ok": False, "message": "submission needs a tenant"}
        if hosts <= 0 or hosts > self.engine.pool.total:
            return {"ok": False,
                    "message": f"hosts must be 1..{self.engine.pool.total} "
                               f"(the pool), got {hosts}"}
        if min_hosts > hosts:
            return {"ok": False,
                    "message": f"min_hosts {min_hosts} > hosts {hosts}"}
        quota = self.quotas.get(tenant, 0)
        if quota > 0 and hosts > quota:
            # Refuse outright rather than queue forever: this request
            # can never be granted under the tenant's quota.
            return {"ok": False,
                    "message": f"{hosts} hosts exceeds tenant "
                               f"{tenant!r}'s quota of {quota}"}
        conf = {str(k): str(v) for k, v in (conf or {}).items()}
        with self._lock:
            self._seq += 1
            seq = self._seq
        job_id = f"fj-{seq:04d}"
        req = JobRequest(job_id, tenant, priority=priority, hosts=hosts,
                         min_hosts=min_hosts, model=model, seq=seq)
        # Write-ahead of the ack: a submission the caller saw accepted
        # must survive a daemon crash into the recovered queue — so a
        # submission that CANNOT be journaled must be refused, never
        # acked on the side of a dead journal (chaos schedule
        # disk.full x submit: the RPC verb must answer, not traceback).
        try:
            self.journal.submit(job_id, tenant, priority, hosts,
                                min_hosts, model, seq, conf)
        except DurableWriteError as e:
            return {"ok": False,
                    "message": f"fleet journal is dead ({e}); the "
                               f"daemon is stopping — resubmit after "
                               f"`fleet start --recover`"}
        job = _FleetJob(req, conf,
                        os.path.join(self.fleet_dir, "jobs", job_id),
                        decision_ring=self.decision_ring)
        job.queue_span = self.tracer.start_span(
            "fleet.queue", task=job_id,
            attrs={"tenant": tenant, "priority": priority,
                   "hosts": hosts, "min_hosts": min_hosts,
                   "model": model})
        with self._lock:
            self.jobs[job_id] = job
            self.engine.submit(req)
        self.events.emit(Event(EventType.FLEET_JOB_QUEUED, {
            "job": job_id, "tenant": tenant, "priority": priority,
            "hosts": hosts, "min_hosts": min_hosts, "model": model}))
        log.info("fleet submit: %s tenant=%s priority=%d hosts=%d",
                 job_id, tenant, priority, hosts)
        return {"ok": True, "job": job_id, "state": QUEUED}

    def cancel(self, job_id: str) -> dict:
        if self.journal.dead is not None:
            return {"ok": False,
                    "message": f"fleet journal is dead "
                               f"({self.journal.dead}); restart with "
                               f"`fleet start --recover`"}
        with self._lock:
            job = self.jobs.get(job_id)
            if job is None:
                return {"ok": False, "message": f"unknown job {job_id!r}"}
            if job.state in fjournal.TERMINAL_STATES:
                return {"ok": False,
                        "message": f"{job_id} already {job.state}"}
            was_queued = job.state == QUEUED
            job.cancelled = True
            if was_queued:
                self.engine.withdraw(job_id)
        if was_queued:
            try:
                self._finish_job(job_id, fjournal.STATE_CANCELLED, None)
            except DurableWriteError as e:
                # Same contract as submit: an RPC verb answers, the
                # daemon's run loop does the dying.
                return {"ok": False,
                        "message": f"fleet journal is dead ({e}); "
                                   f"restart with `fleet start "
                                   f"--recover`"}
            return {"ok": True, "state": fjournal.STATE_CANCELLED}
        # Running: ask its coordinator to die; the poll loop records the
        # exit as CANCELLED (job.cancelled wins over the exit code).
        self.runner.kill(job.workdir)
        return {"ok": True, "state": "CANCELLING"}

    def status(self) -> dict:
        from tony_tpu_torch.coordinator.coordphases import histogram_quantile

        ledger = self._ledger_snapshot()
        tenant_ledgers = (ledger or {}).get("tenants", {})
        with self._lock:
            used = self.engine.tenant_used()
            rows = []
            now = time.monotonic()
            for job in sorted(self.jobs.values(),
                              key=lambda j: j.req.seq):
                wait = job.wait_s if job.wait_s is not None else (
                    now - job.submitted_mono
                    if job.state == QUEUED else None)
                last = job.decisions[-1] if job.decisions else None
                held = ""
                if job.state == QUEUED and last \
                        and last.get("action") != "granted":
                    held = f"{last.get('action')}: " \
                           f"{last.get('reason', '')}"
                rows.append({
                    "job": job.req.job_id, "tenant": job.req.tenant,
                    "priority": job.req.priority, "state": job.state,
                    "hosts_requested": job.req.hosts,
                    "hosts": job.hosts, "model": job.req.model,
                    "app_id": job.app_id, "exit": job.exit_code,
                    "wait_s": round(wait, 3) if wait is not None
                    else None,
                    "denial": job.denial,
                    "held": held})
            queue_depth = self.engine.queue_depth
            free = self.engine.pool.free_total
            cordoned_n = self.engine.pool.cordoned_total
            dying = sorted(self._dying_slices)
            health = {"enabled": self.health_cfg.enabled,
                      "cordoned": self.book.cordoned_names(),
                      "sick_slices": self.book.sick_slices}
        hist = self.metrics.histogram(
            "tony_fleet_queue_wait_seconds",
            buckets=QUEUE_WAIT_BUCKETS_S,
            help="submit-to-grant wait latency").snapshot()
        total = self.slices * self.hosts_per_slice
        tenants = {}
        for t, n in sorted(used.items()):
            row: Dict[str, Any] = {
                "used": n, "quota": self.quotas.get(t, 0) or None}
            lrow = tenant_ledgers.get(t)
            if lrow is not None:
                row["goodput"] = lrow.get("goodput_fraction")
            tenants[t] = row
        # Tenants with a ledger but nothing running still get a row —
        # a tenant whose jobs all finished keeps its goodput visible.
        for t, lrow in sorted(tenant_ledgers.items()):
            tenants.setdefault(t, {
                "used": 0, "quota": self.quotas.get(t, 0) or None,
                "goodput": lrow.get("goodput_fraction")})
        return {
            "fleet_dir": self.fleet_dir, "generation": self.generation,
            "pool": {"slices": self.slices,
                     "hosts_per_slice": self.hosts_per_slice,
                     "total": total,
                     "used": total - free - cordoned_n, "free": free,
                     "cordoned": cordoned_n, "dying": dying},
            "health": health,
            "tenants": tenants,
            "queue_depth": queue_depth,
            "jobs": rows,
            "queue_wait": {
                "p50_s": round(histogram_quantile(hist, 0.5), 4),
                "p99_s": round(histogram_quantile(hist, 0.99), 4),
                "count": hist.get("count", 0)},
            "ledger": ledger,
            "alerts": {"degraded": self._alerts_degraded,
                       "firing": self.alerts.firing()},
            "pool_dir": self.pool_dir,
            "trace_id": self.tracer.trace_id,
        }

    # -- the scheduler tick ----------------------------------------------
    def tick(self) -> None:
        self._poll_jobs()
        self._discover_apps()
        # Health before the plan: this tick's cordons shape this tick's
        # placements, and a sick slice joins _dying_slices in time for
        # _evacuate below.
        self._health_tick()
        self._poll_reclaim()
        self._apply_plan()
        self._evacuate()
        self._restore()
        # Alerts before the export so a transition's gauge/counter
        # updates land in this tick's exposition.
        self._alerts_tick()
        self._export()

    def _poll_jobs(self) -> None:
        done: List[_FleetJob] = []
        with self._lock:
            # Snapshot (job, handle) pairs: a cancel RPC can terminalize
            # a job (handle → None) between this scan and the poll —
            # re-reading job.handle outside the lock would poll None.
            candidates = [(j, j.handle) for j in self.jobs.values()
                          if j.handle is not None
                          and j.state in (GRANTED, RUNNING)]
        for job, handle in candidates:
            rc = self.runner.poll(handle)
            if rc is None:
                continue
            if job.cancelled:
                state = fjournal.STATE_CANCELLED
            elif rc == 0:
                state = fjournal.STATE_FINISHED
            else:
                state = fjournal.STATE_FAILED
            if self._finish_job(job.req.job_id, state, int(rc)):
                done.append(job)
        if done:
            log.info("fleet: %d job(s) finished this tick (%s)",
                     len(done), ", ".join(j.req.job_id for j in done))

    def _finish_job(self, job_id: str, state: str,
                    exit_code: Optional[int]) -> bool:
        """THE terminal-accounting path — every way a fleet job ends
        (poll exit, cancel, spawn failure, recovery post-mortem) funnels
        here so the journal record, pool release, span closure, ledger
        fold and FLEET_JOB_FINISHED event each happen EXACTLY once per
        job. The terminal claim is atomic under the lock: a cancel RPC
        racing the poll tick cannot double-book. Returns False when the
        job was already terminal (nothing re-emitted)."""
        with self._lock:
            job = self.jobs.get(job_id)
            if job is None or job.state in fjournal.TERMINAL_STATES:
                return False
            job.state = state
            job.exit_code = None if exit_code is None else int(exit_code)
            job.handle = None
            job.finished_ms = int(time.time() * 1000)
            self.engine.release(job_id)
            # Deferred cordon sweep + canary resolution: hosts
            # quarantined while this job held them leave service NOW
            # (free -> cordoned), a probation canary resolves on the
            # job's verdict (clean run restores it, a failure
            # re-quarantines with doubled cooldown).
            newly_cordoned, health_recs = self.book.release(
                job_id, time.monotonic(),
                failed=state == fjournal.STATE_FAILED)
            for i, n in newly_cordoned.items():
                for _ in range(n):
                    self.engine.pool.cordon_free(i)
            self._refresh_cordoned_names_locked()
            self._health_offsets.pop(job_id, None)
            app_id = job.app_id
        self.journal.state(job_id, state, app_id=app_id,
                           exit_code=exit_code)
        if health_recs:
            self._apply_health_records(health_recs)
        job.queue_span.end(state=state)        # cancelled while queued
        job.queue_span = tracing.NULL_SPAN
        job.job_span.end(state=state, exit=exit_code)
        job.job_span = tracing.NULL_SPAN
        self._fold_ledger_job(job)
        self.events.emit(Event(EventType.FLEET_JOB_FINISHED, {
            "job": job_id, "state": state, "exit": exit_code,
            "app_id": app_id}))
        return True

    def _discover_apps(self) -> None:
        with self._lock:
            pending = [j for j in self.jobs.values()
                       if j.state == RUNNING and not j.app_id]
        for job in pending:
            app_id = _discover_app(job.workdir)
            if app_id is None:
                continue
            self.journal.state(job.req.job_id, fjournal.STATE_RUNNING,
                               app_id=app_id, pid=job.pid)
            with self._lock:
                job.app_id = app_id

    def _apply_plan(self) -> None:
        with self._lock:
            plan = self.engine.schedule()
        for d in plan:
            if d.action == GRANT:
                if not self._apply_grant(d.job_id, d.placement):
                    return          # retry the rest next tick
            elif d.action == SHRINK:
                if not self._apply_preempt(d.job_id, d.hosts, d.for_job,
                                           d.reason):
                    return
            elif d.action == MIGRATE:
                if not self._apply_migrate(d):
                    return
            elif d.action in HOLD_ACTIONS:
                self._note_decision(d)

    def _note_decision(self, d: Decision) -> None:
        """The scheduler decision explainer's recorder: a queued job's
        not-placed reason TRANSITIONED. Dedup per transition (never per
        tick), then three sinks — the bounded per-job ring behind
        `fleet explain`, a write-ahead REC_FLEET_DECISION journal
        record (fault site ``fleet.explain``: a failed write warns once
        and never blocks the decision), and a FLEET_JOB_HELD event."""
        with self._lock:
            job = self.jobs.get(d.job_id)
            if job is None or job.state != QUEUED:
                return
            if job.denial == d.reason:
                return             # same hold as last tick: no news
            prev_action = job.decisions[-1].get("action") \
                if job.decisions else ""
            job.denial = d.reason
            entry = {"ts_ms": int(time.time() * 1000),
                     "action": d.action, "reason": d.reason,
                     "blocking": list(d.blocking), "free": int(d.free)}
            job.decisions.append(entry)
        try:
            faults.check("fleet.explain")
            self.journal.decision(d.job_id, d.action, d.reason,
                                  blocking=d.blocking, free=d.free)
        except faults.InjectedFault as e:
            if not self._explain_warned:
                self._explain_warned = True
                log.warning(
                    "fleet: decision-record write failed (%s) — the "
                    "decision ring and events still carry the "
                    "explainer; the journal will miss hold records "
                    "until the daemon restarts", e)
        self.tracer.instant("fleet.held", parent=job.queue_span,
                            task=d.job_id,
                            attrs={"action": d.action,
                                   "reason": d.reason,
                                   "blocking": list(d.blocking)})
        self.events.emit(Event(EventType.FLEET_JOB_HELD, {
            "job": d.job_id, "action": d.action, "reason": d.reason,
            "blocking": list(d.blocking)}))
        if d.action == QUOTA_DENIED and prev_action != QUOTA_DENIED:
            # The legacy quota event dedups on ACTION: a reason-wording
            # refinement (the blocking list filling in) is a new ring/
            # journal entry but not a second QUOTA_DENIED episode.
            self.metrics.counter(
                "tony_fleet_quota_denials_total",
                help="grants deferred by tenant quota").inc()
            self.events.emit(Event(EventType.FLEET_QUOTA_DENIED, {
                "job": d.job_id, "reason": d.reason}))

    def _grant_overrides(self, job: _FleetJob) -> Dict[str, str]:
        """The fleet's injections on a granted job's conf: granted gang
        size, elastic preemptibility, the shared warm pool, and the fleet
        history root (one portal over every tenant's jobs). The
        reference's per-model compile-cache mount has no counterpart. The submission's own keys win where
        they name the same knob explicitly."""
        ov = dict(job.conf)
        ov["tony.worker.instances"] = str(job.hosts)
        if 0 < job.req.min_hosts < job.req.hosts:
            ov.setdefault(K.ELASTIC_ENABLED, "true")
            ov.setdefault(K.ELASTIC_MIN_TASKS, str(job.req.min_hosts))
        if self.pool_dir:
            ov.setdefault(K.POOL_DIR, self.pool_dir)
        ov.setdefault(K.HISTORY_LOCATION, self.history_root)
        # Cross-layer trace stitching: the grant stamps the fleet trace
        # id into the job's conf; the client adopts it instead of
        # minting its own, so the whole pool renders as ONE Perfetto
        # timeline (`tony-tpu trace --fleet <fleet_dir>`).
        if self.tracer.enabled:
            ov[K.INTERNAL_FLEET_TRACE_ID] = self.tracer.trace_id
            if getattr(job.job_span, "span_id", ""):
                ov[K.INTERNAL_FLEET_TRACE_PARENT] = job.job_span.span_id
        return ov

    def _apply_grant(self, job_id: str,
                     placement: Dict[int, int]) -> bool:
        try:
            faults.check("fleet.grant")
        except faults.InjectedFault as e:
            # The job stays QUEUED (nothing journaled, nothing
            # accounted) and the next tick retries — a grant failure
            # must never lose a submission.
            log.warning("fleet grant of %s failed (%s); job stays "
                        "queued", job_id, e)
            return False
        with self._lock:
            job = self.jobs.get(job_id)
            if job is None or job.state != QUEUED:
                return True         # cancelled mid-plan: skip
        hosts = sum(placement.values())
        # Concrete host identities + preflight probes (fleet/health.py):
        # a probe failure cordons the bad host and substitutes a spare
        # (the self-repairing grant); an uncoverable placement stays
        # queued and the next tick re-plans around the cordons.
        host_ids: List[str] = []
        canary_recs: List[Dict[str, Any]] = []
        if self.health_cfg.enabled:
            assigned = self._assign_with_probe(job, placement)
            if assigned is None:
                return False
            host_ids, canary_recs = assigned
        # Write-ahead: the grant record lands before the spawn, so a
        # crash in between recovers into "re-carry the grant out", never
        # a lost grant.
        self.journal.grant(job_id, hosts, placement,
                           host_ids=host_ids or None)
        with self._lock:
            try:
                self.engine.grant(job_id, placement)
            except KeyError:
                # Withdrawn between plan and apply: give the picked
                # identities back (canaries keep their probation state).
                self.book.unassign(job_id)
                return True
            job.state = GRANTED
            job.host_ids = host_ids
            job.hosts = hosts
            job.placement = dict(placement)
            job.wait_s = time.monotonic() - job.submitted_mono
            job.denial = ""
            job.granted_ms = int(time.time() * 1000)
            job.host_events = [(job.granted_ms, hosts)]
            self._grant_waits.append(job.wait_s)
            del self._grant_waits[:-512]
            # The grant closes the job's hold timeline in the ring.
            job.decisions.append({
                "ts_ms": job.granted_ms, "action": "granted",
                "reason": f"granted {hosts} host(s) on slice(s) "
                          f"{sorted(placement)} after "
                          f"{job.wait_s:.2f}s", "blocking": [],
                "free": 0})
        if canary_recs:
            # The probation canary took one of the granted slots: the
            # pool slot it vacated returns to accounting (uncordon) now
            # that the grant's own booking has landed.
            self._apply_health_records(canary_recs)
            log.info("fleet grant %s: probation canary %s riding "
                     "along", job_id,
                     [r.get("host") for r in canary_recs])
        job.queue_span.end(wait_s=round(job.wait_s, 3), granted=True)
        job.queue_span = tracing.NULL_SPAN
        job.job_span = self.tracer.start_span(
            "fleet.job", task=job_id,
            attrs={"tenant": job.req.tenant, "hosts": hosts,
                   "placement": {str(i): n
                                 for i, n in sorted(placement.items())}})
        try:
            popen = self.runner.spawn(job.workdir,
                                      self._grant_overrides(job))
        except OSError as e:
            log.error("fleet: spawn of %s failed: %s", job_id, e)
            self._finish_job(job_id, fjournal.STATE_FAILED, 1)
            return True
        self.journal.state(job_id, fjournal.STATE_SPAWNED,
                           pid=popen.pid)
        with self._lock:
            job.handle = popen
            job.pid = popen.pid
            job.state = RUNNING
        self.metrics.counter("tony_fleet_grants_total",
                             help="job grants applied").inc()
        self.metrics.histogram(
            "tony_fleet_queue_wait_seconds",
            buckets=QUEUE_WAIT_BUCKETS_S,
            help="submit-to-grant wait latency").observe(job.wait_s)
        self.events.emit(Event(EventType.FLEET_JOB_GRANTED, {
            "job": job_id, "tenant": job.req.tenant, "hosts": hosts,
            "placement": {str(i): n for i, n in placement.items()},
            "wait_s": round(job.wait_s, 3)}))
        log.info("fleet grant: %s -> %d host(s) on slice(s) %s "
                 "(waited %.2fs)", job_id, hosts,
                 sorted(placement), job.wait_s)
        return True

    def _apply_preempt(self, victim_id: str, to_hosts: int,
                       for_job: str, reason: str) -> bool:
        try:
            faults.check("fleet.preempt")
        except faults.InjectedFault as e:
            log.warning("fleet preempt of %s failed (%s); retried next "
                        "tick", victim_id, e)
            return False
        with self._lock:
            victim = self.jobs.get(victim_id)
            if victim is None or victim.state != RUNNING:
                return True
            from_hosts = victim.hosts
        # The victim shrinks through its own elastic machinery
        # (drain→remesh→barrier — coordinator/elastic.py): the epoch
        # survives, nothing is killed. The resize lands first, then the
        # accounting: a crash between the two under-frees for one
        # recovery (grow-back reconciles) rather than double-booking.
        if not self.runner.resize(victim.workdir, to_hosts):
            log.warning("fleet preempt: %s resize to %d refused/"
                        "unreachable; retried next tick", victim_id,
                        to_hosts)
            return False
        with self._lock:
            new_placement = self.engine.shrink_applied(victim_id,
                                                       to_hosts)
            victim.hosts = to_hosts
            victim.placement = new_placement
            victim.host_events.append((int(time.time() * 1000),
                                       to_hosts))
            self._preempts_per_job[victim_id] = \
                self._preempts_per_job.get(victim_id, 0) + 1
            self._reconcile_hosts_locked(victim, new_placement)
        self.journal.preempt(victim_id, from_hosts, to_hosts, for_job,
                             new_placement)
        self.tracer.instant("fleet.preempt", parent=victim.job_span,
                            task=victim_id,
                            attrs={"from": from_hosts, "to": to_hosts,
                                   "for": for_job, "reason": reason})
        self.metrics.counter(
            "tony_fleet_preemptions_total",
            help="preempt-to-reclaim shrinks applied").inc()
        self.events.emit(Event(EventType.FLEET_JOB_PREEMPTED, {
            "job": victim_id, "from": from_hosts, "to": to_hosts,
            "for": for_job, "reason": reason}))
        log.warning("fleet preempt: %s shrunk %d->%d host(s) for %s",
                    victim_id, from_hosts, to_hosts, for_job)
        return True

    # -- live migration (coordinator/migrate.py over the fleet) -----------
    @staticmethod
    def _slice_pool(i: int) -> str:
        """The node-pool name slice ``i`` presents to coordinators —
        the migrate RPC's target string (symbolic on LocalSim)."""
        return f"slice-{int(i)}"

    def _poll_reclaim(self) -> None:
        """Slice-preemption notice intake. Two feeds: the
        ``slice.preempt`` fault site (drills: each daemon tick is one
        call; the injected notice marks the lowest-indexed slice still
        holding running jobs as dying) and the optional
        ``reclaim_probe``. A dying slice is remembered for the daemon's
        life and evacuated proactively every tick (_evacuate)."""
        notices: List[int] = []
        try:
            faults.check("slice.preempt")
        except faults.InjectedFault:
            with self._lock:
                held = sorted(
                    i for j in self.jobs.values()
                    if j.state == RUNNING for i in j.placement)
            if held:
                notices.append(held[0])
        if self.reclaim_probe is not None:
            try:
                notices.extend(int(i) for i in self.reclaim_probe())
            except Exception as e:  # noqa: BLE001 — a flaky feed is no notice
                log.debug("fleet reclaim probe failed: %s", e)
        fresh: List[int] = []
        with self._lock:
            for i in notices:
                if 0 <= i < self.slices and i not in self._dying_slices:
                    self._dying_slices.add(i)
                    fresh.append(i)
        for i in fresh:
            self.metrics.counter(
                "tony_fleet_reclaim_notices_total",
                help="slice-preemption notices received").inc()
            self.tracer.instant("fleet.reclaim-notice",
                                attrs={"slice": i})
            log.warning("fleet: slice %d preemption notice — evacuating "
                        "its jobs by live migration", i)

    def _evacuate(self) -> None:
        """Move every elastic job off the dying slices (policy
        ``evacuation_candidates``); jobs with no landing room stay and
        the ordinary host-loss ladder absorbs them when the slice
        actually dies."""
        with self._lock:
            dying = sorted(self._dying_slices)
            moves = self.engine.evacuation_candidates(dying) \
                if dying else []
        for d in moves:
            if not self._apply_migrate(d):
                return              # retry the rest next tick

    def _apply_migrate(self, d: Decision) -> bool:
        with self._lock:
            job = self.jobs.get(d.job_id)
            if job is None or job.state != RUNNING:
                return True
        # The move lands through the job's own coordinator (drain →
        # async snapshot → relaunch on the target), then the
        # accounting — same order as preempt: a crash in between
        # leaves the journal one move behind, which the next life's
        # placement replay tolerates (host COUNT never drifts).
        if not self.runner.migrate(job.workdir,
                                   self._slice_pool(d.target)):
            log.warning("fleet migrate: %s move to slice %d refused/"
                        "unreachable; retried next tick", d.job_id,
                        d.target)
            return False
        with self._lock:
            placement = self.engine.migrate_applied(d.job_id,
                                                    d.placement)
            job.placement = placement
            self._reconcile_hosts_locked(job, placement)
        self.journal.migrate(d.job_id, d.source, d.target, placement,
                             reason=d.reason)
        self.tracer.instant("fleet.migrate", parent=job.job_span,
                            task=d.job_id,
                            attrs={"source": d.source,
                                   "target": d.target,
                                   "reason": d.reason})
        self.metrics.counter("tony_fleet_migrations_total",
                             help="live job migrations applied").inc()
        self.events.emit(Event(EventType.FLEET_JOB_MIGRATED, {
            "job": d.job_id, "source": d.source, "target": d.target,
            "reason": d.reason}))
        log.warning("fleet migrate: %s moved slice %d -> %d (%s)",
                    d.job_id, d.source, d.target, d.reason)
        return True

    def migrate(self, job_id: str, target: int) -> dict:
        """`tony-tpu fleet migrate <job> <slice>`: operator-initiated
        live move (defrag by hand, pre-maintenance evacuation)."""
        t = int(target)
        if self.journal.dead is not None:
            return {"ok": False,
                    "message": f"fleet journal is dead "
                               f"({self.journal.dead}); restart with "
                               f"`fleet start --recover`"}
        with self._lock:
            job = self.jobs.get(job_id)
            if job is None:
                return {"ok": False,
                        "message": f"unknown job {job_id!r}"}
            if job.state != RUNNING:
                return {"ok": False,
                        "message": f"{job_id} is {job.state}, not "
                                   f"RUNNING"}
            if not 0 <= t < self.slices:
                return {"ok": False,
                        "message": f"target slice {t} outside the pool "
                                   f"(0..{self.slices - 1})"}
            if set(job.placement) == {t}:
                return {"ok": False,
                        "message": f"{job_id} already runs on slice "
                                   f"{t}"}
            trial = self.engine.pool.clone()
            trial.release(job.placement)
            free_t = trial.free_on(t)
            if free_t < job.hosts:
                return {"ok": False,
                        "message": f"slice {t} has only {free_t} free "
                                   f"host(s); {job_id} holds "
                                   f"{job.hosts}"}
            d = Decision(MIGRATE, job_id, hosts=job.hosts,
                         placement={t: job.hosts},
                         source=min(job.placement), target=t,
                         reason=f"operator migrate to slice {t}")
        try:
            applied = self._apply_migrate(d)
        except DurableWriteError as e:
            return {"ok": False,
                    "message": f"fleet journal is dead ({e}); restart "
                               f"with `fleet start --recover`"}
        if not applied:
            return {"ok": False,
                    "message": "the job's coordinator refused the move "
                               "or is unreachable — see the daemon log"}
        return {"ok": True, "job": job_id, "source": d.source,
                "target": t, "placement": {str(t): job.hosts}}

    def _restore(self) -> None:
        """Grow shrunk victims back toward their requested size once the
        queue has drained — preemption is a loan. The grow rides the
        same elastic resize path (and, with a warm pool configured, the
        fresh members adopt pre-warmed executors — the ≤2s regrow)."""
        with self._lock:
            candidates = self.engine.restore_candidates()
        for job_id, new_hosts, delta in candidates:
            with self._lock:
                job = self.jobs.get(job_id)
                if job is None or job.state != RUNNING:
                    continue
            if not self.runner.resize(job.workdir, new_hosts):
                continue
            with self._lock:
                placement = self.engine.grow_applied(job_id, delta)
                job.hosts = new_hosts
                job.placement = placement
                job.host_events.append((int(time.time() * 1000),
                                        new_hosts))
                self._reconcile_hosts_locked(job, placement)
            self.journal.state(job_id, fjournal.STATE_RESTORED,
                               hosts=new_hosts, placement=placement)
            self.tracer.instant("fleet.restore", parent=job.job_span,
                                task=job_id,
                                attrs={"hosts": new_hosts})
            log.info("fleet restore: %s grown back to %d host(s)",
                     job_id, new_hosts)

    # -- host health (tony_tpu_torch/fleet/health.py) ---------------------------
    def _refresh_cordoned_names_locked(self) -> None:
        """Caller holds the lock. The CAPACITY_DENIED explainer names
        cordoned hosts that are actually out of the pool — a probation
        canary currently leased to a job is in-use, not a hold cause."""
        leased = {h for hs in self.book.assigned.values() for h in hs}
        self.engine.cordoned_names = [
            n for n in self.book.cordoned_names() if n not in leased]

    def _reconcile_hosts_locked(self, job: _FleetJob,
                         placement: Dict[int, int]) -> None:
        """Caller holds the lock. A resize/migration changed the job's
        per-slice counts: trim/extend its concrete host set to match,
        moving any freed cordon-pending slot out of the pool's free
        accounting (a shrink is the fastest way to get a sick slot out
        of a live gang — the book frees those first)."""
        for i, n in self.book.reconcile(job.req.job_id,
                                        placement).items():
            for _ in range(n):
                self.engine.pool.cordon_free(i)
        job.host_ids = list(self.book.assigned.get(job.req.job_id)
                            or [])
        self._refresh_cordoned_names_locked()

    def _apply_health_records(
            self, records: List[Dict[str, Any]]) -> None:
        """Land a batch of host-health transitions: write-ahead journal
        each record, mirror the free/cordoned delta into the pool's
        count accounting, and emit the operator-facing events. Journal
        appends run OUTSIDE the lock (they fsync)."""
        for rec in records:
            self.journal.health(rec)
            i = int(rec.get("slice", -1))
            with self._lock:
                if rec.get("canary") or rec.get("now_free"):
                    self.engine.pool.uncordon(i)
                elif rec.get("was_free"):
                    self.engine.pool.cordon_free(i)
                self._refresh_cordoned_names_locked()
            state = str(rec.get("state", ""))
            if state == fhealth.QUARANTINED:
                self.metrics.counter(
                    "tony_fleet_quarantines_total",
                    help="host quarantines applied (score, probe, "
                         "manual, sick-slice)").inc()
                self.events.emit(Event(EventType.FLEET_HOST_QUARANTINED, {
                    "host": rec.get("host", ""), "slice": i,
                    "score": rec.get("score", 0.0),
                    "manual": bool(rec.get("manual")),
                    "reason": rec.get("reason", "")}))
                log.warning("fleet health: %s quarantined (%s)",
                            rec.get("host"), rec.get("reason"))
            elif state == fhealth.HEALTHY and (
                    rec.get("now_free") is not None
                    or "canary" in str(rec.get("reason", ""))):
                self.events.emit(Event(EventType.FLEET_HOST_RESTORED, {
                    "host": rec.get("host", ""), "slice": i,
                    "reason": rec.get("reason", "")}))
                log.info("fleet health: %s restored (%s)",
                         rec.get("host"), rec.get("reason"))

    def _tail_job_events(self, job: _FleetJob,
                         path: str) -> List[Dict[str, Any]]:
        """Incremental tail of one job's event stream from the last
        byte offset: complete JSON lines only (a torn tail stays unread
        until its newline lands), offsets survive file finalization via
        monotonic-size heuristics (the rename keeps the content)."""
        job_id = job.req.job_id
        with self._lock:
            offset = self._health_offsets.get(job_id, 0)
        try:
            size = os.path.getsize(path)
            if size <= offset:
                return []
            with open(path, "rb") as f:
                f.seek(offset)
                chunk = f.read()
        except OSError:
            return []
        # Only complete lines advance the offset.
        end = chunk.rfind(b"\n")
        if end < 0:
            return []
        with self._lock:
            self._health_offsets[job_id] = offset + end + 1
        out: List[Dict[str, Any]] = []
        for raw in chunk[:end].split(b"\n"):
            raw = raw.strip()
            if not raw:
                continue
            try:
                out.append(json.loads(raw.decode("utf-8")))
            except (ValueError, UnicodeDecodeError):
                continue
        return out

    #: event-type -> evidence kind for non-TASK_FINISHED feeders
    _HEALTH_EVENT_KINDS = {"TASK_HUNG": "hang",
                           "TASK_STRAGGLER": "straggler"}

    def _attribute_failures(self) -> List[Any]:
        """(host, kind, job_id, ts_ms) attributions tailed from running
        jobs' event streams: TASK_FINISHED with an infra failure domain
        (heartbeat expiries and host.loss absorbs arrive this way,
        domain INFRA_TRANSIENT), hang kills, straggler flags.
        USER_ERROR never counts — a user bug says nothing about the
        machine."""
        with self._lock:
            running = [(j, list(j.host_ids)) for j in self.jobs.values()
                       if j.state == RUNNING and j.app_id and j.host_ids]
        if not running:
            return []
        dirs = fledger.job_history_dirs(self.fleet_dir)
        out: List[Any] = []
        for job, host_ids in running:
            job_dir = dirs.get(job.app_id)
            if not job_dir:
                continue
            path = None
            try:
                for name in sorted(os.listdir(job_dir)):
                    if name.endswith(constants.EVENTS_SUFFIX) \
                            or name.endswith(constants.INPROGRESS_SUFFIX):
                        path = os.path.join(job_dir, name)
                        break
            except OSError:
                continue
            if path is None:
                continue
            for rec in self._tail_job_events(job, path):
                etype = str(rec.get("type", ""))
                payload = rec.get("event") or {}
                ts_ms = int(rec.get("timestamp", 0) or 0)
                task = str(payload.get("task", "") or "")
                kind = ""
                if etype == "TASK_FINISHED":
                    kind = str(payload.get("failure_domain", "") or "")
                    if kind not in ("INFRA_TRANSIENT", "PREEMPTION"):
                        continue    # success or USER_ERROR: no evidence
                else:
                    kind = self._HEALTH_EVENT_KINDS.get(etype, "")
                    if not kind:
                        continue
                try:
                    idx = int(task.rsplit(":", 1)[-1])
                except ValueError:
                    continue
                host = host_ids[idx % len(host_ids)]
                out.append((host, kind, job.req.job_id, ts_ms))
        return out

    def _health_tick(self) -> None:
        """The attribution + state-machine pass, before the scheduler
        plan so fresh cordons shape this tick's placements. Also the
        ``host.flaky`` drill feed: a fired site kills the pinned host's
        job (the real-world analogue is the task dying there) and
        attributes the failure."""
        if not self.health_cfg.enabled:
            return
        now = time.monotonic()
        attributions = self._attribute_failures()
        with self._lock:
            running = [(j, list(j.host_ids)) for j in self.jobs.values()
                       if j.state == RUNNING and j.host_ids]
        for job, host_ids in running:
            for host in host_ids:
                if faults.fire("host.flaky", task_id=host):
                    attributions.append(
                        (host, "INFRA_TRANSIENT", job.req.job_id,
                         int(time.time() * 1000)))
                    log.warning(
                        "fleet health: host.flaky fired on %s — "
                        "killing %s (drill)", host, job.req.job_id)
                    self.runner.kill(job.workdir)
                    with self._lock:
                        # The fake runners used in drills have no
                        # process to reap; mark the exit so _poll_jobs
                        # terminalizes the job this tick. Real Popen
                        # handles reap through poll() as usual.
                        if job.handle is not None \
                                and not isinstance(job.handle,
                                                   subprocess.Popen) \
                                and getattr(job.handle, "returncode",
                                            137) is None:
                            job.handle.returncode = 137
        records: List[Dict[str, Any]] = []
        with self._lock:
            for host, kind, job_id, ts_ms in attributions:
                records.extend(self.book.record_failure(
                    host, kind, job_id, now, ts_ms=ts_ms))
            tick_recs, sick = self.book.tick(now)
            records.extend(tick_recs)
        if records:
            self._apply_health_records(records)
        for i in sick:
            self.metrics.counter(
                "tony_fleet_sick_slices_total",
                help="whole-slice cordons from correlated host "
                     "failures").inc()
            self.events.emit(Event(EventType.FLEET_SLICE_CORDONED, {
                "slice": i, "blast_n": self.health_cfg.blast_n,
                "window_s": self.health_cfg.blast_window_s}))
            log.warning("fleet health: slice %d is SICK (>= %d "
                        "correlated suspects) — cordoned, evacuating "
                        "its jobs", i, self.health_cfg.blast_n)
            with self._lock:
                self._dying_slices.add(i)

    def _assign_with_probe(
            self, job: _FleetJob, placement: Dict[int, int]
    ) -> Optional[Any]:
        """Pick concrete hosts for a grant and preflight-probe each.
        A probe failure cordons the host and the loop re-picks with a
        spare substituted — the grant self-repairs instead of failing
        the job. Returns (host_ids, canary records), or None when the
        placement can no longer be covered (the job stays queued; the
        next tick re-plans around the new cordons)."""
        job_id = job.req.job_id
        probe_dir = os.path.join(self.fleet_dir, "probe")
        for _ in range(self.slices * self.hosts_per_slice + 1):
            now = time.monotonic()
            with self._lock:
                try:
                    host_ids, canaries = self.book.assign(
                        job_id, placement, job.req.priority, now)
                except ValueError as e:
                    log.warning("fleet health: grant of %s cannot be "
                                "covered (%s); job stays queued",
                                job_id, e)
                    return None
            failed = []
            for h in host_ids:
                why = fhealth.preflight_probe(h, probe_dir)
                if why is not None:
                    failed.append((h, why))
            if not failed:
                return host_ids, canaries
            recs: List[Dict[str, Any]] = []
            with self._lock:
                self.book.unassign(job_id)
                for h, why in failed:
                    rec = self.book.cordon(
                        h, reason=f"preflight probe failed: {why}",
                        now=now, kind="probe",
                        ts_ms=int(time.time() * 1000))
                    if rec is not None:
                        recs.append(rec)
            self._apply_health_records(recs)
            log.warning("fleet grant %s: preflight probe cordoned "
                        "%s — substituting spare(s)", job_id,
                        [h for h, _ in failed])
        return None

    # -- operator verbs (fleet cordon|uncordon|health) --------------------
    def cordon(self, host: str, reason: str = "") -> dict:
        if self.journal.dead is not None:
            return {"ok": False,
                    "message": f"fleet journal is dead "
                               f"({self.journal.dead}); restart with "
                               f"`fleet start --recover`"}
        why = f"operator cordon: {reason}" if reason \
            else "operator cordon"
        with self._lock:
            rec = self.book.cordon(host, reason=why,
                                   now=time.monotonic(), manual=True)
        if rec is None:
            return {"ok": False, "message": f"unknown host {host!r} "
                    f"(hosts are s<slice>h<index>)"}
        try:
            self._apply_health_records([rec])
        except DurableWriteError as e:
            return {"ok": False,
                    "message": f"fleet journal is dead ({e}); restart "
                               f"with `fleet start --recover`"}
        return {"ok": True, "host": host, "state": rec["state"],
                "was_free": bool(rec.get("was_free"))}

    def uncordon(self, host: str) -> dict:
        if self.journal.dead is not None:
            return {"ok": False,
                    "message": f"fleet journal is dead "
                               f"({self.journal.dead}); restart with "
                               f"`fleet start --recover`"}
        with self._lock:
            rec = self.book.uncordon(host, now=time.monotonic())
        if rec is None:
            return {"ok": False,
                    "message": f"host {host!r} is unknown or not "
                               f"cordoned"}
        try:
            self._apply_health_records([rec])
        except DurableWriteError as e:
            return {"ok": False,
                    "message": f"fleet journal is dead ({e}); restart "
                               f"with `fleet start --recover`"}
        return {"ok": True, "host": host, "state": rec["state"],
                "leased": not bool(rec.get("now_free"))}

    def health_status(self) -> dict:
        """`tony-tpu fleet health`: the per-host ledger, worst first."""
        with self._lock:
            rows = self.book.snapshot(time.monotonic())
            cordoned = self.book.cordoned_names()
            sick = self.book.sick_slices
        return {"ok": True, "enabled": self.health_cfg.enabled,
                "hosts": rows, "cordoned": cordoned,
                "sick_slices": sick}

    # -- goodput ledger (tony_tpu_torch/fleet/ledger.py) ------------------------
    def _ledger_fold_input(self, job: _FleetJob) -> fjournal.JobFold:
        return fjournal.JobFold(
            job_id=job.req.job_id, tenant=job.req.tenant,
            priority=job.req.priority, hosts_requested=job.req.hosts,
            min_hosts=job.req.min_hosts, model=job.req.model,
            seq=job.req.seq, state=job.state, hosts=job.hosts,
            app_id=job.app_id, submitted_ms=job.submitted_ms,
            granted_ms=job.granted_ms, finished_ms=job.finished_ms,
            host_events=list(job.host_events))

    def _fold_ledger_job(self, job: _FleetJob,
                         dirs: Optional[Dict[str, str]] = None) -> None:
        """Fold ONE job's ledger (terminal jobs fold exactly once, at
        finish). Fault site ``fleet.ledger``: any failure degrades the
        fleet to counters-only — goodput gauges and the per-tenant
        table go absent, the scheduler tick never blocks."""
        if self._ledger_degraded:
            return
        try:
            faults.check("fleet.ledger")
            if dirs is None:
                dirs = fledger.job_history_dirs(self.fleet_dir)
            # Compute OUTSIDE the lock (the fold reads job-dir files);
            # only the cache install is a critical section — status()
            # RPC threads snapshot the same maps under the same lock.
            row = fledger.compute_job_ledger(
                self._ledger_fold_input(job),
                job_dir=dirs.get(job.app_id),
                now_ms=int(time.time() * 1000))
            with self._lock:
                self._ledgers[job.req.job_id] = row
                self._ledger_rollup = None  # dirty: rebuilt on export
        except Exception as e:  # noqa: BLE001 — observability, not duty
            self._ledger_degraded = True
            log.warning(
                "fleet: goodput-ledger fold failed (%s) — degrading to "
                "counters-only (no goodput gauges / per-tenant table) "
                "for the rest of this daemon life", e)

    def _refresh_ledger(self) -> None:
        """Throttled refresh for RUNNING jobs (their queued/startup/
        train phases are provisional and keep growing); terminal jobs
        folded at finish are left alone."""
        if self._ledger_degraded:
            return
        now = time.monotonic()
        if now < self._ledger_next_mono:
            return
        self._ledger_next_mono = now + self.ledger_interval_s
        with self._lock:
            live = [j for j in self.jobs.values()
                    if j.state not in fjournal.TERMINAL_STATES]
            missing = [j for j in self.jobs.values()
                       if j.state in fjournal.TERMINAL_STATES
                       and j.req.job_id not in self._ledgers]
        dirs = fledger.job_history_dirs(self.fleet_dir)
        for job in live + missing:
            self._fold_ledger_job(job, dirs=dirs)
            if self._ledger_degraded:
                return

    def _ledger_snapshot(self) -> Optional[Dict[str, Any]]:
        if self._ledger_degraded:
            return None
        # status() runs on RPC threads while the tick thread folds: the
        # rollup cache check-then-build must be one critical section
        # (the tonyrace bring-up flagged the unlocked read/write pair
        # here — tick fold vs fleet.status).
        with self._lock:
            if self._ledger_rollup is None:
                self._ledger_rollup = fledger.rollup(
                    list(self._ledgers.values()))
            return self._ledger_rollup

    # -- the decision explainer's query surface ---------------------------
    def explain(self, job_id: str) -> dict:
        """`tony-tpu fleet explain <job>`: the job's causal hold
        timeline — every recorded reason transition with the blocking
        jobs/tenants named, plus the grant/preempt/finish milestones."""
        with self._lock:
            job = self.jobs.get(job_id)
            if job is None:
                return {"ok": False,
                        "message": f"unknown job {job_id!r}"}
            decisions = list(job.decisions)
            milestones: List[Dict[str, Any]] = [
                {"ts_ms": job.submitted_ms,
                 "what": f"submitted by tenant {job.req.tenant!r} "
                         f"(priority {job.req.priority}, "
                         f"{job.req.hosts} host(s))"}]
            if job.granted_ms:
                milestones.append({"ts_ms": job.granted_ms,
                                   "what": f"granted {job.hosts or '?'}"
                                           f" host(s)"})
            for ts, hosts in job.host_events[1:]:
                milestones.append({"ts_ms": ts,
                                   "what": f"resized to {hosts} "
                                           f"host(s)"})
            if job.finished_ms:
                milestones.append({"ts_ms": job.finished_ms,
                                   "what": f"finished {job.state}"})
            from tony_tpu_torch.fleet import timeline as ftimeline

            return {"ok": True, "job": job_id, "state": job.state,
                    "tenant": job.req.tenant, "app_id": job.app_id,
                    "decisions": decisions,
                    # Decision.blocking/free rolled up into attributed
                    # hold seconds (same algebra as the offline path
                    # and the what-if differ — fleet/timeline.py).
                    "holds": ftimeline.holds_summary(
                        ftimeline.hold_intervals(
                            decisions, granted_ms=job.granted_ms,
                            finished_ms=job.finished_ms,
                            now_ms=int(time.time() * 1000),
                            hosts=job.req.hosts)),
                    "milestones": milestones}

    # -- alerting ---------------------------------------------------------
    def _alerts_tick(self) -> None:
        """Evaluate the fleet-scope alert pack against the daemon's own
        registry. Degrade contract (the fleet.ledger shape): any
        evaluator failure disables alerting for the rest of this daemon
        life with one warning — the scheduler tick never blocks."""
        if self._alerts_degraded:
            return
        try:
            faults.check("alerts.eval")
            for tr in self.alerts.evaluate(
                    falerts.RegistrySource(self.metrics)):
                self._apply_alert_transition(tr)
        except Exception as e:  # noqa: BLE001 — observability, not duty
            self._alerts_degraded = True
            log.warning(
                "fleet: alert evaluation failed (%s) — degrading: "
                "alerting disabled for the rest of this daemon life", e)

    def _apply_alert_transition(self, tr: falerts.Transition) -> None:
        """REC_FLEET_ALERT write-ahead (dedup-fenced by the engine),
        then counter + firing gauge + the fleet-scope ALERT event."""
        if tr.journal:
            self.journal.alert(tr.rule, tr.state, tr.severity, tr.value,
                               tr.labels, tr.summary)
        self.metrics.counter(
            "tony_alert_transitions_total", {"state": tr.state},
            help="alert state-machine transitions journaled").inc()
        for sev, n in self.alerts.firing_count().items():
            self.metrics.gauge(
                "tony_alerts_firing", {"severity": sev},
                help="alerts currently firing, by severity").set(n)
        payload = {"rule": tr.rule, "severity": tr.severity,
                   "value": tr.value, "labels": tr.labels,
                   "summary": tr.summary, "scope": "fleet"}
        if tr.state == "firing":
            log.warning("fleet ALERT firing [%s]: %s (value=%s)",
                        tr.severity, tr.rule, tr.value)
            self.events.emit(Event(EventType.ALERT_FIRING, payload))
        elif tr.state == "resolved":
            log.info("fleet alert resolved: %s", tr.rule)
            self.events.emit(Event(EventType.ALERT_RESOLVED, payload))

    def alerts_status(self) -> dict:
        """The `fleet.alerts` RPC: full per-rule state."""
        return {"fleet_dir": self.fleet_dir, "scope": "fleet",
                "degraded": self._alerts_degraded,
                "alerts": self.alerts.snapshot()}

    def _diagnosis_bundle(self) -> Dict[str, Any]:
        """The in-memory twin of diagnose.bundle_from_dir — same keys,
        no file reads, cheap enough for every export."""
        with self._lock:
            now = time.monotonic()
            queue = [{
                "job": j.req.job_id, "tenant": j.req.tenant,
                "priority": j.req.priority, "hosts": j.req.hosts,
                "wait_s": now - j.submitted_mono,
                "last_decision": j.decisions[-1] if j.decisions else {}}
                for j in self.jobs.values() if j.state == QUEUED]
            used = self.engine.tenant_used()
            waits = sorted(self._grant_waits)
            per_job = dict(self._preempts_per_job)
            health = {
                "enabled": self.health_cfg.enabled,
                "cordoned": [dict(host=h.host, state=h.state,
                                  score=round(h.score, 3),
                                  manual=h.manual,
                                  evidence=list(h.evidence[-4:]))
                             for h in self.book.cordoned_hosts()],
                "sick_slices": self.book.sick_slices,
            }
        return {
            "fleet_dir": self.fleet_dir,
            "quotas": dict(self.quotas), "tenants_used": used,
            "queue": queue,
            "median_grant_wait_s": waits[len(waits) // 2]
            if waits else 0.0,
            "grants_total": int(self.metrics.counter(
                "tony_fleet_grants_total").value),
            "preemptions_total": int(self.metrics.counter(
                "tony_fleet_preemptions_total").value),
            "preempts_per_job": per_job,
            "ledger": self._ledger_snapshot() or {},
            "health": health,
            # Firing alerts as rule evidence: an alert that was firing
            # when the incident was built is a precedence-boosted input
            # to the fleet diagnosis rules.
            "alerts": self.alerts.firing(),
            "pool_dir": self.pool_dir,
        }

    # -- surfaces ---------------------------------------------------------
    def _export(self) -> None:
        self._refresh_ledger()
        snap = self.status()
        pool = snap["pool"]
        for state in ("total", "used", "free", "cordoned"):
            self.metrics.gauge("tony_fleet_hosts", {"state": state},
                               help="pool hosts by state").set(
                pool[state])
        # Host-health families + the cordon handshake file the warm
        # pool reads (fleet/health.py): snapshot under the lock, write
        # outside it.
        rank = {fhealth.HEALTHY: 0, fhealth.SUSPECT: 1,
                fhealth.PROBATION: 2, fhealth.QUARANTINED: 3}
        with self._lock:
            host_states = [(h.host, h.state)
                           for h in self.book.hosts.values()]
            cordons = {h.host: h.state
                       for h in self.book.cordoned_hosts()}
        for host, state in host_states:
            self.metrics.gauge(
                "tony_fleet_host_health", {"host": host},
                help="per-host health state (0 healthy, 1 suspect, "
                     "2 probation, 3 quarantined)").set(
                rank.get(state, 0))
        self.metrics.gauge(
            "tony_fleet_quarantined_hosts",
            help="hosts currently cordoned by health quarantine or "
                 "probation").set(len(cordons))
        for root in filter(None, (self.fleet_dir, self.pool_dir)):
            try:
                fhealth.write_cordon_file(
                    os.path.join(root, constants.FLEET_CORDON_FILE),
                    cordons)
            except OSError:
                log.debug("cordon-file export to %s failed", root)
        by_state = {s: 0 for s in (QUEUED, GRANTED, RUNNING)
                    + fjournal.TERMINAL_STATES}
        for row in snap["jobs"]:
            by_state[row["state"]] = by_state.get(row["state"], 0) + 1
        for state, n in by_state.items():
            # Zero-filled over the full state set so a drained queue
            # reads as 0, not as a frozen last value.
            self.metrics.gauge("tony_fleet_jobs", {"state": state},
                               help="fleet jobs by state").set(n)
        self.metrics.gauge("tony_fleet_queue_depth",
                           help="submissions waiting for a grant").set(
            snap["queue_depth"])
        for tenant, row in snap["tenants"].items():
            self.metrics.gauge("tony_fleet_tenant_hosts",
                               {"tenant": tenant},
                               help="granted hosts per tenant").set(
                row["used"])
        ledger = snap.get("ledger")
        if ledger:
            # The goodput families (tony_tpu_torch/fleet/ledger.py): absent
            # entirely while the ledger is degraded — counters-only, the
            # fleet.ledger fault-site contract.
            fleet_row = ledger.get("fleet") or {}
            if fleet_row.get("goodput_fraction") is not None:
                self.metrics.gauge(
                    "tony_fleet_goodput_fraction",
                    help="chip-seconds doing useful train steps / "
                         "chip-seconds held, per tenant and "
                         "fleet-wide").set(
                    fleet_row["goodput_fraction"])
            for tenant, trow in (ledger.get("tenants") or {}).items():
                if trow.get("goodput_fraction") is not None:
                    self.metrics.gauge(
                        "tony_fleet_goodput_fraction",
                        {"tenant": tenant}).set(
                        trow["goodput_fraction"])
                for phase, secs in (trow.get("phase_chip_s")
                                    or {}).items():
                    self.metrics.gauge(
                        "tony_fleet_phase_seconds",
                        {"phase": phase, "tenant": tenant},
                        help="cumulative ledger chip-seconds per "
                             "goodput phase and tenant").set(secs)
        try:
            from tony_tpu_torch.fleet import diagnose as fdiagnose

            fdiagnose.save_incident(
                self.fleet_dir,
                fdiagnose.build_incident(self._diagnosis_bundle()))
        except Exception:  # noqa: BLE001 — diagnosis must degrade
            log.exception("fleet incident export failed")
        atomic_write(
            os.path.join(self.fleet_dir, constants.FLEET_PROM_FILE),
            self.metrics.render().encode("utf-8"))
        atomic_write(
            os.path.join(self.fleet_dir, constants.FLEET_STATUS_FILE),
            json.dumps(snap, sort_keys=True).encode("utf-8"))
        self.metrics.save_counters(self._counters_path)
