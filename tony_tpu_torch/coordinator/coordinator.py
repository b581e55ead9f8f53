"""The job coordinator: per-job controller process.

Reference model: ``ApplicationMaster.java`` (1238 LoC) — lifecycle
prepare→start→monitor→(reset/retry)→stop (:296-297, ``run`` :312):
registers RPC servers (:402-413), writes the frozen config + event stream to
the history dir (:456-457), launches executors, runs the heartbeat liveness
monitor (:188-208), applies whole-job retry by resetting the session with a
bumped session id (:356-371, :559-575), and waits for the client's finish
signal before tearing down (:684).

TPU-first deltas:
- No container-allocation matching: the backend launches whole gangs (slice
  leases are atomic — SURVEY.md §7 hard part (a)).
- One RPC server carries the application + metrics surfaces.
- The rendezvous the coordinator brokers doubles as the JAX coordination
  bootstrap: task 0's spec becomes ``JAX_COORDINATOR_ADDRESS`` downstream.

Fault-injection hooks honoured here (reference ``Constants.java:116-121``,
SURVEY.md §4.1): TEST_COORDINATOR_CRASH (AM crash analogue,
``ApplicationMaster.java:338-343``), TEST_WORKER_TERMINATION (:1224-1235),
TEST_COMPLETION_DELAY (:1029-1038).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, List, Optional

from tony_tpu_torch import constants, faults, tracing
from tony_tpu_torch.alerts import AlertEngine, RegistrySource, default_job_pack
from tony_tpu_torch.cluster.base import Backend, TaskLaunchSpec
from tony_tpu_torch.metrics import MetricsRegistry
from tony_tpu_torch.conf.config import TonyTpuConfig
from tony_tpu_torch.conf import keys as K
from tony_tpu_torch.coordinator import journal, liveness
from tony_tpu_torch.coordinator.coordphases import CoordPhases
from tony_tpu_torch.coordinator.elastic import (BARRIER, DRAIN, ElasticManager,
                                          ResizeRefused)
from tony_tpu_torch.coordinator.journal import SessionJournal
from tony_tpu_torch.coordinator.liveness import ProgressTracker
from tony_tpu_torch.coordinator.migrate import MigrateRefused, plan_migration
from tony_tpu_torch.coordinator.scheduler import GangScheduler
from tony_tpu_torch.coordinator.session import (FailureDomain, Session,
                                          SessionStatus, Task, TaskStatus)
from tony_tpu_torch.devtools.race import guarded
from tony_tpu_torch.diagnosis.exitcodes import describe_exit
from tony_tpu_torch.events.events import Event, EventHandler, EventType
from tony_tpu_torch.events import history
from tony_tpu_torch.rpc.wire import FencedError, RpcServer
from tony_tpu_torch.utils import durable
from tony_tpu_torch.utils.durable import DurableWriteError

log = logging.getLogger(__name__)


class CoordinatorCrash(RuntimeError):
    """Raised by the TEST_COORDINATOR_CRASH hook."""


class _RpcService:
    """The 7-method application surface + metrics, dispatched by RpcServer.

    Reference: ``tensorflow_cluster_service_protos.proto:11-19`` —
    getTaskInfos / getClusterSpec / registerWorkerSpec / registerTensorBoardUrl
    / registerExecutionResult / finishApplication / taskExecutorHeartbeat —
    plus the Writable metrics channel (``rpc/MetricsRpc.java``).
    """

    def __init__(self, coord: "Coordinator"):
        self._c = coord

    # NOTE: the reference's getTaskInfos/getClusterSpec RPCs are gone on
    # purpose (tonylint rpc-parity: dead surface). register_worker_spec
    # returns the cluster spec once the barrier opens, and
    # get_application_report carries per-task info — nothing ever called
    # the standalone methods.

    def register_worker_spec(self, task_id: str, host: str, port: int,
                             session_id: int = -1,
                             mgen: int = -1) -> Optional[dict]:
        return self._c.register_worker_spec(task_id, host, port,
                                            session_id=session_id,
                                            mgen=mgen)

    def register_tensorboard_url(self, task_id: str, url: str,
                                 session_id: int = -1) -> bool:
        return self._c.register_tensorboard_url(task_id, url,
                                                session_id=session_id)

    def register_execution_result(self, task_id: str, exit_code: int,
                                  session_id: int = -1,
                                  diagnostics: Optional[dict] = None) -> int:
        return self._c.register_execution_result(task_id, exit_code,
                                                 session_id=session_id,
                                                 diagnostics=diagnostics)

    def finish_application(self) -> str:
        self._c.client_signalled_finish.set()
        return self._c.final_status.value

    def task_executor_heartbeat(self, task_id: str, session_id: int = -1,
                                progress: Optional[dict] = None,
                                mgen: int = -1):
        return self._c.heartbeat(task_id, session_id=session_id,
                                 progress=progress, mgen=mgen)

    def resize_application(self, size: int, job: str = "") -> dict:
        """Operator-initiated elastic resize (`tony-tpu resize`)."""
        return self._c.resize_application(int(size), job=str(job or ""))

    def migrate_application(self, target: str, job: str = "",
                            reason: str = "") -> dict:
        """Live migration to another slice (`tony-tpu migrate`)."""
        return self._c.migrate_application(str(target or ""),
                                           job=str(job or ""),
                                           reason=str(reason or ""))

    def get_application_report(self) -> dict:
        return self._c.application_report()

    def kill_application(self) -> bool:
        """Client-initiated force kill (reference
        ``TonyClient.forceKillApplication`` :959)."""
        self._c.request_stop("killed by client")
        return True

    def metrics__push(self, task_id: str, metrics: dict) -> bool:
        return self._c.metrics_push(task_id, metrics)

    def metrics__get(self, task_id: str) -> Optional[dict]:
        return self._c.metrics_get(task_id)

    def metrics__live(self) -> dict:
        """Live per-task utilization snapshot (the `tony-tpu top` feed)."""
        return self._c.metrics_live()

    def profile__start(self, steps: int = 0, task: str = "") -> dict:
        """On-demand device capture (`tony-tpu profile <app>`): arm
        jax.profiler on a RUNNING task at its next step boundary."""
        return self._c.profile_start(int(steps or 0), str(task or ""))

    def profile__status(self) -> dict:
        """Poll surface for the profile CLI: every request + its state."""
        return self._c.profile_status()

    def trace__push(self, records) -> int:
        """Executor/client span intake: remote spans land in the job's
        span log, stitching the cross-process trace tree."""
        return self._c.ingest_trace_records(records)

    def alerts(self) -> dict:
        """Live alert state (`tony-tpu alerts <app>`, portal banner)."""
        return self._c.alerts_snapshot()


@guarded
class Coordinator:
    #: tonyrace registry (devtools/race.py + the guarded-by lint): the
    #: beat-path maps are written by RPC handler threads (heartbeat
    #: beacon fold, metrics.push, execution-result diagnostics) and read
    #: by other RPC threads (metrics.live) and the monitor tick
    #: (heartbeat expiry, report building, teardown) — every touch
    #: holds ``_hb_lock``; the profile directive map keeps its own lock.
    #: The None entries are audited single-writer/atomic rebinds: spans
    #: and scheduler state owned by the monitor thread, throttles, and
    #: status scalars whose readers tolerate old-or-new.
    GUARDED_BY = {
        "_last_hb": "_hb_lock",
        "metrics_store": "_hb_lock",
        "_task_diag": "_hb_lock",
        "_phase_latest": "_hb_lock",
        "_recovered_steps": "_hb_lock",
        "_progress_journal_t": "_hb_lock",
        "_profile_reqs": "_profile_lock",
        "_profile_seq": "_profile_lock",
        # -- audited, not lock-enforced (atomic/single-writer) ---------
        "tb_url": None,
        "final_status": None,
        "scheduler": None,
        "_stop_reason": None,
        "_reregistration_grace": None,
        "_infra_retries_used": None,
        "_preempt_retries_used": None,
        "_attempt": None,
        "_schedule_start": None,
        "_worker_termination_done": None,
        "_final_conf_path": None,
        "_alerts_degraded": None,
        "_prom_last_write": None,
        "_prom_thread": None,
        "_run_span": None,
        "_epoch_span": None,
        "_rendezvous_span": None,
        "session": None,
    }

    def __init__(self, conf: TonyTpuConfig, app_id: str, backend: Backend,
                 history_root: str, user: str = "",
                 rpc_token: Optional[str] = None,
                 recover: bool = False, addr_file: str = ""):
        self.conf = conf
        self.app_id = app_id
        self.backend = backend
        self.user = user or os.environ.get("USER", "unknown")
        self.history_root = history_root
        # Where this coordinator's host/port/token lands (written by
        # __main__/the client); exported to executors so they can
        # RE-resolve a restarted coordinator (new ephemeral port).
        self.addr_file = addr_file
        job_dir = history.intermediate_dir(history_root, app_id)
        self.job_dir = job_dir
        self.journal_path = os.path.join(job_dir, constants.JOURNAL_FILE)
        # --- crash recovery: replay the write-ahead journal BEFORE any
        # other state exists — the fencing generation must be known before
        # the RPC server is created, and the original started_ms before
        # the event stream reattaches to its in-progress file.
        self._recover_state: Optional[journal.ReplayState] = None
        if recover:
            self._recover_state = journal.replay(self.journal_path)
            if self._recover_state.torn_tail:
                log.warning("journal had a torn tail; recovered from the "
                            "%d-record prefix",
                            self._recover_state.records)
        st = self._recover_state
        # Generations are monotonic across coordinator lives: 1 for a
        # fresh job, last-journaled + 1 on every recovery. Carried in
        # every RPC frame (rpc/wire.py) — the split-brain fence.
        self.generation = (st.generation + 1) if st else 1
        self.session = Session(conf, session_id=st.session_id if st else 0)
        # Elastic membership (coordinator/elastic.py): None when the knob
        # is off — every elastic branch below is `self.elastic is not
        # None` gated, so non-elastic jobs pay nothing.
        self.elastic = ElasticManager(conf) \
            if conf.get_bool(K.ELASTIC_ENABLED) else None
        if st is not None:
            for job_name in sorted(st.scheduled_jobs):
                self.session.mark_job_scheduled(job_name)
            if self.elastic is not None:
                self.elastic.mgen = max(self.elastic.mgen,
                                        st.elastic_mgen)
                # The last APPLIED resize is the matrix the journal's
                # task records describe — rebuild it before folding them.
                for job_name, members in st.applied_members.items():
                    if job_name in self.session.jobs:
                        self.session.resize_job(job_name, members)
                # The last APPLIED migration moved the job: re-pin its
                # node pool so recovery relaunches land on the slice the
                # gang actually runs on, not the conf's original.
                for job_name, target in st.migrated_target.items():
                    if job_name in self.session.jobs:
                        self.session.jobs[job_name].node_pool = target
            for task_id, tr in st.tasks.items():
                self.session.restore_task(
                    task_id, TaskStatus(tr.status),
                    host=tr.host, port=tr.port, exit_code=tr.exit_code,
                    domain=(FailureDomain(tr.domain) if tr.domain
                            else None),
                    registered=tr.registered)
        self.scheduler: Optional[GangScheduler] = None
        self.metrics_store: Dict[str, dict] = {}
        # Executor-shipped postmortem context (register_execution_result
        # `diagnostics`): extracted user traceback + decoded exit signal,
        # folded into the task's TASK_FINISHED and the incident bundle.
        self._task_diag: Dict[str, dict] = {}
        self.tb_url: str = ""
        self.client_signalled_finish = threading.Event()
        self.final_status = SessionStatus.RUNNING
        self._stop_requested = threading.Event()
        self._stop_reason = ""
        # Recovery keeps the ORIGINAL start time: the history filename
        # grammar embeds it, and the recovered coordinator must reattach
        # to (and eventually finalize) the first life's in-progress file.
        self._started_ms = (st.started_ms if st and st.started_ms
                            else int(time.time() * 1000))
        # While True, the monitor runs the re-registration grace window
        # instead of the first-rendezvous registration timeout.
        self._reregistration_grace = st is not None
        # Per-domain retry budgets (coordinator/session.py FailureDomain):
        # INFRA_TRANSIENT draws on retry-count; PREEMPTION draws on its
        # own free budget first (expected churn must not exhaust the
        # budget kept for real failures); USER_ERROR is terminal unless
        # the reference-compat escape hatch is set.
        self._retries_total = conf.get_int(K.APPLICATION_RETRY_COUNT, 0)
        self._preempt_retries_total = conf.get_int(
            K.APPLICATION_PREEMPTION_RETRY_COUNT, 3)
        self._retry_user_errors = conf.get_bool(
            K.APPLICATION_RETRY_USER_ERRORS)
        self._infra_retries_used = st.infra_retries_used if st else 0
        self._preempt_retries_used = st.preempt_retries_used if st else 0
        self._attempt = st.session_id if st else 0
        # Deterministic fault injection (tony.fault.*): install for this
        # process; _task_env forwards the same spec to every executor.
        faults.install_from_conf(conf)
        self._last_hb: Dict[str, float] = {}
        self._hb_lock = threading.Lock()
        # Step-time attribution (tony_tpu_torch/profiling/): the latest phase
        # beacon per task — cumulative per-phase seconds + attributed
        # wall. Values are replaced whole (never mutated), so readers
        # (metrics_live, the perf.json writer) take a dict() snapshot.
        self._phase_latest: Dict[str, dict] = {}
        # On-demand device profiling: task_id → request dict. Directives
        # ride heartbeat responses until the task's beacon reports a
        # terminal status (the PR 3 dump / PR 8 RESIZE pattern, deduped
        # executor-side by the monotonic request id).
        self._profile_reqs: Dict[str, dict] = {}
        self._profile_seq = 0
        self._profile_lock = threading.Lock()
        # Progress-based liveness on top of the heartbeat monitor
        # (coordinator/liveness.py): executors piggyback step-counter
        # beacons on heartbeats; this tracker turns frozen counters into
        # hang verdicts and rate skew into straggler events. On recovery,
        # journalled counters re-arm each task with a FRESH deadline as
        # it re-registers — the outage must not expire deadlines.
        self.progress = ProgressTracker(conf)
        self._recovered_steps: Dict[str, float] = \
            {tid: tr.steps for tid, tr in st.tasks.items()
             if tr.steps >= 0} if st else {}
        self._progress_journal_t: Dict[str, float] = {}
        self._schedule_start: float = 0.0
        self._worker_termination_done = False
        self._final_conf_path = ""

        # --- distributed tracing (tony_tpu_torch/tracing.py): the coordinator
        # owns the job's span log, next to the jhist stream. A recovered
        # coordinator rejoins the ORIGINAL trace (id read back from the
        # log) so the outage shows up as a gap in one tree, not two trees.
        trace_path = os.path.join(job_dir, constants.TRACE_FILE)
        trace_id = tracing.existing_trace_id(trace_path) if st else ""
        self.tracer = tracing.Tracer(
            trace_id=trace_id or os.environ.get(constants.TRACE_ID_ENV)
            or None,
            service="coordinator", path=trace_path,
            enabled=conf.get_bool(K.TRACE_ENABLED, True))
        mode = str(conf.get(K.TRACE_RPC_SPANS, "significant") or "")
        self._rpc_span_mode = mode if mode in ("all", "significant",
                                               "off") else "significant"
        # Launch-path spans from the backend (pool.lease adoption) join
        # the same tree — the backend parents them under the task
        # lifecycle span id it finds in the launch env.
        try:
            backend.set_tracer(self.tracer)
        except Exception:  # noqa: BLE001 — tracing is never load-bearing
            pass
        self._run_span = tracing.NULL_SPAN
        self._epoch_span = tracing.NULL_SPAN
        self._rendezvous_span: Optional[object] = None
        self._task_spans: Dict[str, object] = {}
        # task_id → hosts that already failed it with an INFRA domain
        # this run (exclude-on-retry: a relaunch of the task is steered
        # off those hosts via TaskLaunchSpec.exclude_hosts — a retry
        # that lands back on the hardware that just killed it is a
        # burned epoch). USER_ERROR never records a host: the code
        # would fail anywhere.
        self._failed_hosts: Dict[str, List[str]] = {}

        # --- live metrics (tony_tpu_torch/metrics.py): beacon-fed registry,
        # rendered as Prometheus exposition into <job_dir>/metrics.prom
        # (the portal's /metrics scrape source) on the export cadence.
        # Counters reload across --recover so they never step backwards.
        self.metrics = MetricsRegistry(
            ring_points=conf.get_int(K.METRICS_RING_POINTS, 512))
        self._counters_path = os.path.join(job_dir,
                                           constants.METRICS_COUNTERS_FILE)
        if st is not None:
            self.metrics.load_counters(self._counters_path)
        self._prom_path = os.path.join(job_dir, constants.METRICS_PROM_FILE)
        self._prom_interval_s = float(
            conf.get(K.METRICS_EXPORT_INTERVAL_S, 2.0) or 2.0)
        self._prom_last_write = 0.0
        # Prometheus rendering walks every series — milliseconds at
        # thousand-task width (measured by the prom_export phase below)
        # — so the render+write runs on a single-flight worker, never
        # on the monitor tick or a beat.
        self._prom_thread: Optional[threading.Thread] = None

        # --- control-plane self-observation (coordinator/coordphases.py):
        # the coordinator's OWN per-tick phase ring — hb_scan /
        # journal_fsync / beacon_fold / prom_export / rpc_serve /
        # rendezvous_barrier, sum-to-wall like step phases — exported as
        # tony_coord_* families and classified by the control-plane
        # verdicts (profiling/verdict.py classify_coord). This is the
        # measurement layer the width restructuring (ROADMAP item 5)
        # is aimed by.
        self.coordphases = CoordPhases(
            conf.get_int(K.COORD_PHASE_RING_TICKS, 256))
        self._coord_counter_prev: Dict[str, float] = {}

        # --- alerting (tony_tpu_torch/alerts/): the job-scope rule pack,
        # evaluated on the monitor tick behind the never-blocks-the-tick
        # degrade contract (fault site "alerts.eval"). Every transition
        # is journaled write-ahead as REC_ALERT; on --recover the
        # replayed last-state-per-rule re-arms the engine, so a firing
        # alert survives a coordinator SIGKILL with no duplicate record.
        self._alerts_degraded = not conf.get_bool(K.ALERTS_ENABLED, True)
        self.alerts = AlertEngine(default_job_pack(conf))
        if st is not None and st.alerts:
            self.alerts.seed(st.alerts)

        if rpc_token is None and conf.get_bool(K.APPLICATION_SECURITY_ENABLED):
            import secrets
            rpc_token = secrets.token_hex(16)
        self.rpc_token = rpc_token
        tls = None
        self.tls_cert = str(conf.get(K.SECURITY_TLS_CERT, "") or "")
        if self.tls_cert:
            from tony_tpu_torch.rpc.wire import server_tls_context
            tls = server_tls_context(
                self.tls_cert, str(conf.get(K.SECURITY_TLS_KEY, "")))
        self.rpc = RpcServer(
            _RpcService(self),
            host=str(conf.get(K.COORDINATOR_HOST_KEY)),
            port=conf.get_int(K.COORDINATOR_PORT_KEY, 0),
            token=rpc_token, tls=tls,
            generation=self.generation,
            on_superseded=self._on_superseded,
            on_request=self._on_rpc_request)

        self.events = EventHandler(
            job_dir, history.in_progress_name(app_id, self._started_ms,
                                              self.user),
            on_emit=self._on_event_emitted)
        # Write-ahead journal (crash recovery): opened for append in both
        # lives; the generation bump is the first record of each life so
        # even an immediately-recrashed coordinator leaves a fence trail.
        self.journal = SessionJournal(
            self.journal_path,
            enabled=conf.get_bool(K.COORDINATOR_JOURNAL_ENABLED, True),
            observer=self.coordphases.note_journal_append)
        self.journal.generation(self.generation)
        if st is None:
            self.journal.app(app_id, self._started_ms, self.user)

        hb_interval = conf.get_int(K.TASK_HEARTBEAT_INTERVAL_MS, 1000)
        max_missed = conf.get_int(K.TASK_MAX_MISSED_HEARTBEATS, 25)
        # Reference expiry formula: hbInterval * max(3, maxMisses)
        # (ApplicationMaster.java:205).
        self._hb_expiry_s = hb_interval * max(3, max_missed) / 1000.0

    # ------------------------------------------------------------------
    # Fencing
    # ------------------------------------------------------------------
    def _on_superseded(self, newer_generation: int) -> None:
        """A frame proved a successor coordinator exists (rpc/wire.py
        server-side generation check): THIS process is the zombie half of
        a split brain and must stand down without touching the gang —
        the successor owns it now."""
        log.error("superseded by coordinator generation %d (we are %d); "
                  "standing down", newer_generation, self.generation)
        self.request_stop(
            f"superseded by coordinator generation {newer_generation}")

    def _check_epoch(self, task_id: str, session_id) -> None:
        """Reject RPCs from a stale retry epoch. An executor surviving
        from a pre-reset session must not refresh the NEW epoch's task
        liveness or corrupt its results; the FencedError is terminal on
        the executor side (it kills its user process and exits).
        session_id < 0 = caller doesn't know (accepted — compat)."""
        sid = int(session_id if session_id is not None else -1)
        if sid >= 0 and sid != self.session.session_id:
            raise FencedError(
                f"task {task_id} belongs to session epoch {sid}; the "
                f"coordinator is at epoch {self.session.session_id}")

    # ------------------------------------------------------------------
    # Observability: tracing + live metrics
    # ------------------------------------------------------------------
    #: periodic methods excluded from per-RPC spans in 'significant' mode
    #: (they arrive ~1/s/task and belong in the latency histograms, not
    #: the span log; 'all' traces them anyway, 'off' traces nothing).
    _PERIODIC_RPC = frozenset((
        "task_executor_heartbeat", "metrics.push", "metrics.get",
        "metrics.live", "get_application_report", "trace.push"))

    def _on_rpc_request(self, method: str, seconds: float,
                        ok: bool) -> None:
        """RpcServer hook: every dispatched request lands in the server
        latency histogram + request counter, and significant ones get a
        span parented under the caller's trace context."""
        # Control-plane self-observation: the dispatch's wall (minus
        # whatever its handler already booked to a named phase — journal
        # appends, the beacon fold) lands in the rpc_serve tick phase,
        # and heartbeats feed the beats/s rate.
        self.coordphases.note_dispatch(method, seconds)
        app = {"app": self.app_id}
        self.metrics.histogram(
            "tony_rpc_server_seconds", {**app, "method": method},
            help="Coordinator-side RPC dispatch latency.").observe(seconds)
        self.metrics.counter(
            "tony_rpc_requests_total",
            {**app, "method": method, "ok": str(bool(ok)).lower()},
            help="RPC requests dispatched by the coordinator.").inc()
        if self._rpc_span_mode == "off" or not self.tracer.enabled:
            return
        if self._rpc_span_mode == "significant" \
                and method in self._PERIODIC_RPC:
            return
        ctx = tracing.get_rpc_context()
        end = tracing.now_us()
        self.tracer.emit(f"rpc.{method}", start_us=end - int(seconds * 1e6),
                         end_us=end,
                         parent=ctx[1] if ctx else self._run_span,
                         attrs={"ok": bool(ok)})

    def _on_event_emitted(self, event: Event) -> None:
        self.metrics.counter(
            "tony_events_total",
            {"app": self.app_id, "type": event.type.value},
            help="Job-history events emitted, by type.").inc()

    def _observe_beacon(self, task_id: str,
                        progress: Optional[dict]) -> None:
        """Fold a heartbeat's metrics beacon into the registry: the
        steady-state utilization series behind /metrics and `top`."""
        if not isinstance(progress, dict):
            return
        labels = {"app": self.app_id, "task": task_id}
        if "steps" in progress:
            try:
                self.metrics.gauge(
                    "tony_task_steps_completed", labels,
                    help="Step counter from the task's progress beacon."
                ).set(float(progress["steps"]))
            except (TypeError, ValueError):
                pass
        m = progress.get("metrics")
        if isinstance(m, dict):
            for src, name, help_ in (
                    ("steps_per_sec", "tony_task_steps_per_sec",
                     "Training steps per second (telemetry.step)."),
                    ("tokens_per_sec", "tony_task_tokens_per_sec",
                     "Tokens per second (telemetry.step tokens=)."),
                    ("mfu", "tony_task_mfu",
                     "Model FLOPs utilization vs peak bf16."),
                    ("hbm_bytes", "tony_task_hbm_bytes",
                     "Device HBM bytes in use (user process)."),
                    ("rss_bytes", "tony_task_rss_bytes",
                     "Process-tree resident set size bytes.")):
                if src in m:
                    try:
                        self.metrics.gauge(name, labels, help=help_).set(
                            float(m[src]))
                    except (TypeError, ValueError):
                        continue
        ph = progress.get("phases")
        if isinstance(ph, dict) and isinstance(ph.get("cum"), dict):
            for name, secs in ph["cum"].items():
                try:
                    self.metrics.gauge(
                        "tony_step_phase_seconds",
                        {**labels, "phase": str(name)},
                        help="Cumulative seconds of step wall time "
                             "attributed to each phase "
                             "(telemetry.phase; 'other' = unattributed)."
                    ).set(float(secs))
                except (TypeError, ValueError):
                    continue
            # Replaced whole under the beat lock; readers (metrics.live
            # on other RPC threads, the perf.json writer on the monitor)
            # snapshot under the same lock — the tonyrace bring-up
            # flagged this fold-vs-read pair as its coordinator hot spot.
            with self._hb_lock:
                self._phase_latest[task_id] = dict(ph)
        prof = progress.get("profile")
        if isinstance(prof, dict):
            self._observe_profile_beacon(task_id, prof)
        rpc = progress.get("rpc")
        if isinstance(rpc, dict):
            self.metrics.set_histogram_snapshot(
                "tony_rpc_client_seconds", labels, rpc,
                help="Executor-side RPC call latency (cumulative over "
                     "the executor's lifetime).")

    def _maybe_write_prom(self, force: bool = False) -> None:
        """Refresh <job_dir>/metrics.prom (atomic replace) + the counter
        snapshot, throttled to the export cadence — the file the portal
        serves live at /metrics. The gauge refresh (O(tasks)) stays on
        the caller; the RENDER (O(all series) — the measured bulk at
        width) runs on a single-flight worker thread so neither a beat
        nor a monitor tick pays it. ``force`` (teardown) renders
        synchronously: the final exposition must be on disk before the
        coordinator exits."""
        now = time.monotonic()
        if not force and now - self._prom_last_write < self._prom_interval_s:
            return
        self._prom_last_write = now
        with self.coordphases.phase("prom_export"):
            self._update_prom_gauges()
        if force:
            self._render_prom()
            return
        t = self._prom_thread
        if t is None or not t.is_alive():
            self._prom_thread = threading.Thread(
                target=self._render_prom, name="prom-export", daemon=True)
            self._prom_thread.start()

    def _update_prom_gauges(self) -> None:
        """The cheap half of an export: refresh the coordinator-owned
        gauges (per-task liveness, gang sizes, and the control-plane
        self-observation families) in the registry."""
        now = time.monotonic()
        app = {"app": self.app_id}
        self.metrics.gauge(
            "tony_coordinator_generation", app,
            help="Coordinator generation (bumps on --recover)."
        ).set(self.generation)
        self.metrics.gauge("tony_session_epoch", app,
                           help="Current retry epoch.").set(
            self.session.session_id)
        with self._hb_lock:
            hb = dict(self._last_hb)
        for task_id, last in hb.items():
            self.metrics.gauge(
                "tony_task_heartbeat_age_seconds",
                {**app, "task": task_id},
                help="Seconds since the task's last heartbeat — the same "
                     "signal the liveness monitor expires on.").set(
                now - last)
        counts: Dict[str, int] = {}
        for t in self.session.all_tasks():
            counts[t.status.value] = counts.get(t.status.value, 0) + 1
        for status, n in counts.items():
            self.metrics.gauge("tony_tasks", {**app, "status": status},
                               help="Tasks by status.").set(n)
        for name, job in self.session.jobs.items():
            self.metrics.gauge(
                "tony_gang_size", {**app, "job": name},
                help="Current task count of the jobtype's gang — "
                     "changes live on an elastic resize.").set(
                job.instances)
        if self.elastic is not None:
            self.metrics.gauge(
                "tony_membership_generation", app,
                help="Elastic membership generation (bumps on every "
                     "resize; the topology fence).").set(
                self.elastic.mgen)
        self._update_coord_metrics(app)

    def _update_coord_metrics(self, app: Dict[str, str]) -> None:
        """Control-plane self-observation families: the coordinator's own
        phase seconds, tick duration, journal throughput + fsync
        histogram, beats received, registered-task count."""
        snap = self.coordphases.snapshot()
        if not snap:
            return
        for name, secs in sorted((snap.get("cum") or {}).items()):
            self.metrics.gauge(
                "tony_coord_phase_seconds", {**app, "phase": str(name)},
                help="Cumulative seconds of the coordinator's own tick "
                     "wall attributed to each control-plane phase "
                     "(coordinator/coordphases.py; 'other' = "
                     "unattributed, 'idle' = the monitor sleep)."
            ).set(float(secs))
        self.metrics.gauge(
            "tony_coord_tick_seconds", app,
            help="Recent mean ACTIVE coordinator tick duration "
                 "(attributed non-idle work per monitor tick — the "
                 "number that grows with gang width).").set(
            float(snap.get("tick_active_s", 0.0)))
        self.metrics.gauge(
            "tony_coord_registered_tasks", app,
            help="Tasks currently registered with the coordinator."
        ).set(self.session.num_registered)
        for metric, key_, help_ in (
                ("tony_coord_beats_total", "beats_total",
                 "Heartbeats received by the coordinator."),
                ("tony_journal_records_total", "journal_records_total",
                 "Write-ahead journal records appended (each one "
                 "fsync'd)."),
                ("tony_journal_bytes_total", "journal_bytes_total",
                 "Write-ahead journal bytes appended.")):
            cur = float(snap.get(key_, 0) or 0)
            prev = self._coord_counter_prev.get(metric, 0.0)
            self.metrics.counter(metric, app, help=help_).inc(
                max(0.0, cur - prev))
            self._coord_counter_prev[metric] = cur
        fsync = snap.get("fsync")
        if isinstance(fsync, dict):
            self.metrics.set_histogram_snapshot(
                "tony_journal_fsync_seconds", app, fsync,
                help="Write-ahead journal append latency (fsync "
                     "included) — the histogram behind JOURNAL_BOUND "
                     "evidence.")

    def _render_prom(self) -> None:
        """The expensive half of an export: render the whole exposition
        and write it (atomic replace) + snapshot counters for recovery.
        Runs on the export worker (or synchronously at teardown)."""
        with self.coordphases.phase("prom_export"):
            text = self.metrics.render()
            try:
                durable.atomic_write(self._prom_path,
                                     text.encode("utf-8"))
            except OSError as e:
                log.debug("metrics.prom write failed: %s", e)
            self.metrics.save_counters(self._counters_path)

    def metrics_live(self) -> dict:
        """The `tony-tpu top` feed: current utilization + liveness per
        task, with a short steps/s history for sparklines (ring-buffer
        series, bounded by tony.metrics.ring-points)."""
        now = time.monotonic()
        with self._hb_lock:
            # One snapshot for the whole build: heartbeat ages AND the
            # latest phase beacons — beats keep folding on RPC threads
            # while this runs (the beacon-fold-vs-metrics.live race the
            # tonyrace bring-up flagged).
            hb = dict(self._last_hb)
            phase_snapshot = dict(self._phase_latest)
        tasks = []
        for t in self.session.all_tasks():
            labels = {"app": self.app_id, "task": t.task_id}
            row: Dict[str, object] = {"task": t.task_id,
                                      "status": t.status.value}
            snap = self.progress.snapshot(t.task_id) or {}
            if snap.get("state"):
                row["state"] = snap["state"]
            if "steps" in snap:
                row["steps"] = snap["steps"]
            for name, key in (("tony_task_steps_per_sec", "steps_per_sec"),
                              ("tony_task_mfu", "mfu"),
                              ("tony_task_hbm_bytes", "hbm_bytes"),
                              ("tony_task_rss_bytes", "rss_bytes")):
                v = self.metrics.gauge_value(name, labels)
                if v is not None:
                    row[key] = v
            history_v = self.metrics.gauge_history(
                "tony_task_steps_per_sec", labels)
            if history_v:
                row["steps_per_sec_history"] = history_v[-32:]
            ph = phase_snapshot.get(t.task_id)
            if ph:
                # Recent-window attribution preferred (the live view
                # should show what the step is doing NOW, not the job
                # average); falls back to cumulative.
                from tony_tpu_torch.profiling import phase_fractions

                recent = ph.get("recent")
                if isinstance(recent, dict) and ph.get("recent_wall_s"):
                    fr = phase_fractions(recent, ph["recent_wall_s"])
                else:
                    fr = phase_fractions(ph.get("cum") or {},
                                         ph.get("wall_s", 0.0))
                if fr:
                    row["phases"] = {k: round(v, 4)
                                     for k, v in fr.items()}
            last = hb.get(t.task_id)
            if last is not None:
                row["heartbeat_age_s"] = round(now - last, 3)
            tasks.append(row)
        snap = {"app_id": self.app_id, "generation": self.generation,
                "session_id": self.session.session_id,
                "status": self.session.status.value,
                "gang_size": {name: job.instances
                              for name, job in self.session.jobs.items()},
                "tasks": tasks}
        if phase_snapshot:
            # Live bottleneck verdict over the wall-weighted aggregate —
            # the `top` header line every item-4 perf PR is aimed by.
            from tony_tpu_torch import profiling

            doc = profiling.build_perf_report(self.app_id, phase_snapshot)
            if doc.get("verdict"):
                snap["perf"] = {"verdict": doc["verdict"]["category"],
                                "summary": doc["verdict"]["summary"],
                                "fractions": doc["fractions"]}
        if self.elastic is not None:
            snap["elastic"] = self.elastic.snapshot()
        coord = self._coord_live_row()
        if coord is not None:
            # Coordinator self row (`tony-tpu top` control-plane
            # section): control-plane health must be visible DURING an
            # incident, not only in post-hoc metrics.
            snap["coord"] = coord
        firing = self.alerts.firing()
        if firing or self._alerts_degraded:
            # Firing alerts ride the top feed (alert rows in `tony-tpu
            # top`): a page-worthy breach must be on the screen the
            # operator is already watching.
            snap["alerts"] = {"degraded": self._alerts_degraded,
                              "firing": firing}
        return snap

    # ------------------------------------------------------------------
    # Alerting (tony_tpu_torch/alerts/)
    # ------------------------------------------------------------------
    def _alerts_tick(self) -> None:
        """Evaluate the job-scope alert pack against the live registry.
        Degrade contract (the fleet.ledger shape): any evaluator failure
        disables alerting for the rest of this coordinator life with one
        warning — the monitor tick never blocks or fails on its own
        observability."""
        if self._alerts_degraded:
            return
        try:
            faults.check("alerts.eval")
            for tr in self.alerts.evaluate(RegistrySource(self.metrics)):
                self._apply_alert_transition(tr)
        except Exception as e:  # noqa: BLE001 — observability, not duty
            self._alerts_degraded = True
            log.warning(
                "alert evaluation failed (%s) — degrading: alerting "
                "disabled for the rest of this coordinator life", e)

    def _apply_alert_transition(self, tr) -> None:
        """Surface one state-machine step: REC_ALERT write-ahead (dedup-
        fenced by the engine), then the transition counter, the firing
        gauge, and the ALERT_FIRING/ALERT_RESOLVED event (pending stays
        journal-and-counter only — one bad tick never pages, and it
        never spams the event stream either)."""
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
                   "summary": tr.summary, "scope": "job"}
        if tr.state == "firing":
            log.warning("ALERT firing [%s]: %s (value=%s %s)",
                        tr.severity, tr.rule, tr.value, tr.labels)
            self.events.emit(Event(EventType.ALERT_FIRING, payload))
        elif tr.state == "resolved":
            log.info("alert resolved: %s", tr.rule)
            self.events.emit(Event(EventType.ALERT_RESOLVED, payload))

    def alerts_snapshot(self) -> dict:
        """The `alerts` RPC: full per-rule state for the CLI/portal."""
        return {"app_id": self.app_id, "scope": "job",
                "degraded": self._alerts_degraded,
                "alerts": self.alerts.snapshot()}

    def metrics_push(self, task_id: str, metrics: dict) -> bool:
        """metrics.push intake (reference ``rpc/MetricsRpc.java``):
        replaced whole under the beat lock — readers (TASK_FINISHED
        payloads, the report builder) snapshot under the same lock."""
        with self._hb_lock:
            self.metrics_store[task_id] = metrics
        return True

    def metrics_get(self, task_id: str) -> Optional[dict]:
        with self._hb_lock:
            return self.metrics_store.get(task_id)

    def _task_metrics(self, task_id: str) -> dict:
        """The task's last pushed metrics blob (TASK_FINISHED payloads,
        report rows) — one locked read."""
        with self._hb_lock:
            return self.metrics_store.get(task_id, {})

    def _coord_live_row(self) -> Optional[dict]:
        """The control-plane self row for metrics.live/top: tick
        duration, beats/s, journal fsync p99 + records/s, registered
        tasks, recent phase fractions, and the control-plane verdict."""
        snap = self.coordphases.snapshot()
        if not snap:
            return None
        fr = self.coordphases.fractions()
        row: Dict[str, object] = {
            "tick_s": round(float(snap.get("tick_active_s", 0.0)), 6),
            "tick_wall_s": round(float(snap.get("recent_wall_s", 0.0)),
                                 6),
            "beats_per_s": round(float(snap.get("beats_per_sec", 0.0)),
                                 2),
            "journal_records_per_s": round(
                float(snap.get("journal_records_per_sec", 0.0)), 2),
            "journal_fsync_p99_s": round(
                float(snap.get("journal_fsync_p99_s", 0.0)), 6),
            "registered_tasks": self.session.num_registered,
        }
        if fr:
            row["phases"] = {k: round(v, 4) for k, v in fr.items()}
            from tony_tpu_torch import profiling

            v = profiling.classify_coord(fr)
            row["verdict"] = v["category"]
            row["summary"] = v["summary"]
        return row

    # ------------------------------------------------------------------
    # On-demand device profiling (tony-tpu profile <app>)
    # ------------------------------------------------------------------
    def profile_start(self, steps: int = 0, task: str = "") -> dict:
        """Arm an on-demand capture: pick the target task (explicit, or
        the chief), allocate a monotonic request id, and let the PROFILE
        directive ride the target's heartbeat responses until its beacon
        reports the result. Refused when disabled, when the task is not
        running, or at the artifact ceiling — never fails the job."""
        if not self.conf.get_bool(K.PROFILE_ENABLED, True):
            return {"ok": False,
                    "message": "on-demand profiling is disabled "
                               "(tony.profile.enabled=false)"}
        steps = steps or self.conf.get_int(K.PROFILE_DEFAULT_STEPS, 5)
        target = None
        if task:
            t = self.session.get_task(task)
            if t is None or t.status.terminal:
                return {"ok": False,
                        "message": f"task {task!r} is not running"}
            target = t
        else:
            live = [t for t in self.session.all_tasks()
                    if not t.status.terminal]
            for t in live:
                if self.session.is_chief(t.job_name, t.index):
                    target = t
                    break
            target = target or (live[0] if live else None)
        if target is None:
            return {"ok": False, "message": "no running task to profile"}
        profile_root = os.path.join(self.job_dir, "profile")
        try:
            existing = sum(1 for d in os.listdir(profile_root)
                           if d.startswith("ondemand-"))
        except OSError:
            existing = 0
        max_artifacts = self.conf.get_int(K.PROFILE_MAX_ARTIFACTS, 8)
        if existing >= max_artifacts:
            return {"ok": False,
                    "message": f"{existing} on-demand artifact(s) "
                               f"already under {profile_root} (ceiling "
                               f"tony.profile.max-artifacts="
                               f"{max_artifacts}); delete old captures"}
        with self._profile_lock:
            self._profile_seq += 1
            req_id = self._profile_seq
            req = {"id": req_id, "task": target.task_id,
                   "steps": int(steps),
                   "dir": os.path.join(
                       profile_root,
                       f"ondemand-{req_id:03d}-"
                       f"{target.task_id.replace(':', '-')}"),
                   "status": "requested"}
            self._profile_reqs[target.task_id] = req
            out = dict(req)
        log.warning("profile: capture of %d step(s) requested on %s "
                    "(request %d) — arming at its next step boundary",
                    steps, target.task_id, req_id)
        return {"ok": True, **out}

    def profile_status(self) -> dict:
        with self._profile_lock:
            return {"requests": [dict(r)
                                 for r in self._profile_reqs.values()]}

    def _profile_directive(self, task_id: str) -> Optional[dict]:
        """The heartbeat-response payload for a pending capture (re-sent
        every beat — the executor dedups by id); None once terminal."""
        with self._profile_lock:
            req = self._profile_reqs.get(task_id)
            if req is None or req["status"] in ("captured", "failed"):
                return None
            return {"id": req["id"], "steps": req["steps"],
                    "dir": req["dir"]}

    def _observe_profile_beacon(self, task_id: str, prof: dict) -> None:
        """Match a beacon's capture status to our request; emit
        TASK_PROFILED exactly once on the terminal transition."""
        try:
            beacon_id = int(prof.get("id", 0))
        except (TypeError, ValueError):
            return
        status = str(prof.get("status", "") or "")
        emit_payload = None
        with self._profile_lock:
            req = self._profile_reqs.get(task_id)
            if req is None or beacon_id != req["id"]:
                return
            if status == "active" and req["status"] == "requested":
                req["status"] = "active"
            elif status in ("captured", "failed") \
                    and req["status"] not in ("captured", "failed"):
                req["status"] = status
                if prof.get("dir"):
                    req["dir"] = str(prof["dir"])
                if prof.get("error"):
                    req["error"] = str(prof["error"])[:300]
                emit_payload = dict(req)
        if emit_payload is not None:
            emit_payload["session_id"] = self.session.session_id
            self.events.emit(Event(EventType.TASK_PROFILED, emit_payload))
            if emit_payload["status"] == "captured":
                log.warning("profile: request %d captured %s step(s) on "
                            "%s — artifact at %s", emit_payload["id"],
                            emit_payload["steps"], task_id,
                            emit_payload["dir"])
            else:
                log.warning("profile: request %d FAILED on %s: %s "
                            "(training continues)", emit_payload["id"],
                            task_id, emit_payload.get("error", "?"))

    def _write_perf_report(self) -> None:
        """<job_dir>/perf.json at finish: phase totals + the bottleneck
        verdict over the job's steady-state step-time attribution. Only
        written when at least one task beaconed phases (a non-telemetry
        job has nothing to attribute). Best-effort by contract."""
        with self._hb_lock:
            snapshot = dict(self._phase_latest)
        if not snapshot:
            return
        try:
            from tony_tpu_torch import profiling

            doc = profiling.build_perf_report(
                self.app_id, snapshot, status=self.final_status.value)
            profiling.save_perf(
                os.path.join(self.job_dir, constants.PERF_FILE), doc)
            v = doc.get("verdict") or {}
            log.warning("perf: %s — %s (perf.json written)",
                        v.get("category", "?"), v.get("summary", ""))
        except Exception:  # noqa: BLE001 — reporting must never fail a job
            log.exception("perf.json write failed")

    def ingest_trace_records(self, records) -> int:
        return self.tracer.write_records(records)

    def _end_task_span(self, task_id: str, **attrs) -> None:
        span = self._task_spans.pop(task_id, None)
        if span is not None:
            span.end(**attrs)

    def _close_epoch_spans(self, status: SessionStatus) -> None:
        """Close the epoch's open spans when its monitor loop returns —
        every span the coordinator opens must close (the golden trace
        test treats unclosed spans as a regression)."""
        if self._rendezvous_span is not None:
            self._rendezvous_span.end(aborted=True)
            self._rendezvous_span = None
        self._epoch_span.end(status=status.value)
        self._epoch_span = tracing.NULL_SPAN

    # ------------------------------------------------------------------
    # Launching
    # ------------------------------------------------------------------
    def _task_env(self, task: Task) -> Dict[str, str]:
        """Identity env contract (reference ApplicationMaster.java:1129-1141)."""
        job = self.session.jobs[task.job_name]
        host, port = self.rpc.address
        env = {
            constants.JOB_NAME: task.job_name,
            constants.TASK_INDEX: str(task.index),
            constants.TASK_NUM: str(job.instances),
            constants.IS_CHIEF: str(
                self.session.is_chief(task.job_name, task.index)).lower(),
            constants.SESSION_ID: str(self.session.session_id),
            constants.APP_ID: self.app_id,
            constants.TASK_ID: task.task_id,
            constants.COORDINATOR_HOST: host,
            constants.COORDINATOR_PORT: str(port),
            constants.METRICS_PORT: str(port),
            constants.COORDINATOR_GENERATION: str(self.generation),
            constants.TASK_COMMAND: job.command,
        }
        if self.addr_file:
            # Lets the executor RE-resolve a restarted coordinator (it
            # rewrites this file with its fresh ephemeral port).
            env[constants.COORDINATOR_ADDR_FILE] = self.addr_file
        if self.elastic is not None:
            # Topology fence: frames from this executor carry the
            # membership generation it was launched under; survivors
            # adopt newer generations from the RESIZE directive.
            env[constants.MEMBERSHIP_GEN] = str(self.elastic.mgen)
            env.setdefault(constants.TASK_KILL_GRACE_ENV,
                           str(self.elastic.drain_grace_s))
        if self.tracer.enabled:
            # Trace context: the executor's spans parent under this
            # task's lifecycle span, stitching one tree per job.
            env[constants.TRACE_ID_ENV] = self.tracer.trace_id
            span = self._task_spans.get(task.task_id)
            if span is not None and getattr(span, "span_id", ""):
                env[constants.TRACE_PARENT_ENV] = span.span_id
        if self.rpc_token:
            env["TONY_RPC_TOKEN"] = self.rpc_token
        ckpt_dir = str(self.conf.get(K.APPLICATION_CHECKPOINT_DIR, "") or "")
        if ckpt_dir:
            env[constants.CHECKPOINT_DIR] = ckpt_dir
        conf_url = str(self.conf.get(K.INTERNAL_CONF_URL, "") or "")
        if self.conf.get_bool(K.APPLICATION_PROFILER_ENABLED) and \
                self.session.is_chief(task.job_name, task.index):
            # Chief-only trace capture into the job history dir, where the
            # portal finds it (tony_tpu_torch/profiler.py contract). With a
            # remote store the chief may be on another host where the job
            # dir doesn't exist: traces go to the task's own workdir and
            # ride the store home (executor uploads post-run, _stop pulls
            # them into the job dir).
            if conf_url:
                env[constants.PROFILE_DIR] = "profile"
                env[constants.PROFILE_UPLOAD] = self._profile_store_url(
                    conf_url)
            else:
                env[constants.PROFILE_DIR] = os.path.join(self.job_dir,
                                                          "profile")
        if conf_url:
            # Remote store configured: executors fetch the frozen config
            # from the store (they may be on another host); the credential
            # travels by env because it gates reading the config itself.
            env[constants.EXECUTOR_CONF] = conf_url
        elif self._final_conf_path:
            env[constants.EXECUTOR_CONF] = self._final_conf_path
        from tony_tpu_torch.storage.store import STORAGE_TOKEN_ENV

        # Credential passthrough: inherited env from the client (the frozen
        # config is scrubbed of it — see client._stage_bundle).
        token = os.environ.get(STORAGE_TOKEN_ENV, "") \
            or str(self.conf.get(K.STORAGE_TOKEN, "") or "")
        if token:
            env[STORAGE_TOKEN_ENV] = token
        env.update(faults.env_passthrough())
        for kv in self.conf.get_list(K.EXECUTION_ENV):
            if "=" in kv:
                k, v = kv.split("=", 1)
                env[k] = v
        env.update(job.env)
        return env

    @staticmethod
    def _profile_store_url(conf_url: str) -> str:
        """Store prefix for chief traces, next to the frozen config
        (<prefix>/tony-final.json → <prefix>/profile)."""
        return conf_url.rsplit("/", 1)[0] + "/profile"

    def _launch_job(self, job_name: str) -> None:
        # Widen the rendezvous barrier to this gang BEFORE any instance can
        # register, so a fast first instance never sees a spec missing its
        # peers (reference adds numExpectedTasks at schedule time,
        # ``TonySession.addNumExpectedTask`` :197).
        self.session.mark_job_scheduled(job_name)
        self.journal.job_scheduled(job_name, self.session.session_id)
        for i in self.session.members(job_name):
            task = self.session.get_task(f"{job_name}:{i}")
            if task is None or task.status != TaskStatus.NEW:
                continue
            if not self._launch_task(task):
                return

    def _launch_task(self, task: Task) -> bool:
        """Launch ONE task (gang launch and elastic relaunch/grow share
        this path). Returns False when the backend spawn failed and the
        session was failed INFRA_TRANSIENT."""
        if task.status.terminal:
            # Terminal-state discipline (tonylint terminal-state):
            # relaunching a finished Task object would resurrect a
            # closed identity under its old exit verdict — resize and
            # retry paths always hand this a FRESH Task.
            log.error("refusing to launch terminal task %s (%s)",
                      task.task_id, task.status.value)
            return False
        job = self.session.jobs[task.job_name]
        # Write-ahead: journal the SCHEDULED transition before the
        # backend spawn. A crash in between recovers a task the
        # journal says was launched but that never registers — the
        # re-registration grace expires into a normal retry epoch,
        # never a duplicate launch over a live executor.
        self.journal.task(task.task_id, TaskStatus.SCHEDULED.value,
                          self.session.session_id)
        # Lifecycle span opens BEFORE the env is built so the
        # executor inherits it as its trace parent.
        if task.task_id not in self._task_spans:
            self._task_spans[task.task_id] = self.tracer.start_span(
                "task.lifecycle", parent=self._epoch_span,
                task=task.task_id, attrs={"job": task.job_name})
        spec = TaskLaunchSpec(
            task_id=task.task_id, job_name=task.job_name, index=task.index,
            command=job.command, env=self._task_env(task),
            vcores=job.vcores, memory=job.memory, chips=job.chips,
            node_pool=job.node_pool, docker_image=job.docker_image,
            exclude_hosts=tuple(
                self._failed_hosts.get(task.task_id, ())))
        try:
            task.handle = self.backend.launch_task(spec)
        except Exception as e:  # noqa: BLE001 — e.g. SliceProvisionError
            # An unlaunchable gang is an INFRA_TRANSIENT session
            # failure (subject to the normal retry budget), not a
            # coordinator crash — the analogue of an unserviceable
            # container request.
            log.error("launch of %s failed: %s", task.task_id, e)
            self._end_task_span(task.task_id, error=str(e))
            self.session.fail(f"launch of {task.task_id} failed: {e}",
                              FailureDomain.INFRA_TRANSIENT)
            return False
        # Each gang launch restarts the registration-timeout clock; the
        # timeout gates on launched-but-unregistered tasks (scoped like
        # the barrier), so a long-running earlier DAG stage can't trip it.
        self._schedule_start = time.monotonic()
        task.status = TaskStatus.SCHEDULED
        self.events.emit(Event(EventType.TASK_STARTED, {
            "task": task.task_id, "session_id": self.session.session_id}))
        return True

    # ------------------------------------------------------------------
    # RPC-surface behaviour
    # ------------------------------------------------------------------
    def _check_membership(self, task_id: str, mgen,
                          for_register: bool = False) -> None:
        """Topology fence (coordinator/elastic.py): reject frames from a
        pre-resize topology. A registration for a task the matrix no
        longer holds — or holds only as a terminal corpse being replaced
        — is a zombie member of a world that no longer exists."""
        el = self.elastic
        if el is None or task_id.partition(":")[0] != el.job:
            return
        t = self.session.get_task(task_id)
        known = t is not None and not (for_register and t.status.terminal)
        reason = el.fences_frame(known, mgen)
        if reason is not None:
            raise FencedError(f"task {task_id}: {reason}")

    def register_worker_spec(self, task_id: str, host: str, port: int,
                             session_id: int = -1,
                             mgen: int = -1) -> Optional[dict]:
        """Gang barrier: record the spec, return the full cluster spec only
        once ALL tasks registered (reference ApplicationMaster.java:841-889).
        Serves initial registration AND post-recovery re-registration —
        the latter is the same call with the executor's existing
        task_id/host/port, fenced by session epoch — AND a drained
        survivor's PARK during an elastic resize (same call again, now
        carrying the new membership generation)."""
        self._check_epoch(task_id, session_id)
        self._check_membership(task_id, mgen, for_register=True)
        ok = self.session.register_worker(task_id, host, port)
        if ok and self.elastic is not None \
                and self.elastic.ack_registration(task_id, mgen):
            log.info("resize: %s parked under membership generation %s "
                     "(%d still draining)", task_id, mgen,
                     len(self.elastic.op.awaiting)
                     if self.elastic.op else 0)
        if ok:
            if task_id not in self._task_spans and self.tracer.enabled:
                # Post-recovery re-adoption: the original lifecycle span
                # died unclosed with the previous coordinator; open a
                # fresh one in the SAME trace so the task's second life
                # is visible on the timeline.
                self._task_spans[task_id] = self.tracer.start_span(
                    "task.lifecycle", parent=self._epoch_span,
                    task=task_id, attrs={"re_registered": True})
            # Write-ahead: the registration must be on disk before the
            # executor can observe it succeeded (a crash after the reply
            # but before the append would resurrect an unregistered task
            # whose executor believes it is registered).
            self.journal.register(task_id, host, int(port),
                                  self.session.session_id)
            with self._hb_lock:
                self._last_hb[task_id] = time.monotonic()
                steps_hint = self._recovered_steps.pop(task_id, None)
            # Progress tracking starts at registration; a post-recovery
            # re-registration seeds the journalled step counter so the
            # task comes back ARMED with a fresh deadline.
            self.progress.track(
                task_id, task_id.partition(":")[0],
                steps_hint=steps_hint)
            self._maybe_test_worker_termination(task_id)
        el = self.elastic
        if el is not None and el.resizing and el.op is not None \
                and el.op.phase == DRAIN:
            # The barrier stays CLOSED while the drain runs: lost tasks
            # keep their registered flag from their first life, so the
            # raw spec would otherwise open with the OLD topology and a
            # parked survivor would relaunch at the stale world size.
            return None
        spec = self.session.get_cluster_spec()
        if spec is not None and el is not None:
            # Elastic metadata rides the spec under a reserved key the
            # executor pops before the runtimes see it: the current
            # membership generation (survivors adopt it) and the member
            # indices (dense-rank mapping for sparse post-shrink gangs).
            spec["__elastic__"] = {
                "mgen": el.mgen,
                "members": {el.job: self.session.members(el.job)}}
        return spec

    def _maybe_test_worker_termination(self, task_id: str) -> None:
        """TEST_WORKER_TERMINATION hook: once the chief registers, kill one
        task of the configured jobtype (reference :1224-1235)."""
        target_type = os.environ.get(constants.TEST_WORKER_TERMINATION, "")
        if not target_type or self._worker_termination_done:
            return
        job, _, idx = task_id.partition(":")
        if not self.session.is_chief(job, int(idx)):
            return
        for t in self.session.all_tasks():
            if t.job_name == target_type and t.handle is not None:
                log.warning("TEST hook: terminating %s", t.task_id)
                self.backend.kill_task(t.handle, grace_s=0.0)
                self._worker_termination_done = True
                return

    def register_tensorboard_url(self, task_id: str, url: str,
                                 session_id: int = -1) -> bool:
        # Epoch fence (tonylint fence-coverage): a chief surviving from a
        # pre-reset session must not overwrite the NEW epoch's TB URL
        # with its dead server's address. session_id < 0 = pre-fence
        # caller, compat-accepted like every other fenced surface.
        self._check_epoch(task_id, session_id)
        t = self.session.get_task(task_id)
        if t is None:
            return False
        t.tb_url = url
        self.tb_url = url
        return True

    def register_execution_result(self, task_id: str, exit_code: int,
                                  session_id: int = -1,
                                  diagnostics: Optional[dict] = None) -> int:
        """Executor self-report; unregisters from the liveness monitor so a
        completed task can't be deemed dead (reference design note
        ``ApplicationMaster.java:891-919``). ``diagnostics`` is the
        executor's postmortem extract for a failed user process (the
        traceback from its own log tail, the decoded exit signal) —
        captured at the source, where the log is ALWAYS local, instead
        of hoping the coordinator can reach the file."""
        self._check_epoch(task_id, session_id)
        with self._hb_lock:
            if isinstance(diagnostics, dict) and diagnostics:
                self._task_diag[task_id] = diagnostics
            self._last_hb.pop(task_id, None)
        self.progress.forget(task_id)
        self._process_completion(task_id, exit_code)
        return 0

    def heartbeat(self, task_id: str, session_id: int = -1,
                  progress: Optional[dict] = None, mgen: int = -1):
        """Liveness refresh + progress-beacon intake. The return value
        doubles as the coordinator→executor directive channel: normally
        True (wire-compatible with pre-progress executors), or a dict
        carrying ``{"dump": True}`` exactly once after a hang verdict —
        the executor then signals the user process group so its
        pre-registered faulthandler dumps all-thread stacks — and/or
        ``{"resize": {...}}`` while an elastic drain runs (re-sent every
        beat; the executor dedups on the membership generation)."""
        self._check_epoch(task_id, session_id)
        self._check_membership(task_id, mgen)
        with self._hb_lock:
            if task_id in self._last_hb:
                self._last_hb[task_id] = time.monotonic()
        # The beacon doubles as the live-metrics feed: utilization gauges
        # and the executor's client-latency histogram ride the same dict
        # the liveness tracker reads steps from. The fold runs inline on
        # the beat path — its cost is booked to the beacon_fold tick
        # phase (and subtracted from rpc_serve), so a width problem here
        # indicts as HEARTBEAT_BOUND instead of hiding.
        with self.coordphases.phase("beacon_fold"):
            self._observe_beacon(task_id, progress)
        if self.progress.observe(task_id, progress):
            self._maybe_journal_progress(task_id)
        resp: Dict[str, object] = {}
        if self.progress.should_dump(task_id):
            resp["dump"] = True
        if self.elastic is not None:
            directive = self.elastic.directive_for(task_id)
            if directive is not None:
                resp["resize"] = directive
        profile = self._profile_directive(task_id)
        if profile is not None:
            resp["profile"] = profile
        if resp:
            return {"ok": True, **resp}
        return True

    def _maybe_journal_progress(self, task_id: str) -> None:
        """Journal an advanced step counter, throttled per task — the
        recovery seed must not turn the fsync'd journal into a per-step
        hot path."""
        now = time.monotonic()
        with self._hb_lock:
            last = self._progress_journal_t.get(task_id, 0.0)
            if now - last < liveness.PROGRESS_JOURNAL_MIN_INTERVAL_S:
                return
            self._progress_journal_t[task_id] = now
        snap = self.progress.snapshot(task_id) or {}
        steps = snap.get("steps")
        if steps is not None:
            self.journal.progress(task_id, float(steps),
                                  self.session.session_id)

    def _retry_available(self, domain: Optional[FailureDomain]) -> bool:
        """Would the run loop retry a failure of this domain right now?
        (Pure read — the loop consumes via _consume_retry.)"""
        infra_left = self._infra_retries_used < self._retries_total
        if domain == FailureDomain.USER_ERROR:
            # Terminal on first occurrence: retrying a deterministic user
            # crash burns epochs for nothing — unless the operator opted
            # into reference-compat undiscriminating retry.
            return self._retry_user_errors and infra_left
        if domain == FailureDomain.PREEMPTION:
            # Free budget first; once exhausted, preemptions degrade to
            # drawing on the transient budget rather than failing a job
            # that still has retries to give.
            return (self._preempt_retries_used
                    < self._preempt_retries_total) or infra_left
        return infra_left

    def _consume_retry(self, domain: Optional[FailureDomain]) -> None:
        if domain == FailureDomain.PREEMPTION and \
                self._preempt_retries_used < self._preempt_retries_total:
            self._preempt_retries_used += 1
            return
        self._infra_retries_used += 1

    def application_report(self) -> dict:
        status = (self.final_status if self.final_status != SessionStatus.RUNNING
                  else self.session.status)
        retries_left = max(0, self._retries_total - self._infra_retries_used)
        preempt_left = max(0, self._preempt_retries_total
                           - self._preempt_retries_used)
        domain = self.session.failure_domain
        if (self.final_status == SessionStatus.RUNNING
                and status in (SessionStatus.FAILED, SessionStatus.KILLED)
                and self._retry_available(domain)
                and not self._stop_requested.is_set()):
            # Whole-job retry window: the current epoch failed but the
            # failed DOMAIN still has budget, so the next report may well
            # be RUNNING again. A client that treats any terminal status
            # as final (ours does, like ``TonyClient.java:838-892`` gates
            # on the YARN *application* status, never transient session
            # state) must not observe the transient FAILED here. A
            # USER_ERROR with retry-user-errors off is genuinely final
            # and reports FAILED immediately — no wasted retry epochs.
            status = SessionStatus.RUNNING
        if self._stop_requested.is_set() and status == SessionStatus.FAILED:
            # Kill teardown window: session.fail(stop_reason) lands before
            # run()'s finally block remaps the final status, and killing
            # the gang can take seconds — a poll here must already read
            # KILLED, not the transient FAILED (same YARN semantics as the
            # finally-block mapping).
            status = SessionStatus.KILLED
        tasks = []
        with self._hb_lock:
            hb = dict(self._last_hb)
        hb_now = time.monotonic()
        for t in self.session.all_tasks():
            info = t.to_info()
            # Live progress state for the status surfaces (CLI `status`,
            # portal): steps, stall age, rate, and the hang/straggler
            # verdicts — absent for terminal/untracked tasks.
            snap = self.progress.snapshot(t.task_id)
            if snap:
                info["progress"] = snap
            # Heartbeat age, from the same map the liveness monitor
            # expires on — the CLI status column (absent once a task is
            # terminal and unregistered from the monitor).
            last = hb.get(t.task_id)
            if last is not None:
                info["last_heartbeat_age_s"] = round(hb_now - last, 3)
            tasks.append(info)
        report = {
            "app_id": self.app_id,
            "status": status.value,
            "failure_reason": self.session.failure_reason or self._stop_reason,
            "failure_domain": domain.value if domain else "",
            "session_id": self.session.session_id,
            "attempt": self._attempt,
            "generation": self.generation,
            "recovered": self._recover_state is not None,
            "retries_left": retries_left,
            "preemption_retries_left": preempt_left,
            "tb_url": self.tb_url,
            "gang_size": {name: job.instances
                          for name, job in self.session.jobs.items()},
            "tasks": tasks,
        }
        if self.elastic is not None:
            report["elastic"] = self.elastic.snapshot()
        return report

    def request_stop(self, reason: str) -> None:
        self._stop_reason = reason
        self._stop_requested.set()

    # ------------------------------------------------------------------
    # Completion plumbing
    # ------------------------------------------------------------------
    def _record_failed_host(self, task_id: str,
                            domain: Optional[FailureDomain]) -> None:
        """Exclude-on-retry bookkeeping: remember which host an INFRA
        failure happened on, BEFORE the backend forgets the task. The
        next launch of this task id carries the list in
        TaskLaunchSpec.exclude_hosts. USER_ERROR records nothing —
        blacklisting hardware for a code bug just shrinks the pool."""
        if domain is None or domain == FailureDomain.USER_ERROR:
            return
        host = self.backend.host_of(task_id)
        if not host:
            return
        hosts = self._failed_hosts.setdefault(task_id, [])
        if host not in hosts:
            hosts.append(host)

    def _process_completion(self, task_id: str, exit_code: int) -> None:
        """Reference ``processFinishedContainer`` :1187-1220: apply failure
        policy, notify scheduler, emit TASK_FINISHED with last metrics."""
        delay = float(os.environ.get(constants.TEST_COMPLETION_DELAY, "0") or 0)
        if delay:
            time.sleep(delay)
        t = self.session.get_task(task_id)
        if t is None or t.status.terminal:
            return
        self.progress.forget(task_id)
        domain_hint = self.backend.completion_domain(task_id)
        if exit_code != 0 and self._absorb_task_loss(
                t, exit_code, domain_hint,
                reason=f"exited {exit_code} ({describe_exit(exit_code)})"):
            # Elastic absorption: the loss became a shrink (or folded
            # into the in-flight resize) — the session failure policy
            # never sees it.
            return
        self.session.on_task_completed(task_id, exit_code,
                                       domain_hint=domain_hint)
        if exit_code != 0:
            self._record_failed_host(task_id, t.failure_domain)
        self._end_task_span(task_id, exit_code=exit_code,
                            status=t.status.value)
        self.journal.task(
            task_id, t.status.value, self.session.session_id,
            exit_code=exit_code,
            domain=t.failure_domain.value if t.failure_domain else "")
        logs = self.backend.task_log_paths(task_id)
        payload = {
            "task": task_id, "exit_code": exit_code,
            "status": t.status.value,
            "exit_detail": describe_exit(exit_code),
            "failure_domain": (t.failure_domain.value
                               if t.failure_domain else ""),
            "metrics": self._task_metrics(task_id),
            "logs": list(logs) if logs else [],
            "session_id": self.session.session_id}
        with self._hb_lock:
            diag = self._task_diag.get(task_id) if exit_code != 0 else None
        if diag:
            # Executor-extracted postmortem: the user traceback rides the
            # event stream so diagnosis works even after task dirs purge.
            if diag.get("traceback"):
                payload["traceback"] = str(diag["traceback"])[:8192]
            if diag.get("exit_detail"):
                payload["exit_detail"] = str(diag["exit_detail"])
        self.events.emit(Event(EventType.TASK_FINISHED, payload))
        if self.scheduler is not None and t.tracked:
            done = [self.session.get_task(f"{t.job_name}:{i}")
                    for i in self.session.members(t.job_name)]
            if all(x is not None and x.status == TaskStatus.SUCCEEDED
                   for x in done):
                self.journal.job_completed(t.job_name,
                                           self.session.session_id)
                self.scheduler.register_job_completed(t.job_name)
            elif t.status in (TaskStatus.FAILED, TaskStatus.KILLED) and \
                    not self.scheduler.dependency_check_passed(t.job_name):
                # A failed jobtype with unlaunched dependents can never let
                # the DAG progress — fail now instead of waiting on tasks
                # that will never be launched (reference monitor() DAG check,
                # ``ApplicationMaster.java:581-650``).
                self.session.fail(
                    f"jobtype {t.job_name} failed with unlaunched dependent "
                    f"jobtypes; DAG cannot make progress (task {task_id} "
                    f"exit {exit_code})", t.failure_domain)

    # ------------------------------------------------------------------
    # Elastic resizing (coordinator/elastic.py)
    # ------------------------------------------------------------------
    def _absorb_task_loss(self, t: Task, exit_code: int,
                          domain_hint: Optional[str], reason: str,
                          hb_age_s: Optional[float] = None,
                          kill: bool = False) -> bool:
        """Try to absorb a dying elastic-gang member as a shrink instead
        of an epoch failure. Terminalizes the task (WITHOUT the session
        failure policy), emits its TASK_FINISHED with ``resize: true``
        (the diagnosis engine must not blame a deliberate resize), and
        starts — or folds into — the resize op. Returns False when the
        policy says this loss is a real failure (chief, USER_ERROR,
        below min-tasks, elasticity off): the caller then takes the
        ordinary failure path."""
        from tony_tpu_torch.coordinator.session import classify_exit

        el = self.elastic
        if el is None:
            return False
        domain = classify_exit(exit_code, domain_hint) \
            or FailureDomain.INFRA_TRANSIENT
        # A migrating member that already ACKED its park self-exits (it
        # cannot follow the gang to the destination slice) — that exit is
        # as expected as a released task's, and must never fold the move
        # into a shrink.
        released = el.is_released(t.task_id) or \
            el.is_parked_for_migration(t.task_id)
        if not released and not el.may_absorb(t, domain.value,
                                              self.session):
            return False
        task_id = t.task_id
        t.status = (TaskStatus.KILLED
                    if exit_code == constants.EXIT_KILLED
                    else TaskStatus.FAILED)
        t.exit_code = exit_code
        t.failure_domain = domain
        self._record_failed_host(task_id, domain)
        with self._hb_lock:
            self._last_hb.pop(task_id, None)
        self.progress.forget(task_id)
        self._end_task_span(task_id, exit_code=exit_code,
                            resized_out=True)
        self.journal.task(task_id, t.status.value,
                          self.session.session_id, exit_code=exit_code,
                          domain=domain.value)
        if kill and t.handle is not None:
            # Heartbeat-expiry shape: the EXECUTOR vanished but its user
            # tree may live on — reap it off the monitor loop (kill_task
            # blocks through its grace window).
            threading.Thread(
                target=self.backend.kill_task, args=(t.handle,),
                kwargs={"grace_s": 0.0}, daemon=True,
                name=f"resize-reap-{task_id}").start()
        logs = self.backend.task_log_paths(task_id)
        payload = {
            "task": task_id, "exit_code": exit_code,
            "status": t.status.value,
            "exit_detail": describe_exit(exit_code),
            "failure_domain": domain.value,
            "reason": reason,
            "resize": True,
            "metrics": self._task_metrics(task_id),
            "logs": list(logs) if logs else [],
            "session_id": self.session.session_id}
        if hb_age_s is not None:
            payload["last_heartbeat_age_s"] = round(hb_age_s, 3)
        self.events.emit(Event(EventType.TASK_FINISHED, payload))
        if released:
            el.note_task_gone(task_id)
            return True
        if el.resizing and el.op is not None:
            # Second loss during the drain: supersede the op with the
            # smaller membership (mgen bumps again; parked survivors
            # adopt it through the directive channel).
            op = el.op
            members = [m for m in op.members if m != t.index]
            if op.migrate:
                # A host died mid-migration: the move is abandoned and
                # the loss folds into an ordinary elastic shrink — a
                # failed migration is never worse than a host loss. The
                # superseded record closes the journaled migrate start
                # write-ahead of the resize that replaces it.
                self.journal.migrate(el.job, op.mgen, op.members,
                                     "superseded", op.target,
                                     self.session.session_id,
                                     reason=f"lost {task_id} mid-"
                                            f"migration: {reason}")
                log.warning("migrate: member %s lost mid-drain — move to "
                            "%r abandoned, folding into a shrink to %d "
                            "member(s)", task_id, op.target, len(members))
            else:
                log.warning("resize: member %s lost mid-drain — "
                            "superseding to %d member(s)", task_id,
                            len(members))
        else:
            members = [x.index for x in self.session.all_tasks()
                       if x.job_name == el.job and not x.status.terminal]
        self._start_resize(members,
                           f"absorbed loss of {task_id}: {reason}")
        return True

    def _start_resize(self, members, reason: str) -> None:
        """Begin (or supersede) a resize op: journal the start record
        write-ahead, emit the timeline event, and let the drain
        directives ride the next heartbeats."""
        el = self.elastic
        live = [t for t in self.session.all_tasks()
                if t.job_name == el.job and not t.status.terminal]
        op = el.begin(sorted(members), live, reason)
        self.journal.resize(el.job, op.mgen, op.members, "start",
                            self.session.session_id, reason=reason)
        self.events.emit(Event(EventType.GANG_RESIZED, {
            "job": el.job, "phase": "started", "mgen": op.mgen,
            "members": list(op.members), "from": op.size_before,
            "to": len(op.members), "reason": reason,
            "session_id": self.session.session_id}))
        log.warning("resize: %s -> %d member(s) under membership "
                    "generation %d (%s); draining %d, releasing %d",
                    el.job, len(op.members), op.mgen, reason,
                    len(op.awaiting), len(op.release))

    def _start_migrate(self, members, target: str, reason: str,
                       mgen: Optional[int] = None,
                       resumed: bool = False) -> None:
        """Begin a live migration (coordinator/migrate.py): journal the
        REC_MIGRATE start write-ahead, emit the timeline event, and let
        the whole-gang drain directives ride the next heartbeats — every
        member parks (its user process makes one final durable save via
        the SIGTERM handler), then _apply_migrate moves the topology."""
        el = self.elastic
        live = [t for t in self.session.all_tasks()
                if t.job_name == el.job and not t.status.terminal]
        op = el.begin(sorted(members), live, reason, mgen=mgen,
                      target=target, migrate=True)
        self.journal.migrate(el.job, op.mgen, op.members, "start",
                             target, self.session.session_id,
                             reason=reason)
        job_spec = self.session.jobs.get(el.job)
        source = str(job_spec.node_pool or "") if job_spec else ""
        payload = {"job": el.job, "phase": "started", "mgen": op.mgen,
                   "members": list(op.members), "source": source,
                   "target": target, "reason": reason,
                   "session_id": self.session.session_id}
        if resumed:
            payload["resumed"] = True
        self.events.emit(Event(EventType.GANG_MIGRATED, payload))
        log.warning("migrate: %s (%d member(s)) %r -> %r under membership "
                    "generation %d (%s); draining the whole gang",
                    el.job, len(op.members), source, target, op.mgen,
                    reason)

    def _elastic_tick(self) -> None:
        """Advance the resize state machine (monitor-loop cadence):
        drain done → apply the re-mesh; barrier reopened → finish; the
        whole op is bounded by tony.elastic.barrier-timeout-s."""
        el = self.elastic
        if el is None or not el.resizing:
            return
        if el.timed_out():
            op = el.abandon()
            what = (f"live migration to {op.target!r}" if op.migrate
                    else f"elastic resize to {len(op.members)} member(s)")
            self.session.fail(
                f"{what} did not "
                f"complete within {el.barrier_timeout_s}s "
                f"(phase {op.phase}, still draining "
                f"{sorted(op.awaiting)})",
                FailureDomain.INFRA_TRANSIENT)
            return
        op = el.op
        if op.phase == DRAIN and el.drain_complete:
            if op.migrate:
                self._apply_migrate()
            else:
                self._apply_remesh()
        elif op.phase == BARRIER and self.session.all_registered():
            done = el.finish()
            duration_s = round(time.monotonic() - done.started, 3)
            if done.migrate:
                self.events.emit(Event(EventType.GANG_MIGRATED, {
                    "job": el.job, "phase": "completed",
                    "mgen": done.mgen, "members": list(done.members),
                    "target": done.target, "reason": done.reason,
                    "duration_s": duration_s,
                    "session_id": self.session.session_id}))
                log.warning("migrate: %s live on %r at %d member(s) "
                            "(mgen %d) in %.1fs — training continues in "
                            "the SAME epoch, zero steps lost", el.job,
                            done.target, len(done.members), done.mgen,
                            duration_s)
                return
            self.events.emit(Event(EventType.GANG_RESIZED, {
                "job": el.job, "phase": "completed", "mgen": done.mgen,
                "members": list(done.members), "from": done.size_before,
                "to": len(done.members), "reason": done.reason,
                "duration_s": duration_s,
                "session_id": self.session.session_id}))
            log.warning("resize: %s re-meshed at %d member(s) "
                        "(mgen %d) in %.1fs — training continues in the "
                        "SAME epoch", el.job, len(done.members),
                        done.mgen, duration_s)

    def _apply_remesh(self) -> None:
        """All survivors parked (or dead): rebuild the member set at the
        new cardinality, journal it write-ahead, launch replacements /
        grow-back tasks, and reopen the barrier."""
        el = self.elastic
        op = el.op
        try:
            faults.check("resize.remesh")
        except faults.InjectedFault as e:
            el.abandon()
            self.session.fail(f"elastic re-mesh failed: {e}",
                              FailureDomain.INFRA_TRANSIENT)
            return
        member_set = set(op.members)
        for t in self.session.all_tasks():
            if t.job_name != el.job or t.index in member_set:
                continue
            # Removed from the topology: close its trace/liveness state;
            # a released executor that ignored its directive is reaped
            # off-loop (its straggling frames are fenced as non-members).
            self._end_task_span(t.task_id, resized_out=True)
            with self._hb_lock:
                self._last_hb.pop(t.task_id, None)
            self.progress.forget(t.task_id)
            el.note_task_gone(t.task_id)
            if t.handle is not None and not t.status.terminal:
                threading.Thread(
                    target=self.backend.kill_task, args=(t.handle,),
                    kwargs={"grace_s": float(el.drain_grace_s)},
                    daemon=True, name=f"resize-release-{t.task_id}"
                ).start()
        fresh = self.session.resize_job(el.job, op.members)
        self.journal.resize(el.job, op.mgen, op.members, "applied",
                            self.session.session_id, reason=op.reason)
        for t in fresh:
            if not self._launch_task(t):
                el.abandon()
                return             # session already failed INFRA_TRANSIENT
        try:
            faults.check("resize.barrier")
        except faults.InjectedFault as e:
            el.abandon()
            self.session.fail(f"elastic resize barrier failed: {e}",
                              FailureDomain.INFRA_TRANSIENT)
            return
        self._schedule_start = time.monotonic()
        el.mark_remeshed()
        log.warning("resize: topology applied — %s members %s (mgen %d, "
                    "%d fresh launch(es)); waiting at the barrier",
                    el.job, op.members, op.mgen, len(fresh))

    def _apply_migrate(self) -> None:
        """The whole gang is parked (every member's final save durable):
        kill the source-slice executors, re-pin the job's node pool to
        the target, journal the applied record write-ahead, and relaunch
        the SAME member indices on the destination — warm-pool adoption
        or cold spawn, the backend's ordinary launch ladder. Any failure
        degrades to the INFRA_TRANSIENT retry machinery."""
        el = self.elastic
        op = el.op
        try:
            faults.check("migrate.snapshot")
        except faults.InjectedFault as e:
            el.abandon()
            self.session.fail(f"migration snapshot seal failed: {e}",
                              FailureDomain.INFRA_TRANSIENT)
            return
        # Source executors die BEFORE their indices exist again: a
        # straggling frame from the old slice then meets a closed drain
        # barrier or a non-member fence, never the destination gang.
        kills: List[threading.Thread] = []
        for t in self.session.all_tasks():
            if t.job_name != el.job or t.status.terminal:
                continue
            self._end_task_span(t.task_id, resized_out=True)
            with self._hb_lock:
                self._last_hb.pop(t.task_id, None)
            self.progress.forget(t.task_id)
            el.note_task_gone(t.task_id)
            self.session.mark_killed(t.task_id)
            if t.handle is not None:
                th = threading.Thread(
                    target=self.backend.kill_task, args=(t.handle,),
                    kwargs={"grace_s": float(el.drain_grace_s)},
                    daemon=True, name=f"migrate-release-{t.task_id}")
                th.start()
                kills.append(th)
        for th in kills:
            th.join(timeout=float(el.drain_grace_s) + 15.0)
        job_spec = self.session.jobs.get(el.job)
        source = str(job_spec.node_pool or "") if job_spec else ""
        if job_spec is not None:
            job_spec.node_pool = op.target
        fresh = self.session.resize_job(el.job, op.members)
        self.journal.migrate(el.job, op.mgen, op.members, "applied",
                             op.target, self.session.session_id,
                             reason=op.reason)
        try:
            faults.check("migrate.adopt")
        except faults.InjectedFault as e:
            el.abandon()
            self.session.fail(
                f"migration destination adoption failed: {e}",
                FailureDomain.INFRA_TRANSIENT)
            return
        for t in fresh:
            if not self._launch_task(t):
                el.abandon()
                return             # session already failed INFRA_TRANSIENT
        self._schedule_start = time.monotonic()
        el.mark_remeshed()
        log.warning("migrate: topology moved %r -> %r — %s members %s "
                    "(mgen %d, %d destination launch(es)); waiting at "
                    "the barrier", source, op.target, el.job, op.members,
                    op.mgen, len(fresh))

    def resize_application(self, size: int, job: str = "") -> dict:
        """Operator-initiated resize (`tony-tpu resize <app> <n>`):
        validated by policy, then the same drain→remesh→barrier path a
        host-loss absorption takes."""
        el = self.elastic
        if el is None:
            return {"ok": False,
                    "message": "elasticity is disabled for this job "
                               "(set tony.elastic.enabled=true)"}
        if job and job != el.job:
            return {"ok": False,
                    "message": f"jobtype {job!r} is not the elastic "
                               f"jobtype ({el.job})"}
        try:
            members = el.plan_explicit(int(size), self.session)
        except ResizeRefused as e:
            if el.at_size(int(size), self.session):
                # Idempotent no-op: the gang is already exactly there.
                # At-least-once delivery (a lost response, a fleet
                # daemon that crashed between the resize RPC and its
                # journal record) retries the same resize — the second
                # delivery must read as success or the caller livelocks
                # re-sending a resize that can never "succeed".
                return {"ok": True, "noop": True, "mgen": el.mgen,
                        "message": f"gang already has {size} member(s) "
                                   f"— no-op"}
            return {"ok": False, "message": str(e)}
        self._start_resize(members, f"operator resize to {size}")
        return {"ok": True, "mgen": el.mgen, "members": members,
                "message": f"resizing {el.job} to {len(members)} "
                           f"member(s) (membership generation {el.mgen})"}

    def migrate_application(self, target: str, job: str = "",
                            reason: str = "") -> dict:
        """Live migration (`tony-tpu migrate <app> <target>`): validated
        by policy (coordinator/migrate.py), then DRAIN the whole gang →
        final durable saves → relaunch on the target slice → barrier —
        the same machinery as a resize, pointed at a different slice."""
        el = self.elastic
        if el is None:
            return {"ok": False,
                    "message": "migration rides the elastic drain "
                               "machinery — set tony.elastic.enabled"
                               "=true"}
        try:
            plan = plan_migration(el, self.session, target, job=job,
                                  reason=reason)
        except MigrateRefused as e:
            return {"ok": False, "message": str(e)}
        self._start_migrate(plan.members, plan.target, plan.reason)
        return {"ok": True, "mgen": el.mgen,
                "members": list(plan.members), "source": plan.source,
                "target": plan.target,
                "message": f"migrating {el.job} ({len(plan.members)} "
                           f"member(s)) to {plan.target} (membership "
                           f"generation {el.mgen})"}

    def _check_heartbeats(self) -> None:
        """Liveness monitor (reference AbstractLivelinessMonitor usage
        :188-208; expiry → ``onTaskDeemedDead`` :1178-1185)."""
        now = time.monotonic()
        expired: List[tuple] = []
        with self._hb_lock:
            for task_id, last in list(self._last_hb.items()):
                if now - last > self._hb_expiry_s:
                    expired.append((task_id, now - last))
                    del self._last_hb[task_id]
        for task_id, hb_age_s in expired:
            t = self.session.get_task(task_id)
            if t is None or t.status.terminal:
                continue
            log.error("task %s missed heartbeats for %.1fs — deemed dead",
                      task_id, self._hb_expiry_s)
            if self._absorb_task_loss(
                    t, constants.EXIT_KILLED,
                    FailureDomain.INFRA_TRANSIENT.value,
                    reason=f"task {task_id} deemed dead (missed "
                           f"heartbeats for {self._hb_expiry_s:.1f}s)",
                    hb_age_s=hb_age_s, kill=True):
                # Host loss absorbed: the gang shrinks and continues —
                # no epoch failure, no retry burned.
                continue
            # Postmortem context BEFORE the tracker forgets the task: the
            # event must let an operator tell "executor vanished" (stale
            # heartbeat age, any progress state) from "executor alive,
            # user hung" (the TASK_HUNG path, which never comes through
            # here).
            progress_snap = self.progress.snapshot(task_id)
            self.progress.forget(task_id)
            self._end_task_span(task_id, deemed_dead=True,
                                heartbeat_age_s=round(hb_age_s, 3))
            if t.handle is not None:
                self.backend.kill_task(t.handle, grace_s=0.0)
            # Fail first so the recorded reason is the liveness expiry, not
            # the generic chief/worker-exit policy triggered by the kill.
            # A wedged/vanished executor is transient infra: the retry
            # epoch gets a fresh process on (possibly) fresh hardware.
            self.session.fail(f"task {task_id} deemed dead "
                              f"(missed heartbeats)",
                              FailureDomain.INFRA_TRANSIENT)
            self.session.on_task_completed(
                task_id, constants.EXIT_KILLED,
                domain_hint=FailureDomain.INFRA_TRANSIENT.value)
            self._record_failed_host(task_id,
                                     FailureDomain.INFRA_TRANSIENT)
            self.journal.task(
                task_id, t.status.value, self.session.session_id,
                exit_code=constants.EXIT_KILLED,
                domain=FailureDomain.INFRA_TRANSIENT.value)
            # The kill's eventual backend completion is a no-op (task
            # already terminal), so THIS is the only place the task's
            # TASK_FINISHED — with its liveness-expiry domain — can be
            # emitted.
            logs = self.backend.task_log_paths(task_id)
            self.events.emit(Event(EventType.TASK_FINISHED, {
                "task": task_id, "exit_code": constants.EXIT_KILLED,
                "status": t.status.value,
                "exit_detail": describe_exit(constants.EXIT_KILLED),
                "failure_domain": FailureDomain.INFRA_TRANSIENT.value,
                "reason": f"task {task_id} deemed dead (missed "
                          f"heartbeats for {self._hb_expiry_s:.1f}s)",
                "last_heartbeat_age_s": round(hb_age_s, 3),
                "progress": progress_snap or {},
                "metrics": self._task_metrics(task_id),
                "logs": list(logs) if logs else [],
                "session_id": self.session.session_id}))

    def _check_progress(self) -> None:
        """Progress-based liveness pass (coordinator/liveness.py): act on
        the tracker's verdicts. Heartbeat expiry proves a DEAD executor;
        this proves a LIVE executor whose user process stopped doing
        work — hang (frozen step counter → diagnose → kill → retry) and
        straggler (rate below the gang median → event, optional
        restart)."""
        for action in self.progress.poll():
            t = self.session.get_task(action.task_id)
            if t is None or t.status.terminal:
                continue
            payload = dict(action.info)
            payload.update({"task": action.task_id,
                            "session_id": self.session.session_id})
            if action.kind == liveness.WARN_UNINSTRUMENTED:
                log.warning(
                    "task %s reported no step counter within the %ss "
                    "warmup — progress liveness degrades to "
                    "heartbeat-only for it (instrument the training "
                    "loop with tony_tpu_torch.telemetry.step())",
                    action.task_id, action.info.get("warmup_s"))
                self.events.emit(Event(
                    EventType.TASK_PROGRESS_UNINSTRUMENTED, payload))
            elif action.kind == liveness.HUNG:
                log.error(
                    "task %s HUNG: heartbeats alive but step counter "
                    "frozen at %s for %.1fs (deadline %ss) — requesting "
                    "a stack dump, kill follows in %ss",
                    action.task_id, action.info.get("steps"),
                    action.info.get("stalled_s", 0.0),
                    action.info.get("timeout_s"),
                    self.progress.dump_grace_s)
                self.events.emit(Event(EventType.TASK_HUNG, payload))
            elif action.kind == liveness.STRAGGLER:
                log.warning(
                    "task %s STRAGGLING: %.3f steps/s vs gang median "
                    "%.3f (threshold %.0f%%) sustained %ss",
                    action.task_id,
                    action.info.get("rate_steps_per_s", 0.0),
                    action.info.get("median_steps_per_s", 0.0),
                    100 * float(action.info.get("fraction", 0.0)),
                    action.info.get("window_s"))
                self.events.emit(Event(EventType.TASK_STRAGGLER, payload))
            elif action.kind == liveness.HANG_KILL:
                reason = (f"task {action.task_id} hung: heartbeats alive "
                          f"but no step progress for "
                          f"{action.info.get('stalled_s', 0.0):.0f}s "
                          f"(progress deadline "
                          f"{action.info.get('timeout_s')}s)")
                # Elastic hang absorption (PR 8 carry-over): a hung
                # elastic member is drained out via resize like a host
                # loss — same epoch, no INFRA_TRANSIENT retry burned —
                # instead of failing the epoch. The absorb policy itself
                # (chief, min-tasks, elasticity off) decides; refusals
                # fall through to the ordinary hang-kill path.
                if self._absorb_task_loss(
                        t, constants.EXIT_KILLED,
                        FailureDomain.INFRA_TRANSIENT.value,
                        reason=reason, kill=True):
                    continue
                self._kill_unhealthy_task(
                    t, reason, action.info, capture_dump=True)
            elif action.kind == liveness.STRAGGLER_KILL:
                self._kill_unhealthy_task(
                    t, f"task {action.task_id} proactively restarted as "
                       f"a straggler: "
                       f"{action.info.get('rate_steps_per_s', 0.0):.3f} "
                       f"steps/s vs gang median "
                       f"{action.info.get('median_steps_per_s', 0.0):.3f}",
                    action.info, capture_dump=False)

    def _kill_unhealthy_task(self, t: Task, reason: str, info: dict,
                             capture_dump: bool) -> None:
        """Hang/straggler kill: TERM→grace→KILL the task and fail the
        epoch INFRA_TRANSIENT into the ordinary retry machinery — a wedge
        or skew is infra-shaped (fresh process, possibly fresh hardware,
        usually clears it), never a deterministic user crash. Mirrors the
        heartbeat-expiry kill, plus the captured diagnostics."""
        task_id = t.task_id
        hb_age_s = None
        with self._hb_lock:
            last = self._last_hb.pop(task_id, None)
            if last is not None:
                hb_age_s = time.monotonic() - last
        progress_snap = self.progress.snapshot(task_id)
        self.progress.forget(task_id)
        self._end_task_span(task_id, killed=reason[:200])
        dump_excerpt = self._stack_dump_excerpt(task_id) \
            if capture_dump else ""
        log.error("%s — killing into an INFRA_TRANSIENT retry", reason)
        # Verdict BEFORE the kill: kill_task blocks through its grace
        # window, and the dying executor reports its (TERM-shaped, 143)
        # exit over RPC inside that window — processed first, it would
        # re-label this deliberate restart as a chief PREEMPTION failure.
        # With the task already terminal, the late report is a no-op.
        self.session.fail(reason, FailureDomain.INFRA_TRANSIENT)
        self.session.on_task_completed(
            task_id, constants.EXIT_KILLED,
            domain_hint=FailureDomain.INFRA_TRANSIENT.value)
        self.journal.task(
            task_id, t.status.value, self.session.session_id,
            exit_code=constants.EXIT_KILLED,
            domain=FailureDomain.INFRA_TRANSIENT.value)
        if t.handle is not None:
            # A wedged user process rarely honours TERM, but the grace
            # window costs little and lets a merely-slow process flush
            # its save-on-TERM handlers before the KILL lands.
            self.backend.kill_task(
                t.handle,
                grace_s=min(self.conf.get_int(K.COORDINATOR_STOP_GRACE_S,
                                              15), 5))
        logs = self.backend.task_log_paths(task_id)
        payload = {
            "task": task_id, "exit_code": constants.EXIT_KILLED,
            "status": t.status.value,
            "exit_detail": describe_exit(constants.EXIT_KILLED),
            "failure_domain": FailureDomain.INFRA_TRANSIENT.value,
            "reason": reason,
            "progress": progress_snap or dict(info),
            "metrics": self._task_metrics(task_id),
            "logs": list(logs) if logs else [],
            "session_id": self.session.session_id}
        if hb_age_s is not None:
            payload["last_heartbeat_age_s"] = round(hb_age_s, 3)
        if dump_excerpt:
            payload["stack_dump_excerpt"] = dump_excerpt
        self.events.emit(Event(EventType.TASK_FINISHED, payload))

    def _stack_dump_excerpt(self, task_id: str,
                            max_bytes: int = 4096) -> str:
        """Best-effort: pull the faulthandler all-thread dump the executor
        triggered out of the task's stderr log, so the event stream holds
        the stacks even after task dirs are purged. Empty when the log is
        unreachable (remote host) or the dump never landed (user signal
        override, dump signal lost)."""
        from tony_tpu_torch.utils import logs as logutil

        paths = self.backend.task_log_paths(task_id)
        for path in reversed(paths or ()):  # stderr is the usual home
            tail = logutil.tail_text(path, 64 * 1024)
            if tail is None:
                continue
            excerpt = logutil.extract_stack_dump(tail, max_bytes)
            if excerpt:
                return excerpt
        return ""

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------
    def run(self) -> SessionStatus:
        """prepare → [start → monitor → reset?]* → stop
        (reference ``ApplicationMaster.run`` :312 + retry loop :337-371)."""
        self.rpc.start()
        self.events.start()
        recovered = self._recover_state is not None
        # Root coordinator span: parented under the client's submit span
        # (env trace context) on a fresh job; a recovery run is a new root
        # in the SAME trace — the outage reads as a gap between them.
        self._run_span = self.tracer.start_span(
            "coordinator.recover" if recovered else "coordinator.run",
            parent=os.environ.get(constants.TRACE_PARENT_ENV, "") or None,
            attrs={"app": self.app_id, "generation": self.generation})
        if not recovered:
            self.events.emit(Event(EventType.APPLICATION_INITED, {
                "app_id": self.app_id, "user": self.user,
                "conf": {k: v for k, v in self.conf.as_dict().items()
                         if not k.startswith("_")}}))
        self._final_conf_path = self.conf.freeze(
            os.path.join(self.job_dir, constants.FINAL_CONFIG_FILE))

        if os.environ.get(constants.TEST_COORDINATOR_CRASH) == "true":
            # Reference TEST_AM_CRASH aborts the AM after startup (:338-343).
            self.events.stop(history.final_name(
                self.app_id, self._started_ms, int(time.time() * 1000),
                self.user, "FAILED"))
            self.rpc.stop()
            raise CoordinatorCrash("TEST_COORDINATOR_CRASH requested")

        # On recovery the loop resumes AT the journaled epoch: the first
        # iteration re-adopts the surviving gang instead of launching one,
        # and any later retry epochs continue the same numbering.
        attempt = self._attempt
        first = True
        retry_domain: Optional[FailureDomain] = None
        try:
            local_cmd = str(self.conf.get(K.COORDINATOR_COMMAND, "") or "")
            single_node = not self.session.all_tasks()
            if local_cmd and not recovered and (
                    single_node or self.conf.get_bool(
                        K.APPLICATION_ENABLE_PREPROCESS)):
                # Preprocess / single-node path: run the command in the
                # coordinator (reference ``doPreprocessingJob`` :714-766 —
                # short-circuit the job if it fails). Not re-run on
                # recovery: a completed prepare stage's effects are on
                # disk, and re-running it mid-job is never safe to assume.
                code = self._do_local_job(local_cmd, register_tb=single_node)
                if code != 0:
                    self.session.fail(
                        f"coordinator-local job failed (exit {code})")
                    return self.final_status
                if single_node:
                    self.session.status = SessionStatus.SUCCEEDED
                    return self.final_status
            try:
                while True:
                    if first and recovered:
                        self._resume_session()
                    else:
                        self._start_session(attempt, retry_domain)
                    first = False
                    status = self._monitor()
                    self._close_epoch_spans(status)
                    if self.journal.dead is not None:
                        # An RPC-handler append (register/progress) hit
                        # the dead disk first: same terminal INFRA shape
                        # as the raise below, even if the monitor's own
                        # ticks kept succeeding in memory. fail_terminal
                        # on purpose — a finished epoch whose verdict
                        # can no longer be journaled must NOT read as
                        # SUCCEEDED (the history would claim a success
                        # the write-ahead journal never saw).
                        self.session.fail_terminal(
                            f"journal write failed: {self.journal.dead}",
                            FailureDomain.INFRA_TRANSIENT)
                        break
                    if status == SessionStatus.SUCCEEDED \
                            or self._stop_requested.is_set():
                        break
                    retry_domain = (self.session.failure_domain
                                    or FailureDomain.INFRA_TRANSIENT)
                    self.journal.verdict(
                        self.session.session_id, retry_domain.value,
                        self.session.failure_reason or "")
                    if not self._retry_available(retry_domain):
                        if retry_domain == FailureDomain.USER_ERROR \
                                and not self._retry_user_errors:
                            log.error(
                                "session %d failed with USER_ERROR (%s) "
                                "— terminal on first occurrence (set %s "
                                "to retry user errors anyway)", attempt,
                                self.session.failure_reason,
                                K.APPLICATION_RETRY_USER_ERRORS)
                        break
                    log.warning(
                        "session %d failed [%s] (%s); retrying "
                        "(transient budget %d/%d used, preemption %d/%d)",
                        attempt, retry_domain.value,
                        self.session.failure_reason,
                        self._infra_retries_used, self._retries_total,
                        self._preempt_retries_used,
                        self._preempt_retries_total)
                    self._reset_session()
                    attempt += 1
            except DurableWriteError as e:
                # The write-ahead journal died (ENOSPC/EIO) — whether
                # mid-monitor, on the retry path's verdict record, or in
                # a session reset. TERMINAL, domain INFRA: retrying
                # would schedule state transitions recovery can never
                # see, and the verdict/retry machinery itself journals.
                # Kill the gang with the full grace and stop — the
                # committed journal prefix stays replayable for
                # --recover.
                log.critical(
                    "journal write failed (%s) — failing the job "
                    "terminally [INFRA_TRANSIENT]", e)
                self.session.fail_terminal(
                    f"journal write failed: {e}",
                    FailureDomain.INFRA_TRANSIENT)
                self._kill_all_tasks(
                    self.conf.get_int(K.COORDINATOR_STOP_GRACE_S, 15))
        finally:
            self.final_status = self.session.update_status()
            if self._stop_requested.is_set() and self.final_status in (
                    SessionStatus.RUNNING, SessionStatus.FAILED):
                # A requested stop reads as KILLED even when the teardown
                # itself made tasks exit nonzero first (killing the gang
                # races the chief-failure policy) — YARN semantics: a
                # user-killed app is KILLED, not FAILED.
                self.final_status = SessionStatus.KILLED
            try:
                self._stop()
            except DurableWriteError as e:
                # Teardown writes the journal too (terminal states,
                # close). A disk that dies HERE must not crash the
                # coordinator out of its own exit path: the committed
                # prefix is already replayable, the history record below
                # still lands (separate file), so scream and finish.
                log.critical("journal write failed during teardown "
                             "(%s); committed prefix intact", e)
        return self.final_status

    def _do_local_job(self, cmd: str, register_tb: bool) -> int:
        """Run a command in the coordinator process (single-node/preprocess
        mode, reference ``ApplicationMaster.doPreprocessingJob`` :714-766):
        TB port registered for single-node, HOME pinned to the job dir for
        notebook-style servers, exit code short-circuits the job."""
        from tony_tpu_torch.executor.ports import ReservedPort
        from tony_tpu_torch.utils import proc as procutil

        env = dict(os.environ)
        env.update({
            constants.APP_ID: self.app_id,
            constants.JOB_NAME: "coordinator",
            constants.TASK_INDEX: "0",
            "HOME": self.job_dir,
            "PREPROCESSING_JOB": "true",
        })
        if register_tb:
            tb = ReservedPort(reuse=False)
            import socket as _socket
            self.tb_url = f"http://{_socket.gethostname()}:{tb.port}"
            env[constants.TB_PORT] = str(tb.port)
            tb.release()
        for kv in self.conf.get_list(K.EXECUTION_ENV):
            if "=" in kv:
                k, v = kv.split("=", 1)
                env[k] = v
        self.events.emit(Event(EventType.TASK_STARTED, {
            "task": "coordinator:0", "session_id": 0}))
        # The command blocks this thread, but force_kill arrives on the RPC
        # thread as _stop_requested — a watcher delivers the TERM→grace→KILL
        # ladder to the child's process group so a killed notebook/preprocess
        # job cannot orphan its server (reference stops preprocessing with
        # the AM teardown, ApplicationMaster.java:714-766 + :694-711).
        child: List[object] = []
        done = threading.Event()

        def _stop_watcher() -> None:
            while not done.wait(0.2):
                if self._stop_requested.is_set():
                    if not child:
                        # Stop arrived before on_start registered the
                        # child — keep polling; returning here would leave
                        # the about-to-spawn process unkillable.
                        continue
                    procutil.kill_process_groups(
                        [child[0].pid],
                        grace_s=self.conf.get_int(
                            K.COORDINATOR_STOP_GRACE_S, 15))
                    return

        watcher = threading.Thread(target=_stop_watcher,
                                   name="local-job-stop-watcher", daemon=True)
        watcher.start()
        try:
            code = procutil.execute_shell(
                cmd, timeout_s=self.conf.get_int(
                    K.TASK_EXECUTOR_EXECUTION_TIMEOUT_S, 0), env=env,
                on_start=lambda p: child.append(p))
        finally:
            done.set()
        self.events.emit(Event(EventType.TASK_FINISHED, {
            "task": "coordinator:0", "exit_code": code,
            "status": "SUCCEEDED" if code == 0 else "FAILED",
            "metrics": {}, "logs": [], "session_id": 0}))
        return code

    def _start_session(self, attempt: int,
                       retried_domain: Optional[FailureDomain] = None
                       ) -> None:
        if attempt > 0:
            # Rebuild the task matrix under a new epoch (reference
            # ``reset`` :559-575 — sessionId++ and re-request everything).
            self.session = Session(self.conf, session_id=attempt)
            with self._hb_lock:
                self._last_hb.clear()
                # The old gang's per-task residue dies with the epoch:
                # journal throttles, postmortem extracts (a stale
                # traceback must not attach to the new gang's exits) and
                # phase attribution (fresh processes restart their
                # telemetry counters at 0).
                self._progress_journal_t.clear()
                self._task_diag.clear()
                self._phase_latest.clear()
            # Progress state belongs to the old gang; the new epoch's
            # tasks re-arm from scratch (fresh warmup, fresh deadlines).
            self.progress.reset()
            self._worker_termination_done = False
            if self.elastic is not None:
                # The retry epoch relaunches at the CONFIGURED size; the
                # old gang's membership (and any in-flight resize) died
                # with it. mgen stays monotonic — zombies stay fenced.
                self.elastic.reset_for_epoch()
        # Bump the attempt only after the fresh session is installed: a
        # concurrent application_report must never see (old FAILED session,
        # new attempt) — that combination un-masks the transient FAILED.
        self._attempt = attempt
        if attempt > 0 and retried_domain is not None:
            # Consume the budget only AFTER the fresh RUNNING session is
            # installed: a report between consumption and install would
            # see (old FAILED session, exhausted budget) and un-mask the
            # transient FAILED on the last permitted retry.
            self._consume_retry(retried_domain)
        # The epoch record is the journal's per-epoch state barrier:
        # replay folds registrations/transitions only from the LAST epoch
        # record forward, with the budget counters as consumed so far.
        self.journal.epoch(attempt, self._infra_retries_used,
                           self._preempt_retries_used)
        self._reregistration_grace = False
        self._epoch_span = self.tracer.start_span(
            "session.epoch", parent=self._run_span,
            attrs={"epoch": attempt})
        self.scheduler = GangScheduler(self.conf, self._launch_job)
        self._schedule_start = time.monotonic()
        self._rendezvous_span = self.tracer.start_span(
            "gang.rendezvous", parent=self._epoch_span,
            attrs={"expected": self.session.num_expected})
        self.scheduler.schedule_ready()

    def _resume_session(self) -> None:
        """Recovery twin of _start_session: the journaled epoch's session
        was rebuilt in __init__; re-adopt the surviving gang instead of
        launching one. Executors re-register through the ordinary
        register_worker_spec path (their processes never stopped), under
        the re-registration grace window instead of the first-rendezvous
        timeout; jobtypes whose launch never hit the journal go through
        schedule_ready as usual."""
        st = self._recover_state
        scheduled = set(self.session.scheduled_job_names())
        live = [t for t in self.session.all_tasks()
                if not t.status.terminal and t.job_name in scheduled]
        log.warning(
            "recovery: generation %d resumes session epoch %d — %d task(s) "
            "awaiting re-registration (%ds grace), budgets used: "
            "transient %d/%d, preemption %d/%d",
            self.generation, self.session.session_id, len(live),
            self.conf.get_int(K.COORDINATOR_REREGISTRATION_GRACE_S, 60),
            self._infra_retries_used, self._retries_total,
            self._preempt_retries_used, self._preempt_retries_total)
        self.events.emit(Event(EventType.COORDINATOR_RECOVERED, {
            "app_id": self.app_id, "generation": self.generation,
            "session_id": self.session.session_id,
            "journal_records": st.records if st else 0,
            "awaiting_reregistration": [t.task_id for t in live]}))
        self._reregistration_grace = True
        self._epoch_span = self.tracer.start_span(
            "session.epoch", parent=self._run_span,
            attrs={"epoch": self.session.session_id, "resumed": True})
        self.scheduler = GangScheduler(self.conf, self._launch_job)
        self.scheduler.restore(st.scheduled_jobs, st.completed_jobs)
        self._schedule_start = time.monotonic()
        self._rendezvous_span = self.tracer.start_span(
            "gang.rendezvous", parent=self._epoch_span,
            attrs={"expected": self.session.num_expected,
                   "re_registration": True})
        self.scheduler.schedule_ready()
        if self.elastic is not None:
            # The pre-crash gang had completed its rendezvous (or the
            # journal would hold no registrations worth re-adopting).
            self.elastic.established = True
            has_migrate = (st is not None
                           and st.inflight_migrate_job == self.elastic.job
                           and st.inflight_migrate_members)
            has_resize = (st is not None
                          and st.inflight_job == self.elastic.job
                          and st.inflight_members)
            if has_migrate and has_resize:
                # Both in flight on the journal means one superseded the
                # other without its closing record landing — the newer
                # membership generation owns the gang.
                if st.inflight_migrate_mgen >= st.inflight_mgen:
                    has_resize = False
                else:
                    has_migrate = False
            if has_migrate:
                # Mid-migration crash: RE-ENTER the drain toward the
                # journaled target at the journaled mgen — parked
                # survivors re-register with that mgen and the move
                # completes instead of the job restarting.
                reason = st.inflight_migrate_reason \
                    or "resumed mid-migration"
                self._start_migrate(st.inflight_migrate_members,
                                    st.inflight_migrate_target, reason,
                                    mgen=st.inflight_migrate_mgen,
                                    resumed=True)
                op = self.elastic.op
                log.warning(
                    "recovery: resuming in-flight migration to %r "
                    "(%d member(s), mgen %d) — %d survivor(s) still to "
                    "park", st.inflight_migrate_target,
                    len(op.members) if op else 0,
                    st.inflight_migrate_mgen,
                    len(op.awaiting) if op else 0)
            elif has_resize:
                # Mid-resize crash: RE-ENTER the drain at the journaled
                # membership generation instead of abandoning the resize
                # — parked survivors re-register with that mgen and the
                # op completes under the recovery grace window.
                live = [t for t in self.session.all_tasks()
                        if t.job_name == self.elastic.job
                        and not t.status.terminal]
                reason = st.inflight_reason or "resumed mid-resize"
                op = self.elastic.begin(st.inflight_members, live,
                                        reason, mgen=st.inflight_mgen)
                self.journal.resize(self.elastic.job, op.mgen,
                                    op.members, "start",
                                    self.session.session_id,
                                    reason=reason)
                self.events.emit(Event(EventType.GANG_RESIZED, {
                    "job": self.elastic.job, "phase": "started",
                    "mgen": op.mgen, "members": list(op.members),
                    "from": op.size_before, "to": len(op.members),
                    "reason": reason, "resumed": True,
                    "session_id": self.session.session_id}))
                log.warning(
                    "recovery: resuming in-flight resize to %d member(s) "
                    "(mgen %d) — %d survivor(s) still to park",
                    len(op.members), op.mgen, len(op.awaiting))

    def _monitor(self) -> SessionStatus:
        """Reference ``monitor()`` :581-650 — 5 s loop; 500 ms here."""
        interval = self.conf.get_int(K.COORDINATOR_MONITOR_INTERVAL_MS,
                                     500) / 1000.0
        timeout_s = self.conf.get_int(K.APPLICATION_TIMEOUT_S, 0)
        reg_timeout_s = self.conf.get_int(K.TASK_REGISTRATION_TIMEOUT_S, 900)
        regrace_s = self.conf.get_int(K.COORDINATOR_REREGISTRATION_GRACE_S,
                                      60)
        # Anchor the self-observation clock: the first tick_done only
        # records "now" so the first folded interval is a real tick.
        self.coordphases.tick_done()
        while True:
            if faults.fire("coordinator.crash"):
                # The SIGKILL shape: no teardown, no history finalize, no
                # gang kill — exactly what --recover must survive. The
                # call counter is monitor iterations, so `at:K` places
                # the crash deterministically mid-job.
                log.critical("FAULT coordinator.crash: hard-exiting with "
                             "no teardown (os._exit)")
                os._exit(137)
            slow_tick = faults.fire_amount("coord.slow-tick")
            if slow_tick:
                # Injected control-plane stall: the tick stretches by the
                # configured amount BEFORE any per-tick work, so the
                # slowdown lands in the tick-duration accounting the
                # self-observation surfaces must show.
                time.sleep(slow_tick)
            if self._reregistration_grace and self.session.all_registered():
                log.info("recovery: all surviving tasks re-registered; "
                         "resuming normal monitoring")
                self._reregistration_grace = False
            with self.coordphases.phase("rendezvous_barrier"):
                if self._rendezvous_span is not None \
                        and self.session.all_registered():
                    # The gang barrier opened: every later step (first
                    # step, epochs) hangs off a closed rendezvous on the
                    # timeline.
                    self._rendezvous_span.end(
                        registered=self.session.num_registered)
                    self._rendezvous_span = None
                    if self.elastic is not None:
                        # Resizes only make sense against an established
                        # gang; losses before this point are rendezvous
                        # failures, not absorbable churn.
                        self.elastic.established = True
            # Live-metrics export (throttled internally): keeps the
            # portal's /metrics exposition fresh while the job runs.
            self._maybe_write_prom()
            if self._stop_requested.is_set():
                self.session.fail(self._stop_reason or "stop requested")
                # TERM with the FULL configured grace (reference
                # stop-with-grace, ApplicationMaster.java:694-711): a
                # force-killed job's save-on-SIGTERM handlers
                # (checkpoint/manager.install_preemption_handler) get the
                # whole window to make the final save durable.
                self._kill_all_tasks(
                    self.conf.get_int(K.COORDINATOR_STOP_GRACE_S, 15))
                return self.session.status
            if timeout_s and (time.monotonic() - self._schedule_start
                              > timeout_s):
                # The job exceeded its OWN configured wall-clock budget —
                # a rerun would exceed it again. USER_ERROR: terminal.
                self.session.fail(f"application timed out after {timeout_s}s",
                                  FailureDomain.USER_ERROR)
                return self.session.status
            reg_window = regrace_s if self._reregistration_grace \
                else reg_timeout_s
            if not self.session.all_registered() and reg_window and \
                    self.session.num_expected > 0 \
                    and (time.monotonic() - self._schedule_start
                         > reg_window):
                # Gang rendezvous timed out (reference registration timeout
                # kills stuck allocations, ApplicationMaster.java:791-888).
                # In recovery this is the re-registration grace expiring:
                # the gang did not survive the coordinator outage after
                # all — fall through to the ordinary retry machinery.
                what = ("re-registration grace (recovery)"
                        if self._reregistration_grace
                        else "registration timeout")
                self.session.fail(
                    f"{what}: {self.session.num_registered}/"
                    f"{self.session.num_expected} tasks registered within "
                    f"{reg_window}s", FailureDomain.INFRA_TRANSIENT)
                return self.session.status
            for task_id, exit_code in self.backend.poll_completions():
                self._process_completion(task_id, exit_code)
            with self.coordphases.phase("hb_scan"):
                self._check_heartbeats()
            self._check_progress()
            self._alerts_tick()
            self._elastic_tick()
            if self.session.status != SessionStatus.RUNNING:
                return self.session.status
            if self.session.training_finished():
                return self.session.update_status()
            with self.coordphases.phase("idle"):
                time.sleep(interval)
            # Close this tick's attribution interval (sum-to-wall fold,
            # like step_done for the data plane).
            self.coordphases.tick_done()

    def _kill_all_tasks(self, grace_s: float,
                        mark: str = "killed") -> None:
        """TERM→grace→KILL every non-terminal task, CONCURRENTLY: each
        kill_task blocks up to grace_s, and a serial loop would make
        teardown latency N·grace — longer than the client is willing to
        wait for the coordinator. One loop, one grace policy per call
        site (the previous three hand-rolled copies had three different
        caps, which is how the preemption-save window silently shrank to
        2 s)."""
        tasks = [t for t in self.session.all_tasks()
                 if t.handle is not None and not t.status.terminal]
        threads = [threading.Thread(
            target=self.backend.kill_task, args=(t.handle,),
            kwargs={"grace_s": grace_s}, daemon=True,
            name=f"kill-{t.task_id}") for t in tasks]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=grace_s + 30)
        for t in tasks:
            if mark == "none":
                continue          # epoch reset: the session is replaced
            if mark == "teardown" and not t.tracked:
                t.status = TaskStatus.SUCCEEDED  # ps-style normal teardown
            else:
                self.session.mark_killed(t.task_id)

    def _reset_session(self) -> None:
        # Short grace: the whole point of an epoch reset is a fast retry,
        # and the failed epoch's periodic checkpoints are the resume
        # source (save-on-TERM still gets 1 s for tiny states).
        grace = min(self.conf.get_int(K.COORDINATOR_STOP_GRACE_S, 15), 1)
        # The old gang's lifecycle spans end here: the epoch reset is the
        # terminal event for tasks killed with mark="none" (they never
        # reach _process_completion under the replaced session).
        for task_id in list(self._task_spans):
            self._end_task_span(task_id, epoch_reset=True)
        self._kill_all_tasks(grace, mark="none")
        # Wait for the old gang to be FULLY down, draining exits as they
        # land. Breaking on the first empty poll is not enough: a killed
        # task that hasn't exited yet polls as nothing-to-report, and
        # relaunching while it lives trips the slice backend's
        # one-gang-per-lease invariant ("lost hosts while its gang is
        # still running") — a race observed under CI load.
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            self.backend.poll_completions()
            if not self.backend.gang_active():
                break
            time.sleep(0.1)
        else:
            log.warning("old gang still has live tasks after reset grace; "
                        "relaunch may be refused by the backend")
        self.backend.poll_completions()   # clear final stale completions

    def _maybe_diagnose(self) -> None:
        """Automatic failure diagnosis (tony_tpu_torch/diagnosis/): on any
        non-SUCCEEDED finish, flush the event stream to disk, run the
        collector + rule engine over the job dir, write incident.json,
        and emit JOB_DIAGNOSED so downstream tooling sees the verdict
        without re-running the engine. Best-effort by contract: the
        flight recorder must never be the reason a teardown fails."""
        if self.final_status == SessionStatus.SUCCEEDED:
            return
        if not self.conf.get_bool(K.DIAGNOSIS_ENABLED, True):
            return
        try:
            from tony_tpu_torch import diagnosis

            # The collector reads the in-progress jhist file from disk;
            # the async writer must materialize everything emitted so
            # far (including APPLICATION_FINISHED) first.
            self.events.flush()
            incident = diagnosis.diagnose_job_dir(
                self.job_dir, app_id=self.app_id,
                tail_bytes=self.conf.get_int(
                    K.DIAGNOSIS_LOG_TAIL_BYTES, 65536))
            # The just-emitted APPLICATION_FINISHED carries the final
            # status; stamp it in case the stream lagged anyway.
            incident["status"] = self.final_status.value
            incident["provisional"] = False
            path = os.path.join(self.job_dir, constants.INCIDENT_FILE)
            diagnosis.save_incident(path, incident)
            v = incident.get("verdict") or {}
            log.warning(
                "incident diagnosis: %s (blamed task %s, rule %s) — "
                "report at %s", v.get("category", "UNKNOWN"),
                v.get("blamed_task") or "-", v.get("rule", "?"), path)
            self.events.emit(Event(EventType.JOB_DIAGNOSED, {
                "app_id": self.app_id,
                "category": v.get("category", "UNKNOWN"),
                "blamed_task": v.get("blamed_task", ""),
                "rule": v.get("rule", ""),
                "confidence": v.get("confidence", 0.0),
                "summary": v.get("summary", ""),
                "incident_path": path}))
        except Exception:  # noqa: BLE001 — diagnosis is best-effort
            log.exception("incident diagnosis failed")

    def _stop(self) -> None:
        """Reference ``stop()`` :670-711 — stop running tasks with grace,
        wait for the client finish signal, finalize history."""
        # Full grace: the survivors here are untracked services (ps,
        # heads, notebooks) on a job that already finished — they get the
        # same TERM window as everyone else (a TERM-honouring service
        # exits immediately; only TERM-ignoring ones cost the window).
        self._kill_all_tasks(
            self.conf.get_int(K.COORDINATOR_STOP_GRACE_S, 15),
            mark="teardown")
        if self.conf.get_bool(K.APPLICATION_NUM_CLIENTS_TO_WAIT, True):
            self.client_signalled_finish.wait(
                timeout=self.conf.get_int(K.COORDINATOR_STOP_GRACE_S, 15))
        conf_url = str(self.conf.get(K.INTERNAL_CONF_URL, "") or "")
        if conf_url and self.conf.get_bool(K.APPLICATION_PROFILER_ENABLED):
            # Pull store-staged chief traces into the job dir so the
            # portal's /profiles view works for remote-host jobs too.
            try:
                from tony_tpu_torch.storage import get_store

                url = self._profile_store_url(conf_url)
                store = get_store(url)
                if store.isdir(url):
                    store.get_tree(url, os.path.join(self.job_dir,
                                                     "profile"))
            except Exception as e:  # noqa: BLE001 — teardown best-effort
                log.warning("profile trace localization failed: %s", e)
        if self.final_status == SessionStatus.SUCCEEDED \
                and not self._alerts_degraded:
            # A SUCCEEDED job's journal must not end with an alert
            # firing (the alert-journal invariant): force-resolve every
            # open rule while the journal and event stream are still
            # writable. Failed jobs deliberately KEEP their firing
            # alerts — they are the diagnosis engine's evidence.
            try:
                for tr in self.alerts.resolve_all():
                    self._apply_alert_transition(tr)
            except Exception:  # noqa: BLE001 — teardown best-effort
                log.exception("alert teardown resolve failed")
        # Step-time attribution report BEFORE diagnosis: the incident
        # bundle attaches perf.json as its perf advisory section.
        self._write_perf_report()
        self.events.emit(Event(EventType.APPLICATION_FINISHED, {
            "app_id": self.app_id, "status": self.final_status.value,
            "failure_reason": self.session.failure_reason or "",
            "failure_domain": (self.session.failure_domain.value
                               if self.session.failure_domain else ""),
        }))
        self._maybe_diagnose()
        # Close the trace: untracked services killed at teardown still
        # hold open lifecycle spans; the finish marker + root span close
        # the tree (zero unclosed spans on any orderly shutdown), and the
        # final exposition snapshot freezes terminal task states.
        for task_id in list(self._task_spans):
            self._end_task_span(task_id, teardown=True)
        self.tracer.instant("application.finished", parent=self._run_span,
                            attrs={"status": self.final_status.value})
        self._run_span.end(status=self.final_status.value)
        self._maybe_write_prom(force=True)
        self.events.stop(history.final_name(
            self.app_id, self._started_ms, int(time.time() * 1000), self.user,
            self.final_status.value))
        self.journal.close()
        self.backend.stop()
        self.rpc.stop()
        self.tracer.close()
