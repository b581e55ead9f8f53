"""Write-ahead session journal: the coordinator's crash-survivable memory.

The reference inherited application-master restart from YARN
(``keepContainersAcrossApplicationAttempts``: the AM dies, comes back,
and the containers — the gang — keep running). Our coordinator had no
equivalent: Session/Task state lived only in memory
(``coordinator/session.py``), so a coordinator crash lost the job even
though the executors, the rendezvous, and the verified checkpoints all
survived. This module closes that gap: every control-plane state
transition — registration, task state change, epoch reset, failure
verdict, generation bump — is appended as one JSON line and fsync'd
BEFORE the transition is acted on (write-ahead discipline), into a file
next to the job's history stream. ``replay`` folds the journal back into
the state a restarted coordinator needs to resume the SAME epoch and
enter a re-registration grace window instead of launching a fresh gang.

Format: JSON lines (same choice as the event stream — self-describing,
greppable, no schema compiler); one record per line, ``"t"`` is the
record type. Torn final record (the crash window between ``write`` and
``fsync``, utils/durable.py): replay stops at the first undecodable or
unterminated line and uses the prefix — NEVER an exception. Losing the
last record is safe by construction: write-ahead means the lost record's
transition was not yet acted on, so the world matches the prefix.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Callable, Dict, Iterable, Iterator, Optional, Set, Tuple

from tony_tpu_torch.utils.durable import AppendLog, DurableWriteError

log = logging.getLogger(__name__)

#: record types (the "t" field)
REC_GENERATION = "gen"            # coordinator (re)start: generation bump
REC_APP = "app"                   # app identity: app_id/started_ms/user
REC_EPOCH = "epoch"               # session (re)start at a retry epoch
REC_JOB_SCHEDULED = "job_scheduled"
REC_JOB_COMPLETED = "job_completed"
REC_REGISTER = "register"         # executor registration (host/port)
REC_TASK = "task"                 # task state transition
REC_VERDICT = "verdict"           # failure-domain verdict for an epoch
REC_PROGRESS = "progress"         # throttled task step-counter checkpoint
REC_RESIZE = "resize"             # elastic membership change (start/applied)
REC_MIGRATE = "migrate"           # live slice migration (start/applied/
                                  # superseded) — coordinator/migrate.py
REC_ALERT = "alert"               # alert state transition (pending/
                                  # firing/resolved) — tony_tpu_torch/alerts/


class JournalError(RuntimeError):
    pass


@dataclasses.dataclass
class TaskRecord:
    """Folded per-task state for the CURRENT epoch."""

    status: str = "NEW"
    host: str = ""
    port: int = 0
    registered: bool = False
    exit_code: Optional[int] = None
    domain: str = ""
    # Last journalled step counter (-1 = none): seeds the recovered
    # coordinator's progress tracker so hang deadlines RESUME (fresh
    # clock, armed state) instead of instantly expiring across the
    # outage (coordinator/liveness.py track(steps_hint=...)).
    steps: float = -1.0


@dataclasses.dataclass
class ReplayState:
    """What a recovering coordinator reconstructs from the journal."""

    generation: int = 0
    app_id: str = ""
    started_ms: int = 0
    user: str = ""
    session_id: int = 0
    infra_retries_used: int = 0
    preempt_retries_used: int = 0
    scheduled_jobs: Set[str] = dataclasses.field(default_factory=set)
    completed_jobs: Set[str] = dataclasses.field(default_factory=set)
    tasks: Dict[str, TaskRecord] = dataclasses.field(default_factory=dict)
    records: int = 0              # complete records replayed
    torn_tail: bool = False       # a torn/undecodable suffix was dropped
    # --- elastic membership (coordinator/elastic.py) -------------------
    # Highest membership generation journaled (monotonic across lives).
    elastic_mgen: int = 0
    # Member indices of the LAST applied resize per job — the matrix the
    # recovered coordinator must rebuild (None = never resized).
    applied_members: Dict[str, list] = dataclasses.field(
        default_factory=dict)
    # An in-flight resize (start with no matching applied): the recovered
    # coordinator re-enters the drain instead of abandoning it, so a
    # mid-resize crash completes the resize rather than restarting the
    # job. (job, mgen, members, reason) — empty job = none.
    inflight_job: str = ""
    inflight_mgen: int = 0
    inflight_members: list = dataclasses.field(default_factory=list)
    inflight_reason: str = ""
    # --- live migration (coordinator/migrate.py) -----------------------
    # Target slice of the LAST applied migration per job: the recovered
    # coordinator re-pins job.node_pool so relaunches land on the slice
    # the job actually moved to.
    migrated_target: Dict[str, str] = dataclasses.field(
        default_factory=dict)
    # An in-flight migration (start with no applied/superseded): the
    # recovered coordinator re-enters the drain toward the target
    # instead of abandoning the move. Empty job = none.
    inflight_migrate_job: str = ""
    inflight_migrate_mgen: int = 0
    inflight_migrate_members: list = dataclasses.field(
        default_factory=list)
    inflight_migrate_target: str = ""
    inflight_migrate_reason: str = ""
    # --- alerting (tony_tpu_torch/alerts/) -----------------------------------
    # Last journaled state per alert rule (last-wins fold). NOT cleared
    # on REC_EPOCH: an alert watches the job across retry epochs — a
    # heartbeat alert that fired in epoch 2 is still firing while epoch
    # 3's gang launches. Seeds AlertEngine.seed() on --recover so a
    # firing alert survives a coordinator SIGKILL.
    alerts: Dict[str, str] = dataclasses.field(default_factory=dict)


class SessionJournal:
    """Append side. ``enabled=False`` turns every append into a no-op so
    the journal can be conf-gated without littering call sites.

    ``observer`` is the control-plane self-observation seam
    (coordinator/coordphases.py): called ``(n_bytes, seconds)`` after
    every fsync'd append, it feeds the ``journal_fsync`` tick phase, the
    fsync-latency histogram, and the records/bytes rate counters — the
    numbers behind the JOURNAL_BOUND verdict. Best-effort by contract:
    an observer failure must never fail a write-ahead append."""

    def __init__(self, path: str, enabled: bool = True,
                 observer: Optional[Callable[[int, float], None]]
                 = None) -> None:
        self.path = path
        self.enabled = enabled
        self.observer = observer
        #: first durable-write failure, sticky (ENOSPC/EIO). The FIRST
        #: failing append raises so the caller hears it; later appends
        #: no-op — the journal is declared dead ONCE, loudly, and the
        #: teardown/verdict paths must not cascade tracebacks against a
        #: disk that cannot take the write anyway. The committed prefix
        #: on disk stays replayable (readers tolerate a torn tail).
        self.dead: Optional[DurableWriteError] = None
        self._log: Optional[AppendLog] = AppendLog(path) if enabled else None

    def append(self, record: Dict) -> None:
        if self._log is None:
            return
        if self.dead is not None:
            return
        record.setdefault("ts", int(time.time() * 1000))
        data = (json.dumps(record, sort_keys=True) + "\n").encode("utf-8")
        t0 = time.monotonic()
        try:
            self._log.append(data)
        except DurableWriteError as e:
            self.dead = e
            log.critical(
                "session journal %s is DEAD (%s): failing loudly — a "
                "coordinator that cannot journal cannot be recovered "
                "truthfully; the committed prefix remains replayable",
                self.path, e)
            raise
        if self.observer is not None:
            try:
                self.observer(len(data), time.monotonic() - t0)
            except Exception:  # noqa: BLE001 — observation is best-effort
                log.exception("journal observer failed")

    # -- typed convenience appenders (one per record shape) ---------------
    def generation(self, generation: int) -> None:
        self.append({"t": REC_GENERATION, "generation": generation})

    def app(self, app_id: str, started_ms: int, user: str) -> None:
        self.append({"t": REC_APP, "app_id": app_id,
                     "started_ms": started_ms, "user": user})

    def epoch(self, session_id: int, infra_used: int,
              preempt_used: int) -> None:
        self.append({"t": REC_EPOCH, "session": session_id,
                     "infra_used": infra_used, "preempt_used": preempt_used})

    def job_scheduled(self, job: str, session_id: int) -> None:
        self.append({"t": REC_JOB_SCHEDULED, "job": job,
                     "session": session_id})

    def job_completed(self, job: str, session_id: int) -> None:
        self.append({"t": REC_JOB_COMPLETED, "job": job,
                     "session": session_id})

    def register(self, task_id: str, host: str, port: int,
                 session_id: int) -> None:
        self.append({"t": REC_REGISTER, "task": task_id, "host": host,
                     "port": port, "session": session_id})

    def task(self, task_id: str, status: str, session_id: int,
             exit_code: Optional[int] = None, domain: str = "") -> None:
        rec = {"t": REC_TASK, "task": task_id, "status": status,
               "session": session_id}
        if exit_code is not None:
            rec["exit"] = exit_code
        if domain:
            rec["domain"] = domain
        self.append(rec)

    def verdict(self, session_id: int, domain: str, reason: str) -> None:
        self.append({"t": REC_VERDICT, "session": session_id,
                     "domain": domain, "reason": reason})

    def progress(self, task_id: str, steps: float, session_id: int) -> None:
        """Throttled by the caller (liveness.PROGRESS_JOURNAL_MIN_INTERVAL_S)
        — the journal is fsync'd and must stay control-plane-rate."""
        self.append({"t": REC_PROGRESS, "task": task_id, "steps": steps,
                     "session": session_id})

    def resize(self, job: str, mgen: int, members: Iterable[int],
               phase: str,
               session_id: int, reason: str = "") -> None:
        """Elastic membership transition. Write-ahead discipline:
        ``phase="start"`` lands BEFORE any drain directive is issued and
        ``phase="applied"`` BEFORE the new topology's launches, so a
        crash anywhere inside a resize replays into either "re-enter the
        drain" or "the new matrix, under the re-registration grace"."""
        self.append({"t": REC_RESIZE, "job": job, "mgen": int(mgen),
                     "members": sorted(int(m) for m in members),
                     "phase": phase, "session": session_id,
                     "reason": reason})

    def migrate(self, job: str, mgen: int, members: Iterable[int],
                phase: str, target: str, session_id: int,
                reason: str = "") -> None:
        """Live-migration transition (coordinator/migrate.py). Same
        write-ahead discipline as ``resize``: ``phase="start"`` lands
        BEFORE the drain directive, ``phase="applied"`` BEFORE the
        destination launches, and ``phase="superseded"`` when a host
        loss mid-migration folds the op into an ordinary elastic
        shrink — every start is closed by applied/superseded/epoch."""
        self.append({"t": REC_MIGRATE, "job": job, "mgen": int(mgen),
                     "members": sorted(int(m) for m in members),
                     "phase": phase, "target": target,
                     "session": session_id, "reason": reason})

    def alert(self, rule: str, state: str, severity: str,
              value: Optional[float], labels: Dict[str, str],
              summary: str) -> None:
        """Alert state-machine transition (tony_tpu_torch/alerts/). Write-ahead
        like everything else: the record lands BEFORE the ALERT_FIRING/
        ALERT_RESOLVED event or gauge update, so a recovered coordinator
        re-arms the exact firing set. The engine's dedup fence guarantees
        consecutive records for a rule never repeat a state."""
        rec = {"t": REC_ALERT, "rule": rule, "state": state,
               "severity": severity, "summary": summary}
        if value is not None:
            rec["value"] = float(value)
        if labels:
            rec["labels"] = dict(labels)
        self.append(rec)

    def close(self) -> None:
        if self._log is not None:
            self._log.close()
            self._log = None


def _iter_complete_lines(path: str) -> Tuple[Iterator[bytes], bool]:
    """Yield complete (newline-terminated) lines; a trailing unterminated
    line is the torn-write window and is dropped, flagged via the second
    yield element."""
    with open(path, "rb") as f:
        buf = f.read()
    end = buf.rfind(b"\n")
    torn = end != len(buf) - 1 and len(buf) > 0
    if end < 0:
        return iter(()), torn or bool(buf)
    return iter(buf[:end].split(b"\n")), torn


def replay(path: str) -> ReplayState:
    """Fold the journal into a ReplayState.

    Torn/corrupt tail: replay consumes records in order and STOPS at the
    first line that fails to decode — the remainder is the crash window
    and the write-ahead discipline guarantees the world matches the
    prefix. A missing journal is a JournalError (recovery was requested
    for a job that never journaled — operator error, say so plainly).
    """
    if not os.path.exists(path):
        raise JournalError(
            f"no session journal at {path} — this job was not run with "
            f"the journal enabled (tony.coordinator.journal-enabled), or "
            f"the wrong history/job directory was given")
    state = ReplayState()
    lines, torn = _iter_complete_lines(path)
    state.torn_tail = bool(torn)
    for raw in lines:
        raw = raw.strip()
        if not raw:
            continue
        try:
            rec = json.loads(raw.decode("utf-8"))
            if not isinstance(rec, dict):
                raise ValueError("record is not an object")
        except (ValueError, UnicodeDecodeError) as e:
            # Mid-file damage cannot be attributed to the torn-write
            # window, but the recovery contract is the same: replay the
            # prefix rather than refuse to recover at all.
            log.warning("journal %s: undecodable record after %d good "
                        "ones (%s) — replaying the prefix", path,
                        state.records, e)
            state.torn_tail = True
            break
        state.records += 1
        t = rec.get("t")
        if t == REC_GENERATION:
            state.generation = max(state.generation,
                                   int(rec.get("generation", 0) or 0))
        elif t == REC_APP:
            state.app_id = str(rec.get("app_id", "") or "")
            state.started_ms = int(rec.get("started_ms", 0) or 0)
            state.user = str(rec.get("user", "") or "")
        elif t == REC_EPOCH:
            # A new epoch supersedes all per-epoch state before it.
            state.session_id = int(rec.get("session", 0) or 0)
            state.infra_retries_used = int(rec.get("infra_used", 0) or 0)
            state.preempt_retries_used = int(rec.get("preempt_used", 0) or 0)
            state.scheduled_jobs.clear()
            state.completed_jobs.clear()
            state.tasks.clear()
            # Membership belongs to the epoch's gang (a retry epoch
            # relaunches at the configured size); the generation itself
            # stays monotonic so old-topology zombies stay fenced.
            state.applied_members.clear()
            state.inflight_job = ""
            state.inflight_members = []
            state.inflight_reason = ""
            state.inflight_mgen = 0
            # A retry epoch relaunches wherever its conf points: the
            # applied-migration pin and any in-flight move die with the
            # gang they were moving (an epoch reset CLOSES a dangling
            # migrate start — the invariant checker counts on it).
            state.migrated_target.clear()
            state.inflight_migrate_job = ""
            state.inflight_migrate_members = []
            state.inflight_migrate_target = ""
            state.inflight_migrate_reason = ""
            state.inflight_migrate_mgen = 0
        elif t == REC_JOB_SCHEDULED:
            if int(rec.get("session", 0) or 0) == state.session_id:
                state.scheduled_jobs.add(str(rec.get("job", "")))
        elif t == REC_JOB_COMPLETED:
            if int(rec.get("session", 0) or 0) == state.session_id:
                state.completed_jobs.add(str(rec.get("job", "")))
        elif t == REC_REGISTER:
            if int(rec.get("session", 0) or 0) != state.session_id:
                continue
            tr = state.tasks.setdefault(str(rec.get("task", "")),
                                        TaskRecord())
            tr.host = str(rec.get("host", "") or "")
            tr.port = int(rec.get("port", 0) or 0)
            tr.registered = True
            if tr.status in ("NEW", "SCHEDULED"):
                tr.status = "RUNNING"
        elif t == REC_TASK:
            if int(rec.get("session", 0) or 0) != state.session_id:
                continue
            tr = state.tasks.setdefault(str(rec.get("task", "")),
                                        TaskRecord())
            tr.status = str(rec.get("status", tr.status) or tr.status)
            if "exit" in rec:
                tr.exit_code = int(rec["exit"])
            if rec.get("domain"):
                tr.domain = str(rec["domain"])
        elif t == REC_PROGRESS:
            if int(rec.get("session", 0) or 0) != state.session_id:
                continue
            tr = state.tasks.setdefault(str(rec.get("task", "")),
                                        TaskRecord())
            try:
                tr.steps = float(rec.get("steps", -1.0))
            except (TypeError, ValueError):
                pass
        elif t == REC_RESIZE:
            if int(rec.get("session", 0) or 0) != state.session_id:
                continue
            job = str(rec.get("job", "") or "")
            mgen = int(rec.get("mgen", 0) or 0)
            members = [int(m) for m in rec.get("members", []) or []]
            state.elastic_mgen = max(state.elastic_mgen, mgen)
            if rec.get("phase") == "applied":
                state.applied_members[job] = members
                # The applied topology supersedes the removed tasks'
                # folded state AND any in-flight start it completes.
                state.tasks = {
                    tid: tr for tid, tr in state.tasks.items()
                    if tid.partition(":")[0] != job
                    or int(tid.rpartition(":")[2]) in members}
                if state.inflight_job == job \
                        and state.inflight_mgen <= mgen:
                    state.inflight_job = ""
                    state.inflight_members = []
                    state.inflight_reason = ""
                    state.inflight_mgen = 0
            else:                  # "start": a resize is in flight
                state.inflight_job = job
                state.inflight_mgen = mgen
                state.inflight_members = members
                state.inflight_reason = str(rec.get("reason", "") or "")
        elif t == REC_MIGRATE:
            if int(rec.get("session", 0) or 0) != state.session_id:
                continue
            job = str(rec.get("job", "") or "")
            mgen = int(rec.get("mgen", 0) or 0)
            members = [int(m) for m in rec.get("members", []) or []]
            target = str(rec.get("target", "") or "")
            state.elastic_mgen = max(state.elastic_mgen, mgen)
            phase = rec.get("phase")
            if phase == "applied":
                # The move completed: relaunches must land on the
                # target slice, and the same-member topology is the
                # applied matrix. EVERY task was replaced by a fresh
                # destination launch — drop the source gang's folded
                # records (host/port/registered belong to dead
                # executors); the destination's REC_TASK/REC_REGISTER
                # records that follow rebuild them.
                state.migrated_target[job] = target
                state.applied_members[job] = members
                state.tasks = {
                    tid: tr for tid, tr in state.tasks.items()
                    if tid.partition(":")[0] != job}
                if state.inflight_migrate_job == job \
                        and state.inflight_migrate_mgen <= mgen:
                    state.inflight_migrate_job = ""
                    state.inflight_migrate_members = []
                    state.inflight_migrate_target = ""
                    state.inflight_migrate_reason = ""
                    state.inflight_migrate_mgen = 0
            elif phase == "superseded":
                # A host loss mid-migration folded the op into an
                # ordinary elastic shrink: the move is abandoned, the
                # resize records that follow own the membership story.
                if state.inflight_migrate_job == job \
                        and state.inflight_migrate_mgen <= mgen:
                    state.inflight_migrate_job = ""
                    state.inflight_migrate_members = []
                    state.inflight_migrate_target = ""
                    state.inflight_migrate_reason = ""
                    state.inflight_migrate_mgen = 0
            else:                  # "start": a migration is in flight
                state.inflight_migrate_job = job
                state.inflight_migrate_mgen = mgen
                state.inflight_migrate_members = members
                state.inflight_migrate_target = target
                state.inflight_migrate_reason = str(
                    rec.get("reason", "") or "")
        elif t == REC_ALERT:
            # Last-wins per rule; deliberately NOT epoch-scoped (see the
            # ReplayState field comment).
            rule = str(rec.get("rule", "") or "")
            if rule:
                state.alerts[rule] = str(rec.get("state", "") or "")
        elif t == REC_VERDICT:
            pass                   # forensic record; no folded state
        else:
            # Unknown record types from a NEWER build replaying an older
            # coordinator's journal: skip, do not fail recovery.
            log.warning("journal %s: unknown record type %r skipped",
                        path, t)
    return state
