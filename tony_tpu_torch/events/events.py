"""Asynchronous structured event stream for job history.

Reference model: ``events/EventHandler.java`` (157 LoC) — a BlockingQueue
drained by a writer thread into an Avro container file named
``<appId>-<start>[-<end>]-<user>[-STATUS].jhist`` under the job's history
directory, written as ``.inprogress`` and renamed on completion
(:43-60, :98-113, :126-135). Event types are APPLICATION_INITED,
APPLICATION_FINISHED, TASK_STARTED, TASK_FINISHED (``avro/EventType.avsc``).

This build uses JSON-lines instead of Avro (self-describing, greppable, no
schema compiler) with the same lifecycle: queue → writer thread → in-progress
file → atomic rename to final name carrying end-time and status.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
import queue
import threading
import time
from typing import Any, Dict, List, Optional


class EventType(str, enum.Enum):
    APPLICATION_INITED = "APPLICATION_INITED"
    APPLICATION_FINISHED = "APPLICATION_FINISHED"
    TASK_STARTED = "TASK_STARTED"
    TASK_FINISHED = "TASK_FINISHED"
    # A coordinator restarted with --recover re-adopted this job mid-run
    # (coordinator/journal.py); payload carries the new generation and
    # the tasks awaiting re-registration. No reference analogue — the AM
    # restart was invisible in jhist; operators asked why a job "paused".
    COORDINATOR_RECOVERED = "COORDINATOR_RECOVERED"
    # Progress-based liveness (coordinator/liveness.py; no reference
    # analogue — TonY's liveness was heartbeat-only).
    # A task's step counter stopped advancing past the progress deadline
    # while its heartbeats kept arriving: the user process is wedged.
    # Payload: steps, stalled_s, timeout_s; the subsequent TASK_FINISHED
    # carries the captured stack-dump excerpt.
    TASK_HUNG = "TASK_HUNG"
    # A task's step rate stayed below the configured fraction of its
    # gang's median for the sustained window. Payload: rate vs median.
    TASK_STRAGGLER = "TASK_STRAGGLER"
    # One-time warning: progress liveness is configured but this task
    # never reported a step counter — it degrades to heartbeat-only
    # liveness (never a false hang kill).
    TASK_PROGRESS_UNINSTRUMENTED = "TASK_PROGRESS_UNINSTRUMENTED"
    # Automatic failure diagnosis ran on a non-SUCCEEDED finish
    # (tony_tpu_torch/diagnosis/): payload carries the verdict category, the
    # blamed task, the rule that fired, and the incident.json path —
    # downstream tooling reads the verdict without re-running the engine.
    JOB_DIAGNOSED = "JOB_DIAGNOSED"
    # Elastic gang resize (coordinator/elastic.py): the gang's membership
    # changed WITHOUT restarting the job — host-loss absorption, an
    # explicit `tony-tpu resize`, or grow-back. Emitted with
    # phase="started" when the drain begins and phase="completed" when
    # the re-meshed gang's barrier reopens; payload carries the jobtype,
    # the bumped membership generation, the member indices, the from/to
    # sizes and the trigger reason. A deliberate resize on the timeline —
    # the diagnosis engine must not read its absorbed task exits as the
    # job's failure.
    GANG_RESIZED = "GANG_RESIZED"
    # Live job migration (coordinator/migrate.py): the WHOLE gang drained,
    # snapshotted, and relaunched on a different slice WITHOUT restarting
    # the job — spot-reclaim survival or fleet defragmentation. Emitted
    # with phase="started" when the drain begins and phase="completed"
    # when the barrier reopens on the destination; payload carries the
    # jobtype, mgen, members, source/target slice and the trigger reason.
    # The goodput ledger books the completed window as its own
    # "migration" phase (fleet/ledger.py), never as train.
    GANG_MIGRATED = "GANG_MIGRATED"
    # On-demand device profiling (tony-tpu profile <app>): a task's
    # capture reached a terminal state. Payload: task, request id, steps,
    # status ("captured" with the artifact dir, or "failed" with the
    # error — a failed capture never kills or stalls training).
    TASK_PROFILED = "TASK_PROFILED"
    # Fleet scheduler events (tony_tpu_torch/fleet/daemon.py — the multi-job
    # gang scheduler's own stream, written into the fleet dir, not a job
    # dir). A submission entered the queue; payload: job, tenant,
    # priority, hosts.
    FLEET_JOB_QUEUED = "FLEET_JOB_QUEUED"
    # A queued submission was granted capacity and spawned; payload:
    # job, hosts, placement, wait_s (queue wait — the p50/p99 source).
    FLEET_JOB_GRANTED = "FLEET_JOB_GRANTED"
    # A running job was shrunk via its coordinator's elastic resize to
    # reclaim hosts for a higher-priority submission (preempt-to-
    # reclaim: drain→remesh, no victim epoch burned, never a kill);
    # payload: job, from/to hosts, the demanding job.
    FLEET_JOB_PREEMPTED = "FLEET_JOB_PREEMPTED"
    # A grant was deferred because the tenant is at its host quota
    # (emitted once per queued→quota-denied transition, not per tick);
    # payload: job, tenant, used, quota.
    FLEET_QUOTA_DENIED = "FLEET_QUOTA_DENIED"
    # A queued job's not-placed reason TRANSITIONED (the scheduler
    # decision explainer, tony_tpu_torch/fleet/daemon.py): the policy engine
    # held the job this tick for a DIFFERENT reason than last tick —
    # quota / capacity / fragmentation / priority-held / preempt-wait.
    # Emitted per transition, never per tick (the per-tick stream is the
    # REC_FLEET_DECISION journal + the in-memory decision ring behind
    # `tony-tpu fleet explain`); payload: job, action, reason, blocking
    # (the job ids / tenants holding the capacity).
    FLEET_JOB_HELD = "FLEET_JOB_HELD"
    # A running fleet job was live-migrated between slices (spot-reclaim
    # survival or FRAGMENTATION repacking) via its coordinator's migrate
    # op — drain→move→reshard, no epoch burned, never a kill; payload:
    # job, source, target, reason.
    FLEET_JOB_MIGRATED = "FLEET_JOB_MIGRATED"
    # A fleet job reached a terminal state (finished/failed/cancelled);
    # payload: job, state, exit, app_id.
    FLEET_JOB_FINISHED = "FLEET_JOB_FINISHED"
    # Host health (tony_tpu_torch/fleet/health.py): the failure-attribution
    # ledger pushed a host over the quarantine threshold (or an operator
    # / preflight probe cordoned it) — the host leaves the placement
    # pool until probation clears it; payload: host, slice, state,
    # score, reason, manual.
    FLEET_HOST_QUARANTINED = "FLEET_HOST_QUARANTINED"
    # A cordoned host returned to the healthy pool — probation canary
    # ran clean, quarantine cooldown expired into a clean canary, or an
    # operator uncordoned it; payload: host, slice, state, reason.
    FLEET_HOST_RESTORED = "FLEET_HOST_RESTORED"
    # Correlated failure detection: >= blast-n hosts on one slice went
    # suspect inside the blast window, so the whole slice is treated as
    # sick — cordoned and queued for evacuation migration; payload:
    # slice, hosts.
    FLEET_SLICE_CORDONED = "FLEET_SLICE_CORDONED"
    # Alerting (tony_tpu_torch/alerts/): a rule completed its for-duration and
    # transitioned to FIRING — the breach is real, not a blip. Emitted
    # by the coordinator monitor tick (job-scope rules, into the job's
    # event stream) or the fleet daemon tick (fleet-scope rules, into
    # the fleet stream), AFTER the REC_ALERT/REC_FLEET_ALERT record is
    # journaled write-ahead; payload: rule, severity, value, labels,
    # summary, scope ("job"|"fleet"). An alert firing before a failure
    # becomes precedence-boosted diagnosis evidence.
    ALERT_FIRING = "ALERT_FIRING"
    # The firing (or pending) rule returned below threshold — one good
    # evaluation resolves; payload mirrors ALERT_FIRING. A SUCCEEDED
    # job's teardown force-resolves every open alert, so its journal
    # never ends with an alert firing (the alert-journal invariant).
    ALERT_RESOLVED = "ALERT_RESOLVED"


@dataclasses.dataclass
class Event:
    type: EventType
    payload: Dict[str, Any]
    timestamp_ms: int = 0

    def __post_init__(self) -> None:
        if not self.timestamp_ms:
            self.timestamp_ms = int(time.time() * 1000)

    def to_json(self) -> str:
        return json.dumps(
            {"type": self.type.value, "timestamp": self.timestamp_ms,
             "event": self.payload},
            sort_keys=True)

    @classmethod
    def from_json(cls, line: str) -> "Event":
        d = json.loads(line)
        return cls(EventType(d["type"]), d.get("event", {}), d.get("timestamp", 0))


class EventHandler:
    """Queue-backed async writer (reference EventHandler.java:98-113)."""

    def __init__(self, job_dir: str, in_progress_name: str,
                 on_emit: Optional[Any] = None):
        self._queue: "queue.Queue[Optional[Event]]" = queue.Queue()
        self._job_dir = job_dir
        self._path = os.path.join(job_dir, in_progress_name)
        self._thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()
        # Observability tap: called synchronously with each emitted event
        # (the coordinator counts event types into its metrics registry).
        self._on_emit = on_emit
        os.makedirs(job_dir, exist_ok=True)

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._drain, name="tony-event-writer", daemon=True)
        self._thread.start()

    def emit(self, event: Event) -> None:
        if self._on_emit is not None:
            try:
                self._on_emit(event)
            except Exception:  # noqa: BLE001 — the tap must never block history
                pass
        self._queue.put(event)

    def _drain(self) -> None:
        from tony_tpu_torch.utils.durable import fsync_file

        with open(self._path, "a", encoding="utf-8") as f:
            dirty = False
            while True:
                try:
                    ev = self._queue.get(timeout=0.2)
                except queue.Empty:
                    if self._stopped.is_set():
                        break
                    if dirty:
                        # Durability on the idle edge, not per event: a
                        # coordinator crash then loses at most the burst
                        # in flight, and readers tolerate a torn tail
                        # (read_events) — same contract as the journal.
                        fsync_file(f)
                        dirty = False
                    continue
                if ev is None:
                    break
                if not isinstance(ev, Event):
                    # Flush barrier (a threading.Event — possibly the
                    # sanitizer's wrapper, so match "not an event
                    # record" rather than the concrete class):
                    # everything queued before it is now written; push
                    # it to disk and wake the waiter.
                    fsync_file(f)
                    dirty = False
                    ev.set()
                    continue
                f.write(ev.to_json() + "\n")
                dirty = True
            fsync_file(f)

    def flush(self, timeout: float = 5.0) -> bool:
        """Block until every event emitted so far is written AND synced
        to the in-progress file (FIFO queue ⇒ a barrier marker behind
        them proves it). The diagnosis collector reads that file from
        disk mid-teardown, so the stream must be materialized first."""
        if self._thread is None or not self._thread.is_alive():
            return False
        done = threading.Event()
        self._queue.put(done)  # type: ignore[arg-type]
        return done.wait(timeout)

    def stop(self, final_name: str) -> str:
        """Flush remaining events and rename in-progress → final
        (reference EventHandler.java:126-135). The rename is made durable
        (dir fsync) — a finalized-then-vanished history file would read
        as a still-running job forever."""
        from tony_tpu_torch.utils.durable import durable_replace

        self._stopped.set()
        self._queue.put(None)
        if self._thread:
            self._thread.join(timeout=10)
        final_path = os.path.join(self._job_dir, final_name)
        if os.path.exists(self._path):
            durable_replace(self._path, final_path)
        return final_path


def read_events(path: str) -> List[Event]:
    """Decode an event file back into Events (reference
    ``ParserUtils.parseEvents`` :258-287).

    Torn-tail tolerant: a coordinator crash can leave a partially
    written final line (the window between write and fsync). Decoding
    stops at the first bad line with a warning — the portal and CLI must
    render the crashed job's history, not traceback over it."""
    import logging

    out: List[Event] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(Event.from_json(line))
            except (ValueError, KeyError):
                logging.getLogger(__name__).warning(
                    "torn/undecodable event record in %s after %d good "
                    "ones — returning the prefix", path, len(out))
                break
    return out
