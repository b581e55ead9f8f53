"""Progress-based liveness: hang detection and straggler policing.

The heartbeat monitor (coordinator.py ``_check_heartbeats``) proves the
*executor* is alive — nothing more. A user process wedged in a deadlocked
collective, a stuck data loader, or a NaN spin keeps heartbeating through
its executor forever while the whole gang stalls (in-graph gang execution
means one hung replica stalls every replica — TF-Replicator, PAPERS.md).
The progress signal already exists: the user process's telemetry reporter
publishes ``steps_completed`` (tony_tpu_torch/telemetry.py) and the executor
piggybacks it on every heartbeat as a progress beacon. This module is the
coordinator-side consumer: per-task progress state plus two policies on
top of it.

**Hang detection** (``tony.task.progress-timeout-s``, 0 = off): a task is
armed the first time a beacon carries a step counter; from then on, a
task whose counter stops advancing for longer than the deadline is
declared HUNG. The verdict is staged — declare (TASK_HUNG event + a
dump directive rides the next heartbeat response so the executor signals
the user process group and its pre-registered ``faulthandler`` handler
dumps all-thread stacks into the task log), a dump grace, then the kill
(TERM→grace→KILL, INFRA_TRANSIENT through the ordinary retry-epoch
machinery). Warmup-aware by construction: an UNARMED task (still
compiling, restoring, or simply not instrumented) is never subject to
the deadline — uninstrumented tasks degrade to heartbeat-only liveness
with a one-time warning event after ``tony.task.progress-warmup-s``,
never a false kill.

**Straggler policing** (``tony.task.straggler-fraction``): per-task step
rates over a sliding window, compared against the gang (jobtype) median.
A task sustained below ``fraction × median`` for
``tony.task.straggler-window-s`` emits TASK_STRAGGLER with its rate vs.
the median; with ``tony.task.straggler-restart`` (off by default) it is
proactively killed into an INFRA_TRANSIENT retry. A 1-task gang can
never straggle (its own rate IS the median).

Recovery integration: the coordinator journals step counters (throttled
— see ``PROGRESS_JOURNAL_MIN_INTERVAL_S``) and a ``--recover`` replay
seeds ``track(steps_hint=...)``, which re-arms the task with a FRESH
deadline — the outage must not expire deadlines the moment the
coordinator comes back, but a hang that spans the crash is still caught
one full timeout later.
"""

from __future__ import annotations

import collections
import dataclasses
import statistics
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple

from tony_tpu_torch.conf import keys as K

#: Floor between two journalled progress records for one task: the journal
#: is fsync'd and control-plane-rate; step counters must not turn it into
#: a per-step hot path.
PROGRESS_JOURNAL_MIN_INTERVAL_S = 10.0

#: poll() action kinds, in the order a task moves through them.
WARN_UNINSTRUMENTED = "uninstrumented"
HUNG = "hung"
HANG_KILL = "hang_kill"
STRAGGLER = "straggler"
STRAGGLER_KILL = "straggler_kill"


@dataclasses.dataclass
class _TaskProgress:
    job_name: str
    tracked_at: float
    steps: float = -1.0
    last_advance: float = 0.0
    armed: bool = False               # a beacon carried a step counter
    warned: bool = False              # uninstrumented warning emitted
    hung_at: float = 0.0              # 0 = not currently declared hung
    dump_pending: bool = False        # directive queued for the heartbeat
    dump_sent: bool = False
    killed: bool = False              # kill action already handed out
    samples: Deque[Tuple[float, float]] = dataclasses.field(
        default_factory=collections.deque)
    below_since: float = 0.0          # straggler condition start, 0 = above
    straggler_flagged: bool = False   # event emitted for this episode


@dataclasses.dataclass
class Action:
    """One policy verdict for the coordinator's monitor loop to act on."""

    kind: str
    task_id: str
    info: Dict[str, object]


class ProgressTracker:
    """Per-task progress state machine; thread-safe (beacons arrive on RPC
    handler threads, policy runs on the coordinator monitor loop)."""

    def __init__(self, conf, now_fn: Callable[[], float] = time.monotonic):
        self._now = now_fn
        self.timeout_s = float(conf.get_int(K.TASK_PROGRESS_TIMEOUT_S, 0))
        self.warmup_s = float(conf.get_int(K.TASK_PROGRESS_WARMUP_S, 300))
        self.dump_grace_s = float(conf.get_int(K.TASK_HANG_DUMP_GRACE_S, 5))
        self.straggler_fraction = float(
            conf.get(K.TASK_STRAGGLER_FRACTION, 0.0) or 0.0)
        self.straggler_window_s = float(
            conf.get_int(K.TASK_STRAGGLER_WINDOW_S, 60))
        self.straggler_restart = conf.get_bool(K.TASK_STRAGGLER_RESTART)
        self._tasks: Dict[str, _TaskProgress] = {}
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        """Any progress policy configured at all? (When False the tracker
        still records beacons for the status surfaces, but never warns,
        declares, or kills.)"""
        return bool(self.timeout_s or self.straggler_fraction)

    # -- bookkeeping ------------------------------------------------------
    def track(self, task_id: str, job_name: str,
              steps_hint: Optional[float] = None) -> None:
        """Start (or restart) tracking a task — called at registration and
        at post-recovery re-registration. ``steps_hint`` is the journal-
        replayed counter: the task comes back ARMED but with a fresh
        deadline, so a coordinator outage never expires a deadline on
        re-adoption — while a hang that began before the crash still
        trips one full timeout later."""
        now = self._now()
        with self._lock:
            tp = _TaskProgress(job_name=job_name, tracked_at=now)
            if steps_hint is not None and steps_hint >= 0:
                tp.armed = True
                tp.steps = float(steps_hint)
                tp.last_advance = now
            self._tasks[task_id] = tp

    def forget(self, task_id: str) -> None:
        """Task reached a terminal state: drop it from every policy (a
        finished fast task must not drag the gang median around)."""
        with self._lock:
            self._tasks.pop(task_id, None)

    def reset(self) -> None:
        """New retry epoch: all progress state belongs to the old gang."""
        with self._lock:
            self._tasks.clear()

    # -- beacon intake ----------------------------------------------------
    def observe(self, task_id: str,
                progress: Optional[dict]) -> bool:
        """Fold one heartbeat's progress beacon in. Returns True iff the
        step counter ADVANCED (the journal-throttle signal). ``progress``
        is ``{"steps": float, "age_s": float}`` or None from tasks with no
        instrumentation (those stay unarmed: heartbeat-only liveness)."""
        now = self._now()
        with self._lock:
            tp = self._tasks.get(task_id)
            if tp is None or tp.killed:
                return False
            if not isinstance(progress, dict) or "steps" not in progress:
                return False
            try:
                steps = float(progress["steps"])
                age_s = max(0.0, float(progress.get("age_s", 0.0) or 0.0))
            except (TypeError, ValueError):
                return False
            advanced = False
            if not tp.armed:
                # First sighting arms the deadline NOW — compile/restore
                # time before this point was never on the clock.
                tp.armed = True
                tp.steps = steps
                tp.last_advance = now
                advanced = True
            elif steps != tp.steps:
                # Any change counts as an advance ('!=' not '>': a retry
                # or executor restart resets the counter downward and that
                # is a live, progressing task). The executor's own stall
                # age backdates the advance to when IT saw the counter
                # move — clock-skew-free, it is a duration — but never
                # earlier than what we already knew (a recovery grace must
                # not be erased by a huge reported age).
                if steps < tp.steps:
                    # Counter reset (user process restarted inside the
                    # task, epoch-stale metrics file overwritten): the
                    # old samples would give the rate window a negative
                    # slope — clamped to 0, a guaranteed false straggler.
                    # Start the window over.
                    tp.samples.clear()
                    tp.below_since = 0.0
                tp.steps = steps
                tp.last_advance = max(tp.last_advance, now - age_s)
                advanced = True
                if tp.hung_at and not tp.killed:
                    # Progress resumed inside the dump grace: cancel the
                    # verdict (the dump, if delivered, is free forensics).
                    tp.hung_at = 0.0
                    tp.dump_pending = False
                    tp.dump_sent = False
            tp.samples.append((now, steps))
            cutoff = now - max(2.0 * self.straggler_window_s, 10.0)
            while tp.samples and tp.samples[0][0] < cutoff:
                tp.samples.popleft()
            return advanced

    def should_dump(self, task_id: str) -> bool:
        """One-shot dump directive for the heartbeat response: True exactly
        once per hang episode, on the first heartbeat after declaration."""
        with self._lock:
            tp = self._tasks.get(task_id)
            if tp is None or not tp.dump_pending or tp.dump_sent:
                return False
            tp.dump_sent = True
            return True

    # -- policy -----------------------------------------------------------
    def poll(self) -> List[Action]:
        """Run both policies; called from the coordinator monitor loop.
        Each returned Action is emitted at most once per episode (hang
        kills and straggler kills exactly once per task life)."""
        now = self._now()
        out: List[Action] = []
        with self._lock:
            if not self.enabled:
                return out
            rates = self._rates_locked(now)
            medians = self._gang_medians_locked(rates)
            for task_id, tp in self._tasks.items():
                if tp.killed:
                    continue
                if not tp.armed:
                    if not tp.warned and \
                            now - tp.tracked_at > self.warmup_s:
                        tp.warned = True
                        out.append(Action(WARN_UNINSTRUMENTED, task_id, {
                            "warmup_s": self.warmup_s}))
                    continue
                stalled_s = now - tp.last_advance
                if self.timeout_s and not tp.hung_at \
                        and stalled_s > self.timeout_s:
                    tp.hung_at = now
                    tp.dump_pending = True
                    out.append(Action(HUNG, task_id, {
                        "steps": tp.steps, "stalled_s": stalled_s,
                        "timeout_s": self.timeout_s}))
                if tp.hung_at:
                    if now - tp.hung_at >= self.dump_grace_s:
                        tp.killed = True
                        out.append(Action(HANG_KILL, task_id, {
                            "steps": tp.steps,
                            "stalled_s": now - tp.last_advance,
                            "timeout_s": self.timeout_s,
                            "dump_delivered": tp.dump_sent}))
                    continue      # a hung task is past straggler policing
                self._police_straggler_locked(
                    out, task_id, tp, now, rates, medians)
        return out

    def _police_straggler_locked(self, out: List[Action], task_id: str,
                                 tp: _TaskProgress, now: float,
                                 rates: Dict[str, float],
                                 medians: Dict[str, float]) -> None:
        if not self.straggler_fraction:
            return
        rate = rates.get(task_id)
        median = medians.get(tp.job_name)
        # A 1-task gang's median IS its own rate — never below a
        # fraction < 1 of itself; with both at 0 the strict '<' holds
        # the line (0 < 0 is False). Median needs at least the task's
        # own rate to exist.
        if rate is None or median is None or \
                rate >= self.straggler_fraction * median:
            tp.below_since = 0.0
            tp.straggler_flagged = False
            return
        if not tp.below_since:
            tp.below_since = now
        if now - tp.below_since < self.straggler_window_s:
            return
        info = {"rate_steps_per_s": rate, "median_steps_per_s": median,
                "fraction": self.straggler_fraction,
                "window_s": self.straggler_window_s, "steps": tp.steps}
        if not tp.straggler_flagged:
            tp.straggler_flagged = True
            out.append(Action(STRAGGLER, task_id, dict(info)))
        if self.straggler_restart:
            tp.killed = True
            out.append(Action(STRAGGLER_KILL, task_id, dict(info)))

    def _rates_locked(self, now: float) -> Dict[str, float]:
        """Step rate per armed task over the sliding window; absent when
        the sample span is too short to mean anything yet."""
        rates: Dict[str, float] = {}
        for task_id, tp in self._tasks.items():
            if not tp.armed or tp.killed or len(tp.samples) < 2:
                continue
            t0, s0 = tp.samples[0]
            t1, s1 = tp.samples[-1]
            if t1 - t0 < self.straggler_window_s / 2.0:
                continue
            rates[task_id] = max(0.0, (s1 - s0) / (t1 - t0))
        return rates

    def _gang_medians_locked(
            self, rates: Dict[str, float]) -> Dict[str, float]:
        by_job: Dict[str, List[float]] = {}
        for task_id, rate in rates.items():
            tp = self._tasks.get(task_id)
            if tp is not None and not tp.hung_at:
                by_job.setdefault(tp.job_name, []).append(rate)
        return {job: statistics.median(rs) for job, rs in by_job.items()
                if rs}

    # -- status surfaces --------------------------------------------------
    def snapshot(self, task_id: str) -> Optional[Dict[str, object]]:
        """Progress state for the application report / CLI / portal; None
        for untracked tasks."""
        now = self._now()
        with self._lock:
            tp = self._tasks.get(task_id)
            if tp is None:
                return None
            if not tp.armed:
                if not self.enabled:
                    # No policy configured: an unarmed task has nothing
                    # worth a status column ("warmup" would imply a
                    # deadline that does not exist).
                    return None
                state = "heartbeat-only" if tp.warned else "warmup"
                return {"state": state}
            out: Dict[str, object] = {
                "state": "hung" if tp.hung_at else (
                    "straggler" if tp.straggler_flagged else "ok"),
                "steps": tp.steps,
                "stalled_s": round(now - tp.last_advance, 3),
            }
            rate = self._rates_locked(now).get(task_id)
            if rate is not None:
                out["rate_steps_per_s"] = round(rate, 4)
            return out
