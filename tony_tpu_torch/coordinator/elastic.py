"""Elastic gang membership: shrink-and-continue on host loss, grow back live.

Every failure mode PRs 1–5 hardened still ended the same way: tear the
gang down and replay the epoch from a checkpoint. This module makes
worker-set membership ELASTIC instead (the design axis TF-Replicator and
Podracer treat as first-class — PAPERS.md): a preempted or dead host
costs a re-mesh, not an epoch.

The machinery composes the primitives earlier PRs built:

- **Drain directive** rides the heartbeat response exactly like PR 3's
  dump directive: survivors get ``{"resize": {mgen, action, members}}``,
  TERM their user process (whose save-on-SIGTERM handler —
  ``checkpoint/manager.install_preemption_handler`` — makes one final
  durable save: the "checkpoint at a step barrier"), and PARK: instead
  of reporting an exit, the executor re-registers its existing identity
  under the new membership generation and waits at the gang barrier.
- **Membership generation** (``mgen``) extends PR 2's coordinator
  generation fencing to topology: bumped on every resize, journaled,
  carried on register/heartbeat frames. A frame from a pre-resize
  topology with no resize in flight is fenced (the executor tears its
  task down) — a zombie member cannot corrupt the re-meshed gang.
- **Write-ahead journal** (PR 2): ``resize start`` lands before any
  directive, ``resize applied`` before any relaunch — a coordinator
  SIGKILLed mid-resize and restarted with ``--recover`` RE-ENTERS the
  drain and completes the resize instead of restarting the job.

State machine (one op at a time, held here; the coordinator drives it
from its monitor loop and owns every side effect — launches, kills,
journal, events):

    IDLE --begin()--> DRAIN --(all survivors parked/gone)--> [remesh]
         --mark_remeshed()--> BARRIER --(all registered)--> finish() --> IDLE

A member lost DURING the drain folds into the same op: membership drops
the index, ``mgen`` bumps again, and the already-parked survivors adopt
the newer generation through the directive channel (their stale-mgen
barrier polls return "keep polling", never a fence, while the op runs).

Thread-safety: directives and acks arrive on RPC handler threads, the
state machine advances on the coordinator monitor loop — everything
behind one lock, nothing blocking inside it (tonylint lock-blocking).
"""

from __future__ import annotations

import threading
import time
from typing import (TYPE_CHECKING, Any, Callable, Dict, Iterable, List,
                    Optional, Set)

if TYPE_CHECKING:
    from tony_tpu_torch.conf.config import TonyTpuConfig
    from tony_tpu_torch.coordinator.session import Session, Task

from tony_tpu_torch.conf import keys as K
from tony_tpu_torch.devtools.race import guarded

#: op phases
DRAIN = "drain"        # directives out; waiting for survivors to park
BARRIER = "barrier"    # topology applied; waiting for re-registration


class ResizeRefused(ValueError):
    """An explicit resize request the policy rejects (below min-tasks,
    elasticity disabled, gang not established...) — reported to the
    caller, never a job failure."""


class _Op:
    def __init__(self, mgen: int, job: str, members: List[int],
                 reason: str, started: float, target: str = "",
                 migrate: bool = False) -> None:
        self.mgen = mgen
        self.job = job
        self.members = sorted(members)
        self.reason = reason
        self.started = started
        self.phase = DRAIN
        # Live member tasks that must park (re-register under this mgen)
        # before the re-mesh may apply; release = live non-members told
        # to exit.
        self.awaiting: Set[str] = set()
        self.parked: Set[str] = set()
        self.release: Set[str] = set()
        self.size_before = 0
        # Live migration (coordinator/migrate.py): same drain/barrier
        # machinery, but at remesh the WHOLE parked gang is relaunched on
        # ``target`` (a node-pool/slice name) instead of in place.
        self.target = target
        self.migrate = migrate


@guarded
class ElasticManager:
    """Membership policy + resize-op state for ONE elastic jobtype."""

    #: tonyrace registry (devtools/race.py): the op advances on the
    #: monitor loop while directives/acks arrive on RPC threads — every
    #: ``_op`` touch holds the lock. ``mgen``/``established`` are atomic
    #: scalar rebinds (written under the lock, readable without).
    GUARDED_BY = {
        "_op": "_lock",
        "mgen": None,
        "established": None,
    }

    def __init__(self, conf: "TonyTpuConfig",
                 now_fn: Callable[[], float] = time.monotonic) -> None:
        self._now = now_fn
        self.enabled = conf.get_bool(K.ELASTIC_ENABLED)
        self.job = str(conf.get(K.ELASTIC_JOBTYPE, "worker") or "worker")
        self.min_tasks = max(1, conf.get_int(K.ELASTIC_MIN_TASKS, 1))
        self.drain_grace_s = conf.get_int(K.ELASTIC_DRAIN_GRACE_S, 15)
        self.barrier_timeout_s = conf.get_int(
            K.ELASTIC_BARRIER_TIMEOUT_S, 120)
        #: membership generation — monotonic for the job's whole life,
        #: 1 for the launch topology (journal-restored on --recover).
        self.mgen = 1
        #: the initial rendezvous completed at least once: resizes only
        #: make sense against an established gang (a loss before the
        #: first barrier opens is an ordinary rendezvous failure).
        self.established = False
        self._op: Optional[_Op] = None
        self._lock = threading.Lock()

    # -- queries ----------------------------------------------------------
    @property
    def resizing(self) -> bool:
        with self._lock:
            return self._op is not None

    @property
    def op(self) -> Optional[_Op]:
        with self._lock:
            return self._op

    def snapshot(self) -> Dict[str, object]:
        """Status-surface view (application report / metrics.live)."""
        with self._lock:
            out: Dict[str, object] = {"mgen": self.mgen,
                                      "job": self.job,
                                      "resizing": self._op is not None}
            if self._op is not None:
                out["target_size"] = len(self._op.members)
                out["phase"] = self._op.phase
                if self._op.migrate:
                    out["migrating_to"] = self._op.target
            return out

    # -- policy -----------------------------------------------------------
    def may_absorb(self, task: "Task", domain_value: str,
                   session: "Session") -> bool:
        """Would losing this task be absorbed as a shrink (or folded into
        the in-flight resize) instead of failing the epoch? Pure read —
        the coordinator acts via begin()/note_task_gone().

        Absorbable: elasticity on, gang established, the task belongs to
        the elastic jobtype, it is NOT the chief (the chief owns the
        checkpoint cadence and index 0 anchors dense rank 0 — its loss
        keeps the fail-the-epoch policy), the failure is infra-shaped
        (INFRA_TRANSIENT / PREEMPTION — a deterministic USER_ERROR crash
        must not silently shrink the gang), and the survivors stay at or
        above ``tony.elastic.min-tasks``.
        """
        if not self.enabled or not self.established:
            return False
        if task.job_name != self.job:
            return False
        if session.is_chief(task.job_name, task.index):
            return False
        if domain_value not in ("INFRA_TRANSIENT", "PREEMPTION"):
            return False
        with self._lock:
            if self._op is not None:
                # Mid-resize: a released task's exit is expected, and a
                # dying MEMBER folds into the op as a further shrink —
                # as long as the floor still holds.
                if task.task_id in self._op.release:
                    return True
                if task.index in self._op.members:
                    return len(self._op.members) - 1 >= self.min_tasks
                return False
        survivors = [t for t in session.all_tasks()
                     if t.job_name == self.job
                     and not t.status.terminal
                     and t.task_id != task.task_id]
        return len(survivors) >= self.min_tasks

    def at_size(self, size: int, session: "Session") -> bool:
        """Is the established gang ALREADY at ``size`` with no resize in
        flight? The idempotent-resize probe: a caller retrying a resize
        whose first RESPONSE was lost (asymmetric partition, daemon
        crash between the RPC and its journal record) must read
        already-there as success, not as a refusal to retry forever."""
        if not self.enabled or not self.established:
            return False
        with self._lock:
            if self._op is not None:
                return False
        live = [t.index for t in session.all_tasks()
                if t.job_name == self.job and not t.status.terminal]
        return len(live) == int(size)

    def plan_explicit(self, size: int, session: "Session") -> List[int]:
        """Member list for an operator resize to ``size`` — shrink drops
        the HIGHEST indices (never the chief at index 0), grow re-adds
        the smallest free indices. Raises ResizeRefused with the reason
        when policy says no."""
        if not self.enabled:
            raise ResizeRefused(
                "elasticity is disabled (set tony.elastic.enabled)")
        if not self.established:
            raise ResizeRefused("the gang has not completed its initial "
                                "rendezvous yet")
        if self.resizing:
            raise ResizeRefused("a resize is already in progress")
        if size < self.min_tasks:
            raise ResizeRefused(
                f"resize to {size} refused: below tony.elastic.min-tasks "
                f"({self.min_tasks})")
        live = sorted(t.index for t in session.all_tasks()
                      if t.job_name == self.job and not t.status.terminal)
        if not live:
            raise ResizeRefused(f"no live {self.job} tasks to resize")
        if size == len(live):
            raise ResizeRefused(f"gang already has {size} member(s)")
        if size < len(live):
            return live[:size]
        members = set(live)
        i = 0
        while len(members) < size:
            if i not in members:
                members.add(i)
            i += 1
        return sorted(members)

    # -- op lifecycle (driven by the coordinator) -------------------------
    def begin(self, members: List[int], live_tasks: "Iterable[Task]",
              reason: str, mgen: Optional[int] = None, target: str = "",
              migrate: bool = False) -> _Op:
        """Start a resize (or supersede the in-flight one with a smaller
        membership — the second host dying during a drain). Bumps the
        membership generation unless ``mgen`` pins it (recovery re-entry
        of a journaled in-flight resize). ``live_tasks`` are the elastic
        jobtype's current non-terminal tasks; members of the new set must
        park, the rest are released. ``migrate``/``target`` turn the op
        into a live migration: every member drains and the remesh
        relaunches the gang on the target slice (a plain ``begin`` that
        supersedes a migrate op folds the move into an ordinary shrink —
        a failed migration is never worse than a host loss)."""
        with self._lock:
            new_mgen = int(mgen) if mgen is not None else self.mgen + 1
            self.mgen = max(self.mgen, new_mgen)
            op = _Op(new_mgen, self.job, members, reason, self._now(),
                     target=target, migrate=migrate)
            prev = self._op
            if prev is not None:
                # Supersede: keep the ORIGINAL start time so the barrier
                # timeout bounds the whole disturbance, not each bump.
                op.started = prev.started
                op.size_before = prev.size_before
            member_set = set(op.members)
            for t in live_tasks:
                if t.index in member_set:
                    op.awaiting.add(t.task_id)
                else:
                    op.release.add(t.task_id)
            if prev is None:
                op.size_before = len(op.awaiting) + len(op.release)
            self._op = op
            return op

    def directive_for(self, task_id: str) -> Optional[dict]:
        """The resize directive to ride this task's next heartbeat
        response — re-sent every beat while the drain runs (idempotent:
        the executor dedups on mgen), so a lost response costs one
        heartbeat interval, not the resize."""
        with self._lock:
            op = self._op
            if op is None or op.phase != DRAIN:
                return None
            base = {"mgen": op.mgen, "size": len(op.members),
                    "members": list(op.members),
                    "grace_s": self.drain_grace_s}
            if task_id in op.release:
                return {**base, "action": "release"}
            if task_id in op.awaiting or task_id in op.parked:
                if op.migrate:
                    # A migrating executor must NOT wait at the barrier:
                    # the spec it would receive belongs to its fresh
                    # replacement on the destination slice (same task_id,
                    # same mgen), and relaunching here would put two
                    # incarnations of the gang in training at once. The
                    # marker tells it to ack the park and exit instead.
                    return {**base, "action": "drain", "migrate": True,
                            "target": op.target}
                return {**base, "action": "drain"}
            return None

    def ack_registration(self, task_id: str, mgen: int) -> bool:
        """A register frame arrived during the op: a survivor carrying
        the op's mgen counts as PARKED (its user process is down and it
        is waiting at the barrier). Returns True iff this ack newly
        parked a survivor."""
        with self._lock:
            op = self._op
            if op is None or int(mgen) != op.mgen:
                return False
            if task_id in op.awaiting:
                op.awaiting.discard(task_id)
                op.parked.add(task_id)
                return True
            return False

    def note_task_gone(self, task_id: str) -> None:
        """A task died or was reaped mid-op: stop waiting on it (its
        index, if still a member, gets a fresh launch at remesh)."""
        with self._lock:
            op = self._op
            if op is None:
                return
            op.awaiting.discard(task_id)
            op.parked.discard(task_id)
            op.release.discard(task_id)

    def is_released(self, task_id: str) -> bool:
        with self._lock:
            return self._op is not None and task_id in self._op.release

    def is_parked_for_migration(self, task_id: str) -> bool:
        """Did this task park under an in-flight migration's DRAIN? A
        migrating executor acks the park and then self-exits (its
        incarnation cannot follow the gang to the destination slice), so
        its backend completion is EXPECTED — absorbed like a released
        task's, never folded into a shrink that would abandon the move."""
        with self._lock:
            op = self._op
            return op is not None and op.migrate and op.phase == DRAIN \
                and task_id in op.parked

    @property
    def drain_complete(self) -> bool:
        with self._lock:
            op = self._op
            return op is not None and op.phase == DRAIN \
                and not op.awaiting

    def mark_remeshed(self) -> None:
        with self._lock:
            if self._op is not None:
                self._op.phase = BARRIER

    def timed_out(self) -> bool:
        with self._lock:
            op = self._op
            return op is not None and \
                self._now() - op.started > self.barrier_timeout_s

    def finish(self) -> Optional[_Op]:
        with self._lock:
            op, self._op = self._op, None
            return op

    abandon = finish

    def reset_for_epoch(self) -> None:
        """Retry epoch: the new gang relaunches at the configured size;
        membership state dies with the old gang. The generation itself
        stays monotonic so pre-reset zombies remain fenced."""
        with self._lock:
            self._op = None
            self.established = False

    # -- fencing ----------------------------------------------------------
    def fences_frame(self, task_known: bool,
                     mgen: Any) -> Optional[str]:
        """Should a register/heartbeat frame be rejected as stale
        topology? Returns the fence reason, or None to accept.

        - A frame for a task that is NOT in the current matrix (removed
          by a shrink) is always fenced: that executor belongs to a
          topology that no longer exists.
        - A known task's frame with a stale membership generation is
          fenced only when NO resize is in flight — during a resize the
          old generation is expected (the directive that teaches the new
          one may still be in flight).
        """
        if not self.enabled:
            return None
        if not task_known:
            return (f"not a member of membership generation {self.mgen} "
                    f"(removed by an elastic resize)")
        mg = int(mgen if mgen is not None else -1)
        if mg < 0:
            return None          # pre-elastic caller: compat-accepted
        with self._lock:
            if self._op is not None:
                return None
            if mg != self.mgen:
                return (f"stale membership generation {mg} "
                        f"(current {self.mgen})")
        return None
