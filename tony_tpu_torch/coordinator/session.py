"""In-coordinator job state: the task matrix, cluster spec and failure policy.

Reference model: ``tensorflow/TonySession.java`` (561 LoC) —
- jobName → TonyTask[] matrix (:54) with a per-task state machine (:410-551);
- cluster spec {job: [host:port, ...]} built from registered workers
  (``getClusterSpec`` :226-246);
- chief semantics: the ``chief`` jobtype, else worker:0 (``isChief`` :364);
- failure policy on task completion (:251-271): chief failure fails the job;
  ``stop-on-failure-jobtypes`` short-circuit; optional fail-on-any-worker;
- final-status reduction over tracked tasks (``updateSessionStatus`` :276-330);
- ``sessionId`` retry epoch incremented on whole-job retry (:51).
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from typing import Dict, List, Optional

from tony_tpu_torch import constants
from tony_tpu_torch.conf.config import JobType, TonyTpuConfig
from tony_tpu_torch.conf import keys as K
from tony_tpu_torch.devtools.race import guarded


class TaskStatus(str, enum.Enum):
    NEW = "NEW"                # defined, not yet handed to the backend
    SCHEDULED = "SCHEDULED"    # launch requested from the backend
    RUNNING = "RUNNING"        # process up (registered or heartbeating)
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    KILLED = "KILLED"

    @property
    def terminal(self) -> bool:
        return self in (TaskStatus.SUCCEEDED, TaskStatus.FAILED,
                        TaskStatus.KILLED)


class SessionStatus(str, enum.Enum):
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    KILLED = "KILLED"


class FailureDomain(str, enum.Enum):
    """Which kind of thing broke — the axis the retry policy pivots on.

    The reference burned one undiscriminating retry budget on everything
    (``ApplicationMaster.java:356-371``); at TPU scale the three causes
    have opposite economics: a user bug reproduces deterministically (any
    retry is wasted epochs), transient infra deserves the bounded budget,
    and preemption is EXPECTED churn on spot/reclaimable capacity — it
    must not be able to exhaust the budget kept for real failures.
    """

    USER_ERROR = "USER_ERROR"            # non-retryable by default
    INFRA_TRANSIENT = "INFRA_TRANSIENT"  # retryable, consumes retry-count
    PREEMPTION = "PREEMPTION"            # retryable on its own free budget


#: reduction precedence when one epoch has multiple failed tasks: the
#: least-retryable domain decides the epoch's fate.
_DOMAIN_SEVERITY = {FailureDomain.PREEMPTION: 0,
                    FailureDomain.INFRA_TRANSIENT: 1,
                    FailureDomain.USER_ERROR: 2}


def worst_domain(a: Optional[FailureDomain],
                 b: Optional[FailureDomain]) -> Optional[FailureDomain]:
    if a is None:
        return b
    if b is None:
        return a
    return a if _DOMAIN_SEVERITY[a] >= _DOMAIN_SEVERITY[b] else b


def classify_exit(exit_code: int,
                  hint: Optional[str] = None) -> Optional[FailureDomain]:
    """Map a task completion to its failure domain.

    ``hint`` is the backend's attribution when it knows the MACHINE died
    (``Backend.completion_domain``) — exit codes alone cannot tell a lost
    host (137) from an OOM kill (137). Without a hint:
    exit 0 → None (no failure); 143 (128+SIGTERM) → PREEMPTION (the
    advance-notice save path); 137 (SIGKILL) → INFRA_TRANSIENT (liveness
    kill / OOM / sudden death — retryable, on the accounted budget);
    anything else → USER_ERROR (the user process chose that exit).
    """
    if hint:
        return FailureDomain(hint)
    if exit_code == 0:
        return None
    if exit_code == constants.EXIT_PREEMPTED:
        return FailureDomain.PREEMPTION
    if exit_code == constants.EXIT_KILLED:
        return FailureDomain.INFRA_TRANSIENT
    return FailureDomain.USER_ERROR


@dataclasses.dataclass
class Task:
    """One gang member (reference ``TonySession.TonyTask`` :410-551)."""

    job_name: str
    index: int
    session_id: int = 0
    status: TaskStatus = TaskStatus.NEW
    host: str = ""
    port: int = 0
    exit_code: Optional[int] = None
    tracked: bool = True
    registered: bool = False
    tb_url: str = ""
    handle: object = None  # backend-specific process/lease handle
    failure_domain: Optional[FailureDomain] = None

    @property
    def task_id(self) -> str:
        return f"{self.job_name}:{self.index}"

    @property
    def spec(self) -> str:
        return f"{self.host}:{self.port}"

    def to_info(self) -> Dict[str, object]:
        """Wire form of TaskInfo (reference ``rpc/TaskInfo.java``)."""
        return {
            "name": self.job_name, "index": self.index,
            "status": self.status.value, "url": self.tb_url,
            "host": self.host, "port": self.port,
            "exit_code": self.exit_code, "session_id": self.session_id,
            "failure_domain": (self.failure_domain.value
                               if self.failure_domain else ""),
        }


@guarded
class Session:
    """Task matrix + rendezvous barrier + failure policy.

    Thread-safety: RPC handler threads mutate the matrix (register,
    completion, resize) while the monitor tick reads/reduces it — every
    touch of the ``GUARDED_BY`` fields holds ``_lock`` (an RLock, so
    locked methods compose). The scalar fields are atomic rebinds whose
    writes all happen under the same lock; they are audited in the
    registry but not lock-enforced on read (a reader sees the old or the
    new value, both valid snapshots).
    """

    #: tonyrace registry (devtools/race.py + the guarded-by lint rules)
    GUARDED_BY = {
        "tasks": "_lock",
        "scheduled_jobs": "_lock",
        "status": None,
        "failure_reason": None,
        "failure_domain": None,
        "_scheduling_narrowed": None,
    }

    def __init__(self, conf: TonyTpuConfig, session_id: int = 0):
        self.conf = conf
        self.session_id = session_id
        self.jobs: Dict[str, JobType] = conf.job_types()
        untracked = set(conf.untracked_jobtypes())
        self.stop_on_failure = set(
            conf.get_list(K.APPLICATION_STOP_ON_FAILURE_JOBTYPES))
        self.fail_on_worker_failure = conf.get_bool(
            K.APPLICATION_FAIL_ON_WORKER_FAILURE)
        self._lock = threading.RLock()
        self._untracked = untracked
        self.tasks: Dict[str, Task] = {}
        for job in self.jobs.values():
            for i in range(job.instances):
                t = Task(job.name, i, session_id=session_id,
                         tracked=job.name not in untracked)
                self.tasks[t.task_id] = t
        self.status = SessionStatus.RUNNING
        self.failure_reason: Optional[str] = None
        self.failure_domain: Optional[FailureDomain] = None
        # Jobtypes whose gang has been handed to the backend. The rendezvous
        # barrier and cluster spec cover exactly these (reference
        # ``TonySession.getNumExpectedTasks`` :193 — "scheduled at current
        # time"); a staged DAG must not make early-stage executors wait on
        # jobtypes that haven't launched. Starts as ALL jobs so that direct
        # Session use (unit tests, non-DAG paths) keeps whole-job barrier
        # semantics; the coordinator narrows it before the first launch.
        self.scheduled_jobs = set(self.jobs)
        self._scheduling_narrowed = False

    # -- queries ----------------------------------------------------------
    def get_task(self, task_id: str) -> Optional[Task]:
        with self._lock:
            return self.tasks.get(task_id)

    def all_tasks(self) -> List[Task]:
        with self._lock:
            return list(self.tasks.values())

    def tracked_tasks(self) -> List[Task]:
        with self._lock:
            return [t for t in self.tasks.values() if t.tracked]

    def scheduled_job_names(self) -> List[str]:
        with self._lock:
            return sorted(self.scheduled_jobs)

    def members(self, job_name: str) -> List[int]:
        """Sorted member indices of a jobtype's gang. Dense
        ``range(instances)`` until an elastic resize makes it sparse
        (coordinator/elastic.py): a shrink keeps SURVIVOR indices — task
        identity is stable across resizes; only the dense rank (a task's
        position in this list) changes."""
        with self._lock:
            return sorted(t.index for t in self.tasks.values()
                          if t.job_name == job_name)

    def resize_job(self, job_name: str, members) -> List[Task]:
        """Apply an elastic membership change: the jobtype's gang becomes
        exactly ``members`` (indices). Live tasks already in the set are
        kept (their executors are parked at the barrier and re-register);
        indices without a live task get a FRESH Task (returned for the
        caller to launch — lost hosts being replaced, or grow-back);
        indices outside the set are dropped from the matrix (their
        executors were released and any stragglers are fenced as
        non-members). ``jobs[job].instances`` tracks the new cardinality
        so TASK_NUM and the quota surfaces stay truthful."""
        with self._lock:
            job = self.jobs[job_name]
            wanted = sorted(set(int(m) for m in members))
            for t in [t for t in self.tasks.values()
                      if t.job_name == job_name]:
                if t.index not in wanted:
                    del self.tasks[t.task_id]
            fresh: List[Task] = []
            for i in wanted:
                tid = f"{job_name}:{i}"
                t = self.tasks.get(tid)
                if t is None or t.status.terminal:
                    nt = Task(job_name, i, session_id=self.session_id,
                              tracked=job_name not in self._untracked)
                    self.tasks[tid] = nt
                    fresh.append(nt)
            job.instances = len(wanted)
            return fresh

    def is_chief(self, job_name: str, index: int) -> bool:
        """Reference ``TonySession.isChief`` :364 — the ``chief`` jobtype if it
        exists, else worker:0."""
        if constants.CHIEF_JOB_NAME in self.jobs:
            return job_name == constants.CHIEF_JOB_NAME
        return job_name == constants.WORKER_JOB_NAME and index == 0

    def mark_job_scheduled(self, job_name: str) -> None:
        """Called by the coordinator before launching a gang. The first call
        narrows the barrier scope from "all jobs" to "launched jobs" (staged
        DAGs add later stages as they launch)."""
        with self._lock:
            if not self._scheduling_narrowed:
                self.scheduled_jobs = set()
                self._scheduling_narrowed = True
            self.scheduled_jobs.add(job_name)

    def _expected_tasks_locked(self) -> List[Task]:
        return [t for t in self.tasks.values()
                if t.job_name in self.scheduled_jobs]

    @property
    def num_expected(self) -> int:
        with self._lock:
            return len(self._expected_tasks_locked())

    @property
    def num_registered(self) -> int:
        with self._lock:
            return sum(1 for t in self.tasks.values() if t.registered)

    def all_registered(self) -> bool:
        with self._lock:
            expected = self._expected_tasks_locked()
            return bool(expected) and all(t.registered for t in expected)

    def get_cluster_spec(self) -> Optional[Dict[str, List[str]]]:
        """{job: ["host:port", ...]} once all *scheduled* tasks registered,
        else None — this None is the gang barrier the executors poll on
        (reference ``ApplicationMaster.java:856-888`` returns null until every
        one of numExpectedTasks has registered; spec built by
        ``TonySession.getClusterSpec`` :226-246). Only jobs whose gang has
        launched appear; later DAG stages join the spec when they launch."""
        with self._lock:
            if not self.all_registered():
                return None
            spec: Dict[str, List[str]] = {}
            for job_name in self.jobs:
                if job_name not in self.scheduled_jobs:
                    continue
                # Dense-rank order over the (possibly sparse, post-resize)
                # member indices: list position IS the dense rank the
                # runtimes build JAX_PROCESS_ID / TF_CONFIG from.
                addrs = [self.tasks[f"{job_name}:{i}"].spec
                         for i in self.members(job_name)]
                if addrs:
                    spec[job_name] = addrs
            return spec

    # -- mutations --------------------------------------------------------
    def register_worker(self, task_id: str, host: str, port: int) -> bool:
        with self._lock:
            t = self.tasks.get(task_id)
            if t is None or t.status.terminal:
                return False
            t.host, t.port = host, int(port)
            t.registered = True
            if t.status in (TaskStatus.NEW, TaskStatus.SCHEDULED):
                t.status = TaskStatus.RUNNING
            return True

    def on_task_completed(self, task_id: str, exit_code: int,
                          domain_hint: Optional[str] = None) -> None:
        """Apply completion + failure policy (reference
        ``TonySession.onTaskCompleted`` :251-271). ``domain_hint`` is the
        backend's failure attribution (``Backend.completion_domain``)."""
        with self._lock:
            t = self.tasks.get(task_id)
            if t is None or t.status.terminal:
                return
            t.exit_code = exit_code
            if exit_code == 0:
                t.status = TaskStatus.SUCCEEDED
                return
            t.status = (TaskStatus.KILLED
                        if exit_code == constants.EXIT_KILLED
                        else TaskStatus.FAILED)
            domain = classify_exit(exit_code, domain_hint)
            t.failure_domain = domain
            tag = f"exit {exit_code}, {domain.value if domain else '?'}"
            if not t.tracked:
                # Untracked (ps-style) crash is still a job failure when it
                # dies on its own (reference ApplicationMaster.java:1212-1215).
                self._fail_locked(f"untracked task {task_id} crashed "
                           f"({tag})", domain)
                return
            if self.is_chief(t.job_name, t.index):
                self._fail_locked(f"chief task {task_id} failed ({tag})", domain)
            elif t.job_name in self.stop_on_failure:
                self._fail_locked(f"stop-on-failure jobtype {t.job_name}: task "
                           f"{task_id} failed ({tag})", domain)
            elif self.fail_on_worker_failure:
                self._fail_locked(f"task {task_id} failed ({tag}) and "
                           f"fail-on-worker-failure is enabled", domain)

    def restore_task(self, task_id: str, status: TaskStatus,
                     host: str = "", port: int = 0,
                     exit_code: Optional[int] = None,
                     domain: Optional[FailureDomain] = None,
                     registered: bool = False) -> None:
        """Install journal-replayed state for one task (coordinator crash
        recovery, coordinator/journal.py). Terminal states are restored
        verbatim; live states come back as RUNNING with
        ``registered=False`` — the task's last-known host/port are kept
        for the report, but the executor must RE-register inside the
        recovery grace window before it counts toward the barrier again
        (its process survived the coordinator; its liveness did not
        survive the restart)."""
        with self._lock:
            t = self.tasks.get(task_id)
            if t is None:
                return
            t.host, t.port = host, int(port)
            if status.terminal:
                t.status = status
                t.exit_code = exit_code
                t.failure_domain = domain
                # A task that finished before the crash keeps its
                # registered-ness: the barrier must not wait on it.
                t.registered = registered
            elif status in (TaskStatus.SCHEDULED, TaskStatus.RUNNING):
                t.status = TaskStatus.RUNNING
                t.registered = False

    def mark_killed(self, task_id: str, reason: str = "") -> None:
        with self._lock:
            t = self.tasks.get(task_id)
            if t and not t.status.terminal:
                t.status = TaskStatus.KILLED
                t.exit_code = constants.EXIT_KILLED

    def _fail_locked(self, reason: str,
                     domain: Optional[FailureDomain] = None) -> None:
        if self.status == SessionStatus.RUNNING:
            self.status = SessionStatus.FAILED
            self.failure_reason = reason
        # Even when a reason already landed, keep the WORST domain seen:
        # a preempted host plus a user crash in the same epoch must not
        # retry for free.
        self.failure_domain = worst_domain(self.failure_domain, domain)

    def fail(self, reason: str,
             domain: Optional[FailureDomain] = None) -> None:
        with self._lock:
            self._fail_locked(reason, domain)

    def fail_terminal(self, reason: str,
                      domain: Optional[FailureDomain] = None) -> None:
        """Force FAILED even over a completed epoch — the journal-dead
        degrade: an outcome the coordinator can no longer durably
        record must not read as SUCCEEDED (the history would claim a
        success the write-ahead journal never saw)."""
        with self._lock:
            if self.status != SessionStatus.FAILED:
                self.status = SessionStatus.FAILED
                self.failure_reason = reason
            self.failure_domain = worst_domain(self.failure_domain,
                                               domain)

    # -- reduction --------------------------------------------------------
    def update_status(self) -> SessionStatus:
        """Reduce tracked-task states to a session status (reference
        ``TonySession.updateSessionStatus`` :276-330)."""
        with self._lock:
            if self.status != SessionStatus.RUNNING:
                return self.status
            tracked = self.tracked_tasks()
            if tracked and all(t.status.terminal for t in tracked):
                failed = [t for t in tracked
                          if t.status in (TaskStatus.FAILED, TaskStatus.KILLED)]
                if failed:
                    domain = None
                    for t in failed:
                        domain = worst_domain(domain, t.failure_domain)
                    self._fail_locked(
                        f"{len(failed)} tracked task(s) failed: "
                        + ", ".join(t.task_id for t in failed[:5]),
                        domain)
                else:
                    self.status = SessionStatus.SUCCEEDED
            return self.status

    def training_finished(self) -> bool:
        tracked = self.tracked_tasks()
        return bool(tracked) and all(t.status.terminal for t in tracked)
