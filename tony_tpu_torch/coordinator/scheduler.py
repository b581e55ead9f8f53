"""Gang scheduler: stage/DAG-ordered jobtype launch.

Reference model: ``TaskScheduler.java`` (179 LoC) — builds a dependency graph
from ``tony.X.depends-on`` plus the prepare→training stage edge (:75-86),
validates acyclicity (``isDAG`` :142-178), requests containers for ready jobs
(``scheduleJob`` :93), and unlocks dependents as tasks of a jobtype complete
(``registerDependencyCompleted`` :118-140).

The TPU difference: instead of asking YARN for containers and matching
allocations back by priority (``TonySession.getAndInitMatchingTaskByPriority``
:208), the scheduler hands whole ready jobtypes to a backend which launches
them as gangs — a TPU slice lease is all-or-nothing, so partial-allocation
matching has no equivalent here (SURVEY.md §7 hard part (a)).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Set

from tony_tpu_torch.conf.config import JobType, TonyTpuConfig
from tony_tpu_torch.conf import keys as K


class SchedulerError(RuntimeError):
    pass


class GangScheduler:
    def __init__(self, conf: TonyTpuConfig,
                 launch_job: Callable[[str], None]):
        """launch_job(jobtype) must launch all instances of the jobtype."""
        self.conf = conf
        self.jobs: Dict[str, JobType] = conf.job_types()
        self._launch_job = launch_job
        self._lock = threading.Lock()
        self._deps: Dict[str, Set[str]] = {}
        self._scheduled: Set[str] = set()
        self._completed: Set[str] = set()
        self._build_graph()
        if not self._is_dag():
            raise SchedulerError(
                "jobtype dependency graph has a cycle "
                "(reference TaskScheduler.isDAG :142-178)")

    def _build_graph(self) -> None:
        """depends-on edges + prepare-stage → training-stage edges
        (reference TaskScheduler.java:75-86, Utils.java:372-406)."""
        prepare = [j for j in self.conf.get_list(K.APPLICATION_PREPARE_STAGE)
                   if j in self.jobs]
        training = [j for j in self.conf.get_list(K.APPLICATION_TRAINING_STAGE)
                    if j in self.jobs]
        for name, job in self.jobs.items():
            deps = {d for d in job.depends_on if d in self.jobs}
            if name in training:
                deps.update(prepare)
            self._deps[name] = deps

    def _is_dag(self) -> bool:
        WHITE, GRAY, BLACK = 0, 1, 2
        color = {n: WHITE for n in self._deps}

        def visit(n: str) -> bool:
            color[n] = GRAY
            for d in self._deps[n]:
                if color[d] == GRAY:
                    return False
                if color[d] == WHITE and not visit(d):
                    return False
            color[n] = BLACK
            return True

        for n in self._deps:
            if color[n] == WHITE and not visit(n):
                return False
        return True

    # -- scheduling -------------------------------------------------------
    def ready_jobs(self) -> List[str]:
        with self._lock:
            return sorted(
                n for n in self.jobs
                if n not in self._scheduled
                and self._deps[n] <= self._completed)

    def schedule_ready(self) -> List[str]:
        """Launch every jobtype whose dependencies are satisfied (reference
        ``scheduleTasks`` :55 / ``scheduleJob`` :93)."""
        launched = []
        for name in self.ready_jobs():
            with self._lock:
                if name in self._scheduled:
                    continue
                self._scheduled.add(name)
            self._launch_job(name)
            launched.append(name)
        return launched

    def restore(self, scheduled, completed) -> None:
        """Install journal-replayed DAG progress (coordinator crash
        recovery): jobtypes already handed to the backend must not be
        launched again over their surviving executors, and completed
        dependencies must keep their dependents unlocked. A later
        ``schedule_ready`` then launches exactly the jobtypes the crash
        interrupted before their launch record hit the journal."""
        with self._lock:
            self._scheduled |= {j for j in scheduled if j in self.jobs}
            self._completed |= {j for j in completed if j in self.jobs}

    def register_job_completed(self, job_name: str) -> List[str]:
        """All tasks of `job_name` finished successfully → unlock dependents
        (reference ``registerDependencyCompleted`` :118-140)."""
        with self._lock:
            self._completed.add(job_name)
        return self.schedule_ready()

    @property
    def all_scheduled(self) -> bool:
        with self._lock:
            return self._scheduled == set(self.jobs)

    def dependency_check_passed(self, failed_job: str) -> bool:
        """False if `failed_job` blocks a jobtype that has not been launched
        yet — the DAG can't make progress (reference ``dependencyCheckPassed``
        :43; the AM monitor fails the job on this,
        ``ApplicationMaster.java:581-650``). Already-scheduled dependents got
        their launch before the failure and are judged on their own merits."""
        with self._lock:
            return all(failed_job not in deps or name in self._scheduled
                       for name, deps in self._deps.items())
