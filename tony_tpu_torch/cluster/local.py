"""Local-process backend: one executor subprocess per task.

Dual role, mirroring the reference:
- the **test substrate** — in-process fake cluster like
  ``tony-mini/.../MiniCluster.java:43-63`` (no YARN/HDFS needed);
- the **single-host production path** — on a GPU host the coordinator and
  all task processes are host-local; each user process picks its card from
  the ``LOCAL_RANK`` the pytorch runtime exports (runtimes/frameworks.py).

Each task runs ``python -m tony_tpu_torch.executor`` (the TaskExecutor entrypoint)
in its own working directory with the task-identity environment; stdout/stderr
are captured per task like YARN container logs
(``ApplicationMaster.java:1145-1147``).
"""

from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from tony_tpu_torch import constants

from tony_tpu_torch.cluster.base import (Backend, TaskLaunchSpec,
                                   build_executor_argv, container_name,
                                   docker_kill)

log = logging.getLogger(__name__)


class _Proc:
    def __init__(self, task_id: str, popen, workdir: str,
                 container: str = ""):
        self.task_id = task_id
        self.popen = popen
        self.workdir = workdir
        self.container = container   # docker container name, if dockerized
        self.reported = False


class _LeasedProc:
    """Popen-shaped handle over a warm-pool executor. The process is the
    POOL DAEMON's child, not ours, so liveness is a signal-0 probe and
    the exit code comes from the ``pool-exit.json`` the adopted executor
    writes into its task workdir at exit (constants.POOL_EXIT_FILE) —
    pid-dead with no report reads as a crash (EXIT_FAILURE)."""

    def __init__(self, pid: int, workdir: str, worker_id: str):
        self.pid = pid
        self.workdir = workdir
        self.worker_id = worker_id
        self.returncode: object = None

    def poll(self):
        if self.returncode is not None:
            return self.returncode
        path = os.path.join(self.workdir, constants.POOL_EXIT_FILE)
        try:
            with open(path, encoding="utf-8") as f:
                self.returncode = int(json.load(f).get("exit_code", 1))
            return self.returncode
        except (OSError, ValueError, TypeError):
            pass
        try:
            os.kill(self.pid, 0)
            return None               # still running
        except ProcessLookupError:
            # Dead without a report: killed or crashed pre-report. Mirror
            # waitpid's negative-signal convention (what a SIGKILLed cold
            # spawn reports) so poll_completions maps it to 137 →
            # INFRA_TRANSIENT — a kill must stay retryable, not become a
            # USER_ERROR exit-1, just because the executor was pooled.
            self.returncode = -int(signal.SIGKILL)
            return self.returncode
        except PermissionError:
            return None


class LocalProcessBackend(Backend):
    def __init__(self, workdir: str, python: str = sys.executable,
                 inherit_env: bool = True, pool_dir: str = ""):
        self.workdir = workdir
        self.python = python
        self.inherit_env = inherit_env
        self._procs: Dict[str, _Proc] = {}
        self._lock = threading.Lock()
        # Warm executor pool (tony_tpu_torch/pool.py): with tony.pool.dir set,
        # launch_task tries to ADOPT a pre-warmed executor before cold-
        # spawning; every pool failure degrades to the cold path below.
        self._pool = None
        if pool_dir:
            from tony_tpu_torch.pool import PoolClient

            self._pool = PoolClient(pool_dir)
        os.makedirs(workdir, exist_ok=True)

    def launch_task(self, spec: TaskLaunchSpec) -> object:
        task_dir = os.path.join(self.workdir,
                                spec.task_id.replace(":", "_"))
        os.makedirs(task_dir, exist_ok=True)
        env = dict(os.environ) if self.inherit_env else {}
        env.update(spec.env)
        # Make `import tony_tpu_torch` resolvable in the child regardless of cwd.
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = (repo_root + os.pathsep + env.get("PYTHONPATH", "")
                             ).rstrip(os.pathsep)
        if self._pool is not None and not spec.docker_image:
            proc = self._try_pool_lease(spec, task_dir, env)
            if proc is not None:
                with self._lock:
                    self._procs[spec.task_id] = proc
                return proc
        stdout = open(os.path.join(task_dir, "stdout.log"), "ab")
        stderr = open(os.path.join(task_dir, "stderr.log"), "ab")
        popen = subprocess.Popen(
            build_executor_argv(self.python, spec, task_dir),
            cwd=task_dir, env=env, stdout=stdout, stderr=stderr,
            start_new_session=True)
        proc = _Proc(spec.task_id, popen, task_dir,
                     container=container_name(spec) if spec.docker_image
                     else "")
        with self._lock:
            self._procs[spec.task_id] = proc
        log.info("launched %s pid=%d dir=%s", spec.task_id, popen.pid, task_dir)
        return proc

    def _try_pool_lease(self, spec: TaskLaunchSpec, task_dir: str,
                        env: Dict[str, str]) -> Optional[_Proc]:
        """Adopt a warm executor for this task, or None → cold spawn.
        Pool trouble of ANY shape — daemon gone, lease refused, stale
        generation, worker dead on adoption (each rehearsable via the
        pool.* fault sites) — degrades to the cold path; it must never
        fail the launch. A granted-but-unusable lease is DISCARDED at the
        daemon (never returned to the pool) before falling back."""
        from tony_tpu_torch import faults, tracing
        from tony_tpu_torch.pool import PoolError

        t0 = tracing.now_us()
        lease = None
        try:
            faults.check("pool.lease")
            faults.check("pool.stale")
            # Fenced lease: the worker waits for confirm() below, so a
            # lease discarded here never starts an executor.
            lease = self._pool.lease(
                spec.task_id, {**env, constants.POOL_CONFIRM: "1"}, task_dir,
                app_id=env.get(constants.APP_ID, ""),
                generation=int(
                    env.get(constants.COORDINATOR_GENERATION, "0") or 0))
            dead: Optional[BaseException] = None
            try:
                faults.check("pool.adopt")
                os.kill(int(lease["pid"]), 0)
            except ProcessLookupError as e:
                dead = e
            except PermissionError:
                pass                   # alive, just not ours to signal
            except faults.InjectedFault as e:
                dead = e
            if dead is not None:
                self._pool.discard(str(lease.get("worker_id", "")),
                                   reason=f"dead on adoption: {dead}")
                raise PoolError(
                    f"leased executor pid {lease.get('pid')} dead on "
                    f"adoption: {dead}") from dead
            try:
                self._pool.confirm(str(lease["worker_id"]))
            except PoolError:
                self._pool.discard(str(lease["worker_id"]),
                                   reason="lease confirmation failed")
                raise
        except Exception as e:  # noqa: BLE001 — every shape cold-spawns
            # A granted-then-unusable lease names its worker in the span:
            # the trace is how an operator finds the discarded worker.
            worker = str(lease.get("worker_id", "")) if lease else ""
            self._emit_lease_span(spec, t0, error=str(e)[:200],
                                  **({"worker": worker} if worker else {}))
            log.warning("pool lease for %s failed (%s); cold-spawning",
                        spec.task_id, e)
            return None
        self._emit_lease_span(spec, t0, worker=lease["worker_id"],
                              pid=int(lease["pid"]),
                              worker_age_s=lease.get("age_s"))
        log.info("adopted warm executor for %s: worker %s pid %d",
                 spec.task_id, lease["worker_id"], lease["pid"])
        return _Proc(spec.task_id,
                     _LeasedProc(int(lease["pid"]), task_dir,
                                 str(lease["worker_id"])),
                     task_dir)

    def _emit_lease_span(self, spec: TaskLaunchSpec, start_us: int,
                         **attrs) -> None:
        """pool.lease span under the task's lifecycle span (the trace
        parent the coordinator stamped into the launch env) — how a warm
        adoption (or its failure→fallback) shows up on the timeline."""
        tracer = getattr(self, "tracer", None)
        if tracer is None:
            return
        from tony_tpu_torch import tracing

        tracer.emit("pool.lease", start_us=start_us,
                    end_us=tracing.now_us(),
                    parent=spec.env.get(constants.TRACE_PARENT_ENV, ""),
                    task=spec.task_id, attrs=attrs)

    def kill_task(self, handle: object, grace_s: float = 0.0) -> None:
        proc = handle
        if not isinstance(proc, _Proc):
            return
        if proc.container and proc.popen.poll() is None:
            # The containerized executor is containerd's child, not ours:
            # signal the container by name, then the docker-run client.
            docker_kill(proc.container, grace_s=grace_s)
        # The user command lives in its OWN session (utils/proc.execute_shell)
        # — signalling the executor's group alone never reaches it. Deliver
        # the TERM→grace→KILL ladder to both groups; the pgid file is how we
        # reach the user tree even when the executor is already dead
        # (constants.USER_PGID_FILE contract). Pooled executors work the
        # same way: the daemon spawned them session-leading, so their pid
        # IS their pgid.
        from tony_tpu_torch.utils.proc import kill_process_groups, read_pgid_file

        groups = [proc.popen.pid] if proc.popen.poll() is None else []
        if not proc.container:
            # Containerized tasks: user.pgid holds a pid from the
            # container's OWN pid namespace — meaningless (and dangerous to
            # signal) on the host; docker_kill above reaps the in-container
            # tree instead.
            user_pgid = read_pgid_file(
                os.path.join(proc.workdir, constants.USER_PGID_FILE))
            if user_pgid:
                groups.append(user_pgid)
        kill_process_groups(groups, grace_s=grace_s)

    def gang_active(self) -> bool:
        """Any launched executor still alive? The coordinator's epoch
        reset waits on this before relaunching (Backend.gang_active) so a
        killed-but-unreaped task can't leak its exit into the new epoch."""
        with self._lock:
            return any(not p.reported and p.popen.poll() is None
                       for p in self._procs.values())

    def poll_completions(self) -> List[Tuple[str, int]]:
        done: List[Tuple[str, int]] = []
        with self._lock:
            for proc in self._procs.values():
                if proc.reported:
                    continue
                rc = proc.popen.poll()
                if rc is not None:
                    proc.reported = True
                    # Negative returncode = killed by signal N.
                    exit_code = 128 - rc if rc < 0 else rc
                    done.append((proc.task_id, exit_code))
        return done

    def task_log_paths(self, task_id: str) -> Optional[Tuple[str, str]]:
        with self._lock:
            proc = self._procs.get(task_id)
        if proc is None:
            return None
        return (os.path.join(proc.workdir, "stdout.log"),
                os.path.join(proc.workdir, "stderr.log"))

    def stop(self) -> None:
        with self._lock:
            procs = list(self._procs.values())
        for proc in procs:
            self.kill_task(proc, grace_s=0.5)


class VirtualExecutorBackend(Backend):
    """Width-harness twin of :class:`LocalProcessBackend`
    (``tony.scale.virtual-executors``): every launched task becomes a
    beat-only in-process virtual executor (executor/virtual.py) — real
    registration/heartbeat/result RPC traffic against the coordinator,
    no subprocess, no user command — so the control plane is exercised
    at 128–1024 tasks per box (``bench.py --suite scale``,
    tests/test_scale.py). One shared :class:`VirtualGang` pump serves
    every task; its coordinates come from the first launch spec's env
    (the same identity contract a real executor reads)."""

    def __init__(self, workdir: str, hb_interval_s: float = 1.0,
                 steps_per_s: float = 5.0, run_s: float = 0.0,
                 pump_threads: int = 8):
        self.workdir = workdir
        self.hb_interval_s = hb_interval_s
        self.steps_per_s = steps_per_s
        self.run_s = run_s
        self.pump_threads = pump_threads
        self._gang = None
        self._handles: Dict[str, object] = {}
        self._reported: set = set()
        self._lock = threading.Lock()

    @classmethod
    def from_conf(cls, conf, workdir: str) -> "VirtualExecutorBackend":
        from tony_tpu_torch.conf import keys as K

        return cls(
            workdir,
            hb_interval_s=conf.get_int(K.TASK_HEARTBEAT_INTERVAL_MS,
                                       1000) / 1000.0,
            steps_per_s=float(
                conf.get(K.SCALE_VIRTUAL_STEPS_PER_S, 5.0) or 5.0),
            run_s=float(conf.get(K.SCALE_VIRTUAL_RUN_S, 0.0) or 0.0),
            pump_threads=conf.get_int(K.SCALE_VIRTUAL_PUMP_THREADS, 8))

    def launch_task(self, spec: TaskLaunchSpec) -> object:
        from tony_tpu_torch.executor.virtual import VirtualGang

        # Same launch-path fault seam every real backend passes through
        # (``executor.spawn``) — argv itself is discarded.
        build_executor_argv(sys.executable, spec, self.workdir)
        env = spec.env
        with self._lock:
            if self._gang is None:
                self._gang = VirtualGang(
                    env.get(constants.COORDINATOR_HOST, "127.0.0.1"),
                    int(env.get(constants.COORDINATOR_PORT, "0") or 0),
                    token=env.get("TONY_RPC_TOKEN") or None,
                    generation=int(
                        env.get(constants.COORDINATOR_GENERATION, "0")
                        or 0),
                    hb_interval_s=self.hb_interval_s,
                    steps_per_s=self.steps_per_s, run_s=self.run_s,
                    pump_threads=self.pump_threads)
            gang = self._gang
        handle = gang.launch(
            spec.task_id,
            session_id=int(env.get(constants.SESSION_ID, "0") or 0),
            mgen=int(env.get(constants.MEMBERSHIP_GEN, "-1") or -1))
        with self._lock:
            self._handles[spec.task_id] = handle
            self._reported.discard(spec.task_id)
        return handle

    def kill_task(self, handle: object, grace_s: float = 0.0) -> None:
        task_id = getattr(handle, "task_id", None)
        if task_id is not None and self._gang is not None:
            self._gang.kill(task_id)

    def poll_completions(self) -> List[Tuple[str, int]]:
        done: List[Tuple[str, int]] = []
        with self._lock:
            for task_id, handle in self._handles.items():
                if task_id in self._reported:
                    continue
                rc = handle.poll()
                if rc is not None:
                    self._reported.add(task_id)
                    done.append((task_id, int(rc)))
        return done

    def gang_active(self) -> bool:
        with self._lock:
            return any(h.poll() is None for h in self._handles.values())

    def stop(self) -> None:
        if self._gang is not None:
            self._gang.stop()
