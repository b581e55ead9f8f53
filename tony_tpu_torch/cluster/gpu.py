"""GPU host backend: gang launch over leased multi-host GPU slices.

The counterpart of the reference's ``cluster/tpu.py`` (``TpuSliceBackend``)
for hosts that carry NVIDIA cards. The reference acquires compute
incrementally — YARN grants containers one callback at a time
(``RMCallbackHandler.onContainersAllocated`` ``ApplicationMaster.java:1051-1070``)
and each is launched on its NodeManager (``ContainerLauncher.run``
:1108-1175). A gang of GPU hosts joined by one NCCL world is treated the same
way a TPU pod slice is: the cluster substrate is a **lease**: a provisioner
grants a whole slice (all hosts) or nothing (SURVEY.md §7 hard part (a)), and
losing any host invalidates the lease — the whole gang fails and the
coordinator's existing failure policy / whole-job retry takes over (the
analogue of ``onTaskDeemedDead`` → AM reset,
``ApplicationMaster.java:1178-1185``, :559-575).

Three layers:

- ``HostChannel`` — exec/kill/poll on one host. ``SshHostChannel`` is the
  production shape (plain ssh; GPU hosts are reachable machines, no
  cluster manager needed). ``LocalSimHostChannel`` runs the same contract as
  local subprocesses so the full gang-over-hosts path is e2e-testable on one
  machine (the MiniCluster role, ``tony-mini/.../MiniCluster.java:43-63``).
- ``SliceProvisioner`` — ``acquire(n_hosts)`` → all-or-nothing
  ``SliceLease``. ``StaticSshProvisioner`` leases from a fixed host list;
  ``FakeSliceProvisioner`` simulates an inventory, including host **loss**
  mid-job (``fail_host``) and capacity denial, for the fault e2e matrix.
- ``GpuHostBackend`` — the ``Backend`` implementation: leases on first
  launch, places tasks round-robin over the slice's hosts, surfaces host
  loss as synthetic exit codes for every task on the lost host.

The GPU host contract, the env this backend exports per task:

- ``TONY_HOST_ID`` / ``TONY_HOST_LOCAL_ORDINAL`` — which slice host this
  task landed on, and its per-host ordinal (as the reference exports them).
- Nothing of libtpu: a GPU host has none, so the reference's
  ``TPU_WORKER_ID`` / ``TPU_WORKER_HOSTNAMES`` are not set.
- No ``CUDA_VISIBLE_DEVICES``: every task sees every card of its host, and
  the user process picks its own by ``LOCAL_RANK``
  (``trainer.mesh_scope``), so a job's device choice stays in one place.

torch's *process* rendezvous (``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK``
/ ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``) is NOT a backend
concern: it rides the coordinator's gang barrier and is exported by the
``pytorch`` runtime after registration (``runtimes/frameworks.py``), exactly
because the rendezvous ports don't exist yet at launch time.
"""

from __future__ import annotations

import logging
import os
import shlex
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from tony_tpu_torch.devtools import sanitizer
from tony_tpu_torch.utils import durable
from tony_tpu_torch import constants
from tony_tpu_torch.cluster.base import (Backend, TaskLaunchSpec,
                                         build_executor_argv)

log = logging.getLogger(__name__)

# Exit code reported for tasks whose HOST died under them (distinct from
# any user exit so failure policy/logs can tell "your code crashed" from
# "the machine went away"). 128+SIGKILL by convention.
HOST_LOST_EXIT = 137


class HostChannel:
    """Exec/kill/poll on one host of a slice."""

    host_id: str

    def exec_task(self, task_id: str, argv: Sequence[str],
                  env: Dict[str, str], workdir: str) -> object:
        raise NotImplementedError

    def kill(self, handle: object, grace_s: float = 0.0) -> None:
        raise NotImplementedError

    def poll(self, handle: object) -> Optional[int]:
        """Exit code if the task finished, else None."""
        raise NotImplementedError

    def alive(self) -> bool:
        """Is the host itself still reachable?"""
        return not getattr(self, "_forced_lost", False)

    def mark_lost(self) -> None:
        """An outside authority (the cloud API reporting the node
        PREEMPTED/DELETED — cluster/gcloud.py) declares this host gone:
        ``alive()`` goes False without waiting for a probe to time out."""
        self._forced_lost = True

    def log_paths(self, handle: object) -> Optional[Tuple[str, str]]:
        return None

    def fetch_logs(self, handle: object) -> None:
        """Pull the task's stdout/stderr to the coordinator's machine if
        they live remotely — a no-op where ``log_paths`` already points at
        local files. Called by the backend when a task completes or is
        killed, BEFORE the TASK_FINISHED event snapshots the paths, so
        `tony-tpu logs` / the portal read real content instead of paths
        stranded on a remote host (the reference surfaces NodeManager log URLs
        per container, ``models/JobLog.java:69-80``,
        ``util/Utils.java:215-230``; with no NM, the coordinator fetches)."""


class LocalSimHostChannel(HostChannel):
    """A 'host' that is really a local process group — same contract as a
    remote GPU host, minus the network. Used by FakeSliceProvisioner."""

    def __init__(self, host_id: str, workroot: str):
        self.host_id = host_id
        self.workroot = workroot
        self._alive = True
        self._handles: List[dict] = []
        self._lock = threading.Lock()

    def exec_task(self, task_id, argv, env, workdir):
        os.makedirs(workdir, exist_ok=True)
        full_env = dict(os.environ)
        full_env.update(env)
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        full_env["PYTHONPATH"] = (repo_root + os.pathsep
                                  + full_env.get("PYTHONPATH", "")
                                  ).rstrip(os.pathsep)
        stdout = open(os.path.join(workdir, "stdout.log"), "ab")
        stderr = open(os.path.join(workdir, "stderr.log"), "ab")
        popen = subprocess.Popen(
            list(argv), cwd=workdir, env=full_env, stdout=stdout,
            stderr=stderr, start_new_session=True)
        handle = {"popen": popen, "workdir": workdir}
        with self._lock:
            self._handles.append(handle)
        return handle

    @staticmethod
    def _task_groups(handle) -> List[int]:
        """Process groups of one task: the executor's (while alive), plus
        the user command's own session read from the pgid file the executor
        wrote (constants.USER_PGID_FILE) — the only route to the user tree
        once the executor is gone."""
        from tony_tpu_torch import constants
        from tony_tpu_torch.utils.proc import read_pgid_file

        popen = handle["popen"]
        groups = [popen.pid] if popen.poll() is None else []
        user_pgid = read_pgid_file(
            os.path.join(handle["workdir"], constants.USER_PGID_FILE))
        if user_pgid:
            groups.append(user_pgid)
        return groups

    def kill(self, handle, grace_s: float = 0.0) -> None:
        from tony_tpu_torch.utils.proc import kill_process_groups

        kill_process_groups(self._task_groups(handle), grace_s=grace_s)

    def poll(self, handle) -> Optional[int]:
        # A task that FINISHED before the host died keeps its real exit
        # code (a real channel has the buffered status too) — only
        # still-running tasks are converted to host-lost.
        rc = handle["popen"].poll()
        if rc is not None:
            return 128 - rc if rc < 0 else rc
        if not self._alive:
            return HOST_LOST_EXIT
        return None

    def alive(self) -> bool:
        return self._alive

    def mark_lost(self) -> None:
        # For a sim host, "the cloud reclaimed the VM" means its
        # processes die too.
        self.simulate_loss()

    def log_paths(self, handle):
        wd = handle["workdir"]
        return (os.path.join(wd, "stdout.log"),
                os.path.join(wd, "stderr.log"))

    def simulate_loss(self) -> None:
        """The host 'disappears': every process on it — executor AND its
        user session — dies instantly and the channel reports dead."""
        self._alive = False
        with self._lock:
            handles = list(self._handles)
        for h in handles:
            for pg in self._task_groups(h):
                try:
                    os.killpg(pg, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass


class SshHostChannel(HostChannel):
    """Run executors on a remote GPU host over plain ssh.

    The remote command writes its process-group id to ``<workdir>/task.pid``
    so kill() can signal the group from a second ssh exec; ssh itself exits
    with the remote command's code (255 = ssh transport failure = host
    loss). Assumes the job bundle is reachable from the VM (a shared
    filesystem or the remote store — ``tony_tpu_torch.storage``)."""

    def __init__(self, host_id: str, ssh_target: str,
                 ssh_args: Optional[List[str]] = None,
                 python: str = "python3"):
        self.host_id = host_id
        self.ssh_target = ssh_target
        self.ssh_args = list(ssh_args or
                             ["-o", "BatchMode=yes",
                              "-o", "ConnectTimeout=10",
                              "-o", "StrictHostKeyChecking=accept-new",
                              # A suspended/reclaimed VM drops packets
                              # silently; without keepalives an ESTABLISHED
                              # connection (the exec_task channel) can hang
                              # in TCP timeout for many minutes. 15s×4 ≈
                              # a 60s organic detection bound even when no
                              # cloud API reports the loss.
                              "-o", "ServerAliveInterval=15",
                              "-o", "ServerAliveCountMax=4"])
        self.python = python
        self._alive_cache: Optional[Tuple[float, bool]] = None

    def _ssh(self, remote_cmd: str, **popen_kw) -> subprocess.Popen:
        return subprocess.Popen(
            ["ssh", *self.ssh_args, self.ssh_target, remote_cmd],
            **popen_kw)

    def exec_task(self, task_id, argv, env, workdir):
        exports = " ".join(
            f"export {k}={shlex.quote(v)};" for k, v in env.items())
        cmd = " ".join(shlex.quote(a) for a in argv)
        remote = (
            f"mkdir -p {shlex.quote(workdir)} && cd {shlex.quote(workdir)} "
            f"&& echo $$ > task.pid && {exports} exec {cmd} "
            f"> stdout.log 2> stderr.log")
        popen = self._ssh(remote)
        container = ""
        if argv and argv[0] == "docker" and "--name" in argv:
            container = argv[argv.index("--name") + 1]
        return {"popen": popen, "workdir": workdir, "container": container}

    def kill(self, handle, grace_s: float = 0.0) -> None:
        wd = shlex.quote(handle["workdir"])
        if handle.get("container"):
            # Stop the container by name first: signalling the docker-run
            # client's process group does not reach containerd's child.
            # `docker stop -t` = TERM, grace, then KILL (kill_task's
            # escalation contract; bare `docker kill` is instant SIGKILL).
            k = self._ssh(f"docker stop -t {max(0, int(grace_s))} "
                          f"{shlex.quote(handle['container'])} "
                          f">/dev/null 2>&1 || true",
                          stdout=subprocess.DEVNULL,
                          stderr=subprocess.DEVNULL)
            try:
                k.wait(timeout=15 + grace_s)
            except subprocess.TimeoutExpired:
                k.kill()
        # Two groups per task: the remote executor's (task.pid, written by
        # the launch wrapper) and — for non-containerized tasks — the user
        # command's own session (user.pgid, written by the executor; the
        # only route to the user tree if the executor already died). A
        # container's user.pgid is a pid in the container's namespace and
        # must NOT be signalled on the host; docker stop above reaps it.
        files = "task.pid" if handle.get("container") else "task.pid user.pgid"
        for sig in ("TERM", "KILL"):
            k = self._ssh(
                f"for f in {files}; do "
                f"test -f {wd}/$f && kill -{sig} -$(cat {wd}/$f); "
                f"done 2>/dev/null; true",
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            try:
                k.wait(timeout=15)
            except subprocess.TimeoutExpired:
                k.kill()
            if sig == "TERM":
                # Grace window; the local ssh client exiting early just
                # shortens the wait. The KILL rung always runs: the
                # executor's ssh client being gone says nothing about the
                # USER group (the dead-executor case is exactly when the
                # pgid file matters), and KILL on dead groups is a no-op.
                deadline = time.monotonic() + grace_s
                while (time.monotonic() < deadline
                       and handle["popen"].poll() is None):
                    time.sleep(0.1)

    def poll(self, handle) -> Optional[int]:
        rc = handle["popen"].poll()
        if rc is None:
            if getattr(self, "_forced_lost", False):
                # The cloud API declared the VM gone (lease check). The
                # local ssh client may take minutes of TCP timeout to
                # notice (a SUSPENDED VM drops packets silently); tasks
                # on this host are lost NOW — waiting would wedge
                # gang_active() and block the re-lease. Kill the local
                # client too: the task is terminal after this report, so
                # nothing else would ever reap the hung ssh process.
                handle["popen"].kill()
                try:
                    handle["popen"].wait(timeout=5)
                except subprocess.TimeoutExpired:
                    pass
                return HOST_LOST_EXIT
            return None
        if rc == 255:
            # ssh reports ITS OWN failures as 255, but a remote command
            # exiting 255 looks identical. Disambiguate with a FRESH
            # liveness probe (the cache may be seconds old — exactly the
            # window in which a preempted host died): reachable host →
            # the user code really exited 255.
            self._alive_cache = None
            return 255 if self.alive() else HOST_LOST_EXIT
        return 128 - rc if rc < 0 else rc

    #: bound on fetched log size per stream — TASK_FINISHED wants tails
    #: for diagnosis, not multi-GB training stdout over the control plane
    LOG_TAIL_BYTES = 1024 * 1024

    def fetch_logs(self, handle) -> None:
        # One fetch at a time per handle: completion, kill and stop hooks
        # can race (e.g. a fetch thread abandoned by a join timeout vs a
        # later retry), and two writers interleaving into the same
        # .fetch-tmp would corrupt the very file the atomic-replace
        # protects. dict.setdefault is atomic under the GIL. io_lock:
        # this lock EXISTS to hold across the blocking scp/ssh fetch —
        # only fetchers of the same handle contend — so the lock
        # sanitizer's hold-while-blocking check does not apply.
        with handle.setdefault("fetch_lock", sanitizer.io_lock()):
            self._fetch_logs_locked(handle)

    def _fetch_logs_locked(self, handle) -> None:
        if handle.get("logs_fetched"):
            return
        if not self.alive():
            # The VM is gone (preemption/suspend) and its disk with it;
            # paying ssh connect timeouts per stream would stall the
            # coordinator's completion loop for nothing.
            return
        wd = handle["workdir"]
        os.makedirs(wd, exist_ok=True)   # local mirror of the remote path
        # Both streams fetch CONCURRENTLY (launch all, then wait): this
        # runs inside the coordinator's poll loop, where serial 30 s ssh
        # round trips would stall completion processing for the gang.
        procs = []
        for name in ("stdout.log", "stderr.log"):
            local = os.path.join(wd, name)
            # Download to a temp file, then atomically replace: on a
            # shared filesystem (or the stub-ssh test substrate) the
            # "remote" file IS this local path, and opening it for write
            # before tail reads it would truncate the very content being
            # fetched.
            tmp = local + ".fetch-tmp"
            f = None
            try:
                f = open(tmp, "wb")
                p = self._ssh(
                    f"tail -c {self.LOG_TAIL_BYTES} "
                    f"{shlex.quote(wd)}/{name} 2>/dev/null || true",
                    stdout=f, stderr=subprocess.DEVNULL)
                procs.append((name, local, tmp, f, p))
            except OSError as e:
                log.warning("could not fetch %s from %s: %s", name,
                            self.host_id, e)
                if f is not None:       # Popen failed after open: no leak
                    f.close()
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass
        all_ok = len(procs) == 2
        for name, local, tmp, f, p in procs:
            ok = False
            try:
                ok = p.wait(timeout=15) == 0
            except subprocess.TimeoutExpired:
                p.kill()
                try:
                    p.wait(timeout=5)    # reap — no zombie per timeout
                except subprocess.TimeoutExpired:
                    pass
            f.close()
            # Replace only on a CLEAN fetch: a transport failure (255)
            # or timeout leaves tmp empty/partial, and on a shared
            # filesystem `local` IS the authoritative file — clobbering
            # it with a bad fetch would destroy the log.
            if ok:
                try:
                    durable.fsync_path(tmp)
                    durable.durable_replace(tmp, local)
                except OSError:
                    ok = False
            if not ok:
                all_ok = False
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
        if all_ok:
            # Only a fully-clean fetch is final; a transient ssh failure
            # stays retryable (the next completion/kill hook retries).
            handle["logs_fetched"] = True

    def log_paths(self, handle) -> Optional[Tuple[str, str]]:
        """The FETCHED copies (fetch_logs), which mirror the remote
        workdir path locally; None until a fetch produced content."""
        wd = handle["workdir"]
        out = os.path.join(wd, "stdout.log")
        err = os.path.join(wd, "stderr.log")
        if os.path.isfile(out) or os.path.isfile(err):
            return (out, err)
        return None

    def alive(self) -> bool:
        if getattr(self, "_forced_lost", False):
            return False    # the cloud API already said the VM is gone
        # A real ssh probe per call would serialize 15 s round trips into
        # every launch (lost_hosts() runs before each one) — cache for 5 s.
        now = time.monotonic()
        if self._alive_cache is not None and now - self._alive_cache[0] < 5:
            return self._alive_cache[1]
        probe = self._ssh("true", stdout=subprocess.DEVNULL,
                          stderr=subprocess.DEVNULL)
        try:
            ok = probe.wait(timeout=15) == 0
        except subprocess.TimeoutExpired:
            probe.kill()
            ok = False
        self._alive_cache = (now, ok)
        return ok


class SliceLease:
    """An atomic grant of a whole slice: every host or none."""

    def __init__(self, slice_id: str, hosts: List[HostChannel]):
        self.slice_id = slice_id
        self.hosts = hosts

    def lost_hosts(self) -> List[HostChannel]:
        return [h for h in self.hosts if not h.alive()]


class SliceProvisionError(RuntimeError):
    """The provisioner cannot grant the requested slice."""


class SliceProvisioner:
    def acquire(self, n_hosts: int, node_pool: str = "") -> SliceLease:
        """Grant a slice of ``n_hosts`` hosts atomically, or raise
        SliceProvisionError. Never returns a partial slice."""
        raise NotImplementedError

    def release(self, lease: SliceLease) -> None:
        raise NotImplementedError


class StaticSshProvisioner(SliceProvisioner):
    """Leases from a fixed inventory of ssh-reachable GPU hosts (the
    operator's host list — e.g. the machines of one NVLink/InfiniBand
    island)."""

    def __init__(self, ssh_targets: List[str], python: str = "python3"):
        self.targets = list(ssh_targets)
        self.python = python
        self._leased: Dict[str, List[str]] = {}
        self._lock = threading.Lock()
        self._n = 0

    def acquire(self, n_hosts: int, node_pool: str = "") -> SliceLease:
        with self._lock:
            used = {t for ts in self._leased.values() for t in ts}
            free = [t for t in self.targets if t not in used]
            if len(free) < n_hosts:
                raise SliceProvisionError(
                    f"need {n_hosts} hosts, only {len(free)} of "
                    f"{len(self.targets)} free")
            grant = free[:n_hosts]
            self._n += 1
            slice_id = f"slice-{self._n}"
            self._leased[slice_id] = grant
        hosts: List[HostChannel] = [
            SshHostChannel(host_id=t, ssh_target=t, python=self.python)
            for t in grant]
        return SliceLease(slice_id, hosts)

    def release(self, lease: SliceLease) -> None:
        with self._lock:
            self._leased.pop(lease.slice_id, None)


class FakeSliceProvisioner(SliceProvisioner):
    """In-memory slice inventory over LocalSimHostChannels: the test double
    that lets the gang-over-hosts path (grant, placement, host loss,
    capacity denial) run e2e with REAL executors and no hardware."""

    def __init__(self, n_hosts: int, workroot: str):
        self.workroot = workroot
        self._hosts = {
            f"fakehost-{i}": LocalSimHostChannel(
                f"fakehost-{i}", os.path.join(workroot, f"fakehost-{i}"))
            for i in range(n_hosts)}
        self._leased: Dict[str, List[str]] = {}
        self._lock = threading.Lock()
        self._n = 0

    def acquire(self, n_hosts: int, node_pool: str = "") -> SliceLease:
        with self._lock:
            used = {h for hs in self._leased.values() for h in hs}
            free = [h for h, ch in self._hosts.items()
                    if h not in used and ch.alive()]
            if len(free) < n_hosts:
                raise SliceProvisionError(
                    f"need {n_hosts} hosts, only {len(free)} healthy/free")
            grant = free[:n_hosts]
            self._n += 1
            slice_id = f"fakeslice-{self._n}"
            self._leased[slice_id] = grant
            return SliceLease(slice_id, [self._hosts[h] for h in grant])

    def release(self, lease: SliceLease) -> None:
        with self._lock:
            self._leased.pop(lease.slice_id, None)

    def fail_host(self, host_id: str) -> None:
        """Simulate sudden host loss (preemption / hardware failure)."""
        self._hosts[host_id].simulate_loss()


class _SliceTask:
    def __init__(self, spec: TaskLaunchSpec, host: HostChannel,
                 handle: object):
        self.spec = spec
        self.host = host
        self.handle = handle
        self.reported = False


class GpuHostBackend(Backend):
    """Gang launch over a leased slice of GPU hosts (see module docstring).

    The lease is acquired lazily at the first ``launch_task`` — the
    coordinator launches gangs task-by-task, and the all-or-nothing
    semantics live in ``SliceProvisioner.acquire``. Host loss is detected
    on ``poll_completions`` (dead channel → every task on that host reports
    ``HOST_LOST_EXIT``), feeding the coordinator's normal chief/worker
    failure policy and whole-job retry."""

    def __init__(self, provisioner: SliceProvisioner, n_hosts: int,
                 workdir: str, python: str = sys.executable,
                 node_pool: str = ""):
        self.provisioner = provisioner
        self.n_hosts = n_hosts
        self.workdir = workdir
        self.python = python
        self.node_pool = node_pool
        self.lease: Optional[SliceLease] = None
        self._tasks: Dict[str, _SliceTask] = {}
        self._next_host = 0
        self._host_tasks: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._test_fail_done = False
        self._last_launch = 0.0
        # task_id → failure-domain hint for completions this backend
        # attributed to the MACHINE rather than the task (host loss =
        # preemption; see Backend.completion_domain).
        self._domains: Dict[str, str] = {}

    # -- lease ---------------------------------------------------------
    def gang_active(self) -> bool:
        """Any launched task still running on a live host of the current
        lease? (Terminal = already reported, or poll() returns a code.)"""
        with self._lock:
            tasks = list(self._tasks.values())
        return any(not st.reported and st.host.poll(st.handle) is None
                   for st in tasks)

    _gang_active = gang_active   # internal alias (used by _ensure_lease)

    def _ensure_lease(self) -> SliceLease:
        if self.lease is not None and self.lease.lost_hosts():
            # A slice with a dead host is invalid as a whole (the gang's
            # NCCL world is broken) — release it and lease a fresh one. Only legal
            # once the old gang is fully down (the retry-epoch path: the
            # coordinator killed the gang and is relaunching, reference
            # reset :559-575). Re-leasing mid-gang would split the gang
            # across slices and double-book the old lease's healthy hosts.
            if self._gang_active():
                raise SliceProvisionError(
                    f"lease {self.lease.slice_id} lost hosts "
                    f"{[h.host_id for h in self.lease.lost_hosts()]} while "
                    f"its gang is still running — kill the gang first")
            log.warning("lease %s lost hosts %s; re-leasing",
                        self.lease.slice_id,
                        [h.host_id for h in self.lease.lost_hosts()])
            self.provisioner.release(self.lease)
            self.lease = None
        if self.lease is None:
            self.lease = self.provisioner.acquire(self.n_hosts,
                                                  self.node_pool)
            with self._lock:
                self._next_host = 0
                # Reset per-slice-host ordinals only: the coordinator-host
                # counter tracks tasks that outlive slice re-leases.
                self._host_tasks = {
                    k: v for k, v in self._host_tasks.items()
                    if k == "coordinator-host"}
            log.info("leased %s: hosts=%s", self.lease.slice_id,
                     [h.host_id for h in self.lease.hosts])
        return self.lease

    def _maybe_test_fail_host(self) -> None:
        """TEST_SLICE_FAIL_HOST hook (see constants.py): once per job, kill
        the named fake host. Bare ``host`` form: a short post-launch delay.
        ``host#<glob>`` form: only once the glob matches an existing path —
        condition-triggered, so "preempt AFTER the first checkpoint is
        durable" is deterministic instead of a race against the victim's
        startup (a 0.7 s timer loses to a JAX import every time)."""
        import glob as globmod

        from tony_tpu_torch import constants
        target = os.environ.get(constants.TEST_SLICE_FAIL_HOST, "")
        if not target or self._test_fail_done or self.lease is None:
            return
        if not self._tasks:
            return
        target, _, condition = target.partition("#")
        if condition:
            if not globmod.glob(condition):
                return
        elif time.monotonic() - self._last_launch < 0.7:
            return
        for h in self.lease.hosts:
            if h.host_id == target and hasattr(h, "simulate_loss"):
                log.warning("TEST hook: simulating loss of host %s", target)
                h.simulate_loss()
                self._test_fail_done = True
                return

    # -- Backend -------------------------------------------------------
    def _coordinator_host(self) -> HostChannel:
        """Lazy local channel for ``tony.<job>.node-pool=coordinator``
        jobtypes: ps/db-style CPU tasks run on the coordinator's machine
        instead of occupying a GPU host — SURVEY.md §7 hard part (d),
        heterogeneous gangs on infrastructure that wants homogeneous
        slices. They share the rendezvous/heartbeat plane with the slice
        tasks unchanged (the cluster spec doesn't care where a host is)."""
        with self._lock:
            if not hasattr(self, "_coord_channel"):
                self._coord_channel = LocalSimHostChannel(
                    "coordinator-host", os.path.join(self.workdir,
                                                     "coordinator-host"))
            return self._coord_channel

    def launch_task(self, spec: TaskLaunchSpec) -> object:
        if spec.node_pool and spec.node_pool != "coordinator":
            # Per-job pools other than the reserved "coordinator" are not
            # routed by this backend (slice selection is a lease-level
            # concern) — say so instead of silently parking a CPU task on
            # a GPU host after a typo like "Coordinator".
            log.warning(
                "tony.%s.node-pool=%r has no effect on the gpu-host "
                "backend (only 'coordinator' is special); %s will run on "
                "a slice host", spec.job_name, spec.node_pool,
                spec.task_id)
        if spec.node_pool == "coordinator":
            host = self._coordinator_host()
            with self._lock:
                local_ordinal = self._host_tasks.get(host.host_id, 0)
                self._host_tasks[host.host_id] = local_ordinal + 1
            return self._exec_on(host, spec, local_ordinal,
                                 python=self.python)
        lease = self._ensure_lease()
        with self._lock:
            # Round-robin, skipping hosts the coordinator excluded
            # (exclude-on-retry: this task already failed there). Only
            # best-effort — with every lease host excluded the plain
            # rotation wins; a relaunch beats no launch.
            host = lease.hosts[self._next_host % len(lease.hosts)]
            if spec.exclude_hosts and len(lease.hosts) > 1:
                excluded = set(spec.exclude_hosts)
                if not excluded.issuperset(
                        h.host_id for h in lease.hosts):
                    while host.host_id in excluded:
                        self._next_host += 1
                        host = lease.hosts[
                            self._next_host % len(lease.hosts)]
            self._next_host += 1
            local_ordinal = self._host_tasks.get(host.host_id, 0)
            self._host_tasks[host.host_id] = local_ordinal + 1
        # A channel that knows its host's interpreter (ssh: the remote
        # VM's python, tony.slice.remote-python) wins over the
        # coordinator-local default — sys.executable is a path on THIS
        # machine and means nothing on a remote host.
        python = getattr(host, "python", None) or self.python
        return self._exec_on(host, spec, local_ordinal, python=python)

    def _exec_on(self, host: HostChannel, spec: TaskLaunchSpec,
                 local_ordinal: int, python: str) -> "_SliceTask":
        env = dict(spec.env)
        env[constants.HOST_ID_ENV] = host.host_id
        env["TONY_HOST_LOCAL_ORDINAL"] = str(local_ordinal)
        spec.env = env          # the spec records what actually ran
        workdir = os.path.join(self.workdir, host.host_id,
                               spec.task_id.replace(":", "_"))
        handle = host.exec_task(
            spec.task_id, build_executor_argv(python, spec, workdir),
            env, workdir)
        st = _SliceTask(spec, host, handle)
        with self._lock:
            self._tasks[spec.task_id] = st
            # A relaunched task (retry epoch) must not inherit the old
            # epoch's host-loss attribution.
            self._domains.pop(spec.task_id, None)
        self._last_launch = time.monotonic()
        log.info("launched %s on %s", spec.task_id, host.host_id)
        return st

    def host_of(self, task_id: str) -> Optional[str]:
        with self._lock:
            st = self._tasks.get(task_id)
        return st.host.host_id if st is not None else None

    def kill_task(self, handle: object, grace_s: float = 0.0) -> None:
        if isinstance(handle, _SliceTask):
            handle.host.kill(handle.handle, grace_s=grace_s)
            # A force-killed job's logs are the diagnosis artifact; pull
            # them while the host (and lease) still exist.
            handle.host.fetch_logs(handle.handle)

    def poll_completions(self) -> List[Tuple[str, int]]:
        self._maybe_test_fail_host()
        if self.lease is not None and hasattr(self.lease, "check"):
            # Leases with an external health authority (a cloud API:
            # preemption flips the node state server-side) get it consulted
            # on the same cadence as task polling; a terminal state marks
            # every host lost and the loop below reports the tasks.
            self.lease.check()
        done: List[Tuple[str, int]] = []
        newly_done: List[_SliceTask] = []
        with self._lock:
            tasks = list(self._tasks.values())
        for st in tasks:
            if st.reported:
                continue
            rc = st.host.poll(st.handle)
            if rc is not None:
                st.reported = True
                if rc == HOST_LOST_EXIT and not st.host.alive():
                    log.warning("host %s lost; %s reported exit %d",
                                st.host.host_id, st.spec.task_id, rc)
                    # The MACHINE died, not the task: classify as
                    # PREEMPTION so the coordinator's free-retry budget
                    # applies (Backend.completion_domain contract).
                    with self._lock:
                        self._domains[st.spec.task_id] = "PREEMPTION"
                newly_done.append(st)
                done.append((st.spec.task_id, rc))
        # Bring remote stdout/stderr home BEFORE the coordinator snapshots
        # log paths into TASK_FINISHED (no-op for local channels; skipped
        # for dead hosts) — one thread per task so a whole gang finishing
        # in one poll cycle pays one fetch latency, not N.
        if len(newly_done) > 1:
            fetchers = [threading.Thread(target=st.host.fetch_logs,
                                         args=(st.handle,), daemon=True)
                        for st in newly_done]
            for t in fetchers:
                t.start()
            for t in fetchers:
                t.join(timeout=30)
        elif newly_done:
            newly_done[0].host.fetch_logs(newly_done[0].handle)
        return done

    def task_log_paths(self, task_id: str) -> Optional[Tuple[str, str]]:
        with self._lock:
            st = self._tasks.get(task_id)
        if st is None:
            return None
        return st.host.log_paths(st.handle)

    def completion_domain(self, task_id: str) -> Optional[str]:
        with self._lock:
            return self._domains.get(task_id)

    def stop(self) -> None:
        with self._lock:
            tasks = list(self._tasks.values())
        for st in tasks:
            if st.host.alive():
                st.host.kill(st.handle, grace_s=0.5)
                st.host.fetch_logs(st.handle)
        if self.lease is not None:
            self.provisioner.release(self.lease)
            self.lease = None
