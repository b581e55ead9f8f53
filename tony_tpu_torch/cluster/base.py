"""Backend abstraction: how task processes are actually started.

This replaces the reference's YARN substrate (RM container allocation
``RMCallbackHandler.onContainersAllocated`` ``ApplicationMaster.java:1051`` +
NM container launch ``ContainerLauncher.run`` :1108-1175) with a minimal
lease-style interface the coordinator drives directly:

- ``LocalProcessBackend`` (``local.py``) — subprocesses on this host; the
  MiniCluster analogue (``tony-mini/.../MiniCluster.java:43-63``) and also
  the real single-host path.
- ``GpuHostBackend`` (``gpu.py``) — gang launch over an atomically leased
  slice of GPU hosts via a ``SliceProvisioner`` (ssh inventory for real
  hosts, ``FakeSliceProvisioner`` for hardware-free e2e, incl. host-loss
  and capacity-denial fault injection).

A backend launches whole tasks-with-environments and reports exits; it knows
nothing about rendezvous, heartbeats or failure policy — those live in the
coordinator, exactly as the AM/YARN split does in the reference.
"""

from __future__ import annotations

import abc
import dataclasses
import os
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class TaskLaunchSpec:
    task_id: str
    job_name: str
    index: int
    command: str
    env: Dict[str, str]
    vcores: int = 1
    memory: str = "2g"
    chips: int = 0
    node_pool: str = ""
    docker_image: str = ""
    # Hosts this task must NOT land on (health exclude-on-retry: the
    # coordinator threads the hosts that already failed this task so a
    # relaunch never re-rolls the same bad hardware). Best-effort — a
    # backend with no alternative host may still use one.
    exclude_hosts: Tuple[str, ...] = ()


def container_name(spec: TaskLaunchSpec) -> str:
    """Deterministic docker container name for a task, so teardown can
    ``docker kill`` it by name (killing the ``docker run`` client process
    does NOT kill the container — it is containerd's child)."""
    raw = f"tony-{spec.env.get('TONY_APP_ID', 'app')}-{spec.task_id}"
    return "".join(c if c.isalnum() or c in "_.-" else "-" for c in raw)


def build_executor_argv(python: str, spec: TaskLaunchSpec,
                        workdir: str) -> list:
    """argv that launches this task's executor — wrapped in ``docker run``
    when the jobtype configures a container image (reference per-job docker
    support, ``TonyConfigurationKeys.java:178-239`` + docker env
    ``Utils.java:729-776``). Host networking keeps the rendezvous port
    contract unchanged; every task env var crosses with ``-e``; the task
    workdir, the job dir (frozen config + locally-staged bundle/resources/
    venv), and the checkpoint dir are bind-mounted at their host paths so
    localization works unchanged — with a remote store configured nothing
    but the workdir needs mounting. The image must contain python3 with
    tony-tpu installed (and, for accelerator jobs, ``jax[tpu]`` plus TPU
    device access — typically ``--privileged`` baked into a wrapper image
    or the docker daemon's default runtime on TPU VMs)."""
    from tony_tpu_torch import faults

    # Single choke point every backend passes through immediately before
    # its process spawn — the ``executor.spawn`` injection site. A firing
    # raises, launch_task propagates, and the coordinator's launch-failure
    # policy (an INFRA_TRANSIENT session failure) takes over.
    faults.check("executor.spawn")
    if not spec.docker_image:
        return [python, "-m", "tony_tpu_torch.executor"]
    argv = ["docker", "run", "--rm", "--network=host",
            "--name", container_name(spec),
            "-v", f"{workdir}:{workdir}", "-w", workdir]
    mounts = set()
    conf_path = spec.env.get("TONY_EXECUTOR_CONF", "")
    from tony_tpu_torch.storage.store import is_url

    if conf_path and not is_url(conf_path):
        mounts.add(os.path.dirname(os.path.abspath(conf_path)))
    ckpt = spec.env.get("TONY_CHECKPOINT_DIR", "")
    if ckpt and not is_url(ckpt):
        mounts.add(os.path.abspath(ckpt))
    for m in sorted(mounts):
        argv += ["-v", f"{m}:{m}"]
    for k, v in spec.env.items():
        argv += ["-e", f"{k}={v}"]
    argv += [spec.docker_image, "python3", "-m", "tony_tpu_torch.executor"]
    return argv


def docker_kill(name: str, grace_s: float = 0.0) -> None:
    """Best-effort teardown of a named task container (companion of
    build_executor_argv; see container_name). ``docker stop -t`` delivers
    TERM first and escalates to KILL after the grace window, preserving
    kill_task's TERM→grace→KILL contract for in-container checkpoint/
    cleanup handlers (bare ``docker kill`` is SIGKILL with no warning)."""
    import subprocess

    try:
        subprocess.run(
            ["docker", "stop", "-t", str(max(0, int(grace_s))), name],
            timeout=15 + grace_s,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    except Exception:  # noqa: BLE001 — teardown is best-effort
        pass


class Backend(abc.ABC):
    @abc.abstractmethod
    def launch_task(self, spec: TaskLaunchSpec) -> object:
        """Start the task; returns an opaque handle."""

    @abc.abstractmethod
    def kill_task(self, handle: object, grace_s: float = 0.0) -> None:
        """Terminate the task (SIGTERM, then SIGKILL after grace)."""

    @abc.abstractmethod
    def poll_completions(self) -> List[Tuple[str, int]]:
        """Drain (task_id, exit_code) for tasks that exited since last call.

        The analogue of YARN's ``onContainersCompleted`` callback
        (``ApplicationMaster.java:1005-1023``) — catches processes that died
        without reporting their own exit over RPC.
        """

    def task_log_paths(self, task_id: str) -> Optional[Tuple[str, str]]:
        """(stdout, stderr) paths/URLs for a task, if the backend captures
        them (the reference surfaces NodeManager log URLs per container,
        ``models/JobLog.java:69-80``)."""
        return None

    def completion_domain(self, task_id: str) -> Optional[str]:
        """Failure-domain hint for a completion this backend reported:
        ``"PREEMPTION"`` when the backend KNOWS the machine went away
        under the task (slice host lost, node state PREEMPTED) — an exit
        code alone can't distinguish that from an OOM kill. None = no
        backend knowledge; the coordinator classifies from the exit code
        (coordinator/session.py classify_exit)."""
        return None

    def host_of(self, task_id: str) -> Optional[str]:
        """Which physical host a launched task runs on, if the backend
        places tasks on distinguishable hosts (slice VMs). None = no
        host identity (local processes) — the health exclude-on-retry
        path and fleet failure attribution both no-op then."""
        return None

    def gang_active(self) -> bool:
        """Any launched task still running? Backends with gang-scoped
        resources (slice leases) override this so the coordinator's
        epoch reset can wait for the old gang to be FULLY down before
        relaunching — re-leasing under a live gang would split it across
        slices (cluster/gpu.py lease invariant)."""
        return False

    def set_tracer(self, tracer) -> None:
        """Give the backend the job's tracer so launch-path work it does
        on the coordinator's behalf (warm-pool leases) lands in the span
        tree. Default: kept but unused — emitting spans stays optional
        per backend."""
        self.tracer = tracer

    def stop(self) -> None:
        """Release backend resources."""
