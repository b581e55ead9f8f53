"""Warm executor pool: pre-spawned executors a submit adopts instead of
cold-spawning.

Counterpart of ``tony_tpu/pool.py``, torch-free like the rest of the
port's control plane, with its names, files (``ready.json``,
``lease.json``, ``pool-exit.json``, ``pool.addr``), RPC methods, generation
fencing, one lease per worker, replenishing and recycling by age kept, so
that either package's ``PoolClient`` leases from either's daemon. What the
port changes:

- the preload defaults to ``torch``, where the reference's is ``jax``; for
  ``torch`` the worker also asks ``torch.cuda.device_count()`` (the
  counterpart of ``jax.devices()``), which loads libcuda and creates no CUDA
  context: the warm worker becomes the *executor*, and a context there would
  hold card memory beside the job's own user process;
- no compile cache is mounted (the reference's ``--jax-cache-dir``): the
  port's kernels are built once per source into
  ``tony_tpu_torch/_build/<source hash>`` (``ops/_build.py``), which every
  process of the checkout already shares;
- the fleet's health-cordon file is read here (``_read_cordoned``, a copy
  of the reference's ``fleet/health.py:read_cordoned``), since the fleet is
  not ported.

The reference's account follows.

TonY paid the cold-start tax on every job — container allocation plus
HDFS localization before a single user process ran (SURVEY §1 L4). The
span-profiled cold path here shows the same shape: most of the
submit→first-step budget is interpreter boot + imports + backend init in
processes that are identical across jobs. Maple (PAPERS.md) decouples job
arrival from resource acquisition; Arax decouples jobs from the
accelerators they land on. This module is that move for executors: a
daemon keeps N **warm workers** alive — Python up, ``tony_tpu_torch`` (and
optionally torch) imported — and a ``pool.lease`` RPC hands one to a
backend at launch time.

Roles:

- **warm worker** (``python -m tony_tpu_torch.pool worker --dir D``): preloads,
  writes ``ready.json``, then polls its directory for ``lease.json``. On
  a lease it applies the task env, chdirs into the task workdir,
  redirects stdio to the task logs, and runs the ordinary
  ``TaskExecutor`` — from the coordinator's side an adopted executor is
  indistinguishable from a cold-spawned one (same registration, same
  generation fencing, same heartbeats). At exit it writes
  ``pool-exit.json`` into the task workdir (the backend's completion
  source — the process is the daemon's child, not the backend's) and
  dies. **One lease per worker, ever**: a used (or crashed, or merely
  dirty) worker is never returned to the pool; the daemon replenishes
  with a fresh spawn.
- **daemon** (``python -m tony_tpu_torch.pool serve --dir D --size N``): spawns
  and replenishes workers, serves ``pool.lease`` / ``pool.discard`` /
  ``pool.status`` / ``pool.stop`` over the ordinary RPC plane
  (rpc/wire.py, token-authenticated), and enforces hygiene: workers
  older than ``--max-lease-age-s`` are recycled, and leases carry the
  coordinator generation so a stale epoch's lease attempt is refused
  (``tony.pool.*`` conf keys; ``tony-tpu pool start/stop/status`` CLI).
- **backend adoption** (cluster/local.py): with ``tony.pool.dir`` set,
  ``launch_task`` tries a lease first and falls back to the cold spawn on
  ANY pool failure — refused lease, dead-on-adoption, stale generation,
  daemon gone (fault sites ``pool.lease`` / ``pool.adopt`` /
  ``pool.stale`` rehearse each shape deterministically). Pool trouble can
  slow a submit back to cold-start speed; it can never fail a job.

This is the LocalSim-backed seam the future cluster daemon (ROADMAP item
1) plugs into: the same lease contract, served per-host by the daemon
that also owns slice leases.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

from tony_tpu_torch import constants
from tony_tpu_torch.devtools.race import guarded

log = logging.getLogger(__name__)

#: worker-dir protocol files (all JSON, atomically replaced)
READY_FILE = "ready.json"        # worker → daemon: warm and leasable
LEASE_FILE = "lease.json"        # daemon → worker: adopt this task
ADOPTED_FILE = "adopted.json"    # worker → daemon: env applied, running
SHUTDOWN_FILE = "shutdown"       # daemon → worker: exit quietly

#: how often a warm worker polls for its lease — the adoption latency
#: floor (50 ms keeps a warm resubmit well under the 2 s budget while
#: costing ~nothing idle).
_WORKER_POLL_S = 0.05


class PoolError(RuntimeError):
    """A lease could not be granted/honoured; callers fall back to the
    cold spawn path."""


def _atomic_json(path: str, obj: dict, mode: int = 0o644) -> None:
    """Durable JSON drop: these files are the daemon↔worker handoff
    protocol (lease grant, adoption ack, exit report) — a torn write
    adopted as a valid lease or exit report corrupts a real job, so they
    get the full atomic_write discipline, not just tmp+rename."""
    from tony_tpu_torch.utils.durable import atomic_write

    atomic_write(path, json.dumps(obj).encode("utf-8"), mode=mode)


def _read_json(path: str) -> Optional[dict]:
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        return data if isinstance(data, dict) else None
    except (OSError, ValueError):
        return None


def _read_cordoned(path: str) -> Dict[str, str]:
    """Tolerant read of a cordon file: absent/torn -> empty (an absent
    fleet means nothing is cordoned)."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return {}
    hosts = doc.get("hosts") if isinstance(doc, dict) else None
    if not isinstance(hosts, dict):
        return {}
    return {str(k): str(v) for k, v in hosts.items()}


# ---------------------------------------------------------------------------
# Warm worker
# ---------------------------------------------------------------------------
def _preload(preload: str) -> List[str]:
    """Import the configured modules while idle — the whole point of being
    warm. ``torch`` additionally counts the CUDA devices (libcuda loaded,
    no context created) so an adopted executor's own tooling — and, via
    the hot OS page cache, the user process's import of the same libraries
    — starts fast. Failures are logged and skipped: a pool on a CPU-only
    host must still warm the rest."""
    import importlib

    done: List[str] = []
    # The executor module itself is always preloaded: adopting means
    # running TaskExecutor, and its transitive imports (rpc, runtimes,
    # storage) are a measurable slice of the cold spawn.
    mods = ["tony_tpu_torch.executor.executor",
            "tony_tpu_torch.runtimes.frameworks"]
    mods += [m.strip() for m in (preload or "").split(",") if m.strip()]
    for mod in mods:
        try:
            m = importlib.import_module(mod)
            if mod == "torch":
                m.cuda.device_count()    # libcuda, not a context
            done.append(mod)
        except Exception as e:  # noqa: BLE001 — warm what we can
            log.warning("preload of %s failed: %s", mod, e)
    return done


def _worker_main(worker_dir: str, preload: str) -> int:
    """Entry point of one warm worker process."""
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    started_ts = time.time()          # wall anchor for the record only
    t0 = time.monotonic()
    loaded = _preload(preload)
    _atomic_json(os.path.join(worker_dir, READY_FILE), {
        "pid": os.getpid(), "started_ts": started_ts,
        "warm_after_s": round(time.monotonic() - t0, 3),
        # Which physical host this worker warmed up on (the slice
        # backend exports it into the environment) — the lease path
        # refuses workers whose host the fleet health ledger cordoned.
        "host": os.environ.get(constants.HOST_ID_ENV, ""),
        "preloaded": loaded})
    lease_path = os.path.join(worker_dir, LEASE_FILE)
    shutdown_path = os.path.join(worker_dir, SHUTDOWN_FILE)
    while True:
        if os.path.exists(shutdown_path):
            return 0
        lease = _read_json(lease_path)
        if lease is not None:
            break
        time.sleep(_WORKER_POLL_S)

    env = {str(k): str(v) for k, v in (lease.get("env") or {}).items()}
    workdir = str(lease.get("workdir") or "")
    os.makedirs(workdir, exist_ok=True)
    os.chdir(workdir)
    # Same log placement as a cold-spawned executor (cluster/local.py):
    # the coordinator's log surfaces read the task dir, not the pool dir.
    out = os.open(os.path.join(workdir, "stdout.log"),
                  os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    err = os.open(os.path.join(workdir, "stderr.log"),
                  os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    sys.stdout.flush()
    sys.stderr.flush()
    os.dup2(out, 1)
    os.dup2(err, 2)
    os.close(out)
    os.close(err)
    os.environ.update(env)
    _atomic_json(os.path.join(worker_dir, ADOPTED_FILE), {
        "pid": os.getpid(), "task_id": env.get(constants.TASK_ID, ""),
        "adopted_ts": time.time()})
    # From here the process IS a task executor: same fault arming, same
    # signal forwarding, same run loop as `python -m tony_tpu_torch.executor`.
    from tony_tpu_torch import faults
    from tony_tpu_torch.executor.executor import TaskExecutor, _forward_signal

    faults.install_from_env()
    signal.signal(signal.SIGTERM, _forward_signal)
    signal.signal(signal.SIGINT, _forward_signal)
    try:
        code = TaskExecutor().run()
    except SystemExit as e:
        code = int(e.code or 0)
    except BaseException:  # noqa: BLE001
        log.exception("adopted executor crashed")
        code = constants.EXIT_FAILURE
    _atomic_json(os.path.join(workdir, constants.POOL_EXIT_FILE),
                 {"exit_code": int(code), "pid": os.getpid()})
    return int(code)


# ---------------------------------------------------------------------------
# Daemon
# ---------------------------------------------------------------------------
class _Worker:
    def __init__(self, worker_id: str, wdir: str, popen: subprocess.Popen):
        self.id = worker_id
        self.dir = wdir
        self.popen = popen
        self.created = time.monotonic()
        self.leased_to: str = ""       # task_id once leased
        self.lease_app: str = ""

    def ready(self) -> Optional[dict]:
        if self.leased_to or self.popen.poll() is not None:
            return None
        return _read_json(os.path.join(self.dir, READY_FILE))


class _PoolService:
    """RPC surface (rpc/wire.py namespacing: ``pool.lease`` etc.)."""

    def __init__(self, daemon: "PoolDaemon"):
        self._d = daemon

    def pool__lease(self, task_id: str, env: dict, workdir: str,
                    app_id: str = "", generation: int = 0) -> dict:
        return self._d.lease(task_id, env or {}, workdir,
                             app_id=app_id, generation=int(generation or 0))

    def pool__discard(self, worker_id: str, reason: str = "") -> bool:
        return self._d.discard(worker_id, reason)

    def pool__status(self) -> dict:
        return self._d.status()

    def pool__stop(self) -> bool:
        self._d.request_stop()
        return True


@guarded
class PoolDaemon:
    #: tonyrace registry (devtools/race.py): the worker map and the
    #: per-app generation fence are shared between the replenish loop
    #: and pool.lease/discard/status RPC threads — every touch holds
    #: the daemon lock.
    GUARDED_BY = {
        "_workers": "_lock",
        "_gen_by_app": "_lock",
    }

    def __init__(self, pool_dir: str, size: int = 2, preload: str = "torch",
                 max_lease_age_s: float = 600.0,
                 python: str = sys.executable):
        self.pool_dir = os.path.abspath(pool_dir)
        self.size = max(1, int(size))
        self.preload = preload
        self.max_lease_age_s = float(max_lease_age_s)
        self.python = python
        self._workers: Dict[str, _Worker] = {}
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        # Highest coordinator generation seen per app: a lease carrying a
        # LOWER generation comes from a zombie epoch (superseded
        # coordinator still launching) and is refused — the same fencing
        # discipline as the RPC plane (rpc/wire.py).
        self._gen_by_app: Dict[str, int] = {}
        import secrets

        self.token = secrets.token_hex(16)
        from tony_tpu_torch.rpc.wire import RpcServer

        self.rpc = RpcServer(_PoolService(self), host="127.0.0.1", port=0,
                             token=self.token)

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        os.makedirs(os.path.join(self.pool_dir, "workers"), exist_ok=True)
        self._replenish()
        self.rpc.start()
        host, port = self.rpc.address
        addr_path = os.path.join(self.pool_dir, constants.POOL_ADDR_FILE)
        # 0600 from the first byte — the file carries the RPC token
        # (same discipline as the coordinator address file).
        _atomic_json(addr_path,
                     {"host": host, "port": port, "token": self.token,
                      "pid": os.getpid(), "size": self.size}, mode=0o600)
        log.info("pool daemon up at %s:%d (%d warm executors, preload=%r)",
                 host, port, self.size, self.preload)

    def run(self) -> int:
        """Serve until pool.stop/SIGTERM; replenish as leases consume
        workers."""
        self.start()
        try:
            while not self._stop_evt.wait(0.2):
                self._replenish()
        finally:
            self._shutdown()
        return 0

    def request_stop(self) -> None:
        self._stop_evt.set()

    def _shutdown(self) -> None:
        with self._lock:
            workers = list(self._workers.values())
        for w in workers:
            if w.leased_to:
                # A leased executor belongs to a running job; killing it
                # here would fail that job from the janitor's chair.
                log.warning("pool stop: leaving leased worker %s "
                            "(task %s) to its coordinator", w.id,
                            w.leased_to)
                continue
            self._kill_worker(w)
        try:
            os.unlink(os.path.join(self.pool_dir,
                                   constants.POOL_ADDR_FILE))
        except OSError:
            pass
        self.rpc.stop()

    def _kill_worker(self, w: _Worker) -> None:
        try:
            with open(os.path.join(w.dir, SHUTDOWN_FILE), "w"):
                pass
        except OSError:
            pass
        if w.popen.poll() is None:
            try:
                os.killpg(w.popen.pid, signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                pass
        with self._lock:
            self._workers.pop(w.id, None)

    # -- worker fleet ----------------------------------------------------
    def _spawn_worker(self) -> None:
        worker_id = uuid.uuid4().hex[:8]
        wdir = os.path.join(self.pool_dir, "workers", worker_id)
        os.makedirs(wdir, exist_ok=True)
        env = dict(os.environ)
        repo_root = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))
        env["PYTHONPATH"] = (repo_root + os.pathsep +
                             env.get("PYTHONPATH", "")).rstrip(os.pathsep)
        wlog = open(os.path.join(wdir, "worker.log"), "ab")
        popen = subprocess.Popen(
            [self.python, "-m", "tony_tpu_torch.pool", "worker",
             "--dir", wdir, "--preload", self.preload],
            stdout=wlog, stderr=subprocess.STDOUT, env=env,
            start_new_session=True)
        wlog.close()
        with self._lock:
            self._workers[worker_id] = _Worker(worker_id, wdir, popen)
        log.info("spawned warm worker %s (pid %d)", worker_id, popen.pid)

    def _replenish(self) -> None:
        """Keep `size` leasable workers: reap exited/leased-and-done
        records, recycle over-age warm workers (credential/env drift
        hygiene — tony.pool.max-lease-age-s), spawn the deficit."""
        now = time.monotonic()
        stale: List[_Worker] = []
        with self._lock:
            for w in list(self._workers.values()):
                if w.popen.poll() is not None:
                    # Worker exited: either its lease completed (the task
                    # is done) or it died warming up. Either way the
                    # record is garbage — leases never return to the pool.
                    self._workers.pop(w.id)
                    continue
                if not w.leased_to and now - w.created > self.max_lease_age_s:
                    stale.append(w)
            deficit = self.size - sum(
                1 for w in self._workers.values()
                if not w.leased_to and w.popen.poll() is None)
        for w in stale:
            log.info("recycling over-age warm worker %s (%.0fs > %.0fs)",
                     w.id, now - w.created, self.max_lease_age_s)
            self._kill_worker(w)
            deficit += 0  # replacement accounted by next pass
        for _ in range(max(0, deficit)):
            self._spawn_worker()

    def _cordoned_hosts(self) -> Dict[str, str]:
        """The fleet daemon's health-cordon handshake: it atomically
        replaces health.cordon.json in this pool dir on every export
        (fleet/health.py write_cordon_file). Absent/garbled = no fleet
        or health off — nothing cordoned."""
        return _read_cordoned(os.path.join(self.pool_dir,
                                           constants.FLEET_CORDON_FILE))

    # -- RPC behaviour ---------------------------------------------------
    def lease(self, task_id: str, env: dict, workdir: str,
              app_id: str = "", generation: int = 0) -> dict:
        """Grant one warm worker to a task, or raise PoolError (the caller
        cold-spawns). The worker is marked leased BEFORE the lease file
        lands, so two concurrent submits can never adopt the same pid.
        Workers warmed on a health-cordoned host are never leased — and
        are discarded on sight (a warm import cache on bad hardware is
        worth less than the retry it would burn)."""
        now = time.monotonic()
        cordoned = self._cordoned_hosts()
        sick: List[Tuple[_Worker, str]] = []
        with self._lock:
            if generation and app_id:
                last = self._gen_by_app.get(app_id, 0)
                if generation < last:
                    raise PoolError(
                        f"stale-generation lease for {app_id}: generation "
                        f"{generation} < observed {last}")
                self._gen_by_app[app_id] = generation
            candidate: Optional[_Worker] = None
            for w in self._workers.values():
                if w.leased_to or w.popen.poll() is not None:
                    continue
                if now - w.created > self.max_lease_age_s:
                    continue          # recycled by the next replenish pass
                ready = w.ready()
                if ready is None:
                    continue          # still warming up
                if cordoned and ready.get("host") in cordoned:
                    sick.append((w, str(ready.get("host"))))
                    continue
                candidate = w
                break
            if candidate is not None:
                candidate.leased_to = task_id
                candidate.lease_app = app_id
        for w, host in sick:
            log.warning("discarding warm worker %s: its host %s is "
                        "health-cordoned", w.id, host)
            self._kill_worker(w)
        if candidate is None:
            if sick:
                raise PoolError(
                    "pool has no warm executor available (workers on "
                    "health-cordoned hosts discarded: "
                    + ", ".join(sorted(h for _, h in sick)) + ")")
            raise PoolError("pool has no warm executor available")
        lease_env = dict(env)
        lease_env[constants.POOL_WORKER_ID] = candidate.id
        _atomic_json(os.path.join(candidate.dir, LEASE_FILE),
                     {"env": lease_env, "workdir": workdir,
                      "task_id": task_id})
        # Adoption ack: the worker applied the env and is running the
        # executor. A worker that dies between the grant and the ack is a
        # dead-on-adoption lease — surfaced here, not as a job failure.
        deadline = time.monotonic() + 5.0
        adopted_path = os.path.join(candidate.dir, ADOPTED_FILE)
        while time.monotonic() < deadline:
            if os.path.exists(adopted_path):
                break
            if candidate.popen.poll() is not None:
                with self._lock:
                    self._workers.pop(candidate.id, None)
                raise PoolError(
                    f"leased executor {candidate.id} died on adoption "
                    f"(exit {candidate.popen.returncode})")
            time.sleep(0.02)
        else:
            self._kill_worker(candidate)
            raise PoolError(
                f"leased executor {candidate.id} never acknowledged "
                f"adoption")
        log.info("leased worker %s (pid %d) to %s [%s gen %d]",
                 candidate.id, candidate.popen.pid, task_id, app_id,
                 generation)
        return {"worker_id": candidate.id, "pid": candidate.popen.pid,
                "age_s": round(now - candidate.created, 3)}

    def discard(self, worker_id: str, reason: str = "") -> bool:
        """A caller observed the leased worker dead/dirty: drop and
        replace it — a discarded lease is NEVER reused."""
        with self._lock:
            w = self._workers.get(worker_id)
        if w is None:
            return False
        log.warning("discarding worker %s (%s)", worker_id,
                    reason or "caller discard")
        self._kill_worker(w)
        return True

    def status(self) -> dict:
        now = time.monotonic()
        rows = []
        ready = leased = 0
        with self._lock:
            workers = list(self._workers.values())
        for w in workers:
            info = w.ready()
            state = ("leased" if w.leased_to
                     else "ready" if info is not None
                     else "dead" if w.popen.poll() is not None
                     else "warming")
            ready += state == "ready"
            leased += state == "leased"
            rows.append({"worker": w.id, "pid": w.popen.pid,
                         "state": state,
                         "age_s": round(now - w.created, 1),
                         "task": w.leased_to,
                         "preloaded": (info or {}).get("preloaded", [])})
        return {"pool_dir": self.pool_dir, "size": self.size,
                "ready": ready, "leased": leased, "workers": rows}


# ---------------------------------------------------------------------------
# Client helper (backends + CLI)
# ---------------------------------------------------------------------------
class PoolClient:
    """Thin lease client over the pool address file. Deliberately
    short-fused: the pool is an optimization, so a dead/absent daemon must
    cost milliseconds, not retry budgets — callers treat any failure as
    'cold spawn instead'."""

    def __init__(self, pool_dir: str):
        self.pool_dir = os.path.abspath(os.path.expanduser(pool_dir))
        self._rpc = None

    def _client(self):
        if self._rpc is None:
            addr = _read_json(os.path.join(self.pool_dir,
                                           constants.POOL_ADDR_FILE))
            if not addr:
                raise PoolError(f"no pool running under {self.pool_dir}")
            from tony_tpu_torch.rpc.wire import RpcClient

            self._rpc = RpcClient(addr["host"], int(addr["port"]),
                                  token=addr.get("token") or None,
                                  max_retries=1, retry_sleep_s=0.1,
                                  connect_timeout_s=2.0,
                                  call_timeout_s=10.0,
                                  peer="pool")
        return self._rpc

    def call(self, method: str, **args):
        try:
            return self._client().call(method, **args)
        except PoolError:
            raise
        except Exception as e:  # noqa: BLE001 — normalize transport errors
            self.close()
            raise PoolError(f"pool rpc {method} failed: {e}") from e

    def lease(self, task_id: str, env: Dict[str, str], workdir: str,
              app_id: str = "", generation: int = 0) -> dict:
        res = self.call("pool.lease", task_id=task_id, env=dict(env),
                        workdir=workdir, app_id=app_id,
                        generation=generation)
        if not isinstance(res, dict) or "pid" not in res:
            raise PoolError(f"malformed lease response: {res!r}")
        return res

    def discard(self, worker_id: str, reason: str = "") -> None:
        try:
            self.call("pool.discard", worker_id=worker_id, reason=reason)
        except PoolError:
            pass                      # best-effort: daemon may be gone

    def close(self) -> None:
        if self._rpc is not None:
            try:
                self._rpc.close()
            except Exception:  # noqa: BLE001
                pass
            self._rpc = None


# ---------------------------------------------------------------------------
# Entrypoint
# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tony-tpu-pool")
    sub = p.add_subparsers(dest="role", required=True)
    s = sub.add_parser("serve", help="run the pool daemon (foreground)")
    s.add_argument("--dir", required=True)
    s.add_argument("--size", type=int, default=2)
    s.add_argument("--preload", default="torch")
    s.add_argument("--max-lease-age-s", type=float, default=600.0)
    w = sub.add_parser("worker", help="run one warm worker (internal)")
    w.add_argument("--dir", required=True)
    w.add_argument("--preload", default="torch")
    args = p.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    if args.role == "worker":
        return _worker_main(args.dir, args.preload)
    daemon = PoolDaemon(args.dir, size=args.size, preload=args.preload,
                        max_lease_age_s=args.max_lease_age_s)
    signal.signal(signal.SIGTERM, lambda *_: daemon.request_stop())
    signal.signal(signal.SIGINT, lambda *_: daemon.request_stop())
    return daemon.run()


if __name__ == "__main__":
    sys.exit(main())
