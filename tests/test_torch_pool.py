"""Port parity: the warm executor pool (``tony_tpu_torch/pool.py``) and
the local backend's adoption path (``tony_tpu_torch/cluster/local.py``).

The twenty cases of ``tests/test_pool.py``, run through the port: lease
grants, generation fencing, dead-on-adoption, the pool.* fault sites, the
_LeasedProc exit-report contract, and the protocol round trip with real
warm workers (``preload=""``, as there). The port's preload default is
``torch`` where the reference's is ``jax``. One check across the packages:
the reference's ``PoolClient`` leases from the port's daemon, since the
wire format and the worker-directory protocol are kept. The multi-job
drills are ``tests/test_torch_e2e_pool.py``. Select with ``pytest -m
faults``.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import types

import pytest

from tony_tpu_torch import constants, faults, tracing
from tony_tpu_torch import pool as pool_mod
from tony_tpu_torch.cluster.base import TaskLaunchSpec
from tony_tpu_torch.cluster.local import LocalProcessBackend, _LeasedProc, _Proc
from tony_tpu_torch.pool import (ADOPTED_FILE, LEASE_FILE, READY_FILE,
                           PoolClient, PoolDaemon, PoolError, _Worker)

pytestmark = pytest.mark.faults


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.uninstall()
    yield
    faults.uninstall()


def _spec(task_id="worker:0", env=None):
    return TaskLaunchSpec(task_id=task_id, job_name="worker", index=0,
                          command="true", env=dict(env or {}))


def _fake_worker(tmp_path, worker_id="w1", pid=4242, poll_results=None,
                 ready=True, adopted=False):
    """A _Worker whose popen is a stub: ``poll_results`` is consumed one
    per poll() call (None = alive), last value sticks."""
    wdir = str(tmp_path / "workers" / worker_id)
    os.makedirs(wdir, exist_ok=True)
    if ready:
        with open(os.path.join(wdir, READY_FILE), "w") as f:
            json.dump({"pid": pid, "preloaded": []}, f)
    if adopted:
        with open(os.path.join(wdir, ADOPTED_FILE), "w") as f:
            json.dump({"pid": pid}, f)
    results = list(poll_results or [None])

    def poll():
        if len(results) > 1:
            return results.pop(0)
        return results[0]

    popen = types.SimpleNamespace(poll=poll, pid=pid, returncode=None)
    return _Worker(worker_id, wdir, popen)


def _daemon_with(tmp_path, *workers, **kw):
    """A PoolDaemon that never spawns real processes (the RPC server is
    constructed but not started)."""
    d = PoolDaemon(str(tmp_path), size=len(workers) or 1, preload="", **kw)
    for w in workers:
        d._workers[w.id] = w
    return d


# ---------------------------------------------------------------------------
# Fault-site + conf-key registration
# ---------------------------------------------------------------------------
def test_pool_fault_sites_registered():
    for site in ("pool.lease", "pool.stale", "pool.adopt"):
        assert site in faults.SITES
    inj = faults.FaultInjector({"pool.lease": "first:1",
                                "pool.adopt": "first:1"})
    assert inj.fire("pool.lease") and inj.fire("pool.adopt")
    assert not inj.fire("pool.stale")


def test_pool_conf_keys_registered():
    from tony_tpu_torch.conf import keys as K
    from tony_tpu_torch.conf.config import TonyTpuConfig

    conf = TonyTpuConfig()
    assert conf.get(K.POOL_DIR) == ""
    assert conf.get_int(K.POOL_SIZE, 0) == 2
    assert conf.get_int(K.POOL_MAX_LEASE_AGE_S, 0) == 600
    assert str(conf.get(K.POOL_PRELOAD)) == "torch"


# ---------------------------------------------------------------------------
# Daemon lease semantics (stubbed workers — no subprocesses)
# ---------------------------------------------------------------------------
def test_lease_grants_ready_worker_and_marks_it_leased(tmp_path):
    w = _fake_worker(tmp_path, adopted=True)
    d = _daemon_with(tmp_path, w)
    res = d.lease("worker:0", {"A": "1"}, str(tmp_path / "task"),
                  app_id="app1", generation=3)
    assert res["worker_id"] == "w1" and res["pid"] == 4242
    assert w.leased_to == "worker:0"
    lease = json.load(open(os.path.join(w.dir, LEASE_FILE)))
    assert lease["env"]["A"] == "1"
    # the daemon stamps the worker id into the lease env (the adopted
    # executor's span marker)
    assert lease["env"][constants.POOL_WORKER_ID] == "w1"
    # a leased worker is never granted twice
    with pytest.raises(PoolError, match="no warm executor"):
        d.lease("worker:1", {}, str(tmp_path / "task2"))


def test_lease_refuses_stale_generation(tmp_path):
    w = _fake_worker(tmp_path, adopted=True)
    d = _daemon_with(tmp_path, w)
    d.lease("worker:0", {}, str(tmp_path / "t"), app_id="app1",
            generation=5)
    # a LOWER generation for the same app is a zombie epoch — refused
    # before any worker is considered
    with pytest.raises(PoolError, match="stale-generation"):
        d.lease("worker:0", {}, str(tmp_path / "t2"), app_id="app1",
                generation=3)
    # an unrelated app's fencing is independent
    w2 = _fake_worker(tmp_path, worker_id="w2", adopted=True)
    d._workers[w2.id] = w2
    d.lease("worker:0", {}, str(tmp_path / "t3"), app_id="app2",
            generation=1)


def test_lease_skips_warming_and_overage_workers(tmp_path):
    warming = _fake_worker(tmp_path, worker_id="cold", ready=False)
    d = _daemon_with(tmp_path, warming)
    with pytest.raises(PoolError, match="no warm executor"):
        d.lease("worker:0", {}, str(tmp_path / "t"))
    old = _fake_worker(tmp_path, worker_id="old", adopted=True)
    old.created -= 10_000
    d._workers[old.id] = old
    with pytest.raises(PoolError, match="no warm executor"):
        d.lease("worker:0", {}, str(tmp_path / "t"))


def test_lease_detects_worker_dead_before_ack(tmp_path):
    # alive through candidate selection (the direct poll + the one inside
    # ready()), dead in the ack loop, no adopted.json
    w = _fake_worker(tmp_path, poll_results=[None, None, 1], adopted=False)
    w.popen.returncode = 1
    d = _daemon_with(tmp_path, w)
    with pytest.raises(PoolError, match="died on adoption"):
        d.lease("worker:0", {}, str(tmp_path / "t"))
    # the dead record is dropped, never handed out again
    assert "w1" not in d._workers


def test_discard_drops_worker_permanently(tmp_path):
    w = _fake_worker(tmp_path, adopted=True)
    d = _daemon_with(tmp_path, w)
    d.lease("worker:0", {}, str(tmp_path / "t"))
    assert d.discard("w1", reason="caller saw it dead") is True
    assert "w1" not in d._workers
    assert d.discard("w1") is False     # idempotent on unknown ids


def test_status_reports_fleet_states(tmp_path):
    ready = _fake_worker(tmp_path, worker_id="rdy", adopted=True)
    warming = _fake_worker(tmp_path, worker_id="cold", pid=4243,
                           ready=False)
    d = _daemon_with(tmp_path, ready, warming)
    d.lease("worker:0", {}, str(tmp_path / "t"))
    st = d.status()
    states = {r["worker"]: r["state"] for r in st["workers"]}
    assert states == {"rdy": "leased", "cold": "warming"}
    assert st["leased"] == 1 and st["ready"] == 0


# ---------------------------------------------------------------------------
# Elastic grow-back rides the warm path (ROADMAP carried thread): a
# resize-up's fresh launches go through the SAME backend.launch_task →
# pool.lease path as the initial gang, at the same coordinator
# generation — so regrow adopts warm workers instead of cold-spawning.
# ---------------------------------------------------------------------------
def test_grow_back_second_wave_leases_at_same_generation(tmp_path):
    """The grow wave of an elastic resize bumps the MEMBERSHIP
    generation, not the coordinator generation: the pool daemon's
    per-app fence (which tracks coordinator generations) must grant the
    second wave at the unchanged generation — and still refuse a true
    zombie epoch's lower one."""
    w1 = _fake_worker(tmp_path, worker_id="w1", pid=4242, adopted=True)
    w2 = _fake_worker(tmp_path, worker_id="w2", pid=4243, adopted=True)
    d = _daemon_with(tmp_path, w1, w2)
    first = d.lease("worker:0", {}, str(tmp_path / "t0"),
                    app_id="app1", generation=2)
    assert first["worker_id"] == "w1"
    # ...time passes, a host is lost and grown back: same app, same
    # coordinator generation, new task index — the grow-back lease
    grow = d.lease("worker:2", {}, str(tmp_path / "t2"),
                   app_id="app1", generation=2)
    assert grow["worker_id"] == "w2"
    # a superseded (pre-recovery) coordinator's lease stays fenced
    with pytest.raises(PoolError):
        d.lease("worker:3", {}, str(tmp_path / "t3"),
                app_id="app1", generation=1)


def test_grow_back_backend_wave_adopts_warm_workers(tmp_path):
    """Backend-level half of the grow-back contract: a SECOND wave of
    launch_task calls (what Coordinator._apply_remesh issues for the
    grown members, via the shared _launch_task path) adopts from the
    pool exactly like the first wave — the handle is a _LeasedProc, no
    cold spawn."""
    grants = [{"worker_id": "w1", "pid": os.getpid()},
              {"worker_id": "w2", "pid": os.getpid()}]

    class _WaveStub(_StubPool):
        def lease(self, task_id, env, workdir, app_id="", generation=0):
            self.leases.append((task_id, app_id, generation))
            return dict(grants[len(self.leases) - 1])

    stub = _WaveStub()
    b = _backend(tmp_path, stub)
    env = {constants.APP_ID: "app1",
           constants.COORDINATOR_GENERATION: "3"}
    first = b._try_pool_lease(_spec("worker:0", env=env),
                              str(tmp_path / "t0"), env)
    # the grow wave launches a NEW index at the same generation
    grow = b._try_pool_lease(_spec("worker:2", env=env),
                             str(tmp_path / "t2"), env)
    assert isinstance(first.popen, _LeasedProc)
    assert isinstance(grow.popen, _LeasedProc)
    assert grow.popen.worker_id == "w2"
    assert stub.leases == [("worker:0", "app1", 3),
                           ("worker:2", "app1", 3)]


# ---------------------------------------------------------------------------
# Backend adoption path (cluster/local.py) — every failure cold-spawns
# ---------------------------------------------------------------------------
class _StubPool:
    def __init__(self, lease_result=None, lease_exc=None):
        self.lease_result = lease_result
        self.lease_exc = lease_exc
        self.leases = []
        self.discards = []
        self.confirms = []

    def lease(self, task_id, env, workdir, app_id="", generation=0):
        self.leases.append((task_id, app_id, generation))
        # the port's backend fences every lease it asks for
        assert env[constants.POOL_CONFIRM] == "1"
        if self.lease_exc is not None:
            raise self.lease_exc
        return dict(self.lease_result)

    def confirm(self, worker_id):
        self.confirms.append(worker_id)

    def discard(self, worker_id, reason=""):
        self.discards.append((worker_id, reason))


def _backend(tmp_path, stub):
    b = LocalProcessBackend(str(tmp_path / "work"))
    b._pool = stub
    return b


def test_adoption_refused_lease_falls_back_to_cold(tmp_path):
    b = _backend(tmp_path, _StubPool(lease_exc=PoolError("pool empty")))
    assert b._try_pool_lease(_spec(), str(tmp_path / "t"), {}) is None


def test_adoption_fault_site_pool_lease_preempts_rpc(tmp_path):
    stub = _StubPool(lease_result={"worker_id": "w1", "pid": os.getpid()})
    b = _backend(tmp_path, stub)
    faults.install(faults.FaultInjector({"pool.lease": "first:1"}))
    assert b._try_pool_lease(_spec(), str(tmp_path / "t"), {}) is None
    assert stub.leases == []            # fault fires BEFORE the RPC
    # next launch (fault exhausted) adopts
    proc = b._try_pool_lease(_spec(), str(tmp_path / "t"), {})
    assert isinstance(proc, _Proc)
    assert isinstance(proc.popen, _LeasedProc)
    assert proc.popen.worker_id == "w1"


def test_adoption_dead_on_arrival_discards_and_falls_back(tmp_path):
    # a real dead pid: spawn-and-reap so the pid cannot be recycled yet
    child = subprocess.Popen([sys.executable, "-c", "pass"])
    child.wait()
    stub = _StubPool(lease_result={"worker_id": "w9", "pid": child.pid})
    b = _backend(tmp_path, stub)
    assert b._try_pool_lease(_spec(), str(tmp_path / "t"), {}) is None
    assert stub.discards and stub.discards[0][0] == "w9"


def test_adoption_fault_site_pool_adopt_discards_and_falls_back(tmp_path):
    stub = _StubPool(lease_result={"worker_id": "w2", "pid": os.getpid()})
    b = _backend(tmp_path, stub)
    faults.install(faults.FaultInjector({"pool.adopt": "first:1"}))
    assert b._try_pool_lease(_spec(), str(tmp_path / "t"), {}) is None
    assert stub.discards and stub.discards[0][0] == "w2"
    assert "dead on adoption" in stub.discards[0][1]
    assert stub.confirms == []          # a discarded lease is never confirmed


def test_adoption_forwards_generation_and_emits_span(tmp_path):
    stub = _StubPool(lease_result={"worker_id": "w3", "pid": os.getpid(),
                                   "age_s": 1.5})
    b = _backend(tmp_path, stub)
    path = str(tmp_path / "trace.spans.jsonl")
    b.set_tracer(tracing.Tracer(service="coordinator", path=path))
    env = {constants.APP_ID: "app7",
           constants.COORDINATOR_GENERATION: "4",
           constants.TRACE_PARENT_ENV: "deadbeef"}
    spec = _spec(env=env)
    proc = b._try_pool_lease(spec, str(tmp_path / "t"), env)
    assert proc is not None
    assert stub.leases == [("worker:0", "app7", 4)]
    recs = tracing.load_records(path)
    lease_spans = [r for r in recs if r.get("name") == "pool.lease"]
    assert len(lease_spans) == 1
    assert lease_spans[0]["parent"] == "deadbeef"
    assert lease_spans[0]["args"]["worker"] == "w3"
    assert "error" not in lease_spans[0]["args"]
    assert stub.confirms == ["w3"]


def test_adoption_failure_span_carries_error(tmp_path):
    b = _backend(tmp_path, _StubPool(lease_exc=PoolError("refused")))
    path = str(tmp_path / "trace.spans.jsonl")
    b.set_tracer(tracing.Tracer(service="coordinator", path=path))
    assert b._try_pool_lease(_spec(), str(tmp_path / "t"), {}) is None
    recs = tracing.load_records(path)
    assert [r["args"].get("error") for r in recs
            if r.get("name") == "pool.lease"] == ["refused"]


# ---------------------------------------------------------------------------
# _LeasedProc: the exit-report contract for a process that is not ours
# ---------------------------------------------------------------------------
def test_leased_proc_reads_exit_report(tmp_path):
    p = _LeasedProc(os.getpid(), str(tmp_path), "w1")
    assert p.poll() is None             # alive, no report yet
    with open(os.path.join(str(tmp_path), constants.POOL_EXIT_FILE),
              "w") as f:
        json.dump({"exit_code": 3}, f)
    assert p.poll() == 3
    assert p.poll() == 3                # sticky


def test_leased_proc_dead_without_report_reads_as_sigkill(tmp_path):
    """A pooled executor that vanishes without its exit report must look
    like a signal kill (cold-spawn waitpid semantics), NOT a user exit 1:
    poll_completions maps -9 → 137 → INFRA_TRANSIENT, keeping the kill
    retryable."""
    child = subprocess.Popen([sys.executable, "-c", "pass"])
    child.wait()
    p = _LeasedProc(child.pid, str(tmp_path), "w1")
    assert p.poll() == -int(signal.SIGKILL)
    b = LocalProcessBackend(str(tmp_path / "work"))
    b._procs["worker:0"] = _Proc("worker:0", p, str(tmp_path))
    assert b.poll_completions() == [("worker:0", 137)]


# ---------------------------------------------------------------------------
# Worker protocol round trip (two real subprocesses, no jax preload)
# ---------------------------------------------------------------------------
@pytest.mark.timeout_s(120)
def test_daemon_worker_lease_round_trip(tmp_path):
    """The real protocol end to end: daemon spawns a warm worker, a
    PoolClient leases it over RPC, the worker applies the lease env and
    runs the executor (which fails fast here — no coordinator), and its
    exit lands in pool-exit.json where _LeasedProc finds it. Also covers
    pool.status/pool.stop RPCs and addr-file hygiene."""
    pool_dir = str(tmp_path / "pool")
    daemon = PoolDaemon(pool_dir, size=1, preload="", max_lease_age_s=600)
    t = threading.Thread(target=daemon.run, daemon=True)
    t.start()
    try:
        client = PoolClient(pool_dir)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                if client.call("pool.status")["ready"] >= 1:
                    break
            except PoolError:
                pass
            time.sleep(0.2)
        else:
            raise AssertionError("no warm worker became ready")
        task_dir = str(tmp_path / "task")
        # No coordinator env → the adopted TaskExecutor fails fast, which
        # is exactly what exercises the exit-report path.
        lease = client.lease("worker:0", {"TONY_TASK_ID": "worker:0"},
                             task_dir, app_id="appX", generation=1)
        assert lease["worker_id"] and lease["pid"] > 0
        leased = _LeasedProc(lease["pid"], task_dir, lease["worker_id"])
        deadline = time.monotonic() + 60
        while leased.poll() is None and time.monotonic() < deadline:
            time.sleep(0.1)
        rc = leased.poll()
        assert rc is not None and rc != 0
        report = json.load(open(os.path.join(task_dir,
                                             constants.POOL_EXIT_FILE)))
        assert report["exit_code"] == rc and report["pid"] == lease["pid"]
        # stdio was redirected into the task dir like a cold spawn's
        assert os.path.exists(os.path.join(task_dir, "stderr.log"))
        assert client.call("pool.stop") is True
        client.close()
    finally:
        daemon.request_stop()
        t.join(timeout=30)
    assert not t.is_alive()
    assert not os.path.exists(os.path.join(pool_dir,
                                           constants.POOL_ADDR_FILE))


def _wait_ready(client, n=1, timeout_s=60):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            if client.call("pool.status")["ready"] >= n:
                return
        except PoolError:
            pass
        time.sleep(0.2)
    raise AssertionError("no warm worker became ready")


@pytest.mark.timeout_s(120)
def test_fenced_lease_runs_its_executor_only_once_confirmed(tmp_path):
    """The port's lease fence (``TONY_POOL_CONFIRM``): a leased worker
    acknowledges the lease, then waits for the adopter. Discarded, it
    exits having started no executor and writes no exit report into the
    task dir (where the cold spawn that replaces it runs); confirmed, it
    runs the executor as an unfenced lease does."""
    pool_dir = str(tmp_path / "pool")
    daemon = PoolDaemon(pool_dir, size=1, preload="", max_lease_age_s=600)
    t = threading.Thread(target=daemon.run, daemon=True)
    t.start()
    fenced = {"TONY_TASK_ID": "worker:0", constants.POOL_CONFIRM: "1"}
    try:
        client = PoolClient(pool_dir)
        _wait_ready(client)
        dropped_dir = str(tmp_path / "dropped")
        lease = client.lease("worker:0", fenced, dropped_dir,
                             app_id="appF", generation=1)
        # acknowledged but waiting: alive, and no executor has run
        time.sleep(0.5)
        os.kill(lease["pid"], 0)
        with daemon._lock:
            popen = daemon._workers[lease["worker_id"]].popen
        client.discard(lease["worker_id"], reason="adoption check failed")
        popen.wait(timeout=30)        # this process is the daemon: reap it
        assert not os.path.exists(os.path.join(dropped_dir,
                                               constants.POOL_EXIT_FILE))
        with open(os.path.join(dropped_dir, "stderr.log")) as f:
            assert "TaskExecutor" not in f.read()

        _wait_ready(client)           # the replenished worker
        task_dir = str(tmp_path / "task")
        lease = client.lease("worker:0", fenced, task_dir,
                             app_id="appF", generation=1)
        client.confirm(lease["worker_id"])
        leased = _LeasedProc(lease["pid"], task_dir, lease["worker_id"])
        deadline = time.monotonic() + 60
        while leased.poll() is None and time.monotonic() < deadline:
            time.sleep(0.1)
        rc = leased.poll()
        assert rc is not None and rc != 0   # no coordinator: fails fast
        with open(os.path.join(task_dir, constants.POOL_EXIT_FILE)) as f:
            assert json.load(f)["pid"] == lease["pid"]
        assert client.call("pool.stop") is True
        client.close()
    finally:
        daemon.request_stop()
        t.join(timeout=30)
    assert not t.is_alive()


@pytest.mark.timeout_s(120)
def test_replenish_recycles_overage_worker(tmp_path):
    """Hygiene: a warm worker older than max-lease-age is recycled, and
    the fleet is topped back up — tony.pool.max-lease-age-s bounds
    credential/env drift between pool start and adoption."""
    pool_dir = str(tmp_path / "pool")
    daemon = PoolDaemon(pool_dir, size=1, preload="",
                        max_lease_age_s=0.5)
    t = threading.Thread(target=daemon.run, daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 60
        first_pid = None
        while time.monotonic() < deadline:
            with daemon._lock:
                ids = {w.id: w.popen.pid for w in daemon._workers.values()}
            if ids and first_pid is None:
                first_pid = list(ids.values())[0]
            if first_pid is not None and ids \
                    and first_pid not in ids.values():
                break                   # recycled and replaced
            time.sleep(0.2)
        else:
            raise AssertionError("over-age worker was never recycled")
    finally:
        daemon.request_stop()
        t.join(timeout=30)


# ---------------------------------------------------------------------------
# Across the packages: the wire format is the reference's
# ---------------------------------------------------------------------------
@pytest.mark.timeout_s(120)
def test_reference_client_leases_from_the_port_daemon(tmp_path):
    """The reference's ``PoolClient`` reads the port daemon's
    ``pool.addr``, calls ``pool.status`` and ``pool.lease`` over its own
    RPC client, and the leased port worker runs the port's executor (its
    exit report lands where the reference's ``_LeasedProc`` reads it)."""
    from tony_tpu import pool as jpool
    from tony_tpu.cluster.local import _LeasedProc as JLeasedProc

    pool_dir = str(tmp_path / "pool")
    daemon = PoolDaemon(pool_dir, size=1, preload="", max_lease_age_s=600)
    t = threading.Thread(target=daemon.run, daemon=True)
    t.start()
    try:
        client = jpool.PoolClient(pool_dir)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                if client.call("pool.status")["ready"] >= 1:
                    break
            except jpool.PoolError:
                pass
            time.sleep(0.2)
        else:
            raise AssertionError("no warm worker became ready")
        st = client.call("pool.status")
        assert st["size"] == 1 and st["pool_dir"] == daemon.pool_dir
        assert "tony_tpu_torch.executor.executor" in \
            st["workers"][0]["preloaded"]
        task_dir = str(tmp_path / "task")
        lease = client.lease("worker:0", {"TONY_TASK_ID": "worker:0"},
                             task_dir, app_id="appJ", generation=2)
        leased = JLeasedProc(lease["pid"], task_dir, lease["worker_id"])
        deadline = time.monotonic() + 60
        while leased.poll() is None and time.monotonic() < deadline:
            time.sleep(0.1)
        assert leased.poll() not in (None, 0)
        with open(os.path.join(task_dir, constants.POOL_EXIT_FILE)) as f:
            assert json.load(f)["pid"] == lease["pid"]
        # the fence is the daemon's, whoever's client asks
        with pytest.raises(jpool.PoolError, match="stale-generation"):
            client.lease("worker:1", {}, str(tmp_path / "t2"),
                         app_id="appJ", generation=1)
        assert client.call("pool.stop") is True
        client.close()
    finally:
        daemon.request_stop()
        t.join(timeout=30)
    assert not t.is_alive()
