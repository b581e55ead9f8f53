"""Runtime lock sanitizer: lock-order graph + hold-while-blocking hazards.

TF-Replicator and Podracer (PAPERS.md) both observe that control-plane
concurrency bugs — not numerics — dominate orchestrator failures, and the
static side of that insurance (tonylint's ``lock-blocking`` rule) can only
see lexical ``with self._lock:`` blocks. This module watches the REAL
locks at runtime:

- **lock-order graph**: every time a thread acquires lock B while holding
  lock A, the edge (A → B) is recorded, keyed by the locks' allocation
  sites (``file:line`` of the ``threading.Lock()`` call). A cycle in that
  graph is a potential deadlock even if the interleaving that would
  deadlock never happened in this run — the classic lock-order-inversion
  detector (TSan's deadlock detector, ordered-lock disciplines).
- **hold-while-blocking hazards**: a thread that calls a blocking
  primitive (``time.sleep``, ``os.fsync``, ``subprocess.Popen.wait``,
  ``threading.Event.wait``, ``socket.create_connection``) while holding
  any sanitized lock stalls every other thread that needs that lock —
  the exact shape that turned a one-caller RPC outage into a stalled
  heartbeat thread (rpc/wire.py's old backoff-under-lock).

Scope: only locks ALLOCATED from ``tony_tpu_torch`` code are sanitized — the
factory inspects the allocating frame, so stdlib internals (queue,
logging, threading.Event's own condition) and third-party libraries
(jax!) keep raw primitives and zero overhead. Blocking-primitive patches
cost one thread-local read when no sanitized lock is held.

Enablement: ``TONY_LOCK_SANITIZER=1`` in the environment (checked at
``import tony_tpu_torch`` so executor/coordinator subprocesses inherit it), or
``enable()`` directly. ``tests/conftest.py`` turns it on for the whole
tier-1 suite and fails the session on any cycle or hazard. With
``TONY_LOCK_SANITIZER_DIR`` set, a process with findings dumps them there
at exit so multi-process e2e drills aggregate into the same verdict.

Unit tests construct an isolated :class:`State` and wrap locks through
:func:`sanitize_lock` directly — no global patching, no cross-test bleed.
"""

from __future__ import annotations

import _thread
import atexit
import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple

ENV_FLAG = "TONY_LOCK_SANITIZER"
ENV_DIR = "TONY_LOCK_SANITIZER_DIR"

#: cap stored hazards/edges so a pathological loop cannot eat the heap
_MAX_HAZARDS = 200


def _site_of_frame(depth: int = 2, any_file: bool = False) -> Optional[str]:
    """Allocation/call site ``relpath:line`` if the frame is tony_tpu_torch
    code (excluding this module), else None — or, with ``any_file``, the
    raw ``basename:line`` of whatever frame called (hazard labels)."""
    try:
        f = sys._getframe(depth)
    except ValueError:
        return None
    while f is not None:
        fn = f.f_code.co_filename
        if not fn.endswith(os.path.join("devtools", "sanitizer.py")):
            break
        f = f.f_back
    if f is None:
        return None
    fn = f.f_code.co_filename
    if "tony_tpu_torch" not in fn:
        if any_file:
            return f"{os.path.basename(fn)}:{f.f_lineno}"
        return None
    idx = fn.rfind("tony_tpu_torch")
    return f"{fn[idx:]}:{f.f_lineno}"


class State:
    """All sanitizer bookkeeping. The module keeps one global instance;
    tests build their own for isolation."""

    def __init__(self) -> None:
        # Raw primitives on purpose: the sanitizer must never sanitize
        # its own internals.
        self._mu = _REAL_LOCK()
        self._tls = threading.local()
        #: (site_a, site_b) -> one example {thread, blocking site}
        self.edges: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self.hazards: List[Dict[str, Any]] = []
        self._hazard_keys: Set[Tuple[str, str, Tuple[str, ...]]] = set()
        self.lock_sites: Set[str] = set()
        #: race-detector hookup (devtools/race.py RaceState, duck-typed
        #: to avoid the circular import): final lock release publishes a
        #: happens-before edge (``send``), first acquire receives one
        #: (``recv``), and the race detector reads locksets off
        #: :meth:`held_locks`.
        self.race: Optional[Any] = None

    # -- held-lock bookkeeping (thread-local) ----------------------------
    def _held(self) -> List[List[Any]]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def held_locks(self) -> Tuple[Any, ...]:
        """The calling thread's current lockset (wrapper objects, outer-
        most first) — the race detector's per-access lockset source."""
        held = getattr(self._tls, "held", None)
        if not held:
            return ()
        return tuple(entry[0] for entry in held)

    def note_acquired(self, lock: "SanitizedLock") -> None:
        held = self._held()
        for entry in held:
            if entry[0] is lock:
                entry[2] += 1           # reentrant re-acquire: no edge
                return
        new_edges = []
        for entry in held:
            a = entry[1]
            if a != lock.site:
                new_edges.append((a, lock.site))
        held.append([lock, lock.site, 1])
        if new_edges:
            with self._mu:
                for edge in new_edges:
                    self.edges.setdefault(edge, {
                        "thread": threading.current_thread().name,
                        "at": _site_of_frame(3) or "?"})
        if self.race is not None:
            self.race.recv(lock)        # release→acquire HB edge (in)

    def note_released(self, lock: "SanitizedLock") -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is lock:
                held[i][2] -= 1
                if held[i][2] <= 0:
                    if self.race is not None:
                        # Final release: publish everything this thread
                        # did while holding (release→acquire HB edge).
                        self.race.send(lock)
                    del held[i]
                return

    def register_lock(self, site: str) -> None:
        with self._mu:
            self.lock_sites.add(site)

    # -- blocking-primitive intake ---------------------------------------
    def note_blocking(self, what: str, where: Optional[str] = None) -> None:
        """Record a hazard if the calling thread holds any sanitized
        lock. ``where`` defaults to the caller's tony_tpu_torch call site.

        Blocking issued by stdlib primitive INTERNALS is exempt: a
        ``Thread.start()`` waits (bounded, microseconds) on the new
        thread's boot event, and ``Popen.wait`` polls with internal
        sleeps — those are implementation details of calls the holder
        made, not independent blocking the holder wrote. (The outer
        ``Popen.wait`` call itself is still caught at the caller's
        frame.)"""
        held = getattr(self._tls, "held", None)
        if not held:
            return
        if where is None:
            where = _site_of_frame(2, any_file=True) or "?"
            if where.rsplit(":", 1)[0] in ("threading.py",
                                           "subprocess.py"):
                return
        sites = tuple(sorted({e[1] for e in held}))
        key = (what, where, sites)
        with self._mu:
            if key in self._hazard_keys or \
                    len(self.hazards) >= _MAX_HAZARDS:
                return
            self._hazard_keys.add(key)
            self.hazards.append({
                "blocking": what, "where": where, "held": list(sites),
                "thread": threading.current_thread().name})

    # -- reporting -------------------------------------------------------
    def cycles(self) -> List[List[str]]:
        """Cycles in the lock-order site graph (each reported once,
        rotated to its lexicographically-smallest node)."""
        with self._mu:
            graph: Dict[str, Set[str]] = {}
            for a, b in self.edges:
                graph.setdefault(a, set()).add(b)
                graph.setdefault(b, set())
        seen_cycles: Set[Tuple[str, ...]] = set()
        out: List[List[str]] = []
        WHITE, GRAY, BLACK = 0, 1, 2
        color = {n: WHITE for n in graph}
        stack: List[str] = []

        def visit(n: str) -> None:
            color[n] = GRAY
            stack.append(n)
            for m in sorted(graph[n]):
                if color[m] == GRAY:
                    cyc = stack[stack.index(m):]
                    k = min(range(len(cyc)), key=lambda i: cyc[i])
                    canon = tuple(cyc[k:] + cyc[:k])
                    if canon not in seen_cycles:
                        seen_cycles.add(canon)
                        out.append(list(canon))
                elif color[m] == WHITE:
                    visit(m)
            stack.pop()
            color[n] = BLACK

        for n in sorted(graph):
            if color[n] == WHITE:
                visit(n)
        return out

    def report(self) -> Dict[str, Any]:
        with self._mu:
            hazards = list(self.hazards)
            n_edges = len(self.edges)
            n_locks = len(self.lock_sites)
        return {"pid": os.getpid(), "cycles": self.cycles(),
                "hazards": hazards, "edges": n_edges,
                "locks_sanitized": n_locks}

    def clear(self) -> None:
        with self._mu:
            self.edges.clear()
            self.hazards.clear()
            self._hazard_keys.clear()


class SanitizedLock:
    """Duck-typed Lock/RLock wrapper feeding a :class:`State`. Supports
    the full primitive surface tony_tpu_torch uses: acquire/release, context
    manager, ``locked()``."""

    def __init__(self, inner: Any, site: str, state: State) -> None:
        self._inner = inner
        self.site = site
        self._state = state
        state.register_lock(site)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._state.note_acquired(self)
        return got

    def release(self) -> None:
        self._state.note_released(self)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<SanitizedLock {self.site} of {self._inner!r}>"


def sanitize_lock(inner: Any, site: str,
                  state: Optional[State] = None) -> SanitizedLock:
    """Wrap an existing primitive for an explicit State — the unit-test
    entry point (no global patching involved)."""
    return SanitizedLock(inner, site, state or _state)


def io_lock() -> Any:
    """A lock whose PURPOSE is to serialize blocking I/O (one log fetch
    per task handle, one upload per artifact): holding it across
    Popen.wait/fsync is the design, not a hazard, so it is allocated
    raw and excluded from sanitizer tracking. Use sparingly — a lock
    any RPC handler or monitor tick can contend for does NOT qualify."""
    return _REAL_LOCK()


def raw_lock() -> Any:
    """An always-raw Lock for the checker tooling's OWN internals (the
    race detector's bookkeeping mutex): never wrapped, never tracked,
    regardless of when the factories were patched."""
    return _REAL_LOCK()


class SanitizedEvent:
    """Event wrapper for tony allocation sites: ``set`` → successful
    ``wait`` is a happens-before handoff edge for the race detector
    (devtools/race.py). The blocking wait itself still feeds
    hold-while-blocking through the class-level patch on the real
    Event — this wrapper only adds the HB half that was invisible."""

    def __init__(self, inner: Any, site: str, state: State) -> None:
        self._inner = inner
        self.site = site
        self._state = state

    def set(self) -> None:
        if self._state.race is not None:
            self._state.race.send(self)
        self._inner.set()

    def clear(self) -> None:
        self._inner.clear()

    def is_set(self) -> bool:
        return bool(self._inner.is_set())

    def wait(self, timeout: Optional[float] = None) -> bool:
        got = bool(self._inner.wait(timeout))
        if got and self._state.race is not None:
            self._state.race.recv(self)
        return got

    def __repr__(self) -> str:
        return f"<SanitizedEvent {self.site} of {self._inner!r}>"


class SanitizedCondition:
    """Condition wrapper for tony allocation sites (bare
    ``threading.Condition()`` — today these are invisible to the
    sanitizer). It is lock-shaped: acquire/release feed the lock-order
    graph and the thread's lockset exactly like a SanitizedLock, and
    ``wait`` (1) DROPS the condition from the lockset for its duration —
    the underlying primitive releases its lock, so holding it across the
    wait is the design, not a hazard — (2) records hold-while-blocking
    against any OTHER sanitized locks still held, and (3) receives the
    notify side's happens-before edge."""

    def __init__(self, inner: Any, site: str, state: State) -> None:
        self._inner = inner
        self.site = site
        self._state = state
        state.register_lock(site)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._state.note_acquired(self)  # type: ignore[arg-type]
        return bool(got)

    def release(self) -> None:
        self._state.note_released(self)      # type: ignore[arg-type]
        self._inner.release()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        self._state.note_released(self)      # type: ignore[arg-type]
        self._state.note_blocking("threading.Condition.wait")
        try:
            got = bool(self._inner.wait(timeout))
        finally:
            self._state.note_acquired(self)  # type: ignore[arg-type]
        if got and self._state.race is not None:
            self._state.race.recv(self)
        return got

    def wait_for(self, predicate: Any,
                 timeout: Optional[float] = None) -> Any:
        """Stdlib-shaped wait_for, routed through :meth:`wait` so every
        underlying wait keeps the lockset/HB bookkeeping."""
        endtime: Optional[float] = None
        waittime = timeout
        result = predicate()
        while not result:
            if waittime is not None:
                if endtime is None:
                    endtime = time.monotonic() + waittime
                else:
                    waittime = endtime - time.monotonic()
                    if waittime <= 0:
                        break
            self.wait(waittime)
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        if self._state.race is not None:
            self._state.race.send(self)
        self._inner.notify(n)

    def notify_all(self) -> None:
        if self._state.race is not None:
            self._state.race.send(self)
        self._inner.notify_all()

    def __repr__(self) -> str:
        return f"<SanitizedCondition {self.site} of {self._inner!r}>"


# ---------------------------------------------------------------------------
# Global enablement: patch the factories + blocking primitives
# ---------------------------------------------------------------------------
# A process that imports both this package and the one it was ported from
# (the parity tests) may find threading's factories already replaced by that
# package's own sanitizer. This copy then never enables: that sanitizer
# already watches the port's locks (its scope is every path with the package
# name in it), and patching over it would wrap its wrappers. The raw locks
# come from _thread, so they stay raw either way.
_FOREIGN = not isinstance(threading.Event, type)
_REAL_LOCK = _thread.allocate_lock
_REAL_RLOCK = _thread.RLock
_REAL_EVENT = threading.Event
_REAL_CONDITION = threading.Condition
_state = State()
_enabled = False
_real: Dict[str, Any] = {}


def state() -> State:
    return _state


def enabled() -> bool:
    return _enabled


def set_race_listener(race: Optional[Any]) -> None:
    """Attach (or detach) the race detector to the GLOBAL sanitizer
    state: lock acquire/release then feed its happens-before graph, and
    it reads locksets via State.held_locks()."""
    _state.race = race


def _lock_factory() -> Any:
    site = _site_of_frame(2)
    inner = _REAL_LOCK()
    if site is None:
        return inner
    return SanitizedLock(inner, site, _state)


def _rlock_factory() -> Any:
    site = _site_of_frame(2)
    inner = _REAL_RLOCK()
    if site is None:
        return inner
    return SanitizedLock(inner, site, _state)


def _event_factory() -> Any:
    site = _site_of_frame(2)
    inner = _REAL_EVENT()
    if site is None:
        return inner
    return SanitizedEvent(inner, site, _state)


def _condition_factory(lock: Optional[Any] = None) -> Any:
    # Explicit-lock conditions keep the raw primitive: the lock they
    # wrap is already sanitized if it came from a tony factory, and the
    # real Condition drives it by duck-typing. (No such allocation site
    # exists in the package today — bare Condition() is the shape.)
    if lock is not None:
        return _REAL_CONDITION(lock)
    site = _site_of_frame(2)
    inner = _REAL_CONDITION()
    if site is None:
        return inner
    return SanitizedCondition(inner, site, _state)


def enable() -> None:
    """Patch lock factories + blocking primitives (idempotent). A no-op
    where another sanitizer already patched them (``_FOREIGN``)."""
    global _enabled
    if _enabled or _FOREIGN:
        return
    _enabled = True
    import socket
    import subprocess

    threading.Lock = _lock_factory          # type: ignore[assignment]
    threading.RLock = _rlock_factory        # type: ignore[assignment]
    # Event/Condition allocation sites are wrapped the same way — their
    # set→wait / notify→wait handoffs feed the race detector's HB graph,
    # and Condition.wait (previously invisible) now feeds
    # hold-while-blocking. Stdlib-internal allocations (queue.Queue's
    # conditions!) see a non-tony frame and stay raw.
    threading.Event = _event_factory        # type: ignore[misc,assignment]
    threading.Condition = _condition_factory  # type: ignore[misc,assignment]

    _real["sleep"] = time.sleep

    def _sleep(secs: float) -> None:
        if secs and secs > 0:
            _state.note_blocking("time.sleep")
        _real["sleep"](secs)

    time.sleep = _sleep

    _real["fsync"] = os.fsync

    def _fsync(fd: int) -> None:
        _state.note_blocking("os.fsync")
        _real["fsync"](fd)

    os.fsync = _fsync

    _real["popen_wait"] = subprocess.Popen.wait

    def _popen_wait(self: Any, timeout: Optional[float] = None) -> int:
        _state.note_blocking("subprocess.Popen.wait")
        return _real["popen_wait"](self, timeout)

    subprocess.Popen.wait = _popen_wait     # type: ignore[method-assign]

    _real["event_wait"] = _REAL_EVENT.wait

    def _event_wait(self: Any, timeout: Optional[float] = None) -> bool:
        _state.note_blocking("threading.Event.wait")
        return _real["event_wait"](self, timeout)

    _REAL_EVENT.wait = _event_wait          # type: ignore[method-assign]

    _real["create_connection"] = socket.create_connection

    def _create_connection(*a: Any, **k: Any) -> Any:
        _state.note_blocking("socket.create_connection")
        return _real["create_connection"](*a, **k)

    socket.create_connection = _create_connection
    atexit.register(_dump_at_exit)


def disable() -> None:
    """Restore the real primitives. Locks already wrapped stay wrapped
    (they keep working; they just stop being joined by new ones)."""
    global _enabled
    if not _enabled:
        return
    _enabled = False
    import socket
    import subprocess

    threading.Lock = _REAL_LOCK             # type: ignore[assignment]
    threading.RLock = _REAL_RLOCK           # type: ignore[assignment]
    threading.Event = _REAL_EVENT           # type: ignore[misc]
    threading.Condition = _REAL_CONDITION   # type: ignore[misc]
    time.sleep = _real["sleep"]
    os.fsync = _real["fsync"]
    subprocess.Popen.wait = _real["popen_wait"]
    _REAL_EVENT.wait = _real["event_wait"]  # type: ignore[method-assign]
    socket.create_connection = _real["create_connection"]


def maybe_enable_from_env() -> bool:
    """Called at ``import tony_tpu_torch`` so every subprocess in a sanitized
    run (executors, the coordinator, pool workers) joins in."""
    if os.environ.get(ENV_FLAG, "").strip().lower() in ("1", "true", "on"):
        enable()
        return True
    return False


def _dump_at_exit() -> None:
    """Best-effort multi-process aggregation: a process with findings
    drops its report into $TONY_LOCK_SANITIZER_DIR for the test session
    to collect (os._exit fault paths skip this — by design, the fault IS
    the teardown-free crash)."""
    d = os.environ.get(ENV_DIR, "")
    if not d:
        return
    rep = _state.report()
    if not rep["cycles"] and not rep["hazards"]:
        return
    try:
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"sanitizer.{os.getpid()}.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(rep, f, indent=1, sort_keys=True)
    except OSError:
        pass


def collect_reports(directory: Optional[str] = None) -> List[Dict[str, Any]]:
    """This process's report + any subprocess dumps in the directory."""
    out = [_state.report()]
    d = directory or os.environ.get(ENV_DIR, "")
    if d and os.path.isdir(d):
        for name in sorted(os.listdir(d)):
            if not name.startswith("sanitizer.") or \
                    not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(d, name), encoding="utf-8") as f:
                    out.append(json.load(f))
            except (OSError, ValueError):
                continue
    return out


def format_report(reports: List[Dict[str, Any]]) -> str:
    lines = []
    for rep in reports:
        for cyc in rep.get("cycles", []):
            lines.append(
                f"LOCK-ORDER CYCLE (pid {rep.get('pid')}): "
                + " -> ".join(cyc + [cyc[0]]))
        for hz in rep.get("hazards", []):
            lines.append(
                f"HOLD-WHILE-BLOCKING (pid {rep.get('pid')}): "
                f"{hz['blocking']} at {hz['where']} while holding "
                f"{', '.join(hz['held'])} [thread {hz['thread']}]")
    return "\n".join(lines)
