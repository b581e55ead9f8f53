"""tonyrace — lockset + happens-before data-race detection for the control plane.

The fleet daemon alone runs a poll tick, RPC handler threads, a ledger
fold and a single-flight prom worker over one shared state bag, and the
coordinator mixes its monitor tick with RPC dispatch. PR 7's sanitizer
checks lock *ordering* and hold-while-blocking — never whether a shared
field is actually accessed under a consistent lock. The reference leaned
on Java's ``synchronized``/JMM discipline for exactly this state
(heartbeat maps, session matrix); this module is the Python rewrite's
equivalent enforcement, two-sided:

**Dynamic side** (Eraser-style lockset analysis + a vector-clock
happens-before graph, the hybrid the ThreadSanitizer family converged
on). Classes opt in with the :func:`guarded` decorator and a
``GUARDED_BY`` registry in the class body::

    @guarded
    class FleetDaemon:
        #: field → the lock attribute that must guard it (None = the
        #: field is atomic/single-writer by design and only audited)
        GUARDED_BY = {"jobs": "_lock", "_ledgers": "_lock",
                      "_started": None}

Under ``TONY_RACE_DETECTOR=1`` (checked at ``import tony_tpu_torch`` so every
subprocess of an armed run joins), attribute reads and writes of the
lock-named fields are instrumented: each access records the calling
thread's **lockset** (the sanitizer's wrapped Lock/RLock bookkeeping —
``devtools/sanitizer.py`` owns which locks are held) and its **vector
clock**. Two accesses to the same field race when they come from
different threads, at least one is a write (a *read* of a mutable
container counts as a write: ``self.jobs[k]`` mutates through an
attribute load), their locksets do not intersect, and neither access
happens-before the other. Happens-before edges come from lock
release→acquire, ``Thread.start``/``join``, ``queue.Queue`` put→get and
``Event``/``Condition`` handoffs — so single-flight handoffs (the
coordinator's prom-export worker, the event-writer queue) do not
false-positive. Reports carry both access sites and are dumped
per-process into ``$TONY_RACE_DETECTOR_DIR`` at exit; the tier-1
conftest fails the session on any finding, exactly like the lock
sanitizer. With the env flag off, :func:`guarded` returns the class
untouched — zero overhead.

**Static side** — the ``guarded-by`` tonylint rule family (run via the
ordinary ``tony-tpu lint`` surfaces, suppressed with the usual
``# tony: lint-ignore[...]`` grammar), scoped to ``coordinator/`` and
``fleet/``:

===================  ====================================================
guarded-by           every access to a field declared with a lock in
                     ``GUARDED_BY`` (dict form, or a trailing
                     ``# guarded-by: <lock-attr>`` comment on the
                     ``__init__`` assignment) happens lexically inside
                     ``with self.<lock-attr>:`` — except in ``__init__``
                     (no threads yet) and in ``*_locked`` helpers (the
                     caller-holds-the-lock convention)
guarded-decl         the other direction: on a class that HAS a registry,
                     a ``self.<field> = ...`` store outside ``__init__``
                     to an UNDECLARED field is a violation — shared
                     mutable state must not escape the audit
===================  ====================================================

Unit tests build an isolated :class:`RaceState` (paired with an isolated
sanitizer ``State``) and instrument fixture classes through
:func:`instrument_class` — no global patching, no cross-test bleed.
"""

from __future__ import annotations

import ast
import atexit
import json
import os
import re
import sys
import threading
import weakref
from collections import deque
from typing import (Any, Callable, Dict, FrozenSet, List, Optional, Set,
                    Tuple, Type)

from tony_tpu_torch.devtools import sanitizer

ENV_FLAG = "TONY_RACE_DETECTOR"
ENV_DIR = "TONY_RACE_DETECTOR_DIR"

#: the class-body registry attribute the decorator and the lint read
GUARDED_ATTR = "GUARDED_BY"

#: cap stored races so a pathological loop cannot eat the heap
_MAX_RACES = 100
#: cap per-field read records (threads seen since the last write)
_MAX_READS = 32

#: reads of these types mutate state through the attribute load
#: (``self.jobs[k] = v`` is an attr *read* of ``jobs`` at runtime), so
#: they participate as writes in the race check.
_MUTABLE = (dict, list, set, deque)

#: the per-instance slot holding field access state (never tracked)
_FIELDS_SLOT = "_tony_race_fields_"

_VC = Dict[int, int]
#: one access record: (tid, clock, lockset ids, lock sites, site, thread)
_Rec = Tuple[int, int, FrozenSet[int], Tuple[str, ...], str, str]


def _merge(dst: _VC, src: _VC) -> None:
    for k, v in src.items():
        if dst.get(k, 0) < v:
            dst[k] = v


def _site(extra_skip: int = 0) -> str:
    """Short access site: up to 3 tony frames, innermost first, skipping
    this module and the sanitizer."""
    try:
        f: Any = sys._getframe(2 + extra_skip)
    except ValueError:
        return "?"
    out: List[str] = []
    while f is not None and len(out) < 3:
        fn = f.f_code.co_filename
        if not (fn.endswith(os.path.join("devtools", "race.py"))
                or fn.endswith(os.path.join("devtools", "sanitizer.py"))):
            idx = fn.rfind("tony_tpu_torch")
            short = fn[idx:] if idx >= 0 else os.path.basename(fn)
            out.append(f"{short}:{f.f_lineno} ({f.f_code.co_name})")
        f = f.f_back
    return " < ".join(out) if out else "?"


class RaceState:
    """All detector bookkeeping. The module keeps one global instance
    (paired with the sanitizer's global State for locksets); tests build
    their own pair for isolation."""

    def __init__(self, san: Optional[sanitizer.State] = None) -> None:
        # Raw primitive on purpose: the detector must never instrument
        # its own internals (same rule as the sanitizer).
        self._mu = sanitizer.raw_lock()
        self.san = san if san is not None else sanitizer.state()
        self._tls = threading.local()
        self._next_tid = 0
        #: per-thread vector clocks (alive via the Thread object — a
        #: joiner reads the child's final clock after ``join``)
        self._vcs: "weakref.WeakKeyDictionary[threading.Thread, _VC]" = \
            weakref.WeakKeyDictionary()
        #: creator-snapshot seeds installed by Thread.start
        self._seeds: "weakref.WeakKeyDictionary[threading.Thread, _VC]" = \
            weakref.WeakKeyDictionary()
        #: channel clocks: locks (release→acquire), queues (put→get),
        #: events/conditions (set/notify→wait) all use the same edge
        self._chan: "weakref.WeakKeyDictionary[Any, _VC]" = \
            weakref.WeakKeyDictionary()
        self.races: List[Dict[str, Any]] = []
        self._race_keys: Set[Tuple[str, str, str]] = set()
        self.fields_tracked = 0

    # -- thread identity / clocks ----------------------------------------
    def _ctx(self) -> Tuple[int, _VC]:
        tid = getattr(self._tls, "tid", None)
        if tid is not None:
            return tid, self._tls.vc  # type: ignore[no-any-return]
        th = threading.current_thread()
        with self._mu:
            self._next_tid += 1
            tid = self._next_tid
            vc: _VC = {}
            seed = self._seeds.pop(th, None)
            if seed is not None:
                _merge(vc, seed)
            vc[tid] = 1
            self._vcs[th] = vc
        self._tls.tid = tid
        self._tls.vc = vc
        return tid, vc

    # -- happens-before edges --------------------------------------------
    def send(self, obj: Any) -> None:
        """Publish: the current thread's clock joins ``obj``'s channel
        (lock release, queue put, Event.set, Condition.notify)."""
        tid, vc = self._ctx()
        with self._mu:
            ch = self._chan.get(obj)
            if ch is None:
                ch = {}
                try:
                    self._chan[obj] = ch
                except TypeError:
                    return          # unweakrefable channel: no edge
            _merge(ch, vc)
            vc[tid] = vc[tid] + 1

    def recv(self, obj: Any) -> None:
        """Receive: ``obj``'s channel clock joins the current thread
        (lock acquire, queue get, Event.wait, Condition.wait)."""
        tid, vc = self._ctx()
        with self._mu:
            ch = self._chan.get(obj)
            if ch:
                _merge(vc, ch)

    def note_start(self, thread: threading.Thread) -> None:
        """Thread.start edge: the child begins with everything the
        creator did so far."""
        tid, vc = self._ctx()
        with self._mu:
            try:
                self._seeds[thread] = dict(vc)
            except TypeError:
                return
            vc[tid] = vc[tid] + 1

    def note_join(self, thread: threading.Thread) -> None:
        """Thread.join edge: the joiner sees everything the (finished)
        child did."""
        _, vc = self._ctx()
        with self._mu:
            child = self._vcs.get(thread)
            if child is None:
                child = self._seeds.get(thread)
            if child:
                _merge(vc, child)

    # -- the access check -------------------------------------------------
    def _lockset(self) -> Tuple[FrozenSet[int], Tuple[str, ...]]:
        held = self.san.held_locks()
        if not held:
            return frozenset(), ()
        return (frozenset(id(lk) for lk in held),
                tuple(getattr(lk, "site", "?") for lk in held))

    def note_access(self, obj: Any, cls_name: str, attr: str,
                    guard: str, is_write: bool) -> None:
        d = object.__getattribute__(obj, "__dict__")
        fields = d.get(_FIELDS_SLOT)
        if fields is None:
            fields = d[_FIELDS_SLOT] = {}
        tid, vc = self._ctx()
        clock = vc[tid]
        ls, sites = self._lockset()
        fs = fields.get(attr)
        key = (tid, clock, ls, is_write)
        if fs is not None and fs.get("last") == key:
            return              # same thread, same epoch, same lockset
        with self._mu:
            if fs is None:
                fs = fields[attr] = {"w": None, "r": {}, "last": None}
                self.fields_tracked += 1
            rec: _Rec = (tid, clock, ls, sites, _site(),
                         threading.current_thread().name)
            w = fs["w"]
            if (w is not None and w[0] != tid
                    and w[1] > vc.get(w[0], 0) and not (w[2] & ls)):
                self._report(cls_name, attr, guard,
                             "write-write" if is_write else "write-read",
                             w, rec)
            if is_write:
                for rtid, r in list(fs["r"].items()):
                    if (rtid != tid and r[1] > vc.get(rtid, 0)
                            and not (r[2] & ls)):
                        self._report(cls_name, attr, guard,
                                     "read-write", r, rec)
                fs["w"] = rec
                fs["r"].clear()
            else:
                if len(fs["r"]) < _MAX_READS or tid in fs["r"]:
                    fs["r"][tid] = rec
            fs["last"] = key

    def _report(self, cls_name: str, attr: str, guard: str, kind: str,
                a: _Rec, b: _Rec) -> None:
        key = (cls_name, attr, kind)
        if key in self._race_keys or len(self.races) >= _MAX_RACES:
            return
        self._race_keys.add(key)

        def _acc(r: _Rec) -> Dict[str, Any]:
            return {"thread": r[5], "site": r[4], "locks": list(r[3])}

        self.races.append({
            "class": cls_name, "field": attr, "guard": guard,
            "kind": kind, "a": _acc(a), "b": _acc(b)})

    # -- reporting --------------------------------------------------------
    def report(self) -> Dict[str, Any]:
        with self._mu:
            return {"pid": os.getpid(), "races": list(self.races),
                    "fields_tracked": self.fields_tracked}

    def clear(self) -> None:
        with self._mu:
            self.races.clear()
            self._race_keys.clear()


# ---------------------------------------------------------------------------
# Class instrumentation
# ---------------------------------------------------------------------------
_COMMENT_GUARD_RE = re.compile(
    r"self\.(\w+)\s*(?::[^=]+)?=[^#\n]*#\s*guarded-by:\s*([A-Za-z_]\w*|none)")


def declared_guards(cls: type) -> Dict[str, Optional[str]]:
    """The class's guard registry: the ``GUARDED_BY`` dict merged with
    trailing ``# guarded-by: <lock-attr>`` comments on ``self.x = ...``
    assignments in the class source (``none`` declares an audited-but-
    unguarded field)."""
    out: Dict[str, Optional[str]] = {}
    reg = getattr(cls, GUARDED_ATTR, None)
    if isinstance(reg, dict):
        for k, v in reg.items():
            out[str(k)] = str(v) if v else None
    try:
        import inspect

        src = inspect.getsource(cls)
    except (OSError, TypeError):
        return out
    for m in _COMMENT_GUARD_RE.finditer(src):
        field, guard = m.group(1), m.group(2)
        out.setdefault(field, None if guard == "none" else guard)
    return out


def instrument_class(cls: Type[Any],
                     state: Optional[RaceState] = None) -> Type[Any]:
    """Wrap ``cls``'s attribute access so lock-declared ``GUARDED_BY``
    fields feed ``state`` (default: the global detector). Unconditional —
    the :func:`guarded` decorator is the enablement-gated entry point;
    tests call this directly with an isolated state."""
    tracked: Dict[str, str] = {
        f: g for f, g in declared_guards(cls).items() if g}
    if not tracked:
        return cls
    tracked_set = frozenset(tracked)
    cls_name = cls.__name__
    get_state: Callable[[], RaceState]
    if state is None:
        get_state = _global_state
    else:
        def get_state(_s: RaceState = state) -> RaceState:
            return _s
    orig_get = cls.__getattribute__
    orig_set = cls.__setattr__

    def __getattribute__(self: Any, name: str) -> Any:
        value = orig_get(self, name)
        if name in tracked_set:
            get_state().note_access(
                self, cls_name, name, tracked[name],
                isinstance(value, _MUTABLE))
        return value

    def __setattr__(self: Any, name: str, value: Any) -> None:
        if name in tracked_set:
            get_state().note_access(self, cls_name, name, tracked[name],
                                    True)
        orig_set(self, name, value)

    cls.__getattribute__ = __getattribute__  # type: ignore[method-assign]
    cls.__setattr__ = __setattr__            # type: ignore[method-assign]
    return cls


def guarded(cls: Type[Any]) -> Type[Any]:
    """Class decorator: arm the declared ``GUARDED_BY`` fields for race
    detection when ``TONY_RACE_DETECTOR=1``; the class comes back
    untouched (same object, same methods) when the detector is off."""
    if not _enabled:
        return cls
    return instrument_class(cls)


# ---------------------------------------------------------------------------
# Global enablement
# ---------------------------------------------------------------------------
_state: Optional[RaceState] = None
_enabled = False
_real: Dict[str, Any] = {}


def _global_state() -> RaceState:
    global _state
    if _state is None:
        _state = RaceState()
    return _state


def state() -> RaceState:
    return _global_state()


def enabled() -> bool:
    return _enabled


def enable() -> None:
    """Arm the detector: requires (and enables) the lock sanitizer for
    locksets, registers this state for lock-edge callbacks, and patches
    the thread/queue handoff primitives for HB edges. Idempotent."""
    global _enabled
    if _enabled:
        return
    sanitizer.enable()
    if not sanitizer.enabled():
        # Another package's sanitizer owns this process's threading
        # (sanitizer._FOREIGN): no locksets to read, so stay off.
        return
    _enabled = True
    st = _global_state()
    st.san = sanitizer.state()
    sanitizer.set_race_listener(st)
    import queue

    _real["thread_start"] = threading.Thread.start
    _real["thread_join"] = threading.Thread.join
    _real["queue_put"] = queue.Queue.put
    _real["queue_get"] = queue.Queue.get

    def _start(self: threading.Thread) -> None:
        _global_state().note_start(self)
        _real["thread_start"](self)

    def _join(self: threading.Thread,
              timeout: Optional[float] = None) -> None:
        _real["thread_join"](self, timeout)
        if not self.is_alive():
            _global_state().note_join(self)

    def _put(self: Any, item: Any, block: bool = True,
             timeout: Optional[float] = None) -> None:
        _global_state().send(self)
        _real["queue_put"](self, item, block, timeout)

    def _get(self: Any, block: bool = True,
             timeout: Optional[float] = None) -> Any:
        item = _real["queue_get"](self, block, timeout)
        _global_state().recv(self)
        return item

    threading.Thread.start = _start          # type: ignore[method-assign]
    threading.Thread.join = _join            # type: ignore[method-assign]
    queue.Queue.put = _put                   # type: ignore[method-assign]
    queue.Queue.get = _get                   # type: ignore[method-assign]
    atexit.register(_dump_at_exit)


def disable() -> None:
    """Restore the real primitives. Classes already instrumented stay
    instrumented (their accesses keep feeding the state) — same contract
    as the sanitizer's disable()."""
    global _enabled
    if not _enabled:
        return
    _enabled = False
    import queue

    threading.Thread.start = _real["thread_start"]
    threading.Thread.join = _real["thread_join"]
    queue.Queue.put = _real["queue_put"]
    queue.Queue.get = _real["queue_get"]
    sanitizer.set_race_listener(None)


def maybe_enable_from_env() -> bool:
    """Called at ``import tony_tpu_torch`` so every subprocess of an armed run
    (executors, coordinators, pool workers, fleet daemons) joins."""
    if os.environ.get(ENV_FLAG, "").strip().lower() in ("1", "true", "on"):
        enable()
        return True
    return False


def _dump_at_exit() -> None:
    """Best-effort multi-process aggregation (the sanitizer's contract):
    a process with findings drops its report into $TONY_RACE_DETECTOR_DIR
    for the test session to collect."""
    d = os.environ.get(ENV_DIR, "")
    if not d or _state is None:
        return
    rep = _state.report()
    if not rep["races"]:
        return
    try:
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"race.{os.getpid()}.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(rep, f, indent=1, sort_keys=True)
    except OSError:
        pass


def collect_reports(directory: Optional[str] = None) -> List[Dict[str, Any]]:
    """This process's report + any subprocess dumps in the directory."""
    out = [_global_state().report()]
    d = directory or os.environ.get(ENV_DIR, "")
    if d and os.path.isdir(d):
        for name in sorted(os.listdir(d)):
            if not name.startswith("race.") or not name.endswith(".json"):
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
        for r in rep.get("races", []):
            lines.append(
                f"DATA RACE (pid {rep.get('pid')}): "
                f"{r['class']}.{r['field']} [{r['kind']}; declared "
                f"guard {r['guard']!r}]\n"
                f"  access A [{r['a']['thread']}] holding "
                f"{r['a']['locks'] or 'no locks'}\n"
                f"    at {r['a']['site']}\n"
                f"  access B [{r['b']['thread']}] holding "
                f"{r['b']['locks'] or 'no locks'}\n"
                f"    at {r['b']['site']}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Static side: the guarded-by lint rule family (tonylint integration)
# ---------------------------------------------------------------------------
RULES_RACE: Dict[str, str] = {
    "guarded-by": "GUARDED_BY-declared fields are only touched inside "
                  "`with self.<lock>:` (coordinator/ and fleet/)",
    "guarded-decl": "no undeclared shared-field stores outside __init__ "
                    "on GUARDED_BY-registered classes",
}

#: methods where guard-free access is legitimate: construction happens
#: before any thread exists, and the ``*_locked`` suffix is the
#: caller-holds-the-lock convention (documented in docs/development.md)
_EXEMPT_METHODS = ("__init__", "__new__")


def _class_registry(cls_node: ast.ClassDef,
                    src_lines: List[str]) -> Optional[Dict[str, Optional[str]]]:
    """Parse the class's guard declarations: the GUARDED_BY dict in the
    class body, plus trailing ``# guarded-by:`` comments anywhere in the
    class extent. None when the class declares nothing (uninstrumented —
    the rule family does not apply)."""
    reg: Optional[Dict[str, Optional[str]]] = None
    for stmt in cls_node.body:
        if (isinstance(stmt, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == GUARDED_ATTR
                        for t in stmt.targets)
                and isinstance(stmt.value, ast.Dict)):
            reg = {}
            for k, v in zip(stmt.value.keys, stmt.value.values):
                if not (isinstance(k, ast.Constant)
                        and isinstance(k.value, str)):
                    continue
                guard: Optional[str] = None
                if isinstance(v, ast.Constant) and isinstance(v.value, str):
                    guard = v.value
                reg[k.value] = guard
    end = getattr(cls_node, "end_lineno", None) or cls_node.lineno
    for lineno in range(cls_node.lineno, min(end, len(src_lines)) + 1):
        m = _COMMENT_GUARD_RE.search(src_lines[lineno - 1])
        if m:
            if reg is None:
                reg = {}
            reg.setdefault(m.group(1),
                           None if m.group(2) == "none" else m.group(2))
    return reg


def _in_with_guard(src: Any, node: ast.AST, guard: str,
                   method: ast.AST) -> bool:
    """Is ``node`` lexically inside ``with self.<guard>:`` within the
    method?"""
    parents = src.parent_map()
    cur = parents.get(node)
    while cur is not None and cur is not method:
        if isinstance(cur, ast.With):
            for item in cur.items:
                ce = item.context_expr
                if (isinstance(ce, ast.Attribute) and ce.attr == guard
                        and isinstance(ce.value, ast.Name)
                        and ce.value.id == "self"):
                    return True
        cur = parents.get(cur)
    return False


def run_race_rules(linter: Any, pkg_srcs: List[Any],
                   active: Set[str]) -> None:
    """Entry point called from tonylint.Linter.run() — same interface as
    protocol.run_protocol_rules."""
    if "guarded-by" not in active and "guarded-decl" not in active:
        return
    for src in pkg_srcs:
        in_scope = any((os.sep + d + os.sep) in src.rel
                       for d in ("coordinator", "fleet"))
        if not in_scope:
            continue
        for node in ast.walk(src.tree):
            if isinstance(node, ast.ClassDef):
                reg = _class_registry(node, src.lines)
                if reg is not None:
                    _check_class(linter, src, node, reg, active)


def _check_class(linter: Any, src: Any, cls_node: ast.ClassDef,
                 reg: Dict[str, Optional[str]], active: Set[str]) -> None:
    guards = {g for g in reg.values() if g}
    for stmt in cls_node.body:
        if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if stmt.name in _EXEMPT_METHODS:
            continue
        caller_holds = stmt.name.endswith("_locked")
        for sub in ast.walk(stmt):
            if not (isinstance(sub, ast.Attribute)
                    and isinstance(sub.value, ast.Name)
                    and sub.value.id == "self"):
                continue
            field = sub.attr
            guard = reg.get(field)
            if ("guarded-by" in active and guard is not None
                    and not caller_holds
                    and not _in_with_guard(src, sub, guard, stmt)):
                linter._emit(
                    "guarded-by", src.rel, sub.lineno,
                    f"{cls_node.name}.{field} is declared guarded-by "
                    f"{guard!r} but is touched outside `with "
                    f"self.{guard}:` (hold the lock, or do it in a "
                    f"*_locked helper whose callers hold it)", src)
            if ("guarded-decl" in active
                    and isinstance(sub.ctx, ast.Store)
                    and field not in reg
                    and field not in guards
                    and not field.startswith("__")):
                linter._emit(
                    "guarded-decl", src.rel, sub.lineno,
                    f"store to {cls_node.name}.{field} outside __init__ "
                    f"on a GUARDED_BY-registered class: declare it in "
                    f"the registry (with its lock, or None for "
                    f"atomic/single-writer-by-design fields)", src)


# ---------------------------------------------------------------------------
# No-deps self-check (CI lint job): the detector flags a textbook racy
# fixture and stays silent on the locked and handoff-rescued twins.
# ---------------------------------------------------------------------------
def _selfcheck() -> int:
    san = sanitizer.State()
    st = RaceState(san)

    class _Racy:
        GUARDED_BY = {"shared": "_mu"}

        def __init__(self) -> None:
            self.shared: Dict[str, int] = {}

    class _Clean:
        GUARDED_BY = {"shared": "_mu"}

        def __init__(self) -> None:
            self._mu = sanitizer.sanitize_lock(
                sanitizer.raw_lock(), "selfcheck:_mu", san)
            with self._mu:
                self.shared: Dict[str, int] = {}

    class _Handoff:
        GUARDED_BY = {"shared": "_mu"}

        def __init__(self) -> None:
            self.shared: Dict[str, int] = {}

    instrument_class(_Racy, state=st)
    instrument_class(_Clean, state=st)
    instrument_class(_Handoff, state=st)
    racy, clean, hand = _Racy(), _Clean(), _Handoff()

    def _touch_racy() -> None:
        racy.shared["k"] = 1

    def _touch_clean() -> None:
        with clean._mu:
            clean.shared["k"] = 1

    for fn in (_touch_racy, _touch_clean):
        t = threading.Thread(target=fn)
        t.start()
        t.join()
        # NOTE: no note_start/note_join on the isolated state — the
        # fixture threads must look concurrent to it.
        fn()
    # Handoff twin: same unlocked shape as _Racy, but the start/join
    # edges are injected — the HB graph must rescue it.
    t = threading.Thread(target=lambda: hand.shared.update(k=1))
    st.note_start(t)
    t.start()
    t.join()
    st.note_join(t)
    hand.shared["k"] = 2
    rep = st.report()
    racy_hits = [r for r in rep["races"] if r["class"] == "_Racy"]
    clean_hits = [r for r in rep["races"]
                  if r["class"] in ("_Clean", "_Handoff")]
    ok = bool(racy_hits) and not clean_hits
    print(f"tonyrace selfcheck: racy fixture -> "
          f"{len(racy_hits)} finding(s) (want >=1), locked + handoff "
          f"fixtures -> {len(clean_hits)} finding(s) (want 0)")
    if racy_hits:
        print(format_report([{"pid": os.getpid(), "races": racy_hits}]))
    return 0 if ok else 1


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m tony_tpu_torch.devtools.race",
        description="tonyrace self-check (see docs/development.md).")
    p.parse_args(argv)
    return _selfcheck()


if __name__ == "__main__":
    sys.exit(main())
