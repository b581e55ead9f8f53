"""tonylint v2 protocol rules: the control-plane contract, machine-checked.

The coordinator↔executor protocol is hand-maintained the same way the
reference's was — directives ride heartbeat responses, REC_* journal
records drive ``--recover`` replay, gen/mgen fences guard every frame,
beacon fields feed the metrics fold. None of that is declared anywhere:
each half lives in a different file, and tonylint's first rules checked
single-registry surfaces (conf keys, fault sites, EventTypes, the RPC
method table). These six rules extract BOTH halves of each protocol from
the AST and check them against each other, so the scheduler/journal
refactors ahead (ROADMAP items 1 and 5) cannot silently strand one side.

Rules (suppressed like every tonylint rule, ``# tony: lint-ignore[...]``):

=================  =========================================================
directive-parity   every directive key set on a heartbeat response in the
                   coordinator has an executor heartbeat branch reading it
                   (and vice versa); stateful (dict-payload) directives
                   have a dedup/mgen guard in their executor handler
journal-parity     every ``REC_*`` record type is appended somewhere and
                   has a ``replay()`` branch; replay handles no type that
                   is never written; record types are never literal strings
fence-coverage     every task-scoped RpcServer handler that mutates
                   Session state validates the epoch/membership fence
                   (``_check_epoch``/``_check_membership``) before mutating
beacon-parity      every field the executor ships in its heartbeat beacon
                   is read by a coordinator fold, and every read field has
                   a writer
terminal-state     no coordinator-package function assigns ``<task>.status``
                   without testing ``.terminal`` first (the journaled
                   epoch-reset/absorb/restore/replay paths are exempt)
metrics-registry   every exported ``tony_*`` series name is registered in
                   ``tony_tpu_torch.metrics.SERIES`` exactly once, and every
                   registered series has an exporting call site
=================  =========================================================

Pure stdlib ``ast``, same contracts as tonylint.py: findings carry
file:line, the repo gate (tests/test_lint.py) asserts zero findings, and
each rule has a golden bad+clean fixture.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

#: rule id → one-line description, merged into tonylint.RULES
RULES_V2: Dict[str, str] = {
    "directive-parity": "heartbeat-response directives have executor "
                        "handler branches and dedup guards, both ways",
    "journal-parity": "REC_* record types are appended AND replayed; "
                      "no literal record types",
    "fence-coverage": "task-scoped RPC handlers that mutate Session "
                      "state validate gen/mgen before mutating",
    "beacon-parity": "executor beacon fields and coordinator fold "
                     "reads agree 1:1",
    "terminal-state": "no task status store without a .terminal guard "
                      "(epoch-reset/absorb paths exempt)",
    "metrics-registry": "tony_* series names live in metrics.SERIES, "
                        "each with an exporting call site",
}

#: Session methods that mutate the task matrix / failure state
#: (coordinator/session.py) — calling one from an RPC handler is a
#: state mutation the fence must precede.
_SESSION_MUTATORS = frozenset((
    "register_worker", "on_task_completed", "resize_job", "mark_killed",
    "fail", "restore_task", "mark_job_scheduled",
))

#: fence-validation call names — any one of them in the handler's
#: (delegate-resolved) body satisfies fence-coverage.
_FENCE_CALLS = ("check_epoch", "check_membership", "fences_frame")

#: functions exempt from terminal-state: the journaled epoch-reset,
#: absorb and recovery-restore paths legitimately write terminal or
#: post-terminal statuses (the rule exempts "the journaled epoch-reset/
#: absorb paths"), and the journal replay fold applies records verbatim.
_TERMINAL_EXEMPT = re.compile(r"absorb|restore|reset|replay")

#: a tony_* series name — the package's own name ("tony_tpu_torch...") is a
#: path/module reference, never a series.
_SERIES_NAME_RE = re.compile(r"^tony_(?!tpu(?:$|[_/.]))[a-z0-9_]+$")


def _under(src, dirname: str) -> bool:
    return (os.sep + dirname + os.sep) in src.rel


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _functions(tree: ast.AST) -> Iterable[ast.FunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _attr_chain(node: ast.AST) -> List[str]:
    """['self', '_c', 'session', 'get_task'] for self._c.session.get_task."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return list(reversed(parts))


def run_protocol_rules(linter, pkg_srcs: List, active: Set[str]) -> None:
    """Entry point called from tonylint.Linter.run()."""
    if "directive-parity" in active:
        _check_directive_parity(linter, pkg_srcs)
    if "journal-parity" in active:
        _check_journal_parity(linter, pkg_srcs)
    if "fence-coverage" in active:
        _check_fence_coverage(linter, pkg_srcs)
    if "beacon-parity" in active:
        _check_beacon_parity(linter, pkg_srcs)
    if "terminal-state" in active:
        _check_terminal_state(linter, pkg_srcs)
    if "metrics-registry" in active:
        _check_metrics_registry(linter, pkg_srcs)


# ---------------------------------------------------------------------------
# directive-parity
# ---------------------------------------------------------------------------
def _heartbeat_response_keys(srcs) -> Dict[str, Tuple[str, int, object]]:
    """Directive keys set on the response dict inside a coordinator
    heartbeat handler: ``resp["dump"] = ...`` in a function named
    ``heartbeat``/``task_executor_heartbeat`` under coordinator/."""
    keys: Dict[str, Tuple[str, int, object]] = {}
    for src in srcs:
        if not _under(src, "coordinator"):
            continue
        for fn in _functions(src.tree):
            if fn.name not in ("heartbeat", "task_executor_heartbeat"):
                continue
            for node in ast.walk(fn):
                if not (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Subscript)
                        and isinstance(node.targets[0].value, ast.Name)):
                    continue
                key = _const_str(node.targets[0].slice)
                if key and key != "ok":
                    keys.setdefault(key, (src.rel, node.lineno, src))
    return keys


def _executor_heartbeat_reads(srcs):
    """(reads, stateful, found_caller): keys the executor reads off the
    heartbeat RPC result, which of them are dict-payload (stateful), and
    whether any heartbeat call site exists at all. Flow-aware: only
    ``.get()`` calls on the variable the heartbeat result was assigned
    to, inside the function making the call."""
    reads: Dict[str, Tuple[str, int, object]] = {}
    stateful: Set[str] = set()
    found_caller = False
    for src in srcs:
        if not _under(src, "executor"):
            continue
        for fn in _functions(src.tree):
            res_vars: Set[str] = set()
            for node in ast.walk(fn):
                if (isinstance(node, ast.Assign)
                        and isinstance(node.value, ast.Call)
                        and isinstance(node.value.func, ast.Attribute)
                        and node.value.func.attr == "call"
                        and node.value.args
                        and _const_str(node.value.args[0])
                        == "task_executor_heartbeat"):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            res_vars.add(t.id)
            if not res_vars:
                continue
            found_caller = True
            for node in ast.walk(fn):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "get"
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id in res_vars
                        and node.args):
                    key = _const_str(node.args[0])
                    if key and key != "ok":
                        reads.setdefault(key, (src.rel, node.lineno, src))
            for node in ast.walk(fn):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Name)
                        and node.func.id == "isinstance"
                        and len(node.args) == 2
                        and isinstance(node.args[1], ast.Name)
                        and node.args[1].id == "dict"):
                    inner = node.args[0]
                    if (isinstance(inner, ast.Call)
                            and isinstance(inner.func, ast.Attribute)
                            and inner.func.attr == "get"
                            and isinstance(inner.func.value, ast.Name)
                            and inner.func.value.id in res_vars
                            and inner.args):
                        key = _const_str(inner.args[0])
                        if key:
                            stateful.add(key)
    return reads, stateful, found_caller


def _handler_has_dedup_guard(srcs, key: str) -> bool:
    """An executor-package function named after the directive contains a
    comparison/membership test over an mgen- or id-shaped identifier —
    the re-sent-every-beat dedup discipline."""
    for src in srcs:
        if not _under(src, "executor"):
            continue
        for fn in _functions(src.tree):
            if key not in fn.name:
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Compare):
                    continue
                tokens: List[str] = []
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Name):
                        tokens.append(sub.id)
                    elif isinstance(sub, ast.Attribute):
                        tokens.append(sub.attr)
                if any("mgen" in t or "id" in t for t in tokens):
                    return True
    return False


def _check_directive_parity(linter, srcs) -> None:
    coord_keys = _heartbeat_response_keys(srcs)
    reads, stateful, found_caller = _executor_heartbeat_reads(srcs)
    if found_caller:
        for key, (rel, line, src) in sorted(coord_keys.items()):
            if key not in reads:
                linter._emit(
                    "directive-parity", rel, line,
                    f"directive {key!r} rides the heartbeat response but "
                    f"no executor heartbeat branch reads it — the "
                    f"directive is shipped and dropped on the floor", src)
    if coord_keys:
        for key, (rel, line, src) in sorted(reads.items()):
            if key not in coord_keys:
                linter._emit(
                    "directive-parity", rel, line,
                    f"executor reads directive {key!r} off the heartbeat "
                    f"response, but no coordinator heartbeat path sets "
                    f"it — dead handler branch", src)
    for key in sorted(stateful & set(coord_keys)):
        if not _handler_has_dedup_guard(srcs, key):
            rel, line, src = reads[key]
            linter._emit(
                "directive-parity", rel, line,
                f"stateful directive {key!r} is re-sent every beat but "
                f"its executor handler has no dedup/mgen guard — the "
                f"drain/capture would re-fire on every heartbeat", src)


# ---------------------------------------------------------------------------
# journal-parity
# ---------------------------------------------------------------------------
def _check_journal_parity(linter, srcs) -> None:
    # Every write-ahead journal module in the package (the session
    # journal coordinator/journal.py AND the fleet journal
    # fleet/journal.py) owes the same parity: REC_* declared ⇒ appended
    # somewhere ⇒ replayed by ITS OWN replay(). Constant names are
    # globally unique across journal modules, so the repo-wide
    # written-set matches writers to the right registry by name.
    journal_srcs = [s for s in srcs if s.rel.endswith("journal.py")]
    if not journal_srcs:
        return
    written: Set[str] = set()
    for src in srcs:
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Dict):
                continue
            for k, v in zip(node.keys, node.values):
                if _const_str(k) != "t":
                    continue
                if isinstance(v, ast.Name) and v.id.startswith("REC_"):
                    written.add(v.id)
                elif _const_str(v) is not None:
                    linter._emit(
                        "journal-parity", src.rel, v.lineno,
                        f"journal record type {_const_str(v)!r} written "
                        f"as a string literal — use the REC_* constant "
                        f"so replay parity stays checkable", src)
    for journal_src in journal_srcs:
        # REC_* constants this journal module declares: name → (value, line)
        consts: Dict[str, Tuple[str, int]] = {}
        for node in journal_src.tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id.startswith("REC_")):
                val = _const_str(node.value)
                if val is not None:
                    consts[node.targets[0].id] = (val, node.lineno)
        if not consts:
            continue
        replayed: Set[str] = set()
        for fn in _functions(journal_src.tree):
            if fn.name != "replay":
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Compare):
                    continue
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Name) \
                            and sub.id.startswith("REC_"):
                        replayed.add(sub.id)
        for name in sorted(consts):
            val, line = consts[name]
            if name not in written:
                linter._emit(
                    "journal-parity", journal_src.rel, line,
                    f"journal record type {name} ({val!r}) is declared "
                    f"but never appended — dead record type (delete it, "
                    f"or wire the writer)", journal_src)
            elif name not in replayed:
                linter._emit(
                    "journal-parity", journal_src.rel, line,
                    f"journal record type {name} ({val!r}) is appended "
                    f"but replay() has no branch for it — a recover "
                    f"replay silently drops this state transition",
                    journal_src)
        for name in sorted(replayed - set(consts)):
            linter._emit(
                "journal-parity", journal_src.rel, 1,
                f"replay() references record type {name} which is not "
                f"a declared REC_* constant", journal_src)


# ---------------------------------------------------------------------------
# fence-coverage
# ---------------------------------------------------------------------------
def _service_classes(src) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(src.tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "RpcServer" and node.args):
            first = node.args[0]
            if isinstance(first, ast.Call) and isinstance(first.func,
                                                          ast.Name):
                out.add(first.func.id)
            elif isinstance(first, ast.Name):
                out.add(first.id)
    return out


def _module_methods(src) -> Dict[str, ast.FunctionDef]:
    """Every method/function name → def node in the file (last wins);
    good enough to resolve one file's delegation chains."""
    out: Dict[str, ast.FunctionDef] = {}
    for fn in _functions(src.tree):
        out[fn.name] = fn
    return out


def _effective_nodes(handler: ast.FunctionDef,
                     methods: Dict[str, ast.FunctionDef],
                     depth: int = 2) -> List[ast.AST]:
    """The handler's body plus same-file methods it calls through
    ``self`` / ``self._x`` attributes, resolved ``depth`` hops deep —
    the wrapper-delegates-to-coordinator shape."""
    # Track resolved DEF NODES, not names: a thin RPC wrapper usually
    # delegates to a same-named coordinator method in the same file.
    seen: Set[int] = {id(handler)}
    frontier = [handler]
    nodes: List[ast.AST] = [handler]
    for _ in range(depth):
        nxt: List[ast.FunctionDef] = []
        for fn in frontier:
            for node in ast.walk(fn):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)):
                    continue
                chain = _attr_chain(node.func)
                if not chain or chain[0] != "self":
                    continue
                target = methods.get(node.func.attr)
                if target is None or id(target) in seen:
                    continue
                seen.add(id(target))
                nxt.append(target)
                nodes.append(target)
        frontier = nxt
    return nodes


def _mutates_session(nodes: List[ast.AST]) -> Optional[int]:
    """Line of the first Session-state mutation under ``nodes``:
    a mutator call on a ``.session`` chain, or an attribute store on a
    variable obtained from ``session.get_task(...)``."""
    task_vars: Set[str] = set()
    for scope in nodes:
        for node in ast.walk(scope):
            if (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)
                    and isinstance(node.value.func, ast.Attribute)
                    and node.value.func.attr == "get_task"
                    and "session" in _attr_chain(node.value.func)):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        task_vars.add(t.id)
    for scope in nodes:
        for node in ast.walk(scope):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _SESSION_MUTATORS
                    and "session" in _attr_chain(node.func)):
                return node.lineno
            if (isinstance(node, ast.Assign) and node.targets
                    and isinstance(node.targets[0], ast.Attribute)
                    and isinstance(node.targets[0].value, ast.Name)
                    and node.targets[0].value.id in task_vars):
                return node.lineno
    return None


def _has_fence_call(nodes: List[ast.AST]) -> bool:
    for scope in nodes:
        for node in ast.walk(scope):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and any(f in node.func.attr for f in _FENCE_CALLS)):
                return True
    return False


def _check_fence_coverage(linter, srcs) -> None:
    for src in srcs:
        classes = _service_classes(src)
        if not classes:
            continue
        methods = _module_methods(src)
        for node in ast.walk(src.tree):
            if not (isinstance(node, ast.ClassDef)
                    and node.name in classes):
                continue
            for item in node.body:
                if not isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                if item.name.startswith("_"):
                    continue
                params = {a.arg for a in item.args.args}
                if "task_id" not in params:
                    # Operator/client surface (kill, resize, report):
                    # not an executor frame — the task-scoped fences do
                    # not apply.
                    continue
                nodes = _effective_nodes(item, methods)
                mut_line = _mutates_session(nodes)
                if mut_line is None:
                    continue
                if not _has_fence_call(nodes):
                    linter._emit(
                        "fence-coverage", src.rel, item.lineno,
                        f"RPC handler {item.name!r} mutates Session "
                        f"state (line {mut_line}) without validating "
                        f"the epoch/membership fence first — a stale-"
                        f"epoch executor frame can corrupt the live "
                        f"gang's state", src)


# ---------------------------------------------------------------------------
# beacon-parity
# ---------------------------------------------------------------------------
def _check_beacon_parity(linter, srcs) -> None:
    writes: Dict[str, Tuple[str, int, object]] = {}
    for src in srcs:
        if not _under(src, "executor"):
            continue
        for fn in _functions(src.tree):
            if "beacon" not in fn.name:
                continue
            # Only fields of the dict the function RETURNS count as the
            # beacon surface — nested sub-dicts (the "metrics" payload)
            # have their own keys and are folded as one field.
            returned: Set[str] = set()
            for node in ast.walk(fn):
                if isinstance(node, ast.Return) and node.value is not None:
                    for sub in ast.walk(node.value):
                        if isinstance(sub, ast.Name):
                            returned.add(sub.id)
            for node in ast.walk(fn):
                if (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Subscript)
                        and isinstance(node.targets[0].value, ast.Name)
                        and node.targets[0].value.id in returned):
                    key = _const_str(node.targets[0].slice)
                    if key:
                        writes.setdefault(key,
                                          (src.rel, node.lineno, src))
    reads: Dict[str, Tuple[str, int, object]] = {}
    for src in srcs:
        if not _under(src, "coordinator"):
            continue
        for node in ast.walk(src.tree):
            # progress.get("field")
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "get"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "progress"
                    and node.args):
                key = _const_str(node.args[0])
                if key:
                    reads.setdefault(key, (src.rel, node.lineno, src))
            # "field" in progress  /  "field" not in progress
            if (isinstance(node, ast.Compare)
                    and len(node.ops) == 1
                    and isinstance(node.ops[0], (ast.In, ast.NotIn))
                    and isinstance(node.comparators[0], ast.Name)
                    and node.comparators[0].id == "progress"):
                key = _const_str(node.left)
                if key:
                    reads.setdefault(key, (src.rel, node.lineno, src))
            # progress["field"]
            if (isinstance(node, ast.Subscript)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "progress"
                    and isinstance(node.ctx, ast.Load)):
                key = _const_str(node.slice)
                if key:
                    reads.setdefault(key, (src.rel, node.lineno, src))
    if not writes or not reads:
        return
    for key, (rel, line, src) in sorted(writes.items()):
        if key not in reads:
            linter._emit(
                "beacon-parity", rel, line,
                f"beacon field {key!r} is shipped on every heartbeat "
                f"but no coordinator fold reads it — dead payload "
                f"(delete it, or wire the fold)", src)
    for key, (rel, line, src) in sorted(reads.items()):
        if key not in writes:
            linter._emit(
                "beacon-parity", rel, line,
                f"coordinator fold reads beacon field {key!r}, which no "
                f"executor beacon writes — the branch can never fire",
                src)


# ---------------------------------------------------------------------------
# terminal-state
# ---------------------------------------------------------------------------
def _check_terminal_state(linter, srcs) -> None:
    for src in srcs:
        if not _under(src, "coordinator"):
            continue
        for fn in _functions(src.tree):
            if _TERMINAL_EXEMPT.search(fn.name):
                continue
            stores = [
                node for node in ast.walk(fn)
                if isinstance(node, ast.Assign) and node.targets
                and isinstance(node.targets[0], ast.Attribute)
                and node.targets[0].attr == "status"
                and isinstance(node.targets[0].value, ast.Name)
                # self.status is the SESSION reduction, not a task
                # transition — tasks arrive as locals (t, task).
                and node.targets[0].value.id != "self"]
            if not stores:
                continue
            guarded = any(
                isinstance(node, ast.Attribute)
                and node.attr == "terminal"
                for node in ast.walk(fn))
            if guarded:
                continue
            for node in stores:
                linter._emit(
                    "terminal-state", src.rel, node.lineno,
                    f"{fn.name!r} assigns a task status without testing "
                    f".terminal first — a transition out of SUCCEEDED/"
                    f"FAILED/KILLED resurrects a closed task identity "
                    f"(only the journaled epoch-reset/absorb paths may)",
                    src)


# ---------------------------------------------------------------------------
# metrics-registry
# ---------------------------------------------------------------------------
def _check_metrics_registry(linter, srcs) -> None:
    from tony_tpu_torch.metrics import SERIES

    referenced: Set[str] = set()
    metrics_src = None
    for src in srcs:
        if src.rel.endswith(os.path.join("tony_tpu_torch", "metrics.py")):
            metrics_src = src
            # The registry file itself defines the names; its literals
            # are the registry, not references.
            continue
        for node in ast.walk(src.tree):
            name = _const_str(node)
            if name is None or not _SERIES_NAME_RE.match(name):
                continue
            referenced.add(name)
            if name in SERIES:
                continue
            # A prefix of a registered family is a deliberate family
            # match (the portal filters rendered lines by startswith),
            # same shape as conf-key's key-family mentions.
            if any(k.startswith(name) for k in SERIES):
                continue
            linter._emit(
                "metrics-registry", src.rel, node.lineno,
                f"series {name!r} is not registered in "
                f"tony_tpu_torch.metrics.SERIES — the docs/portal/benchdiff "
                f"surfaces can't see it (register it, with its help "
                f"line, or fix the typo)", src)
    series_line = 1
    if metrics_src is not None:
        for node in metrics_src.tree.body:
            if (isinstance(node, ast.Assign)
                    and any(isinstance(t, ast.Name) and t.id == "SERIES"
                            for t in node.targets)):
                series_line = node.lineno
                break
    for name in sorted(set(SERIES) - referenced):
        linter._emit(
            "metrics-registry",
            metrics_src.rel if metrics_src else "tony_tpu_torch/metrics.py",
            series_line,
            f"series {name!r} is registered in metrics.SERIES but "
            f"nothing in the package references it — dead registry "
            f"entry (delete it, or wire the exporter)", metrics_src)
