"""tonylint — project-specific static analysis for the tony-tpu control plane.

Seven PRs in, the orchestrator's correctness rests on implicit registries
(conf keys, fault sites, ``EventType`` members, the RPC method surface)
and disciplines (durable job-dir writes, monotonic deadline clocks, span
and thread hygiene, no blocking under coordinator locks) that were
enforced only by convention and a couple of one-off parity smokes. The
reference made exactly this a first-class concern — its
``TestTonyConfigurationFields.java`` gates keys↔defaults agreement — and
this module generalizes that to every registry the project grew since.

Pure stdlib ``ast``; no third-party linter framework. Scope: the
``tony_tpu_torch`` package (rule ``rpc-parity`` additionally reads ``tests/``
for call sites, so a handler only tests exercise is not "dead").

Rules (ids are what ``# tony: lint-ignore[<rule>]`` suppresses):

==============  ============================================================
conf-key        every ``tony.*`` dotted token in a string literal outside
                ``conf/keys.py`` must resolve to a registered ConfigKey, a
                dynamic per-jobtype key, or a registered key family prefix
fault-site      ``faults.fire/check/fire_amount/check_partition`` call
                sites use literal site names from ``faults.SITES``; every
                listed site has at least one call site (both directions,
                like the reference's fault-hook constants)
event-type      events are built only from live ``EventType`` members;
                ``diagnosis/rules.py`` ``events_used`` tuples and
                ``events_of("...")`` strings reference only live members
rpc-parity      every method name a client ``.call("...")``s has a
                registered server handler, and every handler has at least
                one call site (package or tests) — no dead surface
durable-write   no hand-rolled ``os.replace`` outside ``utils/durable.py``
                and no bare ``open(..., "w")`` targeting a job-dir
                artifact: route through ``atomic_write``/``AppendLog``/
                ``durable_replace`` so a torn write is never adopted
clock           ``time.time()`` must not feed deadline/duration arithmetic
                (+/- or comparisons) — monotonic only; wall time is for
                timestamp anchors (bare assignment, ``* 1000`` stamps)
span-leak       a span from ``start_span`` must be context-managed or have
                a matching ``.end(`` (same function for locals, same
                module for ``self._x`` spans)
thread-leak     ``threading.Thread`` must be daemonized or joined in the
                constructing function
lock-blocking   no blocking calls (sleep, wait, join, rpc ``.call``,
                fsync, subprocess) inside ``with self._lock:`` bodies in
                ``coordinator/`` modules
bare-except     no ``except:`` — name what you catch
defaults-md     ``conf/defaults.md`` is exactly the registry's rendered
                table (the reference keys↔defaults-file parity gate)
==============  ============================================================

Six further v2 *protocol* rules (directive-parity, journal-parity,
fence-coverage, beacon-parity, terminal-state, metrics-registry) extract
both halves of the coordinator↔executor protocol — heartbeat directives,
REC_* journal record types, gen/mgen fences, beacon fields, terminal
task-state discipline, the tony_* metrics registry — and check them
against each other; they live in ``devtools/protocol.py`` and their
runtime counterparts in ``devtools/invariants.py`` (``tony-tpu check``).

Output contract: findings carry ``file:line`` + rule id; the CLI
(``python -m tony_tpu_torch.cli lint``) exits nonzero on any finding and
can emit JSON; the tier-1 test (``tests/test_torch_lint.py``) asserts
that the port's tree reports exactly the known findings of its unported
modules (ROADMAP queue A), so deleting a still-referenced conf key,
fault site or EventType member fails the suite with the exact reference
location.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from tony_tpu_torch.devtools.protocol import RULES_V2, run_protocol_rules
from tony_tpu_torch.devtools.race import RULES_RACE, run_race_rules

#: rule id → one-line description (the ``--list`` surface and the doc table)
RULES: Dict[str, str] = {
    "conf-key": "tony.* string literals resolve to registered config keys",
    "fault-site": "faults.fire/check sites match the canonical SITES list",
    "event-type": "events and diagnosis rules use live EventType members",
    "rpc-parity": "client .call() names and server handlers agree 1:1",
    "durable-write": "job-dir artifacts go through utils/durable, not "
                     "bare open/os.replace",
    "clock": "time.time() never feeds deadline/duration arithmetic",
    "span-leak": "started spans are context-managed or .end()ed",
    "thread-leak": "threads are daemonized or joined",
    "lock-blocking": "no blocking calls while holding coordinator/fleet "
                     "locks",
    "bare-except": "no bare except:",
    "defaults-md": "conf/defaults.md matches the key registry",
    "alert-registry": "default alert-pack series resolve in "
                      "metrics.SERIES and every shipped rule is "
                      "exercised by a test",
}
# v2 protocol rules (devtools/protocol.py): the coordinator↔executor
# directive/journal/fence/beacon/terminal/metrics contracts, both sides.
RULES.update(RULES_V2)
# guarded-by rules (devtools/race.py): the static half of the race
# detector — GUARDED_BY-declared fields only touched under their lock,
# and no undeclared shared-field stores on instrumented classes.
RULES.update(RULES_RACE)

_SUPPRESS_RE = re.compile(r"tony:\s*lint-ignore\[([a-z\-]+)\]")
_KEY_TOKEN_RE = re.compile(
    r"tony\.[a-z][a-z0-9_\-]*(?:\.[a-z0-9_\-]+)*")
#: dotted tokens whose last segment is one of these are file names
#: ("job.tony.json", "tony.xml"), not config-key references
_FILE_EXTS = ("xml", "json", "jsonl", "yaml", "yml", "md", "py", "log",
              "prom", "addr", "pgid")
_RPC_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*(?:\.[a-z][a-z0-9_]*)?$")

#: job-dir artifact files whose torn read changes a control-flow decision
#: (lease adoption, recovery, verified restore): writes must be durable.
#: Matched as substrings of the unparsed path expression, so both the
#: literal basename and the module-level *_FILE constant naming it hit.
_ARTIFACTS = (
    "ready.json", "lease.json", "adopted.json", "pool-exit.json",
    "pool.addr", "tony-final.json", "session.journal", "incident.json",
    "metrics.counters", "tony-manifest", ".tony-localized",
    "perf.json", "profile-request.json",
    "fleet.addr", "fleet.journal", "fleet.status", "fleet.counters",
    "fleet.incident", "health.cordon",
    "READY_FILE", "LEASE_FILE", "ADOPTED_FILE", "POOL_EXIT_FILE",
    "POOL_ADDR_FILE", "FINAL_CONFIG_FILE", "JOURNAL_FILE",
    "INCIDENT_FILE", "METRICS_COUNTERS_FILE", "MANIFEST_NAME",
    "MANIFEST_FILE", "addr_file", "PERF_FILE", "PROFILE_REQUEST_FILE",
    "FLEET_ADDR_FILE", "FLEET_JOURNAL_FILE", "FLEET_STATUS_FILE",
    "FLEET_COUNTERS_FILE", "FLEET_INCIDENT_FILE", "FLEET_CORDON_FILE",
)

#: attribute names whose call blocks (or can block) the calling thread —
#: forbidden while a coordinator/session lock is held (rule lock-blocking)
_BLOCKING_ATTRS = {
    "sleep", "wait", "join", "call", "fsync", "sendall", "recv",
    "connect", "communicate", "check_call", "check_output", "run_job",
}
_BLOCKING_NAMES = {"fsync_file", "fsync_dir", "atomic_write",
                   "durable_replace", "sleep"}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    file: str          # repo-relative path
    line: int
    message: str

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return f"{self.file}:{self.line}: [{self.rule}] {self.message}"


class _Src:
    """One parsed source file."""

    def __init__(self, path: str, rel: str) -> None:
        self.path = path
        self.rel = rel
        with open(path, "r", encoding="utf-8") as f:
            self.text = f.read()
        self.lines = self.text.splitlines()
        self.tree = ast.parse(self.text, filename=rel)
        self._parents: Optional[Dict[ast.AST, ast.AST]] = None

    def parent_map(self) -> Dict[ast.AST, ast.AST]:
        if self._parents is None:
            self._parents = {}
            for node in ast.walk(self.tree):
                for child in ast.iter_child_nodes(node):
                    self._parents[child] = node
        return self._parents

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        parents = self.parent_map()
        cur = parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = parents.get(cur)
        return None


def _is_call_to(node: ast.AST, obj: str, attrs: Iterable[str]) -> bool:
    """Is ``node`` a Call of ``obj.attr(...)`` for attr in attrs?"""
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in set(attrs)
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == obj)


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _contains_time_time(node: ast.AST) -> Optional[int]:
    """Line of a ``time.time()`` call anywhere under ``node``, else None."""
    for sub in ast.walk(node):
        if _is_call_to(sub, "time", ("time",)):
            return sub.lineno
    return None


class Linter:
    def __init__(self, repo_root: Optional[str] = None) -> None:
        if repo_root is None:
            repo_root = os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__))))
        self.root = repo_root
        self.pkg = os.path.join(repo_root, "tony_tpu_torch")
        self.tests = os.path.join(repo_root, "tests")
        self.findings: List[Finding] = []
        self.suppressed: List[Finding] = []

    # -- plumbing --------------------------------------------------------
    def _py_files(self, base: str) -> List[str]:
        out = []
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__", ".git")]
            out.extend(os.path.join(dirpath, f) for f in filenames
                       if f.endswith(".py"))
        return sorted(out)

    def _sources(self, base: str) -> List[_Src]:
        out = []
        for path in self._py_files(base):
            rel = os.path.relpath(path, self.root)
            try:
                out.append(_Src(path, rel))
            except SyntaxError as e:
                self._emit("conf-key", rel, e.lineno or 1,
                           f"file does not parse: {e.msg}", src=None)
        return out

    def _emit(self, rule: str, rel: str, line: int, message: str,
              src: Optional[_Src]) -> None:
        f = Finding(rule, rel, line, message)
        if src is not None and 1 <= line <= len(src.lines):
            m = _SUPPRESS_RE.search(src.lines[line - 1])
            if m and m.group(1) == rule:
                self.suppressed.append(f)
                return
        self.findings.append(f)

    # -- entry point -----------------------------------------------------
    def run(self, rules: Optional[Sequence[str]] = None) -> List[Finding]:
        active = set(rules) if rules else set(RULES)
        unknown = active - set(RULES)
        if unknown:
            raise ValueError(f"unknown lint rule(s) {sorted(unknown)}; "
                             f"known: {sorted(RULES)}")
        pkg_srcs = self._sources(self.pkg)
        per_file = {
            "conf-key": self._check_conf_keys,
            "event-type": self._check_event_types,
            "durable-write": self._check_durable_writes,
            "clock": self._check_clock,
            "span-leak": self._check_span_leak,
            "thread-leak": self._check_thread_leak,
            "lock-blocking": self._check_lock_blocking,
            "bare-except": self._check_bare_except,
        }
        for src in pkg_srcs:
            for rule, fn in per_file.items():
                if rule in active:
                    fn(src)
        if "fault-site" in active:
            self._check_fault_sites(pkg_srcs)
        if "alert-registry" in active:
            self._check_alert_registry(pkg_srcs)
        if "rpc-parity" in active:
            self._check_rpc_parity(pkg_srcs)
        if "defaults-md" in active:
            self._check_defaults_md()
        run_protocol_rules(self, pkg_srcs, active)
        run_race_rules(self, pkg_srcs, active)
        self.findings.sort(key=lambda f: (f.file, f.line, f.rule))
        return self.findings

    # -- conf-key --------------------------------------------------------
    def _check_conf_keys(self, src: _Src) -> None:
        if src.rel.endswith(os.path.join("conf", "keys.py")):
            return
        from tony_tpu_torch.conf import keys as K

        registered = set(K.registry())
        for node in ast.walk(src.tree):
            text = _const_str(node)
            if text is None or "tony." not in text:
                continue
            for tok in _KEY_TOKEN_RE.findall(text):
                if tok in registered or K.parse_job_key(tok):
                    continue
                if tok.rsplit(".", 1)[-1] in _FILE_EXTS:
                    continue    # "job.tony.json": a file name, not a key
                # prose mention of a key family ("tony.fault.<site>",
                # "tony.application.security.tls-*")
                if any(k.startswith(tok + ".") for k in registered):
                    continue
                if tok.endswith("-") and any(
                        k.startswith(tok) for k in registered):
                    continue
                self._emit(
                    "conf-key", src.rel, node.lineno,
                    f"string references {tok!r}, which is not a "
                    f"registered ConfigKey (conf/keys.py), a dynamic "
                    f"per-jobtype key, or a registered key family", src)

    # -- fault-site ------------------------------------------------------
    def _check_fault_sites(self, srcs: List[_Src]) -> None:
        from tony_tpu_torch import faults

        listed = set(faults.SITES)
        used: Dict[str, Tuple[str, int]] = {}
        faults_rel = None
        for src in srcs:
            if src.rel.endswith(os.path.join("tony_tpu_torch", "faults.py")):
                faults_rel = src
                continue
            for node in ast.walk(src.tree):
                if not _is_call_to(node, "faults",
                                   ("fire", "check", "fire_amount",
                                    "check_partition")):
                    continue
                site = _const_str(node.args[0]) if node.args else None
                if site is None:
                    self._emit("fault-site", src.rel, node.lineno,
                               "fault site must be a string literal so "
                               "the call site is statically checkable",
                               src)
                    continue
                used.setdefault(site, (src.rel, node.lineno))
                if site not in listed:
                    self._emit(
                        "fault-site", src.rel, node.lineno,
                        f"fault site {site!r} is not in faults.SITES "
                        f"(canonical list; add it there + a conf key)",
                        src)
        sites_line = 1
        if faults_rel is not None:
            for node in ast.walk(faults_rel.tree):
                if isinstance(node, ast.Assign) and any(
                        isinstance(t, ast.Name) and t.id == "SITES"
                        for t in node.targets):
                    sites_line = node.lineno
                    break
        for site in sorted(listed - set(used)):
            self._emit(
                "fault-site",
                faults_rel.rel if faults_rel else "tony_tpu_torch/faults.py",
                sites_line,
                f"fault site {site!r} is listed in faults.SITES but has "
                f"no fire/check call site — dead site or missed wiring",
                faults_rel)

    # -- alert-registry --------------------------------------------------
    def _check_alert_registry(self, srcs: List[_Src]) -> None:
        """Both directions of the default alert-pack contract: every
        metric family a shipped rule evaluates must be a registered
        ``metrics.SERIES`` entry (an alert over a family nobody emits
        can never fire), and every shipped rule name must appear as a
        string literal in some test (a rule nobody exercises is a
        paging policy with no proof)."""
        from tony_tpu_torch import metrics as M
        from tony_tpu_torch.alerts import rules as AR

        pack = list(AR.default_job_pack()) + list(AR.default_fleet_pack())
        rules_src = None
        for src in srcs:
            if src.rel.endswith(os.path.join("alerts", "rules.py")):
                rules_src = src
                break
        rules_rel = (rules_src.rel if rules_src
                     else os.path.join("tony_tpu_torch", "alerts", "rules.py"))

        def _literal_line(text: str) -> int:
            if rules_src is not None:
                for node in ast.walk(rules_src.tree):
                    if _const_str(node) == text:
                        return node.lineno
            return 1

        for rule in pack:
            if rule.series not in M.SERIES:
                self._emit(
                    "alert-registry", rules_rel,
                    _literal_line(rule.series),
                    f"default alert rule {rule.name!r} evaluates metric "
                    f"family {rule.series!r}, which is not registered in "
                    f"metrics.SERIES — it can never fire", rules_src)
        tests_dir = os.path.join(self.root, "tests")
        if not os.path.isdir(tests_dir):
            self._emit(
                "alert-registry", rules_rel, 1,
                "tests/ directory not found — cannot prove the default "
                "alert pack is exercised by tests", rules_src)
            return
        names = {r.name for r in pack}
        referenced: Set[str] = set()
        for src in self._sources(tests_dir):
            for node in ast.walk(src.tree):
                text = _const_str(node)
                if text is not None and text in names:
                    referenced.add(text)
            if referenced == names:
                break
        for rule in pack:
            if rule.name not in referenced:
                self._emit(
                    "alert-registry", rules_rel,
                    _literal_line(rule.name),
                    f"default alert rule {rule.name!r} is not referenced "
                    f"by any test under tests/ — every shipped rule must "
                    f"be exercised", rules_src)

    # -- event-type ------------------------------------------------------
    def _check_event_types(self, src: _Src) -> None:
        if src.rel.endswith(os.path.join("events", "events.py")):
            return
        from tony_tpu_torch.events.events import EventType

        members = {e.name for e in EventType}

        def _check_name(name: str, line: int, what: str) -> None:
            if name not in members:
                self._emit(
                    "event-type", src.rel, line,
                    f"{what} references EventType member {name!r}, which "
                    f"does not exist (events/events.py)", src)

        in_rules = src.rel.endswith(os.path.join("diagnosis", "rules.py"))
        for node in ast.walk(src.tree):
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "EventType"):
                _check_name(node.attr, node.lineno, "attribute access")
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "Event" and node.args):
                first = node.args[0]
                ok = ((isinstance(first, ast.Attribute)
                       and isinstance(first.value, ast.Name)
                       and first.value.id == "EventType")
                      or (isinstance(first, ast.Call)
                          and isinstance(first.func, ast.Name)
                          and first.func.id == "EventType"))
                if not ok:
                    self._emit(
                        "event-type", src.rel, node.lineno,
                        "Event(...) must be constructed with an EventType "
                        "member (no raw strings/variables — the registry "
                        "is the contract)", src)
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "events_of" and node.args):
                s = _const_str(node.args[0])
                if s is not None:
                    _check_name(s, node.lineno, "events_of()")
            if (in_rules and isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "_rule"):
                tup = None
                if len(node.args) >= 3:
                    tup = node.args[2]
                for kw in node.keywords:
                    if kw.arg == "events_used":
                        tup = kw.value
                if isinstance(tup, ast.Tuple):
                    for el in tup.elts:
                        s = _const_str(el)
                        if s is not None:
                            _check_name(s, el.lineno,
                                        "rule events_used")

    # -- rpc-parity ------------------------------------------------------
    def _check_rpc_parity(self, srcs: List[_Src]) -> None:
        handlers: Dict[str, Tuple[str, int, _Src]] = {}
        for src in srcs:
            service_classes: Set[str] = set()
            for node in ast.walk(src.tree):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Name)
                        and node.func.id == "RpcServer" and node.args):
                    first = node.args[0]
                    if (isinstance(first, ast.Call)
                            and isinstance(first.func, ast.Name)):
                        service_classes.add(first.func.id)
                    elif isinstance(first, ast.Name):
                        service_classes.add(first.id)
            if not service_classes:
                continue
            for node in ast.walk(src.tree):
                if (isinstance(node, ast.ClassDef)
                        and node.name in service_classes):
                    for item in node.body:
                        if not isinstance(item, (ast.FunctionDef,
                                                 ast.AsyncFunctionDef)):
                            continue
                        if item.name.startswith("_"):
                            continue
                        rpc_name = item.name.replace("__", ".")
                        handlers[rpc_name] = (src.rel, item.lineno, src)

        callers: Dict[str, Tuple[str, int, _Src]] = {}
        caller_srcs = list(srcs)
        if os.path.isdir(self.tests):
            caller_srcs += self._sources(self.tests)
        for src in caller_srcs:
            for node in ast.walk(src.tree):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "call" and node.args):
                    continue
                if (isinstance(node.func.value, ast.Name)
                        and node.func.value.id == "subprocess"):
                    continue
                name = _const_str(node.args[0])
                if name is None or not _RPC_NAME_RE.match(name):
                    continue
                callers.setdefault(name, (src.rel, node.lineno, src))
                if (name not in handlers
                        and src.rel.startswith("tony_tpu_torch")):
                    self._emit(
                        "rpc-parity", src.rel, node.lineno,
                        f"client calls RPC method {name!r}, but no "
                        f"registered server handler defines it", src)
        for name, (rel, line, hsrc) in sorted(handlers.items()):
            if name not in callers:
                self._emit(
                    "rpc-parity", rel, line,
                    f"RPC handler {name!r} has no call site in the "
                    f"package or tests — dead surface (delete it, or "
                    f"cover it)", hsrc)

    # -- durable-write ---------------------------------------------------
    def _check_durable_writes(self, src: _Src) -> None:
        if src.rel.endswith(os.path.join("utils", "durable.py")):
            return
        for node in ast.walk(src.tree):
            if _is_call_to(node, "os", ("replace",)):
                self._emit(
                    "durable-write", src.rel, node.lineno,
                    "hand-rolled os.replace: a rename is only durable "
                    "after file+dir fsync — use utils.durable "
                    "atomic_write / durable_replace / fsync_path", src)
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "open"
                    and len(node.args) >= 2):
                mode = _const_str(node.args[1])
                if mode is None or "w" not in mode:
                    continue
                target = ast.unparse(node.args[0])
                hit = next((a for a in _ARTIFACTS if a in target), None)
                if hit is not None:
                    self._emit(
                        "durable-write", src.rel, node.lineno,
                        f"bare open(..., {mode!r}) targets job-dir "
                        f"artifact {hit!r}: a torn write could be "
                        f"adopted as valid state — use "
                        f"utils.durable.atomic_write", src)

    # -- clock -----------------------------------------------------------
    def _check_clock(self, src: _Src) -> None:
        flagged: Set[int] = set()
        for node in ast.walk(src.tree):
            line: Optional[int] = None
            if isinstance(node, ast.BinOp) and isinstance(
                    node.op, (ast.Add, ast.Sub)):
                line = (_contains_time_time(node.left)
                        or _contains_time_time(node.right))
            elif isinstance(node, ast.Compare):
                line = _contains_time_time(node.left)
                for cmp_ in node.comparators:
                    line = line or _contains_time_time(cmp_)
            if line is not None and line not in flagged:
                flagged.add(line)
                self._emit(
                    "clock", src.rel, line,
                    "time.time() feeds deadline/duration arithmetic — an "
                    "NTP step skews it; use time.monotonic() (wall time "
                    "is for timestamp anchors only)", src)

    # -- span-leak -------------------------------------------------------
    def _check_span_leak(self, src: _Src) -> None:
        attr_ends: Set[str] = set()
        for node in ast.walk(src.tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "end"
                    and isinstance(node.func.value, ast.Attribute)):
                attr_ends.add(node.func.value.attr)
        for node in ast.walk(src.tree):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)
                    and isinstance(node.value.func, ast.Attribute)
                    and node.value.func.attr == "start_span"):
                continue
            if len(node.targets) != 1:
                continue
            target = node.targets[0]
            if isinstance(target, ast.Subscript):
                continue    # tracked collections have their own lifecycle
            if isinstance(target, ast.Attribute):
                if target.attr not in attr_ends:
                    self._emit(
                        "span-leak", src.rel, node.lineno,
                        f"span stored on .{target.attr} is never "
                        f".end()ed in this module — it will report as "
                        f"unclosed in the trace export", src)
                continue
            if not isinstance(target, ast.Name):
                continue
            fn = src.enclosing_function(node)
            scope = fn if fn is not None else src.tree
            closed = False
            for sub in ast.walk(scope):
                if (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr == "end"
                        and isinstance(sub.func.value, ast.Name)
                        and sub.func.value.id == target.id):
                    closed = True
                if (isinstance(sub, ast.withitem)
                        and sub.context_expr is node.value):
                    closed = True
            if not closed:
                self._emit(
                    "span-leak", src.rel, node.lineno,
                    f"span {target.id!r} is started but never .end()ed "
                    f"in the enclosing function (use `with` or end it "
                    f"on every path)", src)

    # -- thread-leak -----------------------------------------------------
    def _check_thread_leak(self, src: _Src) -> None:
        for node in ast.walk(src.tree):
            is_thread = (_is_call_to(node, "threading", ("Thread",))
                         or (isinstance(node, ast.Call)
                             and isinstance(node.func, ast.Name)
                             and node.func.id == "Thread"))
            if not is_thread:
                continue
            daemon = False
            for kw in node.keywords:
                if (kw.arg == "daemon"
                        and isinstance(kw.value, ast.Constant)
                        and kw.value.value is True):
                    daemon = True
            if daemon:
                continue
            fn = src.enclosing_function(node)
            scope = fn if fn is not None else src.tree
            handled = False
            for sub in ast.walk(scope):
                if (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr == "join"):
                    handled = True
                if (isinstance(sub, ast.Assign)
                        and any(isinstance(t, ast.Attribute)
                                and t.attr == "daemon"
                                for t in sub.targets)):
                    handled = True
            if not handled:
                self._emit(
                    "thread-leak", src.rel, node.lineno,
                    "thread is neither daemon=True nor joined in the "
                    "constructing function — it can outlive teardown "
                    "and wedge interpreter exit", src)

    # -- lock-blocking ---------------------------------------------------
    def _check_lock_blocking(self, src: _Src) -> None:
        # Control-plane scope: the coordinator AND the fleet daemon both
        # hold locks that RPC handlers and monitor/scheduler ticks
        # contend for (thread-leak needs no such extension — it already
        # sweeps the whole package).
        if not any((os.sep + d + os.sep) in src.rel
                   for d in ("coordinator", "fleet")):
            return
        lock_attrs: Set[str] = set()
        for node in ast.walk(src.tree):
            if (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)
                    and _is_call_to(node.value, "threading",
                                    ("Lock", "RLock"))):
                for t in node.targets:
                    if isinstance(t, ast.Attribute):
                        lock_attrs.add(t.attr)
        if not lock_attrs:
            return
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.With):
                continue
            held = any(
                isinstance(item.context_expr, ast.Attribute)
                and item.context_expr.attr in lock_attrs
                for item in node.items)
            if not held:
                continue
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    if not isinstance(sub, ast.Call):
                        continue
                    name = None
                    if (isinstance(sub.func, ast.Attribute)
                            and sub.func.attr in _BLOCKING_ATTRS):
                        name = sub.func.attr
                        if name == "join" and not self._is_thread_join(sub):
                            name = None
                    elif (isinstance(sub.func, ast.Name)
                          and sub.func.id in _BLOCKING_NAMES):
                        name = sub.func.id
                    elif (isinstance(sub.func, ast.Attribute)
                          and isinstance(sub.func.value, ast.Name)
                          and sub.func.value.id == "subprocess"):
                        name = f"subprocess.{sub.func.attr}"
                    if name is not None:
                        self._emit(
                            "lock-blocking", src.rel, sub.lineno,
                            f"blocking call {name!r} while holding a "
                            f"coordinator lock: every RPC handler and "
                            f"monitor tick behind that lock stalls with "
                            f"it — move the blocking work outside the "
                            f"critical section", src)

    @staticmethod
    def _is_thread_join(call: ast.Call) -> bool:
        """Distinguish Thread.join([timeout]) from str.join(iterable) and
        os.path.join(a, b, ...): thread joins take zero args or one
        numeric/keyword timeout; the others take string/iterable args."""
        assert isinstance(call.func, ast.Attribute)
        if isinstance(call.func.value, ast.Constant):
            return False        # ", ".join(...)
        if (isinstance(call.func.value, ast.Attribute)
                and call.func.value.attr == "path") or (
                isinstance(call.func.value, ast.Name)
                and call.func.value.id in ("os", "path", "posixpath")):
            return False        # os.path.join(...)
        if len(call.args) > 1:
            return False
        if call.args and isinstance(call.args[0], ast.Constant) \
                and isinstance(call.args[0].value, str):
            return False
        return True

    # -- bare-except -----------------------------------------------------
    def _check_bare_except(self, src: _Src) -> None:
        for node in ast.walk(src.tree):
            if isinstance(node, ast.ExceptHandler) and node.type is None:
                self._emit(
                    "bare-except", src.rel, node.lineno,
                    "bare except: swallows SystemExit/KeyboardInterrupt "
                    "and every bug — name the exceptions you mean", src)

    # -- defaults-md -----------------------------------------------------
    def _check_defaults_md(self) -> None:
        from tony_tpu_torch.conf import keys as K

        path = os.path.join(self.pkg, "conf", "defaults.md")
        rel = os.path.relpath(path, self.root)
        try:
            with open(path, "r", encoding="utf-8") as f:
                on_disk = f.read()
        except OSError:
            self._emit("defaults-md", rel, 1,
                       "conf/defaults.md is missing — run "
                       "`python -m tony_tpu_torch.conf.keys`", None)
            return
        if on_disk != K.defaults_markdown():
            self._emit("defaults-md", rel, 1,
                       "conf/defaults.md is stale against the key "
                       "registry — run `python -m tony_tpu_torch.conf.keys`",
                       None)


def run_lint(repo_root: Optional[str] = None,
             rules: Optional[Sequence[str]] = None
             ) -> Tuple[List[Finding], List[Finding]]:
    """Run the lint; returns (findings, suppressed)."""
    linter = Linter(repo_root)
    linter.run(rules)
    return linter.findings, linter.suppressed


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="tony-tpu lint",
        description="Project invariant checker (see docs/development.md).")
    p.add_argument("--root", default=None,
                   help="repo root (default: the installed package's)")
    p.add_argument("--rule", action="append", default=None,
                   help="run only this rule (repeatable)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit findings as a JSON array")
    p.add_argument("--list", action="store_true",
                   help="list rule ids and exit")
    args = p.parse_args(argv)
    if args.list:
        for rule, desc in RULES.items():
            print(f"{rule:14s} {desc}")
        return 0
    findings, suppressed = run_lint(args.root, args.rule)
    if args.as_json:
        print(json.dumps({
            "findings": [f.to_dict() for f in findings],
            "suppressed": [f.to_dict() for f in suppressed],
        }, indent=1, sort_keys=True))
    else:
        for f in findings:
            print(f)
        if suppressed:
            print(f"({len(suppressed)} suppressed via lint-ignore)",
                  file=sys.stderr)
        if findings:
            print(f"{len(findings)} finding(s)", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
