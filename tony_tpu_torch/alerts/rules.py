"""Declarative alert rules, the pending→firing→resolved state machine,
and SLO error-budget burn-rate accounting.

A :class:`Rule` names a metric family (resolved against
``tony_tpu_torch.metrics.SERIES`` — tonylint's ``alert-registry`` rule holds
that both ways), a comparison, and a for-duration; the
:class:`AlertEngine` evaluates a pack of rules against a *source* each
tick and walks each rule through ``ok → pending → firing → resolved``.
One bad tick never pages: a breach must persist ``for_s`` seconds
(hysteresis) before the transition to ``firing``.

Rule kinds:

==========  =============================================================
gauge       the family's latest sample breaches the threshold
rate        windowed increase/second (``MetricsRegistry.rate``) over a
            counter — or a cumulative gauge, which makes the rate a
            *fraction of wall time* (the live INPUT_BOUND signal)
quantile    windowed quantile (``MetricsRegistry.quantile_over``) over a
            histogram ring breaches a latency bound
absent      the family has no samples at all — dead telemetry
burn        multi-window error-budget burn rate from an :class:`Slo`:
            ``bad_fraction(window) / (1 - objective)`` must exceed the
            factor on BOTH the long and the short window (the classic
            two-window page discipline: sensitive to fast burns, immune
            to old stale breaches)
==========  =============================================================

Every rule evaluates across all label sets of its family that contain
``match`` — a per-task family breaches when ANY task breaches, and the
worst offender's labels ride the transition as evidence.

Sources: :class:`RegistrySource` (a live ``MetricsRegistry`` — the
coordinator monitor tick and the fleet daemon tick) and
:class:`PromSource` (a parsed ``metrics.prom`` exposition — the CI
fixture smoke and offline evaluation; windowed kinds that need history
are honestly *unevaluable* there and never fire, except ``burn``, which
degrades to the instantaneous bad-fraction of the snapshot).

An unevaluable rule (missing family, no samples in window) keeps its
current state: absent data neither pages nor resolves a firing alert.

Stdlib only; no tony_tpu_torch imports beyond the SERIES registry, so the
no-deps CI lint job can run the fixture smoke (`python -m
tony_tpu_torch.alerts`).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

# -- alert states ------------------------------------------------------------
STATE_OK = "ok"
STATE_PENDING = "pending"
STATE_FIRING = "firing"
#: journaled transition closing a pending or firing episode
STATE_RESOLVED = "resolved"

#: every state a REC_ALERT / REC_FLEET_ALERT record may carry
JOURNAL_STATES = (STATE_PENDING, STATE_FIRING, STATE_RESOLVED)

SEV_PAGE = "page"
SEV_WARN = "warn"

_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
}


@dataclasses.dataclass(frozen=True)
class Rule:
    """One declarative alert rule (see the kind table in the module
    docstring). ``threshold`` is the breach bound; ``for_s`` the
    hysteresis; ``match`` a label filter ANDed over the family's label
    sets."""

    name: str
    kind: str                   # gauge | rate | quantile | absent | burn
    series: str
    op: str = ">"
    threshold: float = 0.0
    for_s: float = 0.0
    window_s: float = 60.0
    q: float = 0.99             # quantile kind only
    match: Tuple[Tuple[str, str], ...] = ()
    severity: str = SEV_WARN
    summary: str = ""
    # burn kind only (compiled from an Slo):
    objective: float = 0.0
    long_s: float = 0.0
    short_s: float = 0.0
    factor: float = 0.0

    def __post_init__(self) -> None:
        if self.kind not in ("gauge", "rate", "quantile", "absent",
                             "burn"):
            raise ValueError(f"unknown rule kind {self.kind!r}")
        if self.op not in _OPS:
            raise ValueError(f"unknown rule op {self.op!r}")
        if self.severity not in (SEV_PAGE, SEV_WARN):
            raise ValueError(f"unknown severity {self.severity!r}")


@dataclasses.dataclass(frozen=True)
class Slo:
    """A service-level objective over a continuous signal: a sample is
    *bad* when ``op(sample, threshold)`` holds, the error budget is
    ``1 - objective``, and the derived rule pages when the budget burns
    at ``factor``x on both windows. ``compile()`` lowers it to a
    ``burn`` :class:`Rule` so the one state machine drives both plain
    rules and SLOs."""

    name: str
    series: str
    op: str
    threshold: float
    objective: float = 0.9
    long_s: float = 300.0
    short_s: float = 60.0
    factor: float = 2.0
    for_s: float = 0.0
    match: Tuple[Tuple[str, str], ...] = ()
    severity: str = SEV_PAGE
    summary: str = ""

    def compile(self) -> Rule:
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"SLO objective must be in (0, 1), got {self.objective}")
        return Rule(
            name=self.name, kind="burn", series=self.series, op=self.op,
            threshold=self.threshold, for_s=self.for_s, match=self.match,
            severity=self.severity,
            summary=self.summary or f"SLO {self.name} burn-rate breach",
            objective=self.objective, long_s=self.long_s,
            short_s=self.short_s, factor=self.factor)


@dataclasses.dataclass(frozen=True)
class Transition:
    """One state-machine step the caller journals/announces. ``journal``
    is the dedup fence: False when the write-ahead journal already holds
    this (rule, state) — a recovered engine re-entering its replayed
    state must not duplicate the record."""

    rule: str
    state: str                  # pending | firing | resolved
    severity: str
    value: Optional[float]
    labels: Dict[str, str]
    summary: str
    journal: bool = True


# ---------------------------------------------------------------------------
# evaluation sources
# ---------------------------------------------------------------------------
class RegistrySource:
    """Evaluate against a live :class:`tony_tpu_torch.metrics.MetricsRegistry`
    — full windowed semantics (rate / quantile_over / gauge rings)."""

    def __init__(self, registry: Any, now: Optional[float] = None):
        self._reg = registry
        self.now = now if now is not None else time.monotonic()

    def label_sets(self, series: str) -> List[Dict[str, str]]:
        return list(self._reg.label_sets(series))

    def sample(self, series: str,
               labels: Dict[str, str]) -> Optional[float]:
        return self._reg.sample(series, labels)

    def rate(self, series: str, labels: Dict[str, str],
             window_s: float) -> Optional[float]:
        return self._reg.rate(series, labels, window_s, now=self.now)

    def quantile(self, series: str, labels: Dict[str, str],
                 window_s: float, q: float) -> Optional[float]:
        return self._reg.quantile_over(series, labels, window_s, q,
                                       now=self.now)

    def points(self, series: str,
               labels: Dict[str, str]) -> List[Tuple[float, float]]:
        return self._reg.gauge_points(series, labels)


class PromSource:
    """Evaluate against a parsed Prometheus text exposition (a
    ``metrics.prom`` snapshot). No history: ``rate`` is unevaluable
    (None), ``quantile`` uses the full-lifetime cumulative histogram,
    and ``burn`` sees each series as one instantaneous sample."""

    def __init__(self, text: str, now: Optional[float] = None):
        self.now = now if now is not None else 0.0
        # family → [(labels, value)]
        self._values: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
        # family → [(labels, {"buckets": [...], "counts": [...], count})]
        self._hists: Dict[str, List[Tuple[Dict[str, str],
                                          Dict[str, Any]]]] = {}
        self._parse(text)

    @staticmethod
    def _parse_labels(raw: str) -> Dict[str, str]:
        out: Dict[str, str] = {}
        depth = raw.strip()
        if not depth:
            return out
        for part in _split_label_pairs(depth):
            if "=" not in part:
                continue
            k, _, v = part.partition("=")
            v = v.strip()
            if v.startswith('"') and v.endswith('"'):
                v = v[1:-1]
            out[k.strip()] = (v.replace('\\"', '"')
                              .replace("\\n", "\n").replace("\\\\", "\\"))
        return out

    def _parse(self, text: str) -> None:
        # (family, labels_sans_le) → {le_bound: cum_count}
        buckets: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                      Dict[float, float]] = {}
        for line in text.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            name_part, _, value_part = line.rpartition(" ")
            name_part = name_part.strip()
            try:
                value = float(value_part)
            except ValueError:
                continue
            if "{" in name_part:
                name, _, rest = name_part.partition("{")
                labels = self._parse_labels(rest.rstrip("}"))
            else:
                name, labels = name_part, {}
            if name.endswith("_bucket") and "le" in labels:
                fam = name[:-len("_bucket")]
                le = labels.pop("le")
                bound = float("inf") if le in ("+Inf", "inf") \
                    else float(le)
                key = (fam, tuple(sorted(labels.items())))
                buckets.setdefault(key, {})[bound] = value
                continue
            if name.endswith("_sum") or name.endswith("_count"):
                continue
            self._values.setdefault(name, []).append((labels, value))
        for (fam, lkey), by_bound in buckets.items():
            bounds = sorted(b for b in by_bound if b != float("inf"))
            cum = [by_bound[b] for b in bounds]
            # de-cumulate into per-bucket counts + overflow
            counts, prev = [], 0.0
            for c in cum:
                counts.append(max(0.0, c - prev))
                prev = c
            total = by_bound.get(float("inf"), prev)
            counts.append(max(0.0, total - prev))
            self._hists.setdefault(fam, []).append(
                (dict(lkey), {"buckets": bounds, "counts": counts,
                              "count": total}))

    def label_sets(self, series: str) -> List[Dict[str, str]]:
        out = [labels for labels, _ in self._values.get(series, [])]
        out += [labels for labels, _ in self._hists.get(series, [])]
        return out

    def sample(self, series: str,
               labels: Dict[str, str]) -> Optional[float]:
        for cand, value in self._values.get(series, []):
            if cand == labels:
                return value
        return None

    def rate(self, series: str, labels: Dict[str, str],
             window_s: float) -> Optional[float]:
        return None             # no history in a snapshot — unevaluable

    def quantile(self, series: str, labels: Dict[str, str],
                 window_s: float, q: float) -> Optional[float]:
        for cand, snap in self._hists.get(series, []):
            if cand == labels:
                if not snap["count"]:
                    return None
                return bucket_quantile(snap["buckets"], snap["counts"], q)
        return None

    def points(self, series: str,
               labels: Dict[str, str]) -> List[Tuple[float, float]]:
        v = self.sample(series, labels)
        return [(self.now, v)] if v is not None else []


def _split_label_pairs(raw: str) -> List[str]:
    """Split ``a="x",b="y,z"`` on commas outside quotes."""
    out, cur, in_q, esc = [], [], False, False
    for ch in raw:
        if esc:
            cur.append(ch)
            esc = False
            continue
        if ch == "\\":
            cur.append(ch)
            esc = True
            continue
        if ch == '"':
            in_q = not in_q
        if ch == "," and not in_q:
            out.append("".join(cur))
            cur = []
            continue
        cur.append(ch)
    if cur:
        out.append("".join(cur))
    return out


def bucket_quantile(bounds: Sequence[float], counts: Sequence[float],
                    q: float) -> float:
    """Quantile from per-bucket counts (+overflow last) by linear
    interpolation inside the owning bucket — the same semantics as
    ``coordphases.histogram_quantile``, over a de-cumulated shape."""
    total = sum(counts)
    if total <= 0 or not bounds:
        return 0.0
    rank = q * total
    cum, lo = 0.0, 0.0
    for bound, c in zip(bounds, counts):
        if cum + c >= rank and c > 0:
            return lo + (bound - lo) * (rank - cum) / c
        cum += c
        lo = bound
    return float(bounds[-1])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
class _RuleState:
    __slots__ = ("state", "since", "value", "labels", "logged")

    def __init__(self) -> None:
        self.state = STATE_OK
        self.since = 0.0
        self.value: Optional[float] = None
        self.labels: Dict[str, str] = {}
        self.logged: Optional[str] = None   # last journaled state


class AlertEngine:
    """Holds a pack's per-rule state machines. Thread-safe: the
    evaluating tick and the RPC/status snapshot readers share a lock.
    ``immediate=True`` ignores for-durations (the CI fixture smoke: one
    snapshot, one verdict)."""

    def __init__(self, rules: Sequence[Rule],
                 clock: Callable[[], float] = time.monotonic,
                 immediate: bool = False):
        by_name: Dict[str, Rule] = {}
        for r in rules:
            if r.name in by_name:
                raise ValueError(f"duplicate rule name {r.name!r}")
            by_name[r.name] = r
        self._rules = by_name
        self._clock = clock
        self._immediate = immediate
        self._lock = threading.Lock()
        self._state: Dict[str, _RuleState] = {
            name: _RuleState() for name in by_name}

    @property
    def rules(self) -> List[Rule]:
        return list(self._rules.values())

    # -- recover seeding -------------------------------------------------
    def seed(self, replayed: Dict[str, str]) -> None:
        """Install the journal-replayed last state per rule (the recover
        path). ``firing`` re-arms as firing, ``pending`` restarts its
        hysteresis clock, ``resolved`` is ok — and the dedup fence
        remembers what the journal already holds, so the first
        post-recover transition into the same state is not re-journaled."""
        now = self._clock()
        with self._lock:
            for name, state in replayed.items():
                st = self._state.get(name)
                if st is None:
                    continue        # rule retired since that journal life
                st.logged = state if state in JOURNAL_STATES else None
                if state == STATE_FIRING:
                    st.state = STATE_FIRING
                    st.since = now
                elif state == STATE_PENDING:
                    st.state = STATE_PENDING
                    st.since = now
                else:
                    st.state = STATE_OK

    # -- evaluation ------------------------------------------------------
    def evaluate(self, source: Any,
                 now: Optional[float] = None) -> List[Transition]:
        """One tick: evaluate every rule against ``source`` and return
        the state transitions that happened (empty in steady state)."""
        now = now if now is not None else self._clock()
        out: List[Transition] = []
        for rule in self._rules.values():
            breached, value, labels = _evaluate_rule(rule, source)
            with self._lock:
                st = self._state[rule.name]
                if value is not None:
                    st.value, st.labels = value, labels
                if breached is None:
                    continue        # unevaluable: hold the current state
                if breached:
                    if st.state == STATE_OK:
                        if rule.for_s > 0 and not self._immediate:
                            st.state, st.since = STATE_PENDING, now
                            out.append(self._transition_locked(
                                rule, st, STATE_PENDING, value, labels))
                            continue
                        st.state, st.since = STATE_FIRING, now
                        out.append(self._transition_locked(
                            rule, st, STATE_FIRING, value, labels))
                    elif st.state == STATE_PENDING and (
                            self._immediate
                            or now - st.since >= rule.for_s):
                        st.state, st.since = STATE_FIRING, now
                        out.append(self._transition_locked(
                            rule, st, STATE_FIRING, value, labels))
                elif st.state in (STATE_PENDING, STATE_FIRING):
                    st.state, st.since = STATE_OK, now
                    out.append(self._transition_locked(
                        rule, st, STATE_RESOLVED, value, labels))
        return out

    def _transition_locked(self, rule: Rule, st: _RuleState, state: str,
                           value: Optional[float],
                           labels: Dict[str, str]) -> Transition:
        journal = st.logged != state
        st.logged = state
        return Transition(rule=rule.name, state=state,
                          severity=rule.severity, value=value,
                          labels=dict(labels),
                          summary=rule.summary or rule.name,
                          journal=journal)

    def resolve_all(self) -> List[Transition]:
        """Force every pending/firing rule back to ok (clean teardown of
        a SUCCEEDED job: the journal must not end with an alert
        firing)."""
        now = self._clock()
        out: List[Transition] = []
        with self._lock:
            for rule in self._rules.values():
                st = self._state[rule.name]
                if st.state in (STATE_PENDING, STATE_FIRING):
                    st.state, st.since = STATE_OK, now
                    out.append(self._transition_locked(
                        rule, st, STATE_RESOLVED, st.value, st.labels))
        return out

    # -- snapshots -------------------------------------------------------
    def snapshot(self) -> List[Dict[str, Any]]:
        now = self._clock()
        rows = []
        with self._lock:
            for rule in self._rules.values():
                st = self._state[rule.name]
                rows.append({
                    "rule": rule.name, "state": st.state,
                    "severity": rule.severity, "kind": rule.kind,
                    "series": rule.series,
                    "value": st.value, "labels": dict(st.labels),
                    "since_s": round(now - st.since, 3)
                    if st.state != STATE_OK else None,
                    "summary": rule.summary or rule.name})
        return rows

    def firing(self) -> List[Dict[str, Any]]:
        return [r for r in self.snapshot()
                if r["state"] == STATE_FIRING]

    def firing_count(self) -> Dict[str, int]:
        """firing tally by severity — the ``tony_alerts_firing`` gauge
        refresh (every registered severity present, so a resolve zeroes
        the gauge instead of leaving it frozen)."""
        out = {SEV_PAGE: 0, SEV_WARN: 0}
        for row in self.firing():
            out[row["severity"]] = out.get(row["severity"], 0) + 1
        return out


def _match(labels: Dict[str, str],
           match: Tuple[Tuple[str, str], ...]) -> bool:
    return all(labels.get(k) == v for k, v in match)


def _evaluate_rule(rule: Rule, source: Any
                   ) -> Tuple[Optional[bool], Optional[float],
                              Dict[str, str]]:
    """(breached, worst value, worst labels); breached None =
    unevaluable (no data — hold state)."""
    sets = [ls for ls in source.label_sets(rule.series)
            if _match(ls, rule.match)]
    if rule.kind == "absent":
        if not sets:
            return True, None, {}
        present = any(source.sample(rule.series, ls) is not None
                      or source.quantile(rule.series, ls, rule.window_s,
                                         rule.q) is not None
                      for ls in sets)
        return (not present), None, {}
    samples: List[Tuple[float, Dict[str, str]]] = []
    for ls in sets:
        if rule.kind == "gauge":
            v: Optional[float] = source.sample(rule.series, ls)
        elif rule.kind == "rate":
            v = source.rate(rule.series, ls, rule.window_s)
        elif rule.kind == "quantile":
            v = source.quantile(rule.series, ls, rule.window_s, rule.q)
        else:                       # burn
            v = _burn_rate(rule, source, ls)
        if v is not None:
            samples.append((v, ls))
    if not samples:
        return None, None, {}
    op = _OPS[rule.op]
    if rule.kind == "burn":
        # burn value is "budget-burn multiple": always bigger-is-worse
        worst, labels = max(samples, key=lambda s: s[0])
        return worst >= rule.factor, worst, labels
    breaching = [(v, ls) for v, ls in samples if op(v, rule.threshold)]
    if breaching:
        # worst offender: the sample deepest past the threshold
        worst, labels = max(
            breaching,
            key=lambda s: s[0] if rule.op in (">", ">=") else -s[0])
        return True, worst, labels
    worst, labels = max(
        samples, key=lambda s: s[0] if rule.op in (">", ">=") else -s[0])
    return False, worst, labels


def _burn_rate(rule: Rule, source: Any,
               labels: Dict[str, str]) -> Optional[float]:
    """min(burn(long), burn(short)) — the two-window AND collapsed into
    one number: >= factor exactly when BOTH windows breach."""
    points = source.points(rule.series, labels)
    if not points:
        return None
    now = getattr(source, "now", points[-1][0])
    budget = 1.0 - rule.objective
    op = _OPS[rule.op]
    burns = []
    for window in (rule.long_s, rule.short_s):
        cutoff = now - window
        in_window = [v for ts, v in points if ts >= cutoff]
        if not in_window:
            # stale series: the newest sample anchors the short window
            in_window = [points[-1][1]]
        bad = sum(1 for v in in_window if op(v, rule.threshold))
        burns.append((bad / len(in_window)) / budget)
    return min(burns)


# ---------------------------------------------------------------------------
# default packs
# ---------------------------------------------------------------------------
def _f(conf: Any, key: str, default: float) -> float:
    if conf is None:
        return default
    try:
        v = conf.get(key, default)
        return float(v) if v not in (None, "") else default
    except (TypeError, ValueError):
        return default


def default_job_pack(conf: Any = None) -> List[Rule]:
    """Job-scope defaults, evaluated on the coordinator monitor tick.
    Thresholds come from ``tony.alerts.*`` conf keys so a drill (or a
    latency-sensitive serving job) can tighten them without code."""
    from tony_tpu_torch.conf import keys as K

    for_s = _f(conf, K.ALERTS_FOR_S, 10.0)
    return [
        Rule(name="heartbeat-age", kind="gauge",
             series="tony_task_heartbeat_age_seconds", op=">",
             threshold=_f(conf, K.ALERTS_HEARTBEAT_AGE_S, 30.0),
             for_s=for_s, severity=SEV_PAGE,
             summary="a task's heartbeat age breached the liveness "
                     "budget — the gang is about to lose a member"),
        Rule(name="input-bound", kind="rate",
             series="tony_step_phase_seconds",
             match=(("phase", "data_wait"),), op=">",
             threshold=_f(conf, K.ALERTS_DATA_WAIT_FRACTION, 0.5),
             window_s=60.0, for_s=for_s * 3, severity=SEV_WARN,
             summary="the gang spends most of its wall time waiting on "
                     "input — live INPUT_BOUND (rate of the cumulative "
                     "data_wait phase = fraction of wall)"),
        Rule(name="journal-fsync-p99", kind="quantile",
             series="tony_journal_fsync_seconds", q=0.99,
             window_s=300.0, op=">",
             threshold=_f(conf, K.ALERTS_FSYNC_P99_S, 0.05),
             for_s=for_s * 3, severity=SEV_WARN,
             summary="write-ahead journal fsync p99 breached the "
                     "JOURNAL_BOUND budget (BENCH_SCALE_r01 measured "
                     "63ms at 512 wide — ROADMAP item 3 by numbers)"),
        Slo(name="step-time-slo",
            series="tony_task_steps_per_sec", op="<",
            threshold=_f(conf, K.ALERTS_MIN_STEPS_PER_SEC, 0.0),
            objective=_f(conf, K.ALERTS_SLO_OBJECTIVE, 0.9),
            long_s=_f(conf, K.ALERTS_WINDOW_LONG_S, 300.0),
            short_s=_f(conf, K.ALERTS_WINDOW_SHORT_S, 60.0),
            factor=_f(conf, K.ALERTS_BURN_FACTOR, 2.0),
            for_s=for_s, severity=SEV_PAGE,
            summary="step-time SLO budget burning: tasks below the "
                    "step-rate floor on both burn windows").compile(),
    ]


def default_fleet_pack(conf: Any = None) -> List[Rule]:
    """Fleet-scope defaults, evaluated on the fleet daemon tick. The
    fleet for-duration is long (60s) on purpose: a fleet alert is a
    capacity/goodput story, not a single-tick blip."""
    from tony_tpu_torch.conf import keys as K

    for_s = _f(conf, K.ALERTS_FLEET_FOR_S, 60.0)
    return [
        Slo(name="goodput-slo",
            series="tony_fleet_goodput_fraction", op="<",
            threshold=_f(conf, K.ALERTS_GOODPUT_FLOOR, 0.5),
            objective=_f(conf, K.ALERTS_SLO_OBJECTIVE, 0.9),
            long_s=_f(conf, K.ALERTS_WINDOW_LONG_S, 300.0) * 6,
            short_s=_f(conf, K.ALERTS_WINDOW_SHORT_S, 60.0) * 5,
            factor=_f(conf, K.ALERTS_BURN_FACTOR, 2.0),
            for_s=for_s, severity=SEV_PAGE,
            summary="fleet goodput fraction below the floor on both "
                    "burn windows — chip-seconds are burning on "
                    "overhead, not train steps").compile(),
        Rule(name="quarantine-spike", kind="rate",
             series="tony_fleet_quarantines_total", op=">",
             threshold=_f(conf, K.ALERTS_QUARANTINE_PER_MIN, 3.0) / 60.0,
             window_s=300.0, for_s=for_s, severity=SEV_WARN,
             summary="host quarantines applied faster than the "
                     "attribution budget — correlated hardware event "
                     "or a flapping health scorer"),
        Rule(name="queue-wait-p99", kind="quantile",
             series="tony_fleet_queue_wait_seconds", q=0.99,
             window_s=1800.0, op=">",
             threshold=_f(conf, K.ALERTS_QUEUE_WAIT_P99_S, 600.0),
             for_s=for_s, severity=SEV_WARN,
             summary="submit-to-grant p99 wait breached the queue "
                     "budget — the pool is starved or fragmented"),
    ]


def pack_series(pack: Sequence[Rule]) -> List[str]:
    """Every metric family a pack references (the ``alert-registry``
    lint resolves each against metrics.SERIES)."""
    return sorted({r.series for r in pack})
