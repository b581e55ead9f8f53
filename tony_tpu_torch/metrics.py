"""Live metrics pipeline primitives: ring-buffer time series, monotonic
counters, latency histograms, and Prometheus text exposition.

The reference's metrics surface was post-hoc only: TaskMonitor pushed
max/avg aggregates that surfaced on TASK_FINISHED (``TaskMonitor.java``)
— nothing answered "what is the gang doing RIGHT NOW". Here the
executor's heartbeat already carries a progress beacon
(coordinator/liveness.py); the same beacon widened with utilization
numbers (steps/s, MFU, HBM, RSS — tony_tpu_torch/telemetry.py derives them in
the user process) feeds a coordinator-side :class:`MetricsRegistry`,
which renders the whole job as Prometheus text exposition (served live
by the portal at ``/metrics`` and written to ``metrics.prom`` in the job
dir) and as the ``metrics.live`` RPC behind ``tony-tpu top``.

Design constraints:

- **Bounded memory**: gauges keep a ring buffer of the last N points
  (``tony.metrics.ring-points``) — enough for sparklines and short-window
  rates, never an unbounded series store. Prometheus owns long-term
  storage; this registry is the scrape source, not a TSDB.
- **Counter monotonicity across ``--recover``**: counters snapshot to
  ``metrics.counters.json`` (atomic replace) and a recovered coordinator
  reloads them, so ``tony_rpc_requests_total`` never steps backwards just
  because the coordinator process was replaced — rate() windows spanning
  a recovery stay truthful.
- **Cross-process histograms**: executors keep their RPC client latency
  histogram locally and ship the cumulative snapshot on the beacon; the
  registry re-exposes it verbatim (cumulative counts from the executor's
  own lifetime — exactly the monotonic shape Prometheus expects).
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import threading
import time
from typing import Any, Deque, Dict, List, Optional, Tuple

from tony_tpu_torch.devtools.race import guarded

#: Latency buckets (seconds) shared by RPC server/client histograms:
#: sub-ms localhost dispatch up to the 10 s call-timeout ceiling.
DEFAULT_LATENCY_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                             0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

#: THE series-name registry: every ``tony_*`` family the system exports,
#: in one place. tonylint's ``metrics-registry`` rule enforces it both
#: ways (an exported name must be registered; a registered name must
#: have an exporting call site), and ``tony-tpu check`` verifies every
#: family in a job's ``metrics.prom`` against it — so the docs, the
#: portal and benchdiff can never drift against what actually exports.
SERIES: Dict[str, str] = {
    # -- per-task utilization (heartbeat-beacon-fed gauges) --------------
    "tony_task_steps_completed": "step counter from the progress beacon",
    "tony_task_steps_per_sec": "training steps per second",
    "tony_task_tokens_per_sec": "tokens per second",
    "tony_task_mfu": "model FLOPs utilization vs peak bf16",
    "tony_task_hbm_bytes": "device HBM bytes in use",
    "tony_task_rss_bytes": "process-tree resident set size bytes",
    "tony_step_phase_seconds": "cumulative step wall per phase",
    "tony_task_heartbeat_age_seconds": "seconds since last heartbeat",
    # -- gang / session shape --------------------------------------------
    "tony_tasks": "tasks by status",
    "tony_gang_size": "current task count per jobtype gang",
    "tony_session_epoch": "current retry epoch",
    "tony_coordinator_generation": "coordinator generation",
    "tony_membership_generation": "elastic membership generation",
    # -- RPC plane --------------------------------------------------------
    "tony_rpc_server_seconds": "coordinator-side RPC dispatch latency",
    "tony_rpc_client_seconds": "executor-side RPC call latency",
    "tony_rpc_requests_total": "RPC requests dispatched",
    "tony_events_total": "job-history events emitted, by type",
    # -- fleet: multi-job gang scheduler (tony_tpu_torch/fleet/daemon.py) ------
    "tony_fleet_hosts": "pool hosts by state (total/used/free/cordoned)",
    "tony_fleet_jobs": "fleet jobs by state",
    "tony_fleet_queue_depth": "submissions waiting for a grant",
    "tony_fleet_tenant_hosts": "granted hosts per tenant",
    "tony_fleet_grants_total": "job grants applied",
    "tony_fleet_preemptions_total": "preempt-to-reclaim shrinks applied",
    "tony_fleet_migrations_total": "live slice migrations applied "
                                   "(defrag, evacuation, operator)",
    "tony_fleet_reclaim_notices_total": "slice-preemption notices "
                                        "received from the reclaim feed",
    "tony_fleet_quota_denials_total": "grants deferred by tenant quota",
    "tony_fleet_queue_wait_seconds": "submit-to-grant wait latency",
    # -- fleet host health (tony_tpu_torch/fleet/health.py) ---------------------
    "tony_fleet_host_health": "per-host health state (0 healthy, "
                              "1 suspect, 2 probation, 3 quarantined)",
    "tony_fleet_quarantined_hosts": "hosts currently cordoned by "
                                    "health quarantine or probation",
    "tony_fleet_quarantines_total": "host quarantine transitions applied",
    "tony_fleet_sick_slices_total": "correlated slice cordons "
                                    "(blast-radius evacuations)",
    # -- fleet goodput ledger (tony_tpu_torch/fleet/ledger.py) ------------------
    "tony_fleet_goodput_fraction": "chip-seconds doing useful train "
                                   "steps / chip-seconds held, per "
                                   "tenant and fleet-wide",
    "tony_fleet_phase_seconds": "cumulative ledger chip-seconds per "
                                "goodput phase and tenant",
    # -- control-plane self-observation (coordinator/coordphases.py) -----
    "tony_coord_phase_seconds": "coordinator tick wall per phase",
    "tony_coord_tick_seconds": "mean active coordinator tick duration",
    "tony_coord_registered_tasks": "tasks currently registered",
    "tony_coord_beats_total": "heartbeats received",
    "tony_journal_records_total": "write-ahead journal records appended",
    "tony_journal_bytes_total": "write-ahead journal bytes appended",
    "tony_journal_fsync_seconds": "journal append latency (fsync incl.)",
    # -- alerting (tony_tpu_torch/alerts/) --------------------------------------
    "tony_alerts_firing": "alerts currently firing, by severity",
    "tony_alert_transitions_total": "alert state-machine transitions "
                                    "journaled, by state",
}

_LabelsKey = Tuple[Tuple[str, str], ...]


def escape_label_value(value: Any) -> str:
    """Prometheus text-format label escaping: backslash, double-quote and
    newline (exposition format spec, in this order — escaping the
    backslash last would corrupt the other two escapes)."""
    return (str(value).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _labels_key(labels: Optional[Dict[str, Any]]) -> _LabelsKey:
    return tuple(sorted((str(k), str(v))
                        for k, v in (labels or {}).items()))


def format_labels(key: _LabelsKey,
                  extra: Optional[List[Tuple[str, str]]] = None) -> str:
    pairs = list(key) + list(extra or [])
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{escape_label_value(v)}"'
                          for k, v in pairs) + "}"


def _fmt_value(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class Series:
    """Gauge with bounded history: the ring buffer behind sparklines,
    windowed evaluators (``MetricsRegistry.rate`` over cumulative
    gauges, burn-rate windows) and the `latest` sample the exposition
    renders. Ring timestamps are ``time.monotonic()`` — they only ever
    feed window arithmetic, never wall-clock display."""

    def __init__(self, maxlen: int = 512):
        self.points: Deque[Tuple[float, float]] = collections.deque(
            maxlen=max(2, int(maxlen)))

    def set(self, value: float, ts: Optional[float] = None) -> None:
        self.points.append((ts if ts is not None else time.monotonic(),
                            float(value)))

    @property
    def latest(self) -> Optional[float]:
        return self.points[-1][1] if self.points else None

    def values(self) -> List[float]:
        return [v for _, v in self.points]


class Counter:
    """Monotonic counter; ``inc`` with a negative amount is a programming
    error and raises (monotonicity is the contract Prometheus rate()
    depends on). Keeps a bounded ring of (monotonic ts, value-after-inc)
    points so ``MetricsRegistry.rate`` can window it; the seed point
    anchors the recover base, so a rate window spanning a ``--recover``
    sees the reloaded value as history, not as a fresh increase."""

    def __init__(self, base: float = 0.0, maxlen: int = 512):
        self.value = float(base)
        self.points: Deque[Tuple[float, float]] = collections.deque(
            maxlen=max(2, int(maxlen)))
        self.points.append((time.monotonic(), self.value))

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter decrement ({amount}) is not allowed")
        self.value += amount
        self.points.append((time.monotonic(), self.value))


class Histogram:
    """Fixed-bucket latency histogram (cumulative on render, like the
    exposition format wants). ``snapshot()`` is the wire form executors
    put on the heartbeat beacon."""

    def __init__(self, buckets: Tuple[float, ...] = DEFAULT_LATENCY_BUCKETS_S,
                 raw_points: int = 1024):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self.counts = [0] * (len(self.buckets) + 1)  # last = overflow
        self.sum = 0.0
        self.count = 0
        #: bounded (monotonic ts, value) ring behind quantile_over —
        #: exact windowed quantiles for local histograms, no bucket error
        self.raw: Deque[Tuple[float, float]] = collections.deque(
            maxlen=max(2, int(raw_points)))
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        idx = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self.counts[idx] += 1
            self.sum += v
            self.count += 1
            self.raw.append((time.monotonic(), v))

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"buckets": list(self.buckets),
                    "counts": list(self.counts),
                    "sum": self.sum, "count": self.count}


def render_histogram_lines(name: str, key: _LabelsKey,
                           snap: Dict[str, Any]) -> List[str]:
    """_bucket/_sum/_count lines from a snapshot (cumulative, +Inf last)."""
    buckets = [float(b) for b in snap.get("buckets", [])]
    counts = [int(c) for c in snap.get("counts", [])]
    counts += [0] * (len(buckets) + 1 - len(counts))
    lines = []
    cum = 0
    for b, c in zip(buckets, counts):
        cum += c
        lines.append(f"{name}_bucket{format_labels(key, [('le', _fmt_value(b))])}"
                     f" {cum}")
    total = int(snap.get("count", cum + counts[len(buckets)]))
    lines.append(f'{name}_bucket{format_labels(key, [("le", "+Inf")])} '
                 f"{total}")
    lines.append(f"{name}_sum{format_labels(key)} "
                 f"{_fmt_value(float(snap.get('sum', 0.0)))}")
    lines.append(f"{name}_count{format_labels(key)} {total}")
    return lines


def _window_increase(pts: List[Tuple[float, float]],
                     cutoff: float) -> float:
    """Increase of a cumulative series over [cutoff, now]: last in-window
    value minus the value as of the window's start (the newest point at
    or before the cutoff — so a window spanning a quiet stretch, or a
    ``--recover`` reload, reads zero increase instead of re-counting the
    whole base). A backwards step (counter reset) contributes its
    post-reset value, Prometheus-style."""
    base: Optional[float] = None
    in_win: List[float] = []
    for ts, v in pts:
        if ts < cutoff:
            base = v
        else:
            in_win.append(v)
    if not in_win:
        return 0.0
    prev = base if base is not None else in_win[0]
    inc = 0.0
    for v in in_win:
        d = v - prev
        inc += d if d >= 0 else v
        prev = v
    return inc


def _bucket_quantile(bounds: List[float], counts: List[float],
                     q: float) -> float:
    """Quantile from per-bucket counts (+overflow last) by linear
    interpolation inside the owning bucket; overflow clamps to the top
    bound (same convention as coordphases.histogram_quantile)."""
    total = sum(counts)
    if total <= 0 or not bounds:
        return 0.0
    rank = max(0.0, min(1.0, float(q))) * total
    cum, lo = 0.0, 0.0
    for bound, c in zip(bounds, counts):
        if cum + c >= rank and c > 0:
            return lo + (bound - lo) * (rank - cum) / c
        cum += c
        lo = bound
    return float(bounds[-1])


@guarded
class MetricsRegistry:
    """The coordinator's in-memory metrics store: gauges (ring-buffer
    series), counters (recover-persistent), histograms (local and
    beacon-shipped snapshots), rendered as one Prometheus exposition.

    Thread-safety: instruments are registered from beat/RPC threads
    while the export worker renders — every registry-map touch holds
    ``_lock`` (the ``GUARDED_BY`` declaration below is enforced at
    runtime by the tonyrace detector, devtools/race.py)."""

    #: tonyrace registry: every family map is guarded by the one lock.
    GUARDED_BY = {
        "_gauges": "_lock",
        "_counters": "_lock",
        "_hists": "_lock",
        "_hist_snaps": "_lock",
        "_hist_snap_rings": "_lock",
        "_help": "_lock",
        "_saved_counters": "_lock",
    }

    def __init__(self, ring_points: int = 512):
        self._ring_points = ring_points
        self._gauges: Dict[str, Dict[_LabelsKey, Series]] = {}
        self._counters: Dict[str, Dict[_LabelsKey, Counter]] = {}
        self._hists: Dict[str, Dict[_LabelsKey, Histogram]] = {}
        self._hist_snaps: Dict[str, Dict[_LabelsKey, Dict[str, Any]]] = {}
        # (monotonic ts, snapshot) rings behind quantile_over for
        # beacon-shipped histograms: windowed quantile = bucket diff of
        # the newest snapshot against the last one older than the window
        self._hist_snap_rings: Dict[
            str, Dict[_LabelsKey,
                      Deque[Tuple[float, Dict[str, Any]]]]] = {}
        self._help: Dict[str, str] = {}
        self._saved_counters: Dict[str, Dict[str, float]] = {}
        self._lock = threading.Lock()

    # -- instruments -----------------------------------------------------
    def gauge(self, name: str, labels: Optional[Dict[str, Any]] = None,
              help: str = "") -> Series:
        key = _labels_key(labels)
        with self._lock:
            if help and name not in self._help:
                self._help[name] = help
            fam = self._gauges.setdefault(name, {})
            series = fam.get(key)
            if series is None:
                series = fam[key] = Series(self._ring_points)
        return series

    def counter(self, name: str, labels: Optional[Dict[str, Any]] = None,
                help: str = "") -> Counter:
        key = _labels_key(labels)
        with self._lock:
            if help and name not in self._help:
                self._help[name] = help
            fam = self._counters.setdefault(name, {})
            c = fam.get(key)
            if c is None:
                base = self._saved_counters.get(name, {}).get(
                    json.dumps(key), 0.0)
                c = fam[key] = Counter(base, maxlen=self._ring_points)
        return c

    def histogram(self, name: str,
                  labels: Optional[Dict[str, Any]] = None,
                  buckets: Tuple[float, ...] = DEFAULT_LATENCY_BUCKETS_S,
                  help: str = "") -> Histogram:
        key = _labels_key(labels)
        with self._lock:
            if help and name not in self._help:
                self._help[name] = help
            fam = self._hists.setdefault(name, {})
            h = fam.get(key)
            if h is None:
                h = fam[key] = Histogram(buckets)
        return h

    def set_histogram_snapshot(self, name: str,
                               labels: Optional[Dict[str, Any]],
                               snap: Dict[str, Any],
                               help: str = "") -> None:
        """Adopt a remote histogram verbatim (executor client-latency
        histograms ride the beacon as cumulative snapshots)."""
        if not isinstance(snap, dict) or "buckets" not in snap:
            return
        key = _labels_key(labels)
        with self._lock:
            if help and name not in self._help:
                self._help[name] = help
            self._hist_snaps.setdefault(name, {})[key] = snap
            ring = self._hist_snap_rings.setdefault(name, {}).get(key)
            if ring is None:
                ring = self._hist_snap_rings[name][key] = \
                    collections.deque(maxlen=64)
            ring.append((time.monotonic(), snap))

    # -- reads -----------------------------------------------------------
    def gauge_value(self, name: str,
                    labels: Optional[Dict[str, Any]] = None
                    ) -> Optional[float]:
        with self._lock:
            series = self._gauges.get(name, {}).get(_labels_key(labels))
        return series.latest if series is not None else None

    def gauge_history(self, name: str,
                      labels: Optional[Dict[str, Any]] = None
                      ) -> List[float]:
        with self._lock:
            series = self._gauges.get(name, {}).get(_labels_key(labels))
        return series.values() if series is not None else []

    # -- windowed evaluator APIs (tony_tpu_torch/alerts rides these) -----------
    def label_sets(self, name: str) -> List[Dict[str, str]]:
        """Every label set the family currently carries, across all
        instrument kinds."""
        with self._lock:
            keys: set = set()
            for store in (self._gauges, self._counters, self._hists,
                          self._hist_snaps):
                keys.update(store.get(name, {}).keys())
        return [dict(k) for k in sorted(keys)]

    def sample(self, name: str,
               labels: Optional[Dict[str, Any]] = None
               ) -> Optional[float]:
        """Latest instantaneous value: gauge latest, else counter value."""
        key = _labels_key(labels)
        with self._lock:
            series = self._gauges.get(name, {}).get(key)
            if series is not None and series.latest is not None:
                return series.latest
            c = self._counters.get(name, {}).get(key)
        return c.value if c is not None else None

    def gauge_points(self, name: str,
                     labels: Optional[Dict[str, Any]] = None
                     ) -> List[Tuple[float, float]]:
        """The (monotonic ts, value) ring of a gauge (or a counter's
        value-after-inc ring) — burn-rate windows walk this."""
        key = _labels_key(labels)
        with self._lock:
            series = self._gauges.get(name, {}).get(key)
            if series is not None:
                return list(series.points)
            c = self._counters.get(name, {}).get(key)
        return list(c.points) if c is not None else []

    def rate(self, name: str, labels: Optional[Dict[str, Any]] = None,
             window_s: float = 60.0,
             now: Optional[float] = None) -> Optional[float]:
        """Windowed increase/second over a counter ring — or over a
        cumulative gauge (e.g. ``tony_step_phase_seconds``, where the
        rate of cumulative seconds is a fraction of wall time). Counter
        resets (a value stepping backwards, e.g. a replaced executor)
        contribute their post-reset value, Prometheus-style. Returns
        0.0 when the family exists but has no in-window points, None
        when the family/labels are unknown (unevaluable)."""
        key = _labels_key(labels)
        with self._lock:
            c = self._counters.get(name, {}).get(key)
            if c is not None:
                pts = list(c.points)
            else:
                series = self._gauges.get(name, {}).get(key)
                if series is None:
                    return None
                pts = list(series.points)
        now = now if now is not None else time.monotonic()
        window_s = max(1e-9, float(window_s))
        return _window_increase(pts, now - window_s) / window_s

    def quantile_over(self, name: str,
                      labels: Optional[Dict[str, Any]] = None,
                      window_s: float = 60.0, q: float = 0.99,
                      now: Optional[float] = None) -> Optional[float]:
        """Windowed quantile: exact (interpolated rank over the raw
        observation ring) for local histograms; bucket-interpolated over
        a snapshot diff for beacon-shipped histograms. None when there
        are no in-window observations (unevaluable, not zero)."""
        key = _labels_key(labels)
        now = now if now is not None else time.monotonic()
        cutoff = now - max(0.0, float(window_s))
        with self._lock:
            h = self._hists.get(name, {}).get(key)
            raw = list(h.raw) if h is not None else None
            ring = self._hist_snap_rings.get(name, {}).get(key)
            snaps = list(ring) if ring is not None else []
        if raw is not None:
            vals = sorted(v for ts, v in raw if ts >= cutoff)
            if not vals:
                return None
            rank = max(0.0, min(1.0, float(q))) * (len(vals) - 1)
            lo = int(rank)
            hi = min(lo + 1, len(vals) - 1)
            return vals[lo] + (vals[hi] - vals[lo]) * (rank - lo)
        if not snaps or snaps[-1][0] < cutoff:
            return None
        newest = snaps[-1][1]
        base: Optional[Dict[str, Any]] = None
        for ts, snap in snaps:
            if ts < cutoff:
                base = snap
        bounds = [float(b) for b in newest.get("buckets", [])]
        counts = [float(c) for c in newest.get("counts", [])]
        counts += [0.0] * (len(bounds) + 1 - len(counts))
        if base is not None and \
                [float(b) for b in base.get("buckets", [])] == bounds:
            bcounts = [float(c) for c in base.get("counts", [])]
            bcounts += [0.0] * (len(bounds) + 1 - len(bcounts))
            counts = [max(0.0, c - b) for c, b in zip(counts, bcounts)]
        if sum(counts) <= 0 or not bounds:
            return None
        return _bucket_quantile(bounds, counts, q)

    def drop_labels(self, match: Dict[str, Any]) -> None:
        """Drop every series/counter/histogram whose labels contain all of
        ``match`` (a finished retry epoch's task series must not linger as
        frozen gauges in the exposition)."""
        want = set(_labels_key(match))
        with self._lock:
            for store in (self._gauges, self._counters, self._hists,
                          self._hist_snaps, self._hist_snap_rings):
                for fam in store.values():
                    for key in [k for k in fam if want <= set(k)]:
                        del fam[key]

    # -- exposition ------------------------------------------------------
    def render(self) -> str:
        with self._lock:
            gauges = {n: dict(f) for n, f in self._gauges.items()}
            counters = {n: dict(f) for n, f in self._counters.items()}
            hists = {n: dict(f) for n, f in self._hists.items()}
            hist_snaps = {n: dict(f) for n, f in self._hist_snaps.items()}
            helps = dict(self._help)
        lines: List[str] = []
        for name in sorted(gauges):
            if helps.get(name):
                lines.append(f"# HELP {name} {helps[name]}")
            lines.append(f"# TYPE {name} gauge")
            for key, series in sorted(gauges[name].items()):
                if series.latest is not None:
                    lines.append(f"{name}{format_labels(key)} "
                                 f"{_fmt_value(series.latest)}")
        for name in sorted(counters):
            if helps.get(name):
                lines.append(f"# HELP {name} {helps[name]}")
            lines.append(f"# TYPE {name} counter")
            for key, c in sorted(counters[name].items()):
                lines.append(f"{name}{format_labels(key)} "
                             f"{_fmt_value(c.value)}")
        all_hist_names = sorted(set(hists) | set(hist_snaps))
        for name in all_hist_names:
            if helps.get(name):
                lines.append(f"# HELP {name} {helps[name]}")
            lines.append(f"# TYPE {name} histogram")
            for key, h in sorted(hists.get(name, {}).items()):
                lines.extend(render_histogram_lines(name, key, h.snapshot()))
            for key, snap in sorted(hist_snaps.get(name, {}).items()):
                lines.extend(render_histogram_lines(name, key, snap))
        return "\n".join(lines) + "\n" if lines else ""

    # -- recover persistence ---------------------------------------------
    def save_counters(self, path: str) -> None:
        """Atomic counter snapshot — the recover seed (class docstring)."""
        with self._lock:
            payload = {name: {json.dumps(key): c.value
                              for key, c in fam.items()}
                       for name, fam in self._counters.items()}
        try:
            from tony_tpu_torch.utils.durable import atomic_write

            atomic_write(path, json.dumps(payload).encode("utf-8"))
        except OSError:
            pass

    def load_counters(self, path: str) -> bool:
        """Seed counters from a previous life's snapshot; lazily applied as
        each counter is first touched (so label sets need no pre-walk)."""
        try:
            with open(path, encoding="utf-8") as f:
                payload = json.load(f)
        except (OSError, ValueError):
            return False
        if not isinstance(payload, dict):
            return False
        with self._lock:
            self._saved_counters = {
                str(name): {str(k): float(v) for k, v in fam.items()}
                for name, fam in payload.items() if isinstance(fam, dict)}
        return True
