"""Control-plane self-observation: the coordinator's own phase accounting.

PR 9 gave the *data plane* per-step phase attribution (telemetry.phase →
ring → verdict); this module turns the same machinery on the coordinator
itself, because the control plane is built of O(n)-per-tick loops — the
heartbeat scan, fsync-per-journal-record, per-beat beacon fold, prom
rendering, one global rendezvous barrier — and the PR-12 restructuring
(batched heartbeats, group-commit journal, hierarchical beacon fan-in)
must be aimed by numbers, not guesses (ROADMAP item 5; TonY's own
heartbeat/RPC design, SURVEY §1 L2–L4, marks where the reference would
have fallen over first).

Phases (disjoint by construction — see nesting below):

- ``hb_scan``            the monitor loop's heartbeat-expiry scan
- ``journal_fsync``      write-ahead journal appends (fsync included)
- ``beacon_fold``        per-beat metrics-beacon fold into the registry
- ``prom_export``        Prometheus gauge refresh + render + atomic write
- ``rpc_serve``          RPC dispatch time NOT already booked to a phase
  above (the ``_on_rpc_request`` latency hook feeds it; journal appends
  and beacon folds that happen INSIDE a dispatch are subtracted so the
  per-tick phases stay disjoint and sum-to-wall holds)
- ``rendezvous_barrier`` monitor-side barrier bookkeeping (the
  all-registered scan while the gang rendezvous is open)
- ``idle``               the monitor loop's sleep (explicit, so the duty
  cycle is readable directly from the fractions)
- ``other``              everything unattributed in the tick interval

Fold discipline — EXACTLY the step-phase ring (telemetry._fold_phases):
each monitor tick closes one attribution interval (previous tick end →
this tick end); phases recorded on RPC handler threads land in the tick
that paid for them; over-attribution (concurrent handler work exceeding
the interval) widens the wall rather than inventing a negative ``other``
— so per-tick phases ALWAYS sum to the tick wall.

Nesting/disjointness: ``phase()`` keeps a per-thread frame stack; a
nested phase's seconds are subtracted from its parent, and the total
phase-attributed seconds of a dispatch are subtracted from that
dispatch's ``rpc_serve`` booking (``note_dispatch`` reads and resets the
per-thread outermost-attribution counter right after the dispatch, in
the same handler thread).

Thread-safety: accumulation from any thread behind one lock whose
critical sections are pure dict math (tonylint lock-blocking); all
clocks monotonic (tonylint clock).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Deque, Dict, Optional

from tony_tpu_torch.metrics import Histogram

#: canonical control-plane phase names (the coordinator verdict
#: classifier — tony_tpu_torch/profiling/verdict.py classify_coord — reads
#: these; free-form names are accepted like the step-phase ring).
COORD_PHASES = ("hb_scan", "journal_fsync", "beacon_fold", "prom_export",
                "rpc_serve", "rendezvous_barrier", "idle")
#: synthetic bucket: tick wall no phase claimed.
OTHER_PHASE = "other"

#: fsync-latency buckets: journal appends are sub-ms on a healthy local
#: disk and tens of ms when the device stalls — the histogram must
#: resolve both regimes (the p99 behind JOURNAL_BOUND evidence).
FSYNC_BUCKETS_S = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                   0.025, 0.05, 0.1, 0.25, 0.5, 1.0)


def histogram_quantile(snap: Dict[str, object], q: float) -> float:
    """Approximate quantile from a Histogram.snapshot() by linear
    interpolation inside the owning bucket (Prometheus
    histogram_quantile semantics; overflow clamps to the top bound)."""
    buckets = [float(b) for b in snap.get("buckets", [])]
    counts = [int(c) for c in snap.get("counts", [])]
    total = int(snap.get("count", 0) or 0)
    if total <= 0 or not buckets:
        return 0.0
    rank = q * total
    cum = 0
    lo = 0.0
    for bound, c in zip(buckets, counts):
        if cum + c >= rank and c > 0:
            return lo + (bound - lo) * (rank - cum) / c
        cum += c
        lo = bound
    return buckets[-1]


class _Frames(threading.local):
    def __init__(self):
        self.stack = []        # nested-phase seconds per open frame
        self.outer = 0.0       # outermost-phase seconds since last reset


class CoordPhases:
    """Bounded-ring per-tick phase accountant for one coordinator."""

    def __init__(self, ring_ticks: int = 256):
        self._lock = threading.Lock()
        self._frames = _Frames()
        self._acc: Dict[str, float] = {}      # since the last tick fold
        self._cum: Dict[str, float] = {}
        self._wall_cum = 0.0
        self._ticks = 0
        self._ring: Deque[dict] = collections.deque(
            maxlen=max(8, int(ring_ticks)))
        self._last_tick_end: Optional[float] = None
        # Control-plane rate counters (monotonic; rates derived over the
        # ring window from per-tick samples).
        self._beats = 0
        self._journal_records = 0
        self._journal_bytes = 0
        self._samples: Deque[tuple] = collections.deque(maxlen=64)
        self._fsync_hist = Histogram(FSYNC_BUCKETS_S)

    # -- recording (any thread) ------------------------------------------
    @contextlib.contextmanager
    def phase(self, name: str):
        """Attribute the enclosed wall time to control-plane phase
        ``name``. Re-entrant: a nested phase's time is subtracted from
        its parent so concurrent bookings stay disjoint."""
        frames = self._frames
        frames.stack.append(0.0)
        t0 = time.monotonic()
        try:
            yield
        finally:
            dt = time.monotonic() - t0
            nested = frames.stack.pop()
            if frames.stack:
                frames.stack[-1] += dt
            else:
                frames.outer += dt
            self_dt = max(0.0, dt - nested)
            with self._lock:
                self._acc[name] = self._acc.get(name, 0.0) + self_dt

    def note_dispatch(self, method: str, seconds: float) -> None:
        """RPC-dispatch booking (the ``_on_rpc_request`` hook): the
        dispatch's wall MINUS whatever its handler already attributed to
        named phases (journal appends, beacon folds) lands in
        ``rpc_serve``. Runs in the handler thread right after dispatch,
        so the per-thread outer-attribution counter belongs to exactly
        this dispatch."""
        frames = self._frames
        attributed, frames.outer = frames.outer, 0.0
        self_dt = max(0.0, float(seconds) - attributed)
        with self._lock:
            self._acc["rpc_serve"] = \
                self._acc.get("rpc_serve", 0.0) + self_dt
            if method == "task_executor_heartbeat":
                self._beats += 1

    def note_journal_append(self, n_bytes: int, seconds: float) -> None:
        """Journal observer (coordinator/journal.py): one fsync'd append.
        Books the latency into the ``journal_fsync`` phase AND the fsync
        histogram + records/bytes counters."""
        frames = self._frames
        if frames.stack:
            frames.stack[-1] += seconds
        else:
            frames.outer += seconds
        self._fsync_hist.observe(seconds)
        with self._lock:
            self._acc["journal_fsync"] = \
                self._acc.get("journal_fsync", 0.0) + float(seconds)
            self._journal_records += 1
            self._journal_bytes += int(n_bytes)

    # -- tick fold (monitor thread) --------------------------------------
    def tick_done(self) -> None:
        """Close one attribution interval: previous tick end → now.
        The first call only anchors the clock (nothing to attribute a
        wall to yet)."""
        now = time.monotonic()
        with self._lock:
            prev = self._last_tick_end
            self._last_tick_end = now
            if prev is None:
                return
            acc = dict(self._acc)
            self._acc.clear()
            wall = max(now - prev, 0.0)
            attributed = sum(acc.values())
            if attributed > wall:
                # Handler-thread work is concurrent with the monitor
                # loop and can over-attribute an interval; widen the
                # wall rather than invent a negative other bucket
                # (telemetry._fold_phases discipline).
                wall = attributed
            acc[OTHER_PHASE] = wall - attributed
            for k, v in acc.items():
                self._cum[k] = self._cum.get(k, 0.0) + v
            self._wall_cum += wall
            self._ticks += 1
            self._ring.append({"wall_s": wall, "phases": acc})
            self._samples.append((now, self._beats,
                                  self._journal_records,
                                  self._journal_bytes))

    # -- reads -----------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """Self-observation snapshot: cumulative + recent-ring phase
        seconds (sum EXACTLY equals the wall — ``other`` holds the
        unattributed rest), tick duration, and the control-plane rates.
        {} before the first folded tick."""
        with self._lock:
            if not self._ticks:
                return {}
            out: Dict[str, object] = {
                "ticks": float(self._ticks),
                "wall_s": self._wall_cum,
                "cum": dict(self._cum),
                "beats_total": self._beats,
                "journal_records_total": self._journal_records,
                "journal_bytes_total": self._journal_bytes,
            }
            n = len(self._ring)
            if n:
                recent: Dict[str, float] = {}
                rwall = 0.0
                # The tick interval includes the monitor sleep; the
                # ACTIVE tick duration (what grows with gang width) is
                # the attributed non-idle, non-other work per tick.
                active = 0.0
                for rec in self._ring:
                    rwall += rec["wall_s"]
                    for k, v in rec["phases"].items():
                        recent[k] = recent.get(k, 0.0) + v
                        if k not in (OTHER_PHASE, "idle"):
                            active += v
                out["recent"] = {k: v / n for k, v in recent.items()}
                out["recent_wall_s"] = rwall / n
                out["recent_ticks"] = float(n)
                out["tick_active_s"] = active / n
            if len(self._samples) >= 2:
                t0, b0, r0, y0 = self._samples[0]
                t1, b1, r1, y1 = self._samples[-1]
                window = max(t1 - t0, 1e-9)
                out["beats_per_sec"] = (b1 - b0) / window
                out["journal_records_per_sec"] = (r1 - r0) / window
                out["journal_bytes_per_sec"] = (y1 - y0) / window
        snap = self._fsync_hist.snapshot()
        out["fsync"] = snap
        out["journal_fsync_p99_s"] = histogram_quantile(snap, 0.99)
        return out

    def fractions(self) -> Dict[str, float]:
        """Recent-ring phase fractions of the tick wall (the classifier
        input — tony_tpu_torch/profiling/verdict.py classify_coord)."""
        with self._lock:
            n = len(self._ring)
            if not n:
                return {}
            recent: Dict[str, float] = {}
            rwall = 0.0
            for rec in self._ring:
                rwall += rec["wall_s"]
                for k, v in rec["phases"].items():
                    recent[k] = recent.get(k, 0.0) + v
        if rwall <= 0:
            return {}
        return {k: v / rwall for k, v in recent.items()}
