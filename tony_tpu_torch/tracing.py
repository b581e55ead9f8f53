"""Control-plane distributed tracing: spans across client, coordinator and
executors, stitched into ONE tree per job.

The reference had no tracing at all — its observability was the jhist
event stream read after the fact, so "where did the 15 s submit→first-step
go" had no answer short of grepping task logs. Podracer (arXiv:2104.06272)
makes the case that TPU-pod orchestration lives or dies on utilization
accounting across the whole launch path; this module is the launch-path
half of that story (tony_tpu_torch/metrics.py is the steady-state half).

Model: the usual trace_id / span_id / parent_id tree. One trace per job:

- the CLIENT starts the trace at submit (``client.submit`` root span) and
  exports ``TONY_TRACE_ID`` / ``TONY_TRACE_PARENT`` to the coordinator;
- the COORDINATOR parents ``coordinator.run`` under the client's span and
  owns the span LOG: ``trace.spans.jsonl`` in the job history dir, next to
  the jhist stream (same durability posture: JSON lines, torn-tail
  tolerated on read);
- EXECUTORS get the trace id and their task-lifecycle span id through the
  task env, record their own spans (register, user-process, first-step,
  teardown) in a local buffer, and ship them home over the ordinary RPC
  plane (``trace.push``) — one stitched file per job even when tasks run
  on other hosts;
- every RPC frame carries the caller's trace context (``tc`` in the inner
  request, next to the generation field — rpc/wire.py), so server-side
  spans for significant RPCs parent under the caller's span.

Clocks: absolute timestamps are wall-clock microseconds (the only clock
two hosts share at all); durations are measured on the MONOTONIC clock
and the end timestamp is derived as ``start + monotonic_elapsed``, so an
NTP step mid-span can never produce a negative or inflated duration.

Record grammar (one JSON object per line):

- ``{"ev": "B", trace, span, parent, name, svc, task, ts_us, args}`` —
  span opened (file-sink tracers write these eagerly, so a crashed
  coordinator leaves evidence of what was in flight);
- ``{"ev": "E", span, ts_us, args}`` — span closed;
- ``{"ev": "X", ..., ts_us, dur_us, args}`` — complete span in one record
  (what buffered tracers emit: a span is only ever shipped CLOSED, so a
  lost push can drop spans but never manufacture an unclosed one);
- ``{"ev": "I", ..., ts_us, args}`` — instant annotation.

``to_trace_events`` exports the log as Chrome/Perfetto ``trace_events``
JSON (``tony-tpu trace <app>``, portal ``/trace/<app>`` view). Unmatched
B records are reported as unclosed — the golden e2e test and bench.py
treat a nonzero count as a tracing regression.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple, Union

log = logging.getLogger(__name__)


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def now_us() -> int:
    return int(time.time() * 1e6)


# ---------------------------------------------------------------------------
# RPC context: the caller's (trace_id, span_id) rides every request frame
# (rpc/wire.py stamps/reads "tc"); the server parks it in a thread-local
# around dispatch so handler-side spans can parent under the caller.
# ---------------------------------------------------------------------------
_rpc_ctx = threading.local()


def set_rpc_context(tc: Optional[Tuple[str, str]]) -> None:
    _rpc_ctx.value = tc


def get_rpc_context() -> Optional[Tuple[str, str]]:
    return getattr(_rpc_ctx, "value", None)


def clear_rpc_context() -> None:
    _rpc_ctx.value = None


class Span:
    """One open span. ``end()`` exactly once; attrs merge at either edge."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "service",
                 "task", "start_us", "_t0_mono", "attrs", "_tracer", "_done")

    def __init__(self, tracer: "Tracer", name: str, parent_id: str,
                 task: str = "",
                 attrs: Optional[Dict[str, Any]] = None) -> None:
        self.trace_id = tracer.trace_id
        self.span_id = new_span_id()
        self.parent_id = parent_id
        self.name = name
        self.service = tracer.service
        self.task = task
        self.start_us = now_us()
        self._t0_mono = time.monotonic()
        self.attrs = dict(attrs or {})
        self._tracer = tracer
        self._done = False

    def end(self, end_us: Optional[int] = None, **attrs: Any) -> None:
        if self._done:
            return
        self._done = True
        if end_us is None:
            # Monotonic duration, wall-anchored start (module docstring).
            end_us = self.start_us + int(
                (time.monotonic() - self._t0_mono) * 1e6)
        self._tracer._end_span(self, max(int(end_us), self.start_us), attrs)

    # Context-manager form: `with tracer.start_span("x") as span:` closes
    # the span on every exit path, error included — the shape the
    # span-leak lint rule (devtools/tonylint.py) prefers. An explicitly
    # end()ed span inside the block stays ended (end is once-only).
    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type: Optional[type],
                 exc: Optional[BaseException], tb: object) -> None:
        if exc_type is not None and not self._done:
            self.end(error=f"{exc_type.__name__}: {exc}"[:200])
        else:
            self.end()


class _NullSpan:
    """Returned by a disabled tracer: every write is a no-op, so call
    sites need no ``if tracer.enabled`` guards around span lifecycles."""

    trace_id = span_id = parent_id = name = service = task = ""
    start_us = 0
    attrs: Dict[str, Any] = {}

    def end(self, end_us: Optional[int] = None, **attrs: Any) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type: Optional[type],
                 exc: Optional[BaseException], tb: object) -> None:
        pass


NULL_SPAN = _NullSpan()


def _parent_id(parent: Union[Span, _NullSpan, str, None]) -> str:
    if parent is None:
        return ""
    if isinstance(parent, str):
        return parent
    return parent.span_id


class Tracer:
    """Span factory + record sink. Two sink modes:

    - ``path`` given (coordinator): append records to the span log as they
      happen — B at open, E at close — durably greppable mid-run;
    - no path (client, executors): buffer COMPLETE records only and let
      the owner ``drain()`` them into a ``trace.push`` RPC. A span is
      never shipped half-open, so remote crashes can lose spans but never
      leave unclosed ones in the job's log.

    Disabled tracers (``enabled=False``) hand out NULL_SPAN and drop
    everything — the zero-overhead production off-switch
    (tony.trace.enabled)."""

    def __init__(self, trace_id: Optional[str] = None, service: str = "",
                 path: Optional[str] = None, enabled: bool = True) -> None:
        self.trace_id = trace_id or new_trace_id()
        self.service = service
        self.enabled = enabled
        self._path = path
        self._file = None
        self._buffer: List[Dict[str, Any]] = []
        self._lock = threading.Lock()

    # -- span lifecycle --------------------------------------------------
    def start_span(self, name: str,
                   parent: Union[Span, _NullSpan, str, None] = None,
                   task: str = "",
                   attrs: Optional[Dict[str, Any]] = None
                   ) -> Union[Span, _NullSpan]:
        if not self.enabled:
            return NULL_SPAN
        span = Span(self, name, _parent_id(parent), task=task, attrs=attrs)
        if self._path is not None:
            self._write({"ev": "B", "trace": span.trace_id,
                         "span": span.span_id, "parent": span.parent_id,
                         "name": span.name, "svc": span.service,
                         "task": span.task, "ts_us": span.start_us,
                         "args": span.attrs})
        return span

    def _end_span(self, span: Span, end_us: int,
                  attrs: Dict[str, Any]) -> None:
        if self._path is not None:
            self._write({"ev": "E", "span": span.span_id, "ts_us": end_us,
                         "args": dict(attrs)})
        else:
            merged = dict(span.attrs)
            merged.update(attrs)
            self._write({"ev": "X", "trace": span.trace_id,
                         "span": span.span_id, "parent": span.parent_id,
                         "name": span.name, "svc": span.service,
                         "task": span.task, "ts_us": span.start_us,
                         "dur_us": end_us - span.start_us, "args": merged})

    def emit(self, name: str, start_us: int, end_us: int,
             parent: Union[Span, _NullSpan, str, None] = None,
             task: str = "",
             attrs: Optional[Dict[str, Any]] = None) -> None:
        """Record a complete span whose edges were observed out of band
        (e.g. executor.first_step, whose end is the user process's own
        wall timestamp from the telemetry file)."""
        if not self.enabled:
            return
        self._write({"ev": "X", "trace": self.trace_id,
                     "span": new_span_id(), "parent": _parent_id(parent),
                     "name": name, "svc": self.service, "task": task,
                     "ts_us": int(start_us),
                     "dur_us": max(0, int(end_us) - int(start_us)),
                     "args": dict(attrs or {})})

    def instant(self, name: str,
                parent: Union[Span, _NullSpan, str, None] = None,
                task: str = "",
                attrs: Optional[Dict[str, Any]] = None) -> None:
        """Zero-duration annotation (APPLICATION_FINISHED, verdicts...)."""
        if not self.enabled:
            return
        self._write({"ev": "I", "trace": self.trace_id,
                     "span": new_span_id(), "parent": _parent_id(parent),
                     "name": name, "svc": self.service, "task": task,
                     "ts_us": now_us(), "args": dict(attrs or {})})

    # -- sinks -----------------------------------------------------------
    def _write(self, record: Dict[str, Any]) -> None:
        with self._lock:
            if self._path is None:
                self._buffer.append(record)
                return
            try:
                if self._file is None:
                    os.makedirs(os.path.dirname(self._path) or ".",
                                exist_ok=True)
                    self._file = open(self._path, "a", encoding="utf-8")
                self._file.write(json.dumps(record, sort_keys=True) + "\n")
                self._file.flush()
            except (OSError, ValueError, TypeError) as e:
                # Tracing is diagnostics, never a job-failure source.
                log.warning("span record dropped: %s", e)

    def write_records(self, records: Any) -> int:
        """Remote-span intake (the ``trace.push`` RPC lands here): append
        pre-formed records from executors/clients into this tracer's sink.
        Malformed entries are dropped, counted records returned."""
        if not self.enabled or not isinstance(records, (list, tuple)):
            return 0
        n = 0
        for rec in records:
            if isinstance(rec, dict) and rec.get("ev") in ("B", "E", "X",
                                                           "I"):
                self._write(rec)
                n += 1
        return n

    def drain(self) -> List[Dict[str, Any]]:
        """Take the buffered records (buffer-mode tracers only)."""
        with self._lock:
            out, self._buffer = self._buffer, []
        return out

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None


# ---------------------------------------------------------------------------
# Span-log reading + Chrome/Perfetto export
# ---------------------------------------------------------------------------
def load_records(path: str) -> List[Dict[str, Any]]:
    """Decode a span log; torn-tail tolerant like events.read_events (a
    SIGKILLed coordinator can leave a partial final line)."""
    out: List[Dict[str, Any]] = []
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    log.warning("torn span record in %s after %d good ones",
                                path, len(out))
                    break
                if isinstance(rec, dict):
                    out.append(rec)
    except OSError:
        return []
    return out


def existing_trace_id(path: str) -> str:
    """Trace id of an existing span log ('' when absent/empty) — how a
    recovered coordinator rejoins the job's original trace."""
    for rec in load_records(path)[:1]:
        return str(rec.get("trace", ""))
    return ""


def to_trace_events(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Export records as Chrome ``trace_events`` JSON (Perfetto-loadable).

    Complete ("X") events per span; services map to pids and tasks to
    tids with ``process_name``/``thread_name`` metadata so the timeline
    groups client / coordinator / per-task executor tracks. Returns the
    payload with two extra top-level keys (ignored by viewers):
    ``unclosedSpans`` (names of B records with no matching E — zero on any
    healthy run) and ``traceId``."""
    opens: Dict[str, Dict[str, Any]] = {}
    spans: List[Dict[str, Any]] = []
    instants: List[Dict[str, Any]] = []
    trace_id = ""
    for rec in records:
        ev = rec.get("ev")
        trace_id = trace_id or str(rec.get("trace", "") or "")
        if ev == "B":
            opens[str(rec.get("span"))] = rec
        elif ev == "E":
            begin = opens.pop(str(rec.get("span")), None)
            if begin is None:
                continue
            merged = dict(begin.get("args") or {})
            merged.update(rec.get("args") or {})
            span = dict(begin)
            span["args"] = merged
            span["dur_us"] = max(
                0, int(rec.get("ts_us", 0)) - int(begin.get("ts_us", 0)))
            spans.append(span)
        elif ev == "X":
            spans.append(rec)
        elif ev == "I":
            instants.append(rec)

    pids: Dict[str, int] = {}
    tids: Dict[Tuple[str, str], int] = {}
    events: List[Dict[str, Any]] = []

    def _ids(rec: Dict[str, Any]) -> Tuple[int, int]:
        svc = str(rec.get("svc", "") or "?")
        task = str(rec.get("task", "") or "")
        if svc not in pids:
            pids[svc] = len(pids) + 1
            events.append({"ph": "M", "name": "process_name",
                           "pid": pids[svc], "tid": 0,
                           "args": {"name": svc}})
        key = (svc, task)
        if key not in tids:
            tids[key] = len([k for k in tids if k[0] == svc]) + 1 \
                if task else 0
            if task:
                events.append({"ph": "M", "name": "thread_name",
                               "pid": pids[svc], "tid": tids[key],
                               "args": {"name": task}})
        return pids[svc], tids[key]

    for rec in sorted(spans, key=lambda r: int(r.get("ts_us", 0))):
        pid, tid = _ids(rec)
        args = dict(rec.get("args") or {})
        args.update({"trace": rec.get("trace", ""),
                     "span": rec.get("span", ""),
                     "parent": rec.get("parent", "")})
        if rec.get("task"):
            args["task"] = rec["task"]
        events.append({"ph": "X", "name": str(rec.get("name", "?")),
                       "cat": str(rec.get("svc", "") or "span"),
                       "ts": int(rec.get("ts_us", 0)),
                       "dur": int(rec.get("dur_us", 0)),
                       "pid": pid, "tid": tid, "args": args})
    for rec in sorted(instants, key=lambda r: int(r.get("ts_us", 0))):
        pid, tid = _ids(rec)
        events.append({"ph": "i", "s": "g",
                       "name": str(rec.get("name", "?")),
                       "cat": str(rec.get("svc", "") or "span"),
                       "ts": int(rec.get("ts_us", 0)),
                       "pid": pid, "tid": tid,
                       "args": dict(rec.get("args") or {})})
    unclosed = [str(r.get("name", "?")) for r in opens.values()]
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "traceId": trace_id, "unclosedSpans": unclosed}


# ---------------------------------------------------------------------------
# Cold-start decomposition: the submit→first-step critical path as phases
# ---------------------------------------------------------------------------
#: (phase, span name, edge) boundary schedule along the critical path. Each
#: phase runs from the previous boundary to this span's start/end, so the
#: phase durations are CONSECUTIVE and sum exactly to the headline
#: submit→first-step latency — the property that lets a BENCH artifact
#: attribute a regression to one phase without re-running anything.
_COLD_START_BOUNDARIES = (
    # client-side staging (bundle copytree / store PUTs / venv)
    ("stage", "client.stage", "end"),
    # coordinator interpreter boot + backend/slice provisioning + schedule
    ("provision", "task.lifecycle", "start"),
    # executor process spawn + python interpreter + tony_tpu_torch import
    # (the phase a warm-pool lease collapses to ~0)
    ("spawn", "executor.run", "start"),
    # registration + gang barrier (bundle localization overlaps this
    # since the parallel-localize change; its own duration is reported
    # separately under span_durations)
    ("register", "executor.register", "end"),
    # runtime env build + port release + user-process exec
    ("launch", "executor.user_process", "start"),
    # user interpreter + jax import + compile + first real step
    ("user_boot", "executor.first_step", "end"),
)


def cold_start_breakdown(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Decompose ``client.submit → executor.first_step`` into per-phase
    durations, straight from a job's span records.

    Anchors on the FIRST ``executor.first_step`` span (by end time) and
    that task's own lifecycle/executor spans, so multi-task gangs and
    retry epochs report the path of the task that actually reached its
    first step first. Raises RuntimeError when the anchor spans are
    missing — the same loud-on-regression posture as the bench's span
    check. Returns::

        {"total_s": float,            # == sum(phases.values()), exact
         "task": "worker:0",
         "phases": {phase: seconds, ...},     # ordered, consecutive
         "span_durations": {name: seconds}}   # raw (possibly overlapping)
    """
    payload = to_trace_events(records)
    events = [e for e in payload["traceEvents"] if e.get("ph") == "X"]

    def _task(e: Dict[str, Any]) -> str:
        return str((e.get("args") or {}).get("task", "") or "")

    submits = [e for e in events if e["name"] == "client.submit"]
    firsts = [e for e in events if e["name"] == "executor.first_step"]
    if not submits or not firsts:
        raise RuntimeError(
            f"cold-start breakdown needs client.submit and "
            f"executor.first_step spans (have: "
            f"{sorted({e['name'] for e in events})})")
    submit = min(submits, key=lambda e: e["ts"])
    first = min(firsts, key=lambda e: e["ts"] + e.get("dur", 0))
    task = _task(first)

    def _boundary(name: str, edge: str) -> Optional[int]:
        # Prefer the anchor task's span; fall back to task-less spans
        # (client.stage has no task). First occurrence wins — a retry
        # epoch's second lifecycle span is not this cold start.
        cands = [e for e in events if e["name"] == name
                 and _task(e) in (task, "")]
        if not cands:
            return None
        e = min(cands, key=lambda c: c["ts"])
        return int(e["ts"] + (e.get("dur", 0) if edge == "end" else 0))

    t0 = int(submit["ts"])

    def _at(ts: int) -> float:
        # Each boundary is rounded once, against t0; a phase is the
        # difference of two rounded boundaries, so the phases telescope
        # to total_s exactly. (The reference rounds each phase on its
        # own, and its sum can miss the rounded total by a few 1e-4; a
        # phase here differs from the reference's by at most 1e-4.)
        return round((ts - t0) / 1e6, 4)

    phases: Dict[str, float] = {}
    prev = t0
    end = int(first["ts"] + first.get("dur", 0))
    for phase, span_name, edge in _COLD_START_BOUNDARIES:
        b = _boundary(span_name, edge)
        if b is None:
            # A missing intermediate span folds its time into the next
            # phase instead of losing it (the sum must stay exact).
            continue
        b = max(min(b, end), prev)   # clamp: monotonic, inside the window
        phases[phase] = round(_at(b) - _at(prev), 4)
        prev = b
    # Anything after the last known boundary still belongs to the total.
    if end > prev:
        phases["user_boot"] = round(
            phases.get("user_boot", 0.0) + _at(end) - _at(prev), 4)
    durations: Dict[str, float] = {}
    for name in ("client.stage", "executor.localize", "executor.register",
                 "executor.user_process", "executor.first_step",
                 "pool.lease", "gang.rendezvous"):
        cands = [e for e in events if e["name"] == name
                 and _task(e) in (task, "")]
        if cands:
            e = min(cands, key=lambda c: c["ts"])
            durations[name] = round(e.get("dur", 0) / 1e6, 4)
    return {"total_s": _at(end), "task": task,
            "phases": phases, "span_durations": durations}
