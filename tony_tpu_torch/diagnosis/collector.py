"""Incident-bundle collector: one read pass over everything a failed job
left behind.

Four PRs built the raw signals — failure domains in the event stream, a
fsync'd session journal, hang verdicts with stack-dump excerpts, a span
tree and metrics ring — and this module is the layer that gathers them
into ONE in-memory bundle the rule engine (``diagnosis/rules.py``) can
correlate. Everything is read torn-tolerantly (a crashed coordinator
leaves partial final lines everywhere) and best-effort: a missing
artifact is missing evidence, never a collection failure — the collector
must work on any history dir, including one scp'd off a dead host.

Sources, all relative to the job's history dir:

- the jhist event stream (finalized or ``.inprogress`` — live jobs get a
  provisional bundle);
- ``session.journal.jsonl`` raw records (epochs, verdicts, generations —
  the retry/recovery skeleton of the timeline);
- ``trace.spans.jsonl`` span records (µs-precision ordering that breaks
  first-failure ties the ms event clock cannot);
- ``metrics.prom`` (last exported gauge snapshot: RSS/HBM at death);
- ``tony-final.json`` scrubbed config (the knobs in force);
- per-task log tails via the paths recorded in TASK_FINISHED events
  (the only paths diagnosis will ever read), with extracted Python
  tracebacks and faulthandler stack dumps.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional

from tony_tpu_torch import constants, tracing
from tony_tpu_torch.events import history
from tony_tpu_torch.events.events import Event, read_events
from tony_tpu_torch.utils import logs as logutil
from tony_tpu_torch.diagnosis.exitcodes import describe_exit

#: conf-key substrings scrubbed from the bundled config (defense in depth
#: on top of the client's freeze-time scrub — incident bundles get
#: attached to tickets and pasted into chat).
_SECRET_MARKERS = ("token", "secret", "password", "credential", "key")


@dataclasses.dataclass
class TaskIncident:
    """Everything the bundle knows about one task, folded from events,
    spans and its log tails."""

    task_id: str
    status: str = ""
    exit_code: Optional[int] = None
    exit_detail: str = ""
    failure_domain: str = ""
    reason: str = ""
    started_ms: int = 0
    finished_ms: int = 0
    #: µs-precision failure instant from the span tree when available
    #: (falls back to finished_ms * 1000) — the first-failure tiebreak.
    failure_us: int = 0
    session_id: int = 0
    logs: List[str] = dataclasses.field(default_factory=list)
    traceback: str = ""
    stack_dump: str = ""
    last_heartbeat_age_s: Optional[float] = None
    progress: Dict[str, Any] = dataclasses.field(default_factory=dict)
    metrics: Dict[str, Any] = dataclasses.field(default_factory=dict)
    hung: bool = False
    straggler: bool = False
    #: this TASK_FINISHED was an elastic-resize absorption (host loss
    #: shrunk-and-continued, or a released member) — deliberate
    #: elasticity, not the job's failure; blame rules skip these.
    resized: bool = False

    @property
    def failed(self) -> bool:
        return self.status in ("FAILED", "KILLED")


@dataclasses.dataclass
class IncidentBundle:
    app_id: str
    job_dir: str
    live: bool = False            # no finalized history file yet
    status: str = ""              # APPLICATION_FINISHED status (or "")
    failure_reason: str = ""
    failure_domain: str = ""
    events: List[Event] = dataclasses.field(default_factory=list)
    journal: List[dict] = dataclasses.field(default_factory=list)
    spans: List[dict] = dataclasses.field(default_factory=list)
    metrics_prom: str = ""
    config: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: step-time attribution report (<job_dir>/perf.json, written by the
    #: coordinator at finish) — the diagnose perf advisory source.
    perf: Dict[str, Any] = dataclasses.field(default_factory=dict)
    tasks: Dict[str, TaskIncident] = dataclasses.field(default_factory=dict)
    log_tails: Dict[str, str] = dataclasses.field(default_factory=dict)
    generations: List[int] = dataclasses.field(default_factory=list)
    epochs: List[dict] = dataclasses.field(default_factory=list)
    verdicts: List[dict] = dataclasses.field(default_factory=list)

    def events_of(self, *types: str) -> List[Event]:
        names = set(types)
        return [e for e in self.events if e.type in names]

    def first_failed_task(self) -> Optional[TaskIncident]:
        """TonY's first-failed-task heuristic, upgraded with span
        timestamps: among failed tasks, the one whose failure instant is
        earliest — in a gang, every failure after the first is usually
        collateral (peers dying on a broken collective)."""
        failed = [t for t in self.tasks.values()
                  if t.failed and not t.resized]
        if not failed:
            return None
        return min(failed, key=lambda t: (
            t.failure_us or t.finished_ms * 1000 or float("inf"),
            t.task_id))


def _scrub_config(conf: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in conf.items():
        lk = str(k).lower()
        if any(m in lk for m in _SECRET_MARKERS) and v not in ("", None):
            out[k] = "<scrubbed>"
        else:
            out[k] = v
    return out


def _load_json_lines(path: str) -> List[dict]:
    """Torn-tolerant JSONL (same contract as events.read_events): decode
    the prefix, drop the first bad line and everything after."""
    return tracing.load_records(path)


def _read_text(path: str, max_bytes: int = 256 * 1024) -> str:
    try:
        return logutil.tail_file(path, max_bytes).decode("utf-8", "replace")
    except OSError:
        return ""


def _span_failure_times(spans: List[dict]) -> Dict[str, int]:
    """task_id → µs timestamp of the first failure-shaped span edge.

    Failure-shaped: a task-attributed record whose args carry a nonzero
    exit_code, or any of the kill/death markers the coordinator stamps
    when it ends a lifecycle span (killed / deemed_dead / error)."""
    begins: Dict[str, dict] = {}
    out: Dict[str, int] = {}

    def _note(task: str, ts_us: int) -> None:
        if task and ts_us and (task not in out or ts_us < out[task]):
            out[task] = ts_us

    for rec in spans:
        ev = rec.get("ev")
        if ev == "B":
            begins[str(rec.get("span"))] = rec
            continue
        args = rec.get("args") or {}
        task = str(rec.get("task", "") or "")
        if ev == "E" and not task:
            task = str(begins.get(str(rec.get("span")), {})
                       .get("task", "") or "")
        if ev not in ("E", "X"):
            continue
        exit_code = args.get("exit_code")
        failure = (isinstance(exit_code, (int, float)) and exit_code != 0) \
            or args.get("killed") or args.get("deemed_dead") \
            or args.get("error")
        if not failure:
            continue
        ts = int(rec.get("ts_us", 0) or 0)
        if ev == "X":
            ts += int(rec.get("dur_us", 0) or 0)
        _note(task, ts)
    return out


def collect(job_dir: str, app_id: str = "",
            tail_bytes: int = 64 * 1024) -> IncidentBundle:
    """Assemble the incident bundle for one job dir (post-hoc or live)."""
    bundle = IncidentBundle(app_id=app_id or os.path.basename(job_dir),
                            job_dir=job_dir)

    hist = history.find_history_file(job_dir)
    if hist is None:
        bundle.live = True
        if os.path.isdir(job_dir):
            for f in sorted(os.listdir(job_dir)):
                if f.endswith(constants.INPROGRESS_SUFFIX):
                    hist = os.path.join(job_dir, f)
                    break
    if hist and os.path.exists(hist):
        bundle.events = read_events(hist)
        meta = history.parse_metadata(os.path.basename(hist))
        if meta:
            bundle.app_id = meta.app_id
            bundle.status = meta.status if meta.finished else ""

    bundle.journal = _load_json_lines(
        os.path.join(job_dir, constants.JOURNAL_FILE))
    bundle.spans = _load_json_lines(
        os.path.join(job_dir, constants.TRACE_FILE))
    bundle.metrics_prom = _read_text(
        os.path.join(job_dir, constants.METRICS_PROM_FILE))
    conf_path = os.path.join(job_dir, constants.FINAL_CONFIG_FILE)
    try:
        with open(conf_path, encoding="utf-8") as f:
            bundle.config = _scrub_config(json.load(f))
    except (OSError, ValueError):
        bundle.config = {}
    try:
        with open(os.path.join(job_dir, constants.PERF_FILE),
                  encoding="utf-8") as f:
            perf = json.load(f)
        bundle.perf = perf if isinstance(perf, dict) else {}
    except (OSError, ValueError):
        bundle.perf = {}

    for rec in bundle.journal:
        t = rec.get("t")
        if t == "gen":
            bundle.generations.append(int(rec.get("generation", 0) or 0))
        elif t == "epoch":
            bundle.epochs.append(rec)
        elif t == "verdict":
            bundle.verdicts.append(rec)

    _fold_events(bundle)

    span_failures = _span_failure_times(bundle.spans)
    for task_id, ts_us in span_failures.items():
        t = bundle.tasks.get(task_id)
        if t is not None and t.failed:
            t.failure_us = min(t.failure_us or ts_us, ts_us)

    _collect_log_tails(bundle, tail_bytes)
    return bundle


def _fold_events(bundle: IncidentBundle) -> None:
    def task_of(ev: Event) -> TaskIncident:
        tid = str(ev.payload.get("task", "?"))
        return bundle.tasks.setdefault(tid, TaskIncident(task_id=tid))

    for ev in bundle.events:
        p = ev.payload
        if ev.type == "TASK_STARTED":
            t = task_of(ev)
            # Keep the FIRST epoch's start; later epochs restart tasks.
            if not t.started_ms:
                t.started_ms = ev.timestamp_ms
        elif ev.type == "TASK_FINISHED":
            t = task_of(ev)
            # Later epochs overwrite: the final life's outcome is the one
            # the verdict reasons about (earlier lives stay on the
            # timeline via the event list itself).
            t.status = str(p.get("status", "") or "")
            t.exit_code = p.get("exit_code")
            t.exit_detail = str(p.get("exit_detail", "") or "") \
                or describe_exit(t.exit_code)
            t.failure_domain = str(p.get("failure_domain", "") or "")
            t.reason = str(p.get("reason", "") or "")
            t.finished_ms = ev.timestamp_ms
            t.session_id = int(p.get("session_id", 0) or 0)
            t.logs = [str(x) for x in p.get("logs", []) or []]
            if p.get("traceback"):
                t.traceback = str(p["traceback"])
            if p.get("stack_dump_excerpt"):
                t.stack_dump = str(p["stack_dump_excerpt"])
            if p.get("last_heartbeat_age_s") is not None:
                try:
                    t.last_heartbeat_age_s = float(
                        p["last_heartbeat_age_s"])
                except (TypeError, ValueError):
                    pass
            if isinstance(p.get("progress"), dict):
                t.progress = p["progress"]
            if isinstance(p.get("metrics"), dict):
                t.metrics = p["metrics"]
            if p.get("resize"):
                t.resized = True
        elif ev.type == "TASK_HUNG":
            task_of(ev).hung = True
        elif ev.type == "TASK_STRAGGLER":
            task_of(ev).straggler = True
        elif ev.type == "APPLICATION_FINISHED":
            bundle.status = str(p.get("status", bundle.status)
                                or bundle.status)
            bundle.failure_reason = str(p.get("failure_reason", "") or "")
            bundle.failure_domain = str(p.get("failure_domain", "") or "")


def _collect_log_tails(bundle: IncidentBundle, tail_bytes: int) -> None:
    """Tail every log path the event stream recorded, keyed by path;
    extract per-task tracebacks (stderr-first) and stack dumps the event
    payloads didn't already carry."""
    for t in bundle.tasks.values():
        for path in t.logs:
            if path in bundle.log_tails:
                continue
            text = logutil.tail_text(path, tail_bytes)
            if text is not None:
                bundle.log_tails[path] = text
        # stderr is the usual home for both excerpt shapes; fall back to
        # any tail that has one.
        ordered = sorted(t.logs, key=lambda p: not p.endswith("stderr.log"))
        for path in ordered:
            text = bundle.log_tails.get(path)
            if not text:
                continue
            if not t.traceback:
                t.traceback = logutil.extract_traceback(text)
            if not t.stack_dump:
                t.stack_dump = logutil.extract_stack_dump(text)
