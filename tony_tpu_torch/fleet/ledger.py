"""Fleet goodput ledger: where every tenant's chip-seconds actually go.

TonY's history portal explained one job at a time; the multi-job
questions — "which tenant is wasting chips?", "how much of the pool's
life is queue wait vs. training?" — had no in-repo answer (SURVEY §1
L3-L4). This module decomposes every fleet job's wall-clock life into
CONSECUTIVE phases with the perf.json sum-to-wall discipline (the phases
partition the wall exactly, clamped boundaries, missing anchors fold
forward — never lost, never double-booked), sourced from three
artifacts the system already writes:

- the **fleet journal** (``fleet/journal.py``): submit / grant /
  preempt / restore / terminal timestamps and the piecewise host count;
- the job's **span tree** (``tracing.py`` ``trace.spans.jsonl``):
  client.submit start, executor.first_step end, warm-pool adoption
  markers;
- the job's **perf.json** and **event stream**: ckpt_stall
  seconds and GANG_RESIZED drain windows.

Wall phases (seconds, sum == wall within rounding)::

    queued           submit → grant (nothing held yet)
    provision        grant → client.submit span start (client boot)
    cold_start /     client.submit start → first executor.first_step
      warm_start     end (exactly one of the two, picked by the
                     warm-pool adoption markers in the span tree)
    retry_recompute  startup end → the LAST retry-epoch reset: work the
                     failure threw away plus the relaunch
    ckpt_stall       synchronous checkpoint stalls (perf.json)
    preempted        elastic drain windows a fleet preemption caused
                     (GANG_RESIZED completed with to < from)
    resize_drain     the other drain windows (grow-backs, host loss)
    migration        live-migration windows (GANG_MIGRATED completed):
                     drain→move→reshard wall — its own phase, never
                     booked as train
    train            the remainder — steps actually advancing

Chip-seconds: each post-grant phase is weighted by the average host
count over the granted life (the host timeline from grant / preempt /
restore records), ``held_chip_s`` is the exact integral, and
``goodput_fraction = train chip-seconds / held chip-seconds`` — the
fleet-wide and per-tenant headline exported as
``tony_fleet_goodput_fraction`` / ``tony_fleet_phase_seconds``.

Stdlib-only and side-effect-free: the daemon folds it under the
``fleet.ledger`` fault site (a fold failure degrades the fleet to
counters-only, never blocks a tick), `tony-tpu check` re-folds it
offline to enforce sum-to-wall on every drill artifact, and
``bench.py --suite fleet`` records the rollup as the BENCH_FLEET
headline.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, Iterable, List, Optional, Tuple

from tony_tpu_torch import constants
from tony_tpu_torch.fleet.journal import TERMINAL_STATES, JobFold

log = logging.getLogger(__name__)

#: every phase the ledger can book, in timeline order — the golden
#: anchor for tests and the exposition's label set.
PHASES = ("queued", "provision", "cold_start", "warm_start",
          "retry_recompute", "ckpt_stall", "preempted", "resize_drain",
          "migration", "train")

#: sum-to-wall tolerance the fleet-ledger invariant enforces (matches
#: the perf.json phase-sum discipline: 1% relative + rounding epsilon).
SUM_REL_TOL = 0.01
SUM_ABS_TOL = 0.05


def _load_json(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


def _span_anchors(job_dir: str) -> Dict[str, Any]:
    """The ledger's span-tree anchors: client.submit start (us),
    first executor.first_step end (us), gang.rendezvous end (us), and
    whether any task was adopted from the warm pool."""
    from tony_tpu_torch import tracing

    out: Dict[str, Any] = {"submit_us": 0, "first_step_us": 0,
                           "rendezvous_us": 0, "warm": False,
                           "trace_id": ""}
    path = os.path.join(job_dir, constants.TRACE_FILE)
    if not os.path.exists(path):
        return out
    records = tracing.load_records(path)
    opens: Dict[str, str] = {}        # span id → name (E carries none)
    for rec in records:
        out["trace_id"] = out["trace_id"] or str(rec.get("trace", "")
                                                 or "")
        ev = rec.get("ev")
        name = str(rec.get("name", "") or "")
        if ev == "B":
            opens[str(rec.get("span", "") or "")] = name
        elif ev == "E" and not name:
            name = opens.get(str(rec.get("span", "") or ""), "")
        ts = int(rec.get("ts_us", 0) or 0)
        end = ts + int(rec.get("dur_us", 0) or 0)
        if name == "client.submit" and ev in ("B", "X") \
                and not out["submit_us"]:
            out["submit_us"] = ts
        elif name == "executor.first_step" and ev == "X":
            if not out["first_step_us"] or end < out["first_step_us"]:
                out["first_step_us"] = end
        elif name == "gang.rendezvous" and ev in ("E", "X"):
            out["rendezvous_us"] = max(
                out["rendezvous_us"],
                end if ev == "X" else ts)
        if name == "pool.lease" or (
                isinstance(rec.get("args"), dict)
                and rec["args"].get("adopted")):
            out["warm"] = True
    return out


def _event_windows(job_dir: str) -> Tuple[float, float, float]:
    """(preempted_s, resize_drain_s, migration_s) from the job's
    completed gang events: GANG_RESIZED shrink drains (to < from) book
    as preempted — the fleet reclaims via elastic shrink, never a
    kill — the other GANG_RESIZED windows (grow-backs, host-loss
    absorbs that grew nothing) book as resize_drain, and GANG_MIGRATED
    windows (drain→move→reshard wall) book as migration."""
    from tony_tpu_torch.events import events as events_mod

    path = None
    try:
        for name in sorted(os.listdir(job_dir)):
            if name.endswith(constants.EVENTS_SUFFIX) \
                    or name.endswith(constants.INPROGRESS_SUFFIX):
                path = os.path.join(job_dir, name)
                break
    except OSError:
        return 0.0, 0.0, 0.0
    if path is None:
        return 0.0, 0.0, 0.0
    preempted = drain = migration = 0.0
    try:
        evs = events_mod.read_events(path)
    except OSError:
        return 0.0, 0.0, 0.0
    for ev in evs:
        if ev.payload.get("phase") != "completed":
            continue
        dur = float(ev.payload.get("duration_s", 0.0) or 0.0)
        if ev.type.value == "GANG_MIGRATED":
            migration += dur
        elif ev.type.value == "GANG_RESIZED":
            if int(ev.payload.get("to", 0) or 0) \
                    < int(ev.payload.get("from", 0) or 0):
                preempted += dur
            else:
                drain += dur
    return preempted, drain, migration


def _last_retry_reset_ms(job_dir: str) -> int:
    """ts of the LAST retry-epoch reset (session > 0) in the job's
    session journal, 0 when the job never retried."""
    path = os.path.join(job_dir, constants.JOURNAL_FILE)
    last = 0
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return 0
    for line in data.splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict) and rec.get("t") == "epoch" \
                and int(rec.get("session", 0) or 0) > 0:
            last = max(last, int(rec.get("ts", 0) or 0))
    return last


def _ckpt_stall_s(job_dir: str) -> float:
    doc = _load_json(os.path.join(job_dir, constants.PERF_FILE))
    if not doc:
        return 0.0
    phases = doc.get("phases_s")
    if not isinstance(phases, dict):
        return 0.0
    try:
        return max(0.0, float(phases.get("ckpt_stall", 0.0) or 0.0))
    except (TypeError, ValueError):
        return 0.0


def _host_integral(events: List[Tuple[int, int]],
                   end_ms: int) -> Tuple[float, float]:
    """(held_chip_s, avg_hosts) — the exact integral of the piecewise
    host count from the grant to ``end_ms``."""
    if not events or end_ms <= events[0][0]:
        return 0.0, 0.0
    total = 0.0
    span = (end_ms - events[0][0]) / 1000.0
    for i, (ts, hosts) in enumerate(events):
        nxt = events[i + 1][0] if i + 1 < len(events) else end_ms
        nxt = min(max(nxt, ts), end_ms)
        total += max(0, nxt - ts) / 1000.0 * max(0, hosts)
    return total, (total / span if span > 0 else 0.0)


def compute_job_ledger(fold: JobFold, job_dir: Optional[str] = None,
                       now_ms: Optional[int] = None) -> Dict[str, Any]:
    """One job's goodput ledger. ``job_dir`` is the job's HISTORY dir
    (span log / perf.json / events / session journal live there);
    None degrades to journal-only accounting (queued + train). Live
    jobs need ``now_ms`` as the provisional end anchor and are marked
    ``provisional``."""
    terminal = fold.state in TERMINAL_STATES
    end_ms = fold.finished_ms if terminal and fold.finished_ms \
        else int(now_ms or 0)
    start_ms = fold.submitted_ms
    phases: Dict[str, float] = {p: 0.0 for p in PHASES}
    doc: Dict[str, Any] = {
        "job": fold.job_id, "tenant": fold.tenant, "state": fold.state,
        "provisional": not terminal, "start_kind": "",
        "phases_s": phases, "wall_s": 0.0, "chip_seconds": {},
        "held_chip_s": 0.0, "lost_preempted_chip_s": 0.0,
        "goodput_fraction": None,
    }
    if not start_ms or end_ms <= start_ms:
        return doc
    wall_s = (end_ms - start_ms) / 1000.0
    doc["wall_s"] = round(wall_s, 4)

    anchors = {"submit_us": 0, "first_step_us": 0, "rendezvous_us": 0,
               "warm": False, "trace_id": ""}
    preempted_s = drain_s = migration_s = ckpt_s = 0.0
    last_reset_ms = 0
    if job_dir and os.path.isdir(job_dir):
        anchors = _span_anchors(job_dir)
        preempted_s, drain_s, migration_s = _event_windows(job_dir)
        ckpt_s = _ckpt_stall_s(job_dir)
        last_reset_ms = _last_retry_reset_ms(job_dir)
    doc["trace_id"] = anchors["trace_id"]

    def clamp(ms: float) -> float:
        return min(max(ms, float(start_ms)), float(end_ms))

    # Consecutive boundaries: each missing anchor folds its time
    # forward, so the partition stays exact (the cold-start shape).
    prev = float(start_ms)
    b_grant = clamp(fold.granted_ms) if fold.granted_ms else prev
    phases["queued"] = (b_grant - prev) / 1000.0
    prev = b_grant
    if not fold.granted_ms:
        # Never granted: the whole life is queue wait.
        phases["queued"] = wall_s
        _finish(doc, fold, end_ms)
        return doc
    b_client = clamp(anchors["submit_us"] / 1000.0) \
        if anchors["submit_us"] else prev
    b_client = max(b_client, prev)
    phases["provision"] = (b_client - prev) / 1000.0
    prev = b_client
    startup_us = anchors["first_step_us"] or anchors["rendezvous_us"]
    b_start = max(clamp(startup_us / 1000.0), prev) if startup_us \
        else prev
    start_kind = "warm" if anchors["warm"] else "cold"
    doc["start_kind"] = start_kind
    phases[f"{start_kind}_start"] = (b_start - prev) / 1000.0
    prev = b_start

    run_s = (end_ms - prev) / 1000.0
    retry_s = 0.0
    if last_reset_ms:
        retry_s = min(max(0.0, (last_reset_ms - prev) / 1000.0), run_s)
    phases["retry_recompute"] = retry_s
    post_s = run_s - retry_s
    stalls = {"ckpt_stall": ckpt_s, "preempted": preempted_s,
              "resize_drain": drain_s, "migration": migration_s}
    stall_total = sum(stalls.values())
    if stall_total > post_s > 0:
        # Over-attribution (overlapping windows, artifact rounding):
        # scale the stalls into the window rather than going negative.
        scale = post_s / stall_total
        stalls = {k: v * scale for k, v in stalls.items()}
        stall_total = post_s
    elif post_s <= 0:
        stalls = {k: 0.0 for k in stalls}
        stall_total = 0.0
    phases.update(stalls)
    phases["train"] = max(0.0, post_s - stall_total)
    for k in phases:
        phases[k] = round(phases[k], 4)
    _finish(doc, fold, end_ms)
    return doc


def _finish(doc: Dict[str, Any], fold: JobFold, end_ms: int) -> None:
    """Chip-second weighting + goodput over the final phase map."""
    phases = doc["phases_s"]
    held, avg_hosts = _host_integral(fold.host_events, end_ms)
    doc["held_chip_s"] = round(held, 4)
    if fold.host_events:
        hosts0 = fold.host_events[0][1]
        full, _ = _host_integral([(fold.host_events[0][0], hosts0)],
                                 end_ms)
        doc["lost_preempted_chip_s"] = round(max(0.0, full - held), 4)
    chip = {p: round(s * (avg_hosts if p != "queued" else 0.0), 4)
            for p, s in phases.items()}
    doc["chip_seconds"] = chip
    doc["goodput_fraction"] = round(chip["train"] / held, 4) \
        if held > 0 else None


def sum_to_wall_error(doc: Dict[str, Any]) -> float:
    """Absolute |sum(phases) - wall| beyond tolerance; 0.0 when the
    ledger holds its own invariant (what `tony-tpu check` enforces)."""
    wall = float(doc.get("wall_s", 0.0) or 0.0)
    total = sum(float(v) for v in (doc.get("phases_s") or {}).values())
    tol = max(SUM_ABS_TOL, SUM_REL_TOL * wall)
    err = abs(total - wall)
    return err if err > tol else 0.0


def rollup(ledgers: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-tenant and fleet-wide aggregation: chip-seconds per phase,
    goodput fraction, warm-start fraction, job counts."""
    tenants: Dict[str, Dict[str, Any]] = {}
    fleet = _empty_bucket()
    for led in ledgers:
        bucket = tenants.setdefault(str(led.get("tenant", "") or "?"),
                                    _empty_bucket())
        for b in (bucket, fleet):
            b["jobs"] += 1
            b["held_chip_s"] += float(led.get("held_chip_s", 0.0) or 0.0)
            b["lost_preempted_chip_s"] += float(
                led.get("lost_preempted_chip_s", 0.0) or 0.0)
            for p, v in (led.get("chip_seconds") or {}).items():
                b["phase_chip_s"][p] = b["phase_chip_s"].get(p, 0.0) \
                    + float(v or 0.0)
            for p, v in (led.get("phases_s") or {}).items():
                b["phase_s"][p] = b["phase_s"].get(p, 0.0) \
                    + float(v or 0.0)
            kind = led.get("start_kind")
            if kind == "warm":
                b["warm_starts"] += 1
            elif kind == "cold":
                b["cold_starts"] += 1
    for b in list(tenants.values()) + [fleet]:
        held = b["held_chip_s"]
        b["goodput_fraction"] = round(
            b["phase_chip_s"].get("train", 0.0) / held, 4) \
            if held > 0 else None
        starts = b["warm_starts"] + b["cold_starts"]
        b["warm_start_fraction"] = round(b["warm_starts"] / starts, 4) \
            if starts else None
        b["held_chip_s"] = round(held, 2)
        b["lost_preempted_chip_s"] = round(b["lost_preempted_chip_s"], 2)
        b["phase_chip_s"] = {p: round(v, 2)
                             for p, v in sorted(b["phase_chip_s"].items())}
        b["phase_s"] = {p: round(v, 2)
                        for p, v in sorted(b["phase_s"].items())}
    return {"tenants": {t: tenants[t] for t in sorted(tenants)},
            "fleet": fleet}


def _empty_bucket() -> Dict[str, Any]:
    return {"jobs": 0, "held_chip_s": 0.0, "lost_preempted_chip_s": 0.0,
            "phase_chip_s": {}, "phase_s": {}, "warm_starts": 0,
            "cold_starts": 0}


def job_history_dirs(fleet_dir: str) -> Dict[str, str]:
    """app_id → job history dir for every job the fleet ran (the fleet
    injects its own history root into every grant)."""
    from tony_tpu_torch.events import history

    root = os.path.join(fleet_dir, "history")
    if not os.path.isdir(root):
        return {}
    return history.list_job_dirs(root)


def fold_fleet_dir(fleet_dir: str,
                   now_ms: Optional[int] = None,
                   timeline=None) -> Dict[str, Any]:
    """Offline entry: fold the fleet journal (via the shared
    fleet/timeline.py replay — pass ``timeline`` to reuse a fold the
    caller already paid for), resolve each job's history dir, compute
    every ledger and the rollup — what `tony-tpu check`,
    `fleet diagnose` (offline) and the bench suite consume."""
    from tony_tpu_torch.fleet import timeline as ftimeline

    st = (timeline or ftimeline.load(fleet_dir)).state
    dirs = job_history_dirs(fleet_dir)
    jobs: Dict[str, Dict[str, Any]] = {}
    for job_id, fold in sorted(st.jobs.items()):
        jobs[job_id] = compute_job_ledger(
            fold, job_dir=dirs.get(fold.app_id), now_ms=now_ms)
    out = rollup(jobs.values())
    out["jobs"] = jobs
    return out
