"""Bottleneck verdicts over the step-phase ring: where do the lost MFU go.

The classifier consumes per-task phase FRACTIONS (seconds attributed to
each phase divided by the attributed wall — telemetry.phase_stats()
shipped on the heartbeat beacon) and returns one of five evidence-backed
verdicts, in the PR 5 rule-engine style: every verdict names the numbers
that fired it, because an operator must be able to check the
classifier's work before spending a week on async checkpointing.

Thresholds (module constants, tunable in one place):

- INPUT_BOUND: ``data_wait + h2d`` ≥ 15% of step wall — the input
  pipeline (host read, H2D transfer) stalls the device; overlap/prefetch
  is the fix, not a faster kernel.
- CKPT_BOUND: ``ckpt_stall`` ≥ 10% — synchronous checkpoint saves stall
  steps; async/overlapped checkpointing (ROADMAP item 4a) is the fix.
- COMMS_BOUND: ``comms`` ≥ 15% — collective waits (instrument DCN
  all-reduce with ``telemetry.phase("comms")``) dominate; overlap the
  gradient all-reduce.
- COMPUTE_BOUND: ``step_compute`` ≥ 70% and no waste class fired — the
  healthy verdict: the chip is the limit, go after kernels/precision.
- UNDERUTILIZED: unattributed ``other`` ≥ 30%, or nothing else fired —
  wall time is leaking into host-side gaps (python overhead, logging,
  un-instrumented eval); profile the host, not the device.

Waste classes outrank COMPUTE_BOUND; among fired waste classes the
largest fraction wins (the biggest recoverable slice is where to aim).
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

INPUT_BOUND = "INPUT_BOUND"
CKPT_BOUND = "CKPT_BOUND"
COMMS_BOUND = "COMMS_BOUND"
COMPUTE_BOUND = "COMPUTE_BOUND"
UNDERUTILIZED = "UNDERUTILIZED"

#: every category the classifier can return (golden-matrix test anchor).
VERDICTS = (INPUT_BOUND, CKPT_BOUND, COMMS_BOUND, COMPUTE_BOUND,
            UNDERUTILIZED)

# --- control-plane verdicts (coordinator self-observation) -----------------
# classify_coord consumes the COORDINATOR's own per-tick phase fractions
# (coordinator/coordphases.py) and names which O(n) control-plane loop is
# eating the tick — the numbers that aim the width restructuring
# (ROADMAP item 5: batched heartbeats, group-commit journal, hierarchical
# beacon fan-in, incremental cluster-spec deltas).
JOURNAL_BOUND = "JOURNAL_BOUND"
HEARTBEAT_BOUND = "HEARTBEAT_BOUND"
RENDEZVOUS_BOUND = "RENDEZVOUS_BOUND"
RPC_BOUND = "RPC_BOUND"
COORD_HEALTHY = "COORD_HEALTHY"

#: every category classify_coord can return (golden-matrix test anchor).
COORD_VERDICTS = (JOURNAL_BOUND, HEARTBEAT_BOUND, RENDEZVOUS_BOUND,
                  RPC_BOUND, COORD_HEALTHY)

#: schema version stamped into perf.json — bump on breaking changes.
PERF_SCHEMA = 1

INPUT_THRESHOLD = 0.15
CKPT_THRESHOLD = 0.10
COMMS_THRESHOLD = 0.15
COMPUTE_THRESHOLD = 0.70
OTHER_THRESHOLD = 0.30

#: verdict → one-line operator guidance (rendered by top/diagnose).
_ADVICE = {
    INPUT_BOUND: "the input pipeline stalls the device — raise prefetch "
                 "depth / overlap H2D, not the kernels",
    CKPT_BOUND: "checkpoint saves stall steps — move to async/overlapped "
                "checkpointing or widen the save interval",
    COMMS_BOUND: "collective waits dominate — bucket/overlap the DCN "
                 "all-reduce: set tony.train.accum-steps > 1 and tune "
                 "tony.train.bucket-mb (parallel/grad_sync.py)",
    COMPUTE_BOUND: "the chip is the limit — opt into low-precision "
                   "matmuls (tony.train.matmul-dtype=int8 | fp8_e4m3) "
                   "and the fused conv trunk; geometry is the remaining "
                   "lever",
    UNDERUTILIZED: "step wall leaks into unattributed host time — "
                   "instrument eval/logging phases or profile the host",
}


def phase_fractions(cum: Dict[str, float],
                    wall_s: float) -> Dict[str, float]:
    """Fraction of the attributed wall per phase (``other`` included when
    present in ``cum``; zero wall → {})."""
    try:
        wall = float(wall_s)
    except (TypeError, ValueError):
        return {}
    if wall <= 0:
        return {}
    out: Dict[str, float] = {}
    for name, secs in (cum or {}).items():
        try:
            out[str(name)] = max(0.0, float(secs)) / wall
        except (TypeError, ValueError):
            continue
    return out


def classify(fractions: Dict[str, float]) -> Dict[str, Any]:
    """One verdict over a fraction map. Returns ``{category, summary,
    advice, confidence, evidence: [..], fractions}`` — evidence lines
    carry the exact numbers and thresholds that fired."""
    f = {k: float(v) for k, v in (fractions or {}).items()}
    data = f.get("data_wait", 0.0) + f.get("h2d", 0.0)
    ckpt = f.get("ckpt_stall", 0.0)
    comms = f.get("comms", 0.0)
    compute = f.get("step_compute", 0.0)
    other = f.get("other", 0.0)
    evidence: List[str] = []
    waste = []
    if data >= INPUT_THRESHOLD:
        waste.append((data, INPUT_BOUND,
                      f"data_wait+h2d = {data:.1%} of step wall "
                      f"(threshold {INPUT_THRESHOLD:.0%})"))
    if ckpt >= CKPT_THRESHOLD:
        waste.append((ckpt, CKPT_BOUND,
                      f"ckpt_stall = {ckpt:.1%} of step wall "
                      f"(threshold {CKPT_THRESHOLD:.0%})"))
    if comms >= COMMS_THRESHOLD:
        waste.append((comms, COMMS_BOUND,
                      f"comms = {comms:.1%} of step wall "
                      f"(threshold {COMMS_THRESHOLD:.0%})"))
    if waste:
        waste.sort(reverse=True)
        frac, category, line = waste[0]
        evidence.append(line)
        for _, other_cat, other_line in waste[1:]:
            evidence.append(f"also fired: {other_cat} ({other_line})")
        evidence.append(f"step_compute = {compute:.1%}")
        if category == COMMS_BOUND:
            # Prescribe the fix this repo ships, not generic advice: the
            # comms phase is recorded by grad_sync's bucketed sync, and
            # these are its knobs.
            evidence.append(
                "knobs: tony.train.accum-steps (raise the compute:sync "
                "ratio), tony.train.bucket-mb (bucket/overlap the "
                "all-reduce)")
        confidence = min(0.95, 0.5 + frac)
    elif other >= OTHER_THRESHOLD:
        category = UNDERUTILIZED
        evidence.append(f"unattributed (other) = {other:.1%} of step "
                        f"wall (threshold {OTHER_THRESHOLD:.0%})")
        evidence.append(f"step_compute = {compute:.1%}")
        confidence = min(0.9, 0.4 + other)
    elif compute >= COMPUTE_THRESHOLD:
        category = COMPUTE_BOUND
        evidence.append(f"step_compute = {compute:.1%} of step wall "
                        f"(threshold {COMPUTE_THRESHOLD:.0%}); no waste "
                        f"class above threshold")
        evidence.append(
            "knobs: tony.train.matmul-dtype=int8|fp8_e4m3 (quantized "
            "projections, loss-parity-gated) — see docs/operations.md "
            "'Spending the verdict'")
        confidence = min(0.9, compute)
    else:
        category = UNDERUTILIZED
        evidence.append(
            f"no phase dominates: step_compute = {compute:.1%}, "
            f"data_wait+h2d = {data:.1%}, ckpt_stall = {ckpt:.1%}, "
            f"comms = {comms:.1%}, other = {other:.1%} — attribution is "
            f"spread thin (instrument the missing phases)")
        confidence = 0.4
    return {
        "category": category,
        "summary": _ADVICE[category],
        "advice": _ADVICE[category],
        "confidence": round(confidence, 3),
        "evidence": evidence,
        "fractions": {k: round(v, 4) for k, v in f.items()},
    }


#: control-plane thresholds: fraction of the coordinator's tick wall a
#: loop must eat before it is indicted (the tick wall includes the
#: monitor sleep, so even 15% of wall means the loop dominates the
#: coordinator's ACTIVE time many times over).
COORD_JOURNAL_THRESHOLD = 0.15
COORD_HEARTBEAT_THRESHOLD = 0.15
COORD_RENDEZVOUS_THRESHOLD = 0.15
COORD_RPC_THRESHOLD = 0.25

#: control-plane verdict → the restructure it prescribes. These name the
#: FUTURE knobs on purpose: the PR-12 width work (ROADMAP item 5) spends
#: exactly these verdicts, the way PR 10 spent COMMS_BOUND.
_COORD_ADVICE = {
    JOURNAL_BOUND: "fsync-per-journal-record dominates the tick — "
                   "group-commit the journal (batch appends per fsync) "
                   "before growing the gang further",
    HEARTBEAT_BOUND: "per-beat work (heartbeat scan + beacon fold) "
                     "dominates — batch/coalesce heartbeats and move to "
                     "hierarchical (per-jobtype sub-aggregator) beacon "
                     "fan-in",
    RENDEZVOUS_BOUND: "the global rendezvous barrier dominates — "
                      "hierarchical registration and incremental "
                      "cluster-spec deltas instead of full re-broadcast",
    RPC_BOUND: "RPC dispatch itself dominates — batch the per-task "
               "control RPCs (one frame per host, not per task) or "
               "shard the serve plane",
    COORD_HEALTHY: "the control plane keeps up at this width — no "
                   "restructure indicated",
}


def classify_coord(fractions: Dict[str, float]) -> Dict[str, Any]:
    """One control-plane verdict over a coordinator phase-fraction map
    (coordphases.fractions()). Same contract as classify(): every
    verdict is evidence-backed with the numbers and thresholds that
    fired, and the advice names the knob to spend it on."""
    f = {k: float(v) for k, v in (fractions or {}).items()}
    journal = f.get("journal_fsync", 0.0)
    beats = f.get("hb_scan", 0.0) + f.get("beacon_fold", 0.0)
    rendezvous = f.get("rendezvous_barrier", 0.0)
    rpc = f.get("rpc_serve", 0.0)
    idle = f.get("idle", 0.0)
    evidence: List[str] = []
    fired = []
    if journal >= COORD_JOURNAL_THRESHOLD:
        fired.append((journal, JOURNAL_BOUND,
                      f"journal_fsync = {journal:.1%} of tick wall "
                      f"(threshold {COORD_JOURNAL_THRESHOLD:.0%})"))
    if beats >= COORD_HEARTBEAT_THRESHOLD:
        fired.append((beats, HEARTBEAT_BOUND,
                      f"hb_scan+beacon_fold = {beats:.1%} of tick wall "
                      f"(threshold {COORD_HEARTBEAT_THRESHOLD:.0%})"))
    if rendezvous >= COORD_RENDEZVOUS_THRESHOLD:
        fired.append((rendezvous, RENDEZVOUS_BOUND,
                      f"rendezvous_barrier = {rendezvous:.1%} of tick "
                      f"wall (threshold "
                      f"{COORD_RENDEZVOUS_THRESHOLD:.0%})"))
    if rpc >= COORD_RPC_THRESHOLD:
        fired.append((rpc, RPC_BOUND,
                      f"rpc_serve = {rpc:.1%} of tick wall (threshold "
                      f"{COORD_RPC_THRESHOLD:.0%})"))
    if fired:
        fired.sort(reverse=True)
        frac, category, line = fired[0]
        evidence.append(line)
        for _, other_cat, other_line in fired[1:]:
            evidence.append(f"also fired: {other_cat} ({other_line})")
        evidence.append(f"idle = {idle:.1%}")
        confidence = min(0.95, 0.5 + frac)
    else:
        category = COORD_HEALTHY
        evidence.append(
            f"no control-plane loop above threshold: journal_fsync = "
            f"{journal:.1%}, hb_scan+beacon_fold = {beats:.1%}, "
            f"rendezvous_barrier = {rendezvous:.1%}, rpc_serve = "
            f"{rpc:.1%}, idle = {idle:.1%}")
        confidence = min(0.9, 0.4 + idle)
    return {
        "category": category,
        "summary": _COORD_ADVICE[category],
        "advice": _COORD_ADVICE[category],
        "confidence": round(confidence, 3),
        "evidence": evidence,
        "fractions": {k: round(v, 4) for k, v in f.items()},
    }


def build_perf_report(app_id: str,
                      per_task: Dict[str, Dict[str, Any]],
                      status: str = "") -> Dict[str, Any]:
    """The ``perf.json`` document: job-level phase totals (seconds, sum
    EXACTLY equals ``wall_s`` — the acceptance invariant), the job
    verdict over wall-weighted aggregate fractions, and per-task
    fractions + verdicts. ``per_task`` maps task_id → the beacon's
    ``step_phases`` payload ({"cum": {phase: s}, "wall_s": s,
    "steps": n, ...})."""
    agg: Dict[str, float] = {}
    wall_total = 0.0
    steps_total = 0.0
    tasks: Dict[str, Any] = {}
    for task_id, ph in sorted((per_task or {}).items()):
        if not isinstance(ph, dict):
            continue
        cum = ph.get("cum") or {}
        try:
            wall = float(ph.get("wall_s", 0.0) or 0.0)
        except (TypeError, ValueError):
            wall = 0.0
        fr = phase_fractions(cum, wall)
        row: Dict[str, Any] = {"wall_s": round(wall, 4),
                               "steps": ph.get("steps"),
                               "fractions": {k: round(v, 4)
                                             for k, v in fr.items()}}
        if fr:
            row["verdict"] = classify(fr)["category"]
        tasks[task_id] = row
        wall_total += wall
        try:
            steps_total += float(ph.get("steps", 0.0) or 0.0)
        except (TypeError, ValueError):
            pass
        for name, secs in cum.items():
            try:
                agg[str(name)] = agg.get(str(name), 0.0) + float(secs)
            except (TypeError, ValueError):
                continue
    fractions = phase_fractions(agg, wall_total)
    doc: Dict[str, Any] = {
        "schema": PERF_SCHEMA,
        "app_id": app_id,
        "status": status,
        "generated_ms": int(time.time() * 1000),
        "steps": steps_total,
        "wall_s": round(wall_total, 4),
        "phases_s": {k: round(v, 4) for k, v in sorted(agg.items())},
        "fractions": {k: round(v, 4) for k, v in sorted(fractions.items())},
        "verdict": classify(fractions) if fractions else None,
        "tasks": tasks,
    }
    return doc


def save_perf(path: str, doc: Dict[str, Any]) -> None:
    """Atomic replace — readers see the whole report or the previous one."""
    from tony_tpu_torch.utils.durable import atomic_write

    atomic_write(path, json.dumps(doc, indent=1,
                                  sort_keys=True).encode("utf-8"))


def load_perf(path: str) -> Optional[Dict[str, Any]]:
    """Decoded perf.json, or None when absent/torn/not-an-object."""
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None
