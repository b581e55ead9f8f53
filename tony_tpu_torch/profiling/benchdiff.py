"""Bench regression gate: compare two BENCH json documents with tolerance.

The r04→r05 cold-start regression (submit_to_first_step_s 9.8s → 15.3s)
sat unnoticed in the BENCH trajectory until a manual re-anchor read the
numbers side by side. This module is the mechanical version of that
read: ``tony-tpu bench diff <base.json> <candidate.json>`` (and
``bench.py --against``) walks both documents, pairs every comparable
numeric metric, and exits nonzero when the candidate is worse than the
base by more than the tolerance — including the per-phase breakdowns
(cold-start ``phases`` and steady-state ``step_phases``), so a future
regression is attributed to a phase from the jsons alone.

Accepted shapes: the raw ``bench.py`` output line (``{"metric", "value",
"detail": {...}}``) or the harness wrapper that nests it under
``"parsed"`` (BENCH_r*.json).

Direction is inferred from the metric name, never guessed from values:
throughput-like names (tokens_per_sec, samples_per_sec, mfu, value) are
higher-is-better; latency-like names (*_s under phases,
submit_to_first_step_s, seconds_per_step) are lower-is-better; anything
unrecognized (loss, params, batch) is skipped — the gate must never
flag a config echo as a perf regression.

Stdlib-only on purpose: CI's no-deps lint job runs the gate on two
checked-in fixtures so the gate itself can't rot.
"""

from __future__ import annotations

import json
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: metric-name suffixes where bigger is better
_HIGHER = ("tokens_per_sec", "samples_per_sec", "mfu_vs_peak_bf16",
           "pct_of_synthetic", "steps_per_sec", "value",
           # BENCH_SCALE family (control-plane width, bench --suite
           # scale): sustained control throughput at width.
           "beats_per_sec", "records_per_sec",
           # BENCH_FLEET family (bench --suite fleet): chip-seconds
           # doing useful steps / chip-seconds held, and the warm-pool
           # adoption rate across tenants.
           "goodput_fraction", "warm_start_fraction",
           # BENCH_MIGRATE family (bench --suite migrate): share of the
           # synchronous save cost the async writer hides, and the
           # destination gang's warm-pool adoption rate.
           "ckpt_overlap_fraction", "warm_adoption_fraction",
           # BENCH_WHATIF family (bench --suite whatif): the
           # counterfactual's fractional queue-wait payoff on the
           # starved tenant, and how full the pool ran in the sim.
           "improvement_fraction", "utilization_fraction")
#: metric-name suffixes where smaller is better
_LOWER = ("submit_to_first_step_s", "probe_self_reported_s",
          "phase_total_s", "seconds_per_step", "mean_step_s",
          "comms_fraction",
          # BENCH_SCALE family: control-plane latency/stall metrics.
          "rendezvous_s", "tick_duration_s", "fsync_p99_s",
          "fsync_stall_fraction", "resize_latency_s",
          # BENCH_FLEET family: scheduler latency/churn metrics.
          "queue_wait_p50_s", "queue_wait_p99_s",
          "preemptions_per_job", "drain_s",
          # BENCH_MIGRATE family: the move's wall, training steps the
          # move lost (the e2e drills pin 0), and save()-blocking share
          # of the step loop under the async snapshot writer.
          "migration_wall_s", "steps_lost", "ckpt_stall_fraction",
          # BENCH_WHATIF family (bench --suite whatif, fleet time
          # machine): policy-parity divergences (must pin 0), the full
          # report's fold wall, the recorded mix's end-to-end span, and
          # per-kind hold seconds the counterfactual differ attributes.
          "parity_mismatches", "sim_wall_s", "makespan_s",
          "quota_hold_s", "capacity_hold_s", "fragmentation_hold_s",
          "preempt_wait_hold_s", "priority_hold_s")
#: path components under which every plain numeric leaf is seconds of a
#: phase breakdown → lower is better
_LOWER_CONTAINERS = ("phases", "step_phases_s", "phase_span_durations")

DEFAULT_TOLERANCE = 0.10

#: lower-is-better (seconds) metrics where BOTH sides sit under this are
#: host-jitter territory, not a regression signal — skipped entirely
#: (a 0.6ms→0.8ms phase wobble must not fail a bench run).
NOISE_FLOOR_S = 0.005


def _unwrap(doc: Dict[str, Any]) -> Dict[str, Any]:
    """BENCH_r*.json wraps the bench output under "parsed"."""
    if isinstance(doc.get("parsed"), dict):
        return doc["parsed"]
    return doc


def _direction(path: Tuple[str, ...]) -> Optional[str]:
    leaf = path[-1]
    if any(leaf == s or leaf.endswith(s) for s in _HIGHER):
        return "higher"
    if any(leaf == s or leaf.endswith(s) for s in _LOWER):
        return "lower"
    if any(p in _LOWER_CONTAINERS for p in path[:-1]):
        return "lower"
    return None


def flatten_metrics(doc: Dict[str, Any]) -> Dict[str, Tuple[str, float]]:
    """{dotted.path: (direction, value)} for every comparable numeric
    leaf of a bench document."""
    out: Dict[str, Tuple[str, float]] = {}

    def walk(node: Any, path: Tuple[str, ...]) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
            return
        if isinstance(node, bool) or not isinstance(node, (int, float)):
            return
        direction = _direction(path)
        if direction is not None:
            out[".".join(path)] = (direction, float(node))

    walk(_unwrap(doc), ())
    return out


def diff_bench(base: Dict[str, Any], candidate: Dict[str, Any],
               tolerance: float = DEFAULT_TOLERANCE) -> Dict[str, Any]:
    """Compare candidate against base. Returns ``{"compared": n,
    "regressions": [...], "improvements": [...], "missing": [...]}``;
    each row is ``{metric, direction, base, candidate, change_pct}``.
    A metric worse than base by more than ``tolerance`` (relative) is a
    regression; metrics absent from either side are listed, never
    flagged (a CPU smoke run lacks the TPU points by design)."""
    a = flatten_metrics(base)
    b = flatten_metrics(candidate)
    regressions: List[Dict[str, Any]] = []
    improvements: List[Dict[str, Any]] = []
    missing = sorted(set(a) - set(b))
    compared = 0
    for name in sorted(set(a) & set(b)):
        direction, base_v = a[name]
        _, cand_v = b[name]
        if base_v == 0:
            continue
        if direction == "lower" and max(base_v, cand_v) < NOISE_FLOOR_S:
            continue
        compared += 1
        rel = (cand_v - base_v) / abs(base_v)
        row = {"metric": name, "direction": direction,
               "base": base_v, "candidate": cand_v,
               "change_pct": round(100.0 * rel, 2)}
        worse = rel < -tolerance if direction == "higher" \
            else rel > tolerance
        better = rel > tolerance if direction == "higher" \
            else rel < -tolerance
        if worse:
            regressions.append(row)
        elif better:
            improvements.append(row)
    return {"compared": compared, "regressions": regressions,
            "improvements": improvements, "missing": missing,
            "tolerance": tolerance}


def _load(path: str) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: bench document must be a JSON object")
    return doc


def format_report(result: Dict[str, Any], base_name: str,
                  cand_name: str) -> str:
    lines = [f"bench diff: {base_name} -> {cand_name}  "
             f"({result['compared']} comparable metric(s), tolerance "
             f"{result['tolerance']:.0%})"]
    for row in result["regressions"]:
        arrow = "↓" if row["direction"] == "higher" else "↑"
        lines.append(
            f"  REGRESSION {row['metric']}: {row['base']:g} -> "
            f"{row['candidate']:g}  ({arrow}{abs(row['change_pct']):.1f}%"
            f", {row['direction']}-is-better)")
    for row in result["improvements"]:
        lines.append(
            f"  improved   {row['metric']}: {row['base']:g} -> "
            f"{row['candidate']:g}  ({row['change_pct']:+.1f}%)")
    if result["missing"]:
        lines.append(f"  (not in candidate: "
                     f"{', '.join(result['missing'][:8])}"
                     + (" …" if len(result["missing"]) > 8 else "") + ")")
    if not result["regressions"]:
        lines.append("  no regressions")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="tony-tpu bench diff",
        description="Compare two bench jsons; exit 1 on regression.")
    p.add_argument("base", help="baseline bench json (raw or BENCH_r*)")
    p.add_argument("candidate", help="candidate bench json")
    p.add_argument("--tolerance", type=float, default=DEFAULT_TOLERANCE,
                   help=f"relative tolerance before a worse metric "
                        f"counts as a regression (default "
                        f"{DEFAULT_TOLERANCE})")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit the diff as JSON")
    args = p.parse_args(argv)
    try:
        result = diff_bench(_load(args.base), _load(args.candidate),
                            tolerance=args.tolerance)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.as_json:
        print(json.dumps(result, indent=1, sort_keys=True))
    else:
        print(format_report(result, args.base, args.candidate))
    return 1 if result["regressions"] else 0


if __name__ == "__main__":
    sys.exit(main())
