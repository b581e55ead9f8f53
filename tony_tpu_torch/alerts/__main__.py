"""Fixture smoke for the default alert packs: evaluate both packs
against a ``metrics.prom`` snapshot in immediate mode (for-durations
ignored) and compare the firing set against ``--expect``.

    python -m tony_tpu_torch.alerts <metrics.prom> [--expect rule-a,rule-b]

Exit 0 iff the firing rule set equals the expected set (empty by
default — the healthy fixture). The no-deps CI lint job runs this over
two checked-in fixtures: healthy → nothing fires, breaching → the
expected set fires. Stdlib only, like the engine itself.
"""

from __future__ import annotations

import argparse
import sys
from typing import List

from tony_tpu_torch.alerts.rules import (
    AlertEngine,
    PromSource,
    default_fleet_pack,
    default_job_pack,
)


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tony_tpu_torch.alerts",
        description="evaluate the default alert packs against a "
                    "metrics.prom snapshot (immediate mode)")
    ap.add_argument("prom", help="path to a Prometheus text exposition")
    ap.add_argument("--expect", default="",
                    help="comma-separated rule names that must be "
                         "firing (default: none)")
    args = ap.parse_args(argv)

    with open(args.prom, "r", encoding="utf-8") as fh:
        source = PromSource(fh.read())

    engine = AlertEngine(default_job_pack() + default_fleet_pack(),
                         immediate=True)
    engine.evaluate(source)
    firing = sorted(row["rule"] for row in engine.firing())
    expected = sorted(r for r in args.expect.split(",") if r.strip())

    for row in engine.snapshot():
        mark = "FIRING" if row["state"] == "firing" else "ok"
        val = "" if row["value"] is None else f" value={row['value']:.4g}"
        print(f"{mark:>6}  {row['rule']} [{row['severity']}]{val}")

    if firing != expected:
        print(f"firing set mismatch: got {firing}, expected {expected}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
