"""Fleet daemon entrypoint: ``python -m tony_tpu_torch.fleet serve``.

The operator-facing wrapper is ``tony-tpu fleet start`` (spawns this
detached and waits for the endpoint); running ``serve`` directly keeps
the daemon in the foreground — the systemd/supervisor deployment shape.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
from typing import List, Optional

from tony_tpu_torch.fleet.daemon import FleetDaemon, FleetError
from tony_tpu_torch.fleet.health import HealthConfig


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="tony-tpu-fleet")
    sub = p.add_subparsers(dest="role", required=True)
    s = sub.add_parser("serve", help="run the fleet daemon (foreground)")
    s.add_argument("--dir", required=True, help="fleet state directory")
    s.add_argument("--slices", type=int, default=1)
    s.add_argument("--hosts-per-slice", type=int, default=8)
    s.add_argument("--quotas", default="",
                   help="per-tenant host quotas: tenant=hosts,...")
    s.add_argument("--pool-dir", default="",
                   help="warm executor pool granted jobs adopt from")
    s.add_argument("--tick-s", type=float, default=0.5)
    s.add_argument("--decision-ring", type=int, default=64,
                   help="per-job scheduler-decision ring bound "
                        "(tony.fleet.decision-ring)")
    s.add_argument("--ledger-interval-s", type=float, default=5.0,
                   help="goodput-ledger refresh cadence for running "
                        "jobs (tony.fleet.ledger-interval-s)")
    s.add_argument("--recover", action="store_true",
                   help="replay the fleet journal and resume the queue "
                        "(required when the dir holds non-terminal jobs)")
    s.add_argument("--health-enabled", type=int, default=1,
                   help="host-health subsystem switch "
                        "(tony.health.enabled)")
    s.add_argument("--health-half-life-s", type=float, default=300.0)
    s.add_argument("--health-suspect-threshold", type=float, default=1.0)
    s.add_argument("--health-quarantine-threshold", type=float,
                   default=3.0)
    s.add_argument("--health-quarantine-s", type=float, default=120.0)
    s.add_argument("--health-probation-priority", type=int, default=0)
    s.add_argument("--health-blast-n", type=int, default=2)
    s.add_argument("--health-blast-window-s", type=float, default=120.0)
    args = p.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    health_conf = HealthConfig(
        enabled=bool(args.health_enabled),
        half_life_s=args.health_half_life_s,
        suspect_threshold=args.health_suspect_threshold,
        quarantine_threshold=args.health_quarantine_threshold,
        quarantine_s=args.health_quarantine_s,
        probation_priority=args.health_probation_priority,
        blast_n=args.health_blast_n,
        blast_window_s=args.health_blast_window_s)
    try:
        daemon = FleetDaemon(args.dir, slices=args.slices,
                             hosts_per_slice=args.hosts_per_slice,
                             quotas=args.quotas, pool_dir=args.pool_dir,
                             tick_s=args.tick_s, recover=args.recover,
                             decision_ring=args.decision_ring,
                             ledger_interval_s=args.ledger_interval_s,
                             health_conf=health_conf)
    except (FleetError, ValueError) as e:
        print(f"fleet: {e}", file=sys.stderr)
        return 1
    signal.signal(signal.SIGTERM, lambda *_: daemon.request_stop())
    signal.signal(signal.SIGINT, lambda *_: daemon.request_stop())
    return daemon.run()


if __name__ == "__main__":
    sys.exit(main())
