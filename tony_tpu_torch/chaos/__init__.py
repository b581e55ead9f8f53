"""tonychaos — the seeded multi-fault chaos engine.

One seed, one reproducible storm. The engine composes the fault-site
registry (tony_tpu_torch/faults.py) into *schedules* — small correlated sets
of injections (host losses, asymmetric RPC partitions, disk faults,
fleet preemption storms) — runs each schedule against the in-process
control plane (a real :class:`Coordinator` over virtual executors, or a
real :class:`FleetDaemon` over a fake job runner), and holds every run
to the invariant ladder:

1. the job SUCCEEDED, or ended terminal with the CORRECT failure
   domain (infra-only injections must never read as USER_ERROR);
2. ``tony-tpu check`` over the run's artifacts is clean;
3. zero orphan processes carry the run's TONY_APP_ID marker;
4. the lock sanitizer and race detector (when armed) stayed quiet.

Every run writes a replayable artifact; ``tony-tpu chaos replay``
re-plans the schedule bit-identically from (seed, index, suite) and
re-runs it, and ``tony-tpu chaos shrink`` delta-debugs a failing
schedule down to the minimal injection set that still fails.

    tony-tpu chaos run --seed 17 --schedules 200 --suite e2e
    tony-tpu chaos replay chaos-artifacts/schedule-000042.json
    tony-tpu chaos shrink chaos-artifacts/schedule-000042.json
"""

from tony_tpu_torch.chaos.artifact import load_artifact, save_artifact
from tony_tpu_torch.chaos.schedule import Injection, Schedule, plan
from tony_tpu_torch.chaos.shrink import ddmin

__all__ = ["Injection", "Schedule", "plan", "ddmin", "load_artifact",
           "save_artifact"]
