"""Steady-state step-time attribution: phase fractions → bottleneck verdict.

The observability layer ROADMAP item 4's perf PRs are measured against:
``telemetry.phase()`` records where each training step's wall time goes
(data_wait / h2d / step_compute / comms / ckpt_stall / eval + the
unattributed ``other``), the heartbeat beacon ships the totals to the
coordinator, and this package turns them into something an operator can
act on:

- ``verdict.classify`` — evidence-backed bottleneck classification
  (INPUT_BOUND / CKPT_BOUND / COMMS_BOUND / COMPUTE_BOUND /
  UNDERUTILIZED), shown live in ``tony-tpu top`` and attached to
  ``tony-tpu diagnose`` as a perf advisory;
- ``verdict.build_perf_report`` — the ``<job_dir>/perf.json`` artifact
  the coordinator writes at finish (phase totals sum exactly to the
  attributed wall);
- ``benchdiff`` — the regression gate over BENCH jsons
  (``tony-tpu bench diff`` / ``bench.py --against``), so a cold-start or
  per-phase regression is caught at bench time, not at the next manual
  re-anchor.
"""

from tony_tpu_torch.profiling.benchdiff import diff_bench  # noqa: F401
from tony_tpu_torch.profiling.verdict import (COMPUTE_BOUND,  # noqa: F401
                                        CKPT_BOUND, COMMS_BOUND,
                                        COORD_HEALTHY, COORD_VERDICTS,
                                        HEARTBEAT_BOUND, INPUT_BOUND,
                                        JOURNAL_BOUND, RENDEZVOUS_BOUND,
                                        RPC_BOUND, UNDERUTILIZED,
                                        VERDICTS, build_perf_report,
                                        classify, classify_coord,
                                        load_perf, phase_fractions,
                                        save_perf)
