"""Live job migration: drain → async snapshot → relaunch on another slice.

The reference's answer to "your slice is being reclaimed" was the whole
retry ladder: kill the gang, burn an attempt, relaunch wherever YARN put
you next (``ApplicationMaster.java:356-371``). This module composes the
primitives the elastic machinery already built into a MOVE instead:

- the **drain directive** (coordinator/elastic.py) parks the whole gang —
  every member's user process TERMs, its save-on-SIGTERM handler makes
  one final durable checkpoint (async writer, manifest-last:
  checkpoint/manager.py), and the executor waits at the barrier;
- at remesh the coordinator kills the parked source-slice executors,
  re-pins the job's ``node_pool`` to the target, and relaunches the SAME
  member indices there — destination executors adopt from the warm pool
  (tony_tpu_torch/pool.py) when one serves the target, else cold-spawn;
- the restored state reshards into the destination mesh through the
  ordinary restore path (manifest ``saved_mesh_shape`` +
  ``parallel/sharding.reshard``) — a migration that changes topology is
  just a resize that also moved.

Write-ahead ``REC_MIGRATE`` records (coordinator/journal.py) bracket the
op — ``start`` before the drain directive, ``applied`` before the
destination launches, ``superseded`` when a mid-migration host loss
folds the move into an ordinary elastic shrink — so a coordinator
SIGKILLed mid-migration re-enters the op under ``--recover`` instead of
abandoning the job, and `tony-tpu check` can prove every start was
closed (migrate-dangling).

Failure ladder (THE invariant): every abort path degrades to the
ordinary elastic/retry machinery — ``migrate.snapshot`` /
``migrate.adopt`` faults, barrier timeouts and launch failures all land
in the same INFRA_TRANSIENT epoch retry a plain host loss takes. A
failed migration is never worse than losing a host.

This module owns the POLICY (may this job move, and what does the move
look like); the coordinator owns every side effect — directives, kills,
launches, journal, events — exactly like the resize split.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, List

if TYPE_CHECKING:
    from tony_tpu_torch.coordinator.elastic import ElasticManager
    from tony_tpu_torch.coordinator.session import Session


class MigrateRefused(ValueError):
    """A migration request the policy rejects (no elastic machinery, no
    target, gang mid-resize...) — reported to the caller, never a job
    failure."""


@dataclasses.dataclass
class MigrationPlan:
    """A validated migration: the full live member set moves to
    ``target``. ``source`` is the slice the job sits on now (empty for
    jobs launched without a node-pool pin — local/virtual backends)."""

    job: str
    members: List[int]
    source: str
    target: str
    reason: str


def plan_migration(elastic: "ElasticManager", session: "Session",
                   target: str, job: str = "",
                   reason: str = "") -> MigrationPlan:
    """Validate a migrate request against the gang's state and return
    the plan. Raises MigrateRefused with the operator-readable reason
    when policy says no. Pure read — the coordinator acts on the plan
    via ``ElasticManager.begin(..., migrate=True)``."""
    if elastic is None or not elastic.enabled:
        raise MigrateRefused(
            "migration rides the elastic drain machinery — set "
            "tony.elastic.enabled=true")
    if job and job != elastic.job:
        raise MigrateRefused(
            f"jobtype {job!r} is not the elastic jobtype ({elastic.job})")
    if not elastic.established:
        raise MigrateRefused(
            "the gang has not completed its initial rendezvous yet")
    if elastic.resizing:
        op = elastic.op
        what = "migration" if op is not None and op.migrate else "resize"
        raise MigrateRefused(f"a {what} is already in progress")
    target = str(target or "").strip()
    if not target:
        raise MigrateRefused("no target slice given")
    source = ""
    job_spec = session.jobs.get(elastic.job)
    if job_spec is not None:
        source = str(job_spec.node_pool or "")
    if source and source == target:
        raise MigrateRefused(
            f"job already runs on slice {target!r}")
    members = sorted(t.index for t in session.all_tasks()
                     if t.job_name == elastic.job
                     and not t.status.terminal)
    if not members:
        raise MigrateRefused(f"no live {elastic.job} tasks to migrate")
    return MigrationPlan(job=elastic.job, members=members, source=source,
                         target=target,
                         reason=reason or f"migrate to {target}")
