"""Fleet policy engine: who runs, where, and at whose expense.

The YARN ResourceManager decided this for the reference (CapacityScheduler
queues + container preemption); here the decision logic is one small,
deterministic, stdlib-only module so it can be unit-tested exhaustively
and smoke-run in the no-deps CI lint job (``python -m
tony_tpu_torch.fleet.policy``). The daemon (``fleet/daemon.py``) owns every
side effect — journal records, spawns, resize RPCs — and calls in here
only to decide and to account.

Model:

- The pool is ``slices × hosts_per_slice`` hosts. A **sub-slice** job
  (fewer hosts than a slice) must land in ONE slice — a gang wants ICI
  locality — and slices are shared, best-fit, between sub-slice jobs.
  A larger job takes whole free slices plus a best-fit remainder.
- **Priority** orders the queue (higher first), submission sequence
  breaks ties (FIFO within a priority band).
- **Quotas** cap a tenant's granted hosts. A quota-denied submission
  stays queued and is SKIPPED — it never blocks other tenants' grants
  (no head-of-line quota starvation).
- A **capacity-denied** job at the head of the queue holds the line:
  nothing behind it is granted this pass (strict priority — backfill
  behind a starving large job is how large jobs starve forever), but
  quota-denials never hold.
- **Preempt-to-reclaim**: when the head job cannot fit, victims are
  chosen among strictly-lower-priority running jobs that declared a
  shrink floor (``min_hosts``), lowest priority first, youngest first
  within a priority, each shrunk only as far as needed and never below
  its floor. The plan reserves the reclaimed hosts for the demander;
  the daemon applies the shrinks through the victims' elastic resize
  (drain→remesh — no victim epoch burned) and the grant lands on a
  later pass once the hosts are free.
- **Grow-back**: with the queue drained and hosts free, previously
  shrunk jobs are restored toward their requested size, highest
  priority first — preemption is a loan, not a confiscation.
- **Defrag-by-migration**: when a FRAGMENTATION hold is computed (free
  hosts exist but do not pack), the planner looks for ONE running
  sub-slice elastic job whose live migration to another slice merges
  the holes so the demander places — cheaper than preempting anybody
  (no victim loses a host, the mover loses only its drain window).
- **Slice evacuation**: on a slice-preemption notice (the cloud is
  reclaiming a queued resource), every elastic job touching the dying
  slice gets a MIGRATE plan onto surviving capacity — spot survival by
  moving, not by dying and retrying.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

#: decision kinds (Decision.action)
GRANT = "grant"
SHRINK = "shrink"          # preempt-to-reclaim: victim shrinks via resize
MIGRATE = "migrate"        # live move between slices (defrag / evacuation)
QUOTA_DENIED = "quota"     # tenant at quota: stays queued, never holds
CAPACITY_DENIED = "capacity"  # pool full and nothing preemptible: holds
# Explainer-only decisions (tony-tpu fleet explain): the policy engine
# states why every OTHER queued job did not place this pass, not just
# the head of the line. The daemon records them (decision ring +
# REC_FLEET_DECISION journal) and applies nothing.
PREEMPT_WAIT = "preempt-wait"  # head job: shrinks planned, reclaim landing
PRIORITY_HELD = "held"         # queued behind the head-of-line hold

#: decisions that hold a job in the queue (vs. act on the pool) — the
#: set the daemon's decision recorder consumes.
HOLD_ACTIONS = (QUOTA_DENIED, CAPACITY_DENIED, PREEMPT_WAIT,
                PRIORITY_HELD)


@dataclasses.dataclass(frozen=True)
class JobRequest:
    """One submission as the policy engine sees it. ``min_hosts`` > 0
    marks the job elastic-shrinkable (a preemption victim candidate and
    a grow-back beneficiary); 0 means never preempt it."""

    job_id: str
    tenant: str
    priority: int = 0
    hosts: int = 1
    min_hosts: int = 0
    model: str = ""
    seq: int = 0


@dataclasses.dataclass
class Decision:
    """One step of a scheduling plan, applied in order by the daemon."""

    action: str
    job_id: str
    hosts: int = 0                       # grant size / shrink target
    placement: Dict[int, int] = dataclasses.field(default_factory=dict)
    reason: str = ""
    for_job: str = ""                    # SHRINK: the demanding job
    #: the jobs/tenants holding the capacity this decision waits on —
    #: the explainer's "who is blocking me" answer (hold decisions only)
    blocking: List[str] = dataclasses.field(default_factory=list)
    #: free hosts in the pool when a capacity hold was computed: free >=
    #: requested means the hosts EXIST but do not pack — fragmentation,
    #: not capacity (the fleet-diagnose FRAGMENTATION rule keys off it)
    free: int = 0
    #: MIGRATE only: the slice the job vacates and the slice it lands
    #: on (``placement`` already holds the POST-move layout)
    source: int = -1
    target: int = -1


@dataclasses.dataclass
class _Running:
    req: JobRequest
    hosts: int
    placement: Dict[int, int]


class SlicePool:
    """Host accounting over ``slices`` slices of ``hosts_per_slice``."""

    def __init__(self, slices: int, hosts_per_slice: int) -> None:
        self.slices = max(1, int(slices))
        self.hosts_per_slice = max(1, int(hosts_per_slice))
        self._free: List[int] = [self.hosts_per_slice] * self.slices
        #: hosts cordoned out of service by health quarantine (fleet/
        #: health.py) or operator cordon: per slice, free + in-use +
        #: cordoned == hosts_per_slice. Cordoned hosts are invisible to
        #: place() because they are simply not free.
        self._cordoned: List[int] = [0] * self.slices

    @property
    def total(self) -> int:
        return self.slices * self.hosts_per_slice

    @property
    def free_total(self) -> int:
        return sum(self._free)

    @property
    def cordoned_total(self) -> int:
        return sum(self._cordoned)

    def free_on(self, i: int) -> int:
        """Free hosts on one slice (the operator-migrate room check)."""
        return self._free[int(i)]

    def cordon_free(self, i: int) -> None:
        """Move one FREE host on slice ``i`` out of service. Occupied
        hosts are cordoned at release time instead (the daemon defers
        the sweep until the holding job frees them)."""
        i = int(i)
        if self._free[i] <= 0:
            raise ValueError(f"slice {i} has no free host to cordon")
        self._free[i] -= 1
        self._cordoned[i] += 1

    def uncordon(self, i: int) -> None:
        """Return one cordoned host on slice ``i`` to the free pool."""
        i = int(i)
        if self._cordoned[i] <= 0:
            raise ValueError(f"slice {i} has no cordoned host")
        self._cordoned[i] -= 1
        self._free[i] += 1

    def clone(self) -> "SlicePool":
        c = SlicePool(self.slices, self.hosts_per_slice)
        c._free = list(self._free)
        c._cordoned = list(self._cordoned)
        return c

    def place(self, hosts: int) -> Optional[Dict[int, int]]:
        """Placement for a gang of ``hosts``, or None when it cannot be
        packed. Sub-slice gangs go best-fit into ONE slice (tightest
        fitting slice — leaves big holes big); larger gangs take whole
        free slices first, then a best-fit remainder. Deterministic:
        ties break on the lowest slice index."""
        hosts = int(hosts)
        if hosts <= 0 or hosts > self.free_total:
            return None
        hps = self.hosts_per_slice
        if hosts < hps:
            best: Optional[int] = None
            for i, free in enumerate(self._free):
                if free >= hosts and (best is None
                                      or free < self._free[best]):
                    best = i
            return None if best is None else {best: hosts}
        placement: Dict[int, int] = {}
        remaining = hosts
        for i, free in enumerate(self._free):
            if remaining < hps:
                break
            if free == hps:
                placement[i] = hps
                remaining -= hps
        if remaining > 0:
            best = None
            for i, free in enumerate(self._free):
                if i in placement:
                    continue
                if free >= remaining and (best is None
                                          or free < self._free[best]):
                    best = i
            if best is None:
                return None
            placement[best] = remaining
        return placement

    def allocate(self, placement: Dict[int, int]) -> None:
        for i, n in placement.items():
            if self._free[i] < n:
                raise ValueError(
                    f"slice {i} has {self._free[i]} free, need {n}")
            self._free[i] -= n

    def release(self, placement: Dict[int, int]) -> None:
        for i, n in placement.items():
            self._free[i] = min(self.hosts_per_slice - self._cordoned[i],
                                self._free[i] + n)

    def shrink(self, placement: Dict[int, int],
               by: int) -> Dict[int, int]:
        """Free ``by`` hosts from ``placement``, CONCENTRATED: each
        host comes off the placement slice already closest to free
        (ties → lowest index), so shrinks vacate whole slices instead
        of fragmenting one hole per slice — a waiting gang needs
        contiguous slice capacity, not a scattered host count. Mutates
        and returns the placement; the preemption planner relies on
        plan-time and apply-time shrinks freeing the SAME slices."""
        for _ in range(int(by)):
            if not placement:
                break
            best = min(sorted(placement), key=lambda i: -self._free[i])
            placement[best] -= 1
            self._free[best] = min(
                self.hosts_per_slice - self._cordoned[best],
                self._free[best] + 1)
            if placement[best] == 0:
                del placement[best]
        return placement


class PolicyEngine:
    """Queue + accounting state; ``schedule()`` computes a plan, the
    mutators apply what the daemon actually carried out (write-ahead:
    the daemon journals each step before calling its mutator)."""

    def __init__(self, slices: int, hosts_per_slice: int,
                 quotas: Optional[Dict[str, int]] = None) -> None:
        self.pool = SlicePool(slices, hosts_per_slice)
        self.quotas: Dict[str, int] = dict(quotas or {})
        self._queued: Dict[str, JobRequest] = {}
        self._running: Dict[str, _Running] = {}
        #: host ids currently cordoned by health quarantine (set by the
        #: daemon, read by the CAPACITY_DENIED explainer: a hold caused
        #: by sick hardware must NAME the sick hardware, or the
        #: operator debugs a phantom capacity shortage).
        self.cordoned_names: List[str] = []

    # -- queries ---------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return len(self._queued)

    def queued_order(self) -> List[JobRequest]:
        return sorted(self._queued.values(),
                      key=lambda r: (-r.priority, r.seq))

    def running(self, job_id: str) -> Optional[Tuple[int, Dict[int, int]]]:
        r = self._running.get(job_id)
        return (r.hosts, dict(r.placement)) if r is not None else None

    def tenant_used(self) -> Dict[str, int]:
        used: Dict[str, int] = {}
        for r in self._running.values():
            used[r.req.tenant] = used.get(r.req.tenant, 0) + r.hosts
        return used

    # -- lifecycle mutators (the daemon journals, then calls these) ------
    def submit(self, req: JobRequest) -> None:
        if req.job_id in self._queued or req.job_id in self._running:
            raise ValueError(f"job {req.job_id!r} already known")
        if req.hosts > self.pool.total:
            raise ValueError(
                f"job {req.job_id!r} wants {req.hosts} hosts; the pool "
                f"only has {self.pool.total}")
        self._queued[req.job_id] = req

    def withdraw(self, job_id: str) -> bool:
        """Cancel a still-queued submission."""
        return self._queued.pop(job_id, None) is not None

    def grant(self, job_id: str, placement: Dict[int, int]) -> None:
        req = self._queued.pop(job_id)
        self.pool.allocate(placement)
        self._running[job_id] = _Running(req, sum(placement.values()),
                                         dict(placement))

    def force_grant(self, req: JobRequest, hosts: int,
                    placement: Dict[int, int]) -> None:
        """Recovery path: re-account a job the journal says is running
        (no queue transit, placement replayed verbatim)."""
        self.pool.allocate(placement)
        self._queued.pop(req.job_id, None)
        self._running[req.job_id] = _Running(req, hosts, dict(placement))

    def shrink_applied(self, job_id: str, to_hosts: int) -> Dict[int, int]:
        """A preemption shrink (or any downward resize) landed: free the
        difference and return the new placement."""
        r = self._running[job_id]
        by = r.hosts - int(to_hosts)
        if by > 0:
            self.pool.shrink(r.placement, by)
            r.hosts = int(to_hosts)
        return dict(r.placement)

    def grow_applied(self, job_id: str,
                     placement_delta: Dict[int, int]) -> Dict[int, int]:
        """A grow-back resize landed: account the extra hosts."""
        r = self._running[job_id]
        self.pool.allocate(placement_delta)
        for i, n in placement_delta.items():
            r.placement[i] = r.placement.get(i, 0) + n
        r.hosts += sum(placement_delta.values())
        return dict(r.placement)

    def release(self, job_id: str) -> None:
        """Terminal job: free everything it held."""
        r = self._running.pop(job_id, None)
        if r is not None:
            self.pool.release(r.placement)
        else:
            self._queued.pop(job_id, None)

    # -- the scheduling pass ---------------------------------------------
    def schedule(self) -> List[Decision]:
        """One scheduling pass over the queue (pure: mutates nothing —
        the daemon applies each Decision write-ahead and calls the
        mutators above for the ones that actually happened)."""
        plan: List[Decision] = []
        tentative = self.pool.clone()
        used = self.tenant_used()
        queue = self.queued_order()
        head_id = ""
        for pos, req in enumerate(queue):
            quota_hold = self._quota_hold(req, used)
            if quota_hold is not None:
                plan.append(quota_hold)
                continue            # quota never blocks other tenants
            placement = tentative.place(req.hosts)
            if placement is not None:
                tentative.allocate(placement)
                used[req.tenant] = used.get(req.tenant, 0) + req.hosts
                plan.append(Decision(GRANT, req.job_id, hosts=req.hosts,
                                     placement=placement))
                continue
            free = tentative.free_total
            shrinks = self._plan_preemption(req, tentative)
            if shrinks:
                plan.extend(shrinks)
                victims = [d.job_id for d in shrinks]
                plan.append(Decision(
                    PREEMPT_WAIT, req.job_id, hosts=req.hosts, free=free,
                    blocking=victims,
                    reason=f"reclaiming {max(0, req.hosts - free)} "
                           f"host(s) via elastic shrink of {victims} "
                           f"(priority {req.priority}); the grant lands "
                           f"once the drain completes"))
            elif free >= req.hosts \
                    and (moves := self._plan_defrag(req, tentative)):
                # FRAGMENTATION with a cure: one live migration merges
                # the holes. Nobody shrinks — the mover only pays its
                # drain window; the grant lands once the move completes.
                plan.extend(moves)
                movers = [d.job_id for d in moves]
                plan.append(Decision(
                    PREEMPT_WAIT, req.job_id, hosts=req.hosts,
                    free=free, blocking=movers,
                    reason=f"defragmentation: repacking via live "
                           f"migration of {movers} — the grant lands "
                           f"once the move completes"))
            else:
                holders = self._largest_holders()
                if free >= req.hosts:
                    why = (f"fragmentation: {free} free host(s) exist "
                           f"but do not pack into a {req.hosts}-host "
                           f"gang (sub-slice gangs need ONE slice)")
                else:
                    why = (f"{req.hosts} hosts do not fit ({free} free) "
                           f"and no lower-priority elastic capacity "
                           f"exists")
                if self.cordoned_names:
                    why += (f"; {len(self.cordoned_names)} host(s) "
                            f"cordoned by health quarantine: "
                            f"{self.cordoned_names}")
                plan.append(Decision(
                    CAPACITY_DENIED, req.job_id, hosts=req.hosts,
                    free=free, blocking=holders, reason=why))
            # Head-of-line hold: the reclaimed (or awaited) hosts belong
            # to THIS job; granting anything behind it would re-consume
            # them and starve the large/high-priority job forever. The
            # rest of the queue still gets an EXPLAINER decision each —
            # quota-denied where at quota, priority-held otherwise.
            head_id = req.job_id
            for later in queue[pos + 1:]:
                hold = self._quota_hold(later, used)
                if hold is None:
                    hold = Decision(
                        PRIORITY_HELD, later.job_id, hosts=later.hosts,
                        free=free, blocking=[head_id],
                        reason=f"held behind {head_id!r} (priority "
                               f"{req.priority}, seq {req.seq}) — "
                               f"head-of-line hold, no backfill")
                plan.append(hold)
            break
        return plan

    def _quota_hold(self, req: JobRequest,
                    used: Dict[str, int]) -> Optional[Decision]:
        quota = self.quotas.get(req.tenant, 0)
        if quota <= 0 or used.get(req.tenant, 0) + req.hosts <= quota:
            return None
        blocking = sorted(
            r.req.job_id for r in self._running.values()
            if r.req.tenant == req.tenant)
        return Decision(
            QUOTA_DENIED, req.job_id, hosts=req.hosts,
            blocking=blocking or [req.tenant],
            reason=f"tenant {req.tenant!r} at quota "
                   f"({used.get(req.tenant, 0)}/{quota} hosts; running: "
                   f"{blocking or 'none'})")

    def _largest_holders(self, limit: int = 5) -> List[str]:
        """Running jobs holding the most hosts — the 'who is blocking
        me' answer on a capacity hold."""
        holders = sorted(self._running.values(),
                         key=lambda r: (-r.hosts, r.req.seq))
        return [r.req.job_id for r in holders[:limit]]

    def _plan_preemption(self, req: JobRequest,
                         tentative: SlicePool) -> List[Decision]:
        """Shrink plan reclaiming enough PACKABLE capacity for ``req``
        from strictly lower-priority elastic jobs, or [] when
        impossible. Victim order: lowest priority first, then youngest
        (highest seq) — the job that has run longest is disturbed last.
        Placement-aware: each victim is shrunk one host at a time until
        the demander actually places (quantity alone is not enough — 3
        free hosts on one slice plus 2 on another never fit a 4-host
        gang), so victims are disturbed minimally and a geometrically
        unsatisfiable demand preempts nobody."""
        victims = sorted(
            (r for r in self._running.values()
             if r.req.priority < req.priority
             and r.req.min_hosts > 0 and r.hosts > r.req.min_hosts),
            key=lambda r: (r.req.priority, -r.req.seq))
        shrinks: List[Decision] = []
        trial = tentative.clone()
        for v in victims:
            if trial.place(req.hosts) is not None:
                break
            placement = dict(v.placement)
            to = v.hosts
            while to > v.req.min_hosts \
                    and trial.place(req.hosts) is None:
                trial.shrink(placement, 1)
                to -= 1
            if to < v.hosts:
                shrinks.append(Decision(
                    SHRINK, v.req.job_id, hosts=to,
                    for_job=req.job_id,
                    reason=f"reclaim {v.hosts - to} host(s) for "
                           f"{req.job_id!r} (priority {req.priority} > "
                           f"{v.req.priority})"))
        if not shrinks or trial.place(req.hosts) is None:
            # Failure MUST leave ``tentative`` untouched: schedule()
            # falls through to _plan_defrag next, and a defrag placement
            # computed against phantom reclaimed capacity is a MIGRATE
            # nobody can apply (migrate_applied would overfill a slice).
            return []
        tentative._free = list(trial._free)
        return shrinks

    def _plan_defrag(self, req: JobRequest,
                     tentative: SlicePool) -> List[Decision]:
        """ONE live migration that merges the fragmented holes so
        ``req`` places, or []. Candidates are running sub-slice elastic
        jobs (``min_hosts`` > 0 — migration rides the same drain
        machinery as a shrink) at or below the demander's priority,
        cheapest move first (fewest hosts), then youngest — the job
        that has run longest is disturbed last. Pure: works on clones
        of ``tentative``."""
        hps = self.pool.hosts_per_slice
        movers = sorted(
            (r for r in self._running.values()
             if len(r.placement) == 1 and r.hosts < hps
             and r.req.min_hosts > 0
             and r.req.priority <= req.priority),
            key=lambda r: (r.hosts, -r.req.seq))
        for v in movers:
            src = next(iter(v.placement))
            trial = tentative.clone()
            trial.release(v.placement)
            # Land the mover anywhere BUT its own slice — the point is
            # to merge the hole it leaves behind.
            src_free = trial._free[src]
            trial._free[src] = 0
            dest = trial.place(v.hosts)
            if dest is None or src in dest:
                continue
            trial.allocate(dest)
            trial._free[src] = src_free
            if trial.place(req.hosts) is None:
                continue
            tgt = next(iter(dest))
            return [Decision(
                MIGRATE, v.req.job_id, hosts=v.hosts, placement=dest,
                source=src, target=tgt, for_job=req.job_id,
                reason=f"defragmentation: moving {v.hosts} host(s) "
                       f"from slice {src} to slice {tgt} packs a "
                       f"{req.hosts}-host gang for {req.job_id!r}")]
        return []

    def evacuation_candidates(self, dying: List[int]) -> List[Decision]:
        """MIGRATE plan moving every elastic job off the ``dying``
        slices (a slice-preemption notice) onto surviving capacity,
        highest priority first. Jobs with no landing room — or without
        the elastic machinery a live move rides — are skipped; the
        ordinary host-loss ladder absorbs them when the slice dies.
        Pure: the daemon applies each move write-ahead and calls
        ``migrate_applied`` when it lands."""
        dying_set = {int(i) for i in dying
                     if 0 <= int(i) < self.pool.slices}
        if not dying_set:
            return []
        tentative = self.pool.clone()
        for i in dying_set:
            tentative._free[i] = 0      # never a migration target
        out: List[Decision] = []
        for r in sorted(self._running.values(),
                        key=lambda r: (-r.req.priority, r.req.seq)):
            doomed = {i: n for i, n in r.placement.items()
                      if i in dying_set}
            if not doomed or r.req.min_hosts <= 0:
                continue
            # The WHOLE gang moves (drain→move→reshard is one op), so
            # its healthy hosts free up for the placement too.
            for i, n in r.placement.items():
                if i not in dying_set:
                    tentative._free[i] = min(
                        self.pool.hosts_per_slice
                        - tentative._cordoned[i],
                        tentative._free[i] + n)
            dest = tentative.place(r.hosts)
            if dest is None:
                for i, n in r.placement.items():
                    if i not in dying_set:
                        tentative._free[i] -= n
                continue
            tentative.allocate(dest)
            src = min(doomed)
            tgt = min(dest)
            out.append(Decision(
                MIGRATE, r.req.job_id, hosts=r.hosts, placement=dest,
                source=src, target=tgt,
                reason=f"slice {sorted(doomed)} preemption notice: "
                       f"evacuating {r.hosts} host(s) to slice(s) "
                       f"{sorted(dest)} before the reclaim lands"))
        return out

    def migrate_applied(self, job_id: str,
                        placement: Dict[int, int]) -> Dict[int, int]:
        """A live migration landed: re-account the job's hosts at the
        new placement (host COUNT unchanged — a move, not a resize)."""
        r = self._running[job_id]
        self.pool.release(r.placement)
        self.pool.allocate(placement)
        r.placement = dict(placement)
        r.hosts = sum(placement.values())
        return dict(r.placement)

    def restore_candidates(self) -> List[Tuple[str, int, Dict[int, int]]]:
        """Grow-back plan: with an empty queue and free hosts, restore
        shrunk jobs toward their requested size, highest priority
        first. Returns (job_id, new_total_hosts, placement_delta)."""
        if self._queued:
            return []               # reclaimed space belongs to the queue
        out: List[Tuple[str, int, Dict[int, int]]] = []
        tentative = self.pool.clone()
        for r in sorted(self._running.values(),
                        key=lambda r: (-r.req.priority, r.req.seq)):
            want = r.req.hosts - r.hosts
            if want <= 0:
                continue
            grow = min(want, tentative.free_total)
            if grow <= 0:
                continue
            delta = tentative.place(grow)
            if delta is None:
                continue
            tentative.allocate(delta)
            out.append((r.req.job_id, r.hosts + grow, delta))
        return out


def parse_quotas(spec: str) -> Dict[str, int]:
    """'teamA=8,teamB=4' → {'teamA': 8, 'teamB': 4} (the
    tony.fleet.quotas grammar; blank entries skipped, bad ones raise)."""
    out: Dict[str, int] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        tenant, sep, hosts = part.partition("=")
        if not sep:
            raise ValueError(
                f"bad quota entry {part!r} (need tenant=hosts)")
        out[tenant.strip()] = int(hosts)
    return out


def _self_check() -> None:
    """Deterministic scenario asserting the four policy behaviours —
    the no-deps CI smoke (``python -m tony_tpu_torch.fleet.policy``)."""
    eng = PolicyEngine(2, 4, quotas={"capped": 2})
    # Bin-pack: two sub-slice jobs share one slice (best-fit).
    eng.submit(JobRequest("a", "t1", hosts=2, seq=1))
    eng.submit(JobRequest("b", "t1", hosts=2, seq=2))
    plan = eng.schedule()
    assert [d.action for d in plan] == [GRANT, GRANT], plan
    assert plan[0].placement == {0: 2} and plan[1].placement == {0: 2}
    for d in plan:
        eng.grant(d.job_id, d.placement)
    # Quota: the capped tenant queues WITHOUT blocking others.
    eng.submit(JobRequest("q", "capped", hosts=4, seq=3))
    eng.submit(JobRequest("c", "t2", hosts=4, seq=4))
    plan = eng.schedule()
    assert [(d.action, d.job_id) for d in plan] == [
        (QUOTA_DENIED, "q"), (GRANT, "c")], plan
    eng.grant("c", plan[1].placement)
    # Priority + preempt-to-reclaim: a priority-10 job arrives into a
    # full pool; with no declared floors nothing is preemptible...
    eng._queued.pop("q")
    eng.submit(JobRequest("hi", "t3", priority=10, hosts=3, seq=5))
    plan = eng.schedule()
    assert [d.action for d in plan] == [CAPACITY_DENIED], plan
    # ...but once the lower-priority job declares a shrink floor, the
    # plan reclaims exactly what the demander needs via elastic shrink.
    eng._running["c"].req = dataclasses.replace(
        eng._running["c"].req, min_hosts=1)
    plan = eng.schedule()
    # ...and the explainer records WHY the demander still waits this
    # pass (the reclaim is in flight), with the victim named.
    assert [d.action for d in plan] == [SHRINK, PREEMPT_WAIT], plan
    assert plan[0].job_id == "c" and plan[0].hosts == 1
    assert plan[1].job_id == "hi" and plan[1].blocking == ["c"]
    eng.shrink_applied("c", plan[0].hosts)
    plan = eng.schedule()
    assert [(d.action, d.job_id) for d in plan] == [(GRANT, "hi")], plan
    eng.grant("hi", plan[0].placement)
    # Grow-back: the demander leaves, the victim is restored.
    eng.release("hi")
    restores = eng.restore_candidates()
    assert restores and restores[0][0] == "c" and restores[0][1] == 4
    # Defrag-by-migration: 2+2 free hosts split across both slices
    # cannot pack a 4-host gang — moving one sub-slice elastic job
    # merges the holes, nobody shrinks.
    eng = PolicyEngine(2, 4)
    eng.submit(JobRequest("m1", "t1", hosts=2, min_hosts=1, seq=1))
    eng.grant("m1", {0: 2})
    eng.submit(JobRequest("m2", "t1", hosts=2, min_hosts=1, seq=2))
    eng.grant("m2", {1: 2})
    eng.submit(JobRequest("big", "t2", hosts=4, seq=3))
    plan = eng.schedule()
    assert [d.action for d in plan] == [MIGRATE, PREEMPT_WAIT], plan
    mv = plan[0]
    assert mv.job_id == "m2" and (mv.source, mv.target) == (1, 0), mv
    assert plan[1].blocking == ["m2"] \
        and plan[1].reason.startswith("defragmentation"), plan[1]
    eng.migrate_applied(mv.job_id, mv.placement)
    plan = eng.schedule()
    assert [(d.action, d.job_id) for d in plan] == [(GRANT, "big")], plan
    # Slice evacuation: a preemption notice on slice 0 moves the
    # elastic job there to surviving capacity; the job without a
    # shrink floor is left to the ordinary retry ladder.
    eng = PolicyEngine(2, 4)
    eng.submit(JobRequest("ev", "t1", hosts=2, min_hosts=1, seq=1))
    eng.grant("ev", {0: 2})
    eng.submit(JobRequest("pin", "t1", hosts=2, seq=2))
    eng.grant("pin", {0: 2})
    plan = eng.evacuation_candidates([0])
    assert [(d.action, d.job_id) for d in plan] == [(MIGRATE, "ev")], plan
    assert (plan[0].source, plan[0].target) == (0, 1), plan[0]
    eng.migrate_applied("ev", plan[0].placement)
    assert eng.running("ev") == (2, {1: 2})
    # Health cordon: a cordoned host is simply not free — placements
    # route around it, releases never resurrect it, and a capacity hold
    # caused by the cordon NAMES the sick host.
    eng = PolicyEngine(1, 4)
    eng.pool.cordon_free(0)
    assert (eng.pool.free_total, eng.pool.cordoned_total) == (3, 1)
    eng.cordoned_names = ["s0h3"]
    eng.submit(JobRequest("w", "t1", hosts=4, seq=1))
    plan = eng.schedule()
    assert [d.action for d in plan] == [CAPACITY_DENIED], plan
    assert "s0h3" in plan[0].reason, plan[0].reason
    eng._queued.pop("w")
    eng.submit(JobRequest("x", "t1", hosts=3, seq=2))
    plan = eng.schedule()
    assert [d.action for d in plan] == [GRANT], plan
    eng.grant("x", plan[0].placement)
    eng.release("x")
    assert eng.pool.free_total == 3   # release never refills the cordon
    eng.pool.uncordon(0)
    assert (eng.pool.free_total, eng.pool.cordoned_total) == (4, 0)
    print("fleet policy self-check OK")


if __name__ == "__main__":
    _self_check()
