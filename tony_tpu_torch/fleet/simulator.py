"""Fleet time machine: deterministic what-if scheduler simulation.

Every fleet number the repo produces is retrospective — the goodput
ledger says where chip-seconds WENT, ``fleet diagnose`` says which
tenant is starving NOW. An operator who suspects a quota bump, a
priority flip, or a bigger pool would fix a STARVATION or FRAGMENTATION
verdict had no way to test the hypothesis short of touching production
(ROADMAP item 5b). This module closes the loop:

1. ``fold_workload`` folds a recorded fleet journal (via the shared
   ``fleet/timeline.py`` replay) into a workload: submit times, tenants,
   priorities, gang sizes, shrink floors, and each job's OBSERVED work —
   the chip-millisecond integral of its piecewise host count from grant
   to terminal (a job shrunk to half rate for half its life carries that
   into every counterfactual).
2. ``parity_replay`` is the calibration gate: the journal's own
   decision/grant/preempt/migrate sequence is re-derived record by
   record through the REAL :class:`fleet.policy.PolicyEngine` and
   compared bit-for-bit. A journal that parity-replays clean proves the
   simulator and the daemon share one scheduling brain — which is what
   makes a counterfactual trustworthy.
3. ``simulate`` re-executes the workload as a discrete-event simulation
   against the same engine under OVERRIDDEN configuration — quotas,
   pool shape, per-job priorities, preemption/defrag/restore toggles
   (``tony.fleet.sim-*``) — with work consumed at the granted host
   rate, so shrinks stretch runtimes and bigger pools compress them.
4. ``whatif`` diffs counterfactual metrics (goodput fraction, queue-wait
   p50/p99, preemptions, per-tenant quota/fragmentation hold seconds —
   the same hold algebra ``fleet explain`` renders) against the
   simulated baseline, expands ``--sweep`` grids, and cites which holds
   each counterfactual removed.

Everything is integer-millisecond arithmetic on journal timestamps —
no wall clock, no randomness — so the same journal plus the same
overrides produce a byte-identical report (test-enforced). The
simulator can also RECORD a run as a real fleet journal
(:class:`JournalRecorder`) — parity-clean by construction — which is
how the checked-in ``tests/fixtures/whatif_mix`` 50-job fixture and the
BENCH_WHATIF suite are generated.

Known limits (documented in docs/operations.md "Capacity planning and
what-if"): observed durations were measured UNDER the recorded
contention (a job that thrashed may carry inflated work into the
counterfactual), migrations/restores apply instantly (no drain
window), and host-health cordons mid-journal are approximated from the
fhealth fold. Stdlib-only, side-effect-free, like the policy engine.

The no-deps CI smoke runs ``python -m tony_tpu_torch.fleet.simulator
<fleet_dir-or-journal> --expect-parity`` (plus counterfactual flags)
against the checked-in fixtures.
"""

from __future__ import annotations

import dataclasses
import heapq
import json
from typing import Any, Dict, Iterable, List, Optional, Tuple

from tony_tpu_torch.conf import keys as K
from tony_tpu_torch.fleet import journal as fjournal
from tony_tpu_torch.fleet import ledger as fledger
from tony_tpu_torch.fleet import policy as fpolicy
from tony_tpu_torch.fleet import timeline as ftimeline

#: fallback per-host work for a job the journal never ran (submitted
#: but never granted): the median observed per-host duration is used
#: instead when any job finished; this only when NONE did.
DEFAULT_HOST_WORK_MS = 60_000

#: cap on the expanded sweep grid — a fat-fingered sweep should fail
#: loudly, not run for an hour.
SWEEP_CAP = 64

#: hold kind -> report metric key ("-" and the policy's terse "held"
#: are report-hostile).
HOLD_METRIC = {
    fpolicy.QUOTA_DENIED: "quota_hold_s",
    fpolicy.CAPACITY_DENIED: "capacity_hold_s",
    ftimeline.FRAGMENTATION: "fragmentation_hold_s",
    fpolicy.PREEMPT_WAIT: "preempt_wait_hold_s",
    fpolicy.PRIORITY_HELD: "priority_hold_s",
}

#: metric direction for the diff report (mirrors profiling/benchdiff.py
#: suffix conventions; used to mark each delta improves/regresses).
LOWER_BETTER = (
    "queue_wait_p50_s", "queue_wait_p99_s", "queue_wait_mean_s",
    "makespan_s", "preemptions", "preemptions_per_job", "migrations",
    "restores", "ungranted", "refused") + tuple(HOLD_METRIC.values())
HIGHER_BETTER = ("goodput_fraction", "utilization_fraction", "granted")


# ---------------------------------------------------------------------------
# workload fold: journal -> replayable submissions with observed work
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SimJob:
    """One recorded submission as the simulator replays it."""

    job_id: str
    tenant: str
    priority: int
    hosts: int
    min_hosts: int
    model: str
    seq: int
    submit_ms: int
    #: observed work in chip-milliseconds (host-count integral from
    #: grant to terminal) — consumed at the granted host rate, so a
    #: counterfactual that grants more hosts finishes the job sooner.
    work_chip_ms: int
    #: recorded terminal state (FINISHED/FAILED/CANCELLED), or "" when
    #: the journal never finished it — re-emitted by record mode.
    recorded_state: str = ""


@dataclasses.dataclass
class Workload:
    """The folded timeline ``simulate()`` re-executes."""

    slices: int
    hosts_per_slice: int
    quotas: Dict[str, int]
    jobs: List[SimJob]

    @property
    def pool_chips(self) -> int:
        return self.slices * self.hosts_per_slice


def _work_chip_ms(fold: fjournal.JobFold, end_ms: int) -> int:
    """Exact chip-ms integral of the fold's piecewise host count from
    the grant to its terminal anchor (or ``end_ms`` for a live job)."""
    events = fold.host_events
    stop = fold.finished_ms if fold.finished_ms else end_ms
    total = 0
    for i, (ts, hosts) in enumerate(events):
        nxt = events[i + 1][0] if i + 1 < len(events) else stop
        nxt = min(max(nxt, ts), stop)
        total += max(0, nxt - ts) * max(0, hosts)
    return total


def fold_workload(tl: ftimeline.FleetTimeline) -> Workload:
    """Fold the shared timeline into the simulator's workload. Jobs the
    journal never granted get the median observed per-host duration as
    their work estimate (their TRUE duration was never observed — the
    docs call this out as a trust caveat)."""
    st = tl.state
    end_ms = max((int(r.get("ts", 0) or 0) for r in tl.records),
                 default=0)
    per_host: List[int] = []
    for fold in st.jobs.values():
        work = _work_chip_ms(fold, end_ms)
        if work > 0 and fold.hosts_requested > 0:
            per_host.append(work // fold.hosts_requested)
    per_host.sort()
    median = per_host[len(per_host) // 2] if per_host \
        else DEFAULT_HOST_WORK_MS
    jobs: List[SimJob] = []
    for fold in sorted(st.jobs.values(), key=lambda f: f.seq):
        work = _work_chip_ms(fold, end_ms)
        if work <= 0:
            work = median * max(1, fold.hosts_requested)
        jobs.append(SimJob(
            job_id=fold.job_id, tenant=fold.tenant,
            priority=fold.priority, hosts=fold.hosts_requested,
            min_hosts=fold.min_hosts, model=fold.model, seq=fold.seq,
            submit_ms=fold.submitted_ms, work_chip_ms=work,
            recorded_state=fold.state
            if fold.state in fjournal.TERMINAL_STATES else ""))
    return Workload(slices=st.slices, hosts_per_slice=st.hosts_per_slice,
                    quotas=dict(st.quotas), jobs=jobs)


# ---------------------------------------------------------------------------
# counterfactual overrides
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Overrides:
    """One counterfactual configuration: what differs from the
    recorded policy. Everything defaults to "as recorded"."""

    quotas: Dict[str, int] = dataclasses.field(default_factory=dict)
    slices: Optional[int] = None
    hosts_per_slice: Optional[int] = None
    priorities: Dict[str, int] = dataclasses.field(default_factory=dict)
    preemption: bool = True
    defrag: bool = True
    restore: bool = True

    def describe(self) -> str:
        parts: List[str] = []
        for t in sorted(self.quotas):
            parts.append(f"quota.{t}={self.quotas[t]}")
        if self.slices is not None:
            parts.append(f"slices={self.slices}")
        if self.hosts_per_slice is not None:
            parts.append(f"hosts-per-slice={self.hosts_per_slice}")
        for j in sorted(self.priorities):
            parts.append(f"priority.{j}={self.priorities[j]}")
        if not self.preemption:
            parts.append("preemption=off")
        if not self.defrag:
            parts.append("defrag=off")
        if not self.restore:
            parts.append("restore=off")
        return " ".join(parts) or "baseline"

    def clone(self) -> "Overrides":
        return Overrides(quotas=dict(self.quotas), slices=self.slices,
                         hosts_per_slice=self.hosts_per_slice,
                         priorities=dict(self.priorities),
                         preemption=self.preemption, defrag=self.defrag,
                         restore=self.restore)


def _parse_bool(value: str) -> bool:
    v = value.strip().lower()
    if v in ("true", "1", "yes", "on"):
        return True
    if v in ("false", "0", "no", "off"):
        return False
    raise ValueError(f"not a boolean: {value!r}")


def apply_override(ov: Overrides, key: str, value: str) -> None:
    """One ``--set``/``--sweep`` assignment onto ``ov``. Accepts the
    registered ``tony.fleet.*`` keys plus the whatif shorthands
    (``quota.<tenant>``, ``priority.<job>``, ``pool=SxH``). Inside
    sweep grids ``|`` stands in for ``,`` in quota specs."""
    key = key.strip()
    value = value.strip()
    if key in (K.FLEET_QUOTAS, "quotas"):
        ov.quotas.update(fpolicy.parse_quotas(value.replace("|", ",")))
    elif key.startswith("quota.") or key.startswith("quota:"):
        ov.quotas[key[len("quota."):]] = int(value)
    elif key in (K.FLEET_SLICES, "slices"):
        ov.slices = int(value)
    elif key in (K.FLEET_HOSTS_PER_SLICE, "hosts-per-slice"):
        ov.hosts_per_slice = int(value)
    elif key == "pool":
        ov.slices, ov.hosts_per_slice = parse_pool(value)
    elif key.startswith("priority.") or key.startswith("priority:"):
        ov.priorities[key[len("priority."):]] = int(value)
    elif key in (K.FLEET_SIM_PREEMPTION, "preemption"):
        ov.preemption = _parse_bool(value)
    elif key in (K.FLEET_SIM_DEFRAG, "defrag"):
        ov.defrag = _parse_bool(value)
    elif key in (K.FLEET_SIM_RESTORE, "restore"):
        ov.restore = _parse_bool(value)
    else:
        raise ValueError(
            f"unknown whatif key {key!r} (settable: {K.FLEET_QUOTAS}, "
            f"{K.FLEET_SLICES}, {K.FLEET_HOSTS_PER_SLICE}, "
            f"{K.FLEET_SIM_PREEMPTION}, {K.FLEET_SIM_DEFRAG}, "
            f"{K.FLEET_SIM_RESTORE}, quota.<tenant>, priority.<job>, "
            f"pool)")


def parse_pool(spec: str) -> Tuple[int, int]:
    """``2x4`` / ``2×4`` -> (slices, hosts_per_slice)."""
    s = spec.strip().lower().replace("×", "x")
    slices, sep, hps = s.partition("x")
    if not sep:
        raise ValueError(f"bad pool spec {spec!r} (need SLICESxHOSTS)")
    return int(slices), int(hps)


def build_overrides(sets: Optional[Iterable[str]] = None,
                    quotas: Optional[Iterable[str]] = None,
                    pool: Optional[str] = None,
                    priorities: Optional[Iterable[str]] = None
                    ) -> Overrides:
    """The CLI surface: ``--set k=v``, ``--quota tenant=N``,
    ``--pool SxH``, ``--priority job=P`` folded into one Overrides."""
    ov = Overrides()
    for spec in sets or []:
        key, sep, value = spec.partition("=")
        if not sep:
            raise ValueError(f"bad --set {spec!r} (need key=value)")
        apply_override(ov, key, value)
    for spec in quotas or []:
        tenant, sep, n = spec.partition("=")
        if not sep:
            raise ValueError(f"bad --quota {spec!r} (need tenant=N)")
        ov.quotas[tenant.strip()] = int(n)
    if pool:
        ov.slices, ov.hosts_per_slice = parse_pool(pool)
    for spec in priorities or []:
        job, sep, p = spec.partition("=")
        if not sep:
            raise ValueError(f"bad --priority {spec!r} (need job=P)")
        ov.priorities[job.strip()] = int(p)
    return ov


def expand_sweeps(base: Overrides,
                  sweeps: Iterable[str]) -> List[Tuple[str, Overrides]]:
    """``--sweep key=a,b,c`` grids -> the cartesian product of
    (label, Overrides), each a clone of ``base`` with the grid point
    applied. Capped at SWEEP_CAP combinations."""
    axes: List[Tuple[str, List[str]]] = []
    for spec in sweeps:
        key, sep, values = spec.partition("=")
        if not sep:
            raise ValueError(f"bad --sweep {spec!r} (need key=a,b,c)")
        vals = [v for v in (s.strip() for s in values.split(",")) if v]
        if not vals:
            raise ValueError(f"--sweep {spec!r} has no values")
        axes.append((key.strip(), vals))
    combos: List[List[Tuple[str, str]]] = [[]]
    for key, vals in axes:
        combos = [c + [(key, v)] for c in combos for v in vals]
        if len(combos) > SWEEP_CAP:
            raise ValueError(
                f"sweep grid exceeds {SWEEP_CAP} combinations")
    out: List[Tuple[str, Overrides]] = []
    for combo in combos:
        if not combo:
            continue
        ov = base.clone()
        for key, value in combo:
            apply_override(ov, key, value)
        out.append((" ".join(f"{k}={v}" for k, v in combo), ov))
    return out


# ---------------------------------------------------------------------------
# journal recorder: a simulated run written as a REAL fleet journal
# ---------------------------------------------------------------------------
class JournalRecorder:
    """Writes the simulated sequence as an ordinary fleet journal with
    the simulation's own timestamps — the fixture generator behind
    ``tests/fixtures/whatif_mix`` and the round-trip determinism tests.
    Record shapes match :class:`fleet.journal.FleetJournal`'s typed
    appenders exactly (explicit ``ts`` wins over the appender's
    wall-clock setdefault), so the output replays, parity-checks and
    invariant-checks like a daemon's journal."""

    def __init__(self, path: str) -> None:
        self._journal = fjournal.FleetJournal(path)

    def _append(self, ts: int, rec: Dict[str, Any]) -> None:
        rec["ts"] = int(ts)
        self._journal.append(rec)

    def generation(self, ts: int, wl: Workload) -> None:
        self._append(ts, {
            "t": fjournal.REC_FLEET_GEN, "generation": 1,
            "slices": wl.slices, "hosts_per_slice": wl.hosts_per_slice,
            "quotas": {str(t): int(q) for t, q in wl.quotas.items()}})

    def submit(self, ts: int, job: SimJob) -> None:
        self._append(ts, {
            "t": fjournal.REC_FLEET_SUBMIT, "job": job.job_id,
            "tenant": job.tenant, "priority": job.priority,
            "hosts": job.hosts, "min_hosts": job.min_hosts,
            "model": job.model, "seq": job.seq, "conf": {}})

    def grant(self, ts: int, job_id: str, hosts: int,
              placement: Dict[int, int]) -> None:
        self._append(ts, {
            "t": fjournal.REC_FLEET_GRANT, "job": job_id, "hosts": hosts,
            "placement": {str(i): int(n) for i, n in placement.items()}})

    def preempt(self, ts: int, job_id: str, from_hosts: int,
                to_hosts: int, for_job: str,
                placement: Dict[int, int]) -> None:
        self._append(ts, {
            "t": fjournal.REC_FLEET_PREEMPT, "job": job_id,
            "from": int(from_hosts), "to": int(to_hosts),
            "for": for_job,
            "placement": {str(i): int(n) for i, n in placement.items()}})

    def migrate(self, ts: int, job_id: str, source: int, target: int,
                placement: Dict[int, int], reason: str) -> None:
        self._append(ts, {
            "t": fjournal.REC_FLEET_MIGRATE, "job": job_id,
            "source": int(source), "target": int(target),
            "placement": {str(i): int(n) for i, n in placement.items()},
            "reason": reason})

    def decision(self, ts: int, d: fpolicy.Decision) -> None:
        self._append(ts, {
            "t": fjournal.REC_FLEET_DECISION, "job": d.job_id,
            "action": d.action, "reason": d.reason,
            "blocking": [str(b) for b in d.blocking],
            "free": int(d.free)})

    def state(self, ts: int, job_id: str, state: str,
              exit_code: Optional[int] = None, hosts: int = 0,
              placement: Optional[Dict[int, int]] = None) -> None:
        rec: Dict[str, Any] = {"t": fjournal.REC_FLEET_STATE,
                               "job": job_id, "state": state}
        if exit_code is not None:
            rec["exit"] = int(exit_code)
        if hosts:
            rec["hosts"] = int(hosts)
        if placement is not None:
            rec["placement"] = {str(i): int(n)
                                for i, n in placement.items()}
        self._append(ts, rec)

    def close(self) -> None:
        self._journal.close()


# ---------------------------------------------------------------------------
# the discrete-event simulation
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _Run:
    """One granted job mid-flight: remaining chip-ms consumed at the
    current host rate; ``version`` invalidates stale finish events
    after a shrink/restore re-rates the job."""

    remaining_ms: int
    hosts: int
    last_ms: int
    version: int = 0
    done: bool = False


class _Sim:
    def __init__(self, wl: Workload, ov: Overrides,
                 recorder: Optional[JournalRecorder]) -> None:
        self.recorder = recorder
        self.defrag_on = ov.defrag
        self.restore_on = ov.restore
        slices = ov.slices if ov.slices is not None else wl.slices
        hps = ov.hosts_per_slice if ov.hosts_per_slice is not None \
            else wl.hosts_per_slice
        quotas = dict(wl.quotas)
        quotas.update(ov.quotas)
        self.quotas = {t: q for t, q in quotas.items() if q > 0}
        self.slices, self.hps = slices, hps
        self.engine = fpolicy.PolicyEngine(slices, hps, self.quotas)
        self.jobs: Dict[str, SimJob] = {}
        for j in wl.jobs:
            prio = ov.priorities.get(j.job_id, j.priority)
            # preemption off = every gang is rigid: no shrink floor, so
            # the preemption AND defrag planners find no elastic victims.
            minh = j.min_hosts if ov.preemption else 0
            self.jobs[j.job_id] = dataclasses.replace(
                j, priority=prio, min_hosts=minh)
        self.runs: Dict[str, _Run] = {}
        self.fence: Dict[str, str] = {}      # job -> last hold reason
        self.decisions: Dict[str, List[Dict[str, Any]]] = {}
        self.placements: Dict[str, Dict[int, int]] = {}
        self.host_events: Dict[str, List[Tuple[int, int]]] = {}
        self.granted_ms: Dict[str, int] = {}
        self.finished_ms: Dict[str, int] = {}
        self.refused: List[Dict[str, Any]] = []
        self.preemptions = self.migrations = self.restores = 0
        self._order = 0
        self._heap: List[Tuple[int, int, int, str, str, int]] = []

    # -- event plumbing --------------------------------------------------
    def _push(self, ms: int, kind: int, name: str, job_id: str,
              version: int) -> None:
        self._order += 1
        heapq.heappush(self._heap,
                       (ms, kind, self._order, name, job_id, version))

    def _consume(self, run: _Run, ts: int) -> None:
        run.remaining_ms -= (ts - run.last_ms) * run.hosts
        run.last_ms = ts

    def _push_finish(self, job_id: str, run: _Run, ts: int) -> None:
        left_ms = -(-max(0, run.remaining_ms) // max(1, run.hosts))
        self._push(ts + left_ms, 0, "finish", job_id, run.version)

    # -- the run ---------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        for j in sorted(self.jobs.values(), key=lambda j: j.seq):
            self._push(j.submit_ms, 1, "submit", j.job_id, 0)
        origin_ms = self._heap[0][0] if self._heap else 0
        if self.recorder:
            self.recorder.generation(
                origin_ms, Workload(self.slices, self.hps, self.quotas,
                                    []))
        end_ms = origin_ms
        while self._heap:
            ts = self._heap[0][0]
            while self._heap and self._heap[0][0] == ts:
                _, _, _, name, job_id, version = heapq.heappop(self._heap)
                if name == "submit":
                    self._submit(self.jobs[job_id], ts)
                else:
                    self._finish(job_id, version, ts)
            self._passes(ts)
            if self.restore_on:
                self._restores(ts)
            end_ms = max(end_ms, ts)
        if self.recorder:
            self.recorder.close()
        return self._result(origin_ms, end_ms)

    def _submit(self, job: SimJob, ts: int) -> None:
        req = fpolicy.JobRequest(
            job.job_id, job.tenant, priority=job.priority,
            hosts=job.hosts, min_hosts=job.min_hosts, model=job.model,
            seq=job.seq)
        try:
            self.engine.submit(req)
        except ValueError as e:
            # A counterfactual pool can be too small for a recorded
            # gang — the daemon refuses those at submit; so do we.
            self.refused.append({"job": job.job_id, "tenant": job.tenant,
                                 "hosts": job.hosts, "reason": str(e)})
            return
        if self.recorder:
            self.recorder.submit(ts, job)

    def _finish(self, job_id: str, version: int, ts: int) -> None:
        run = self.runs.get(job_id)
        if run is None or run.done or run.version != version:
            return                     # stale event after a re-rate
        self._consume(run, ts)
        run.done = True
        self.engine.release(job_id)
        self.finished_ms[job_id] = ts
        if self.recorder:
            state = self.jobs[job_id].recorded_state \
                or fjournal.STATE_FINISHED
            self.recorder.state(
                ts, job_id, state,
                exit_code=1 if state == fjournal.STATE_FAILED else 0)

    def _passes(self, ts: int) -> None:
        """Apply scheduling plans until a pass applies nothing — the
        same fixpoint a daemon reaches across consecutive ticks at one
        instant, with holds journaled inline in plan order like
        ``_apply_plan`` does."""
        for _ in range(10_000):
            plan = self.engine.schedule()
            applied = False
            for d in plan:
                if d.action == fpolicy.GRANT:
                    self._grant(d, ts)
                    applied = True
                elif d.action == fpolicy.SHRINK:
                    self._shrink(d, ts)
                    applied = True
                elif d.action == fpolicy.MIGRATE:
                    if self.defrag_on:
                        self._migrate(d, ts)
                        applied = True
                    # defrag off: the move never lands; the demander
                    # keeps its preempt-wait hold until capacity frees.
                elif d.action in fpolicy.HOLD_ACTIONS:
                    self._hold(d, ts)
            if not applied:
                return
        raise RuntimeError("simulation did not reach a scheduling "
                           "fixpoint (policy engine livelock?)")

    def _hold(self, d: fpolicy.Decision, ts: int) -> None:
        if self.fence.get(d.job_id) == d.reason:
            return                     # the daemon's dedup fence
        self.fence[d.job_id] = d.reason
        self.decisions.setdefault(d.job_id, []).append({
            "ts_ms": ts, "action": d.action, "reason": d.reason,
            "blocking": [str(b) for b in d.blocking],
            "free": int(d.free)})
        if self.recorder:
            self.recorder.decision(ts, d)

    def _grant(self, d: fpolicy.Decision, ts: int) -> None:
        self.engine.grant(d.job_id, d.placement)
        self.fence.pop(d.job_id, None)
        run = _Run(remaining_ms=self.jobs[d.job_id].work_chip_ms,
                   hosts=d.hosts, last_ms=ts)
        self.runs[d.job_id] = run
        self.granted_ms[d.job_id] = ts
        self.placements[d.job_id] = dict(d.placement)
        self.host_events[d.job_id] = [(ts, d.hosts)]
        self._push_finish(d.job_id, run, ts)
        if self.recorder:
            self.recorder.grant(ts, d.job_id, d.hosts, d.placement)

    def _shrink(self, d: fpolicy.Decision, ts: int) -> None:
        run = self.runs[d.job_id]
        self._consume(run, ts)
        from_hosts = run.hosts
        placement = self.engine.shrink_applied(d.job_id, d.hosts)
        run.hosts = d.hosts
        run.version += 1
        self._push_finish(d.job_id, run, ts)
        self.preemptions += 1
        self.placements[d.job_id] = placement
        self.host_events[d.job_id].append((ts, d.hosts))
        if self.recorder:
            self.recorder.preempt(ts, d.job_id, from_hosts, d.hosts,
                                  d.for_job, placement)

    def _migrate(self, d: fpolicy.Decision, ts: int) -> None:
        placement = self.engine.migrate_applied(d.job_id, d.placement)
        self.migrations += 1
        self.placements[d.job_id] = placement
        if self.recorder:
            self.recorder.migrate(ts, d.job_id, d.source, d.target,
                                  placement, d.reason)

    def _restores(self, ts: int) -> None:
        """Grow-back like the daemon's ``_restore``: one candidate at a
        time, re-planned after each (a grow changes what still fits)."""
        for _ in range(10_000):
            cands = self.engine.restore_candidates()
            if not cands:
                return
            job_id, new_hosts, delta = cands[0]
            run = self.runs[job_id]
            self._consume(run, ts)
            placement = self.engine.grow_applied(job_id, delta)
            run.hosts = new_hosts
            run.version += 1
            self._push_finish(job_id, run, ts)
            self.restores += 1
            self.placements[job_id] = placement
            self.host_events[job_id].append((ts, new_hosts))
            if self.recorder:
                self.recorder.state(ts, job_id,
                                    fjournal.STATE_RESTORED,
                                    hosts=new_hosts, placement=placement)
        raise RuntimeError("grow-back restores did not converge")

    # -- results ---------------------------------------------------------
    def _folds(self, end_ms: int) -> List[fjournal.JobFold]:
        out: List[fjournal.JobFold] = []
        refused = {r["job"] for r in self.refused}
        for j in sorted(self.jobs.values(), key=lambda j: j.seq):
            if j.job_id in refused:
                continue
            granted = self.granted_ms.get(j.job_id, 0)
            finished = self.finished_ms.get(j.job_id, 0)
            state = (j.recorded_state or fjournal.STATE_FINISHED) \
                if finished else "QUEUED" if not granted else "RUNNING"
            run = self.runs.get(j.job_id)
            out.append(fjournal.JobFold(
                job_id=j.job_id, tenant=j.tenant, priority=j.priority,
                hosts_requested=j.hosts, min_hosts=j.min_hosts,
                model=j.model, seq=j.seq, state=state,
                hosts=run.hosts if run else 0,
                placement=dict(self.placements.get(j.job_id, {})),
                submitted_ms=j.submit_ms, granted_ms=granted,
                finished_ms=finished,
                host_events=list(self.host_events.get(j.job_id, [])),
                decisions=list(self.decisions.get(j.job_id, []))))
        return out

    def _result(self, origin_ms: int, end_ms: int) -> Dict[str, Any]:
        folds = self._folds(end_ms)
        metrics, per_tenant = metrics_from_folds(
            folds, pool_chips=self.slices * self.hps, end_ms=end_ms,
            preemptions=self.preemptions, migrations=self.migrations,
            restores=self.restores, refused=len(self.refused))
        return {
            "config": {"slices": self.slices,
                       "hosts_per_slice": self.hps,
                       "quotas": dict(sorted(self.quotas.items()))},
            "metrics": metrics, "per_tenant": per_tenant,
            "refused": self.refused,
            "ungranted": sorted(f.job_id for f in folds
                                if not f.granted_ms),
        }


def simulate(wl: Workload, overrides: Optional[Overrides] = None,
             recorder: Optional[JournalRecorder] = None
             ) -> Dict[str, Any]:
    """Re-execute the workload through the real policy engine under
    ``overrides``; pure and deterministic (integer sim-time only)."""
    return _Sim(wl, overrides or Overrides(), recorder).run()


# ---------------------------------------------------------------------------
# shared metric fold (recorded journal and simulated run alike)
# ---------------------------------------------------------------------------
def _pct(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return round(sorted_vals[idx], 3)


def metrics_from_folds(folds: List[fjournal.JobFold], *,
                       pool_chips: int, end_ms: int, preemptions: int,
                       migrations: int, restores: int, refused: int = 0
                       ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """One metric/per-tenant rollup over job folds — the SAME code path
    for the recorded journal and every simulated run, so a diff never
    compares two accounting systems. Holds use the timeline module's
    interval algebra; goodput uses the journal-only ledger fold."""
    waits: List[float] = []
    tenant_waits: Dict[str, List[float]] = {}
    hold_s: Dict[str, float] = {k: 0.0 for k in HOLD_METRIC.values()}
    per_tenant: Dict[str, Dict[str, Any]] = {}
    ledgers: List[Dict[str, Any]] = []
    work_chip_ms = 0
    granted = ungranted = 0
    start_ms = min((f.submitted_ms for f in folds if f.submitted_ms),
                   default=0)
    for f in folds:
        bucket = per_tenant.setdefault(f.tenant, {
            "jobs": 0, "granted": 0,
            "holds_s": {}, "blocking": {}})
        bucket["jobs"] += 1
        if f.granted_ms:
            granted += 1
            bucket["granted"] += 1
            wait = max(0.0, (f.granted_ms - f.submitted_ms) / 1000.0)
            waits.append(wait)
            tenant_waits.setdefault(f.tenant, []).append(wait)
        else:
            ungranted += 1
        stop = f.finished_ms or end_ms
        work_chip_ms += _work_chip_ms(f, stop)
        intervals = ftimeline.hold_intervals(
            f.decisions, granted_ms=f.granted_ms,
            finished_ms=f.finished_ms, now_ms=end_ms,
            hosts=f.hosts_requested)
        for kind, summary in ftimeline.holds_summary(intervals).items():
            metric = HOLD_METRIC.get(kind)
            if metric is None:
                continue
            hold_s[metric] = round(hold_s[metric] + summary["seconds"], 3)
            hs = bucket["holds_s"]
            hs[metric] = round(hs.get(metric, 0.0)
                               + summary["seconds"], 3)
            blocking = bucket["blocking"].setdefault(metric, [])
            for b in summary["blocking"]:
                if b not in blocking:
                    blocking.append(b)
        ledgers.append(fledger.compute_job_ledger(f, job_dir=None,
                                                  now_ms=end_ms))
    roll = fledger.rollup(ledgers)
    makespan_s = max(0.0, (end_ms - start_ms) / 1000.0) if folds else 0.0
    util = round(work_chip_ms / 1000.0 / (pool_chips * makespan_s), 4) \
        if pool_chips > 0 and makespan_s > 0 else 0.0
    waits.sort()
    metrics: Dict[str, Any] = {
        "jobs": len(folds) + refused, "granted": granted,
        "ungranted": ungranted, "refused": refused,
        "makespan_s": round(makespan_s, 3),
        "queue_wait_p50_s": _pct(waits, 0.50),
        "queue_wait_p99_s": _pct(waits, 0.99),
        "queue_wait_mean_s": round(sum(waits) / len(waits), 3)
        if waits else 0.0,
        "preemptions": preemptions, "migrations": migrations,
        "restores": restores,
        "preemptions_per_job": round(preemptions / granted, 4)
        if granted else 0.0,
        "goodput_fraction": roll["fleet"]["goodput_fraction"],
        "utilization_fraction": util,
    }
    metrics.update(hold_s)
    for tenant, bucket in per_tenant.items():
        tw = sorted(tenant_waits.get(tenant, []))
        bucket["queue_wait_p50_s"] = _pct(tw, 0.50)
        bucket["queue_wait_p99_s"] = _pct(tw, 0.99)
        tb = roll["tenants"].get(tenant) or {}
        bucket["goodput_fraction"] = tb.get("goodput_fraction")
        bucket["blocking"] = {m: sorted(v)
                              for m, v in bucket["blocking"].items()}
    return metrics, {t: per_tenant[t] for t in sorted(per_tenant)}


def recorded_metrics(tl: ftimeline.FleetTimeline) -> Dict[str, Any]:
    """The journal's OWN metrics through the same fold the simulator
    uses — the 'recorded' column of every whatif report."""
    st = tl.state
    end_ms = max((int(r.get("ts", 0) or 0) for r in tl.records),
                 default=0)
    folds = sorted(st.jobs.values(), key=lambda f: f.seq)
    metrics, per_tenant = metrics_from_folds(
        folds, pool_chips=st.slices * st.hosts_per_slice, end_ms=end_ms,
        preemptions=tl.preemptions_total, migrations=tl.migrations_total,
        restores=tl.restores_total)
    return {"config": {"slices": st.slices,
                       "hosts_per_slice": st.hosts_per_slice,
                       "quotas": dict(sorted(st.quotas.items()))},
            "metrics": metrics, "per_tenant": per_tenant}


# ---------------------------------------------------------------------------
# parity mode: the calibration gate
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Mismatch:
    """One record the replayed policy engine would not have produced."""

    index: int          # record position in the journal
    kind: str           # grant | preempt | migrate | decision | restore
    expected: str
    recorded: str


def _fmt_decision(kind: str, d: fpolicy.Decision) -> str:
    if kind == "grant":
        return f"grant {d.job_id} hosts={d.hosts} placement={d.placement}"
    if kind == "preempt":
        return f"preempt {d.job_id} to={d.hosts} for={d.for_job}"
    if kind == "migrate":
        return (f"migrate {d.job_id} {d.source}->{d.target} "
                f"placement={d.placement}")
    return (f"decision {d.job_id} action={d.action} free={d.free} "
            f"blocking={d.blocking} reason={d.reason!r}")


def _fmt_record(kind: str, rec: Dict[str, Any]) -> str:
    job = rec.get("job", "?")
    if kind == "grant":
        return (f"grant {job} hosts={rec.get('hosts')} "
                f"placement={fjournal._placement(rec)}")
    if kind == "preempt":
        return (f"preempt {job} to={rec.get('to')} "
                f"for={rec.get('for', '')}")
    if kind == "migrate":
        return (f"migrate {job} {rec.get('source')}->{rec.get('target')} "
                f"placement={fjournal._placement(rec)}")
    if kind == "restore":
        return (f"restore {job} hosts={rec.get('hosts')} "
                f"placement={fjournal._placement(rec)}")
    return (f"decision {job} action={rec.get('action')} "
            f"free={rec.get('free')} blocking={rec.get('blocking')} "
            f"reason={str(rec.get('reason', ''))!r}")


class _ParityReplay:
    """Record-driven re-derivation: external records (submits, terminal
    states, generation bumps, health transitions) mutate the engine;
    actionable records (grants, preempts, migrates, decision holds) must
    match the head of the engine's own pending plan emissions. The
    daemon journals an applied plan in plan order within a tick, so the
    pending queue is consumed in order and rebuilt whenever external
    state lands (or, once, on a mismatch — a tick boundary after a
    partially-applied plan looks exactly like staleness)."""

    def __init__(self, tl: ftimeline.FleetTimeline) -> None:
        self.tl = tl
        self.engine: Optional[fpolicy.PolicyEngine] = None
        self.reqs: Dict[str, fpolicy.JobRequest] = {}
        self.job_state: Dict[str, str] = {}
        self.fence: Dict[str, str] = {}
        self.last_decision: Dict[str, str] = {}
        self.pending: List[Tuple[str, fpolicy.Decision]] = []
        self.mismatches: List[Mismatch] = []
        self.counts = {"grant": 0, "preempt": 0, "migrate": 0,
                       "decision": 0, "restore": 0}
        self.mismatch_counts = dict(self.counts)
        self.exogenous_migrations = 0
        self.notes: List[str] = []
        self.pool_sig: Optional[Tuple[int, int]] = None
        self.unsupported = ""

    # -- plan emissions --------------------------------------------------
    def _plan(self) -> List[Tuple[str, fpolicy.Decision]]:
        out: List[Tuple[str, fpolicy.Decision]] = []
        assert self.engine is not None
        for d in self.engine.schedule():
            if d.action == fpolicy.GRANT:
                out.append(("grant", d))
            elif d.action == fpolicy.SHRINK:
                out.append(("preempt", d))
            elif d.action == fpolicy.MIGRATE:
                out.append(("migrate", d))
            elif d.action in fpolicy.HOLD_ACTIONS \
                    and self.fence.get(d.job_id) != d.reason:
                out.append(("decision", d))
        return out

    def _invalidate(self) -> None:
        self.pending = []

    # -- record handlers -------------------------------------------------
    def replay(self) -> Dict[str, Any]:
        if self.tl.torn_tail:
            self.notes.append("torn tail: parity covers the decodable "
                              "prefix only")
        if not self.tl.terminal:
            return self._done(supported=False,
                              reason="journal is not terminal — a live "
                                     "queue's next decisions are not "
                                     "recorded yet")
        for idx, rec in enumerate(self.tl.records):
            t = rec.get("t")
            if t == fjournal.REC_FLEET_GEN:
                self._on_gen(rec)
            elif self.engine is None:
                return self._done(supported=False,
                                  reason="no fgen record before the "
                                         "first scheduler record")
            elif t == fjournal.REC_FLEET_SUBMIT:
                self._on_submit(rec, idx)
            elif t == fjournal.REC_FLEET_GRANT:
                self._match("grant", rec, idx)
            elif t == fjournal.REC_FLEET_PREEMPT:
                self._match("preempt", rec, idx)
            elif t == fjournal.REC_FLEET_DECISION:
                self._match("decision", rec, idx)
            elif t == fjournal.REC_FLEET_MIGRATE:
                self._on_migrate(rec, idx)
            elif t == fjournal.REC_FLEET_STATE:
                self._on_state(rec, idx)
            elif t == fjournal.REC_FLEET_HEALTH:
                self._on_health(rec)
            if self.unsupported:
                return self._done(supported=False,
                                  reason=self.unsupported)
        return self._done(supported=True)

    def _on_gen(self, rec: Dict[str, Any]) -> None:
        slices = int(rec.get("slices", 0) or 0)
        hps = int(rec.get("hosts_per_slice", 0) or 0)
        quotas = {str(t): int(q)
                  for t, q in (rec.get("quotas") or {}).items()}
        if self.engine is None:
            self.engine = fpolicy.PolicyEngine(slices, hps, quotas)
            self.pool_sig = (slices, hps)
            return
        if (slices, hps) != self.pool_sig:
            self.unsupported = ("pool shape changed mid-journal "
                                f"({self.pool_sig} -> {(slices, hps)})")
            return
        self.engine.quotas.clear()
        self.engine.quotas.update(quotas)
        # Recovery semantics (daemon._recover): GRANTED-but-never-
        # SPAWNED jobs are requeued at their original seq; RUNNING jobs
        # stay accounted at their journaled placement (our engine holds
        # them already). The recovered fence re-seeds from the fold.
        for job, state in sorted(self.job_state.items()):
            if state == "GRANTED":
                self.engine.release(job)
                req = self.reqs.get(job)
                if req is not None:
                    self.engine.submit(req)
                self.job_state[job] = "QUEUED"
                if job in self.last_decision:
                    self.fence[job] = self.last_decision[job]
        self._invalidate()

    def _on_submit(self, rec: Dict[str, Any], idx: int) -> None:
        job = str(rec.get("job", "") or "")
        req = fpolicy.JobRequest(
            job, str(rec.get("tenant", "") or ""),
            priority=int(rec.get("priority", 0) or 0),
            hosts=int(rec.get("hosts", 0) or 0),
            min_hosts=int(rec.get("min_hosts", 0) or 0),
            model=str(rec.get("model", "") or ""),
            seq=int(rec.get("seq", 0) or 0))
        self.reqs[job] = req
        assert self.engine is not None
        try:
            self.engine.submit(req)
            self.job_state[job] = "QUEUED"
        except ValueError as e:
            self.notes.append(f"record {idx}: fsubmit {job} not "
                              f"replayable ({e})")
        self._invalidate()

    def _on_state(self, rec: Dict[str, Any], idx: int) -> None:
        job = str(rec.get("job", "") or "")
        state = str(rec.get("state", "") or "")
        assert self.engine is not None
        if state in fjournal.TERMINAL_STATES:
            self.engine.release(job)
            self.job_state.pop(job, None)
            self.fence.pop(job, None)
            self._invalidate()
        elif state == fjournal.STATE_RESTORED:
            self._on_restore(rec, idx)
        elif state in (fjournal.STATE_SPAWNED, fjournal.STATE_RUNNING):
            if job in self.job_state:
                self.job_state[job] = "RUNNING"

    def _on_health(self, rec: Dict[str, Any]) -> None:
        """Best-effort cordon mirror. The journal does not carry the
        free/leased flag the live daemon used, so quarantines cordon a
        free host when one exists and restores uncordon when one is
        cordoned — exact for the common free-host case, approximate
        otherwise (noted; deferred cordon sweeps are invisible to
        parity either way)."""
        assert self.engine is not None
        i = int(rec.get("slice", -1))
        if not 0 <= i < self.engine.pool.slices:
            return
        state = str(rec.get("state", "") or "")
        try:
            if state == "quarantined":
                self.engine.pool.cordon_free(i)
            elif state == "healthy":
                # probation hosts STAY cordoned (canary re-admission);
                # only the healthy transition frees the cordon.
                self.engine.pool.uncordon(i)
            else:
                return
        except ValueError:
            return                    # leased host: the sweep is deferred
        note = "health cordon transitions approximated from fhealth fold"
        if note not in self.notes:
            self.notes.append(note)
        self._invalidate()

    # -- actionable record matching --------------------------------------
    def _compare(self, kind: str, d: fpolicy.Decision,
                 rec: Dict[str, Any]) -> bool:
        job = str(rec.get("job", "") or "")
        if d.job_id != job:
            return False
        if kind == "grant":
            return (int(rec.get("hosts", 0) or 0) == d.hosts
                    and fjournal._placement(rec) == d.placement)
        if kind == "preempt":
            return (int(rec.get("to", -1) or 0) == d.hosts
                    and str(rec.get("for", "") or "") == d.for_job)
        if kind == "migrate":
            return (int(rec.get("source", -2) or 0) == d.source
                    and int(rec.get("target", -2) or 0) == d.target
                    and fjournal._placement(rec) == d.placement)
        return (str(rec.get("action", "") or "") == d.action
                and str(rec.get("reason", "") or "") == d.reason
                and [str(b) for b in (rec.get("blocking") or [])]
                == [str(b) for b in d.blocking]
                and int(rec.get("free", 0) or 0) == d.free)

    def _apply(self, kind: str, d: fpolicy.Decision,
               rec: Dict[str, Any], idx: int) -> None:
        assert self.engine is not None
        job = d.job_id
        if kind == "grant":
            self.engine.grant(job, d.placement)
            self.job_state[job] = "GRANTED"
            self.fence.pop(job, None)
        elif kind == "preempt":
            applied = self.engine.shrink_applied(job, d.hosts)
            recorded = fjournal._placement(rec)
            if applied != recorded:
                # Plan-time and apply-time shrinks free the same slices
                # by contract; a divergence is a real finding.
                self._mismatch(
                    kind, idx,
                    expected=f"post-shrink placement {applied}",
                    recorded=f"post-shrink placement {recorded}")
                self._trust_placement(job, recorded)
        elif kind == "migrate":
            self.engine.migrate_applied(job, d.placement)
        else:
            self.fence[job] = d.reason
            self.last_decision[job] = d.reason

    def _match(self, kind: str, rec: Dict[str, Any], idx: int) -> None:
        self.counts[kind] += 1
        rebuilt = False
        for attempt in (0, 1):
            if not self.pending:
                self.pending = self._plan()
                rebuilt = True
            if self.pending:
                pkind, d = self.pending[0]
                if pkind == kind and self._compare(kind, d, rec):
                    self.pending.pop(0)
                    self._apply(kind, d, rec, idx)
                    return
            if rebuilt:
                break
            # Stale pending (tick boundary after a partial apply, or
            # external state since the plan): rebuild once and retry.
            self._invalidate()
        expected = _fmt_decision(*self.pending[0]) if self.pending \
            else "no planned emission"
        self._mismatch(kind, idx, expected=expected,
                       recorded=_fmt_record(kind, rec))
        self._trust(kind, rec)
        self._invalidate()

    def _on_migrate(self, rec: Dict[str, Any], idx: int) -> None:
        """A planned defrag/evacuation migrate must match like any
        emission; an UNPLANNED one is exogenous (operator `fleet
        migrate`) — applied and noted, never a mismatch."""
        self.counts["migrate"] += 1
        if not self.pending:
            self.pending = self._plan()
        if self.pending:
            pkind, d = self.pending[0]
            if pkind == "migrate" and self._compare("migrate", d, rec):
                self.pending.pop(0)
                self._apply("migrate", d, rec, idx)
                return
        job = str(rec.get("job", "") or "")
        self.exogenous_migrations += 1
        self.counts["migrate"] -= 1
        self.notes.append(
            f"record {idx}: exogenous migrate of {job} "
            f"(slice {rec.get('source')} -> {rec.get('target')}) — "
            f"applied as an operator move")
        self._trust_placement(job, fjournal._placement(rec))
        self._invalidate()

    def _on_restore(self, rec: Dict[str, Any], idx: int) -> None:
        self.counts["restore"] += 1
        assert self.engine is not None
        job = str(rec.get("job", "") or "")
        hosts = int(rec.get("hosts", 0) or 0)
        recorded = fjournal._placement(rec)
        for cand_job, new_hosts, delta in self.engine.restore_candidates():
            if cand_job != job or new_hosts != hosts:
                continue
            applied = self.engine.grow_applied(job, delta)
            if recorded and applied != recorded:
                self._mismatch(
                    "restore", idx,
                    expected=f"restore {job} placement {applied}",
                    recorded=_fmt_record("restore", rec))
                self._trust_placement(job, recorded)
            self._invalidate()
            return
        self._mismatch("restore", idx,
                       expected=f"no grow-back candidate for {job} "
                                f"at {hosts} hosts",
                       recorded=_fmt_record("restore", rec))
        self._trust(
            "restore", rec)
        self._invalidate()

    # -- mismatch bookkeeping & resync -----------------------------------
    def _mismatch(self, kind: str, idx: int, expected: str,
                  recorded: str) -> None:
        self.mismatch_counts[kind] += 1
        if len(self.mismatches) < 32:
            self.mismatches.append(Mismatch(index=idx, kind=kind,
                                            expected=expected,
                                            recorded=recorded))

    def _trust_placement(self, job: str,
                         placement: Dict[int, int]) -> None:
        """Resync the engine to a recorded placement we could not
        derive: re-book the job verbatim so later records still replay
        against a truthful pool."""
        assert self.engine is not None
        if not placement:
            return
        req = self.reqs.get(job) or fpolicy.JobRequest(job, "?")
        self.engine.release(job)
        try:
            self.engine.force_grant(req, sum(placement.values()),
                                    dict(placement))
            self.job_state.setdefault(job, "GRANTED")
        except ValueError as e:
            self.notes.append(f"resync of {job} at {placement} failed "
                              f"({e}) — pool accounting degraded")

    def _trust(self, kind: str, rec: Dict[str, Any]) -> None:
        job = str(rec.get("job", "") or "")
        if kind == "decision":
            reason = str(rec.get("reason", "") or "")
            self.fence[job] = reason
            self.last_decision[job] = reason
            return
        if kind == "preempt":
            self._trust_placement(job, fjournal._placement(rec))
            return
        self._trust_placement(job, fjournal._placement(rec))
        if kind == "grant":
            self.job_state[job] = "GRANTED"
            self.fence.pop(job, None)

    def _done(self, supported: bool, reason: str = "") -> Dict[str, Any]:
        gate = (self.mismatch_counts["grant"]
                + self.mismatch_counts["preempt"]) == 0
        return {
            "supported": supported,
            "reason": reason,
            "ok": supported and not self.mismatches,
            #: the check-rule gate: grant/preempt sequence bit-for-bit
            #: (decision/restore texts can legitimately drift across
            #: daemon versions; placements and victims cannot)
            "gate_ok": supported and gate,
            "records": len(self.tl.records),
            "torn_tail": self.tl.torn_tail,
            "counts": dict(self.counts),
            "mismatch_counts": dict(self.mismatch_counts),
            "mismatches": [dataclasses.asdict(m)
                           for m in self.mismatches],
            "exogenous_migrations": self.exogenous_migrations,
            "notes": list(self.notes),
        }


def parity_replay(tl: ftimeline.FleetTimeline) -> Dict[str, Any]:
    """The calibration gate: re-derive the journal's actionable records
    through the real policy engine and report every divergence."""
    return _ParityReplay(tl).replay()


# ---------------------------------------------------------------------------
# whatif: parity gate + baseline + counterfactual diffs
# ---------------------------------------------------------------------------
def diff_metrics(base: Dict[str, Any],
                 counter: Dict[str, Any]) -> Dict[str, Any]:
    """Per-metric delta with an improves/regresses verdict from the
    metric's direction (same convention profiling/benchdiff.py gates
    on)."""
    out: Dict[str, Any] = {}
    for key in sorted(set(base) | set(counter)):
        b, c = base.get(key), counter.get(key)
        if not isinstance(b, (int, float)) \
                or not isinstance(c, (int, float)) \
                or isinstance(b, bool) or isinstance(c, bool):
            continue
        delta = round(c - b, 4)
        entry: Dict[str, Any] = {"base": b, "counterfactual": c,
                                 "delta": delta}
        if delta and key in LOWER_BETTER:
            entry["improves"] = delta < 0
        elif delta and key in HIGHER_BETTER:
            entry["improves"] = delta > 0
        out[key] = entry
    return out


def _holds_removed(base_pt: Dict[str, Any],
                   cf_pt: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Which holds did the counterfactual remove, per tenant — the
    report's causal citation (blocking jobs come from the BASE run's
    hold summary: they held the capacity the change freed)."""
    out: List[Dict[str, Any]] = []
    for tenant in sorted(base_pt):
        base_holds = base_pt[tenant].get("holds_s") or {}
        cf_holds = (cf_pt.get(tenant) or {}).get("holds_s") or {}
        for metric in sorted(base_holds):
            before = float(base_holds.get(metric, 0.0) or 0.0)
            after = float(cf_holds.get(metric, 0.0) or 0.0)
            if before - after > 0.001:
                out.append({
                    "tenant": tenant, "hold": metric,
                    "before_s": round(before, 3),
                    "after_s": round(after, 3),
                    "removed_s": round(before - after, 3),
                    "was_blocking": (base_pt[tenant].get("blocking")
                                     or {}).get(metric, [])})
    return out


def whatif(tl: ftimeline.FleetTimeline,
           overrides: Optional[Overrides] = None,
           sweeps: Optional[Iterable[str]] = None, *,
           parity: bool = True) -> Dict[str, Any]:
    """The full report: parity gate, recorded metrics, simulated
    baseline (recorded config through the simulator — the honest
    comparison basis for counterfactuals), then one diffed run per
    override set / sweep grid point."""
    wl = fold_workload(tl)
    report: Dict[str, Any] = {
        "journal": tl.path,
        "jobs": len(wl.jobs),
        "records": len(tl.records),
    }
    if parity:
        report["parity"] = parity_replay(tl)
    report["recorded"] = recorded_metrics(tl)
    base = simulate(wl)
    report["base"] = base
    runs: List[Tuple[str, Overrides]] = []
    if overrides is not None and overrides.describe() != "baseline":
        runs.append((overrides.describe(), overrides))
    if sweeps:
        runs.extend(expand_sweeps(overrides or Overrides(), sweeps))
    counterfactuals: List[Dict[str, Any]] = []
    for label, ov in runs:
        cf = simulate(wl, ov)
        counterfactuals.append({
            "label": label,
            "config": cf["config"],
            "metrics": cf["metrics"],
            "per_tenant": cf["per_tenant"],
            "refused": cf["refused"],
            "diff": diff_metrics(base["metrics"], cf["metrics"]),
            "holds_removed": _holds_removed(base["per_tenant"],
                                            cf["per_tenant"]),
        })
    report["counterfactuals"] = counterfactuals
    return report


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------
_TABLE_KEYS = ("goodput_fraction", "utilization_fraction",
               "queue_wait_p50_s", "queue_wait_p99_s", "makespan_s",
               "preemptions", "migrations", "restores", "quota_hold_s",
               "fragmentation_hold_s", "capacity_hold_s",
               "preempt_wait_hold_s", "priority_hold_s", "ungranted",
               "refused")


def _cell(v: Any) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.3f}".rstrip("0").rstrip(".") or "0"
    return str(v)


def render_report(report: Dict[str, Any]) -> str:
    lines: List[str] = [f"fleet whatif — {report.get('journal', '?')} "
                        f"({report.get('jobs', 0)} jobs, "
                        f"{report.get('records', 0)} records)"]
    par = report.get("parity")
    if par is not None:
        if not par.get("supported"):
            lines.append(f"parity: SKIPPED — {par.get('reason', '?')}")
        elif par.get("ok"):
            lines.append("parity: OK — the recorded decision/grant/"
                         "preempt sequence reproduces bit-for-bit")
        else:
            mc = par.get("mismatch_counts") or {}
            summary = ", ".join(f"{k}={v}" for k, v in sorted(mc.items())
                                if v)
            gate = "gate HOLDS (grant/preempt clean)" \
                if par.get("gate_ok") else "gate BROKEN"
            lines.append(f"parity: {summary or 'mismatches'} — {gate}; "
                         f"counterfactuals are NOT trustworthy beyond "
                         f"the gate")
            for m in (par.get("mismatches") or [])[:5]:
                lines.append(f"  record {m['index']} [{m['kind']}]: "
                             f"expected {m['expected']}; recorded "
                             f"{m['recorded']}")
        for note in par.get("notes") or []:
            lines.append(f"  note: {note}")
    rec = (report.get("recorded") or {}).get("metrics") or {}
    base = (report.get("base") or {}).get("metrics") or {}
    lines.append("")
    lines.append(f"{'metric':<24}{'recorded':>12}{'sim-base':>12}")
    for key in _TABLE_KEYS:
        if key in rec or key in base:
            lines.append(f"{key:<24}{_cell(rec.get(key)):>12}"
                         f"{_cell(base.get(key)):>12}")
    for cf in report.get("counterfactuals") or []:
        lines.append("")
        lines.append(f"counterfactual [{cf['label']}]:")
        lines.append(f"  {'metric':<24}{'base':>12}{'whatif':>12}"
                     f"{'delta':>12}")
        diff = cf.get("diff") or {}
        for key in _TABLE_KEYS:
            entry = diff.get(key)
            if not entry or not entry.get("delta"):
                continue
            mark = ""
            if entry.get("improves") is True:
                mark = "  (improves)"
            elif entry.get("improves") is False:
                mark = "  (regresses)"
            lines.append(f"  {key:<24}{_cell(entry['base']):>12}"
                         f"{_cell(entry['counterfactual']):>12}"
                         f"{_cell(entry['delta']):>12}{mark}")
        for h in cf.get("holds_removed") or []:
            blocking = ", ".join(h["was_blocking"]) or "-"
            lines.append(f"  removed {h['removed_s']}s of "
                         f"{h['hold'].replace('_s', '')} for tenant "
                         f"{h['tenant']!r} (was blocking: {blocking})")
        for r in cf.get("refused") or []:
            lines.append(f"  refused {r['job']} ({r['hosts']} hosts): "
                         f"{r['reason']}")
    return "\n".join(lines)


def whatif_from_dir(fleet_dir: Optional[str] = None, *,
                    path: Optional[str] = None,
                    sets: Optional[Iterable[str]] = None,
                    quotas: Optional[Iterable[str]] = None,
                    pool: Optional[str] = None,
                    priorities: Optional[Iterable[str]] = None,
                    sweeps: Optional[Iterable[str]] = None,
                    parity: bool = True) -> Dict[str, Any]:
    """CLI/portal entry: load the journal through the shared timeline
    fold and run the full report."""
    tl = ftimeline.load(fleet_dir, path=path)
    ov = build_overrides(sets=sets, quotas=quotas, pool=pool,
                         priorities=priorities)
    return whatif(tl, ov, sweeps, parity=parity)


# ---------------------------------------------------------------------------
# no-deps CLI smoke (python -m tony_tpu_torch.fleet.simulator)
# ---------------------------------------------------------------------------
def _main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import os

    from tony_tpu_torch import constants

    ap = argparse.ArgumentParser(
        prog="python -m tony_tpu_torch.fleet.simulator",
        description="what-if replay of a recorded fleet journal "
                    "(the no-deps smoke behind tony-tpu fleet whatif)")
    ap.add_argument("target", help="fleet dir or journal file")
    ap.add_argument("--set", action="append", default=[], metavar="K=V")
    ap.add_argument("--quota", action="append", default=[],
                    metavar="TENANT=N")
    ap.add_argument("--pool", default="", metavar="SxH")
    ap.add_argument("--priority", action="append", default=[],
                    metavar="JOB=P")
    ap.add_argument("--sweep", action="append", default=[],
                    metavar="K=a,b,c")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--expect-parity", action="store_true",
                    help="exit 1 unless the parity gate reproduces the "
                         "recorded sequence bit-for-bit")
    ap.add_argument("--expect-improves", default="", metavar="T:METRIC",
                    help="exit 1 unless the first counterfactual "
                         "strictly improves tenant T's METRIC "
                         "(e.g. capped:queue_wait_p99_s)")
    args = ap.parse_args(argv)
    path = args.target
    if os.path.isdir(path):
        path = os.path.join(path, constants.FLEET_JOURNAL_FILE)
    report = whatif_from_dir(
        path=path, sets=args.set, quotas=args.quota,
        pool=args.pool or None, priorities=args.priority,
        sweeps=args.sweep)
    print(json.dumps(report, indent=1, sort_keys=True) if args.json
          else render_report(report))
    rc = 0
    par = report.get("parity") or {}
    if args.expect_parity and not par.get("ok"):
        print(f"PARITY FAILED: {par.get('mismatch_counts')} "
              f"{par.get('reason', '')}".strip())
        rc = 1
    if args.expect_improves:
        tenant, sep, metric = args.expect_improves.partition(":")
        if not sep:
            ap.error("--expect-improves needs TENANT:METRIC")
        cfs = report.get("counterfactuals") or []
        if not cfs:
            print("EXPECT-IMPROVES FAILED: no counterfactual ran")
            rc = 1
        else:
            base_v = ((report["base"]["per_tenant"].get(tenant) or {})
                      .get(metric))
            cf_v = ((cfs[0]["per_tenant"].get(tenant) or {})
                    .get(metric))
            if base_v is None or cf_v is None or not cf_v < base_v:
                print(f"EXPECT-IMPROVES FAILED: {tenant}:{metric} "
                      f"base={base_v} counterfactual={cf_v}")
                rc = 1
            else:
                print(f"improves: {tenant}:{metric} {base_v} -> {cf_v}")
    return rc


if __name__ == "__main__":
    raise SystemExit(_main())
