"""One shared fold of the fleet journal — the single replay every
offline consumer rides.

Before this module, four call sites parsed the fleet journal
independently: ``fleet explain``'s offline fallback
(diagnose.offline_explain), ``fleet diagnose --from-dir``
(diagnose.bundle_from_dir), the goodput ledger re-fold
(ledger.fold_fleet_dir) and the what-if simulator
(fleet/simulator.py). Each re-derived the same things — the
FleetReplayState job fold, the raw record prefix, preemption counts,
grant waits, the last-wins alert fold — with four chances to drift.
``load()`` folds once and hands every consumer the same
:class:`FleetTimeline`.

The module also owns the hold-interval algebra (``hold_intervals`` /
``holds_summary``): a REC_FLEET_DECISION record opens a hold that
closes at the next reason transition, the grant, or the terminal
anchor. ``fleet explain`` surfaces the summary (which jobs were
blocking, for how long, with how many free hosts) and the what-if
differ uses the same math to attribute quota-hold and
fragmentation-hold seconds per tenant — one algebra, two consumers,
no skew between what the explainer says and what the simulator
accounts.

Stdlib-only, like everything else in tony_tpu_torch/fleet/.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Tuple

from tony_tpu_torch import constants
from tony_tpu_torch.fleet import journal as fjournal


def journal_path(fleet_dir: str) -> str:
    return os.path.join(fleet_dir, constants.FLEET_JOURNAL_FILE)


@dataclasses.dataclass
class FleetTimeline:
    """The shared offline fold: the replayed state plus the raw record
    prefix and the derived counters every consumer used to re-compute."""

    path: str
    #: the canonical per-job fold (journal.replay) — states, anchors,
    #: host events, decision history, quotas, pool shape
    state: fjournal.FleetReplayState
    #: the decodable record prefix, in journal order (torn tail cut)
    records: List[Dict[str, Any]]
    torn_tail: bool
    # -- derived (previously re-computed per consumer) -------------------
    grants_total: int
    preemptions_total: int
    migrations_total: int
    restores_total: int
    preempts_per_job: Dict[str, int]
    #: grant waits in seconds for every granted job, sorted ascending
    grant_waits: List[float]
    #: rule -> last raw REC_FLEET_ALERT record (severity/value/summary)
    alert_last: Dict[str, Dict[str, Any]]

    @property
    def terminal(self) -> bool:
        """True when every journaled job reached a terminal state — the
        precondition for a trustworthy parity replay (a live queue's
        next decision is not in the journal yet)."""
        return all(f.state in fjournal.TERMINAL_STATES
                   for f in self.state.jobs.values())


def load(fleet_dir: Optional[str] = None, *,
         path: Optional[str] = None) -> FleetTimeline:
    """Fold a fleet journal once. Raises
    :class:`journal.FleetJournalError` like ``journal.replay`` when the
    file is absent/unreadable."""
    if path is None:
        if fleet_dir is None:
            raise ValueError("load() needs fleet_dir or path")
        path = journal_path(fleet_dir)
    state = fjournal.replay(path)
    records, torn = _raw_records(path)
    grants = preempts = migrates = restores = 0
    preempts_per_job: Dict[str, int] = {}
    alert_last: Dict[str, Dict[str, Any]] = {}
    for rec in records:
        t = rec.get("t")
        if t == fjournal.REC_FLEET_GRANT:
            grants += 1
        elif t == fjournal.REC_FLEET_PREEMPT:
            job = str(rec.get("job", "") or "")
            preempts += 1
            preempts_per_job[job] = preempts_per_job.get(job, 0) + 1
        elif t == fjournal.REC_FLEET_MIGRATE:
            migrates += 1
        elif t == fjournal.REC_FLEET_STATE \
                and rec.get("state") == fjournal.STATE_RESTORED:
            restores += 1
        elif t == fjournal.REC_FLEET_ALERT:
            alert_last[str(rec.get("rule", "") or "")] = rec
    waits = sorted(
        max(0.0, (f.granted_ms - f.submitted_ms) / 1000.0)
        for f in state.jobs.values() if f.granted_ms)
    return FleetTimeline(
        path=path, state=state, records=records, torn_tail=torn,
        grants_total=grants, preemptions_total=preempts,
        migrations_total=migrates, restores_total=restores,
        preempts_per_job=preempts_per_job, grant_waits=waits,
        alert_last=alert_last)


def _raw_records(path: str) -> Tuple[List[Dict[str, Any]], bool]:
    from tony_tpu_torch.devtools.invariants import _iter_journal_records

    recs, torn = _iter_journal_records(path)
    return [r for _, r in recs], torn


# ---------------------------------------------------------------------------
# hold algebra: decision records -> attributed hold intervals
# ---------------------------------------------------------------------------
#: a capacity hold whose free count covers the request is a
#: fragmentation hold — the hosts EXIST but do not pack (the same
#: free >= hosts test fleet-diagnose's FRAGMENTATION rule keys off)
FRAGMENTATION = "fragmentation"


def classify_hold(action: str, free: int, hosts: int) -> str:
    """Hold attribution bucket for one decision: quota / capacity /
    fragmentation / held / preempt-wait."""
    from tony_tpu_torch.fleet import policy as fpolicy

    if action == fpolicy.CAPACITY_DENIED and hosts and free >= hosts:
        return FRAGMENTATION
    return action


def hold_intervals(decisions: List[Dict[str, Any]], *,
                   granted_ms: int = 0, finished_ms: int = 0,
                   now_ms: int = 0,
                   hosts: int = 0) -> List[Dict[str, Any]]:
    """Each hold-reason transition opens an interval that closes at the
    NEXT transition, the grant, the terminal state, or ``now_ms`` (for
    a still-queued job). Entries whose action is not a hold (the live
    ring's closing ``granted`` entry) close the previous interval and
    open nothing."""
    from tony_tpu_torch.fleet import policy as fpolicy

    end_anchor = granted_ms or finished_ms or now_ms
    out: List[Dict[str, Any]] = []
    for i, d in enumerate(decisions):
        action = str(d.get("action", "") or "")
        if action not in fpolicy.HOLD_ACTIONS:
            continue
        start = int(d.get("ts_ms", 0) or 0)
        if i + 1 < len(decisions):
            end = int(decisions[i + 1].get("ts_ms", 0) or 0)
        else:
            end = end_anchor
        end = max(end, start)
        out.append({
            "action": action,
            "kind": classify_hold(action, int(d.get("free", 0) or 0),
                                  hosts),
            "reason": str(d.get("reason", "") or ""),
            "blocking": [str(b) for b in (d.get("blocking") or [])],
            "free": int(d.get("free", 0) or 0),
            "start_ms": start, "end_ms": end,
            "seconds": round((end - start) / 1000.0, 3)})
    return out


def holds_summary(intervals: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-kind rollup of hold intervals: total seconds, the union of
    blocking jobs/tenants, and the last observed free count — the
    `fleet explain --json` "holds" section and the differ's
    which-hold-did-the-counterfactual-remove citation."""
    out: Dict[str, Any] = {}
    for iv in intervals:
        bucket = out.setdefault(iv["kind"], {
            "seconds": 0.0, "episodes": 0, "blocking": [], "free": 0})
        bucket["seconds"] = round(bucket["seconds"] + iv["seconds"], 3)
        bucket["episodes"] += 1
        for b in iv["blocking"]:
            if b not in bucket["blocking"]:
                bucket["blocking"].append(b)
        bucket["free"] = iv["free"]
    for bucket in out.values():
        bucket["blocking"] = sorted(bucket["blocking"])
    return out
