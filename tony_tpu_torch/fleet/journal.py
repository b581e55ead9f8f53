"""Write-ahead fleet journal: the scheduler's crash-survivable memory.

Same discipline as the per-job session journal (``coordinator/
journal.py`` — whose module docstring is the contract's full statement):
every scheduler state transition — submission, grant, preemption, job
state change, daemon generation bump — is appended as one JSON line and
fsync'd BEFORE the transition is acted on, so a SIGKILLed daemon
restarted with ``tony-tpu fleet start --recover`` replays into the SAME
queue state with zero duplicated or lost grants. Torn/undecodable tails
replay as the prefix (write-ahead means the lost record was never acted
on). Record types are ``REC_FLEET_*`` constants (never string literals)
so the tonylint ``journal-parity`` rule checks both halves — every type
appended somewhere, every type replayed — exactly as it does for the
session journal.

The ``fgen`` record additionally carries the pool shape (slices ×
hosts-per-slice): ``tony-tpu check`` uses it to assert that granted
hosts never exceed the pool at any point in the journal's history
(devtools/invariants.py ``fleet-capacity``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Any, Dict, List, Optional, Tuple

from tony_tpu_torch.utils.durable import AppendLog, DurableWriteError

log = logging.getLogger(__name__)

#: record types (the "t" field) — globally unique against the session
#: journal's REC_* values so the parity rule can match writers by name.
REC_FLEET_GEN = "fgen"          # daemon (re)start: generation + pool shape
REC_FLEET_SUBMIT = "fsubmit"    # a submission entered the queue
REC_FLEET_GRANT = "fgrant"      # capacity granted (write-ahead of spawn)
REC_FLEET_PREEMPT = "fpreempt"  # victim shrunk to reclaim hosts
REC_FLEET_STATE = "fstate"      # job state transition (spawned/running/...)
# Scheduler decision explainer (tony-tpu fleet explain): a queued job's
# not-placed reason TRANSITIONED — quota / capacity / fragmentation /
# priority-held / preempt-wait, with the blocking jobs/tenants named.
# Written per transition (never per tick — the dedup is part of the
# contract, checked by the fleet-decision invariant) so the journal
# holds the job's full causal hold timeline without per-tick bloat.
REC_FLEET_DECISION = "fdecision"
# A running job live-migrated between slices (spot-reclaim survival or
# FRAGMENTATION repacking): write-ahead of the victim coordinator's
# migrate RPC; the post-move placement is journaled so replay
# re-accounts the pool exactly (host COUNT is unchanged — migration
# moves capacity, it never shrinks it).
REC_FLEET_MIGRATE = "fmigrate"
# A host's health state TRANSITIONED (fleet/health.py: healthy /
# suspect / quarantined / probation), write-ahead of the cordon or
# restore taking effect. Each record is self-contained — it carries
# the host's attributed-failure evidence — so `fleet start --recover`
# resumes the identical cordon set (the fold persists across fgen
# records: cordons outlive daemon lives) and `tony-tpu check` audits
# that no quarantine lacks evidence.
REC_FLEET_HEALTH = "fhealth"
# A fleet-scope alert rule TRANSITIONED (tony_tpu_torch/alerts/: pending /
# firing / resolved), write-ahead of the FLEET event and gauge update.
# The fold is last-wins per rule and persists across fgen records —
# like cordons, a firing alert outlives daemon lives until a journaled
# resolve closes it; `fleet start --recover` re-arms the identical
# firing set via AlertEngine.seed().
REC_FLEET_ALERT = "falert"

#: in-fold cap on per-job decision history (the journal keeps all of it
#: on disk; the replayed fold only needs enough to seed the explain
#: ring and the dedup fence).
DECISION_FOLD_CAP = 64

#: job states the fstate record carries (QUEUED/GRANTED are implied by
#: fsubmit/fgrant; these are the post-grant lifecycle).
STATE_SPAWNED = "SPAWNED"       # client subprocess forked (pid recorded)
STATE_RUNNING = "RUNNING"       # app dir discovered (app_id recorded)
STATE_RESTORED = "RESTORED"     # grow-back resize landed (hosts recorded)
STATE_FINISHED = "FINISHED"
STATE_FAILED = "FAILED"
STATE_CANCELLED = "CANCELLED"
TERMINAL_STATES = (STATE_FINISHED, STATE_FAILED, STATE_CANCELLED)


class FleetJournalError(RuntimeError):
    pass


@dataclasses.dataclass
class JobFold:
    """Folded per-job state."""

    job_id: str = ""
    tenant: str = ""
    priority: int = 0
    hosts_requested: int = 0
    min_hosts: int = 0
    model: str = ""
    seq: int = 0
    conf: Dict[str, str] = dataclasses.field(default_factory=dict)
    state: str = "QUEUED"
    hosts: int = 0                 # currently granted
    placement: Dict[int, int] = dataclasses.field(default_factory=dict)
    #: concrete host identities the grant landed on (fleet/health.py
    #: names), when the grant record carried them
    host_ids: List[str] = dataclasses.field(default_factory=list)
    app_id: str = ""
    pid: int = 0
    exit_code: Optional[int] = None
    # --- goodput-ledger anchors (tony_tpu_torch/fleet/ledger.py) -------------
    submitted_ms: int = 0          # fsubmit ts
    granted_ms: int = 0            # latest fgrant ts (re-grants supersede)
    finished_ms: int = 0           # terminal fstate ts
    #: piecewise host count over the granted life: (ts_ms, hosts) at the
    #: grant, each preempt shrink, and each grow-back restore — the
    #: chip-second integrand.
    host_events: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)
    #: replayed decision history (capped at DECISION_FOLD_CAP): dicts of
    #: {ts_ms, action, reason, blocking, free} — seeds the recovered
    #: daemon's explain ring and the offline explain fallback.
    decisions: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)


@dataclasses.dataclass
class FleetReplayState:
    """What a recovering daemon reconstructs from the journal."""

    generation: int = 0
    slices: int = 0
    hosts_per_slice: int = 0
    quotas: Dict[str, int] = dataclasses.field(default_factory=dict)
    seq: int = 0                   # highest submission sequence seen
    jobs: Dict[str, JobFold] = dataclasses.field(default_factory=dict)
    records: int = 0
    torn_tail: bool = False
    #: last-wins per-host health fold (host -> the latest fhealth
    #: record). NOT reset on fgen: a cordon survives daemon restarts
    #: until a journaled transition closes it.
    health: Dict[str, Dict[str, Any]] = dataclasses.field(
        default_factory=dict)
    #: last-wins per-rule alert fold (rule -> latest journaled state:
    #: pending/firing/resolved). NOT reset on fgen, like health.
    alerts: Dict[str, str] = dataclasses.field(default_factory=dict)


class FleetJournal:
    """Append side. Appends are serialized by an I/O lock (the lock
    exists solely to keep the fsync'd record order equal to the decision
    order — submit handlers and the scheduler tick both append)."""

    def __init__(self, path: str, enabled: bool = True) -> None:
        from tony_tpu_torch.devtools.sanitizer import io_lock

        self.path = path
        self.enabled = enabled
        #: first durable-write failure, sticky (ENOSPC/EIO). The first
        #: failing append raises; later appends no-op — the daemon must
        #: STOP scheduling against a journal that can no longer write
        #: ahead (daemon.run checks this), and the committed prefix on
        #: disk stays replayable for `fleet start --recover`.
        self.dead: Optional[DurableWriteError] = None
        self._log: Optional[AppendLog] = AppendLog(path) if enabled else None
        self._lock = io_lock()

    def append(self, record: Dict[str, Any]) -> None:
        if self._log is None:
            return
        if self.dead is not None:
            return
        record.setdefault("ts", int(time.time() * 1000))
        data = (json.dumps(record, sort_keys=True) + "\n").encode("utf-8")
        with self._lock:
            try:
                self._log.append(data)
            except DurableWriteError as e:
                self.dead = e
                log.critical(
                    "fleet journal %s is DEAD (%s): the daemon must stop "
                    "— scheduling decisions it cannot write ahead would "
                    "be lost to recovery; the committed prefix remains "
                    "replayable", self.path, e)
                raise

    # -- typed appenders --------------------------------------------------
    def generation(self, generation: int, slices: int,
                   hosts_per_slice: int,
                   quotas: Optional[Dict[str, int]] = None) -> None:
        self.append({"t": REC_FLEET_GEN, "generation": int(generation),
                     "slices": int(slices),
                     "hosts_per_slice": int(hosts_per_slice),
                     "quotas": {str(t): int(q)
                                for t, q in (quotas or {}).items()}})

    def submit(self, job_id: str, tenant: str, priority: int, hosts: int,
               min_hosts: int, model: str, seq: int,
               conf: Dict[str, str]) -> None:
        self.append({"t": REC_FLEET_SUBMIT, "job": job_id,
                     "tenant": tenant, "priority": int(priority),
                     "hosts": int(hosts), "min_hosts": int(min_hosts),
                     "model": model, "seq": int(seq),
                     "conf": dict(conf)})

    def grant(self, job_id: str, hosts: int, placement: Dict[int, int],
              host_ids: Optional[List[str]] = None) -> None:
        rec: Dict[str, Any] = {
            "t": REC_FLEET_GRANT, "job": job_id, "hosts": int(hosts),
            "placement": {str(i): int(n)
                          for i, n in placement.items()}}
        if host_ids:
            # Concrete host identities (fleet/health.py names) so a
            # recovering daemon re-books the SAME slots — a cordoned
            # host must stay cordoned even while an adopted job runs
            # beside it. Optional: pre-health journals replay fine.
            rec["host_ids"] = [str(h) for h in host_ids]
        self.append(rec)

    def preempt(self, job_id: str, from_hosts: int, to_hosts: int,
                for_job: str, placement: Dict[int, int]) -> None:
        """Write-ahead of the victim's shrink: the post-shrink placement
        is journaled so replay re-accounts the pool exactly."""
        self.append({"t": REC_FLEET_PREEMPT, "job": job_id,
                     "from": int(from_hosts), "to": int(to_hosts),
                     "for": for_job,
                     "placement": {str(i): int(n)
                                   for i, n in placement.items()}})

    def migrate(self, job_id: str, source: int, target: int,
                placement: Dict[int, int], reason: str = "") -> None:
        """Write-ahead of a live migration: the job's gang moves from
        slice ``source`` to slice ``target`` with its host count intact;
        ``placement`` is the post-move slice map."""
        self.append({"t": REC_FLEET_MIGRATE, "job": job_id,
                     "source": int(source), "target": int(target),
                     "placement": {str(i): int(n)
                                   for i, n in placement.items()},
                     "reason": str(reason)})

    def health(self, record: Dict[str, Any]) -> None:
        """One host-health transition (fleet/health.py builds the
        payload: host, slice, state, score, reason, manual, cooldown_s,
        evidence). Write-ahead: appended BEFORE the cordon/restore is
        applied to the pool."""
        rec = {"t": REC_FLEET_HEALTH}
        for k in ("host", "slice", "state", "score", "reason", "manual",
                  "cooldown_s", "evidence"):
            if k in record:
                rec[k] = record[k]
        self.append(rec)

    def alert(self, rule: str, state: str, severity: str,
              value: Optional[float], labels: Dict[str, str],
              summary: str) -> None:
        """One fleet-alert state transition (tony_tpu_torch/alerts/), appended
        BEFORE the event/gauge surfaces it. The engine's dedup fence
        guarantees consecutive records for a rule never repeat a state
        (the alert-journal invariant audits this)."""
        rec: Dict[str, Any] = {"t": REC_FLEET_ALERT, "rule": rule,
                               "state": state, "severity": severity,
                               "summary": summary}
        if value is not None:
            rec["value"] = float(value)
        if labels:
            rec["labels"] = dict(labels)
        self.append(rec)

    def decision(self, job_id: str, action: str, reason: str,
                 blocking: Optional[List[str]] = None,
                 free: int = 0) -> None:
        """One hold-reason transition for a queued job (the explainer's
        write-ahead stream). Callers dedup on reason — two consecutive
        identical records for one job violate the fleet-decision
        invariant."""
        self.append({"t": REC_FLEET_DECISION, "job": job_id,
                     "action": str(action), "reason": str(reason),
                     "blocking": [str(b) for b in (blocking or [])],
                     "free": int(free)})

    def state(self, job_id: str, state: str, app_id: str = "",
              pid: int = 0, exit_code: Optional[int] = None,
              hosts: int = 0,
              placement: Optional[Dict[int, int]] = None) -> None:
        rec: Dict[str, Any] = {"t": REC_FLEET_STATE, "job": job_id,
                               "state": state}
        if app_id:
            rec["app_id"] = app_id
        if pid:
            rec["pid"] = int(pid)
        if exit_code is not None:
            rec["exit"] = int(exit_code)
        if hosts:
            rec["hosts"] = int(hosts)
        if placement is not None:
            rec["placement"] = {str(i): int(n)
                                for i, n in placement.items()}
        self.append(rec)

    def close(self) -> None:
        if self._log is not None:
            self._log.close()
            self._log = None


def _placement(rec: Dict[str, Any]) -> Dict[int, int]:
    out: Dict[int, int] = {}
    for k, v in (rec.get("placement") or {}).items():
        try:
            out[int(k)] = int(v)
        except (TypeError, ValueError):
            continue
    return out


def replay(path: str) -> FleetReplayState:
    """Fold the fleet journal into a FleetReplayState (same torn-tail
    posture as the session journal's replay: decode in order, stop at
    the first bad line, the prefix is the truth)."""
    if not os.path.exists(path):
        raise FleetJournalError(
            f"no fleet journal at {path} — this directory never ran a "
            f"fleet daemon, or the wrong --dir was given")
    from tony_tpu_torch.coordinator.journal import _iter_complete_lines

    state = FleetReplayState()
    lines, torn = _iter_complete_lines(path)
    state.torn_tail = bool(torn)
    for raw in lines:
        raw = raw.strip()
        if not raw:
            continue
        try:
            rec = json.loads(raw.decode("utf-8"))
            if not isinstance(rec, dict):
                raise ValueError("record is not an object")
        except (ValueError, UnicodeDecodeError) as e:
            log.warning("fleet journal %s: undecodable record after %d "
                        "good ones (%s) — replaying the prefix", path,
                        state.records, e)
            state.torn_tail = True
            break
        state.records += 1
        t = rec.get("t")
        ts_ms = int(rec.get("ts", 0) or 0)
        if t == REC_FLEET_GEN:
            state.generation = max(state.generation,
                                   int(rec.get("generation", 0) or 0))
            state.slices = int(rec.get("slices", 0) or 0)
            state.hosts_per_slice = int(
                rec.get("hosts_per_slice", 0) or 0)
            for t, q in (rec.get("quotas") or {}).items():
                try:
                    state.quotas[str(t)] = int(q)
                except (TypeError, ValueError):
                    continue
        elif t == REC_FLEET_SUBMIT:
            job = str(rec.get("job", "") or "")
            seq = int(rec.get("seq", 0) or 0)
            state.seq = max(state.seq, seq)
            state.jobs[job] = JobFold(
                job_id=job, tenant=str(rec.get("tenant", "") or ""),
                priority=int(rec.get("priority", 0) or 0),
                hosts_requested=int(rec.get("hosts", 0) or 0),
                min_hosts=int(rec.get("min_hosts", 0) or 0),
                model=str(rec.get("model", "") or ""), seq=seq,
                conf={str(k): str(v)
                      for k, v in (rec.get("conf") or {}).items()},
                submitted_ms=ts_ms)
        elif t == REC_FLEET_GRANT:
            fold = state.jobs.get(str(rec.get("job", "") or ""))
            if fold is None:
                continue           # unknown job: invariants flag it
            fold.state = "GRANTED"
            fold.hosts = int(rec.get("hosts", 0) or 0)
            fold.placement = _placement(rec)
            fold.host_ids = [str(h) for h in (rec.get("host_ids") or [])]
            fold.granted_ms = ts_ms
            fold.host_events = [(ts_ms, fold.hosts)]
        elif t == REC_FLEET_PREEMPT:
            fold = state.jobs.get(str(rec.get("job", "") or ""))
            if fold is None:
                continue
            fold.hosts = int(rec.get("to", fold.hosts) or 0)
            fold.placement = _placement(rec)
            fold.host_events.append((ts_ms, fold.hosts))
        elif t == REC_FLEET_MIGRATE:
            fold = state.jobs.get(str(rec.get("job", "") or ""))
            if fold is None:
                continue
            # Host count is unchanged by a move — only the slice map.
            fold.placement = _placement(rec)
        elif t == REC_FLEET_HEALTH:
            host = str(rec.get("host", "") or "")
            if host:
                state.health[host] = rec
        elif t == REC_FLEET_ALERT:
            rule = str(rec.get("rule", "") or "")
            if rule:
                state.alerts[rule] = str(rec.get("state", "") or "")
        elif t == REC_FLEET_DECISION:
            fold = state.jobs.get(str(rec.get("job", "") or ""))
            if fold is None:
                continue           # unknown job: invariants flag it
            fold.decisions.append({
                "ts_ms": ts_ms,
                "action": str(rec.get("action", "") or ""),
                "reason": str(rec.get("reason", "") or ""),
                "blocking": [str(b)
                             for b in (rec.get("blocking") or [])],
                "free": int(rec.get("free", 0) or 0)})
            del fold.decisions[:-DECISION_FOLD_CAP]
        elif t == REC_FLEET_STATE:
            fold = state.jobs.get(str(rec.get("job", "") or ""))
            if fold is None:
                continue
            st = str(rec.get("state", "") or "")
            fold.state = st
            if rec.get("app_id"):
                fold.app_id = str(rec["app_id"])
            if rec.get("pid"):
                fold.pid = int(rec["pid"])
            if "exit" in rec:
                fold.exit_code = int(rec["exit"])
            if st in TERMINAL_STATES:
                fold.finished_ms = ts_ms
            if st == STATE_RESTORED:
                fold.hosts = int(rec.get("hosts", fold.hosts) or 0)
                if rec.get("placement") is not None:
                    fold.placement = _placement(rec)
                fold.state = STATE_RUNNING
                fold.host_events.append((ts_ms, fold.hosts))
        else:
            log.warning("fleet journal %s: unknown record type %r "
                        "skipped", path, t)
    return state


def queued_folds(state: FleetReplayState) -> List[JobFold]:
    """Still-queued jobs in original submission order (the queue a
    recovered daemon re-enqueues)."""
    return sorted((f for f in state.jobs.values() if f.state == "QUEUED"),
                  key=lambda f: f.seq)
