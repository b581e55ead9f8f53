"""Cross-artifact trace invariant checker: the runtime half of tonycheck.

tonylint's protocol rules (devtools/protocol.py) prove the CODE keeps
both halves of each control-plane contract; this module proves a
finished RUN did. It reads a job dir's artifacts — the write-ahead
journal, the span log, perf.json, metrics.prom — and asserts the
invariants the protocol promises at runtime:

=======================  ==================================================
journal-gen-monotonic    coordinator generations strictly increase
journal-mgen-monotonic   membership generations never step backwards
journal-resize-dangling  every REC_RESIZE ``start`` is closed by an
                         ``applied`` (same-or-newer mgen), a superseding
                         ``start``, or an epoch reset — never left open
journal-migrate-dangling every REC_MIGRATE ``start`` is closed by an
                         ``applied`` (same-or-newer mgen), a
                         ``superseded`` record (host loss folded the op
                         into the elastic ladder), or an epoch reset —
                         a SUCCEEDED job never ends mid-migration
journal-migrate-mgen-monotonic
                         migration records respect the shared
                         membership-generation fence — no stale-slice
                         migration frame lands after a newer mgen
journal-stale-epoch      no sessioned record lands after a newer epoch
                         fence (a stale frame was accepted post-fence)
journal-terminal         no REC_TASK transition out of SUCCEEDED/FAILED/
                         KILLED and no REC_REGISTER for a terminal task
                         within an epoch (applied resizes reset their
                         job's fold — the journaled absorb path)
trace-unclosed           every opened span is closed (single-generation
                         runs; pre-recovery lives may leave unclosed
                         spans and are reported as a note instead)
trace-orphan-close       no span close without a matching open
trace-parent             every span's parent resolves inside the log
phase-sum                perf.json per-phase seconds sum to the
                         attributed wall within tolerance
metrics-unregistered     every ``tony_*`` family in metrics.prom is in
                         ``tony_tpu_torch.metrics.SERIES``
fleet-gen-monotonic      fleet daemon generations strictly increase
fleet-unknown-job        no grant/preempt/migrate/state record for a
                         job the journal never saw submitted
fleet-double-grant       no second grant for a job without an
                         intervening terminal state or daemon
                         generation bump (a recovered daemon may
                         re-carry a grant out; a live one must not)
fleet-terminal           no job state transition out of FINISHED/
                         FAILED/CANCELLED
fleet-capacity           granted hosts never exceed the journaled pool
                         (slices × hosts-per-slice) at any point
fleet-decision           every REC_FLEET_DECISION names a journaled
                         submission, never lands after the job's
                         terminal state, and reason transitions are
                         deduplicated (no two consecutive identical
                         holds for one job within a daemon life —
                         the bounded-journal contract)
fleet-ledger             the goodput ledger re-folded offline books
                         non-negative phases that sum to each
                         terminal job's wall within 1% (the job's
                         sum-to-wall discipline at the fleet layer;
                         migration wall books under its own phase and
                         participates in the same sum)
fleet-sim-parity         the journaled grant/preempt sequence re-derives
                         bit-for-bit through the real policy engine
                         (fleet/simulator.py parity replay) — placements
                         and shrink victims the engine would not have
                         planned mean daemon/policy drift, the condition
                         under which `fleet whatif` counterfactuals stop
                         being trustworthy (hold-reason wording and
                         operator migrations are notes, not violations;
                         non-terminal journals are skipped)
fleet-trace-stitch       every granted job's span tree carries the
                         fleet's trace id (the grant's injected
                         tony.internal.fleet-trace-id reached the
                         client) so one --fleet export stitches
health-quarantine-evidence
                         every non-manual REC_FLEET_HEALTH quarantine
                         carries attributed-failure evidence (the
                         score/probe/slice trail that justified the
                         cordon) — a quarantine the journal cannot
                         explain is an unauditable cordon
health-dangling-cordon   every manual (operator) cordon is closed by
                         an uncordon before the journal ends — manual
                         cordons never auto-expire, so a dangling one
                         is capacity silently lost
alert-journal            REC_ALERT / REC_FLEET_ALERT transitions carry
                         valid states and are dedup-fenced per (rule,
                         state) — never re-journaled per tick — and a
                         SUCCEEDED job's journal never ends with a
                         rule still firing (the teardown resolve);
                         failure paths keep the firing record as
                         diagnosis evidence (note, not violation)
=======================  ==================================================

Surfaces: ``python -m tony_tpu_torch.cli check <app|job_dir>`` (and the
no-deps module CLI ``python -m tony_tpu_torch.devtools.invariants
<job_dir>``); every ``tests/test_torch_e2e*`` drill runs ``check_tree``
over its own tree, fleet dirs included.

Stdlib only (the journal/tracing readers it leans on are stdlib too), so
CI runs it without installing anything. Torn tails are tolerated exactly
as the readers tolerate them (write-ahead discipline makes the prefix
the truth) and reported as notes, never violations.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from tony_tpu_torch import constants
from tony_tpu_torch.coordinator import journal as journal_mod

_TERMINAL = ("SUCCEEDED", "FAILED", "KILLED")

#: perf.json sum-to-wall tolerance: the writer rounds each phase to 4
#: decimals, so allow 1% relative plus a rounding epsilon.
PHASE_SUM_REL_TOL = 0.01
PHASE_SUM_ABS_TOL = 0.05


@dataclasses.dataclass(frozen=True)
class Violation:
    """One invariant breach, in the diagnosis evidence style: what broke,
    where (artifact + record/line number), and the record that proves
    it."""

    rule: str
    artifact: str
    record: int          # 1-based record/line index; 0 = file-level
    message: str
    evidence: str = ""

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        s = f"{self.artifact}:{self.record}: [{self.rule}] {self.message}"
        if self.evidence:
            s += f"\n    evidence: {self.evidence}"
        return s


@dataclasses.dataclass
class Report:
    job_dir: str
    violations: List[Violation] = dataclasses.field(default_factory=list)
    notes: List[str] = dataclasses.field(default_factory=list)
    checked: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_dict(self) -> Dict[str, object]:
        return {
            "job_dir": self.job_dir,
            "ok": self.ok,
            "violations": [v.to_dict() for v in self.violations],
            "notes": list(self.notes),
            "checked": dict(self.checked),
        }


def _iter_journal_records(
        path: str) -> Tuple[List[Tuple[int, Dict[str, Any]]], bool]:
    """(index, record) for every decodable complete record; mirrors
    replay()'s torn-tail posture. Returns (records, torn)."""
    lines, torn = journal_mod._iter_complete_lines(path)
    out: List[Tuple[int, Dict[str, Any]]] = []
    for i, raw in enumerate(lines, start=1):
        raw = raw.strip()
        if not raw:
            continue
        try:
            rec = json.loads(raw.decode("utf-8"))
            if not isinstance(rec, dict):
                raise ValueError("not an object")
        except (ValueError, UnicodeDecodeError):
            torn = True
            break
        out.append((i, rec))
    return out, torn


# ---------------------------------------------------------------------------
# journal invariants
# ---------------------------------------------------------------------------
def _check_journal(path: str, rel: str, rep: Report,
                   strict: bool) -> Tuple[int, bool]:
    """All journal invariants in one ordered fold. Returns
    ``(generations, clean)`` — the recovery count and whether the run
    was disturbance-free (one epoch, no failed/killed task): the facts
    the span-tree check needs to know how much stitching to demand.
    ``strict`` = the job finished SUCCEEDED: end-state invariants (no
    dangling resize) are hard; on failure paths they degrade to notes."""
    records, torn = _iter_journal_records(path)
    rep.checked[rel] = len(records)
    clean = True
    if torn:
        rep.notes.append(
            f"{rel}: torn/undecodable tail after {len(records)} good "
            f"record(s) — the crash window; prefix checked")
    last_gen: Optional[int] = None
    n_gens = 0
    max_mgen: Optional[int] = None
    session: Optional[int] = None
    # job → (record_idx, mgen) of the open resize start
    open_start: Dict[str, Tuple[int, int]] = {}
    # job → (record_idx, mgen, target) of the open migration start
    open_migrate: Dict[str, Tuple[int, int, str]] = {}
    # task → folded status for the current epoch
    tasks: Dict[str, str] = {}
    # alert rule → (record_idx, last journaled state). Deliberately NOT
    # cleared on REC_EPOCH: alerts watch the job across retry epochs
    # (mirror replay()).
    alert_state: Dict[str, Tuple[int, str]] = {}
    for idx, rec in records:
        t = rec.get("t")
        ev = json.dumps(rec, sort_keys=True)
        if t == journal_mod.REC_GENERATION:
            n_gens += 1
            gen = int(rec.get("generation", 0) or 0)
            if last_gen is not None and gen <= last_gen:
                rep.violations.append(Violation(
                    "journal-gen-monotonic", rel, idx,
                    f"coordinator generation {gen} does not supersede "
                    f"{last_gen} — generations must strictly increase "
                    f"(the split-brain fence)", ev))
            last_gen = max(gen, last_gen or 0)
        elif t == journal_mod.REC_EPOCH:
            new_session = int(rec.get("session", 0) or 0)
            if session is not None and new_session < session:
                rep.violations.append(Violation(
                    "journal-stale-epoch", rel, idx,
                    f"epoch record steps back from session {session} to "
                    f"{new_session}", ev))
            if new_session > 0:
                clean = False      # a retry epoch happened
            session = new_session
            tasks.clear()
            open_start.clear()     # an epoch reset abandons the resize
            open_migrate.clear()   # ... and the in-flight migration
        elif t == journal_mod.REC_RESIZE:
            if _stale_session(rec, session):
                rep.violations.append(_stale_violation(rel, idx, rec,
                                                       session, ev))
                continue
            job = str(rec.get("job", "") or "")
            mgen = int(rec.get("mgen", 0) or 0)
            if max_mgen is not None and mgen < max_mgen:
                rep.violations.append(Violation(
                    "journal-mgen-monotonic", rel, idx,
                    f"membership generation {mgen} steps back from "
                    f"{max_mgen} — a stale-topology record landed after "
                    f"the fence", ev))
            max_mgen = max(mgen, max_mgen if max_mgen is not None else 0)
            if rec.get("phase") == "applied":
                start = open_start.pop(job, None)
                if start is not None and mgen < start[1]:
                    rep.violations.append(Violation(
                        "journal-resize-dangling", rel, idx,
                        f"resize applied at mgen {mgen} but the open "
                        f"start is newer (mgen {start[1]}) — the applied "
                        f"topology is stale", ev))
                # The applied topology supersedes the member tasks' fold:
                # replaced indices relaunch fresh (the journaled absorb
                # path) — mirror replay() and reset the job's fold.
                for tid in [tid for tid in tasks
                            if tid.partition(":")[0] == job]:
                    del tasks[tid]
            else:
                open_start[job] = (idx, mgen)
        elif t == journal_mod.REC_MIGRATE:
            if _stale_session(rec, session):
                rep.violations.append(_stale_violation(rel, idx, rec,
                                                       session, ev))
                continue
            job = str(rec.get("job", "") or "")
            mgen = int(rec.get("mgen", 0) or 0)
            target = str(rec.get("target", "") or "")
            if max_mgen is not None and mgen < max_mgen:
                rep.violations.append(Violation(
                    "journal-migrate-mgen-monotonic", rel, idx,
                    f"migration record at mgen {mgen} steps back from "
                    f"{max_mgen} — a stale-slice migration frame landed "
                    f"after the membership fence", ev))
            max_mgen = max(mgen, max_mgen if max_mgen is not None else 0)
            phase = rec.get("phase")
            if phase == "applied":
                start = open_migrate.pop(job, None)
                if start is not None and mgen < start[1]:
                    rep.violations.append(Violation(
                        "journal-migrate-dangling", rel, idx,
                        f"migration applied at mgen {mgen} but the open "
                        f"start is newer (mgen {start[1]}) — the "
                        f"applied move is stale", ev))
                # Every member relaunched on the target slice: the
                # source gang's fold is superseded exactly like an
                # applied resize (mirror replay()). The killed source
                # executors also strand their spans — this run no
                # longer owes a fully stitched tree.
                for tid in [tid for tid in tasks
                            if tid.partition(":")[0] == job]:
                    del tasks[tid]
                clean = False
            elif phase == "superseded":
                # A host loss mid-migration folded the op into the
                # ordinary elastic ladder: the start is closed, the
                # REC_RESIZE that follows carries the story on.
                open_migrate.pop(job, None)
            else:
                open_migrate[job] = (idx, mgen, target)
        elif t == journal_mod.REC_ALERT:
            rule = str(rec.get("rule", "") or "")
            state = str(rec.get("state", "") or "")
            if state not in ("pending", "firing", "resolved"):
                rep.violations.append(Violation(
                    "alert-journal", rel, idx,
                    f"alert record for rule {rule!r} carries unknown "
                    f"state {state!r} — only pending/firing/resolved "
                    f"are journaled transitions", ev))
            elif alert_state.get(rule, (0, ""))[1] == state:
                rep.violations.append(Violation(
                    "alert-journal", rel, idx,
                    f"consecutive identical alert state {state!r} for "
                    f"rule {rule!r} — transitions must be dedup-fenced "
                    f"per (rule, state), never re-journaled per tick "
                    f"(the bounded-journal contract)", ev))
            alert_state[rule] = (idx, state)
        elif t in (journal_mod.REC_REGISTER, journal_mod.REC_TASK,
                   journal_mod.REC_PROGRESS, journal_mod.REC_VERDICT,
                   journal_mod.REC_JOB_SCHEDULED,
                   journal_mod.REC_JOB_COMPLETED):
            if _stale_session(rec, session):
                rep.violations.append(_stale_violation(rel, idx, rec,
                                                       session, ev))
                continue
            tid = str(rec.get("task", "") or "")
            if t == journal_mod.REC_TASK and tid:
                status = str(rec.get("status", "") or "")
                if status in ("FAILED", "KILLED"):
                    clean = False  # a task died along the way
                prev = tasks.get(tid)
                if prev in _TERMINAL and status != prev:
                    rep.violations.append(Violation(
                        "journal-terminal", rel, idx,
                        f"task {tid} transitions {prev} → {status} after "
                        f"a terminal state — a closed task identity was "
                        f"resurrected outside the journaled epoch-reset/"
                        f"absorb paths", ev))
                tasks[tid] = status
            elif t == journal_mod.REC_REGISTER and tid:
                if tasks.get(tid) in _TERMINAL:
                    rep.violations.append(Violation(
                        "journal-terminal", rel, idx,
                        f"register record for task {tid} in terminal "
                        f"state {tasks[tid]} — a registration frame was "
                        f"accepted after the task finished", ev))
    for job, (idx, mgen) in sorted(open_start.items()):
        msg = (f"resize start for job {job!r} (mgen {mgen}) is never "
               f"applied, superseded, or reset — the journal ends with "
               f"the resize in flight (a --recover would re-enter the "
               f"drain; a SUCCEEDED job must not end here)")
        if strict:
            rep.violations.append(Violation(
                "journal-resize-dangling", rel, idx, msg))
        else:
            # A job that died/was killed mid-resize legitimately leaves
            # the start open — that IS the recover re-entry record.
            rep.notes.append(f"{rel}:{idx}: {msg}")
    for job, (idx, mgen, target) in sorted(open_migrate.items()):
        msg = (f"migration start for job {job!r} (mgen {mgen}, target "
               f"{target!r}) is never applied, superseded, or reset — "
               f"the journal ends mid-migration (a --recover re-enters "
               f"the op; a SUCCEEDED job must not end here)")
        if strict:
            rep.violations.append(Violation(
                "journal-migrate-dangling", rel, idx, msg))
        else:
            # A coordinator killed mid-migration legitimately leaves
            # the start open — that IS the recover re-entry record.
            rep.notes.append(f"{rel}:{idx}: {msg}")
    for rule, (idx, state) in sorted(alert_state.items()):
        if state != "firing":
            continue
        msg = (f"alert rule {rule!r} is still firing when the journal "
               f"ends — a SUCCEEDED teardown resolves every alert "
               f"(resolve_all); on a failure path the firing record is "
               f"the diagnosis evidence")
        if strict:
            rep.violations.append(Violation(
                "alert-journal", rel, idx, msg))
        else:
            rep.notes.append(f"{rel}:{idx}: {msg}")
    return n_gens, clean and n_gens <= 1


def _stale_session(rec: Dict[str, Any], session: Optional[int]) -> bool:
    if session is None or "session" not in rec:
        return False
    try:
        return int(rec.get("session", 0) or 0) != session
    except (TypeError, ValueError):
        return True


def _stale_violation(rel: str, idx: int, rec: Dict[str, Any],
                     session: Optional[int], ev: str) -> Violation:
    return Violation(
        "journal-stale-epoch", rel, idx,
        f"record for session {rec.get('session')} appended while the "
        f"epoch fence is at session {session} — a stale-epoch frame was "
        f"accepted after the fence", ev)


# ---------------------------------------------------------------------------
# span-log invariants
# ---------------------------------------------------------------------------
def _check_spans(path: str, rel: str, rep: Report,
                 strict: bool) -> None:
    """``strict`` = SUCCEEDED + single generation + no task deaths/retry
    epochs: the only shape that owes a fully closed, fully stitched
    span tree (buffered tracers ship spans complete-only, so any kill
    along the way legitimately drops parents)."""
    from tony_tpu_torch import tracing

    records = tracing.load_records(path)
    rep.checked[rel] = len(records)
    opens: Dict[str, Tuple[int, str]] = {}     # span id → (line, name)
    known: Set[str] = set()
    parents: List[Tuple[int, str, str]] = []   # (line, span name, parent)
    for i, recd in enumerate(records, start=1):
        ev = recd.get("ev")
        span = str(recd.get("span", "") or "")
        name = str(recd.get("name", "") or "")
        if ev == "B":
            opens[span] = (i, name)
            known.add(span)
        elif ev == "E":
            if opens.pop(span, None) is None:
                rep.violations.append(Violation(
                    "trace-orphan-close", rel, i,
                    f"span close for {span!r} has no matching open — "
                    f"the span tree is inconsistent",
                    json.dumps(recd, sort_keys=True)))
        elif ev in ("X", "I"):
            known.add(span)
        if ev in ("B", "X", "I"):
            parent = str(recd.get("parent", "") or "")
            if parent:
                parents.append((i, name, parent))
    if opens:
        names = ", ".join(
            f"{name} (line {line})"
            for line, name in sorted(opens.values())[:5])
        if strict:
            line = min(l for l, _ in opens.values())
            rep.violations.append(Violation(
                "trace-unclosed", rel, line,
                f"{len(opens)} span(s) opened but never closed on a "
                f"clean SUCCEEDED run: {names}"))
        else:
            # A SIGKILLed coordinator life (pre-recovery, or a crash
            # drill that never recovered) leaves its open spans
            # unclosed by design — evidence of what was in flight, not
            # a protocol breach.
            rep.notes.append(
                f"{rel}: {len(opens)} unclosed span(s) from a killed/"
                f"pre-recovery coordinator life: {names}")
    unresolved = [(i, name, p) for i, name, p in parents if p not in known]
    if not strict and unresolved:
        # Executor/client spans ship over best-effort trace.push, and a
        # buffered tracer only ships CLOSED spans: any task or
        # coordinator killed mid-life strands its children's parent
        # links. Only a clean single-epoch SUCCEEDED run owes a fully
        # stitched tree.
        rep.notes.append(
            f"{rel}: {len(unresolved)} unresolved parent link(s) on a "
            f"disturbed run (best-effort span push)")
        return
    for i, name, p in unresolved[:5]:
        rep.violations.append(Violation(
            "trace-parent", rel, i,
            f"span {name!r} has parent {p!r} which resolves to no span "
            f"in the log — the trace tree is broken at this edge"))
    if len(unresolved) > 5:
        rep.notes.append(f"{rel}: {len(unresolved) - 5} further "
                         f"unresolved parent link(s) suppressed")


# ---------------------------------------------------------------------------
# fleet-journal invariants (tony_tpu_torch/fleet/journal.py)
# ---------------------------------------------------------------------------
def _check_fleet_journal(path: str, rel: str, rep: Report) -> None:
    """The fleet scheduler's write-ahead journal holds the multi-job
    half of the protocol: monotonic daemon generations, every grant for
    a known submission, at most one live grant per job per daemon life,
    terminal job states that stay terminal, and host accounting that
    never exceeds the journaled pool."""
    from tony_tpu_torch.fleet import journal as fj

    records, torn = _iter_journal_records(path)
    rep.checked[rel] = len(records)
    if torn:
        rep.notes.append(
            f"{rel}: torn/undecodable tail after {len(records)} good "
            f"record(s) — the crash window; prefix checked")
    last_gen: Optional[int] = None
    capacity = 0
    submitted: Set[str] = set()
    # job → current state fold ("QUEUED"/"GRANTED"/lifecycle states)
    states: Dict[str, str] = {}
    hosts: Dict[str, int] = {}        # granted hosts per live job
    # job → (action, reason) of its last decision record this life —
    # the fleet-decision dedup fence (reset at fgen: a recovered daemon
    # legitimately re-records the holds it re-derives).
    last_decision: Dict[str, Tuple[str, str]] = {}
    # host → record index of a still-open manual cordon (fhealth
    # records replay across daemon lives — last-wins per host — so the
    # fold deliberately survives fgen bumps).
    open_manual: Dict[str, int] = {}
    # alert rule → last journaled state. Survives fgen bumps like the
    # health fold (a recovered daemon seeds its engine from the replay,
    # so the dedup fence carries across lives); a fleet journal MAY end
    # firing — the daemon is long-lived, there is no SUCCEEDED teardown.
    falert_state: Dict[str, str] = {}
    for idx, rec in records:
        t = rec.get("t")
        ev = json.dumps(rec, sort_keys=True)
        job = str(rec.get("job", "") or "")
        if t == fj.REC_FLEET_ALERT:
            rule = str(rec.get("rule", "") or "")
            state = str(rec.get("state", "") or "")
            if state not in ("pending", "firing", "resolved"):
                rep.violations.append(Violation(
                    "alert-journal", rel, idx,
                    f"fleet alert record for rule {rule!r} carries "
                    f"unknown state {state!r} — only pending/firing/"
                    f"resolved are journaled transitions", ev))
            elif falert_state.get(rule) == state:
                rep.violations.append(Violation(
                    "alert-journal", rel, idx,
                    f"consecutive identical alert state {state!r} for "
                    f"fleet rule {rule!r} — transitions must be "
                    f"dedup-fenced per (rule, state), never "
                    f"re-journaled per tick", ev))
            falert_state[rule] = state
            continue
        if t == fj.REC_FLEET_HEALTH:
            host = str(rec.get("host", "") or "")
            state = str(rec.get("state", "") or "")
            if state == "quarantined":
                if rec.get("manual"):
                    open_manual[host] = idx
                else:
                    open_manual.pop(host, None)
                    if not rec.get("evidence"):
                        rep.violations.append(Violation(
                            "health-quarantine-evidence", rel, idx,
                            f"quarantine of host {host} carries no "
                            f"attributed-failure evidence — the cordon "
                            f"cannot be audited", ev))
            else:
                # healthy (uncordon / clean canary) or probation both
                # close a manual-cordon episode.
                open_manual.pop(host, None)
            continue
        if t == fj.REC_FLEET_GEN:
            gen = int(rec.get("generation", 0) or 0)
            if last_gen is not None and gen <= last_gen:
                rep.violations.append(Violation(
                    "fleet-gen-monotonic", rel, idx,
                    f"fleet generation {gen} does not supersede "
                    f"{last_gen} — generations must strictly increase "
                    f"(the zombie-daemon fence)", ev))
            last_gen = max(gen, last_gen or 0)
            capacity = (int(rec.get("slices", 0) or 0)
                        * int(rec.get("hosts_per_slice", 0) or 0))
            # A new daemon life re-carries interrupted grants out: its
            # grant folds restart (the fgen record is the license), and
            # a granted-but-never-spawned job's hosts were never truly
            # in use — drop them from the capacity fold.
            for j, st in list(states.items()):
                if st == "GRANTED":
                    states[j] = "QUEUED"
                    hosts.pop(j, None)
            last_decision.clear()
            continue
        if t == fj.REC_FLEET_SUBMIT:
            submitted.add(job)
            states[job] = "QUEUED"
            continue
        if t not in (fj.REC_FLEET_GRANT, fj.REC_FLEET_PREEMPT,
                     fj.REC_FLEET_STATE, fj.REC_FLEET_DECISION,
                     fj.REC_FLEET_MIGRATE):
            continue
        if job not in submitted:
            rep.violations.append(Violation(
                "fleet-unknown-job", rel, idx,
                f"record for job {job!r} which the journal never saw "
                f"submitted — a grant/state without a submission", ev))
            continue
        prev = states.get(job, "QUEUED")
        if t == fj.REC_FLEET_DECISION:
            action = str(rec.get("action", "") or "")
            reason = str(rec.get("reason", "") or "")
            if prev in fj.TERMINAL_STATES:
                rep.violations.append(Violation(
                    "fleet-decision", rel, idx,
                    f"decision record for job {job} in terminal state "
                    f"{prev} — the explainer recorded a hold for a "
                    f"finished job", ev))
            elif last_decision.get(job) == (action, reason):
                rep.violations.append(Violation(
                    "fleet-decision", rel, idx,
                    f"consecutive identical decision for job {job} "
                    f"([{action}] {reason[:80]!r}) — decisions must be "
                    f"recorded per reason TRANSITION, never per tick "
                    f"(the bounded-journal contract)", ev))
            last_decision[job] = (action, reason)
            continue
        if t == fj.REC_FLEET_MIGRATE:
            # A live move re-books hosts between slices without
            # changing the count — the capacity fold is untouched; a
            # migration record for a finished job is still a breach.
            if prev in fj.TERMINAL_STATES:
                rep.violations.append(Violation(
                    "fleet-terminal", rel, idx,
                    f"migration record for job {job} in terminal state "
                    f"{prev} — a finished job was moved", ev))
            continue
        if t == fj.REC_FLEET_GRANT:
            # A grant closes the hold episode: the same hold may
            # legitimately recur after a preemption re-queues the job.
            last_decision.pop(job, None)
            if prev in fj.TERMINAL_STATES:
                rep.violations.append(Violation(
                    "fleet-terminal", rel, idx,
                    f"grant for job {job} in terminal state {prev} — a "
                    f"finished job was re-granted", ev))
            elif prev != "QUEUED":
                rep.violations.append(Violation(
                    "fleet-double-grant", rel, idx,
                    f"second grant for job {job} (state {prev}) with no "
                    f"intervening terminal state or generation bump — "
                    f"a duplicated grant runs the job twice", ev))
            states[job] = "GRANTED"
            hosts[job] = int(rec.get("hosts", 0) or 0)
        elif t == fj.REC_FLEET_PREEMPT:
            hosts[job] = int(rec.get("to", hosts.get(job, 0)) or 0)
        else:                        # REC_FLEET_STATE
            st = str(rec.get("state", "") or "")
            if prev in fj.TERMINAL_STATES and st != prev:
                rep.violations.append(Violation(
                    "fleet-terminal", rel, idx,
                    f"job {job} transitions {prev} → {st} after a "
                    f"terminal state — a closed job was resurrected",
                    ev))
            states[job] = st if st != fj.STATE_RESTORED \
                else fj.STATE_RUNNING
            if st == fj.STATE_RESTORED:
                hosts[job] = int(rec.get("hosts", hosts.get(job, 0))
                                 or 0)
            if st in fj.TERMINAL_STATES:
                hosts.pop(job, None)
        in_use = sum(hosts.values())
        if capacity and in_use > capacity:
            rep.violations.append(Violation(
                "fleet-capacity", rel, idx,
                f"granted hosts total {in_use} exceeds the journaled "
                f"pool of {capacity} — the scheduler over-committed",
                ev))
    for host, idx in sorted(open_manual.items()):
        rep.violations.append(Violation(
            "health-dangling-cordon", rel, idx,
            f"manual cordon of host {host} is never closed by an "
            f"uncordon — manual cordons do not auto-expire, so this "
            f"host is capacity silently lost"))


def _check_fleet_ledger(fleet_dir: str, rep: Report) -> None:
    """Re-fold the goodput ledger offline (fleet/ledger.py) and hold
    its own invariant: every terminal job's phases are non-negative and
    sum to its wall within 1% — the acceptance discipline that makes
    the per-tenant goodput numbers trustworthy."""
    from tony_tpu_torch.fleet import ledger as fledger

    try:
        folded = fledger.fold_fleet_dir(fleet_dir)
    except Exception as e:  # noqa: BLE001 — a broken fold IS the finding
        rep.violations.append(Violation(
            "fleet-ledger", constants.FLEET_JOURNAL_FILE, 0,
            f"goodput-ledger fold failed over this fleet dir: {e}"))
        return
    checked = 0
    for job_id, led in sorted(folded.get("jobs", {}).items()):
        wall = float(led.get("wall_s", 0.0) or 0.0)
        if led.get("provisional") or wall <= 0:
            continue            # live jobs have no terminal anchor
        checked += 1
        phases = led.get("phases_s") or {}
        negative = {p: v for p, v in phases.items() if float(v) < 0}
        if negative:
            rep.violations.append(Violation(
                "fleet-ledger", constants.FLEET_JOURNAL_FILE, 0,
                f"job {job_id}: negative ledger phase(s) {negative} — "
                f"the wall partition went inconsistent",
                json.dumps(phases, sort_keys=True)))
            continue
        err = fledger.sum_to_wall_error(led)
        if err:
            total = sum(float(v) for v in phases.values())
            rep.violations.append(Violation(
                "fleet-ledger", constants.FLEET_JOURNAL_FILE, 0,
                f"job {job_id}: ledger phases sum to {total:.4f}s but "
                f"the wall is {wall:.4f}s (off by {err:.4f}s beyond "
                f"tolerance) — phase accounting leaked or double-"
                f"booked", json.dumps(phases, sort_keys=True)))
    rep.checked["fleet-ledger"] = checked


def _check_fleet_parity(fleet_dir: str, rep: Report) -> None:
    """Re-derive the journal's grant/preempt sequence through the real
    policy engine (fleet/simulator.py parity replay) and hold it
    bit-for-bit: a placement or victim the engine would not have
    produced means the daemon and the policy drifted — the exact
    condition under which `fleet whatif` counterfactuals (and the
    recorded journal itself) stop being trustworthy. Hold-decision
    REASON WORDING may drift across daemon versions (and operator
    migrations are exogenous), so only grant/preempt divergence is a
    violation; everything else is a note."""
    from tony_tpu_torch.fleet import simulator as fsim
    from tony_tpu_torch.fleet import timeline as ftimeline

    try:
        tl = ftimeline.load(fleet_dir)
        par = fsim.parity_replay(tl)
    except Exception as e:  # noqa: BLE001 — a crashed replay IS the finding
        rep.violations.append(Violation(
            "fleet-sim-parity", constants.FLEET_JOURNAL_FILE, 0,
            f"parity replay crashed over this fleet dir: {e}"))
        return
    if not par.get("supported"):
        rep.notes.append(
            f"fleet-sim-parity: skipped — {par.get('reason', '?')}")
        return
    counts = par.get("counts") or {}
    rep.checked["fleet-sim-parity"] = \
        counts.get("grant", 0) + counts.get("preempt", 0)
    gated = {"grant", "preempt"}
    for m in par.get("mismatches") or []:
        if m.get("kind") in gated:
            rep.violations.append(Violation(
                "fleet-sim-parity", constants.FLEET_JOURNAL_FILE,
                int(m.get("index", 0)),
                f"record {m['index']}: journaled {m['kind']} diverges "
                f"from the policy engine's plan — recorded "
                f"{m['recorded']}; the engine planned {m['expected']}"))
    soft = sum(v for k, v in (par.get("mismatch_counts") or {}).items()
               if k not in gated)
    if soft:
        rep.notes.append(
            f"fleet-sim-parity: {soft} decision/restore record(s) "
            f"differ from the replayed plan (reason wording or "
            f"recovery-path drift — not gated)")


def _check_fleet_trace(fleet_dir: str, rep: Report) -> None:
    """Fleet span-log hygiene + cross-layer stitching: the fleet dir's
    own span log must be tree-consistent (non-strict: a killed daemon
    life's opens are closed by the recovering life), and every granted
    job's span tree must carry the FLEET's trace id — the proof the
    grant's injected trace context reached the client."""
    from tony_tpu_torch import tracing
    from tony_tpu_torch.fleet import journal as fj
    from tony_tpu_torch.fleet import ledger as fledger

    trace_path = os.path.join(fleet_dir, constants.TRACE_FILE)
    if not os.path.exists(trace_path):
        rep.notes.append(f"{constants.TRACE_FILE}: absent — fleet "
                         f"trace checks skipped (pre-ledger fleet dir "
                         f"or tracing disabled)")
        return
    _check_spans(trace_path, constants.TRACE_FILE, rep, strict=False)
    fleet_trace = tracing.existing_trace_id(trace_path)
    if not fleet_trace:
        return
    try:
        st = fj.replay(os.path.join(fleet_dir,
                                    constants.FLEET_JOURNAL_FILE))
    except fj.FleetJournalError:
        return
    dirs = fledger.job_history_dirs(fleet_dir)
    stitched = 0
    for job_id, fold in sorted(st.jobs.items()):
        if not fold.granted_ms or not fold.app_id:
            continue
        job_dir = dirs.get(fold.app_id)
        if job_dir is None:
            continue
        job_trace_path = os.path.join(job_dir, constants.TRACE_FILE)
        if not os.path.exists(job_trace_path):
            rep.notes.append(
                f"{job_id} ({fold.app_id}): no span log — stitching "
                f"unverifiable (job tracing disabled?)")
            continue
        job_trace = tracing.existing_trace_id(job_trace_path)
        if job_trace and job_trace != fleet_trace:
            rep.violations.append(Violation(
                "fleet-trace-stitch", constants.TRACE_FILE, 0,
                f"job {job_id} ({fold.app_id}) traces under "
                f"{job_trace!r}, not the fleet's {fleet_trace!r} — the "
                f"grant's injected trace id never reached the client, "
                f"so a --fleet export cannot stitch this job",
                job_trace_path))
        else:
            stitched += 1
    rep.checked["fleet-trace-stitch"] = stitched


# ---------------------------------------------------------------------------
# perf.json + metrics.prom invariants
# ---------------------------------------------------------------------------
def _check_perf(path: str, rel: str, rep: Report) -> None:
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        rep.notes.append(f"{rel}: absent or torn — skipped")
        return
    if not isinstance(doc, dict):
        return
    phases = doc.get("phases_s")
    wall = doc.get("wall_s")
    if not isinstance(phases, dict) or not isinstance(wall, (int, float)):
        return
    rep.checked[rel] = 1
    total = 0.0
    for v in phases.values():
        try:
            total += float(v)
        except (TypeError, ValueError):
            continue
    tol = max(PHASE_SUM_ABS_TOL, PHASE_SUM_REL_TOL * float(wall))
    if abs(total - float(wall)) > tol:
        rep.violations.append(Violation(
            "phase-sum", rel, 0,
            f"per-phase seconds sum to {total:.4f} but the attributed "
            f"wall is {wall:.4f} (tolerance {tol:.4f}) — phase "
            f"accounting leaked or double-booked step time",
            json.dumps({"phases_s": phases, "wall_s": wall},
                       sort_keys=True)))


def _check_prom(path: str, rel: str, rep: Report) -> None:
    from tony_tpu_torch.metrics import SERIES

    try:
        with open(path, encoding="utf-8") as f:
            text = f.read()
    except OSError:
        rep.notes.append(f"{rel}: absent — skipped")
        return
    families = 0
    for lineno, line in enumerate(text.splitlines(), start=1):
        if not line.startswith("# TYPE "):
            continue
        parts = line.split()
        if len(parts) < 3:
            continue
        name = parts[2]
        if not name.startswith("tony_"):
            continue
        families += 1
        if name not in SERIES:
            rep.violations.append(Violation(
                "metrics-unregistered", rel, lineno,
                f"exported family {name!r} is not registered in "
                f"tony_tpu_torch.metrics.SERIES — the registry and the "
                f"exposition drifted", line))
    rep.checked[rel] = families


def _finished_succeeded(job_dir: str) -> bool:
    """Did this job finalize SUCCEEDED? (From the jhist filename, the
    same source the history index uses.) Unknown/unfinished → False:
    the checker then holds only the always-invariants."""
    from tony_tpu_torch.events import history

    path = history.find_history_file(job_dir)
    if not path:
        return False
    meta = history.parse_metadata(os.path.basename(path))
    return bool(meta is not None and meta.status == "SUCCEEDED")


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def check_job_dir(job_dir: str) -> Report:
    """Verify one job dir's artifacts. Absent artifacts are notes (a
    minimal job writes only the journal); present artifacts must hold
    their invariants. A FLEET dir (holds a fleet journal, usually no
    session journal) is checked by the fleet rules and its per-job
    artifacts skipped as absent."""
    rep = Report(job_dir=job_dir)
    fleet_path = os.path.join(job_dir, constants.FLEET_JOURNAL_FILE)
    if os.path.exists(fleet_path):
        _check_fleet_journal(fleet_path, constants.FLEET_JOURNAL_FILE,
                             rep)
        _check_prom(os.path.join(job_dir, constants.FLEET_PROM_FILE),
                    constants.FLEET_PROM_FILE, rep)
        _check_fleet_ledger(job_dir, rep)
        _check_fleet_parity(job_dir, rep)
        _check_fleet_trace(job_dir, rep)
        if not os.path.exists(os.path.join(job_dir,
                                           constants.JOURNAL_FILE)):
            return rep
    strict = _finished_succeeded(job_dir)
    if not strict:
        rep.notes.append(
            "job did not finish SUCCEEDED — end-state invariants "
            "(dangling resize, span-tree stitching) degrade to notes")
    journal_path = os.path.join(job_dir, constants.JOURNAL_FILE)
    clean = False
    if os.path.exists(journal_path):
        _, clean = _check_journal(journal_path, constants.JOURNAL_FILE,
                                  rep, strict)
    else:
        rep.notes.append(f"{constants.JOURNAL_FILE}: absent — journal "
                         f"checks skipped (journal disabled?)")
    trace_path = os.path.join(job_dir, constants.TRACE_FILE)
    if os.path.exists(trace_path):
        _check_spans(trace_path, constants.TRACE_FILE, rep,
                     strict=strict and clean)
    else:
        rep.notes.append(f"{constants.TRACE_FILE}: absent — span checks "
                         f"skipped (tracing disabled?)")
    _check_perf(os.path.join(job_dir, constants.PERF_FILE),
                constants.PERF_FILE, rep)
    _check_prom(os.path.join(job_dir, constants.METRICS_PROM_FILE),
                constants.METRICS_PROM_FILE, rep)
    return rep


def find_job_dirs(root: str) -> List[str]:
    """Every dir under ``root`` holding a session journal OR a fleet
    journal — how the pytest artifact fixture and `check` on a history
    root find the dirs to verify (a fleet drill's tmp_path holds both
    kinds, and every one is checked)."""
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        if constants.JOURNAL_FILE in filenames \
                or constants.FLEET_JOURNAL_FILE in filenames:
            out.append(dirpath)
    return sorted(out)


def check_tree(root: str) -> List[Report]:
    return [check_job_dir(d) for d in find_job_dirs(root)]


def render_text(reports: Sequence[Report]) -> str:
    lines: List[str] = []
    for rep in reports:
        head = "OK" if rep.ok else f"{len(rep.violations)} violation(s)"
        lines.append(f"{rep.job_dir}: {head}")
        for v in rep.violations:
            lines.append(f"  {v}")
        for n in rep.notes:
            lines.append(f"  note: {n}")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="tony-tpu check",
        description="Cross-artifact trace invariant checker "
                    "(see docs/development.md).")
    p.add_argument("target",
                   help="a job dir, or a tree of job dirs to scan")
    p.add_argument("--json", action="store_true", dest="as_json")
    args = p.parse_args(argv)
    if not os.path.isdir(args.target):
        print(f"not a directory: {args.target}", file=sys.stderr)
        return 2
    if os.path.exists(os.path.join(args.target, constants.JOURNAL_FILE)) \
            or os.path.exists(os.path.join(args.target,
                                           constants.FLEET_JOURNAL_FILE)):
        reports = [check_job_dir(args.target)]
    else:
        reports = check_tree(args.target)
        if not reports:
            print(f"no job/fleet dirs (no {constants.JOURNAL_FILE} or "
                  f"{constants.FLEET_JOURNAL_FILE}) under "
                  f"{args.target}", file=sys.stderr)
            return 2
    if args.as_json:
        print(json.dumps([r.to_dict() for r in reports], indent=1,
                         sort_keys=True))
    else:
        print(render_text(reports))
    return 0 if all(r.ok for r in reports) else 1


if __name__ == "__main__":
    sys.exit(main())
