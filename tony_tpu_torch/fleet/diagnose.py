"""Fleet-level automatic diagnosis: one evidence-backed verdict over the
whole pool.

The per-job engine (``tony_tpu_torch/diagnosis/``) answers "why did my job
die"; this is its fleet twin answering "why is the POOL unhealthy" —
fed by the goodput ledger (``fleet/ledger.py``) and the scheduler
decision records (``REC_FLEET_DECISION``), in the same rule-engine
style: every rule emits a Finding with the numbers that fired it, the
verdict is picked by category precedence, and an unexplained verdict is
treated as worse than none.

Verdicts (precedence order)::

    SICK_SLICE       correlated host failures cordoned a whole slice —
                     a hardware incident, evacuation in progress
    FLAKY_HOST       the failure-attribution ledger quarantined a host;
                     placements already route around it
    STARVATION       a non-quota-held job has waited far beyond the
                     median grant wait — priority/quota tuning needed
    QUOTA_SATURATED  a tenant sits at its quota with work queued behind
                     it — raise the quota or drain the tenant
    FRAGMENTATION    free hosts EXIST but do not pack into the waiting
                     gang (sub-slice locality) — min_hosts / defrag
    PREEMPT_STORM    preemptions dominate grants or one victim is
                     shrunk over and over — priority bands too close
    POOL_COLD        a warm pool is configured but starts keep going
                     cold — the pool is under-sized or mis-mounted
    SLO_BREACH       no structural pathology matched, but the alert
                     engine (``tony_tpu_torch/alerts/``) has fleet-scope
                     rules firing — the SLO numbers are the verdict
    FLEET_HEALTHY    none of the above; goodput evidence attached

A firing alert is also *evidence*: when a structural verdict wins, any
alerts that were firing ride along in its incident as corroboration
(the ``alerts`` bundle key, fed live from the engine or offline from
replayed ``REC_FLEET_ALERT`` records).

The daemon recomputes this from its in-memory state every export and
atomically replaces ``fleet.incident.json`` (fault-gated: a rule-engine
failure degrades to no-verdict, never a blocked tick); ``tony-tpu fleet
diagnose`` rebuilds the same bundle OFFLINE from the fleet dir, so the
verdict survives the daemon. The verdict→knob table lives in
docs/operations.md ("Fleet triage").
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional

from tony_tpu_torch import constants

log = logging.getLogger(__name__)

SICK_SLICE = "SICK_SLICE"
FLAKY_HOST = "FLAKY_HOST"
STARVATION = "STARVATION"
QUOTA_SATURATED = "QUOTA_SATURATED"
FRAGMENTATION = "FRAGMENTATION"
PREEMPT_STORM = "PREEMPT_STORM"
POOL_COLD = "POOL_COLD"
SLO_BREACH = "SLO_BREACH"
FLEET_HEALTHY = "FLEET_HEALTHY"

#: every category the engine can return (golden-matrix test anchor) in
#: precedence order, most urgent first. Hardware verdicts outrank
#: scheduling ones: a starving queue behind a cordoned slice is a
#: hardware incident, not a priority-tuning problem.
CATEGORY_PRECEDENCE = (SICK_SLICE, FLAKY_HOST, STARVATION,
                       QUOTA_SATURATED, FRAGMENTATION,
                       PREEMPT_STORM, POOL_COLD, SLO_BREACH,
                       FLEET_HEALTHY)

#: schema version stamped into fleet.incident.json.
INCIDENT_SCHEMA = 1

# --- thresholds (module constants, tunable in one place) -------------------
STARVATION_MIN_WAIT_S = 30.0     # absolute floor before anyone starves
STARVATION_FACTOR = 5.0          # × median grant wait
PREEMPT_STORM_MIN = 3            # absolute preemption floor
PREEMPT_STORM_RATIO = 0.5        # preemptions / grants
PREEMPT_STORM_PER_JOB = 3        # one victim shrunk this often
POOL_COLD_MIN_STARTS = 4         # starts before cold-fraction is signal
POOL_COLD_WARM_FRACTION = 0.5    # below this with a pool = cold

#: verdict → the knob to spend it on (rendered by the CLI/portal; the
#: full table with context is the Fleet triage runbook).
_ADVICE = {
    SICK_SLICE: "correlated failures cordoned a whole slice — file the "
                "hardware ticket, let the evacuation migrations drain "
                "it, and uncordon after repair (docs/operations.md "
                "'Host health')",
    FLAKY_HOST: "the failure-attribution ledger quarantined the host — "
                "jobs already route around it; replace or repair the "
                "hardware, then let probation's canary re-admit it "
                "(or `fleet uncordon` after a manual fix)",
    STARVATION: "a job is starving behind the queue — raise its "
                "priority, lower the blocker's, or widen the "
                "blocking tenant's quota headroom",
    QUOTA_SATURATED: "the tenant is quota-bound, not capacity-bound — "
                     "raise tony.fleet.quotas for the tenant or drain "
                     "its running jobs",
    FRAGMENTATION: "free hosts exist but do not pack — submit with "
                   "min_hosts so the scheduler can shrink-to-fit, or "
                   "prefer slice-sized gangs (the defragmentation move "
                   "is ROADMAP item 3's live migration)",
    PREEMPT_STORM: "preemption is churning the pool — widen the "
                   "priority bands or raise victims' min_hosts floors "
                   "so each shrink reclaims more",
    POOL_COLD: "starts keep going cold despite a warm pool — raise "
               "tony.pool.size (and check tony.fleet.pool-dir reaches "
               "every grant)",
    SLO_BREACH: "a fleet SLO alert is firing with no structural "
                "pathology matched — read the rule's series and the "
                "burn-rate windows (docs/operations.md 'Alerting & "
                "SLOs') before turning any scheduler knob",
    FLEET_HEALTHY: "the pool keeps up — no scheduler knob indicated",
}


@dataclasses.dataclass
class Finding:
    category: str
    rule: str
    summary: str
    confidence: float = 0.5
    evidence: List[str] = dataclasses.field(default_factory=list)
    details: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["advice"] = _ADVICE[self.category]
        return d


_RULES: List[Callable[[Dict[str, Any]], Optional[Finding]]] = []


def _rule(fn: Callable[[Dict[str, Any]], Optional[Finding]]):
    _RULES.append(fn)
    return fn


def _queued(bundle: Dict[str, Any]) -> List[Dict[str, Any]]:
    return [r for r in bundle.get("queue", []) if isinstance(r, dict)]


@_rule
def _sick_slice(b: Dict[str, Any]) -> Optional[Finding]:
    health = b.get("health") or {}
    sick = list(health.get("sick_slices") or [])
    if not sick:
        return None
    members = [r for r in health.get("cordoned", [])
               if isinstance(r, dict) and r.get("slice") in sick]
    ev = [f"health: slice(s) {sick} cordoned by correlated-failure "
          f"detection (tony.health.slice-blast-n hosts suspect inside "
          f"the blast window)"]
    for r in members[:4]:
        ev.append(f"  {r.get('host')}: {r.get('state')} "
                  f"score={r.get('score')} ({r.get('reason', '?')})")
    return Finding(SICK_SLICE, "sick-slice",
                   f"slice(s) {sick} are sick — correlated host "
                   f"failures triggered a blast-radius cordon",
                   confidence=0.95, evidence=ev,
                   details={"slices": sick,
                            "hosts": [r.get("host") for r in members]})


@_rule
def _flaky_host(b: Dict[str, Any]) -> Optional[Finding]:
    health = b.get("health") or {}
    auto = [r for r in health.get("cordoned", [])
            if isinstance(r, dict) and not r.get("manual")]
    if not auto:
        return None
    worst = auto[0]
    ev = [f"health: {len(auto)} host(s) cordoned by the "
          f"failure-attribution ledger: "
          f"{[r.get('host') for r in auto]}"]
    for e in (worst.get("evidence") or [])[-4:]:
        ev.append(f"  {worst.get('host')}: {e.get('kind', '?')} "
                  f"in {e.get('job') or '?'}")
    return Finding(FLAKY_HOST, "flaky-host",
                   f"host {worst.get('host')} is quarantined with "
                   f"attributed failures (score {worst.get('score')})",
                   confidence=0.9, evidence=ev,
                   details={"hosts": [r.get("host") for r in auto],
                            "worst": worst.get("host")})


@_rule
def _starvation(b: Dict[str, Any]) -> Optional[Finding]:
    median = float(b.get("median_grant_wait_s", 0.0) or 0.0)
    floor = max(STARVATION_MIN_WAIT_S, STARVATION_FACTOR * median)
    worst = None
    for row in _queued(b):
        if (row.get("last_decision") or {}).get("action") == "quota":
            continue             # quota-held is its own verdict
        wait = float(row.get("wait_s", 0.0) or 0.0)
        if wait >= floor and (worst is None
                              or wait > worst["wait_s"]):
            worst = {"job": row.get("job"), "wait_s": wait,
                     "decision": row.get("last_decision") or {}}
    if worst is None:
        return None
    dec = worst["decision"]
    ev = [f"queue: {worst['job']} has waited {worst['wait_s']:.0f}s "
          f"(threshold max({STARVATION_MIN_WAIT_S:.0f}s, "
          f"{STARVATION_FACTOR:.0f}x median grant wait "
          f"{median:.1f}s))"]
    if dec:
        ev.append(f"last hold: [{dec.get('action')}] "
                  f"{dec.get('reason', '?')}")
        if dec.get("blocking"):
            ev.append(f"blocking: {dec['blocking']}")
    return Finding(STARVATION, "starvation",
                   f"job {worst['job']} is starving in the queue",
                   confidence=0.85, evidence=ev,
                   details={"job": worst["job"],
                            "wait_s": round(worst["wait_s"], 1)})


@_rule
def _quota_saturated(b: Dict[str, Any]) -> Optional[Finding]:
    quotas = b.get("quotas") or {}
    used = b.get("tenants_used") or {}
    hits = []
    for row in _queued(b):
        dec = row.get("last_decision") or {}
        if dec.get("action") != "quota":
            continue
        tenant = str(row.get("tenant", "") or "")
        quota = int(quotas.get(tenant, 0) or 0)
        if quota > 0:
            hits.append((tenant, quota, row, dec))
    if not hits:
        return None
    tenant, quota, row, dec = hits[0]
    queued_jobs = sorted({str(r.get("job")) for t, _, r, _ in
                          [(h[0], h[1], h[2], h[3]) for h in hits]
                          if t == tenant})
    ev = [f"tenant {tenant!r} uses {used.get(tenant, 0)}/{quota} "
          f"quota hosts with {len(queued_jobs)} job(s) quota-held: "
          f"{queued_jobs}",
          f"last hold ({row.get('job')}): {dec.get('reason', '?')}"]
    if dec.get("blocking"):
        ev.append(f"blocking (the tenant's own running jobs): "
                  f"{dec['blocking']}")
    return Finding(QUOTA_SATURATED, "quota-saturated",
                   f"tenant {tenant!r} is saturated at its "
                   f"{quota}-host quota with work queued behind it",
                   confidence=0.9, evidence=ev,
                   details={"tenant": tenant, "quota": quota,
                            "queued": queued_jobs})


@_rule
def _fragmentation(b: Dict[str, Any]) -> Optional[Finding]:
    for row in _queued(b):
        dec = row.get("last_decision") or {}
        if dec.get("action") != "capacity":
            continue
        free = int(dec.get("free", 0) or 0)
        hosts = int(row.get("hosts", 0) or 0)
        if hosts and free >= hosts:
            ev = [f"queue: {row.get('job')} wants {hosts} host(s); "
                  f"{free} are FREE but do not pack (sub-slice gangs "
                  f"need one slice)",
                  f"hold: {dec.get('reason', '?')}"]
            if dec.get("blocking"):
                ev.append(f"largest holders: {dec['blocking']}")
            return Finding(
                FRAGMENTATION, "fragmentation",
                f"the pool has {free} free host(s) that cannot pack "
                f"a waiting {hosts}-host gang",
                confidence=0.85, evidence=ev,
                details={"job": row.get("job"), "free": free,
                         "hosts": hosts})
    return None


@_rule
def _preempt_storm(b: Dict[str, Any]) -> Optional[Finding]:
    preempts = int(b.get("preemptions_total", 0) or 0)
    grants = int(b.get("grants_total", 0) or 0)
    per_job = b.get("preempts_per_job") or {}
    worst = max(per_job.items(), key=lambda kv: kv[1]) \
        if per_job else ("", 0)
    ratio = preempts / grants if grants else 0.0
    storm = (preempts >= PREEMPT_STORM_MIN
             and ratio >= PREEMPT_STORM_RATIO) \
        or worst[1] >= PREEMPT_STORM_PER_JOB
    if not storm:
        return None
    ev = [f"counters: {preempts} preemption(s) against {grants} "
          f"grant(s) (ratio {ratio:.2f}, threshold "
          f"{PREEMPT_STORM_RATIO})"]
    if worst[1]:
        ev.append(f"worst victim: {worst[0]} shrunk {worst[1]} time(s) "
                  f"(threshold {PREEMPT_STORM_PER_JOB})")
    return Finding(PREEMPT_STORM, "preempt-storm",
                   "preempt-to-reclaim is churning the pool",
                   confidence=0.8, evidence=ev,
                   details={"preemptions": preempts, "grants": grants,
                            "worst_victim": worst[0]})


@_rule
def _pool_cold(b: Dict[str, Any]) -> Optional[Finding]:
    if not b.get("pool_dir"):
        return None
    fleet = (b.get("ledger") or {}).get("fleet") or {}
    starts = int(fleet.get("warm_starts", 0) or 0) \
        + int(fleet.get("cold_starts", 0) or 0)
    frac = fleet.get("warm_start_fraction")
    if starts < POOL_COLD_MIN_STARTS or frac is None \
            or float(frac) >= POOL_COLD_WARM_FRACTION:
        return None
    return Finding(
        POOL_COLD, "pool-cold",
        f"only {float(frac):.0%} of {starts} start(s) adopted a warm "
        f"executor despite a configured pool",
        confidence=0.75,
        evidence=[f"ledger: warm_start_fraction = {float(frac):.2f} "
                  f"over {starts} start(s) (threshold "
                  f"{POOL_COLD_WARM_FRACTION})",
                  f"pool: {b.get('pool_dir')}"],
        details={"warm_start_fraction": frac, "starts": starts})


def _firing_alerts(b: Dict[str, Any]) -> List[Dict[str, Any]]:
    return [r for r in (b.get("alerts") or [])
            if isinstance(r, dict) and r.get("state") == "firing"]


@_rule
def _slo_breach(b: Dict[str, Any]) -> Optional[Finding]:
    firing = _firing_alerts(b)
    if not firing:
        return None
    # Page-severity rules outrank warns when picking the headline.
    firing = sorted(firing, key=lambda r: (
        0 if r.get("severity") == "page" else 1, str(r.get("rule"))))
    worst = firing[0]
    ev = [f"alerts: {len(firing)} fleet rule(s) firing: "
          f"{[r.get('rule') for r in firing]}"]
    for r in firing[:4]:
        ev.append(f"  {r.get('rule')} [{r.get('severity', '?')}] "
                  f"value={r.get('value')} — "
                  f"{r.get('summary') or r.get('series', '')}")
    return Finding(SLO_BREACH, "slo-breach",
                   f"fleet alert {worst.get('rule')!r} is firing "
                   f"({worst.get('severity', '?')}) with no structural "
                   f"pathology matched",
                   confidence=0.7, evidence=ev,
                   details={"rules": [r.get("rule") for r in firing],
                            "worst": worst.get("rule")})


@_rule
def _healthy(b: Dict[str, Any]) -> Optional[Finding]:
    fleet = (b.get("ledger") or {}).get("fleet") or {}
    gp = fleet.get("goodput_fraction")
    ev = [f"queue depth {len(_queued(b))}, "
          f"{int(b.get('grants_total', 0) or 0)} grant(s), "
          f"{int(b.get('preemptions_total', 0) or 0)} preemption(s)"]
    if gp is not None:
        ev.append(f"ledger: fleet goodput_fraction = {float(gp):.2f} "
                  f"over {fleet.get('held_chip_s', 0)} chip-seconds "
                  f"held")
    return Finding(FLEET_HEALTHY, "healthy",
                   "no fleet-level pathology above threshold",
                   confidence=0.5, evidence=ev)


def run_rules(bundle: Dict[str, Any]) -> List[Finding]:
    """All findings, verdict candidate first (precedence, then
    confidence). A broken rule downgrades to absent — diagnosis must
    degrade, never die (the daemon calls this on its tick path)."""
    findings: List[Finding] = []
    for fn in _RULES:
        try:
            f = fn(bundle)
        except Exception:  # noqa: BLE001 — degrade, never die
            log.exception("fleet diagnosis rule %s failed",
                          getattr(fn, "__name__", "?"))
            continue
        if f is not None:
            findings.append(f)
    prec = {c: i for i, c in enumerate(CATEGORY_PRECEDENCE)}
    findings.sort(key=lambda f: (prec.get(f.category, len(prec)),
                                 -f.confidence))
    return findings


def build_incident(bundle: Dict[str, Any]) -> Dict[str, Any]:
    findings = run_rules(bundle)
    verdict = findings[0] if findings else Finding(
        FLEET_HEALTHY, "none", "no findings", confidence=0.0)
    # An alert firing at verdict time is corroborating evidence for a
    # structural verdict: boost its confidence and fold the rule names
    # in, so "the health ledger cordoned the slice AND goodput-slo was
    # firing" reads as one story, not two.
    firing = _firing_alerts(bundle)
    if firing and verdict.category not in (SLO_BREACH, FLEET_HEALTHY):
        verdict.confidence = min(0.99, verdict.confidence + 0.1)
        verdict.evidence.append(
            f"alerts: {[r.get('rule') for r in firing]} firing at "
            f"verdict time (corroborating)")
    fleet = (bundle.get("ledger") or {}).get("fleet") or {}
    return {
        "schema": INCIDENT_SCHEMA,
        "generated_ms": int(time.time() * 1000),
        "fleet_dir": bundle.get("fleet_dir", ""),
        "verdict": verdict.to_dict(),
        "findings": [f.to_dict() for f in findings],
        "goodput_fraction": fleet.get("goodput_fraction"),
        "alerts_firing": [r.get("rule") for r in firing],
        "queue_depth": len(_queued(bundle)),
        "grants_total": int(bundle.get("grants_total", 0) or 0),
        "preemptions_total": int(bundle.get("preemptions_total", 0)
                                 or 0),
    }


def save_incident(fleet_dir: str, doc: Dict[str, Any]) -> None:
    """Atomic replace — readers see a whole document or the previous
    one, the incident.json discipline."""
    from tony_tpu_torch.utils.durable import atomic_write

    atomic_write(os.path.join(fleet_dir, constants.FLEET_INCIDENT_FILE),
                 json.dumps(doc, indent=1, sort_keys=True
                            ).encode("utf-8"))


def load_incident(fleet_dir: str) -> Optional[Dict[str, Any]]:
    try:
        with open(os.path.join(fleet_dir,
                               constants.FLEET_INCIDENT_FILE),
                  encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


def bundle_from_dir(fleet_dir: str,
                    now_ms: Optional[int] = None) -> Dict[str, Any]:
    """Rebuild the diagnosis bundle OFFLINE from a fleet dir — the
    shared timeline fold (fleet/timeline.py) + ledger fold + the
    replayed decision history; works on a dir copied off a dead host,
    no daemon needed."""
    from tony_tpu_torch.fleet import journal as fjournal
    from tony_tpu_torch.fleet import ledger as fledger
    from tony_tpu_torch.fleet import timeline as ftimeline

    tl = ftimeline.load(fleet_dir)
    st = tl.state
    now = int(now_ms or time.time() * 1000)
    led = fledger.fold_fleet_dir(fleet_dir, now_ms=now,
                                 timeline=tl)
    queue: List[Dict[str, Any]] = []
    used: Dict[str, int] = {}
    for fold in st.jobs.values():
        if fold.state == "QUEUED":
            queue.append({
                "job": fold.job_id, "tenant": fold.tenant,
                "priority": fold.priority,
                "hosts": fold.hosts_requested,
                "wait_s": max(0.0, (now - fold.submitted_ms) / 1000.0)
                if fold.submitted_ms else 0.0,
                "last_decision": fold.decisions[-1]
                if fold.decisions else {}})
        elif fold.state not in fjournal.TERMINAL_STATES \
                and fold.hosts:
            used[fold.tenant] = used.get(fold.tenant, 0) + fold.hosts
    # preemption counts and the alert fold come from the timeline's raw
    # record prefix (the job fold keeps only the final placement)
    grants = len(tl.grant_waits)
    preempts = tl.preemptions_total
    preempts_per_job = dict(tl.preempts_per_job)
    alert_last = tl.alert_last
    grant_waits = tl.grant_waits
    median = grant_waits[len(grant_waits) // 2] if grant_waits else 0.0
    pool_dir = ""
    for fold in st.jobs.values():
        pool_dir = pool_dir or fold.conf.get("tony.pool.dir", "")
    # health fold: st.health is last-wins per host, so a host whose
    # final record is "healthy" has already been re-admitted.
    cordoned: List[Dict[str, Any]] = []
    for host in sorted(st.health):
        rec = st.health[host]
        if rec.get("state") not in ("quarantined", "probation"):
            continue
        cordoned.append({
            "host": host, "slice": rec.get("slice"),
            "state": rec.get("state"), "score": rec.get("score"),
            "manual": bool(rec.get("manual")),
            "reason": rec.get("reason", ""),
            "evidence": list(rec.get("evidence") or [])})
    sick = sorted({r["slice"] for r in cordoned
                   if str(r.get("reason", "")).startswith("sick slice")
                   and r.get("slice") is not None})
    return {
        "fleet_dir": fleet_dir,
        "quotas": dict(st.quotas), "tenants_used": used, "queue": queue,
        "median_grant_wait_s": round(median, 3),
        "grants_total": grants, "preemptions_total": preempts,
        "preempts_per_job": preempts_per_job,
        "ledger": {"tenants": led.get("tenants", {}),
                   "fleet": led.get("fleet", {})},
        "pool_dir": pool_dir,
        "health": {"enabled": bool(st.health),
                   "cordoned": cordoned, "sick_slices": sick},
        # Replayed REC_FLEET_ALERT fold: last-wins state per rule, so
        # the offline verdict sees exactly what was firing when the
        # daemon last wrote (severity/value from the raw record).
        "alerts": [{"rule": rule, "state": state,
                    "severity": alert_last.get(rule, {}).get(
                        "severity", "?"),
                    "value": alert_last.get(rule, {}).get("value"),
                    "summary": alert_last.get(rule, {}).get(
                        "summary", "")}
                   for rule, state in sorted(st.alerts.items())
                   if state == "firing"],
    }


def offline_explain(fleet_dir: str, job_id: str) -> Dict[str, Any]:
    """`fleet explain` without a daemon: rebuild the job's hold
    timeline from the replayed REC_FLEET_DECISION records (via the
    shared fleet/timeline.py fold) — the same response shape as the
    fleet.explain RPC."""
    from tony_tpu_torch.fleet import timeline as ftimeline

    st = ftimeline.load(fleet_dir).state
    fold = st.jobs.get(job_id)
    if fold is None:
        return {"ok": False,
                "message": f"unknown job {job_id!r} in the journal "
                           f"under {fleet_dir}"}
    milestones: List[Dict[str, Any]] = [
        {"ts_ms": fold.submitted_ms,
         "what": f"submitted by tenant {fold.tenant!r} (priority "
                 f"{fold.priority}, {fold.hosts_requested} host(s))"}]
    if fold.granted_ms:
        milestones.append({"ts_ms": fold.granted_ms,
                           "what": f"granted {fold.hosts or '?'} "
                                   f"host(s)"})
    for ts, hosts in fold.host_events[1:]:
        milestones.append({"ts_ms": ts,
                           "what": f"resized to {hosts} host(s)"})
    if fold.finished_ms:
        milestones.append({"ts_ms": fold.finished_ms,
                           "what": f"finished {fold.state}"})
    return {"ok": True, "job": job_id, "state": fold.state,
            "tenant": fold.tenant, "app_id": fold.app_id,
            "decisions": list(fold.decisions),
            # Decision.blocking/free threaded through as attributed
            # hold seconds: which jobs blocked this one, under which
            # hold kind, for how long — the citation `fleet whatif`
            # diffs against when a counterfactual removes a hold.
            "holds": ftimeline.holds_summary(ftimeline.hold_intervals(
                fold.decisions, granted_ms=fold.granted_ms,
                finished_ms=fold.finished_ms,
                now_ms=int(time.time() * 1000),
                hosts=fold.hosts_requested)),
            "milestones": milestones, "offline": True}


def render_explain(doc: Dict[str, Any]) -> str:
    """The causal hold timeline, human-readable: decisions and
    milestones merged in time order, blockers named per hold."""
    import datetime

    def hhmmss(ts_ms: int) -> str:
        if not ts_ms:
            return "--:--:--.---"
        dt = datetime.datetime.fromtimestamp(ts_ms / 1000.0)
        return dt.strftime("%H:%M:%S.") + f"{ts_ms % 1000:03d}"

    rows: List[Dict[str, Any]] = []
    for m in doc.get("milestones", []):
        rows.append({"ts_ms": int(m.get("ts_ms", 0) or 0),
                     "line": m.get("what", "?"), "blocking": []})
    for d in doc.get("decisions", []):
        rows.append({"ts_ms": int(d.get("ts_ms", 0) or 0),
                     "line": f"[{d.get('action', '?')}] "
                             f"{d.get('reason', '?')}",
                     "blocking": d.get("blocking") or []})
    rows.sort(key=lambda r: r["ts_ms"])
    out = [f"{doc.get('job', '?')} (tenant {doc.get('tenant', '?')}) "
           f"— {doc.get('state', '?')}"
           + (f"  app={doc['app_id']}" if doc.get("app_id") else "")
           + ("  [offline: journal replay]" if doc.get("offline")
              else "")]
    if not rows:
        out.append("  (no recorded decisions — the job was never held)")
    for r in rows:
        out.append(f"  {hhmmss(r['ts_ms'])}  {r['line']}")
        if r["blocking"]:
            out.append(f"  {'':14}blocking: "
                       f"{', '.join(str(b) for b in r['blocking'])}")
    holds = doc.get("holds") or {}
    if holds:
        parts = []
        for kind in sorted(holds):
            h = holds[kind]
            cite = f" (blocking: {', '.join(h['blocking'])})" \
                if h.get("blocking") else ""
            free = f", {h['free']} free" \
                if kind == "fragmentation" else ""
            parts.append(f"{kind} {h['seconds']}s{free}{cite}")
        out.append(f"  held: {'; '.join(parts)}")
    return "\n".join(out)


def render_text(doc: Dict[str, Any]) -> str:
    v = doc.get("verdict") or {}
    lines = [f"fleet verdict: {v.get('category', '?')}  "
             f"(confidence {v.get('confidence', 0)})",
             f"  {v.get('summary', '')}",
             f"  advice: {v.get('advice', '')}"]
    for e in v.get("evidence", []):
        lines.append(f"  evidence: {e}")
    others = [f for f in doc.get("findings", [])
              if f.get("rule") != v.get("rule")]
    for f in others:
        lines.append(f"  also: [{f.get('category')}] "
                     f"{f.get('summary')}")
    gp = doc.get("goodput_fraction")
    if gp is not None:
        lines.append(f"  fleet goodput: {float(gp):.1%}")
    if doc.get("alerts_firing"):
        lines.append(f"  alerts firing: "
                     f"{', '.join(doc['alerts_firing'])}")
    return "\n".join(lines)
