"""Diagnosis rule engine: from an incident bundle to a verdict.

Each rule inspects the bundle (``diagnosis/collector.py``) and emits a
Finding — a category, a blamed task, a confidence, and the EVIDENCE
LINES that fired it (an operator must be able to check the engine's
work; an unexplained verdict is worse than none). The engine runs every
rule, keeps all findings, and picks the verdict by category precedence:
explicit control-plane verdicts (hang events, recovery records,
backend-attributed preemption) outrank log-pattern heuristics, which
outrank the UNKNOWN fallback.

Rules declare the event types they consume (``events_used``) so a
tier-1 smoke test can assert every referenced type still exists in
``events.EventType`` — rules must not silently rot as events evolve.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

from tony_tpu_torch.diagnosis.collector import IncidentBundle, TaskIncident
from tony_tpu_torch.diagnosis.exitcodes import describe_exit, exit_signal

# -- categories ------------------------------------------------------------
USER_TRACEBACK = "USER_TRACEBACK"
OOM_RSS = "OOM_RSS"
OOM_HBM = "OOM_HBM"
HANG = "HANG"
STRAGGLER_CASCADE = "STRAGGLER_CASCADE"
PREEMPTION = "PREEMPTION"
INFRA_STORM = "INFRA_STORM"
COORDINATOR_LOSS = "COORDINATOR_LOSS"
PORT_RENDEZVOUS = "PORT_RENDEZVOUS"
GANG_RESIZE = "GANG_RESIZE"
SLO_BREACH = "SLO_BREACH"
UNKNOWN = "UNKNOWN"

#: verdict precedence, most specific first: explicit verdicts the
#: control plane already made, then backend attribution, then log-shape
#: heuristics, then the fallback. SLO_BREACH sits just above UNKNOWN:
#: "an alert was firing" is real evidence but every structural verdict
#: explains MORE — the alert instead boosts whichever structural
#: finding it corroborates (see ``_ALERT_CATEGORY`` / ``run_rules``).
CATEGORY_PRECEDENCE = (
    COORDINATOR_LOSS, GANG_RESIZE, HANG, STRAGGLER_CASCADE, PREEMPTION,
    OOM_HBM, OOM_RSS, PORT_RENDEZVOUS, INFRA_STORM, USER_TRACEBACK,
    SLO_BREACH, UNKNOWN)


@dataclasses.dataclass
class Finding:
    category: str
    rule: str
    summary: str
    blamed_task: str = ""
    confidence: float = 0.5
    evidence: List[str] = dataclasses.field(default_factory=list)
    details: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Rule:
    name: str
    category: str
    #: EventType NAMES this rule reads from the event stream — checked
    #: against events.EventType by the parity smoke test.
    events_used: Tuple[str, ...]
    fn: Callable[[IncidentBundle], Optional[Finding]]


RULES: List[Rule] = []


def _rule(name: str, category: str, events_used: Tuple[str, ...] = ()):
    def deco(fn):
        RULES.append(Rule(name, category, events_used, fn))
        return fn
    return deco


def _blame(bundle: IncidentBundle,
           task: Optional[TaskIncident] = None) -> str:
    t = task or bundle.first_failed_task()
    return t.task_id if t else ""


# -- rules -----------------------------------------------------------------
@_rule("coordinator-loss", COORDINATOR_LOSS,
       ("COORDINATOR_RECOVERED", "APPLICATION_FINISHED"))
def _coordinator_loss(b: IncidentBundle) -> Optional[Finding]:
    """The coordinator died and the job did not survive the recovery:
    the re-registration grace expired (the gang was lost with it), or
    the journal shows generation churn behind a failed recovery run."""
    recov = b.events_of("COORDINATOR_RECOVERED")
    grace = "re-registration grace" in (b.failure_reason or "")
    if not grace and not (recov and b.status in ("FAILED", "KILLED")):
        return None
    ev = []
    for e in recov:
        ev.append(f"events: COORDINATOR_RECOVERED generation="
                  f"{e.payload.get('generation')} awaiting="
                  f"{e.payload.get('awaiting_reregistration')}")
    if len(b.generations) > 1:
        ev.append(f"journal: {len(b.generations)} coordinator "
                  f"generation(s): {b.generations}")
    if grace:
        ev.append(f"failure_reason: {b.failure_reason}")
    if not grace and not any("re-registration" in x for x in ev):
        # Recovered AND failed, but not ON the recovery itself — let the
        # failure's own shape (hang, user crash...) take the verdict.
        return None
    return Finding(
        COORDINATOR_LOSS, "coordinator-loss",
        "the coordinator was lost mid-run and the surviving gang did not "
        "re-register within the recovery grace window",
        blamed_task=_blame(b), confidence=0.9 if grace else 0.6,
        evidence=ev)


@_rule("hang", HANG, ("TASK_HUNG", "TASK_FINISHED"))
def _hang(b: IncidentBundle) -> Optional[Finding]:
    """Progress-liveness verdict: heartbeats alive, step counter frozen.
    The control plane already diagnosed this live — surface its evidence
    (stall ages, the captured all-thread stack dump)."""
    hung_events = b.events_of("TASK_HUNG")
    if not hung_events:
        return None
    first = hung_events[0]
    tid = str(first.payload.get("task", ""))
    t = b.tasks.get(tid)
    ev = [f"events: TASK_HUNG {tid} steps={first.payload.get('steps')} "
          f"stalled_s={first.payload.get('stalled_s')} "
          f"timeout_s={first.payload.get('timeout_s')}"]
    details: Dict[str, Any] = {"stalled_s": first.payload.get("stalled_s"),
                               "steps": first.payload.get("steps")}
    if t is not None:
        if t.last_heartbeat_age_s is not None:
            ev.append(f"events: heartbeats were alive at the kill "
                      f"(age {t.last_heartbeat_age_s:.1f}s) — the "
                      f"executor survived; the user process wedged")
        if t.stack_dump:
            ev.append("stack dump captured (all-thread faulthandler "
                      "excerpt in blamed_task.stack_dump)")
            details["has_stack_dump"] = True
        if t.reason:
            ev.append(f"kill reason: {t.reason}")
    return Finding(
        HANG, "hang",
        f"task {tid} hung: heartbeats kept arriving while its step "
        f"counter stayed frozen past the progress deadline",
        blamed_task=tid or _blame(b), confidence=0.95,
        evidence=ev, details=details)


@_rule("straggler-cascade", STRAGGLER_CASCADE,
       ("TASK_STRAGGLER", "TASK_FINISHED"))
def _straggler(b: IncidentBundle) -> Optional[Finding]:
    strag = b.events_of("TASK_STRAGGLER")
    if not strag:
        return None
    by_task: Dict[str, dict] = {}
    for e in strag:
        by_task.setdefault(str(e.payload.get("task", "")), e.payload)
    first_tid = str(strag[0].payload.get("task", ""))
    ev = [f"events: TASK_STRAGGLER {tid} rate="
          f"{p.get('rate_steps_per_s')} median="
          f"{p.get('median_steps_per_s')}"
          for tid, p in by_task.items()]
    restarted = [tid for tid in by_task
                 if b.tasks.get(tid) and b.tasks[tid].failed]
    if restarted:
        ev.append(f"straggler(s) {restarted} killed/restarted by "
                  f"straggler policing")
    return Finding(
        STRAGGLER_CASCADE, "straggler-cascade",
        f"{len(by_task)} task(s) fell below the gang's median step rate "
        f"for the sustained window, dragging the whole gang",
        blamed_task=first_tid, confidence=0.85, evidence=ev,
        details={"stragglers": sorted(by_task)})


@_rule("elastic-resize", GANG_RESIZE, ("GANG_RESIZED", "TASK_FINISHED"))
def _elastic_resize(b: IncidentBundle) -> Optional[Finding]:
    """Distinguish "the gang shrank and continued" (deliberate
    elasticity — NOT the failure; other rules skip the absorbed task
    exits via their ``resized`` flag) from "the job died mid-resize"
    (drain/barrier never completed): only the latter takes the verdict,
    with the incomplete resize as the evidence."""
    resized = b.events_of("GANG_RESIZED")
    if not resized:
        return None
    started = [e for e in resized if e.payload.get("phase") == "started"]
    completed = [e for e in resized
                 if e.payload.get("phase") == "completed"]
    reason = (b.failure_reason or "").lower()
    mid_resize = "resize" in reason or len(completed) < len(started)
    if not mid_resize:
        # Every resize completed: absorbed losses are routine
        # elasticity. Let the real cause (if any) take the verdict.
        return None
    last = started[-1].payload if started else {}
    ev = [f"events: GANG_RESIZED started mgen={last.get('mgen')} "
          f"{last.get('from')}->{last.get('to')} "
          f"({last.get('reason')}) never completed"]
    if b.failure_reason:
        ev.append(f"failure_reason: {b.failure_reason}")
    absorbed = sorted(t.task_id for t in b.tasks.values() if t.resized)
    if absorbed:
        ev.append(f"absorbed member loss(es): {absorbed}")
    return Finding(
        GANG_RESIZE, "elastic-resize",
        "the job failed while an elastic resize was in flight — the "
        "drain or the post-remesh barrier never completed (the retry "
        "epoch relaunches at the configured size)",
        blamed_task=_blame(b), confidence=0.85, evidence=ev,
        details={"mgen": last.get("mgen"), "target": last.get("to")})


@_rule("preemption", PREEMPTION, ("TASK_FINISHED", "APPLICATION_FINISHED"))
def _preemption(b: IncidentBundle) -> Optional[Finding]:
    """Backend-attributed preemption (host reclaimed, spot notice, 143
    save-on-TERM exits) — authoritative when the domain says so. Losses
    a resize absorbed are deliberate elasticity, not this verdict."""
    preempted = [t for t in b.tasks.values()
                 if t.failed and t.failure_domain == "PREEMPTION"
                 and not t.resized]
    if not preempted and b.failure_domain != "PREEMPTION":
        return None
    blamed = min(preempted, key=lambda t: t.failure_us or t.finished_ms
                 * 1000 or float("inf")) if preempted else None
    ev = [f"events: TASK_FINISHED {t.task_id} "
          f"{t.exit_detail or describe_exit(t.exit_code)} "
          f"domain=PREEMPTION" for t in preempted[:5]]
    if b.failure_domain == "PREEMPTION":
        ev.append(f"failure_domain: PREEMPTION ({b.failure_reason})")
    return Finding(
        PREEMPTION, "preemption",
        "the backend attributed the failure to preemption — reclaimed "
        "capacity, not a bug; retries on a fresh lease usually clear it",
        blamed_task=blamed.task_id if blamed else _blame(b),
        confidence=0.9, evidence=ev)


#: allocator/oom phrases that mean DEVICE memory (XLA/jax HBM), matched
#: against tracebacks and log tails.
_HBM_RE = re.compile(
    r"RESOURCE_EXHAUSTED|out of memory while trying to allocate|"
    r"Failed to allocate request for .* of .* hbm|HBM OOM|"
    r"Allocator .* ran out of memory", re.IGNORECASE)
#: host-memory kill markers (the kernel OOM-killer reaps with SIGKILL and
#: says so in dmesg, not the task log — the log shows the victim's side).
_RSS_RE = re.compile(r"MemoryError|Cannot allocate memory|"
                     r"oom-?kill", re.IGNORECASE)


@_rule("oom-hbm", OOM_HBM, ("TASK_FINISHED",))
def _oom_hbm(b: IncidentBundle) -> Optional[Finding]:
    for t in sorted(b.tasks.values(),
                    key=lambda x: x.failure_us or x.finished_ms * 1000):
        if not t.failed:
            continue
        for text, where in ((t.traceback, "traceback"), *(
                (b.log_tails.get(p, ""), p) for p in t.logs)):
            m = _HBM_RE.search(text or "")
            if m:
                line = next((ln.strip() for ln in text.splitlines()
                             if m.group(0) in ln), m.group(0))
                return Finding(
                    OOM_HBM, "oom-hbm",
                    f"task {t.task_id} exhausted device memory (HBM) — "
                    f"shrink the per-device batch/model shard or widen "
                    f"the mesh",
                    blamed_task=t.task_id, confidence=0.9,
                    evidence=[f"{where}: {line[:200]}"])
    return None


@_rule("oom-rss", OOM_RSS, ("TASK_FINISHED",))
def _oom_rss(b: IncidentBundle) -> Optional[Finding]:
    """SIGKILL with no supervisor-stamped reason is the kernel
    OOM-killer's signature shape; explicit host-memory markers in the
    log raise the confidence."""
    for t in sorted(b.tasks.values(),
                    key=lambda x: x.failure_us or x.finished_ms * 1000):
        if not t.failed or t.hung or t.resized \
                or t.failure_domain == "PREEMPTION":
            continue
        texts = [(t.traceback, "traceback")] + \
            [(b.log_tails.get(p, ""), p) for p in t.logs]
        marker = next(((m.group(0), where) for text, where in texts
                       for m in [_RSS_RE.search(text or "")] if m), None)
        killed = exit_signal(t.exit_code) == 9 and not t.reason \
            and t.last_heartbeat_age_s is None
        if not marker and not killed:
            continue
        ev = []
        if killed:
            ev.append(f"events: TASK_FINISHED {t.task_id} "
                      f"{t.exit_detail or describe_exit(t.exit_code)} "
                      f"with no supervisor kill reason — the OOM-killer "
                      f"shape")
        if marker:
            ev.append(f"{marker[1]}: {marker[0]}")
        rss = t.metrics.get("MAX_MEMORY_BYTES") or \
            t.metrics.get("rss_bytes")
        if rss:
            ev.append(f"metrics: peak RSS {rss} bytes")
        return Finding(
            OOM_RSS, "oom-rss",
            f"task {t.task_id} was killed for host memory (RSS) — the "
            f"input pipeline / host-side buffers outgrew the VM",
            blamed_task=t.task_id,
            confidence=0.8 if marker else 0.5, evidence=ev)
    return None


@_rule("port-rendezvous", PORT_RENDEZVOUS,
       ("TASK_FINISHED", "APPLICATION_FINISHED"))
def _rendezvous(b: IncidentBundle) -> Optional[Finding]:
    reason = b.failure_reason or ""
    ev = []
    if "registration timeout" in reason:
        ev.append(f"failure_reason: {reason}")
    bind_re = re.compile(r"Address already in use|Failed to bind|"
                         r"EADDRINUSE|address in use", re.IGNORECASE)
    blamed = ""
    for t in b.tasks.values():
        for p in t.logs:
            m = bind_re.search(b.log_tails.get(p, ""))
            if m:
                ev.append(f"{p}: {m.group(0)}")
                blamed = blamed or t.task_id
    if not ev:
        return None
    return Finding(
        PORT_RENDEZVOUS, "port-rendezvous",
        "the gang never completed its rendezvous — a member could not "
        "register or bind its port",
        blamed_task=blamed or _blame(b),
        confidence=0.8 if len(ev) > 1 else 0.6, evidence=ev)


@_rule("executor-vanished", INFRA_STORM, ("TASK_FINISHED",))
def _vanished(b: IncidentBundle) -> Optional[Finding]:
    """Heartbeat-expiry kill: the EXECUTOR (not just the user process)
    went silent — host death, network partition, or a wedged VM."""
    gone = [t for t in b.tasks.values()
            if t.failed and not t.resized
            and t.last_heartbeat_age_s is not None
            and ("deemed dead" in t.reason
                 or t.last_heartbeat_age_s >= 1.0 and not t.hung
                 and not t.reason)]
    if not gone:
        return None
    blamed = min(gone, key=lambda t: t.failure_us or t.finished_ms * 1000
                 or float("inf"))
    ev = [f"events: TASK_FINISHED {t.task_id} after "
          f"{t.last_heartbeat_age_s:.1f}s of heartbeat silence "
          f"({t.reason or 'deemed dead'})" for t in gone[:5]]
    return Finding(
        INFRA_STORM, "executor-vanished",
        f"task {blamed.task_id}'s executor stopped heartbeating entirely "
        f"— host loss or network partition, not a user-code failure",
        blamed_task=blamed.task_id, confidence=0.8, evidence=ev,
        details={"vanished": sorted(t.task_id for t in gone)})


#: exception lines that mean the INFRASTRUCTURE failed under the user
#: process (transport resets, injected faults, rpc deadlines) — these
#: must not read as user bugs just because they arrived as a traceback.
_INFRA_EXC_RE = re.compile(
    r"^(.*\.)?(ConnectionError|ConnectionResetError|ConnectionRefusedError|"
    r"BrokenPipeError|TimeoutError|InjectedFault|RpcTimeout|RpcError|"
    r"OSError|socket\.gaierror|ssl\.SSLError)\b")


@_rule("infra-traceback", INFRA_STORM, ("TASK_FINISHED",))
def _infra_traceback(b: IncidentBundle) -> Optional[Finding]:
    hits = []
    for t in b.tasks.values():
        if not t.failed or not t.traceback:
            continue
        last = _final_exception_line(t.traceback)
        if last and _INFRA_EXC_RE.match(last):
            hits.append((t, last))
    if not hits:
        return None
    hits.sort(key=lambda x: x[0].failure_us or x[0].finished_ms * 1000)
    blamed, line = hits[0]
    ev = [f"traceback {t.task_id}: {ln[:200]}" for t, ln in hits[:5]]
    if b.verdicts:
        ev.append(f"journal: {len(b.verdicts)} epoch verdict(s): "
                  + ", ".join(str(v.get("domain")) for v in b.verdicts))
    return Finding(
        INFRA_STORM, "infra-traceback",
        f"{len(hits)} task(s) died on infrastructure-shaped exceptions "
        f"(transport/storage/timeout) — an infra storm, even where the "
        f"exit code was classified USER_ERROR",
        blamed_task=blamed.task_id, confidence=0.75, evidence=ev)


@_rule("retry-budget-exhausted", INFRA_STORM, ("APPLICATION_FINISHED",))
def _retry_exhausted(b: IncidentBundle) -> Optional[Finding]:
    infra = [v for v in b.verdicts
             if v.get("domain") == "INFRA_TRANSIENT"]
    if len(infra) < 2:
        return None
    reasons = [str(v.get("reason", ""))[:120] for v in infra]
    return Finding(
        INFRA_STORM, "retry-budget-exhausted",
        f"{len(infra)} consecutive epochs failed INFRA_TRANSIENT — "
        f"repeated transient failures exhausted the retry budget",
        blamed_task=_blame(b), confidence=0.7,
        evidence=[f"journal verdict epoch {v.get('session')}: "
                  f"{r}" for v, r in zip(infra, reasons)])


@_rule("user-traceback", USER_TRACEBACK, ("TASK_FINISHED",))
def _user_traceback(b: IncidentBundle) -> Optional[Finding]:
    candidates = []
    for t in b.tasks.values():
        if not t.failed or not t.traceback:
            continue
        last = _final_exception_line(t.traceback)
        if last and _INFRA_EXC_RE.match(last):
            continue            # infra-shaped: the storm rule owns it
        candidates.append((t, last or "?"))
    if not candidates:
        # Domain says user error but no traceback was captured: still a
        # user verdict, with the exit code as the only evidence.
        plain = [t for t in b.tasks.values()
                 if t.failed and t.failure_domain == "USER_ERROR"]
        if not plain:
            return None
        t = min(plain, key=lambda x: x.failure_us or x.finished_ms * 1000
                or float("inf"))
        return Finding(
            USER_TRACEBACK, "user-traceback",
            f"task {t.task_id} exited "
            f"{t.exit_detail or describe_exit(t.exit_code)} "
            f"(USER_ERROR) — no traceback captured in its log tail",
            blamed_task=t.task_id, confidence=0.5,
            evidence=[f"events: TASK_FINISHED {t.task_id} "
                      f"exit={t.exit_code} domain=USER_ERROR"])
    candidates.sort(key=lambda x: x[0].failure_us
                    or x[0].finished_ms * 1000)
    t, last = candidates[0]
    return Finding(
        USER_TRACEBACK, "user-traceback",
        f"task {t.task_id} crashed in user code: {last[:160]}",
        blamed_task=t.task_id, confidence=0.9,
        evidence=[f"traceback {t.task_id}: {last[:200]}",
                  f"events: TASK_FINISHED {t.task_id} exit={t.exit_code} "
                  f"domain={t.failure_domain or '?'}"],
        details={"exception": last})


def _alerts_still_firing(b: IncidentBundle) -> Dict[str, dict]:
    """Alert rules whose final journaled state in the event stream is
    firing: more ALERT_FIRING than ALERT_RESOLVED emissions (the state
    machine strictly alternates them per rule), payload of the last
    firing kept as the evidence."""
    fired: Dict[str, List[dict]] = {}
    for e in b.events_of("ALERT_FIRING"):
        fired.setdefault(str(e.payload.get("rule", "")),
                         []).append(e.payload)
    for e in b.events_of("ALERT_RESOLVED"):
        rule = str(e.payload.get("rule", ""))
        if fired.get(rule):
            fired[rule].pop(0)
    return {rule: payloads[-1]
            for rule, payloads in fired.items() if payloads}


@_rule("slo-breach", SLO_BREACH, ("ALERT_FIRING", "ALERT_RESOLVED"))
def _slo_breach(b: IncidentBundle) -> Optional[Finding]:
    """The alert engine saw the job breach an SLO before the terminal
    verdict and the alert never resolved. Structural rules outrank
    this; it carries the diagnosis alone only when nothing else
    matched (e.g. the job was killed by the operator mid-breach)."""
    firing = _alerts_still_firing(b)
    if not firing:
        return None
    worst = sorted(firing.items(), key=lambda kv: (
        0 if kv[1].get("severity") == "page" else 1, kv[0]))[0]
    ev = [f"events: ALERT_FIRING {rule} [{p.get('severity', '?')}] "
          f"value={p.get('value')} — never resolved"
          for rule, p in sorted(firing.items())]
    if worst[1].get("summary"):
        ev.append(f"alert summary: {worst[1]['summary']}")
    return Finding(
        SLO_BREACH, "slo-breach",
        f"alert {worst[0]!r} was firing when the job ended and never "
        f"resolved — the SLO broke before the terminal verdict",
        blamed_task=_blame(b), confidence=0.6, evidence=ev,
        details={"rules": sorted(firing)})


@_rule("unknown", UNKNOWN, ("APPLICATION_FINISHED",))
def _unknown(b: IncidentBundle) -> Optional[Finding]:
    """Fallback: a non-SUCCEEDED job always gets at least this."""
    ev = []
    if b.failure_reason:
        ev.append(f"failure_reason: {b.failure_reason}")
    t = b.first_failed_task()
    if t is not None:
        ev.append(f"first failed task: {t.task_id} "
                  f"{t.exit_detail or describe_exit(t.exit_code)}")
    return Finding(
        UNKNOWN, "unknown",
        "no rule matched — see the timeline and raw evidence",
        blamed_task=_blame(b), confidence=0.1, evidence=ev)


def _final_exception_line(traceback_text: str) -> str:
    """Last unindented 'ExcName: message' line of a traceback block."""
    for line in reversed(traceback_text.splitlines()):
        if line and line[0] not in (" ", "\t") \
                and not line.startswith("Traceback"):
            return line.strip()
    return ""


# -- engine ----------------------------------------------------------------
#: default-pack alert rule → the failure category it corroborates. An
#: alert left firing at job end is a precedence-boosted input: the
#: matching structural finding gains confidence and cites the alert.
_ALERT_CATEGORY = {
    "heartbeat-age": INFRA_STORM,    # executor silence precedes vanish
    "step-time-slo": HANG,           # step rate collapsed first
    "input-bound": STRAGGLER_CASCADE,
    "journal-fsync-p99": INFRA_STORM,
}


def run_rules(bundle: IncidentBundle) -> List[Finding]:
    """All findings, verdict-candidate first (category precedence, then
    confidence). Rules never raise out of the engine — a broken rule
    downgrades to absent, it cannot take the whole diagnosis down.

    Post-pass: alerts left firing at job end (``_alerts_still_firing``)
    boost the confidence of findings in the category the alert
    corroborates — the live SLO engine saw the breach develop BEFORE
    the terminal verdict, which is stronger than post-hoc log shape."""
    import logging

    findings: List[Finding] = []
    for rule in RULES:
        try:
            f = rule.fn(bundle)
        except Exception:  # noqa: BLE001 — diagnosis must degrade, not die
            logging.getLogger(__name__).exception(
                "diagnosis rule %s failed", rule.name)
            continue
        if f is not None:
            findings.append(f)
    try:
        firing = _alerts_still_firing(bundle)
    except Exception:  # noqa: BLE001 — same degrade contract as rules
        logging.getLogger(__name__).exception(
            "alert-evidence post-pass failed")
        firing = {}
    for f in findings:
        corroborating = sorted(
            rule for rule in firing
            if _ALERT_CATEGORY.get(rule) == f.category)
        if corroborating and f.category != SLO_BREACH:
            f.confidence = min(0.99, f.confidence + 0.1)
            f.evidence.append(
                f"alerts: {corroborating} firing before the terminal "
                f"verdict (corroborating — see `tony-tpu alerts`)")
    prec = {c: i for i, c in enumerate(CATEGORY_PRECEDENCE)}
    findings.sort(key=lambda f: (prec.get(f.category, len(prec)),
                                 -f.confidence))
    return findings


def verdict_of(findings: List[Finding]) -> Finding:
    return findings[0] if findings else Finding(
        UNKNOWN, "none", "no findings", confidence=0.0)
