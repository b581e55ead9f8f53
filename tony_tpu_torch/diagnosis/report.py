"""Incident document: build, persist, and render the diagnosis.

``build_incident`` folds the bundle + findings into ONE json-able dict —
``incident.json`` in the job dir, written atomically (a reader sees the
whole document or none of it; ``load_incident`` additionally tolerates a
torn/partial file by returning None, the same degrade-to-absent contract
as ``read_events``). The renderers produce the CLI text report
(``tony-tpu diagnose``) and the portal's ``/diagnose/<app>`` HTML body
from the same document, so every surface tells the same story.
"""

from __future__ import annotations

import html as html_mod
import json
import time
from typing import Any, Dict, List, Optional

from tony_tpu_torch.diagnosis.collector import IncidentBundle
from tony_tpu_torch.diagnosis.exitcodes import describe_exit
from tony_tpu_torch.diagnosis.rules import Finding

#: schema version stamped into every incident.json — bump on breaking
#: shape changes so downstream tooling can gate.
INCIDENT_SCHEMA = 1

#: timeline length cap: a 512-task gang's full event stream is the
#: events view's job; the timeline is the curated causal read.
_TIMELINE_MAX = 120


def build_timeline(bundle: IncidentBundle) -> List[Dict[str, Any]]:
    """Causal timeline: lifecycle + incident events from the jhist
    stream merged with the journal's epoch/verdict/generation records,
    sorted on the shared ms clock."""
    out: List[Dict[str, Any]] = []
    for ev in bundle.events:
        if ev.type in ("TASK_STARTED",) and len(bundle.tasks) > 8:
            continue            # big gangs: starts drown the signal
        p = ev.payload
        detail = ""
        if ev.type == "TASK_STARTED":
            detail = str(p.get("task", ""))
        elif ev.type == "TASK_FINISHED":
            detail = (f"{p.get('task', '')} "
                      f"{p.get('exit_detail') or describe_exit(p.get('exit_code'))}"
                      f"{' domain=' + p['failure_domain'] if p.get('failure_domain') else ''}")
        elif ev.type == "TASK_HUNG":
            detail = (f"{p.get('task', '')} frozen at step "
                      f"{p.get('steps')} for {p.get('stalled_s')}s")
        elif ev.type == "TASK_STRAGGLER":
            detail = (f"{p.get('task', '')} "
                      f"{p.get('rate_steps_per_s')} steps/s vs median "
                      f"{p.get('median_steps_per_s')}")
        elif ev.type == "COORDINATOR_RECOVERED":
            detail = f"generation {p.get('generation')}"
        elif ev.type == "APPLICATION_FINISHED":
            detail = str(p.get("status", ""))
            if p.get("failure_reason"):
                detail += f": {p['failure_reason']}"
        elif ev.type == "JOB_DIAGNOSED":
            detail = (f"{p.get('category', '')} "
                      f"blamed={p.get('blamed_task', '')}")
        elif ev.type == "APPLICATION_INITED":
            detail = str(p.get("app_id", ""))
        else:
            detail = str(p.get("task", "") or "")
        out.append({"ts_ms": ev.timestamp_ms, "what": ev.type,
                    "detail": detail.strip()})
    for rec in bundle.epochs:
        out.append({"ts_ms": int(rec.get("ts", 0) or 0),
                    "what": "SESSION_EPOCH",
                    "detail": f"epoch {rec.get('session')} started "
                              f"(transient retries used "
                              f"{rec.get('infra_used')})"})
    for rec in bundle.verdicts:
        out.append({"ts_ms": int(rec.get("ts", 0) or 0),
                    "what": "EPOCH_VERDICT",
                    "detail": f"epoch {rec.get('session')} failed "
                              f"[{rec.get('domain')}] "
                              f"{str(rec.get('reason', ''))[:160]}"})
    out.sort(key=lambda r: r["ts_ms"])
    if len(out) > _TIMELINE_MAX:
        # Keep the head (launch) and tail (death) — the middle of a long
        # steady run is the least diagnostic part.
        keep = _TIMELINE_MAX // 2
        out = out[:keep] + [{"ts_ms": out[keep]["ts_ms"],
                             "what": "...",
                             "detail": f"{len(out) - 2 * keep} entries "
                                       f"elided"}] + out[-keep:]
    return out


def _perf_advisory(perf: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Condense <job_dir>/perf.json into the incident's perf advisory:
    the bottleneck verdict + phase fractions. Orthogonal to the failure
    verdict by design — 'the job died of X, and while it ran it was
    INPUT_BOUND' are two different answers an operator wants together.
    None when the job recorded no step-time attribution."""
    if not perf or not isinstance(perf.get("verdict"), dict):
        return None
    v = perf["verdict"]
    return {
        "verdict": v.get("category", ""),
        "summary": v.get("summary", ""),
        "confidence": v.get("confidence", 0.0),
        "evidence": list(v.get("evidence") or []),
        "fractions": dict(perf.get("fractions") or {}),
        "wall_s": perf.get("wall_s"),
        "steps": perf.get("steps"),
    }


def build_incident(bundle: IncidentBundle, findings: List[Finding],
                   provisional: bool = False) -> Dict[str, Any]:
    verdict = findings[0] if findings else None
    blamed_id = verdict.blamed_task if verdict else ""
    blamed = bundle.tasks.get(blamed_id)
    doc: Dict[str, Any] = {
        "schema": INCIDENT_SCHEMA,
        "app_id": bundle.app_id,
        "generated_ms": int(time.time() * 1000),
        "provisional": bool(provisional or bundle.live),
        "status": bundle.status or ("RUNNING" if bundle.live else ""),
        "failure_reason": bundle.failure_reason,
        "failure_domain": bundle.failure_domain,
        "verdict": verdict.to_dict() if verdict else None,
        "findings": [f.to_dict() for f in findings],
        "blamed_task": None,
        "timeline": build_timeline(bundle),
        "tasks": {
            tid: {"status": t.status, "exit_code": t.exit_code,
                  "exit_detail": t.exit_detail
                  or describe_exit(t.exit_code),
                  "failure_domain": t.failure_domain,
                  "finished_ms": t.finished_ms,
                  "has_traceback": bool(t.traceback),
                  "has_stack_dump": bool(t.stack_dump)}
            for tid, t in sorted(bundle.tasks.items())},
        "perf": _perf_advisory(bundle.perf),
        "bundle": {"events": len(bundle.events),
                   "journal_records": len(bundle.journal),
                   "spans": len(bundle.spans),
                   "log_tails": len(bundle.log_tails),
                   "epochs": len(bundle.epochs),
                   "generations": bundle.generations,
                   "config_keys": len(bundle.config)},
        "config": bundle.config,
    }
    if blamed is not None:
        doc["blamed_task"] = {
            "task": blamed.task_id,
            "status": blamed.status,
            "exit_code": blamed.exit_code,
            "exit_detail": blamed.exit_detail
            or describe_exit(blamed.exit_code),
            "failure_domain": blamed.failure_domain,
            "reason": blamed.reason,
            "last_heartbeat_age_s": blamed.last_heartbeat_age_s,
            "progress": blamed.progress,
            "traceback": blamed.traceback,
            "stack_dump": blamed.stack_dump,
            "logs": blamed.logs,
        }
    return doc


# -- persistence -----------------------------------------------------------
def save_incident(path: str, incident: Dict[str, Any]) -> None:
    """Atomic replace (utils/durable.py): a scraper mid-crash sees the
    previous whole document or the new one, never a torn mix."""
    from tony_tpu_torch.utils.durable import atomic_write

    atomic_write(path, json.dumps(incident, indent=1,
                                  sort_keys=True).encode("utf-8"))


def load_incident(path: str) -> Optional[Dict[str, Any]]:
    """Decoded incident.json, or None when absent/torn/not-an-object —
    callers recompute from the bundle instead of tracebacking over a
    half-written artifact."""
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


# -- renderers -------------------------------------------------------------
def render_text(incident: Dict[str, Any]) -> str:
    """The `tony-tpu diagnose` report. Leads with the verdict; the
    blamed task's traceback is printed VERBATIM (operators paste it into
    the bug report; a paraphrase would be worse than useless)."""
    v = incident.get("verdict") or {}
    lines = [
        f"incident report — {incident.get('app_id', '?')}"
        + ("  [PROVISIONAL — job still running]"
           if incident.get("provisional") else ""),
        f"status:      {incident.get('status', '?')}",
    ]
    if incident.get("failure_reason"):
        lines.append(f"reason:      {incident['failure_reason']}")
    if incident.get("failure_domain"):
        lines.append(f"domain:      {incident['failure_domain']}")
    lines += [
        "",
        f"verdict:     {v.get('category', 'UNKNOWN')} "
        f"(confidence {v.get('confidence', 0):.0%}, rule "
        f"{v.get('rule', '?')})",
        f"blamed task: {v.get('blamed_task') or '(none)'}",
        f"summary:     {v.get('summary', '')}",
    ]
    if v.get("evidence"):
        lines.append("")
        lines.append("evidence:")
        lines += [f"  - {e}" for e in v["evidence"]]
    others = [f for f in incident.get("findings", [])[1:]
              if f.get("category") != "UNKNOWN"]
    if others:
        lines.append("")
        lines.append("other findings:")
        lines += [f"  - [{f.get('category')}] {f.get('summary', '')}"
                  for f in others]
    perf = incident.get("perf") or {}
    if perf.get("verdict"):
        fr = perf.get("fractions") or {}
        frac_line = "  ".join(
            f"{k}={v:.0%}" for k, v in sorted(fr.items(), key=lambda kv:
                                              -kv[1]))
        lines += ["",
                  f"perf advisory: {perf['verdict']} — "
                  f"{perf.get('summary', '')}",
                  f"  step-time attribution: {frac_line}"]
        lines += [f"  - {e}" for e in perf.get("evidence", [])]
    blamed = incident.get("blamed_task") or {}
    if blamed.get("traceback"):
        lines += ["", f"--- user traceback ({blamed.get('task')}) ---",
                  blamed["traceback"].rstrip()]
    if blamed.get("stack_dump"):
        lines += ["", f"--- stack dump excerpt ({blamed.get('task')}) ---",
                  blamed["stack_dump"].rstrip()]
    timeline = incident.get("timeline", [])
    if timeline:
        lines += ["", "timeline:"]
        t0 = timeline[0]["ts_ms"] or 0
        for row in timeline:
            dt = (row["ts_ms"] - t0) / 1000.0 if row["ts_ms"] else 0.0
            lines.append(f"  +{dt:9.3f}s  {row['what']:<22} "
                         f"{row['detail']}")
    b = incident.get("bundle", {})
    lines += ["", f"bundle: {b.get('events', 0)} events, "
                  f"{b.get('journal_records', 0)} journal records, "
                  f"{b.get('spans', 0)} spans, "
                  f"{b.get('log_tails', 0)} log tails"]
    return "\n".join(lines)


def render_html(incident: Dict[str, Any]) -> str:
    """Portal /diagnose/<app> body (the surrounding page shell is the
    portal's)."""
    esc = html_mod.escape
    v = incident.get("verdict") or {}
    parts = [f"<h1>diagnosis — {esc(str(incident.get('app_id', '?')))}"
             f"</h1>"]
    if incident.get("provisional"):
        parts.append("<p><b>PROVISIONAL</b> — the job is still running; "
                     "this is a live read, not the final verdict.</p>")
    parts.append(
        f"<p><b>{esc(str(v.get('category', 'UNKNOWN')))}</b> "
        f"(confidence {float(v.get('confidence', 0)):.0%}) — "
        f"blamed task <code>{esc(str(v.get('blamed_task') or '-'))}"
        f"</code><br>{esc(str(v.get('summary', '')))}</p>")
    if incident.get("failure_reason"):
        parts.append(f"<p>status {esc(str(incident.get('status', '')))} — "
                     f"{esc(str(incident['failure_reason']))}</p>")
    if v.get("evidence"):
        items = "".join(f"<li><code>{esc(str(e))}</code></li>"
                        for e in v["evidence"])
        parts.append(f"<h2>evidence</h2><ul>{items}</ul>")
    perf = incident.get("perf") or {}
    if perf.get("verdict"):
        fr = perf.get("fractions") or {}
        frac = "  ".join(f"{esc(str(k))}={float(v):.0%}"
                         for k, v in sorted(fr.items(),
                                            key=lambda kv: -kv[1]))
        parts.append(
            f"<h2>perf advisory</h2><p><b>{esc(str(perf['verdict']))}"
            f"</b> — {esc(str(perf.get('summary', '')))}<br>"
            f"<code>{frac}</code></p>")
    blamed = incident.get("blamed_task") or {}
    if blamed.get("traceback"):
        parts.append(f"<h2>user traceback — "
                     f"{esc(str(blamed.get('task')))}</h2>"
                     f"<pre>{esc(blamed['traceback'])}</pre>")
    if blamed.get("stack_dump"):
        parts.append(f"<h2>stack dump excerpt — "
                     f"{esc(str(blamed.get('task')))}</h2>"
                     f"<pre>{esc(blamed['stack_dump'])}</pre>")
    others = incident.get("findings", [])[1:]
    real_others = [f for f in others if f.get("category") != "UNKNOWN"]
    if real_others:
        items = "".join(
            f"<li><b>{esc(str(f.get('category')))}</b> "
            f"{esc(str(f.get('summary', '')))}</li>" for f in real_others)
        parts.append(f"<h2>other findings</h2><ul>{items}</ul>")
    timeline = incident.get("timeline", [])
    if timeline:
        t0 = timeline[0]["ts_ms"] or 0
        rows = "".join(
            f"<tr><td>+{(r['ts_ms'] - t0) / 1000.0 if r['ts_ms'] else 0:.3f}s"
            f"</td><td>{esc(str(r['what']))}</td>"
            f"<td>{esc(str(r['detail']))}</td></tr>" for r in timeline)
        parts.append(f"<h2>timeline</h2><table border=1 cellpadding=3>"
                     f"<tr><th>t</th><th>event</th><th>detail</th></tr>"
                     f"{rows}</table>")
    return "".join(parts)
