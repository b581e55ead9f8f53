"""Flight recorder + automatic failure diagnosis.

The capstone of the robustness/observability PRs: every raw signal the
control plane records — failure-domain events, the session journal, hang
verdicts with stack dumps, the span tree, the metrics ring — correlated
into one answer to the operator's actual question, "why did my job die
and which task started it".

Pipeline: ``collector.collect`` reads the job dir into an
``IncidentBundle`` → ``rules.run_rules`` emits evidence-backed findings
→ ``report.build_incident`` folds them into the ``incident.json``
document, rendered by ``report.render_text`` (CLI) and
``report.render_html`` (portal). The coordinator runs this automatically
on every non-SUCCEEDED finish and emits JOB_DIAGNOSED; ``tony-tpu
diagnose`` and the portal's ``/diagnose/<app>`` run it post-hoc on any
history dir (live jobs get a provisional read).
"""

from __future__ import annotations

from typing import Any, Dict

from tony_tpu_torch.diagnosis.collector import (IncidentBundle,  # noqa: F401
                                          TaskIncident, collect)
from tony_tpu_torch.diagnosis.exitcodes import (describe_exit,  # noqa: F401
                                          exit_signal)
from tony_tpu_torch.diagnosis.report import (build_incident,  # noqa: F401
                                       load_incident, render_html,
                                       render_text, save_incident)
from tony_tpu_torch.diagnosis.rules import (CATEGORY_PRECEDENCE,  # noqa: F401
                                      RULES, Finding, run_rules,
                                      verdict_of)


def diagnose_job_dir(job_dir: str, app_id: str = "",
                     tail_bytes: int = 64 * 1024,
                     provisional: bool = False) -> Dict[str, Any]:
    """Collect + rule + report in one call: the incident document for a
    job dir (post-hoc on finished jobs, provisional on live ones)."""
    bundle = collect(job_dir, app_id=app_id, tail_bytes=tail_bytes)
    findings = run_rules(bundle)
    return build_incident(bundle, findings, provisional=provisional)
