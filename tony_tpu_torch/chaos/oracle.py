"""The invariant ladder every chaos run must climb.

A schedule "passes" when all four rungs hold; each violated rung is a
recorded, replayable finding, not an exception — the runner keeps
sweeping and the artifact carries the violation list.

1. **Verdict** — the run ended SUCCEEDED, or terminal with a failure
   domain the injections can legitimately cause. Every chaos injection
   is infrastructure (transport, disk, host, scheduler), so a terminal
   USER_ERROR is ALWAYS a ladder violation: it means an injected infra
   fault was mis-attributed to the user's code.
2. **Artifacts** — ``tony-tpu check`` (devtools/invariants.py) over the
   run's tree is clean: journals replayable, write-ahead brackets
   paired, no half-applied topology on disk.
3. **Orphans** — no live process carries the run's ``TONY_APP_ID``
   environment marker (mirrors tests/procwatch.py; the chaos CLI cannot
   import the test tree).
4. **Gates** — the lock sanitizer and race detector, when armed, report
   nothing new for the run's duration.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

#: failure domains an infra-only storm may legitimately produce
ALLOWED_TERMINAL_DOMAINS = ("INFRA_TRANSIENT", "PREEMPTION")


@dataclass
class Violation:
    rung: str           # verdict | artifacts | orphans | gates
    detail: str

    def as_dict(self) -> dict:
        return {"rung": self.rung, "detail": self.detail}


@dataclass
class GateSnapshot:
    """Sanitizer/race counters BEFORE the run; the post-run check
    reports only what the run itself added."""

    hazards: int = 0
    races: int = 0


@dataclass
class Outcome:
    status: str = ""                      # SUCCEEDED | FAILED | KILLED
    failure_domain: str = ""
    detail: str = ""
    violations: List[Violation] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def as_dict(self) -> dict:
        return {"status": self.status,
                "failure_domain": self.failure_domain,
                "detail": self.detail,
                "ok": self.ok,
                "violations": [v.as_dict() for v in self.violations]}


def snapshot_gates() -> GateSnapshot:
    snap = GateSnapshot()
    try:
        from tony_tpu_torch.devtools import race, sanitizer
        if sanitizer.enabled():
            snap.hazards = len(sanitizer.state().hazards)
        if race.enabled():
            snap.races = len(race.state().races)
    except Exception:  # noqa: BLE001 — the gates are optional equipment
        pass
    return snap


def check_verdict(status: str, failure_domain: str,
                  violations: List[Violation]) -> None:
    if status == "SUCCEEDED":
        return
    if status in ("FAILED", "KILLED"):
        if failure_domain in ALLOWED_TERMINAL_DOMAINS:
            return
        violations.append(Violation(
            "verdict",
            f"terminal {status} attributed to "
            f"{failure_domain or '<none>'} — an infra-only storm may "
            f"only end in {ALLOWED_TERMINAL_DOMAINS}"))
        return
    violations.append(Violation(
        "verdict", f"run ended non-terminal in state {status!r}"))


def check_artifacts(root: str, violations: List[Violation]) -> None:
    from tony_tpu_torch.devtools import invariants

    try:
        reports = invariants.check_tree(root)
    except Exception as e:  # noqa: BLE001 — a crashed checker IS a finding
        violations.append(Violation("artifacts", f"checker crashed: {e}"))
        return
    for rep in reports:
        if not rep.ok:
            violations.append(Violation(
                "artifacts", invariants.render_text([rep]).strip()))


def _live_pids_with_env(needle: str) -> List[Tuple[int, str]]:
    """(pid, cmdline) of live processes whose environment carries
    ``needle``. Skips self and unreadable entries. (Mirror of
    tests/procwatch.py — the package cannot import the test tree.)"""
    needle_b = needle.encode()
    me = os.getpid()
    out: List[Tuple[int, str]] = []
    try:
        entries = os.listdir("/proc")
    except OSError:
        return out
    for entry in entries:
        if not entry.isdigit() or int(entry) == me:
            continue
        try:
            with open(f"/proc/{entry}/environ", "rb") as f:
                env = f.read()
            if needle_b not in env:
                continue
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(
                    "utf-8", "replace").strip()
        except OSError:
            continue
        out.append((int(entry), cmd))
    return out


def check_orphans(app_id: str, violations: List[Violation],
                  timeout_s: float = 5.0) -> None:
    needle = f"TONY_APP_ID={app_id}"
    deadline = time.monotonic() + timeout_s
    survivors = _live_pids_with_env(needle)
    while survivors and time.monotonic() < deadline:
        time.sleep(0.2)
        survivors = _live_pids_with_env(needle)
    for pid, cmd in survivors:
        violations.append(Violation(
            "orphans", f"pid {pid} survived teardown with {needle}: "
                       f"{cmd}"))


def check_gates(before: Optional[GateSnapshot],
                violations: List[Violation]) -> None:
    if before is None:
        return
    try:
        from tony_tpu_torch.devtools import race, sanitizer
    except Exception:  # noqa: BLE001
        return
    try:
        if sanitizer.enabled():
            new = sanitizer.state().hazards[before.hazards:]
            for h in new:
                violations.append(Violation(
                    "gates", f"lock hazard: {h.get('kind', '?')} at "
                             f"{h.get('site', '?')}"))
        if race.enabled():
            new_races = race.state().races[before.races:]
            for r in new_races:
                violations.append(Violation(
                    "gates", f"data race on {r.get('field', '?')} at "
                             f"{r.get('site', '?')}"))
    except Exception:  # noqa: BLE001
        pass
