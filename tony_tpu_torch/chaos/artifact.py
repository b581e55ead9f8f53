"""Replayable run artifacts: one JSON file per executed schedule.

The artifact is the repro: it carries the (seed, index, suite) triple
the planner needs to regenerate the schedule bit-identically, the
planned injections (so `replay` can PROVE the regeneration matched
before trusting it), and the run's outcome + ladder violations. A
shrunk artifact additionally records the surviving injection subset
under ``shrunk_from`` provenance — the seed corpus checks these in.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from tony_tpu_torch.chaos.oracle import Outcome, Violation
from tony_tpu_torch.chaos.schedule import Injection, Schedule
from tony_tpu_torch.utils.durable import atomic_write

VERSION = 1


def artifact_path(outdir: str, schedule: Schedule) -> str:
    return os.path.join(outdir, f"{schedule.name}.json")


def save_artifact(outdir: str, schedule: Schedule, outcome: Outcome,
                  shrunk_from: Optional[dict] = None,
                  note: str = "") -> str:
    os.makedirs(outdir, exist_ok=True)
    doc = {
        "version": VERSION,
        "schedule": schedule.as_dict(),
        "outcome": outcome.as_dict(),
    }
    if shrunk_from:
        doc["shrunk_from"] = shrunk_from
    if note:
        doc["note"] = note
    path = artifact_path(outdir, schedule)
    atomic_write(path,
                 (json.dumps(doc, indent=2, sort_keys=True) + "\n").encode())
    return path


def load_artifact(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if doc.get("version") != VERSION:
        raise ValueError(f"unsupported chaos artifact version "
                         f"{doc.get('version')!r} in {path}")
    sched = doc.get("schedule") or {}
    for key in ("seed", "index", "suite"):
        if key not in sched:
            raise ValueError(f"chaos artifact {path} missing "
                             f"schedule.{key}")
    return doc


def schedule_from_doc(doc: dict) -> Schedule:
    """The schedule AS RECORDED (shrunk artifacts carry a subset the
    planner would never emit — replay must honour what actually ran)."""
    sched = doc["schedule"]
    return Schedule(
        seed=int(sched["seed"]), index=int(sched["index"]),
        suite=str(sched["suite"]),
        injections=[Injection(i["site"], i["spec"])
                    for i in sched.get("injections", [])])


def outcome_from_doc(doc: dict) -> Outcome:
    rec = doc.get("outcome") or {}
    out = Outcome(status=str(rec.get("status", "")),
                  failure_domain=str(rec.get("failure_domain", "")),
                  detail=str(rec.get("detail", "")))
    for v in rec.get("violations", []):
        out.violations.append(Violation(str(v.get("rung", "?")),
                                        str(v.get("detail", ""))))
    return out
