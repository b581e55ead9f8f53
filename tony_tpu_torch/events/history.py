"""History file naming, layout, parsing, moving and purging.

Reference model:
- filename grammar ``<appId>-<started>[-<completed>]-<user>[-<STATUS>].jhist``
  (``util/HistoryFileUtils.java:12-31``, parse ``util/ParserUtils.java:67-98``);
- directory layout ``<history>/intermediate/<appId>/`` while running, moved to
  ``<history>/finished/yyyy/MM/dd/<appId>/`` by a background mover every 5 min
  (``tony-portal/.../HistoryFileMover.java:74-121``), retention-deleted by a
  purger (``HistoryFilePurger.java:53-107``);
- job metadata synthesized from the filename (``models/JobMetadata.java``).
"""

from __future__ import annotations

import dataclasses
import os
import re
import shutil
import time
from typing import Dict, List, Optional

from tony_tpu_torch import constants

_HIST_RE = re.compile(
    r"^(?P<app>[A-Za-z0-9_]+)-(?P<start>\d+)(?:-(?P<end>\d+))?-(?P<user>[^-]+)"
    r"(?:-(?P<status>[A-Z]+))?" + re.escape(constants.EVENTS_SUFFIX) + r"$")


@dataclasses.dataclass
class JobMetadata:
    """Reference ``models/JobMetadata.java`` (143 LoC)."""

    app_id: str
    started_ms: int
    completed_ms: int
    user: str
    status: str

    @property
    def finished(self) -> bool:
        return self.completed_ms > 0


def in_progress_name(app_id: str, started_ms: int, user: str) -> str:
    return f"{app_id}-{started_ms}-{user}{constants.INPROGRESS_SUFFIX}"


def final_name(app_id: str, started_ms: int, completed_ms: int, user: str,
               status: str) -> str:
    """Reference ``HistoryFileUtils.generateFileName`` :12-31."""
    return (f"{app_id}-{started_ms}-{completed_ms}-{user}-{status}"
            f"{constants.EVENTS_SUFFIX}")


def parse_metadata(filename: str) -> Optional[JobMetadata]:
    """Parse filename metadata (reference ``ParserUtils.parseMetadata`` :67-98)."""
    m = _HIST_RE.match(os.path.basename(filename))
    if not m:
        return None
    return JobMetadata(
        app_id=m.group("app"),
        started_ms=int(m.group("start")),
        completed_ms=int(m.group("end") or 0),
        user=m.group("user"),
        status=m.group("status") or "RUNNING",
    )


def date_partition(ms: int) -> str:
    """yyyy/MM/dd partition dir (reference ``ParserUtils.getYearMonthDayDirectory``
    :307)."""
    t = time.gmtime(ms / 1000.0)
    return os.path.join(f"{t.tm_year:04d}", f"{t.tm_mon:02d}", f"{t.tm_mday:02d}")


def intermediate_dir(history_root: str, app_id: str) -> str:
    return os.path.join(history_root, constants.HISTORY_INTERMEDIATE, app_id)


def find_history_file(job_dir: str) -> Optional[str]:
    """Latest event file in a job dir (reference ``ParserUtils`` :100)."""
    if not os.path.isdir(job_dir):
        return None
    candidates = [f for f in os.listdir(job_dir)
                  if f.endswith(constants.EVENTS_SUFFIX)]
    if not candidates:
        return None
    return os.path.join(job_dir, sorted(candidates)[-1])


def list_job_dirs(history_root: str) -> Dict[str, str]:
    """app_id → job dir, across intermediate and finished trees."""
    out: Dict[str, str] = {}
    inter = os.path.join(history_root, constants.HISTORY_INTERMEDIATE)
    if os.path.isdir(inter):
        for app in os.listdir(inter):
            out[app] = os.path.join(inter, app)
    fin = os.path.join(history_root, constants.HISTORY_FINISHED)
    for root, dirs, _files in os.walk(fin):
        depth = os.path.relpath(root, fin).count(os.sep)
        if depth == 2:  # root == finished/yyyy/MM/dd → its dirs are app ids
            for app in list(dirs):
                out[app] = os.path.join(root, app)
            dirs.clear()
    return out


@dataclasses.dataclass
class JobRow:
    """One row of the jobs index (portal jobs view / CLI history)."""

    app_id: str
    status: str
    user: str
    started_ms: int

    @property
    def started_iso(self) -> str:
        return time.strftime("%Y-%m-%d %H:%M:%S",
                             time.gmtime(self.started_ms / 1000.0))


def list_jobs(history_root: str) -> List[JobRow]:
    """Jobs index across intermediate + finished trees, newest first."""
    rows: List[JobRow] = []
    for app, job_dir in list_job_dirs(history_root).items():
        hist = find_history_file(job_dir)
        meta = parse_metadata(hist) if hist else None
        if meta is None:
            # Fall back to the in-progress file for running jobs.
            for f in os.listdir(job_dir):
                if f.endswith(constants.INPROGRESS_SUFFIX):
                    meta = parse_metadata(
                        f[: -len(constants.INPROGRESS_SUFFIX)]
                        + constants.EVENTS_SUFFIX)
                    break
        if meta is None:
            continue
        rows.append(JobRow(app_id=app, status=meta.status, user=meta.user,
                           started_ms=meta.started_ms))
    rows.sort(key=lambda r: -r.started_ms)
    return rows


def read_job_events(history_root: str, app_id: str):
    """Decoded event list for one job, or None if unknown
    (reference ``ParserUtils.parseEvents`` :258-287)."""
    from tony_tpu_torch.events.events import read_events

    job_dir = list_job_dirs(history_root).get(app_id)
    if job_dir is None:
        return None
    hist = find_history_file(job_dir)
    if hist is None:
        for f in os.listdir(job_dir):
            if f.endswith(constants.INPROGRESS_SUFFIX):
                hist = os.path.join(job_dir, f)
                break
    if hist is None:
        return None
    return read_events(hist)


class HistoryFileMover:
    """Move completed jobs intermediate → finished/yyyy/MM/dd
    (reference ``HistoryFileMover.java:74-121``; KILLED-rename behaviour for
    jobs whose coordinator died before finalizing)."""

    def __init__(self, history_root: str):
        self.root = history_root

    def move_once(self) -> List[str]:
        moved = []
        inter = os.path.join(self.root, constants.HISTORY_INTERMEDIATE)
        if not os.path.isdir(inter):
            return moved
        for app in os.listdir(inter):
            job_dir = os.path.join(inter, app)
            hist = find_history_file(job_dir)
            if hist is None:
                # Coordinator died without finalizing: finalize as KILLED
                # (reference HistoryFileMover.java in-progress rename).
                for f in os.listdir(job_dir):
                    if f.endswith(constants.INPROGRESS_SUFFIX):
                        meta_part = f[: -len(constants.INPROGRESS_SUFFIX)]
                        m = re.match(r"^(.+)-(\d+)-([^-]+)$", meta_part)
                        if not m:
                            continue
                        killed = final_name(m.group(1), int(m.group(2)),
                                            int(time.time() * 1000),
                                            m.group(3), "KILLED")
                        from tony_tpu_torch.utils.durable import durable_replace
                        durable_replace(os.path.join(job_dir, f),
                                        os.path.join(job_dir, killed))
                        hist = os.path.join(job_dir, killed)
                if hist is None:
                    continue
            meta = parse_metadata(hist)
            when = meta.completed_ms if meta and meta.completed_ms else int(
                time.time() * 1000)
            dest = os.path.join(self.root, constants.HISTORY_FINISHED,
                                date_partition(when), app)
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            shutil.move(job_dir, dest)
            moved.append(dest)
        return moved


class HistoryFilePurger:
    """Delete finished history older than retention
    (reference ``HistoryFilePurger.java:53-107``)."""

    def __init__(self, history_root: str, retention_days: int):
        self.root = history_root
        self.retention_days = retention_days

    def purge_once(self, now_ms: Optional[int] = None) -> List[str]:
        now_ms = now_ms or int(time.time() * 1000)
        cutoff = now_ms - self.retention_days * 86400 * 1000
        purged = []
        for app, job_dir in list_job_dirs(self.root).items():
            if constants.HISTORY_INTERMEDIATE in job_dir.split(os.sep):
                continue
            hist = find_history_file(job_dir)
            meta = parse_metadata(hist) if hist else None
            when = meta.completed_ms if meta and meta.completed_ms else 0
            if when and when < cutoff:
                shutil.rmtree(job_dir, ignore_errors=True)
                purged.append(app)
        return purged
