"""Process execution helpers (reference ``Utils.executeShell`` :294-323)."""

from __future__ import annotations

import logging
import os
import signal
import subprocess
import time
from typing import Callable, Dict, Optional

log = logging.getLogger(__name__)


def _group_has_live_member(pg: int) -> bool:
    """Any NON-ZOMBIE process left in group ``pg``? ``killpg(pg, 0)``
    alone cannot answer this: it succeeds while only zombies remain, and a
    TERM'd child whose parent hasn't reaped it yet IS a zombie — exactly
    the teardown window this function is called in (a coordinator killing
    an executor it owns polls nothing while it waits). Counting a
    zombie-only group as alive made every such kill burn its FULL grace
    window (measured: 15 s per failed-job teardown)."""
    try:
        entries = os.listdir("/proc")
    except OSError:
        return True     # no /proc: fall back to the killpg-only signal
    for entry in entries:
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                # "pid (comm) state ppid pgrp ..." — comm may hold spaces/
                # parens; split after the LAST ')'.
                rest = f.read().rsplit(")", 1)[1].split()
            if int(rest[2]) == pg and rest[0] != "Z":
                return True
        except (OSError, ValueError, IndexError):
            continue
    return False


def kill_process_groups(pgids, grace_s: float = 0.0) -> None:
    """TERM → grace → KILL for one or more process groups. The building
    block of the teardown contract (reference stops containers with grace,
    ``ApplicationMaster.java:694-711``, and YARN's NM then reaps the whole
    container tree — with no NM, supervisors here must do the reaping).

    Safe on already-dead groups (ProcessLookupError = nothing left) and on
    pgids we cannot signal (PermissionError = not ours, e.g. after a
    pid-reuse race — skip rather than kill a stranger). The grace wait
    ends when every group member is dead OR a zombie (see
    ``_group_has_live_member``)."""
    alive = set()
    for pg in pgids:
        if not pg or pg <= 0:
            continue
        try:
            os.killpg(pg, signal.SIGTERM)
            alive.add(pg)
        except (ProcessLookupError, PermissionError):
            pass
    deadline = time.monotonic() + grace_s
    zombie_only = set()
    while alive and time.monotonic() < deadline:
        for pg in list(alive):
            try:
                os.killpg(pg, 0)
            except (ProcessLookupError, PermissionError):
                alive.discard(pg)
                continue
            if not _group_has_live_member(pg):
                # Stop WAITING on it, but still include it in the KILL
                # pass below: the /proc snapshot races a fork during the
                # grace window, and SIGKILL on a truly zombie-only group
                # is a free no-op.
                alive.discard(pg)
                zombie_only.add(pg)
        if alive:
            time.sleep(0.05)
    for pg in alive | zombie_only:
        try:
            os.killpg(pg, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass


def read_pgid_file(path: str) -> int:
    """Process-group id from a pidfile (``user.pgid`` contract —
    constants.USER_PGID_FILE); 0 when absent/corrupt."""
    try:
        with open(path) as f:
            return int(f.read().strip() or 0)
    except (OSError, ValueError):
        return 0


def execute_shell(command: str, timeout_s: float = 0,
                  env: Optional[Dict[str, str]] = None,
                  cwd: Optional[str] = None,
                  on_start: Optional[Callable[[subprocess.Popen], None]] = None,
                  ) -> int:
    """Run a shell command, inheriting stdout/stderr (container logs pattern,
    ``ApplicationMaster.java:1145-1147``). Returns the exit code (128+N for
    death by signal N); a timeout kills the whole process group and returns
    137. The command runs in its OWN session/process group so a supervisor
    can signal the user tree without shooting itself — the group id (=child
    pid) is observable via ``on_start`` and must be reaped by the caller's
    teardown (see ``kill_process_groups``); any stragglers the command
    leaves in its group are reaped here after it exits.

    The reference unsets MALLOC_ARENA_MAX before exec (``Utils.java:312``) —
    a YARN-ism we do not need; we instead leave JAX/XLA env untouched so
    the user process sees exactly what the runtime exported.
    """
    full_env = dict(os.environ)
    if env:
        full_env.update(env)
    log.info("executing: %s", command)
    proc = subprocess.Popen(
        ["/bin/sh", "-c", command], env=full_env, cwd=cwd,
        start_new_session=True)
    if on_start:
        on_start(proc)
    try:
        rc = proc.wait(timeout=timeout_s or None)
        return 128 - rc if rc < 0 else rc
    except subprocess.TimeoutExpired:
        log.error("command timed out after %ss; killing process group",
                  timeout_s)
        kill_process_groups([proc.pid], grace_s=1.0)
        proc.wait()
        return 137
    finally:
        # The shell may have backgrounded children that survive its exit
        # (sh -c "serve.py &"); they share its group — reap them so no
        # user process outlives its supervisor. Free when the group is
        # already empty (first killpg raises ProcessLookupError).
        kill_process_groups([proc.pid], grace_s=0.5)


def poll_till_non_null(fn: Callable[[], Optional[object]],
                       interval_s: float = 3.0,
                       timeout_s: float = 0) -> Optional[object]:
    """Reference ``Utils.pollTillNonNull`` :91-145 — the executor's
    registration barrier poll."""
    deadline = time.monotonic() + timeout_s if timeout_s else None
    while True:
        result = fn()
        if result is not None:
            return result
        if deadline and time.monotonic() > deadline:
            return None
        time.sleep(interval_s)
