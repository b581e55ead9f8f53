"""Crash-durable file primitives shared by the session journal, the event
stream, and the frozen-config artifact.

A coordinator can be SIGKILLed between any two instructions (that is the
whole premise of ``--recover``), so every write that recovery or the
history portal later depends on must be one of exactly two shapes:

- **atomic replace**: write a temp file in the SAME directory, fsync it,
  ``os.replace`` over the target, fsync the directory — a reader sees
  either the old bytes or the new bytes, never a torn mix
  (``atomic_write``/``durable_replace``);
- **append-only log**: appended records are fsync'd before the caller
  proceeds, and the READER tolerates a torn final record (the crash
  window between ``write`` and ``fsync``) by degrading to
  replay-of-prefix (``AppendLog``; readers: journal.replay,
  events.read_events).

POSIX note: ``os.replace`` is atomic on the same filesystem but the
RENAME itself is only durable once the parent directory is fsync'd —
skipping that step is how "the rename happened but vanished after the
power cut" bugs are born.
"""

from __future__ import annotations

import errno
import logging
import os
from typing import IO, Optional

from tony_tpu_torch import faults

log = logging.getLogger(__name__)


class DurableWriteError(OSError):
    """A durable write (fsync'd append / atomic replace) FAILED — the
    bytes may not be on disk. ENOSPC/EIO on the write-ahead path must
    surface loudly (terminal INFRA verdict, daemon stop): proceeding as
    if the record landed is how recovery later resurrects state the
    rest of the cluster already saw retired. The committed prefix on
    disk stays intact — ``--recover`` replays it (readers tolerate a
    torn final record)."""

    def __init__(self, path: str, op: str, cause: BaseException) -> None:
        eno = cause.errno if isinstance(cause, OSError) and cause.errno \
            else errno.EIO
        super().__init__(eno, f"durable {op} failed for {path}: {cause}")
        self.path = path
        self.op = op


def fsync_dir(path: str) -> None:
    """fsync a DIRECTORY so renames/creates inside it survive a crash.
    Best-effort: some filesystems (and all of Windows) refuse O_RDONLY
    on directories — durability then degrades to the OS's own schedule,
    which is still no worse than the pre-helper behaviour."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write(path: str, data: bytes, mode: int = 0o644) -> None:
    """Atomically (re)place ``path`` with ``data``: temp file in the same
    directory → write → flush+fsync → rename → directory fsync.

    ``mode`` applies from the temp file's very first byte (no chmod-after
    window) — pass 0o600 for secret-bearing artifacts like the
    coordinator/pool address files, which carry the RPC auth token."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, f".{os.path.basename(path)}.tmp.{os.getpid()}")
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, mode)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        if faults.fire("disk.torn"):
            # The injected power-cut-at-rename shape: the temp file was
            # durable but the RENAME never landed — a reader still sees
            # the OLD bytes, and the caller must hear about it.
            raise OSError(errno.EIO, "injected torn rename (disk.torn)")
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    fsync_dir(d)


def durable_replace(src: str, dst: str) -> None:
    """``os.replace`` + directory fsync (same-directory renames like the
    in-progress → final history file flip)."""
    os.replace(src, dst)
    fsync_dir(os.path.dirname(os.path.abspath(dst)))


def fsync_path(path: str) -> None:
    """fsync an already-written file by path. For stream-written temp
    files (downloads, copies) promote with ``fsync_path(tmp)`` +
    ``durable_replace(tmp, dst)`` — the same two-fsync shape as
    ``atomic_write`` without buffering the payload in memory."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def fsync_file(f: IO) -> None:
    """flush + fsync an open file object; best-effort on exotic streams
    without a real descriptor (StringIO in tests)."""
    try:
        f.flush()
        os.fsync(f.fileno())
    except (OSError, ValueError, AttributeError):
        pass


class AppendLog:
    """fsync-per-append log file (the write-ahead journal's substrate).

    Every ``append`` returns only after the record is flushed AND
    fsync'd: a crash immediately after a state transition must find that
    transition on disk — otherwise replay resurrects pre-transition
    state and the recovered coordinator disagrees with the executors
    that already observed the transition over RPC.
    """

    def __init__(self, path: str) -> None:
        self.path = path
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        existed = os.path.exists(path)
        self._f: Optional[IO] = open(path, "ab")
        if not existed:
            # The file CREATION itself must survive a crash too.
            fsync_dir(d)

    def append(self, record: bytes) -> None:
        """Append + flush + fsync, STRICT: any failure raises
        DurableWriteError instead of pretending the record landed.
        A torn append (partial write, then the failure) is exactly the
        shape the journal readers already absorb — replay-of-prefix —
        so the committed records before it stay recoverable."""
        if self._f is None:
            raise ValueError(f"append log {self.path} is closed")
        try:
            faults.check("disk.full")
            if faults.fire("disk.torn"):
                self._f.write(record[:max(1, len(record) // 2)])
                self._f.flush()
                raise OSError(errno.EIO,
                              "injected torn append (disk.torn)")
            self._f.write(record)
            self._f.flush()
            os.fsync(self._f.fileno())
        except OSError as e:
            raise DurableWriteError(self.path, "append", e) from e

    def close(self) -> None:
        if self._f is not None:
            fsync_file(self._f)
            self._f.close()
            self._f = None
