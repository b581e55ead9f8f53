"""Crash-durable atomic file replace.

The port's copy of ``atomic_write`` and ``fsync_dir`` from
``tony_tpu/utils/durable.py``: write a temp file in the SAME directory,
fsync it, ``os.replace`` over the target, fsync the directory, so a reader
sees either the old bytes or the new bytes, never a torn mix. The telemetry
reporter's stats file and the checkpoint manifests are written this way.

POSIX note: ``os.replace`` is atomic on the same filesystem but the
RENAME itself is only durable once the parent directory is fsync'd.
"""

from __future__ import annotations

import errno
import os

from tony_tpu_torch import faults


def fsync_dir(path: str) -> None:
    """fsync a DIRECTORY so renames/creates inside it survive a crash.
    Best-effort: some filesystems refuse O_RDONLY on directories —
    durability then degrades to the OS's own schedule."""
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
    window)."""
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
