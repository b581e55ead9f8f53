"""Shared log-tail + excerpt extraction helpers.

One seek-based tail used by everything that reads task logs — the portal
``/logfile`` view, the diagnosis collector, the coordinator's stack-dump
capture. The previous pattern (``open(path).read()[-N:]``) slurped whole
multi-GB task logs into memory to keep the last megabyte; ``tail_file``
seeks instead, so cost is bounded by the requested tail regardless of
file size.

The extractors pull the two excerpt shapes incident diagnosis cares
about out of a log tail:

- ``extract_traceback``: the LAST complete Python traceback (a crashing
  user process may log earlier, caught-and-retried tracebacks; the one
  that killed it is the final one);
- ``extract_stack_dump``: the faulthandler all-thread dump the hung-task
  diagnostics pass writes (``Thread 0x...`` / ``Current thread 0x...``
  markers — Python's own format, telemetry.install_stack_dump_handler).
"""

from __future__ import annotations

import os
import re
from typing import Optional

#: default tail kept by log views / collectors when the caller gives none
DEFAULT_TAIL_BYTES = 1_000_000


def tail_file(path: str, max_bytes: int = DEFAULT_TAIL_BYTES) -> bytes:
    """Last ``max_bytes`` of ``path``, read with a seek — never the whole
    file. Raises OSError like open() would (callers decide whether a
    missing log is an error or just absent evidence)."""
    max_bytes = max(0, int(max_bytes))
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        f.seek(max(0, size - max_bytes))
        return f.read(max_bytes) if max_bytes else b""


def tail_text(path: str, max_bytes: int = DEFAULT_TAIL_BYTES
              ) -> Optional[str]:
    """``tail_file`` decoded utf-8/replace; None when unreadable — the
    diagnosis collector treats a purged log as missing evidence, not a
    collection failure."""
    try:
        return tail_file(path, max_bytes).decode("utf-8", "replace")
    except OSError:
        return None


_TRACEBACK_START = "Traceback (most recent call last):"
#: the exception line closing a traceback block: "Name: msg" or bare
#: "Name" at column 0 (frames and source lines are indented).
_EXC_LINE = re.compile(r"^[A-Za-z_][\w.]*(Error|Exception|Interrupt|Exit|"
                       r"Warning|Fault)?\b.*$")


def extract_traceback(text: str, max_chars: int = 8192) -> str:
    """The LAST complete Python traceback in ``text`` ('' when none).

    Scans from the final "Traceback (most recent call last):" marker and
    keeps lines through the unindented exception line that terminates the
    block (chained tracebacks — "During handling..." — are kept whole by
    restarting from the FIRST marker of the final chain)."""
    idx = text.rfind(_TRACEBACK_START)
    if idx < 0:
        return ""
    # Walk back over a chained-exception group so "The above exception
    # was the direct cause" context survives in the excerpt.
    while True:
        prev = text.rfind(_TRACEBACK_START, 0, idx)
        if prev < 0:
            break
        between = text[prev + len(_TRACEBACK_START):idx]
        if "direct cause" in between or "During handling" in between:
            idx = prev
            continue
        break
    lines = text[idx:].splitlines()
    out = []
    for i, line in enumerate(lines):
        out.append(line)
        if i == 0 or not line or line[0] in (" ", "\t"):
            continue
        if line.startswith(_TRACEBACK_START) or "direct cause" in line \
                or "During handling" in line:
            continue
        if _EXC_LINE.match(line):
            # Unindented exception line ends the block — unless a
            # chained traceback follows (blank lines + the "direct
            # cause"/"During handling" bridge sit between the blocks).
            rest = "\n".join(lines[i + 1:i + 6])
            if _TRACEBACK_START not in rest and "direct cause" not in rest \
                    and "During handling" not in rest:
                break
    return "\n".join(out)[:max_chars]


def extract_stack_dump(text: str, max_chars: int = 4096) -> str:
    """Faulthandler all-thread dump excerpt ('' when none): from the
    FIRST thread marker in ``text`` so the excerpt spans the whole dump,
    not just its final thread block (same logic the coordinator uses on
    a hang kill), trimmed at the first line that is not part of the dump
    (frames, thread headers) so trailing log noise stays out."""
    idx = text.find("Thread 0x")
    cur = text.find("Current thread 0x")
    if idx < 0 or (0 <= cur < idx):
        idx = cur
    if idx < 0:
        return ""
    out = []
    for line in text[idx:].splitlines():
        if line and not line.startswith(("Thread 0x", "Current thread 0x",
                                         " ", "\t")):
            break
        out.append(line)
    return "\n".join(out).rstrip()[:max_chars]
