"""One shared exit-status decoder for every surface that prints one.

The reference surfaced raw per-task exit codes and left "-9 means what?"
to the operator. This helper turns the three encodings a task exit can
arrive in — a plain code, Popen's negative-signal form (``-9``), and the
shell's 128+N form (``137``) — into a human explanation, used by the
TASK_FINISHED event detail, ``tony-tpu status``/``diagnose``, and the
diagnosis rule engine (which keys OOM heuristics off the decoded
signal, not the raw integer).
"""

from __future__ import annotations

import signal
from typing import Optional

#: per-signal operator hints: what USUALLY sent this signal in a tony-tpu
#: deployment (the rule engine refines with per-incident evidence).
_SIGNAL_HINTS = {
    signal.SIGKILL: "likely OOM-killer or a supervisor kill",
    signal.SIGTERM: "termination requested — preemption notice or "
                    "supervisor stop",
    signal.SIGSEGV: "segmentation fault in native code",
    signal.SIGBUS: "bus error — bad mmap/alignment, sometimes a full "
                   "/dev/shm",
    signal.SIGABRT: "abort() — failed native assertion",
    signal.SIGILL: "illegal instruction — wrong-arch native wheel",
    signal.SIGFPE: "fatal arithmetic error in native code",
    signal.SIGINT: "interrupted (Ctrl-C / SIGINT)",
    signal.SIGHUP: "hangup — controlling terminal or parent went away",
    signal.SIGQUIT: "quit signal",
    signal.SIGXCPU: "CPU time limit exceeded",
    signal.SIGXFSZ: "file size limit exceeded",
}


def exit_signal(exit_code: Optional[int]) -> Optional[int]:
    """Signal number encoded in an exit code, or None for a plain exit.

    Accepts Popen's ``-N`` and the shell's ``128+N`` encodings. ``0``
    and ordinary codes (1..127) are not signals."""
    if exit_code is None:
        return None
    code = int(exit_code)
    if code < 0:
        return -code
    if 128 < code < 256:
        return code - 128
    return None


def describe_exit(exit_code: Optional[int]) -> str:
    """'SIGKILL (signal 9; likely OOM-killer or a supervisor kill)' for
    -9/137, 'exit 1' for a plain nonzero, 'exit 0' for success."""
    if exit_code is None:
        return ""
    code = int(exit_code)
    sig = exit_signal(code)
    if sig is None:
        return f"exit {code}"
    try:
        name = signal.Signals(sig).name
    except ValueError:
        return f"signal {sig}"
    hint = _SIGNAL_HINTS.get(sig)
    return f"{name} (signal {sig}; {hint})" if hint \
        else f"{name} (signal {sig})"
