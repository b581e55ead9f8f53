"""User-side profiler capture: chief-only trace windows into the job dir.

The port's counterpart of ``tony_tpu/profiler.py``, on ``torch.profiler``.
When profiling is enabled the coordinator exports ``TONY_PROFILE_DIR`` to
the CHIEF task only (one trace per job, from the process that sees the
whole step). User code wraps the steps it wants captured:

    from tony_tpu_torch import profiler
    with profiler.trace_window():
        train_step(state, batch)

The window records the CPU and, where CUDA is up, the card, and writes a
Chrome trace (``trace.json``, for Perfetto or ``chrome://tracing``) into
``$TONY_PROFILE_DIR/<name>``. Everything no-ops when the variable is
unset, so the same training script runs unchanged with profiling on or off.
"""

from __future__ import annotations

import contextlib
import logging
import os
from typing import Iterator, Optional

from tony_tpu_torch.constants import PROFILE_DIR as PROFILE_DIR_ENV

log = logging.getLogger(__name__)

#: file name of the exported Chrome trace inside a capture directory
TRACE_FILE = "trace.json"


def profile_dir() -> Optional[str]:
    """The trace destination, or None when this task shouldn't profile."""
    return os.environ.get(PROFILE_DIR_ENV) or None


def start_profiler():
    """A started ``torch.profiler.profile`` over the CPU and, where this
    process has brought CUDA up, the card. Stop it and export with
    ``stop_profiler``."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def stop_profiler(prof, out: str) -> str:
    """Wait for the card's queued work (a kernel still queued at the stop
    is not in the trace), stop ``prof`` and write its Chrome trace into
    directory ``out``; returns the trace's path."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    prof.stop()
    path = os.path.join(out, TRACE_FILE)
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace_window(name: str = "trace") -> Iterator[Optional[str]]:
    """Capture a torch profiler trace of the enclosed block into
    ``$TONY_PROFILE_DIR/<name>/trace.json``; no-op (yields None) when
    unset. Yields the directory the trace goes to."""
    dest = profile_dir()
    if not dest:
        yield None
        return
    out = os.path.join(dest, name)
    os.makedirs(out, exist_ok=True)
    prof = start_profiler()
    try:
        yield out
    finally:
        stop_profiler(prof, out)
        log.info("profiler trace written to %s", out)
