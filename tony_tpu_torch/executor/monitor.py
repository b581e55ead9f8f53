"""Per-task resource metrics sampler.

Reference model: ``TaskMonitor.java`` (192 LoC) — samples process-tree RSS via
YARN's ResourceCalculatorProcessTree (:71,:109-114) and GPU utilization via
``nvidia-smi -x -q`` (``GpuDiscoverer.java:88-131``), keeps max/avg aggregates
(:172-186), and pushes MetricsWritable to the AM every
``tony.task.metrics-interval-ms`` (:92-99).

Port deltas: RSS comes from /proc (no YARN). Device memory belongs to the
user process, the one that brought CUDA up, so it comes from that process's
telemetry file (``telemetry.py`` fills it from ``torch.cuda.memory_allocated``
and ``max_memory_allocated``) instead of an ``nvidia-smi`` subprocess. The
metric names keep the reference's ``*_TPU_HBM_BYTES``: on the card they hold
its device memory. Sampling is best-effort and never fails the task.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional

MAX_MEMORY_BYTES = "MAX_MEMORY_BYTES"
AVG_MEMORY_BYTES = "AVG_MEMORY_BYTES"
MAX_TPU_HBM_BYTES = "MAX_TPU_HBM_BYTES"
AVG_TPU_HBM_BYTES = "AVG_TPU_HBM_BYTES"
USER_DEVICE_COUNT = "USER_DEVICE_COUNT"
# Utilization, derived in the user process by telemetry.step() wrappers
# (the TPU stand-in for the reference's nvidia-smi duty-cycle sampling,
# TaskMonitor.java:116-170): latest-value passthrough, not max/avg.
STEPS_PER_SEC = "STEPS_PER_SEC"
STEP_DUTY_CYCLE = "STEP_DUTY_CYCLE"
MODEL_FLOPS_PER_SEC = "MODEL_FLOPS_PER_SEC"
MFU = "MFU"
# Final step count: the same counter the executor's progress beacon rides
# on heartbeats (hang detection, coordinator/liveness.py) — in the final
# metrics it lets a postmortem line up "steps done" with the step rate.
STEPS_COMPLETED = "STEPS_COMPLETED"
_UTIL_PASSTHROUGH = {
    STEPS_PER_SEC: "steps_per_sec",
    STEP_DUTY_CYCLE: "step_duty_cycle",
    MODEL_FLOPS_PER_SEC: "model_flops_per_sec",
    MFU: "mfu_vs_peak_bf16",
    STEPS_COMPLETED: "steps_completed",
}


def _proc_tree_rss_bytes(root_pid: int) -> int:
    """Sum VmRSS over root_pid and its descendants (the
    ResourceCalculatorProcessTree analogue)."""
    children: Dict[int, List[int]] = {}
    try:
        for entry in os.listdir("/proc"):
            if not entry.isdigit():
                continue
            try:
                with open(f"/proc/{entry}/stat") as f:
                    parts = f.read().rsplit(") ", 1)[-1].split()
                ppid = int(parts[1])
                children.setdefault(ppid, []).append(int(entry))
            except (OSError, ValueError, IndexError):
                continue
    except OSError:
        return 0
    total = 0
    stack = [root_pid]
    seen = set()
    while stack:
        pid = stack.pop()
        if pid in seen:
            continue
        seen.add(pid)
        try:
            with open(f"/proc/{pid}/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        total += int(line.split()[1]) * 1024
                        break
        except (OSError, ValueError):
            pass
        stack.extend(children.get(pid, []))
    return total


def cuda_memory_in_use_bytes() -> int:
    """Best-effort device memory allocated by THIS process on its CUDA
    devices; 0 unless this process has torch imported and CUDA up (an
    in-process user, as in notebook modes). Never imports torch: that costs
    seconds and reads 0 in an executor whose user process owns the card."""
    try:
        import sys

        torch = sys.modules.get("torch")
        if torch is None or not torch.cuda.is_initialized():
            return 0
        return sum(int(torch.cuda.memory_allocated(i))
                   for i in range(torch.cuda.device_count()))
    except Exception:  # noqa: BLE001 — telemetry must never break the task
        return 0


class TaskMonitor:
    """Background sampler pushing metrics to the coordinator."""

    def __init__(self, task_id: str, push: Callable[[str, dict], None],
                 interval_s: float = 5.0,
                 pid_fn: Optional[Callable[[], Optional[int]]] = None,
                 metrics_file: Optional[str] = None):
        self.task_id = task_id
        self._push = push
        self._interval_s = interval_s
        self._pid_fn = pid_fn or (lambda: os.getpid())
        self._metrics_file = metrics_file
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._samples = 0
        # Latest raw RSS sample (not max/avg): the live-metrics beacon
        # reads it so `tony-tpu top` shows current memory, not the peak.
        self.last_rss = 0.0
        self._metrics: Dict[str, float] = {
            MAX_MEMORY_BYTES: 0.0, AVG_MEMORY_BYTES: 0.0,
            MAX_TPU_HBM_BYTES: 0.0, AVG_TPU_HBM_BYTES: 0.0,
            USER_DEVICE_COUNT: 0.0,
        }

    def sample_once(self) -> Dict[str, float]:
        pid = self._pid_fn()
        rss = _proc_tree_rss_bytes(pid) if pid else 0
        # Device memory: prefer the user process's own reporter
        # (tony_tpu_torch.telemetry writes TONY_METRICS_FILE from inside the
        # process that owns the card); the local probe only ever sees this
        # monitor process and reads 0 on real jobs.
        hbm = peak = 0.0
        if self._metrics_file:
            from tony_tpu_torch.telemetry import read_stats

            stats = read_stats(self._metrics_file)
            hbm = float(stats.get("hbm_bytes_in_use", 0) or 0)
            # The process's own peak (max_memory_allocated) since CUDA came
            # up: the samples, seconds apart, miss a step's transient peak
            # and the last one lands after the run has freed its state.
            peak = float(stats.get("hbm_peak_bytes", 0) or 0)
            self._metrics[USER_DEVICE_COUNT] = max(
                self._metrics[USER_DEVICE_COUNT],
                float(stats.get("device_count", 0) or 0))
            for key, src in _UTIL_PASSTHROUGH.items():
                if src in stats:
                    self._metrics[key] = float(stats[src])
        if not hbm:
            hbm = cuda_memory_in_use_bytes()
        self.last_rss = float(rss)
        self._samples += 1
        n = self._samples
        # max/avg aggregation (reference TaskMonitor.java:172-186).
        m = self._metrics
        m[MAX_MEMORY_BYTES] = max(m[MAX_MEMORY_BYTES], rss)
        m[AVG_MEMORY_BYTES] += (rss - m[AVG_MEMORY_BYTES]) / n
        m[MAX_TPU_HBM_BYTES] = max(m[MAX_TPU_HBM_BYTES], hbm, peak)
        m[AVG_TPU_HBM_BYTES] += (hbm - m[AVG_TPU_HBM_BYTES]) / n
        return dict(m)

    def _loop(self) -> None:
        while not self._stop.wait(self._interval_s):
            try:
                self._push(self.task_id, self.sample_once())
            except Exception:  # noqa: BLE001
                pass

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="tony-task-monitor")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
        try:
            # Final sample so short tasks (< one interval) still report real
            # numbers in their TASK_FINISHED metrics.
            self._push(self.task_id, self.sample_once())
        except Exception:  # noqa: BLE001
            pass
