"""User-process-side accelerator telemetry reporter.

The port's counterpart of ``tony_tpu/telemetry.py``. The executor's task
monitor samples process-tree RSS, but device memory belongs to the *user*
process — the one that brought CUDA up — so the user process reports it
itself.

Mechanism: the executor exports ``TONY_METRICS_FILE`` into the user
process's environment; ``maybe_start`` starts a daemon thread that
periodically writes device and step stats to that file via atomic replace,
and the task monitor tails the file. The step and phase accounting
(``step``, ``phase``, ``step_stats``, ``phase_stats``) is the reference's,
unchanged: it reads no device.

The reporter NEVER imports torch itself and never initialises CUDA: it reads
device stats only once the user's own code has brought CUDA up in this
process (``torch`` in ``sys.modules`` and ``torch.cuda.is_initialized()``).
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import sys
import threading
import time
from typing import Any, Deque, Dict, Iterator, Optional

from tony_tpu_torch import constants

_started = threading.Lock()
_thread: Optional[threading.Thread] = None

# ---------------------------------------------------------------------------
# Step-time utilization: wrap each step in ``with telemetry.step(flops=...)``
# and the reporter publishes steps/s, duty cycle, and — when FLOPs are
# declared and the device has a known peak — MFU.
# ---------------------------------------------------------------------------
_step_lock = threading.Lock()
_steps = {"count": 0, "busy_s": 0.0, "flops": 0.0, "tokens": 0.0,
          "first_start": 0.0, "last_end": 0.0, "first_end_wall": 0.0}


# ---------------------------------------------------------------------------
# Per-step PHASE accounting (steady-state step-time attribution).
#
# The ``phase(name)`` context manager times any slice of the training loop,
# and ``step_done`` folds the accumulated phase seconds into a ring of
# per-step records whose attribution interval runs from the PREVIOUS step's
# end to this step's end (so between-step work — the prefetch queue wait, a
# checkpoint save — is attributed to the step that paid for it).
#
# Three of the canonical phases come free in the port:
# - ``data_wait``: ShardedBatchIterator.__next__ (data.py)
# - ``ckpt_stall``: CheckpointManager.save/wait (checkpoint/manager.py)
# - ``comms``: train_step_accum's bucketed all-reduce (parallel/grad_sync.py)
# ``step_compute`` defaults to the step() busy time when no explicit
# step_compute phase was recorded. Everything unattributed lands in the
# synthetic ``other`` bucket, so the per-step phases ALWAYS sum to the wall
# interval.
# ---------------------------------------------------------------------------
#: canonical phase names (free-form names are accepted).
PHASES = ("data_wait", "h2d", "step_compute", "comms", "ckpt_stall",
          "eval")
#: synthetic bucket: wall time no phase claimed (host-side gaps).
OTHER_PHASE = "other"

_phase_lock = threading.Lock()
_phase_acc: Dict[str, float] = {}   # seconds since the last step boundary
_phase_cum: Dict[str, float] = {}   # job-cumulative, folded per step
_phase_wall_cum = 0.0               # cumulative attribution wall
_phase_steps = 0
_phase_ring: Deque[dict] = collections.deque(
    maxlen=max(8, int(os.environ.get("TONY_PHASE_RING_STEPS", "") or 256)))


def _tensors(x: Any) -> Iterator[Any]:
    """Every tensor in a nest of dicts, lists and tuples."""
    if isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif hasattr(x, "is_cuda"):
        yield x


def block_until_ready(x):
    """Wait until the card has finished the work queued so far on the
    current stream of every CUDA device ``x`` holds tensors on (a CUDA
    launch returns when the work is queued); tensors on the CPU need no
    wait. Returns ``x``."""
    torch = sys.modules.get("torch")
    if torch is None:
        return x
    for dev in {t.device for t in _tensors(x) if t.is_cuda}:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()
    return x


class _PhaseSpan:
    """Handle yielded by ``phase()``: ``block_until_ready(x)`` anchors the
    phase end on device completion, so the phase times the work and not
    only its enqueue."""

    block_until_ready = staticmethod(block_until_ready)


@contextlib.contextmanager
def phase(name: str):
    """Attribute the enclosed wall time to step-phase ``name``:
    ``with telemetry.phase("data_wait"): batch = next(it)``. Folded into
    the per-step ring at the next ``step_done``."""
    t0 = time.monotonic()
    try:
        yield _PhaseSpan()
    finally:
        dt = time.monotonic() - t0
        with _phase_lock:
            _phase_acc[name] = _phase_acc.get(name, 0.0) + dt


def _fold_phases(interval_s: float, busy_s: float) -> None:
    """Close one attribution interval (step_done): drain the accumulator
    into the ring + cumulative totals, defaulting step_compute to the
    step's busy time and booking the unattributed remainder as other."""
    global _phase_wall_cum, _phase_steps
    with _phase_lock:
        acc = dict(_phase_acc)
        _phase_acc.clear()
        if "step_compute" not in acc:
            acc["step_compute"] = busy_s
        wall = max(interval_s, 0.0)
        attributed = sum(acc.values())
        if attributed > wall:
            # Overlapped phases (an async save timed across several
            # steps) can over-attribute; widen the wall rather than
            # invent a negative other bucket.
            wall = attributed
        acc[OTHER_PHASE] = wall - attributed
        for k, v in acc.items():
            _phase_cum[k] = _phase_cum.get(k, 0.0) + v
        _phase_wall_cum += wall
        _phase_steps += 1
        _phase_ring.append({"wall_s": wall, "phases": acc})


def phase_stats() -> Dict[str, object]:
    """Step-time attribution snapshot: cumulative seconds per phase (sum
    EXACTLY equals ``wall_s`` — ``other`` holds the unattributed rest)
    plus recent per-step means over the ring. {} before the first step."""
    with _phase_lock:
        if not _phase_steps:
            return {}
        out: Dict[str, object] = {
            "steps": float(_phase_steps),
            "wall_s": _phase_wall_cum,
            "cum": dict(_phase_cum),
        }
        n = len(_phase_ring)
        if n:
            recent: Dict[str, float] = {}
            rwall = 0.0
            for rec in _phase_ring:
                rwall += rec["wall_s"]
                for k, v in rec["phases"].items():
                    recent[k] = recent.get(k, 0.0) + v
            out["recent"] = {k: v / n for k, v in recent.items()}
            out["recent_wall_s"] = rwall / n
            out["recent_steps"] = float(n)
    return out


def _reset_phase_state() -> None:
    """Tests/bench probes: start attribution from a clean slate."""
    global _phase_wall_cum, _phase_steps
    with _phase_lock:
        _phase_acc.clear()
        _phase_cum.clear()
        _phase_wall_cum = 0.0
        _phase_steps = 0
        _phase_ring.clear()


def step_done(started_at: float, flops: float = 0.0,
              tokens: float = 0.0) -> None:
    """Record one completed training step that began at ``started_at``
    (``time.monotonic()``). Prefer the ``step()`` context manager."""
    from tony_tpu_torch import faults

    if faults.fire("user.hang"):
        # Injected user hang: the recording is silently dropped, so the
        # published step counter freezes while the process (and its
        # executor's heartbeats) keep running.
        return
    delay = faults.fire_amount("user.slow_step")
    if delay:
        # Injected straggler skew: stretch this step by the configured
        # amount BEFORE timestamping, so the slowdown lands in the step
        # rate the gang-median policing compares.
        time.sleep(delay)
    now = time.monotonic()
    with _step_lock:
        if not _steps["first_start"]:
            _steps["first_start"] = started_at
            # Wall-clock completion of the FIRST step: the one absolute
            # timestamp the executor's first-step trace span anchors on.
            _steps["first_end_wall"] = time.time()
        prev_end = _steps["last_end"]
        busy = max(0.0, now - started_at)
        _steps["count"] += 1
        _steps["busy_s"] += busy
        _steps["flops"] += flops
        _steps["tokens"] += tokens
        _steps["last_end"] = now
    # Attribution interval: previous step end → this step end, so the
    # data wait / checkpoint stall BETWEEN steps lands on the step that
    # paid for it; the first step's interval is its own busy time.
    _fold_phases(now - prev_end if prev_end else busy, busy)
    _profile_on_step_boundary()


@contextlib.contextmanager
def step(flops: float = 0.0, tokens: float = 0.0):
    """Time one training step: ``with telemetry.step(flops=6*params*B*S):``.
    Feeds steps/s, duty-cycle, and MFU into the task's metrics stream."""
    t0 = time.monotonic()
    try:
        yield
    finally:
        step_done(t0, flops=flops, tokens=tokens)


def step_stats() -> Dict[str, float]:
    """Derived utilization over the window since the first recorded step;
    {} until a step completes."""
    with _step_lock:
        s = dict(_steps)
    if not s["count"]:
        return {}
    wall = max(s["last_end"] - s["first_start"], 1e-9)
    out = {
        "steps_completed": float(s["count"]),
        "steps_per_sec": s["count"] / wall,
        "mean_step_s": s["busy_s"] / s["count"],
        # Fraction of wall time spent inside steps: the duty-cycle proxy
        # (host-side; dispatch gaps and eval/checkpoint pauses count as
        # idle).
        "step_duty_cycle": min(1.0, s["busy_s"] / wall),
    }
    if s["tokens"]:
        out["tokens_per_sec"] = s["tokens"] / wall
    if s["flops"]:
        out["model_flops_per_sec"] = s["flops"] / wall
    if s["first_end_wall"]:
        out["first_step_done_ts"] = s["first_end_wall"]
    return out


# ---------------------------------------------------------------------------
# On-demand device profiling (live, any task, mid-run): the executor writes
# a request file this module polls (TONY_PROFILE_REQUEST_FILE, reporter-loop
# cadence), and the NEXT step boundary arms ``torch.profiler`` for N steps —
# the capture brackets whole steps. The trace is exported as a Chrome trace
# into the requested directory. Capture must never kill or stall training:
# every failure shape (fault site ``profile.capture``) degrades to a
# reported failed result.
# ---------------------------------------------------------------------------
_profile_lock = threading.Lock()
_profile: Dict[str, object] = {
    "last_id": 0,        # highest request id ever seen (the dedup fence)
    "pending": None,     # request waiting for the next step boundary
    "active": None,      # {"req":..., "remaining": n, "prof": ...} tracing
    "result": None,      # last terminal {"id","status","dir"|"error",...}
}


def _poll_profile_request(path: str = "") -> None:
    """Reporter-loop tick: adopt a new profile request from the request
    file (executor-written, atomic replace). Dedup on the request id —
    the directive is re-sent every beat until the result lands."""
    path = path or os.environ.get(constants.PROFILE_REQUEST_ENV, "")
    if not path:
        return
    try:
        with open(path, encoding="utf-8") as f:
            req = json.load(f)
        req_id = int(req.get("id", 0))
    except (OSError, ValueError, TypeError):
        return
    if req_id <= 0:
        return
    with _profile_lock:
        if req_id <= int(_profile["last_id"]):  # type: ignore[arg-type]
            return
        _profile["last_id"] = req_id
        _profile["pending"] = {
            "id": req_id,
            "steps": max(1, int(req.get("steps", 1) or 1)),
            "dir": str(req.get("dir", "") or ""),
        }


def _profile_on_step_boundary() -> None:
    """step_done hook: start a pending capture at this step boundary, or
    advance/stop an active one. Never raises — a failed capture becomes a
    failed result on the beacon and the loop keeps training."""
    with _profile_lock:
        pending = _profile["pending"]
        active = _profile["active"]
    if active is not None:
        active["remaining"] -= 1
        if active["remaining"] > 0:
            return
        req = active["req"]
        result = {"id": req["id"], "steps": req["steps"]}
        try:
            from tony_tpu_torch.profiler import stop_profiler

            stop_profiler(active["prof"], req["dir"])
            result.update(status="captured", dir=req["dir"])
        except Exception as e:  # noqa: BLE001 — capture is best-effort
            result.update(status="failed", error=f"stop: {e}"[:300])
        with _profile_lock:
            _profile["active"] = None
            _profile["result"] = result
        return
    if pending is None:
        return
    result = {"id": pending["id"], "steps": pending["steps"]}
    try:
        from tony_tpu_torch import faults
        from tony_tpu_torch.profiler import start_profiler

        faults.check("profile.capture")
        if "torch" not in sys.modules:
            raise RuntimeError("torch is not imported in this process")
        dest = pending["dir"] or os.path.join(
            os.getcwd(), "profile", f"ondemand-{pending['id']}")
        try:
            os.makedirs(dest, exist_ok=True)
        except OSError:
            # Directive named a dir this host can't write: capture locally
            # and report where the artifact actually is.
            dest = os.path.join(os.getcwd(), "profile",
                                f"ondemand-{pending['id']}")
            os.makedirs(dest, exist_ok=True)
        pending["dir"] = dest
        prof = start_profiler()
    except Exception as e:  # noqa: BLE001 — never stall training
        with _profile_lock:
            _profile["pending"] = None
            _profile["result"] = {**result, "status": "failed",
                                  "error": str(e)[:300]}
        return
    with _profile_lock:
        _profile["pending"] = None
        _profile["active"] = {"req": pending, "prof": prof,
                              "remaining": pending["steps"]}


def profile_state() -> Optional[Dict[str, object]]:
    """Beacon payload: the capture in flight or the last terminal result
    (kept until a newer request supersedes it); None = nothing to say."""
    with _profile_lock:
        if _profile["active"] is not None:
            req = _profile["active"]["req"]  # type: ignore[index]
            return {"id": req["id"], "status": "active",
                    "dir": req["dir"], "steps": req["steps"]}
        if _profile["result"] is not None:
            return dict(_profile["result"])  # type: ignore[arg-type]
    return None


def _reset_profile_state() -> None:
    """Tests: forget every request/capture/result."""
    with _profile_lock:
        _profile.update(last_id=0, pending=None, active=None, result=None)


def collect_device_stats() -> Dict[str, float]:
    """Best-effort per-process device + step stats; {} when neither is
    available. Step stats publish without CUDA — a CPU loop wrapped in
    telemetry.step() still feeds the progress beacon the coordinator's hang
    detection watches. Device stats (``device_count``, ``hbm_bytes_in_use``
    from ``memory_allocated``, ``hbm_peak_bytes`` from
    ``max_memory_allocated``, ``devices[].kind`` from ``get_device_name``)
    appear once this process has initialised CUDA."""
    out: Dict[str, float] = {}
    per_device: list = []
    torch = sys.modules.get("torch")
    cuda_up = False
    if torch is not None:
        try:
            cuda_up = torch.cuda.is_available() and \
                torch.cuda.is_initialized()
        except Exception:  # noqa: BLE001 — telemetry must never break the task
            cuda_up = False
    if cuda_up:
        n = torch.cuda.device_count()
        out["device_count"] = float(n)
        in_use = peak = 0.0
        for i in range(n):
            try:
                b = float(torch.cuda.memory_allocated(i))
                p = float(torch.cuda.max_memory_allocated(i))
                kind = torch.cuda.get_device_name(i)
            except Exception:  # noqa: BLE001
                b, p, kind = 0.0, 0.0, "?"
            in_use += b
            peak += p
            per_device.append({"kind": kind, "bytes_in_use": b,
                               "peak_bytes_in_use": p})
        out["hbm_bytes_in_use"] = in_use
        out["hbm_peak_bytes"] = peak
        out["devices"] = per_device  # type: ignore[assignment]
    util = step_stats()
    if util:
        out.update(util)
        if cuda_up and per_device and util.get("model_flops_per_sec"):
            from tony_tpu_torch._device import peak_bf16

            peak_fl = peak_bf16(str(per_device[0]["kind"]))
            if peak_fl:
                # flops passed to step() are the model's GLOBAL per-step
                # FLOPs (over the global batch), so the denominator is the
                # global device pool: one process per card, so the
                # torch.distributed world size (1 without a group).
                dist = torch.distributed
                n_global = dist.get_world_size() if (
                    dist.is_available() and dist.is_initialized()) else 1
                out["mfu_vs_peak_bf16"] = (util["model_flops_per_sec"]
                                           / (peak_fl * n_global))
    phases = phase_stats()
    if phases:
        out["step_phases"] = phases  # type: ignore[assignment]
    prof = profile_state()
    if prof is not None:
        out["profile"] = prof  # type: ignore[assignment]
    return out


def write_stats_once(path: str) -> bool:
    stats = collect_device_stats()
    if not stats:
        return False
    stats["ts"] = time.time()
    stats["pid"] = os.getpid()
    try:
        from tony_tpu_torch.utils.durable import atomic_write

        atomic_write(path, json.dumps(stats).encode("utf-8"))
        return True
    except OSError:
        return False


def _loop(path: str, interval_s: float) -> None:
    while True:
        # On-demand profiling directive intake first, so a request
        # written just before this tick arms at the very next boundary.
        try:
            _poll_profile_request()
        except Exception:  # noqa: BLE001 — telemetry must never die
            pass
        write_stats_once(path)
        time.sleep(interval_s)


def maybe_start(interval_s: float = 3.0) -> bool:
    """Start the reporter iff TONY_METRICS_FILE is set and it isn't running
    yet. ``TONY_TELEMETRY_INTERVAL_S`` overrides the cadence."""
    global _thread
    path = os.environ.get(constants.METRICS_FILE, "")
    if not path:
        return False
    try:
        interval_s = float(
            os.environ.get(constants.TELEMETRY_INTERVAL_ENV, "")
            or interval_s)
    except ValueError:
        pass
    with _started:
        if _thread is not None and _thread.is_alive():
            return True
        _thread = threading.Thread(target=_loop, args=(path, interval_s),
                                   name="tony-telemetry", daemon=True)
        _thread.start()
        return True


def read_stats(path: str) -> Dict[str, float]:
    """Monitor side: read the latest reporter snapshot ({} if absent)."""
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


# ---------------------------------------------------------------------------
# Hung-task diagnostics: pre-registered all-thread stack dump on the signal
# the executor exports as TONY_STACKDUMP_SIGNAL.
# ---------------------------------------------------------------------------
_dump_registered = False


def install_stack_dump_handler(stream=None) -> bool:
    """Register a faulthandler all-thread stack dump on the signal named by
    ``TONY_STACKDUMP_SIGNAL`` (exported by the executor into the user
    env). No-op without the env var. A handler the user already installed
    on that signal is detected and warned about, never broken: the dump
    chains to it (both run). Returns True iff the dump handler is armed."""
    global _dump_registered
    spec = os.environ.get(constants.STACKDUMP_SIGNAL, "")
    if not spec:
        return False
    if _dump_registered:
        return True
    try:
        signum = int(spec)
    except ValueError:
        return False
    import faulthandler
    import logging
    import signal as _signal

    try:
        existing = _signal.getsignal(signum)
    except (ValueError, OSError):
        return False
    chain = callable(existing) and \
        existing is not _signal.default_int_handler
    if chain:
        # Chaining over SIG_DFL would re-run the signal's DEFAULT action
        # (terminate, for SIGUSR1/2) and kill the process we are trying
        # to diagnose — hence callable-only.
        logging.getLogger(__name__).warning(
            "signal %d already has a user handler (%r); chaining the "
            "tony-tpu stack-dump handler in front of it — hung-task "
            "dumps will run both", signum, existing)
    try:
        faulthandler.register(signum, file=stream or sys.stderr,
                              all_threads=True, chain=chain)
    except (ValueError, OSError, RuntimeError, AttributeError):
        return False
    _dump_registered = True
    return True
