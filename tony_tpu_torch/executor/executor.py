"""Per-task agent: registers with the coordinator, waits on the gang barrier,
wires the framework env, supervises the user process.

Reference model: ``TaskExecutor.java`` (393 LoC) — identity from env
(``initConfigs`` :255), RPC proxies to the AM (:140-145), port reservation
(:83-95), ``registerAndGetClusterSpec`` poll-until-non-null barrier
(:295-309), framework env switch (:161-207), user exec + exit-code report
(:239-243), background heartbeater (:330-370) and metrics pump (:146-150).

Fault hooks honoured: TEST_NUM_HB_MISS (skip first N heartbeats, reference
:330-357), TEST_EXECUTOR_SKEW (post-exit straggler sleep, reference :372-392).
"""

from __future__ import annotations

import json
import logging
import os
import signal
import socket
import sys
import threading
import time
from typing import Callable, Dict, Optional

from tony_tpu_torch import constants, tracing
from tony_tpu_torch.conf.config import TonyTpuConfig
from tony_tpu_torch.conf import keys as K
from tony_tpu_torch.executor.monitor import TaskMonitor
from tony_tpu_torch.metrics import Histogram
from tony_tpu_torch.executor.ports import ReservedPort
from tony_tpu_torch.rpc.wire import FencedError, RpcClient
from tony_tpu_torch.runtimes.base import TaskIdentity, get_runtime
from tony_tpu_torch.utils import proc as procutil

log = logging.getLogger(__name__)

# The running user command's Popen, for the signal forwarder (the user
# process lives in its own session — see utils/proc.execute_shell — so a
# TERM aimed at the executor's group does not reach it on its own).
_user_proc: list = []


def _forward_signal(signum, frame) -> None:
    """Deliver the executor's TERM/INT to the user process group, with a
    KILL escalation timer, then let run() finish its teardown (monitor
    stop, result report) while the user command dies. The TERM-grace-KILL
    contract is what lets in-process checkpoint-on-preemption handlers run
    (reference grace: ApplicationMaster.java:694-711)."""
    p = _user_proc[0] if _user_proc else None
    if p is None or p.poll() is not None:
        # No user process to protect — die like a default handler would.
        raise SystemExit(128 + signum)
    log.warning("executor got signal %d; forwarding to user pgid %d",
                signum, p.pid)
    try:
        os.killpg(p.pid, signal.SIGTERM)
    except (ProcessLookupError, PermissionError):
        return
    grace = float(os.environ.get(constants.TASK_KILL_GRACE_ENV, "5") or 5)

    def _escalate():
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
    t = threading.Timer(grace, _escalate)
    t.daemon = True
    t.start()


class Heartbeater(threading.Thread):
    """Reference ``TaskExecutor`` heartbeat thread :330-370, extended with
    coordinator-loss detection (crash recovery): after ``loss_threshold``
    CONSECUTIVE failed beats the thread flips to reconnect mode —
    re-resolve the coordinator, re-register the existing task identity,
    resume beating — and only if no coordinator answers within
    ``orphan_deadline_s`` does it declare the executor orphaned
    (``on_orphaned`` kills the user process: a headless gang must not
    burn TPU time forever). A FAST coordinator restart is therefore
    invisible to the user process. A FencedError at any point means a
    LIVE coordinator rejected this executor as stale (old generation or
    old session epoch) — orphaned immediately, no deadline."""

    def __init__(self, client: RpcClient, task_id: str, interval_s: float,
                 session_id: int = -1,
                 loss_threshold: int = 0,
                 reconnect: Optional[Callable[[], RpcClient]] = None,
                 orphan_deadline_s: float = 120.0,
                 on_orphaned: Optional[Callable[[str], None]] = None,
                 progress_fn: Optional[Callable[[], Optional[dict]]] = None,
                 on_dump: Optional[Callable[[], None]] = None,
                 mgen_fn: Optional[Callable[[], int]] = None,
                 on_resize: Optional[Callable[[dict], None]] = None,
                 on_profile: Optional[Callable[[dict], None]] = None):
        super().__init__(name="tony-heartbeater", daemon=True)
        self._client = client
        self._task_id = task_id
        self._session_id = session_id
        self._interval_s = interval_s
        self._loss_threshold = loss_threshold
        self._reconnect = reconnect
        self._orphan_deadline_s = orphan_deadline_s
        self._on_orphaned = on_orphaned
        # Progress beacon (coordinator/liveness.py): each beat piggybacks
        # the user process's step counter + stall age; the response may
        # carry the coordinator's dump directive for a hung verdict.
        self._progress_fn = progress_fn
        self._on_dump = on_dump
        # Elastic membership (coordinator/elastic.py): every beat carries
        # the executor's CURRENT membership generation (the topology
        # fence) and the response may carry a RESIZE directive — drain
        # (checkpoint-and-park) or release.
        self._mgen_fn = mgen_fn
        self._on_resize = on_resize
        # On-demand profiling (tony-tpu profile): the response may carry
        # a PROFILE directive — re-sent every beat until the capture
        # result rides a beacon back; the executor dedups by request id.
        self._on_profile = on_profile
        self._misses = 0
        # _stop_evt, not _stop: threading.Thread has a private _stop()
        # method; shadowing it with an Event breaks Thread.join().
        self._stop_evt = threading.Event()
        self._skip = int(os.environ.get(constants.TEST_NUM_HB_MISS, "0") or 0)

    def run(self) -> None:
        from tony_tpu_torch import faults

        while not self._stop_evt.wait(self._interval_s):
            if self._skip > 0:
                self._skip -= 1
                log.warning("TEST hook: skipping heartbeat (%d more)",
                            self._skip)
                continue
            if faults.fire("heartbeat"):
                # Injected stall: the beat is silently dropped, exactly
                # as if the executor were wedged — the coordinator's
                # liveness monitor is what must notice.
                continue
            if faults.fire("host.loss"):
                # Sudden whole-host death: everything on the "host" dies
                # at once — the user process group AND this executor,
                # with no teardown and no exit report. The shape elastic
                # shrink-and-continue must absorb (the call counter is
                # heartbeats, so after:N places it deterministically).
                log.critical("FAULT host.loss: SIGKILLing the user "
                             "process group and hard-exiting")
                p = _user_proc[0] if _user_proc else None
                if p is not None and p.poll() is None:
                    try:
                        os.killpg(p.pid, signal.SIGKILL)
                    except (ProcessLookupError, PermissionError):
                        pass
                os._exit(137)
            progress = None
            if self._progress_fn is not None:
                try:
                    progress = self._progress_fn()
                except Exception:  # noqa: BLE001 — the beat must not die
                    progress = None
            try:
                res = self._client.call(
                    "task_executor_heartbeat",
                    task_id=self._task_id,
                    session_id=self._session_id,
                    progress=progress,
                    mgen=self._mgen_fn() if self._mgen_fn else -1)
                self._misses = 0
                if isinstance(res, dict) and res.get("dump") \
                        and self._on_dump is not None:
                    # Hung verdict: the coordinator wants all-thread
                    # stacks from the user process before it kills it.
                    try:
                        self._on_dump()
                    except Exception:  # noqa: BLE001 — best-effort
                        log.exception("stack-dump delivery failed")
                if isinstance(res, dict) \
                        and isinstance(res.get("resize"), dict) \
                        and self._on_resize is not None:
                    try:
                        self._on_resize(res["resize"])
                    except Exception:  # noqa: BLE001 — keep beating
                        log.exception("resize directive handling failed")
                if isinstance(res, dict) \
                        and isinstance(res.get("profile"), dict) \
                        and self._on_profile is not None:
                    try:
                        self._on_profile(res["profile"])
                    except Exception:  # noqa: BLE001 — keep beating
                        log.exception("profile directive handling failed")
            except FencedError as e:
                self._orphan(f"fenced by a live coordinator: {e}")
                return
            except Exception as e:  # noqa: BLE001
                self._misses += 1
                log.warning("heartbeat failed (%d consecutive): %s",
                            self._misses, e)
                if self._loss_threshold and self._reconnect is not None \
                        and self._misses >= self._loss_threshold:
                    if not self._reenter():
                        return

    def _reenter(self) -> bool:
        """Coordinator-loss mode: keep trying to re-resolve + re-register
        until success, normal stop, fencing, or the orphan deadline."""
        log.error("coordinator unreachable after %d heartbeats — entering "
                  "reconnect mode (orphan deadline %.0fs)",
                  self._misses, self._orphan_deadline_s)
        deadline = time.monotonic() + self._orphan_deadline_s
        while not self._stop_evt.is_set():
            try:
                self._client = self._reconnect()
                self._misses = 0
                log.warning("re-registered %s with the coordinator; "
                            "resuming heartbeats", self._task_id)
                return True
            except FencedError as e:
                self._orphan(f"fenced during re-registration: {e}")
                return False
            except Exception as e:  # noqa: BLE001
                log.warning("re-registration attempt failed: %s", e)
            if time.monotonic() >= deadline:
                self._orphan(
                    f"no coordinator within the {self._orphan_deadline_s:.0f}s"
                    f" orphan deadline")
                return False
            if self._stop_evt.wait(min(self._interval_s, 2.0)):
                return False       # normal stop while reconnecting
        return False

    def _orphan(self, reason: str) -> None:
        if self._on_orphaned is not None and not self._stop_evt.is_set():
            self._on_orphaned(reason)

    def stop(self) -> None:
        self._stop_evt.set()


class TaskExecutor:
    def __init__(self, env: Optional[Dict[str, str]] = None):
        e = env or os.environ
        self.job_name = e[constants.JOB_NAME]
        self.index = int(e[constants.TASK_INDEX])
        self.task_num = int(e[constants.TASK_NUM])
        self.is_chief = e.get(constants.IS_CHIEF, "false") == "true"
        self.session_id = int(e.get(constants.SESSION_ID, "0"))
        self.task_id = e.get(constants.TASK_ID,
                             f"{self.job_name}:{self.index}")
        self.coordinator_host = e[constants.COORDINATOR_HOST]
        self.coordinator_port = int(e[constants.COORDINATOR_PORT])
        self.command = e.get(constants.TASK_COMMAND, "")
        conf_path = e.get(constants.EXECUTOR_CONF, "")
        from tony_tpu_torch.storage.store import is_url
        if conf_path and is_url(conf_path):
            # Frozen config lives in the remote store (multi-host path);
            # fetch it with the env credential before reading any key.
            from tony_tpu_torch.storage import get_store

            local = os.path.join(os.getcwd(), constants.FINAL_CONFIG_FILE)
            get_store(conf_path).get_file(conf_path, local)
            conf_path = local
        self.conf = (TonyTpuConfig.load_final(conf_path)
                     if conf_path and os.path.exists(conf_path)
                     else TonyTpuConfig())
        tls = None
        tls_cert = str(self.conf.get(K.SECURITY_TLS_CERT, "") or "")
        if tls_cert:
            from tony_tpu_torch.rpc.wire import client_tls_context
            tls = client_tls_context(tls_cert)
        self._rpc_token = e.get("TONY_RPC_TOKEN") or None
        self._tls = tls
        # Crash-recovery contract: the launch-time coordinator generation
        # fences every frame (adopted upward on reconnect, stale rejected),
        # and the address file is how a RESTARTED coordinator — fresh
        # ephemeral port — is re-resolved.
        self.generation = int(
            e.get(constants.COORDINATOR_GENERATION, "0") or 0)
        self.coordinator_addr_file = e.get(constants.COORDINATOR_ADDR_FILE,
                                           "")
        # Elastic membership generation (coordinator/elastic.py): -1 =
        # not an elastic job (compat-accepted by the coordinator).
        # Survivors adopt newer generations from the RESIZE directive
        # riding the heartbeat response; a frame carrying a stale value
        # with no resize in flight is fenced.
        try:
            self.mgen = int(e.get(constants.MEMBERSHIP_GEN, "") or -1)
        except ValueError:
            self.mgen = -1
        self._resize_lock = threading.Lock()
        self._resize_directive: Optional[dict] = None
        self._released = False
        # On-demand profiling: request ids already written to the user
        # process's request file (the directive re-rides every beat until
        # the result lands — write each request exactly once).
        self._profile_ids: set = set()
        self._rpc_max_retries = self.conf.get_int(K.RPC_MAX_RETRIES, 10)
        self._rpc_retry_sleep_s = float(
            self.conf.get(K.RPC_RETRY_SLEEP_S, 2.0) or 2.0)
        # Per-call deadline so a WEDGED coordinator can't park the
        # heartbeat thread forever (the precondition for loss detection).
        self._rpc_call_timeout_s = float(
            self.conf.get(K.RPC_CALL_TIMEOUT_S, 10.0) or 0) or None
        # Client-side RPC latency histogram: cumulative over this
        # executor's lifetime, shipped on every heartbeat beacon and
        # re-exposed by the coordinator as tony_rpc_client_seconds.
        self._rpc_hist = Histogram()
        # Distributed tracing (tony_tpu_torch/tracing.py): the coordinator
        # exported the job's trace id and this task's lifecycle span as
        # our parent; spans are buffered locally and shipped home over
        # trace.push. Absent env (tracing off / old coordinator) = no-op.
        self.tracer = tracing.Tracer(
            trace_id=e.get(constants.TRACE_ID_ENV) or None,
            service=f"executor:{self.task_id}",
            enabled=bool(e.get(constants.TRACE_ID_ENV)))
        self._trace_parent = e.get(constants.TRACE_PARENT_ENV, "")
        self._run_span = tracing.NULL_SPAN
        self._trace_ctx: Optional[tuple] = None
        self._user_start_us = 0
        self._first_step_emitted = False
        self._monitor: Optional[TaskMonitor] = None
        self.client = self._make_client(self.coordinator_host,
                                        self.coordinator_port)
        self._orphaned_reason: Optional[str] = None
        # Progress beacon state (coordinator/liveness.py): the executor
        # tails the user process's telemetry file and reports the step
        # counter plus how long ago IT last saw the counter move — a
        # duration, so coordinator/executor clock skew never corrupts the
        # stall measurement.
        self._metrics_file = ""
        self._beacon_steps: Optional[float] = None
        self._beacon_advance_t = 0.0
        # Signal delivered to the user process group on a hung verdict;
        # `import tony_tpu_torch` in the user process pre-registers a
        # faulthandler all-thread dump on it. Operators can move it via
        # the TONY_STACKDUMP_SIGNAL env (execution-env passthrough).
        try:
            self._dump_signal = int(
                e.get(constants.STACKDUMP_SIGNAL, "") or 0) \
                or int(signal.SIGUSR1)
        except ValueError:
            self._dump_signal = int(signal.SIGUSR1)
        # Warm-pool adoption marker (tony_tpu_torch/pool.py): stamped into the
        # lease env by the pool daemon; empty on cold-spawned executors.
        # Drives the adopted=true span attributes — nothing else differs:
        # an adopted executor is indistinguishable to the coordinator.
        self._pool_worker = e.get(constants.POOL_WORKER_ID, "")
        self.hostname = e.get("TONY_ADVERTISED_HOST") or socket.gethostname()
        try:
            socket.getaddrinfo(self.hostname, None)
        except OSError:
            self.hostname = "127.0.0.1"
        self.rendezvous_port: Optional[ReservedPort] = None
        self.tb_port: Optional[ReservedPort] = None

    # -- coordinator link (crash recovery) -------------------------------
    def _make_client(self, host: str, port: int) -> RpcClient:
        client = RpcClient(
            host, port, token=self._rpc_token,
            max_retries=self._rpc_max_retries,
            retry_sleep_s=self._rpc_retry_sleep_s,
            tls=self._tls, generation=self.generation,
            call_timeout_s=self._rpc_call_timeout_s,
            on_latency=self._record_rpc_latency, peer="coordinator")
        client.trace_context = self._trace_ctx
        return client

    def _record_rpc_latency(self, method: str, seconds: float) -> None:
        self._rpc_hist.observe(seconds)

    def _flush_trace(self) -> None:
        """Ship buffered spans to the coordinator's span log. Best-effort:
        spans are only ever shipped COMPLETE, so a failed push loses
        detail but can never leave the job's trace with an unclosed
        executor span."""
        if not self.tracer.enabled:
            return
        records = self.tracer.drain()
        if not records:
            return
        try:
            self.client.call("trace.push", records=records)
        except Exception as e:  # noqa: BLE001 — tracing is best-effort
            log.debug("trace push failed (%d spans dropped): %s",
                      len(records), e)

    def _resolve_coordinator(self) -> None:
        """Re-read the coordinator address file, if one is reachable from
        this host: a recovered coordinator binds a fresh ephemeral port
        and rewrites the file. Unreadable/absent → keep the last known
        address (a coordinator restarted on a fixed host:port needs no
        file)."""
        if not self.coordinator_addr_file:
            return
        try:
            with open(self.coordinator_addr_file, encoding="utf-8") as f:
                addr = json.load(f)
            self.coordinator_host = addr["host"]
            self.coordinator_port = int(addr["port"])
            self._rpc_token = addr.get("token") or None
        except (OSError, ValueError, KeyError) as e:
            log.debug("could not re-resolve coordinator from %s: %s",
                      self.coordinator_addr_file, e)

    def _reconnect_coordinator(self) -> RpcClient:
        """One reconnect attempt for the Heartbeater's loss mode:
        re-resolve the address, dial with a SHORT budget (the outer loop
        owns pacing), and re-register the existing task identity so the
        recovered coordinator re-adopts this task without touching the
        user process. Raises on failure; FencedError means a live
        coordinator ruled this executor stale — terminal."""
        from tony_tpu_torch import faults

        faults.check("executor.reregister")
        self._resolve_coordinator()
        client = RpcClient(
            self.coordinator_host, self.coordinator_port,
            token=self._rpc_token, max_retries=1, retry_sleep_s=0.1,
            connect_timeout_s=5.0, tls=self._tls,
            generation=self.generation,
            call_timeout_s=self._rpc_call_timeout_s,
            on_latency=self._record_rpc_latency, peer="coordinator")
        client.trace_context = self._trace_ctx
        try:
            client.call("register_worker_spec", task_id=self.task_id,
                        host=self.hostname,
                        port=self.rendezvous_port.port
                        if self.rendezvous_port else 0,
                        session_id=self.session_id, mgen=self.mgen)
        except BaseException:
            client.close()
            raise
        # Adopt the successor's generation for all future frames.
        self.generation = max(self.generation, client.generation)
        old, self.client = self.client, client
        old.close()
        return client

    # -- progress liveness + metrics beacon ------------------------------
    def _progress_beacon(self) -> Optional[dict]:
        """Heartbeat payload, two audiences in one dict. For the liveness
        tracker (coordinator/liveness.py): the user process's step counter
        (published by telemetry.step() into the metrics file) plus the age
        of its last advance as seen from THIS process — absent while the
        task has no progress instrumentation, so the coordinator keeps it
        on heartbeat-only liveness (one-time warning, never a false kill).
        Any counter CHANGE counts as an advance ('!=' not '>': a user
        process restarted inside the same task resets the counter downward
        and is very much alive). For the live-metrics registry: a
        ``metrics`` sub-dict (steps/s, MFU, HBM, RSS) and the cumulative
        RPC client-latency histogram snapshot."""
        if not self._metrics_file:
            return None
        from tony_tpu_torch import telemetry

        stats = telemetry.read_stats(self._metrics_file)
        beacon: Dict[str, object] = {}
        steps = stats.get("steps_completed")
        if steps is not None:
            now = time.monotonic()
            steps = float(steps)
            if self._beacon_steps is None or steps != self._beacon_steps:
                self._beacon_steps = steps
                self._beacon_advance_t = now
            beacon["steps"] = steps
            beacon["age_s"] = round(now - self._beacon_advance_t, 3)
            self._maybe_emit_first_step(stats, steps)
        m: Dict[str, float] = {}
        for src, dst in (("steps_per_sec", "steps_per_sec"),
                         ("tokens_per_sec", "tokens_per_sec"),
                         ("mfu_vs_peak_bf16", "mfu"),
                         ("hbm_bytes_in_use", "hbm_bytes")):
            v = stats.get(src)
            if isinstance(v, (int, float)):
                m[dst] = float(v)
        if self._monitor is not None and self._monitor.last_rss:
            m["rss_bytes"] = self._monitor.last_rss
        if m:
            beacon["metrics"] = m
        ph = stats.get("step_phases")
        if isinstance(ph, dict) and ph:
            # Step-time attribution: cumulative per-phase seconds + the
            # recent ring means → tony_step_phase_seconds gauges and the
            # `top` phase bar (tony_tpu_torch/profiling/).
            beacon["phases"] = ph
        prof = stats.get("profile")
        if isinstance(prof, dict) and prof:
            # On-demand capture status/result — the coordinator matches
            # it to its request by id and emits TASK_PROFILED.
            beacon["profile"] = prof
        if self._rpc_hist.count:
            beacon["rpc"] = self._rpc_hist.snapshot()
        return beacon or None

    def _maybe_emit_first_step(self, stats: dict, steps: float) -> None:
        """Record the submit→first-step tail: a complete span from user-
        process start to the FIRST telemetry step, end-anchored on the
        user process's own wall timestamp (telemetry first_step_done_ts)
        rather than this poll's arrival time. The span bench.py measures
        its submit_to_first_step_s from."""
        if self._first_step_emitted or steps < 1 \
                or not self.tracer.enabled or not self._user_start_us:
            return
        self._first_step_emitted = True
        end_ts = stats.get("first_step_done_ts")
        try:
            end_us = int(float(end_ts) * 1e6) if end_ts else tracing.now_us()
        except (TypeError, ValueError):
            end_us = tracing.now_us()
        self.tracer.emit("executor.first_step",
                         start_us=self._user_start_us,
                         end_us=max(end_us, self._user_start_us),
                         parent=self._run_span, task=self.task_id,
                         attrs={"steps_at_observation": steps})

    def _dump_user_stacks(self) -> None:
        """Coordinator declared this task HUNG: deliver the dump signal so
        the pre-registered faulthandler handler writes all-thread stacks
        into the task log — the diagnostics pass before the
        TERM-grace-KILL lands. The target is the PID stamped into the
        metrics file: exactly the process whose step counter froze, and
        by construction one that imported tony_tpu_torch (so the handler is
        registered). Blasting the whole group instead would kill any
        member WITHOUT a handler — the `/bin/sh -c` wrapper dies on an
        unhandled SIGUSR1 and turns the diagnostics pass into the kill."""
        p = _user_proc[0] if _user_proc else None
        if p is None or p.poll() is not None:
            log.warning("coordinator requested a stack dump but no user "
                        "process is running")
            return
        from tony_tpu_torch import telemetry

        pid = 0
        try:
            pid = int(telemetry.read_stats(self._metrics_file).get("pid", 0))
        except (TypeError, ValueError):
            pid = 0
        try:
            # Guard against pid recycling: only signal a pid still inside
            # the user command's process group.
            if not pid or os.getpgid(pid) != p.pid:
                log.warning("no live instrumented pid to stack-dump "
                            "(metrics pid %s outside user pgid %d)",
                            pid or "?", p.pid)
                return
            log.warning("coordinator declared %s hung; sending dump "
                        "signal %d to instrumented pid %d for an "
                        "all-thread stack dump",
                        self.task_id, self._dump_signal, pid)
            os.kill(pid, self._dump_signal)
        except (ProcessLookupError, PermissionError) as e:
            log.warning("stack-dump signal failed: %s", e)

    # -- on-demand profiling (tony-tpu profile) --------------------------
    def _profile_request_path(self) -> str:
        return os.path.join(os.getcwd(), constants.PROFILE_REQUEST_FILE)

    def _on_profile_directive(self, directive: dict) -> None:
        """PROFILE directive off the heartbeat response (the dump/RESIZE
        pattern): hand the request to the user process by writing the
        request file its telemetry reporter polls
        (TONY_PROFILE_REQUEST_FILE). Deduped by request id — the
        coordinator re-sends the directive every beat until the capture
        result rides a beacon back; the file is written exactly once per
        request. Atomic replace: the reporter must never adopt a torn
        request (it would dedup a garbage id)."""
        try:
            req_id = int(directive.get("id", 0))
        except (TypeError, ValueError):
            return
        if req_id <= 0 or req_id in self._profile_ids:
            return
        self._profile_ids.add(req_id)
        from tony_tpu_torch.utils.durable import atomic_write

        try:
            atomic_write(self._profile_request_path(),
                         json.dumps(directive).encode("utf-8"))
            log.info("profile request %d (steps=%s) written for the "
                     "user process", req_id, directive.get("steps"))
        except OSError as e:
            log.warning("could not write profile request %d: %s",
                        req_id, e)

    # -- elastic resize (coordinator/elastic.py) -------------------------
    def _on_resize(self, directive: dict) -> None:
        """RESIZE directive off the heartbeat response (the dump-
        directive pattern): the gang is re-meshing. Drain the user
        process at a step barrier — TERM so its save-on-SIGTERM handler
        makes one final durable save, KILL after the drain grace — and
        leave the park/release decision to the run loop once the exit
        lands. Re-sent every beat while the drain runs; dedup on the
        membership generation (never act twice, never act on a stale
        generation after adopting a newer one)."""
        try:
            mgen = int(directive.get("mgen", -1))
        except (TypeError, ValueError):
            return
        with self._resize_lock:
            cur = self._resize_directive
            if mgen <= self.mgen or (
                    cur is not None and mgen <= int(cur.get("mgen", -1))):
                return
            self._resize_directive = dict(directive)
        action = str(directive.get("action", "drain"))
        log.warning("resize directive: %s under membership generation "
                    "%d (size %s) — draining the user process",
                    action, mgen, directive.get("size"))
        p = _user_proc[0] if _user_proc else None
        if p is None or p.poll() is not None:
            return                 # nothing to drain; the loop handles it
        try:
            os.killpg(p.pid, signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            return
        try:
            grace = float(directive.get("grace_s") or 0) or float(
                os.environ.get(constants.TASK_KILL_GRACE_ENV, "15") or 15)
        except (TypeError, ValueError):
            grace = 15.0

        def _escalate():
            if p.poll() is None:
                log.warning("resize drain grace (%.0fs) expired; "
                            "SIGKILLing the user process group", grace)
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
        timer = threading.Timer(grace, _escalate)
        timer.daemon = True
        timer.start()

    def _take_resize_directive(self) -> Optional[dict]:
        """Consume the pending directive (run loop, after a user-process
        exit): adopting the new membership generation here makes every
        later frame — heartbeats, the park re-registration — carry it."""
        with self._resize_lock:
            d, self._resize_directive = self._resize_directive, None
        if d is not None:
            self.mgen = max(self.mgen, int(d.get("mgen", -1)))
        return d

    def _gang_position(self, cluster_spec) -> tuple:
        """(dense_rank, world, members) for this task under the spec's
        elastic metadata. A post-shrink gang keeps SURVIVOR indices —
        task identity is stable — so the wire spec lists members in
        dense-rank order and this maps our stable index into it. Plain
        (index, task_num, range) for non-elastic jobs."""
        meta = cluster_spec.pop("__elastic__", None) \
            if isinstance(cluster_spec, dict) else None
        members = None
        if isinstance(meta, dict):
            try:
                self.mgen = max(self.mgen, int(meta.get("mgen", -1)))
            except (TypeError, ValueError):
                pass
            raw = (meta.get("members") or {}).get(self.job_name)
            if raw:
                members = sorted(int(m) for m in raw)
        if members and self.index in members:
            return members.index(self.index), len(members), members
        return self.index, self.task_num, list(range(self.task_num))

    def _orphan_teardown(self, reason: str) -> None:
        """No coordinator will ever hear from us again (deadline expired)
        or a live one fenced us out as stale: deliver the TERM-grace-KILL
        ladder to the user process group and let run() unwind. Without
        this, a lost coordinator leaves headless executors training into
        the void indefinitely."""
        self._orphaned_reason = reason
        log.error("executor orphaned (%s); stopping user process", reason)
        p = _user_proc[0] if _user_proc else None
        if p is not None and p.poll() is None:
            grace = float(os.environ.get(constants.TASK_KILL_GRACE_ENV,
                                         "5") or 5)
            procutil.kill_process_groups([p.pid], grace_s=grace)

    # -- setup ----------------------------------------------------------
    def setup_ports(self) -> None:
        """Reserve the rendezvous port (+ TensorBoard port if chief);
        reference ``TaskExecutor.setupPorts`` :83-95."""
        reuse = self.conf.get_bool(K.TASK_REUSE_PORT) or \
            os.environ.get("TF_GRPC_REUSE_PORT", "").lower() == "true"
        # Missing SO_REUSEPORT degrades to the ephemeral strategy inside
        # ReservedPort itself (with a warning), so no fallback here.
        self.rendezvous_port = ReservedPort(reuse=reuse)
        if self.is_chief:
            self.tb_port = ReservedPort(reuse=False)
            try:
                self.client.call(
                    "register_tensorboard_url", task_id=self.task_id,
                    url=f"http://{self.hostname}:{self.tb_port.port}",
                    session_id=self.session_id)
            except Exception as e:  # noqa: BLE001
                log.warning("TB registration failed: %s", e)
        port_file = str(self.conf.get(K.TASK_PORT_FILE, "") or "")
        if port_file:
            with open(port_file, "w") as f:
                f.write(str(self.rendezvous_port.port))

    def register_and_get_cluster_spec(self) -> Optional[dict]:
        """The gang barrier (reference :295-309): re-register every 3 s until
        the coordinator returns the complete spec."""
        timeout_s = self.conf.get_int(K.TASK_REGISTRATION_TIMEOUT_S, 900)
        if os.environ.get(constants.TEST_SKIP_REGISTRATION):
            # Simulates an executor that never reaches the coordinator so the
            # coordinator-side registration timeout can be exercised E2E
            # (reference kills stuck allocations after the timeout,
            # ``ApplicationMaster.java:791-888``).
            log.warning("TEST hook: skipping registration; sleeping")
            # Outlive the coordinator's registration timeout but stay
            # bounded: an unbounded multiple of a production-sized timeout
            # left zombie sleepers wedging suite teardown (VERDICT r3 #7).
            time.sleep(min(timeout_s * 4, 120))
            return None

        def attempt() -> Optional[dict]:
            try:
                return self.client.call(
                    "register_worker_spec", task_id=self.task_id,
                    host=self.hostname, port=self.rendezvous_port.port,
                    session_id=self.session_id, mgen=self.mgen)
            except FencedError:
                # A live coordinator ruled this executor stale (old
                # generation/epoch): polling cannot fix that — abort.
                raise
            except Exception as e:  # noqa: BLE001
                log.warning("register_worker_spec failed: %s", e)
                return None

        return procutil.poll_till_non_null(
            attempt, interval_s=0.3, timeout_s=timeout_s)

    def _park_ack_for_migration(self) -> bool:
        """Deliver ONE park acknowledgement for a live migration, then
        return — never wait for the spec. Survives a coordinator outage
        the same way a result report does (the mid-migration SIGKILL
        drill): re-resolve + retry inside the orphan deadline, so the
        RECOVERED coordinator re-entering the journaled move collects
        this ack. FencedError is terminal (a live coordinator already
        moved past this incarnation); an exhausted deadline just exits —
        the coordinator's drain degrades to the heartbeat-expiry ladder."""
        deadline = time.monotonic() + float(
            self.conf.get_int(K.TASK_ORPHAN_DEADLINE_S, 120))
        while True:
            try:
                self.client.call(
                    "register_worker_spec", task_id=self.task_id,
                    host=self.hostname, port=self.rendezvous_port.port,
                    session_id=self.session_id, mgen=self.mgen)
                return True
            except FencedError as e:
                log.warning("migration park ack for %s fenced: %s",
                            self.task_id, e)
                return False
            except Exception as e:  # noqa: BLE001
                if time.monotonic() >= deadline:
                    log.warning("migration park ack failed within the "
                                "orphan deadline: %s", e)
                    return False
                log.info("migration park ack failed (%s); re-resolving "
                         "the coordinator and retrying", e)
                time.sleep(0.5)
                self._resolve_coordinator()
                old, self.client = self.client, self._make_client(
                    self.coordinator_host, self.coordinator_port)
                old.close()

    def _localize_bundle(self) -> None:
        """Localize the staged job bundle, container resources, and venv
        into this task's working dir (reference ``Utils.extractResources``
        :710-723 unzipping the HDFS-localized src/venv archives, and YARN
        resource localization per ``LocalizableResource``).

        Cold-start posture: runs in a BACKGROUND thread overlapped with
        port setup + the registration barrier (run() joins it before the
        user process launches), fetches resources concurrently, and skips
        content-unchanged files via the workdir manifest
        (utils/localize.py) — a retry epoch re-localizing into the same
        task dir pays ~nothing."""
        from tony_tpu_torch.storage.store import is_url
        from tony_tpu_torch.utils import localize as loc

        workdir = os.getcwd()
        manifest = loc.load_manifest(workdir)
        bundle = str(self.conf.get(K.INTERNAL_BUNDLE_DIR, "") or "")
        if bundle and is_url(bundle):
            from tony_tpu_torch.storage import get_store

            get_store(bundle).get_tree(bundle, workdir)
        elif bundle and os.path.isdir(bundle):
            import shutil

            sig = f"__bundle__|{loc.tree_signature(bundle)}"
            if manifest.get("__bundle__") != sig:
                shutil.copytree(bundle, workdir, dirs_exist_ok=True)
                manifest["__bundle__"] = sig
            else:
                log.debug("bundle localization skip (content unchanged)")
        resources = self.conf.get_list(K.INTERNAL_RESOURCES)
        if resources:
            loc.localize_resources(resources, workdir, manifest=manifest)
        venv = str(self.conf.get(K.INTERNAL_VENV, "") or "")
        if venv and is_url(venv):
            from tony_tpu_torch.storage import get_store

            local = os.path.join(workdir, os.path.basename(venv))
            get_store(venv).get_file(venv, local)
            venv = local
        if venv and os.path.isfile(venv):
            import shutil

            venv_sig = f"__venv__|{loc.file_content_hash(venv)}"
            venv_dir = os.path.join(workdir, "venv")
            if manifest.get("__venv__") == venv_sig \
                    and os.path.isdir(venv_dir):
                log.debug("venv localization skip (content unchanged)")
            else:
                os.makedirs(venv_dir, exist_ok=True)
                shutil.unpack_archive(venv, venv_dir)
                manifest["__venv__"] = venv_sig
                # Archived venvs lose the executable bit on their binaries
                # when zipped; restore it so venv/bin/python is runnable.
                bin_dir = os.path.join(venv_dir, "bin")
                if os.path.isdir(bin_dir):
                    for f in os.listdir(bin_dir):
                        p = os.path.join(bin_dir, f)
                        if os.path.isfile(p):
                            os.chmod(p, os.stat(p).st_mode | 0o755)
        loc.save_manifest(workdir, manifest)

    # -- run ------------------------------------------------------------
    def run(self) -> int:
        if not self.command:
            log.error("no task command configured for %s", self.task_id)
            return constants.EXIT_FAILURE
        # Postmortem span durability: the buffered complete-only sink
        # only reaches the job's span log via trace.push, so an executor
        # dying on SIGTERM (backend kill, preemption ladder) used to
        # take its whole side of the timeline with it. atexit covers
        # every orderly-ish death — the signal forwarder exits via
        # SystemExit, which runs atexit hooks; only SIGKILL still loses
        # the buffer (and can lose nothing else either).
        import atexit
        atexit.register(self._flush_trace)
        self._run_span = self.tracer.start_span(
            "executor.run", parent=self._trace_parent, task=self.task_id,
            attrs={"pooled": self._pool_worker} if self._pool_worker
            else None)
        # Every RPC this executor makes carries the trace context, so
        # coordinator-side RPC spans stitch under this run span.
        self._trace_ctx = (self.tracer.trace_id, self._run_span.span_id) \
            if self.tracer.enabled else None
        self.client.trace_context = self._trace_ctx
        # Localization overlaps the registration barrier: the staged
        # bytes only need to be in place before the USER process starts,
        # and the gang barrier routinely idles for seconds waiting on
        # peers — run() joins this thread (and re-raises its failure)
        # right after the barrier opens, before the runtime env is built.
        localize_span = self.tracer.start_span(
            "executor.localize", parent=self._run_span, task=self.task_id)
        localize_err: list = []

        def _localize_bg() -> None:
            try:
                self._localize_bundle()
            except BaseException as e:  # noqa: BLE001 — re-raised at join
                localize_err.append(e)
            finally:
                localize_span.end(error=str(localize_err[0])[:200]
                                  if localize_err else "")

        localize_thread = threading.Thread(
            target=_localize_bg, name="tony-localize", daemon=True)
        localize_thread.start()
        self.setup_ports()
        metrics_file = os.path.join(os.getcwd(), "user-metrics.json")
        self._metrics_file = metrics_file
        hb = Heartbeater(
            self.client, self.task_id,
            self.conf.get_int(K.TASK_HEARTBEAT_INTERVAL_MS, 1000) / 1000.0,
            session_id=self.session_id,
            loss_threshold=self.conf.get_int(
                K.TASK_COORDINATOR_LOSS_HEARTBEATS, 3),
            reconnect=self._reconnect_coordinator,
            orphan_deadline_s=float(
                self.conf.get_int(K.TASK_ORPHAN_DEADLINE_S, 120)),
            on_orphaned=self._orphan_teardown,
            progress_fn=self._progress_beacon,
            on_dump=self._dump_user_stacks,
            mgen_fn=lambda: self.mgen,
            on_resize=self._on_resize,
            on_profile=self._on_profile_directive)
        hb.start()
        monitor = TaskMonitor(
            self.task_id,
            push=lambda tid, m: self.client.call("metrics.push", task_id=tid,
                                                 metrics=m),
            interval_s=self.conf.get_int(K.TASK_METRICS_INTERVAL_MS,
                                         5000) / 1000.0,
            metrics_file=metrics_file)

        register_span = self.tracer.start_span(
            "executor.register", parent=self._run_span, task=self.task_id,
            attrs={"adopted": True, "pool_worker": self._pool_worker}
            if self._pool_worker else None)
        try:
            cluster_spec = self.register_and_get_cluster_spec()
        except FencedError as e:
            register_span.end(fenced=True)
            log.error("registration fenced for %s: %s", self.task_id, e)
            return constants.EXIT_KILLED
        register_span.end(barrier_open=cluster_spec is not None)
        if cluster_spec is None:
            log.error("registration barrier timed out for %s", self.task_id)
            self._run_span.end(barrier_timeout=True)
            self._flush_trace()
            return constants.EXIT_FAILURE
        log.info("cluster spec: %s", cluster_spec)
        # The barrier is open; the staged bytes must now actually be in
        # place (and a localization failure must fail THIS task the same
        # way it did when localization ran serially before registration).
        localize_thread.join()
        if localize_err:
            hb.stop()
            log.error("bundle localization failed for %s: %s",
                      self.task_id, localize_err[0])
            self._run_span.end(localize_error=str(localize_err[0])[:200])
            self._flush_trace()
            return constants.EXIT_FAILURE
        # First flush: registration/localization spans reach the span log
        # even if this executor is later SIGKILLed mid-training.
        self._flush_trace()

        framework = str(self.conf.get(K.APPLICATION_FRAMEWORK, "pytorch"))
        runtime = get_runtime(framework)

        def _on_user_start(p) -> None:
            # Publish the user pgid: in-process for the signal forwarder,
            # on disk for backends that must reap the user tree even after
            # this executor is SIGKILLed (constants.USER_PGID_FILE).
            self._user_start_us = tracing.now_us()
            _user_proc[:] = [p]
            try:
                with open(os.path.join(os.getcwd(),
                                       constants.USER_PGID_FILE), "w") as f:
                    f.write(str(p.pid))
            except OSError as e:
                log.warning("could not write %s: %s",
                            constants.USER_PGID_FILE, e)

        # Root the proc-tree walk at the executor itself: the user process
        # is a descendant, and this root stays sampleable after the child
        # exits (a dead child pid would zero the final sample short tasks
        # rely on). Started ONCE — it spans elastic park/relaunch cycles.
        monitor._pid_fn = os.getpid
        monitor.start()
        self._monitor = monitor

        # Spot/preemptible TPU VMs: the metadata server's advance notice
        # becomes a SIGTERM to the user group, so save-on-preemption
        # handlers run inside the warning window (executor/preemption.py;
        # silently off when no metadata server answers).
        from tony_tpu_torch.executor.preemption import start_for_executor
        preempt_watcher = start_for_executor(_user_proc)

        tb_proc = None
        ports_released = False
        exit_code = constants.EXIT_FAILURE
        try:
            # The user process runs inside a loop because of elastic
            # resizes (coordinator/elastic.py): a drained survivor PARKS
            # — re-registers its existing identity under the new
            # membership generation, waits at the barrier, and relaunches
            # the user command at the new world size — instead of
            # reporting an exit. Exactly one iteration for non-elastic
            # jobs (the common case breaks at the bottom).
            while True:
                rank, world, members = self._gang_position(cluster_spec)
                me = TaskIdentity(self.job_name, rank, world,
                                  self.is_chief,
                                  self.rendezvous_port.port)
                env = runtime.build_env(cluster_spec, me, self.conf)
                # Reference-compat aliases: user scripts written against
                # the reference read bare names (Constants.java:104-110 —
                # JOB_NAME/TASK_INDEX/... without the TONY_ prefix).
                # TASK_INDEX/TASK_NUM are the DENSE rank and world: after
                # a shrink the member indices are sparse, and what user
                # data pipelines need is their position in the gang.
                env.update({
                    "JOB_NAME": self.job_name,
                    "TASK_INDEX": str(rank),
                    "TASK_NUM": str(world),
                    "IS_CHIEF": "true" if self.is_chief else "false",
                    "SESSION_ID": str(self.session_id),
                })
                env[constants.GANG_MEMBERS] = ",".join(
                    str(m) for m in members)
                if self.mgen >= 0:
                    env[constants.MEMBERSHIP_GEN] = str(self.mgen)
                if self.tb_port is not None:
                    env[constants.TB_PORT] = str(self.tb_port.port)
                # The user process reports its own device stats here (it
                # owns the chips; see tony_tpu_torch/telemetry.py) and the
                # monitor tails the file.
                env[constants.METRICS_FILE] = metrics_file
                # On-demand profiling request channel: the telemetry
                # reporter polls this file for PROFILE directives the
                # executor writes off the heartbeat response.
                env[constants.PROFILE_REQUEST_ENV] = \
                    self._profile_request_path()
                # Hung-task diagnostics contract: `import tony_tpu_torch` in
                # the user process pre-registers a faulthandler
                # all-thread stack dump on this signal; _dump_user_stacks
                # delivers it on the coordinator's hung verdict.
                env.setdefault(constants.STACKDUMP_SIGNAL,
                               str(self._dump_signal))
                if tb_proc is None:
                    tb_proc = self._maybe_launch_tensorboard(env)
                if not ports_released:
                    # Release-before-exec dance (reference :224-249):
                    # ephemeral ports must be free for the user process
                    # to bind; reusable ports stay held.
                    if not self.rendezvous_port.reuse:
                        self.rendezvous_port.release()
                    if self.tb_port is not None:
                        self.tb_port.release()
                    ports_released = True
                user_span = self.tracer.start_span(
                    "executor.user_process", parent=self._run_span,
                    task=self.task_id,
                    attrs={"world": world, "rank": rank})
                try:
                    exit_code = procutil.execute_shell(
                        self.command,
                        timeout_s=self.conf.get_int(
                            K.TASK_EXECUTOR_EXECUTION_TIMEOUT_S, 0),
                        env=env, on_start=_on_user_start)
                    user_span.end(exit_code=exit_code)
                finally:
                    user_span.end(aborted=True)   # no-op when ended above
                    _user_proc[:] = []
                    # The group is reaped (execute_shell's finally); drop
                    # the pgid file so later backend kills can't TERM a
                    # recycled group id while the executor lingers
                    # through reporting/teardown (ADVICE r4: same-user
                    # pgid reuse isn't caught by the PermissionError
                    # guard).
                    try:
                        os.unlink(os.path.join(os.getcwd(),
                                               constants.USER_PGID_FILE))
                    except OSError:
                        pass
                log.info("user process for %s exited with %d",
                         self.task_id, exit_code)
                directive = self._take_resize_directive()
                if directive is None or self._orphaned_reason is not None:
                    break
                if str(directive.get("action")) == "release":
                    # Shrunk out of the gang: no coordinator wants this
                    # exit — the re-meshed topology no longer holds the
                    # task (a result report would be fenced anyway).
                    self._released = True
                    break
                if directive.get("migrate"):
                    # Live migration: the gang relaunches on the
                    # DESTINATION slice under this same task identity.
                    # Waiting at the barrier would hand THIS incarnation
                    # the re-meshed spec meant for its replacement — two
                    # gangs training at once — so ack the park (the
                    # coordinator's drain completes on it) and exit with
                    # the quiet released shape.
                    log.warning("migrating to %r under membership "
                                "generation %d: acking the drain and "
                                "exiting %s", directive.get("target"),
                                self.mgen, self.task_id)
                    park_span = self.tracer.start_span(
                        "executor.park", parent=self._run_span,
                        task=self.task_id,
                        attrs={"mgen": self.mgen, "migrate": True})
                    acked = self._park_ack_for_migration()
                    park_span.end(acked=acked)
                    self._released = True
                    break
                # PARK: re-register the existing identity under the new
                # membership generation and wait at the barrier for the
                # re-meshed spec — the user process relaunches at the
                # new world size and resumes from the checkpoint.
                log.warning("parked for resize (membership generation "
                            "%d): re-registering %s", self.mgen,
                            self.task_id)
                self._beacon_steps = None
                park_span = self.tracer.start_span(
                    "executor.park", parent=self._run_span,
                    task=self.task_id, attrs={"mgen": self.mgen})
                try:
                    cluster_spec = self.register_and_get_cluster_spec()
                except FencedError as e:
                    park_span.end(fenced=True)
                    log.error("park re-registration fenced for %s: %s",
                              self.task_id, e)
                    hb.stop()
                    self._run_span.end(fenced=True)
                    self._flush_trace()
                    return constants.EXIT_KILLED
                park_span.end(barrier_open=cluster_spec is not None)
                if cluster_spec is None:
                    log.error("post-resize barrier timed out for %s",
                              self.task_id)
                    hb.stop()
                    self._run_span.end(barrier_timeout=True)
                    self._flush_trace()
                    return constants.EXIT_FAILURE
                self._flush_trace()
        finally:
            if preempt_watcher is not None:
                preempt_watcher.stop()
            monitor.stop()
            if self.rendezvous_port.reuse:
                self.rendezvous_port.release()
            self._teardown_tensorboard(tb_proc)
        # A short task can finish before the heartbeater's next beacon
        # poll: read the final telemetry snapshot once more so the
        # first-step span lands even for one-step jobs (the bench probe).
        try:
            self._progress_beacon()
        except Exception:  # noqa: BLE001 — diagnostics only
            pass
        self._maybe_upload_profile()

        if self._released:
            # Released by a shrink: exit quietly with the preemption
            # shape. The coordinator absorbs the backend completion (the
            # task left the matrix at the re-mesh) — reporting a result
            # for a topology that no longer exists would only be fenced.
            hb.stop()
            log.warning("released from the gang by an elastic resize; "
                        "exiting")
            self._run_span.end(released=True)
            self._flush_trace()
            return constants.EXIT_PREEMPTED

        if self._orphaned_reason is not None:
            # The user process was stopped BY the orphan/fencing teardown:
            # there is no coordinator that wants this result (dead, or a
            # successor that fenced us out of a newer epoch). Reporting
            # the exit would be wrong on top of useless — a stale result
            # landing in a recovered session is exactly what the epoch
            # fence exists to stop.
            hb.stop()
            log.error("exiting as orphaned executor: %s",
                      self._orphaned_reason)
            self._run_span.end(orphaned=self._orphaned_reason)
            return constants.EXIT_KILLED
        hb.stop()
        # Close + ship the whole executor tree BEFORE reporting the
        # result: once the coordinator processes the exit it may tear the
        # epoch down, and these frames should already be in the log.
        self._run_span.end(exit_code=exit_code)
        self._flush_trace()
        self._report_result_with_recovery(
            exit_code, diagnostics=self._postmortem_diagnostics(exit_code))
        self._maybe_skew_sleep()
        return exit_code

    def _postmortem_diagnostics(self, exit_code: int) -> Optional[dict]:
        """Failed user process: extract the postmortem the coordinator
        can't reliably get itself — the last Python traceback from the
        task's own log tail (always local to THIS host, unlike the
        coordinator's view of it) and the decoded exit signal. Rides the
        result report into the TASK_FINISHED event and the incident
        bundle."""
        if exit_code == 0:
            return None
        from tony_tpu_torch.diagnosis.exitcodes import describe_exit
        from tony_tpu_torch.utils import logs as logutil

        diag: Dict[str, str] = {"exit_detail": describe_exit(exit_code)}
        for name in ("stderr.log", "stdout.log"):
            text = logutil.tail_text(os.path.join(os.getcwd(), name),
                                     64 * 1024)
            if not text:
                continue
            tb = logutil.extract_traceback(text)
            if tb:
                diag["traceback"] = tb
                break
        return diag

    def _report_result_with_recovery(
            self, exit_code: int,
            diagnostics: Optional[dict] = None) -> None:
        """Deliver the exit code, surviving a coordinator outage. A task
        that FINISHES while the coordinator is down would otherwise
        discard its result after one failed call — and the recovered
        coordinator, finding nobody to re-adopt, would burn a retry epoch
        re-running work that already completed (caught live in the
        recovery drill). Same contract as the heartbeat loop: re-resolve
        + retry inside the orphan deadline; a FencedError (stale epoch
        after a reset, or a superseding generation) is terminal — that
        result belongs to a world that no longer exists."""
        deadline = time.monotonic() + float(
            self.conf.get_int(K.TASK_ORPHAN_DEADLINE_S, 120))
        while True:
            try:
                self.client.call("register_execution_result",
                                 task_id=self.task_id, exit_code=exit_code,
                                 session_id=self.session_id,
                                 diagnostics=diagnostics)
                return
            except FencedError as e:
                log.warning("result for %s fenced by a live coordinator: "
                            "%s", self.task_id, e)
                return
            except Exception as e:  # noqa: BLE001
                if time.monotonic() >= deadline:
                    log.warning("failed to report execution result within "
                                "the orphan deadline: %s", e)
                    return
                log.info("result report failed (%s); re-resolving the "
                         "coordinator and retrying", e)
                time.sleep(1.0)
                self._resolve_coordinator()
                old, self.client = self.client, self._make_client(
                    self.coordinator_host, self.coordinator_port)
                old.close()

    def _maybe_upload_profile(self) -> None:
        """Remote-store jobs: ship the chief's captured traces home (the
        coordinator pulls them into the job dir at stop — see
        Coordinator._profile_store_url). Best-effort: a failed upload must
        not turn a finished task into a failure."""
        url = os.environ.get(constants.PROFILE_UPLOAD, "")
        local = os.environ.get(constants.PROFILE_DIR, "")
        if not url or not local:
            return
        local = os.path.join(os.getcwd(), local) \
            if not os.path.isabs(local) else local
        if not os.path.isdir(local):
            return
        try:
            from tony_tpu_torch.storage import get_store

            get_store(url).put_tree(local, url)
            log.info("uploaded profiler traces to %s", url)
        except Exception as e:  # noqa: BLE001
            log.warning("profile upload failed: %s", e)

    def _maybe_launch_tensorboard(self, env: Dict[str, str]):
        """Chief-only: spawn the configured TensorBoard command on the
        reserved TB_PORT (the URL was registered at setup_ports; serving is
        new — the reference left launching to user scripts)."""
        cmd = str(self.conf.get(K.APPLICATION_TENSORBOARD_COMMAND, "") or "")
        if not cmd or not self.is_chief or self.tb_port is None:
            return None
        import subprocess

        full_env = dict(os.environ)
        full_env.update(env)
        log.info("chief launching tensorboard: %s", cmd)
        self._tb_log = open("tensorboard.log", "ab")
        try:
            return subprocess.Popen(cmd, shell=True, env=full_env,
                                    stdout=self._tb_log,
                                    stderr=subprocess.STDOUT)
        except Exception:
            self._tb_log.close()
            self._tb_log = None
            raise

    def _teardown_tensorboard(self, tb_proc) -> None:
        """Terminate→wait→kill escalation; must never raise — it runs in
        run()'s finally, after the user exit code is already in hand."""
        if tb_proc is not None:
            if tb_proc.poll() is None:
                tb_proc.terminate()
                try:
                    tb_proc.wait(timeout=5)
                except Exception:  # noqa: BLE001 — escalate to SIGKILL
                    tb_proc.kill()
                    try:
                        tb_proc.wait(timeout=5)
                    except Exception:  # noqa: BLE001 — unreapable; move on
                        log.warning("tensorboard process unreapable")
            log_f = getattr(self, "_tb_log", None)
            if log_f is not None:
                log_f.close()
                self._tb_log = None

    def _maybe_skew_sleep(self) -> None:
        """TEST_EXECUTOR_SKEW='job#idx#seconds' straggler simulation
        (reference :372-392)."""
        spec = os.environ.get(constants.TEST_EXECUTOR_SKEW, "")
        if not spec:
            return
        try:
            job, idx, seconds = spec.split("#")
            if job == self.job_name and int(idx) == self.index:
                log.warning("TEST hook: skew sleep %ss", seconds)
                time.sleep(float(seconds))
        except ValueError:
            log.warning("bad %s spec: %r", constants.TEST_EXECUTOR_SKEW, spec)


def main() -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    # BEFORE anything talks to the network: the injected faults may target
    # the very RPC/storage calls that bootstrap this executor (fetching
    # the frozen config, registration) — env, not conf, carries the spec.
    from tony_tpu_torch import faults

    faults.install_from_env()
    signal.signal(signal.SIGTERM, _forward_signal)
    signal.signal(signal.SIGINT, _forward_signal)
    executor = TaskExecutor()
    code = executor.run()
    return code


if __name__ == "__main__":
    sys.exit(main())
