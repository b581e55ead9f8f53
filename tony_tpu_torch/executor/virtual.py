"""Beat-only virtual executors: the control-plane width harness.

Every drill so far ran ≤8 virtual hosts because each task cost a whole
executor subprocess plus a user process. This module keeps everything
the CONTROL PLANE sees — real RPC frames over real TCP (register →
barrier poll → heartbeat with a progress/metrics beacon → execution
result), real journal records, real fencing (session epoch, membership
generation) — and drops everything it doesn't: no subprocess, no user
command, no ports, no localization. One :class:`VirtualGang` multiplexes
hundreds of virtual tasks over a small beat pump (a deadline heap +
``tony.scale.virtual-pump-threads`` worker threads, one RPC connection
per worker), so 128–1024 registered tasks per box fit in CI-sized time
— the width at which the coordinator's O(n)-per-tick loops
(coordinator/coordphases.py) become measurable.

Task state machine (one RPC call per firing, rescheduled on the heap):

    register --(spec != None: barrier open)--> beat --(run_s up)--> finish
        ^                                       |
        '----(resize directive: park under new mgen)

A ``release`` resize directive ends the task unreported with exit 143
(exactly what a real released executor does); fencing errors
(FencedError / StaleGenerationError) are terminal without a report, like
a real executor's teardown. ``register_execution_result`` carries exit 0
when ``run_s`` elapses — jobs built on virtual gangs SUCCEED through the
ordinary completion path.
"""

from __future__ import annotations

import heapq
import logging
import threading
import time
from typing import Dict, Optional

from tony_tpu_torch import faults
from tony_tpu_torch.rpc.wire import FencedError, RpcClient

log = logging.getLogger(__name__)

#: task states
_REGISTER = "register"
_BEAT = "beat"
_FINISH = "finish"


class VirtualTaskHandle:
    """Popen-shaped handle for the backend: ``poll()`` returns the final
    exit code once the virtual task ended, else None."""

    def __init__(self, task_id: str):
        self.task_id = task_id
        self.returncode: Optional[int] = None

    def poll(self) -> Optional[int]:
        return self.returncode


class _VTask:
    def __init__(self, task_id: str, session_id: int, mgen: int,
                 seq: int):
        self.task_id = task_id
        self.session_id = session_id
        self.mgen = mgen
        self.seq = seq
        self.state = _REGISTER
        self.handle = VirtualTaskHandle(task_id)
        self.started = time.monotonic()
        self.beat_t0: Optional[float] = None   # set when the barrier opens
        self.errors = 0

    @property
    def done(self) -> bool:
        return self.handle.returncode is not None


class _Clients(threading.local):
    client: Optional[RpcClient] = None


class VirtualGang:
    """Shared beat pump for one coordinator's virtual tasks."""

    #: consecutive RPC failures before a virtual task is declared dead
    #: (exit 137 — the vanished-host shape the coordinator must absorb
    #: or fail exactly like a real loss).
    MAX_ERRORS = 3

    def __init__(self, host: str, port: int, token: Optional[str] = None,
                 generation: int = 0, hb_interval_s: float = 1.0,
                 steps_per_s: float = 5.0, run_s: float = 0.0,
                 pump_threads: int = 8):
        self._addr = (host, int(port))
        self._token = token or None
        self._generation = int(generation)
        self.hb_interval_s = max(0.05, float(hb_interval_s))
        self.steps_per_s = float(steps_per_s)
        self.run_s = float(run_s)
        self._pump_threads = max(1, int(pump_threads))
        self._tasks: Dict[str, _VTask] = {}
        self._heap: list = []          # (deadline, seq, task_id)
        self._cv = threading.Condition()
        self._stopping = False
        self._seq = 0
        self._threads: list = []
        self._tls = _Clients()

    # -- lifecycle --------------------------------------------------------
    def launch(self, task_id: str, session_id: int = 0,
               mgen: int = -1) -> VirtualTaskHandle:
        with self._cv:
            self._seq += 1
            task = _VTask(task_id, int(session_id), int(mgen), self._seq)
            self._tasks[task_id] = task
            # Deterministic stagger: registrations spread over one beat
            # interval instead of arriving in lockstep (a gang-sized
            # thundering herd would measure the herd, not the plane).
            delay = (self._seq % 97) * (self.hb_interval_s / 97.0)
            heapq.heappush(self._heap,
                           (time.monotonic() + delay, self._seq, task_id))
            self._ensure_threads()
            self._cv.notify()
        return task.handle

    def kill(self, task_id: str, exit_code: int = 143) -> None:
        """Backend kill: the virtual task stops calling home and reads as
        exited-by-signal (the TERM shape by default)."""
        with self._cv:
            task = self._tasks.get(task_id)
            if task is not None and not task.done:
                task.handle.returncode = exit_code

    def stop(self) -> None:
        with self._cv:
            self._stopping = True
            for task in self._tasks.values():
                if not task.done:
                    task.handle.returncode = 143
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=2)

    def live_count(self) -> int:
        with self._cv:
            return sum(1 for t in self._tasks.values() if not t.done)

    # -- pump -------------------------------------------------------------
    def _ensure_threads(self) -> None:
        while len(self._threads) < self._pump_threads:
            t = threading.Thread(
                target=self._worker, daemon=True,
                name=f"virtual-pump-{len(self._threads)}")
            self._threads.append(t)
            t.start()

    def _client(self) -> RpcClient:
        if self._tls.client is None:
            self._tls.client = RpcClient(
                self._addr[0], self._addr[1], token=self._token,
                generation=self._generation, max_retries=2,
                retry_sleep_s=0.2, call_timeout_s=30.0,
                peer="coordinator")
        return self._tls.client

    def _worker(self) -> None:
        while True:
            with self._cv:
                while True:
                    if self._stopping:
                        return
                    now = time.monotonic()
                    if self._heap and self._heap[0][0] <= now:
                        _, _, task_id = heapq.heappop(self._heap)
                        task = self._tasks.get(task_id)
                        break
                    timeout = (self._heap[0][0] - now) if self._heap \
                        else 0.5
                    self._cv.wait(timeout=min(max(timeout, 0.0), 0.5))
            if task is None or task.done:
                continue
            try:
                next_in = self._fire(task)
            except Exception:  # noqa: BLE001 — the pump must survive
                log.exception("virtual task %s pump error", task.task_id)
                next_in = self.hb_interval_s
            if next_in is None or task.done:
                continue
            with self._cv:
                self._seq += 1
                heapq.heappush(
                    self._heap,
                    (time.monotonic() + next_in, self._seq,
                     task.task_id))
                self._cv.notify()

    def _apply_directives(self, task: _VTask, resp) -> Optional[float]:
        """Fold a heartbeat response's directives into the task's state
        machine. Returns the next-fire delay when a directive decided it
        (park / release), else None (the caller continues as usual)."""
        if not isinstance(resp, dict):
            return None
        rz = resp.get("resize")
        if isinstance(rz, dict) and int(rz.get("mgen", -1)) > task.mgen:
            task.mgen = int(rz["mgen"])
            if rz.get("action") == "release":
                # Released members exit 143 unreported, like the real
                # executor's release path.
                task.handle.returncode = 143
                return None
            # Drain: "TERM the user process" is a no-op here; park =
            # re-register under the new generation, promptly.
            task.state = _REGISTER
            return 0.05
        return None

    # -- one state-machine step ------------------------------------------
    def _fire(self, task: _VTask) -> Optional[float]:
        client = self._client()
        job, _, index = task.task_id.partition(":")
        try:
            if task.state == _REGISTER:
                # Host/port are synthetic but structurally real: the
                # cluster spec the barrier broadcasts is built from them.
                spec = client.call(
                    "register_worker_spec", task_id=task.task_id,
                    host=f"vh-{index}", port=20000 + int(index or 0),
                    session_id=task.session_id, mgen=task.mgen)
                if spec is None:
                    # Barrier still closed. Beat anyway, like the real
                    # executor (its Heartbeater starts BEFORE
                    # registration): the resize directive rides
                    # heartbeat responses, and a task that only polled
                    # the barrier could never learn the membership
                    # generation a drain is waiting for it to park
                    # under — a deadlock the real stack cannot have.
                    resp = client.call("task_executor_heartbeat",
                                       task_id=task.task_id,
                                       session_id=task.session_id,
                                       mgen=task.mgen)
                    self._apply_directives(task, resp)
                    return self.hb_interval_s
                task.state = _BEAT
                if task.beat_t0 is None:
                    task.beat_t0 = time.monotonic()
                task.errors = 0
                return self.hb_interval_s
            if task.state == _FINISH:
                client.call("register_execution_result",
                            task_id=task.task_id, exit_code=0,
                            session_id=task.session_id)
                task.handle.returncode = 0
                return None
            # _BEAT: one heartbeat with a synthetic progress beacon —
            # real beacon_fold work for the coordinator, real liveness.
            # host.loss here mirrors the real executor's heartbeat-loop
            # poll (executor.py): a firing kills THIS virtual host with
            # the vanished-host exit shape. ``task:*`` correlates the
            # loss across hosts — the chaos planner's multi-host-death
            # schedules ride this one site.
            if faults.fire("host.loss", task_id=task.task_id):
                log.warning("FAULT host.loss: virtual task %s vanishes",
                            task.task_id)
                task.handle.returncode = 137
                return None
            steps = self.steps_per_s * (time.monotonic()
                                        - (task.beat_t0 or task.started))
            progress = {"steps": round(steps, 2), "age_s": 0.0,
                        "metrics": {"steps_per_sec": self.steps_per_s}}
            resp = client.call("task_executor_heartbeat",
                               task_id=task.task_id,
                               session_id=task.session_id,
                               progress=progress, mgen=task.mgen)
            task.errors = 0
            next_in = self._apply_directives(task, resp)
            if next_in is not None or task.done:
                return next_in
            if self.run_s and time.monotonic() - task.started \
                    >= self.run_s:
                task.state = _FINISH
                return 0.0
            return self.hb_interval_s
        except FencedError as e:
            # Terminal verdict about this task's topology/epoch — tear
            # down without a report, exactly like a fenced executor.
            log.info("virtual task %s fenced: %s", task.task_id, e)
            task.handle.returncode = 143
            # The fenced client connection is closed; drop it so the
            # worker's next task gets a fresh one.
            self._tls.client = None
            return None
        except Exception as e:  # noqa: BLE001 — RPC trouble is survivable
            task.errors += 1
            self._tls.client = None
            if task.errors >= self.MAX_ERRORS:
                log.warning("virtual task %s giving up after %d RPC "
                            "failures: %s", task.task_id, task.errors, e)
                task.handle.returncode = 137     # vanished-host shape
                return None
            return self.hb_interval_s
