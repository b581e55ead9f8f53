"""Deterministic fault-injection harness: rehearse infra failure on purpose.

The port's own copy of ``tony_tpu/faults.py`` (the port imports nothing of
``tony_tpu``): the same sites, spec grammar and seeding. In the port the
training loop fires ``checkpoint.save``, ``ckpt.async-write``
(``checkpoint/manager.py``), ``user.hang``, ``user.slow_step`` and
``profile.capture`` (``telemetry.py``); the rest wait for the control plane.

The reference proved its robustness story with env-hook faults compiled
into production code (``Constants.java:116-121``: AM crash, worker
termination, heartbeat misses, completion delay) — deterministic enough
to drive an E2E matrix (``TestTonyE2E.java``). This module generalizes
that idea into one conf-driven, seeded subsystem with injection sites
threaded through every layer that talks to unreliable infrastructure:

========================  =====================================================
site                      where it fires
========================  =====================================================
``rpc.connect``           RpcClient._connect, before the TCP connect
``rpc.send``              RpcClient.call, before a request frame is sent
``heartbeat``             Heartbeater loop (a firing skips that heartbeat)
``executor.spawn``        backend launch_task, before the process spawn
``storage.put``           Store.put_file via the retrying wrapper
``storage.get``           Store.get_file via the retrying wrapper
``checkpoint.save``       CheckpointManager.save, before the orbax call
``coordinator.crash``     Coordinator._monitor loop: hard os._exit(137) —
                          the SIGKILL shape that --recover must survive
``executor.reregister``   executor reconnect: drops a re-registration
                          attempt during coordinator-loss recovery
``user.hang``             telemetry.step_done: a firing silently drops the
                          step recording — heartbeats continue, progress
                          freezes (the hung-user-process shape)
``user.slow_step``        telemetry.step_done: a firing delays the step by
                          ``amt:`` seconds — one task's step rate skews
                          below the gang median (the straggler shape)
``rpc.slow``              RpcClient.call: a firing delays the request by
                          ``amt:`` seconds before it is sent — injected
                          control-plane latency that never drops a frame
                          (exercises trace spans + latency histograms)
``pool.lease``            backend warm-pool adoption, before the lease RPC
                          — the lease-refused/daemon-unreachable shape;
                          the backend must cold-spawn instead
``pool.stale``            backend warm-pool adoption, before the lease RPC
                          — simulates the daemon's stale-generation lease
                          refusal (a zombie epoch trying to lease); the
                          backend must cold-spawn instead
``pool.adopt``            backend warm-pool adoption, after a granted
                          lease — the leased-executor-dead-on-adoption
                          shape; the backend must discard the lease and
                          cold-spawn instead
``host.loss``             executor heartbeat loop: a firing SIGKILLs the
                          user process group and hard-exits the executor
                          (os._exit 137) — sudden whole-host death, the
                          shape elastic shrink-and-continue absorbs;
                          combine ``after:N``/``task:ID`` to fell one
                          deterministic virtual host mid-run
``resize.barrier``        coordinator elastic re-mesh, once per resize
                          after the new topology is applied — a failed
                          post-resize re-registration barrier; the resize
                          aborts INFRA_TRANSIENT into the retry machinery
``resize.remesh``         coordinator elastic re-mesh, once per resize
                          before the member set is rebuilt — a failed
                          topology application; same abort path
``profile.capture``       telemetry on-demand device capture, at the step
                          boundary that would arm jax.profiler — the
                          unsupported/failed-capture shape; the task
                          reports PROFILE_FAILED on the next beat and
                          training continues (capture must never kill or
                          stall the job)
``quant.probe``           ops/quant.py backend support probe for the
                          int8/fp8 matmul path — a firing simulates an
                          unsupported backend; the model must degrade to
                          bf16 with a one-time beacon warning, never
                          fail the job
``coord.slow-tick``       Coordinator._monitor loop: a firing stalls the
                          tick by ``amt:`` seconds before any per-tick
                          work — the overloaded-control-plane shape the
                          coordinator's own phase accounting must
                          surface (tick duration in ``top``, the
                          control-plane verdicts); the call counter is
                          monitor iterations
``fleet.grant``           fleet daemon grant application, after the
                          placement decision and the write-ahead grant
                          record but before the job spawn — the
                          unspawnable-grant shape; the job must stay
                          QUEUED and be retried, never lost
``fleet.preempt``         fleet daemon preempt-to-reclaim, before the
                          victim's elastic shrink RPC — the
                          unreachable-victim shape; the preemption (and
                          the grant waiting on the reclaimed hosts) is
                          retried on a later tick, the victim keeps
                          running
``fleet.ledger``          fleet goodput-ledger fold (reading a job's
                          span tree / perf.json / events into phase
                          accounting) — a firing simulates a corrupt
                          artifact; the fleet degrades to counters-only
                          with a one-time warning and the scheduler
                          tick never blocks or fails
``fleet.explain``         fleet decision-record journal write
                          (REC_FLEET_DECISION) — a firing simulates a
                          full/failed disk on the observability path;
                          the decision is still applied (ring + event),
                          one-time warning, scheduling unaffected
``ckpt.async-write``      checkpoint background writer, before the
                          serialized bytes are handed to orbax — the
                          failed-in-flight-async-save shape; the step
                          is NOT committed (no manifest), restore falls
                          back to the last committed step, training
                          continues
``migrate.snapshot``      coordinator migration, before the drained
                          gang's state is sealed for the move — the
                          failed-snapshot shape; the migration aborts
                          into the ordinary INFRA_TRANSIENT retry
                          ladder (never worse than a host loss)
``migrate.adopt``         coordinator migration, after the topology
                          moved but before destination executors
                          launch — the unadoptable-destination shape;
                          same abort path
``slice.preempt``         fleet slice-reclaim notice poll: a firing
                          marks one held slice as dying (the
                          queued-resource spot-reclaim shape) so the
                          fleet rehearses proactive migration off it
``rpc.partition``         RpcClient.call, per frame and per DIRECTION —
                          ``dir:c2s`` drops the request before it is
                          sent (the callee never sees it), ``dir:s2c``
                          drops the RESPONSE after the callee has
                          already processed the request (its side
                          effects land; the caller sees a reset and
                          retries) — the asymmetric-partition shape;
                          ``peer:NAME`` scopes the cut to one wire
                          (coordinator / pool / fleet)
``disk.full``             utils/durable AppendLog.append, before the
                          write — ENOSPC on the fsync'd journal append;
                          the writer must degrade LOUDLY (terminal
                          INFRA verdict / daemon stop), never silently
                          truncate, and ``--recover`` must replay the
                          committed prefix
``disk.torn``             utils/durable — AppendLog.append writes a
                          torn partial record then fails EIO, and
                          atomic_write drops the rename (old bytes
                          survive) — the power-cut-mid-write shape the
                          replay-of-prefix readers must absorb
``host.flaky``            fleet daemon health tick, per running job and
                          assigned host (``task:<host>`` pins it, e.g.
                          ``task:s0h2``) — a firing attributes an
                          INFRA_TRANSIENT failure to that host and
                          kills the job, the recurring-bad-hardware
                          shape the quarantine ledger must cordon
``health.probe``          fleet preflight probe (health.preflight_probe),
                          per probed host before a grant books it —
                          a firing simulates a host failing its port
                          bind / durable-write check; the grant must
                          self-repair by cordoning the host and
                          substituting a spare, never spawn on it
========================  =====================================================

Spec grammar (the value of ``tony.fault.<site>`` conf keys, or one
``;``-separated assignment list in the ``TONY_FAULTS`` env var):

- ``first:N``   — fire on the first N calls of the site (per process)
- ``at:K``      — fire on call K only (1-based)
- ``after:N``   — fire on every call past the first N (the freeze shape:
  progress that starts fine and then stops forever)
- ``every:N``   — fire on every Nth call
- ``p:X``       — fire with probability X, from a per-site RNG seeded
  with (seed, site) — the sequence of decisions is identical for a given
  seed, machine-independent
- ``prob:P``    — fire with probability P, decided by a stable hash of
  (seed, site, call-index): unlike ``p:X``'s sequential RNG the decision
  for call #N is a pure function of the seed — chaos schedules can
  predict, replay and SHRINK around it. Seed comes from the injector
  (``seed=N`` / ``tony.fault.seed``), defaulting to ``TONY_FAULT_SEED``
- ``session:S`` — additional filter: only fire when this process's
  ``TONY_SESSION_ID`` is S (lets a fault hit epoch 0 and spare the retry)
- ``task:T``    — additional filter: only fire when this process's
  ``TONY_TASK_ID`` is T (e.g. ``task:worker:1`` — slow ONE gang member)
- ``amt:X``     — payload for sites that take a magnitude (float,
  site-interpreted: ``user.slow_step`` reads it as seconds of delay)
- ``dir:D``     — additional filter for directional sites
  (``rpc.partition``): only fire when the call site reports direction D
  (``c2s`` = request frames, ``s2c`` = response frames)
- ``peer:NAME`` — additional filter for labelled wires: only fire when
  the call site reports peer NAME (the RpcClient's ``peer`` label:
  ``coordinator``, ``pool``, ``fleet``)

Tokens combine with ``,``: ``p:0.5,session:0``. Example conf:

    tony.fault.seed = 7
    tony.fault.rpc-send = first:2
    tony.fault.storage-get = p:0.3,session:0

Plumbing: the coordinator installs from its conf and forwards the same
spec to every executor via the ``TONY_FAULTS`` env var (executors must be
able to inject into the storage fetch of the very config that carries the
keys); the client installs from conf at submit for its staging I/O.

Zero overhead when disabled: ``fire(site)`` is a module-global None check
— no dict lookups, no RNG, nothing to configure away in production.
"""

from __future__ import annotations

import hashlib
import logging
import os
import random
import threading
from typing import Any, Dict, List, Optional, Tuple

log = logging.getLogger(__name__)

#: env var carrying the serialized spec into executor/user processes
FAULTS_ENV = "TONY_FAULTS"

#: env var supplying the DEFAULT injector seed (chaos schedules export it
#: so ``prob:P`` decisions replay bit-identically in every child process;
#: an explicit ``seed=N`` token / ``tony.fault.seed`` conf still wins)
FAULT_SEED_ENV = "TONY_FAULT_SEED"

#: the canonical site names (kept in lockstep with the conf keys in
#: tony_tpu_torch/conf/keys.py: ``tony.fault.<site with . -> ->``)
SITES = ("rpc.connect", "rpc.send", "rpc.slow", "heartbeat",
         "executor.spawn", "storage.put", "storage.get", "checkpoint.save",
         "coordinator.crash", "executor.reregister",
         "user.hang", "user.slow_step",
         "pool.lease", "pool.stale", "pool.adopt",
         "host.loss", "resize.barrier", "resize.remesh",
         "profile.capture", "quant.probe", "coord.slow-tick",
         "fleet.grant", "fleet.preempt", "fleet.ledger", "fleet.explain",
         "ckpt.async-write", "migrate.snapshot", "migrate.adopt",
         "slice.preempt", "rpc.partition", "disk.full", "disk.torn",
         "host.flaky", "health.probe", "alerts.eval")


class InjectedFault(ConnectionError):
    """Raised by injection sites that simulate transport/IO failure.

    Subclasses ConnectionError (hence OSError) on purpose: the production
    retry paths — RPC reconnect, storage transfer retry — must treat an
    injected fault EXACTLY like a real reset, with no fault-harness
    special-casing in the code under test.
    """

    def __init__(self, site: str, call_no: int) -> None:
        super().__init__(f"injected fault at {site} (call #{call_no})")
        self.site = site
        self.call_no = call_no


class _SiteRule:
    """Parsed spec + deterministic per-site decision state."""

    def __init__(self, site: str, spec: str, seed: int) -> None:
        self.site = site
        self.spec = spec
        self.first = 0
        self.at = 0
        self.after = 0
        self.every = 0
        self.p = 0.0
        self.prob = 0.0
        self.amount = 0.0
        self.session: Optional[int] = None
        self.task: Optional[str] = None
        self.direction: Optional[str] = None
        self.peer: Optional[str] = None
        for token in spec.split(","):
            token = token.strip()
            if not token:
                continue
            # Partition on the FIRST separator only: the task filter's
            # value legitimately contains ':' ("task:worker:1").
            key, sep, value = token.replace("=", ":", 1).partition(":")
            if not sep:
                raise ValueError(
                    f"fault spec token {token!r} for {site!r} needs "
                    f"key:value (one of first/at/after/every/p/prob/amt/"
                    f"session/task/dir/peer)")
            key = key.strip().lower()
            value = value.strip()
            try:
                if key == "first":
                    self.first = int(value)
                elif key == "at":
                    self.at = int(value)
                elif key == "after":
                    self.after = int(value)
                elif key == "every":
                    self.every = int(value)
                elif key == "p":
                    self.p = float(value)
                elif key == "prob":
                    self.prob = float(value)
                elif key == "amt":
                    self.amount = float(value)
                elif key == "session":
                    self.session = int(value)
                elif key == "task":
                    self.task = value
                elif key == "dir":
                    if value not in ("c2s", "s2c"):
                        raise ValueError(
                            f"dir: must be c2s or s2c, got {value!r}")
                    self.direction = value
                elif key == "peer":
                    self.peer = value
                else:
                    raise ValueError(f"unknown fault spec key {key!r}")
            except ValueError as e:
                raise ValueError(
                    f"bad fault spec {spec!r} for {site!r}: {e}") from e
        # Per-site RNG seeded by (seed, site): decision sequences are
        # reproducible and independent across sites.
        self._rng = random.Random(f"{seed}:{site}")
        self._seed = seed
        self._calls = 0
        self._lock = threading.Lock()

    def _hash_draw(self, n: int) -> float:
        """Stable uniform [0, 1) for call #n: a pure function of
        (seed, site, n) — unlike the sequential ``p:`` RNG, the decision
        for a given call index is independent of every other call, so a
        shrunk schedule keeps the surviving injections' decisions."""
        h = hashlib.sha256(
            f"{self._seed}:{self.site}:{n}".encode()).digest()
        return int.from_bytes(h[:8], "big") / float(1 << 64)

    def decide(self, direction: Optional[str] = None,
               peer: Optional[str] = None,
               task_id: Optional[str] = None) -> Tuple[bool, int]:
        """(fire?, call number) — one deterministic decision per call.

        ``dir:``/``peer:`` filters are scope, not outcome: an
        out-of-scope frame does NOT consume a call index, so
        ``dir:s2c,at:3`` means "the 3rd RESPONSE frame", not "call 3 if
        it happens to be a response".

        ``task_id`` lets IN-PROCESS callers (the virtual gang, where
        every task shares one process) name the task on whose behalf the
        site is polled; subprocess executors keep the env-derived
        identity. ``task:*`` matches every task — the correlated-loss
        spec (``host.loss=task:*,first:2`` kills the first two beats to
        poll, i.e. two DIFFERENT hosts near-simultaneously)."""
        if self.direction is not None and direction != self.direction:
            with self._lock:
                return False, self._calls
        if self.peer is not None and peer != self.peer:
            with self._lock:
                return False, self._calls
        # The task filter is scope too — WHEN the caller names the task
        # in-process (``task:worker:1,at:3`` = that task's 3rd poll, not
        # "poll 3 if it happens to be hers"). Subprocess executors keep
        # the env-derived post-counter check: their counter is already
        # per-process, so the filter always matches locally.
        if self.task is not None and task_id is not None:
            if self.task != "*" and task_id != self.task:
                with self._lock:
                    return False, self._calls
        with self._lock:
            self._calls += 1
            n = self._calls
            # Draw EVERY call so the p-sequence depends only on the call
            # index, not on which other tokens matched before it.
            draw = self._rng.random()
        if self.session is not None:
            env_session = int(os.environ.get("TONY_SESSION_ID", "0") or 0)
            if env_session != self.session:
                return False, n
        if self.task is not None and task_id is None:
            if self.task != "*" and \
                    os.environ.get("TONY_TASK_ID", "") != self.task:
                return False, n
        if self.first and n <= self.first:
            return True, n
        if self.at and n == self.at:
            return True, n
        if self.after and n > self.after:
            return True, n
        if self.every and n % self.every == 0:
            return True, n
        if self.p and draw < self.p:
            return True, n
        if self.prob and self._hash_draw(n) < self.prob:
            return True, n
        return False, n


class FaultInjector:
    def __init__(self, rules: Dict[str, str], seed: int = 0) -> None:
        unknown = set(rules) - set(SITES)
        if unknown:
            raise ValueError(
                f"unknown fault site(s) {sorted(unknown)}; known: "
                f"{list(SITES)}")
        self.seed = seed
        self.rules = {site: _SiteRule(site, spec, seed)
                      for site, spec in rules.items() if spec}

    def fire(self, site: str, task_id: Optional[str] = None) -> bool:
        rule = self.rules.get(site)
        if rule is None:
            return False
        fired, call_no = rule.decide(task_id=task_id)
        if fired:
            log.warning("FAULT INJECTED at %s (call #%d, spec %r)",
                        site, call_no, rule.spec)
        return fired

    def fire_amount(self, site: str) -> Optional[float]:
        """Like fire(), but returns the rule's ``amt:`` payload when the
        site fires (None otherwise) — for magnitude-style sites
        (user.slow_step: seconds of injected delay per fired step)."""
        rule = self.rules.get(site)
        if rule is None:
            return None
        fired, call_no = rule.decide()
        if not fired:
            return None
        log.warning("FAULT INJECTED at %s (call #%d, spec %r, amt %g)",
                    site, call_no, rule.spec, rule.amount)
        return rule.amount

    def check(self, site: str) -> None:
        """Raise InjectedFault when the site fires (transport-style sites)."""
        rule = self.rules.get(site)
        if rule is None:
            return
        fired, call_no = rule.decide()
        if fired:
            log.warning("FAULT INJECTED at %s (call #%d, spec %r)",
                        site, call_no, rule.spec)
            raise InjectedFault(site, call_no)

    def check_partition(self, site: str, direction: str, peer: str) -> None:
        """Directional ``check``: the wire layer reports which way the
        frame is travelling (``c2s``/``s2c``) and over which labelled
        wire; a rule's ``dir:``/``peer:`` filters scope the cut."""
        rule = self.rules.get(site)
        if rule is None:
            return
        fired, call_no = rule.decide(direction=direction, peer=peer)
        if fired:
            log.warning("FAULT INJECTED at %s (call #%d, dir %s, peer %s, "
                        "spec %r)", site, call_no, direction, peer,
                        rule.spec)
            raise InjectedFault(site, call_no)

    def to_env_value(self) -> str:
        """Serialize for the TONY_FAULTS env passthrough."""
        parts = [f"seed={self.seed}"]
        parts += [f"{site}={rule.spec}"
                  for site, rule in sorted(self.rules.items())]
        return ";".join(parts)


#: THE hot-path switch. None = disabled = zero overhead beyond one global
#: read; production code never pays for the harness it isn't using.
_active: Optional[FaultInjector] = None


def active() -> Optional[FaultInjector]:
    return _active


def fire(site: str, task_id: Optional[str] = None) -> bool:
    """Did the site fire? (bool-style sites: heartbeat skip). In-process
    multi-task callers pass ``task_id`` for the ``task:`` filter;
    subprocess callers rely on the TONY_TASK_ID env identity."""
    inj = _active
    return inj is not None and inj.fire(site, task_id=task_id)


def fire_amount(site: str) -> Optional[float]:
    """Did the site fire, and with what ``amt:`` payload? None = no
    (magnitude-style sites: user.slow_step)."""
    inj = _active
    return inj.fire_amount(site) if inj is not None else None


def check(site: str) -> None:
    """Raise InjectedFault if the site fires (exception-style sites)."""
    inj = _active
    if inj is not None:
        inj.check(site)


def check_partition(site: str, direction: str, peer: str) -> None:
    """Raise InjectedFault if the directional site fires for this
    (direction, peer) — the asymmetric-partition hook (rpc.partition)."""
    inj = _active
    if inj is not None:
        inj.check_partition(site, direction, peer)


def env_seed(default: int = 0) -> int:
    """The ambient injector seed: TONY_FAULT_SEED when set (chaos runs
    export it), else ``default``."""
    raw = os.environ.get(FAULT_SEED_ENV, "")
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        log.warning("ignoring non-integer %s=%r", FAULT_SEED_ENV, raw)
        return default


def install(injector: Optional[FaultInjector]) -> None:
    global _active
    _active = injector
    if injector is not None and injector.rules:
        from tony_tpu_torch import retry as _retry

        # Seeded faults deserve seeded backoff jitter: the full schedule
        # of a rehearsed failure is then reproducible end to end.
        _retry.seed_default_rng(injector.seed)
        log.warning("fault injection ACTIVE: %s",
                    injector.to_env_value())


def uninstall() -> None:
    install(None)


def parse_spec(spec: str, default_seed: Optional[int] = None) -> "FaultInjector":
    """Parse the serialized ``site=spec;site=spec;seed=N`` form. With no
    explicit default, the seed falls back to TONY_FAULT_SEED then 0."""
    rules: Dict[str, str] = {}
    seed = env_seed(0) if default_seed is None else default_seed
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        key, sep, value = part.partition("=")
        if not sep:
            raise ValueError(f"bad TONY_FAULTS entry {part!r} "
                             f"(need site=spec)")
        key = key.strip()
        if key == "seed":
            seed = int(value)
        else:
            rules[key] = value.strip()
    return FaultInjector(rules, seed=seed)


def install_from_env() -> bool:
    """Executor/user-process path: TONY_FAULTS beats everything (it must —
    the faults may target the storage fetch of the config itself)."""
    spec = os.environ.get(FAULTS_ENV, "")
    if not spec:
        return False
    install(parse_spec(spec))
    return True


def install_from_conf(conf: Any) -> bool:
    """Coordinator/client path: read ``tony.fault.*`` keys. Returns True
    iff any site is configured (callers then export TONY_FAULTS)."""
    from tony_tpu_torch.conf import keys as K

    rules: Dict[str, str] = {}
    for site in SITES:
        spec = str(conf.get(K.fault_key(site), "") or "")
        if spec:
            rules[site] = spec
    if not rules:
        return False
    install(FaultInjector(rules, seed=conf.get_int(K.FAULT_SEED,
                                                   env_seed(0))))
    return True


def env_passthrough() -> Dict[str, str]:
    """Env vars a supervisor exports so child processes inherit the active
    injection config (empty when disabled)."""
    inj = _active
    if inj is None or not inj.rules:
        return {}
    return {FAULTS_ENV: inj.to_env_value()}
