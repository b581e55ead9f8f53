"""Shared retry policy: exponential backoff with full jitter.

The port's own copy of ``tony_tpu/retry.py``; ``faults.install`` seeds its
jitter.

One policy object serves every transient-failure surface — control-plane
RPC reconnects (``rpc/wire.py``), object-store transfers
(``storage/store.py`` — GCS 429/5xx and socket resets), and any future
cloud-API caller. The reference retried everything on a fixed cadence
(``ApplicationRpcClient.java:66-76``: 10 × 2 s), which synchronizes an
entire gang's retries into bursts exactly when the service is least able
to absorb them; full jitter (delay ~ U[0, min(cap, base·2^attempt)]) is
the standard de-correlator (the AWS-architecture result: near-optimal
total load at the same completion time).

Determinism for tests: the RNG, sleep, and (therefore) the clock are all
injectable — the ``-m faults`` unit suite drives policies with a seeded
``random.Random`` and a recording fake sleep, so backoff schedules are
asserted exactly, with zero wall-clock cost.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import time
from typing import Callable, Optional, Sequence, Tuple, Type

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with full jitter.

    ``max_attempts`` bounds TOTAL tries (first call included);
    ``base_delay_s`` seeds the exponential ramp; ``max_delay_s`` caps any
    single sleep. ``jitter=False`` makes the schedule the deterministic
    upper envelope (min(cap, base·2^attempt)) — for tests that want exact
    delays without threading an RNG through.
    """

    max_attempts: int = 5
    base_delay_s: float = 0.5
    max_delay_s: float = 10.0
    jitter: bool = True

    def delay_s(self, attempt: int,
                rng: Optional[random.Random] = None) -> float:
        """Sleep before retry number ``attempt`` (0-based: the delay
        between the first failure and the second try)."""
        cap = min(self.max_delay_s, self.base_delay_s * (2 ** attempt))
        if not self.jitter:
            return cap
        return (rng or _default_rng).uniform(0.0, cap)


#: module-level RNG for production call sites (seeded by the fault
#: harness when determinism is requested — see tony_tpu_torch/faults.py)
_default_rng = random.Random()


def seed_default_rng(seed: int) -> None:
    """Make jittered delays reproducible process-wide (fault harness)."""
    global _default_rng
    _default_rng = random.Random(seed)


def call_with_retry(
    fn: Callable[[], "object"],
    policy: RetryPolicy,
    retry_on: Tuple[Type[BaseException], ...] = (ConnectionError, OSError),
    give_up_on: Tuple[Type[BaseException], ...] = (),
    sleep: Callable[[float], None] = time.sleep,
    rng: Optional[random.Random] = None,
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
    what: str = "operation",
) -> object:
    """Run ``fn`` under ``policy``. Exceptions in ``give_up_on`` (checked
    first — carve non-retryable subclasses like FileNotFoundError out of
    OSError) and anything not in ``retry_on`` propagate immediately; the
    last retryable failure propagates once attempts are exhausted.
    ``on_retry(attempt, err, delay_s)`` observes each scheduled retry.
    """
    attempts = max(1, policy.max_attempts)
    for attempt in range(attempts):
        try:
            return fn()
        except give_up_on:
            raise
        except retry_on as e:
            if attempt >= attempts - 1:
                raise
            delay = policy.delay_s(attempt, rng)
            if on_retry is not None:
                on_retry(attempt, e, delay)
            else:
                log.debug("%s failed (%s); retry %d/%d in %.2fs",
                          what, e, attempt + 1, attempts - 1, delay)
            sleep(delay)
    raise AssertionError("unreachable")  # loop always returns or raises
