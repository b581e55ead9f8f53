"""Delta-debugging shrinker: failing schedule -> minimal repro.

Classic ddmin (Zeller) over the schedule's injection list. The
predicate re-RUNS the candidate subset through the real runner; thanks
to ``prob:P``'s stable per-call hash and the scope-only dir/peer/task
filters, removing one injection does not re-roll the survivors'
decisions — the search space behaves, and the minimal set it converges
on is a real repro, not an artifact of RNG drift.

The result is 1-minimal: removing ANY single surviving injection makes
the failure disappear. That is the strongest claim a black-box shrink
can make, and exactly what a debugging session wants pinned in the
seed corpus.
"""

from __future__ import annotations

import logging
from typing import Callable, List, Sequence, TypeVar

log = logging.getLogger(__name__)

T = TypeVar("T")


def ddmin(items: Sequence[T], fails: Callable[[List[T]], bool],
          max_runs: int = 200) -> List[T]:
    """Minimize ``items`` such that ``fails(result)`` still holds.

    ``fails`` must hold for the full input (the caller verifies; we
    assert). Returns a 1-minimal failing subset. ``max_runs`` bounds
    predicate invocations — on exhaustion the best-so-far subset is
    returned (still failing, possibly not yet 1-minimal).
    """
    current = list(items)
    if not fails(current):
        raise ValueError("ddmin needs a failing input to shrink")
    runs = 1
    granularity = 2
    while len(current) >= 2:
        chunk = max(1, len(current) // granularity)
        starts = list(range(0, len(current), chunk))
        subsets = [current[i:i + chunk] for i in starts]
        complements = [current[:i] + current[i + chunk:] for i in starts]
        reduced = False
        # Try each subset alone, then each complement.
        for candidate in subsets + complements:
            if not candidate or len(candidate) == len(current):
                continue
            if runs >= max_runs:
                log.warning("ddmin budget exhausted after %d runs at "
                            "%d item(s)", runs, len(current))
                return current
            runs += 1
            if fails(list(candidate)):
                current = list(candidate)
                granularity = max(granularity - 1, 2)
                reduced = True
                break
        if not reduced:
            if granularity >= len(current):
                break
            granularity = min(granularity * 2, len(current))
    log.info("ddmin: %d -> %d item(s) in %d run(s)",
             len(items), len(current), runs)
    return current
