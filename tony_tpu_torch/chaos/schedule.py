"""Seeded schedule planner: (seed, index, suite) -> injection set.

The planner is a PURE function of its three inputs — no wall clock, no
ambient RNG, no environment. That is the whole contract: `chaos replay`
re-plans from the artifact's (seed, index, suite) triple and must get a
bit-identical schedule back, and a shrunk schedule's surviving
injections keep their specs verbatim (the ddmin operates on the planned
list, never re-rolls it).

Two layers of determinism compose:

* the PLAN — which sites, which specs — comes from
  ``random.Random(f"{seed}:{index}:{suite}")`` here;
* the per-call DECISIONS of ``prob:P`` specs come from the injector's
  stable hash (faults._SiteRule._hash_draw), seeded with
  :func:`fault_seed` so every run of the same schedule draws the same
  verdict for call #n regardless of what else fired around it.
"""

from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

from tony_tpu_torch import faults

SUITES = ("e2e", "migrate", "fleet", "health")


@dataclass(frozen=True)
class Injection:
    """One (site, spec) pair — the schedule's atom, and the unit the
    shrinker removes."""

    site: str
    spec: str

    def as_dict(self) -> Dict[str, str]:
        return {"site": self.site, "spec": self.spec}


@dataclass
class Schedule:
    seed: int
    index: int
    suite: str
    injections: List[Injection] = field(default_factory=list)

    @property
    def name(self) -> str:
        return f"schedule-{self.index:06d}"

    def rules(self) -> Dict[str, str]:
        """Fold to the injector's rules dict. Duplicate sites compose by
        comma-joining specs (the grammar is comma-combined already)."""
        rules: Dict[str, str] = {}
        for inj in self.injections:
            if inj.site in rules:
                rules[inj.site] = rules[inj.site] + "," + inj.spec
            else:
                rules[inj.site] = inj.spec
        return rules

    def injector(self) -> faults.FaultInjector:
        return faults.FaultInjector(self.rules(),
                                    seed=fault_seed(self.seed, self.index))

    def as_dict(self) -> dict:
        return {"seed": self.seed, "index": self.index,
                "suite": self.suite,
                "injections": [i.as_dict() for i in self.injections]}


def fault_seed(seed: int, index: int) -> int:
    """The injector seed for schedule #index of a sweep: a stable hash,
    NOT seed+index — adjacent sweeps must not share decision streams."""
    h = hashlib.sha256(f"tonychaos:{seed}:{index}".encode()).digest()
    return int.from_bytes(h[:4], "big")


# ---------------------------------------------------------------------------
# Site menus: what can plausibly fire per suite, and how a spec is rolled.
# Each entry is (site, weight, spec_fn(rng) -> spec). Keep every
# generator a pure function of the rng — see the module contract.
# ---------------------------------------------------------------------------
def _spec_first(rng: random.Random) -> str:
    return f"first:{rng.randint(1, 2)}"


def _spec_at(rng: random.Random) -> str:
    return f"at:{rng.randint(1, 8)}"


def _spec_prob(rng: random.Random) -> str:
    return f"prob:{rng.choice(('0.05', '0.1', '0.2'))}"


def _spec_partition(rng: random.Random) -> str:
    direction = rng.choice(("c2s", "s2c"))
    return f"dir:{direction},peer:coordinator,at:{rng.randint(1, 12)}"


def _spec_host_loss(rng: random.Random) -> str:
    # Correlated loss: task:* fires across hosts, so first:N is N
    # near-simultaneous deaths (different hosts, same storm).
    if rng.random() < 0.5:
        return f"task:*,first:{rng.randint(1, 2)}"
    return f"task:*,at:{rng.randint(2, 10)}"


def _spec_disk(rng: random.Random) -> str:
    # Journal appends are frequent; a later index lands mid-run.
    return f"at:{rng.randint(4, 40)}"


def _spec_slow(rng: random.Random) -> str:
    return f"at:{rng.randint(1, 6)},amt:{rng.choice(('0.1', '0.25'))}"


def _spec_flaky(rng: random.Random) -> str:
    # Exactly ONE flaky host per schedule, pinned by name (the daemon
    # fires the site with task_id=<host>): the drill's whole point is
    # that the ledger finds and cordons THIS host.
    host = f"s{rng.randint(0, 1)}h{rng.randint(0, 3)}"
    return f"task:{host},prob:{rng.choice(('0.8', '1.0'))}"


def _spec_probe(rng: random.Random) -> str:
    # Pinned per host like host.flaky; first:N so the host fails its
    # preflight and the grant must self-repair with a spare.
    host = f"s{rng.randint(0, 1)}h{rng.randint(0, 3)}"
    return f"task:{host},first:{rng.randint(1, 2)}"


_Menu = List[Tuple[str, int, Callable[[random.Random], str]]]

#: e2e: a virtual gang runs to self-finish under transport + disk +
#: host-loss pressure.
_E2E_MENU: _Menu = [
    ("rpc.connect", 3, _spec_first),
    ("rpc.send", 3, _spec_at),
    ("rpc.send", 2, _spec_prob),
    ("rpc.partition", 4, _spec_partition),
    ("heartbeat", 2, _spec_prob),
    ("host.loss", 4, _spec_host_loss),
    ("coord.slow-tick", 1, _spec_slow),
    ("disk.full", 2, _spec_disk),
    ("disk.torn", 2, _spec_disk),
]

#: migrate: everything e2e, plus the migration-op sites — the schedule
#: storms a gang that is mid-move.
_MIGRATE_MENU: _Menu = _E2E_MENU + [
    ("migrate.snapshot", 3, _spec_first),
    ("migrate.adopt", 3, _spec_first),
    ("resize.barrier", 2, _spec_first),
    ("resize.remesh", 2, _spec_first),
]

#: fleet: the daemon ticks a multi-tenant pool under grant/preempt
#: storms, slice reclaims, and journal disk faults.
_FLEET_MENU: _Menu = [
    ("fleet.grant", 3, _spec_first),
    ("fleet.preempt", 3, _spec_first),
    ("fleet.ledger", 2, _spec_first),
    ("slice.preempt", 3, _spec_at),
    ("disk.full", 2, _spec_disk),
    ("disk.torn", 2, _spec_disk),
]

#: health: noise AROUND the mandatory flaky host (plan() pins one
#: host.flaky injection unconditionally for this suite) — probe
#: failures force grant self-repair, journal faults stress the
#: write-ahead cordon records.
_HEALTH_MENU: _Menu = [
    ("health.probe", 3, _spec_probe),
    ("fleet.grant", 2, _spec_first),
    ("disk.torn", 1, _spec_disk),
]

_MENUS: Dict[str, _Menu] = {
    "e2e": _E2E_MENU,
    "migrate": _MIGRATE_MENU,
    "fleet": _FLEET_MENU,
    "health": _HEALTH_MENU,
}


def plan(seed: int, index: int, suite: str) -> Schedule:
    """Plan schedule #index of the seed's sweep: 1..4 weighted draws
    from the suite's menu, at most one spec per site (multi-spec sites
    compose at run time via Schedule.rules, but the PLANNER keeps one
    so the shrinker's unit stays meaningful)."""
    if suite not in _MENUS:
        raise ValueError(f"unknown chaos suite {suite!r}; "
                         f"one of {list(_MENUS)}")
    rng = random.Random(f"{seed}:{index}:{suite}")
    menu = _MENUS[suite]
    n = rng.randint(1, 4)
    sites: List[str] = []
    injections: List[Injection] = []
    if suite == "health":
        # The suite's contract: every health schedule seeds exactly one
        # flaky host; the menu draws below only add noise around it.
        sites.append("host.flaky")
        injections.append(Injection("host.flaky", _spec_flaky(rng)))
    weights = [w for _, w, _ in menu]
    for _ in range(n):
        site, _, spec_fn = rng.choices(menu, weights=weights, k=1)[0]
        # Roll the spec even on a duplicate-site skip: the rng stream —
        # hence every LATER draw — must not depend on the skip.
        spec = spec_fn(rng)
        if site in sites:
            continue
        sites.append(site)
        injections.append(Injection(site, spec))
    return Schedule(seed=seed, index=index, suite=suite,
                    injections=injections)
