"""The port's ``cold_start_breakdown`` against the reference's.

The port rounds each cumulative boundary against the submit once and
takes a phase as the difference of two rounded boundaries, so the phases
sum to ``total_s`` exactly; the reference rounds each phase on its own.
Every phase stays within 1e-4 of the reference's.
"""
import numpy as np
import pytest

from tony_tpu import tracing as ref_tracing
from tony_tpu_torch import tracing

#: One rounding step of the breakdown's 4-decimal seconds.
TOL_PHASE_S = 1e-4 + 1e-9


def _x(name, ts_us, dur_us=0, task="", svc="svc"):
    return {"ev": "X", "trace": "t1", "span": f"{name}@{ts_us}",
            "parent": "", "name": name, "svc": svc, "task": task,
            "ts_us": ts_us, "dur_us": dur_us, "args": {}}


def _records(bounds, task="worker:0"):
    """Spans whose six boundaries (µs after the submit) are ``bounds``:
    stage end, lifecycle start, run start, register end, user-process
    start, first-step end."""
    stage, prov, spawn, reg, launch, first = (int(b) for b in bounds)
    return [
        _x("client.submit", 0, first, svc="client"),
        _x("client.stage", 0, stage, svc="client"),
        _x("task.lifecycle", prov, first - prov, task=task),
        _x("executor.run", spawn, first - spawn, task=task),
        _x("executor.register", spawn, reg - spawn, task=task),
        _x("executor.user_process", launch, first - launch, task=task),
        _x("executor.first_step", launch, first - launch, task=task),
    ]


def test_two_60us_phases_sum_to_the_rounded_total():
    """The smallest input the per-phase rounding gets wrong: two 60 µs
    phases round to 0.0001 each against a total of 0.0001."""
    recs = [_x("client.submit", 0, 120, svc="client"),
            _x("client.stage", 0, 60, svc="client"),
            _x("executor.first_step", 60, 60, task="worker:0")]
    bd = tracing.cold_start_breakdown(recs)
    assert bd["total_s"] == 0.0001
    assert bd["phases"] == {"stage": 0.0001, "user_boot": 0.0}
    assert round(sum(bd["phases"].values()), 4) == bd["total_s"]
    ref = ref_tracing.cold_start_breakdown(recs)
    assert ref["total_s"] == bd["total_s"]
    for k, v in bd["phases"].items():
        assert abs(v - ref["phases"][k]) <= TOL_PHASE_S


def test_seeded_boundaries_telescope_to_total():
    """Random boundaries: the phases always sum to the total, each within
    one rounding step of the exact span and of the reference's phase."""
    rng = np.random.default_rng(11)
    misses_ref = 0
    for _ in range(500):
        bounds = np.sort(rng.integers(1, 3_000_000, size=6))
        recs = _records(bounds)
        bd = tracing.cold_start_breakdown(recs)
        ref = ref_tracing.cold_start_breakdown(recs)
        assert round(sum(bd["phases"].values()), 4) == bd["total_s"]
        assert bd["total_s"] == ref["total_s"]
        assert list(bd["phases"]) == list(ref["phases"])
        exact = np.diff(np.concatenate([[0], bounds])) / 1e6
        for (k, v), e in zip(bd["phases"].items(), exact):
            assert abs(v - e) <= TOL_PHASE_S, (k, v, e)
            assert abs(v - ref["phases"][k]) <= TOL_PHASE_S, (k, v)
        misses_ref += round(sum(ref["phases"].values()), 4) != ref["total_s"]
    # The draws do reach the reference's fault, so the sweep tests it.
    assert misses_ref > 0


@pytest.mark.parametrize("bounds", [
    (1_000_000, 2_000_000, 3_500_000, 4_500_000, 5_000_000, 10_000_000),
    (100, 200, 300, 400, 500, 600),
    (0, 0, 0, 0, 0, 50),
])
def test_whole_boundaries_match_the_reference(bounds):
    """Where no boundary needs rounding the two agree exactly."""
    recs = _records(bounds)
    assert (tracing.cold_start_breakdown(recs)
            == ref_tracing.cold_start_breakdown(recs))
