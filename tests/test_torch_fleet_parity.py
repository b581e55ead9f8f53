"""The port's fleet against the reference's on the same inputs.

Each case feeds both packages the same seeded inputs (numpy's generator,
seeded): the policy engine's decisions over one driven sequence of queue
and pool states, the simulator's placements and goodput on bench's tenant
mix cut to twelve jobs (``bench.py`` ``run_fleet_suite``: a whole-pool
elastic victim, a priority-10 demander, two tenants of sizes 1-4 and a
quota-capped tenant), ``ledger.fold_fleet_dir`` over the same fleet dirs,
and the reference's ``check_tree`` over a fleet dir that the port's daemon
wrote (one wire format).
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from tony_tpu.devtools import invariants as ref_invariants
from tony_tpu.fleet import ledger as ref_ledger
from tony_tpu.fleet import policy as ref_policy
from tony_tpu.fleet import simulator as ref_sim
from tony_tpu.fleet import timeline as ref_timeline
from tony_tpu_torch.devtools import invariants
from tony_tpu_torch.fleet import journal as fj
from tony_tpu_torch.fleet import ledger
from tony_tpu_torch.fleet import policy
from tony_tpu_torch.fleet import simulator as sim
from tony_tpu_torch.fleet import timeline

from test_torch_fleet import _daemon, _job_row

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = [os.path.join(REPO, "tests", "fixtures", name)
            for name in ("golden_fleetdir", "whatif_mix")]


def _plain(decisions):
    return [dataclasses.asdict(d) for d in decisions]


# ---------------------------------------------------------------------------
# policy.py: the same decisions on the same queue and pool states
# ---------------------------------------------------------------------------
def _drive_policy(rng, engines, steps=40):
    """Drives every engine through one random sequence of submissions,
    plans, carried-out decisions, releases, cordons and evacuations;
    returns each engine's trace of every plan it made."""
    traces = [[] for _ in engines]
    mods = [ref_policy, policy]
    running, seq = [], 0
    for _ in range(steps):
        op = rng.integers(0, 6)
        if op <= 2:
            seq += 1
            hosts = int(rng.integers(1, 9))
            min_hosts = int(rng.integers(0, hosts)) if rng.random() < 0.5 \
                else 0
            tenant = ["alpha", "bravo", "capped"][int(rng.integers(0, 3))]
            priority = int(rng.integers(0, 11))
            for mod, eng in zip(mods, engines):
                eng.submit(mod.JobRequest(
                    f"j{seq}", tenant, priority=priority, hosts=hosts,
                    min_hosts=min_hosts, seq=seq))
        elif op == 3 and running:
            job = running.pop(int(rng.integers(0, len(running))))
            for eng in engines:
                eng.release(job)
        elif op == 4:
            dying = [int(rng.integers(0, engines[0].pool.slices))]
            for trace, eng in zip(traces, engines):
                trace.append(("evacuate", _plain(
                    eng.evacuation_candidates(dying))))
            for trace, eng in zip(traces, engines):
                trace.append(("restore", eng.restore_candidates()))
        for trace, eng in zip(traces, engines):
            plan = eng.schedule()
            trace.append(("plan", _plain(plan)))
            for d in plan:
                if d.action == policy.GRANT:
                    eng.grant(d.job_id, d.placement)
                elif d.action == policy.SHRINK:
                    eng.shrink_applied(d.job_id, d.hosts)
                elif d.action == policy.MIGRATE:
                    eng.migrate_applied(d.job_id, d.placement)
        granted = [d["job_id"] for d in traces[1][-1][1]
                   if d["action"] == policy.GRANT]
        running.extend(granted)
        for trace, eng in zip(traces, engines):
            trace.append(("state", eng.queue_depth, eng.tenant_used(),
                          eng.pool.free_total))
    return traces


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_policy_decisions_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    quotas = {"capped": 2}
    engines = [ref_policy.PolicyEngine(2, 4, quotas=quotas),
               policy.PolicyEngine(2, 4, quotas=quotas)]
    ref_trace, port_trace = _drive_policy(rng, engines)
    assert port_trace == ref_trace
    # the drive reached the interesting decisions, not just grants
    actions = {d["action"] for kind, *rest in port_trace if kind == "plan"
               for d in rest[0]}
    assert policy.GRANT in actions and len(actions) >= 3, actions


def test_policy_cordon_holds_match_the_reference():
    engines = [ref_policy.PolicyEngine(1, 4), policy.PolicyEngine(1, 4)]
    plans = []
    for mod, eng in zip([ref_policy, policy], engines):
        eng.pool.cordon_free(0)
        eng.cordoned_names = ["s0h3"]
        eng.submit(mod.JobRequest("w", "t1", hosts=4, seq=1))
        eng.submit(mod.JobRequest("x", "t1", hosts=3, seq=2))
        plans.append(_plain(eng.schedule()))
    assert plans[1] == plans[0]
    assert "s0h3" in plans[1][0]["reason"]


# ---------------------------------------------------------------------------
# simulator.py: placements and goodput on bench's mix, cut to 12 jobs
# ---------------------------------------------------------------------------
def _bench_mix(mod, seed, n_jobs=12):
    """``run_fleet_suite``'s mix at ``n_jobs``: the whole-pool elastic
    victim, the priority-10 demander, alternating alpha/bravo jobs of
    sizes 1-4 at priorities 0-2, and the quota-capped tenant's 1-2 host
    jobs; submit gaps and work drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    origin = 1_600_000_000_000
    shapes = [("bulk", 0, 8, 2), ("prod", 10, 4, 0)]
    for i in range(n_jobs - 2 - 3):
        shapes.append(("alpha" if i % 2 == 0 else "bravo", i % 3,
                       (1, 2, 3, 4)[i % 4], 0))
    for i in range(3):
        shapes.append(("capped", 0, 1 + i % 2, 0))
    jobs, submit = [], origin
    for i, (tenant, priority, hosts, min_hosts) in enumerate(shapes, 1):
        submit += int(rng.integers(500, 4000))
        jobs.append(mod.SimJob(
            job_id=f"fj-{i:04d}", tenant=tenant, priority=priority,
            hosts=hosts, min_hosts=min_hosts, model=f"m-{tenant}", seq=i,
            submit_ms=submit,
            work_chip_ms=hosts * int(rng.integers(5_000, 60_000)),
            recorded_state="FINISHED"))
    return mod.Workload(slices=2, hosts_per_slice=4,
                        quotas={"capped": 2}, jobs=jobs)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_simulator_matches_the_reference_on_bench_mix(seed, tmp_path):
    out = {}
    for name, mod in (("ref", ref_sim), ("port", sim)):
        path = str(tmp_path / f"{name}.journal.jsonl")
        result = mod.simulate(_bench_mix(mod, seed),
                              recorder=mod.JournalRecorder(path))
        with open(path, "rb") as f:
            out[name] = (json.dumps(result, sort_keys=True), f.read())
    assert out["port"] == out["ref"]
    result = json.loads(out["port"][0])
    assert result["metrics"]["jobs"] == 12
    assert result["metrics"]["granted"] == 12
    # the journal the port's simulator recorded replays to parity through
    # the port's policy engine
    par = sim.parity_replay(timeline.load(path=str(
        tmp_path / "port.journal.jsonl")))
    assert par["ok"], par["mismatches"]


@pytest.mark.parametrize("fixture", FIXTURES,
                         ids=[os.path.basename(f) for f in FIXTURES])
def test_whatif_matches_the_reference(fixture):
    kw = dict(quotas=["capped=4"], pool="3x4")
    ref = ref_sim.whatif_from_dir(fixture, **kw)
    port = sim.whatif_from_dir(fixture, **kw)
    assert json.dumps(port, sort_keys=True) == \
        json.dumps(ref, sort_keys=True)
    ref_wl = ref_sim.fold_workload(ref_timeline.load(fixture))
    port_wl = sim.fold_workload(timeline.load(fixture))
    assert dataclasses.asdict(port_wl) == dataclasses.asdict(ref_wl)


# ---------------------------------------------------------------------------
# ledger.fold_fleet_dir and check_tree over the same fleet dirs
# ---------------------------------------------------------------------------
def _daemon_fleet_dir(tmp_path):
    """A fleet dir written by the port's daemon: grants, a preemption of
    an elastic victim by a priority-10 demander, grow-back, an operator
    migration, and every job FINISHED."""
    d = _daemon(tmp_path, slices=2, hosts_per_slice=4)
    runner = d.runner
    victim = d.submit("bulk", 8, min_hosts=2, conf={})["job"]
    d.tick()
    runner.fake_app(victim)
    hi = d.submit("prod", 4, priority=10, conf={})["job"]
    d.tick()
    d.tick()
    small = d.submit("alpha", 1, conf={})["job"]
    for _ in range(3):
        d.tick()
    for job in (hi, small):
        if job in {os.path.basename(wd) for wd, _, _ in runner.spawned}:
            runner.handle_for(job).exit = 0
        d.tick()
    for _ in range(3):
        d.tick()
    for job in (victim, hi, small):
        runner.handle_for(job).exit = 0
    for _ in range(3):
        d.tick()
    states = {j: _job_row(d, j)["state"] for j in (victim, hi, small)}
    d._shutdown()
    assert set(states.values()) == {fj.STATE_FINISHED}, states
    assert any(size < 8 for _, size in runner.resized), runner.resized
    return d.fleet_dir


def test_ledger_fold_matches_the_reference(tmp_path):
    dirs = FIXTURES + [_daemon_fleet_dir(tmp_path)]
    for fleet_dir in dirs:
        port = ledger.fold_fleet_dir(fleet_dir)
        ref = ref_ledger.fold_fleet_dir(fleet_dir)
        assert json.dumps(port, sort_keys=True, default=str) == \
            json.dumps(ref, sort_keys=True, default=str), fleet_dir


def test_reference_check_tree_reads_the_port_daemons_fleet_dir(tmp_path):
    fleet_dir = _daemon_fleet_dir(tmp_path)
    port = invariants.check_tree(fleet_dir)
    ref = ref_invariants.check_tree(fleet_dir)
    assert port and all(r.ok for r in port), invariants.render_text(port)
    assert all(r.ok for r in ref), ref_invariants.render_text(ref)
    assert [(r.job_dir, r.ok, r.checked) for r in ref] == \
        [(r.job_dir, r.ok, r.checked) for r in port]
    fleet = [r for r in port if r.job_dir == fleet_dir]
    assert fleet and fj.__name__ and any(
        "fleet" in rel for rel in fleet[0].checked), port
