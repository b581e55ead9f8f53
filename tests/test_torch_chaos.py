"""The port's chaos engine (``tony_tpu_torch/chaos/``): the 27 cases of
``tests/test_chaos.py`` run through the port (the seeded planner, the
``prob:P`` grammar token, the rpc.partition matrix over a real server and
client, the disk-fault degrade shapes, ddmin, the artifact round trip and
the corpus), plus parity with the reference: ``plan()`` gives the same
schedule in both packages for 3 seeds × 50 indices × 4 suites (replay
depends on it: an artifact planned by one package is replanned by the
other), and ``ddmin`` shrinks to the same minimal set in the same
predicate calls. The slow sweep drill lives in
``tests/test_torch_e2e_chaos.py``."""

import errno
import json
import os
import threading

import pytest

from tony_tpu_torch import faults
from tony_tpu_torch.chaos import artifact as chaos_artifact
from tony_tpu_torch.chaos import schedule as chaos_schedule
from tony_tpu_torch.chaos.oracle import Outcome, Violation
from tony_tpu_torch.chaos.schedule import Injection, Schedule, fault_seed, plan
from tony_tpu_torch.chaos.shrink import ddmin
from tony_tpu_torch.utils.durable import DurableWriteError

pytestmark = pytest.mark.faults

CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "chaos_corpus")


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.uninstall()
    yield
    faults.uninstall()


# ---------------------------------------------------------------------------
# planner determinism
# ---------------------------------------------------------------------------
def test_plan_is_bit_identical_per_triple():
    for suite in chaos_schedule.SUITES:
        for index in range(25):
            a = plan(17, index, suite)
            b = plan(17, index, suite)
            assert a.as_dict() == b.as_dict()
            assert 1 <= len(a.injections) <= 4


def test_plan_varies_with_seed_and_index():
    a = [plan(17, i, "e2e").as_dict() for i in range(40)]
    b = [plan(18, i, "e2e").as_dict() for i in range(40)]
    assert a != b
    assert len({json.dumps(x, sort_keys=True) for x in a}) > 10


def test_planned_schedules_are_valid_injector_input():
    """Every planned schedule must parse: registered sites, grammatical
    specs — the planner and the registry cannot drift apart."""
    for suite in chaos_schedule.SUITES:
        for index in range(40):
            sched = plan(17, index, suite)
            for inj in sched.injections:
                assert inj.site in faults.SITES
            inj = sched.injector()          # raises on a bad site/spec
            assert inj.seed == fault_seed(17, index)


def test_duplicate_site_specs_compose_in_rules():
    sched = Schedule(seed=1, index=0, suite="e2e",
                     injections=[Injection("rpc.send", "at:2"),
                                 Injection("rpc.send", "at:5")])
    assert sched.rules() == {"rpc.send": "at:2,at:5"}


# ---------------------------------------------------------------------------
# prob:P — the hash-deterministic probability token
# ---------------------------------------------------------------------------
def test_prob_decisions_are_pure_function_of_seed_site_index():
    def pattern(seed):
        inj = faults.FaultInjector({"rpc.send": "prob:0.5"}, seed=seed)
        return [inj.fire("rpc.send") for _ in range(40)]

    p1, p2 = pattern(7), pattern(7)
    assert p1 == p2                        # same seed, same stream
    assert any(p1) and not all(p1)
    assert pattern(8) != p1                # seed matters


def test_prob_decisions_survive_schedule_shrinking():
    """Removing another site's rule must not re-roll prob decisions —
    the property ddmin leans on."""
    full = faults.FaultInjector({"rpc.send": "prob:0.3",
                                 "heartbeat": "first:2"}, seed=11)
    shrunk = faults.FaultInjector({"rpc.send": "prob:0.3"}, seed=11)
    f = [full.fire("rpc.send") for _ in range(30)]
    for _ in range(5):
        full.fire("heartbeat")             # interleaved other-site calls
    s = [shrunk.fire("rpc.send") for _ in range(30)]
    assert f == s


def test_env_seed_drives_parse_spec_default(monkeypatch):
    monkeypatch.setenv(faults.FAULT_SEED_ENV, "4242")
    inj = faults.parse_spec("rpc.send=prob:0.5")
    assert inj.seed == 4242
    monkeypatch.setenv(faults.FAULT_SEED_ENV, "not-an-int")
    assert faults.env_seed(9) == 9


def test_prob_registered_in_grammar_docs():
    assert "prob" in faults.__doc__


# ---------------------------------------------------------------------------
# correlated host loss: task:* wildcard, in-process task scoping
# ---------------------------------------------------------------------------
def test_task_wildcard_correlates_across_tasks():
    inj = faults.FaultInjector({"host.loss": "task:*,first:2"})
    assert inj.fire("host.loss", task_id="worker:0")
    assert inj.fire("host.loss", task_id="worker:3")
    assert not inj.fire("host.loss", task_id="worker:1")


def test_task_filter_is_scope_for_in_process_callers():
    """A non-matching task must not consume a call index: task:W,first:1
    means W's first poll, whoever polls around it."""
    inj = faults.FaultInjector({"host.loss": "task:worker:1,first:1"})
    assert not inj.fire("host.loss", task_id="worker:0")
    assert inj.fire("host.loss", task_id="worker:1")
    assert not inj.fire("host.loss", task_id="worker:1")


# ---------------------------------------------------------------------------
# rpc.partition: the asymmetric-cut matrix over a REAL wire
# ---------------------------------------------------------------------------
class _CountService:
    def __init__(self):
        self.calls = 0
        self._lock = threading.Lock()

    def bump(self):
        with self._lock:
            self.calls += 1
            return self.calls


@pytest.fixture()
def wire():
    from tony_tpu_torch.rpc.wire import RpcServer

    svc = _CountService()
    srv = RpcServer(svc, port=0)
    srv.start()
    yield svc, srv
    srv.stop()


def _client(srv, peer="coordinator"):
    from tony_tpu_torch.rpc.wire import RpcClient

    return RpcClient("127.0.0.1", srv.port, max_retries=4,
                     retry_sleep_s=0.05, peer=peer)


def test_partition_c2s_drops_before_delivery(wire):
    """Request-direction cut: the callee NEVER sees the dropped frame —
    the retry is the first delivery, so no duplicate."""
    svc, srv = wire
    faults.install(faults.FaultInjector(
        {"rpc.partition": "dir:c2s,peer:coordinator,at:1"}))
    c = _client(srv)
    assert c.call("bump") == 1             # retried transparently
    assert svc.calls == 1                  # exactly-once: drop was pre-send
    c.close()


def test_partition_s2c_duplicates_delivery(wire):
    """Response-direction cut: the callee's side effects LAND, the
    caller sees a reset and retries — at-least-once delivery made
    visible. This is the semantics resize/submit idempotence exists
    for."""
    svc, srv = wire
    faults.install(faults.FaultInjector(
        {"rpc.partition": "dir:s2c,peer:coordinator,at:1"}))
    c = _client(srv)
    assert c.call("bump") == 2             # second delivery's answer
    assert svc.calls == 2                  # first one landed too
    c.close()


def test_partition_peer_scoping_spares_other_wires(wire):
    svc, srv = wire
    faults.install(faults.FaultInjector(
        {"rpc.partition": "dir:c2s,peer:pool,first:9"}))
    c = _client(srv, peer="coordinator")   # not the targeted wire
    assert c.call("bump") == 1
    assert svc.calls == 1
    c.close()


def test_partition_direction_indices_are_independent(wire):
    """dir: filters are scope: at:2 under dir:s2c means the 2nd
    RESPONSE frame even though request frames flow between them."""
    svc, srv = wire
    faults.install(faults.FaultInjector(
        {"rpc.partition": "dir:s2c,peer:coordinator,at:2"}))
    c = _client(srv)
    assert c.call("bump") == 1             # response #1 passes
    assert c.call("bump") == 3             # response #2 cut -> retry
    assert svc.calls == 3                  # the duplicate landed
    c.close()


# ---------------------------------------------------------------------------
# disk-fault degrade shapes
# ---------------------------------------------------------------------------
def test_append_log_enospc_is_loud_and_sticky_dead_prefix_survives(
        tmp_path):
    from tony_tpu_torch.coordinator.journal import SessionJournal
    from tony_tpu_torch.coordinator import journal as cjournal

    path = str(tmp_path / "j.jsonl")
    j = SessionJournal(path)
    j.generation(1)
    j.app("app_x", 0, "u")
    faults.install(faults.FaultInjector({"disk.full": "first:1"}))
    with pytest.raises(DurableWriteError) as ei:
        j.task("worker:0", "RUNNING", 0)
    assert ei.value.errno in (errno.ENOSPC, errno.EIO)
    assert j.dead is not None
    # later appends no-op instead of cascading tracebacks
    j.task("worker:1", "RUNNING", 0)
    j.close()
    # the committed prefix replays — this IS the --recover contract
    st = cjournal.replay(path)
    assert st.records == 2
    assert st.generation == 1


def test_torn_append_keeps_prefix_replayable(tmp_path):
    from tony_tpu_torch.coordinator import journal as cjournal
    from tony_tpu_torch.coordinator.journal import SessionJournal

    path = str(tmp_path / "j.jsonl")
    j = SessionJournal(path)
    j.generation(1)
    j.app("app_x", 0, "u")
    faults.install(faults.FaultInjector({"disk.torn": "first:1"}))
    with pytest.raises(DurableWriteError):
        j.task("worker:0", "RUNNING", 0)
    j.close()
    faults.uninstall()
    st = cjournal.replay(path)
    assert st.records == 2 and st.torn_tail   # half-record detected


def test_atomic_write_torn_rename_leaves_no_file(tmp_path):
    from tony_tpu_torch.utils.durable import atomic_write

    path = str(tmp_path / "doc.json")
    faults.install(faults.FaultInjector({"disk.torn": "first:1"}))
    with pytest.raises(OSError):
        atomic_write(path, b"{}")
    assert not os.path.exists(path)
    assert os.listdir(str(tmp_path)) == []    # tmp cleaned up
    faults.uninstall()
    atomic_write(path, b"{}")                 # healthy disk: lands
    assert os.path.exists(path)


def test_fail_terminal_demotes_a_succeeded_epoch():
    """The schedule-000022 regression: a verdict that cannot be
    journaled must not read as SUCCEEDED."""
    from tony_tpu_torch.conf.config import TonyTpuConfig
    from tony_tpu_torch.coordinator.session import (FailureDomain, Session,
                                              SessionStatus)

    conf = TonyTpuConfig()
    conf.set("tony.worker.instances", 1)
    conf.set("tony.worker.command", "true")
    s = Session(conf)
    for t in s.all_tasks():
        t.status = type(t.status).SUCCEEDED
    assert s.update_status() == SessionStatus.SUCCEEDED
    s.fail("journal write failed")            # plain fail: too late
    assert s.status == SessionStatus.SUCCEEDED
    s.fail_terminal("journal write failed",
                    FailureDomain.INFRA_TRANSIENT)
    assert s.status == SessionStatus.FAILED
    assert s.failure_domain == FailureDomain.INFRA_TRANSIENT


def test_fleet_submit_refused_while_journal_dead(tmp_path):
    from tony_tpu_torch.fleet.daemon import FleetDaemon

    d = FleetDaemon(str(tmp_path / "fleet"), slices=1, hosts_per_slice=4,
                    runner=object())
    faults.install(faults.FaultInjector({"disk.full": "first:1"}))
    res = d.submit("t", 2, conf={})
    assert not res["ok"] and "--recover" in res["message"]
    assert d.journal.dead is not None
    faults.uninstall()
    # STILL refused once dead: sticky no-op appends must not let an
    # unjournaled submission get acked
    res2 = d.submit("t", 2, conf={})
    assert not res2["ok"] and "--recover" in res2["message"]
    assert d.cancel("fj-0001")["ok"] is False
    d._shutdown()


# ---------------------------------------------------------------------------
# shrinker
# ---------------------------------------------------------------------------
def test_ddmin_converges_on_crafted_three_fault_repro():
    """Five injections, failure needs exactly {A, C}: the shrinker must
    find the 1-minimal pair."""
    a, b, c, d, e = (Injection("rpc.send", "at:1"),
                     Injection("heartbeat", "first:1"),
                     Injection("disk.torn", "at:3"),
                     Injection("host.loss", "task:*,first:1"),
                     Injection("rpc.connect", "first:2"))
    runs = []

    def fails(items):
        runs.append(list(items))
        return a in items and c in items

    minimal = ddmin([a, b, c, d, e], fails)
    assert minimal == [a, c]
    assert len(runs) <= 30


def test_ddmin_single_fault_repro_is_terminal():
    x = Injection("disk.full", "at:2")
    assert ddmin([x], lambda items: x in items) == [x]


def test_ddmin_requires_failing_input():
    with pytest.raises(ValueError):
        ddmin([Injection("rpc.send", "at:1")], lambda items: False)


def test_ddmin_budget_returns_best_so_far():
    items = list(range(16))

    def fails(sub):
        return set(sub) >= {3, 11}

    out = ddmin(items, fails, max_runs=3)
    assert {3, 11} <= set(out)             # still failing, maybe larger


# ---------------------------------------------------------------------------
# artifacts + corpus
# ---------------------------------------------------------------------------
def test_artifact_roundtrip(tmp_path):
    sched = plan(17, 3, "fleet")
    out = Outcome(status="FAILED", failure_domain="INFRA_TRANSIENT",
                  detail="x")
    out.violations.append(Violation("verdict", "why"))
    path = chaos_artifact.save_artifact(str(tmp_path), sched, out,
                                        note="n")
    doc = chaos_artifact.load_artifact(path)
    back = chaos_artifact.schedule_from_doc(doc)
    assert back.as_dict() == sched.as_dict()
    rec = chaos_artifact.outcome_from_doc(doc)
    assert not rec.ok and rec.status == "FAILED"
    assert rec.violations[0].rung == "verdict"


def test_corpus_artifacts_replan_or_carry_provenance():
    """Every checked-in corpus artifact either replans bit-identically
    (full schedules) or carries shrunk_from provenance (minimal
    repros) — and names only registered sites."""
    files = sorted(os.listdir(CORPUS))
    assert files, "seed corpus must not be empty"
    for name in files:
        doc = chaos_artifact.load_artifact(os.path.join(CORPUS, name))
        sched = chaos_artifact.schedule_from_doc(doc)
        for inj in sched.injections:
            assert inj.site in faults.SITES
        sched.injector()                   # specs parse
        if doc.get("shrunk_from"):
            assert doc.get("note"), f"{name}: a shrunk repro needs its " \
                                    f"bug story"
        else:
            replanned = plan(sched.seed, sched.index, sched.suite)
            assert replanned.as_dict() == sched.as_dict()


def test_chaos_cli_registered():
    from tony_tpu_torch.cli.main import build_parser

    p = build_parser()
    for argv in (["chaos", "run", "--seed", "1", "--schedules", "2"],
                 ["chaos", "replay", "x.json"],
                 ["chaos", "shrink", "x.json", "--max-runs", "9"]):
        args = p.parse_args(argv)
        assert callable(args.fn)


def test_new_sites_have_conf_keys_and_docs():
    from tony_tpu_torch.conf import keys as K
    from tony_tpu_torch.conf.config import TonyTpuConfig

    conf = TonyTpuConfig()
    for site in ("rpc.partition", "disk.full", "disk.torn"):
        assert site in faults.SITES
        key = K.fault_key(site)
        assert conf.get(key, None) in ("", None) or True
        conf.set(key, "first:1")
    assert faults.install_from_conf(conf) is True
    faults.uninstall()


# ---------------------------------------------------------------------------
# parity with the reference's planner and shrinker
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 17, 20260417])
def test_plan_equals_the_reference(seed):
    from tony_tpu import faults as jfaults
    from tony_tpu.chaos import schedule as jschedule

    assert tuple(faults.SITES) == tuple(jfaults.SITES)
    assert chaos_schedule.SUITES == jschedule.SUITES
    assert len(chaos_schedule.SUITES) == 4
    for suite in chaos_schedule.SUITES:
        for index in range(50):
            ours = plan(seed, index, suite)
            ref = jschedule.plan(seed, index, suite)
            assert ours.as_dict() == ref.as_dict(), (seed, index, suite)
            assert fault_seed(seed, index) == jschedule.fault_seed(seed,
                                                                   index)


@pytest.mark.parametrize("culprits", [(), (3,), (1, 6), (0, 4, 7),
                                      (2, 3, 5, 9)])
def test_ddmin_equals_the_reference(culprits):
    """Both shrinkers, over the same ten injections and the same failing
    predicate (every culprit present), return the same minimal set after
    the same sequence of predicate calls; a budget-cut run returns the
    same best-so-far."""
    from tony_tpu.chaos.shrink import ddmin as jddmin

    items = list(range(10))
    needed = set(culprits) or {8}

    def recorder(calls):
        def fails(subset):
            calls.append(tuple(subset))
            return needed <= set(subset)
        return fails

    for budget in (60, 5):
        ours, ref = [], []
        got = ddmin(items, recorder(ours), max_runs=budget)
        want = jddmin(items, recorder(ref), max_runs=budget)
        assert got == want and ours == ref, budget
    assert set(ddmin(items, recorder([]))) == needed
