"""Fleet time-machine unit matrix (the what-if simulator): the
workload fold's observed-work integrals, the override/sweep grammar,
parity replay on the golden + recorded-mix fixtures (bit-for-bit and
gated), the fixture generator's byte-identical regeneration, the
counterfactual axes (quota bump, priority flip, pool resize,
preemption/defrag/restore toggles), the diff/holds-removed report, the
`fleet whatif` CLI and the fleet-sim-parity check rule's twin
fixtures. Everything tier-1-safe: pure folds over checked-in journals,
no daemons, no subprocess drills (the generator regeneration test runs
one quick python subprocess).
"""

import json
import os
import subprocess
import sys

import pytest

from tony_tpu_torch.conf import keys as K
from tony_tpu_torch.fleet import journal as fj
from tony_tpu_torch.fleet import simulator as fsim
from tony_tpu_torch.fleet import timeline as ftimeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "fixtures", "golden_fleetdir")
MIX = os.path.join(REPO, "tests", "fixtures", "whatif_mix")
PARITY_BAD = os.path.join(REPO, "tests", "fixtures",
                          "fleetdir_parity_bad")
GEN = os.path.join(REPO, "tests", "scripts", "gen_whatif_mix.py")


@pytest.fixture(scope="module")
def mix_tl():
    return ftimeline.load(MIX)


# ---------------------------------------------------------------------------
# workload fold
# ---------------------------------------------------------------------------
def test_fold_workload_observed_work_integral(mix_tl):
    wl = fsim.fold_workload(mix_tl)
    assert wl.slices == 2 and wl.hosts_per_slice == 4
    assert wl.quotas == {"capped": 2}
    assert len(wl.jobs) == 50
    by_id = {j.job_id: j for j in wl.jobs}
    # an unpreempted job's work is hosts x (finish - grant)
    st = mix_tl.state
    for job_id, fold in st.jobs.items():
        if len(fold.host_events) == 1 and fold.finished_ms:
            ts, hosts = fold.host_events[0]
            assert by_id[job_id].work_chip_ms == \
                hosts * (fold.finished_ms - ts)
    # a preempted job's integral is smaller than flat-rate would claim
    preempted = [j for j in st.jobs.values()
                 if len(j.host_events) > 1
                 and j.host_events[1][1] < j.host_events[0][1]]
    assert preempted, "mix fixture lost its preemption shape"
    for fold in preempted:
        flat = fold.host_events[0][1] * (fold.finished_ms
                                         - fold.host_events[0][0])
        assert by_id[fold.job_id].work_chip_ms < flat


def test_fold_workload_ungranted_job_gets_median_estimate(tmp_path):
    # journal with one finished job and one never-granted submission
    path = tmp_path / "fleet.journal.jsonl"
    j = fj.FleetJournal(str(path))
    t0 = 1_600_000_000_000
    j.append({"t": fj.REC_FLEET_GEN, "generation": 1, "slices": 1,
              "hosts_per_slice": 4, "quotas": {}, "ts": t0})
    j.append({"t": fj.REC_FLEET_SUBMIT, "job": "a", "tenant": "x",
              "priority": 0, "hosts": 2, "min_hosts": 0, "model": "",
              "seq": 1, "conf": {}, "ts": t0})
    j.append({"t": fj.REC_FLEET_GRANT, "job": "a", "hosts": 2,
              "placement": {"0": 2}, "ts": t0})
    j.append({"t": fj.REC_FLEET_STATE, "job": "a", "state": "FINISHED",
              "exit": 0, "ts": t0 + 40_000})
    j.append({"t": fj.REC_FLEET_SUBMIT, "job": "b", "tenant": "x",
              "priority": 0, "hosts": 3, "min_hosts": 0, "model": "",
              "seq": 2, "conf": {}, "ts": t0 + 1_000})
    j.close()
    wl = fsim.fold_workload(ftimeline.load(path=str(path)))
    by_id = {jb.job_id: jb for jb in wl.jobs}
    assert by_id["a"].work_chip_ms == 2 * 40_000
    # b never ran: median per-host duration (40s) x requested hosts
    assert by_id["b"].work_chip_ms == 40_000 * 3


# ---------------------------------------------------------------------------
# override grammar
# ---------------------------------------------------------------------------
def test_override_grammar_axes():
    ov = fsim.build_overrides(
        sets=[f"{K.FLEET_QUOTAS}=a=1|b=2", "defrag=off",
              f"{K.FLEET_SIM_RESTORE}=false", "priority.j1=9"],
        quotas=["capped=4"], pool="3x8", priorities=["j2=-1"])
    assert ov.quotas == {"a": 1, "b": 2, "capped": 4}
    assert (ov.slices, ov.hosts_per_slice) == (3, 8)
    assert ov.priorities == {"j1": 9, "j2": -1}
    assert ov.defrag is False and ov.restore is False
    assert ov.preemption is True
    assert "quota.capped=4" in ov.describe()


def test_override_unknown_key_and_bad_specs_raise():
    with pytest.raises(ValueError, match="unknown whatif key"):
        fsim.build_overrides(sets=["bogus=1"])
    with pytest.raises(ValueError, match="need key=value"):
        fsim.build_overrides(sets=["no-equals"])
    with pytest.raises(ValueError, match="need SLICESxHOSTS"):
        fsim.parse_pool("8")
    with pytest.raises(ValueError, match="not a boolean"):
        fsim.build_overrides(sets=["preemption=maybe"])


def test_sweep_cartesian_product_and_cap():
    combos = fsim.expand_sweeps(
        fsim.Overrides(), ["quota.t=1,2,3", "pool=1x4,2x4"])
    assert len(combos) == 6
    labels = [lbl for lbl, _ in combos]
    assert "quota.t=1 pool=1x4" in labels
    ov = dict(combos)["quota.t=3 pool=2x4"]
    assert ov.quotas == {"t": 3} and ov.slices == 2
    with pytest.raises(ValueError, match="exceeds"):
        fsim.expand_sweeps(fsim.Overrides(),
                           [f"priority.j={','.join(map(str, range(65)))}"])


# ---------------------------------------------------------------------------
# parity replay
# ---------------------------------------------------------------------------
def test_parity_bit_for_bit_on_recorded_mix(mix_tl):
    par = fsim.parity_replay(mix_tl)
    assert par["supported"] and par["ok"] and par["gate_ok"]
    assert par["mismatches"] == []
    assert par["counts"]["grant"] == 50
    assert par["counts"]["preempt"] > 0


def test_parity_gate_on_golden_fleetdir():
    # golden's handcrafted decision texts differ from the engine's
    # plan (notes territory), but the grant/preempt gate must HOLD and
    # the exogenous operator migrate must be applied, not flagged.
    par = fsim.parity_replay(ftimeline.load(GOLDEN))
    assert par["supported"] and par["gate_ok"]
    assert par["mismatch_counts"]["grant"] == 0
    assert par["mismatch_counts"]["preempt"] == 0
    assert par["exogenous_migrations"] == 1


def test_parity_flags_tampered_grant_placement():
    par = fsim.parity_replay(ftimeline.load(PARITY_BAD))
    assert par["supported"] and not par["ok"] and not par["gate_ok"]
    kinds = {m["kind"] for m in par["mismatches"]}
    assert "grant" in kinds


def test_parity_skips_non_terminal_journal(tmp_path):
    path = tmp_path / "fleet.journal.jsonl"
    j = fj.FleetJournal(str(path))
    t0 = 1_600_000_000_000
    j.append({"t": fj.REC_FLEET_GEN, "generation": 1, "slices": 1,
              "hosts_per_slice": 4, "quotas": {}, "ts": t0})
    j.append({"t": fj.REC_FLEET_SUBMIT, "job": "a", "tenant": "x",
              "priority": 0, "hosts": 2, "min_hosts": 0, "model": "",
              "seq": 1, "conf": {}, "ts": t0})
    j.append({"t": fj.REC_FLEET_GRANT, "job": "a", "hosts": 2,
              "placement": {"0": 2}, "ts": t0})
    j.close()
    par = fsim.parity_replay(ftimeline.load(path=str(path)))
    assert not par["supported"]
    assert "not terminal" in par["reason"]


def test_check_rule_fleet_sim_parity_twins():
    from tony_tpu_torch.devtools import invariants

    rep = invariants.check_job_dir(MIX)
    assert not [v for v in rep.violations
                if v.rule == "fleet-sim-parity"]
    assert rep.checked.get("fleet-sim-parity", 0) > 50
    rep_bad = invariants.check_job_dir(PARITY_BAD)
    bad = [v for v in rep_bad.violations
           if v.rule == "fleet-sim-parity"]
    assert len(bad) == 1 and "diverges" in bad[0].message
    # golden: decision-text drift is a note, never a violation
    rep_g = invariants.check_job_dir(GOLDEN)
    assert not [v for v in rep_g.violations
                if v.rule == "fleet-sim-parity"]
    assert any("fleet-sim-parity" in n for n in rep_g.notes)


# ---------------------------------------------------------------------------
# determinism + fixture regeneration
# ---------------------------------------------------------------------------
def test_simulation_deterministic_byte_identical(mix_tl):
    wl = fsim.fold_workload(mix_tl)
    a = json.dumps(fsim.simulate(wl), sort_keys=True)
    b = json.dumps(fsim.simulate(wl), sort_keys=True)
    assert a == b
    ov = fsim.build_overrides(quotas=["capped=4"])
    ra = json.dumps(fsim.whatif(mix_tl, ov, ["pool=1x4,2x4"]),
                    sort_keys=True)
    rb = json.dumps(fsim.whatif(mix_tl, ov, ["pool=1x4,2x4"]),
                    sort_keys=True)
    assert ra == rb


@pytest.mark.slow
def test_gen_whatif_mix_regenerates_checked_in_fixture(tmp_path):
    """The fixture generator's workload through the PORT's simulator
    reproduces the checked-in journal byte for byte."""
    with open(GEN) as f:
        text = f.read()
    ref_import = "from tony_tpu.fleet import simulator as fsim"
    assert ref_import in text
    gen = tmp_path / "gen_whatif_mix_port.py"
    gen.write_text(text.replace(
        ref_import, "from tony_tpu_torch.fleet import simulator as fsim"))
    out = tmp_path / "fleet.journal.jsonl"
    subprocess.run([sys.executable, str(gen), str(out)], check=True,
                   capture_output=True, cwd=REPO,
                   env={**os.environ, "PYTHONPATH": REPO})
    with open(out, "rb") as f:
        fresh = f.read()
    with open(os.path.join(MIX, "fleet.journal.jsonl"), "rb") as f:
        checked_in = f.read()
    assert fresh == checked_in, \
        "gen_whatif_mix.py no longer reproduces tests/fixtures/" \
        "whatif_mix byte-for-byte — regenerate the fixture (and " \
        "re-record BENCH_WHATIF) or fix the drift"


def test_recorded_sim_run_parity_replays_clean(tmp_path):
    wl = fsim.fold_workload(ftimeline.load(GOLDEN))
    path = str(tmp_path / "fleet.journal.jsonl")
    fsim.simulate(wl, recorder=fsim.JournalRecorder(path))
    par = fsim.parity_replay(ftimeline.load(path=path))
    assert par["ok"], par["mismatches"]


# ---------------------------------------------------------------------------
# counterfactual axes
# ---------------------------------------------------------------------------
def test_quota_bump_unblocks_starved_tenant(mix_tl):
    report = fsim.whatif(mix_tl,
                         fsim.build_overrides(quotas=["capped=4"]))
    assert report["parity"]["ok"]
    base = report["base"]
    cf = report["counterfactuals"][0]
    assert cf["per_tenant"]["capped"]["queue_wait_p99_s"] \
        < base["per_tenant"]["capped"]["queue_wait_p99_s"]
    assert cf["metrics"]["quota_hold_s"] < base["metrics"]["quota_hold_s"]
    assert cf["diff"]["quota_hold_s"]["improves"] is True
    removed = {(h["tenant"], h["hold"]) for h in cf["holds_removed"]}
    assert ("capped", "quota_hold_s") in removed
    capped_cite = [h for h in cf["holds_removed"]
                   if h["tenant"] == "capped"
                   and h["hold"] == "quota_hold_s"]
    assert capped_cite[0]["was_blocking"], \
        "quota-hold citation lost its blocking jobs"


def test_priority_flip_reorders_grants(mix_tl):
    # boosting a late capped job to priority 20 must shrink ITS wait
    wl = fsim.fold_workload(mix_tl)
    base = fsim.simulate(wl)
    boosted = fsim.simulate(
        wl, fsim.build_overrides(priorities=["wf-0045=20"]))

    def wait(res, job):
        tl_base = {j.job_id: j for j in wl.jobs}
        # queue wait is granted - submitted; recompute from folds via
        # metrics? use per-run granted_ms through ungranted list absence
        return res

    # direct check via a per-job re-simulation API: fold metrics only
    # expose percentiles, so assert through the tenant bucket instead —
    # wf-0045 is capped's last-but-one job and dominates its p99.
    b = base["per_tenant"]["capped"]["queue_wait_p99_s"]
    c = boosted["per_tenant"]["capped"]["queue_wait_p99_s"]
    assert c < b


def test_pool_resize_axes(mix_tl):
    wl = fsim.fold_workload(mix_tl)
    base = fsim.simulate(wl)
    bigger = fsim.simulate(wl, fsim.build_overrides(pool="4x4"))
    assert bigger["metrics"]["makespan_s"] \
        < base["metrics"]["makespan_s"]
    assert bigger["metrics"]["queue_wait_p99_s"] \
        < base["metrics"]["queue_wait_p99_s"]
    # shrinking below the biggest recorded gang refuses those gangs at
    # submit, mirroring the daemon's refusal
    tiny = fsim.simulate(wl, fsim.build_overrides(pool="1x4"))
    assert tiny["metrics"]["refused"] >= 2
    assert all(r["hosts"] > 4 for r in tiny["refused"])


def test_preemption_disable_removes_shrinks(mix_tl):
    wl = fsim.fold_workload(mix_tl)
    base = fsim.simulate(wl)
    assert base["metrics"]["preemptions"] > 0
    rigid = fsim.simulate(
        wl, fsim.build_overrides(sets=["preemption=false"]))
    assert rigid["metrics"]["preemptions"] == 0
    assert rigid["metrics"]["restores"] == 0


def test_defrag_disable_gates_migrations():
    # golden's workload replans its defrag move; with defrag off the
    # sim must apply zero migrations and still drain every job
    wl = fsim.fold_workload(ftimeline.load(MIX))
    base = fsim.simulate(wl)
    nodefrag = fsim.simulate(wl,
                             fsim.build_overrides(sets=["defrag=off"]))
    assert base["metrics"]["migrations"] > 0
    assert nodefrag["metrics"]["migrations"] == 0
    assert nodefrag["metrics"]["ungranted"] == 0
    assert nodefrag["ungranted"] == []
    assert nodefrag["metrics"]["granted"] == 50


def test_restore_disable_keeps_shrunk_sizes(mix_tl):
    wl = fsim.fold_workload(mix_tl)
    base = fsim.simulate(wl)
    norestore = fsim.simulate(
        wl, fsim.build_overrides(sets=[f"{K.FLEET_SIM_RESTORE}=off"]))
    assert base["metrics"]["restores"] > 0
    assert norestore["metrics"]["restores"] == 0
    # shrunk jobs run longer at fewer hosts: makespan can only grow
    assert norestore["metrics"]["makespan_s"] \
        >= base["metrics"]["makespan_s"]


def test_recorded_metrics_match_sim_base_on_recorded_mix(mix_tl):
    # the mix fixture IS a recorded simulation, so the recorded column
    # and the sim-base column must agree exactly — the strongest
    # calibration statement the report makes
    rec = fsim.recorded_metrics(mix_tl)["metrics"]
    base = fsim.simulate(fsim.fold_workload(mix_tl))["metrics"]
    assert rec == base


# ---------------------------------------------------------------------------
# CLI + rendering
# ---------------------------------------------------------------------------
def test_cli_whatif_json_and_expect_parity(capsys):
    from tony_tpu_torch.cli.main import main

    rc = main(["fleet", "whatif", "--dir", MIX, "--quota", "capped=4",
               "--sweep", "quota.capped=3,4", "--expect-parity",
               "--json"])
    out = capsys.readouterr().out
    assert rc == 0
    doc = json.loads(out)
    assert doc["parity"]["ok"]
    assert [c["label"] for c in doc["counterfactuals"]] == \
        ["quota.capped=4", "quota.capped=3", "quota.capped=4"]


def test_cli_whatif_expect_parity_fails_on_tampered_journal(capsys):
    from tony_tpu_torch.cli.main import main

    rc = main(["fleet", "whatif", "--dir", PARITY_BAD,
               "--expect-parity"])
    assert rc == 1
    assert "gate BROKEN" in capsys.readouterr().out


def test_cli_whatif_bad_key_exits_2(capsys):
    from tony_tpu_torch.cli.main import main

    rc = main(["fleet", "whatif", "--dir", MIX, "--set", "bogus=1"])
    assert rc == 2
    assert "unknown whatif key" in capsys.readouterr().err


def test_render_report_cites_holds_and_marks_directions(mix_tl):
    report = fsim.whatif(mix_tl,
                         fsim.build_overrides(quotas=["capped=4"]))
    text = fsim.render_report(report)
    assert "parity: OK" in text
    assert "counterfactual [quota.capped=4]" in text
    assert "(improves)" in text
    assert "removed" in text and "tenant 'capped'" in text


def test_whatif_report_and_bogus_key(tmp_path):
    """What the portal's /whatif serves: the report renders parity and the
    counterfactual, and a bogus --set key is refused; then the same
    through the port's portal (HTML, ``format=json``, and the 400)."""
    import urllib.error
    import urllib.request

    from tony_tpu_torch.portal.server import PortalServer

    report = fsim.whatif_from_dir(MIX, quotas=["capped=4"])
    assert report["parity"]["ok"]
    body = fsim.render_report(report)
    assert "parity: OK" in body and "quota.capped=4" in body
    with pytest.raises(ValueError):
        fsim.whatif_from_dir(MIX, sets=["bogus=1"])

    hist = tmp_path / "history"
    hist.mkdir()
    srv = PortalServer(str(hist), port=0, fleet_dir=MIX)
    srv.start()
    try:
        page = urllib.request.urlopen(
            srv.url + "/whatif?quota=capped=4").read().decode()
        assert "parity: OK" in page and "quota.capped=4" in page
        doc = json.load(urllib.request.urlopen(
            srv.url + "/whatif?quota=capped=4&format=json"))
        assert doc["parity"]["ok"]
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(srv.url + "/whatif?set=bogus=1")
        assert e.value.code == 400
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# conf-key registration
# ---------------------------------------------------------------------------
def test_sim_conf_keys_registered():
    from tony_tpu_torch.conf.config import TonyTpuConfig

    conf = TonyTpuConfig()
    for key in (K.FLEET_SIM_PREEMPTION, K.FLEET_SIM_DEFRAG,
                K.FLEET_SIM_RESTORE):
        assert conf.get_bool(key, False) is True
