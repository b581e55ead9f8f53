"""Chaos drills through the port's runner: the seeded sweep and the
seed-corpus replays of ``tests/test_e2e_chaos.py``.

The sweep (``slow``, as the reference's) runs 40 seeded schedules over the
migrate and fleet suites, every schedule asserted clean on the full
invariant ladder. The corpus replay re-runs the checked-in shrunk repros of
``tests/chaos_corpus/`` (``schedule-000022.json`` and
``schedule-000045.json``) through the port's runner: each is a schedule
that once violated the ladder in the reference, and must stay clean here.
It takes a few seconds, so it runs in tier-1, as does ``cli chaos run |
replay | shrink`` over two schedules. The conftest's artifact gate arms
only ``test_e2e*`` modules, so the drills run ``check_artifacts`` over
their trees themselves."""

import json
import os

import pytest

from tony_tpu_torch.chaos import artifact as chaos_artifact
from tony_tpu_torch.chaos.runner import run_schedule
from tony_tpu_torch.chaos.schedule import plan

from test_torch_e2e_recovery import check_artifacts

pytestmark = pytest.mark.faults

CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "chaos_corpus")

SWEEP_SEED = 17
SWEEP_SCHEDULES = 40


@pytest.mark.slow
@pytest.mark.timeout_s(560)
def test_seeded_sweep_migrate_and_fleet_hold_the_ladder(tmp_path):
    suites = ("migrate", "fleet")
    failures = []
    for index in range(SWEEP_SCHEDULES):
        sched = plan(SWEEP_SEED, index, suites[index % len(suites)])
        workdir = str(tmp_path / sched.name)
        outcome = run_schedule(sched, workdir)
        if not outcome.ok:
            # Keep the evidence: a replayable artifact for `tony-tpu
            # chaos replay` / `chaos shrink`, plus the scratch tree.
            path = chaos_artifact.save_artifact(
                str(tmp_path / "findings"), sched, outcome)
            failures.append(
                f"{sched.name} [{sched.suite}] {outcome.status}/"
                f"{outcome.failure_domain}: "
                + "; ".join(f"{v.rung}: {v.detail}"
                            for v in outcome.violations)
                + f" (artifact: {path})")
    assert not failures, (
        f"{len(failures)}/{SWEEP_SCHEDULES} schedule(s) violated the "
        f"invariant ladder (seed {SWEEP_SEED}):\n" + "\n".join(failures))
    check_artifacts(tmp_path)


def _corpus_docs():
    return [(name, chaos_artifact.load_artifact(os.path.join(CORPUS, name)))
            for name in sorted(os.listdir(CORPUS))
            if name.endswith(".json")]


@pytest.mark.timeout_s(300)
def test_corpus_repros_stay_fixed(tmp_path):
    """Every corpus schedule re-runs clean: the chaos-found bugs each
    artifact's note describes must stay fixed."""
    docs = _corpus_docs()
    assert docs, "seed corpus must not be empty"
    for name, doc in docs:
        sched = chaos_artifact.schedule_from_doc(doc)
        outcome = run_schedule(sched, str(tmp_path / name))
        recorded = chaos_artifact.outcome_from_doc(doc)
        assert outcome.ok, (
            f"{name} regressed — note: {doc.get('note', '?')!r}; "
            f"violations: "
            + "; ".join(f"{v.rung}: {v.detail}"
                        for v in outcome.violations))
        # Terminal shape should match the recorded post-fix outcome.
        assert (outcome.status, outcome.failure_domain) == \
               (recorded.status, recorded.failure_domain), (
            f"{name}: replay ended {outcome.status}/"
            f"{outcome.failure_domain}, artifact recorded "
            f"{recorded.status}/{recorded.failure_domain}")
    assert [name for name, _ in docs] == ["schedule-000022.json",
                                          "schedule-000045.json"]
    check_artifacts(tmp_path)


@pytest.mark.slow
def test_corpus_artifacts_are_canonical_json():
    """Corpus files are hand-checked-in: keep them loadable, sorted and
    newline-terminated so diffs stay reviewable."""
    for name, doc in _corpus_docs():
        path = os.path.join(CORPUS, name)
        with open(path, encoding="utf-8") as f:
            raw = f.read()
        assert raw == json.dumps(doc, indent=2, sort_keys=True) + "\n", (
            f"{name} is not canonical: rewrite with "
            f"json.dumps(doc, indent=2, sort_keys=True)")


def test_cli_chaos_run_replay_and_shrink(tmp_path, capsys):
    """``cli chaos run`` sweeps two seeded e2e schedules and saves an
    artifact per schedule (the oracle's ladder, ``check`` included, ran on
    each; a clean run's scratch tree is removed); ``chaos replay``
    re-plans the first bit for bit and re-runs it to the recorded verdict;
    ``chaos shrink`` refuses an artifact that does not fail."""
    from tony_tpu_torch.cli.main import main as cli_main

    out = str(tmp_path / "chaos")
    assert cli_main(["chaos", "run", "--seed", str(SWEEP_SEED),
                     "--schedules", "2", "--suite", "e2e",
                     "--out", out]) == 0
    text = capsys.readouterr().out
    assert "chaos: 2 schedule(s), 0 failing" in text
    names = sorted(n for n in os.listdir(out) if n.endswith(".json"))
    assert names == ["schedule-000000.json", "schedule-000001.json"]
    doc = chaos_artifact.load_artifact(os.path.join(out, names[0]))
    assert chaos_artifact.schedule_from_doc(doc).as_dict() == \
        plan(SWEEP_SEED, 0, "e2e").as_dict()
    assert cli_main(["chaos", "replay", os.path.join(out, names[0]),
                     "--out", str(tmp_path / "replay")]) == 0
    assert "replay" in capsys.readouterr().out
    assert cli_main(["chaos", "shrink", os.path.join(out, names[0]),
                     "--out", str(tmp_path / "shrink")]) == 2
    assert "FAILING artifact" in capsys.readouterr().err
