"""Save-on-SIGTERM in the port's trainer, and the failure-survival CLI.

``trainer.train`` with a ``ckpt_dir`` installs the manager's SIGTERM
handler: the drain of an elastic resize or a migration TERMs the process
and expects one final save. torch updates parameters and Adam moments IN
PLACE, one tensor after another, so a snapshot taken where the TERM lands
could hold some tensors at step k+1 and the rest at step k. The step runs
inside ``CheckpointManager.updating()``: the TERM is deferred, and the
final save holds the state after the whole step.

Here a TERM is sent from inside the optimizer's update of a small decoder
(after the first parameter's ``addcdiv_``, the rest not yet updated), in a
subprocess. Its checkpoint must equal, bit for bit, an uninterrupted run's
checkpoint of the same step, and a resume from it must continue at that
step with the uninterrupted run's losses. A TERM sent from inside the
periodic save of a step (before the save's busy scope, or inside its host
snapshot) must leave that step's checkpoint too.

A job of two gloo ranks, replicated and on an ``fsdp=2`` mesh, is TERMed
on rank 1 only, from inside a step: the ranks agree on the TERM at that
step's boundary, both save that step together and exit 143, and a resume
continues at the next step with the uninterrupted run's losses.

Also the exit codes and ``--json`` output of ``cli check`` and
``cli lint``, as ``tests/test_invariants.py`` and ``tests/test_lint.py``
cover the reference's.
"""

import json
import os
import socket
import statistics
import subprocess
import sys

import pytest
import torch

from tony_tpu_torch import constants
from tony_tpu_torch.checkpoint import CheckpointManager
from tony_tpu_torch.cli.main import main as cli_main
from tony_tpu_torch.devtools import invariants
from tony_tpu_torch.models.transformer import TransformerConfig
from tony_tpu_torch.parallel.train import checkpoint_tree
from tony_tpu_torch import trainer

#: The resumed losses against the uninterrupted run's, relative
#: (chip_smoke.py's limit for a resume).
TOL_RESUME_REL = 1e-3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: The optimizer step (0-based) inside which the TERM lands, and the steps
#: of the interrupted job.
TERM_AT, STEPS = 3, 6

# Trains the tiny decoder on the CPU with one thread. Mode "term": a TERM
# is sent to this process from inside optimizer step TERM_AT, right after
# the first parameter's update, having written how many parameters had
# moved then. Modes "term-sync" and "term-save": the TERM is sent from
# inside the manager's save of step TERM_AT, from its wait for the state
# (before the save's busy scope: the handler runs at once) or from its host
# snapshot (inside the busy scope: deferred). Mode "plain": no TERM. Prints
# the trainer's result.
SCRIPT = r"""
import json, os, signal, sys
import torch
from torch.optim.optimizer import register_optimizer_step_pre_hook
from torch.overrides import TorchFunctionMode
from tony_tpu_torch import trainer
from tony_tpu_torch.checkpoint import manager as ckpt_manager
from tony_tpu_torch.models.transformer import TransformerConfig

mode, corpus, ckpt, marker = sys.argv[1:5]
term_at, steps, save_every = (int(x) for x in sys.argv[5:8])
torch.set_num_threads(1)
seen = {"steps": 0, "armed": False}


def pre_hook(opt, args, kwargs):
    if opt.param_groups[0]["lr"] == 0:
        return          # checkpoint_tree's moment-creating zero step
    if mode == "term" and seen["steps"] == term_at:
        seen["params"] = [p for g in opt.param_groups for p in g["params"]]
        seen["before"] = [p.detach().clone() for p in seen["params"]]
        seen["armed"] = True
    seen["steps"] += 1


register_optimizer_step_pre_hook(pre_hook)


def term_in_save(owner, name):
    inner = getattr(owner, name)
    saves = {"n": 0}

    def wrapper(*args, **kwargs):
        if sys._getframe(1).f_code.co_name == "save":
            saves["n"] += 1
            if saves["n"] == term_at + 1:
                os.kill(os.getpid(), signal.SIGTERM)
        return inner(*args, **kwargs)

    setattr(owner, name, wrapper)


if mode == "term-sync":
    term_in_save(ckpt_manager.telemetry, "block_until_ready")
elif mode == "term-save":
    term_in_save(ckpt_manager, "_host_snapshot")


class TermMidUpdate(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if seen["armed"] and getattr(func, "__name__", "") == "addcdiv_":
            seen["armed"] = False
            moved = sum(not torch.equal(p, b)
                        for p, b in zip(seen["params"], seen["before"]))
            with open(marker, "w") as f:
                json.dump({"moved": moved, "total": len(seen["params"])}, f)
            os.kill(os.getpid(), signal.SIGTERM)
        return out


with TermMidUpdate():
    out = trainer.train(TransformerConfig.tiny(max_seq_len=32), corpus,
                        batch=4, seq=32, steps=steps, ckpt_dir=ckpt,
                        save_interval=save_every, device="cpu", seed=0)
del out["state"]
print(json.dumps(out))
sys.exit(0 if mode == "plain" else 3)
"""


def _run(tmp, mode, ckpt, steps, save_every):
    return subprocess.Popen(
        [sys.executable, str(tmp / "preempt_train.py"), mode, str(tmp / "corpus.bin"),
         str(ckpt), str(tmp / "moved.json"), str(TERM_AT), str(steps),
         str(save_every)],
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(proc):
    try:
        out, err = proc.communicate(timeout=150)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    return proc.returncode, out, err


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The interrupted job (checkpoints only through the TERM); an
    uninterrupted one that stops after step TERM_AT (its last step is
    always saved, and waited for); an uninterrupted one of as many steps
    as the interrupted job; and two jobs that save every step and are
    TERMed inside the save of step TERM_AT."""
    tmp = tmp_path_factory.mktemp("preempt")
    (tmp / "preempt_train.py").write_text(SCRIPT)
    trainer.write_corpus(str(tmp / "corpus.bin"),
                         TransformerConfig.tiny().vocab_size)
    procs = {"term": _run(tmp, "term", tmp / "term", STEPS, 1000),
             "whole": _run(tmp, "plain", tmp / "whole", TERM_AT + 1, 1000),
             "full": _run(tmp, "plain", tmp / "full", STEPS, 1000),
             "term-sync": _run(tmp, "term-sync", tmp / "sync", STEPS, 1),
             "term-save": _run(tmp, "term-save", tmp / "save", STEPS, 1)}
    return {"tmp": tmp, **{k: _finish(p) for k, p in procs.items()}}


def _tree(directory, step):
    """Checkpoint ``step`` of ``directory``, restored into the tree of a
    decoder made from another seed (every value comes from the file)."""
    like = trainer.build_state(TransformerConfig.tiny(max_seq_len=32),
                               "cpu", seed=1)
    mgr = CheckpointManager(str(directory))
    try:
        return mgr.restore(step, checkpoint_tree(like))
    finally:
        mgr.close()


def _assert_bitwise(a, b, path="tree"):
    if isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str), path
        for k in a:
            _assert_bitwise(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


def test_term_inside_the_update_saves_the_whole_step(runs):
    rc, out, err = runs["term"]
    assert rc == 143, (out, err[-4000:])
    moved = json.loads((runs["tmp"] / "moved.json").read_text())
    # The TERM really landed between two parameters' updates.
    assert 0 < moved["moved"] < moved["total"], moved
    mgr = CheckpointManager(str(runs["tmp"] / "term"))
    try:
        # save_interval 1000: the policy saves the first step, and only
        # the TERM's save can hold step TERM_AT.
        assert mgr.all_steps() == [0, TERM_AT]
        assert mgr.verify_step(TERM_AT)
    finally:
        mgr.close()
    rc, out, err = runs["whole"]
    assert rc == 0, err[-4000:]
    got = _tree(runs["tmp"] / "term", TERM_AT)
    want = _tree(runs["tmp"] / "whole", TERM_AT)
    assert got["step"] == want["step"] == TERM_AT + 1
    _assert_bitwise(got, want)


def test_resume_from_the_term_checkpoint_continues_at_its_step(runs):
    assert runs["term"][0] == 143
    rc, out, err = _finish(_run(runs["tmp"], "plain", runs["tmp"] / "term",
                                STEPS, 1000))
    assert rc == 0, err[-4000:]
    resumed = json.loads(out.strip().splitlines()[-1])
    assert runs["full"][0] == 0, runs["full"][2][-4000:]
    full = json.loads(runs["full"][1].strip().splitlines()[-1])
    assert resumed["start_step"] == TERM_AT + 1
    assert resumed["restored_step"] == TERM_AT
    assert resumed["losses"] == full["losses"][TERM_AT + 1:]


@pytest.mark.parametrize("mode", ["term-sync", "term-save"])
def test_term_inside_a_due_save_keeps_its_step(runs, mode):
    """The TERM lands inside ``mgr.save`` of step TERM_AT (save_interval
    1): at once, before the save's busy scope, or deferred from inside
    its host snapshot. Either way the drain's checkpoint is step TERM_AT,
    equal bit for bit to an uninterrupted run's."""
    rc, out, err = runs[mode]
    assert rc == 143, (out, err[-4000:])
    mgr = CheckpointManager(str(runs["tmp"] / mode.split("-")[1]))
    try:
        assert mgr.all_steps()[-1] == TERM_AT, mgr.all_steps()
        assert mgr.verify_step(TERM_AT)
    finally:
        mgr.close()
    assert runs["whole"][0] == 0, runs["whole"][2][-4000:]
    _assert_bitwise(_tree(runs["tmp"] / mode.split("-")[1], TERM_AT),
                    _tree(runs["tmp"] / "whole", TERM_AT))


# Trains the tiny decoder for 3 steps with a checkpoint directory, as rank
# RANK of a gloo group of WORLD processes (no group for one), and prints
# whether SIGTERM's handler was the default at each optimizer step and
# after the loop.
HANDLER_SCRIPT = r"""
import json, signal, sys
import torch
import torch.distributed as dist
from torch.optim.optimizer import register_optimizer_step_pre_hook
from tony_tpu_torch import trainer
from tony_tpu_torch.models.transformer import TransformerConfig

corpus, ckpt, port, rank, world = sys.argv[1:6]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
if world > 1:
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
default = []


def pre_hook(opt, args, kwargs):
    if opt.param_groups[0]["lr"] != 0:
        default.append(signal.getsignal(signal.SIGTERM) is signal.SIG_DFL)


register_optimizer_step_pre_hook(pre_hook)
trainer.train(TransformerConfig.tiny(max_seq_len=32), corpus, batch=4,
              seq=32, steps=3, ckpt_dir=ckpt, device="cpu", seed=0)
print(json.dumps({"steps": default, "after": signal.getsignal(
    signal.SIGTERM) is signal.SIG_DFL}))
if world > 1:
    dist.destroy_process_group()
"""


@pytest.mark.parametrize("world", [1, 2])
def test_handler_only_in_a_job_of_one_process(tmp_path, world):
    """Every job that checkpoints, whatever its world size, installs the
    handler once its first step is done and puts the default back after
    the loop. (The name is older than the contract: a job of several
    ranks now installs it too, and agrees on the TERM at each step's
    boundary; the drills below hold that.)"""
    (tmp_path / "handler.py").write_text(HANDLER_SCRIPT)
    corpus = trainer.write_corpus(str(tmp_path / "corpus.bin"),
                                  TransformerConfig.tiny().vocab_size)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, str(tmp_path / "handler.py"), corpus,
         str(tmp_path / "ckpt"), str(port), str(rank), str(world)],
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(world)]
    for proc in procs:
        rc, out, err = _finish(proc)
        assert rc == 0, err[-4000:]
        got = json.loads(out.strip().splitlines()[-1])
        assert got == {"steps": [True, False, False], "after": True}


# Trains the tiny decoder for STEPS steps as rank RANK of a gloo group of
# two processes (FileStore rendezvous in TMP), on MESH ("" replicated),
# saving into CKPT every 1000 steps (the first and last steps, and a
# drain's). Mode "term": rank 1 sends itself a TERM from inside optimizer
# step TERM_AT (its pre-hook: inside the step's busy scope). Mode "plain":
# no TERM. Prints the trainer's result with the seconds of each step
# boundary's agreement (CheckpointManager.preemption_point).
DRAIN_SCRIPT = r"""
import json, os, signal, sys, time
import torch
import torch.distributed as dist
from torch.optim.optimizer import register_optimizer_step_pre_hook
from tony_tpu_torch import trainer
from tony_tpu_torch.checkpoint import manager as ckpt_manager
from tony_tpu_torch.models.transformer import TransformerConfig

mode, corpus, ckpt, mesh, tmp = sys.argv[1:6]
rank, steps, term_at = (int(x) for x in sys.argv[6:9])
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(
    os.path.join(tmp, "rdzv"), 2), rank=rank, world_size=2)
seen = {"steps": 0}


def pre_hook(opt, args, kwargs):
    if opt.param_groups[0]["lr"] == 0:
        return          # checkpoint_tree's moment-creating zero step
    if mode == "term" and rank == 1 and seen["steps"] == term_at:
        os.kill(os.getpid(), signal.SIGTERM)
    seen["steps"] += 1


register_optimizer_step_pre_hook(pre_hook)
agree_s = []
point = ckpt_manager.CheckpointManager.preemption_point


def timed_point(self):
    t0 = time.perf_counter()
    point(self)
    agree_s.append(time.perf_counter() - t0)


ckpt_manager.CheckpointManager.preemption_point = timed_point
out = trainer.train(TransformerConfig.tiny(max_seq_len=32), corpus,
                    batch=4, seq=32, steps=steps, ckpt_dir=ckpt,
                    save_interval=1000, device="cpu", seed=0, mesh=mesh)
del out["state"]
out["agree_s"] = agree_s
print(json.dumps(out))
dist.destroy_process_group()
sys.exit(0 if mode == "plain" else 3)
"""

DRAIN_LAYOUTS = {"replicated": "", "fsdp": "fsdp=2"}
#: A rank that stopped by agreement waits this long for its own TERM.
DRAIN_GRACE_S = 2


def _drain_pair(tmp, label, mode, ckpt, mesh):
    run = tmp / label
    run.mkdir()
    env = dict(os.environ, PYTHONPATH=REPO,
               TONY_TASK_KILL_GRACE_S=str(DRAIN_GRACE_S))
    return [subprocess.Popen(
        [sys.executable, str(tmp / "drain_train.py"), mode,
         str(tmp / "corpus.bin"), str(ckpt), mesh, str(run), str(rank),
         str(STEPS), str(TERM_AT)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in range(2)]


@pytest.fixture(scope="module")
def drains(tmp_path_factory):
    """Per layout: the job TERMed on rank 1 inside step TERM_AT, an
    uninterrupted job of as many steps, then the TERMed job resumed."""
    tmp = tmp_path_factory.mktemp("drain")
    (tmp / "drain_train.py").write_text(DRAIN_SCRIPT)
    trainer.write_corpus(str(tmp / "corpus.bin"),
                         TransformerConfig.tiny().vocab_size)
    procs = {}
    for layout, mesh in DRAIN_LAYOUTS.items():
        procs[layout, "term"] = _drain_pair(
            tmp, f"{layout}-term", "term", tmp / f"{layout}-ckpt", mesh)
        procs[layout, "full"] = _drain_pair(
            tmp, f"{layout}-full", "plain", tmp / f"{layout}-full-ckpt",
            mesh)
    out = {k: [_finish(p) for p in pair] for k, pair in procs.items()}
    for layout in DRAIN_LAYOUTS:
        # What the drain left, before the resume adds its own steps.
        mgr = CheckpointManager(str(tmp / f"{layout}-ckpt"))
        try:
            out[layout, "left"] = (mgr.all_steps(), mgr.verify_step(TERM_AT),
                                   mgr.saved_world_size(TERM_AT))
        finally:
            mgr.close()
    procs = {(layout, "resume"): _drain_pair(
        tmp, f"{layout}-resume", "plain", tmp / f"{layout}-ckpt", mesh)
        for layout, mesh in DRAIN_LAYOUTS.items()}
    out.update({k: [_finish(p) for p in pair] for k, pair in procs.items()})
    return {"tmp": tmp, **out}


@pytest.mark.parametrize("layout", sorted(DRAIN_LAYOUTS))
def test_term_on_one_rank_saves_the_boundary_step_on_both(drains, layout):
    """Rank 1 alone takes the TERM, inside step TERM_AT. At that step's
    boundary both ranks see it, save step TERM_AT together (a sharded
    state: each its shards; a replicated one: rank 0, rank 1 at the
    barrier) and exit 143; rank 0, which took no TERM, first waits the
    grace for its own."""
    for rank, (rc, out, err) in enumerate(drains[layout, "term"]):
        assert rc == 143, (rank, out, err[-4000:])
        saved = f"saving preemption checkpoint at step {TERM_AT}" in err
        assert saved == (layout == "fsdp" or rank == 0), (rank, err[-4000:])
        assert ("stopped by the ranks' agreement" in err) == (rank == 0), \
            (rank, err[-4000:])
    # save_interval 1000: the policy saves the first step, and only the
    # drain can hold step TERM_AT; it verifies, saved at world 2.
    assert drains[layout, "left"] == ([0, TERM_AT], True, 2)


@pytest.mark.parametrize("layout", sorted(DRAIN_LAYOUTS))
def test_resume_after_the_agreed_save_reruns_no_step(drains, layout):
    for rank in range(2):
        rc, out, err = drains[layout, "full"][rank]
        assert rc == 0, err[-4000:]
        full = json.loads(out.strip().splitlines()[-1])
        rc, out, err = drains[layout, "resume"][rank]
        assert rc == 0, err[-4000:]
        resumed = json.loads(out.strip().splitlines()[-1])
        assert resumed["restored_step"] == TERM_AT
        assert resumed["start_step"] == TERM_AT + 1
        want = full["losses"][TERM_AT + 1:]
        assert len(resumed["losses"]) == len(want) == STEPS - TERM_AT - 1
        for got, ref in zip(resumed["losses"], want):
            assert abs(got - ref) <= TOL_RESUME_REL * abs(ref), (got, ref)
        # The boundary's agreement: one host round trip on the gloo group.
        agree = full["agree_s"]
        assert len(agree) == STEPS
        print(f"{layout} rank {rank}: flag all-reduce per step on the CPU "
              f"(gloo, 2 ranks): median {statistics.median(agree):.6f} s, "
              f"max {max(agree):.6f} s over {len(agree)} steps")


# ---------------------------------------------------------------------------
# cli check and cli lint: exit codes and --json
# ---------------------------------------------------------------------------
def _write_journal(job_dir, records):
    os.makedirs(job_dir, exist_ok=True)
    with open(os.path.join(job_dir, constants.JOURNAL_FILE), "w",
              encoding="utf-8") as f:
        for rec in records:
            f.write(json.dumps(rec, sort_keys=True) + "\n")


def _base_journal(session=0):
    return [
        {"t": "gen", "generation": 1},
        {"t": "app", "app_id": "app-x", "started_ms": 1, "user": "t"},
        {"t": "epoch", "session": session, "infra_used": 0,
         "preempt_used": 0},
        {"t": "job_scheduled", "job": "worker", "session": session},
        {"t": "task", "task": "worker:0", "status": "SCHEDULED",
         "session": session},
        {"t": "register", "task": "worker:0", "host": "h", "port": 1,
         "session": session},
    ]


def test_cli_check_job_dir_and_json(tmp_path, capsys):
    job = tmp_path / "history" / "intermediate" / "app-x"
    _write_journal(str(job), _base_journal() + [
        {"t": "gen", "generation": 1},     # duplicate: violation
    ])
    rc = cli_main(["check", str(job), "--json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert out["ok"] is False
    assert out["violations"][0]["rule"] == "journal-gen-monotonic"

    rc = cli_main(["check", str(tmp_path / "nope" / "missing"),
                   "--history-root", str(tmp_path / "history")])
    assert rc == 2


def test_cli_check_resolves_app_id(tmp_path, capsys):
    from tony_tpu_torch.events import history

    hist = tmp_path / "history"
    _write_journal(str(hist / "intermediate" / "app-ok"), _base_journal())
    assert history.list_job_dirs(str(hist)).get("app-ok")
    rc = cli_main(["check", "app-ok", "--history-root", str(hist)])
    assert rc == 0
    assert "OK" in capsys.readouterr().out


def test_module_cli_tree_scan(tmp_path, capsys):
    _write_journal(str(tmp_path / "a"), _base_journal())
    _write_journal(str(tmp_path / "b"), [
        {"t": "gen", "generation": 2},
        {"t": "gen", "generation": 1},
    ])
    rc = invariants.main([str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 1
    assert "OK" in out and "journal-gen-monotonic" in out
    assert len(invariants.find_job_dirs(str(tmp_path))) == 2


def test_check_raises_on_a_fleet_artifact(tmp_path, capsys):
    """A tree that holds a fleet journal goes through the fleet rules of
    the port's fleet/: ``cli check`` passes a clean fleet dir and flags a
    broken one (the reference's golden and bad fixtures)."""
    fixtures = os.path.join(REPO, "tests", "fixtures")
    golden = os.path.join(fixtures, "golden_fleetdir")
    assert os.path.exists(os.path.join(golden, constants.FLEET_JOURNAL_FILE))
    assert cli_main(["check", golden]) == 0
    assert "OK" in capsys.readouterr().out
    assert cli_main(["check", os.path.join(fixtures, "fleetdir_bad")]) == 1
    assert "fleet-" in capsys.readouterr().out
    reports = invariants.check_tree(golden)
    assert reports and all(r.ok for r in reports)


def test_cli_lint_exit_codes_and_json(capsys, tmp_path):
    """``cli lint --json`` on the port's tree: exit 0 and no finding
    (every module is ported, tests/test_torch_lint.py pins it); on a tree
    with a finding, exit 1 with it machine-readable; one rule the tree
    keeps exits 0; ``--list`` 0."""
    rc = cli_main(["lint", "--json", "--root", REPO])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert out["findings"] == [] and isinstance(out["suppressed"], list)
    bad = tmp_path / "tony_tpu_torch"
    bad.mkdir()
    (bad / "snippet.py").write_text(
        "def f():\n    try:\n        pass\n    except:\n        pass\n")
    rc = cli_main(["lint", "--json", "--root", str(tmp_path), "--rule",
                   "bare-except"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert [(f["rule"], f["file"]) for f in out["findings"]] == [
        ("bare-except", os.path.join("tony_tpu_torch", "snippet.py"))]
    rc = cli_main(["lint", "--json", "--root", REPO, "--rule",
                   "durable-write"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["findings"] == []
    assert cli_main(["lint", "--list"]) == 0
    assert "durable-write" in capsys.readouterr().out
