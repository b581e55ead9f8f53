"""A TERM that lands while the training loop's thread holds a lock.

``trainer.train`` with a ``ckpt_dir`` saves on SIGTERM. The save waits
for the checkpoint writer's thread, and takes telemetry's phase lock. Run
from the signal handler at the point where the TERM lands, it would wait
for a lock that the interrupted thread holds and will never release: the
import lock of ``torch.distributed.checkpoint``, which the first step's
save imports (the writer's ``import`` of it then waits for the main
thread, which waits for the writer), or telemetry's phase lock (the
handler's own thread holds it). Either way the process hangs until the
drain's grace runs out and it is killed unsaved. So the loop acts on a
TERM only at a step's boundary.

Here the tiny decoder trains on the CPU in a subprocess that sends itself
a TERM from inside each of those two locks. It must exit 143 within the
time limit, having saved the step the TERM landed in, equal bit for bit
to the same step of a run that no TERM interrupts.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from tony_tpu_torch.checkpoint import CheckpointManager
from tony_tpu_torch.models.transformer import TransformerConfig
from tony_tpu_torch.parallel.train import checkpoint_tree
from tony_tpu_torch import trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: The step in whose lock the "lock" mode's TERM lands; the job's steps.
TERM_AT, STEPS = 2, 6
#: Seconds a job may take; a hung one is killed then.
LIMIT_S = 90

# Mode "import": a TERM is sent from inside the import of
# torch.distributed.checkpoint, which the first step's save (step 0)
# imports first. Mode "lock": a TERM is sent from inside telemetry's phase
# lock at the end of step TERM_AT. Mode "plain": no TERM, TERM_AT + 1
# steps. Writes where the TERM was sent, then prints the trainer's result
# (a TERM exits 143 before that).
SCRIPT = r"""
import importlib.abc, json, os, signal, sys
import torch
from tony_tpu_torch import telemetry, trainer
from tony_tpu_torch.models.transformer import TransformerConfig

mode, corpus, ckpt, marker = sys.argv[1:5]
term_at, steps = int(sys.argv[5]), int(sys.argv[6])
torch.set_num_threads(1)
assert "torch.distributed.checkpoint" not in sys.modules


def term(where):
    with open(marker, "w") as f:
        json.dump({"where": where}, f)
    os.kill(os.getpid(), signal.SIGTERM)


class TermInImport(importlib.abc.MetaPathFinder):
    # Finds nothing: the TERM lands while the package's import (and its
    # module lock) is under way.
    def find_spec(self, name, path=None, target=None):
        if name == "torch.distributed.checkpoint.state_dict_saver":
            sys.meta_path.remove(self)
            term(name)
        return None


if mode == "import":
    sys.meta_path.insert(0, TermInImport())
elif mode == "lock":
    inner, done = telemetry.step_done, {"n": 0}

    def step_done(*args, **kwargs):
        inner(*args, **kwargs)
        if done["n"] == term_at:
            with telemetry._phase_lock:
                term("phase lock")
        done["n"] += 1

    telemetry.step_done = step_done
out = trainer.train(TransformerConfig.tiny(max_seq_len=32), corpus, batch=4,
                    seq=32, steps=steps, ckpt_dir=ckpt, save_interval=1000,
                    device="cpu", seed=0)
del out["state"]
print(json.dumps(out))
"""


def _job(tmp, mode, steps):
    """Runs the job; its exit code, stderr and checkpoint directory."""
    ckpt = tmp / mode
    proc = subprocess.Popen(
        [sys.executable, str(tmp / "job.py"), mode, str(tmp / "corpus.bin"),
         str(ckpt), str(tmp / f"{mode}.json"), str(TERM_AT), str(steps)],
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        _, err = proc.communicate(timeout=LIMIT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        _, err = proc.communicate()
        err = f"hung for {LIMIT_S} s: {err}"
    return proc.returncode, err, ckpt


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


@pytest.fixture(scope="module")
def plain(tmp_path_factory):
    """The job's script and corpus, and a run of TERM_AT + 1 steps that no
    TERM interrupts (it saves its first and last steps)."""
    tmp = tmp_path_factory.mktemp("locks")
    (tmp / "job.py").write_text(SCRIPT)
    trainer.write_corpus(str(tmp / "corpus.bin"),
                         TransformerConfig.tiny().vocab_size)
    rc, err, ckpt = _job(tmp, "plain", TERM_AT + 1)
    assert rc == 0, err[-4000:]
    return tmp, ckpt


@pytest.mark.parametrize("mode,step", [("import", 0), ("lock", TERM_AT)])
def test_term_inside_a_held_lock_saves_and_exits(plain, mode, step):
    tmp, whole = plain
    rc, err, ckpt = _job(tmp, mode, STEPS)
    # The TERM really landed inside the lock.
    assert json.loads((tmp / f"{mode}.json").read_text())["where"] == (
        "torch.distributed.checkpoint.state_dict_saver"
        if mode == "import" else "phase lock")
    assert rc == 143, err[-4000:]
    mgr = CheckpointManager(str(ckpt))
    try:
        # save_interval 1000: the first step's save, and the TERM's.
        assert mgr.all_steps() == sorted({0, step}), mgr.all_steps()
        assert mgr.verify_step(step)
    finally:
        mgr.close()
    _assert_bitwise(_tree(ckpt, step), _tree(whole, step))
