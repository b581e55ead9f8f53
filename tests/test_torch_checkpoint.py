"""Port parity: the checkpoint manager of tony_tpu_torch (on
torch.distributed.checkpoint) against the mesh-free cases of
tests/test_checkpoint.py — round trip, retention, the interval policy,
manifests and verified fallback (the same step as the orbax-backed
reference on the same scripted sequence), overlapped writes, both fault
sites, the preemption handler — and an interrupted and resumed CPU run of
trainer.train whose losses equal an uninterrupted run's exactly."""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tony_tpu_torch import faults, trainer
from tony_tpu_torch.checkpoint import CheckpointManager
from tony_tpu_torch.models.transformer import TransformerConfig
from tony_tpu_torch.parallel import checkpoint_tree, load_checkpoint_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)


def _tree(scale=1.0):
    return {"step": 7, "w": torch.arange(8.0) * scale,
            "nested": {"b": torch.linspace(-1, 1, 5) * scale,
                       "i": torch.arange(4, dtype=torch.int64)}}


def _zeros_like(tree):
    return {"step": 0, "w": torch.zeros(8),
            "nested": {"b": torch.zeros(5),
                       "i": torch.zeros(4, dtype=torch.int64)}}


def test_roundtrip_is_bitwise(tmp_path):
    tree = _tree(1.2345)
    with CheckpointManager(str(tmp_path / "c"), async_save=False) as mgr:
        assert mgr.latest_step() is None
        assert mgr.save(0, tree, force=True)
        like = _zeros_like(tree)
        restored = mgr.restore(0, like)
    assert restored is like and restored["step"] == 7
    assert torch.equal(restored["w"], tree["w"])
    assert torch.equal(restored["nested"]["b"], tree["nested"]["b"])
    assert torch.equal(restored["nested"]["i"], tree["nested"]["i"])


def test_train_state_roundtrip_params_and_moments_bitwise(tmp_path):
    cfg = TransformerConfig.tiny(max_seq_len=16)
    state = trainer.build_state(cfg, "cpu", seed=0)
    tok = torch.randint(0, cfg.vocab_size, (2, 16),
                        generator=torch.Generator().manual_seed(0))
    for _ in range(2):
        trainer.train_step(state, {"tokens": tok})
    with CheckpointManager(str(tmp_path / "c")) as mgr:
        mgr.save(1, checkpoint_tree(state))
    fresh = trainer.build_state(cfg, "cpu", seed=1)
    before = [p.detach().clone() for p in fresh.model.parameters()]
    tree = checkpoint_tree(fresh)
    # creating the fresh optimizer's moments moved no parameter
    assert all(torch.equal(a, p) for a, p in
               zip(before, fresh.model.parameters()))
    with CheckpointManager(str(tmp_path / "c")) as mgr:
        load_checkpoint_tree(fresh, mgr.restore(None, tree))
    assert fresh.step == state.step == 2
    for a, b in zip(state.model.parameters(), fresh.model.parameters()):
        assert torch.equal(a, b)
    sa, sb = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for k, moments in sa["state"].items():
        for name, v in moments.items():
            assert torch.equal(v, sb["state"][k][name]), (k, name)


def test_latest_step_and_retention(tmp_path):
    with CheckpointManager(str(tmp_path / "c"), max_to_keep=2,
                           async_save=False) as mgr:
        for s in (1, 2, 3):
            mgr.save(s, _tree(s), force=True)
        mgr.wait()
        assert mgr.latest_step() == 3
        restored = mgr.restore(None, _zeros_like(_tree()))
        assert torch.equal(restored["w"], torch.arange(8.0) * 3)
        assert mgr.all_steps() == [2, 3]      # step 1 was purged
        with pytest.raises(FileNotFoundError):
            mgr.restore(1, _zeros_like(_tree()))


def test_save_interval_policy(tmp_path):
    with CheckpointManager(str(tmp_path / "c"), save_interval_steps=5,
                           async_save=False) as mgr:
        assert mgr.save(0, _tree())
        assert not mgr.should_save(2)
        assert not mgr.save(2, _tree())      # skipped by policy
        assert mgr.save(5, _tree())
        assert mgr.save(7, _tree(), force=True)  # force overrides
        assert not mgr.save(7, _tree())      # not past the newest


def _ckpt_with_steps(root, steps=(1, 2, 3)):
    mgr = CheckpointManager(str(root), async_save=False, max_to_keep=10)
    for s in steps:
        mgr.save(s, {"w": torch.arange(8.0) * s}, force=True)
    mgr.wait()
    return mgr


def _corrupt_step(manifest_path, step_dir):
    """Truncate every file the step's manifest covers (a torn write)."""
    with open(manifest_path, encoding="utf-8") as f:
        manifest = json.load(f)
    assert manifest["files"], "manifest should list files"
    for rel in manifest["files"]:
        p = os.path.join(step_dir, rel.replace("/", os.sep))
        with open(p, "r+b") as f:
            f.truncate(os.path.getsize(p) // 2)


def test_manifest_written_and_steps_verify(tmp_path):
    mgr = _ckpt_with_steps(tmp_path / "c")
    try:
        for s in (1, 2, 3):
            assert os.path.exists(mgr.manifest_path(s))
            assert mgr.verify_step(s)
            assert mgr.saved_world_size(s) == 1
        assert mgr.latest_verified_step() == 3
        with open(mgr.manifest_path(3)) as f:
            files = json.load(f)["files"]
        assert mgr.step_bytes(3) == sum(m["size"] for m in files.values()) \
            + os.path.getsize(mgr.manifest_path(3))
    finally:
        mgr.close()


@pytest.mark.parametrize("corrupt", [3, 2])
def test_corrupt_step_fallback_matches_reference(tmp_path, corrupt):
    """THE integrity contract, scripted on both managers: steps 1-3, one
    truncated; restore(None) picks the newest verified step — the same step
    as the orbax-backed reference — and restores its values."""
    import jax.numpy as jnp

    from tony_tpu.checkpoint import CheckpointManager as RefManager

    ours = _ckpt_with_steps(tmp_path / "ours")
    ref = RefManager(str(tmp_path / "ref"), async_save=False, max_to_keep=10)
    try:
        for s in (1, 2, 3):
            ref.save(s, {"w": jnp.arange(8.0) * s}, force=True)
        ref.wait()
        _corrupt_step(ours.manifest_path(corrupt),
                      str(tmp_path / "ours" / str(corrupt)))
        _corrupt_step(ref.manifest_path(corrupt),
                      str(tmp_path / "ref" / str(corrupt)))
        assert not ours.verify_step(corrupt)
        picked = ours.latest_verified_step()
        assert picked == ref.latest_verified_step() == \
            (2 if corrupt == 3 else 3)
        got = ours.restore(None, {"w": torch.zeros(8)})
        want = ref.restore(None, {"w": jnp.zeros(8)})
        np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
        assert got["w"][1].item() == picked
    finally:
        ours.close()
        ref.close()


def test_explicitly_requested_corrupt_step_fails_loudly(tmp_path):
    mgr = _ckpt_with_steps(tmp_path / "c")
    try:
        _corrupt_step(mgr.manifest_path(2), str(tmp_path / "c" / "2"))
        with pytest.raises(IOError):
            mgr.restore(2, {"w": torch.zeros(8)})
        # and an explicit GOOD step still restores
        ok = mgr.restore(3, {"w": torch.zeros(8)})
        assert torch.equal(ok["w"], torch.arange(8.0) * 3)
    finally:
        mgr.close()


def test_missing_file_fails_verification(tmp_path):
    mgr = _ckpt_with_steps(tmp_path / "c", steps=(1, 2))
    try:
        with open(mgr.manifest_path(2), encoding="utf-8") as f:
            rel = sorted(json.load(f)["files"])[0]
        os.unlink(os.path.join(str(tmp_path / "c" / "2"),
                               rel.replace("/", os.sep)))
        assert not mgr.verify_step(2)
        assert mgr.latest_verified_step() == 1
    finally:
        mgr.close()


def test_async_saves_get_manifests_on_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "c"), async_save=True)
    try:
        mgr.save(1, {"w": torch.arange(4.0)}, force=True)
        mgr.wait()
        assert mgr.verify_step(1) and 1 in mgr.write_s
    finally:
        mgr.close()


def test_async_save_never_blocks_the_training_thread(tmp_path):
    """save() in overlapped mode pays only the snapshot: with the write
    slowed, the save call returns long before the write finishes; wait()
    is where the wall time goes. The snapshot is frozen: changing the
    live tensor after save() returns does not change the checkpoint."""
    mgr = CheckpointManager(str(tmp_path / "c"), async_save=True)
    real_write = mgr._write

    def slow_write(*a, **kw):
        time.sleep(0.5)
        return real_write(*a, **kw)

    mgr._write = slow_write
    live = {"w": torch.arange(64.0)}
    try:
        t0 = time.monotonic()
        assert mgr.save(1, live, force=True)
        enqueue_wall = time.monotonic() - t0
        assert enqueue_wall < 0.4, \
            f"overlapped save stalled the step for {enqueue_wall:.2f}s"
        live["w"].add_(1000.0)                # an in-place update
        mgr.wait()
        assert mgr.verify_step(1)
        assert not mgr.async_errors
        got = mgr.restore(1, {"w": torch.zeros(64)})
        assert torch.equal(got["w"], torch.arange(64.0))
    finally:
        mgr.close()


def test_async_double_save_coalesces_newest_wins(tmp_path):
    """With the writer wedged on step 1, steps 2 and 3 queue back to back:
    2 is superseded by 3 before it ever starts."""
    mgr = CheckpointManager(str(tmp_path / "c"), async_save=True)
    gate = threading.Event()
    real_write = mgr._write

    def gated_write(step, *a, **kw):
        if int(step) == 1:
            gate.wait(timeout=30)
        return real_write(step, *a, **kw)

    mgr._write = gated_write
    try:
        assert mgr.save(1, {"w": torch.zeros(4)}, force=True)
        deadline = time.monotonic() + 10
        while mgr._winflight != 1:      # writer picked step 1 up
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert mgr.save(2, {"w": torch.ones(4)}, force=True)
        assert mgr.save(3, {"w": torch.full((4,), 3.0)}, force=True)
        gate.set()
        mgr.wait()
        assert mgr.coalesced_saves == 1
        assert mgr.all_steps() == [1, 3]         # 2 was never written
        assert mgr.verify_step(1) and mgr.verify_step(3)
        restored = mgr.restore(None, {"w": torch.zeros(4)})
        assert torch.equal(restored["w"], torch.full((4,), 3.0))
    finally:
        gate.set()
        mgr.close()


def test_crash_mid_async_save_restores_newest_committed_step(tmp_path):
    """The ckpt.async-write fault kills the background write of step 2
    after step 1 committed: no step 2, the failure lands in async_errors
    instead of crashing training, and restore(None) comes back from 1."""
    mgr = CheckpointManager(str(tmp_path / "c"), async_save=True)
    try:
        assert mgr.save(1, {"w": torch.arange(4.0)}, force=True)
        mgr.wait()
        assert mgr.verify_step(1)
        faults.install(faults.FaultInjector({"ckpt.async-write":
                                             "first:1"}))
        assert mgr.save(2, {"w": torch.arange(4.0) * 2}, force=True)
        mgr.wait()
        assert mgr.async_errors and "step 2" in mgr.async_errors[0]
        assert not os.path.exists(mgr.manifest_path(2))
        assert mgr.latest_verified_step() == 1
        restored = mgr.restore(None, {"w": torch.zeros(4)})
        assert torch.equal(restored["w"], torch.arange(4.0))
    finally:
        faults.uninstall()
        mgr.close()


def test_partial_write_is_not_a_step(tmp_path):
    """A write killed inside DCP leaves only the partial directory, which
    is never listed, restored or counted by the interval policy."""
    mgr = CheckpointManager(str(tmp_path / "c"), async_save=False)
    try:
        mgr.save(1, {"w": torch.arange(4.0)}, force=True)
        os.makedirs(os.path.join(str(tmp_path / "c"), "2.partial"))
        assert mgr.all_steps() == [1] and mgr.latest_step() == 1
        assert mgr.save(2, {"w": torch.ones(4)})   # overwrites the partial
        assert mgr.all_steps() == [1, 2] and mgr.verify_step(2)
    finally:
        mgr.close()


def test_checkpoint_save_fault_site(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "c"), async_save=False)
    try:
        faults.install(faults.FaultInjector({"checkpoint.save": "at:2"}))
        assert mgr.save(1, {"w": torch.zeros(2)}, force=True)
        with pytest.raises(faults.InjectedFault):
            mgr.save(2, {"w": torch.zeros(2)}, force=True)
        assert mgr.save(3, {"w": torch.zeros(2)}, force=True)
    finally:
        faults.uninstall()
        mgr.close()


_PREEMPT_SCRIPT = r"""
import os, signal, sys, time
import torch
from tony_tpu_torch.checkpoint import CheckpointManager

mode, root = sys.argv[1], sys.argv[2]
mgr = CheckpointManager(root, async_save=False)
state = {"w": torch.arange(4.0)}
mgr.install_preemption_handler(lambda: (9, state), exit_code=143)
if mode == "defer":
    mgr._busy = True                     # simulate: inside mgr.save()
    os.kill(os.getpid(), signal.SIGTERM)
    time.sleep(0.2)                      # let the handler run
    assert mgr._preempt["deferred"] and not mgr._preempt["fired"]
    mgr._busy = False
    mgr.save(8, state, force=True)       # completes, then the final save
    sys.exit(3)                          # never reached
open(os.path.join(root, "ready"), "w").close()
time.sleep(60)
sys.exit(4)
"""


def _preempt_run(tmp_path, mode):
    script = tmp_path / "preempt.py"
    script.write_text(_PREEMPT_SCRIPT)
    root = tmp_path / "c"
    root.mkdir()
    return subprocess.Popen([sys.executable, str(script), mode, str(root)],
                            env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), root


def test_preemption_handler_saves_on_sigterm(tmp_path):
    import signal

    proc, root = _preempt_run(tmp_path, "plain")
    try:
        deadline = time.monotonic() + 90
        while not (root / "ready").exists():
            assert proc.poll() is None, proc.communicate()[0]
            assert time.monotonic() < deadline, "never became ready"
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=60)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    assert proc.returncode == 143, out
    mgr = CheckpointManager(str(root))
    try:
        assert mgr.all_steps() == [9] and mgr.verify_step(9)
    finally:
        mgr.close()


def test_preemption_handler_defers_while_save_in_flight(tmp_path):
    """TERM landing while the main thread is INSIDE a save must not
    re-enter the save: the handler defers, and the final save runs the
    moment the periodic call completes."""
    proc, root = _preempt_run(tmp_path, "defer")
    try:
        out = proc.communicate(timeout=90)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    assert proc.returncode == 143, out
    mgr = CheckpointManager(str(root))
    try:
        assert mgr.all_steps() == [8, 9]       # both saves durable
        assert mgr.verify_step(8) and mgr.verify_step(9)
    finally:
        mgr.close()


def test_interrupted_and_resumed_run_equals_uninterrupted(tmp_path):
    """trainer.train on the tiny f32 decoder: 6 steps with checkpoints
    (every 2, the last forced), then a fresh process state resumes from the
    newest verified one (step 5) and runs steps 6-7. Its losses, and its
    final parameters, are IDENTICAL to an uninterrupted 8-step run's."""
    cfg = TransformerConfig.tiny(max_seq_len=32)
    corpus = trainer.write_corpus(str(tmp_path / "corpus.bin"),
                                  cfg.vocab_size)
    kw = dict(batch=4, seq=32, device="cpu", seed=0)
    full = trainer.train(cfg, corpus, steps=8, **kw)
    ckpt = str(tmp_path / "ckpt")
    first = trainer.train(cfg, corpus, steps=6, ckpt_dir=ckpt,
                          save_interval=2, max_to_keep=2, **kw)
    assert first["async_errors"] == [] and first["start_step"] == 0
    assert first["losses"] == full["losses"][:6]
    assert first["latest_step"] == 5 and sorted(first["write_s"]) != []
    resumed = trainer.train(cfg, corpus, steps=8, ckpt_dir=ckpt,
                            save_interval=2, max_to_keep=2, **kw)
    assert resumed["start_step"] == 6 and resumed["restored_step"] == 5
    assert resumed["losses"] == full["losses"][6:]
    assert resumed["state"].step == full["state"].step == 8
    for a, b in zip(full["state"].model.parameters(),
                    resumed["state"].model.parameters()):
        assert torch.equal(a, b)


def test_train_with_accumulation_on_cpu(tmp_path):
    cfg = TransformerConfig.tiny(max_seq_len=32)
    corpus = trainer.write_corpus(str(tmp_path / "corpus.bin"),
                                  cfg.vocab_size)
    one = trainer.train(cfg, corpus, batch=4, seq=32, steps=3,
                        device="cpu")
    two = trainer.train(cfg, corpus, batch=4, seq=32, steps=3,
                        accum_steps=2, bucket_mb=1, device="cpu")
    assert two["accum_steps"] == 2 and two["world"] == 1
    assert "save_stall_s" not in two
    # the mean of two microbatch means is the batch mean (f32 rounding)
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5)


def test_cli_data_trains_the_flagship_only(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        trainer.main(["--model", "mnist", "--data", str(tmp_path / "c.bin"),
                      "--device", "cpu"])
    assert e.value.code == 2
    assert "--data trains a decoder" in capsys.readouterr().err
