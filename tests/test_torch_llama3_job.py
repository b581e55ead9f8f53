"""The Llama-3-8B example's job on the port's loop (``trainer.train`` and
``python -m tony_tpu_torch.trainer --model llama3_8b``), the counterpart of
``tests/test_examples.py:124-160`` (``examples/llama3-8b/train_llama3.py``
at its CI geometry).

- On four gloo ranks (one spawn, ``FileStore`` rendezvous) at ``(fsdp=2,
  tp=2)``: the example's tiny config (``TransformerConfig.tiny(n_layers=2,
  remat=True, remat_policy="dots_with_no_batch_dims_saveable")``), the
  chunked loss (chunk 16) and AdamW(3e-4, weight decay 0.1), 3 steps
  through ``train()`` from a token file; the losses within 1e-5
  (relative) of the reference's steps on the same rows, the example's
  ``_loss_on`` on its ``init_sharded_state`` over four virtual devices
  (``MeshSpec(dp=1, fsdp=-1, tp=2)``), and every parameter after them
  within 1e-5 (relative Frobenius). A run stopped after 2 steps with a
  checkpoint directory and resumed gives the uninterrupted run's losses
  bit for bit.
- A vocabulary past 65,536 ids: ``write_corpus`` writes uint32, the loop
  reads ids >= 65,536 as they are in the file, and a uint16 read raises.
- ``main(["--model", "llama3_8b", "--data", ...])`` on the CPU, its
  geometry cut through the Python API (``LM_POINTS``; one layer, dim 64,
  Llama-3's whole 128,256-id vocabulary): the example's weight decay,
  policy, chunked loss and uint32 ids in its JSON.
"""

import dataclasses
import json
import os
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tony_tpu import compat
from tony_tpu.models import transformer as jtf
from tony_tpu.parallel import MeshSpec, build_mesh, init_sharded_state
from tony_tpu.parallel.sharding import DEFAULT_RULES
from tony_tpu_torch import trainer
from tony_tpu_torch.convert import to_flax_params
from tony_tpu_torch.data import TokenFileDataset, token_file_batches
from tony_tpu_torch.models import transformer as ttf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POLICY = "dots_with_no_batch_dims_saveable"
BATCH, SEQ, STEPS, CHUNK = 4, 32, 3, 16
MESH = "dp=1,fsdp=2,tp=2"
RANK_TIMEOUT_S = 300


def _tiny(**kw):
    return dict(n_layers=2, remat=True, remat_policy=POLICY, **kw)


_RANK_SCRIPT = r"""
import os, sys
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
torch.set_num_threads(1)
from tony_tpu_torch import trainer
from tony_tpu_torch.models import transformer as ttf

rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group(
    "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
    rank=rank, world_size=world)
BATCH, SEQ, STEPS, CHUNK, MESH, KW = %(consts)r
cfg = ttf.TransformerConfig.tiny(**KW)
corpus = os.path.join(tmp, "corpus.bin")


def run(steps, ckpt=None):
    out = trainer.train(cfg, corpus, batch=BATCH, seq=SEQ, steps=steps,
                        ckpt_dir=ckpt, device="cpu", mesh=MESH, chunked=True,
                        loss_chunk=CHUNK,
                        weight_decay=trainer.LLAMA_WEIGHT_DECAY)
    res = {k: out[k] for k in ("losses", "start_step", "restored_step",
                               "loss_chunk", "weight_decay", "remat_policy",
                               "token_dtype", "mesh")}
    res["params"] = {
        k: (p.full_tensor() if isinstance(p, DTensor) else p).detach().clone()
        for k, p in out["state"].model.named_parameters()}
    return res


ckpt = os.path.join(tmp, "ckpt")
res = {"whole": run(STEPS), "first": run(STEPS - 1, ckpt),
       "resumed": run(STEPS, ckpt)}
torch.save(res, os.path.join(tmp, f"out{rank}.pt"))
dist.barrier()
dist.destroy_process_group()
"""


def _reference(params0, batches):
    """The example's step on the reference: its tiny config, the chunked
    ``_loss_on`` under ``DEFAULT_RULES``, ``optax.adamw(3e-4,
    weight_decay=0.1)``, ``init_sharded_state`` on four virtual devices."""
    cfg = jtf.TransformerConfig.tiny(**_tiny())
    model = jtf.Transformer(cfg)
    mesh = build_mesh(MeshSpec(dp=1, fsdp=-1, tp=2),
                      devices=jax.devices()[:4])
    tx = optax.adamw(trainer.LEARNING_RATE,
                     weight_decay=trainer.LLAMA_WEIGHT_DECAY)
    state, sh = init_sharded_state(model, jnp.asarray(batches[0]), tx, mesh)
    state = state.replace(params=jax.device_put(params0, sh.params))

    def loss(params, toks):
        with fnn.logical_axis_rules(list(DEFAULT_RULES)):
            h = model.apply({"params": params}, toks, return_hidden=True)
            return jtf.chunked_causal_lm_loss(
                h, params["lm_head"]["kernel"], toks, chunk_size=CHUNK,
                head_dtype=cfg.lm_head_dtype)

    @jax.jit
    def step(state, toks):
        value, grads = jax.value_and_grad(loss)(state.params, toks)
        return state.apply_gradients(grads=grads), value

    losses = []
    with compat.set_mesh(mesh):
        for b in batches:
            state, value = step(state, jnp.asarray(b))
            losses.append(float(value))
    return losses, jax.tree.map(np.asarray, state.params)


def test_example_job_on_four_ranks_matches_reference_and_resumes(tmp_path):
    cfg = ttf.TransformerConfig.tiny(**_tiny())
    corpus = trainer.write_corpus(str(tmp_path / "corpus.bin"),
                                  cfg.vocab_size)
    script = tmp_path / "rank.py"
    script.write_text(_RANK_SCRIPT % {
        "consts": (BATCH, SEQ, STEPS, CHUNK, MESH, _tiny())})
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), "4", str(tmp_path)], env=env,
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(4)]
    try:
        # The loop's initial state: the seeded model, the same values on a
        # mesh (init_sharded_state) as off it.
        model = trainer.build_state(cfg, "cpu", seed=0).model
        params0 = jax.tree.map(np.asarray, to_flax_params(
            {k: v.detach() for k, v in model.state_dict().items()}))
        ds = TokenFileDataset(corpus, SEQ, dtype=np.uint16, seed=0)
        batches = [ds.load_local(s, slice(0, BATCH))["tokens"]
                   for s in range(STEPS)]
        want, want_params = _reference(params0, batches)
        outs = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    runs = [torch.load(tmp_path / f"out{r}.pt") for r in range(4)]
    whole = runs[0]["whole"]
    assert whole["loss_chunk"] == CHUNK and whole["weight_decay"] == 0.1
    assert whole["remat_policy"] == POLICY
    assert whole["token_dtype"] == "uint16"
    assert whole["mesh"]["fsdp"] == 2 and whole["mesh"]["tp"] == 2
    for r in runs:
        assert r["whole"]["losses"] == whole["losses"]
    np.testing.assert_allclose(whole["losses"], want, rtol=1e-5, atol=0)
    # The parameters after 3 AdamW steps, each within 1e-5 relative
    # Frobenius error (Adam makes an elementwise tolerance meaningless);
    # the weight decay alone moves them by ~3e-5 a step.
    flat = jax.tree_util.tree_flatten_with_path(
        to_flax_params(whole["params"]))[0]
    jflat = dict(jax.tree_util.tree_flatten_with_path(want_params)[0])
    assert len(flat) == len(jflat)
    for path, v in flat:
        w = np.asarray(jflat[path], np.float64)
        rel = np.linalg.norm(np.asarray(v, np.float64) - w) / \
            np.linalg.norm(w)
        assert rel < 1e-5, (jax.tree_util.keystr(path), rel)
    # Stopped after step 1 and resumed: the same losses, bit for bit.
    for r in runs:
        assert r["first"]["losses"] == whole["losses"][:STEPS - 1]
        assert r["resumed"]["start_step"] == STEPS - 1
        assert r["resumed"]["restored_step"] == STEPS - 2
        assert r["resumed"]["losses"] == whole["losses"][STEPS - 1:]


def test_a_large_vocabulary_reads_uint32_ids(tmp_path):
    vocab = 70_000
    cfg = ttf.TransformerConfig.tiny(vocab_size=vocab, n_layers=1)
    path = trainer.write_corpus(str(tmp_path / "corpus.bin"), vocab)
    assert os.path.getsize(path) == 4 * trainer.CORPUS_TOKENS
    raw = np.fromfile(path, dtype=np.uint32)
    assert raw.max() >= 1 << 16 and raw.max() < vocab
    assert trainer.token_dtype(vocab) == np.uint32
    assert trainer.token_dtype(256) == np.uint16
    it = token_file_batches(path, 2, 16, dtype=trainer.token_dtype(vocab),
                            device="cpu", prefetch=0)
    try:
        got = next(it)["tokens"].numpy()
    finally:
        it.close()
    want = TokenFileDataset(path, 16, dtype=np.uint32).load_local(
        0, slice(0, 2))["tokens"]
    np.testing.assert_array_equal(got, want)
    starts = [np.flatnonzero(np.all(
        np.lib.stride_tricks.sliding_window_view(raw, 16) == row, axis=1))
        for row in got]
    assert all(len(s) == 1 for s in starts)         # windows of the file
    with pytest.raises(ValueError, match="uint32"):
        trainer.token_dtype(vocab, np.uint16)
    with pytest.raises(ValueError, match="uint32"):
        trainer.train(cfg, path, batch=2, seq=16, steps=1, device="cpu",
                      dtype=np.uint16)
    out = trainer.train(cfg, path, batch=2, seq=16, steps=1, device="cpu")
    assert out["token_dtype"] == "uint32"
    assert np.isfinite(out["losses"]).all()


def test_cli_runs_the_example_job(tmp_path, monkeypatch, capsys):
    """``--model llama3_8b --data``, the geometry cut through the API."""
    def cut(seq):
        return dataclasses.replace(trainer.llama3_8b_config(seq), n_layers=1,
                                   dim=64, n_heads=4, n_kv_heads=2,
                                   mlp_dim=128)
    point = trainer.LM_POINTS["llama3_8b"]
    monkeypatch.setitem(trainer.LM_POINTS, "llama3_8b", (cut,) + point[1:])
    monkeypatch.setitem(trainer.DEFAULT_BATCH, "llama3_8b", 2)
    vocab = trainer.llama3_8b_config().vocab_size
    corpus = trainer.write_corpus(str(tmp_path / "corpus.bin"), vocab)
    assert trainer.main(["--model", "llama3_8b", "--data", corpus,
                         "--device", "cpu", "--steps", "2", "--seq", "64",
                         "--loss-chunk", "16"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["loss_chunk"] == 16 and out["weight_decay"] == 0.1
    assert out["remat_policy"] == POLICY
    assert out["token_dtype"] == "uint32"
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    # The example's own point: 8 x 8192, the chunked loss in chunks of 2048
    # from 8192 on, AdamW's decay 0.1.
    assert point[1:] == (8192, 2048, None)
    assert trainer.DEFAULT_BATCH["llama3_8b"] == 2      # cut above
    assert trainer.LLAMA_BATCH == 8
    assert trainer.WEIGHT_DECAY["llama3_8b"] == 0.1
