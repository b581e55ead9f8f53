"""Port parity: the GPipe schedule with ``sp`` or ``ep`` > 1 beside ``pp``
(``tony_tpu_torch/parallel/pipeline.py``'s ``pipeline_shard``), against the
reference's ``pipeline_loss`` on the conftest's eight virtual host devices.

The reference's ``shard_map`` names only pp and the batch axes, so the
ranks of an sp or ep axis are replicas: each computes its whole stage on
the same rows, and the step must not sum their gradients (the sequential
decoder's step sums over sp, where each rank's gradient is its sequence
chunk's share). One spawn of eight gloo ranks (``FileStore`` rendezvous in
``tmp_path``, each rank with its own timeout) trains the tiny 4-layer
decoder from the reference's ``init_pipeline_params`` (carried over by
``convert.py``) for 3 SGD(0.1, 0.9) steps at ``(dp=2, pp=2, sp=2)``,
``(dp=2, pp=2, ep=2)`` and ``(dp=2, pp=4)``: SGD, whose update scales with
the gradient, so that a gradient summed over the replicas shows (Adam's
would hide a factor of 2). Losses within 1e-5 relative and each gathered
parameter within 1e-5 relative Frobenius error of the reference's run on
the same mesh, and of the port's ``(dp=2, pp=4)`` run; the replicas of a
stage hold the same parameters bit for bit.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tony_tpu.models import transformer as jtf
from tony_tpu.parallel import MeshSpec, build_mesh
from tony_tpu.parallel import pipeline as jpp
from tony_tpu_torch.convert import (from_flax_pipeline_params,
                                    to_flax_pipeline_params)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, N_LAYERS, STEPS, M = 8, 4, 3, 2
GB, SEQ, LR, MOMENTUM, RTOL = 8, 16, 0.1, 0.9, 1e-5
RANK_TIMEOUT_S = 300
torch.set_num_threads(2)
# The reference compiles three pipelined steps while eight gloo ranks
# train.
pytestmark = pytest.mark.timeout_s(600)
CASES = {
    "dp2_pp2_sp2": dict(dp=2, pp=2, sp=2),
    "dp2_pp2_ep2": dict(dp=2, pp=2, ep=2),
    "dp2_pp4": dict(dp=2, pp=4),
}
REPLICAS = ("dp2_pp2_sp2", "dp2_pp2_ep2")

_RANK_SCRIPT = r"""
import os, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor
torch.set_num_threads(1)
from tony_tpu_torch.data import process_batch_slice
from tony_tpu_torch.models.transformer import TransformerConfig
from tony_tpu_torch.parallel import (MeshSpec, build_mesh,
                                     init_sharded_state, sgd)
from tony_tpu_torch.parallel.pipeline import (PipelineTransformer,
                                              pipeline_shard,
                                              pipeline_train_step)

rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group(
    "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
    rank=rank, world_size=world)
CASES, (N_LAYERS, STEPS, M, LR, MOMENTUM) = %(cases)r, %(consts)r
cfg = TransformerConfig.tiny(n_layers=N_LAYERS)
tokens = np.load(os.path.join(tmp, "tokens.npy"))


def whole(x):
    return (x.full_tensor() if isinstance(x, DTensor) else x).detach().clone()


out = {}
for name, spec in CASES.items():
    mesh = build_mesh(MeshSpec(**spec), "cpu")
    state, _ = init_sharded_state(
        lambda d: PipelineTransformer(cfg, d),
        lambda g: sgd(g, LR, momentum=MOMENTUM), mesh, layout=pipeline_shard)
    full = torch.load(os.path.join(tmp, "w.pt"))
    with torch.no_grad():
        for k, p in state.model.named_parameters():
            w = full[k]
            if isinstance(p, DTensor):
                w = distribute_tensor(w, p.device_mesh, p.placements,
                                      src_data_rank=None).to_local()
                p = p.to_local()
            p.copy_(w)
    rows = process_batch_slice(tokens.shape[1], mesh=mesh)
    losses = []
    for s in range(STEPS):
        state, m = pipeline_train_step(
            mesh, state, {"tokens": torch.from_numpy(tokens[s, rows]).long()},
            M)
        losses.append(m["loss"].item())
    out[name] = dict(
        losses=losses, step=state.step,
        coord={a: mesh.get_local_rank(a) for a in spec},
        params={k: whole(p) for k, p in state.model.named_parameters()})
    del state
torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
dist.barrier()
dist.destroy_process_group()
""" % {"cases": CASES, "consts": (N_LAYERS, STEPS, M, LR, MOMENTUM)}


def _spawn(tmp_path):
    script = tmp_path / "rank.py"
    script.write_text(_RANK_SCRIPT)
    env = dict(os.environ, PYTHONPATH=REPO)
    return [subprocess.Popen(
        [sys.executable, str(script), str(r), str(WORLD), str(tmp_path)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]


def _wait(procs):
    """Every rank's output; a rank still running after the timeout (a hang
    in a collective's backward) is killed and fails the fixture."""
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0] + "\n[timed out]")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]


def _reference(params, tokens, spec):
    """The reference's SGD steps of ``pipeline_loss`` on ``spec``: (losses,
    params)."""
    cfg = jtf.TransformerConfig.tiny(n_layers=N_LAYERS)
    mesh = build_mesh(MeshSpec(**spec))
    tx = optax.sgd(LR, momentum=MOMENTUM)

    @jax.jit
    def step(p, opt, t):
        loss, g = jax.value_and_grad(
            lambda p: jpp.pipeline_loss(cfg, mesh, p, t, M))(p)
        upd, opt = tx.update(g, opt, p)
        return optax.apply_updates(p, upd), opt, loss

    p, opt, losses = params, tx.init(params), []
    for s in range(STEPS):
        p, opt, loss = step(p, opt, jnp.asarray(tokens[s]))
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The eight ranks' results, with the reference's computed in this
    process while the ranks train."""
    tmp = tmp_path_factory.mktemp("pipeline_replicas")
    params = jax.tree.map(np.asarray, jpp.init_pipeline_params(
        jtf.TransformerConfig.tiny(n_layers=N_LAYERS), jax.random.key(0)))
    tokens = np.random.default_rng(1).integers(
        0, 256, (STEPS, GB, SEQ)).astype(np.int32)
    torch.save(from_flax_pipeline_params(params), tmp / "w.pt")
    np.save(tmp / "tokens.npy", tokens)
    procs = _spawn(tmp)
    try:
        ref = {name: _reference(params, tokens, spec)
               for name, spec in CASES.items()}
    finally:
        _wait(procs)
    return [torch.load(tmp / f"out{r}.pt") for r in range(WORLD)], ref


def _rel(have, want):
    want = np.asarray(want, np.float64)
    return np.linalg.norm(np.asarray(have, np.float64) - want) / \
        np.linalg.norm(want)


def _merged(outs, name):
    """Every parameter of the whole model, gathered, from the ranks that
    hold it (all of which must agree bit for bit: the dp and the replica
    ranks of a stage)."""
    merged = {}
    for o in outs:
        for k, v in o[name]["params"].items():
            if k in merged:
                assert torch.equal(merged[k], v), (name, k, o[name]["coord"])
            merged[k] = v
    return merged


def _close(got, want, what):
    flat = jax.tree_util.tree_leaves_with_path(want)
    for path, w in flat:
        have = got
        for key in path:
            have = have[key.key]
        assert _rel(have, w) <= RTOL, (what, jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_step_matches_reference(runs, name):
    out, ref = runs
    losses, params = ref[name]
    for o in out:
        assert o[name]["step"] == STEPS
        np.testing.assert_allclose(o[name]["losses"], losses, rtol=RTOL)
    merged = _merged(out, name)
    assert len(merged) == len(from_flax_pipeline_params(params))
    _close(to_flax_pipeline_params(merged), params, name)


@pytest.mark.parametrize("name", REPLICAS)
def test_replica_axes_train_as_the_deeper_pipeline(runs, name):
    """sp or ep as replicas of a 2-stage pipeline against the port's
    4-stage one on the same rows, and the reference's losses the same on
    all three meshes."""
    out, ref = runs
    for o in out:
        np.testing.assert_allclose(o[name]["losses"],
                                   o["dp2_pp4"]["losses"], rtol=RTOL)
    np.testing.assert_allclose(ref[name][0], ref["dp2_pp4"][0], rtol=RTOL)
    _close(to_flax_pipeline_params(_merged(out, name)),
           to_flax_pipeline_params(_merged(out, "dp2_pp4")), name)
