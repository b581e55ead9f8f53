"""Port parity: the sharded training step of tony_tpu_torch on four gloo
ranks against the reference's ``init_sharded_state`` + ``jit_train_step``
on four of the virtual host devices, and against the port's one-rank run.

One spawn of four ranks (``FileStore`` rendezvous in ``tmp_path``, each
rank with its own 120 s timeout) runs every case, each from ``convert.py``'s
copy of the reference's flax parameters for the tiny f32 decoder:

- ``(dp=2, fsdp=2)``: HSDP, the gradient reduced over both; again with
  accumulation 2 (FSDP2 holds its reduction back to the last microbatch);
- ``(fsdp=2, tp=2)``: FSDP2 over the tensor-parallel plan (each rank holds
  two of the four heads); its optimizer is AdamW's foreach form, the one the
  card runs;
- ``(dcn_dp=2, tp=2)`` with accumulation 2 and the bucketed all-reduce over
  dcn_dp (1 MiB buckets), against ``jit_train_step_accum(...,
  sync_axes=("dcn_dp",))``;

then ``(fsdp=2, tp=2)`` once more with the chunked cross-entropy inside the
forward (the vocab-sharded head read there, whole) and AdamW's bf16 first
moment, against the port's one-rank run; then the tiny f32 ResNet at
``(dp=2, fsdp=2)`` with SGD(0.1, 0.9) (from
the port's seeded weights, carried to the flax tree by ``convert.py``), as
``examples/resnet/resnet_fsdp.py`` lays it out (the head's kernel sharded
over fsdp, the convolutions and norms replicated; the convfuse apply on its
path), then a DCP save at ``(fsdp=2, tp=2)`` restored at ``(dp=2, fsdp=2)``
(bitwise, the reshard reported) and the same state re-laid in memory
(``sharding.reshard``).

Tolerances: losses within 1e-5 relative; each gathered parameter after 3
AdamW steps within 1e-5 relative Frobenius error (per tensor: Adam's first
update is ±lr·sign(g), see ``tests/test_torch_grad_sync.py``). Attention is
the flash path on both sides: the reference's Pallas kernel in interpret
mode, the port's plain version of its CUDA kernels (CPU tensors), each rank
with its ``n_heads / tp`` local heads under tp.
"""

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

from tony_tpu.models import ResNet as JResNet
from tony_tpu.models import ResNetConfig as JResNetConfig
from tony_tpu.models import transformer as jtf
from tony_tpu.models.mlp import classification_loss as jclassification
from tony_tpu.parallel import (MeshSpec, build_mesh, init_sharded_state,
                               jit_train_step, jit_train_step_accum)
from tony_tpu_torch import trainer
from tony_tpu_torch.convert import (from_flax_params,
                                    from_flax_resnet_params, to_flax_params,
                                    to_flax_resnet_params)
from tony_tpu_torch.models import ResNet, ResNetConfig
from tony_tpu_torch.models import transformer as ttf
from tony_tpu_torch.parallel import train_step, train_step_accum

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GB, SEQ, LR, STEPS = 8, 16, 3e-4, 3
IMAGE, SGD_LR, MOMENTUM = 32, 0.1, 0.9
RTOL = 1e-5
torch.set_num_threads(2)
# name -> (mesh spec, accumulation)
CASES = {
    "dp2_fsdp2": (dict(dp=2, fsdp=2), 1),
    "dp2_fsdp2_accum2": (dict(dp=2, fsdp=2), 2),
    "fsdp2_tp2": (dict(fsdp=2, tp=2), 1),
    "dcn2_tp2_accum2": (dict(dcn_dp=2, tp=2), 2),
}

_RANK_SCRIPT = r"""
import os, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.checkpoint.state_dict import (StateDictOptions,
                                                     set_model_state_dict)
from torch.distributed.tensor import DTensor
torch.set_num_threads(1)
from tony_tpu_torch import trainer
from tony_tpu_torch.checkpoint import CheckpointManager
from tony_tpu_torch.data import process_batch_slice
from tony_tpu_torch.models import ResNet, ResNetConfig, classification_loss
from tony_tpu_torch.models import transformer as ttf
from tony_tpu_torch.parallel import (MeshSpec, adamw, batch_rank,
                                     build_mesh, checkpoint_tree,
                                     init_sharded_state,
                                     load_checkpoint_tree, reshard, sgd,
                                     sharded_train_step)

rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group(
    "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
    rank=rank, world_size=world)
cfg = ttf.TransformerConfig.tiny()
params0 = torch.load(os.path.join(tmp, "w.pt"))
tokens = np.load(os.path.join(tmp, "tokens.npy"))
CASES = %(cases)r
LR, STEPS, SGD_LR, MOMENTUM = %(lr)r, %(steps)r, %(sgd_lr)r, %(momentum)r


def lm_loss(m, batch):
    tok = batch["tokens"]
    return ttf.causal_lm_loss(m(tok), tok), {}


def whole(x):
    return (x.full_tensor() if isinstance(x, DTensor) else x).detach().clone()


def local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def build(mesh, seed, foreach=False):
    def opt(groups):
        if foreach:
            return torch.optim.AdamW(groups, lr=LR, weight_decay=1e-4,
                                     foreach=True)
        return adamw(groups, LR)
    state, placements = init_sharded_state(
        lambda d: ttf.Transformer(cfg, device=d), opt, mesh, seed=seed)
    return state, placements


out = {}
saved = None
for name, (spec, accum) in CASES.items():
    mesh = build_mesh(MeshSpec(**spec), "cpu")
    state, placements = build(mesh, 0, foreach=name == "fsdp2_tp2")
    # (set_model_state_dict replaces the values of the dict it is given)
    set_model_state_dict(state.model, dict(params0),
                         options=StateDictOptions(full_state_dict=True))
    rows = process_batch_slice(tokens.shape[1], mesh=mesh)
    seen = [None] * world
    dist.all_gather_object(seen, (batch_rank(mesh), rows.start, rows.stop,
                                  tuple(mesh.get_coordinate())))
    losses = []
    for s in range(STEPS):
        state, m = sharded_train_step(
            lm_loss, mesh, state,
            {"tokens": torch.from_numpy(tokens[s, rows]).long()},
            accum_steps=accum, bucket_mb=1)
        losses.append(m["loss"].item())
    out[name] = dict(
        losses=losses, rows=seen, step=state.step,
        local_shapes={k: tuple(local(p).shape)
                      for k, p in state.model.named_parameters()},
        planned={k: pl.local_shape for k, pl in placements.items()},
        params={k: whole(p) for k, p in state.model.named_parameters()})
    if name == "fsdp2_tp2":
        saved = (mesh, state)
        mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
        mgr.save(STEPS - 1, checkpoint_tree(state), force=True, mesh=mesh)
        mgr.close()
        out["saved_moments"] = {
            k: {n: whole(v) for n, v in st.items() if n != "step"}
            for k, st in checkpoint_tree(state)["optim"]["state"].items()}

# (fsdp=2, tp=2): the chunked loss in the forward, AdamW's bf16 moment.
mesh = build_mesh(MeshSpec(fsdp=2, tp=2), "cpu")
cstate = trainer.build_state(cfg, "cpu", chunked=True, loss_chunk=4,
                             mu_dtype=torch.bfloat16, mesh=mesh)
set_model_state_dict(cstate.model, dict(params0),
                     options=StateDictOptions(full_state_dict=True))
rows = process_batch_slice(tokens.shape[1], mesh=mesh)
losses = []
for s in range(STEPS):
    cstate, m = sharded_train_step(
        cstate.loss_fn, mesh, cstate,
        {"tokens": torch.from_numpy(tokens[s, rows]).long()})
    losses.append(m["loss"].item())
out["chunked_bf16_mu"] = dict(
    losses=losses,
    params={k: whole(p) for k, p in cstate.model.named_parameters()})

# The tiny ResNet at (dp=2, fsdp=2), SGD with momentum.
mesh = build_mesh(MeshSpec(dp=2, fsdp=2), "cpu")
rstate, rplaced = init_sharded_state(
    lambda d: ResNet(ResNetConfig.tiny(), device=d),
    lambda groups: sgd(groups, SGD_LR, momentum=MOMENTUM), mesh)
set_model_state_dict(rstate.model,
                     torch.load(os.path.join(tmp, "resnet_w.pt")),
                     options=StateDictOptions(full_state_dict=True))
images = np.load(os.path.join(tmp, "images.npy"))
labels = np.load(os.path.join(tmp, "labels.npy"))
rows = process_batch_slice(images.shape[1], mesh=mesh)


def vision_loss(m, batch):
    return classification_loss(m(batch["images"]), batch["labels"]), {}


losses = []
for s in range(STEPS):
    rstate, m = sharded_train_step(
        vision_loss, mesh, rstate,
        {"images": torch.from_numpy(images[s, rows]),
         "labels": torch.from_numpy(labels[s, rows]).long()})
    losses.append(m["loss"].item())
out["resnet_dp2_fsdp2"] = dict(
    losses=losses, step=rstate.step,
    local_shapes={k: tuple(local(p).shape)
                  for k, p in rstate.model.named_parameters()},
    planned={k: pl.local_shape for k, pl in rplaced.items()},
    params={k: whole(p) for k, p in rstate.model.named_parameters()})

# The (fsdp=2, tp=2) checkpoint restored onto (dp=2, fsdp=2).
mesh = build_mesh(MeshSpec(dp=2, fsdp=2), "cpu")
fresh, _ = build(mesh, 1)
mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
load_checkpoint_tree(fresh, mgr.restore(None, checkpoint_tree(fresh),
                                        mesh=mesh))
out["restored"] = dict(
    step=fresh.step, resharded=mgr.last_restore_resharded,
    noted=mgr.saved_mesh_shape(STEPS - 1),
    params={k: whole(p) for k, p in fresh.model.named_parameters()},
    moments={k: {n: whole(v) for n, v in st.items() if n != "step"}
             for k, st in checkpoint_tree(fresh)["optim"]["state"].items()},
    layout={k: str(getattr(p, "placements", None))
            for k, p in fresh.model.named_parameters()})
mgr.close()
# The same state re-laid in memory onto the (dp=2, fsdp=2) layout.
relaid = reshard(saved[1].model.state_dict(), fresh.model.state_dict())
out["relaid"] = {k: whole(v) for k, v in relaid.items()}
if rank == 0:
    torch.save(out, os.path.join(tmp, "out.pt"))
dist.barrier()
dist.destroy_process_group()
""" % {"cases": CASES, "lr": LR, "steps": STEPS, "sgd_lr": SGD_LR,
       "momentum": MOMENTUM}


def _spawn(tmp_path, world=4):
    script = tmp_path / "rank.py"
    script.write_text(_RANK_SCRIPT)
    env = dict(os.environ, PYTHONPATH=REPO)
    return [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), str(tmp_path)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]


def _wait(procs):
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=120)[0])
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


def _reference(params0, tokens, spec, accum):
    """The reference's sharded run: (losses, params, shard shapes)."""
    cfg = jtf.TransformerConfig.tiny()
    model = jtf.Transformer(cfg)
    n = int(np.prod(list(spec.values())))
    mesh = build_mesh(MeshSpec(**spec), devices=jax.devices()[:n])

    def loss_fn(params, batch, rng):
        toks = batch["tokens"]
        return jtf.causal_lm_loss(model.apply({"params": params}, toks),
                                  toks), {}

    first = {"tokens": jnp.asarray(tokens[0])}
    state, sh = init_sharded_state(model, first["tokens"], optax.adamw(LR),
                                   mesh)
    state = state.replace(params=jax.device_put(params0, sh.params))
    if accum > 1:
        step = jit_train_step_accum(loss_fn, mesh, sh, first,
                                    accum_steps=accum, bucket_mb=1,
                                    sync_axes=("dcn_dp",), donate=False)
    else:
        step = jit_train_step(loss_fn, mesh, sh, first, donate=False)
    losses = []
    for s in range(STEPS):
        state, m = step(state, {"tokens": jnp.asarray(tokens[s])},
                        jax.random.key(s))
        losses.append(float(m["loss"]))
    shapes = jax.tree.map(lambda x: x.sharding.shard_shape(x.shape),
                          state.params)
    return losses, jax.tree.map(np.asarray, state.params), shapes


def _one_rank(params0, tokens, accum, **kw):
    """The port's one-process run over the whole global batch (accumulation
    over as many microbatches as the sharded run has in all; ``kw``:
    ``trainer.build_state``'s loss and optimizer options)."""
    state = trainer.build_state(ttf.TransformerConfig.tiny(), "cpu", **kw)
    state.model.load_state_dict(from_flax_params(params0))
    losses = []
    for s in range(STEPS):
        batch = {"tokens": torch.from_numpy(tokens[s]).long()}
        m = (train_step_accum(state, batch, accum) if accum > 1
             else train_step(state, batch))
        losses.append(m["loss"].item())
    return losses, {k: v.detach().clone()
                    for k, v in state.model.state_dict().items()}


def _resnet_reference(params0, images, labels):
    """The reference's ResNet at (dp=2, fsdp=2): (losses, params, shard
    shapes)."""
    model = JResNet(JResNetConfig.tiny())
    mesh = build_mesh(MeshSpec(dp=2, fsdp=2), devices=jax.devices()[:4])

    def loss_fn(params, batch, rng):
        return jclassification(model.apply({"params": params}, batch["x"]),
                               batch["y"]), {}

    first = {"x": jnp.asarray(images[0]), "y": jnp.asarray(labels[0])}
    state, sh = init_sharded_state(model, first["x"],
                                   optax.sgd(SGD_LR, momentum=MOMENTUM),
                                   mesh)
    state = state.replace(params=jax.device_put(params0, sh.params))
    step = jit_train_step(loss_fn, mesh, sh, first, donate=False)
    losses = []
    for s in range(STEPS):
        state, m = step(state, {"x": jnp.asarray(images[s]),
                                "y": jnp.asarray(labels[s])},
                        jax.random.key(s))
        losses.append(float(m["loss"]))
    shapes = jax.tree.map(lambda x: x.sharding.shard_shape(x.shape),
                          state.params)
    return losses, jax.tree.map(np.asarray, state.params), shapes


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results, with the reference's and the one-rank
    runs computed in this process while the ranks train."""
    tmp = tmp_path_factory.mktemp("sharded")
    cfg = jtf.TransformerConfig.tiny()
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (STEPS, GB, SEQ)).astype(np.int32)
    params0 = jax.tree.map(np.asarray, fnn.meta.unbox(
        jtf.Transformer(cfg).init(jax.random.key(0),
                                  jnp.zeros((1, SEQ), jnp.int32))["params"]))
    torch.save(from_flax_params(params0), tmp / "w.pt")
    np.save(tmp / "tokens.npy", tokens)
    rng = np.random.default_rng(2)
    images = rng.standard_normal((STEPS, GB, IMAGE, IMAGE, 3),
                                 dtype=np.float32)
    labels = rng.integers(0, 10, (STEPS, GB)).astype(np.int32)
    # ResNet's weights: the port's seeded init carried to the flax tree
    # (a flax init of the ResNet costs seconds here).
    rcfg = ResNetConfig.tiny()
    rweights = ResNet(rcfg, device="cpu").state_dict()
    rparams0 = to_flax_resnet_params(rweights, rcfg)
    torch.save(from_flax_resnet_params(rparams0, rcfg), tmp / "resnet_w.pt")
    np.save(tmp / "images.npy", images)
    np.save(tmp / "labels.npy", labels)
    procs = _spawn(tmp)
    try:
        ref = {name: _reference(params0, tokens, spec, accum)
               for name, (spec, accum) in CASES.items()}
        ref["resnet_dp2_fsdp2"] = _resnet_reference(rparams0, images,
                                                    labels)
        one = {n: _one_rank(params0, tokens, n) for n in (1, 4, 8)}
        one["chunked_bf16_mu"] = _one_rank(
            params0, tokens, 1, chunked=True, loss_chunk=4,
            mu_dtype=torch.bfloat16)
    finally:
        _wait(procs)
    return torch.load(tmp / "out.pt"), ref, one


def _rel(have, want):
    want = np.asarray(want, np.float64)
    return np.linalg.norm(np.asarray(have, np.float64) - want) / \
        np.linalg.norm(want)


def _assert_close(state_dict, ref_params, to_flax=to_flax_params):
    got = to_flax(state_dict)
    for path, want in jax.tree_util.tree_leaves_with_path(ref_params):
        have = got
        for key in path:
            have = have[key.key]
        assert _rel(have, want) <= RTOL, jax.tree_util.keystr(path)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_reference(runs, name):
    out, ref, _ = runs
    losses, params, _ = ref[name]
    got = out[name]
    assert got["step"] == STEPS
    np.testing.assert_allclose(got["losses"], losses, rtol=RTOL)
    _assert_close(got["params"], params)


def test_sharded_resnet_matches_reference(runs):
    out, ref, _ = runs
    losses, params, shapes = ref["resnet_dp2_fsdp2"]
    got = out["resnet_dp2_fsdp2"]
    assert got["step"] == STEPS
    np.testing.assert_allclose(got["losses"], losses, rtol=RTOL)
    cfg = ResNetConfig.tiny()
    _assert_close(got["params"], params,
                  lambda sd: to_flax_resnet_params(sd, cfg))
    assert got["local_shapes"] == got["planned"]
    local = to_flax_resnet_params(
        {k: torch.empty(s) for k, s in got["local_shapes"].items()}, cfg)
    for path, want in jax.tree_util.tree_leaves_with_path(
            shapes, is_leaf=lambda x: isinstance(x, tuple)):
        have = local
        for key in path:
            have = have[key.key]
        assert tuple(have.shape) == tuple(want), jax.tree_util.keystr(path)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_one_rank(runs, name):
    out, _, one = runs
    spec, accum = CASES[name]
    # The batch coordinates times the accumulation: the microbatches of the
    # global batch.
    n = accum * (spec.get("dcn_dp", 1) * spec.get("dp", 1)
                 * spec.get("fsdp", 1)) if accum > 1 else 1
    losses, params = one[n]
    np.testing.assert_allclose(out[name]["losses"], losses, rtol=RTOL)
    for k, v in params.items():
        assert _rel(out[name]["params"][k], v) <= RTOL, k


@pytest.mark.parametrize("name", list(CASES))
def test_local_shard_shapes_match_reference(runs, name):
    out, ref, _ = runs
    got = out[name]
    assert got["local_shapes"] == got["planned"]
    shapes = to_flax_params({k: torch.empty(s) for k, s in
                             got["local_shapes"].items()})
    for path, want in jax.tree_util.tree_leaves_with_path(
            ref[name][2], is_leaf=lambda x: isinstance(x, tuple)):
        have = shapes
        for key in path:
            have = have[key.key]
        assert tuple(have.shape) == tuple(want), jax.tree_util.keystr(path)


def test_chunked_loss_and_bf16_moment_under_tp_match_one_rank(runs):
    out, _, one = runs
    losses, params = one["chunked_bf16_mu"]
    got = out["chunked_bf16_mu"]
    np.testing.assert_allclose(got["losses"], losses, rtol=RTOL)
    for k, v in params.items():
        assert _rel(got["params"][k], v) <= RTOL, k


def test_tp_peers_read_the_same_rows(runs):
    out, _, _ = runs
    for name, (spec, _) in CASES.items():
        rows = out[name]["rows"]       # per rank: (batch rank, start, stop,
        tp = spec.get("tp", 1)         # mesh coordinate)
        n = 4 // tp
        assert sorted({r[0] for r in rows}) == list(range(n))
        for batch_rank, start, stop, coord in rows:
            assert (start, stop) == (batch_rank * GB // n,
                                     (batch_rank + 1) * GB // n)
        for a in rows:
            for b in rows:
                if a[3][:-1] == b[3][:-1]:      # differ only in tp
                    assert a[:3] == b[:3], name


def test_checkpoint_restores_onto_another_mesh(runs):
    out, _, _ = runs
    saved = out["fsdp2_tp2"]
    r = out["restored"]
    assert r["step"] == STEPS
    for k, v in saved["params"].items():
        assert torch.equal(r["params"][k], v), k
        assert torch.equal(out["relaid"][k], v), k
    for k, moments in out["saved_moments"].items():
        for n, v in moments.items():
            assert torch.equal(r["moments"][k][n], v), (k, n)
    axes = ("dcn_dp", "dp", "fsdp", "pp", "ep", "sp", "tp")
    was = dict.fromkeys(axes, 1, ) | dict(fsdp=2, tp=2)
    now = dict.fromkeys(axes, 1) | dict(dp=2, fsdp=2)
    assert r["noted"] == was
    assert r["resharded"] == (was, now)
    # The restored state is laid out on the new mesh: HSDP over (dp, fsdp).
    assert "Replicate" in r["layout"]["layers.0.attn.wq.weight"]
