"""Port parity: the layouts the reference trains that the port once refused
(``tony_tpu_torch/parallel/sharding.py``: ``attention_split``,
``KvGathered``, ``fsdp2_refusal``, ``hold_gathered``; the attention's
``_kv_read``) against the reference, which takes the same table in
``init_sharded_state`` and ``jit_train_step`` and lets GSPMD lay the models
out.

- tp wider than the kv heads: the tiny decoder (4 heads, 2 kv heads) and
  the tiny MoE at ``tp=4``, an MQA decoder (4 heads, 1 kv head) at
  ``(fsdp=2, tp=2)``: q on each rank's heads, k and v gathered, their
  gradient summed over tp;
- what FSDP2 cannot hold: two dims of one tensor (``("mlp", "sp"),
  ("embed", "fsdp")``, dense and MoE) and a dim flattened out of the mesh's
  order (``("embed", ("sp", "fsdp"))``) at ``(fsdp=2, sp=2)`` with ring
  attention; the MoE under ``random21`` at ``(fsdp=2, tp=2)`` (its experts
  on two dims); the experts' expert dim over ``("tp", "ep")`` at ``(ep=2,
  tp=2)``; T4's head, ``("embed", ("fsdp", "tp"))``, at ``(fsdp=2,
  tp=2)``.

One spawn of four gloo ranks (``FileStore`` rendezvous in ``tmp_path``,
each rank with its own timeout), the reference's runs computed in this
process on four virtual host devices meanwhile, from one set of weights
(the reference's init), SGD with momentum (a gradient's scale shows in the
step, where Adam's update would hide it). Per case: every gradient of the
first batch (after the train step's reductions) within 1e-5 relative
Frobenius error of the reference's ``jax.grad`` under the same table and
mesh (the MoE on sp: its ``shard_map``'d apply, ``_sp_moe_run``); the losses of 3 steps within 1e-5 relative and each gathered
parameter after each step within 1e-5; every local shard of the
reference's ``shard_shape``, and each rank's step-0 shard equal to the
reference's ``addressable_shards`` entry of the device at the same mesh
coordinate.

And in this process: the flagship's attention (8 heads, 4 kv heads) as
each of tp = 8's ranks runs it (``Attention._kv_read`` on eight fake ranks,
one at a time): its q head against the kv head it reads, forward and
backward, against the slices of the unsharded attention.
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
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from test_torch_moe_layouts import _sp_model
from test_torch_rules import (ALL_TABLES, DEFAULT, REPO, T4, TABLE_IDS,
                              _converters, _jmodel, _leaves, _rel, _wait)
from tony_tpu import compat
from tony_tpu.models import moe as jmoe
from tony_tpu.models import transformer as jtf
from tony_tpu.parallel import (MeshSpec, build_mesh, init_sharded_state,
                               jit_train_step)
from tony_tpu.parallel.mesh import tree_batch_shardings
from tony_tpu_torch.models import transformer as ttf
from tony_tpu_torch.ops.attention import flash_attention
from tony_tpu_torch.parallel import mesh as tmesh

GB, SEQ, STEPS, RTOL = 8, 16, 3, 1e-5
SGD_LR, MOMENTUM = 0.1, 0.9
torch.set_num_threads(2)
pytestmark = pytest.mark.timeout_s(900)

TABLES = {
    "default": DEFAULT, "T4": T4,
    "two_dims": (("mlp", "sp"), ("embed", "fsdp")) + DEFAULT,
    "out_of_order": (("embed", ("sp", "fsdp")),) + DEFAULT,
    "random21": ALL_TABLES[TABLE_IDS.index("random21")],
    "expert_tp_ep": (("expert", ("tp", "ep")),) + DEFAULT,
}
RING = dict(attn_impl="ring")
TP4, FT, FS, ET = dict(tp=4), dict(fsdp=2, tp=2), dict(fsdp=2, sp=2), \
    dict(ep=2, tp=2)
# name -> (model kind, mesh spec, config keywords, table)
CASES = {
    "dense_tp4": ("dense", TP4, {}, "default"),
    "mqa_fsdp_tp": ("dense", FT, dict(n_heads=4, n_kv_heads=1), "default"),
    "moe_tp4": ("moe", TP4, {}, "default"),
    "dense_two_dims": ("dense", FS, RING, "two_dims"),
    "dense_out_of_order": ("dense", FS, RING, "out_of_order"),
    "moe_two_dims": ("moe", FS, RING, "two_dims"),
    "moe_random21": ("moe", FT, {}, "random21"),
    "moe_expert_tp_ep": ("moe", ET, {}, "expert_tp_ep"),
    "dense_T4": ("dense", FT, {}, "T4"),
}
# What each case lays where the port once refused it, read off rank 0's
# parameters: (parameter, the mesh dims it is held on, in the mesh's order;
# None: not gathered).
HELD = {
    "dense_tp4": ("layers.0.attn.wk.weight", None),
    "mqa_fsdp_tp": ("layers.0.attn.wk.weight", None),
    "moe_tp4": ("layers.0.attn.wv.weight", None),
    "dense_two_dims": ("layers.0.mlp.gate.weight", ("fsdp", "sp")),
    "dense_out_of_order": ("layers.0.attn.wq.weight", ("fsdp", "sp", "tp")),
    "moe_two_dims": ("layers.0.moe.gate", ("fsdp", "ep", "sp")),
    # Its axes off the plan's have one rank each: FSDP2 holds it, and the
    # router beside the experts is an FSDP2 unit on its own mesh.
    "moe_random21": ("layers.0.moe.down", None),
    "moe_expert_tp_ep": ("layers.0.moe.gate", ("fsdp", "ep", "tp")),
    "dense_T4": ("lm_head.weight", ("fsdp", "tp")),
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
from tony_tpu_torch.data import process_batch_slice
from tony_tpu_torch.models import moe as tmoe
from tony_tpu_torch.models import transformer as ttf
from tony_tpu_torch.parallel import (MeshSpec, build_mesh, grad_sync,
                                     init_sharded_state, sgd,
                                     sharded_train_step)

rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group(
    "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
    rank=rank, world_size=world)
CASES, TABLES = %(cases)r, %(tables)r
SGD_LR, MOMENTUM, STEPS = %(consts)r


def whole(x):
    return (x.full_tensor() if isinstance(x, DTensor) else x).detach().clone()


def local(x):
    return (x.to_local() if isinstance(x, DTensor) else x).detach().clone()


def setup(kind, kw):
    # (build(device), loss_fn(model, batch))
    if kind == "dense":
        cfg = ttf.TransformerConfig.tiny(**kw)
        return (lambda d: ttf.Transformer(cfg, device=d),
                lambda m, b: (ttf.causal_lm_loss(m(b["tokens"]),
                                                 b["tokens"]), {}))
    cfg = tmoe.MoEConfig.tiny_moe(**kw)
    return (lambda d: tmoe.MoETransformer(cfg, device=d),
            lambda m, b: (tmoe.moe_lm_loss(m(b["tokens"]), b["tokens"],
                                           cfg.aux_loss_weight), {}))


def first_grads(state, mesh, loss_fn, batch):
    # The first batch's gradients after the train step's reductions.
    state.loss_fn = loss_fn
    grads, _, _ = grad_sync.accumulate_grads(state, batch, 1)
    grad_sync._mesh_sync(grads, grad_sync.DEFAULT_BUCKET_MB, mesh,
                         state.model.sp_group is not None,
                         state.model.reduced_by_fsdp)
    out = {k: whole(g) for k, g in grads.items()}
    state.optimizer.zero_grad(set_to_none=True)
    return out


out = {}
for name, (kind, spec, kw, table) in CASES.items():
    build, loss_fn = setup(kind, kw)
    mesh = build_mesh(MeshSpec(**spec), "cpu")
    state, placements = init_sharded_state(
        build, lambda g: sgd(g, SGD_LR, momentum=MOMENTUM), mesh,
        rules=TABLES[table])
    set_model_state_dict(
        state.model, torch.load(os.path.join(tmp, f"{name}_w.pt")),
        options=StateDictOptions(full_state_dict=True))
    case = dict(shards0={k: local(p)
                         for k, p in state.model.named_parameters()})
    data = np.load(os.path.join(tmp, f"{name}_data.npy"))
    rows = process_batch_slice(data.shape[1], mesh=mesh)

    def batch(s):
        return {"tokens": torch.from_numpy(data[s, rows]).long()}
    case["grads"] = first_grads(state, mesh, loss_fn, batch(0))
    losses, params = [], []
    for s in range(STEPS):
        state, m = sharded_train_step(loss_fn, mesh, state, batch(s))
        losses.append(m["loss"].item())
        params.append({k: whole(p) for k, p in state.model.named_parameters()})
    case.update(
        losses=losses, step=state.step,
        params=params if rank == 0 else params[-1:],
        meshes={k: getattr(p, "device_mesh", None) and
                p.device_mesh.mesh_dim_names
                for k, p in state.model.named_parameters()},
        gathered={k for k, p in state.model.named_parameters()
                  if k.rpartition(".")[2] in getattr(
                      state.model.get_submodule(k.rpartition(".")[0]),
                      "_gathered", {})},
        local_shapes={k: tuple(local(p).shape)
                      for k, p in state.model.named_parameters()},
        planned={k: pl.local_shape for k, pl in placements.items()})
    out[name] = case
    del state
torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
dist.barrier()
dist.destroy_process_group()
""" % {"cases": CASES, "tables": TABLES,
       "consts": (SGD_LR, MOMENTUM, STEPS)}


def _spawn(tmp_path, world=4):
    script = tmp_path / "rank.py"
    script.write_text(_RANK_SCRIPT)
    env = dict(os.environ, PYTHONPATH=REPO)
    return [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), str(tmp_path)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]


def _case_inputs(name, seed):
    """(the reference's initial params, [STEPS, GB, SEQ] tokens)."""
    kind, _, kw, _ = CASES[name]
    tokens = np.random.default_rng(seed).integers(
        0, 256, (STEPS, GB, SEQ)).astype(np.int32)
    with fnn.logical_axis_rules(list(DEFAULT)):
        params = _jmodel(kind, kw).init(jax.random.key(0),
                                        jnp.asarray(tokens[0]))
    return jax.tree.map(np.asarray, fnn.meta.unbox(params)["params"]), tokens


def _reference(name, params0, tokens):
    """The reference's run under the case's table: (first grads, losses,
    params after each step, shard shapes, {leaf path: {device id: step-0
    shard}}, device ids in mesh order)."""
    kind, spec, kw, table = CASES[name]
    rules = TABLES[table]
    model = _jmodel(kind, kw)
    n = int(np.prod(list(spec.values())))
    mesh = build_mesh(MeshSpec(**spec), devices=jax.devices()[:n])

    def loss_fn(params, batch, rng):
        out = model.apply({"params": params}, batch["tokens"])
        if kind == "dense":
            return jtf.causal_lm_loss(out, batch["tokens"]), {}
        return jmoe.moe_lm_loss(out, batch["tokens"],
                                model.cfg.aux_loss_weight), {}

    tx = optax.sgd(SGD_LR, momentum=MOMENTUM)
    first = {"tokens": jnp.asarray(tokens[0])}
    state, sh = init_sharded_state(model, first["tokens"], tx, mesh,
                                   rules=rules)
    state = state.replace(params=jax.device_put(params0, sh.params))
    shapes = jax.tree.map(lambda x: x.sharding.shard_shape(x.shape),
                          state.params)
    shards = {jax.tree_util.keystr(path): {
        s.device.id: np.asarray(s.data) for s in x.addressable_shards}
        for path, x in jax.tree_util.tree_leaves_with_path(state.params)}
    order = [d.id for d in mesh.devices.flat]
    if kind == "moe" and spec.get("sp", 1) > 1:
        return (*_sp_moe_run(params0, tokens, spec, kw), shapes, shards,
                order)
    with compat.set_mesh(mesh), fnn.logical_axis_rules(list(rules)):
        grads = jax.jit(jax.grad(lambda p, b: loss_fn(p, b, None)[0]))(
            state.params, jax.device_put(
                first, tree_batch_shardings(mesh, first)))
    grads = jax.tree.map(np.asarray, grads)
    step = jit_train_step(loss_fn, mesh, sh, first, rules=rules,
                          donate=False)
    losses, params = [], []
    with compat.set_mesh(mesh):
        for s in range(STEPS):
            state, m = step(state, {"tokens": jnp.asarray(tokens[s])},
                            jax.random.key(s))
            losses.append(float(m["loss"]))
            params.append(jax.tree.map(np.asarray, state.params))
    return grads, losses, params, shapes, shards, order


def _sp_moe_run(params0, tokens, spec, kw):
    """The MoE decoder's run on an sp mesh: (first grads, losses, params
    after each step). The reference's sequence-parallel MoE is its
    ``shard_map``'d apply, each (batch, sp) shard routing its own tokens
    (``tests/test_torch_moe_layouts.py``'s ``_sp_model``, whose
    convention the port follows): a jit of the plain apply would route the
    global batch as one group. The table lays out the parameters; the
    numbers do not depend on it."""
    cfg, fwd = _sp_model(spec, kw)

    def loss(p, t):
        logits, auxes = fwd(p, t)
        return jmoe.moe_lm_loss((logits, jnp.mean(auxes)), t,
                                cfg.aux_loss_weight)

    tx = optax.sgd(SGD_LR, momentum=MOMENTUM)

    @jax.jit
    def step(p, opt, t):
        value, g = jax.value_and_grad(loss)(p, t)
        upd, opt = tx.update(g, opt, p)
        return optax.apply_updates(p, upd), opt, value, g

    p, opt, losses, params = params0, tx.init(params0), [], []
    for s in range(STEPS):
        p, opt, value, g = step(p, opt, jnp.asarray(tokens[s]))
        grads = grads if s else jax.tree.map(np.asarray, g)
        losses.append(float(value))
        params.append(jax.tree.map(np.asarray, p))
    return grads, losses, params


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results, with the reference's runs computed in this
    process while the ranks train."""
    tmp = tmp_path_factory.mktemp("last_layouts")
    inputs = {}
    for i, name in enumerate(CASES):
        params, tokens = inputs[name] = _case_inputs(name, i)
        kind, _, kw, _ = CASES[name]
        torch.save(_converters(kind, kw)[0](params), tmp / f"{name}_w.pt")
        np.save(tmp / f"{name}_data.npy", tokens)
    procs = _spawn(tmp)
    try:
        ref = {name: _reference(name, *inputs[name]) for name in CASES}
    finally:
        _wait(procs)
    return [torch.load(tmp / f"out{r}.pt") for r in range(4)], ref


@pytest.mark.parametrize("name", list(CASES))
def test_first_gradients_match_reference(runs, name):
    """Every gradient of the first batch (wk's and wv's among them, which
    every tp rank reads with its own q heads where tp is wider than the kv
    heads) against the reference's under the same table and mesh."""
    out, ref = runs
    kind, _, kw, _ = CASES[name]
    to_flax = _converters(kind, kw)[1]
    for o in out:
        got = to_flax(o[name]["grads"])
        for path, have, want in _leaves(got, ref[name][0]):
            assert _rel(have, want) <= RTOL, (name, path, _rel(have, want))


@pytest.mark.parametrize("name", list(CASES))
def test_last_layouts_step_matches_reference(runs, name):
    """Losses over the 3 steps, and each gathered parameter after each
    step, against the reference under the same table; every rank ends
    with the same parameters."""
    out, ref = runs
    losses, params = ref[name][1:3]
    kind, _, kw, _ = CASES[name]
    to_flax = _converters(kind, kw)[1]
    for o in out:
        assert o[name]["step"] == STEPS
        np.testing.assert_allclose(o[name]["losses"], losses, rtol=RTOL)
    for s in range(STEPS):
        got = to_flax(out[0][name]["params"][s])
        for path, have, want in _leaves(got, params[s]):
            assert _rel(have, want) <= RTOL, (name, s, path)
    for o in out[1:]:
        for k, v in o[name]["params"][-1].items():
            assert torch.equal(v, out[0][name]["params"][-1][k]), (name, k)


@pytest.mark.parametrize("name", list(CASES))
def test_last_layouts_shards_are_the_references(runs, name):
    """Every local shard's shape is the reference's ``shard_shape``, and
    each rank's step-0 shard holds what the reference's device at the same
    mesh coordinate holds (T4's head fsdp-major, the expert dim over
    ``("tp", "ep")`` tp-major); the parameter each case once had refused
    is held as ``HELD`` says."""
    out, ref = runs
    shapes, shards, order = ref[name][3:]
    kind, _, kw, _ = CASES[name]
    to_flax = _converters(kind, kw)[1]
    for rank, o in enumerate(out):
        got = o[name]
        assert got["local_shapes"] == got["planned"]
        local = to_flax(got["shards0"])
        for path, have, want in _leaves(local, shapes):
            assert tuple(have.shape) == tuple(want), (name, path)
            np.testing.assert_array_equal(
                np.asarray(have), shards[path][order[rank]],
                err_msg=f"{name} rank {rank} {path}")
    param, held = HELD[name]
    assert (param in out[0][name]["gathered"]) == (held is not None), name
    if held is not None:
        assert out[0][name]["meshes"][param] == held, name


def test_flagship_attention_at_tp8_is_the_unsharded_slices():
    """The flagship's attention geometry (8 heads, 4 kv heads) at a small
    width, as each rank of tp = 8 runs it: ``Attention._kv_read`` on rank r
    of eight fake ranks gives q head r the kv head r // 2 of k and v
    gathered whole; its output and dq are the unsharded attention's slices
    for head r, and dk/dv summed over the eight ranks are the unsharded
    ones."""
    cfg = ttf.TransformerConfig.tiny(dim=8 * 16, n_heads=8, n_kv_heads=4)
    rng = np.random.default_rng(0)
    b, s, hd = 2, 32, cfg.dim // cfg.n_heads
    q0, k0, v0, do = (torch.from_numpy(rng.standard_normal(
        (b, s, h, hd), dtype=np.float32)) for h in (8, 4, 4, 8))

    q, k, v = (t.clone().requires_grad_() for t in (q0, k0, v0))
    o = flash_attention(q, k, v, causal=True)
    o.backward(do)
    o, dq, dk, dv = o.detach(), q.grad, k.grad, v.grad
    sum_dk, sum_dv = torch.zeros_like(dk), torch.zeros_like(dv)
    for r in range(8):
        dist.init_process_group("fake", store=FakeStore(), rank=r,
                                world_size=8)
        try:
            mesh = tmesh.build_mesh(tmesh.MeshSpec(tp=8, dp=1), "cpu")
            attn = ttf.Attention(cfg, torch.device("meta"))
            attn.tp_group = mesh["tp"].get_group()
            k, v = k0.clone().requires_grad_(), v0.clone().requires_grad_()
            ks, vs = attn._kv_read(k, v, 1)
            assert ks.shape[2] == 1
            assert torch.equal(ks[:, :, 0], k0[:, :, r // 2])
            do_r = do[:, :, r:r + 1]
            q = q0[:, :, r:r + 1].clone().requires_grad_()
            o_r = flash_attention(q, ks, vs, causal=True)
            o_r.backward(do_r)
        finally:
            dist.destroy_process_group()
        torch.testing.assert_close(o_r.detach(), o[:, :, r:r + 1],
                                   rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(q.grad, dq[:, :, r:r + 1], rtol=1e-5,
                                   atol=1e-6)
        sum_dk += k.grad
        sum_dv += v.grad
    torch.testing.assert_close(sum_dk, dk, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(sum_dv, dv, rtol=1e-5, atol=1e-6)
