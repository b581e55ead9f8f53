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
from torch_layout_cases import (CASES, GB, HELD, MOMENTUM, SEQ, SGD_LR,
                                STEPS, TABLES)
from tony_tpu import compat
from tony_tpu.models import moe as jmoe
from tony_tpu.models import transformer as jtf
from tony_tpu.parallel import (MeshSpec, build_mesh, init_sharded_state,
                               jit_train_step)
from tony_tpu.parallel.mesh import tree_batch_shardings
from tony_tpu_torch.models import transformer as ttf
from tony_tpu_torch.ops.attention import flash_attention
from tony_tpu_torch.parallel import mesh as tmesh

RTOL = 1e-5
torch.set_num_threads(2)
pytestmark = pytest.mark.timeout_s(900)
TESTS = os.path.dirname(os.path.abspath(__file__))


def _spawn(tmp_path, world=4):
    """The rank script of ``torch_layout_cases.py`` on ``world`` gloo
    ranks."""
    env = dict(os.environ, PYTHONPATH=REPO)
    return [subprocess.Popen(
        [sys.executable, os.path.join(TESTS, "torch_layout_cases.py"),
         str(r), str(world), str(tmp_path)],
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


def test_case_tables_are_the_rules_tests():
    """``torch_layout_cases.py`` (JAX-free, for the cards' run) writes out
    the tables ``tests/test_torch_rules.py`` makes: its ``random21``, T4
    and the default are those."""
    assert TABLES["random21"] == ALL_TABLES[TABLE_IDS.index("random21")]
    assert TABLES["T4"] == T4 and TABLES["default"] == DEFAULT
