"""Port parity: the MoE decoder and expert parallelism
(``tony_tpu_torch/models/moe.py`` and the ``ep`` mesh axis) against
``tony_tpu/models/moe.py``.

In this process:

- the routed expert FFN of one routing group against the reference's
  ``_routed_ffn_group``, on the same weights and router probabilities:
  uniform probabilities (every expert ties: ``jax.lax.top_k`` puts the
  lower index first, the port's stable sort must too), random and skewed
  ones, at capacity factors that drop tokens (positions past the capacity,
  where the reference's ``one_hot`` gives a zero row) and that keep all;
- a single expert equals the dense MLP; the aux loss penalises imbalance
  (and equals the reference's);
- ``convert.py``'s MoE pair round-trips the reference's tree; the whole
  tiny MoE decoder's loss and gradients against the reference's at ep = 1
  (f32, relative 1e-5 and 1e-4);
- the local shard shapes ``param_placements`` plans on ep meshes against
  the reference's ``param_shardings``; the refusals; one rank of gloo,
  sharded against unsharded, bit for bit.

On four gloo ranks (one spawn: ``FileStore`` rendezvous, 120 s per rank)
against the reference's ``init_sharded_state`` with ``MoETransformer`` and
``moe_lm_loss`` under ``set_mesh`` on four virtual host devices, 3 AdamW
steps each (losses within 1e-5 relative, each gathered parameter within
1e-5 relative Frobenius error, every local shard shape the reference's):
ep = 4, (dp=2, ep=2), (fsdp=2, ep=2), and with a capacity that drops tokens
at (dp=2, ep=2) (the reference's routing group is one batch coordinate's
tokens: a rank's own half would route differently) and at (dp=2, fsdp=2)
(ep = 1: one group over the global batch, across four ranks); the port's
``dryrun_ep_step`` at (dp=2, ep=2); a DCP save at (fsdp=2, ep=2) restored
bitwise, the mesh in the manifest.
"""

import math
import os
import subprocess
import sys

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from tony_tpu import compat
from tony_tpu.models import moe as jmoe
from tony_tpu.parallel import MeshSpec, build_mesh, init_sharded_state
from tony_tpu.parallel import sharding as jsh
from tony_tpu_torch.convert import from_flax_moe_params, to_flax_moe_params
from tony_tpu_torch.models import moe as tmoe
from tony_tpu_torch.parallel import mesh as tmesh
from tony_tpu_torch.parallel import sharding as tsh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GB, SEQ, LR, STEPS = 8, 16, 3e-4, 3
RTOL = 1e-5
torch.set_num_threads(2)
# The module's fixture runs the JAX reference (compile-bound, ~1 min here)
# while four gloo ranks train: more than the default watchdog allows on a
# loaded machine.
pytestmark = pytest.mark.timeout_s(600)
# name -> (mesh spec, capacity factor)
CASES = {
    "ep4": (dict(ep=4, dp=1), 1.25),
    "dp2_ep2": (dict(dp=2, ep=2), 1.25),
    "fsdp2_ep2": (dict(fsdp=2, ep=2), 1.25),
    "dp2_ep2_drop": (dict(dp=2, ep=2), 0.5),
    "dp2_fsdp2_drop": (dict(dp=2, fsdp=2), 0.5),
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
from tony_tpu_torch.checkpoint import CheckpointManager
from tony_tpu_torch.data import process_batch_slice
from tony_tpu_torch.models import moe as tmoe
from tony_tpu_torch.parallel import (MeshSpec, adamw, build_mesh,
                                     checkpoint_tree, init_sharded_state,
                                     load_checkpoint_tree, mesh_shape,
                                     sharded_train_step)

rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group(
    "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
    rank=rank, world_size=world)
CASES = %(cases)r
LR, STEPS = %(lr)r, %(steps)r
params0 = torch.load(os.path.join(tmp, "w.pt"))
tokens = np.load(os.path.join(tmp, "tokens.npy"))


def whole(x):
    return (x.full_tensor() if isinstance(x, DTensor) else x).detach().clone()


def local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def build(mesh, cfg, seed=0):
    return init_sharded_state(lambda d: tmoe.MoETransformer(cfg, device=d),
                              lambda g: adamw(g, LR), mesh, seed=seed)


out = {}
for name, (spec, cf) in CASES.items():
    cfg = tmoe.MoEConfig.tiny_moe(capacity_factor=cf)
    mesh = build_mesh(MeshSpec(**spec), "cpu")
    state, placements = build(mesh, cfg)
    set_model_state_dict(state.model, dict(params0),
                         options=StateDictOptions(full_state_dict=True))
    rows = process_batch_slice(tokens.shape[1], mesh=mesh)

    def loss_fn(m, batch):
        tok = batch["tokens"]
        return tmoe.moe_lm_loss(m(tok), tok, cfg.aux_loss_weight), {}

    losses = []
    for s in range(STEPS):
        state, m = sharded_train_step(
            loss_fn, mesh, state,
            {"tokens": torch.from_numpy(tokens[s, rows]).long()})
        losses.append(m["loss"].item())
    out[name] = dict(
        losses=losses,
        local_shapes={k: tuple(local(p).shape)
                      for k, p in state.model.named_parameters()},
        planned={k: pl.local_shape for k, pl in placements.items()},
        params={k: whole(p) for k, p in state.model.named_parameters()})
    if name == "fsdp2_ep2":
        mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
        mgr.save(STEPS - 1, checkpoint_tree(state), force=True, mesh=mesh)
        fresh, _ = build(mesh, cfg, seed=1)
        load_checkpoint_tree(fresh, mgr.restore(None, checkpoint_tree(fresh),
                                                mesh=mesh))
        sa = checkpoint_tree(state)["optim"]["state"]
        sb = checkpoint_tree(fresh)["optim"]["state"]
        out["dcp"] = dict(
            step=fresh.step, noted=mgr.saved_mesh_shape(STEPS - 1),
            mesh=mesh_shape(mesh), resharded=mgr.last_restore_resharded,
            params=all(torch.equal(whole(a), whole(b)) for a, b in zip(
                state.model.parameters(), fresh.model.parameters())),
            moments=all(torch.equal(whole(v), whole(sb[k][n]))
                        for k in sa for n, v in sa[k].items()
                        if n != "step"))
        mgr.close()
out["dryrun"] = tmoe.dryrun_ep_step(build_mesh(MeshSpec(dp=2, ep=2), "cpu"))
torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
dist.barrier()
dist.destroy_process_group()
""" % {"cases": CASES, "lr": LR, "steps": STEPS}


def _rules():
    return fnn.logical_axis_rules(list(jsh.DEFAULT_RULES))


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


def _reference(params0, tokens, spec, cf):
    """The reference's sharded run: (losses, params, shard shapes)."""
    cfg = jmoe.MoEConfig.tiny_moe(capacity_factor=cf)
    model = jmoe.MoETransformer(cfg)
    n = int(np.prod(list(spec.values())))
    mesh = build_mesh(MeshSpec(**spec), devices=jax.devices()[:n])
    state, sh = init_sharded_state(model, jnp.asarray(tokens[0]),
                                   optax.adamw(LR), mesh)
    state = state.replace(params=jax.device_put(params0, sh.params))
    # The laid-out shards (the jitted step below leaves its outputs'
    # shardings to XLA).
    shapes = jax.tree.map(lambda x: x.sharding.shard_shape(x.shape),
                          state.params)

    def loss_fn(p, t):
        with _rules():
            return jmoe.moe_lm_loss(model.apply({"params": p}, t), t,
                                    cfg.aux_loss_weight)

    @jax.jit
    def step(state, t):
        loss, g = jax.value_and_grad(loss_fn)(state.params, t)
        return state.apply_gradients(grads=g), loss

    losses = []
    with compat.set_mesh(mesh):
        for s in range(STEPS):
            state, loss = step(state, jnp.asarray(tokens[s]))
            losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, state.params), shapes


def _init_params(cfg, tokens):
    with _rules():
        v = jmoe.MoETransformer(cfg).init(jax.random.key(0),
                                          jnp.asarray(tokens))
    return jax.tree.map(np.asarray, fnn.meta.unbox(v)["params"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results, with the reference's computed in this
    process while the ranks train."""
    tmp = tmp_path_factory.mktemp("moe")
    cfg = jmoe.MoEConfig.tiny_moe()
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (STEPS, GB, SEQ)).astype(np.int32)
    params0 = _init_params(cfg, tokens[0])
    torch.save(from_flax_moe_params(params0), tmp / "w.pt")
    np.save(tmp / "tokens.npy", tokens)
    procs = _spawn(tmp)
    try:
        ref = {name: _reference(params0, tokens, *case)
               for name, case in CASES.items()}
    finally:
        _wait(procs)
    return [torch.load(tmp / f"out{r}.pt") for r in range(4)], ref, \
        params0, tokens


def _rel(have, want):
    want = np.asarray(want, np.float64)
    return np.linalg.norm(np.asarray(have, np.float64) - want) / \
        np.linalg.norm(want)


def _leaves(tree, paths_of):
    for path, want in jax.tree_util.tree_leaves_with_path(
            paths_of, is_leaf=lambda x: isinstance(x, tuple)):
        have = tree
        for key in path:
            have = have[key.key]
        yield jax.tree_util.keystr(path), have, want


# ---------------------------------------------------------------------------
# One process
# ---------------------------------------------------------------------------
def _group_inputs(cfg, kind, t=64, seed=0):
    rng = np.random.default_rng(seed)
    e, d, f = cfg.n_experts, cfg.dim, cfg.mlp_dim
    xt = rng.standard_normal((t, d), dtype=np.float32)
    w = [rng.standard_normal(s, dtype=np.float32) / math.sqrt(s[1])
         for s in ((e, d, f), (e, d, f), (e, f, d))]
    if kind == "uniform":
        probs = np.full((t, e), 1.0 / e, np.float32)
    else:
        logits = rng.standard_normal((t, e), dtype=np.float32)
        if kind == "skewed":
            logits[:, 0] += 3.0
        probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return xt, probs.astype(np.float32), w


def _port_mlp(cfg, w, router=None):
    m = tmoe.MoEMLP(cfg, torch.device("cpu"))
    with torch.no_grad():
        for name, x in zip(("gate", "up", "down"), w):
            getattr(m, name).copy_(torch.from_numpy(x))
        if router is not None:
            m.router.weight.copy_(torch.from_numpy(router.T.copy()))
    return m


@pytest.mark.parametrize("cf", [0.5, 1.0, 2.0])
@pytest.mark.parametrize("kind", ["uniform", "random", "skewed"])
def test_routed_group_matches_reference(kind, cf):
    jcfg = jmoe.MoEConfig.tiny_moe(capacity_factor=cf)
    cfg = tmoe.MoEConfig.tiny_moe(capacity_factor=cf)
    xt, probs, w = _group_inputs(cfg, kind)
    want = jmoe._routed_ffn_group(jcfg, jnp.asarray(xt), jnp.asarray(probs),
                                  *(jnp.asarray(x) for x in w), n_ep=1)
    got = _port_mlp(cfg, w)._routed(torch.from_numpy(xt),
                                    torch.from_numpy(probs))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def test_top_k_ties_take_the_lower_index_first():
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.2, 0.3, 0.2]], np.float32)
    _, want = jax.lax.top_k(jnp.asarray(probs), 2)
    got = tmoe.top_k_experts(torch.from_numpy(probs), 2)
    assert got.tolist() == np.asarray(want).tolist() == \
        [[0, 1], [1, 3], [0, 2]]


def test_route_drops_past_capacity():
    cfg = tmoe.MoEConfig.tiny_moe(n_experts=2, top_k=1)
    idx = torch.tensor([[0], [0], [1], [0]])
    pos, kept = tmoe.route(cfg, idx, cap=2)
    assert pos[:, 0].tolist() == [0, 1, 0, 2]
    assert kept[:, 0].tolist() == [True, True, True, False]
    dispatch, combine = tmoe.dispatch_combine(
        cfg, idx, torch.ones(4, 1), pos, kept, 2)
    # The dropped token's row is zero: no slot is out of range.
    assert dispatch.sum(1).tolist() == [1, 1, 1, 0]
    assert combine[3].abs().sum() == 0


def test_single_expert_equals_dense_mlp():
    cfg = tmoe.MoEConfig.tiny_moe(n_experts=1, top_k=1, capacity_factor=2.0)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 16, cfg.dim),
                                             dtype=np.float32))
    m = tmoe.MoEMLP(cfg, torch.device("cpu"))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name in ("gate", "up", "down"):
            tmoe.init_expert_(getattr(m, name), gen)
        tmoe.init_dense_(m.router.weight, gen)
    out, aux = m(x)
    want = (torch.nn.functional.silu(x @ m.gate[0]) * (x @ m.up[0])) \
        @ m.down[0]
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(),
                               atol=1e-5, rtol=1e-5)
    assert float(aux) == pytest.approx(1.0)


def test_aux_loss_penalizes_imbalance():
    jcfg = jmoe.MoEConfig.tiny_moe(n_experts=4, top_k=1)
    cfg = tmoe.MoEConfig.tiny_moe(n_experts=4, top_k=1)
    x = np.random.default_rng(0).standard_normal((1, 64, cfg.dim)).astype(
        np.float32)
    with _rules():
        variables = jmoe.MoEMLP(jcfg).init(jax.random.key(1), x)
    flat = flax.traverse_util.flatten_dict(
        jax.tree.map(np.asarray, fnn.meta.unbox(variables)["params"]),
        sep="/")
    kernel = flat["router/kernel"]
    collapsed = np.zeros_like(kernel)
    collapsed[:, 0] = 10.0
    auxes = []
    for router in (np.zeros_like(kernel), collapsed):
        p = dict(flat, **{"router/kernel": router})
        with _rules():
            _, want = jmoe.MoEMLP(jcfg).apply(
                {"params": flax.traverse_util.unflatten_dict(p, sep="/")},
                x)
        m = _port_mlp(cfg, [p["gate"], p["up"], p["down"]], router)
        _, aux = m(torch.from_numpy(x))
        assert float(aux) == pytest.approx(float(want), rel=1e-6)
        auxes.append(float(aux))
    assert auxes[0] == pytest.approx(1.0, abs=1e-5)
    assert auxes[1] > auxes[0] + 0.1


def test_moe_params_round_trip_through_convert():
    cfg = jmoe.MoEConfig.tiny_moe()
    params = _init_params(cfg, np.zeros((1, 8), np.int32))
    sd = from_flax_moe_params(params)
    model = tmoe.MoETransformer(tmoe.MoEConfig.tiny_moe(), device="cpu")
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert sd[k].shape == v.shape, k
    back = to_flax_moe_params(sd)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["keep", "drop"])
def test_moe_decoder_matches_reference(cf):
    jcfg = jmoe.MoEConfig.tiny_moe(capacity_factor=cf)
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (4, SEQ)).astype(np.int32)
    params = _init_params(jcfg, tokens)

    def loss_fn(p):
        with _rules():
            return jmoe.moe_lm_loss(
                jmoe.MoETransformer(jcfg).apply({"params": p}, tokens),
                tokens, jcfg.aux_loss_weight)
    loss, grads = jax.value_and_grad(loss_fn)(params)
    cfg = tmoe.MoEConfig.tiny_moe(capacity_factor=cf)
    model = tmoe.MoETransformer(cfg, device="cpu")
    model.load_state_dict(from_flax_moe_params(params))
    tok = torch.from_numpy(tokens).long()
    got = tmoe.moe_lm_loss(model(tok), tok, cfg.aux_loss_weight)
    got.backward()
    assert float(got) == pytest.approx(float(loss), rel=RTOL)
    have = to_flax_moe_params({k: p.grad
                               for k, p in model.named_parameters()})
    for path, g, want in _leaves(have, jax.tree.map(np.asarray, grads)):
        assert _rel(g, want) <= 1e-4, path


@pytest.mark.parametrize("spec", [
    dict(dp=4, ep=2), dict(fsdp=2, ep=2), dict(fsdp=4, ep=2), dict(ep=4, dp=2),
    dict(dp=2, fsdp=2, ep=2)], ids=str)
def test_moe_param_placements_match_reference(spec):
    jcfg = jmoe.MoEConfig.tiny_moe()
    abstract = jax.eval_shape(
        lambda k: _rules_init(jcfg, k), jax.random.key(0))
    n = int(np.prod(list(spec.values())))
    mesh = build_mesh(MeshSpec(**spec), devices=jax.devices()[:n])
    want = jax.tree.map(lambda x, s: s.shard_shape(x.shape),
                        fnn.meta.unbox(abstract),
                        jsh.param_shardings(mesh, abstract))
    model = tmoe.MoETransformer(tmoe.MoEConfig.tiny_moe(), device="meta")
    sizes = dict(zip(tmesh.MESH_AXES,
                     tmesh.MeshSpec(**spec).resolve(n).sizes()))
    got = to_flax_moe_params({
        k: torch.empty(pl.local_shape)
        for k, pl in tsh.param_placements(model, sizes).items()})
    for path, have, shape in _leaves(got, want):
        assert tuple(have.shape) == tuple(shape), path


def _rules_init(cfg, key):
    with _rules():
        return jmoe.MoETransformer(cfg).init(
            key, jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.mark.parametrize("spec,knob", [
    (dict(tp=2, dp=1), "tp"), (dict(sp=2, dp=1), "sp"),
    (dict(pp=2, dp=1), "pp")])
def test_moe_mesh_refusals_name_the_knob(spec, knob):
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=2)
    try:
        mesh = tmesh.build_mesh(tmesh.MeshSpec(**spec), "cpu")
        model = tmoe.MoETransformer(tmoe.MoEConfig.tiny_moe(),
                                    device="meta")
        with pytest.raises(NotImplementedError, match=f"{knob}=2"):
            tsh.shard_model(model, mesh)
    finally:
        dist.destroy_process_group()


def test_moe_on_world1_mesh_matches_unsharded():
    """A one-rank gloo mesh (every axis 1, the experts DTensors on ep):
    the same losses as the unsharded model, bit for bit."""
    from tony_tpu_torch.parallel import (adamw, init_sharded_state,
                                         sharded_train_step, train_step)
    from tony_tpu_torch.parallel.train import TrainState

    cfg = tmoe.MoEConfig.tiny_moe(capacity_factor=0.5)
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, SEQ)))

    def loss_fn(m, batch):
        t = batch["tokens"]
        return tmoe.moe_lm_loss(m(t), t, cfg.aux_loss_weight), {}

    plain = tmoe.MoETransformer(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    ps = TrainState(plain, adamw(plain.parameters(), 1e-2), loss_fn)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = tmesh.build_mesh(tmesh.MeshSpec(), "cpu")
        state, _ = init_sharded_state(
            lambda d: tmoe.MoETransformer(cfg, device=d),
            lambda g: adamw(g, 1e-2), mesh)
        gate = state.model.layers[0].moe.gate
        assert type(gate).__name__ == "DTensor"
        for _ in range(2):
            a = sharded_train_step(loss_fn, mesh, state,
                                   {"tokens": tok})[1]["loss"]
            assert torch.equal(a, train_step(ps, {"tokens": tok})["loss"])
    finally:
        dist.destroy_process_group()


def test_capacity_cases_drop_tokens(runs):
    """The drop cases really drop: at step 0, the first layer's routing
    over the reference's groups keeps fewer slots than it is asked for."""
    _, _, params0, tokens = runs
    for name, (spec, cf) in CASES.items():
        cfg = tmoe.MoEConfig.tiny_moe(capacity_factor=cf)
        model = tmoe.MoETransformer(cfg, device="cpu")
        model.load_state_dict(from_flax_moe_params(params0))
        seen = {}
        model.layers[0].moe.router.register_forward_hook(
            lambda m, i, o: seen.setdefault("logits", o))
        with torch.no_grad():
            model(torch.from_numpy(tokens[0]).long())
        idx = tmoe.top_k_experts(torch.softmax(seen["logits"], -1),
                                 cfg.top_k)
        groups = spec.get("ep", 1)
        t = idx.shape[0] // groups
        dropped = sum(int((~tmoe.route(cfg, idx[g * t:(g + 1) * t],
                                       tmoe.capacity(cfg, t))[1]).sum())
                      for g in range(groups))
        if name.endswith("_drop"):
            assert dropped > 0, name


# ---------------------------------------------------------------------------
# Four gloo ranks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(CASES))
def test_ep_train_step_matches_reference(runs, name):
    out, ref, _, _ = runs
    losses, params, _ = ref[name]
    for o in out:
        np.testing.assert_allclose(o[name]["losses"], losses, rtol=RTOL)
    got = to_flax_moe_params(out[0][name]["params"])
    for path, have, want in _leaves(got, params):
        assert _rel(have, want) <= RTOL, path
    for o in out[1:]:
        for k, v in o[name]["params"].items():
            assert torch.equal(v, out[0][name]["params"][k]), (name, k)


@pytest.mark.parametrize("name", list(CASES))
def test_ep_local_shard_shapes_match_reference(runs, name):
    out, ref, _, _ = runs
    shapes = ref[name][2]
    for o in out:
        got = o[name]
        assert got["local_shapes"] == got["planned"]
        local = to_flax_moe_params({k: torch.empty(s) for k, s in
                                    got["local_shapes"].items()})
        for path, have, want in _leaves(local, shapes):
            assert tuple(have.shape) == tuple(want), path
    spec = CASES[name][0]
    e = jmoe.MoEConfig.tiny_moe().n_experts
    assert out[0][name]["local_shapes"]["layers.0.moe.gate"][0] == \
        e // spec.get("ep", 1)


def test_dryrun_ep_step(runs):
    out, _, _, _ = runs
    losses = {o["dryrun"] for o in out}
    assert len(losses) == 1 and math.isfinite(losses.pop())


def test_ep_checkpoint_round_trip(runs):
    out, _, _, _ = runs
    for o in out:
        d = o["dcp"]
        assert d["step"] == STEPS and d["params"] and d["moments"]
        assert d["noted"] == d["mesh"] and d["mesh"]["ep"] == 2
        assert d["resharded"] is None
