"""Port parity: parameters on every mesh axis a rules table names
(``tony_tpu_torch/parallel/sharding.py``: ``fsdp_shards``,
``fully_shard_placed``, ``_distribute_experts``; ``grad_sync._mesh_sync``;
the MoE's expert dim over tp or off ep) against the reference, which takes
the same table in ``init_sharded_state`` and ``jit_train_step`` and lets
GSPMD lay the models out.

The tables are ``DEFAULT_RULES`` with rules put first: G1 ``("embed",
"dp")`` (ZeRO over dp), G2 ``("embed", ("fsdp", "sp"))``, G3 ``("norm",
"tp")``, G4 ``("embed", ("dcn_dp", "fsdp"))`` (ZeRO over dcn_dp), G5
``("embed", "ep")``, G6 ``("expert", "tp")``, G7 ``("embed", ("fsdp",
"sp", "ep")), ("norm", "tp")`` (MaxText-style), and G6b ``("expert",
("ep", "tp"))`` (the experts' expert dim over both).

One spawn of four gloo ranks (``FileStore`` rendezvous in ``tmp_path``,
each rank with its own timeout), the reference's runs computed in this
process on four virtual host devices meanwhile, 3 steps each from one set
of weights: the dense decoder under G1 and G3 at ``(dp=2, tp=2)``, the
ring decoder under G2 at ``(fsdp=2, sp=2)``, the dense decoder under G4 at
``(dcn_dp=2, fsdp=2)``, the MoE decoder under G5, G6 and G6b at ``(ep=2,
tp=2)`` and under G7 at ``(fsdp=2, ep=2)``, the MNIST MLP under G1 at
``(dp=2, tp=2)``. Losses within 1e-5 relative, each gathered parameter
within 1e-5 relative Frobenius error after each step, every local shard
shape the reference's ``shard_shape``, and each rank's step-0 shard equal
to the reference's ``addressable_shards`` entry of the device at the same
mesh coordinate (``build_mesh`` puts device r where the port puts rank r).

Then the ring decoder's state after its 3 steps goes through a checkpoint
chain: a DCP save under G2 at ``(fsdp=2, sp=2)`` restored under the
default table at ``(fsdp=4)``, one step, saved again and restored under G4
at ``(dcn_dp=2, fsdp=2)``, one step; the same two hops in memory
(``sharding.reshard``). Every restore bit for bit the saved parameters and
moments, and each next step's loss within 1e-5 of the reference's fourth
and fifth (a layout moves bytes, not results, as orbax re-lays a restore
onto whatever mesh the reference names).
"""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_rules import (DEFAULT, GSPMD_TABLES, REPO, _converters,
                              _jmodel, _leaves, _rel, _wait)
from tony_tpu import compat
from tony_tpu.models import moe as jmoe
from tony_tpu.models import transformer as jtf
from tony_tpu.models.mlp import classification_loss as jclassification
from tony_tpu.parallel import (MeshSpec, build_mesh, init_sharded_state,
                               jit_train_step)
from tony_tpu_torch.models import MnistMLP

GB, SEQ, LR, STEPS, RTOL = 8, 16, 3e-4, 3, 1e-5
VISION_GB, HIDDEN, SGD_LR, MOMENTUM = 8, 64, 0.1, 0.9
RANK_TIMEOUT_S = 600
torch.set_num_threads(2)
pytestmark = pytest.mark.timeout_s(900)

# The experts' expert dim over (ep, tp) together: ep's all-to-all on the
# ep shard, tp's shards gathered.
TABLES = {"default": DEFAULT, **GSPMD_TABLES,
          "G6b": (("expert", ("ep", "tp")),) + DEFAULT}

# name -> (model kind, mesh spec, config keywords, table). SGD with
# momentum where a gradient's scale is at stake (a sum over sp, a mean over
# the tp or ep replicas): Adam's update hides a factor of 2.
DT, FS, DF = dict(dp=2, tp=2), dict(fsdp=2, sp=2), dict(dcn_dp=2, fsdp=2)
ET, FE = dict(ep=2, tp=2), dict(fsdp=2, ep=2)
CASES = {
    "dense_G1": ("dense", DT, {}, "G1"),
    "dense_G3": ("dense", DT, {}, "G3"),
    "ring_G2": ("dense", FS, dict(attn_impl="ring"), "G2"),
    "dense_G4": ("dense", DF, {}, "G4"),
    "moe_G5": ("moe", ET, {}, "G5"),
    "moe_G6": ("moe", ET, {}, "G6"),
    "moe_G6b": ("moe", ET, {}, "G6b"),
    "moe_G7": ("moe", FE, {}, "G7"),
    "mlp_G1": ("mlp", DT, {}, "G1"),
}
ADAMW = ("dense_G1", "dense_G4")
# The checkpoint chain from ring_G2's state: (table, mesh) of each hop.
CHAIN_FROM = "ring_G2"
CHAIN = (("default", dict(fsdp=4)), ("G4", DF))

# What each table lays where the default would not, read off rank 0's
# parameters after the step: (parameter, the mesh dim names it sits on).
LAID = {
    "dense_G1": ("layers.0.attn.wq.weight", ("dp", "tp")),
    "dense_G3": ("layers.0.attn_norm.scale", ("dp", "tp")),
    "ring_G2": ("layers.0.attn.wq.weight", ("fsdp+sp", "tp")),
    "dense_G4": ("layers.0.attn.wq.weight", ("dcn_dp+fsdp", "tp")),
    "moe_G5": ("embedding", ("ep", "tp")),
    "moe_G6": ("layers.0.moe.gate", ("fsdp", "tp")),
    "moe_G6b": ("layers.0.moe.gate", ("fsdp", "ep", "tp")),
    "moe_G7": ("layers.0.moe.gate", ("fsdp+sp+ep", "tp")),
    "mlp_G1": ("dense.0.weight", ("dp", "tp")),
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
from tony_tpu_torch.models import MnistMLP, classification_loss
from tony_tpu_torch.models import moe as tmoe
from tony_tpu_torch.models import transformer as ttf
from tony_tpu_torch.parallel import (MeshSpec, adamw, build_mesh,
                                     checkpoint_tree, init_sharded_state,
                                     load_checkpoint_tree, reshard, sgd,
                                     sharded_train_step)

rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group(
    "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
    rank=rank, world_size=world)
CASES, TABLES, CHAIN_FROM, CHAIN = %(cases)r, %(tables)r, %(from)r, %(chain)r
ADAMW = %(adamw)r
LR, SGD_LR, MOMENTUM, STEPS, HIDDEN = %(consts)r


def whole(x):
    return (x.full_tensor() if isinstance(x, DTensor) else x).detach().clone()


def local(x):
    return (x.to_local() if isinstance(x, DTensor) else x).detach().clone()


def setup(name, kind, kw):
    # (build(device), optimizer(groups), loss_fn(model, batch))
    opt = ((lambda g: adamw(g, LR)) if name in ADAMW else
           (lambda g: sgd(g, SGD_LR, momentum=MOMENTUM)))
    if kind == "dense":
        cfg = ttf.TransformerConfig.tiny(**kw)
        return (lambda d: ttf.Transformer(cfg, device=d), opt,
                lambda m, b: (ttf.causal_lm_loss(m(b["tokens"]),
                                                 b["tokens"]), {}))
    if kind == "moe":
        cfg = tmoe.MoEConfig.tiny_moe(**kw)
        return (lambda d: tmoe.MoETransformer(cfg, device=d), opt,
                lambda m, b: (tmoe.moe_lm_loss(m(b["tokens"]), b["tokens"],
                                               cfg.aux_loss_weight), {}))
    return (lambda d: MnistMLP(HIDDEN, device=d), opt,
            lambda m, b: (classification_loss(m(b["x"]), b["y"]), {}))


def batch(data, s, rows):
    b = {k: torch.from_numpy(v[s, rows]) for k, v in data.items()}
    return {k: v.long() if k in ("tokens", "y") else v for k, v in b.items()}


def moments(state):
    return {k: {n: whole(v) for n, v in st.items() if n != "step"}
            for k, st in checkpoint_tree(state)["optim"]["state"].items()}


def relay(src, dst):
    # src's parameters, moments and step re-laid in memory onto dst's.
    a, b = checkpoint_tree(src), checkpoint_tree(dst)
    optim = {k: reshard(st, b["optim"]["state"][k])
             for k, st in a["optim"]["state"].items()}
    load_checkpoint_tree(dst, {
        "step": a["step"], "model": reshard(a["model"], b["model"]),
        "optim": {"state": optim,
                  "param_groups": b["optim"]["param_groups"]}})


def chain(mesh, state, build, opt, loss_fn, data):
    # The DCP hops and the in-memory ones, each restore held bit for bit.
    hops = []
    dcp, mem = (mesh, state), (mesh, state)
    for hop, (table, spec) in enumerate(CHAIN):
        src_mesh, src = dcp
        saved = ({k: whole(p) for k, p in src.model.named_parameters()},
                 moments(src), src.step)
        mgr = CheckpointManager(os.path.join(tmp, f"ckpt{hop}"))
        mgr.save(src.step, checkpoint_tree(src), force=True, mesh=src_mesh)
        mgr.close()
        mesh = build_mesh(MeshSpec(**spec), "cpu")
        fresh, _ = init_sharded_state(build, opt, mesh, rules=TABLES[table],
                                      seed=1)
        mgr = CheckpointManager(os.path.join(tmp, f"ckpt{hop}"))
        load_checkpoint_tree(fresh, mgr.restore(None, checkpoint_tree(fresh),
                                                mesh=mesh))
        resharded = mgr.last_restore_resharded
        mgr.close()
        twin, _ = init_sharded_state(build, opt, mesh, rules=TABLES[table],
                                     seed=1)
        relay(mem[1], twin)
        got = {}
        for label, st in (("dcp", fresh), ("memory", twin)):
            got[label] = dict(
                step=st.step,
                params={k: whole(p) for k, p in st.model.named_parameters()},
                moments=moments(st))
        rows = process_batch_slice(data["tokens"].shape[1], mesh=mesh)
        b = batch(data, STEPS + hop, rows)
        for label, st in (("dcp", fresh), ("memory", twin)):
            _, m = sharded_train_step(loss_fn, mesh, st, b)
            got[label]["loss"] = m["loss"].item()
        hops.append(dict(saved=saved, resharded=resharded, **got))
        dcp, mem = (mesh, fresh), (mesh, twin)
    return hops


out = {}
for name, (kind, spec, kw, table) in CASES.items():
    build, opt, loss_fn = setup(name, kind, kw)
    mesh = build_mesh(MeshSpec(**spec), "cpu")
    state, placements = init_sharded_state(build, opt, mesh,
                                           rules=TABLES[table])
    set_model_state_dict(
        state.model, torch.load(os.path.join(tmp, f"{name}_w.pt")),
        options=StateDictOptions(full_state_dict=True))
    case = dict(shards0={k: local(p)
                         for k, p in state.model.named_parameters()})
    data = dict(np.load(os.path.join(tmp, f"{name}_data.npz")))
    rows = process_batch_slice(next(iter(data.values())).shape[1], mesh=mesh)
    losses, params = [], []
    for s in range(STEPS):
        state, m = sharded_train_step(loss_fn, mesh, state,
                                      batch(data, s, rows))
        losses.append(m["loss"].item())
        params.append({k: whole(p) for k, p in state.model.named_parameters()})
    case.update(
        losses=losses, step=state.step,
        params=params if rank == 0 else params[-1:],
        meshes={k: getattr(p, "device_mesh", None) and
                p.device_mesh.mesh_dim_names
                for k, p in state.model.named_parameters()},
        local_shapes={k: tuple(local(p).shape)
                      for k, p in state.model.named_parameters()},
        planned={k: pl.local_shape for k, pl in placements.items()})
    if name == CHAIN_FROM:
        case["chain"] = chain(mesh, state, build, opt, loss_fn, data)
    out[name] = case
    del state
torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
dist.barrier()
dist.destroy_process_group()
""" % {"cases": CASES, "tables": TABLES, "from": CHAIN_FROM, "chain": CHAIN,
       "adamw": ADAMW, "consts": (LR, SGD_LR, MOMENTUM, STEPS, HIDDEN)}


def _spawn(tmp_path, world=4):
    import subprocess
    import sys

    script = tmp_path / "rank.py"
    script.write_text(_RANK_SCRIPT)
    env = dict(os.environ, PYTHONPATH=REPO)
    return [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), str(tmp_path)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]


def _steps(name):
    return STEPS + (len(CHAIN) if name == CHAIN_FROM else 0)


def _case_inputs(name, seed):
    """(flax params, {key: batches}): the decoders' weights the reference's
    init (with the default rules), the MLP's the port's seeded init carried
    to the flax tree with a linear probe's labels."""
    kind, _, kw, _ = CASES[name]
    rng = np.random.default_rng(seed)
    n = _steps(name)
    if kind in ("dense", "moe"):
        tokens = rng.integers(0, 256, (n, GB, SEQ)).astype(np.int32)
        with fnn.logical_axis_rules(list(DEFAULT)):
            params = _jmodel(kind, kw).init(jax.random.key(0),
                                            jnp.asarray(tokens[0]))
        return (jax.tree.map(np.asarray, fnn.meta.unbox(params)["params"]),
                {"tokens": tokens})
    params = _converters(kind, kw)[1](MnistMLP(HIDDEN,
                                               device="cpu").state_dict())
    x = rng.standard_normal((n, VISION_GB, 28, 28, 1), dtype=np.float32)
    w = rng.standard_normal((784, 10), dtype=np.float32)
    y = np.argmax(x.reshape(n, VISION_GB, -1) @ w, axis=-1)
    return params, {"x": x, "y": y.astype(np.int32)}


def _reference(name, params0, data):
    """The reference's run under the case's table: (losses, params after
    each step, shard shapes, {leaf path: {device id: step-0 shard}})."""
    kind, spec, kw, table = CASES[name]
    rules = TABLES[table]
    model = _jmodel(kind, kw)
    n = int(np.prod(list(spec.values())))
    mesh = build_mesh(MeshSpec(**spec), devices=jax.devices()[:n])
    key = "tokens" if kind in ("dense", "moe") else "x"

    def loss_fn(params, batch, rng):
        out = model.apply({"params": params}, batch[key])
        if kind == "dense":
            return jtf.causal_lm_loss(out, batch["tokens"]), {}
        if kind == "moe":
            return jmoe.moe_lm_loss(out, batch["tokens"],
                                    model.cfg.aux_loss_weight), {}
        return jclassification(out, batch["y"]), {}

    tx = optax.adamw(LR) if name in ADAMW else \
        optax.sgd(SGD_LR, momentum=MOMENTUM)
    first = {k: jnp.asarray(v[0]) for k, v in data.items()}
    state, sh = init_sharded_state(model, first[key], tx, mesh, rules=rules)
    state = state.replace(params=jax.device_put(params0, sh.params))
    shapes = jax.tree.map(lambda x: x.sharding.shard_shape(x.shape),
                          state.params)
    shards = {jax.tree_util.keystr(path): {
        s.device.id: np.asarray(s.data) for s in x.addressable_shards}
        for path, x in jax.tree_util.tree_leaves_with_path(state.params)}
    order = [d.id for d in mesh.devices.flat]
    step = jit_train_step(loss_fn, mesh, sh, first, rules=rules,
                          donate=False)
    losses, params = [], []
    with compat.set_mesh(mesh):
        for s in range(_steps(name)):
            state, m = step(state, {k: jnp.asarray(v[s])
                                    for k, v in data.items()},
                            jax.random.key(s))
            losses.append(float(m["loss"]))
            params.append(jax.tree.map(np.asarray, state.params))
    return losses, params, shapes, shards, order


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results, with the reference's runs computed in this
    process while the ranks train."""
    tmp = tmp_path_factory.mktemp("gspmd")
    inputs = {}
    for i, name in enumerate(CASES):
        params, data = inputs[name] = _case_inputs(name, i)
        kind, _, kw, _ = CASES[name]
        torch.save(_converters(kind, kw)[0](params), tmp / f"{name}_w.pt")
        np.savez(tmp / f"{name}_data.npz", **data)
    procs = _spawn(tmp)
    try:
        ref = {name: _reference(name, *inputs[name]) for name in CASES}
    finally:
        _wait(procs)
    return [torch.load(tmp / f"out{r}.pt") for r in range(4)], ref


@pytest.mark.parametrize("name", list(CASES))
def test_gspmd_step_matches_reference(runs, name):
    """Losses over the 3 steps, and each gathered parameter after each
    step, against the reference under the same table."""
    out, ref = runs
    losses, params = ref[name][:2]
    kind, _, kw, _ = CASES[name]
    to_flax = _converters(kind, kw)[1]
    for o in out:
        assert o[name]["step"] == STEPS
        np.testing.assert_allclose(o[name]["losses"], losses[:STEPS],
                                   rtol=RTOL)
    for s in range(STEPS):
        got = to_flax(out[0][name]["params"][s])
        for path, have, want in _leaves(got, params[s]):
            assert _rel(have, want) <= RTOL, (name, s, path)
    for o in out[1:]:
        for k, v in o[name]["params"][-1].items():
            assert torch.equal(v, out[0][name]["params"][-1][k]), (name, k)


@pytest.mark.parametrize("name", list(CASES))
def test_gspmd_shards_are_the_references(runs, name):
    """Every local shard's shape is the reference's ``shard_shape``, and
    each rank's step-0 shard holds what the reference's device at the same
    mesh coordinate holds."""
    out, ref = runs
    _, _, shapes, shards, order = ref[name]
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


def test_gspmd_layouts_are_the_tables(runs):
    """What each table lays out, read off rank 0's parameters: the mesh
    dims FSDP2 (and the plan) put the named parameter on."""
    out, _ = runs
    for name, (param, dims) in LAID.items():
        assert out[0][name]["meshes"][param] == dims, (name, param)


@pytest.mark.parametrize("hop", range(len(CHAIN)))
def test_checkpoint_across_layouts(runs, hop):
    """Hop 0: the ring decoder's state saved under G2 at ``(fsdp=2, sp=2)``
    restored under the default table at ``(fsdp=4)``; hop 1: that state
    after one more step restored under G4 at ``(dcn_dp=2, fsdp=2)``. DCP
    and ``reshard`` restore the parameters and moments bit for bit, and
    the next step's loss is the reference's."""
    out, ref = runs
    losses = ref[CHAIN_FROM][0]
    was = dict.fromkeys(("dcn_dp", "dp", "fsdp", "pp", "ep", "sp", "tp"), 1)
    meshes = [CASES[CHAIN_FROM][1]] + [spec for _, spec in CHAIN]
    for o in out:
        h = o[CHAIN_FROM]["chain"][hop]
        params, moments, step = h["saved"]
        assert h["resharded"] == (was | meshes[hop], was | meshes[hop + 1])
        for label in ("dcp", "memory"):
            got = h[label]
            assert got["step"] == step == STEPS + hop
            for k, v in params.items():
                assert torch.equal(got["params"][k], v), (label, k)
            for k, m in moments.items():
                for n, v in m.items():
                    assert torch.equal(got["moments"][k][n], v), (label, k)
            np.testing.assert_allclose(got["loss"], losses[STEPS + hop],
                                       rtol=RTOL)
        assert h["dcp"]["loss"] == h["memory"]["loss"]
