"""Port parity: tensor-parallel layouts under any logical rules table
(``tony_tpu_torch/parallel/sharding.py``: ``mesh_axes``'s rule-priority
resolution, ``tp_plan``'s and ``vision_tp_plan``'s pair-or-gather styles,
``EmbedParallelTable``, ``fsdp_shards``; the models' tp paths) against the
reference, which takes the same table in ``init_sharded_state`` and
``jit_train_step`` and lets GSPMD lay the models out.

(a) In this process: about 60 tables drawn from a seeded generator over the
logical names and the mesh axes (tuples of axes, ``None`` targets, names
repeated as fallbacks), the four tables below and ``DEFAULT_RULES``; for
every parameter of the port's tiny models (dense, tied, int8, MoE, ResNet,
MLP), ``param_placements`` equals flax's ``logical_to_mesh_axes`` on the
reference's names of the same parameter, reordered to torch's layout (the
reference's names read off its boxed init, the order off ``convert.py``).
A name twice in one tensor raises ``ValueError`` in both packages.

(b) One spawn of four gloo ranks (``FileStore`` rendezvous in ``tmp_path``,
each rank with its own timeout), the reference's runs computed in this
process on four virtual host devices meanwhile, 3 steps each from one set
of weights: the dense decoder under T1-T4 at ``(fsdp=2, tp=2)``, int8
under T2, the tied decoder under T3, the MLP and the tiny ResNet under T2,
the MoE decoder under T1 and T2 at ``(ep=2, tp=2)``. Losses within 1e-5
relative, each gathered parameter within 1e-5 relative Frobenius error
(per tensor), every local shard shape the reference's ``shard_shape``. The
int8 run is held to the reference's first step (loss and parameters) and
to the port's unsharded int8 run over the 3 steps, as
``tests/test_torch_tp_layouts.py`` holds its quantized cases (quantization
is discontinuous: two frameworks' ~1e-7 parameter noise moves a few
elements across a rounding level at the next step).

(c) In this process: the pipelined decoder's placements under T2 are the
default's (the reference's pipeline reads ``DEFAULT_RULES`` whatever its
caller passes); the tables once refused (a dim on dp, sp, ep off the
expert dim, tp on a norm or the expert dim; two dims of one tensor, axes
out of the mesh's order) laid out on four fake ranks, each parameter on
the axes its placement names (their training against the reference is
``tests/test_torch_rules_gspmd.py`` and
``tests/test_torch_rules_last_layouts.py``); the refusals that stay (pp >
1 on a sequential model, the MoE with sp and ep); no table puts tp on a
conv's in channels or lays a quantized projection other than
``Shard(0)``/``Shard(1)``.
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
from torch.distributed.tensor import DTensor, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from tony_tpu import compat
from tony_tpu.models import MnistMLP as JMnistMLP
from tony_tpu.models import ResNet as JResNet
from tony_tpu.models import ResNetConfig as JResNetConfig
from tony_tpu.models import moe as jmoe
from tony_tpu.models import transformer as jtf
from tony_tpu.models.mlp import classification_loss as jclassification
from tony_tpu.parallel import (MeshSpec, build_mesh, init_sharded_state,
                               jit_train_step)
from tony_tpu_torch.convert import (from_flax_mlp_params,
                                    from_flax_moe_params, from_flax_params,
                                    from_flax_resnet_params,
                                    to_flax_mlp_params, to_flax_moe_params,
                                    to_flax_params, to_flax_resnet_params)
from tony_tpu_torch.models import MnistMLP, ResNet, ResNetConfig
from tony_tpu_torch.models import moe as tmoe
from tony_tpu_torch.models import transformer as ttf
from tony_tpu_torch.parallel import mesh as tmesh
from tony_tpu_torch.parallel import sharding as tsh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GB, SEQ, LR, STEPS, RTOL = 8, 16, 3e-4, 3, 1e-5
VISION_GB, IMAGE, HIDDEN, SGD_LR, MOMENTUM = 8, 32, 64, 0.1, 0.9
RANK_TIMEOUT_S = 600
torch.set_num_threads(2)
# The module's fixture runs ten of the reference's sharded runs (each
# compile-bound) while four gloo ranks train.
pytestmark = pytest.mark.timeout_s(900)

DEFAULT = tsh.DEFAULT_RULES
# q heads over tp, kv heads whole.
T1 = tuple((n, None) if n == "kv_heads" else (n, a) for n, a in DEFAULT)
# embed takes tp wherever it is free: every projection, the LM head and the
# experts split on embed.
T2 = (("embed", "tp"),) + DEFAULT
# The embedding table's embed dim over tp, its rows over fsdp.
T3 = tuple(("vocab_table", "fsdp") if n == "vocab_table" else
           ("embed_table", "tp") if n == "embed_table" else (n, a)
           for n, a in DEFAULT)
# A MaxText-style fallback list: the head rowwise over (fsdp, tp), the
# projections as by default.
T4 = tuple(r for r in DEFAULT if r[0] not in ("embed", "vocab")) + (
    ("vocab", None), ("embed", ("fsdp", "tp")), ("embed", "fsdp"))
TABLES = {"default": DEFAULT, "T1": T1, "T2": T2, "T3": T3, "T4": T4}

# name -> (model kind, mesh spec, config keywords, table)
FT, ET = dict(fsdp=2, tp=2), dict(ep=2, tp=2)
CASES = {
    "dense_T1": ("dense", FT, {}, "T1"),
    "dense_T2": ("dense", FT, {}, "T2"),
    "dense_T3": ("dense", FT, {}, "T3"),
    "dense_T4": ("dense", FT, {}, "T4"),
    "int8_T2": ("dense", FT, dict(matmul_dtype="int8"), "T2"),
    "tied_T3": ("dense", FT, dict(tie_embeddings=True), "T3"),
    "mlp_T2": ("mlp", FT, {}, "T2"),
    "resnet_T2": ("resnet", FT, {}, "T2"),
    "moe_T1": ("moe", ET, {}, "T1"),
    "moe_T2": ("moe", ET, {}, "T2"),
}
QUANTIZED = ("int8_T2",)


# ---------------------------------------------------------------------------
# (a) Resolution
# ---------------------------------------------------------------------------
LOGICAL = ("batch", "seq", "embed", "mlp", "heads", "kv_heads", "kv", "qkv",
           "vocab", "vocab_table", "embed_table", "layers", "stage",
           "expert", "expert_logits", "norm")


def _random_tables(n=60, seed=17):
    """``n`` tables over the logical names and the mesh axes: single axes,
    tuples of two or three, ``None``; names drawn with repetition, so that
    a later rule for a name is a fallback for an earlier one."""
    rng = np.random.default_rng(seed)
    axes = list(tmesh.MESH_AXES)
    tables = []
    for _ in range(n):
        rules = []
        for _ in range(int(rng.integers(3, 18))):
            name = str(rng.choice(LOGICAL))
            r = rng.random()
            if r < 0.2:
                target = None
            elif r < 0.7:
                target = str(rng.choice(axes))
            else:
                k = int(rng.integers(2, 4))
                target = tuple(str(a) for a in
                               rng.choice(axes, k, replace=False))
            rules.append((name, target))
        tables.append(tuple(rules))
    return tables


ALL_TABLES = list(TABLES.values()) + _random_tables()
TABLE_IDS = list(TABLES) + [f"random{i}" for i in range(len(ALL_TABLES)
                                                         - len(TABLES))]
PRIMES = (2, 3, 5, 7)


def _reference_names(abstract, from_flax):
    """Per torch parameter name: the reference's logical names of that
    parameter, in torch's dim order. Each flax leaf becomes an array of
    distinct prime sizes filled with its index; ``from_flax`` carries it
    to the torch layout, where the sizes give the permutation and the fill
    the leaf."""
    specs = fnn.get_partition_spec(abstract)
    leaves, treedef = jax.tree_util.tree_flatten(
        jax.tree.map(lambda x: x.shape, fnn.meta.unbox(abstract)),
        is_leaf=lambda x: isinstance(x, tuple))
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
        or x is None)
    tagged = jax.tree_util.tree_unflatten(treedef, [
        np.full(PRIMES[:len(shape)], i, np.float32)
        for i, shape in enumerate(leaves)])
    out = {}
    for name, t in from_flax(tagged).items():
        leaf = int(t.reshape(-1)[0])
        spec = spec_leaves[leaf]
        names = tuple(spec) if spec else (None,) * len(leaves[leaf])
        names += (None,) * (len(leaves[leaf]) - len(names))
        out[name] = tuple(names[PRIMES.index(n)] for n in t.shape)
    return out


@pytest.fixture(scope="module")
def models():
    """(port model on meta, {torch name: the reference's names in torch's
    order}) for each tiny model."""
    def init(module, *args):
        with fnn.logical_axis_rules(list(DEFAULT)):
            return jax.eval_shape(
                lambda k: module.init(k, *args)["params"],
                jax.random.key(0))

    toks = jnp.zeros((1, 8), jnp.int32)
    out = {}
    for name, kw in (("dense", {}), ("tied", dict(tie_embeddings=True)),
                     ("int8", dict(matmul_dtype="int8"))):
        out[name] = (
            ttf.Transformer(ttf.TransformerConfig.tiny(**kw), device="meta"),
            _reference_names(init(jtf.Transformer(
                jtf.TransformerConfig.tiny(**kw)), toks), from_flax_params))
    out["moe"] = (
        tmoe.MoETransformer(tmoe.MoEConfig.tiny_moe(), device="meta"),
        _reference_names(init(jmoe.MoETransformer(jmoe.MoEConfig.tiny_moe()),
                              toks), from_flax_moe_params))
    rcfg = ResNetConfig.tiny()
    out["resnet"] = (
        ResNet(rcfg, device="meta"),
        _reference_names(init(JResNet(JResNetConfig.tiny()),
                              jnp.zeros((1, IMAGE, IMAGE, 3))),
                         lambda p: from_flax_resnet_params(p, rcfg)))
    out["mlp"] = (
        MnistMLP(HIDDEN, device="meta"),
        _reference_names(init(JMnistMLP(hidden=HIDDEN),
                              jnp.zeros((1, 28, 28, 1))),
                         from_flax_mlp_params))
    return out


def test_port_names_are_the_references(models):
    """Every parameter of every tiny model carries the reference's logical
    names (``PARAM_AXES``, or the model's own), in torch's order."""
    for kind, (model, ref) in models.items():
        own = getattr(model, "PARAM_AXES", {})
        names = dict(model.named_parameters())
        assert set(names) == set(ref), kind
        for name in names:
            assert tuple(own.get(name) or tsh.logical_axes(name)) == \
                ref[name], (kind, name)


@pytest.mark.parametrize("rules", ALL_TABLES, ids=TABLE_IDS)
def test_placements_resolve_as_flax(models, rules):
    sizes = dict.fromkeys(tmesh.MESH_AXES, 1)
    for kind, (model, ref) in models.items():
        placed = tsh.param_placements(model, sizes, rules)
        for name, names in ref.items():
            spec = fnn.logical_to_mesh_axes(names, rules=list(rules))
            want = tuple(() if a is None else (a,) if isinstance(a, str)
                         else tuple(a) for a in spec)
            assert placed[name].dims == want, (kind, name)


def test_duplicate_names_raise_in_both():
    names = ("embed", "mlp", "embed")
    with pytest.raises(ValueError, match="occur more than once") as ours:
        tsh.mesh_axes(names, T2)
    with pytest.raises(ValueError) as ref:
        fnn.logical_to_mesh_axes(names, rules=list(T2))
    assert str(ours.value) == str(ref.value)


def test_competing_names_follow_table_order():
    """Where two names of one tensor compete for tp, the rule earlier in
    the table wins, whichever dim comes first in torch's layout (the
    resolution before this one went dim by dim)."""
    assert tsh.mesh_axes(("heads", "embed"), T2) == ((), ("tp",))
    assert tsh.mesh_axes(("embed", "heads"), T2) == (("tp",), ())
    assert tsh.mesh_axes(("embed", "mlp"), T4) == (("fsdp",), ("tp",))
    assert tsh.mesh_axes(("expert", "mlp", "embed"), T4) == (
        ("ep",), ("tp",), ("fsdp",))


# ---------------------------------------------------------------------------
# (b) Four gloo ranks
# ---------------------------------------------------------------------------
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
from tony_tpu_torch.models import (MnistMLP, ResNet, ResNetConfig,
                                   classification_loss)
from tony_tpu_torch.models import moe as tmoe
from tony_tpu_torch.models import transformer as ttf
from tony_tpu_torch.ops import quant
from tony_tpu_torch.parallel import (MeshSpec, adamw, build_mesh,
                                     init_sharded_state, sgd,
                                     sharded_train_step)

rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group(
    "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
    rank=rank, world_size=world)
CASES, TABLES = %(cases)r, %(tables)r
LR, SGD_LR, MOMENTUM, STEPS, HIDDEN = %(consts)r


def whole(x):
    return (x.full_tensor() if isinstance(x, DTensor) else x).detach().clone()


def local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def setup(kind, kw):
    # (build(device), optimizer(groups), loss_fn(model, batch))
    if kind == "dense":
        cfg = ttf.TransformerConfig.tiny(**kw)
        return (lambda d: ttf.Transformer(cfg, device=d),
                lambda g: adamw(g, LR),
                lambda m, b: (ttf.causal_lm_loss(m(b["tokens"]),
                                                 b["tokens"]), {}))
    if kind == "moe":
        cfg = tmoe.MoEConfig.tiny_moe(**kw)
        return (lambda d: tmoe.MoETransformer(cfg, device=d),
                lambda g: adamw(g, LR),
                lambda m, b: (tmoe.moe_lm_loss(m(b["tokens"]), b["tokens"],
                                               cfg.aux_loss_weight), {}))
    build = ((lambda d: ResNet(ResNetConfig.tiny(**kw), device=d))
             if kind == "resnet" else lambda d: MnistMLP(HIDDEN, device=d))
    return (build, lambda g: sgd(g, SGD_LR, momentum=MOMENTUM),
            lambda m, b: (classification_loss(m(b["x"]), b["y"]), {}))


out = {}
for name, (kind, spec, kw, table) in CASES.items():
    build, opt, loss_fn = setup(kind, kw)
    mesh = build_mesh(MeshSpec(**spec), "cpu")
    state, placements = init_sharded_state(build, opt, mesh,
                                           rules=TABLES[table])
    set_model_state_dict(
        state.model, torch.load(os.path.join(tmp, f"{name}_w.pt")),
        options=StateDictOptions(full_state_dict=True))
    data = dict(np.load(os.path.join(tmp, f"{name}_data.npz")))
    rows = process_batch_slice(next(iter(data.values())).shape[1], mesh=mesh)
    case, losses = {}, []
    for s in range(STEPS):
        batch = {k: torch.from_numpy(v[s, rows]) for k, v in data.items()}
        for k in ("tokens", "y"):
            if k in batch:
                batch[k] = batch[k].long()
        state, m = sharded_train_step(loss_fn, mesh, state, batch)
        losses.append(m["loss"].item())
        if s == 0:
            case["first_params"] = {
                k: whole(p) for k, p in state.model.named_parameters()}
    case.update(
        losses=losses, step=state.step,
        layout={k: str(getattr(p, "placements", None))
                for k, p in state.model.named_parameters()},
        local_shapes={k: tuple(local(p).shape)
                      for k, p in state.model.named_parameters()},
        planned={k: pl.local_shape for k, pl in placements.items()},
        params={k: whole(p) for k, p in state.model.named_parameters()})
    out[name] = case
    del state
out["fallbacks"] = quant.fallback_events()
torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
dist.barrier()
dist.destroy_process_group()
""" % {"cases": CASES, "tables": TABLES,
       "consts": (LR, SGD_LR, MOMENTUM, STEPS, HIDDEN)}


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


def _jmodel(kind, kw):
    if kind == "dense":
        return jtf.Transformer(jtf.TransformerConfig.tiny(**kw))
    if kind == "moe":
        return jmoe.MoETransformer(jmoe.MoEConfig.tiny_moe(**kw))
    if kind == "resnet":
        return JResNet(JResNetConfig.tiny(**kw))
    return JMnistMLP(hidden=HIDDEN)


def _converters(kind, kw):
    """(from_flax, to_flax) of the kind's parameters."""
    if kind == "dense":
        return from_flax_params, to_flax_params
    if kind == "moe":
        return from_flax_moe_params, to_flax_moe_params
    if kind == "resnet":
        cfg = ResNetConfig.tiny(**kw)
        return (lambda p: from_flax_resnet_params(p, cfg),
                lambda sd: to_flax_resnet_params(sd, cfg))
    return from_flax_mlp_params, to_flax_mlp_params


def _case_inputs(name, seed):
    """(flax params, {key: STEPS batches}). The decoders' weights are the
    reference's init (with the default rules); the vision models' the
    port's seeded init carried to the flax tree; the MLP's labels a linear
    probe's."""
    kind, _, kw, _ = CASES[name]
    rng = np.random.default_rng(seed)
    if kind in ("dense", "moe"):
        tokens = rng.integers(0, 256, (STEPS, GB, SEQ)).astype(np.int32)
        with fnn.logical_axis_rules(list(DEFAULT)):
            params = _jmodel(kind, kw).init(jax.random.key(0),
                                            jnp.asarray(tokens[0]))
        return (jax.tree.map(np.asarray, fnn.meta.unbox(params)["params"]),
                {"tokens": tokens})
    to_flax = _converters(kind, kw)[1]
    if kind == "resnet":
        cfg = ResNetConfig.tiny(**kw)
        params = to_flax(ResNet(cfg, device="cpu").state_dict())
        x = rng.standard_normal((STEPS, VISION_GB, IMAGE, IMAGE, 3),
                                dtype=np.float32)
        y = rng.integers(0, cfg.num_classes, (STEPS, VISION_GB))
    else:
        params = to_flax(MnistMLP(HIDDEN, device="cpu").state_dict())
        x = rng.standard_normal((STEPS, VISION_GB, 28, 28, 1),
                                dtype=np.float32)
        w = rng.standard_normal((784, 10), dtype=np.float32)
        y = np.argmax(x.reshape(STEPS, VISION_GB, -1) @ w, axis=-1)
    return params, {"x": x, "y": y.astype(np.int32)}


def _reference(name, params0, data):
    """The reference's run under the case's table: (losses, params after
    each step, shard shapes)."""
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

    tx = optax.adamw(LR) if kind in ("dense", "moe") else \
        optax.sgd(SGD_LR, momentum=MOMENTUM)
    first = {k: jnp.asarray(v[0]) for k, v in data.items()}
    state, sh = init_sharded_state(model, first[key], tx, mesh, rules=rules)
    state = state.replace(params=jax.device_put(params0, sh.params))
    shapes = jax.tree.map(lambda x: x.sharding.shard_shape(x.shape),
                          state.params)
    step = jit_train_step(loss_fn, mesh, sh, first, rules=rules,
                          donate=False)
    losses, params = [], []
    with compat.set_mesh(mesh):
        for s in range(STEPS):
            state, m = step(state, {k: jnp.asarray(v[s])
                                    for k, v in data.items()},
                            jax.random.key(s))
            losses.append(float(m["loss"]))
            params.append(jax.tree.map(np.asarray, state.params))
    return losses, params, shapes


def _unsharded(name, params0, data):
    """The port's run of a decoder case on one process over the whole
    batch, no mesh: losses."""
    from tony_tpu_torch.parallel import adamw, train_step
    from tony_tpu_torch.parallel.train import TrainState

    _, _, kw, _ = CASES[name]
    model = ttf.Transformer(ttf.TransformerConfig.tiny(**kw), device="cpu")
    model.load_state_dict(from_flax_params(params0))

    def loss_fn(m, batch):
        tok = batch["tokens"]
        return ttf.causal_lm_loss(m(tok), tok), {}
    state = TrainState(model, adamw(model.parameters(), LR), loss_fn)
    return [train_step(state, {"tokens": torch.from_numpy(t).long()})
            ["loss"].item() for t in data["tokens"]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results, with the reference's runs (and the port's
    unsharded quantized run) computed in this process while the ranks
    train."""
    tmp = tmp_path_factory.mktemp("rules")
    inputs = {}
    for i, name in enumerate(CASES):
        params, data = inputs[name] = _case_inputs(name, i)
        kind, _, kw, _ = CASES[name]
        torch.save(_converters(kind, kw)[0](params), tmp / f"{name}_w.pt")
        np.savez(tmp / f"{name}_data.npz", **data)
    procs = _spawn(tmp)
    try:
        ref = {name: _reference(name, *inputs[name]) for name in CASES}
        one = {name: _unsharded(name, *inputs[name]) for name in QUANTIZED}
    finally:
        _wait(procs)
    return [torch.load(tmp / f"out{r}.pt") for r in range(4)], ref, one


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


@pytest.mark.parametrize("name", list(CASES))
def test_rules_step_matches_reference(runs, name):
    out, ref, _ = runs
    losses, params, _ = ref[name]
    kind, _, kw, _ = CASES[name]
    quantized = name in QUANTIZED
    for o in out:
        assert o[name]["step"] == STEPS
        got = o[name]["losses"]
        np.testing.assert_allclose(got[:1] if quantized else got,
                                   losses[:1] if quantized else losses,
                                   rtol=RTOL)
    to_flax = _converters(kind, kw)[1]
    checks = [("first_params", params[0])]
    if not quantized:
        checks.append(("params", params[-1]))
    for key, want_tree in checks:
        got = to_flax(out[0][name][key])
        for path, have, want in _leaves(got, want_tree):
            assert _rel(have, want) <= RTOL, (name, key, path)
    for o in out[1:]:
        for k, v in o[name]["params"].items():
            assert torch.equal(v, out[0][name]["params"][k]), (name, k)
    assert all(o["fallbacks"] == {} for o in out)


@pytest.mark.parametrize("name", QUANTIZED)
def test_rules_quantized_run_matches_unsharded(runs, name):
    out, _, one = runs
    for o in out:
        np.testing.assert_allclose(o[name]["losses"], one[name], rtol=RTOL)


@pytest.mark.parametrize("name", list(CASES))
def test_rules_local_shard_shapes_match_reference(runs, name):
    out, ref, _ = runs
    kind, _, kw, _ = CASES[name]
    to_flax = _converters(kind, kw)[1]
    for o in out:
        got = o[name]
        assert got["local_shapes"] == got["planned"]
        local = to_flax({k: torch.empty(s) for k, s in
                         got["local_shapes"].items()})
        for path, have, want in _leaves(local, ref[name][2]):
            assert tuple(have.shape) == tuple(want), (name, path)


def test_rules_layouts_are_the_tables(runs):
    """What each table changes, read off rank 0's parameters: T1's kv
    projections whole over tp, T2's projections, head and experts split on
    embed (none over fsdp), T3's table on its embed dim, T4's head rowwise
    over (fsdp, tp)."""
    out, _, _ = runs
    shapes = {name: out[0][name]["local_shapes"] for name in CASES}
    layout = {name: out[0][name]["layout"] for name in CASES}
    cfg = ttf.TransformerConfig.tiny()
    hd = cfg.dim // cfg.n_heads
    assert shapes["dense_T1"]["layers.0.attn.wk.weight"] == (
        cfg.n_kv_heads * hd, cfg.dim // 2)
    # (fsdp, tp): the embed dim over fsdp, the heads over tp.
    assert layout["dense_T1"]["layers.0.attn.wq.weight"] == \
        "(Shard(dim=1), Shard(dim=0))"
    assert shapes["dense_T2"]["layers.0.attn.wq.weight"] == (
        cfg.dim, cfg.dim // 2)
    assert layout["dense_T2"]["layers.0.attn.wo.weight"] == "(Shard(dim=0),)"
    assert layout["dense_T2"]["lm_head.weight"] == "(Shard(dim=1),)"
    assert layout["dense_T3"]["embedding"].startswith("(Shard(dim=0)") and \
        shapes["dense_T3"]["embedding"] == (cfg.vocab_size // 2, cfg.dim // 2)
    assert shapes["dense_T4"]["lm_head.weight"] == (cfg.vocab_size,
                                                    cfg.dim // 4)
    assert shapes["mlp_T2"]["dense.0.weight"] == (HIDDEN, 784 // 2)
    assert layout["resnet_T2"]["head.weight"] == "(Shard(dim=1),)"
    mcfg = tmoe.MoEConfig.tiny_moe()
    assert shapes["moe_T2"]["layers.0.moe.gate"] == (
        mcfg.n_experts // 2, mcfg.dim // 2, mcfg.mlp_dim)
    assert shapes["moe_T2"]["layers.0.moe.router.weight"] == (
        mcfg.n_experts, mcfg.dim // 2)
    assert shapes["moe_T1"]["layers.0.moe.gate"] == (
        mcfg.n_experts // 2, mcfg.dim, mcfg.mlp_dim // 2)


# ---------------------------------------------------------------------------
# (c) The pipeline, refusals, unreachable layouts
# ---------------------------------------------------------------------------
def test_pipeline_reads_the_default_rules():
    """``init_sharded_state(..., rules=T2)`` on the pipelined decoder
    (``layout=pipeline_shard``) lays it out as under the default table, as
    the reference's pipeline reads ``DEFAULT_RULES`` whatever its caller
    passes; the plain decoder under the same table is laid out otherwise."""
    from tony_tpu_torch.parallel import pipeline as tpipe
    from tony_tpu_torch.parallel.train import init_sharded_state

    cfg = ttf.TransformerConfig.tiny(n_layers=4)
    spec = tmesh.MeshSpec(pp=2, fsdp=2, tp=2)
    sizes = dict(zip(tmesh.MESH_AXES, spec.resolve(8).sizes()))

    def layouts():
        mesh = tmesh.build_mesh(spec, "cpu")
        out = []
        for rules in (DEFAULT, T2):
            _, placements = init_sharded_state(
                lambda d: tpipe.PipelineTransformer(cfg, d),
                lambda g: torch.optim.SGD(g, lr=LR), mesh, rules,
                layout=tpipe.pipeline_shard)
            out.append(placements)
        return out
    default, t2 = _on_fake_ranks(8, layouts)
    assert t2 == default
    assert default == {name: pl for name, pl in
                       tpipe.pipeline_param_placements(cfg, sizes).items()
                       if name in default}
    dense = ttf.Transformer(cfg, device="meta")
    assert tsh.param_placements(dense, sizes, T2) != \
        tsh.param_placements(dense, sizes)


def _on_fake_ranks(world, fn):
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        return fn()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kind,spec,rules,param,axis,ref_spec", [
    ("dense", dict(dp=2, tp=2), (("embed", "dp"),) + DEFAULT,
     "layers.0.attn.wq.weight", "dp=2", "PartitionSpec('dp', 'tp')"),
    ("ring", dict(sp=2, tp=2), (("norm", "sp"),) + DEFAULT,
     "layers.0.attn_norm.scale", "sp=2", "PartitionSpec('sp',)"),
    ("dense", dict(tp=2, dp=2), (("norm", "tp"),) + DEFAULT,
     "layers.0.attn_norm.scale", "tp=2", "PartitionSpec('tp',)"),
    ("moe", dict(ep=2, tp=2), (("embed", "ep"),) + DEFAULT,
     "embedding", "ep=2", "PartitionSpec('tp', 'ep')"),
    ("moe", dict(ep=2, tp=2), (("expert", "tp"),) + DEFAULT,
     "layers.0.moe.gate", "tp=2", "PartitionSpec('tp', 'fsdp', None)"),
], ids=["embed_dp", "norm_sp", "norm_tp", "embed_ep", "expert_tp"])
def test_unlayable_rules_refused(kind, spec, rules, param, axis, ref_spec):
    """The tables ``shard_model`` once refused (a dim on dp, sp, ep off the
    expert dim, tp on a norm or on the expert dim) are laid out: on four
    fake ranks every parameter's DTensor, the plan's or FSDP2's, sits on
    the mesh axes ``param_placements`` names, shard for shard (a flattened
    dim of FSDP2's mesh names its axes joined by ``+``), and the
    parameter these cases once named carries the reference's
    ``PartitionSpec`` (``_reference_spec``: its flax layout)."""
    def run():
        mesh = tmesh.build_mesh(tmesh.MeshSpec(**spec), "cpu")
        model = (tmoe.MoETransformer(tmoe.MoEConfig.tiny_moe(),
                                     device="meta") if kind == "moe" else
                 ttf.Transformer(ttf.TransformerConfig.tiny(
                     attn_impl="ring" if kind == "ring" else "flash"),
                     device="meta"))
        placements = tsh.shard_model(model, mesh, rules)
        sizes = tmesh.mesh_shape(mesh)
        for name, p in model.named_parameters():
            want = placements[name].dims
            carried = [[] for _ in want]
            if isinstance(p, DTensor):
                for dim, on in zip(p.device_mesh.mesh_dim_names,
                                   p.placements):
                    if hasattr(on, "dim"):       # Shard, _StridedShard
                        carried[on.dim] += dim.split("+")
            assert [sorted(c) for c in carried] == [sorted(w) for w in want],\
                (name, p.placements if isinstance(p, DTensor) else None)
            local = p.to_local() if isinstance(p, DTensor) else p
            assert tuple(local.shape) == placements[name].local_shape, name
        p = dict(model.named_parameters())[param]
        return (_reference_spec(p, param, placements[param].dims),
                f"{axis[:-2]}={sizes[axis[:-2]]}")
    got, size = _on_fake_ranks(4, run)
    assert got == ref_spec and size == axis


GSPMD_TABLES = {
    "G1": (("embed", "dp"),) + DEFAULT,
    "G2": (("embed", ("fsdp", "sp")),) + DEFAULT,
    "G3": (("norm", "tp"),) + DEFAULT,
    "G4": (("embed", ("dcn_dp", "fsdp")),) + DEFAULT,
    "G5": (("embed", "ep"),) + DEFAULT,
    "G6": (("expert", "tp"),) + DEFAULT,
    "G7": (("embed", ("fsdp", "sp", "ep")), ("norm", "tp")) + DEFAULT,
}
HSDP_CASES = [(kind, spec, table)
              for kind, spec, tables in (
                  ("dense", dict(dcn_dp=2, dp=2, fsdp=2, tp=2),
                   ("G1", "G3", "G4")),
                  ("ring", dict(dp=2, fsdp=2, sp=2, tp=2), ("G2", "G7")),
                  ("moe", dict(dp=2, fsdp=2, ep=2, tp=2),
                   ("G4", "G5", "G6", "G7")),
                  ("moe", dict(dcn_dp=2, dp=2, fsdp=2, sp=2), ("G2", "G7")))
              for table in tables]


@pytest.mark.parametrize("kind,spec,table", HSDP_CASES,
                         ids=[f"{k}_{t}_{'_'.join(s)}"
                              for k, s, t in HSDP_CASES])
def test_tables_lay_out_beside_hsdp(kind, spec, table):
    """On sixteen fake ranks, with dp > 1 and up to four axes of two ranks,
    each of ``tests/test_torch_rules_gspmd.py``'s tables lays the model
    out (FSDP2's flattened shard meshes joined to HSDP's dp and the plan's
    tp), every local shard of ``param_placements``' shape, and one SGD
    step runs (the fake group moves no bytes: what runs is the code)."""
    from tony_tpu_torch import trainer
    from tony_tpu_torch.parallel import (init_sharded_state, sgd,
                                         sharded_train_step)

    moe = kind == "moe"
    cfg = (tmoe.MoEConfig.tiny_moe(attn_impl="ring") if moe else
           ttf.TransformerConfig.tiny(
               attn_impl="ring" if kind == "ring" else "xla"))

    def run():
        mesh = tmesh.build_mesh(tmesh.MeshSpec(**spec), "cpu")
        state, placements = init_sharded_state(
            lambda d: (tmoe.MoETransformer if moe else ttf.Transformer)(
                cfg, device=d),
            lambda g: sgd(g, 0.1, momentum=0.9), mesh,
            rules=GSPMD_TABLES[table])
        for name, p in state.model.named_parameters():
            local = p.to_local() if isinstance(p, DTensor) else p
            assert tuple(local.shape) == placements[name].local_shape, name
        sharded_train_step(trainer.moe_loss if moe else trainer.lm_loss,
                           mesh, state,
                           {"tokens": torch.zeros((2, 16), dtype=torch.long)})
        return state.step
    assert _on_fake_ranks(16, run) == 1


def _reference_spec(p, name, dims):
    """``dims`` as the reference's ``PartitionSpec`` of the same parameter,
    in flax's layout (a projection's kernel ``[in, out]``, a conv's
    ``HWIO``; ``convert.py``)."""
    if name.endswith("weight") and p.dim() == 2:
        dims = dims[::-1]
    elif p.dim() == 4:
        dims = [dims[i] for i in (2, 3, 1, 0)]
    return "PartitionSpec%r" % (tuple(
        None if not a else a[0] if len(a) == 1 else a for a in dims),)


@pytest.mark.parametrize("kind,spec,knob", [
    ("dense", dict(pp=2, fsdp=2), "pp=2"),
    ("moe", dict(sp=2, ep=2), "sp=2 and ep=2"),
], ids=["pp_sequential", "moe_sp_ep"])
def test_refusals_that_stay(kind, spec, knob):
    """What ``shard_model`` still refuses under any table: pp > 1 on a
    sequential model (the pipelined decoder is ``pipeline_shard``'s) and
    the MoE decoder with sp and ep together (the reference fails to lower
    it), naming the knob."""
    def run():
        mesh = tmesh.build_mesh(tmesh.MeshSpec(**spec), "cpu")
        model = (tmoe.MoETransformer(tmoe.MoEConfig.tiny_moe(
            attn_impl="ring"), device="meta") if kind == "moe" else
                 ttf.Transformer(ttf.TransformerConfig.tiny(), device="meta"))
        for rules in (DEFAULT, T2, (("embed", ("fsdp", "sp", "ep")),)
                      + DEFAULT):
            with pytest.raises(NotImplementedError) as e:
                tsh.shard_model(model, mesh, rules)
            assert knob in str(e.value), str(e.value)
    _on_fake_ranks(4, run)


@pytest.mark.parametrize("rules,spec,param,held", [
    ((("mlp", "sp"), ("embed", "fsdp")) + DEFAULT, dict(fsdp=2, sp=2),
     "layers.0.mlp.gate.weight", ("fsdp", "sp")),
    ((("embed", ("sp", "fsdp")),) + DEFAULT, dict(fsdp=2, sp=2),
     "layers.0.attn.wq.weight", ("fsdp", "sp", "tp")),
], ids=["two_dims", "out_of_order"])
def test_layouts_fsdp2_cannot_hold(rules, spec, param, held):
    """A parameter with axes on two of its dims, or flattened out of the
    mesh's order (layouts FSDP2 cannot hold, once refused), is laid out:
    where those axes have two ranks each, held by ``hold_gathered`` as a
    DTensor on the submesh of its axes (in the mesh's order), a shard per
    mesh dim (``_StridedShard`` for fsdp, which the table lays minor to
    sp), its local shard of ``param_placements``' shape. Where they have
    one rank each beside dp=4, FSDP2 holds it as before (an axis of one
    rank lays nothing; the two-dims weight, no axis of which has two ranks,
    stays whole). On a world of one rank the table alone decides,
    and it is held as at scale."""
    def run(world):
        cases = ((spec, held), ({}, None)) if world > 1 else (({}, held),)
        for sizes, on in cases:
            mesh = tmesh.build_mesh(tmesh.MeshSpec(dp=-1, **sizes), "cpu")
            model = ttf.Transformer(ttf.TransformerConfig.tiny(
                attn_impl="ring"), device="meta")
            placements = tsh.shard_model(model, mesh, rules)
            p = dict(model.named_parameters())[param]
            owner, _, leaf = param.rpartition(".")
            gathered = getattr(model.get_submodule(owner), "_gathered", {})
            assert (leaf in gathered) == (on is not None), (world, sizes)
            local = p.to_local() if hasattr(p, "to_local") else p
            assert tuple(local.shape) == placements[param].local_shape, \
                (world, sizes)
            if on is None:
                continue
            assert p.device_mesh.mesh_dim_names == on, (world, sizes)
            assert all(hasattr(on, "dim") for on in p.placements)
            strided = [type(on).__name__ == "_StridedShard"
                       for on in p.placements]
            assert strided == [param.endswith("wq.weight") and
                               bool(sizes), False, False][:len(strided)]
    for world in (4, 1):
        _on_fake_ranks(world, lambda: run(world))


def test_dim_over_tp_must_divide():
    """Where a table puts the model's ``dim`` over tp, a tp that does not
    divide it is refused from the placements, in the reference's words
    (the knob checks of ``check_tensor_parallel`` cover the heads, the MLP
    width and the vocab)."""
    rules = tuple(r for r in T2 if r[0] != "vocab_table") + \
        (("vocab_table", "fsdp"),)
    cfg = ttf.TransformerConfig.tiny()
    tsh.check_tensor_parallel(cfg, 3, rules)

    def run():
        mesh = tmesh.build_mesh(tmesh.MeshSpec(tp=3, dp=1), "cpu")
        with pytest.raises(ValueError) as e:
            tsh.shard_model(ttf.Transformer(cfg, device="meta"), mesh,
                            rules)
        return str(e.value)
    msg = _on_fake_ranks(3, run)
    assert "sharded over tp" in msg, msg
    assert f"should be divisible by 3, but it is equal to {cfg.dim}" in msg


def test_reference_specs_in_refusals_are_flaxs():
    """The spec ``_reference_spec`` reports for a parameter (the layout
    cases above, once refusals) is flax's resolution of the reference's
    names, in the reference's layout, for each of those cases' tables."""
    abstract = jax.eval_shape(
        lambda k: jtf.Transformer(jtf.TransformerConfig.tiny()).init(
            k, jnp.zeros((1, 8), jnp.int32))["params"], jax.random.key(0))
    specs = fnn.get_partition_spec(abstract)
    model = ttf.Transformer(ttf.TransformerConfig.tiny(), device="meta")
    params = dict(model.named_parameters())
    for rules, param, names in (
            ((("embed", "dp"),) + DEFAULT, "layers.0.attn.wq.weight",
             specs["layer_0"]["attn"]["wq"]["kernel"]),
            ((("norm", "tp"),) + DEFAULT, "layers.0.attn_norm.scale",
             specs["layer_0"]["attn_norm"]["scale"])):
        dims = tsh.param_placements(
            model, dict.fromkeys(tmesh.MESH_AXES, 1), rules)[param].dims
        assert _reference_spec(params[param], param, dims) == str(
            fnn.logical_to_mesh_axes(tuple(names), rules=list(rules)))


def test_conv_names_reach_tp_only_on_out_channels(models):
    """The reference names a conv kernel's out dim alone; under every table
    the port's plan puts a conv over tp there or nowhere (the assertion in
    ``vision_tp_plan`` stands for the refusal no table reaches)."""
    model, ref = models["resnet"]
    convs = [n for n in ref if n.endswith("weight") and
             len(ref[n]) == 4]
    assert convs and all(ref[n] == ("mlp", None, None, None) for n in convs)
    for rules in ALL_TABLES:
        for n in convs:
            assert tsh.tp_dim(ref[n], rules) in (0, None)
        tsh.vision_tp_plan(model, rules)


def test_quantized_projections_are_colwise_or_rowwise():
    """Under every table the plan lays each quantized projection's weight
    ``Shard(0)`` or ``Shard(1)`` over tp, or leaves it whole: the other
    placements ``_quantized_on_plan`` refuses no table reaches."""
    cfg = ttf.TransformerConfig.tiny(matmul_dtype="int8", n_layers=1)
    seen = set()

    def run():
        mesh = tmesh.build_mesh(tmesh.MeshSpec(tp=2, dp=1), "cpu")
        for rules in ALL_TABLES:
            model = ttf.Transformer(cfg, device="meta")
            tsh.shard_model(model, mesh, rules)
            for name, mod in model.named_modules():
                w = mod.weight if isinstance(mod, ttf.Dense) else None
                if isinstance(w, DTensor) and \
                        "tp" in w.device_mesh.mesh_dim_names:
                    on_tp = w.placements[w.device_mesh.mesh_dim_names.index(
                        "tp")]
                    assert on_tp in (Shard(0), Shard(1)), name
                    seen.add(on_tp)
    _on_fake_ranks(2, run)
    assert seen == {Shard(0), Shard(1)}
