"""Port parity: every rules table of ``tests/test_torch_rules.py``
(``ALL_TABLES``: T1-T4, the default and 60 seeded random tables) on ten
meshes of four ranks, for the tiny decoder and the tiny MoE: 1,300 layouts.

Each layout is laid out by ``shard_model`` on the meta device, one rank of
torch's fake process group at a time (the fake group moves no bytes: what
runs is the layout code), and every parameter's local shard has the shape
of the reference's ``NamedSharding.shard_shape`` under the same table on a
mesh of the same shape (``param_shardings`` of its ``jax.eval_shape``
init: nothing is compiled). Ring attention where sp > 1. No layout of the
sweep is refused: the reference trains every one of them.

And the flagship at ``tp=8`` (4 kv heads) on eight fake ranks, against the
reference's shard shapes on eight devices.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.testing._internal.distributed.fake_pg import FakeStore

from test_torch_rules import ALL_TABLES, DEFAULT, TABLE_IDS, _leaves
from tony_tpu.models import moe as jmoe
from tony_tpu.models import transformer as jtf
from tony_tpu.parallel import MeshSpec, build_mesh
from tony_tpu.parallel.sharding import param_shardings
from tony_tpu_torch.convert import to_flax_moe_params, to_flax_params
from tony_tpu_torch.models import moe as tmoe
from tony_tpu_torch.models import transformer as ttf
from tony_tpu_torch.parallel import mesh as tmesh
from tony_tpu_torch.parallel import sharding as tsh

pytestmark = pytest.mark.timeout_s(600)

MESHES = {
    "fsdp_sp": dict(fsdp=2, sp=2), "fsdp_tp": dict(fsdp=2, tp=2),
    "ep_tp": dict(ep=2, tp=2), "dp_fsdp": dict(dp=2, fsdp=2),
    "dp_tp": dict(dp=2, tp=2), "sp_tp": dict(sp=2, tp=2),
    "ep_fsdp": dict(ep=2, fsdp=2), "dcn_dp_fsdp": dict(dcn_dp=2, fsdp=2),
    "fsdp4": dict(fsdp=4), "tp4": dict(tp=4),
}
WORLD = 4


def _kinds(ring):
    """kind → (the port's model on the meta device, a factory; the
    reference's model; the port's state dict → flax tree)."""
    impl = "ring" if ring else "flash"
    dense = ttf.TransformerConfig.tiny(attn_impl=impl)
    moe = tmoe.MoEConfig.tiny_moe(attn_impl=impl)
    return {
        "dense": (lambda: ttf.Transformer(dense, device="meta"),
                  jtf.Transformer(jtf.TransformerConfig.tiny()),
                  to_flax_params),
        "moe": (lambda: tmoe.MoETransformer(moe, device="meta"),
                jmoe.MoETransformer(jmoe.MoEConfig.tiny_moe()),
                to_flax_moe_params),
    }


@pytest.fixture(scope="module")
def abstract():
    """kind → the reference's boxed abstract params (names by the default
    table; ``param_shardings`` resolves them under each table)."""
    toks = jnp.zeros((1, 8), jnp.int32)
    out = {}
    for kind, (_, jmodel, _) in _kinds(False).items():
        with fnn.logical_axis_rules(list(DEFAULT)):
            out[kind] = jax.eval_shape(
                lambda k, m=jmodel: m.init(k, toks)["params"],
                jax.random.key(0))
    return out


@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_every_table_lays_out_as_the_reference(abstract, mesh_id):
    spec = MESHES[mesh_id]
    jmesh = build_mesh(MeshSpec(**{"dp": 1, **spec}),
                       devices=jax.devices()[:WORLD])
    kinds = _kinds(spec.get("sp", 1) > 1)
    want = {(kind, t): jax.tree.map(
        lambda x, s: s.shard_shape(x.shape), fnn.meta.unbox(abstract[kind]),
        param_shardings(jmesh, abstract[kind], rules))
        for kind in kinds for t, rules in zip(TABLE_IDS, ALL_TABLES)}
    failures = []
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=WORLD)
    try:
        mesh = tmesh.build_mesh(tmesh.MeshSpec(**{"dp": 1, **spec}), "cpu")
        for kind, (build, _, to_flax) in kinds.items():
            for t, rules in zip(TABLE_IDS, ALL_TABLES):
                model = build()
                try:
                    placements = tsh.shard_model(model, mesh, rules)
                except (NotImplementedError, ValueError) as e:
                    failures.append((kind, t, f"{type(e).__name__}: {e}"))
                    continue
                shapes = {}
                for name, p in model.named_parameters():
                    local = p.to_local() if isinstance(p, DTensor) else p
                    shapes[name] = tuple(local.shape)
                    assert shapes[name] == placements[name].local_shape, \
                        (kind, t, name)
                got = to_flax({k: torch.empty(s) for k, s in shapes.items()})
                for path, have, shape in _leaves(got, want[kind, t]):
                    assert tuple(have.shape) == tuple(shape), (kind, t, path)
    finally:
        dist.destroy_process_group()
    assert not failures, "\n".join(map(str, failures))


def test_flagship_at_tp8_lays_out_as_the_reference():
    """The flagship (``trainer.flagship_config``: 8 heads, 4 kv heads,
    head_dim 128) at ``MeshSpec(tp=8)`` under the default rules, on eight
    fake ranks: the attention keeps q on each rank's head and gathers k and
    v (``attention_split`` "q_heads"), and every local shard has the shape
    of the reference's ``shard_shape`` on eight devices (wk and wv split
    mid-head: 64 of a kv head's 128 columns on each rank, as GSPMD splits
    them)."""
    from tony_tpu_torch import trainer

    cfg = trainer.flagship_config()
    ref = jtf.Transformer(jtf.TransformerConfig(
        vocab_size=cfg.vocab_size, dim=cfg.dim, n_layers=cfg.n_layers,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, mlp_dim=cfg.mlp_dim,
        max_seq_len=cfg.max_seq_len))
    with fnn.logical_axis_rules(list(DEFAULT)):
        boxed = jax.eval_shape(lambda k: ref.init(
            k, jnp.zeros((1, 8), jnp.int32))["params"], jax.random.key(0))
    jmesh = build_mesh(MeshSpec(dp=1, tp=8), devices=jax.devices()[:8])
    want = jax.tree.map(lambda x, s: s.shard_shape(x.shape),
                        fnn.meta.unbox(boxed),
                        param_shardings(jmesh, boxed, DEFAULT))
    assert tsh.attention_split(cfg, 8) == "q_heads"
    dist.init_process_group("fake", store=FakeStore(), rank=3,
                            world_size=8)
    try:
        mesh = tmesh.build_mesh(tmesh.MeshSpec(dp=1, tp=8), "cpu")
        model = ttf.Transformer(cfg, device="meta")
        placements = tsh.shard_model(model, mesh)
        shapes = {name: tuple((p.to_local() if isinstance(p, DTensor)
                               else p).shape)
                  for name, p in model.named_parameters()}
        assert isinstance(model.layers[0].attn.wk.weight, DTensor)
        assert model.layers[0].attn.tp_group is not None
    finally:
        dist.destroy_process_group()
    assert shapes == {n: pl.local_shape for n, pl in placements.items()}
    assert shapes["layers.0.attn.wk.weight"] == (64, cfg.dim)
    got = to_flax_params({k: torch.empty(s) for k, s in shapes.items()})
    for path, have, shape in _leaves(got, want):
        assert tuple(have.shape) == tuple(shape), path
