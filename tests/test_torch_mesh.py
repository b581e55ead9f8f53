"""Port parity: tony_tpu_torch.parallel.{mesh,sharding} against
tony_tpu.parallel.{mesh,sharding}.

- ``MeshSpec``: ``from_string``, ``resolve`` and ``respec`` give the same
  specs, or the same error messages, on a table of strings;
- batch coordinates: on every rank of a mesh (built on torch's fake process
  group, one rank at a time, in this process), ``process_batch_slice(...,
  mesh=)`` is the row block the reference's ``batch_sharding`` gives the
  device at that rank's mesh position;
- ``param_placements``: the local shard shape of every parameter of the
  tiny decoder equals the reference's ``param_shardings(...).shard_shape``
  on the same mesh shape (through ``convert.py``: torch keeps [out, in]);
- the tensor-parallel plan, the knob checks and ``build_mesh``'s refusals.

The four-rank training runs are ``tests/test_torch_sharded_train.py``.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate
from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel
from torch.testing._internal.distributed.fake_pg import FakeStore

from tony_tpu.models import transformer as jtf
from tony_tpu.parallel import mesh as jmesh
from tony_tpu.parallel import sharding as jsh
from tony_tpu_torch.convert import to_flax_params
from tony_tpu_torch.data import process_batch_slice
from tony_tpu_torch.models import transformer as ttf
from tony_tpu_torch.parallel import mesh as tmesh
from tony_tpu_torch.parallel import sharding as tsh

SPEC_STRINGS = ["", "dp=2,tp=4", "fsdp=4,tp=2", "dcn_dp=2,fsdp=2,tp=2",
                "tp=-1", "dp=3", "fsdp=2,dp=-1,tp=2", "foo=2", "tp", "tp=x",
                "dp=-1,tp=-1", "dp=0", " fsdp = 2 ", "pp=2,ep=2,sp=2"]


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("ValueError", str(e).replace("tony_tpu.parallel",
                                             "tony_tpu_torch.parallel"))


def _sizes(spec):
    return None if spec is None else tuple(spec.sizes())


@pytest.mark.parametrize("text", SPEC_STRINGS)
def test_mesh_spec_matches_reference(text):
    ours = _outcome(lambda: tmesh.MeshSpec.from_string(text))
    ref = _outcome(lambda: jmesh.MeshSpec.from_string(text))
    assert ours[0] == ref[0]
    if ours[0] != "ok":
        assert ours[1] == ref[1]
        return
    assert _sizes(ours[1]) == _sizes(ref[1])
    for n in (1, 4, 8, 16):
        for method in ("resolve", "respec"):
            a = _outcome(lambda: _sizes(getattr(ours[1], method)(n)))
            b = _outcome(lambda: _sizes(getattr(ref[1], method)(n)))
            assert a[0] == b[0], (method, n)
            if a[0] == "ok":
                assert a[1] == b[1], (method, n)
            else:     # the messages print the spec, whose class is ours
                assert a[1].replace("MeshSpec", "") == \
                    b[1].replace("MeshSpec", ""), (method, n)


def test_axes_are_the_references():
    assert tmesh.MESH_AXES == jmesh.MESH_AXES
    assert tmesh.BATCH_AXES == jmesh.BATCH_AXES
    assert tsh.DEFAULT_RULES == jsh.DEFAULT_RULES


def _on_fake_ranks(world, fn):
    """``fn(rank)`` on each rank of a fake process group of ``world``
    ranks, one at a time in this process."""
    out = []
    for r in range(world):
        dist.init_process_group("fake", store=FakeStore(), rank=r,
                                world_size=world)
        try:
            out.append(fn(r))
        finally:
            dist.destroy_process_group()
    return out


@pytest.mark.parametrize("spec", [
    dict(dp=8), dict(fsdp=2, tp=4), dict(dp=2, fsdp=2, tp=2),
    dict(dcn_dp=2, tp=2, dp=2), dict(dcn_dp=2, fsdp=2, sp=2),
    dict(dp=2, pp=2, ep=2)], ids=str)
def test_batch_rows_match_reference(spec):
    gb, seq = 16, 4
    devices = jax.devices()[:8]
    ref_mesh = jmesh.build_mesh(jmesh.MeshSpec(**spec), devices=devices)
    index = jmesh.batch_sharding(ref_mesh).devices_indices_map((gb, seq))
    position = {d: tuple(int(i) for i in np.argwhere(
        ref_mesh.devices == d)[0]) for d in devices}

    def ours(rank):
        m = tmesh.build_mesh(tmesh.MeshSpec(**spec), "cpu")
        return (m.get_coordinate(), process_batch_slice(gb, mesh=m),
                tmesh.batch_world(m))

    got = _on_fake_ranks(8, ours)
    for d in devices:
        coord, rows, world = got[d.id]
        assert tuple(coord) == position[d]
        assert world == 8 // (spec.get("tp", 1) * spec.get("sp", 1)
                              * spec.get("pp", 1) * spec.get("ep", 1))
        want = index[d][0]
        assert (rows.start, rows.stop) == (want.start or 0, want.stop or gb)


@pytest.fixture(scope="module")
def flax_abstract():
    cfg = jtf.TransformerConfig.tiny()
    return jax.eval_shape(
        lambda k: jtf.Transformer(cfg).init(
            k, jnp.zeros((1, 8), jnp.int32))["params"],
        jax.random.key(0))


@pytest.mark.parametrize("spec", [
    dict(fsdp=2, tp=2), dict(dp=2, fsdp=2), dict(dcn_dp=2, tp=2),
    dict(fsdp=4, tp=2), dict(fsdp=8), dict(tp=4, dp=2)], ids=str)
def test_param_placements_shard_shapes_match_reference(flax_abstract,
                                                       spec):
    n = int(np.prod(list(spec.values())))
    ref_mesh = jmesh.build_mesh(jmesh.MeshSpec(**spec),
                                devices=jax.devices()[:n])
    shardings = jsh.param_shardings(ref_mesh, flax_abstract)
    want = jax.tree.map(lambda x, s: s.shard_shape(x.shape),
                        fnn.meta.unbox(flax_abstract), shardings)
    model = ttf.Transformer(ttf.TransformerConfig.tiny(), device="meta")
    sizes = dict(zip(tmesh.MESH_AXES,
                     tmesh.MeshSpec(**spec).resolve(n).sizes()))
    placed = tsh.param_placements(model, sizes)
    got = to_flax_params({k: torch.empty(pl.local_shape)
                          for k, pl in placed.items()})
    for path, shape in jax.tree_util.tree_leaves_with_path(
            want, is_leaf=lambda x: isinstance(x, tuple)):
        leaf = got
        for key in path:
            leaf = leaf[key.key]
        assert tuple(leaf.shape) == tuple(shape), jax.tree_util.keystr(path)


def test_placements_name_the_references_axes():
    model = ttf.Transformer(ttf.TransformerConfig.tiny(), device="meta")
    dims = {k: pl.dims for k, pl in tsh.param_placements(
        model, dict.fromkeys(tmesh.MESH_AXES, 1)).items()}
    assert dims["embedding"] == (("tp", "fsdp"), ())
    assert dims["layers.0.attn.wq.weight"] == (("tp",), ("fsdp",))
    assert dims["layers.1.attn.wo.weight"] == (("fsdp",), ("tp",))
    assert dims["layers.0.mlp.down.weight"] == (("fsdp",), ("tp",))
    assert dims["lm_head.weight"] == (("tp",), ("fsdp",))
    assert dims["final_norm.scale"] == ((),)


def test_tp_plan_follows_the_rules():
    cfg = ttf.TransformerConfig.tiny(n_layers=1)
    plan = tsh.tp_plan(cfg, 2)
    assert set(plan) == {"", "lm_head"} | {
        f"layers.0.{m}" for m in ("attn.wq", "attn.wk", "attn.wv",
                                  "attn.wo", "mlp.gate", "mlp.up",
                                  "mlp.down")}
    assert isinstance(plan[""], tsh.VocabParallelTable)
    for m in ("attn.wq", "attn.wk", "attn.wv", "mlp.gate", "mlp.up"):
        assert type(plan[f"layers.0.{m}"]) is ColwiseParallel
    for m in ("attn.wo", "mlp.down"):
        assert type(plan[f"layers.0.{m}"]) is RowwiseParallel
    assert plan["lm_head"].output_layouts == (Replicate(),)
    # Rules without tp give no plan at all.
    no_tp = tuple((k, None if v == "tp" else v) for k, v in
                  tsh.DEFAULT_RULES if k != "vocab_table")
    assert tsh.tp_plan(cfg, 1, no_tp + (("vocab_table", "fsdp"),)) == {}
    # The projections are nn.Linear, which the parallel styles take.
    assert isinstance(ttf.Transformer(cfg, device="meta").layers[0].attn.wq,
                      torch.nn.Linear)


# The ids the cases had when tp wider than the kv heads was refused: the
# two n_kv_heads cases now check that the plan takes those layouts.
@pytest.mark.parametrize("kw,tp,err,match", [
    (dict(n_kv_heads=2), 4, "laid", "n_kv_heads"),
    (dict(n_heads=4, n_kv_heads=1), 2, "laid", "n_kv_heads"),
    (dict(mlp_dim=129), 2, ValueError, "mlp_dim"),
    (dict(vocab_size=255), 2, ValueError, "vocab_size"),
    (dict(tie_embeddings=True), 1, None, "tie_embeddings"),
    (dict(matmul_dtype="int8"), 2, None, "matmul_dtype"),
], ids=["kw0-4-ValueError-n_kv_heads", "kw1-2-ValueError-n_kv_heads",
        "kw2-2-ValueError-mlp_dim", "kw3-2-ValueError-vocab_size",
        "kw4-1-None-tie_embeddings", "kw5-2-None-matmul_dtype"])
def test_tp_knob_checks_name_the_knob(kw, tp, err, match):
    """Widths that tp does not divide raise, naming the knob; a tied head
    and quantized projections take the plan (``err`` None): the tied one
    without an ``lm_head`` entry (it reads the vocab-sharded table), the
    quantized one with the bf16 plan's styles. A tp wider than the kv
    heads (``"laid"``: 2 kv heads at tp = 4, MQA at tp = 2) keeps q on each
    rank's heads and gathers k and v (``KvGathered``), and ``shard_model``
    lays the decoder out on that many fake ranks, each q projection
    ``n_heads / tp`` heads wide, k and v whole heads' columns split over
    tp as the reference splits them."""
    cfg = ttf.TransformerConfig.tiny(**kw)
    if err == "laid":
        plan = tsh.tp_plan(cfg, tp)
        assert tsh.attention_split(cfg, tp) == "q_heads"
        assert type(plan["layers.0.attn.wq"]) is ColwiseParallel
        assert type(plan["layers.0.attn.wo"]) is RowwiseParallel
        for m in ("wk", "wv"):
            assert type(plan[f"layers.0.attn.{m}"]) is tsh.KvGathered

        def run():
            mesh = tmesh.build_mesh(tmesh.MeshSpec(tp=tp, dp=1), "cpu")
            model = ttf.Transformer(cfg, device="meta")
            tsh.shard_model(model, mesh)
            attn = model.layers[0].attn
            return (attn.wq.weight.to_local().shape[0],
                    attn.wk.weight.to_local().shape[0])
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=tp)
        try:
            hd = cfg.dim // cfg.n_heads
            assert run() == (cfg.n_heads * hd // tp,
                             cfg.n_kv_heads * hd // tp)
        finally:
            dist.destroy_process_group()
        return
    if err is not None:
        with pytest.raises(err, match=match):
            tsh.tp_plan(cfg, tp)
        return
    plan = tsh.tp_plan(cfg, tp)
    want = tsh.tp_plan(ttf.TransformerConfig.tiny(), tp)
    if cfg.tie_embeddings:
        del want["lm_head"]
    assert {k: type(v) for k, v in plan.items()} == \
        {k: type(v) for k, v in want.items()}


def test_build_mesh_refuses_without_group_or_card():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.build_mesh(tmesh.MeshSpec(), "cpu")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="CUDA|NCCL"):
            tmesh.build_mesh(tmesh.MeshSpec(), "cuda")
        with pytest.raises(ValueError, match="wants 2 devices"):
            tmesh.build_mesh(tmesh.MeshSpec(tp=2, dp=1), "cpu")
        m = tmesh.build_mesh(tmesh.MeshSpec(), "cpu")
        assert tmesh.mesh_shape(m) == dict.fromkeys(tmesh.MESH_AXES, 1)
    finally:
        dist.destroy_process_group()


def test_sharding_later_axes_refused():
    """pp > 1 (the pipeline slice) raises, naming the knob; the MoE decoder
    under tp > 1 takes the attention's styles and its stacked experts'
    ``mlp`` dim over tp."""
    from torch.distributed.tensor import Shard

    from tony_tpu_torch.models.moe import MoEConfig, MoETransformer

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=2)
    try:
        m = tmesh.build_mesh(tmesh.MeshSpec(pp=2, dp=1), "cpu")
        with pytest.raises(NotImplementedError, match="pp"):
            tsh.shard_model(ttf.Transformer(ttf.TransformerConfig.tiny(),
                                            device="meta"), m)
        m = tmesh.build_mesh(tmesh.MeshSpec(tp=2, dp=1), "cpu")
        cfg = MoEConfig.tiny_moe()
        moe = MoETransformer(cfg, device="meta")
        placed = tsh.shard_model(moe, m)
        block = moe.layers[0]
        assert block.attn.wq.weight.to_local().shape[0] == cfg.dim // 2
        assert block.moe.gate.placements[-1] == Shard(2)
        assert block.moe.down.placements[-1] == Shard(1)
        assert placed["layers.0.moe.up"].local_shape == (
            cfg.n_experts, cfg.dim, cfg.mlp_dim // 2)
        assert block.moe.tp_group is not None
    finally:
        dist.destroy_process_group()


def _measure(cfg, **kw):
    from tony_tpu_torch import trainer

    return trainer.measure(cfg, batch=2, seq=32, steps=3, warmup=1,
                           device="cpu", **kw)


@pytest.mark.parametrize("kw", [
    {}, dict(chunked=True, loss_chunk=8), dict(mu_dtype=torch.bfloat16),
    dict(cfg=dict(matmul_dtype="int8")),
    dict(cfg=dict(matmul_dtype="fp8_e4m3")),
    dict(cfg=dict(tie_embeddings=True)),
    dict(cfg=dict(tie_embeddings=True), chunked=True, loss_chunk=8)],
    ids=["adamw", "chunked", "bf16_mu", "int8", "fp8", "tied",
         "tied_chunked"])
def test_world1_mesh_trains_as_unsharded(kw):
    """``measure(mesh="fsdp=1")`` with no group up: a one-rank gloo group
    for the call, the tensor-parallel plan and FSDP2 on a mesh of ones, and
    the same losses as the unsharded run, bit for bit (AdamW, the chunked
    loss inside the forward, AdamW with a bf16 first moment; the int8 and
    fp8 projections and the tied head, its chunked loss too, under the
    plan)."""
    kw = dict(kw)
    cfg = ttf.TransformerConfig.tiny(max_seq_len=32, **kw.pop("cfg", {}))
    plain = _measure(cfg, **kw)
    sharded = _measure(cfg, mesh="fsdp=1", **kw)
    assert not dist.is_initialized()
    assert sharded["mesh"] == dict.fromkeys(tmesh.MESH_AXES, 1)
    assert plain["mesh"] is None
    assert sharded["losses"] == plain["losses"]
    assert sharded["params"] == plain["params"]


def test_world1_mesh_fills_missing_grads_and_sgd():
    """A loss that never reaches the head: ``fill_missing_grads`` gives the
    sharded (DTensor) head zeros, AdamW decays it as on one device; SGD
    over the sharded ResNet steps as the unsharded one."""
    from tony_tpu_torch import trainer
    from tony_tpu_torch.models import ResNet, ResNetConfig
    from tony_tpu_torch.parallel import (adamw, init_sharded_state, sgd,
                                         sharded_train_step, train_step)
    from tony_tpu_torch.parallel.train import TrainState

    cfg = ttf.TransformerConfig.tiny(max_seq_len=16)
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 16)))

    def hidden_loss(m, batch):
        return m(batch["tokens"], return_hidden=True).square().mean(), {}

    plain = ttf.Transformer(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    ps = TrainState(plain, adamw(plain.parameters(), 1e-2), hidden_loss)
    rcfg = ResNetConfig.tiny(num_classes=1000)
    rplain = ResNet(rcfg, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    rs = TrainState(rplain, sgd(rplain.parameters(), 0.1, momentum=0.9),
                    trainer.vision_loss)
    batch = trainer.vision_batch("resnet50", 0, 2, image=32, device="cpu")
    batch["images"] = batch["images"].float()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = tmesh.build_mesh(tmesh.MeshSpec(), "cpu")
        state, _ = init_sharded_state(
            lambda d: ttf.Transformer(cfg, device=d),
            lambda g: adamw(g, 1e-2), mesh)
        rstate, _ = init_sharded_state(
            lambda d: ResNet(rcfg, device=d),
            lambda g: sgd(g, 0.1, momentum=0.9), mesh)
        for _ in range(2):
            a = sharded_train_step(hidden_loss, mesh, state,
                                   {"tokens": tok})[1]["loss"]
            assert torch.equal(a, train_step(ps, {"tokens": tok})["loss"])
            b = sharded_train_step(trainer.vision_loss, mesh, rstate,
                                   batch)[1]["loss"]
            assert torch.equal(b, train_step(rs, batch)["loss"])
        head = state.model.lm_head.weight
        assert head.grad is None and type(head).__name__ == "DTensor"
        assert torch.equal(head.full_tensor(), plain.lm_head.weight)
        assert not torch.equal(head.full_tensor(), ttf.Transformer(
            cfg, device="cpu").lm_head.weight)       # decayed
        for (n, p), q in zip(rstate.model.named_parameters(),
                             rplain.parameters()):
            full = p.full_tensor() if hasattr(p, "full_tensor") else p
            assert torch.equal(full, q), n
    finally:
        dist.destroy_process_group()


def test_train_on_a_mesh_saves_and_resumes(tmp_path):
    """``trainer.train(mesh="fsdp=1")``: every rank saves its shards with
    the mesh in the manifest, and a resume equals an uninterrupted run."""
    from tony_tpu_torch import trainer
    from tony_tpu_torch.checkpoint import CheckpointManager

    cfg = ttf.TransformerConfig.tiny(max_seq_len=32)
    corpus = trainer.write_corpus(str(tmp_path / "c.bin"), cfg.vocab_size)
    kw = dict(batch=4, seq=32, device="cpu", seed=0, mesh="fsdp=1")
    full = trainer.train(cfg, corpus, steps=5, **kw)
    ckpt = str(tmp_path / "ckpt")
    first = trainer.train(cfg, corpus, steps=3, ckpt_dir=ckpt,
                          save_interval=2, **kw)
    resumed = trainer.train(cfg, corpus, steps=5, ckpt_dir=ckpt,
                            save_interval=2, **kw)
    assert first["losses"] + resumed["losses"] == full["losses"]
    assert resumed["restored_step"] == 2 and resumed["start_step"] == 3
    assert full["mesh"] == dict.fromkeys(tmesh.MESH_AXES, 1)
    mgr = CheckpointManager(ckpt)
    assert mgr.saved_mesh_shape(4) == full["mesh"]
    assert mgr.saved_world_size(4) == 1 and mgr.verify_step(4)
    mgr.close()


def test_cli_mesh_flag(monkeypatch):
    from tony_tpu_torch import trainer

    seen, vision = {}, {}

    def fake_measure(cfg, **kw):
        seen.update(kw)
        return {}

    def fake_vision(kind, **kw):
        vision.update(kw, kind=kind)
        return {}
    monkeypatch.setattr(trainer, "measure", fake_measure)
    monkeypatch.setattr(trainer, "measure_vision", fake_vision)
    assert trainer.main(["--mesh", "fsdp=2,tp=2", "--device", "cpu"]) == 0
    assert seen["mesh"] == "fsdp=2,tp=2"
    # The vision models take a mesh too; the decoders' knobs stay theirs.
    assert trainer.main(["--model", "mnist", "--mesh", "fsdp=1",
                         "--device", "cpu"]) == 0
    assert vision["kind"] == "mnist" and vision["mesh"] == "fsdp=1"
    with pytest.raises(SystemExit):
        trainer.main(["--model", "mnist", "--attn-impl", "ring"])


def test_mesh_shape_key_is_the_references():
    from tony_tpu.conf import keys as jkeys
    from tony_tpu_torch.conf import keys as tkeys

    assert tkeys.TPU_MESH_SHAPE == jkeys.TPU_MESH_SHAPE
    a = tkeys._REGISTRY[tkeys.TPU_MESH_SHAPE]
    b = jkeys._REGISTRY[jkeys.TPU_MESH_SHAPE]
    assert (a.default, a.type) == (b.default, b.type)
