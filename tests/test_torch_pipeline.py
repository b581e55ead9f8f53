"""Port parity: GPipe over the mesh's ``pp`` axis
(``tony_tpu_torch/parallel/pipeline.py``, ``convert.py``'s pipeline pair)
against ``tony_tpu/parallel/pipeline.py``.

In this process: the converters' round trip (the reference's stacked tree
→ port → tree, bit for bit, whole and one stage's); the one-stage pipeline
off any mesh against the port's sequential ``Transformer`` on the same
weights; the placements without a mesh.

On eight gloo ranks (one spawn for the file: ``FileStore`` rendezvous in
``tmp_path``, each rank waited for under a timeout, so that a hang fails),
against the reference on the conftest's eight virtual devices, on weights
the reference's ``init_pipeline_params`` made and ``convert.py`` carried
over (the reference's ``tests/test_pipeline.py`` cases):

- (dp=2, pp=4), 4 layers, M=2, tokens (4, 32): each rank holds exactly its
  stage's layers; a sharded init's values are the one-rank build's; the
  logits against the reference's ``pipeline_forward`` and against its
  sequential ``Transformer``; the loss and every gradient (gathered)
  against ``jax.grad`` of ``pipeline_loss``; the embedding gradient equal
  on every pp rank;
- M=1 against M=4 on (8, 16);
- five Adam(3e-3) steps: the losses within 1e-4 of ``optax.adam``'s, the
  last lower than the first;
- ``n_layers % pp`` raises "divisible", in both packages;
- (pp=2, fsdp=2, tp=2): no parameter whole on any rank, the logits against
  the sequential oracle, a finite loss and every gradient laid out as its
  parameter.

Tolerances are the reference's 2e-4 (logits and loss absolute and
relative; each gradient by relative Frobenius error, since many of its
elements are far below 2e-4) unless a case says otherwise.
"""

import functools
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

from tony_tpu.models import transformer as jtf
from tony_tpu.parallel import MeshSpec, build_mesh
from tony_tpu.parallel import pipeline as jpp
from tony_tpu.parallel.sharding import DEFAULT_RULES as JRULES
from tony_tpu_torch.convert import (from_flax_params,
                                    from_flax_pipeline_params,
                                    to_flax_pipeline_params)
from tony_tpu_torch.models import transformer as ttf
from tony_tpu_torch.parallel import pipeline as tpp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL, ADAM_TOL, LR, STEPS = 2e-4, 1e-4, 3e-3, 5
WORLD, N_LAYERS = 8, 4
RANK_TIMEOUT_S = 300
torch.set_num_threads(2)
# The fixture runs the reference's jitted pipeline while eight gloo ranks
# run theirs.
pytestmark = pytest.mark.timeout_s(600)

_RANK_SCRIPT = r"""
import os, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor
torch.set_num_threads(1)
from tony_tpu_torch.models.transformer import TransformerConfig
from tony_tpu_torch.parallel import (MeshSpec, batch_rank, batch_world,
                                     build_mesh, init_sharded_state)
from tony_tpu_torch.parallel.grad_sync import (DEFAULT_BUCKET_MB,
                                               accumulate_grads, batch_mean,
                                               _mesh_sync)
from tony_tpu_torch.parallel.pipeline import (PipelineTransformer,
                                              pipeline_forward,
                                              pipeline_loss,
                                              pipeline_shard,
                                              pipeline_train_step)

rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group(
    "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
    rank=rank, world_size=world)
LR, STEPS, N_LAYERS = %(lr)r, %(steps)r, %(n_layers)r
cfg = TransformerConfig.tiny(n_layers=N_LAYERS)
weights = torch.load(os.path.join(tmp, "w.pt"))
tok = {k: torch.from_numpy(v).long()
       for k, v in np.load(os.path.join(tmp, "tokens.npz")).items()}
out = {}


def whole(x):
    x = x.full_tensor() if isinstance(x, DTensor) else x
    return x.detach().numpy().copy()


def build(spec, seed=0):
    mesh = build_mesh(MeshSpec(**spec), "cpu")
    state, placements = init_sharded_state(
        lambda d: PipelineTransformer(cfg, d),
        # optax.adam's defaults (eps outside the square root, as optax)
        lambda groups: torch.optim.Adam(groups, lr=LR), mesh, seed=seed,
        layout=pipeline_shard)
    return mesh, state, placements


def load(model, sd):
    with torch.no_grad():
        for name, p in model.named_parameters():
            w = sd[name]
            if isinstance(p, DTensor):
                w = distribute_tensor(w, p.device_mesh, p.placements,
                                      src_data_rank=None).to_local()
                p = p.to_local()
            p.copy_(w)


def rows(mesh, t):
    n = t.shape[0] // batch_world(mesh)
    b = batch_rank(mesh)
    return t[b * n:(b + 1) * n]


def grads_of(state, mesh, tokens, m):
    state.loss_fn = lambda model, batch: (
        pipeline_loss(model, batch["tokens"], m), {})
    grads, loss, _ = accumulate_grads(state, {"tokens": tokens}, 1)
    _mesh_sync(grads, DEFAULT_BUCKET_MB, mesh,
               reduced=state.model.reduced_by_fsdp)
    return grads, batch_mean(loss, mesh)


# (dp=2, pp=4)
mesh, state, placements = build(dict(dp=2, pp=4))
model = state.model
out["coord"] = dict(pp=mesh.get_local_rank("pp"), dp=mesh.get_local_rank("dp"))
out["layers"] = sorted(int(k) for k in model.layers)
out["init"] = {k: whole(p) for k, p in model.named_parameters()}
load(model, weights)
with torch.no_grad():
    out["logits"] = pipeline_forward(model, rows(mesh, tok["a"]), 2).numpy()
    out["mb1"] = pipeline_forward(model, rows(mesh, tok["b"]), 1).numpy()
    out["mb4"] = pipeline_forward(model, rows(mesh, tok["b"]), 4).numpy()
grads, loss = grads_of(state, mesh, rows(mesh, tok["a"]), 2)
out["loss"] = loss.item()
out["grads"] = {k: whole(g) for k, g in grads.items()}
state.optimizer.zero_grad(set_to_none=True)
losses = []
for _ in range(STEPS):
    state, m = pipeline_train_step(mesh, state,
                                   {"tokens": rows(mesh, tok["b"])}, 2)
    losses.append(m["loss"].item())
out["adam"] = losses
try:
    pipeline_shard(PipelineTransformer(TransformerConfig.tiny(n_layers=3),
                                       "meta"), mesh)
    out["indivisible"] = None
except ValueError as e:
    out["indivisible"] = str(e)
del state, model

# (pp=2, fsdp=2, tp=2)
mesh, state, placements = build(dict(dp=1, pp=2, fsdp=2, tp=2))
model = state.model
load(model, weights)
out["ft_layers"] = sorted(int(k) for k in model.layers)
out["ft_pp"] = mesh.get_local_rank("pp")
out["ft_shapes"] = {k: (tuple(p.shape), tuple(p.to_local().shape)
                        if isinstance(p, DTensor) else tuple(p.shape))
                    for k, p in model.named_parameters()}
out["ft_planned"] = {k: pl.local_shape for k, pl in placements.items()}
with torch.no_grad():
    out["ft_logits"] = pipeline_forward(model, rows(mesh, tok["a"]),
                                        2).numpy()
grads, loss = grads_of(state, mesh, rows(mesh, tok["a"]), 2)
out["ft_loss"] = loss.item()
out["ft_layout"] = {
    k: (str(getattr(p, "placements", None)),
        str(getattr(grads[k], "placements", None)),
        tuple((p.to_local() if isinstance(p, DTensor) else p).shape),
        tuple((grads[k].to_local() if isinstance(grads[k], DTensor)
               else grads[k]).shape))
    for k, p in model.named_parameters()}
out["ft_grads_finite"] = all(
    bool(torch.isfinite(g.to_local() if isinstance(g, DTensor) else g).all())
    for g in grads.values())

torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
dist.barrier()
dist.destroy_process_group()
""" % {"lr": LR, "steps": STEPS, "n_layers": N_LAYERS}


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


def _plain_params(params):
    """The stacked pipeline tree as the sequential Transformer's tree (the
    reference's own test's ``_plain_params_from_pipeline``)."""
    plain = {"embedding": params["embedding"],
             "final_norm": {"scale": params["final_norm"]},
             "lm_head": {"kernel": params["lm_head"]}}
    for i in range(N_LAYERS):
        plain[f"layer_{i}"] = jax.tree.map(lambda a, i=i: a[i],
                                           params["blocks"])
    return plain


def _reference(params, tokens):
    """The reference on (dp=2, pp=4) of the eight virtual devices."""
    cfg = jtf.TransformerConfig.tiny(n_layers=N_LAYERS)
    mesh = build_mesh(MeshSpec(dp=2, pp=4))
    ta, tb = jnp.asarray(tokens["a"]), jnp.asarray(tokens["b"])
    ref = {}
    ref["logits"] = np.asarray(jax.jit(lambda p, t: jpp.pipeline_forward(
        cfg, mesh, p, t, num_microbatches=2))(params, ta))
    with fnn.logical_axis_rules(list(JRULES)):
        ref["oracle"] = np.asarray(jtf.Transformer(cfg).apply(
            {"params": _plain_params(params)}, ta))
    ref["mb4"] = np.asarray(jax.jit(lambda p, t: jpp.pipeline_forward(
        cfg, mesh, p, t, 4))(params, tb))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jpp.pipeline_loss(cfg, mesh, p, ta, 2)))(params)
    ref["loss"] = float(loss)
    ref["grads"] = jax.tree.map(np.asarray, grads)
    tx = optax.adam(LR)

    @jax.jit
    def step(p, opt, t):
        loss, g = jax.value_and_grad(
            lambda p: jpp.pipeline_loss(cfg, mesh, p, t, 2))(p)
        upd, opt = tx.update(g, opt, p)
        return optax.apply_updates(p, upd), opt, loss

    p, opt, losses = params, tx.init(params), []
    for _ in range(STEPS):
        p, opt, loss = step(p, opt, tb)
        losses.append(float(loss))
    ref["adam"] = losses
    try:
        jpp.pipeline_forward(jtf.TransformerConfig.tiny(n_layers=3), mesh,
                             params, jnp.zeros((4, 16), jnp.int32), 2)
        ref["indivisible"] = None
    except ValueError as e:
        ref["indivisible"] = str(e)
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The eight ranks' results, with the reference's computed in this
    process while the ranks run."""
    tmp = tmp_path_factory.mktemp("pipeline")
    params = jax.tree.map(np.asarray, jpp.init_pipeline_params(
        jtf.TransformerConfig.tiny(n_layers=N_LAYERS), jax.random.key(0)))
    rng = np.random.default_rng(1)
    tokens = {"a": rng.integers(0, 256, (4, 32)).astype(np.int32),
              "b": rng.integers(0, 256, (8, 16)).astype(np.int32)}
    torch.save(from_flax_pipeline_params(params), tmp / "w.pt")
    np.savez(tmp / "tokens.npz", **tokens)
    procs = _spawn(tmp)
    try:
        ref = _reference(params, tokens)
    finally:
        _wait(procs)
    outs = [torch.load(tmp / f"out{r}.pt", weights_only=False)
            for r in range(WORLD)]
    return outs, ref, params, tokens


def _rel(have, want):
    want = np.asarray(want, np.float64)
    return np.linalg.norm(np.asarray(have, np.float64) - want) / \
        np.linalg.norm(want)


def _by_dp(outs, key):
    """``key`` of every rank, joined in batch order (dp major): each dp
    coordinate's rows once (its pp ranks must all agree)."""
    parts = {}
    for o in outs:
        dp = o["coord"]["dp"]
        if dp in parts:
            np.testing.assert_array_equal(o[key], parts[dp])
        parts[dp] = o[key]
    return np.concatenate([parts[d] for d in sorted(parts)])


def _port_grads(outs):
    """Every parameter's gathered gradient: each block's from a rank of its
    stage, the head's from rank 0."""
    merged = {}
    for o in outs:
        for k, g in o["grads"].items():
            merged.setdefault(k, g)
    return to_flax_pipeline_params({k: torch.from_numpy(g)
                                    for k, g in merged.items()})


# ---------------------------------------------------------------------------
# One process
# ---------------------------------------------------------------------------
def _tiny_params(n_layers=N_LAYERS):
    return jax.tree.map(np.asarray, jpp.init_pipeline_params(
        jtf.TransformerConfig.tiny(n_layers=n_layers), jax.random.key(0)))


def test_convert_round_trip_bit_for_bit():
    params = _tiny_params()
    back = to_flax_pipeline_params(from_flax_pipeline_params(params))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("stage", [0, 1])
def test_convert_one_stage(stage):
    """A pp rank's slice: its layers (global names) and the head; the
    tree side stacks only that stage's L/S layers."""
    params = _tiny_params()
    sd = from_flax_pipeline_params(params, stage=stage, n_stages=2)
    layers = sorted({int(k.split(".")[1]) for k in sd if
                     k.startswith("layers.")})
    assert layers == [2 * stage, 2 * stage + 1]
    tree = to_flax_pipeline_params(from_flax_pipeline_params(params),
                                   stage=stage, n_stages=2)
    for a, b in zip(jax.tree.leaves(params["blocks"]),
                    jax.tree.leaves(tree["blocks"])):
        np.testing.assert_array_equal(a[2 * stage:2 * stage + 2], b)
    with pytest.raises(ValueError, match="divisible"):
        from_flax_pipeline_params(params, stage=0, n_stages=3)


def test_one_stage_matches_sequential_transformer():
    """pp=1 off any mesh: the pipelined model equals the port's sequential
    ``Transformer`` on the same weights (f32, so the f32 head and the
    sequential head agree), at M=1 and M=2, logits and loss gradients."""
    cfg = ttf.TransformerConfig.tiny(n_layers=N_LAYERS)
    params = _tiny_params()
    pipe = tpp.PipelineTransformer(cfg, "cpu")
    pipe.load_state_dict(from_flax_pipeline_params(params))
    seq = ttf.Transformer(cfg, "cpu")
    seq.load_state_dict(from_flax_params(_plain_params(params)))
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (4, 32))).long()
    want = seq(tokens)
    for m in (1, 2):
        got = tpp.pipeline_forward(pipe, tokens, m)
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    tpp.pipeline_loss(pipe, tokens, 2).backward()
    ttf.causal_lm_loss(seq(tokens), tokens).backward()
    assert _rel(pipe.embedding.grad, seq.embedding.grad) < TOL
    assert _rel(pipe.lm_head.grad, seq.lm_head.weight.grad.T) < TOL
    for i in range(N_LAYERS):
        assert _rel(pipe.layers[str(i)].attn.wq.weight.grad,
                    seq.layers[i].attn.wq.weight.grad) < TOL


def test_placements_without_a_mesh():
    """The counterpart of ``pipeline_param_shardings``: block leaves over
    pp (the stage of their layer) and fsdp on the embed dim only; the head
    ``P("fsdp", None)``, ``P("fsdp")``, ``P("fsdp", "tp")``."""
    cfg = ttf.TransformerConfig.tiny(n_layers=N_LAYERS)
    sizes = dict(dcn_dp=1, dp=1, fsdp=2, pp=2, ep=1, sp=1, tp=2)
    pl = tpp.pipeline_param_placements(cfg, sizes)
    assert pl["embedding"].dims == (("fsdp",), ())
    assert pl["final_norm"].dims == (("fsdp",),)
    assert pl["lm_head"] == tpp.PipelinePlacement(
        (("fsdp",), ("tp",)), (32, 128), None)
    assert pl["layers.3.attn.wq.weight"] == tpp.PipelinePlacement(
        ((), ("fsdp",)), (64, 32), 1)
    assert pl["layers.0.mlp.down.weight"].dims == (("fsdp",), ())
    assert pl["layers.1.attn_norm.scale"] == tpp.PipelinePlacement(
        ((),), (64,), 0)
    with pytest.raises(ValueError, match="divisible"):
        tpp.pipeline_param_placements(cfg, dict(sizes, pp=3))


def test_shard_model_points_at_the_pipeline():
    """A sequential model on a pp > 1 mesh is still refused, and the
    refusal names the module that pipelines."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from tony_tpu_torch.parallel import mesh as tmesh
    from tony_tpu_torch.parallel.sharding import shard_model

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=2)
    try:
        m = tmesh.build_mesh(tmesh.MeshSpec(pp=2, dp=1), "cpu")
        with pytest.raises(NotImplementedError,
                           match="pp=2.*parallel/pipeline.py"):
            shard_model(ttf.Transformer(ttf.TransformerConfig.tiny(),
                                        device="meta"), m)
    finally:
        dist.destroy_process_group()


def test_trainer_measures_the_pipelined_decoder():
    """``trainer.measure(..., model=)`` with the pipelined decoder: off
    any mesh and on a one-rank ``pp=1`` mesh (FSDP2 over gloo) from the
    same seed it gives the same AdamW losses; M=1 and M=4 agree within the
    reference's tolerance."""
    from tony_tpu_torch import trainer

    def pipelined(m):
        return functools.partial(tpp.PipelineTransformer,
                                 num_microbatches=m)

    cfg = ttf.TransformerConfig.tiny(n_layers=N_LAYERS)
    kw = dict(batch=4, seq=16, steps=3, warmup=1, device="cpu")
    off = trainer.measure(cfg, model=pipelined(2), **kw)
    on = trainer.measure(cfg, model=pipelined(2), mesh="pp=1", **kw)
    m1 = trainer.measure(cfg, model=pipelined(1), **kw)
    m4 = trainer.measure(cfg, model=pipelined(4), **kw)
    with pytest.raises(ValueError, match="whole loss"):
        trainer.build_state(cfg, "cpu", chunked=True, model=pipelined(2))
    assert np.isfinite(off["losses"]).all()
    assert on["mesh"]["pp"] == 1
    np.testing.assert_allclose(on["losses"], off["losses"], rtol=1e-5)
    np.testing.assert_allclose(m1["losses"], m4["losses"], rtol=TOL,
                               atol=TOL)


def test_no_card_no_fallback():
    """The entry points build on the card unless the CPU is asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        tpp.PipelineTransformer(ttf.TransformerConfig.tiny())


# ---------------------------------------------------------------------------
# Eight gloo ranks against the reference
# ---------------------------------------------------------------------------
def test_stage_placement(runs):
    """Each rank holds exactly its contiguous L/S layers."""
    outs, *_ = runs
    for o in outs:
        s = o["coord"]["pp"]
        assert o["layers"] == [s]
    for o in outs:
        s = o["ft_pp"]
        assert o["ft_layers"] == [2 * s, 2 * s + 1]


def test_sharded_init_is_the_one_rank_build(runs):
    """``init_sharded_state(..., layout=pipeline_shard)`` gives each rank
    the values ``PipelineTransformer(cfg, "cpu")`` draws from the same
    seed, for the parameters it holds."""
    outs, *_ = runs
    one = tpp.PipelineTransformer(ttf.TransformerConfig.tiny(
        n_layers=N_LAYERS), "cpu").state_dict()
    for o in outs:
        for k, v in o["init"].items():
            np.testing.assert_array_equal(v, one[k].numpy(), err_msg=k)


def test_logits_match_reference_pipeline(runs):
    outs, ref, *_ = runs
    np.testing.assert_allclose(_by_dp(outs, "logits"), ref["logits"],
                               rtol=TOL, atol=TOL)


def test_logits_match_sequential_oracle(runs):
    outs, ref, *_ = runs
    np.testing.assert_allclose(_by_dp(outs, "logits"), ref["oracle"],
                               rtol=TOL, atol=TOL)


def test_loss_matches_reference(runs):
    outs, ref, *_ = runs
    for o in outs:
        assert abs(o["loss"] - ref["loss"]) <= TOL * max(1, ref["loss"])


@pytest.mark.parametrize("leaf", [
    "embedding", "final_norm", "lm_head", "attn/wq", "attn/wk", "attn/wv",
    "attn/wo", "mlp/gate", "mlp/up", "mlp/down", "attn_norm", "mlp_norm"])
def test_gradient_matches_reference(runs, leaf):
    """Each leaf of the reference's tree, the block leaves stacked over all
    four stages: no factor of pp, nothing missing."""
    outs, ref, *_ = runs
    have, want = _port_grads(outs), ref["grads"]
    if "/" in leaf:
        sub, name = leaf.split("/")
        have, want = (t["blocks"][sub][name]["kernel"] for t in (have, want))
    elif leaf.endswith("_norm") and leaf != "final_norm":
        have, want = (t["blocks"][leaf]["scale"] for t in (have, want))
    else:
        have, want = have[leaf], want[leaf]
    assert have.shape == want.shape
    assert np.isfinite(have).all()
    assert _rel(have, want) < TOL, (leaf, _rel(have, want))


def test_embedding_gradient_equal_on_every_pp_rank(runs):
    outs, *_ = runs
    first = outs[0]["grads"]["embedding"]
    for o in outs[1:]:
        np.testing.assert_array_equal(o["grads"]["embedding"], first)


def test_microbatch_invariance(runs):
    """M=1 against M=4 on (8, 16), and M=4 against the reference's."""
    outs, ref, *_ = runs
    a, b = _by_dp(outs, "mb1"), _by_dp(outs, "mb4")
    np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(b, ref["mb4"], rtol=TOL, atol=TOL)


def test_adam_steps_match_optax(runs):
    outs, ref, *_ = runs
    for o in outs:
        np.testing.assert_allclose(o["adam"], ref["adam"], rtol=0,
                                   atol=ADAM_TOL)
        assert o["adam"][-1] < o["adam"][0]


def test_indivisible_layers_raise(runs):
    outs, ref, *_ = runs
    assert ref["indivisible"] and "divisible" in ref["indivisible"]
    for o in outs:
        assert o["indivisible"] and "divisible" in o["indivisible"]


def test_fsdp_tp_no_parameter_whole(runs):
    """(pp=2, fsdp=2, tp=2): every head and projection parameter is a
    shard of its whole (fsdp, and tp for the head), each block's norm
    scales live on their stage only (the reference's stacked scale is
    sharded over pp): no leaf of the reference's tree is whole on any
    rank. The shards are the shapes ``pipeline_param_placements``
    plans."""
    outs, *_ = runs
    for o in outs:
        assert len(o["ft_layers"]) == N_LAYERS // 2
        for name, (glob, local) in o["ft_shapes"].items():
            assert local == o["ft_planned"][name], name
            if not name.endswith("_norm.scale"):
                assert np.prod(local) < np.prod(glob), name
        assert o["ft_shapes"]["lm_head"][1] == (32, 128)


def test_fsdp_tp_logits_match_oracle(runs):
    outs, ref, *_ = runs
    for o in outs:
        # fsdp=2 splits the batch: rank r's rows are its fsdp coordinate's.
        rows = o["ft_logits"].shape[0]
        hit = [np.allclose(o["ft_logits"], ref["oracle"][i:i + rows],
                           rtol=TOL, atol=TOL)
               for i in range(0, ref["oracle"].shape[0], rows)]
        assert sum(hit) == 1


def test_fsdp_tp_loss_and_gradient_layouts(runs):
    """A finite loss (the same on every rank), finite gradients, and each
    gradient laid out as its parameter: the same placements, the same
    local shape."""
    outs, ref, *_ = runs
    for o in outs:
        assert np.isfinite(o["ft_loss"])
        assert abs(o["ft_loss"] - ref["loss"]) <= TOL * max(1, ref["loss"])
        assert o["ft_grads_finite"]
        for name, (p_pl, g_pl, p_shape, g_shape) in o["ft_layout"].items():
            assert p_pl == g_pl and p_shape == g_shape, name
        assert "Shard" in o["ft_layout"]["lm_head"][0]
