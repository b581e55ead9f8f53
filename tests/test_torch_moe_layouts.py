"""Port parity: the MoE decoder over tp and over sp
(``tony_tpu_torch/models/moe.py``, ``parallel/sharding.py``'s layout of the
stacked experts on ``(ep, tp)``) against ``tony_tpu/models/moe.py``.

On four gloo ranks (one spawn: ``FileStore`` rendezvous in ``tmp_path``,
120 s per rank), 3 AdamW steps each (losses within 1e-5 relative, each
gathered parameter within 1e-5 relative Frobenius error):

- ``(fsdp=2, tp=2)`` against the reference's ``init_sharded_state`` and
  its jitted step under ``set_mesh`` on four virtual host devices (GSPMD
  lays the experts' ``mlp`` dim over tp); every local shard shape the
  reference's;
- ring and Ulysses attention at ``(dp=2, sp=2)``, and ring with a capacity
  that drops tokens, against the reference's whole model inside a
  full-manual ``shard_map`` over ``P(batch, "sp")`` (the convention of
  ``tests/test_torch_seqpar.py``): each shard routes its own tokens as one
  group and returns its own aux, and the loss adds the aux weight times the
  shards' mean aux to the cross-entropy of the gathered logits (the module
  docstring of ``models/moe.py``). The reference is handed the global
  positions, sharded as the tokens are: its ``MoETransformer`` numbers
  each shard's chunk from 0 when left to its default (``jnp.arange`` of the
  local length; the dense decoder offsets them by the sp index), which the
  port does not copy. The logits before the first step against the
  ``shard_map``'d apply (atol/rtol 2e-4), then the train.

The MoE at ``(dp=2, ep=2, tp=2)`` takes eight ranks:
``tests/test_torch_moe_ep_tp.py``.

In this process: ``MoETransformer(tie_embeddings=True)`` builds its untied
head and matches the reference's (which never reads the flag); sp with
ep > 1 is refused, naming the reference's lowering failure; the local
grouping gives another capacity and another aux than the global one on the
same tokens (what the sp cases above hold); ``trainer.measure`` trains the
MoE decoder on a one-rank mesh as unsharded, bit for bit.
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
from jax.sharding import PartitionSpec as P
from torch.testing._internal.distributed.fake_pg import FakeStore

from tony_tpu import compat
from tony_tpu.compat import shard_map
from tony_tpu.models import moe as jmoe
from tony_tpu.parallel import MeshSpec, build_mesh, init_sharded_state
from tony_tpu.parallel import sharding as jsh
from tony_tpu_torch.convert import from_flax_moe_params, to_flax_moe_params
from tony_tpu_torch.models import moe as tmoe
from tony_tpu_torch.parallel import mesh as tmesh
from tony_tpu_torch.parallel import sharding as tsh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GB, SEQ, LR, STEPS = 8, 16, 3e-4, 3
RTOL, LOGIT_TOL = 1e-5, 2e-4
BATCH = ("dcn_dp", "dp", "fsdp")
torch.set_num_threads(2)
# The module's fixture runs the JAX reference (compile-bound) while four
# gloo ranks train: more than the default watchdog allows on a loaded
# machine.
pytestmark = pytest.mark.timeout_s(600)
# name -> (mesh spec, MoEConfig.tiny_moe keywords)
CASES = {
    "fsdp2_tp2": (dict(fsdp=2, tp=2), {}),
    "ring_dp2_sp2": (dict(dp=2, sp=2), dict(attn_impl="ring")),
    "ulysses_dp2_sp2": (dict(dp=2, sp=2), dict(attn_impl="ulysses")),
    "ring_dp2_sp2_drop": (dict(dp=2, sp=2),
                          dict(attn_impl="ring", capacity_factor=0.5)),
}
SP_CASES = [n for n, (spec, _) in CASES.items() if spec.get("sp", 1) > 1]

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
from tony_tpu_torch.parallel import (MeshSpec, adamw, build_mesh,
                                     init_sharded_state, sharded_train_step)

rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group(
    "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
    rank=rank, world_size=world)
CASES = %(cases)r
LR, STEPS = %(lr)r, %(steps)r
tokens = np.load(os.path.join(tmp, "tokens.npy"))


def whole(x):
    return (x.full_tensor() if isinstance(x, DTensor) else x).detach().clone()


def local(x):
    return x.to_local() if isinstance(x, DTensor) else x


out = {}
for name, (spec, kw) in CASES.items():
    cfg = tmoe.MoEConfig.tiny_moe(**kw)
    mesh = build_mesh(MeshSpec(**spec), "cpu")
    state, placements = init_sharded_state(
        lambda d: tmoe.MoETransformer(cfg, device=d),
        lambda g: adamw(g, LR), mesh)
    set_model_state_dict(state.model, torch.load(os.path.join(tmp, "w.pt")),
                         options=StateDictOptions(full_state_dict=True))
    rows = process_batch_slice(tokens.shape[1], mesh=mesh)
    case = {"rows": (rows.start, rows.stop)}
    with torch.no_grad():
        logits, aux = state.model(torch.from_numpy(tokens[0, rows]).long())
    case.update(logits=logits.clone(), aux=float(aux))

    def loss_fn(m, batch):
        tok = batch["tokens"]
        return tmoe.moe_lm_loss(m(tok), tok, cfg.aux_loss_weight), {}

    losses = []
    for s in range(STEPS):
        state, m = sharded_train_step(
            loss_fn, mesh, state,
            {"tokens": torch.from_numpy(tokens[s, rows]).long()})
        losses.append(m["loss"].item())
    case.update(
        losses=losses,
        local_shapes={k: tuple(local(p).shape)
                      for k, p in state.model.named_parameters()},
        planned={k: pl.local_shape for k, pl in placements.items()},
        placements={k: str(getattr(p, "placements", None))
                    for k, p in state.model.named_parameters()},
        params={k: whole(p) for k, p in state.model.named_parameters()})
    out[name] = case
torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
dist.barrier()
dist.destroy_process_group()
"""


def _rules():
    return fnn.logical_axis_rules(list(jsh.DEFAULT_RULES))


def _spawn(tmp_path, cases, world):
    """``world`` gloo ranks running ``cases``, each writing its
    ``out{rank}.pt``."""
    script = tmp_path / "rank.py"
    script.write_text(_RANK_SCRIPT % {"cases": cases, "lr": LR,
                                      "steps": STEPS})
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


def _init_params(cfg, tokens):
    with _rules():
        v = jmoe.MoETransformer(cfg).init(jax.random.key(0),
                                          jnp.asarray(tokens))
    return jax.tree.map(np.asarray, fnn.meta.unbox(v)["params"])


def _sharded_reference(params0, tokens, spec, kw):
    """The reference's ``init_sharded_state`` run under ``set_mesh``:
    (losses, params, shard shapes)."""
    cfg = jmoe.MoEConfig.tiny_moe(**kw)
    model = jmoe.MoETransformer(cfg)
    n = int(np.prod(list(spec.values())))
    mesh = build_mesh(MeshSpec(**spec), devices=jax.devices()[:n])
    state, sh = init_sharded_state(model, jnp.asarray(tokens[0]),
                                   optax.adamw(LR), mesh)
    state = state.replace(params=jax.device_put(params0, sh.params))
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


def _sp_model(spec, kw):
    """The reference's MoE decoder inside a full-manual ``shard_map`` over
    ``P(batch, "sp")``: ``fwd(params, tokens)`` → (global logits, every
    shard's aux as a ``[batch shards, sp shards]`` array)."""
    cfg = jmoe.MoEConfig.tiny_moe(**kw)
    n = int(np.prod(list(spec.values())))
    mesh = build_mesh(MeshSpec(**spec), devices=jax.devices()[:n])

    def fwd(p, t, pos):
        logits, aux = jmoe.MoETransformer(cfg).apply({"params": p}, t, pos)
        return logits, aux.reshape(1, 1)
    sharded = shard_map(
        fwd, mesh=mesh, in_specs=(P(), P(BATCH, "sp"), P(BATCH, "sp")),
        out_specs=(P(BATCH, "sp", None), P(BATCH, "sp")), check_vma=False)

    def apply(p, t):
        # The global positions, each shard's chunk at its own: left to
        # itself, the reference's MoETransformer numbers a shard's chunk
        # from 0 (its default positions are arange of the local length).
        pos = jnp.broadcast_to(jnp.arange(t.shape[1])[None, :], t.shape)
        return sharded(p, t, pos)
    return cfg, apply


def _sp_reference(params0, tokens, spec, kw):
    """The shard_map'd logits and shards' aux on ``tokens[0]``, then 3
    AdamW steps of the loss ``moe_lm_loss`` with the shards' mean aux:
    (logits, aux, losses, params)."""
    cfg, fwd = _sp_model(spec, kw)
    logits, auxes = jax.jit(fwd)(params0, jnp.asarray(tokens[0]))
    tx = optax.adamw(LR)

    def loss(p, t):
        logits, auxes = fwd(p, t)
        return jmoe.moe_lm_loss((logits, jnp.mean(auxes)), t,
                                cfg.aux_loss_weight)

    @jax.jit
    def step(p, opt, t):
        value, g = jax.value_and_grad(loss)(p, t)
        upd, opt = tx.update(g, opt, p)
        return optax.apply_updates(p, upd), opt, value

    p, opt, losses = params0, tx.init(params0), []
    for s in range(STEPS):
        p, opt, value = step(p, opt, jnp.asarray(tokens[s]))
        losses.append(float(value))
    return (np.asarray(logits), np.asarray(auxes), losses,
            jax.tree.map(np.asarray, p))


def run_cases(tmp, cases, world):
    """``world`` ranks' results of ``cases``, with the reference's runs
    computed in this process while the ranks train."""
    cfg = jmoe.MoEConfig.tiny_moe()
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (STEPS, GB, SEQ)).astype(np.int32)
    params0 = _init_params(cfg, tokens[0])
    torch.save(from_flax_moe_params(params0), tmp / "w.pt")
    np.save(tmp / "tokens.npy", tokens)
    procs = _spawn(tmp, cases, world)
    try:
        ref = {}
        for name, (spec, kw) in cases.items():
            ref[name] = (_sp_reference if spec.get("sp", 1) > 1
                         else _sharded_reference)(params0, tokens, spec, kw)
    finally:
        _wait(procs)
    return [torch.load(tmp / f"out{r}.pt") for r in range(world)], ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("moe_layouts"), CASES, 4)


def check_train_step(runs, name, sp):
    """Every rank's losses, and the gathered parameters, against the
    reference's; the ranks' parameters equal."""
    out, ref = runs
    losses, params = ref[name][-2:] if sp else ref[name][:2]
    for o in out:
        np.testing.assert_allclose(o[name]["losses"], losses, rtol=RTOL)
    got = to_flax_moe_params(out[0][name]["params"])
    for path, have, want in _leaves(got, params):
        assert _rel(have, want) <= RTOL, (name, path)
    for o in out[1:]:
        for k, v in o[name]["params"].items():
            assert torch.equal(v, out[0][name]["params"][k]), (name, k)


def check_shard_shapes(runs, name):
    """Every rank's local shard shapes: the planned ones, and the
    reference's."""
    out, ref = runs
    for o in out:
        got = o[name]
        assert got["local_shapes"] == got["planned"]
        local = to_flax_moe_params({k: torch.empty(s) for k, s in
                                    got["local_shapes"].items()})
        for path, have, want in _leaves(local, ref[name][2]):
            assert tuple(have.shape) == tuple(want), path


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
# Four gloo ranks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(CASES))
def test_moe_layout_train_step_matches_reference(runs, name):
    check_train_step(runs, name, name in SP_CASES)


def test_moe_tp_local_shard_shapes_match_reference(runs):
    check_shard_shapes(runs, "fsdp2_tp2")
    out, _ = runs
    cfg = tmoe.MoEConfig.tiny_moe()
    shapes = out[0]["fsdp2_tp2"]["local_shapes"]
    # The experts' mlp dim over tp, their embed dim over fsdp.
    assert shapes["layers.0.moe.gate"] == (cfg.n_experts, cfg.dim // 2,
                                           cfg.mlp_dim // 2)
    assert shapes["layers.0.moe.down"] == (cfg.n_experts, cfg.mlp_dim // 2,
                                           cfg.dim // 2)
    placed = out[0]["fsdp2_tp2"]["placements"]
    assert "Shard(dim=2)" in placed["layers.0.moe.gate"]
    assert "Shard(dim=1)" in placed["layers.0.moe.down"]


@pytest.mark.parametrize("name", SP_CASES)
def test_moe_sp_logits_and_aux_match_shard_mapped_reference(runs, name):
    out, ref = runs
    logits, auxes = ref[name][:2]
    for o in out:
        got = o[name]
        start, stop = got["rows"]
        np.testing.assert_allclose(got["logits"].numpy(),
                                   logits[start:stop], atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
        # Every rank returns the shards' mean aux.
        assert got["aux"] == pytest.approx(float(np.mean(auxes)), rel=RTOL)


# ---------------------------------------------------------------------------
# One process
# ---------------------------------------------------------------------------
def test_tied_flag_builds_the_references_untied_head():
    """The reference's ``MoETransformer`` never reads ``tie_embeddings``:
    with the flag set it builds its ``lm_head`` all the same, and so does
    the port's, with the same loss and gradients."""
    jcfg = jmoe.MoEConfig.tiny_moe(tie_embeddings=True)
    tokens = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (4, SEQ)).astype(np.int32)
    params = _init_params(jcfg, tokens)
    assert "lm_head" in params

    def loss_fn(p):
        with _rules():
            return jmoe.moe_lm_loss(
                jmoe.MoETransformer(jcfg).apply({"params": p}, tokens),
                tokens, jcfg.aux_loss_weight)
    loss, grads = jax.value_and_grad(loss_fn)(params)
    cfg = tmoe.MoEConfig.tiny_moe(tie_embeddings=True)
    model = tmoe.MoETransformer(cfg, device="cpu")
    assert model.lm_head is not None
    model.load_state_dict(from_flax_moe_params(params))
    tok = torch.from_numpy(tokens).long()
    got = tmoe.moe_lm_loss(model(tok), tok, cfg.aux_loss_weight)
    got.backward()
    assert got.item() == pytest.approx(float(loss), rel=RTOL)
    have = to_flax_moe_params({k: p.grad
                               for k, p in model.named_parameters()})
    for path, g, want in _leaves(have, jax.tree.map(np.asarray, grads)):
        assert _rel(g, want) <= 1e-4, path


def test_sp_with_ep_refused_naming_the_references_failure():
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=4)
    try:
        mesh = tmesh.build_mesh(tmesh.MeshSpec(sp=2, ep=2, dp=1), "cpu")
        model = tmoe.MoETransformer(
            tmoe.MoEConfig.tiny_moe(attn_impl="ring"), device="meta")
        with pytest.raises(NotImplementedError,
                           match=r"sp=2 and ep=2.*chlo\.top_k"):
            tsh.shard_model(model, mesh)
    finally:
        dist.destroy_process_group()


def test_local_groups_route_and_weigh_otherwise():
    """A shard's own tokens as one group (sp) against the batch's as one
    group: another capacity, other drops, another aux, on the same
    router output. The sp cases above hold the local one to the reference's
    ``shard_map``."""
    cfg = tmoe.MoEConfig.tiny_moe(capacity_factor=0.5)
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal((64, cfg.n_experts),
                                                  dtype=np.float32))
    logits[:32, 0] += 2.0         # the first shard leans on expert 0
    probs = torch.softmax(logits, -1)
    idx = tmoe.top_k_experts(probs, cfg.top_k)
    whole = tmoe.route(cfg, idx, tmoe.capacity(cfg, 64))[1]
    halves = torch.cat([tmoe.route(cfg, idx[i:i + 32],
                                   tmoe.capacity(cfg, 32))[1]
                        for i in (0, 32)])
    assert not torch.equal(whole, halves)
    m = tmoe.MoEMLP(cfg, torch.device("cpu"))
    global_aux = float(m._aux(probs))
    local_aux = np.mean([float(m._aux(probs[i:i + 32])) for i in (0, 32)])
    assert abs(global_aux - local_aux) > 1e-3


def test_measure_trains_the_moe_decoder_on_a_world1_mesh():
    """``trainer.measure`` takes a ``MoEConfig`` (the MoE decoder on
    ``moe_loss``), on a one-rank gloo mesh too, where its experts are
    DTensors on ``(ep, tp)``: the same losses as unsharded, bit for bit."""
    from tony_tpu_torch import trainer

    cfg = tmoe.MoEConfig.tiny_moe(max_seq_len=32, capacity_factor=0.5)

    def run(mesh):
        return trainer.measure(cfg, batch=2, seq=32, steps=3, warmup=1,
                               device="cpu", mesh=mesh)
    plain, sharded = run(""), run("fsdp=1")
    assert sharded["mesh"] is not None and not dist.is_initialized()
    assert sharded["losses"] == plain["losses"]
    assert sharded["params"] == plain["params"]
