"""Port parity: sequence parallelism (``tony_tpu_torch/ops/{ring,ulysses}.py``,
``parallel/_comm.py``, the decoder's ``attn_impl="ring"|"ulysses"`` and the
sharded step on an ``sp`` mesh) against ``tony_tpu``'s ring and Ulysses.

In this process:

- ``_comm``'s five functions on a one-rank fake group (identities, forward
  and backward);
- the ring's ``_hop``/``_merge`` driven through n virtual shards (each
  shard's Q against the K/V chunks in the order the ring delivers them,
  with the causal skip) against the reference's ``reference_attention``,
  forward (f32 atol/rtol 2e-5) and gradients (1e-4), and the bf16 error
  flat in n (2 against 8 shards);
- the decoder with ``attn_impl="ring"|"ulysses"`` off any mesh against the
  reference's model outside ``shard_map``;
- the refusals.

On four gloo ranks (one spawn for the file: ``FileStore`` rendezvous in
``tmp_path``, 120 s per rank), against the reference on four of the
virtual host devices:

- the collectives at n = 4 (``ppermute`` both ways, ``all_to_all_tiled``
  and its transpose, ``split_to_group`` / ``gather_from_group`` and their
  backwards);
- ``ring_attention`` and ``ulysses_attention``, causal and full, GQA,
  forward and gradients of Σ o², against ``ring_attention_sharded`` /
  ``ulysses_attention_sharded`` at sp = 4 and (dp=2, sp=2); Ulysses at
  sp = 4 with 2 kv heads raises the reference's ``ValueError``;
- the tiny decoder with ring and Ulysses at (dp=2, sp=2), logits against
  the reference's ``shard_map``'d apply (atol/rtol 2e-4);
- 3 AdamW steps of ``sharded_train_step`` at (fsdp=2, sp=2), ring and
  Ulysses, against ``jax.value_and_grad`` of the reference's
  ``shard_map``'d loss and ``optax.adamw``: losses within 1e-5 relative,
  each gathered parameter within 1e-5 relative Frobenius error;
- a DCP save of the (fsdp=2, sp=2) state restored bitwise, the mesh in the
  manifest.
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

from tony_tpu.compat import shard_map
from tony_tpu.models import transformer as jtf
from tony_tpu.ops import attention as jattn
from tony_tpu.ops.ring import ring_attention_sharded as jring
from tony_tpu.ops.ulysses import ulysses_attention_sharded as julysses
from tony_tpu.parallel import MeshSpec, build_mesh
from tony_tpu_torch.convert import from_flax_params, to_flax_params
from tony_tpu_torch.models import transformer as ttf
from tony_tpu_torch.ops import attention as tattn
from tony_tpu_torch.ops import ring as tring
from tony_tpu_torch.ops import ulysses as tulysses
from tony_tpu_torch.parallel import _comm
from tony_tpu_torch.parallel import mesh as tmesh
from tony_tpu_torch.parallel import sharding as tsh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GB, SEQ, LR, STEPS = 8, 16, 3e-4, 3
RTOL = 1e-5
OP_TOL, GRAD_TOL, LOGIT_TOL = 2e-5, 1e-4, 2e-4
BATCH = ("dcn_dp", "dp", "fsdp")
torch.set_num_threads(2)
# The module's fixture runs the JAX reference (compile-bound, ~1 min here)
# while four gloo ranks train: more than the default watchdog allows on a
# loaded machine.
pytestmark = pytest.mark.timeout_s(600)
# Attention op cases: name -> (mesh spec, op, causal, q heads, kv heads)
OP_CASES = {
    f"{op}_{name}_{'causal' if causal else 'full'}": (spec, op, causal, h,
                                                      hk)
    for name, spec in (("sp4", dict(sp=4)), ("dp2_sp2", dict(dp=2, sp=2)))
    for op in ("ring", "ulysses") for causal in (True, False)
    for h, hk in [(4, 2) if op == "ring" or name != "sp4" else (8, 4)]
}
OP_SHAPE = (4, 32, 16)          # batch, sequence, head_dim
MODEL_CASES = ("ring", "ulysses")

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
from tony_tpu_torch.models import transformer as ttf
from tony_tpu_torch.ops import ulysses_attention_sharded
from tony_tpu_torch.ops.ring import ring_attention_sharded
from tony_tpu_torch.parallel import (MeshSpec, adamw, batch_rank, build_mesh,
                                     checkpoint_tree, init_sharded_state,
                                     load_checkpoint_tree, mesh_shape,
                                     sharded_train_step)
from tony_tpu_torch.parallel import _comm

rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group(
    "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
    rank=rank, world_size=world)
OP_CASES, MODEL_CASES = %(op_cases)r, %(model_cases)r
LR, STEPS = %(lr)r, %(steps)r
out = {}

# The collectives at n = 4 on the whole world.
g = dist.group.WORLD
x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank
x.requires_grad_(True)
y = _comm.ppermute(x, g)
y.backward(torch.full_like(y, float(rank)))
back = _comm.ppermute(y.detach(), g, shift=-1)
a = (torch.arange(4 * 8 * 2, dtype=torch.float32).reshape(4, 8, 2)
     + 1000 * rank).requires_grad_(True)
b = _comm.all_to_all_tiled(a, g, 1, 0)
b.backward(b.detach() * 2)
s = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3).requires_grad_(True)
part = _comm.split_to_group(s, g, 0)
part.backward(torch.full_like(part, float(rank + 1)))
gat = _comm.gather_from_group(part.detach().requires_grad_(True), g, 0)
gat.backward(torch.arange(gat.numel(), dtype=torch.float32).view_as(gat))
out["comm"] = dict(ppermute=y.detach(), ppermute_grad=x.grad, back=back,
                   a2a=b.detach(), a2a_grad=a.grad, split=part.detach(),
                   split_grad=s.grad, gather=gat.detach())


def chunk(x, mesh):
    # This rank's batch rows and its sp sequence chunk.
    rows = process_batch_slice(x.shape[0], mesh=mesh)
    n, r = mesh["sp"].size(), mesh.get_local_rank("sp")
    s = x.shape[1] // n
    return np.ascontiguousarray(x[rows, r * s:(r + 1) * s])


qkv = np.load(os.path.join(tmp, "qkv.npz"))
for name, (spec, op, causal, h, hk) in OP_CASES.items():
    mesh = build_mesh(MeshSpec(**spec), "cpu")
    q, k, v = (torch.from_numpy(chunk(qkv[f"{n}_{h}_{hk}"], mesh))
               .requires_grad_(True) for n in "qkv")
    fn = ring_attention_sharded if op == "ring" else ulysses_attention_sharded
    o = fn(mesh, q, k, v, causal=causal)
    (o ** 2).sum().backward()
    out[name] = dict(o=o.detach(), dq=q.grad, dk=k.grad, dv=v.grad,
                     coord=(batch_rank(mesh), mesh.get_local_rank("sp")))
mesh = build_mesh(MeshSpec(sp=4), "cpu")
q = torch.from_numpy(chunk(qkv["q_4_2"], mesh))
k = torch.from_numpy(chunk(qkv["k_4_2"], mesh))
try:
    ulysses_attention_sharded(mesh, q, k, k)
    out["ulysses_refusal"] = None
except ValueError as e:
    out["ulysses_refusal"] = str(e)

params0 = torch.load(os.path.join(tmp, "w.pt"))
tokens = np.load(os.path.join(tmp, "tokens.npy"))


def whole(x):
    return (x.full_tensor() if isinstance(x, DTensor) else x).detach().clone()


def lm_loss(m, batch):
    tok = batch["tokens"]
    return ttf.causal_lm_loss(m(tok), tok), {}


def build(mesh, impl, seed=0):
    cfg = ttf.TransformerConfig.tiny(attn_impl=impl)
    state, _ = init_sharded_state(lambda d: ttf.Transformer(cfg, device=d),
                                  lambda gr: adamw(gr, LR), mesh, seed=seed)
    return state


for impl in MODEL_CASES:
    # The decoder's logits at (dp=2, sp=2).
    mesh = build_mesh(MeshSpec(dp=2, sp=2), "cpu")
    state = build(mesh, impl)
    set_model_state_dict(state.model, dict(params0),
                         options=StateDictOptions(full_state_dict=True))
    rows = process_batch_slice(tokens.shape[1], mesh=mesh)
    with torch.no_grad():
        logits = state.model(torch.from_numpy(tokens[0, rows]).long())
    out[f"logits_{impl}"] = dict(logits=logits, rows=(rows.start, rows.stop))

    # Three AdamW steps at (fsdp=2, sp=2).
    mesh = build_mesh(MeshSpec(fsdp=2, sp=2), "cpu")
    state = build(mesh, impl)
    set_model_state_dict(state.model, dict(params0),
                         options=StateDictOptions(full_state_dict=True))
    rows = process_batch_slice(tokens.shape[1], mesh=mesh)
    losses = []
    for s in range(STEPS):
        state, m = sharded_train_step(
            lm_loss, mesh, state,
            {"tokens": torch.from_numpy(tokens[s, rows]).long()})
        losses.append(m["loss"].item())
    out[f"train_{impl}"] = dict(
        losses=losses,
        params={k: whole(p) for k, p in state.model.named_parameters()})
    if impl == "ring":
        mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
        mgr.save(STEPS - 1, checkpoint_tree(state), force=True, mesh=mesh)
        fresh = build(mesh, impl, seed=1)
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

torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
dist.barrier()
dist.destroy_process_group()
""" % {"op_cases": OP_CASES, "model_cases": MODEL_CASES, "lr": LR,
       "steps": STEPS}


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


def _qkv_arrays():
    """Inputs of every attention case, by name ``{q,k,v}_{h}_{hk}``."""
    b, s, d = OP_SHAPE
    rng = np.random.default_rng(11)
    out = {}
    for h, hk in {(c[3], c[4]) for c in OP_CASES.values()}:
        for n, heads in (("q", h), ("k", hk), ("v", hk)):
            out[f"{n}_{h}_{hk}"] = rng.standard_normal(
                (b, s, heads, d), dtype=np.float32)
    return out


def _op_reference(qkv, spec, op, causal, h, hk):
    """The reference's sharded op on four virtual devices: (o, dq, dk, dv)
    of Σ o²."""
    n = int(np.prod(list(spec.values())))
    mesh = build_mesh(MeshSpec(**spec), devices=jax.devices()[:n])
    fn = jring if op == "ring" else julysses
    q, k, v = (jnp.asarray(qkv[f"{x}_{h}_{hk}"]) for x in "qkv")

    def loss(q, k, v):
        o = fn(mesh, q, k, v, causal=causal)
        return jnp.sum(o ** 2), o

    (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                       has_aux=True)(q, k, v)
    return [np.asarray(x) for x in (o, *grads)]


def _sp_model(impl, spec):
    """The reference's decoder under ``shard_map`` over ``spec``'s mesh:
    ``fwd(params, tokens)`` → global logits."""
    cfg = jtf.TransformerConfig.tiny(attn_impl=impl)
    mesh = build_mesh(MeshSpec(**spec), devices=jax.devices()[:4])
    spec_t = P(BATCH, "sp")
    return shard_map(
        lambda p, t: jtf.Transformer(cfg).apply({"params": p}, t),
        mesh=mesh, in_specs=(P(), spec_t), out_specs=P(BATCH, "sp", None),
        check_vma=False)


def _train_reference(params0, tokens, impl):
    """3 AdamW steps of the reference's shard_map'd loss at (fsdp=2,
    sp=2): (losses, params)."""
    fwd = _sp_model(impl, dict(fsdp=2, sp=2))
    tx = optax.adamw(LR)

    @jax.jit
    def step(p, opt, t):
        loss, g = jax.value_and_grad(
            lambda p: jtf.causal_lm_loss(fwd(p, t), t))(p)
        upd, opt = tx.update(g, opt, p)
        return optax.apply_updates(p, upd), opt, loss

    p, opt, losses = params0, tx.init(params0), []
    for s in range(STEPS):
        p, opt, loss = step(p, opt, jnp.asarray(tokens[s]))
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results, with the reference's computed in this
    process while the ranks run."""
    tmp = tmp_path_factory.mktemp("seqpar")
    cfg = jtf.TransformerConfig.tiny()
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (STEPS, GB, SEQ)).astype(np.int32)
    params0 = jax.tree.map(np.asarray, fnn.meta.unbox(
        jtf.Transformer(cfg).init(jax.random.key(0),
                                  jnp.zeros((1, SEQ), jnp.int32))["params"]))
    torch.save(from_flax_params(params0), tmp / "w.pt")
    np.save(tmp / "tokens.npy", tokens)
    qkv = _qkv_arrays()
    np.savez(tmp / "qkv.npz", **qkv)
    procs = _spawn(tmp)
    try:
        ref = {name: _op_reference(qkv, *case)
               for name, case in OP_CASES.items()}
        try:
            julysses(build_mesh(MeshSpec(sp=4), devices=jax.devices()[:4]),
                     *(jnp.asarray(qkv[f"{x}_4_2"]) for x in "qkk"))
            ref["ulysses_refusal"] = None
        except ValueError as e:
            ref["ulysses_refusal"] = str(e)
        for impl in MODEL_CASES:
            ref[f"logits_{impl}"] = np.asarray(jax.jit(_sp_model(
                impl, dict(dp=2, sp=2)))(params0, jnp.asarray(tokens[0])))
            ref[f"train_{impl}"] = _train_reference(params0, tokens, impl)
    finally:
        _wait(procs)
    return [torch.load(tmp / f"out{r}.pt") for r in range(4)], ref


def _rel(have, want):
    want = np.asarray(want, np.float64)
    return np.linalg.norm(np.asarray(have, np.float64) - want) / \
        np.linalg.norm(want)


# ---------------------------------------------------------------------------
# One process
# ---------------------------------------------------------------------------
@pytest.fixture
def fake_world1():
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("fn", [
    lambda x, g: _comm.ppermute(x, g),
    lambda x, g: _comm.all_to_all_tiled(x, g, 1, 0),
    lambda x, g: _comm.split_to_group(x, g, 0),
    lambda x, g: _comm.gather_from_group(x, g, 1),
    lambda x, g: _comm.reduce_from_group(x, g)],
    ids=["ppermute", "all_to_all_tiled", "split_to_group",
         "gather_from_group", "reduce_from_group"])
def test_comm_world1_is_identity(fake_world1, fn):
    x = torch.randn(4, 6, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    y = fn(x, fake_world1)
    assert torch.equal(y, x)
    gy = torch.randn(4, 6, generator=torch.Generator().manual_seed(1))
    y.backward(gy)
    assert torch.equal(x.grad, gy)
    assert _comm.group_size(fake_world1) == 1 and _comm.group_size(None) == 1


def _virtual_ring(q, k, v, n, causal):
    """Ring attention for n virtual ranks in one process, through the
    ring's own ``schedule``, ``_hop`` and ``_merge``: the gathered output."""
    s = q.shape[1] // n
    scale = q.shape[-1] ** -0.5
    outs = []
    for r in range(n):
        o_acc, lse_acc = tring.empty_state(q[:, r * s:(r + 1) * s])
        for _, src, kind in tring.schedule(r, n, causal):
            if kind == tring.SKIP:
                continue
            o, lse = tring._hop(q[:, r * s:(r + 1) * s],
                                k[:, src * s:(src + 1) * s],
                                v[:, src * s:(src + 1) * s], kind, scale,
                                8, 8)
            o_acc, lse_acc = tring._merge(o_acc, lse_acc, o, lse)
        outs.append(o_acc.to(q.dtype))
    return torch.cat(outs, dim=1)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_virtual_ring_matches_reference(n, causal):
    rng = np.random.default_rng(3)
    b, s, h, hk, d = 2, 32, 4, 2, 16
    arrs = [rng.standard_normal((b, s, x, d), dtype=np.float32)
            for x in (h, hk, hk)]

    def ref_loss(q, k, v):
        o = jattn.reference_attention(q, jnp.repeat(k, 2, axis=2),
                                      jnp.repeat(v, 2, axis=2),
                                      causal=causal)
        return jnp.sum(o ** 2), o

    (_, want), grads = jax.value_and_grad(ref_loss, argnums=(0, 1, 2),
                                          has_aux=True)(*arrs)
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrs)
    o = _virtual_ring(q, k, v, n, causal)
    (o ** 2).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), want, atol=OP_TOL,
                               rtol=OP_TOL)
    for got, ref, name in zip((q.grad, k.grad, v.grad), grads, "qkv"):
        np.testing.assert_allclose(got.numpy(), ref, atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=f"d{name}")


def test_virtual_ring_error_flat_in_shards():
    """bf16 through the f32 merge: 8 shards pay the same single rounding
    as 2 (``test_ring_error_flat_in_sp_degree`` of the reference)."""
    rng = np.random.default_rng(7)
    arrs = [rng.standard_normal((4, 64, 2, 16), dtype=np.float32)
            for _ in range(3)]
    ref = np.asarray(jattn.reference_attention(*arrs, causal=True))
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)

    def err(n):
        o = _virtual_ring(q, k, v, n, True).float().numpy()
        return float(np.abs(o - ref).max())
    e2, e8 = err(2), err(8)
    assert e8 <= 1.5 * e2 + 1e-6, (e2, e8)


def test_ring_schedule_skips_the_future():
    assert tring.schedule(2, 4, True) == [
        (0, 2, tring.DIAG), (1, 1, tring.FULL), (2, 0, tring.FULL),
        (3, 3, tring.SKIP)]
    assert [kind for _, _, kind in tring.schedule(0, 3, False)] == \
        [tring.FULL] * 3


def test_ops_without_a_group_are_the_references_unsharded_semantics(
        monkeypatch):
    """Without a group the ring is a ring of one rank: one hop through the
    flash entry point (the kernels on a CUDA tensor), with the reference's
    unsharded result."""
    rng = np.random.default_rng(5)
    arrs = [rng.standard_normal((2, 16, x, 16), dtype=np.float32)
            for x in (4, 2, 2)]
    q, k, v = (torch.from_numpy(a) for a in arrs)
    want = np.asarray(jattn.reference_attention(
        arrs[0], np.repeat(arrs[1], 2, 2), np.repeat(arrs[2], 2, 2)))
    hops = []

    def counted(*a, **kw):
        hops.append(kw["causal"])
        return tattn.flash_attention_with_lse(*a, **kw)
    monkeypatch.setattr(tring, "flash_attention_with_lse", counted)
    np.testing.assert_allclose(tring.ring_attention(q, k, v).numpy(), want,
                               atol=OP_TOL, rtol=OP_TOL)
    assert hops == [True]
    assert torch.equal(tulysses.ulysses_attention(q, k, v, block_q=8,
                                                  block_k=8),
                       tattn.flash_attention(q, k, v, block_q=8, block_k=8))


@pytest.mark.parametrize("impl", MODEL_CASES)
def test_decoder_off_mesh_matches_reference(impl):
    """Off any mesh (init, one-shard apply) ring is a ring of one rank and
    Ulysses is flash, in both."""
    jcfg = jtf.TransformerConfig.tiny(attn_impl=impl)
    tokens = np.random.default_rng(2).integers(0, 256, (2, SEQ)).astype(
        np.int32)
    params = fnn.meta.unbox(jtf.Transformer(jcfg).init(
        jax.random.key(0), jnp.asarray(tokens))["params"])
    want = jtf.Transformer(jcfg).apply({"params": params}, tokens)
    model = ttf.Transformer(ttf.TransformerConfig.tiny(attn_impl=impl),
                            device="cpu")
    model.load_state_dict(from_flax_params(
        jax.tree.map(np.asarray, params)))
    got = model(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_sequence_parallel_refusals():
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=2)
    try:
        mesh = tmesh.build_mesh(tmesh.MeshSpec(sp=2, dp=1), "cpu")
        flash = ttf.Transformer(ttf.TransformerConfig.tiny(), device="meta")
        with pytest.raises(NotImplementedError, match="sp=2"):
            tsh.shard_model(flash, mesh)
        # The chunked loss inside an sp group of two ranks.
        cfg = ttf.TransformerConfig.tiny(attn_impl="ring")
        model = ttf.Transformer(cfg, device="cpu")
        model.sp_group = mesh["sp"].get_group()
        with pytest.raises(ValueError, match="chunked_causal_lm_loss"):
            model(torch.zeros((2, 8), dtype=torch.long), loss_chunk=4)
    finally:
        dist.destroy_process_group()


def test_cli_attn_impl_flag(monkeypatch):
    from tony_tpu_torch import trainer

    seen = {}

    def fake_measure(cfg, **kw):
        seen.update(kw, attn_impl=cfg.attn_impl)
        return {}
    monkeypatch.setattr(trainer, "measure", fake_measure)
    assert trainer.main(["--mesh", "fsdp=2,sp=2", "--attn-impl", "ulysses",
                         "--device", "cpu"]) == 0
    assert seen["mesh"] == "fsdp=2,sp=2" and seen["attn_impl"] == "ulysses"
    with pytest.raises(SystemExit):
        trainer.main(["--model", "mnist", "--attn-impl", "ring"])


# ---------------------------------------------------------------------------
# Four gloo ranks
# ---------------------------------------------------------------------------
def test_collectives_on_four_ranks(runs):
    out, _ = runs
    for r, o in enumerate(out):
        c = o["comm"]
        base = torch.arange(6, dtype=torch.float32).reshape(2, 3)
        # Rank r holds rank r-1's x; the cotangent goes back to r-1.
        assert torch.equal(c["ppermute"], base + 10 * ((r - 1) % 4))
        assert torch.equal(c["ppermute_grad"],
                           torch.full((2, 3), float((r + 1) % 4)))
        assert torch.equal(c["back"], base + 10 * r)
        # all_to_all_tiled(a, split 1, concat 0): block r of every rank's
        # dim 1, stacked on dim 0 in rank order.
        want = torch.cat([
            (torch.arange(64, dtype=torch.float32).reshape(4, 8, 2)
             + 1000 * j)[:, 2 * r:2 * r + 2] for j in range(4)])
        assert torch.equal(c["a2a"], want)
        a = torch.arange(64, dtype=torch.float32).reshape(4, 8, 2) + 1000 * r
        assert torch.equal(c["a2a_grad"], a * 2)     # the transpose
        s = torch.arange(24, dtype=torch.float32).reshape(8, 3)
        assert torch.equal(c["split"], s[2 * r:2 * r + 2])
        assert torch.equal(c["split_grad"], torch.repeat_interleave(
            torch.arange(1.0, 5.0), 6).reshape(8, 3))
        assert torch.equal(c["gather"], s)


def _assemble(out, name, key):
    """The global tensor of ``key`` from every rank's block, by the ranks'
    (batch coordinate, sp index)."""
    blocks = {o[name]["coord"]: o[name][key].numpy() for o in out}
    nb = 1 + max(c[0] for c in blocks)
    ns = 1 + max(c[1] for c in blocks)
    return np.concatenate([np.concatenate([blocks[(b, s)]
                                           for s in range(ns)], axis=1)
                           for b in range(nb)], axis=0)


@pytest.mark.parametrize("name", list(OP_CASES))
def test_sequence_parallel_op_matches_reference(runs, name):
    out, ref = runs
    o, dq, dk, dv = ref[name]
    np.testing.assert_allclose(_assemble(out, name, "o"), o, atol=OP_TOL,
                               rtol=OP_TOL)
    for key, want in (("dq", dq), ("dk", dk), ("dv", dv)):
        np.testing.assert_allclose(_assemble(out, name, key), want,
                                   atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=key)


def test_ulysses_refuses_indivisible_kv_heads(runs):
    out, ref = runs
    assert ref["ulysses_refusal"] is not None
    for o in out:
        assert o["ulysses_refusal"] == ref["ulysses_refusal"]


@pytest.mark.parametrize("impl", MODEL_CASES)
def test_decoder_logits_match_shard_mapped_reference(runs, impl):
    out, ref = runs
    want = ref[f"logits_{impl}"]
    for o in out:
        got = o[f"logits_{impl}"]
        start, stop = got["rows"]
        np.testing.assert_allclose(got["logits"].numpy(), want[start:stop],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("impl", MODEL_CASES)
def test_sp_train_step_matches_reference(runs, impl):
    out, ref = runs
    losses, params = ref[f"train_{impl}"]
    got = to_flax_params(out[0][f"train_{impl}"]["params"])
    for o in out:
        np.testing.assert_allclose(o[f"train_{impl}"]["losses"], losses,
                                   rtol=RTOL)
    for path, want in jax.tree_util.tree_leaves_with_path(params):
        have = got
        for key in path:
            have = have[key.key]
        assert _rel(have, want) <= RTOL, jax.tree_util.keystr(path)
    # The sp peers hold the same parameters.
    for o in out[1:]:
        for k, v in o[f"train_{impl}"]["params"].items():
            assert torch.equal(v, out[0][f"train_{impl}"]["params"][k]), k


def test_sp_checkpoint_round_trip(runs):
    out, _ = runs
    for o in out:
        d = o["dcp"]
        assert d["step"] == STEPS and d["params"] and d["moments"]
        assert d["noted"] == d["mesh"] and d["mesh"]["sp"] == 2
        assert d["resharded"] is None


@pytest.mark.parametrize("impl", MODEL_CASES)
def test_world1_sp_mesh_trains_as_flash(impl):
    """``measure(mesh="fsdp=1")`` with ring or Ulysses: the sp group of one
    rank runs the one diagonal hop (or the identity swaps) through the
    flash path, and f32 training equals the flash run bit for bit."""
    from tony_tpu_torch import trainer

    def run(attn):
        cfg = ttf.TransformerConfig.tiny(max_seq_len=32, attn_impl=attn)
        return trainer.measure(cfg, batch=2, seq=32, steps=3, warmup=1,
                               device="cpu", mesh="fsdp=1")["losses"]
    assert run(impl) == run("flash")
    assert not dist.is_initialized()
