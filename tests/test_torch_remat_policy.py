"""Port parity: ``TransformerConfig.remat_policy`` (``models/remat.py``)
against the reference's ``nn.remat(..., policy=getattr(
jax.checkpoint_policies, name))``.

- (a) The tiny f32 decoder under None and each of the six policy names the
  reference accepts, at ``attn_impl`` "xla" and "flash" (the plain
  stand-in on the CPU; the reference's Pallas kernel as its own tests run
  it), with ``remat_skip_every=2`` under a policy, and int8 and fp8 under
  ``dots_with_no_batch_dims_saveable``: the loss and every parameter's
  gradient within 1e-5 (absolute and relative) of the reference's
  ``jax.value_and_grad`` under the same policy, weights through
  ``convert.py``; and bit for bit the port's own full-remat run. fp8 is
  the exception, named: the two frameworks quantize activations that
  differ by f32 rounding, and on these inputs fp8 levels flip (the loss
  6.041971 against 6.041280, with remat off as well; the two decoders'
  parity without remat is ``tests/test_torch_quant.py``'s). Under fp8 the
  reference's policy run is held at 1e-5 to its own run without remat,
  and the port's bit for bit to its own: the policy moves nothing in
  either framework.
- (b) Per policy, what one block keeps: the port's kept products
  (``remat.recording``: site, numel, dtype) against the reference's
  ``jax.ad_checkpoint.print_saved_residuals`` of the same block, as a
  multiset of (numel, dtype). Named differences, held on purpose: the
  reference's ``jax.nn.silu`` is a jitted function and JAX keeps its
  output where the port keeps the ``gate`` product it is taken of (same
  numel and dtype: the multisets agree, and the test checks that the
  reference's list names ``silu`` exactly where it should); SAC keeps
  what it marks while JAX keeps only what the backward reads, so the
  port leaves ``down`` and ``combine`` unmarked (the reference keeps
  neither). The flash forward runs twice per layer under full remat and
  both dots policies (the kernel is opaque to the policy, as the
  reference's ``pallas_call``), once under ``everything_saveable``.
- (c) The six factories of ``jax.checkpoint_policies`` raise
  ``TypeError`` and an unknown name ``AttributeError``, in both packages.
- (d) The tiny MoE decoder under both dots policies against the reference
  (router, dispatch, experts: the same residual multiset; the loss and
  gradients within 1e-5), and on two gloo ranks at ep = 2, where the
  checkpointed block recomputes its ``all_to_all`` pair: 2 AdamW steps
  under each dots policy within 1e-5 of the reference's on a 2-device ep
  mesh, and bit for bit the port's full-remat run on the same ranks.
"""

import collections
import contextlib
import io
import os
import re
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.ad_checkpoint import print_saved_residuals

from tony_tpu import compat
from tony_tpu.models import moe as jmoe
from tony_tpu.models import transformer as jtf
from tony_tpu.parallel import MeshSpec, build_mesh, init_sharded_state
from tony_tpu.parallel import sharding as jsh
from tony_tpu_torch.convert import (from_flax_moe_params, from_flax_params,
                                    to_flax_moe_params, to_flax_params)
from tony_tpu_torch.models import moe as tmoe
from tony_tpu_torch.models import remat
from tony_tpu_torch.models import transformer as ttf
from tony_tpu_torch.ops import attention as tattn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-5, rtol=1e-5)
B, S = 2, 32
NO_BATCH = "dots_with_no_batch_dims_saveable"
POLICY_NAMES = [None] + list(remat.POLICIES)
torch.set_num_threads(2)


def _tokens(vocab=256, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S),
                                                dtype=np.int32)


def _flash_calls(monkeypatch):
    """A counter of the port's flash forward calls."""
    calls = collections.Counter()
    real = tattn.flash_fwd

    def counted(*a, **k):
        calls["fwd"] += 1
        return real(*a, **k)
    monkeypatch.setattr(tattn, "flash_fwd", counted)
    return calls


def _port_loss_grads(cfg, params, tok, moe=False):
    model = (tmoe.MoETransformer if moe else ttf.Transformer)(
        cfg, device="cpu")
    model.load_state_dict((from_flax_moe_params if moe
                           else from_flax_params)(params))
    t = torch.from_numpy(tok).long()
    with remat.recording() as rec:
        out = model(t)
        loss = (tmoe.moe_lm_loss(out, t, cfg.aux_loss_weight) if moe
                else ttf.causal_lm_loss(out, t))
    loss.backward()
    grads = {k: p.grad.detach().clone()
             for k, p in model.named_parameters()}
    return loss.detach(), grads, rec


def _ref_loss_grads(jm, params, tok, moe=False):
    def loss(p):
        out = jm.apply({"params": p}, jnp.asarray(tok))
        return (jmoe.moe_lm_loss(out, jnp.asarray(tok),
                                 jm.cfg.aux_loss_weight) if moe
                else jtf.causal_lm_loss(out, jnp.asarray(tok)))
    value, g = jax.jit(jax.value_and_grad(loss))(params)
    return float(value), jax.tree.map(np.asarray, g)


def _dense_params(jcfg, tok):
    v = jtf.Transformer(jcfg).init(jax.random.key(0), jnp.asarray(tok))
    return jax.tree.map(np.asarray, fnn.meta.unbox(v)["params"])


DENSE_CASES = (
    [(attn, pol, 0, None) for attn in ("xla", "flash")
     for pol in POLICY_NAMES]
    + [("flash", NO_BATCH, 2, None), ("xla", "dots_saveable", 2, None),
       ("flash", NO_BATCH, 0, "int8"), ("flash", NO_BATCH, 0, "fp8_e4m3")])


@pytest.mark.parametrize(
    "attn,policy,skip,mode", DENSE_CASES,
    ids=[f"{a}-{p}-skip{s}-{m}" for a, p, s, m in DENSE_CASES])
def test_dense_loss_and_gradients_match_reference(attn, policy, skip, mode):
    kw = dict(remat=True, remat_policy=policy, remat_skip_every=skip,
              attn_impl=attn, matmul_dtype=mode)
    tok = _tokens(seed=3)
    jcfg = jtf.TransformerConfig.tiny(**kw)
    params = _dense_params(jcfg, tok)
    want, jgrads = _ref_loss_grads(jtf.Transformer(jcfg), params, tok)
    loss, grads, _ = _port_loss_grads(ttf.TransformerConfig.tiny(**kw),
                                      params, tok)
    flat = jax.tree_util.tree_flatten_with_path(to_flax_params(grads))[0]
    jflat = dict(jax.tree_util.tree_flatten_with_path(jgrads)[0])
    assert len(flat) == len(jflat)
    if mode == "fp8_e4m3":
        off, joff = _ref_loss_grads(
            jtf.Transformer(jtf.TransformerConfig.tiny(**dict(kw,
                                                              remat=False))),
            params, tok)
        np.testing.assert_allclose(want, off, **TOL)
        for path, g in jax.tree_util.tree_flatten_with_path(joff)[0]:
            np.testing.assert_allclose(jflat[path], g, **TOL)
        off_loss, off_grads, _ = _port_loss_grads(
            ttf.TransformerConfig.tiny(**dict(kw, remat=False)), params, tok)
        assert torch.equal(loss, off_loss)
        for k, g in grads.items():
            assert torch.equal(g, off_grads[k]), k
    else:
        np.testing.assert_allclose(loss.item(), want, **TOL)
        for path, g in flat:
            np.testing.assert_allclose(np.asarray(g), jflat[path], **TOL,
                                       err_msg=jax.tree_util.keystr(path))
    # Bit for bit the port's full remat.
    full_loss, full_grads, _ = _port_loss_grads(
        ttf.TransformerConfig.tiny(**dict(kw, remat_policy=None)), params,
        tok)
    assert torch.equal(loss, full_loss)
    for k, g in grads.items():
        assert torch.equal(g, full_grads[k]), k


_RESIDUAL = re.compile(r"^(\w+)\[([\d,]*)\] output of (.*)$")


def _ref_residuals(block, params, x, pos):
    """The outputs the reference's ``print_saved_residuals`` lists for
    ``block`` (remat'ed under its policy) on ``x``: [(numel, dtype name,
    what)]. The block's arguments and constants are left out, and so is
    the sin of the outer function that makes the cotangent."""
    def f(p, x):
        out = block.apply(p, x, pos)
        out = out[0] if isinstance(out, tuple) else out
        return jnp.sum(jnp.sin(out))

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        print_saved_residuals(f, params, x)
    out = []
    for line in buf.getvalue().splitlines():
        m = _RESIDUAL.match(line.strip())
        if not m or "_ref_residuals" in m.group(3):
            continue
        dims = [int(d) for d in m.group(2).split(",") if d]
        out.append((int(np.prod(dims)), m.group(1), m.group(3)))
    return out


_DTYPES = {torch.float32: "f32", torch.int32: "i32", torch.bfloat16: "bf16"}


def _port_kept(block, x, *args):
    """(kept [(numel, dtype name, site)], decided-not-kept sites, flash
    forward calls) of one block under its config's policy."""
    with remat.recording() as rec:
        out = remat.run(block, block_policy(block), x, *args)
    out = out[0] if isinstance(out, tuple) else out
    torch.sin(out).sum().backward()
    kept = [(int(np.prod(r["shape"])), _DTYPES[r["dtype"]], r["site"])
            for r in rec if r["kept"]]
    return kept, {r["site"] for r in rec if not r["kept"]}


def block_policy(block):
    return block.attn.cfg.remat_policy


def _block_inputs(seed):
    x = np.random.default_rng(seed).standard_normal(
        (B, S, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    return x, pos


def _layer_0(state_dict):
    """The first block's entries of a decoder's ``state_dict``."""
    return {k[len("layers.0."):]: v for k, v in state_dict.items()
            if k.startswith("layers.0.")}


def _multiset(items):
    return collections.Counter((n, d) for n, d, _ in items)


RESIDUAL_CASES = [(attn, pol, None)
                  for attn in ("xla", "flash")
                  for pol in ("nothing_saveable", NO_BATCH, "dots_saveable")
                  ] + [("flash", NO_BATCH, "int8"),
                       ("flash", "dots_saveable", "fp8_e4m3")]


@pytest.mark.parametrize(
    "attn,policy,mode", RESIDUAL_CASES,
    ids=[f"{a}-{p}-{m}" for a, p, m in RESIDUAL_CASES])
def test_dense_block_keeps_what_the_reference_keeps(attn, policy, mode,
                                                    monkeypatch):
    kw = dict(remat=True, remat_policy=policy, attn_impl=attn,
              matmul_dtype=mode)
    jcfg = jtf.TransformerConfig.tiny(**kw)
    params = _dense_params(jcfg, _tokens(seed=4))
    x, pos = _block_inputs(4)
    ref_block = fnn.remat(jtf.Block, prevent_cse=True, policy=getattr(
        jax.checkpoint_policies, policy))(jcfg)
    want = _ref_residuals(ref_block, {"params": params["layer_0"]},
                          jnp.asarray(x), jnp.asarray(pos))
    block = ttf.Block(ttf.TransformerConfig.tiny(**kw), torch.device("cpu"))
    block.load_state_dict(_layer_0(from_flax_params(params)))
    calls = _flash_calls(monkeypatch)
    kept, not_kept = _port_kept(block, torch.from_numpy(x).requires_grad_(),
                                torch.from_numpy(pos.copy()).long())
    assert _multiset(kept) == _multiset(want), (kept, want)
    sites = collections.Counter(site for _, _, site in kept)
    if policy == "nothing_saveable":
        assert not kept and not want
    else:
        # wq, wk, wv, wo, gate, up; never down.
        assert sites["projection"] == 6, sites
        assert "down" in not_kept
        # The plain attention's scores and output under dots_saveable
        # only; the flash path's products never.
        assert sites["attention"] == (2 if attn == "xla"
                                      and policy == "dots_saveable" else 0)
        assert ("flash" in not_kept) == (attn == "flash")
        # The reference keeps silu(gate) where the port keeps gate's
        # product (jax.nn.silu is jitted); quantized, it keeps both
        # accumulators.
        silu = [w for w in want if "'silu'" in w[2]]
        assert len(silu) == (0 if mode else 1), want
    if attn == "flash":
        assert calls["fwd"] == (1 if policy is None else 2), calls


def test_everything_saveable_runs_without_checkpoint(monkeypatch):
    """The reference keeps every output, the flash call's too: the port
    runs the block once, as with remat off, and equals it bit for bit."""
    tok = _tokens(seed=5)
    params = _dense_params(jtf.TransformerConfig.tiny(), tok)
    calls = _flash_calls(monkeypatch)
    runs = {}
    for name, kw in {"everything": dict(remat=True,
                                        remat_policy="everything_saveable"),
                     "off": dict(remat=False)}.items():
        calls.clear()
        runs[name] = _port_loss_grads(ttf.TransformerConfig.tiny(**kw),
                                      params, tok)
        assert calls["fwd"] == 2, (name, calls)        # 2 layers, once each
    assert torch.equal(runs["everything"][0], runs["off"][0])
    for k, g in runs["off"][1].items():
        assert torch.equal(runs["everything"][1][k], g), k


@pytest.mark.parametrize("name", remat.FACTORIES + ("no_such_policy",))
def test_refused_names_raise_the_reference_types(name):
    want = TypeError if name in remat.FACTORIES else AttributeError
    tok = _tokens(seed=6)
    jcfg = jtf.TransformerConfig.tiny(remat=True, remat_policy=name)
    with pytest.raises(want):
        params = _dense_params(jcfg, tok)
        _ref_loss_grads(jtf.Transformer(jcfg), params, tok)
    with pytest.raises(want, match=name):
        ttf.Transformer(ttf.TransformerConfig.tiny(remat=True,
                                                   remat_policy=name),
                        device="cpu")
    with pytest.raises(want, match=name):
        tmoe.MoETransformer(tmoe.MoEConfig.tiny_moe(remat=True,
                                                    remat_policy=name),
                            device="cpu")


def _rules():
    return fnn.logical_axis_rules(list(jsh.DEFAULT_RULES))


def _moe_params(jcfg, tok):
    with _rules():
        v = jmoe.MoETransformer(jcfg).init(jax.random.key(0),
                                           jnp.asarray(tok))
    return jax.tree.map(np.asarray, fnn.meta.unbox(v)["params"])


@pytest.mark.parametrize("policy", ["dots_saveable", NO_BATCH])
def test_moe_matches_reference_under_dots_policies(policy):
    kw = dict(remat=True, remat_policy=policy, attn_impl="xla")
    tok = _tokens(seed=7)
    jcfg = jmoe.MoEConfig.tiny_moe(**kw)
    params = _moe_params(jcfg, tok)
    with _rules():
        want, jgrads = _ref_loss_grads(jmoe.MoETransformer(jcfg), params,
                                       tok, moe=True)
    loss, grads, rec = _port_loss_grads(tmoe.MoEConfig.tiny_moe(**kw),
                                        params, tok, moe=True)
    np.testing.assert_allclose(loss.item(), want, **TOL)
    flat = jax.tree_util.tree_flatten_with_path(to_flax_moe_params(grads))[0]
    jflat = dict(jax.tree_util.tree_flatten_with_path(jgrads)[0])
    assert len(flat) == len(jflat)
    for path, g in flat:
        np.testing.assert_allclose(np.asarray(g), jflat[path], **TOL,
                                   err_msg=jax.tree_util.keystr(path))
    # One block's kept products against the reference's residuals.
    x, pos = _block_inputs(8)
    ref_block = fnn.remat(jmoe.MoEBlock, prevent_cse=True, policy=getattr(
        jax.checkpoint_policies, policy))(jcfg)
    with _rules():
        ref = _ref_residuals(ref_block, {"params": params["layer_0"]},
                             jnp.asarray(x), jnp.asarray(pos))
    block = tmoe.MoEBlock(tmoe.MoEConfig.tiny_moe(**kw), torch.device("cpu"))
    block.load_state_dict(_layer_0(from_flax_moe_params(params)))
    kept, not_kept = _port_kept(block, torch.from_numpy(x).requires_grad_(),
                                torch.from_numpy(pos.copy()).long())
    assert _multiset(kept) == _multiset(ref), (kept, ref)
    sites = collections.Counter(site for _, _, site in kept)
    assert sites["router"] == 1 and sites["dispatch"] == 1, sites
    assert sites["experts"] == (3 if policy == "dots_saveable" else 0)
    assert "combine" in not_kept


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
POLICIES, LR, STEPS = %(consts)r
params0 = torch.load(os.path.join(tmp, "w.pt"))
tokens = np.load(os.path.join(tmp, "tokens.npy"))
mesh = build_mesh(MeshSpec(ep=2), "cpu")
rows = process_batch_slice(tokens.shape[1], mesh=mesh)
out = {}
for policy in POLICIES:
    cfg = tmoe.MoEConfig.tiny_moe(remat=True, remat_policy=policy,
                                  attn_impl="xla")
    state, _ = init_sharded_state(lambda d: tmoe.MoETransformer(cfg, device=d),
                                  lambda g: adamw(g, LR), mesh)
    set_model_state_dict(state.model, dict(params0),
                         options=StateDictOptions(full_state_dict=True))

    def loss_fn(m, batch):
        tok = batch["tokens"]
        return tmoe.moe_lm_loss(m(tok), tok, cfg.aux_loss_weight), {}

    losses = []
    for s in range(STEPS):
        state, m = sharded_train_step(
            loss_fn, mesh, state,
            {"tokens": torch.from_numpy(tokens[s, rows]).long()})
        losses.append(m["loss"].item())
    out[policy] = dict(losses=losses, params={
        k: (p.full_tensor() if isinstance(p, DTensor) else p).detach().clone()
        for k, p in state.model.named_parameters()})
torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
dist.barrier()
dist.destroy_process_group()
"""

EP_POLICIES = (None, "dots_saveable", NO_BATCH)
EP_LR, EP_STEPS = 1e-3, 2


def _ref_ep(params0, tokens, policy):
    cfg = jmoe.MoEConfig.tiny_moe(remat=True, remat_policy=policy,
                                  attn_impl="xla")
    model = jmoe.MoETransformer(cfg)
    mesh = build_mesh(MeshSpec(ep=2), devices=jax.devices()[:2])
    state, sh = init_sharded_state(model, jnp.asarray(tokens[0]),
                                   optax.adamw(EP_LR), mesh)
    state = state.replace(params=jax.device_put(params0, sh.params))

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
        for s in range(EP_STEPS):
            state, loss = step(state, jnp.asarray(tokens[s]))
            losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, state.params)


def test_moe_ep2_recomputes_its_all_to_all(tmp_path):
    tokens = np.random.default_rng(9).integers(
        0, 256, (EP_STEPS, 4, S)).astype(np.int32)
    params0 = _moe_params(jmoe.MoEConfig.tiny_moe(), tokens[0])
    torch.save(from_flax_moe_params(params0), tmp_path / "w.pt")
    np.save(tmp_path / "tokens.npy", tokens)
    script = tmp_path / "rank.py"
    script.write_text(_RANK_SCRIPT % {"consts": (EP_POLICIES, EP_LR,
                                                 EP_STEPS)})
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), "2", str(tmp_path)], env=env,
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    try:
        ref = {p: _ref_ep(params0, tokens, p) for p in EP_POLICIES[1:]}
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    got = torch.load(tmp_path / "out0.pt")
    full = got[None]
    for policy in EP_POLICIES[1:]:
        run = got[policy]
        assert run["losses"] == full["losses"], policy
        for k, v in run["params"].items():
            assert torch.equal(v, full["params"][k]), (policy, k)
        want_losses, want_params = ref[policy]
        np.testing.assert_allclose(run["losses"], want_losses, **TOL)
        flat = jax.tree_util.tree_flatten_with_path(
            to_flax_moe_params(run["params"]))[0]
        jflat = dict(jax.tree_util.tree_flatten_with_path(want_params)[0])
        for path, v in flat:
            w = jflat[path]
            rel = np.linalg.norm(np.asarray(v, np.float64) - w) / \
                max(np.linalg.norm(w), 1e-30)
            assert rel < 1e-5, (policy, jax.tree_util.keystr(path), rel)
