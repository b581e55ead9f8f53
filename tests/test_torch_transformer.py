"""Port parity: tony_tpu_torch.models.transformer against
tony_tpu.models.transformer with the same weights (converted from the flax
tree) and the same tokens.

Tolerances: f32 logits, losses and every parameter's gradient at
atol/rtol 1e-4 (the flash gradient tolerance of tests/test_ops.py); the
bf16 model's logits at 5e-2 (bf16 rounds at other places in the two
frameworks).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import transformer as jtf
from tony_tpu_torch.convert import from_flax_params, to_flax_params
from tony_tpu_torch.models import transformer as ttf

TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 32
# The shapes are small; two intra-op threads keep this file from crowding
# the timing-sensitive e2e tests that share the host.
torch.set_num_threads(2)


def _tokens(vocab=256, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S),
                                                dtype=np.int32)


def _pair(jdtype=jnp.float32, tdtype=torch.float32, **kw):
    """(flax model, numpy params, port model loaded with the same
    weights)."""
    jcfg = jtf.TransformerConfig.tiny(dtype=jdtype, **kw)
    jm = jtf.Transformer(jcfg)
    params = fnn.meta.unbox(jm.init(jax.random.key(0),
                                    jnp.asarray(_tokens()))["params"])
    params = jax.tree.map(np.asarray, params)
    tm = ttf.Transformer(ttf.TransformerConfig.tiny(dtype=tdtype, **kw),
                         device="cpu")
    tm.load_state_dict(from_flax_params(params))
    return jm, params, tm


@pytest.mark.parametrize("attn_impl", ["flash", "xla"])
def test_logits_and_loss_match_f32(attn_impl):
    jm, params, tm = _pair(attn_impl=attn_impl)
    tok = _tokens()
    jlogits = jm.apply({"params": params}, jnp.asarray(tok))
    with torch.no_grad():
        tlogits = tm(torch.from_numpy(tok).long())
    assert tlogits.dtype == torch.float32
    np.testing.assert_allclose(tlogits.numpy(), jlogits, **TOL)
    tl = ttf.causal_lm_loss(tlogits, torch.from_numpy(tok).long())
    jl = jtf.causal_lm_loss(jlogits, jnp.asarray(tok))
    np.testing.assert_allclose(tl.item(), float(jl), **TOL)


def test_bf16_logits_match():
    jm, params, tm = _pair(jdtype=jnp.bfloat16, tdtype=torch.bfloat16)
    tok = _tokens(seed=1)
    jlogits = jm.apply({"params": params}, jnp.asarray(tok))
    with torch.no_grad():
        tlogits = tm(torch.from_numpy(tok).long())
    np.testing.assert_allclose(tlogits.numpy(), jlogits, atol=5e-2,
                               rtol=5e-2)


@pytest.mark.parametrize("remat", [False, True])
def test_every_gradient_matches_jax_grad(remat):
    """Gradients of causal_lm_loss for every parameter, remat on and off
    (remat_skip_every=2 with remat on: layer 0 runs un-checkpointed)."""
    kw = dict(remat=remat, remat_skip_every=2 if remat else 0)
    jm, params, tm = _pair(**kw)
    tok = _tokens(seed=2)

    def jloss(p):
        return jtf.causal_lm_loss(jm.apply({"params": p}, jnp.asarray(tok)),
                                  jnp.asarray(tok))
    jl, jg = jax.value_and_grad(jloss)(params)
    tt = torch.from_numpy(tok).long()
    tl = ttf.causal_lm_loss(tm(tt), tt)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), **TOL)
    tg = to_flax_params({n: p.grad for n, p in tm.named_parameters()})
    jflat = dict(jax.tree_util.tree_leaves_with_path(jg))
    tflat = dict(jax.tree_util.tree_leaves_with_path(tg))
    assert set(map(str, jflat)) == set(map(str, tflat))
    for path, g in jflat.items():
        np.testing.assert_allclose(tflat[path], g, **TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_chunked_loss_equals_full_loss_and_jax():
    jm, params, tm = _pair()
    tok = _tokens(seed=3)
    tt = torch.from_numpy(tok).long()
    hidden = tm(tt, return_hidden=True)
    kernel = tm.lm_head.weight.T
    chunked = ttf.chunked_causal_lm_loss(hidden, kernel, tt, chunk_size=8)
    full = ttf.causal_lm_loss(tm(tt), tt)
    np.testing.assert_allclose(chunked.item(), full.item(), **TOL)
    jh = jm.apply({"params": params}, jnp.asarray(tok), return_hidden=True)
    jchunked = jtf.chunked_causal_lm_loss(
        jh, jnp.asarray(params["lm_head"]["kernel"]), jnp.asarray(tok),
        chunk_size=8)
    np.testing.assert_allclose(chunked.item(), float(jchunked), **TOL)
    # The checkpointed chunks carry the same gradient as the full loss.
    g_chunk = torch.autograd.grad(chunked, tm.lm_head.weight)[0]
    g_full = torch.autograd.grad(ttf.causal_lm_loss(tm(tt), tt),
                                 tm.lm_head.weight)[0]
    np.testing.assert_allclose(g_chunk.numpy(), g_full.numpy(), **TOL)


def test_masked_losses_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((B, S, 64), dtype=np.float32)
    tok = rng.integers(0, 64, (B, S), dtype=np.int32)
    mask = (rng.random((B, S)) > 0.3).astype(np.float32)
    tl = ttf.causal_lm_loss(torch.from_numpy(logits),
                            torch.from_numpy(tok).long(),
                            torch.from_numpy(mask))
    jl = jtf.causal_lm_loss(jnp.asarray(logits), jnp.asarray(tok),
                            jnp.asarray(mask))
    np.testing.assert_allclose(tl.item(), float(jl), **TOL)


def test_tied_embeddings_logits_match():
    jm, params, tm = _pair(tie_embeddings=True)
    assert "lm_head" not in params and tm.lm_head is None
    tok = _tokens(seed=5)
    jlogits = jm.apply({"params": params}, jnp.asarray(tok))
    with torch.no_grad():
        tlogits = tm(torch.from_numpy(tok).long())
    np.testing.assert_allclose(tlogits.numpy(), jlogits, **TOL)


def test_rope_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, S, 4, 16), dtype=np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    out = ttf._rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                    500000.0)
    ref = jtf._rope(jnp.asarray(x), jnp.asarray(pos), 500000.0)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_max_seq_len_guard():
    tm = ttf.Transformer(ttf.TransformerConfig.tiny(max_seq_len=16),
                         device="cpu")
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        tm(torch.zeros((1, 17), dtype=torch.long))


@pytest.mark.parametrize("kw,match", [
    (dict(attn_impl="ring"), "pp=2"),
    (dict(attn_impl="ulysses"), "pp=2"),
])
def test_later_slices_raise_not_implemented(kw, match):
    """Ring and Ulysses build (the sequence-parallel slice is in); laying
    the model out on a pipeline axis, a later slice, raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from tony_tpu_torch.parallel import MeshSpec, build_mesh, shard_model

    cfg = ttf.TransformerConfig.tiny(**kw)
    ttf.Transformer(cfg, device="cpu")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=2)
    try:
        mesh = build_mesh(MeshSpec(pp=2, dp=1), "cpu")
        with pytest.raises(NotImplementedError, match=match):
            shard_model(ttf.Transformer(cfg, device="meta"), mesh)
    finally:
        dist.destroy_process_group()


def test_configs_carry_the_reference_geometry():
    for name in ("tiny", "llama3_8b"):
        j = getattr(jtf.TransformerConfig, name)()
        t = getattr(ttf.TransformerConfig, name)()
        for f in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
                  "mlp_dim", "max_seq_len", "rope_theta", "norm_eps",
                  "remat", "attn_block_q", "attn_block_k"):
            assert getattr(t, f) == getattr(j, f), (name, f)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttf.Transformer(ttf.TransformerConfig.tiny())
