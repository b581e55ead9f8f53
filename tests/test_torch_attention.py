"""Port parity: tony_tpu_torch.ops.attention (plain PyTorch path on the CPU)
against tony_tpu.ops.attention (Pallas kernels in interpret mode, and the
XLA reference), fed the same numpy inputs.

Tolerances are the reference's own (tests/test_ops.py): f32 2e-5 forward
and 1e-4 on gradients, bf16 3e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.ops import attention as jattn
from tony_tpu_torch.ops import _flash_cuda
from tony_tpu_torch.ops import attention as tattn

F32 = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=3e-2, rtol=3e-2)
# The shapes are small; two intra-op threads keep this file from crowding
# the timing-sensitive e2e tests that share the host.
torch.set_num_threads(2)


def _qkv(b=2, s=128, h=4, d=32, hk=None, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, n, d), dtype=np.float32)
                 for n in (h, hk or h, hk or h))


def _torch(*xs, dtype=torch.float32, grad=False):
    return tuple(torch.from_numpy(x).to(dtype).requires_grad_(grad)
                 for x in xs)


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_jax_flash_and_reference(causal):
    q, k, v = _qkv()
    out = tattn.flash_attention(*_torch(q, k, v), causal=causal,
                                block_q=32, block_k=32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    np.testing.assert_allclose(
        _np(out), jattn.flash_attention(jq, jk, jv, causal=causal,
                                        block_q=32, block_k=32), **F32)
    np.testing.assert_allclose(
        _np(out), jattn.reference_attention(jq, jk, jv, causal=causal),
        **F32)


@pytest.mark.parametrize("causal", [True, False])
def test_reference_attention_matches_jax(causal):
    q, k, v = _qkv(s=48, seed=1)
    out = tattn.reference_attention(*_torch(q, k, v), causal=causal)
    ref = jattn.reference_attention(*map(jnp.asarray, (q, k, v)),
                                    causal=causal)
    np.testing.assert_allclose(_np(out), ref, **F32)


def test_flash_gqa_heads_h8_hk2():
    q, k, v = _qkv(h=8, hk=2)
    out = tattn.flash_attention(*_torch(q, k, v), block_q=32, block_k=32)
    ref = jattn.flash_attention(*map(jnp.asarray, (q, k, v)), block_q=32,
                                block_k=32)
    np.testing.assert_allclose(_np(out), ref, **F32)


def _grads_vs_jax(q, k, v, causal, block):
    tq, tk, tv = _torch(q, k, v, grad=True)
    (tattn.flash_attention(tq, tk, tv, causal=causal, block_q=block,
                           block_k=block) ** 2).sum().backward()

    def loss(q, k, v):
        return jnp.sum(jattn.flash_attention(q, k, v, causal=causal,
                                             block_q=block,
                                             block_k=block) ** 2)
    jg = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for t, j, name in zip((tq, tk, tv), jg, "qkv"):
        np.testing.assert_allclose(_np(t.grad), j, **GRAD,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_flash_gradients_match_jax(causal):
    _grads_vs_jax(*_qkv(b=1, s=64, h=2, d=16), causal, 16)


def test_flash_gqa_gradients_match_jax():
    _grads_vs_jax(*_qkv(b=1, s=64, h=8, hk=2, d=16, seed=3), True, 16)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_ragged_seq_100_blocks_32(causal):
    """S = 100 is not a multiple of the 32-row blocks: the padded tail must
    not reach the softmax or the gradients."""
    q, k, v = _qkv(b=1, s=100, h=2, d=16, seed=4)
    out = tattn.flash_attention(*_torch(q, k, v), causal=causal, block_q=32,
                                block_k=32)
    ref = jattn.reference_attention(*map(jnp.asarray, (q, k, v)),
                                    causal=causal)
    np.testing.assert_allclose(_np(out), ref, **F32)
    _grads_vs_jax(q, k, v, causal, 32)


def test_flash_bf16():
    q, k, v = _qkv(seed=5)
    out = tattn.flash_attention(*_torch(q, k, v, dtype=torch.bfloat16),
                                block_q=32, block_k=32)
    assert out.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    jout = jattn.flash_attention(jq, jk, jv, block_q=32, block_k=32)
    np.testing.assert_allclose(_np(out), np.asarray(jout, np.float32),
                               **BF16)
    ref = jattn.reference_attention(*(x.astype(jnp.float32)
                                      for x in (jq, jk, jv)))
    np.testing.assert_allclose(_np(out), ref, **BF16)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_with_lse_matches_jax(causal):
    q, k, v = _qkv(b=2, s=64, h=4, hk=2, d=16, seed=6)
    o, lse = tattn.flash_attention_with_lse(*_torch(q, k, v), causal=causal,
                                            block_q=32, block_k=32)
    jo, jlse = jattn.flash_attention_with_lse(
        *map(jnp.asarray, (q, k, v)), causal=causal, block_q=32, block_k=32)
    assert lse.shape == (2, 64, 4) and lse.dtype == torch.float32
    np.testing.assert_allclose(_np(o), jo, **F32)
    np.testing.assert_allclose(_np(lse), jlse, **F32)


def test_flash_with_lse_out_dtype_f32_from_bf16():
    q, k, v = _qkv(b=1, s=64, h=2, d=16, seed=7)
    o, lse = tattn.flash_attention_with_lse(
        *_torch(q, k, v, dtype=torch.bfloat16), block_q=32, block_k=32,
        out_dtype=torch.float32)
    assert o.dtype == torch.float32
    jo, jlse = jattn.flash_attention_with_lse(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
        block_q=32, block_k=32, out_dtype=jnp.float32)
    np.testing.assert_allclose(_np(o), jo, **BF16)
    np.testing.assert_allclose(_np(lse), jlse, **BF16)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_with_lse_out_f32_row_sum_matches_jax(d):
    """The row sum l of the forward at out_dtype=f32: below head_dim 128 the
    reference sums P rounded to bf16 (its ones-column P·V product), from
    128 up the f32 P. Both sides share the 128-row block partition; S = 200
    leaves a ragged tail.

    The means are held at 2e-6: a port summing the f32 P at d = 64 is off by
    ~2e-4 in the mean of lse. The maxima are held at the file's bf16
    tolerance, not tighter: torch's and XLA's f32 exp differ by an ulp at
    some arguments, which now and then puts one P on the other side of a
    bf16 rounding and moves that row's o by up to ~3e-4."""
    rng = np.random.default_rng(d)
    q, k, v = (rng.standard_normal((1, 200, n, d), dtype=np.float32)
               for n in (4, 2, 2))
    o, lse = tattn.flash_attention_with_lse(
        *_torch(q, k, v, dtype=torch.bfloat16), causal=True, block_q=128,
        block_k=128, out_dtype=torch.float32)
    jo, jlse = jattn.flash_attention_with_lse(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
        causal=True, block_q=128, block_k=128, out_dtype=jnp.float32)
    for name, t, j in (("o", o, jo), ("lse", lse, jlse)):
        err = np.abs(_np(t) - np.asarray(j))
        assert err.mean() <= 2e-6, f"{name}: mean abs err {err.mean()}"
        np.testing.assert_allclose(_np(t), j, **BF16, err_msg=name)


def test_flash_with_lse_gradient_flows_through_lse():
    """A loss of both o and lse (as the ring merge uses them): the dlse
    cotangent must match jax.grad of the reference kernels."""
    q, k, v = _qkv(b=1, s=32, h=4, hk=2, d=16, seed=8)
    tq, tk, tv = _torch(q, k, v, grad=True)
    o, lse = tattn.flash_attention_with_lse(tq, tk, tv, block_q=16,
                                            block_k=16)
    ((o ** 2).sum() + torch.sin(lse).sum()).backward()

    def loss(q, k, v):
        o, lse = jattn.flash_attention_with_lse(q, k, v, block_q=16,
                                                block_k=16)
        return jnp.sum(o ** 2) + jnp.sum(jnp.sin(lse))
    jg = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for t, j, name in zip((tq, tk, tv), jg, "qkv"):
        np.testing.assert_allclose(_np(t.grad), j, **GRAD,
                                   err_msg=f"d{name}")


def test_flash_with_lse_gradient_of_lse_alone():
    q, k, v = _qkv(b=1, s=32, h=2, d=16, seed=9)
    tq, tk, tv = _torch(q, k, v, grad=True)
    _, lse = tattn.flash_attention_with_lse(tq, tk, tv, causal=False,
                                            block_q=16, block_k=16)
    lse.sum().backward()
    jg = jax.grad(lambda q, k, v: jnp.sum(jattn.flash_attention_with_lse(
        q, k, v, causal=False, block_q=16, block_k=16)[1]),
        argnums=(0, 1))(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(_np(tq.grad), jg[0], **GRAD)
    np.testing.assert_allclose(_np(tk.grad), jg[1], **GRAD)
    np.testing.assert_allclose(_np(tv.grad), 0.0, atol=1e-7)


@pytest.mark.parametrize("d", [64, 128])
def test_plain_backward_gqa4_ragged_causal_matches_jax_grad(d):
    """The plain dq and dk/dv, which chip_smoke.py holds the bf16 wgmma
    kernels against on the card, against jax.grad of the reference
    attention at the structure of its new cases: GQA group 4, causal, a
    sequence the 32-row blocks do not divide, head_dim 64 and 128."""
    b, s, h, hk = 1, 100, 8, 2
    q, k, v = _qkv(b=b, s=s, h=h, hk=hk, d=d, seed=11)
    do = np.random.default_rng(12).standard_normal(q.shape, dtype=np.float32)
    scale = d ** -0.5
    tq, tk, tv, tdo = _torch(q, k, v, do)
    o, lse = tattn.flash_fwd_plain(tq, tk, tv, scale, True, block_q=32,
                                   block_k=32)
    delta = (o * tdo).sum(-1).transpose(1, 2).contiguous()
    dq = tattn.flash_bwd_dq_plain(tq, tk, tv, tdo, lse, delta, scale, True,
                                  32, 32)
    dk, dv = tattn.flash_bwd_dkv_plain(tq, tk, tv, tdo, lse, delta, scale,
                                       True, 32, 32)
    g = h // hk

    def loss(q, k, v):
        o = jattn.reference_attention(q, jnp.repeat(k, g, axis=2),
                                      jnp.repeat(v, g, axis=2), causal=True)
        return jnp.sum(o * do)
    jg = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for t, j, name in zip((dq, dk, dv), jg, "qkv"):
        assert t.shape == j.shape
        np.testing.assert_allclose(_np(t), j, **GRAD, err_msg=f"d{name}")


@pytest.mark.parametrize("case,match", [
    ("kv_heads", "k heads"),
    ("causal_seq", "requires seq_q == seq_k"),
    ("group", "not a multiple of kv heads"),
])
def test_flash_value_errors_match_reference(case, match):
    q, k, v = _qkv(b=1, s=32, h=4, hk=2, d=16)
    causal = True
    if case == "kv_heads":
        v = v[:, :, :1]
    elif case == "causal_seq":
        k, v = k[:, :16], v[:, :16]
    else:
        q = np.concatenate([q, q[:, :, :1]], axis=2)        # 5 heads over 2
        causal = False
    with pytest.raises(ValueError, match=match):
        tattn.flash_attention(*_torch(q, k, v), causal=causal)
    with pytest.raises(ValueError, match=match):
        jattn.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal)


def test_kernel_entry_refuses_cpu_tensors():
    """The CUDA wrappers take CUDA tensors only: a CPU tensor handed to a
    kernel entry raises instead of running anything."""
    q, k, v = _torch(*_qkv(b=1, s=32, h=2, d=64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        _flash_cuda.flash_fwd(q, k, v, 0.125, True)
    lse = torch.zeros((1, 2, 32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        _flash_cuda.flash_bwd_dq(q, k, v, q, lse, lse, 0.125, True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _flash_cuda.flash_bwd_dkv(q, k, v, q, lse, lse, 0.125, True)
    with pytest.raises(TypeError, match="bf16 or f32"):
        _flash_cuda.flash_fwd(q.half(), k.half(), v.half(), 0.125, True)


def test_dispatch_refuses_other_devices():
    q, k, v = (torch.empty((1, 16, 2, 64), device="meta") for _ in range(3))
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        tattn.flash_attention(q, k, v)
