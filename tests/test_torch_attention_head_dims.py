"""Port parity at every head_dim the flash kernels take besides 64 and 128:
``tony_tpu_torch.ops.attention``'s plain versions (what a CPU tensor runs,
and what the card's kernels are held to) against ``tony_tpu.ops.attention``
(the Pallas kernels in interpret mode) on the same numpy inputs, at
d = 8, 16, 20, 32, 80, 96, 100, 136, 192 and 256, and past 256 (the split
FMA family's head dims) at d = 264, 384 and 512; ``_flash_cuda.route``,
which sends each (head_dim, dtype, kernel) to a kernel family and a
compiled tile width, against the widths each C entry point launches; and
``fwd_key_tile``, the key tile of the routed forward kernel.

Tolerances are ``tests/test_torch_attention.py``'s (the reference's own):
f32 2e-5 forward and 1e-4 on gradients, bf16 3e-2. The bf16 forward with
an f32 output also holds the mean error of o and lse at 2e-6: below
head_dim 128 the row sum adds P rounded to bf16 (the reference's
``fused_rowsum``), and summing the f32 P there moves lse's mean by ~1e-4.
"""

import pathlib
import re

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
HEAD_DIMS = (8, 16, 32, 80, 96, 256)
# Past 256: two whole chunks of 256 and a narrower last chunk (264, 384).
SPLIT_DIMS = (264, 384, 512)
# The highest head_dim the route tests sweep to: four chunks.
SWEEP_TO = 1024
BLOCK = 32
CSRC = pathlib.Path(tattn.__file__).resolve().parents[1] / "csrc"
torch.set_num_threads(2)


def _qkv(b, s, h, hk, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, n, d), dtype=np.float32)
                 for n in (h, hk, hk))


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("d", HEAD_DIMS + SPLIT_DIMS)
def test_forward_bf16_to_f32_out_matches_jax(d):
    """o and lse of a bf16 causal GQA forward with an f32 output (the ring's
    hop): S = 100 leaves a ragged tail in the 32-row blocks both share."""
    q, k, v = _qkv(2, 100, 4, 2, d, seed=d)
    o, lse = tattn.flash_attention_with_lse(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)), causal=True,
        block_q=BLOCK, block_k=BLOCK, out_dtype=torch.float32)
    assert o.dtype == torch.float32 and o.shape == (2, 100, 4, d)
    jo, jlse = jattn.flash_attention_with_lse(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
        causal=True, block_q=BLOCK, block_k=BLOCK, out_dtype=jnp.float32)
    for name, t, j in (("o", o, jo), ("lse", lse, jlse)):
        err = np.abs(_np(t) - np.asarray(j))
        assert err.mean() <= 2e-6, f"{name}: mean abs err {err.mean()}"
        np.testing.assert_allclose(_np(t), j, **BF16, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", HEAD_DIMS + SPLIT_DIMS)
def test_forward_f32_matches_jax(d, causal):
    q, k, v = _qkv(1, 64, 4, 2, d, seed=10 + d)
    o, lse = tattn.flash_attention_with_lse(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        block_q=BLOCK, block_k=BLOCK)
    jo, jlse = jattn.flash_attention_with_lse(
        *map(jnp.asarray, (q, k, v)), causal=causal, block_q=BLOCK,
        block_k=BLOCK)
    np.testing.assert_allclose(_np(o), jo, **F32)
    np.testing.assert_allclose(_np(lse), jlse, **F32)


@pytest.mark.parametrize("d", HEAD_DIMS + (192, 20, 100) + SPLIT_DIMS)
def test_backward_gqa4_ragged_causal_matches_jax_grad(d):
    """dq, dk and dv through the port's autograd Function (the plain dq and
    dk/dv) against ``jax.grad`` of the reference's flash kernels: GQA group
    4, causal, S = 100 over 32-row blocks, a loss of o and of lse. d = 20
    and 100 are rows off a 16-byte vector in bf16 (the FMA kernels at width
    32 and 128)."""
    q, k, v = _qkv(1, 100, 8, 2, d, seed=20 + d)
    w = np.random.default_rng(30 + d).standard_normal(q.shape,
                                                      dtype=np.float32)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    o, lse = tattn.flash_attention_with_lse(tq, tk, tv, causal=True,
                                            block_q=BLOCK, block_k=BLOCK)
    ((o * torch.from_numpy(w)).sum() + torch.sin(lse).sum()).backward()

    def loss(q, k, v):
        o, lse = jattn.flash_attention_with_lse(q, k, v, causal=True,
                                                block_q=BLOCK, block_k=BLOCK)
        return jnp.sum(o * w) + jnp.sum(jnp.sin(lse))
    jg = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for t, j, name in zip((tq, tk, tv), jg, "qkv"):
        assert t.grad.shape == j.shape
        np.testing.assert_allclose(_np(t.grad), j, **GRAD,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("d", SPLIT_DIMS)
def test_with_lse_cotangent_full_mha_matches_jax_grad(d):
    """``flash_attention_with_lse`` past head_dim 256 through the port's
    autograd Function, non-causal, one query head a kv head (the ring's full
    hops), a loss of o and of lse (the lse cotangent the ring's merge
    gives): dq, dk and dv against ``jax.grad`` of the reference's kernels,
    f32, S = 64."""
    q, k, v = _qkv(1, 64, 2, 2, d, seed=50 + d)
    w = np.random.default_rng(51 + d).standard_normal(q.shape,
                                                      dtype=np.float32)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    o, lse = tattn.flash_attention_with_lse(tq, tk, tv, causal=False,
                                            block_q=BLOCK, block_k=BLOCK)
    ((o * torch.from_numpy(w)).sum() + torch.cos(lse).sum()).backward()

    def loss(q, k, v):
        o, lse = jattn.flash_attention_with_lse(q, k, v, causal=False,
                                                block_q=BLOCK, block_k=BLOCK)
        return jnp.sum(o * w) + jnp.sum(jnp.cos(lse))
    jg = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for t, j, name in zip((tq, tk, tv), jg, "qkv"):
        np.testing.assert_allclose(_np(t.grad), j, **GRAD,
                                   err_msg=f"d{name}")


def _lse_rounded_sum(q, k, d, block):
    """lse of a causal bf16 forward whose row sum adds P rounded to bf16
    over ``block``-key tiles (the rule below head_dim 128), at any d: the
    plain forward's loop with that rule forced."""
    qs = (q * torch.tensor(d ** -0.5, dtype=torch.bfloat16)).float()
    s = qs.transpose(1, 2) @ k.float().permute(0, 2, 3, 1)   # [B, H, S, S]
    n = s.shape[-1]
    s = s.masked_fill(~torch.ones(n, n, dtype=torch.bool).tril(), -1e30)
    m = torch.full(s.shape[:3] + (1,), -1e30)
    l = torch.zeros_like(m)
    for k0 in range(0, n, block):
        t = s[..., k0:k0 + block]
        m_new = torch.maximum(m, t.amax(-1, keepdim=True))
        p = torch.exp(t - m_new).bfloat16().float()
        l = l * torch.exp(m - m_new) + p.sum(-1, keepdim=True)
        m = m_new
    return (m + torch.log(l.clamp_min(1e-30)))[..., 0]


def _jax_lse(q, k, v, block):
    _, jlse = jattn.flash_attention_with_lse(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
        causal=True, block_q=block, block_k=block, out_dtype=jnp.float32)
    return np.asarray(jlse).transpose(0, 2, 1)


def test_bf16_forward_row_sum_rule_follows_the_true_head_dim():
    """At d = 96 (the 128-wide wgmma tile on the card) the row sum adds the
    rounded P, as the reference does below 128; the f32 P's sum differs
    from the reference's lse by an order of magnitude more in the mean. At
    d = 192 (the 256-wide tile, a narrower head) the rule flips: the f32
    sum matches the reference, the rounded sum is 10x further off."""
    q, k, v = _qkv(1, 100, 2, 2, 96, seed=7)
    args = [torch.from_numpy(x).bfloat16() for x in (q, k, v)]
    _, lse = tattn.flash_fwd_plain(*args, 96 ** -0.5, True, torch.float32,
                                   BLOCK, BLOCK)
    jlse = _jax_lse(q, k, v, BLOCK)
    rounded = np.abs(_np(lse) - jlse).mean()
    # The f32 row sum, as from 128 up: sum_j exp(s_ij - lse_i) = 1 exactly.
    qs = (args[0] * torch.tensor(96 ** -0.5, dtype=torch.bfloat16)).float()
    kt = args[1].float().permute(0, 2, 3, 1)             # [B, H, D, S]
    s = qs.transpose(1, 2) @ kt
    s = s.masked_fill(~torch.ones(100, 100, dtype=torch.bool).tril(), -1e30)
    f32_lse = torch.logsumexp(s, -1)
    assert rounded <= 2e-6
    assert np.abs(_np(f32_lse) - jlse).mean() > 10 * rounded
    assert np.abs(_np(_lse_rounded_sum(args[0], args[1], 96, BLOCK))
                  - jlse).mean() <= 2e-6

    q, k, v = _qkv(1, 100, 2, 2, 192, seed=8)
    args = [torch.from_numpy(x).bfloat16() for x in (q, k, v)]
    _, lse = tattn.flash_fwd_plain(*args, 192 ** -0.5, True, torch.float32,
                                   BLOCK, BLOCK)
    jlse = _jax_lse(q, k, v, BLOCK)
    f32_sum = np.abs(_np(lse) - jlse).mean()
    assert f32_sum <= 2e-6
    assert np.abs(_np(_lse_rounded_sum(args[0], args[1], 192, BLOCK))
                  - jlse).mean() > 10 * f32_sum


@pytest.mark.parametrize("d", [136, 192, 256])
def test_forward_over_the_width_256_key_tile_matches_jax(d):
    """The plain forward the card's width-256 kernel is held to, over that
    kernel's key tiles (``fwd_key_tile``): bf16 in, f32 out, causal GQA,
    S = 200 (a ragged last tile), against the reference's kernels in
    interpret mode at the same blocks; o and lse also in the mean."""
    tile = _flash_cuda.fwd_key_tile(d, torch.bfloat16)
    q, k, v = _qkv(1, 200, 4, 2, d, seed=40 + d)
    o, lse = tattn.flash_fwd_plain(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)), d ** -0.5,
        True, torch.float32, tile, tile)
    jo, jlse = jattn.flash_attention_with_lse(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
        causal=True, block_q=tile, block_k=tile, out_dtype=jnp.float32)
    jlse = np.asarray(jlse).transpose(0, 2, 1)
    for name, t, j in (("o", o, jo), ("lse", lse, jlse)):
        err = np.abs(_np(t) - np.asarray(j))
        assert err.mean() <= 2e-6, f"{name}: mean abs err {err.mean()}"
        np.testing.assert_allclose(_np(t), j, **BF16, err_msg=name)


@pytest.mark.parametrize("d,dtype", [
    (20, torch.bfloat16), (100, torch.bfloat16), (140, torch.bfloat16),
    (16, torch.float32), (256, torch.float32)])
def test_forward_over_the_fma_key_tile_matches_jax(d, dtype):
    """The plain forward the card's FMA kernel is held to, over that
    kernel's key tiles (``fwd_key_tile``): causal GQA, S = 200 (a ragged
    last tile), f32 out, against the reference's kernels in interpret mode
    at the same blocks; bf16 (off a multiple of 8) also in the mean."""
    tile = _flash_cuda.fwd_key_tile(d, dtype)
    assert _flash_cuda.route(d, dtype, "flash_fwd")[0] == "fma"
    q, k, v = _qkv(1, 200, 4, 2, d, seed=60 + d)
    bf16 = dtype == torch.bfloat16
    o, lse = tattn.flash_fwd_plain(
        *(torch.from_numpy(x).to(dtype) for x in (q, k, v)), d ** -0.5,
        True, torch.float32, tile, tile)
    jdtype = jnp.bfloat16 if bf16 else jnp.float32
    jo, jlse = jattn.flash_attention_with_lse(
        *(jnp.asarray(x).astype(jdtype) for x in (q, k, v)),
        causal=True, block_q=tile, block_k=tile, out_dtype=jnp.float32)
    jlse = np.asarray(jlse).transpose(0, 2, 1)
    for name, t, j in (("o", o, jo), ("lse", lse, jlse)):
        if bf16:
            err = np.abs(_np(t) - np.asarray(j))
            assert err.mean() <= 2e-6, f"{name}: mean abs err {err.mean()}"
        np.testing.assert_allclose(_np(t), j, **(BF16 if bf16 else F32),
                                   err_msg=name)


@pytest.mark.parametrize("d", [384, 520])
def test_forward_over_the_split_key_tile_matches_jax(d):
    """The plain forward the card's split kernel is held to, over its key
    tiles (``fwd_key_tile``: 32): bf16 in, f32 out, causal GQA, S = 100 (a
    ragged last tile), against the reference's kernels in interpret mode at
    the same blocks; o and lse also in the mean. d = 384 and 520 end in a
    narrower chunk."""
    tile = _flash_cuda.fwd_key_tile(d, torch.bfloat16)
    assert _flash_cuda.route(d, torch.bfloat16, "flash_fwd")[0] == \
        "fma_split"
    q, k, v = _qkv(1, 100, 4, 2, d, seed=70 + d)
    o, lse = tattn.flash_fwd_plain(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)), d ** -0.5,
        True, torch.float32, tile, tile)
    jo, jlse = jattn.flash_attention_with_lse(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
        causal=True, block_q=tile, block_k=tile, out_dtype=jnp.float32)
    jlse = np.asarray(jlse).transpose(0, 2, 1)
    for name, t, j in (("o", o, jo), ("lse", lse, jlse)):
        err = np.abs(_np(t) - np.asarray(j))
        assert err.mean() <= 2e-6, f"{name}: mean abs err {err.mean()}"
        np.testing.assert_allclose(_np(t), j, **BF16, err_msg=name)


def _fma_fwd_key_tiles():
    """Keys per tile of the FMA forward at each width, from its traits in
    ``flash_fwd.cu`` (``FwdFma<W>``: BN = GX * TN), and of the split
    forward, which takes the traits of the width ``SPLIT`` names."""
    src = (CSRC / "flash_fwd.cu").read_text()
    out = {}
    for w, body in re.findall(r"struct FwdFma<(\d+)> \{([^}]*)\}", src):
        gx = int(re.search(r"\bGX = (\d+)", body).group(1))
        tn = int(re.search(r"\bTN = (\d+)", body).group(1))
        out[int(w)] = gx * tn
    common = (CSRC / "flash_common.cuh").read_text()
    split = int(re.search(r"constexpr int SPLIT = (\d+);", common).group(1))
    assert re.search(r"struct FwdSplit : FwdLay<SPLIT>", src)
    return out, out[split]


def test_fwd_key_tile_is_the_fma_kernels_traits():
    """``fwd_key_tile`` on FMA is the key tile the C source compiles at
    every width the forward's FMA family has, and on the split family the
    one its traits take."""
    tiles, split_tile = _fma_fwd_key_tiles()
    assert set(tiles) == set(_flash_cuda.FMA_WIDTHS["flash_fwd"])
    seen = set()
    for dtype in (torch.bfloat16, torch.float32):
        for d in range(1, SWEEP_TO + 1):
            family, width = _flash_cuda.route(d, dtype, "flash_fwd")
            seen.add(family)
            if family == "fma":
                assert _flash_cuda.fwd_key_tile(d, dtype) == tiles[width]
            elif family == "fma_split":
                assert _flash_cuda.fwd_key_tile(d, dtype) == split_tile
    assert seen == {"wgmma", "fma", "fma_split"}


@pytest.mark.parametrize("d,dtype,tile", [
    (8, torch.bfloat16, 128), (64, torch.bfloat16, 128),
    (96, torch.bfloat16, 128), (128, torch.bfloat16, 128),
    (136, torch.bfloat16, 80), (192, torch.bfloat16, 80),
    (256, torch.bfloat16, 80), (20, torch.bfloat16, 32),
    (140, torch.bfloat16, 32), (16, torch.float32, 32),
    (256, torch.float32, 32), (264, torch.bfloat16, 32),
    (512, torch.bfloat16, 32), (384, torch.float32, 32)])
def test_fwd_key_tile_is_the_routed_forward_kernels(d, dtype, tile):
    """128 keys a tile on wgmma at width 64 / 128, 80 at width 256, 32 on
    FMA (bf16 off a multiple of 8, every f32) and on the split FMA family
    (every head_dim past 256)."""
    assert _flash_cuda.fwd_key_tile(d, dtype) == tile


# The routes of all three kernels: bf16 at a multiple of 8 on wgmma at
# width 64, 128 or 256; off a multiple of 8, and f32, FMA, whose narrowest
# tile is 16 wide; past 256, in either dtype, the split FMA family on the
# 256-wide tiles.
FWD_ROUTES = [
    (8, torch.bfloat16, "wgmma", 64),
    (16, torch.bfloat16, "wgmma", 64),
    (32, torch.bfloat16, "wgmma", 64),
    (64, torch.bfloat16, "wgmma", 64),
    (72, torch.bfloat16, "wgmma", 128),
    (80, torch.bfloat16, "wgmma", 128),
    (96, torch.bfloat16, "wgmma", 128),
    (128, torch.bfloat16, "wgmma", 128),
    (20, torch.bfloat16, "fma", 32),
    (100, torch.bfloat16, "fma", 128),
    (136, torch.bfloat16, "wgmma", 256),
    (256, torch.bfloat16, "wgmma", 256),
    (1, torch.float32, "fma", 16),
    (16, torch.float32, "fma", 16),
    (33, torch.float32, "fma", 64),
    (64, torch.float32, "fma", 64),
    (96, torch.float32, "fma", 128),
    (128, torch.float32, "fma", 128),
    (256, torch.float32, "fma", 256),
]


def _routes():
    out = []
    for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        for d, dtype, family, width in FWD_ROUTES + [
                (192, torch.bfloat16, "wgmma", 256),
                (248, torch.bfloat16, "wgmma", 256),
                (140, torch.bfloat16, "fma", 256),
                (12, torch.bfloat16, "fma", 16)] + [
                (d, dtype, "fma_split", 256)
                for d in (257, 264, 384, 512, 520, 1024)
                for dtype in (torch.bfloat16, torch.float32)]:
            out.append((kernel, d, dtype, family, width))
    return out


ROUTES = _routes()


@pytest.mark.parametrize("kernel,d,dtype,family,width", ROUTES)
def test_route_family_and_width(kernel, d, dtype, family, width):
    assert _flash_cuda.route(d, dtype, kernel) == (family, width)


@pytest.mark.parametrize("kernel", sorted(_flash_cuda.KERNELS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [0])
def test_route_refuses_past_the_limit_naming_it(d, dtype, kernel):
    """The one head_dim no kernel takes: below 1."""
    with pytest.raises(ValueError, match="at least 1"):
        _flash_cuda.route(d, dtype, kernel)


@pytest.mark.parametrize("kernel", sorted(_flash_cuda.KERNELS))
def test_route_covers_every_head_dim_up_to_the_limit(kernel):
    """No head_dim from 1 to ``SWEEP_TO`` is refused, in either dtype, by
    any kernel; the wgmma family takes only bf16 rows of whole 16-byte
    vectors up to 256, and every such row the kernel's widest wgmma tile
    holds; every head_dim past 256 runs on the split family's 256-wide
    tiles."""
    widest = _flash_cuda.WGMMA_WIDTHS[kernel][-1]
    for dtype in (torch.bfloat16, torch.float32):
        for d in range(1, SWEEP_TO + 1):
            family, width = _flash_cuda.route(d, dtype, kernel)
            if d > _flash_cuda.SPLIT_WIDTH:
                assert (family, width) == ("fma_split",
                                           _flash_cuda.SPLIT_WIDTH), d
                continue
            assert d <= width
            widths = (_flash_cuda.WGMMA_WIDTHS[kernel] if family == "wgmma"
                      else _flash_cuda.FMA_WIDTHS[kernel])
            assert width == min(w for w in widths if d <= w)
            on_wgmma = dtype == torch.bfloat16 and d % 8 == 0 and d <= widest
            assert (family == "wgmma") == on_wgmma, (d, dtype)


def _entry_widths(kernel):
    """The widths the C entry point of ``kernel`` launches, by family: the
    ``case`` labels of its FMA ``switch (width)``, the ``width == N``
    tests in front of its wgmma launches, and the width of its split
    launch (``family == 2 && width == SPLIT``, ``SPLIT`` read from
    ``flash_common.cuh``)."""
    src = (CSRC / _flash_cuda.KERNELS[kernel][0]).read_text()
    entry = src[src.index(f'extern "C" int tt_{kernel}('):]
    fma = entry[entry.index("#define TT_FMA_W"):]
    fma = fma[:fma.index("break")]
    common = (CSRC / "flash_common.cuh").read_text()
    split = int(re.search(r"constexpr int SPLIT = (\d+);", common).group(1))
    return {"fma": {int(w) for w in re.findall(r"case (\d+):", fma)},
            "wgmma": {int(w) for w in re.findall(r"width == (\d+) &&",
                                                 entry)},
            "fma_split": ({split} if re.search(
                r"family == 2 && width == SPLIT\) \{", entry) else set())}


@pytest.mark.parametrize("kernel", sorted(_flash_cuda.KERNELS))
def test_route_widths_have_their_case_in_the_c_entry(kernel):
    """Every (family, width) ``route`` can return for ``kernel``, in either
    dtype and up to ``SWEEP_TO``, is a width its C entry point's switch
    launches, and the entry launches no width ``route`` never picks: the
    Python and C sides of the widths cannot drift apart."""
    entry = _entry_widths(kernel)
    routed = {"fma": set(), "wgmma": set(), "fma_split": set()}
    for dtype in (torch.bfloat16, torch.float32):
        for d in range(1, SWEEP_TO + 1):
            family, width = _flash_cuda.route(d, dtype, kernel)
            routed[family].add(width)
    assert routed == entry
    assert entry["fma"] == set(_flash_cuda.FMA_WIDTHS[kernel])
    assert entry["wgmma"] == set(_flash_cuda.WGMMA_WIDTHS[kernel])
    assert entry["fma_split"] == {_flash_cuda.SPLIT_WIDTH}
    assert set(_flash_cuda.FAMILIES) == set(entry)


def test_route_refuses_other_dtypes():
    with pytest.raises(TypeError, match="bf16 or f32"):
        _flash_cuda.route(64, torch.float16, "flash_fwd")


def test_route_refuses_other_kernels():
    with pytest.raises(KeyError):
        _flash_cuda.route(64, torch.bfloat16, "convfuse_apply")


def test_kernel_entries_refuse_cpu_tensors_at_new_head_dims():
    """A CPU tensor handed to a kernel entry raises at every head_dim: the
    plain versions run only through the dispatchers."""
    for d in (16, 96, 256, 512):
        q = torch.zeros((1, 16, 2, d))
        with pytest.raises(ValueError, match="CUDA tensors"):
            _flash_cuda.flash_fwd(q, q, q, d ** -0.5, True)
