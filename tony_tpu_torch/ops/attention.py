"""Blockwise (flash) attention: CUDA kernels on the card, plain PyTorch on the
CPU.

Counterpart of ``tony_tpu/ops/attention.py``. The public layout is
``[batch, seq, heads, head_dim]``; GQA reads kv head ``h // g`` without
repeating K/V. ``flash_attention`` and ``flash_attention_with_lse`` run one
``torch.autograd.Function`` whose forward saves ``(q, k, v, o, lse)`` and
whose backward computes ``delta = rowsum(o·do) − dlse`` in plain torch and
then the dq and dk/dv kernels.

Each of the three kernels has a dispatcher here (``flash_fwd``,
``flash_bwd_dq``, ``flash_bwd_dkv``). A CUDA tensor goes to the hand-written
kernel in ``tony_tpu_torch/csrc`` (``ops/_flash_cuda.py``) or raises; a CPU
tensor goes to the plain version beside it (``*_plain``), a blockwise
online softmax with the same math: masked scores are ``NEG_INF``, the row
sum is clamped at 1e-30, lse = m + log l, q is scaled in its own dtype
before the forward's dot, k before dq's and q before dk/dv's, and P and dS
are rounded to the input dtype before their products. The forward's row
sum l follows the reference's ``fused_rowsum``: below head_dim 128 it sums
P rounded to v's dtype (the reference takes l from its P·V product against
a column of ones), from 128 up the f32 P; both accumulate in f32.

``block_q``/``block_k`` set the plain version's tiles and are kept in the
signatures so configs carry over; the CUDA kernels choose their own tiles
and ignore them. For bf16 all three run on Hopper warpgroups (``wgmma``,
register accumulators, TMA loads through ``mbarrier`` rings,
``csrc/hopper_common.cuh``): the forward with two warpgroups over 128
query rows streaming 128-key tiles, the next tile's S under this tile's
softmax; dq with one warpgroup over 64 query rows streaming 64-key tiles;
dk/dv with one over 64 keys streaming the group's 64-row q tiles. For f32
all three are simple FMA kernels over 32-row tiles.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tony_tpu_torch.ops import _flash_cuda

NEG_INF = -1e30
DEFAULT_BLOCK = 1024


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with f32 accumulation: the products of bf16 inputs are exact in
    f32, which is what the reference's ``preferred_element_type=f32`` dot
    computes."""
    return torch.matmul(a.float(), b.float())


def _scaled(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``x * scale`` in x's own dtype (the scale rounded to it first)."""
    return x * torch.tensor(scale, dtype=x.dtype)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention ([B,S,H,D] layout, same head count for q and k/v) —
    the correctness oracle. Each einsum runs in its inputs' dtype, as the
    reference's do; on the card an f32 oracle needs TF32 off."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(diagonal=sk - sq)
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def _heads_first(x: torch.Tensor, g: int) -> torch.Tensor:
    """[B,S,Hx,D] → [B,Hx·g,S,D], repeating each head g times (the plain
    version's GQA; the kernels index instead)."""
    x = x.transpose(1, 2)
    return x.repeat_interleave(g, dim=1) if g > 1 else x


def _valid(rows: torch.Tensor, cols: torch.Tensor, sq: int, sk: int,
           causal: bool) -> torch.Tensor:
    ok = (rows[:, None] < sq) & (cols[None, :] < sk)
    if causal:
        ok = ok & (rows[:, None] >= cols[None, :])
    return ok


def _last_k_block(i: int, block_q: int, block_k: int, nk: int,
                  causal: bool) -> int:
    """One past the last k block with any unmasked element for q block i."""
    return min(nk, (i * block_q + block_q - 1) // block_k + 1) if causal \
        else nk


# ---------------------------------------------------------------------------
# Plain versions of the three kernels (CPU tensors, and the card-side check)
# ---------------------------------------------------------------------------
def flash_fwd_plain(q, k, v, scale: float, causal: bool,
                    out_dtype: Optional[torch.dtype] = None,
                    block_q: int = DEFAULT_BLOCK,
                    block_k: int = DEFAULT_BLOCK):
    """q [B,Sq,H,D], k/v [B,Sk,Hkv,D] → (o [B,Sq,H,D], lse [B,H,Sq] f32)."""
    b, sq, h, d = q.shape
    sk, g = k.shape[1], h // k.shape[2]
    block_q, block_k = min(block_q, sq), min(block_k, sk)
    qs = _scaled(q, scale).transpose(1, 2)          # [B,H,Sq,D]
    kh, vh = _heads_first(k, g), _heads_first(v, g)
    nk = -(-sk // block_k)
    # Below head_dim 128 the reference takes l from the P·V product against a
    # column of ones, so l sums P rounded to v's dtype; from 128 up it sums
    # the f32 P (tony_tpu/ops/attention.py, fused_rowsum).
    sum_rounded = d < 128
    o = torch.empty((b, h, sq, d), dtype=out_dtype or q.dtype,
                    device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    for q0 in range(0, sq, block_q):
        qb = qs[:, :, q0:q0 + block_q]
        rows = torch.arange(q0, q0 + qb.shape[2], device=q.device)
        m = torch.full(qb.shape[:3] + (1,), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(qb.shape, dtype=torch.float32, device=q.device)
        for j in range(_last_k_block(q0 // block_q, block_q, block_k, nk,
                                     causal)):
            k0 = j * block_k
            kb, vb = kh[:, :, k0:k0 + block_k], vh[:, :, k0:k0 + block_k]
            cols = torch.arange(k0, k0 + kb.shape[2], device=q.device)
            s = _mm(qb, kb.transpose(-1, -2))
            s = s.masked_fill(~_valid(rows, cols, sq, sk, causal), NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            pv = p.to(v.dtype)
            l = l * alpha + (pv.float() if sum_rounded else p).sum(
                -1, keepdim=True)
            acc = acc * alpha + _mm(pv, vb)
            m = m_new
        l = l.clamp_min(1e-30)
        o[:, :, q0:q0 + block_q] = (acc / l).to(o.dtype)
        lse[:, :, q0:q0 + block_q] = (m + torch.log(l))[..., 0]
    return o.transpose(1, 2), lse


def _bwd_blocks(q, k, v, do, lse, delta, causal, block_q, block_k):
    """Walk the (q block, k block) pairs the causal mask leaves, yielding the
    block slices with p = exp(s − lse) (0 where masked) and
    dp = do·vᵀ — the part the dq and dk/dv passes share."""
    sq, sk = q.shape[2], k.shape[2]
    nk = -(-sk // block_k)
    for q0 in range(0, sq, block_q):
        rows = torch.arange(q0, min(q0 + block_q, sq), device=q.device)
        qs = slice(q0, q0 + block_q)
        for j in range(_last_k_block(q0 // block_q, block_q, block_k, nk,
                                     causal)):
            ks = slice(j * block_k, (j + 1) * block_k)
            cols = torch.arange(ks.start, min(ks.stop, sk), device=q.device)
            s = _mm(q[:, :, qs], k[:, :, ks].transpose(-1, -2))
            p = torch.exp(s - lse[:, :, qs, None])
            p = p.masked_fill(~_valid(rows, cols, sq, sk, causal), 0.0)
            dp = _mm(do[:, :, qs], v[:, :, ks].transpose(-1, -2))
            yield qs, ks, p, dp - delta[:, :, qs, None]


def flash_bwd_dq_plain(q, k, v, do, lse, delta, scale: float, causal: bool,
                       block_q: int = DEFAULT_BLOCK,
                       block_k: int = DEFAULT_BLOCK):
    """dq [B,Sq,H,D] in q's dtype (k scaled in its dtype for both dots)."""
    g = q.shape[2] // k.shape[2]
    block_q, block_k = min(block_q, q.shape[1]), min(block_k, k.shape[1])
    qh = q.transpose(1, 2)
    ks = _heads_first(_scaled(k, scale), g)
    vh = _heads_first(v, g)
    acc = torch.zeros(qh.shape, dtype=torch.float32, device=q.device)
    for qsl, ksl, p, dpd in _bwd_blocks(qh, ks, vh, do.transpose(1, 2), lse,
                                        delta, causal, block_q, block_k):
        ds = (p * dpd).to(k.dtype)
        acc[:, :, qsl] += _mm(ds, ks[:, :, ksl])
    return acc.to(q.dtype).transpose(1, 2)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale: float, causal: bool,
                        block_q: int = DEFAULT_BLOCK,
                        block_k: int = DEFAULT_BLOCK):
    """(dk, dv) [B,Sk,Hkv,D]: summed over each kv head's g query heads, in
    f32, then cast to k's and v's dtype."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    g = h // hk
    block_q, block_k = min(block_q, sq), min(block_k, sk)
    qs = _scaled(q, scale).transpose(1, 2)
    kh, vh = _heads_first(k, g), _heads_first(v, g)
    dk = torch.zeros((b, h, sk, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    doh = do.transpose(1, 2)
    for qsl, ksl, p, dpd in _bwd_blocks(qs, kh, vh, doh, lse, delta, causal,
                                        block_q, block_k):
        dv[:, :, ksl] += _mm(p.to(do.dtype).transpose(-1, -2),
                             doh[:, :, qsl])
        ds = (p * dpd).to(q.dtype)
        dk[:, :, ksl] += _mm(ds.transpose(-1, -2), qs[:, :, qsl])

    def group_sum(x):                       # [B,H,Sk,D] → [B,Sk,Hkv,D]
        return x.view(b, hk, g, sk, d).sum(2).transpose(1, 2)
    return group_sum(dk).to(k.dtype), group_sum(dv).to(v.dtype)


# ---------------------------------------------------------------------------
# Dispatch: a CUDA tensor launches the kernel, a CPU tensor takes the plain
# version. Nothing else is accepted and nothing falls back.
# ---------------------------------------------------------------------------
def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"flash attention runs on cuda or cpu tensors, got "
                       f"{t.device}")


def flash_fwd(q, k, v, scale, causal, out_dtype=None, block_q=DEFAULT_BLOCK,
              block_k=DEFAULT_BLOCK):
    if _on_cuda(q):
        return _flash_cuda.flash_fwd(q, k, v, scale, causal, out_dtype)
    return flash_fwd_plain(q, k, v, scale, causal, out_dtype, block_q,
                           block_k)


def flash_bwd_dq(q, k, v, do, lse, delta, scale, causal,
                 block_q=DEFAULT_BLOCK, block_k=DEFAULT_BLOCK):
    if _on_cuda(q):
        return _flash_cuda.flash_bwd_dq(q, k, v, do, lse, delta, scale,
                                        causal)
    return flash_bwd_dq_plain(q, k, v, do, lse, delta, scale, causal,
                              block_q, block_k)


def flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal,
                  block_q=DEFAULT_BLOCK, block_k=DEFAULT_BLOCK):
    if _on_cuda(q):
        return _flash_cuda.flash_bwd_dkv(q, k, v, do, lse, delta, scale,
                                         causal)
    return flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale, causal,
                               block_q, block_k)


class _Flash(torch.autograd.Function):
    """(q, k, v) → (o, lse [B,H,Sq]); the backward takes both cotangents."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, block_q, block_k, out_dtype):
        o, lse = flash_fwd(q, k, v, scale, causal, out_dtype, block_q,
                           block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (scale, causal, block_q, block_k)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        scale, causal, block_q, block_k = ctx.args
        if do is None:
            do = torch.zeros_like(q)
        # With out_dtype=f32 the cotangent arrives f32; the kernels take it
        # in q's dtype, as the reference's lse backward casts it.
        do = do.to(q.dtype).contiguous()
        delta = (o.float() * do.float()).sum(-1).transpose(1, 2)  # [B,H,S]
        if dlse is not None:
            # ∂lse_i/∂s_ij = p_ij: the lse cotangent folds into delta.
            delta = delta - dlse.float()
        delta = delta.contiguous()
        dq = flash_bwd_dq(q, k, v, do, lse, delta, scale, causal, block_q,
                          block_k)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal,
                               block_q, block_k)
        return dq, dk, dv, None, None, None, None, None


def _check(q, k, v, causal, scale) -> float:
    """The public entry points' validation (the reference's
    ``_check_and_transpose``); returns the scale."""
    sq, h = q.shape[1], q.shape[2]
    hk = k.shape[2]
    if causal and sq != k.shape[1]:
        raise ValueError(
            f"causal flash attention requires seq_q == seq_k, got {sq} vs "
            f"{k.shape[1]} (the kernel's mask is top-left aligned; for "
            f"decode-style offsets use ring attention or causal=False with "
            f"an explicit mask)")
    if k.shape[2] != v.shape[2]:
        raise ValueError(f"k heads ({k.shape[2]}) != v heads "
                         f"({v.shape[2]})")
    if h % hk:
        raise ValueError(f"q heads {h} not a multiple of kv heads {hk}")
    return scale if scale is not None else q.shape[-1] ** -0.5


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = True,
                             scale: Optional[float] = None,
                             block_q: int = DEFAULT_BLOCK,
                             block_k: int = DEFAULT_BLOCK,
                             out_dtype: Optional[torch.dtype] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention returning ``(o [B,S,H,D], lse [B,S,H] f32)``.

    ``lse`` is the per-row logsumexp of the scaled, masked scores. Two
    partial results over disjoint key sets combine exactly as
    ``lse = logaddexp(lse_a, lse_b)``,
    ``o = o_a·exp(lse_a − lse) + o_b·exp(lse_b − lse)``. Both outputs are
    differentiable. ``out_dtype=torch.float32`` returns the f32 accumulator
    unrounded."""
    scale = _check(q, k, v, causal, scale)
    o, lse = _Flash.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                          scale, causal, block_q, block_k, out_dtype)
    return o, lse.transpose(1, 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    block_q: int = DEFAULT_BLOCK,
                    block_k: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Flash attention, layout ``[B, S, H, D]`` (GQA: H_kv may divide H).
    Differentiable; f32 accumulation whatever the input dtype, output in
    the input dtype."""
    scale = _check(q, k, v, causal, scale)
    o, _ = _Flash.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                        scale, causal, block_q, block_k, None)
    return o
