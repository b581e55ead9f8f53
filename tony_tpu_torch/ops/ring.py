"""Ring attention: exact attention over a sequence sharded on the ``sp`` axis.

Counterpart of ``tony_tpu/ops/ring.py``. Each rank holds a ``[B, S/n, H,
D]`` shard of Q, K and V. The K/V chunks travel round the ring of the sp
group (``parallel/_comm.py:ppermute``, nearest neighbours only) while each
rank accumulates its Q shard's softmax state; after n hops every Q block has
seen every K/V block.

- **Each hop is the flash kernel** (``flash_attention_with_lse`` with
  ``out_dtype=float32``: on a CUDA tensor the hand-written forward and
  backward kernels, on the CPU their plain versions), giving a normalised
  partial ``(o, lse)``; the partials merge in f32 by the logsumexp rule
  (``_merge``) and the output is rounded to the input dtype once, at the
  end, so the error stays flat in n.
- **Causally dead hops are skipped.** The rank and the hop index are Python
  integers, so the reference's ``lax.switch`` is a host branch (``_hop``):
  the diagonal chunk takes causal flash, a past chunk full flash, a future
  chunk nothing. No hop reads a value back from the device.
- **GQA is native**: K/V travel at their ``H_kv`` width and the kernels
  index kv head ``h // g``.

The backward runs through autograd: through each hop's flash kernels (with
the lse cotangent the merge gives them) and through the ``ppermute`` calls
in reverse. JAX transposes the whole SPMD program, so every device runs every
transposed ``ppermute``; torch's autograd runs only the nodes that reach this
rank's loss, and under the causal skip a rank's last chunks reach nothing
there, while its neighbours wait on it in the backward of the rotation that
brought them their chunks. So the last chunk is tied to the output with a
zero cotangent (``_Tie``), which puts every rotation on each rank's path.
Autograd keeps every hop's visiting K/V chunk, O(n · S_local) per rank, as
the reference's ``lax.scan`` does. The last rotation, which only brings the
chunks home, is not made. The rotation does not overlap the hop: on one
card it could not be measured.

Without an sp group (``group=None``: the reference's trace with no bound
axis, a model off any mesh) the ring has one rank: one hop over the whole
sequence, through the same kernels, with no rotation.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from tony_tpu_torch.ops.attention import (DEFAULT_BLOCK,
                                          flash_attention_with_lse)
from tony_tpu_torch.parallel import _comm

# The empty state's lse: finite, so that exp(lse_acc − lse_new) stays 0 and
# never turns NaN (−inf − −inf) on an empty first hop.
NEG_INF = -1e30

DIAG, FULL, SKIP = "diagonal", "full", "skip"


def schedule(rank: int, n: int, causal: bool):
    """``(hop, kv_rank, kind)`` for each of the n hops of rank ``rank``:
    after i rotations it holds the chunk that started on rank
    ``kv_rank = (rank − i) % n``, and its Q shard takes causal flash on its
    own chunk (DIAG), full flash on a past one or on any chunk without the
    causal mask (FULL), nothing on a future one (SKIP)."""
    out = []
    for i in range(n):
        src = (rank - i) % n
        kind = FULL if not causal or src < rank else \
            DIAG if src == rank else SKIP
        out.append((i, src, kind))
    return out


def _hop(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kind: str,
         scale: float, block_q: int, block_k: int
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One hop's partial ``(o [B,S,H,D] f32, lse [B,S,H] f32)`` of the local
    Q shard against one visiting K/V chunk (``kind`` DIAG or FULL)."""
    return flash_attention_with_lse(q, k, v, causal=kind == DIAG,
                                    scale=scale, block_q=block_q,
                                    block_k=block_k, out_dtype=torch.float32)


def _merge(o_acc: torch.Tensor, lse_acc: torch.Tensor, o: torch.Tensor,
           lse: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two partials over disjoint key sets → their union's, in f32."""
    lse_new = torch.logaddexp(lse_acc, lse)
    o_new = (o_acc * torch.exp(lse_acc - lse_new)[..., None]
             + o * torch.exp(lse - lse_new)[..., None])
    return o_new, lse_new


class _Tie(torch.autograd.Function):
    """``o`` unchanged, made to depend on ``x``, whose cotangent is zero."""

    @staticmethod
    def forward(ctx, o, x):
        ctx.x_meta = (x.shape, x.dtype, x.device)
        return o.view_as(o)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.x_meta
        return g, torch.zeros(shape, dtype=dtype, device=device)


def empty_state(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The merge's starting point: o = 0, lse = ``NEG_INF`` (f32)."""
    b, s, h, d = q.shape
    return (torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device),
            torch.full((b, s, h), NEG_INF, dtype=torch.float32,
                       device=q.device))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if k.shape[2] != v.shape[2]:
        raise ValueError(f"k heads ({k.shape[2]}) != v heads "
                         f"({v.shape[2]})")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"q heads {q.shape[2]} not a multiple of kv heads "
                         f"{k.shape[2]}")


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group: Optional[Any] = None, causal: bool = True,
                   scale: Optional[float] = None,
                   block_q: int = DEFAULT_BLOCK,
                   block_k: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Per-shard ring attention over the ranks of ``group`` (the mesh's
    ``sp`` group): ``[B, S_local, H, D]`` in and out, this rank holding
    sequence chunk ``rank`` of the group; K/V may carry ``H_kv`` heads with
    ``H_kv | H``. Differentiable. With ``group=None``, a ring of one rank
    (see the module docstring)."""
    _check(q, k, v)
    n, my = _comm.group_size(group), _comm.group_rank(group)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    o_acc, lse_acc = empty_state(q)
    kv = torch.stack([k, v])
    for i, _, kind in schedule(my, n, causal):
        if kind != SKIP:
            o, lse = _hop(q, kv[0], kv[1], kind, scale, block_q, block_k)
            o_acc, lse_acc = _merge(o_acc, lse_acc, o, lse)
        if i < n - 1:
            kv = _comm.ppermute(kv, group)
    if n > 1 and kv.requires_grad:
        o_acc = _Tie.apply(o_acc, kv)
    return o_acc.to(q.dtype)


def ring_attention_sharded(mesh: Any, q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, causal: bool = True,
                           scale: Optional[float] = None,
                           axis_name: str = "sp",
                           block_q: int = DEFAULT_BLOCK,
                           block_k: int = DEFAULT_BLOCK) -> torch.Tensor:
    """``ring_attention`` over the ``axis_name`` group of ``mesh`` (a
    ``DeviceMesh``): this rank's sequence shard in, its shard of the output
    out (the reference's global-array wrapper, one rank's view of it)."""
    return ring_attention(q, k, v, mesh[axis_name].get_group(), causal,
                          scale, block_q, block_k)
