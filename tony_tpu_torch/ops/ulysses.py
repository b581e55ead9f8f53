"""Ulysses sequence parallelism: an all-to-all swap of sequence and heads.

Counterpart of ``tony_tpu/ops/ulysses.py``. Instead of rotating K/V chunks
(``ops/ring.py``), two all-to-alls over the sp group
(``parallel/_comm.py:all_to_all_tiled``) turn the sequence-sharded layout
``[B, S/n, H, D]`` into a head-sharded one ``[B, S, H/n, D]``; each rank
runs the whole sequence's flash attention on its head group (the
hand-written kernels on a CUDA tensor), and the output is swapped back.
Rank j's head group is q heads ``[j·H/n, (j+1)·H/n)`` and kv heads
``[j·Hkv/n, (j+1)·Hkv/n)``; since ``H/n = g·Hkv/n``, q head h still meets kv
head ``h // g``. The backward is the transposed swaps around the flash
backward, through autograd.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from tony_tpu_torch.ops.attention import DEFAULT_BLOCK, flash_attention
from tony_tpu_torch.parallel import _comm


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group: Optional[Any] = None, causal: bool = True,
                      scale: Optional[float] = None,
                      block_q: int = DEFAULT_BLOCK,
                      block_k: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Per-shard Ulysses attention over the ranks of ``group`` (the mesh's
    ``sp`` group): ``[B, S_local, H, D]`` in and out. With ``group=None``,
    ``flash_attention`` on the one shard. Raises the reference's
    ``ValueError`` when a head count does not divide by the group's
    size."""
    n = _comm.group_size(group)
    if n == 1:
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               block_q=block_q, block_k=block_k)
    if q.shape[2] % n or k.shape[2] % n:
        raise ValueError(f"Ulysses needs q heads ({q.shape[2]}) and kv "
                         f"heads ({k.shape[2]}) divisible by the 'sp' axis "
                         f"size ({n}); use ring attention instead")

    def seq_to_heads(x):                 # [B, S/n, H, D] → [B, S, H/n, D]
        return _comm.all_to_all_tiled(x, group, split_dim=2, concat_dim=1)

    o = flash_attention(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v),
                        causal=causal, scale=scale, block_q=block_q,
                        block_k=block_k)
    return _comm.all_to_all_tiled(o, group, split_dim=1, concat_dim=2)


def ulysses_attention_sharded(mesh: Any, q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              scale: Optional[float] = None,
                              axis_name: str = "sp",
                              block_q: int = DEFAULT_BLOCK,
                              block_k: int = DEFAULT_BLOCK) -> torch.Tensor:
    """``ulysses_attention`` over the ``axis_name`` group of ``mesh`` (a
    ``DeviceMesh``), this rank's sequence shard in and out."""
    return ulysses_attention(q, k, v, mesh[axis_name].get_group(), causal,
                             scale, block_q, block_k)
