"""Per-process batch rows and deterministic synthetic token batches.

Counterpart of ``tony_tpu/data.py``'s ``process_batch_slice`` and the
``load_local`` of ``synthetic_lm_batches``: row ``r`` of step ``s`` is drawn
from ``np.random.SeedSequence([seed, s, r])``, so the tokens are
byte-identical to the reference's for every (seed, step, row), whatever the
process layout. The prefetching iterator and token files come with a later
slice.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from tony_tpu_torch._device import resolve_device


def process_batch_slice(global_batch: int, rank: Optional[int] = None,
                        world: Optional[int] = None) -> slice:
    """This process's contiguous row range of the global batch.

    ``rank``/``world`` default to the initialized ``torch.distributed``
    group, else to a single process. Every row of every step is consumed by
    exactly one process at whatever world size ran that step."""
    dist = torch.distributed
    up = dist.is_available() and dist.is_initialized()
    n = int(world) if world is not None else (dist.get_world_size()
                                              if up else 1)
    i = int(rank) if rank is not None else (dist.get_rank() if up else 0)
    if not 0 <= i < n:
        raise ValueError(f"rank {i} outside world of {n}")
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} not divisible by process count {n}")
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


def synthetic_lm_load_local(seq: int, vocab_size: int, seed: int = 0
                            ) -> Callable[[int, slice],
                                          Dict[str, np.ndarray]]:
    """``load_local(step, rows) -> {"tokens": int32 [rows, seq]}``."""

    def load_local(step: int, rows: slice) -> Dict[str, np.ndarray]:
        out = np.empty((rows.stop - rows.start, seq), np.int32)
        for j, r in enumerate(range(rows.start, rows.stop)):
            rng = np.random.default_rng(
                np.random.SeedSequence([seed, step, r]))
            out[j] = rng.integers(0, vocab_size, size=seq, dtype=np.int32)
        return {"tokens": out}

    return load_local


def synthetic_lm_batch(step: int, global_batch: int, seq: int,
                       vocab_size: int, seed: int = 0,
                       rank: Optional[int] = None,
                       world: Optional[int] = None,
                       device: Union[str, torch.device] = "cuda"
                       ) -> Dict[str, torch.Tensor]:
    """This process's rows of step ``step`` as int64 tensors on
    ``device``."""
    dev = resolve_device(device)
    rows = process_batch_slice(global_batch, rank, world)
    local = synthetic_lm_load_local(seq, vocab_size, seed)(step, rows)
    return {k: torch.from_numpy(v).to(dev, torch.int64)
            for k, v in local.items()}
