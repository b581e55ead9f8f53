"""Remat policies: ``TransformerConfig.remat_policy`` on PyTorch's selective
activation checkpointing.

The reference names a ``jax.checkpoint_policies`` policy and hands it to
``nn.remat(Block, prevent_cse=True, policy=...)``
(``tony_tpu/models/transformer.py:270-283``, ``moe.py:200-213``). It
accepts six names:

- ``nothing_saveable`` (and None): the block is recomputed whole;
- ``everything_saveable``: every output is kept, the same as no
  checkpoint, and run as none here;
- ``dots_with_no_batch_dims_saveable`` (``checkpoint_dots_with_no_batch_dims``):
  the outputs of the products without batch dims are kept;
- ``dots_saveable`` (``checkpoint_dots``): the batched products' too.

Here each of the last two is a policy of
``torch.utils.checkpoint.create_selective_checkpoint_contexts``: a
product's output is ``MUST_SAVE`` where the policy keeps its class, and
every other op is ``PREFER_RECOMPUTE``. JAX reads the class off a
``dot_general``'s batch dims; an aten op does not carry it (``F.linear``
on ``[B, S, D]`` folds to ``mm``, an einsum may lower a product without
batch dims to ``bmm`` and fold a batched one of batch 1 to ``mm``). So the
model names the class where it multiplies: each product runs inside
``product_site(name)``, and ``SITES`` says, once for both decoders, what
each site's products are:

- ``projection`` (wq, wk, wv, wo, gate, up; their int32 / f32
  accumulators when quantized), ``router``, ``dispatch`` (the one-hot
  ``[E, C, D]``): no batch dims;
- ``attention`` (the plain ``"xla"`` attention's scores and output) and
  ``experts`` (the stacked experts' products): batched;
- ``down`` and ``combine``: never kept. Their outputs are added to the
  residual stream and no backward reads them; JAX keeps only what the
  backward reads, while a marked op's output would be stored all the
  same;
- ``flash``: never kept. The reference's ``pallas_call`` is opaque to the
  policy, so the dots policies rerun it; on the card the CUDA kernels are
  no dispatcher op and the policy never sees them, and on the CPU their
  plain stand-in multiplies inside this site.

Products outside any site are recomputed. A policy that cannot build its
context raises; nothing falls back to full remat. Off a checkpoint (no
remat, or a layer that ``remat_skip_every`` skips) the sites cost a
thread-local write and decide nothing.

The factories of ``jax.checkpoint_policies`` are no policy: the
reference raises ``TypeError`` when it calls one on a primitive, and an
unknown name ``AttributeError`` in its ``getattr``. ``check_policy``
raises the same types when a config is built.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Callable, List, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

UNBATCHED = "unbatched"
BATCHED = "batched"

#: Site -> the class of its products; None: never kept.
SITES = {
    "projection": UNBATCHED,
    "router": UNBATCHED,
    "dispatch": UNBATCHED,
    "attention": BATCHED,
    "experts": BATCHED,
    "down": None,
    "combine": None,
    "flash": None,
}

#: Policy name -> the classes it keeps; None: no checkpoint.
POLICIES = {
    "nothing_saveable": frozenset(),
    "everything_saveable": None,
    "dots_saveable": frozenset({UNBATCHED, BATCHED}),
    "checkpoint_dots": frozenset({UNBATCHED, BATCHED}),
    "dots_with_no_batch_dims_saveable": frozenset({UNBATCHED}),
    "checkpoint_dots_with_no_batch_dims": frozenset({UNBATCHED}),
}

#: Names of ``jax.checkpoint_policies`` that make a policy from arguments.
FACTORIES = (
    "offload_dot_with_no_batch_dims",
    "save_and_offload_only_these_names",
    "save_any_names_but_these",
    "save_anything_except_these_names",
    "save_from_both_policies",
    "save_only_these_names",
)

#: The aten products; which of them a policy keeps is the site's business.
PRODUCT_OPS = frozenset(getattr(torch.ops.aten, name) for name in (
    "mm", "bmm", "addmm", "baddbmm", "_int_mm", "_scaled_mm"))


def check_policy(name: Optional[str]) -> Optional[str]:
    """``name`` if it is None or one of ``POLICIES``; a factory name
    raises ``TypeError``, any other name ``AttributeError``."""
    if name is None or name in POLICIES:
        return name
    if name in FACTORIES:
        raise TypeError(
            f"remat_policy {name!r} is a factory of jax.checkpoint_policies "
            f"that makes a policy from arguments, not a policy; one of "
            f"{sorted(POLICIES)}")
    raise AttributeError(
        f"remat_policy {name!r}: jax.checkpoint_policies has no such "
        f"policy; one of {sorted(POLICIES)}")


_site = threading.local()
_record: Optional[List[dict]] = None


@contextlib.contextmanager
def product_site(name: str):
    """The products run inside are the site ``name``'s (``SITES``)."""
    outer = getattr(_site, "name", None)
    _site.name = name
    try:
        yield
    finally:
        _site.name = outer


@contextlib.contextmanager
def recording():
    """Yields a list that collects, for every product a policy decides in
    a forward, ``{"site", "op", "shape", "dtype", "kept"}``."""
    global _record
    outer, _record = _record, []
    try:
        yield _record
    finally:
        _record = outer


def _policy(keep: frozenset, ctx: Any, op: Any, *args: Any,
            **kwargs: Any) -> CheckpointPolicy:
    if getattr(op, "overloadpacket", None) not in PRODUCT_OPS:
        return CheckpointPolicy.PREFER_RECOMPUTE
    site = getattr(_site, "name", None)
    kept = SITES.get(site) in keep
    if _record is not None:
        out = getattr(ctx, "op_output", None)
        _record.append({"site": site, "op": op.overloadpacket.__name__,
                        "shape": tuple(out.shape) if out is not None
                        else None,
                        "dtype": out.dtype if out is not None else None,
                        "kept": kept})
    return CheckpointPolicy.MUST_SAVE if kept else \
        CheckpointPolicy.PREFER_RECOMPUTE


def run(block: Callable[..., Any], policy: Optional[str],
        *args: Any) -> Any:
    """``block(*args)`` under the remat policy ``policy`` (None: the
    block recomputed whole)."""
    keep = POLICIES[check_policy(policy) or "nothing_saveable"]
    if keep is None:
        return block(*args)
    if not keep:
        return checkpoint(block, *args, use_reentrant=False)
    return checkpoint(block, *args, use_reentrant=False,
                      context_fn=functools.partial(
                          create_selective_checkpoint_contexts,
                          functools.partial(_policy, keep)))
