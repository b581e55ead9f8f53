"""Microbatched accumulation and bucketed gradient synchronization.

Counterpart of ``tony_tpu/parallel/grad_sync.py``. The reference computes
the gradients of every sync slice in one program (a ``vmap`` over a leading
slice dim) and mean-reduces them bucket by bucket. In the port each sync
slice is one process of a ``torch.distributed`` group, the DDP shape:

1. **Microbatched accumulation** (``tony.train.accum-steps``): this rank's
   rows are split into A microbatches, in order (microbatch ``a`` is rows
   ``[a·local, (a+1)·local)``, as the reference's ``reshape(n_sync, A,
   local)`` gives rank ``r``). Their gradients are summed into ``.grad``
   by successive backwards, then scaled by 1/A in the leaf's dtype, as the
   reference sums and scales; the loss is the mean of the microbatch
   losses.
2. **Bucketed, order-stable sync** (``tony.train.bucket-mb``): the
   gradients, in parameter order, are packed into ≤bucket-MiB buckets (a
   parameter bigger than the bucket gets one of its own, a dtype change
   closes a bucket); each bucket is flattened into one buffer, all-reduced
   (SUM, then ×1/n in the leaf's dtype: gloo has no AVG) and split back.
3. **An attributable comms phase**: the card first finishes the
   backward (outside the phase), then the sync runs inside
   ``telemetry.phase("comms")``, which waits for the all-reduces to finish
   on the card before it closes. The phase costs a host wait per step.

``bucketed_sync`` also has the reference's pure form, over stacked
``[n, ...]`` gradients with no group: the parity target of the reference's
own function. With no group and world 1, ``train_step_accum`` runs no
collective and books no comms phase.

On a mesh (``train_step_accum(..., mesh=)``, the step
``parallel/train.py:sharded_train_step`` runs), as the reference's
``_build_accum_fn`` with ``sync_axes=("dcn_dp",)``: FSDP2 reduces each
DTensor gradient it holds over its parameter's shard mesh (and dp under
HSDP) once per step, on the last microbatch (``set_requires_gradient_sync``):
the mean, or over sp the sum; ``sharding.fully_shard_placed`` records
those axes per parameter (``reduced_by_fsdp``). Every reduction left is
done here on the local shards, each over an axis the parameter is not
sharded over (where the ranks hold the same slice): the mean over
``fsdp`` and ``dp``; on a sequence-parallel mesh the SUM over ``sp``
(each sp rank's gradient is its sequence chunk's share of one loss, the
whole sequence's), unless the model does not split the sequence (the
pipelined decoder, whose sp ranks are replicas); then the mean over
``dcn_dp``, by the bucketed all-reduce on that axis's group. The loss and
aux are averaged over the batch axes.

Semantics note: ``loss_fn(model, batch)`` must return a MEAN over its batch
(the ``train_step`` contract) — the mean of per-rank/per-microbatch means
then equals the global mean because every piece is the same size
(divisibility is checked loudly).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, \
    Tuple

import torch
from torch.distributed.tensor import DTensor

from tony_tpu_torch import telemetry
from tony_tpu_torch.parallel.mesh import BATCH_AXES, batch_world, mesh_shape
from tony_tpu_torch.parallel.train import TrainState, fill_missing_grads

#: default bucket size (MiB) — matches tony.train.bucket-mb's default.
DEFAULT_BUCKET_MB = 32


@dataclasses.dataclass(frozen=True)
class GradSyncSpec:
    """The conf-shaped knobs (``tony.train.*``) in one carryable value."""

    accum_steps: int = 1
    bucket_mb: int = DEFAULT_BUCKET_MB
    matmul_dtype: str = ""

    @classmethod
    def from_conf(cls, conf) -> "GradSyncSpec":
        from tony_tpu_torch.conf import keys as K

        return cls(
            accum_steps=max(1, conf.get_int(K.TRAIN_ACCUM_STEPS, 1)),
            bucket_mb=max(1, conf.get_int(K.TRAIN_BUCKET_MB,
                                          DEFAULT_BUCKET_MB)),
            matmul_dtype=str(conf.get(K.TRAIN_MATMUL_DTYPE, "") or ""))


def plan_buckets(leaf_descs: Sequence[Tuple[Tuple[int, ...], torch.dtype]],
                 bucket_mb: int = DEFAULT_BUCKET_MB) -> List[List[int]]:
    """Order-stable bucket plan over the gradient leaves.

    ``leaf_descs`` is ``[(shape, torch dtype), ...]`` in parameter order;
    returns a list of buckets, each a list of leaf indices. Greedy in
    order — never reorders leaves, so packing and split-back agree and
    the reduction is deterministic. A bucket closes when it would exceed
    ``bucket_mb`` or when the dtype changes (mixed-dtype grads are never
    silently upcast into one flat buffer). A single leaf larger than the
    bucket gets a bucket of its own (the one-param-spills edge)."""
    cap = max(1, int(bucket_mb)) << 20
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    cur_dtype = None
    for i, (shape, dt) in enumerate(leaf_descs):
        nbytes = math.prod(shape) * dt.itemsize
        if cur and (dt != cur_dtype or cur_bytes + nbytes > cap):
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
        cur_dtype = dt
    if cur:
        buckets.append(cur)
    return buckets


def bucketed_sync(grads: Mapping[str, torch.Tensor],
                  bucket_mb: int = DEFAULT_BUCKET_MB,
                  group: Optional[Any] = None,
                  mean: bool = True) -> Dict[str, torch.Tensor]:
    """Mean-reduce (with ``mean=False``: sum) gradients bucket by bucket, in
    the mapping's order.

    With no ``group``, ``grads`` are stacked per-slice gradients
    ``[n, ...]`` and the mean is over the leading dim (the reference's
    pure function). With a ``group``, ``grads`` are this rank's gradients
    and the mean is over the group's ranks: each bucket is one flat buffer,
    all-reduced (SUM, asynchronously, all buckets in flight at once) and
    scaled by 1/n; the returned tensors are views of those buffers, ready
    once the collectives are (``work.wait()`` orders the caller's stream
    after them)."""
    names = list(grads)
    if not names:
        return {}
    leaves = [grads[k] for k in names]
    if group is None:
        n = leaves[0].shape[0]
        descs = [(tuple(x.shape[1:]), x.dtype) for x in leaves]
    else:
        n = torch.distributed.get_world_size(group)
        descs = [(tuple(x.shape), x.dtype) for x in leaves]
    out: Dict[str, torch.Tensor] = {}
    pending = []
    for bucket in plan_buckets(descs, bucket_mb):
        dtype = leaves[bucket[0]].dtype
        inv = torch.tensor(1.0 / n if mean else 1.0, dtype=dtype)
        if group is None:
            if len(bucket) == 1:
                i = bucket[0]
                out[names[i]] = leaves[i].sum(0) * inv
                continue
            flat = torch.cat([leaves[i].reshape(n, -1) for i in bucket],
                             dim=1)
            red = flat.sum(0) * inv
        else:
            red = torch.cat([leaves[i].reshape(-1) for i in bucket])
            pending.append((
                torch.distributed.all_reduce(red, group=group,
                                             async_op=True), red, inv))
        off = 0
        for i in bucket:
            shape = descs[i][0]
            size = math.prod(shape)
            out[names[i]] = red[off:off + size].view(shape)
            off += size
    for work, red, inv in pending:
        work.wait()
        red.mul_(inv)          # a 0-d CPU tensor: an argument, no copy
    return {k: out[k] for k in names}


def monolithic_grads(loss_fn: Callable, model: torch.nn.Module,
                     batch: Any) -> Dict[str, torch.Tensor]:
    """The reference the bucketed path is held against: the gradient of
    one loss over the whole batch, by name (zeros where the loss does not
    reach a parameter), leaving ``.grad`` as it was.

    It runs the backward into ``.grad`` and hands back what lands there:
    FSDP2 computes a sharded parameter's gradient on the unsharded copy it
    gathers and reduce-scatters it into ``.grad`` from its hooks, outside
    autograd, so ``torch.autograd.grad`` with respect to the sharded
    parameter reads no path from the loss and gives zeros (on a laid-out
    model every gradient FSDP2 holds). Every rank of a sharded model
    computes the same whole-batch loss, so FSDP2's mean over its axes
    keeps that gradient."""
    named = [(k, p) for k, p in model.named_parameters() if p.requires_grad]
    saved = [p.grad for _, p in named]
    for _, p in named:
        p.grad = None
    try:
        loss, _ = loss_fn(model, batch)
        loss.backward()
        return {k: p.grad if p.grad is not None else torch.zeros_like(p)
                for k, p in named}
    finally:
        for (_, p), g in zip(named, saved):
            p.grad = g


def _microbatches(batch: Mapping[str, Any], accum_steps: int
                  ) -> List[Dict[str, Any]]:
    """Split every batched leaf into ``accum_steps`` consecutive row
    blocks; 0-d and non-tensor leaves ride along into every microbatch."""
    micro: List[Dict[str, Any]] = [{} for _ in range(accum_steps)]
    for k, v in batch.items():
        if not isinstance(v, torch.Tensor) or v.dim() == 0:
            for m in micro:
                m[k] = v
            continue
        rows = v.shape[0]
        if rows % accum_steps:
            raise ValueError(
                f"batch of {rows} rows on this rank not divisible by "
                f"tony.train.accum-steps ({accum_steps})")
        for m, part in zip(micro, v.chunk(accum_steps)):
            m[k] = part
    return micro


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank (the same storage), or ``t``."""
    return t.to_local() if isinstance(t, DTensor) else t


def accumulate_grads(state: TrainState, batch: Mapping[str, Any],
                     accum_steps: int
                     ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                                Dict[str, Any]]:
    """Forward and backward over ``accum_steps`` microbatches of
    ``batch``: ``(grads by name, mean loss, mean aux)``. The gradients are
    the ``.grad`` fields, summed over microbatches and scaled by 1/A, with
    zeros for a parameter the loss did not reach (every rank returns the
    same names, so every rank plans the same buckets); no collective runs
    here, except FSDP2's reduction of a sharded model's gradients, which it
    holds back until the last microbatch."""
    accum_steps = max(1, int(accum_steps))
    sync = getattr(state.model, "set_requires_gradient_sync", None)
    losses, auxes = [], []
    for a, micro in enumerate(_microbatches(batch, accum_steps)):
        if sync is not None:
            sync(a == accum_steps - 1)
        loss, aux = state.loss_fn(state.model, micro)
        loss.backward()
        losses.append(loss.detach())
        auxes.append(aux)
    grads = fill_missing_grads(state.model)
    if accum_steps > 1:
        inv = 1.0 / accum_steps
        for g in grads.values():
            _local(g).mul_(torch.tensor(inv, dtype=g.dtype))
    aux = {k: torch.stack([torch.as_tensor(a[k]).detach().float()
                           for a in auxes]).mean(0) for k in auxes[0]}
    return grads, torch.stack(losses).mean(), aux


def _sync_into(grads: Dict[str, torch.Tensor], bucket_mb: int,
               group: Any, mean: bool = True) -> None:
    """``bucketed_sync`` over ``group``, written back into ``grads``."""
    for k, g in bucketed_sync(grads, bucket_mb, group, mean).items():
        grads[k].copy_(g)


def _mesh_sync(grads: Mapping[str, torch.Tensor], bucket_mb: int,
               mesh: Any, split_sp: bool = True,
               reduced: Optional[Mapping[str, Sequence[str]]] = None
               ) -> None:
    """The gradient reductions FSDP2 does not do, in place, each on the
    local shards of the gradients whose ``reduced`` entry (the mesh axes
    FSDP2 reduced them over: ``sharding.fully_shard_placed``'s
    ``reduced_by_fsdp``; none for a missing name) lacks the axis:
    averaged over ``fsdp`` then ``dp``; with ``split_sp`` (a model that
    splits the sequence over sp) summed over ``sp``, each rank's being its
    chunk's share of one loss (the pipelined decoder's sp ranks are
    replicas of one another, and sum nothing); then averaged over
    ``dcn_dp``. A gradient's shard is the same on the ranks of an axis its
    parameter is not sharded over, so each such reduction adds like
    slices; over its shard axes FSDP2's reduce-scatter has already added
    them."""
    shape = mesh_shape(mesh)
    reduced = reduced or {}

    def left(axis):
        return {k: _local(g) for k, g in grads.items()
                if axis not in reduced.get(k, ())}

    for axis in ("fsdp", "dp"):
        if shape[axis] > 1:
            _sync_into(left(axis), bucket_mb, mesh.get_group(axis))
    if shape["sp"] > 1 and split_sp:
        _sync_into(left("sp"), bucket_mb, mesh.get_group("sp"), mean=False)
    if shape["dcn_dp"] > 1:
        _sync_into(left("dcn_dp"), bucket_mb, mesh.get_group("dcn_dp"))


def batch_mean(x: torch.Tensor, mesh: Any) -> torch.Tensor:
    """The mean of ``x`` over the batch axes of ``mesh`` (each rank's
    value counted once per batch coordinate)."""
    x = x.detach().clone()
    shape = mesh_shape(mesh)
    for axis in BATCH_AXES:
        if shape[axis] > 1:
            torch.distributed.all_reduce(x, group=mesh.get_group(axis))
    return x / batch_world(mesh)


def train_step_accum(state: TrainState, batch: Mapping[str, Any],
                     accum_steps: int = 1,
                     bucket_mb: int = DEFAULT_BUCKET_MB,
                     group: Optional[Any] = None,
                     comms_phase: bool = True,
                     mesh: Optional[Any] = None) -> Dict[str, Any]:
    """The grad-sync twin of ``train_step``, counterpart of the step
    ``jit_train_step_accum`` builds: accumulate ``accum_steps``
    microbatches of this rank's ``batch``, mean-reduce the gradients over
    ``group`` in ``bucket_mb``-MiB buckets (inside the telemetry ``comms``
    phase unless ``comms_phase`` is False), then apply the optimizer.
    Returns what ``train_step`` returns. With no group there is no
    collective: the gradients are this process's.

    With ``mesh`` (in place of ``group``) the state is a sharded one
    (``init_sharded_state``): the sync is the mesh's (module docstring; the
    comms phase only where a batch axis or sp is larger than 1, since a
    mesh of one rank runs no explicit collective) and the loss and aux are the
    global batch's means."""
    if mesh is not None and group is not None:
        raise ValueError("train_step_accum takes a group or a mesh, not "
                         "both")
    grads, loss, aux = accumulate_grads(state, batch, accum_steps)
    if mesh is not None:
        shape = mesh_shape(mesh)
        # Only a model that shard_model gave the sp group splits the
        # sequence over it.
        split_sp = getattr(state.model, "sp_group", None) is not None
        reduced = getattr(state.model, "reduced_by_fsdp", None)
        if comms_phase and any(shape[a] > 1 for a in BATCH_AXES + ("sp",)):
            telemetry.block_until_ready(grads)
            with telemetry.phase("comms") as p:
                _mesh_sync(grads, bucket_mb, mesh, split_sp, reduced)
                p.block_until_ready(grads)
        else:
            _mesh_sync(grads, bucket_mb, mesh, split_sp, reduced)
        state.apply_gradients()
        return {"loss": batch_mean(loss, mesh), "step": state.step,
                **{k: batch_mean(v, mesh) for k, v in aux.items()}}
    if group is not None:
        if comms_phase:
            # The backward still running on the card is the step's
            # compute: wait for it outside the phase, so that comms times
            # the all-reduce and its packing alone.
            telemetry.block_until_ready(grads)
            with telemetry.phase("comms") as p:
                grads = bucketed_sync(grads, bucket_mb, group)
                p.block_until_ready(grads)
        else:
            grads = bucketed_sync(grads, bucket_mb, group)
    state.apply_gradients(grads)
    return {"loss": loss, "step": state.step, **aux}
