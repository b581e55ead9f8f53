"""Collectives with a reverse mode, for sequence and expert parallelism.

The reference differentiates through ``lax.ppermute`` and
``lax.all_to_all`` for free: the transpose of a permutation is the reverse
permutation, the transpose of an all-to-all the all-to-all back. Torch's
collectives have no autograd, so each one the port needs is a
``torch.autograd.Function`` here, with that transpose as its backward:

- ``ppermute(x, group, shift)``: every rank sends ``x`` to the rank
  ``shift`` places on around the group's ring and receives from the rank
  ``shift`` places back (one ``batch_isend_irecv``, so that no pair waits on
  the other); backward: the same with ``-shift``;
- ``all_to_all_tiled(x, group, split_dim, concat_dim)``: JAX's
  ``all_to_all(..., tiled=True)``: ``x`` cut into n blocks on
  ``split_dim``, block i to rank i, the received blocks joined on
  ``concat_dim`` in rank order; backward: the same with the two dims
  swapped;
- ``split_to_group(x, group, dim)``: this rank's contiguous 1/n of a
  tensor every rank of the group holds alike; backward: the slices'
  gradients gathered, so that every rank holds the whole gradient;
- ``gather_from_group(x, group, dim)``: the ranks' slices joined in rank
  order; backward: this rank's slice of the gradient, no sum. Every rank of
  the group computes the same loss from the gathered tensor, so the
  gradient each rank receives is already the whole one
  (``torch.distributed.nn.functional.all_gather`` sums it, counting a
  replicated loss n times);
- ``sum_grad_over_group(x, group)``: the identity; backward: the gradients
  of every rank of the group summed (what JAX's transpose gives a value
  every rank holds alike but only some use: the pipeline's embedded
  tokens, which only stage 0 injects);
- ``reduce_from_group(x, group)``: the sum of every rank's ``x``;
  backward: the identity (each rank holds a partial sum of a value that
  every rank then uses alike, as a tensor-parallel product's output split
  on its contraction dim: each rank's cotangent is already the whole one);
- ``broadcast_from_group(x, group, src)``: every rank leaves with group
  rank ``src``'s ``x``; backward: ``src`` keeps its gradient, the others
  get zeros (every rank takes the same loss from the broadcast value, so
  ``src``'s gradient is already the whole one; summing the replicas would
  count it n times).

Peers are global ranks, found from the group (a ``DeviceMesh`` axis's
``get_group()``). A group of one rank, or none, makes each function the
identity.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist


def group_size(group: Optional[Any]) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group: Optional[Any]) -> int:
    return 0 if group is None else dist.get_rank(group)


def _ppermute(x: torch.Tensor, group: Any, shift: int) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x,
                      dist.get_global_rank(group, (r + shift) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (r - shift) % n), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _ppermute(x.contiguous(), group, shift)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g.contiguous(), ctx.group, -ctx.shift), None, None


def ppermute(x: torch.Tensor, group: Optional[Any],
             shift: int = 1) -> torch.Tensor:
    """Rank r's ``x`` lands on rank ``(r + shift) % n`` of ``group``."""
    if group_size(group) == 1:
        return x
    return _PPermute.apply(x, group, shift)


def _all_to_all(x: torch.Tensor, group: Any, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not split into {n} blocks")
    # all_to_all_single sends block i of dim 0 to rank i and stacks the
    # received blocks on dim 0: bring the split dim to the front.
    inp = x.movedim(split_dim, 0).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    block = list(inp.shape)
    block[0] //= n
    # [n, block...]: the block from rank j at index j, its split dim back in
    # place, then the n blocks joined on concat_dim in rank order.
    y = out.view(n, *block).movedim(1, split_dim + 1)
    return y.movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, split_dim, concat_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        return _all_to_all(g, group, concat_dim, split_dim), None, None, None


def all_to_all_tiled(x: torch.Tensor, group: Optional[Any], split_dim: int,
                     concat_dim: int) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``
    over ``group``."""
    if group_size(group) == 1:
        return x
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def _gather(x: torch.Tensor, group: Any, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _slice(x: torch.Tensor, group: Any, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"into {n} equal slices")
    return x.chunk(n, dim=dim)[dist.get_rank(group)].contiguous()


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return _slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, *ctx.args), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, *ctx.args), None, None


def split_to_group(x: torch.Tensor, group: Optional[Any],
                   dim: int) -> torch.Tensor:
    """This rank's contiguous 1/n of ``x`` on ``dim``; ``x`` must be the
    same on every rank of ``group``."""
    if group_size(group) == 1:
        return x
    return _Split.apply(x, group, dim)


def gather_from_group(x: torch.Tensor, group: Optional[Any],
                      dim: int) -> torch.Tensor:
    """The ranks' ``x`` joined on ``dim`` in rank order; the gradient is
    taken to be the same on every rank (a loss every rank computes
    alike)."""
    if group_size(group) == 1:
        return x
    return _Gather.apply(x, group, dim)


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_grad_over_group(x: torch.Tensor,
                        group: Optional[Any]) -> torch.Tensor:
    """``x`` unchanged; its gradient summed over ``group``."""
    if group_size(group) == 1:
        return x
    return _SumGrad.apply(x, group)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_from_group(x: torch.Tensor,
                      group: Optional[Any]) -> torch.Tensor:
    """The sum of the ranks' ``x``; the gradient passes to each unchanged."""
    if group_size(group) == 1:
        return x
    return _Reduce.apply(x, group)


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, src):
        ctx.mine = dist.get_rank(group) == src
        out = x.contiguous().clone()
        dist.broadcast(out, dist.get_global_rank(group, src), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.mine else torch.zeros_like(g)), None, None


def broadcast_from_group(x: torch.Tensor, group: Optional[Any],
                         src: int) -> torch.Tensor:
    """Group rank ``src``'s ``x`` on every rank of ``group``; the gradient
    reaches ``src`` once."""
    if group_size(group) == 1:
        return x
    return _Broadcast.apply(x, group, src)
