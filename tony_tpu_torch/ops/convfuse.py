"""Fused GroupNorm→ReLU for the ResNet conv trunk: a CUDA kernel on the card,
plain PyTorch on the CPU.

Counterpart of ``tony_tpu/ops/convfuse.py``. The activation is NHWC
(``[B, H, W, C]``, or any ``[B, ..., C]``); GroupNorm(+ReLU) runs in two
passes over it:

- ``group_stats``: mean and E[x²] per (batch, group) in f32, var =
  E[x²] − E[x]² clamped at 0;
- ``folded_affine``: scale, rsqrt(var + eps), mean and bias folded into
  per-(batch, channel) f32 ``a``/``b``, so that the whole normalise + affine
  (+ ReLU) is ``max(x·a + b, 0)``;
- the apply, one ``torch.autograd.Function`` over the flattened
  ``[B, H·W, C]`` view. A CUDA tensor launches the hand-written kernel
  (``ops/_convfuse_cuda.py``, ``csrc/convfuse_apply.cu``) or raises; a CPU
  tensor takes ``apply_plain``, the counterpart of the reference's
  ``_apply_lax``. The Function saves x, a and b, not y: the backward
  recomputes the ReLU mask, which is what the reference's
  ``jax.checkpoint`` around the apply buys. Its backward is plain torch in
  f32 (the reference leaves it to XLA autodiff: there is no backward
  kernel), and ``da``/``db`` flow on through ``folded_affine`` and
  ``group_stats`` by autograd.

Under the tensor-parallel plan (``parallel/sharding.py``) the channels are
split over the tp ranks and each rank normalises its own contiguous slice
(``tp_group``): where the slice holds whole groups the statistics are its
own; where a group straddles two ranks (more ranks than groups) each rank
sums its part of every group and the sums are all-reduced over tp before
``folded_affine``. The apply runs on the local ``[B, H·W, C/tp]`` view.

The reference's ``use_pallas``/``remat`` switches and its probe-once
degrade to the lax path have no counterpart: the port does not fall back.
"""

from __future__ import annotations

import torch

from tony_tpu_torch.ops import _convfuse_cuda
from tony_tpu_torch.parallel import _comm


def group_stats(x: torch.Tensor, groups: int):
    """(mean, var) [B, G] f32 per (batch, group) over the spatial dims and
    the group's channels (E[x²] − E[x]² with a non-negative clamp)."""
    b, c = x.shape[0], x.shape[-1]
    xg = x.reshape(b, -1, groups, c // groups).float()
    mean = xg.mean(dim=(1, 3))
    ex2 = xg.square().mean(dim=(1, 3))
    var = (ex2 - mean.square()).clamp_min(0.0)
    return mean, var


def straddled_group_stats(x: torch.Tensor, groups: int, first: int,
                          channels: int, tp_group):
    """(mean, var) [B, G] f32 of all ``groups`` groups of ``channels``
    channels, from every rank of ``tp_group`` holding the slice of them
    that starts at channel ``first`` (``x`` [B, ..., C_local]): each rank
    sums x and x² over its part of each group, the sums are added over the
    group (an all-reduce whose backward adds the ranks' gradients too: each
    rank normalises its own channels with the totals), then divided."""
    b, c = x.shape[0], x.shape[-1]
    cg = channels // groups
    xf = x.reshape(b, -1, c).float()
    sums = torch.stack([xf.sum(1), xf.square().sum(1)], 1)       # [B, 2, C]
    idx = torch.arange(first, first + c, device=x.device) // cg
    part = sums.new_zeros(b, 2, groups).index_add(2, idx, sums)
    total = _comm.reduce_from_group(
        _comm.sum_grad_over_group(part, tp_group), tp_group)
    mean, ex2 = (total / (xf.shape[1] * cg)).unbind(1)
    return mean, (ex2 - mean.square()).clamp_min(0.0)


def folded_affine(mean: torch.Tensor, var: torch.Tensor, scale: torch.Tensor,
                  bias: torch.Tensor, channels: int, eps: float,
                  first: int = 0):
    """Fold (mean, var, scale, bias) into per-(B, C) f32 ``a``/``b`` so
    that normalise + affine is ``x * a + b``. ``scale`` and ``bias`` may be
    the slice of the ``channels`` channels that starts at ``first`` (a
    tensor-parallel rank's): ``a``/``b`` are then that slice's."""
    cg = channels // mean.shape[-1]
    idx = torch.arange(first, first + scale.shape[0],
                       device=mean.device) // cg
    inv_c = torch.rsqrt(var + eps)[:, idx]                        # [B, C]
    mean_c = mean[:, idx]
    a = inv_c * scale.float()[None, :]
    b = bias.float()[None, :] - mean_c * a
    return a, b


def apply_plain(x3: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                relu: bool) -> torch.Tensor:
    """The kernel's plain version: x3 [B, R, C], a/b [B, C] f32 →
    ``max(x3·a + b, 0)`` in f32, cast to x3's dtype."""
    y = x3.float() * a[:, None, :] + b[:, None, :]
    if relu:
        y = torch.relu(y)
    return y.to(x3.dtype)


def apply(x3: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
          relu: bool) -> torch.Tensor:
    """Dispatch: a CUDA tensor launches the kernel, a CPU tensor takes the
    plain version; nothing else is accepted and nothing falls back."""
    if x3.device.type == "cuda":
        return _convfuse_cuda.apply(x3, a, b, relu)
    if x3.device.type == "cpu":
        return apply_plain(x3, a, b, relu)
    raise RuntimeError(f"the fused GroupNorm apply runs on cuda or cpu "
                       f"tensors, got {x3.device}")


class _Apply(torch.autograd.Function):
    """(x3, a, b) → y; saves the inputs and recomputes the mask."""

    @staticmethod
    def forward(ctx, x3, a, b, relu):
        ctx.save_for_backward(x3, a, b)
        ctx.relu = relu
        return apply(x3, a, b, relu)

    @staticmethod
    def backward(ctx, dy):
        x3, a, b = ctx.saved_tensors
        xf = x3.float()
        g = dy.float()
        if ctx.relu:
            g = g * (xf * a[:, None, :] + b[:, None, :] > 0)
        dx = (g * a[:, None, :]).to(x3.dtype)
        return dx, (g * xf).sum(1), g.sum(1), None


def groupnorm_affine(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, groups: int, eps: float = 1e-6,
                     tp_group=None):
    """The stats sweep and ``folded_affine``: ``a``/``b`` [B, C] f32 of the
    channels-last ``x`` [B, ..., C] over ``groups`` groups. With
    ``tp_group`` (n ranks, this one r) ``x``, ``scale`` and ``bias`` are
    rank r's contiguous slice of n·C channels and ``groups`` counts the
    groups of all of them: a slice of whole groups takes its own stats, a
    group split between ranks takes ``straddled_group_stats``."""
    c = x.shape[-1]
    n, r = _comm.group_size(tp_group), _comm.group_rank(tp_group)
    channels = n * c
    if channels % groups:
        raise ValueError(f"channels {channels} not divisible by groups "
                         f"{groups}")
    cg = channels // groups
    if c % cg == 0:
        mean, var = group_stats(x, c // cg)
        return folded_affine(mean, var, scale, bias, c, eps)
    mean, var = straddled_group_stats(x, groups, r * c, channels, tp_group)
    return folded_affine(mean, var, scale, bias, channels, eps, first=r * c)


def fused_groupnorm_relu(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, *, groups: int,
                         eps: float = 1e-6, relu: bool = True,
                         tp_group=None) -> torch.Tensor:
    """GroupNorm (+ ReLU) of the channels-last ``x`` [B, ..., C] in two
    passes, the stats sweep and the fused apply; output in x's dtype.
    Numerically ``relu(GroupNorm(groups)(x))`` to f32 tolerance. With
    ``tp_group``, ``x`` is this rank's channel slice (``groupnorm_affine``).

    ``x`` must be contiguous: its ``[B, H·W, C]`` view is taken without a
    copy, so a layout slip raises here instead of costing a hidden one."""
    c = x.shape[-1]
    a, b = groupnorm_affine(x, scale, bias, groups, eps, tp_group)
    y = _Apply.apply(x.view(x.shape[0], -1, c), a, b, relu)
    return y.view(x.shape)
