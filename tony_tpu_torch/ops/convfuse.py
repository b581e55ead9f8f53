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

The reference's ``use_pallas``/``remat`` switches and its probe-once
degrade to the lax path have no counterpart: the port does not fall back.
"""

from __future__ import annotations

import torch

from tony_tpu_torch.ops import _convfuse_cuda


def group_stats(x: torch.Tensor, groups: int):
    """(mean, var) [B, G] f32 per (batch, group) over the spatial dims and
    the group's channels (E[x²] − E[x]² with a non-negative clamp)."""
    b, c = x.shape[0], x.shape[-1]
    xg = x.reshape(b, -1, groups, c // groups).float()
    mean = xg.mean(dim=(1, 3))
    ex2 = xg.square().mean(dim=(1, 3))
    var = (ex2 - mean.square()).clamp_min(0.0)
    return mean, var


def folded_affine(mean: torch.Tensor, var: torch.Tensor, scale: torch.Tensor,
                  bias: torch.Tensor, channels: int, eps: float):
    """Fold (mean, var, scale, bias) into per-(B, C) f32 ``a``/``b`` so
    that normalise + affine is ``x * a + b``."""
    groups = mean.shape[-1]
    cg = channels // groups
    inv_c = torch.rsqrt(var + eps).repeat_interleave(cg, dim=1)   # [B, C]
    mean_c = mean.repeat_interleave(cg, dim=1)
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


def fused_groupnorm_relu(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, *, groups: int,
                         eps: float = 1e-6, relu: bool = True
                         ) -> torch.Tensor:
    """GroupNorm (+ ReLU) of the channels-last ``x`` [B, ..., C] in two
    passes, the stats sweep and the fused apply; output in x's dtype.
    Numerically ``relu(GroupNorm(groups)(x))`` to f32 tolerance.

    ``x`` must be contiguous: its ``[B, H·W, C]`` view is taken without a
    copy, so a layout slip raises here instead of costing a hidden one."""
    c = x.shape[-1]
    if c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    mean, var = group_stats(x, groups)
    a, b = folded_affine(mean, var, scale, bias, c, eps)
    y = _Apply.apply(x.view(x.shape[0], -1, c), a, b, relu)
    return y.view(x.shape)
