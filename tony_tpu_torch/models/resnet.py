"""ResNet (v1.5 bottleneck, GroupNorm) in PyTorch.

Counterpart of ``tony_tpu/models/resnet.py``, with the same numbers at the
same places:

- the public input is NHWC images ``[B, H, W, 3]``; inside, activations are
  logical NCHW in ``torch.channels_last`` memory (the permuted view of a
  contiguous NHWC tensor, no copy), and conv weights are stored
  channels_last, so cuDNN keeps its outputs channels_last and each norm
  reads the ``[B, H·W, C]`` view of its input without a copy;
- flax's ``padding="SAME"``: the total pad ``max((out−1)·s + k − in, 0)``
  is split ``lo = total // 2``, ``hi = total − lo`` (asymmetric at stride 2:
  (2, 3) for the 7×7/2 stem at 224², (0, 1) for a 3×3/2), padded
  explicitly before ``conv2d(padding=0)``; the stem's 3×3/2 max pool pads
  with −inf the same way;
- f32 parameters; each conv casts its input and weight to ``cfg.dtype``
  (no autocast), as a flax ``Conv(dtype=bf16)`` over f32 params does;
  he_normal (truncated, fan in = kh·kw·in) conv weights;
- every conv → norm (→ ReLU) chain is ``ops.convfuse.fused_groupnorm_relu``
  (``cfg.fused``, on by default) or the unfused twin, ``F.group_norm`` in
  f32 with eps 1e-6 and its own scale and bias, then ``relu``;
- the residual add and the block's ReLU run in ``cfg.dtype``; the global
  mean sums in f32, divides, and rounds to ``cfg.dtype`` once, as
  ``jnp.mean`` does; the head is an f32 ``Dense`` with bias.

Module names map one to one onto the flax tree (``convert.py``). The
parameters are drawn in ``named_parameters()`` order
(``ResNet.init_parameter_``, which a sharded init replays one tensor at a
time); ``device="meta"`` builds the skeleton without drawing.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from tony_tpu_torch._device import resolve_device
from tony_tpu_torch.models.mlp import DenseBias, variance_scaling_
from tony_tpu_torch.ops.convfuse import fused_groupnorm_relu

_CL = torch.channels_last


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Sequence[int] = (3, 4, 6, 3)   # ResNet-50
    width: int = 64
    num_classes: int = 1000
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    norm_groups: int = 32
    # Each conv → norm → relu chain runs the fused two-pass GroupNorm
    # (ops/convfuse.py); False keeps F.group_norm + relu, the parity twin.
    fused: bool = True

    @classmethod
    def resnet50(cls, **kw) -> "ResNetConfig":
        return cls(stage_sizes=(3, 4, 6, 3), **kw)

    @classmethod
    def tiny(cls, **kw) -> "ResNetConfig":
        defaults = dict(stage_sizes=(1, 1), width=8, num_classes=10,
                        dtype=torch.float32, norm_groups=4)
        defaults.update(kw)
        return cls(**defaults)


def same_pad(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax/XLA ``padding="SAME"`` for one spatial dim: (lo, hi)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, s: int,
              value: float = 0.0) -> torch.Tensor:
    (hl, hh), (wl, wh) = same_pad(x.shape[2], k, s), same_pad(x.shape[3], k, s)
    if hl or hh or wl or wh:
        x = F.pad(x, (wl, wh, hl, hh), value=value)
    return x.contiguous(memory_format=_CL)


class _Conv(nn.Module):
    """Bias-free ``k``×``k`` conv, stride ``s``, SAME padding; weight
    ``[out, in, k, k]`` f32 in channels_last memory."""

    def __init__(self, in_ch: int, out_ch: int, k: int, s: int,
                 cfg: ResNetConfig, device: torch.device):
        super().__init__()
        self.k, self.s, self.dtype = k, s, cfg.dtype
        self.weight = nn.Parameter(torch.empty(
            (out_ch, in_ch, k, k), dtype=cfg.param_dtype,
            device=device).contiguous(memory_format=_CL))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _pad_same(x.to(self.dtype), self.k, self.s)
        return F.conv2d(x, self.weight.to(self.dtype), stride=self.s)


class _Norm(nn.Module):
    """GroupNorm over ``min(norm_groups, C)`` groups, then ReLU when
    ``relu``: fused (``fused_groupnorm_relu`` on the NHWC view) or the
    unfused ``F.group_norm`` twin, with the same ``scale``/``bias``."""

    def __init__(self, channels: int, cfg: ResNetConfig,
                 device: torch.device, relu: bool = True):
        super().__init__()
        self.groups = min(cfg.norm_groups, channels)
        self.fused, self.relu, self.dtype = cfg.fused, relu, cfg.dtype
        self.scale = nn.Parameter(torch.ones(channels, dtype=cfg.param_dtype,
                                             device=device))
        self.bias = nn.Parameter(torch.zeros(channels, dtype=cfg.param_dtype,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            y = fused_groupnorm_relu(x.permute(0, 2, 3, 1), self.scale,
                                     self.bias, groups=self.groups,
                                     relu=self.relu)
            return y.permute(0, 3, 1, 2)
        y = F.group_norm(x.float(), self.groups, self.scale.float(),
                         self.bias.float(), eps=1e-6).to(self.dtype)
        return torch.relu(y) if self.relu else y


class _Bottleneck(nn.Module):
    """1×1 → 3×3 (stride here: v1.5) → 1×1 ×4, each with its norm; a 1×1
    projection with its norm on the residual when the shapes differ."""

    def __init__(self, in_ch: int, features: int, stride: int,
                 cfg: ResNetConfig, device: torch.device):
        super().__init__()
        out = features * 4
        specs = [(in_ch, features, 1, 1), (features, features, 3, stride),
                 (features, out, 1, 1)]
        # The reference projects when the shapes differ; every stride-2
        # block also changes the channel count, so this is the same test.
        if in_ch != out or stride != 1:
            specs.append((in_ch, out, 1, stride))           # projection
        self.convs = nn.ModuleList(_Conv(i, o, k, s, cfg, device)
                                   for i, o, k, s in specs)
        self.norms = nn.ModuleList(_Norm(o, cfg, device, relu=j < 2)
                                   for j, (_, o, _, _) in enumerate(specs))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for conv, norm in zip(self.convs[:3], self.norms):
            y = norm(conv(y))
        residual = x
        if len(self.convs) == 4:
            residual = self.norms[3](self.convs[3](x))
        return torch.relu(y + residual)


class ResNet(nn.Module):
    """Images [B, H, W, 3] → logits [B, num_classes] f32.

    Parameters are made on ``device`` (default ``"cuda"``; raises without a
    CUDA device unless ``"cpu"`` is asked for; ``"meta"`` allocates and
    draws nothing) from ``generator``, a generator on that device (default:
    one seeded with 0)."""

    def __init__(self, cfg: ResNetConfig,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        meta = torch.device(device).type == "meta"
        dev = torch.device("meta") if meta else resolve_device(device)
        self.cfg = cfg
        self.stem_conv = _Conv(3, cfg.width, 7, 2, cfg, dev)
        self.stem_norm = _Norm(cfg.width, cfg, dev)
        blocks, in_ch = [], cfg.width
        for stage, n_blocks in enumerate(cfg.stage_sizes):
            for block in range(n_blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                features = cfg.width * 2 ** stage
                blocks.append(_Bottleneck(in_ch, features, stride, cfg, dev))
                in_ch = features * 4
        self.blocks = nn.ModuleList(blocks)
        self.head = DenseBias(in_ch, cfg.num_classes, cfg.param_dtype, dev)
        if not meta:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            with torch.no_grad():
                for name, p in self.named_parameters():
                    # Drawn contiguous: a conv weight is kept channels_last.
                    whole = torch.empty(p.shape, dtype=p.dtype, device=dev)
                    self.init_parameter_(name, whole, generator)
                    p.copy_(whole)

    def init_parameter_(self, name: str, t: torch.Tensor,
                        generator: torch.Generator) -> None:
        """Fill ``t``, the whole (contiguous) parameter ``name``, as the
        constructor does: he_normal (fan in kh·kw·in) for a conv weight,
        lecun_normal for the head's, ones for a norm scale, zeros for a
        bias."""
        if name.endswith(".scale"):
            nn.init.ones_(t)
        elif name.endswith(".bias"):
            nn.init.zeros_(t)
        elif t.dim() == 4:
            variance_scaling_(t, math.prod(t.shape[1:]), 2.0, generator)
        else:
            variance_scaling_(t, t.shape[1], 1.0, generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = images.to(cfg.dtype).permute(0, 3, 1, 2)        # NCHW view
        x = self.stem_norm(self.stem_conv(x))
        x = F.max_pool2d(_pad_same(x, 3, 2, float("-inf")), 3, 2)
        for blk in self.blocks:
            x = blk(x)
        pooled = torch.sum(x, dim=(2, 3), dtype=torch.float32) / (
            x.shape[2] * x.shape[3])
        return self.head(pooled.to(cfg.dtype))
