"""MNIST MLP and the classification loss, in PyTorch.

Counterpart of ``tony_tpu/models/mlp.py``: ``MnistMLP`` is 784 → hidden →
hidden → 10 with ReLU between, three flax-style ``Dense`` layers with bias
(weight ``[out, in]``, truncated-normal lecun init, zero bias) in f32;
``classification_loss`` is the mean NLL of an f32 log_softmax. Module names
follow the flax tree (``Dense_{i}`` → ``dense.{i}``, see ``convert.py``).
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from tony_tpu_torch._device import resolve_device

# flax's truncated-normal initialisers: std of a unit normal cut at ±2.
_TRUNC_STD = 0.87962566103423978


def variance_scaling_(w: torch.Tensor, fan_in: int, scale: float,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``variance_scaling(scale, "fan_in", "truncated_normal")`` in
    place: lecun_normal is scale 1, he_normal scale 2."""
    std = math.sqrt(scale / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                     generator=generator)


class DenseBias(nn.Module):
    """flax ``Dense`` with bias in f32: weight ``[out, in]`` lecun-normal
    (drawn from ``generator`` when one is given, else left uninitialized:
    a ``ResNet`` draws its head itself), bias zeros; input and weight
    multiply in f32."""

    def __init__(self, in_features: int, out_features: int,
                 param_dtype: torch.dtype, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            (out_features, in_features), dtype=param_dtype, device=device))
        if generator is not None:
            variance_scaling_(self.weight, in_features, 1.0, generator)
        self.bias = nn.Parameter(torch.zeros(out_features, dtype=param_dtype,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.float(), self.weight.float(), self.bias.float())


class MnistMLP(nn.Module):
    """Images [B, 28, 28, 1] (any [B, ...] of 784 values) → logits [B, 10]
    f32. Made on ``device`` (default ``"cuda"``; raises without a CUDA
    device unless ``"cpu"`` is asked for) from ``generator``."""

    def __init__(self, hidden: int = 512,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.dense = nn.ModuleList(
            DenseBias(i, o, torch.float32, dev, generator)
            for i, o in ((784, hidden), (hidden, hidden), (hidden, 10)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        x = torch.relu(self.dense[0](x))
        x = torch.relu(self.dense[1](x))
        return self.dense[2](x)


def classification_loss(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` [B] under ``logits``
    [B, classes], log_softmax in f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels[:, None].long())[:, 0].mean()
