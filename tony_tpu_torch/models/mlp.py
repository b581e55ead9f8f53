"""MNIST MLP and the classification loss, in PyTorch.

Counterpart of ``tony_tpu/models/mlp.py``: ``MnistMLP`` is 784 → hidden →
hidden → 10 with ReLU between, three flax-style ``Dense`` layers with bias
(weight ``[out, in]``, truncated-normal lecun init, zero bias) in f32;
``classification_loss`` is the mean NLL of an f32 log_softmax. Module names
follow the flax tree (``Dense_{i}`` → ``dense.{i}``, see ``convert.py``).

Under the tensor-parallel plan (``parallel/sharding.py``, from the
reference's logical axes: ``("embed", "mlp")``, ``("mlp", "embed")``,
``("embed", "vocab")``) the three layers run colwise, rowwise and colwise
over tp with the default rules (rowwise, colwise, rowwise under a table
that puts ``embed`` over tp), their biases replicated, as the reference's
are: a colwise layer adds its slice of the bias to its slice of the
outputs (gathered where the next layer is not rowwise), a rowwise one sums
the ranks' partial products and then adds the whole bias.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from tony_tpu_torch._device import resolve_device
from tony_tpu_torch.parallel import _comm

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
    """flax ``Dense`` with bias in f32: weight ``[out, in]`` (left
    uninitialized: the model draws it, lecun-normal), bias zeros; input and
    weight multiply in f32.

    The tp plan sets ``tp_group`` and ``tp_style`` (the weight then a
    DTensor over tp): ``"colwise"`` (weight ``Shard(0)``: this rank's
    outputs, a channel-shard input gathered first), ``"colwise_gather"``
    (the same, the outputs gathered: the head's logits) or ``"rowwise"``
    (weight ``Shard(1)``: the input is this rank's slice of the features,
    or the whole features, of which it takes its slice; the partial
    products are summed over tp before the bias). The input's
    gradient of a colwise layer sums the ranks' parts: each rank's outputs
    read the whole input."""

    def __init__(self, in_features: int, out_features: int,
                 param_dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            (out_features, in_features), dtype=param_dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, dtype=param_dtype,
                                             device=device))
        self.tp_group, self.tp_style = None, None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.tp_group
        if g is None:
            return F.linear(x.float(), self.weight.float(), self.bias.float())
        w = self.weight.to_local().float()
        if self.tp_style == "rowwise":
            if x.shape[-1] == self.weight.shape[1]:
                # A whole input (the MLP's image, under a table that puts
                # the embed dim over tp): this rank's slice of it.
                x = _comm.split_to_group(x, g, -1)
            y = _comm.reduce_from_group(F.linear(x.float(), w), g)
            return y + self.bias.float()
        if x.shape[-1] != self.weight.shape[1]:
            x = _comm.gather_from_group(x, g, -1)
        x = _comm.sum_grad_over_group(x, g)
        y = F.linear(x.float(), w,
                     _comm.split_to_group(self.bias, g, 0).float())
        if self.tp_style == "colwise_gather":
            y = _comm.gather_from_group(y, g, -1)
        return y


class MnistMLP(nn.Module):
    """Images [B, 28, 28, 1] (any [B, ...] of 784 values) → logits [B, 10]
    f32. Made on ``device`` (default ``"cuda"``; raises without a CUDA
    device unless ``"cpu"`` is asked for; ``"meta"`` allocates and draws
    nothing) from ``generator`` (default: one seeded with 0), drawing in
    ``named_parameters()`` order (``init_parameter_``, which a sharded init
    replays)."""

    # The reference's logical axes (tony_tpu/models/mlp.py:22-29), in
    # torch's [out, in] layout.
    PARAM_AXES = {"dense.0.weight": ("mlp", "embed"),
                  "dense.1.weight": ("embed", "mlp"),
                  "dense.2.weight": ("vocab", "embed")}

    def __init__(self, hidden: int = 512,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        meta = torch.device(device).type == "meta"
        dev = torch.device("meta") if meta else resolve_device(device)
        self.dense = nn.ModuleList(
            DenseBias(i, o, torch.float32, dev)
            for i, o in ((784, hidden), (hidden, hidden), (hidden, 10)))
        if not meta:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            for name, p in self.named_parameters():
                self.init_parameter_(name, p, generator)

    def init_parameter_(self, name: str, t: torch.Tensor,
                        generator: torch.Generator) -> None:
        """Fill ``t``, the whole parameter ``name``: lecun_normal for a
        weight, zeros for a bias."""
        if name.endswith(".bias"):
            nn.init.zeros_(t)
        else:
            variance_scaling_(t, t.shape[1], 1.0, generator)

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
