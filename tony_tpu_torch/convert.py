"""Weights carried between the flax ``Transformer`` and the port's.

``from_flax_params`` takes the flax param tree of
``tony_tpu.models.Transformer`` as nested dicts of numpy arrays and returns
a ``state_dict`` for ``tony_tpu_torch.models.Transformer``;
``to_flax_params`` is its exact inverse (the gradient parity tests carry
torch grads back to the flax tree with it). A flax ``Dense`` kernel is
``[in, out]`` and a ``Dense.weight`` here ``[out, in]``, so every projection
is transposed; the embedding and the norm scales keep their layout.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

_DENSE = {"attn": ("wq", "wk", "wv", "wo"), "mlp": ("gate", "up", "down")}
_NORMS = ("attn_norm", "mlp_norm")


def _layer_ids(keys) -> list:
    ids = sorted(int(m.group(1)) for m in
                 (re.fullmatch(r"layer_(\d+)", k) for k in keys) if m)
    if ids != list(range(len(ids))):
        raise ValueError(f"layers are not numbered 0..n-1: {ids}")
    return ids


def from_flax_params(params: Mapping[str, Any]
                     ) -> Dict[str, torch.Tensor]:
    """flax param tree (numpy leaves) → torch ``state_dict`` (CPU tensors)."""
    def t(x):
        return torch.from_numpy(np.array(x, copy=True))

    sd = {"embedding": t(params["embedding"])}
    for i in _layer_ids(params):
        layer = params[f"layer_{i}"]
        for sub, names in _DENSE.items():
            for n in names:
                sd[f"layers.{i}.{sub}.{n}.weight"] = t(
                    np.asarray(layer[sub][n]["kernel"]).T)
        for n in _NORMS:
            sd[f"layers.{i}.{n}.scale"] = t(layer[n]["scale"])
    sd["final_norm.scale"] = t(params["final_norm"]["scale"])
    if "lm_head" in params:
        sd["lm_head.weight"] = t(np.asarray(params["lm_head"]["kernel"]).T)
    return sd


def to_flax_params(state_dict: Mapping[str, torch.Tensor]
                   ) -> Dict[str, Any]:
    """torch ``state_dict`` (or a name → grad mapping of the same names)
    → flax param tree of numpy arrays."""
    def n(x):
        return x.detach().cpu().numpy()

    out: Dict[str, Any] = {"embedding": n(state_dict["embedding"])}
    ids = sorted({int(k.split(".")[1]) for k in state_dict
                  if k.startswith("layers.")})
    for i in ids:
        layer: Dict[str, Any] = {}
        for sub, names in _DENSE.items():
            layer[sub] = {
                nm: {"kernel": np.ascontiguousarray(
                    n(state_dict[f"layers.{i}.{sub}.{nm}.weight"]).T)}
                for nm in names}
        for nm in _NORMS:
            layer[nm] = {"scale": n(state_dict[f"layers.{i}.{nm}.scale"])}
        out[f"layer_{i}"] = layer
    out["final_norm"] = {"scale": n(state_dict["final_norm.scale"])}
    if "lm_head.weight" in state_dict:
        out["lm_head"] = {"kernel": np.ascontiguousarray(
            n(state_dict["lm_head.weight"]).T)}
    return out
