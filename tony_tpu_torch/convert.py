"""Weights carried between the flax models and the port's.

``from_flax_params`` takes the flax param tree of the reference's
``Transformer`` (``tony_tpu/models/transformer.py``) as nested dicts of
numpy arrays and returns a ``state_dict`` for
``tony_tpu_torch.models.Transformer``;
``to_flax_params`` is its exact inverse (the gradient parity tests carry
torch grads back to the flax tree with it). A flax ``Dense`` kernel is
``[in, out]`` and a ``Dense.weight`` here ``[out, in]``, so every projection
is transposed; the embedding and the norm scales keep their layout.

``from_flax_resnet_params``/``to_flax_resnet_params``,
``from_flax_mlp_params``/``to_flax_mlp_params`` and
``from_flax_moe_params``/``to_flax_moe_params`` are the same pair for
``ResNet``, ``MnistMLP`` and ``MoETransformer`` (whose stacked expert
kernels ``layer_i/moe/{gate,up,down}`` keep their layout; its router is a
``Dense``); ``from_flax_pipeline_params``/``to_flax_pipeline_params`` for
the pipelined decoder (``parallel/pipeline.py``), whole or one stage's.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

_DENSE = {"attn": ("wq", "wk", "wv", "wo"), "mlp": ("gate", "up", "down")}
_NORMS = ("attn_norm", "mlp_norm")


def _t(x) -> torch.Tensor:
    """A numpy leaf → a CPU tensor of its own memory."""
    return torch.from_numpy(np.array(x, copy=True))


def _n(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _ids(keys, prefix: str) -> list:
    """The ``i`` of every ``{prefix}_{i}`` in ``keys``, checked 0..n-1."""
    ids = sorted(int(m.group(1)) for m in
                 (re.fullmatch(prefix + r"_(\d+)", k) for k in keys) if m)
    if ids != list(range(len(ids))):
        raise ValueError(f"{prefix} modules are not numbered 0..n-1: {ids}")
    return ids


def from_flax_params(params: Mapping[str, Any]
                     ) -> Dict[str, torch.Tensor]:
    """flax param tree (numpy leaves) → torch ``state_dict`` (CPU tensors)."""
    return _from_flax_decoder(params, _DENSE)


def _from_flax_decoder(params, dense):
    sd = {"embedding": _t(params["embedding"])}
    for i in _ids(params, "layer"):
        layer = params[f"layer_{i}"]
        for sub, names in dense.items():
            for n in names:
                sd[f"layers.{i}.{sub}.{n}.weight"] = _t(
                    np.asarray(layer[sub][n]["kernel"]).T)
        for n in _NORMS:
            sd[f"layers.{i}.{n}.scale"] = _t(layer[n]["scale"])
    sd["final_norm.scale"] = _t(params["final_norm"]["scale"])
    if "lm_head" in params:
        sd["lm_head.weight"] = _t(np.asarray(params["lm_head"]["kernel"]).T)
    return sd


def to_flax_params(state_dict: Mapping[str, torch.Tensor]
                   ) -> Dict[str, Any]:
    """torch ``state_dict`` (or a name → grad mapping of the same names)
    → flax param tree of numpy arrays."""
    return _to_flax_decoder(state_dict, _DENSE)


def _to_flax_decoder(state_dict, dense):
    out: Dict[str, Any] = {"embedding": _n(state_dict["embedding"])}
    ids = sorted({int(k.split(".")[1]) for k in state_dict
                  if k.startswith("layers.")})
    for i in ids:
        layer: Dict[str, Any] = {}
        for sub, names in dense.items():
            layer[sub] = {
                nm: {"kernel": np.ascontiguousarray(
                    _n(state_dict[f"layers.{i}.{sub}.{nm}.weight"]).T)}
                for nm in names}
        for nm in _NORMS:
            layer[nm] = {"scale": _n(state_dict[f"layers.{i}.{nm}.scale"])}
        out[f"layer_{i}"] = layer
    out["final_norm"] = {"scale": _n(state_dict["final_norm.scale"])}
    if "lm_head.weight" in state_dict:
        out["lm_head"] = {"kernel": np.ascontiguousarray(
            _n(state_dict["lm_head.weight"]).T)}
    return out


# The MoE decoder: the dense model's tree with ``moe`` in place of ``mlp``.
_MOE_DENSE = {"attn": _DENSE["attn"], "moe": ("router",)}
_EXPERTS = ("gate", "up", "down")


def from_flax_moe_params(params: Mapping[str, Any]
                         ) -> Dict[str, torch.Tensor]:
    """flax ``MoETransformer`` param tree (numpy leaves) → torch
    ``state_dict`` of ``tony_tpu_torch.models.moe.MoETransformer``."""
    sd = _from_flax_decoder(params, _MOE_DENSE)
    for i in _ids(params, "layer"):
        for n in _EXPERTS:
            sd[f"layers.{i}.moe.{n}"] = _t(params[f"layer_{i}"]["moe"][n])
    return sd


def to_flax_moe_params(state_dict: Mapping[str, torch.Tensor]
                       ) -> Dict[str, Any]:
    """Inverse of ``from_flax_moe_params`` (also for a name → grad
    mapping of the same names)."""
    out = _to_flax_decoder(state_dict, _MOE_DENSE)
    for key, layer in out.items():
        if key.startswith("layer_"):
            i = key.split("_")[1]
            for n in _EXPERTS:
                layer["moe"][n] = _n(state_dict[f"layers.{i}.moe.{n}"])
    return out


# ---------------------------------------------------------------------------
# The pipelined decoder (``parallel/pipeline.py``): the reference's
# ``init_pipeline_params`` tree stacks every block leaf on a leading layer
# dim (``blocks/attn/wq/kernel`` ``[L, in, out]``), keeps ``final_norm`` a
# bare vector and ``lm_head`` a bare ``[dim, vocab]`` kernel; the port's
# ``PipelineTransformer`` names its blocks ``layers.{i}`` by global index and
# keeps ``final_norm`` and ``lm_head`` in that layout.
# ---------------------------------------------------------------------------
def _stage_range(n_layers: int, stage, n_stages: int) -> range:
    from tony_tpu_torch.parallel.pipeline import stage_layers

    return range(n_layers) if stage is None else \
        stage_layers(n_layers, n_stages, stage)


def from_flax_pipeline_params(params: Mapping[str, Any],
                              stage: Optional[int] = None,
                              n_stages: int = 1
                              ) -> Dict[str, torch.Tensor]:
    """The reference's pipeline tree (numpy leaves) → torch ``state_dict``
    of ``PipelineTransformer``; with ``stage``, only pp rank ``stage``'s
    layers of ``n_stages`` (and the head, which every stage holds)."""
    blocks = params["blocks"]
    sd = {"embedding": _t(params["embedding"])}
    for i in _stage_range(len(blocks["attn_norm"]["scale"]), stage,
                          n_stages):
        for sub, names in _DENSE.items():
            for n in names:
                sd[f"layers.{i}.{sub}.{n}.weight"] = _t(
                    np.asarray(blocks[sub][n]["kernel"][i]).T)
        for n in _NORMS:
            sd[f"layers.{i}.{n}.scale"] = _t(blocks[n]["scale"][i])
    sd["final_norm"] = _t(params["final_norm"])
    sd["lm_head"] = _t(params["lm_head"])
    return sd


def to_flax_pipeline_params(state_dict: Mapping[str, torch.Tensor],
                            stage: Optional[int] = None,
                            n_stages: int = 1) -> Dict[str, Any]:
    """Inverse of ``from_flax_pipeline_params`` (also for a name → grad
    mapping of the same names): the layers present, in order, stacked on
    the leading dim; with ``stage``, only pp rank ``stage``'s of
    ``n_stages`` (out of every layer the mapping holds)."""
    ids = sorted({int(k.split(".")[1]) for k in state_dict
                  if k.startswith("layers.")})
    ids = [ids[i] for i in _stage_range(len(ids), stage, n_stages)]

    def stacked(suffix, transpose=False):
        return np.stack([np.ascontiguousarray(
            _n(state_dict[f"layers.{i}.{suffix}"]).T if transpose
            else _n(state_dict[f"layers.{i}.{suffix}"])) for i in ids])

    blocks: Dict[str, Any] = {
        sub: {n: {"kernel": stacked(f"{sub}.{n}.weight", True)}
              for n in names} for sub, names in _DENSE.items()}
    blocks.update({n: {"scale": stacked(f"{n}.scale")} for n in _NORMS})
    return {"embedding": _n(state_dict["embedding"]), "blocks": blocks,
            "final_norm": _n(state_dict["final_norm"]),
            "lm_head": _n(state_dict["lm_head"])}


# ---------------------------------------------------------------------------
# ResNet and the MNIST MLP. flax names submodules per class in call order:
# the stem is ``_Conv_0`` and ``_NormAct_0`` (``_Norm_0`` unfused), each
# bottleneck ``_Bottleneck_{i}`` holds ``_Conv_{0..3}`` and
# ``_NormAct_{0..3}`` (index 3 is the projection, present only where the
# shapes differ), the head is ``Dense_0``. A conv kernel is HWIO
# ``[kh, kw, in, out]``; the port's conv weight is OIHW.
# ---------------------------------------------------------------------------
def _norm_name(fused: bool, j: int) -> str:
    return f"_NormAct_{j}" if fused else f"_Norm_{j}"


def from_flax_resnet_params(params: Mapping[str, Any], cfg
                            ) -> Dict[str, torch.Tensor]:
    """flax ``ResNet`` param tree (numpy leaves) → torch ``state_dict`` of
    ``tony_tpu_torch.models.ResNet(cfg)`` (CPU tensors)."""
    def conv(tree):
        return _t(np.asarray(tree["Conv_0"]["kernel"]).transpose(3, 2, 0, 1))

    def norm(prefix, tree):
        leaves = tree if cfg.fused else tree["GroupNorm_0"]
        return {f"{prefix}.scale": _t(leaves["scale"]),
                f"{prefix}.bias": _t(leaves["bias"])}

    sd = {"stem_conv.weight": conv(params["_Conv_0"])}
    sd.update(norm("stem_norm", params[_norm_name(cfg.fused, 0)]))
    for i in _ids(params, "_Bottleneck"):
        blk = params[f"_Bottleneck_{i}"]
        for j in _ids(blk, "_Conv"):
            sd[f"blocks.{i}.convs.{j}.weight"] = conv(blk[f"_Conv_{j}"])
            sd.update(norm(f"blocks.{i}.norms.{j}",
                           blk[_norm_name(cfg.fused, j)]))
    sd["head.weight"] = _t(np.asarray(params["Dense_0"]["kernel"]).T)
    sd["head.bias"] = _t(params["Dense_0"]["bias"])
    return sd


def to_flax_resnet_params(state_dict: Mapping[str, torch.Tensor], cfg
                          ) -> Dict[str, Any]:
    """torch ``state_dict`` of ``ResNet(cfg)`` (or a name → grad mapping of
    the same names) → flax param tree of numpy arrays."""

    def conv(name):
        return {"Conv_0": {"kernel": np.ascontiguousarray(
            _n(state_dict[name]).transpose(2, 3, 1, 0))}}

    def norm(prefix):
        leaves = {"scale": _n(state_dict[f"{prefix}.scale"]),
                  "bias": _n(state_dict[f"{prefix}.bias"])}
        return leaves if cfg.fused else {"GroupNorm_0": leaves}

    out: Dict[str, Any] = {"_Conv_0": conv("stem_conv.weight"),
                           _norm_name(cfg.fused, 0): norm("stem_norm")}
    blocks = sorted({int(k.split(".")[1]) for k in state_dict
                     if k.startswith("blocks.")})
    for i in blocks:
        convs = sorted({int(k.split(".")[3]) for k in state_dict
                        if k.startswith(f"blocks.{i}.convs.")})
        blk: Dict[str, Any] = {}
        for j in convs:
            blk[f"_Conv_{j}"] = conv(f"blocks.{i}.convs.{j}.weight")
            blk[_norm_name(cfg.fused, j)] = norm(f"blocks.{i}.norms.{j}")
        out[f"_Bottleneck_{i}"] = blk
    out["Dense_0"] = {"kernel": np.ascontiguousarray(
        _n(state_dict["head.weight"]).T), "bias": _n(state_dict["head.bias"])}
    return out


def from_flax_mlp_params(params: Mapping[str, Any]
                         ) -> Dict[str, torch.Tensor]:
    """flax ``MnistMLP`` param tree → torch ``state_dict`` of
    ``tony_tpu_torch.models.MnistMLP``."""
    sd = {}
    for i in _ids(params, "Dense"):
        d = params[f"Dense_{i}"]
        sd[f"dense.{i}.weight"] = _t(np.asarray(d["kernel"]).T)
        sd[f"dense.{i}.bias"] = _t(d["bias"])
    return sd


def to_flax_mlp_params(state_dict: Mapping[str, torch.Tensor]
                       ) -> Dict[str, Any]:
    """Inverse of ``from_flax_mlp_params``."""
    ids = sorted({int(k.split(".")[1]) for k in state_dict})
    return {f"Dense_{i}": {
        "kernel": np.ascontiguousarray(_n(state_dict[f"dense.{i}.weight"]).T),
        "bias": _n(state_dict[f"dense.{i}.bias"])} for i in ids}
