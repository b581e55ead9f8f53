"""Logical-axis sharding rules, mapped onto FSDP2 and tensor-parallel plans.

Counterpart of ``tony_tpu/parallel/sharding.py``. The reference names each
tensor dimension with a logical axis (``embed``, ``mlp``, ``heads``…) and one
rules table maps those names onto mesh axes. The port keeps the table
(``DEFAULT_RULES``, a copy) and the names (``PARAM_AXES``, per parameter of
the port's models, in torch's layout), and turns the mesh axes they give
into what torch runs:

- ``tp`` on a projection's output dim → ``ColwiseParallel``, on its input
  dim → ``RowwiseParallel``; the LM head's vocab over tp → a colwise head
  whose logits are gathered; the embedding table's rows over tp →
  ``VocabParallelTable`` (masked lookup, then an all-reduce);
- ``tp`` on a ResNet conv's out-channel dim → ``ConvOutParallel`` (torch's
  styles take only ``nn.Linear`` and ``nn.Embedding``): the weight a DTensor
  ``Shard(0)``, the input gathered to whole channels, the output this
  rank's channel shard, on which every norm (``NormShardParallel``: its
  slice of the replicated scale and bias), the residual add and the pool
  run; a ``DenseBias`` (the MNIST MLP's layers, ResNet's head) →
  ``DenseBiasParallel``, colwise or rowwise with its bias replicated, the
  head's logits gathered (``vision_tp_plan``). A dim that tp (or fsdp)
  does not divide is refused, as the reference refuses it;
- ``fsdp`` on a dim → FSDP2's shard on that dim (``fsdp_placement_fn``);
  a parameter whose layout names no ``fsdp`` (the norm scales, ResNet's
  convolutions and norms, the biases) stays whole over fsdp, as in the
  reference: FSDP2 leaves it alone and the train step averages its
  gradient by hand (a conv weight over tp: its local shard);
- ``dp`` → FSDP2's replicate dim (HSDP); ``dcn_dp`` stays out of FSDP2 and
  is synced by the explicit bucketed all-reduce (``parallel/grad_sync.py``),
  the reference's multislice design. The FSDP2 mesh is then a plain slice
  of the mesh (``("dp", "fsdp")``), so no private ``DeviceMesh._flatten`` is
  needed;
- ``ep`` and ``tp`` on the MoE decoder's stacked experts (``expert`` → ep,
  ``mlp`` → tp) → the weights become DTensors on the mesh's ``(ep, tp)``
  axes (``gate``/``up`` ``[Shard(0), Shard(2)]``, ``down`` ``[Shard(0),
  Shard(1)]``), which FSDP2 then shards over fsdp on their ``embed`` dim
  like every other weight; its attention takes the dense decoder's styles,
  its router stays replicated;
- ``sp``: no parameter names it (parameters stay replicated over sp, as in
  the reference); the model gets the sp group, over which its attention
  runs (ring or Ulysses) and the train step sums the gradients.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, NamedTuple, Sequence, Tuple, Union

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.fsdp import fully_shard
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.parallel import (ColwiseParallel, ParallelStyle,
                                               RowwiseParallel,
                                               parallelize_module)

from tony_tpu_torch.parallel.mesh import BATCH_AXES, mesh_shape

# The model classes are imported where they are used: the models import
# this package (its collectives, ``parallel/_comm.py``).

# Logical name → mesh axis (or tuple of axes): the reference's table.
DEFAULT_RULES: Tuple[Tuple[str, Any], ...] = (
    ("batch", BATCH_AXES),
    ("seq", "sp"),
    ("embed", "fsdp"),
    ("mlp", "tp"),
    ("heads", "tp"),
    ("kv_heads", "tp"),
    ("kv", None),
    ("qkv", None),
    ("vocab", "tp"),
    # Embedding-table dims: vocab rows over both model axes, embed dim
    # whole — the lookup is then a masked gather plus an all-reduce.
    ("vocab_table", ("tp", "fsdp")),
    ("embed_table", None),
    ("layers", None),
    ("stage", "pp"),
    ("expert", "ep"),
    ("expert_logits", None),
    ("norm", None),
)

# The logical axes of each dim of the port's parameters, keyed by the end of
# the parameter's name without its layer numbers, in torch's layout: a
# projection's weight is [out, in] where flax's kernel is [in, out]
# (tony_tpu/models/transformer.py:95 for the projections, :139 the norm
# scale, :265 the table, :302 the head; tony_tpu/models/resnet.py:64 the
# convolutions, whose OIHW weight has flax's HWIO "mlp" on its out dim, and
# :152 the head; a GroupNorm's scale and bias and the head's bias carry no
# names there).
PARAM_AXES: Dict[str, Tuple[Any, ...]] = {
    "embedding": ("vocab_table", "embed_table"),
    "attn.wq.weight": ("heads", "embed"),
    "attn.wk.weight": ("kv_heads", "embed"),
    "attn.wv.weight": ("kv_heads", "embed"),
    "attn.wo.weight": ("embed", "heads"),
    "mlp.gate.weight": ("mlp", "embed"),
    "mlp.up.weight": ("mlp", "embed"),
    "mlp.down.weight": ("embed", "mlp"),
    "lm_head.weight": ("vocab", "embed"),
    "scale": ("norm",),
    "stem_conv.weight": ("mlp", None, None, None),
    "convs.weight": ("mlp", None, None, None),
    "head.weight": ("vocab", "embed"),
    "bias": (None,),
    # The MoE decoder (tony_tpu/models/moe.py:118 the router, :133-135 the
    # stacked experts in the reference's own layout).
    "moe.router.weight": ("expert_logits", "embed"),
    "moe.gate": ("expert", "embed", "mlp"),
    "moe.up": ("expert", "embed", "mlp"),
    "moe.down": ("expert", "mlp", "embed"),
}


class Placement(NamedTuple):
    """Where a parameter lives on a mesh: for each tensor dim, the mesh axes
    that shard it (major first, empty: whole), and the shape of one
    rank's shard."""
    dims: Tuple[Tuple[str, ...], ...]
    local_shape: Tuple[int, ...]


def logical_axes(name: str) -> Tuple[Any, ...]:
    """The logical axes of parameter ``name``: those of ``PARAM_AXES``'
    longest key that ends its name, layer numbers left out."""
    parts = [p for p in name.split(".") if not p.isdigit()]
    for n in range(len(parts), 0, -1):
        key = ".".join(parts[-n:])
        if key in PARAM_AXES:
            return PARAM_AXES[key]
    raise KeyError(f"no logical axes for parameter {name!r}")


def mesh_axes(logical: Sequence[Any],
              rules: Sequence[Tuple[str, Any]] = DEFAULT_RULES
              ) -> Tuple[Tuple[str, ...], ...]:
    """Logical axes → the mesh axes of each dim, as flax's
    ``logical_to_mesh_axes`` maps them: the first rule for a name whose mesh
    axes no earlier dim took (one mesh axis shards at most one dim)."""
    used, out = set(), []
    for name in logical:
        axes: Tuple[str, ...] = ()
        for rule, target in rules:
            if name is None or rule != name:
                continue
            cand = () if target is None else (
                (target,) if isinstance(target, str) else tuple(target))
            if not used & set(cand):
                axes = cand
                break
        used |= set(axes)
        out.append(axes)
    return tuple(out)


def _sizes(mesh: Union[DeviceMesh, Mapping[str, int]]) -> Mapping[str, int]:
    return mesh if isinstance(mesh, Mapping) else mesh_shape(mesh)


def param_placements(model: nn.Module,
                     mesh: Union[DeviceMesh, Mapping[str, int]],
                     rules: Sequence[Tuple[str, Any]] = DEFAULT_RULES
                     ) -> Dict[str, Placement]:
    """Per parameter (by name): which mesh axes shard which tensor dim, and
    its local shard shape on ``mesh`` (a ``DeviceMesh`` or ``{axis:
    size}``). Counterpart of ``param_shardings``; the shapes are the
    reference's ``shard_shape`` of the same parameter. A model class may
    name some of its parameters' axes itself (``PARAM_AXES``, by full
    name), where they differ from the table's."""
    sizes = _sizes(mesh)
    own = getattr(model, "PARAM_AXES", {})
    out = {}
    for name, p in model.named_parameters():
        dims = mesh_axes(own.get(name) or logical_axes(name), rules)
        local = tuple(-(-n // math.prod(sizes[a] for a in axes))
                      for n, axes in zip(p.shape, dims))
        out[name] = Placement(dims, local)
    return out


class VocabParallelTable(ParallelStyle):
    """Tensor parallelism for the embedding table, which is a bare
    parameter of the root (``Transformer.embedding``), not an
    ``nn.Embedding``: its rows are sharded over the tp ranks, and the
    model's ``lookup`` takes the tokens replicated, gathers its own rows
    (masking the others to zero) and all-reduces the result, so every
    rank leaves the lookup with the whole [B, S, D] activation as a plain
    tensor."""

    def _apply(self, module: nn.Module, device_mesh: DeviceMesh
               ) -> nn.Module:
        table = module.embedding
        module.register_parameter("embedding", nn.Parameter(
            distribute_tensor(table.data, device_mesh, [Shard(0)],
                              src_data_rank=None),
            requires_grad=table.requires_grad))

        def tokens_in(_, args):
            tokens, rows = args
            return (DTensor.from_local(tokens, device_mesh, [Replicate()],
                                       run_check=False), rows)

        def gathered_out(_, args, out):
            return out.redistribute(device_mesh, [Replicate()]).to_local()

        module.lookup.register_forward_pre_hook(tokens_in)
        module.lookup.register_forward_hook(gathered_out)
        return module


_MODULE_OF = {"attn": ("wq", "wk", "wv", "wo"),
              "mlp": ("gate", "up", "down")}


def tp_plan(cfg, tp: int = 1,
            rules: Sequence[Tuple[str, Any]] = DEFAULT_RULES
            ) -> Dict[str, ParallelStyle]:
    """The tensor-parallel plan that ``rules`` imply for a ``Transformer``
    (or, for a ``MoEConfig``, an ``MoETransformer``) of ``cfg`` over ``tp``
    ranks: module name ("" is the root) → style. With the default rules:
    ``wq``/``wk``/``wv``/``gate``/``up`` colwise, ``wo``/``down`` rowwise,
    ``lm_head`` colwise over the vocab with its logits gathered, and the
    table's rows over tp. A tied head has no ``lm_head``: it reads the
    table. The MoE decoder's blocks take the attention's styles only (its
    stacked experts are laid out by ``shard_model``), and it always has its
    ``lm_head``, tied flag or not, as the reference's."""
    from tony_tpu_torch.models.moe import MoEConfig
    from tony_tpu_torch.models.transformer import check_tensor_parallel

    check_tensor_parallel(cfg, tp)
    moe = isinstance(cfg, MoEConfig)

    def tp_dim(logical):
        dims = mesh_axes(logical, rules)
        found = [d for d, axes in enumerate(dims) if "tp" in axes]
        return found[0] if found else None

    plan: Dict[str, ParallelStyle] = {}
    if tp_dim(PARAM_AXES["embedding"]) == 0:
        plan[""] = VocabParallelTable()
    elif tp_dim(PARAM_AXES["embedding"]) is not None:
        raise NotImplementedError("the embedding table sharded over tp on "
                                  "its embed dim")
    for i in range(cfg.n_layers):
        for sub, names in _MODULE_OF.items():
            if moe and sub != "attn":
                continue
            for n in names:
                d = tp_dim(PARAM_AXES[f"{sub}.{n}.weight"])
                if d is not None:
                    plan[f"layers.{i}.{sub}.{n}"] = (
                        ColwiseParallel() if d == 0 else RowwiseParallel())
    d = tp_dim(PARAM_AXES["lm_head.weight"])
    if cfg.tie_embeddings and not moe:
        d = None
    if d == 0:
        plan["lm_head"] = ColwiseParallel(output_layouts=Replicate())
    elif d is not None:
        raise NotImplementedError("the LM head sharded over tp on its "
                                  "embed dim")
    return plan


def _distribute(module: nn.Module, name: str, mesh: DeviceMesh,
                dim: int) -> None:
    """``module.<name>`` becomes a DTensor ``Shard(dim)`` on ``mesh`` (on
    the meta device nothing is allocated)."""
    p = getattr(module, name)
    module.register_parameter(name, nn.Parameter(
        distribute_tensor(p.data, mesh, [Shard(dim)], src_data_rank=None),
        requires_grad=p.requires_grad))


class ConvOutParallel(ParallelStyle):
    """Tensor parallelism for a ResNet conv (``models/resnet.py:_Conv``)
    over its out channels: the weight ``[out, in, k, k]`` becomes a DTensor
    ``Shard(0)`` on the tp mesh and the module gets the tp group, with
    which it gathers a channel-shard input to whole channels (the in-channel
    dim stays whole, as the reference keeps it) and returns this rank's
    slice of the out channels."""

    def _apply(self, module: nn.Module, device_mesh: DeviceMesh
               ) -> nn.Module:
        _distribute(module, "weight", device_mesh, 0)
        module.tp_group = device_mesh.get_group()
        return module


class NormShardParallel(ParallelStyle):
    """A ResNet norm (``models/resnet.py:_Norm``) on a channel shard: its
    scale and bias stay replicated (the reference leaves them
    unpartitioned); the module gets the tp group, normalises this rank's
    channels with its slice of them and takes the GroupNorm statistics
    over the tp ranks where a group straddles them."""

    def _apply(self, module: nn.Module, device_mesh: DeviceMesh
               ) -> nn.Module:
        module.tp_group = device_mesh.get_group()
        return module


class DenseBiasParallel(ParallelStyle):
    """Tensor parallelism for ``models/mlp.py:DenseBias`` with its bias
    replicated (torch's ``ColwiseParallel`` would shard it):
    ``"colwise"`` / ``"colwise_gather"`` (weight ``Shard(0)``; the second
    gathers the outputs) or ``"rowwise"`` (weight ``Shard(1)``)."""

    def __init__(self, style: str):
        super().__init__()
        self.style = style

    def _apply(self, module: nn.Module, device_mesh: DeviceMesh
               ) -> nn.Module:
        _distribute(module, "weight", device_mesh,
                    1 if self.style == "rowwise" else 0)
        module.tp_group, module.tp_style = device_mesh.get_group(), self.style
        return module


def vision_tp_plan(model: nn.Module,
                   rules: Sequence[Tuple[str, Any]] = DEFAULT_RULES
                   ) -> Dict[str, ParallelStyle]:
    """The tensor-parallel plan that ``rules`` imply for a ``ResNet`` or an
    ``MnistMLP``: module name → style. With the default rules every conv
    over its out channels (``mlp``) with every norm on the channel shard,
    the MLP's layers colwise, rowwise, colwise, and the head (``vocab``
    over tp) colwise with its logits gathered."""
    from tony_tpu_torch.models.mlp import DenseBias
    from tony_tpu_torch.models.resnet import _Conv, _Norm

    own = getattr(model, "PARAM_AXES", {})
    plan: Dict[str, ParallelStyle] = {}
    convs = False
    for name, mod in model.named_modules():
        if not isinstance(mod, (_Conv, DenseBias)):
            continue
        logical = own.get(f"{name}.weight") or logical_axes(f"{name}.weight")
        dims = mesh_axes(logical, rules)
        d = next((d for d, axes in enumerate(dims) if "tp" in axes), None)
        if d is None:
            continue
        if isinstance(mod, _Conv):
            if d != 0:
                raise NotImplementedError(
                    f"{name}: a conv sharded over tp on its dim {d}")
            plan[name], convs = ConvOutParallel(), True
        elif d == 0:
            plan[name] = DenseBiasParallel(
                "colwise_gather" if logical[0] == "vocab" else "colwise")
        else:
            plan[name] = DenseBiasParallel("rowwise")
    if convs:
        plan.update((name, NormShardParallel())
                    for name, mod in model.named_modules()
                    if isinstance(mod, _Norm))
    return plan


def check_divisible(model: nn.Module,
                    placements: Mapping[str, Placement],
                    sizes: Mapping[str, int]) -> None:
    """``ValueError`` for a parameter dim that its mesh axes do not
    divide, as the reference's sharded init refuses one ("... should be
    divisible by 4, but it is equal to 10")."""
    for name, p in model.named_parameters():
        for d, (n, axes) in enumerate(zip(p.shape, placements[name].dims)):
            k = math.prod(sizes[a] for a in axes)
            if n % k:
                raise ValueError(
                    f"{name} sharded over {'×'.join(axes)}: the global size "
                    f"of its dimension {d} should be divisible by {k}, but "
                    f"it is equal to {n} (full shape: {tuple(p.shape)})")


def fsdp_placement_fn(model: nn.Module,
                      placements: Mapping[str, Placement]):
    """FSDP2's ``shard_placement_fn``: each parameter's shard on the dim
    that names ``fsdp`` (its ``embed`` dim with the default rules; the
    table's vocab rows, under tp's)."""
    dim_of = {p: d for name, p in model.named_parameters()
              for d, axes in enumerate(placements[name].dims)
              if "fsdp" in axes}
    return lambda p: Shard(dim_of[p])


def fsdp_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """FSDP2's mesh: ``(dp, fsdp)`` (HSDP: replicate over dp, shard over
    fsdp) when dp > 1, else ``fsdp`` alone."""
    return mesh["dp", "fsdp"] if mesh_shape(mesh)["dp"] > 1 \
        else mesh["fsdp"]


def _distribute_experts(model: nn.Module, mesh: DeviceMesh,
                        placements: Mapping[str, Placement]) -> None:
    """Each stacked expert weight of the MoE decoder becomes a DTensor on
    the mesh's ``(ep, tp)`` axes, sharded on the dims its rules give each
    axis (``expert``: dim 0 over ep; ``mlp``: gate/up dim 2, down dim 1,
    over tp). On the meta device nothing is allocated."""
    from tony_tpu_torch.models.moe import MoEMLP

    axes = ("ep", "tp")
    for prefix, mod in model.named_modules():
        if not isinstance(mod, MoEMLP):
            continue
        for name in ("gate", "up", "down"):
            p = getattr(mod, name)
            dims = placements[f"{prefix}.{name}"].dims
            where = [next((Shard(d) for d, on in enumerate(dims)
                           if axis in on), Replicate()) for axis in axes]
            mod.register_parameter(name, nn.Parameter(
                distribute_tensor(p.data, mesh[axes], where,
                                  src_data_rank=None),
                requires_grad=p.requires_grad))


def shard_model(model: nn.Module, mesh: DeviceMesh,
                rules: Sequence[Tuple[str, Any]] = DEFAULT_RULES
                ) -> Dict[str, Placement]:
    """Lay ``model`` (best on the meta device) out on ``mesh``: a
    decoder's tensor-parallel plan over ``tp`` (an ``MoETransformer``'s
    stacked experts over ``(ep, tp)``), then FSDP2 on each ``Block`` /
    ``MoEBlock`` (each ResNet bottleneck holding a sharded parameter) and
    on the root, the replicated parameters left out; the model's attention
    gets the ``sp`` group, each ``MoEMLP`` the ``ep``, ``tp`` and ``sp``
    groups and the batch axes' groups. A ``ResNet`` or an ``MnistMLP``
    takes ``vision_tp_plan`` over ``tp`` (its convs over their out
    channels, its ``DenseBias`` layers colwise or rowwise), then FSDP2 the
    same way. Parameters stay f32 (no mixed-precision policy: the
    projections cast as the reference's do). Returns ``param_placements``.

    Refused with ``NotImplementedError`` naming the knob: ``pp`` > 1 (the
    pipelined decoder is ``parallel/pipeline.py``'s, laid out by its
    ``pipeline_shard``), ``sp`` > 1 except for a ``Transformer`` or an
    ``MoETransformer`` with ring or Ulysses attention, ``sp`` > 1 with
    ``ep`` > 1 for the MoE decoder (a layout the reference fails to
    lower). ``ValueError`` for a ResNet or MLP dim that its mesh axes do
    not divide (a class count tp does not divide), as the reference's."""
    from tony_tpu_torch.models.mlp import MnistMLP
    from tony_tpu_torch.models.moe import MoEBlock, MoEMLP, MoETransformer
    from tony_tpu_torch.models.resnet import ResNet, _Bottleneck
    from tony_tpu_torch.models.transformer import (SEQUENCE_PARALLEL,
                                                   Attention, Block,
                                                   Transformer)

    shape = mesh_shape(mesh)
    kind = type(model).__name__
    if shape["pp"] > 1:
        raise NotImplementedError(
            f"mesh axis pp={shape['pp']} > 1 for {kind}: a sequential model "
            "does not pipeline; the GPipe schedule over pp is "
            "PipelineTransformer's (tony_tpu_torch/parallel/pipeline.py, "
            "laid out by pipeline_shard)")
    decoder = isinstance(model, (Transformer, MoETransformer))
    if shape["sp"] > 1 and not (
            decoder and model.cfg.attn_impl in SEQUENCE_PARALLEL):
        raise NotImplementedError(
            f"mesh axis sp={shape['sp']} > 1 for {kind} with attn_impl="
            f"{getattr(getattr(model, 'cfg', None), 'attn_impl', None)!r}: "
            f"sequence parallelism takes a Transformer or an MoETransformer "
            f"with attn_impl in {SEQUENCE_PARALLEL}")
    if isinstance(model, MoETransformer) and shape["sp"] > 1 \
            and shape["ep"] > 1:
        raise NotImplementedError(
            f"mesh axes sp={shape['sp']} and ep={shape['ep']} together for "
            f"{kind}: the reference fails to lower this layout (ValueError: "
            "Cannot lower jaxpr with verifier errors: 'chlo.top_k' ... "
            "incompatible with return type(s), at "
            "MoETransformer/layer_0/moe/top_k); take sp or ep, not both")
    # Names and global shapes: the plan below changes neither.
    placements = param_placements(model, mesh, rules)
    plan: Dict[str, ParallelStyle] = {}
    if decoder:
        plan = tp_plan(model.cfg, shape["tp"], rules)
    elif isinstance(model, (ResNet, MnistMLP)):
        check_divisible(model, placements, shape)
        plan = vision_tp_plan(model, rules)
    elif shape["tp"] > 1:
        raise NotImplementedError(
            f"tensor parallelism for {kind}")
    for key, style in plan.items():
        parallelize_module(model.get_submodule(key), mesh["tp"], style)
    if isinstance(model, MoETransformer):
        _distribute_experts(model, mesh, placements)
    sp_group = mesh["sp"].get_group()
    batch_groups = tuple(mesh[a].get_group() for a in BATCH_AXES
                         if shape[a] > 1)
    for unit in model.modules():
        if isinstance(unit, (Transformer, MoETransformer, Attention)):
            unit.sp_group = sp_group
        elif isinstance(unit, MoEMLP):
            unit.ep_group = mesh["ep"].get_group()
            unit.tp_group = mesh["tp"].get_group()
            unit.sp_group = sp_group
            unit.batch_groups = batch_groups
    replicated = {p for name, p in model.named_parameters()
                  if not any("fsdp" in a for a in placements[name].dims)}
    kw = dict(mesh=fsdp_mesh(mesh),
              shard_placement_fn=fsdp_placement_fn(model, placements))
    for unit in model.modules():
        if isinstance(unit, (Block, MoEBlock, _Bottleneck)) and any(
                p not in replicated for p in unit.parameters()):
            fully_shard(unit, ignored_params=replicated, **kw)
    fully_shard(model, ignored_params=replicated, **kw)
    return placements


def reshard(tree: Mapping[str, torch.Tensor],
            like: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Re-lay an in-memory tree onto another mesh: each tensor of ``tree``
    (a DTensor on any mesh, or a whole tensor) goes onto the mesh and
    placements of the DTensor of the same name in ``like`` (for instance
    the state dict of the model freshly laid out on the new mesh); names
    whose ``like`` is a plain tensor get the whole tensor. One tensor at a
    time is made whole. Counterpart of the reference's ``reshard``: the
    elastic re-mesh path when the state survives in memory (a checkpoint
    restore covers the on-disk path). Every rank of both meshes calls
    it."""
    out = {}
    for name, x in tree.items():
        whole = x.full_tensor() if isinstance(x, DTensor) else x
        t = like[name]
        out[name] = (distribute_tensor(whole, t.device_mesh, t.placements,
                                       src_data_rank=None)
                     if isinstance(t, DTensor) else whole)
    return out
