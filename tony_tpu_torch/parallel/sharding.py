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
- ``fsdp`` on a dim → FSDP2's shard on that dim (``fsdp_placement_fn``);
  a parameter whose layout names no ``fsdp`` (the norm scales, ResNet's
  convolutions and norms) stays replicated, as in the reference: FSDP2 leaves it
  alone and the train step averages its gradient by hand;
- ``dp`` → FSDP2's replicate dim (HSDP); ``dcn_dp`` stays out of FSDP2 and
  is synced by the explicit bucketed all-reduce (``parallel/grad_sync.py``),
  the reference's multislice design. The FSDP2 mesh is then a plain slice
  of the mesh (``("dp", "fsdp")``), so no private ``DeviceMesh._flatten`` is
  needed;
- ``ep`` on the MoE decoder's stacked experts (``expert`` → ep) → the
  weights become DTensors ``Shard(0)`` on the mesh's ep axis, which FSDP2
  then shards over fsdp on their ``embed`` dim like every other weight;
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
    of ``cfg`` over ``tp`` ranks: module name ("" is the root) → style.
    With the default rules: ``wq``/``wk``/``wv``/``gate``/``up`` colwise,
    ``wo``/``down`` rowwise, ``lm_head`` colwise over the vocab with its
    logits gathered, and the table's rows over tp."""
    from tony_tpu_torch.models.transformer import check_tensor_parallel

    check_tensor_parallel(cfg, tp)

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
            for n in names:
                d = tp_dim(PARAM_AXES[f"{sub}.{n}.weight"])
                if d is not None:
                    plan[f"layers.{i}.{sub}.{n}"] = (
                        ColwiseParallel() if d == 0 else RowwiseParallel())
    d = tp_dim(PARAM_AXES["lm_head.weight"])
    if d == 0:
        plan["lm_head"] = ColwiseParallel(output_layouts=Replicate())
    elif d is not None:
        raise NotImplementedError("the LM head sharded over tp on its "
                                  "embed dim")
    return plan


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
    """Each stacked expert weight of the MoE decoder becomes a DTensor
    sharded over ``ep`` on the dim its rules give it (``expert``: dim 0).
    On the meta device nothing is allocated."""
    from tony_tpu_torch.models.moe import MoEMLP

    for prefix, mod in model.named_modules():
        if not isinstance(mod, MoEMLP):
            continue
        for name in ("gate", "up", "down"):
            p = getattr(mod, name)
            dims = placements[f"{prefix}.{name}"].dims
            d = next(i for i, axes in enumerate(dims) if "ep" in axes)
            mod.register_parameter(name, nn.Parameter(
                distribute_tensor(p.data, mesh["ep"], [Shard(d)],
                                  src_data_rank=None),
                requires_grad=p.requires_grad))


def shard_model(model: nn.Module, mesh: DeviceMesh,
                rules: Sequence[Tuple[str, Any]] = DEFAULT_RULES
                ) -> Dict[str, Placement]:
    """Lay ``model`` (best on the meta device) out on ``mesh``: a
    ``Transformer``'s tensor-parallel plan over ``tp`` (an ``MoETransformer``'s
    experts over ``ep``), then FSDP2 on each ``Block`` / ``MoEBlock`` (each
    ResNet bottleneck holding a sharded parameter) and on the root, the
    replicated parameters left out; the model's attention gets the ``sp``
    group, each ``MoEMLP`` the ``ep`` group and the batch axes' groups.
    Parameters stay f32 (no mixed-precision policy: the projections cast as
    the reference's do). Returns ``param_placements``.

    Refused with ``NotImplementedError`` naming the knob: ``pp`` > 1 (the
    pipeline slice comes later), ``sp`` > 1 except for a ``Transformer``
    with ring or Ulysses attention, ``sp`` or ``tp`` > 1 for the MoE
    decoder (the reference leaves its tp to XLA; the port has no plan for
    the stacked experts), ``tp`` > 1 for ResNet."""
    from tony_tpu_torch.models.moe import MoEBlock, MoEMLP, MoETransformer
    from tony_tpu_torch.models.resnet import _Bottleneck
    from tony_tpu_torch.models.transformer import (SEQUENCE_PARALLEL,
                                                   Attention, Block,
                                                   Transformer)

    shape = mesh_shape(mesh)
    kind = type(model).__name__
    if shape["pp"] > 1:
        raise NotImplementedError(
            f"mesh axis pp={shape['pp']} > 1: pipeline parallelism comes "
            "with a later slice of the port")
    if isinstance(model, MoETransformer):
        for knob in ("sp", "tp"):
            if shape[knob] > 1:
                raise NotImplementedError(
                    f"mesh axis {knob}={shape[knob]} > 1 for {kind}: the "
                    "MoE decoder runs on the batch axes and ep only")
    elif shape["sp"] > 1 and not (
            isinstance(model, Transformer)
            and model.cfg.attn_impl in SEQUENCE_PARALLEL):
        raise NotImplementedError(
            f"mesh axis sp={shape['sp']} > 1 for {kind} with attn_impl="
            f"{getattr(getattr(model, 'cfg', None), 'attn_impl', None)!r}: "
            f"sequence parallelism takes a Transformer with attn_impl in "
            f"{SEQUENCE_PARALLEL}")
    if isinstance(model, Transformer):
        for key, style in tp_plan(model.cfg, shape["tp"], rules).items():
            parallelize_module(model.get_submodule(key), mesh["tp"], style)
    elif shape["tp"] > 1:
        raise NotImplementedError(
            f"tensor parallelism for {kind}")
    placements = param_placements(model, mesh, rules)
    if isinstance(model, MoETransformer):
        _distribute_experts(model, mesh, placements)
    sp_group = mesh["sp"].get_group()
    batch_groups = tuple(mesh[a].get_group() for a in BATCH_AXES
                         if shape[a] > 1)
    for unit in model.modules():
        if isinstance(unit, (Transformer, Attention)):
            unit.sp_group = sp_group
        elif isinstance(unit, MoEMLP):
            unit.ep_group = mesh["ep"].get_group()
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
