"""Logical-axis sharding rules, mapped onto FSDP2 and tensor-parallel plans.

Counterpart of ``tony_tpu/parallel/sharding.py``. The reference names each
tensor dimension with a logical axis (``embed``, ``mlp``, ``heads``…) and one
rules table maps those names onto mesh axes. The port keeps the table
(``DEFAULT_RULES``, a copy; any other table is taken where the reference
takes one: ``init_sharded_state(..., rules=)``, ``shard_model``) and the
names (``PARAM_AXES``, per parameter of the port's models, in torch's
layout), resolves them as flax does (``mesh_axes``: rule by rule in table
order, a rule taking its name's dim only while that dim is unassigned and
none of its mesh axes is taken, so the result does not depend on the order
of the dims), and turns the mesh axes they give into what torch runs:

- ``tp`` on a projection's output dim → colwise, on its input dim →
  rowwise, by the pair-or-gather rule (``tp_plan``): a colwise output stays
  ``Shard(-1)`` only where its consumer takes exactly that shard (q/k/v
  split on heads → the attention on each rank's heads → rowwise ``wo``;
  ``gate``/``up`` → rowwise ``down``); every other colwise output is
  gathered (``output_layouts=Replicate()``), every other rowwise layer
  slices its whole input (``input_layouts=Replicate()``, no
  communication). With the default rules that is Megatron's layout; a tp
  wider than the kv heads keeps q on each rank's heads and gathers k and v
  (``KvGathered``: their gradient summed over tp), each q head reading the
  kv head of its group; a table that keeps the kv heads whole, or a tp
  that splits q mid-head, gathers q to every head; one that puts ``embed``
  over tp runs every projection the other way round. The
  LM head's vocab over tp → colwise with its logits gathered, its embed
  dim → rowwise with its logits summed; the embedding table's rows over
  tp → ``VocabParallelTable`` (masked lookup, then an all-reduce), its
  embed dim → ``EmbedParallelTable`` (each rank's columns, gathered);
- ``tp`` on a ResNet conv's out-channel dim → ``ConvOutParallel`` (torch's
  styles take only ``nn.Linear`` and ``nn.Embedding``): the weight a DTensor
  ``Shard(0)``, the input gathered to whole channels, the output this
  rank's channel shard, on which every norm (``NormShardParallel``: its
  slice of the replicated scale and bias), the residual add and the pool
  run; a ``DenseBias`` (the MNIST MLP's layers, ResNet's head) →
  ``DenseBiasParallel``, colwise or rowwise with its bias replicated, by
  the same pair-or-gather rule (``vision_tp_plan``). A dim that tp (or
  fsdp) does not divide is refused, as the reference refuses it;
- every other mesh axis a parameter's placement names (``fsdp``, ``dp``,
  ``dcn_dp``, ``sp``, ``ep`` off the expert dim, ``tp`` on a norm's
  scale), on any dim → FSDP2's shard on that dim, over that axis or over
  several flattened in the rules' order (``fsdp_shards``): ZeRO over dp
  or ``(dcn_dp, fsdp)``, params over sp or ep, a norm's scale over tp
  (gathered before use: the activations are whole over tp; its tp ranks
  are replicas, so FSDP2's mean is its gradient). ``dp`` where the
  placement does not name it is FSDP2's replicate dim (HSDP); ``dcn_dp``
  where it does not is synced by the explicit bucketed all-reduce
  (``parallel/grad_sync.py``), the reference's multislice design. FSDP2
  takes one mesh per call, so each unit's parameters are grouped by mesh
  (``fully_shard_placed``); over sp the gradient is a sum, not FSDP2's
  mean (the unit's divide factor). A parameter whose placement names no
  such axis (the norm scales under the default rules, ResNet's
  convolutions and norms, the biases, every projection under a table that
  gives ``embed`` to tp) stays whole, as in the reference: FSDP2 leaves it
  alone and the train step averages its gradient by hand (a DTensor over
  tp: its local shard). Each parameter's reduced axes are recorded for
  ``grad_sync`` (``reduced_by_fsdp``), so that every gradient is reduced
  once over each axis;
- ``ep`` and ``tp`` on the MoE decoder's stacked experts (``expert`` → ep
  on its dim 0, tp on any dim) → the weights become DTensors on those
  axes (with the default rules ``gate``/``up`` ``[Shard(0), Shard(2)]``,
  ``down`` ``[Shard(0), Shard(1)]`` on ``(ep, tp)``), which FSDP2 then
  shards over the rest; the ``MoEMLP`` gathers an expert dim over tp and
  takes its own E/ep experts of an expert dim ep does not split. Its
  attention, router and head take the dense decoder's styles;
- a layout FSDP2 cannot hold (``fsdp2_refusal``, read off the axes of
  more than one rank, on one rank off all: axes outside the plan's on two
  dims of one tensor, flattened out of the mesh's order, or before the
  plan's on the plan's dim, as T4's head ``("embed", ("fsdp", "tp"))``;
  an expert dim over ``("tp", "ep")``) →
  the parameter is a DTensor on the root mesh's submesh of its axes,
  ``Shard`` or ``_StridedShard`` so that each rank holds the block of the
  reference's device at the same mesh coordinate (``hold_gathered``),
  left out of FSDP2 and gathered by its owner module before each forward
  to what the module reads (the whole tensor, or the plan's block of it);
  the gather's backward reduce-scatters the gradient over those axes;
- ``sp``: the model gets the sp group, over which its attention runs
  (ring or Ulysses) and the train step sums the gradients that FSDP2 has
  not summed.

What stays refused is what the reference refuses: ``pp`` > 1 for a
sequential model (the pipelined decoder is ``parallel/pipeline.py``'s),
the MoE decoder with sp and ep together (the reference fails to lower it;
``shard_model``), and a dim its mesh axes do not divide
(``check_tensor_parallel``, ``check_divisible``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, NamedTuple, Sequence, Tuple, Union

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.fsdp import fully_shard
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.placement_types import _StridedShard
from torch.distributed.tensor.parallel import (ColwiseParallel, ParallelStyle,
                                               RowwiseParallel,
                                               parallelize_module)

from tony_tpu_torch.parallel.mesh import BATCH_AXES, MESH_AXES, mesh_shape

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
# projection's weight is [out, in] where flax's kernel is [in, out] (the
# order does not matter to ``mesh_axes``, which resolves a set of names)
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
    # ResNet's GroupNorm scales carry no names (tony_tpu/models/resnet.py).
    "stem_norm.scale": (None,),
    "norms.scale": (None,),
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
    """Logical axes → the mesh axes of each dim, by flax's rule-priority
    resolution (``flax.linen.logical_to_mesh_axes``): the rules are taken in
    table order, and a rule assigns its target to its name's dim only when
    that dim is still unassigned and no dim holds any of the target's mesh
    axes yet. A ``None`` target assigns "whole" (later rules for that name
    then find the dim taken); a name no rule assigned is whole. The result
    depends on the set of names, not on the order of the dims. A name
    twice in one tensor raises ``ValueError``, as flax does."""
    names = [n for n in logical if n is not None]
    dups = tuple(dict.fromkeys(n for n in names if names.count(n) > 1))
    if dups:
        raise ValueError(f"Unsupported: Dimensions {dups} occur more than "
                         "once in array names.")
    out: list = [None] * len(logical)        # None: not assigned yet
    used: set = set()
    for name, target in rules:
        if name is None or name not in names:
            continue
        pos = list(logical).index(name)
        cand = () if target is None else (
            (target,) if isinstance(target, str) else tuple(target))
        if out[pos] is None and not used & set(cand):
            out[pos] = cand
            used |= set(cand)
    return tuple(axes or () for axes in out)


def _sizes(mesh: Union[DeviceMesh, Mapping[str, int]]) -> Mapping[str, int]:
    return mesh if isinstance(mesh, Mapping) else mesh_shape(mesh)


def param_placements(model: nn.Module,
                     mesh: Union[DeviceMesh, Mapping[str, int]],
                     rules: Sequence[Tuple[str, Any]] = DEFAULT_RULES
                     ) -> Dict[str, Placement]:
    """Per parameter (by name): which mesh axes shard which tensor dim, and
    its local shard shape on ``mesh`` (a ``DeviceMesh`` or ``{axis:
    size}``). Counterpart of ``param_shardings``: the mesh axes are the
    reference's ``PartitionSpec`` of the same parameter under the same
    rules (``mesh_axes`` resolves them as flax does), in torch's layout,
    and the shapes its ``shard_shape``. A model class may name some of its
    parameters' axes itself (``PARAM_AXES``, by full name), where they
    differ from the table's. ``shard_model`` lays the model out as these
    say."""
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

    shard_dim = 0

    def _apply(self, module: nn.Module, device_mesh: DeviceMesh
               ) -> nn.Module:
        table = module.embedding
        module.register_parameter("embedding", nn.Parameter(
            distribute_tensor(table.data, device_mesh,
                              [Shard(self.shard_dim)], src_data_rank=None),
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


class EmbedParallelTable(VocabParallelTable):
    """The embedding table's embed dim over tp: the table a DTensor
    ``Shard(1)``; each rank looks its columns up for every token and the
    lookup's ``[B, S, D/tp]`` output is gathered on its last dim (backward:
    each rank keeps its columns' gradient). The tied head on such a table
    is ``transformer.tied_logits``'s."""

    shard_dim = 1


_MODULE_OF = {"attn": ("wq", "wk", "wv", "wo"),
              "mlp": ("gate", "up", "down")}


def tp_dim(logical: Sequence[Any],
           rules: Sequence[Tuple[str, Any]] = DEFAULT_RULES
           ) -> Union[int, None]:
    """The dim of a tensor with these logical axes that ``rules`` put over
    tp, or None."""
    return next((d for d, axes in enumerate(mesh_axes(logical, rules))
                 if "tp" in axes), None)


def _dense_style(dim: Union[int, None], paired: bool
                 ) -> Union[ParallelStyle, None]:
    """A projection's style from where tp falls on its ``[out, in]``
    weight. ``paired``: its neighbour across the activation takes this
    layer's tp shard as it is (a colwise output read by a rowwise layer);
    else a colwise output is gathered and a rowwise layer slices its whole
    input itself (no communication)."""
    if dim == 0:
        return ColwiseParallel() if paired else \
            ColwiseParallel(output_layouts=Replicate())
    if dim == 1:
        return RowwiseParallel() if paired else \
            RowwiseParallel(input_layouts=Replicate())
    return None


def _is_moe(cfg) -> bool:
    from tony_tpu_torch.models.moe import MoEConfig
    return isinstance(cfg, MoEConfig)


def _decoder_tp_dim(cfg, rules: Sequence[Tuple[str, Any]]):
    """``key → tp_dim`` for the parameters of a decoder of ``cfg`` (keys
    as ``PARAM_AXES``'s; the MoE decoder's own names first)."""
    from tony_tpu_torch.models.moe import MoETransformer

    own = MoETransformer.PARAM_AXES if _is_moe(cfg) else {}
    return lambda key: tp_dim(own.get(key) or PARAM_AXES[key], rules)


def check_tensor_parallel(cfg, tp: int,
                          rules: Sequence[Tuple[str, Any]] = DEFAULT_RULES
                          ) -> None:
    """Raise unless ``cfg`` runs under the tensor-parallel plan that
    ``rules`` imply over ``tp`` ranks, naming the knob: each of the heads,
    the kv heads, the MLP width and the vocab that the rules split over tp
    a multiple of tp, as the reference refuses a dim its mesh axes do not
    divide (a tp wider than the kv heads, or than the heads, is no refusal:
    ``tp_plan`` gathers what each rank's heads read). A width the rules
    leave whole is not checked; the model's ``dim``, where the rules put it
    over tp, is checked from the placements (``check_divisible`` in
    ``shard_model``). A tied head and quantized projections run under any
    tp (``tied_logits``, ``Dense``)."""
    dim = _decoder_tp_dim(cfg, rules)
    hd = cfg.dim // cfg.n_heads
    # (knob, a parameter that carries it, the dim, that dim's size)
    mlp = ("moe.gate", 2) if _is_moe(cfg) else ("mlp.gate.weight", 0)
    for knob, key, d, size in (
            ("n_heads", "attn.wq.weight", 0, cfg.n_heads * hd),
            ("n_kv_heads", "attn.wk.weight", 0, cfg.n_kv_heads * hd),
            ("mlp_dim", *mlp, cfg.mlp_dim),
            ("vocab_size", "lm_head.weight", 0, cfg.vocab_size),
            ("vocab_size", "embedding", 0, cfg.vocab_size)):
        if dim(key) == d and size % tp:
            raise ValueError(
                f"{knob} ({getattr(cfg, knob)}) is not divisible by the "
                f"mesh's tp ({tp}): {key} sharded over tp: the global size "
                f"of its dimension {d} should be divisible by {tp}, but it "
                f"is equal to {size}")


class KvGathered(ColwiseParallel):
    """``ColwiseParallel`` with its output gathered over tp for k or v
    that each rank reads with its own q heads (``tp_plan``'s heads split
    where tp does not divide the kv heads): the gathered tensor's gradient
    is a partial sum over tp (each rank's q heads give their part), so its
    local view is taken with ``grad_placements=[Partial()]`` and the
    backward reduce-scatters it (the plain style's ``to_local()`` would
    call it replicated and keep one rank's part)."""

    def __init__(self):
        super().__init__(output_layouts=Replicate())

    @staticmethod
    def _prepare_output_fn(output_layouts, use_local_output, mod, outputs,
                           device_mesh):
        return outputs.redistribute(placements=output_layouts).to_local(
            grad_placements=[Partial()])


def attention_split(cfg, tp: int,
                    rules: Sequence[Tuple[str, Any]] = DEFAULT_RULES) -> str:
    """How the attention runs under the plan over ``tp`` ranks: ``"heads"``
    (q, k and v split on heads, whole GQA groups on each rank: tp divides
    the kv heads), ``"q_heads"`` (q on each rank's heads, k and v gathered:
    tp divides the heads, not the kv heads; each q head then reads the kv
    head of its group, ``Attention.forward``) or ``"whole"`` (every rank
    runs every head: the rules keep q or k and v off the heads' tp, or tp
    splits q mid-head)."""
    dim = _decoder_tp_dim(cfg, rules)
    if not dim("attn.wq.weight") == dim("attn.wk.weight") == 0:
        return "whole"
    if cfg.n_kv_heads % tp == 0:
        return "heads"
    return "q_heads" if cfg.n_heads % tp == 0 else "whole"


def tp_plan(cfg, tp: int = 1,
            rules: Sequence[Tuple[str, Any]] = DEFAULT_RULES
            ) -> Dict[str, ParallelStyle]:
    """The tensor-parallel plan that ``rules`` imply for a ``Transformer``
    (or, for a ``MoEConfig``, an ``MoETransformer``) of ``cfg`` over ``tp``
    ranks: module name ("" is the root) → style, each projection's from
    where tp falls on its weight (``_dense_style``), by the pair-or-gather
    rule: ``wq``/``wk``/``wv`` colwise keep their head shards where the
    attention runs on each rank's heads (``attention_split`` "heads"; with
    "q_heads" ``wq`` keeps its shard and ``wk``/``wv`` are gathered,
    ``KvGathered``), and ``wo`` is rowwise on that shard; the ``gate``/
    ``up`` → ``down`` pair likewise; every other colwise output is
    gathered, every other rowwise layer slices its whole input. With the
    default rules: ``wq``/``wk``/``wv``/``gate``/``up`` colwise, ``wo``/
    ``down`` rowwise, ``lm_head`` colwise over the vocab with its logits
    gathered, and the table's rows over tp (``VocabParallelTable``; its
    embed dim over tp: ``EmbedParallelTable``). A tied head has no
    ``lm_head``: it reads the table. The MoE decoder's blocks take the
    attention's styles and the router's (its stacked experts are laid out
    by ``shard_model``), and it always has its ``lm_head``, tied flag or
    not, as the reference's."""
    check_tensor_parallel(cfg, tp, rules)
    moe = _is_moe(cfg)
    dim = _decoder_tp_dim(cfg, rules)
    plan: Dict[str, ParallelStyle] = {}
    table = dim("embedding")
    if table is not None:
        plan[""] = VocabParallelTable() if table == 0 \
            else EmbedParallelTable()
    split = attention_split(cfg, tp, rules)
    paired = {"attn": split != "whole", "mlp": dim("mlp.gate.weight") == 0}
    for i in range(cfg.n_layers):
        for sub, names in _MODULE_OF.items():
            if moe and sub != "attn":
                continue
            for n in names:
                style = _dense_style(dim(f"{sub}.{n}.weight"), paired[sub])
                if split == "q_heads" and n in ("wk", "wv"):
                    style = KvGathered()
                if style is not None:
                    plan[f"layers.{i}.{sub}.{n}"] = style
        style = _dense_style(dim("moe.router.weight"), False)
        if moe and style is not None:
            plan[f"layers.{i}.moe.router"] = style
    style = _dense_style(dim("lm_head.weight"), False)
    if style is not None and (moe or not cfg.tie_embeddings):
        plan["lm_head"] = style
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
    ``MnistMLP``: module name → style. Each conv over tp goes over its out
    channels with every norm on the channel shard; each ``DenseBias`` is
    colwise or rowwise from where tp falls on its weight, by the
    pair-or-gather rule: a colwise layer keeps its output shard when the
    next layer is rowwise, else gathers it; a rowwise layer takes a shard
    as it comes and slices a whole input itself. With the default rules
    the MLP's layers run colwise, rowwise, colwise (the last gathered) and
    ResNet's head (``vocab`` over tp) colwise with its logits gathered."""
    from tony_tpu_torch.models.mlp import DenseBias
    from tony_tpu_torch.models.resnet import _Conv, _Norm

    own = getattr(model, "PARAM_AXES", {})
    layers = []
    for name, mod in model.named_modules():
        if isinstance(mod, (_Conv, DenseBias)):
            logical = own.get(f"{name}.weight") or \
                logical_axes(f"{name}.weight")
            layers.append((name, mod, tp_dim(logical, rules)))
    plan: Dict[str, ParallelStyle] = {}
    convs = False
    for i, (name, mod, d) in enumerate(layers):
        if d is None:
            continue
        if isinstance(mod, _Conv):
            # The reference names a conv kernel's out dim alone, (None,
            # None, None, "mlp") (tony_tpu/models/resnet.py:62-65), and a
            # None name takes no rule: no table puts tp anywhere else.
            assert d == 0, f"{name}: a conv over tp on its dim {d}"
            plan[name], convs = ConvOutParallel(), True
        elif d == 0:
            nxt = next((e for _, m, e in layers[i + 1:]
                        if isinstance(m, DenseBias)), None)
            plan[name] = DenseBiasParallel(
                "colwise" if nxt == 1 else "colwise_gather")
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


def plan_laid(model: nn.Module, name: str, axis: str, d: int) -> bool:
    """Whether the tensor-parallel plan (``tp_plan``, ``vision_tp_plan``)
    or the experts' own layout (``_distribute_experts``) lays dim ``d`` of
    parameter ``name`` over mesh ``axis``: tp on a projection's weight,
    the embedding table, a conv's out channels or any dim of a stacked
    expert weight; ep on the experts' expert dim. FSDP2 lays every other
    axis a placement names (``fsdp_shards``)."""
    from tony_tpu_torch.models.mlp import DenseBias
    from tony_tpu_torch.models.moe import MoEMLP
    from tony_tpu_torch.models.resnet import _Conv

    owner, _, leaf = name.rpartition(".")
    mod = model.get_submodule(owner) if owner else model
    if axis == "tp":
        return (isinstance(mod, (nn.Linear, DenseBias)) and leaf == "weight"
                ) or leaf == "embedding" or isinstance(mod, MoEMLP) or (
                    isinstance(mod, _Conv) and d == 0)
    return axis == "ep" and isinstance(mod, MoEMLP) and d == 0


class FsdpShard(NamedTuple):
    """How FSDP2 holds one parameter: the tensor dim it shards, the mesh
    axes it shards that dim over (the rules' order, major first) and
    whether it replicates the parameter over dp (HSDP)."""
    dim: int
    axes: Tuple[str, ...]
    hsdp: bool

    def reduced(self) -> Tuple[str, ...]:
        """The mesh axes over which FSDP2 reduces the gradient."""
        return ("dp",) * self.hsdp + self.axes


def fsdp2_refusal(model: nn.Module, name: str,
                  dims: Sequence[Tuple[str, ...]], sizes: Mapping[str, int],
                  laid=plan_laid) -> Union[str, None]:
    """Why FSDP2 cannot hold parameter ``name`` laid out on ``dims`` (its
    placement's mesh axes per dim) beside the plan's axes (``laid``), or
    None: axes outside the plan's on two dims (FSDP2 shards one dim),
    flattened out of the mesh's order (a process group numbers its ranks
    in ascending order), or before the plan's on the plan's dim (FSDP2
    shards the plan's shard, so the plan's axes come first: T4's head,
    ``("embed", ("fsdp", "tp"))``, would be laid tp-major where the
    reference lays it fsdp-major); or the plan's axes on one dim against
    the mesh's order (an expert dim over ``("tp", "ep")``: the experts
    shard ep before tp). Read off the axes of more than one rank (one of
    one rank lays nothing, so FSDP2 holds every layout whose wide axes it
    can); on a mesh of one rank off all of them, so that a world of one
    rank runs the code the table takes at scale (its gathers move
    nothing)."""
    if math.prod(sizes.values()) > 1:
        dims = [tuple(a for a in axes if sizes[a] > 1) for axes in dims]
    plan = [tuple(a for a in axes if laid(model, name, a, d))
            for d, axes in enumerate(dims)]
    own = {d: tuple(a for a in axes if a not in plan[d])
           for d, axes in enumerate(dims)}
    own = {d: axes for d, axes in own.items() if axes}
    if len(own) > 1:
        return (f"its dimensions {sorted(own)} over "
                f"{[own[d] for d in sorted(own)]}: FSDP2 shards one "
                "dimension of a tensor")
    for d, axes in enumerate(dims):
        for these in (own.get(d, ()), plan[d]):
            if list(these) != sorted(these, key=MESH_AXES.index):
                return (f"its dimension {d} over {these}, out of the mesh's "
                        f"order {MESH_AXES}: a process group numbers its "
                        "ranks in ascending order")
        if d in own and plan[d] and \
                axes.index(own[d][0]) < axes.index(plan[d][-1]):
            return (f"its dimension {d} over {axes}: FSDP2 shards the "
                    f"plan's shard, so it lays {plan[d]} first")
    return None


def fsdp_shards(model: nn.Module, placements: Mapping[str, Placement],
                sizes: Mapping[str, int], laid=plan_laid,
                gathered: Sequence[str] = ()
                ) -> Dict[str, Union[FsdpShard, None]]:
    """Per parameter: where FSDP2 holds it, from its placement. The axes a
    dim names outside the plan's (``laid(model, name, axis, dim)``) are
    the parameter's shard axes, one axis or several flattened in the
    rules' order, taken also where each has size 1 (FSDP2 then holds the
    whole tensor, so that a world of one rank runs the code a larger one
    does); of several dims, the one with an axis of more than one rank, or
    else the one with the mesh's first axis (alike for every weight of a
    module: the experts' ``gate`` and ``down`` name one table's axes on
    their dims the other way round); ``dp`` replicates it (HSDP) where its
    placement does not name dp. None where no such axis is named (the
    parameter stays whole, FSDP2 leaves it alone and the train step
    reduces its gradient, ``parallel/grad_sync.py``) and for the names of
    ``gathered``, what FSDP2 cannot hold (``fsdp2_refusal``,
    ``hold_gathered``)."""
    out: Dict[str, Union[FsdpShard, None]] = {}
    for name, _ in model.named_parameters():
        dims = placements[name].dims
        own = {d: tuple(a for a in axes if not laid(model, name, a, d))
               for d, axes in enumerate(dims)}
        own = {d: axes for d, axes in own.items() if axes}
        if name in gathered or not own:
            out[name] = None
            continue
        wide = [d for d, axes in own.items()
                if any(sizes[a] > 1 for a in axes)]
        if len(own) > 1 and not wide:
            out[name] = None
            continue
        d = wide[0] if wide else min(own)
        named = {a for axes in dims for a in axes}
        out[name] = FsdpShard(d, own[d], sizes["dp"] > 1
                              and "dp" not in named)
    return out


class _Gathered(NamedTuple):
    """How the owner of a parameter that ``hold_gathered`` holds makes the
    tensor its code reads: the whole tensor, whose gradient is reduced per
    mesh dim of the held DTensor by ``grads`` (``Partial``: its ranks read
    the tensor each their own way), then the block of ``use_mesh`` and
    ``use_placements`` (the plan's DTensor, or None: the whole tensor)."""
    grads: Tuple[Partial, ...]
    use_mesh: Union[DeviceMesh, None]
    use_placements: Tuple[Any, ...]


def _use(p: DTensor, how: _Gathered) -> torch.Tensor:
    """``p`` (held) as its owner reads it: gathered whole (its backward
    reduce-scatters the gradient back to ``p``'s blocks; on a mesh of one
    rank the local tensor is the whole), then the plan's block of it
    (narrowed; its gradient zero elsewhere, so the sum over a plan axis is
    the block owner's own)."""
    x = p.to_local() if p.device_mesh.size() == 1 else p.redistribute(
        placements=[Replicate()] * len(how.grads)).to_local(
            grad_placements=how.grads)
    if how.use_mesh is None:
        return x
    for i, on in enumerate(how.use_placements):
        if isinstance(on, Shard):
            n = x.shape[on.dim] // how.use_mesh.size(i)
            x = x.narrow(on.dim, how.use_mesh.get_local_rank(i) * n, n)
    return DTensor.from_local(x, how.use_mesh, how.use_placements,
                              run_check=False)


def _gather_in(module: nn.Module, args) -> None:
    module._held = {}
    for leaf, how in module._gathered.items():
        module._held[leaf] = p = module._parameters[leaf]
        module._parameters[leaf] = _use(p, how)


def _gather_out(module: nn.Module, args, out) -> None:
    module._parameters.update(module._held)
    module._held = {}


def _gathered_placements(dims: Sequence[Tuple[str, ...]],
                        sizes: Mapping[str, int]) -> Tuple[Any, ...]:
    """A parameter's placements on the mesh of its axes in the mesh's order
    (``dims``: its axes per dim, major first): ``Shard`` on the dim of
    each axis, ``_StridedShard`` where the dim's axes run against the
    mesh's order (a DTensor shards a dim over its mesh dims in their order:
    an axis whose dim names larger axes later in the mesh before it is
    split into their product of strided pieces first), so that each rank
    holds the block of the reference's device at the same mesh
    coordinate."""
    pos = {a: (d, axes) for d, axes in enumerate(dims) for a in axes}
    out = []
    for a in sorted(pos, key=MESH_AXES.index):
        d, axes = pos[a]
        split = math.prod(sizes[b] for b in axes[:axes.index(a)]
                          if MESH_AXES.index(b) > MESH_AXES.index(a))
        out.append(_StridedShard(d, split_factor=split) if split > 1
                   else Shard(d))
    return tuple(out)


def hold_gathered(model: nn.Module, mesh: DeviceMesh,
                  placements: Mapping[str, Placement],
                  names: Sequence[str]) -> Dict[str, Tuple[str, ...]]:
    """Hold each parameter of ``names`` (those FSDP2 cannot hold:
    ``fsdp2_refusal``) as a DTensor on the root mesh's submesh of its
    placement's axes (``DeviceMesh._concatenate`` of the one-axis meshes,
    in the mesh's order), placed by ``_gathered_placements``: each rank
    holds the block of the reference's device at the same mesh coordinate.
    FSDP2 leaves it alone; its owner module gathers it before each forward
    (``install_gathers``) to the whole tensor, then the plan's block where
    the plan lays it (the DTensor the plan made of it). The gather's
    backward reduce-scatters the gradient over each of its axes: the mean
    over those outside the plan's (``plan_laid``), the sum over sp (whose
    ranks each hold a share of one loss) and the plan's. Returns the axes
    outside the plan's per parameter, for ``reduced_by_fsdp``."""
    sizes = mesh_shape(mesh)
    meshes: Dict[Tuple[str, ...], DeviceMesh] = {}
    reduced = {}
    for name in names:
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        p = getattr(mod, leaf)
        dims = placements[name].dims
        order = [(a, d) for d, axes in enumerate(dims) for a in axes]
        axes = tuple(sorted((a for a, _ in order), key=MESH_AXES.index))
        if axes not in meshes:
            meshes[axes] = mesh[axes[0]] if len(axes) == 1 else \
                DeviceMesh._concatenate([mesh[a] for a in axes])
        plan = {a for a, d in order if plan_laid(model, name, a, d)}
        whole = (torch.empty(p.shape, dtype=p.dtype, device="meta")
                 if p.is_meta else p.full_tensor()
                 if isinstance(p, DTensor) else p.data)
        mod.register_parameter(leaf, nn.Parameter(
            distribute_tensor(whole, meshes[axes],
                              _gathered_placements(dims, sizes),
                              src_data_rank=None),
            requires_grad=p.requires_grad))
        if not hasattr(mod, "_gathered"):
            mod._gathered = {}
        mod._gathered[leaf] = _Gathered(
            tuple(Partial("avg" if a not in plan and a != "sp" else "sum")
                  for a in axes),
            *((p.device_mesh, p.placements) if isinstance(p, DTensor)
              else (None, ())))
        reduced[name] = tuple(a for a in axes if a not in plan)
    return reduced


def install_gathers(model: nn.Module) -> None:
    """The forward hooks that swap each gathered parameter (``_gathered``,
    ``hold_gathered``) for the tensor its owner reads, and back after the
    forward. Installed after FSDP2's, so that the root's lazy init sees
    the parameters."""
    for mod in model.modules():
        if getattr(mod, "_gathered", None):
            mod.register_forward_pre_hook(_gather_in)
            mod.register_forward_hook(_gather_out, always_call=True)


def _fsdp_mesh(mesh: DeviceMesh, axes: Tuple[str, ...],
               hsdp: bool) -> DeviceMesh:
    """FSDP2's mesh for ``axes`` (several flattened into one dim, in their
    order) with, under HSDP, ``dp`` before it as the replicate dim. Built
    by concatenating the root's one-axis meshes, as FSDP2 joins its mesh
    to a tensor-parallel one: slicing a flattened dim back out of the root
    is refused by torch where the axes are not adjacent."""
    shard = mesh[axes[0]] if len(axes) == 1 else DeviceMesh._concatenate(
        [mesh[a] for a in axes])._flatten("+".join(axes))
    return DeviceMesh._concatenate([mesh["dp"], shard]) if hsdp else shard


def fully_shard_placed(model: nn.Module, mesh: DeviceMesh,
                       shards: Mapping[str, Union[FsdpShard, None]],
                       units: Sequence[Tuple[str, nn.Module]],
                       summed: Sequence[str] = (),
                       gathered: Mapping[str, Tuple[str, ...]] = {}
                       ) -> None:
    """FSDP2 on each ``(name, module)`` of ``units`` that holds a sharded
    parameter, then on ``model``, each parameter on the mesh of its
    ``shards`` entry, the whole ones left out. FSDP2 takes one mesh per
    call, so a unit's parameters are grouped by mesh: the unit takes the
    group of its own parameters (the root's table) or else the largest,
    and each other group goes to ``fully_shard`` on the modules that own
    its parameters (a norm under ``("norm", "tp")``, the experts under a
    table that lays them apart from the attention), after their
    submodules on yet another mesh (a router beside the experts). FSDP2
    averages a gradient over its mesh; over an axis of ``summed`` (sp,
    whose ranks each hold a share of one loss) the unit's divide factor
    leaves that axis out, so the gradient is summed there. Records on ``model``
    ``reduced_by_fsdp``: per parameter, the mesh axes FSDP2 (or, for a
    parameter of ``gathered``, its gather: ``hold_gathered``) reduces its
    gradient over, read by ``grad_sync``."""
    sizes = mesh_shape(mesh)
    meshes: Dict[Any, DeviceMesh] = {}
    params = dict(model.named_parameters())
    replicated = {p for n, p in params.items() if shards[n] is None}
    dim_of = {p: shards[n].dim for n, p in params.items()
              if shards[n] is not None}

    def key(name):
        s = shards[name]
        return None if s is None else (s.axes, s.hsdp)

    def shard(module, k):
        axes, hsdp = k
        if k not in meshes:
            meshes[k] = _fsdp_mesh(mesh, axes, hsdp)
        fully_shard(module, mesh=meshes[k], ignored_params=replicated,
                    shard_placement_fn=lambda p: Shard(dim_of[p]))
        if any(sizes[a] > 1 for a in axes if a in summed):
            module.set_gradient_divide_factor(float(math.prod(
                sizes[a] for a in ("dp",) * hsdp + axes
                if a not in summed)))
            module.set_force_sum_reduction_for_comms(True)

    done: set = set()
    for prefix, unit in list(units) + [("", model)]:
        pre = f"{prefix}." if prefix else ""
        names = [pre + n for n, _ in unit.named_parameters()
                 if pre + n not in done]
        groups: Dict[Any, list] = {}
        for n in names:
            if key(n) is not None:
                groups.setdefault(key(n), []).append(n)
        own = {key(pre + n) for n, _ in unit.named_parameters(recurse=False)
               } - {None}
        assert len(own) <= 1, (prefix, own)
        main = own.pop() if own else max(groups, key=lambda k: len(groups[k]),
                                         default=None)
        claimed: set = set()

        def place(owner):
            # FSDP2 on ``owner``, after its submodules that own parameters
            # on another mesh than its own parameters (a router beside the
            # experts), each on the mesh of its own.
            sub = model.get_submodule(owner)
            mine = {key(f"{owner}.{n}")
                    for n, _ in sub.named_parameters(recurse=False)}
            inner = {n.rpartition(".")[0] for n, _ in sub.named_parameters(
                prefix=owner) if n not in claimed and key(n) not in
                mine | {None}}
            for o in sorted(inner, key=lambda o: -o.count(".")):
                place(o)
            held = [n for n, _ in sub.named_parameters(prefix=owner)
                    if n not in claimed]
            ks = {key(n) for n in held} - {None}
            assert len(ks) == 1, (owner, ks)
            shard(sub, ks.pop())
            claimed.update(held)

        for owner in sorted({n.rpartition(".")[0] for k, ns in groups.items()
                             if k != main for n in ns},
                            key=lambda o: -o.count(".")):
            place(owner)
        if main is not None or unit is model:
            shard(unit, main or (("fsdp",), sizes["dp"] > 1))
        done.update(names)
    model.reduced_by_fsdp = {n: gathered.get(n, ()) if s is None
                             else s.reduced() for n, s in shards.items()}


def _distribute_experts(model: nn.Module, mesh: DeviceMesh,
                        placements: Mapping[str, Placement]) -> None:
    """Each stacked expert weight of the MoE decoder becomes a DTensor on
    the mesh axes of its placement that ``plan_laid`` gives the experts:
    ``ep`` on the expert dim (``Shard(0)``) and ``tp`` on whichever dim
    the rules put it (with the default rules ``mlp``: gate/up dim 2, down
    dim 1; a table that puts ``embed`` over tp: gate/up dim 1, down dim
    2; ``expert``: dim 0, after ep's), from which the ``MoEMLP`` reads the
    dim tp splits. A weight neither axis lays stays a plain tensor (FSDP2
    may still shard it). On the meta device nothing is allocated. An
    expert dim over ``("tp", "ep")`` is held ep-major here and re-held
    tp-major by ``hold_gathered``, which gathers it back to this layout
    before each use."""
    from tony_tpu_torch.models.moe import MoEMLP

    for prefix, mod in model.named_modules():
        if not isinstance(mod, MoEMLP):
            continue
        for name in ("gate", "up", "down"):
            dims = placements[f"{prefix}.{name}"].dims
            laid = {a: d for d, axes in enumerate(dims) for a in axes
                    if a == "tp" or (a == "ep" and d == 0)}
            if not laid:
                continue
            axes = tuple(a for a in ("ep", "tp") if a in laid)
            p = getattr(mod, name)
            mod.register_parameter(name, nn.Parameter(
                distribute_tensor(p.data, mesh[axes],
                                  [Shard(laid[a]) for a in axes],
                                  src_data_rank=None),
                requires_grad=p.requires_grad))


def shard_model(model: nn.Module, mesh: DeviceMesh,
                rules: Sequence[Tuple[str, Any]] = DEFAULT_RULES
                ) -> Dict[str, Placement]:
    """Lay ``model`` (best on the meta device) out on ``mesh`` where
    ``param_placements`` says, as GSPMD lays the reference's: a decoder's
    tensor-parallel plan over ``tp`` (an ``MoETransformer``'s stacked
    experts over ``ep`` and ``tp``: ``_distribute_experts``), then FSDP2
    on each ``Block`` / ``MoEBlock`` (each ResNet bottleneck) holding a
    sharded parameter and on the root, each parameter over its shard axes
    (``fsdp_shards``: every other axis its placement names, on one dim,
    replicated over dp where it names no dp) and the whole ones left out
    (``fully_shard_placed``); the model's attention gets the ``sp`` group,
    each ``MoEMLP`` the ``ep``, ``tp`` and ``sp`` groups and the batch
    axes' groups. A ``ResNet`` or an ``MnistMLP`` takes ``vision_tp_plan``
    over ``tp`` (its convs over their out channels, its ``DenseBias``
    layers colwise or rowwise), then FSDP2 the same way. Parameters stay
    f32 (no mixed-precision policy: the projections cast as the
    reference's do). Returns ``param_placements``.

    A parameter FSDP2 cannot hold (``fsdp2_refusal``) is held on the
    submesh of its axes instead and gathered before use
    (``hold_gathered``, ``install_gathers``); the attention gets the
    ``tp`` group, with which a rank's q heads find the kv heads they read
    where tp is wider than the kv heads.

    Refused with ``NotImplementedError`` naming the knob: ``pp`` > 1 (the
    pipelined decoder is ``parallel/pipeline.py``'s, laid out by its
    ``pipeline_shard``), ``sp`` > 1 except for a ``Transformer`` or an
    ``MoETransformer`` with ring or Ulysses attention, ``sp`` > 1 with
    ``ep`` > 1 for the MoE decoder (a layout the reference fails to
    lower). ``ValueError`` for a dim that its mesh axes do not divide, in
    the reference's words (a decoder's over tp: FSDP2 pads the others)."""
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
        # The rest of tp's widths (FSDP2 pads a dim its axes do not
        # divide).
        check_divisible(model, placements,
                        {a: n if a == "tp" else 1 for a, n in shape.items()})
    elif isinstance(model, (ResNet, MnistMLP)):
        check_divisible(model, placements, shape)
        plan = vision_tp_plan(model, rules)
    elif shape["tp"] > 1:
        raise NotImplementedError(
            f"tensor parallelism for {kind}")
    gathered = [name for name, pl in placements.items()
                if fsdp2_refusal(model, name, pl.dims, shape)]
    shards = fsdp_shards(model, placements, shape, gathered=gathered)
    for key, style in plan.items():
        parallelize_module(model.get_submodule(key), mesh["tp"], style)
    if isinstance(model, MoETransformer):
        _distribute_experts(model, mesh, placements)
    reduced = hold_gathered(model, mesh, placements, gathered)
    sp_group = mesh["sp"].get_group()
    batch_groups = tuple(mesh[a].get_group() for a in BATCH_AXES
                         if shape[a] > 1)
    for unit in model.modules():
        if isinstance(unit, (Transformer, MoETransformer, Attention)):
            unit.sp_group = sp_group
        if isinstance(unit, Attention):
            unit.tp_group = mesh["tp"].get_group()
        elif isinstance(unit, MoEMLP):
            unit.ep_group = mesh["ep"].get_group()
            unit.tp_group = mesh["tp"].get_group()
            unit.sp_group = sp_group
            unit.batch_groups = batch_groups
    units = [(name, unit) for name, unit in model.named_modules()
             if isinstance(unit, (Block, MoEBlock, _Bottleneck))]
    fully_shard_placed(model, mesh, shards, units, summed=("sp",),
                       gathered=reduced)
    install_gathers(model)
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
