"""Pipeline parallelism: the GPipe schedule over the mesh's ``pp`` axis.

Counterpart of ``tony_tpu/parallel/pipeline.py``, with its semantics kept
and written in PyTorch's idiom:

- **The layout.** ``PipelineTransformer`` holds the reference's pipeline
  parameters: ``embedding`` ``[vocab, dim]``, the blocks (the decoder's
  ``Block``, ``layers.{i}`` by global layer index), ``final_norm`` a bare
  ``[dim]`` vector and ``lm_head`` ``[dim, vocab]``. On a mesh
  (``pipeline_shard``, through ``init_sharded_state(...,
  layout=pipeline_shard)``) pp rank ``s`` keeps only the contiguous layer
  range ``[s·L/S, (s+1)·L/S)`` (the reference's stage axis sharded over
  pp), each block gets FSDP2 over the stage's ``(dp, fsdp)`` sub-mesh on
  its ``embed`` dim and stays whole over ``tp`` (the reference's
  ``shard_map`` leaves the blocks replicated over tp), and the root's
  FSDP2 shards ``embedding`` ``P("fsdp", None)``, ``final_norm``
  ``P("fsdp")`` and ``lm_head`` ``P("fsdp", "tp")`` (the head a DTensor
  over tp first). With fsdp > 1 no parameter is whole on any rank, apart
  from a block's norm scales, which the reference shards over pp alone:
  they are FSDP2's ``ignored_params`` and the step averages their
  gradients (``grad_sync``). FSDP2 unshards and reshards a block at each
  of its M + S − 1 calls and reduce-scatters its gradient once a step.
- **The schedule** (``_pipeline_blocks``): the local batch in M
  microbatches, M + S − 1 ticks; at tick t stage 0 injects microbatch
  ``min(t, M − 1)``, every stage applies its layers to the state it holds
  (bubble ticks included: they compute on zeros or on a repeat of the
  last microbatch, and are never banked), the last stage banks microbatch
  ``t − (S − 1)`` once that is ≥ 0, and the state moves one stage on by
  ``_comm.ppermute`` (its backward the reverse shift). The last tick's
  shift, whose result nobody reads, is left out on every rank.
- **Autograd across ranks.** Torch runs only the backward nodes on this
  rank's path to its loss, while JAX transposes the whole SPMD program, so
  three things are explicit here: stage 0 *selects* the injected
  microbatch over the state it received (``torch.where`` on a 0-d mask, as
  the reference's ``jnp.where``), so the received tensor stays on the
  graph with a zero cotangent and the sender's backward shift is matched;
  the embedded tokens, used by stage 0 only, pass through
  ``_comm.sum_grad_over_group`` over pp, so that every pp rank ends the
  backward with the same embedding gradient (JAX's transpose sums it over
  pp); the banked output reaches every pp rank by
  ``_comm.broadcast_from_group`` from the last stage, whose backward hands
  the last stage the cotangent once (the reference's ``psum`` over pp of
  an output that is zero off the last stage; a summing backward would make
  every block gradient pp times too large).
- **The head** (``pipeline_forward``): the lookup outside the pipeline,
  cast to ``cfg.dtype``; the final norm in f32, not cast back; the logits
  ``xf @ lm_head.float()`` in f32 (unlike the sequential ``Transformer``,
  whose norm returns the activation dtype and whose head is bf16).
- **Replica axes**: ``sp`` and ``ep`` name no dim of the pipeline's
  parameters or data, so their ranks each run the whole stage on the same
  rows, and the step sums nothing over them.
- **Remat**: with ``cfg.remat`` each layer runs under a full
  ``torch.utils.checkpoint``; ``remat_policy`` and ``remat_skip_every`` are
  not read here, as the reference does not read them.

The reference's case for GPipe over 1F1B (``tony_tpu/parallel/pipeline.py``
module docstring) holds here too: with per-layer remat the stash per
microbatch is one stage-boundary activation, and a uniform program that
runs the same code on every stage every tick keeps the backward schedule
autograd's mirror of the forward.

The step is ``pipeline_train_step``: ``sharded_train_step`` with
``pipeline_loss``, so the gradients over ``(dp, fsdp)`` come from FSDP2,
the replicated ones are averaged by ``grad_sync``, and the optimizer is
the port's (``parallel/train.py``). Off a mesh the model runs the same
schedule with one stage. Its entry points build on the card unless
``"cpu"`` is asked for.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, \
    distribute_tensor
from torch.utils.checkpoint import checkpoint

from tony_tpu_torch._device import resolve_device
from tony_tpu_torch.models.transformer import (SEQUENCE_PARALLEL, Block,
                                               TransformerConfig,
                                               _check_supported,
                                               causal_lm_loss, init_dense_)
from tony_tpu_torch.parallel import _comm
from tony_tpu_torch.parallel.mesh import mesh_shape
from tony_tpu_torch.parallel.sharding import (DEFAULT_RULES,
                                              fsdp_shards,
                                              fully_shard_placed,
                                              logical_axes, mesh_axes)
from tony_tpu_torch.parallel.train import TrainState, sharded_train_step

PP_AXIS = "pp"

# The head's parameters and their mesh axes per dim
# (``pipeline_param_shardings``' outside-the-pipeline specs).
_HEAD_DIMS = {
    "embedding": (("fsdp",), ()),
    "final_norm": (("fsdp",),),
    "lm_head": (("fsdp",), ("tp",)),
}


class PipelinePlacement(NamedTuple):
    """Where a parameter of the pipelined model lives: per tensor dim the
    mesh axes that shard it (major first, empty: whole), the shape of one
    rank's shard, and the pp rank (stage) holding it (None: every pp
    rank)."""
    dims: Tuple[Tuple[str, ...], ...]
    local_shape: Tuple[int, ...]
    stage: Optional[int]


def stage_layers(n_layers: int, n_stages: int, stage: int) -> range:
    """The global indices of the layers stage ``stage`` of ``n_stages``
    holds: a contiguous ``n_layers / n_stages``."""
    if n_layers % n_stages:
        raise ValueError(f"n_layers={n_layers} not divisible by pp="
                         f"{n_stages}")
    per = n_layers // n_stages
    return range(stage * per, (stage + 1) * per)


class PipelineTransformer(nn.Module):
    """The reference's pipeline parameters as a module: tokens [B, S] →
    logits [B, S, vocab] f32 through the GPipe schedule (``forward``'s
    ``num_microbatches``).

    Built whole on ``device`` (default ``"cuda"``; raises without a CUDA
    device unless ``"cpu"`` is asked for; ``"meta"`` allocates and draws
    nothing) from ``generator`` (default: one seeded with 0), drawing in
    ``named_parameters()`` order; ``pipeline_shard`` lays it out on a mesh.
    ``num_microbatches`` is the M a call without one runs.
    """

    def __init__(self, cfg: TransformerConfig,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None,
                 num_microbatches: int = 2):
        super().__init__()
        _check_supported(cfg)
        if cfg.attn_impl in SEQUENCE_PARALLEL:
            raise NotImplementedError(
                f"attn_impl={cfg.attn_impl!r} inside the pipeline: the "
                "stages run flash (or the plain oracle) attention")
        meta = torch.device(device).type == "meta"
        dev = torch.device("meta") if meta else resolve_device(device)
        self.cfg = cfg
        self.num_microbatches = num_microbatches
        pd = cfg.param_dtype
        self.embedding = nn.Parameter(torch.empty(
            (cfg.vocab_size, cfg.dim), dtype=pd, device=dev))
        self.layers = nn.ModuleDict(
            {str(i): Block(cfg, dev) for i in range(cfg.n_layers)})
        self.final_norm = nn.Parameter(torch.empty(cfg.dim, dtype=pd,
                                                   device=dev))
        self.lm_head = nn.Parameter(torch.empty(
            (cfg.dim, cfg.vocab_size), dtype=pd, device=dev))
        # Set by pipeline_shard; off a mesh, one stage of every layer.
        self.pp_group = None
        self.stage, self.n_stages = 0, 1
        self.tp_mesh: Optional[DeviceMesh] = None
        if not meta:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            with torch.no_grad():
                for name, p in self.named_parameters():
                    self.init_parameter_(name, p, generator)

    def init_parameter_(self, name: str, t: torch.Tensor,
                        generator: torch.Generator) -> None:
        """Fill ``t``, the whole of parameter ``name``, as the reference's
        ``init_pipeline_params`` initialises it: normal(0.02) for the
        embedding, ones for the norms, lecun's truncated normal (fan in:
        the input dim) for the projections and the ``[dim, vocab]``
        head."""
        if name == "embedding":
            nn.init.normal_(t, std=0.02, generator=generator)
        elif name == "final_norm" or name.endswith(".scale"):
            nn.init.ones_(t)
        elif name == "lm_head":
            init_dense_(t.T, generator)      # [dim, vocab]: fan in is dim
        else:
            init_dense_(t, generator)

    def forward(self, tokens: torch.Tensor,
                num_microbatches: Optional[int] = None) -> torch.Tensor:
        cfg = self.cfg
        if num_microbatches is None:
            num_microbatches = self.num_microbatches
        if tokens.shape[1] > cfg.max_seq_len:
            raise ValueError(f"seq {tokens.shape[1]} > max "
                             f"{cfg.max_seq_len}")
        x = F.embedding(tokens, self.embedding).to(cfg.dtype)
        # Only stage 0 reads x; every pp rank's embedding takes the sum.
        x = _comm.sum_grad_over_group(x, self.pp_group)
        x = self._pipeline_blocks(x, num_microbatches)
        xf = x.float()
        var = xf.square().mean(-1, keepdim=True)
        xf = xf * torch.rsqrt(var + cfg.norm_eps) * self.final_norm
        return self._head(xf)

    def _head(self, xf: torch.Tensor) -> torch.Tensor:
        """``xf @ lm_head`` in f32; over tp the head's vocab columns are
        this rank's, and the logits are gathered."""
        w = self.lm_head
        if self.tp_mesh is None:
            return torch.matmul(xf, w.float())
        x = DTensor.from_local(xf, self.tp_mesh, [Replicate()],
                               run_check=False)
        logits = torch.matmul(x, w.float())
        return logits.redistribute(self.tp_mesh, [Replicate()]).to_local()

    def _stage_apply(self, h: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
        """This stage's layers, in order, each under a full checkpoint
        with ``cfg.remat``."""
        remat = self.cfg.remat and torch.is_grad_enabled()
        for blk in self.layers.values():
            h = (checkpoint(blk, h, positions, use_reentrant=False)
                 if remat else blk(h, positions))
        return h

    def _pipeline_blocks(self, x: torch.Tensor, m: int) -> torch.Tensor:
        """The GPipe loop on this rank's [B_local, S, D] activations (the
        same on every pp rank of a batch coordinate)."""
        b_loc, seq, _ = x.shape
        if m < 1 or b_loc % m:
            raise ValueError(
                f"batch of {b_loc} rows on this rank not divisible into "
                f"{m} microbatches")
        n_stages, group = self.n_stages, self.pp_group
        mbs = x.chunk(m)
        mb = b_loc // m
        positions = torch.arange(seq, device=x.device).expand(mb, seq)
        first = torch.tensor(self.stage == 0, device=x.device)
        state = torch.zeros_like(mbs[0])
        outs = []
        n_ticks = m + n_stages - 1
        for t in range(n_ticks):
            state = torch.where(first, mbs[min(t, m - 1)], state)
            state = self._stage_apply(state, positions)
            if t >= n_stages - 1:
                outs.append(state)
            if t < n_ticks - 1:
                state = _comm.ppermute(state, group, 1)
        out = torch.cat(outs)
        # Only the last stage banked real outputs.
        return _comm.broadcast_from_group(out, group, n_stages - 1)


def pipeline_forward(model: nn.Module, tokens: torch.Tensor,
                     num_microbatches: Optional[int] = None) -> torch.Tensor:
    """The reference's name for the model's call: causal-LM forward with
    the block stack pipelined over ``pp``, tokens [B_local, S] (this rank's
    rows; B_local divisible into ``num_microbatches``, None: the model's)
    → logits [B_local, S, vocab] f32, the same on every pp rank."""
    return model(tokens, num_microbatches)


def pipeline_loss(model: nn.Module, tokens: torch.Tensor,
                  num_microbatches: Optional[int] = None) -> torch.Tensor:
    """``causal_lm_loss`` of ``pipeline_forward``: this rank's rows'
    mean."""
    return causal_lm_loss(model(tokens, num_microbatches), tokens)


def pipeline_param_placements(
        cfg: TransformerConfig,
        mesh: Union[DeviceMesh, Mapping[str, int]]
) -> Dict[str, PipelinePlacement]:
    """Per parameter of the whole pipelined model (by name): its mesh
    axes per dim, one rank's shard shape and its stage. Counterpart of
    ``pipeline_param_shardings``: a block's leaves over pp (the stage
    holding its layer) and fsdp on the dim the default rules map to fsdp
    (its ``embed`` dim; none for the norm scales), whole over tp; the
    head's as ``_HEAD_DIMS``. Like the reference's (``_block_fsdp_axes``,
    tony_tpu/parallel/pipeline.py:95-120) it reads no other rules
    table."""
    sizes = mesh if isinstance(mesh, Mapping) else mesh_shape(mesh)
    per = len(stage_layers(cfg.n_layers, sizes[PP_AXIS], 0))
    out = {}
    for name, p in PipelineTransformer(cfg, "meta").named_parameters():
        if name in _HEAD_DIMS:
            dims, stage = _HEAD_DIMS[name], None
        else:
            dims = tuple(("fsdp",) if "fsdp" in axes else ()
                         for axes in mesh_axes(logical_axes(name),
                                               DEFAULT_RULES))
            stage = int(name.split(".")[1]) // per
        local = tuple(-(-n // math.prod(sizes[a] for a in axes))
                      for n, axes in zip(p.shape, dims))
        out[name] = PipelinePlacement(dims, local, stage)
    return out


def pipeline_shard(model: PipelineTransformer, mesh: DeviceMesh
                   ) -> Dict[str, PipelinePlacement]:
    """Lay ``model`` (best on the meta device) out on ``mesh``: keep this
    pp rank's layers, give the model its pp group and stage, the head's
    vocab over tp (a DTensor, when tp > 1), then FSDP2 on each block and
    on the root over ``(dp, fsdp)``, the norm scales left replicated.
    The ranks of an ``sp`` or ``ep`` axis are replicas: each computes the
    whole stage on the same rows, as the reference's ``shard_map`` (whose
    specs name only pp and the batch axes) has them do, and their
    gradients are not summed (the model has no ``sp_group``, which is what
    ``grad_sync`` reads). Raises ``ValueError`` ("divisible") unless pp
    divides the layers. Returns ``pipeline_param_placements`` of the
    parameters this rank holds."""
    shape = mesh_shape(mesh)
    n_stages = shape[PP_AXIS]
    stage = mesh.get_local_rank(PP_AXIS)
    keep = stage_layers(model.cfg.n_layers, n_stages, stage)
    for key in list(model.layers.keys()):
        if int(key) not in keep:
            del model.layers[key]
    model.pp_group = mesh[PP_AXIS].get_group() if n_stages > 1 else None
    model.stage, model.n_stages = stage, n_stages
    if shape["tp"] > 1:
        model.tp_mesh = mesh["tp"]
        model.register_parameter("lm_head", nn.Parameter(distribute_tensor(
            model.lm_head.data, model.tp_mesh, [Shard(1)],
            src_data_rank=None)))
    held = dict(model.named_parameters())
    placements = {name: pl for name, pl in pipeline_param_placements(
        model.cfg, mesh).items() if name in held}
    # The head's vocab over tp is the DTensor above; fsdp is FSDP2's.
    shards = fsdp_shards(model, placements, shape,
                         lambda model, name, axis, d: axis == "tp")
    fully_shard_placed(model, mesh, shards, [
        (f"layers.{key}", blk) for key, blk in model.layers.items()])
    return placements


def pipeline_train_step(mesh: DeviceMesh, state: TrainState,
                        batch: Mapping[str, Any],
                        num_microbatches: Optional[int] = None
                        ) -> Tuple[TrainState, Dict[str, Any]]:
    """One step of a pipelined state (``init_sharded_state(...,
    layout=pipeline_shard)``) on this rank's rows of ``batch``
    (``{"tokens"}``; the pp ranks of a batch coordinate read the same
    rows): ``sharded_train_step`` with ``pipeline_loss`` at
    ``num_microbatches`` (None: the model's). The counterpart of the
    reference's pp × dp step."""
    return sharded_train_step(
        lambda model, b: (pipeline_loss(model, b["tokens"],
                                        num_microbatches), {}),
        mesh, state, batch)
