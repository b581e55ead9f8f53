"""Mixture-of-experts decoder with expert parallelism over the ``ep`` mesh
axis.

Counterpart of ``tony_tpu/models/moe.py``: the GShard/Switch dense dispatch.

- Each block is the port's ``Attention`` and a routed expert FFN
  (``MoEMLP``): a f32 router (``Dense`` over ``dim`` → ``n_experts``),
  softmax, top-k experts per token, each expert a gated-silu FFN whose
  weights are stacked ``gate``/``up`` ``[E, D, F]`` and ``down`` ``[E, F,
  D]`` in the reference's layout (no ``nn.Linear``).
- Tokens reach their experts through one-hot dispatch and combine tensors
  ``[T, E, C]`` and matrix products (``"tec,td->ecd"`` and back), per
  expert capacity ``C = max(k, ceil(k·T_g/E · capacity_factor))``; a token
  over capacity is dropped (its residual passes). The dispatch is in
  ``cfg.dtype``; the reference builds the combine in f32 from the
  normalised gate values and casts it before its product, and since each
  (token, expert) entry holds one gate value or 0, the port builds it from
  the gate values already cast: the same tensor, without an f32 one of
  ``T·E·C`` elements.
- Slot priority: slot 0 of every token before slot 1, earlier tokens before
  later ones. ``jax.lax.top_k`` puts the lower expert first on a tie;
  ``torch.topk`` promises no order, so the experts come from a stable
  descending sort. Positions past the capacity are masked, where the
  reference's ``one_hot`` gives a zero row.
- **The routing group.** The reference routes each contiguous 1/ep of the
  *global* batch's flattened tokens as one group (one group at ep = 1),
  whatever the batch axes. A rank here holds only its batch coordinate's
  rows, so the top-k experts are all-gathered over the batch axes (a few
  KiB), every rank runs the slot loop over the reference's group that holds
  its tokens, and keeps its own rows: the tokens kept and dropped are the
  reference's. The port's slots are laid out per rank (a rank's tokens sit
  at their group positions in a ``[T_local, E, C]`` dispatch).
- **ep > 1.** The expert weights are DTensors ``Shard(0)`` on the mesh's
  ``ep`` axis (``parallel/sharding.py``); the forward reads ``to_local()``,
  its E/ep experts. The ep ranks of a batch coordinate hold the same rows:
  rank j takes its 1/ep of them (``split_to_group``), dispatches them,
  ships ``[E, C, D] → [E/ep, ep·C, D]`` to the experts' owners and back
  (``all_to_all_tiled``), combines, and the whole output is rebuilt on
  every rank (``gather_from_group``). Every replicated parameter then gets
  the same whole gradient on each ep rank, with no reduction over ep.
- **The aux loss** (Switch: E · Σ_e token_frac_e · prob_frac_e) is the
  global batch's: the two fractions are averaged over the batch axes before
  the product, through an all-reduce whose backward sums, so that the
  gradient FSDP averages over the batch is the reference's.

``MoETransformer`` returns ``(logits f32, aux averaged over layers)``;
``moe_lm_loss`` adds ``aux_weight · aux`` to the cross-entropy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tony_tpu_torch._device import resolve_device
from tony_tpu_torch.models.transformer import (_TRUNC_STD, Attention, Dense,
                                               RMSNorm, TableLookup,
                                               TransformerConfig,
                                               _check_supported,
                                               causal_lm_loss, init_dense_)
from tony_tpu_torch.parallel import _comm


@dataclasses.dataclass(frozen=True)
class MoEConfig(TransformerConfig):
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01

    @classmethod
    def tiny_moe(cls, **kw) -> "MoEConfig":
        defaults = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                        n_kv_heads=2, mlp_dim=128, max_seq_len=128,
                        dtype=torch.float32, remat=False, n_experts=4,
                        top_k=2)
        defaults.update(kw)
        return cls(**defaults)


def init_expert_(w: torch.Tensor,
                 generator: Optional[torch.Generator]) -> None:
    """flax's lecun_normal on a stacked ``[E, in, out]`` kernel: fan in is
    ``in · E`` (flax counts the leading dims as the receptive field)."""
    std = 1.0 / math.sqrt(w.shape[-2] * w.shape[0]) / _TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


def capacity(cfg: MoEConfig, group_tokens: int) -> int:
    """Slots per expert for a routing group of ``group_tokens`` tokens."""
    k = cfg.top_k
    return max(k, int(math.ceil(k * group_tokens / cfg.n_experts
                                * cfg.capacity_factor)))


def top_k_experts(probs: torch.Tensor, k: int) -> torch.Tensor:
    """The k most probable experts of each row, the lower index first on a
    tie (``jax.lax.top_k``'s order): ``[T, k]`` int64."""
    return torch.sort(probs.detach(), dim=-1, descending=True,
                      stable=True).indices[:, :k]


def route(cfg: MoEConfig, gate_idx: torch.Tensor, cap: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's slot loop over one routing group's ``[T_g, k]``
    experts: each (token, slot)'s position in its expert and whether it is
    kept (position < ``cap``), ``[T_g, k]`` each. Slot 0 of every token
    comes before slot 1, earlier tokens before later ones."""
    experts = torch.arange(cfg.n_experts, device=gate_idx.device)[:, None]
    offset = torch.zeros_like(experts)
    pos = []
    for slot in range(gate_idx.shape[1]):
        idx = gate_idx[:, slot][None, :]
        # [E, T_g], the tokens on the inner dim: torch's scan along the
        # outer dim of [T_g, E] took 1.4 ms a call at T_g = 8192 on an H100.
        onehot = (idx == experts).int()
        loc = torch.cumsum(onehot, dim=1, dtype=torch.int64) - 1 + offset
        offset = offset + onehot.sum(1, keepdim=True)
        pos.append(loc.gather(0, idx)[0])
    pos = torch.stack(pos, dim=1)
    return pos, pos < cap


def dispatch_combine(cfg: MoEConfig, gate_idx: torch.Tensor,
                     gate_vals: torch.Tensor, pos: torch.Tensor,
                     kept: torch.Tensor, cap: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The one-hot dispatch and the combine (the normalised f32 gate values
    cast to ``cfg.dtype``), ``[T, E·C]`` each, of a rank's tokens. A token's
    k slots name k different experts, so each lands in its own column; a
    dropped slot writes 0."""
    t = gate_idx.shape[0]
    cols = gate_idx * cap + torch.where(kept, pos, torch.zeros_like(pos))

    def scatter(vals):
        return torch.zeros((t, cfg.n_experts * cap), dtype=cfg.dtype,
                           device=gate_idx.device).scatter(
                               1, cols, vals.to(cfg.dtype))
    return scatter(kept), scatter(gate_vals * kept)


def _local(p: torch.Tensor) -> torch.Tensor:
    return p.to_local() if hasattr(p, "to_local") else p


def _all_gather_rows(x: torch.Tensor, groups: Sequence[Any]) -> torch.Tensor:
    """``x`` of every batch coordinate, stacked in the global row order: the
    innermost batch axis first (``groups`` are major → minor)."""
    for group in reversed(groups):
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        x = torch.cat(parts)
    return x


def _batch_index(groups: Sequence[Any]) -> Tuple[int, int]:
    """(this rank's batch coordinate, the number of coordinates)."""
    i, n = 0, 1
    for group in groups:
        size = dist.get_world_size(group)
        i, n = i * size + dist.get_rank(group), n * size
    return i, n


def _batch_mean(x: torch.Tensor, groups: Sequence[Any]) -> torch.Tensor:
    """The mean of ``x`` over the batch coordinates; its backward sums the
    cotangents over them (``torch.distributed.nn``'s all-reduce)."""
    if not groups:
        return x
    from torch.distributed.nn.functional import all_reduce

    n = 1
    for group in groups:
        x = all_reduce(x, group=group)
        n *= dist.get_world_size(group)
    return x / n


class MoEMLP(nn.Module):
    """Top-k routed expert FFN (gated-silu experts, like the dense MLP).
    ``forward(x [B, S, D]) → (out [B, S, D], aux)``. ``ep_group`` and
    ``batch_groups`` (the batch axes' groups of size > 1, major first) are
    set by ``parallel/sharding.py:shard_model``; off a mesh they are None
    and ()."""

    def __init__(self, cfg: MoEConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        e, d, f = cfg.n_experts, cfg.dim, cfg.mlp_dim
        self.router = Dense(d, e, torch.float32, cfg.param_dtype, device)

        def stacked(*shape):
            return nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype,
                                            device=device))
        self.gate = stacked(e, d, f)
        self.up = stacked(e, d, f)
        self.down = stacked(e, f, d)
        self.ep_group = None
        self.batch_groups: Tuple[Any, ...] = ()

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        b, s, d = x.shape
        xt = x.reshape(b * s, d)
        # Router in f32: stability matters more than speed for a [d, E] dot.
        probs = torch.softmax(self.router(xt.float()), dim=-1)
        out = self._routed(xt, probs)
        return out.reshape(b, s, d), self._aux(probs)

    def _routed(self, xt: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
        cfg, ep, groups = self.cfg, self.ep_group, self.batch_groups
        e, k = cfg.n_experts, cfg.top_k
        n_ep, j = _comm.group_size(ep), _comm.group_rank(ep)
        t = xt.shape[0]
        if t % n_ep or e % n_ep:
            raise ValueError(f"tokens ({t}) and experts ({e}) must divide "
                             f"the ep axis ({n_ep})")
        gate_idx = top_k_experts(probs, k)                   # [t, k]
        bi, nb = _batch_index(groups)
        # The reference's group holding this rank's tokens: a contiguous
        # 1/n_ep of the global batch's flattened tokens.
        group_t = t * nb // n_ep
        t_loc = t // n_ep
        start = bi * t + j * t_loc
        g0 = start // group_t * group_t
        everyone = _all_gather_rows(gate_idx, groups) if groups else gate_idx
        cap = capacity(cfg, group_t)
        pos, kept = route(cfg, everyone[g0:g0 + group_t], cap)
        rows = slice(start - g0, start - g0 + t_loc)
        pos, kept = pos[rows], kept[rows]
        idx = gate_idx[j * t_loc:(j + 1) * t_loc]
        xt, probs = (_comm.split_to_group(a, ep, 0) for a in (xt, probs))
        vals = probs.gather(1, idx)
        vals = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)
        dispatch, combine = dispatch_combine(cfg, idx, vals, pos, kept, cap)

        expert_in = (dispatch.T @ xt.to(cfg.dtype)).view(e, cap, -1)
        # Each expert's slots to its owner: [E, C, D] → [E/ep, ep·C, D].
        expert_in = _comm.all_to_all_tiled(expert_in, ep, 0, 1)
        w_gate, w_up, w_down = (_local(w).to(cfg.dtype)
                                for w in (self.gate, self.up, self.down))
        h = F.silu(torch.bmm(expert_in, w_gate)) * torch.bmm(expert_in, w_up)
        expert_out = torch.bmm(h, w_down)
        # The results back, slot-major: [E/ep, ep·C, D] → [E, C, D].
        expert_out = _comm.all_to_all_tiled(expert_out, ep, 1, 0)
        out = combine @ expert_out.reshape(e * cap, -1)
        return _comm.gather_from_group(out, ep, 0)

    def _aux(self, probs: torch.Tensor) -> torch.Tensor:
        """Switch's E · Σ_e (token fraction to e) · (mean router prob), over
        the global batch."""
        e = self.cfg.n_experts
        token_frac = F.one_hot(probs.argmax(-1), e).float().mean(0)
        token_frac = _batch_mean(token_frac, self.batch_groups)
        prob_frac = _batch_mean(probs.mean(0), self.batch_groups)
        return e * (token_frac * prob_frac).sum()


class MoEBlock(nn.Module):
    def __init__(self, cfg: MoEConfig, device: torch.device):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.param_dtype,
                                 device)
        self.attn = Attention(cfg, device)
        self.mlp_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.param_dtype,
                                device)
        self.moe = MoEMLP(cfg, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        h = x + self.attn(self.attn_norm(x), positions)
        mlp_out, aux = self.moe(self.mlp_norm(h))
        return h + mlp_out, aux


class MoETransformer(nn.Module):
    """Causal LM with routed-expert FFNs: tokens [B, S] → (logits [B, S,
    vocab] f32, aux loss). Made on ``device`` from ``generator`` as
    ``Transformer`` is (``"meta"`` draws nothing); the LM head runs in
    f32, as the reference's."""

    # The table is a plain ("vocab", "embed") parameter here
    # (tony_tpu/models/moe.py:204), not the dense decoder's embedding table.
    PARAM_AXES = {"embedding": ("vocab", "embed")}

    def __init__(self, cfg: MoEConfig,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_supported(cfg)
        if cfg.tie_embeddings:
            raise NotImplementedError("tie_embeddings in the MoE decoder")
        meta = torch.device(device).type == "meta"
        dev = torch.device("meta") if meta else resolve_device(device)
        self.cfg = cfg
        self.embedding = nn.Parameter(torch.empty(
            (cfg.vocab_size, cfg.dim), dtype=cfg.param_dtype, device=dev))
        self.lookup = TableLookup()
        self.layers = nn.ModuleList(
            MoEBlock(cfg, dev) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.param_dtype, dev)
        self.lm_head = Dense(cfg.dim, cfg.vocab_size, torch.float32,
                             cfg.param_dtype, dev)
        if not meta:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            with torch.no_grad():
                for name, p in self.named_parameters():
                    self.init_parameter_(name, p, generator)

    def init_parameter_(self, name: str, t: torch.Tensor,
                        generator: torch.Generator) -> None:
        """Fill ``t``, the whole of parameter ``name``, as the constructor
        does (see ``Transformer.init_parameter_``); the stacked expert
        kernels take ``init_expert_``."""
        if name == "embedding":
            nn.init.normal_(t, std=0.02, generator=generator)
        elif name.endswith(".scale"):
            nn.init.ones_(t)
        elif name.rsplit(".", 1)[-1] in ("gate", "up", "down"):
            init_expert_(t, generator)
        else:
            init_dense_(t, generator)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        if positions is None:
            positions = torch.arange(tokens.shape[1],
                                     device=tokens.device).expand(
                                         tokens.shape)
        x = self.lookup(tokens, self.embedding).to(cfg.dtype)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for blk in self.layers:
            if cfg.remat and torch.is_grad_enabled():
                x, aux = checkpoint(blk, x, positions, use_reentrant=False)
            else:
                x, aux = blk(x, positions)
            aux_total = aux_total + aux
        x = self.final_norm(x)
        logits = self.lm_head(x.float())
        return logits.float(), aux_total / cfg.n_layers


def moe_lm_loss(model_out: Tuple[torch.Tensor, torch.Tensor],
                tokens: torch.Tensor, aux_weight: float) -> torch.Tensor:
    logits, aux = model_out
    return causal_lm_loss(logits, tokens) + aux_weight * aux


def dryrun_ep_step(mesh: Any, seed: int = 0) -> float:
    """One full MoE train step (forward, backward, AdamW) of ``tiny_moe``
    on ``mesh`` (a ``DeviceMesh`` with ``ep`` ≥ 1), every rank calling it;
    returns the global batch's loss and raises if it is not finite.
    Counterpart of the reference's ``dryrun_ep_step``."""
    from tony_tpu_torch.data import process_batch_slice
    from tony_tpu_torch.parallel import (adamw, batch_world,
                                         init_sharded_state,
                                         sharded_train_step)

    cfg = MoEConfig.tiny_moe()
    state, _ = init_sharded_state(lambda d: MoETransformer(cfg, device=d),
                                  lambda g: adamw(g, 1e-3), mesh, seed=seed)
    dev = next(state.model.parameters()).device
    rows = 2 * batch_world(mesh)
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                  (rows, 32))
    local = torch.from_numpy(tokens[process_batch_slice(rows, mesh=mesh)])

    def loss_fn(model, batch):
        tok = batch["tokens"]
        return moe_lm_loss(model(tok), tok, cfg.aux_loss_weight), {}

    _, metrics = sharded_train_step(loss_fn, mesh, state,
                                    {"tokens": local.to(dev)})
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise RuntimeError(f"ep MoE train step diverged: {loss}")
    return loss
