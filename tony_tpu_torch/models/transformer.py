"""Decoder-only transformer (llama-family architecture) in PyTorch.

Counterpart of ``tony_tpu/models/transformer.py``, with the same numbers at
the same places:

- f32 parameters, activations in ``cfg.dtype``: every projection casts its
  input and its weight to ``cfg.dtype`` inside ``forward`` and multiplies
  there, as a flax ``Dense(dtype=bf16)`` over f32 params does (no autocast);
- ``Dense.weight`` is ``[out, in]`` (``Linear`` layout; flax keeps
  ``[in, out]``, see ``tony_tpu_torch/convert.py``);
- RoPE rotates the two halves of each head, in f32;
- the embedding table is f32, gathered and then cast to ``cfg.dtype``;
- logits come back f32;
- the embedding lookup is ``F.embedding`` in the ``lookup`` submodule (no
  parameters of its own), where a tensor-parallel plan can reach it;
- attention is the flash kernel (``"flash"``), the plain oracle (``"xla"``,
  K/V repeated to the full head count), or sequence-parallel over the
  mesh's ``sp`` group: ring attention (``"ring"``, ``ops/ring.py``) or
  Ulysses (``"ulysses"``, ``ops/ulysses.py``), both through the flash
  kernels;
- ``matmul_dtype`` ("int8" | "fp8_e4m3") sends the seven attention and MLP
  projections through ``ops/quant.py``'s quantized product (the embedding
  and the LM head stay unquantized); None is the bf16 path, bit for bit.

Module names follow the flax tree (``embedding``, ``layers.{i}.attn.wq``,
``layers.{i}.mlp.gate``, ``*_norm.scale``, ``lm_head``) so weights convert
one to one. Init follows flax: truncated-normal lecun (fan in) for the
projections, normal(0.02) for the embedding, ones for the norms, drawn from
an explicit ``torch.Generator`` in parameter order
(``Transformer.init_parameter_``, which a sharded init replays one tensor at
a time). ``device="meta"`` builds the skeleton without drawing.

Under a tensor-parallel plan (``parallel/sharding.py:tp_plan``) each rank
holds ``n_heads / tp`` heads: attention takes its head counts from the
projections' local widths, never from the config.

On a mesh with an ``sp`` axis (``shard_model`` sets ``sp_group`` on the model
and on each ``Attention``; None off a mesh) the model still takes the whole
``[B, S]`` tokens every sp peer reads: each rank runs its sequence chunk
``[r·S/n, (r+1)·S/n)`` at its global positions (RoPE offset ``r·S/n``), and
the logits (or hidden states) are gathered over the group
(``parallel/_comm.py:gather_from_group``), as the reference's ``shard_map``
``out_specs`` gather them. The loss every sp rank then takes is the whole
sequence's; each rank's parameter gradient is its chunk's share of it, and
the train step sums them over sp (``parallel/grad_sync.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tony_tpu_torch._device import resolve_device
from tony_tpu_torch.ops import quant
from tony_tpu_torch.ops.attention import flash_attention, reference_attention
from tony_tpu_torch.ops.ring import ring_attention
from tony_tpu_torch.ops.ulysses import ulysses_attention
from tony_tpu_torch.parallel import _comm

# lecun_normal's truncated normal: std of a unit normal cut at ±2.
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    mlp_dim: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16          # activations
    param_dtype: torch.dtype = torch.float32
    attn_impl: str = "flash"                 # flash | ring | ulysses | xla
    remat: bool = True
    # With remat on and N >= 2, every Nth block runs without checkpointing.
    remat_skip_every: int = 0
    # Tile sizes of the plain attention version; the CUDA kernels pick
    # their own (see ops/attention.py).
    attn_block_q: int = 1024
    attn_block_k: int = 1024
    tie_embeddings: bool = False
    lm_head_dtype: Optional[torch.dtype] = None  # None → activation dtype
    # Quantized projections ("int8" | "fp8_e4m3", see ops/quant.py); None
    # is the bf16 path.
    matmul_dtype: Optional[str] = None

    @classmethod
    def llama3_8b(cls, **kw) -> "TransformerConfig":
        """Llama-3-8B geometry (32L, 4096d, 32h/8kv, 14336 mlp, 128k
        vocab)."""
        return cls(vocab_size=128256, dim=4096, n_layers=32, n_heads=32,
                   n_kv_heads=8, mlp_dim=14336, rope_theta=500000.0, **kw)

    @classmethod
    def tiny(cls, **kw) -> "TransformerConfig":
        """Test-sized config."""
        defaults = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                        n_kv_heads=2, mlp_dim=128, max_seq_len=128,
                        dtype=torch.float32, remat=False)
        defaults.update(kw)
        return cls(**defaults)


SEQUENCE_PARALLEL = ("ring", "ulysses")


def _check_supported(cfg: TransformerConfig) -> None:
    if cfg.attn_impl not in ("flash", "xla") + SEQUENCE_PARALLEL:
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    quant.check_mode(cfg.matmul_dtype)


def init_dense_(w: torch.Tensor,
                generator: Optional[torch.Generator]) -> None:
    """flax's lecun_normal on a ``[out, in]`` weight: a normal truncated at
    ±2 std, std = 1/sqrt(fan in) over the truncation's own std."""
    std = 1.0 / math.sqrt(w.shape[1]) / _TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class Dense(nn.Linear):
    """Bias-free projection with a flax ``Dense``'s numerics: weight
    ``[out, in]`` in ``param_dtype``; input and weight cast to ``dtype``
    and multiplied there; drawn from ``generator`` when one is given,
    else left uninitialized (a ``Transformer`` draws all its parameters
    itself, in order). With ``matmul_dtype`` set (and resolved on the
    input's device) the product is ``quant.quantized_matmul`` of the cast
    operands, as the reference's ``QDense``; off, it is ``F.linear``.

    An ``nn.Linear`` (``bias`` None) so that torch's ``ColwiseParallel`` and
    ``RowwiseParallel`` take it; ``nn.Linear.__init__`` is skipped because
    its ``reset_parameters`` would draw from the global generator."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, param_dtype: torch.dtype,
                 device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 matmul_dtype: Optional[str] = None):
        nn.Module.__init__(self)
        self.in_features, self.out_features = in_features, out_features
        self.dtype = dtype
        self.matmul_dtype = quant.check_mode(matmul_dtype)
        self.weight = nn.Parameter(torch.empty(
            (out_features, in_features), dtype=param_dtype, device=device))
        self.register_parameter("bias", None)
        if generator is not None:
            init_dense_(self.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = x.to(self.dtype), self.weight.to(self.dtype)
        mode = self.matmul_dtype and quant.resolve_mode(self.matmul_dtype,
                                                        x.device)
        if mode:
            return quant.quantized_matmul(x, w, mode)
        return F.linear(x, w)


class TableLookup(nn.Module):
    """``F.embedding(tokens, table)``: the embedding lookup as a module of
    its own, without parameters (the table stays the root's
    ``embedding``), so that a tensor-parallel style can hook its inputs
    and output (``parallel/sharding.py:VocabParallelTable``)."""

    def forward(self, tokens: torch.Tensor,
                table: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, table)


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    """Rotary embedding on [B, S, H, D]: halves, f32 trig, cast back."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d)
    angles = positions[:, :, None, None].float() * freqs     # [B,S,1,D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, param_dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=param_dtype,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.square().mean(-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps) * self.scale).to(x.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        hd = cfg.dim // cfg.n_heads
        self.head_dim = hd

        def dense(i, o):
            return Dense(i, o, cfg.dtype, cfg.param_dtype, device,
                         matmul_dtype=cfg.matmul_dtype)
        self.wq = dense(cfg.dim, cfg.n_heads * hd)
        self.wk = dense(cfg.dim, cfg.n_kv_heads * hd)
        self.wv = dense(cfg.dim, cfg.n_kv_heads * hd)
        self.wo = dense(cfg.n_heads * hd, cfg.dim)
        self.sp_group = None        # the mesh's sp group (shard_model)

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        cfg, hd = self.cfg, self.head_dim
        b, s, _ = x.shape
        # Head counts from the local widths: n_heads / tp under a plan.
        q = self.wq(x).view(b, s, -1, hd)
        k = self.wk(x).view(b, s, -1, hd)
        v = self.wv(x).view(b, s, -1, hd)
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
        blocks = dict(block_q=cfg.attn_block_q, block_k=cfg.attn_block_k)
        if cfg.attn_impl == "flash":
            o = flash_attention(q, k, v, causal=True, **blocks)
        elif cfg.attn_impl == "ring":
            # GQA-native: K/V travel the ring at kv-head width.
            o = ring_attention(q, k, v, self.sp_group, causal=True, **blocks)
        elif cfg.attn_impl == "ulysses":
            o = ulysses_attention(q, k, v, self.sp_group, causal=True,
                                  **blocks)
        else:                                            # "xla"
            g = q.shape[2] // k.shape[2]
            o = reference_attention(q, k.repeat_interleave(g, dim=2),
                                    v.repeat_interleave(g, dim=2),
                                    causal=True)
        return self.wo(o.reshape(b, s, -1))


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: torch.device):
        super().__init__()

        def dense(i, o):
            return Dense(i, o, cfg.dtype, cfg.param_dtype, device,
                         matmul_dtype=cfg.matmul_dtype)
        self.gate = dense(cfg.dim, cfg.mlp_dim)
        self.up = dense(cfg.dim, cfg.mlp_dim)
        self.down = dense(cfg.mlp_dim, cfg.dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.silu(self.gate(x)) * self.up(x))


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: torch.device):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.param_dtype,
                                 device)
        self.attn = Attention(cfg, device)
        self.mlp_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.param_dtype,
                                device)
        self.mlp = MLP(cfg, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        h = x + self.attn(self.attn_norm(x), positions)
        return h + self.mlp(self.mlp_norm(h))


class Transformer(nn.Module):
    """Causal LM: tokens [B, S] int → logits [B, S, vocab] f32.

    Parameters are made on ``device`` (default ``"cuda"``; raises without a
    CUDA device unless ``"cpu"`` is asked for; ``"meta"`` allocates and
    draws nothing) from ``generator``, a generator on that device (default:
    one seeded with 0)."""

    def __init__(self, cfg: TransformerConfig,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_supported(cfg)
        meta = torch.device(device).type == "meta"
        dev = torch.device("meta") if meta else resolve_device(device)
        self.cfg = cfg
        self.embedding = nn.Parameter(torch.empty(
            (cfg.vocab_size, cfg.dim), dtype=cfg.param_dtype, device=dev))
        self.lookup = TableLookup()
        self.layers = nn.ModuleList(
            Block(cfg, dev) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.param_dtype, dev)
        self.lm_head = None if cfg.tie_embeddings else Dense(
            cfg.dim, cfg.vocab_size, cfg.lm_head_dtype or cfg.dtype,
            cfg.param_dtype, dev)
        self.sp_group = None        # the mesh's sp group (shard_model)
        if not meta:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            with torch.no_grad():
                for name, p in self.named_parameters():
                    self.init_parameter_(name, p, generator)

    def init_parameter_(self, name: str, t: torch.Tensor,
                        generator: torch.Generator) -> None:
        """Fill ``t``, the whole of parameter ``name``, as the constructor
        does: normal(0.02) for the embedding, ones for a norm scale,
        lecun's truncated normal for a projection. The constructor draws in
        ``named_parameters()`` order; replaying that order from a generator
        in the same state gives the same values, one tensor at a time."""
        if name == "embedding":
            nn.init.normal_(t, std=0.02, generator=generator)
        elif name.endswith(".scale"):
            nn.init.ones_(t)
        else:
            init_dense_(t, generator)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                return_hidden: bool = False,
                loss_chunk: Optional[int] = None) -> torch.Tensor:
        """``return_hidden=True`` skips the LM head and returns the
        final-norm hidden states [B, S, D]. ``loss_chunk=C`` returns the
        next-token loss instead of logits, taken by
        ``chunked_causal_lm_loss`` over the head in chunks of C positions,
        so the [B, S, vocab] logits never exist; the head is read inside
        this forward, where a sharded model's parameters are whole."""
        cfg = self.cfg
        seq = tokens.shape[1]
        if seq > cfg.max_seq_len:
            raise ValueError(
                f"global sequence length {seq} exceeds max_seq_len "
                f"{cfg.max_seq_len} (RoPE would extrapolate)")
        if positions is None:
            positions = torch.arange(seq, device=tokens.device).expand(
                tokens.shape)
        sp = self.sp_group
        if _comm.group_size(sp) > 1:
            if loss_chunk is not None:
                raise ValueError(
                    "chunked_causal_lm_loss inside an sp group of more than "
                    "one rank would shift targets per shard (wrong at every "
                    "shard boundary) and skip the cross-shard mean; take the "
                    "loss on the gathered logits")
            # This rank's sequence chunk, at its global positions.
            tokens = _comm.split_to_group(tokens, sp, 1)
            positions = _comm.split_to_group(positions, sp, 1)
        out = self._forward(tokens, positions, return_hidden, loss_chunk)
        return out if loss_chunk is not None else \
            _comm.gather_from_group(out, sp, 1)

    def _forward(self, tokens, positions, return_hidden, loss_chunk):
        cfg = self.cfg
        x = self.lookup(tokens, self.embedding).to(cfg.dtype)
        for i, blk in enumerate(self.layers):
            skip = cfg.remat_skip_every >= 2 and i % cfg.remat_skip_every == 0
            if cfg.remat and not skip and torch.is_grad_enabled():
                x = checkpoint(blk, x, positions, use_reentrant=False)
            else:
                x = blk(x, positions)
        x = self.final_norm(x)
        if return_hidden:
            return x
        head_dtype = cfg.lm_head_dtype or cfg.dtype
        if loss_chunk is not None:
            if cfg.tie_embeddings:
                return chunked_causal_lm_loss(x, self.embedding.T, tokens,
                                              loss_chunk,
                                              head_dtype=head_dtype)
            return _chunked_nll(x, self.lm_head, tokens, loss_chunk, None)
        if cfg.tie_embeddings:
            # The reference accumulates this product in f32.
            logits = torch.matmul(x.to(head_dtype).float(),
                                  self.embedding.to(head_dtype).float().T)
        else:
            logits = self.lm_head(x.to(head_dtype))
        return logits.float()


def check_tensor_parallel(cfg: TransformerConfig, tp: int) -> None:
    """Raise unless ``cfg`` runs under a tensor-parallel plan over ``tp``
    ranks: every split width a multiple of tp (each rank keeps whole
    heads, and the GQA groups stay whole with n_kv_heads % tp == 0), an
    untied head, bf16/f32 projections."""
    for knob in ("n_heads", "n_kv_heads", "mlp_dim", "vocab_size"):
        if getattr(cfg, knob) % tp:
            raise ValueError(
                f"{knob} ({getattr(cfg, knob)}) is not divisible by the "
                f"mesh's tp ({tp})")
    if cfg.tie_embeddings:
        raise NotImplementedError(
            "tie_embeddings under a tensor-parallel plan: the tied head "
            "reads the vocab-sharded table outside the plan's styles")
    if cfg.matmul_dtype:
        raise NotImplementedError(
            f"matmul_dtype={cfg.matmul_dtype!r} under a tensor-parallel "
            "plan: the quantized projections take plain tensors, not the "
            "plan's DTensors")


def causal_lm_loss(logits: torch.Tensor, tokens: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token cross entropy (logsumexp − picked logit); logits [B,S,V]
    predict tokens shifted by one."""
    targets = tokens[:, 1:]
    logits = logits[:, :-1].float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = lse - picked
    if mask is not None:
        m = mask[:, 1:].float()
        return (nll * m).sum() / m.sum().clamp_min(1.0)
    return nll.mean()


def _chunk_stats(xc, tc, mc, head):
    logits = head(xc).float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, tc[..., None].long())[..., 0]
    return ((lse - picked) * mc).sum(), mc.sum()


def _chunked_nll(hidden: torch.Tensor, head, tokens: torch.Tensor,
                 chunk_size: int, mask: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """Mean next-token cross entropy of ``head(hidden)`` (a callable: a
    [.., D] chunk → its logits), in [B, C, D] sequence chunks, each under
    ``torch.utils.checkpoint`` (see ``chunked_causal_lm_loss``)."""
    if hidden.shape[1] != tokens.shape[1]:
        raise ValueError(
            f"hidden seq {hidden.shape[1]} != tokens seq {tokens.shape[1]} "
            "— per-shard hidden states with full-sequence tokens? Gather "
            "hidden states before the loss")
    x = hidden[:, :-1]
    t = tokens[:, 1:]
    b, s, _ = x.shape
    if s == 0:
        return torch.zeros((), dtype=torch.float32, device=hidden.device)
    valid = torch.ones((b, s), dtype=torch.float32, device=hidden.device) \
        if mask is None else mask[:, 1:].float()
    chunk_size = min(chunk_size, s)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, chunk_size):
        sl = slice(c0, c0 + chunk_size)
        dn, dc = checkpoint(_chunk_stats, x[:, sl], t[:, sl], valid[:, sl],
                            head, use_reentrant=False)
        tot = tot + dn
        cnt = cnt + dc
    return tot / cnt.clamp_min(1.0)


def chunked_causal_lm_loss(hidden: torch.Tensor, head_kernel: torch.Tensor,
                           tokens: torch.Tensor, chunk_size: int = 4096,
                           mask: Optional[torch.Tensor] = None,
                           head_dtype: Optional[torch.dtype] = None
                           ) -> torch.Tensor:
    """Next-token cross entropy without materializing [B, S, vocab].

    ``hidden`` [B, S, D] (``Transformer(..., return_hidden=True)``) goes
    through ``head_kernel`` [D, V] (``model.lm_head.weight.T``, or
    ``model.embedding.T`` for a tied head) in [B, C, D] sequence chunks.
    Each chunk is reduced to (Σ nll, count) under ``torch.utils.checkpoint``
    so its logits are recomputed in backward, never kept: peak residency is
    O(B·C·V). Equals ``causal_lm_loss(model(tokens), tokens)`` for the untied
    head; the product runs in ``head_dtype`` (default the hidden dtype).
    ``Transformer(..., loss_chunk=C)`` takes the same loss inside the
    model's forward."""
    hd = head_dtype or hidden.dtype
    return _chunked_nll(
        hidden, lambda xc: torch.matmul(xc.to(hd), head_kernel.to(hd)),
        tokens, chunk_size, mask)
