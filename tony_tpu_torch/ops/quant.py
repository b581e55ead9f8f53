"""Low-precision (int8 / fp8-e4m3) projections for the training step.

Counterpart of ``tony_tpu/ops/quant.py``, opt-in through
``TransformerConfig.matmul_dtype`` (``tony.train.matmul-dtype``), which
``models/transformer.py``'s ``Dense`` threads into the seven attention and
MLP projections; the embedding and the LM head stay unquantized.

- **Symmetric, per-channel, round-to-nearest.** Activations get one scale
  per row (amax over the contraction dim), weights one per output channel;
  no zero points. The amax is taken in f32, after the cast to the
  activation dtype; int8 rounds half to even (``torch.round``, as
  ``jnp.round``), fp8 clips to ±448 before the cast (an out-of-range value
  cast to ``float8_e4m3fn`` is NaN) and takes the cast's rounding.
- **The product.** int8 × int8 accumulates in int32, fp8 × fp8 in f32;
  the accumulator (as f32) is multiplied by the row scales, then by the
  channel scales, then cast to the input dtype, in the reference's order.
  On the card the product is a library call, as the reference's is
  ``lax.dot_general``: ``torch._int_mm`` (cuBLASLt int8, int32 out) and
  ``torch._scaled_mm`` (cuBLASLt fp8 e4m3 with unit scales, f32 out), A
  row-major and B column-major. On the CPU it is the plain version: the
  int32 product of the int8 values (summed exactly, in f64), or the f32
  product of the upcast fp8 values. Each product run on the card adds one to
  ``launch_counts[mode]``.
- **Forward only.** ``quantized_matmul``'s backward is the exact
  full-precision gradient (straight-through): dx = g·w, dw = gᵀ·x, both in
  the input's dtype.
- **Degrade, never die.** ``resolve_mode`` probes once per (mode, device
  type) with a 32×32 product on that device (``torch._int_mm`` refuses the
  reference's 8×8); a refusal, or the ``quant.probe`` fault site, degrades
  the path to the unquantized one with a one-time warning that also rides
  the telemetry beacon (``quant_fallback``).

The weight layout is the port's ``[out, in]`` (``Linear``), so the
reference's per-output-channel ``axis=0`` over its ``[in, out]`` kernel is
``axis=-1`` here.

**On a tensor-parallel shard** (``quantized_matmul`` with the tp group,
which ``models/transformer.py``'s ``Dense`` calls under the plan of
``parallel/sharding.py``) the operands are this rank's local shards, and
the result is the one GSPMD gives the reference on the same mesh: scales
over the whole contraction dim, wherever tp splits it.

- **Colwise** (``wq``, ``wk``, ``wv``, ``gate``, ``up``): the weight is
  split on its output dim, so each rank holds whole rows of the
  contraction: the local product is the unsharded one, column by column.
  Its dx is a partial sum over tp (each rank contracts its own output
  columns); the caller marks it so (``to_local(grad_placements=
  [Partial()])``) and the plan's input hook all-reduces it.
- **Rowwise** (``wo``, ``down``): the activation and the weight are both
  split on the contraction dim. The activation's per-row amax and the
  weight's per-output-channel amax are all-reduced (MAX) over tp before the
  scales are formed: a shard that took its own amax would quantize with
  another scale and miss the reference. The accumulator (int32 for int8,
  f32 for fp8) is summed over tp FIRST, and only then multiplied by the
  row scales and the channel scales, in the reference's order. An int32
  sum is exact, so the int8 output is the unsharded one bit for bit;
  scaling each shard before the sum would round each partial product on
  its own and lose that. dx and dw are the local shards of the
  straight-through gradients, with no collective.
"""

from __future__ import annotations

import functools
import logging
import threading
from typing import Dict, Optional, Union

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

INT8 = "int8"
FP8_E4M3 = "fp8_e4m3"
#: the modes resolve_mode accepts (anything else raises).
MODES = (INT8, FP8_E4M3)
#: spellings that mean "quantization off".
_OFF = (None, "", "bf16", "none", "off")

_INT8_MAX = 127.0
_FP8_E4M3_MAX = 448.0       # largest finite float8_e4m3fn
_EPS = 1e-12

_fallback_lock = threading.Lock()
_fallbacks: Dict[str, str] = {}

# Quantized products run on the card since the last reset, by mode.
launch_counts: Dict[str, int] = {m: 0 for m in MODES}


def reset_launch_counts() -> None:
    for m in launch_counts:
        launch_counts[m] = 0


def fallback_events() -> Dict[str, str]:
    """{mode: reason} for every quantized path that degraded in this
    process; shipped on the telemetry beacon."""
    with _fallback_lock:
        return dict(_fallbacks)


def _record_fallback(mode: str, reason: str) -> None:
    with _fallback_lock:
        if mode in _fallbacks:
            return
        _fallbacks[mode] = reason
    log.warning(
        "quantized matmul path %r unavailable on this device (%s); "
        "DEGRADING to the bf16 path — throughput loses the low-precision "
        "win, the job keeps training (one-time warning)", mode, reason)


def check_mode(mode: Optional[str]) -> Optional[str]:
    """The validated mode, or None when off. Unknown names raise: a typo'd
    knob must fail loudly, not silently train in bf16."""
    if mode in _OFF:
        return None
    if mode not in MODES:
        raise ValueError(
            f"unknown tony.train.matmul-dtype {mode!r} (choose from "
            f"{list(MODES)}, or empty for bf16)")
    return mode


@functools.lru_cache(maxsize=None)
def _probe(mode: str, device_type: str) -> str:
    """Empty string when ``device_type`` runs the quantized product; else
    the refusal reason. Cached per (mode, device type)."""
    from tony_tpu_torch import faults

    try:
        faults.check("quant.probe")
        a = torch.ones((32, 32), device=device_type)
        q, _ = quantize_symmetric(a, mode, axis=-1)
        _product(q, q, mode)
        if device_type == "cuda":
            torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 — any refusal shape degrades
        return f"{type(e).__name__}: {e}"[:200]
    return ""


def resolve_mode(mode: Optional[str],
                 device: Union[str, torch.device] = "cuda") -> Optional[str]:
    """Effective quantization mode on ``device``: None when off or
    degraded (use the unquantized path), else the validated mode."""
    mode = check_mode(mode)
    if mode is None:
        return None
    reason = _probe(mode, torch.device(device).type)
    if reason:
        _record_fallback(mode, reason)
        return None
    return mode


def _reset_fallback_state() -> None:
    """Tests: forget recorded fallbacks and probe results."""
    with _fallback_lock:
        _fallbacks.clear()
    _probe.cache_clear()


def quantize_symmetric(x: torch.Tensor, mode: str, axis: int):
    """Per-channel symmetric quantization along ``axis`` (the contraction
    dim): ``(q, scale)`` with ``q * scale ~= x`` and ``scale`` f32 keeping
    dims."""
    return _quantize(x, _amax(x, axis), mode)


def _amax(x: torch.Tensor, axis: int) -> torch.Tensor:
    """The f32 absolute maximum along ``axis``, dims kept."""
    return x.float().abs().amax(dim=axis, keepdim=True)


def _quantize(x: torch.Tensor, amax: torch.Tensor, mode: str):
    """``(q, scale)`` of ``x`` against ``amax`` (``quantize_symmetric``'s
    rounding; the amax may come from a larger tensor than ``x``)."""
    qmax = _INT8_MAX if mode == INT8 else _FP8_E4M3_MAX
    # A tensor divisor: CUDA divides by a Python scalar as a multiply by
    # its reciprocal, one ulp away from the reference's division.
    scale = amax.clamp_min(_EPS) / amax.new_full((), qmax)
    y = x.float() / scale
    if mode == INT8:
        q = torch.clamp(torch.round(y), -_INT8_MAX, _INT8_MAX).to(torch.int8)
    else:
        q = torch.clamp(y, -_FP8_E4M3_MAX, _FP8_E4M3_MAX).to(
            torch.float8_e4m3fn)
    return q, scale


def product_plain(qx: torch.Tensor, qw: torch.Tensor,
                  mode: str) -> torch.Tensor:
    """``qx [M, K] @ qw [N, K]ᵀ``: the int32 product of the int8 values, or
    the f32 product of the upcast fp8 values. The int8 sums are taken in
    f64, where every partial sum (at most K·127², below 2^53) is an exact
    integer, so the result is the int32 accumulator's on any device (CUDA
    has no int32 matmul)."""
    if mode == INT8:
        return (qx.double() @ qw.double().t()).to(torch.int32)
    return qx.float() @ qw.float().t()


def product_library(qx: torch.Tensor, qw: torch.Tensor,
                    mode: str) -> torch.Tensor:
    """``qx [M, K] @ qw [N, K]ᵀ`` on the card: ``torch._int_mm`` (int32
    out; M > 16, K and N multiples of 8) or ``torch._scaled_mm`` with unit
    scales (f32 out; K and N multiples of 16), B given column-major as
    ``qw.t()``. Both raise on other shapes."""
    if mode == INT8:
        return torch._int_mm(qx, qw.t())
    one = torch.ones((), dtype=torch.float32, device=qx.device)
    return torch._scaled_mm(qx, qw.t(), one, one, out_dtype=torch.float32)


def _product(qx: torch.Tensor, qw: torch.Tensor, mode: str) -> torch.Tensor:
    if qx.device.type == "cpu":
        return product_plain(qx, qw, mode)
    return product_library(qx, qw, mode)


def _split(group: Optional[object]) -> bool:
    return group is not None and dist.get_world_size(group) > 1


def _qmm_forward(x: torch.Tensor, w: torch.Tensor, mode: str,
                 group: Optional[object] = None) -> torch.Tensor:
    """The quantized contraction ``x [..., K] @ w [N, K]ᵀ`` with per-row /
    per-output-channel scales. With ``group``, K is split over its ranks
    and ``x``, ``w`` are this rank's shards of it: the amaxes are
    all-reduced (MAX) and the accumulator summed over the group before the
    scales apply (module docstring)."""
    n, k = w.shape
    ax, aw = _amax(x, -1), _amax(w, -1)                 # [..., 1], [N, 1]
    split = _split(group)
    if split:
        both = torch.cat([ax.reshape(-1), aw.reshape(-1)])
        dist.all_reduce(both, op=dist.ReduceOp.MAX, group=group)
        ax = both[:ax.numel()].view_as(ax)
        aw = both[ax.numel():].view_as(aw)
    qx, sx = _quantize(x, ax, mode)
    qw, sw = _quantize(w, aw, mode)
    acc = _product(qx.reshape(-1, k), qw, mode)
    if x.is_cuda:
        launch_counts[mode] += 1
    if split:
        dist.all_reduce(acc, group=group)
    acc = acc.float().reshape(*x.shape[:-1], n)
    out = acc * sx * sw.reshape(n)
    return out.to(x.dtype)


class _QuantizedMatmul(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, mode, group):
        ctx.save_for_backward(x, w)
        return _qmm_forward(x, w, mode, group)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = g @ w                                       # [..., K]
        dw = g.reshape(-1, g.shape[-1]).t() @ x.reshape(-1, x.shape[-1])
        return dx.to(x.dtype), dw.to(w.dtype), None, None


def quantized_matmul(x: torch.Tensor, w: torch.Tensor, mode: str,
                     group: Optional[object] = None) -> torch.Tensor:
    """``x @ w.T`` (``w`` is ``[out, in]``) through the quantized path;
    gradients are the exact full-precision ones (straight-through).

    On a tensor-parallel shard ``x`` and ``w`` are this rank's local
    operands. ``group`` is the tp group of a rowwise layer (``w`` split on
    its input dim, ``x`` on its last): the amaxes and the accumulator are
    reduced over it and every rank returns the whole output. A colwise
    layer (``w`` split on its output dim, ``x`` whole) passes none: its
    local product is this rank's output columns, and its dx a partial sum
    over tp, which the caller reduces (module docstring)."""
    return _QuantizedMatmul.apply(x, w, mode, group)
