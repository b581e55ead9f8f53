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
"""

from __future__ import annotations

import functools
import logging
import threading
from typing import Dict, Optional, Union

import torch

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
    qmax = _INT8_MAX if mode == INT8 else _FP8_E4M3_MAX
    xf = x.float()
    amax = xf.abs().amax(dim=axis, keepdim=True)
    # A tensor divisor: CUDA divides by a Python scalar as a multiply by
    # its reciprocal, one ulp away from the reference's division.
    scale = amax.clamp_min(_EPS) / amax.new_full((), qmax)
    y = xf / scale
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


def _qmm_forward(x: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """The quantized contraction ``x [..., K] @ w [N, K]ᵀ`` with per-row /
    per-output-channel scales."""
    qx, sx = quantize_symmetric(x, mode, axis=-1)       # sx [..., 1]
    qw, sw = quantize_symmetric(w, mode, axis=-1)       # sw [N, 1]
    n, k = w.shape
    acc = _product(qx.reshape(-1, k), qw, mode)
    if x.is_cuda:
        launch_counts[mode] += 1
    acc = acc.float().reshape(*x.shape[:-1], n)
    out = acc * sx * sw.reshape(n)
    return out.to(x.dtype)


class _QuantizedMatmul(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, mode):
        ctx.save_for_backward(x, w)
        return _qmm_forward(x, w, mode)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = g @ w                                       # [..., K]
        dw = g.reshape(-1, g.shape[-1]).t() @ x.reshape(-1, x.shape[-1])
        return dx.to(x.dtype), dw.to(w.dtype), None


def quantized_matmul(x: torch.Tensor, w: torch.Tensor,
                     mode: str) -> torch.Tensor:
    """``x @ w.T`` (``w`` is ``[out, in]``) through the quantized path;
    gradients are the exact full-precision ones (straight-through)."""
    return _QuantizedMatmul.apply(x, w, mode)
