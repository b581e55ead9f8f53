"""Build, load and launch the hand-written CUDA kernel of the fused
GroupNorm apply (``tony_tpu_torch/csrc/convfuse_apply.cu``).

Built by ``ops/_build.py`` like the flash kernels, but a family of its own:
``launch_counts`` here counts this kernel only, so a run of the flagship
decoder, which never launches it, leaves the flash family's counts alone.
"""

from __future__ import annotations

from typing import Dict

import torch

from tony_tpu_torch.ops import _build
from tony_tpu_torch.ops._build import I as _I, P as _P

SPECS = {
    # x, a, b, y; B, R, C, dtype, relu; stream
    "convfuse_apply": _build.Kernel("convfuse_apply.cu", "tt_convfuse_apply",
                                    (_P,) * 4 + (_I,) * 5 + (_P,)),
}

# Launches since the last reset (plain integers).
launch_counts: Dict[str, int] = {name: 0 for name in SPECS}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def build() -> Dict[str, object]:
    """Compile (if not yet built) and load the kernel; idempotent."""
    return _build.build(SPECS)


def apply(x3: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
          relu: bool) -> torch.Tensor:
    """x3 [B, R, C] bf16/f32, a/b [B, C] f32 → y [B, R, C] in x3's dtype,
    ``max(x3·a + b, 0)`` (no max when ``relu`` is False)."""
    _build.check_tensor("x", x3, (torch.bfloat16, torch.float32))
    for name, t in (("a", a), ("b", b)):
        _build.check_tensor(name, t, (torch.float32,))
    if x3.dim() != 3:
        raise ValueError(f"x: expected [B, R, C], got {tuple(x3.shape)}")
    bsz, rows, c = x3.shape
    if a.shape != (bsz, c) or b.shape != (bsz, c):
        raise ValueError(f"a {tuple(a.shape)} / b {tuple(b.shape)} must be "
                         f"[B, C] = {(bsz, c)}")
    if a.device != x3.device or b.device != x3.device:
        raise ValueError("x, a and b must be on one device")
    if not (0 < bsz < 65536 and rows > 0 and c > 0 and rows * c < 2**31):
        raise ValueError(f"x {tuple(x3.shape)}: the kernel takes "
                         "0 < B < 65536, R, C > 0 and R·C < 2^31")
    build()
    y = torch.empty_like(x3)
    with torch.cuda.device(x3.device):
        err = _build.fn("convfuse_apply")(
            x3.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(), bsz,
            rows, c, int(x3.dtype == torch.float32), int(relu),
            _build.stream(x3))
    _build.raise_on("convfuse_apply", err)
    launch_counts["convfuse_apply"] += 1
    return y
