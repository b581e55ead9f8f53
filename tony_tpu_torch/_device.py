"""Device selection shared by the port's entry points.

Every entry point takes ``device="cuda"`` by default and runs on the card.
Without a CUDA device it raises instead of carrying on somewhere else; a
caller that wants the CPU (the parity tests) asks for ``"cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

# Dense bf16 peak FLOP/s by device-name fragment (NVIDIA data sheets; the
# SXM part is the one named "H100 80GB HBM3"). The trainers' and
# telemetry's MFU divide by it.
PEAK_BF16 = (
    ("H100 PCIe", 756e12),
    ("H100 NVL", 835e12),
    ("H100", 989e12),
    ("H200", 989e12),
)


def peak_bf16(name: str) -> Optional[float]:
    return next((v for k, v in PEAK_BF16 if k in name), None)


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for, but no CUDA device is "
            "present; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {str(device)!r}: the port "
                           "runs on 'cuda' or, when asked, on 'cpu'")
    return dev
