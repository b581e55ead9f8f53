"""Device selection shared by the port's entry points.

Every entry point takes ``device="cuda"`` by default and runs on the card.
Without a CUDA device it raises instead of carrying on somewhere else; a
caller that wants the CPU (the parity tests) asks for ``"cpu"``.
"""

from __future__ import annotations

from typing import Union

import torch


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
