"""Train the flagship decoder on synthetic tokens and report its speed.

Counterpart of ``bench.py``'s ``build_flagship_config`` and
``measure_point``: 16 layers, dim 1024, 8 heads over 4 kv heads (head_dim
128), mlp 4096, vocab 32000, seq 2048, batch 4, bf16 activations, f32
params, no remat — about 300 M parameters — trained with AdamW(3e-4) on
``causal_lm_loss``. Attention runs through the CUDA flash kernels.

    python -m tony_tpu_torch.trainer --steps 10

prints one JSON object with tokens/s and MFU. MFU counts the same FLOPs as
``bench.py`` (6·params + 12·L·dim·S/2 per token, fwd + bwd, causal) over
the card's dense bf16 peak, looked up from its name.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, Optional, Union

import torch

from tony_tpu_torch._device import resolve_device
from tony_tpu_torch.data import synthetic_lm_batch
from tony_tpu_torch.models.transformer import (Transformer, TransformerConfig,
                                               causal_lm_loss)
from tony_tpu_torch.parallel.train import TrainState, adamw, train_step

# Dense bf16 peak FLOP/s by device-name fragment (NVIDIA data sheets; the
# SXM part is the one named "H100 80GB HBM3").
PEAK_BF16 = (
    ("H100 PCIe", 756e12),
    ("H100 NVL", 835e12),
    ("H100", 989e12),
    ("H200", 989e12),
)


def peak_bf16(name: str) -> Optional[float]:
    return next((v for k, v in PEAK_BF16 if k in name), None)


LEARNING_RATE = 3e-4    # bench.py's optax.adamw(3e-4)


def flagship_config(seq: int = 2048) -> TransformerConfig:
    return TransformerConfig(
        vocab_size=32000, dim=1024, n_layers=16, n_heads=8,
        n_kv_heads=4, mlp_dim=4096, max_seq_len=seq, remat=False)


def lm_loss(model, batch):
    tokens = batch["tokens"]
    return causal_lm_loss(model(tokens), tokens), {}


def build_state(cfg: TransformerConfig,
                device: Union[str, torch.device] = "cuda",
                seed: int = 0) -> TrainState:
    """The model made from ``seed`` on ``device``, AdamW and the LM loss."""
    dev = resolve_device(device)
    model = Transformer(cfg, device=dev,
                        generator=torch.Generator(dev).manual_seed(seed))
    return TrainState(model, adamw(model.parameters(), LEARNING_RATE),
                      lm_loss)


def measure(cfg: TransformerConfig, batch: int = 4, seq: int = 2048,
            steps: int = 10, warmup: int = 2,
            device: Union[str, torch.device] = "cuda",
            seed: int = 0) -> Dict[str, Any]:
    """Train ``steps`` steps (the first ``warmup`` of them untimed) and
    return losses, tokens/s over the timed steps and MFU. Each step draws
    fresh synthetic tokens for its step number."""
    if not 0 <= warmup < steps:
        raise ValueError(f"need 0 <= warmup ({warmup}) < steps ({steps})")
    dev = resolve_device(device)
    state = build_state(cfg, dev, seed)
    n_params = sum(p.numel() for p in state.model.parameters())
    batches = [synthetic_lm_batch(s, batch, seq, cfg.vocab_size, seed=seed,
                                  device=dev) for s in range(steps)]
    losses = []
    t0 = time.perf_counter()
    for s in range(steps):
        if s == warmup:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
        losses.append(train_step(state, batches[s])["loss"])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    tokens_per_sec = batch * seq * (steps - warmup) / dt
    flops_per_token = 6 * n_params + 12 * cfg.n_layers * cfg.dim * seq // 2
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    peak = peak_bf16(name) if dev.type == "cuda" else None
    return {
        "losses": [float(x) for x in losses],
        "tokens_per_sec": tokens_per_sec,
        "mfu_vs_peak_bf16": (tokens_per_sec * flops_per_token / peak
                             if peak else None),
        "step_ms": dt / (steps - warmup) * 1e3,
        "params": n_params, "batch": batch, "seq": seq, "steps": steps,
        "warmup": warmup, "device": name,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain path")
    a = ap.parse_args(argv)
    out = measure(flagship_config(), steps=a.steps, device=a.device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
