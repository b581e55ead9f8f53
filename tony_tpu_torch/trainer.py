"""Train the flagship decoder, ResNet-50 or the MNIST MLP on synthetic data
and report their speed.

``measure`` is the counterpart of ``bench.py``'s ``build_flagship_config``
and ``measure_point``: 16 layers, dim 1024, 8 heads over 4 kv heads
(head_dim 128), mlp 4096, vocab 32000, seq 2048, batch 4, bf16 activations,
f32 params, no remat — about 300 M parameters — trained with AdamW(3e-4) on
``causal_lm_loss``. Attention runs through the CUDA flash kernels. MFU
counts the same FLOPs as ``bench.py`` (6·params + 12·L·dim·S/2 per token,
fwd + bwd, causal) over the card's dense bf16 peak, looked up from its
name.

``measure_vision`` is the counterpart of ``bench.py``'s
``measure_vision_point``: ResNet-50 (bf16 images ``[B, 224, 224, 3]``, 1000
classes, batch 256 in bench) or ``MnistMLP(hidden=128)`` (f32
``[B, 28, 28, 1]``, 10 classes, batch 4096 in bench), trained with
SGD(0.1, momentum 0.9) on ``classification_loss``; every GroupNorm apply of
ResNet runs through the CUDA convfuse kernel. ResNet's MFU counts bench's
3 · 4.089 GFLOPs · (image/224)² per sample.

    python -m tony_tpu_torch.trainer --steps 10                 # flagship
    python -m tony_tpu_torch.trainer --model resnet50 --steps 10
    python -m tony_tpu_torch.trainer --model mnist --steps 20

prints one JSON object with the throughput and MFU.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from tony_tpu_torch._device import resolve_device
from tony_tpu_torch.data import synthetic_lm_batch
from tony_tpu_torch.models.mlp import MnistMLP, classification_loss
from tony_tpu_torch.models.resnet import ResNet, ResNetConfig
from tony_tpu_torch.models.transformer import (Transformer, TransformerConfig,
                                               causal_lm_loss)
from tony_tpu_torch.parallel.train import TrainState, adamw, sgd, train_step

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


def _timed_steps(state: TrainState, batch_of: Callable[[int], Any],
                 steps: int, warmup: int, dev: torch.device):
    """``train_step`` on ``batch_of(s)`` for s < ``steps``: the losses as
    floats and the synchronised seconds of the steps from ``warmup`` on,
    with the device's name and dense bf16 peak (None off the card)."""
    losses = []
    t0 = time.perf_counter()
    for s in range(steps):
        if s == warmup:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
        losses.append(train_step(state, batch_of(s))["loss"])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    peak = peak_bf16(name) if dev.type == "cuda" else None
    return [float(x) for x in losses], dt, name, peak


def _check_steps(steps: int, warmup: int) -> None:
    if not 0 <= warmup < steps:
        raise ValueError(f"need 0 <= warmup ({warmup}) < steps ({steps})")


def measure(cfg: TransformerConfig, batch: int = 4, seq: int = 2048,
            steps: int = 10, warmup: int = 2,
            device: Union[str, torch.device] = "cuda",
            seed: int = 0) -> Dict[str, Any]:
    """Train ``steps`` steps (the first ``warmup`` of them untimed) and
    return losses, tokens/s over the timed steps and MFU. Each step draws
    fresh synthetic tokens for its step number."""
    _check_steps(steps, warmup)
    dev = resolve_device(device)
    state = build_state(cfg, dev, seed)
    n_params = sum(p.numel() for p in state.model.parameters())
    batches = [synthetic_lm_batch(s, batch, seq, cfg.vocab_size, seed=seed,
                                  device=dev) for s in range(steps)]
    losses, dt, name, peak = _timed_steps(state, batches.__getitem__, steps,
                                          warmup, dev)
    tokens_per_sec = batch * seq * (steps - warmup) / dt
    flops_per_token = 6 * n_params + 12 * cfg.n_layers * cfg.dim * seq // 2
    return {
        "losses": losses,
        "tokens_per_sec": tokens_per_sec,
        "mfu_vs_peak_bf16": (tokens_per_sec * flops_per_token / peak
                             if peak else None),
        "step_ms": dt / (steps - warmup) * 1e3,
        "params": n_params, "batch": batch, "seq": seq, "steps": steps,
        "warmup": warmup, "device": name,
    }


# bench.py's vision workloads: SGD(0.1, momentum 0.9); ResNet-50's forward
# FLOPs per 224² image (bench.py:368), scaled by the image area.
VISION_LR, VISION_MOMENTUM = 0.1, 0.9
RESNET50_FWD_FLOPS_224 = 4.089e9
# kind -> (image dtype, classes)
VISION = {"resnet50": (torch.bfloat16, 1000), "mnist": (torch.float32, 10)}


def vision_loss(model, batch):
    return classification_loss(model(batch["images"]), batch["labels"]), {}


def vision_batch(kind: str, step: int, batch: int, image: int = 224,
                 device: Union[str, torch.device] = "cuda",
                 seed: int = 0) -> Dict[str, torch.Tensor]:
    """Step ``step``'s synthetic images (normal) and labels (uniform),
    drawn on ``device`` from a generator seeded from (seed, step)."""
    dev = resolve_device(device)
    dtype, classes = VISION[kind]
    shape = (batch, image, image, 3) if kind == "resnet50" else \
        (batch, 28, 28, 1)
    g = torch.Generator(dev).manual_seed(int(
        np.random.SeedSequence([seed, step]).generate_state(1)[0]))
    return {"images": torch.randn(shape, generator=g, device=dev,
                                  dtype=dtype),
            "labels": torch.randint(0, classes, (batch,), generator=g,
                                    device=dev)}


def build_vision_state(kind: str, device: Union[str, torch.device] = "cuda",
                       seed: int = 0) -> TrainState:
    """ResNet-50 or ``MnistMLP(hidden=128)`` made from ``seed`` on
    ``device``, SGD(0.1, 0.9) and the classification loss."""
    if kind not in VISION:
        raise ValueError(f"unknown vision model {kind!r}: one of "
                         f"{sorted(VISION)}")
    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(seed)
    model = (ResNet(ResNetConfig.resnet50(), device=dev, generator=gen)
             if kind == "resnet50" else
             MnistMLP(hidden=128, device=dev, generator=gen))
    return TrainState(model, sgd(model.parameters(), VISION_LR,
                                 momentum=VISION_MOMENTUM), vision_loss)


def measure_vision(kind: str, batch: int, steps: int, warmup: int = 2,
                   image: int = 224,
                   device: Union[str, torch.device] = "cuda",
                   seed: int = 0) -> Dict[str, Any]:
    """Train ``steps`` steps of ``kind`` ("resnet50" or "mnist"), the
    first ``warmup`` untimed, and return losses, samples/s and step ms over
    the timed steps, and ResNet's MFU. Each step draws its own batch on the
    device inside the timed loop, as bench's scan does."""
    _check_steps(steps, warmup)
    state = build_vision_state(kind, device, seed)
    dev = next(state.model.parameters()).device
    n_params = sum(p.numel() for p in state.model.parameters())
    losses, dt, name, peak = _timed_steps(
        state, lambda s: vision_batch(kind, s, batch, image, dev, seed),
        steps, warmup, dev)
    samples_per_sec = batch * (steps - warmup) / dt
    flops = 3 * RESNET50_FWD_FLOPS_224 * (image / 224) ** 2
    return {
        "kind": kind,
        "losses": losses,
        "samples_per_sec": samples_per_sec,
        "mfu_vs_peak_bf16": (samples_per_sec * flops / peak
                             if peak and kind == "resnet50" else None),
        "step_ms": dt / (steps - warmup) * 1e3,
        "params": n_params, "batch": batch,
        "image": image if kind == "resnet50" else 28, "steps": steps,
        "warmup": warmup, "device": name,
    }


# --model -> bench's batch
DEFAULT_BATCH = {"flagship": 4, "resnet50": 256, "mnist": 4096}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=sorted(DEFAULT_BATCH),
                    default="flagship")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain path")
    a = ap.parse_args(argv)
    batch = DEFAULT_BATCH[a.model]
    if a.model == "flagship":
        out = measure(flagship_config(), batch=batch, steps=a.steps,
                      device=a.device)
    else:
        out = measure_vision(a.model, batch=batch, steps=a.steps,
                             device=a.device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
