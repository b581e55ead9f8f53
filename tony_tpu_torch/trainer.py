"""Train the flagship decoder, ResNet-50 or the MNIST MLP and report their
speed; run the training job's own loop.

``measure`` is the counterpart of ``bench.py``'s ``build_flagship_config``
and ``measure_point``: 16 layers, dim 1024, 8 heads over 4 kv heads
(head_dim 128), mlp 4096, vocab 32000, seq 2048, batch 4, bf16 activations,
f32 params, no remat — about 300 M parameters — trained with AdamW(3e-4) on
``causal_lm_loss``. Attention runs through the CUDA flash kernels. MFU
counts the same FLOPs as ``bench.py`` (6·params + 12·L·dim·S/2 per token,
fwd + bwd, causal) over the card's dense bf16 peak, looked up from its
name.

``measure_token_file`` is the counterpart of ``bench.py``'s
``measure_token_file_point``: the same model trained from a 4,000,000-token
uint16 ``.bin`` corpus through the prefetching iterator, the host read and
the copy to the card inside the timed loop.

``train`` is the loop of ``examples/llama3-8b/train_llama3.py`` at any
width: batches from a token file, microbatch accumulation and the bucketed
gradient all-reduce (over the ``torch.distributed`` group when one is up),
AdamW, telemetry step and phase accounting, async checkpoints, and a resume
from the newest verified checkpoint.

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
    python -m tony_tpu_torch.trainer --data corpus.bin --accum 2 \\
        --ckpt-dir ckpt --save-every 50 --steps 200        # the job's loop

prints one JSON object with the throughput and MFU (with ``--data``: the
losses, the resume point and the checkpoint costs).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from tony_tpu_torch import telemetry
from tony_tpu_torch._device import peak_bf16, resolve_device
from tony_tpu_torch.checkpoint import CheckpointManager
from tony_tpu_torch.data import (synthetic_lm_batch, token_file_batches,
                                 write_token_file)
from tony_tpu_torch.models.mlp import MnistMLP, classification_loss
from tony_tpu_torch.models.resnet import ResNet, ResNetConfig
from tony_tpu_torch.models.transformer import (Transformer, TransformerConfig,
                                               causal_lm_loss)
from tony_tpu_torch.parallel.grad_sync import (DEFAULT_BUCKET_MB,
                                               train_step_accum)
from tony_tpu_torch.parallel.train import (TrainState, adamw,
                                           checkpoint_tree,
                                           load_checkpoint_tree, sgd,
                                           train_step)


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


def _phase_cum(name: str) -> float:
    return telemetry.phase_stats().get("cum", {}).get(name, 0.0)


def _timed_steps(state: TrainState, batch_of: Callable[[int], Any],
                 steps: int, warmup: int, dev: torch.device,
                 flops: float = 0.0, tokens: float = 0.0):
    """``train_step`` on ``batch_of(s)`` for s < ``steps``, each inside
    ``telemetry.step``: the losses as floats, the synchronised seconds of
    the steps from ``warmup`` on and the telemetry ``data_wait`` and
    ``h2d`` seconds they booked, with the device's name and dense bf16
    peak (None off the card)."""
    losses = []
    t0 = time.perf_counter()
    phases = ("data_wait", "h2d")
    start = {p: _phase_cum(p) for p in phases}
    for s in range(steps):
        if s == warmup:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            start = {p: _phase_cum(p) for p in phases}
        with telemetry.step(flops=flops, tokens=tokens):
            losses.append(train_step(state, batch_of(s))["loss"])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    peak = peak_bf16(name) if dev.type == "cuda" else None
    return ([float(x) for x in losses], dt,
            {p: _phase_cum(p) - start[p] for p in phases}, name, peak)


def _check_steps(steps: int, warmup: int) -> None:
    if not 0 <= warmup < steps:
        raise ValueError(f"need 0 <= warmup ({warmup}) < steps ({steps})")


def flops_per_token(cfg: TransformerConfig, n_params: int, seq: int) -> int:
    """bench.py's count: 6·params + 12·L·dim·S/2 (fwd + bwd, causal)."""
    return 6 * n_params + 12 * cfg.n_layers * cfg.dim * seq // 2


def _measure_lm(state: TrainState, cfg: TransformerConfig, batch: int,
                seq: int, steps: int, warmup: int, dev: torch.device,
                batch_of: Callable[[int], Any]) -> Dict[str, Any]:
    n_params = sum(p.numel() for p in state.model.parameters())
    fpt = flops_per_token(cfg, n_params, seq)
    losses, dt, wait, name, peak = _timed_steps(
        state, batch_of, steps, warmup, dev, flops=fpt * batch * seq,
        tokens=batch * seq)
    tokens_per_sec = batch * seq * (steps - warmup) / dt
    return {
        "losses": losses,
        "tokens_per_sec": tokens_per_sec,
        "mfu_vs_peak_bf16": tokens_per_sec * fpt / peak if peak else None,
        "step_ms": dt / (steps - warmup) * 1e3,
        "data_wait_s_per_step": wait["data_wait"] / (steps - warmup),
        "h2d_s_per_step": wait["h2d"] / (steps - warmup),
        "params": n_params, "batch": batch, "seq": seq, "steps": steps,
        "warmup": warmup, "device": name,
    }


def measure(cfg: TransformerConfig, batch: int = 4, seq: int = 2048,
            steps: int = 10, warmup: int = 2,
            device: Union[str, torch.device] = "cuda",
            seed: int = 0) -> Dict[str, Any]:
    """Train ``steps`` steps (the first ``warmup`` of them untimed) and
    return losses, tokens/s over the timed steps and MFU. Each step draws
    fresh synthetic tokens for its step number, made before the loop."""
    _check_steps(steps, warmup)
    dev = resolve_device(device)
    state = build_state(cfg, dev, seed)
    batches = [synthetic_lm_batch(s, batch, seq, cfg.vocab_size, seed=seed,
                                  device=dev) for s in range(steps)]
    out = _measure_lm(state, cfg, batch, seq, steps, warmup, dev,
                      batches.__getitem__)
    del out["data_wait_s_per_step"], out["h2d_s_per_step"]
    return out


#: bench.py's token-file corpus: 4,000,000 uint16 ids (8 MB)
CORPUS_TOKENS = 4_000_000


def write_corpus(path: str, vocab_size: int) -> str:
    """``bench.py``'s token-file corpus at ``path``: ``CORPUS_TOKENS``
    uniform ids below ``vocab_size`` from ``np.random.default_rng(0)``, as
    uint16."""
    corpus = np.random.default_rng(0).integers(
        0, vocab_size, size=CORPUS_TOKENS, dtype=np.int64)
    return write_token_file(path, corpus, dtype=np.uint16)


def measure_token_file(cfg: TransformerConfig, batch: int = 4,
                       seq: int = 2048, steps: int = 10, warmup: int = 2,
                       device: Union[str, torch.device] = "cuda",
                       seed: int = 0, prefetch: int = 2) -> Dict[str, Any]:
    """``measure`` fed from a token file: the corpus of ``write_corpus`` in
    a temporary directory (removed at the end), read through
    ``token_file_batches`` with ``prefetch`` batches in flight (0 = read on
    the training thread), the read and the copy to the card inside the
    timed loop. Returns ``measure``'s keys plus the telemetry
    ``data_wait`` and ``h2d`` seconds per timed step
    (``data_wait_s_per_step``, ``h2d_s_per_step``)."""
    _check_steps(steps, warmup)
    dev = resolve_device(device)
    state = build_state(cfg, dev, seed)
    tmp = tempfile.mkdtemp(prefix="tony-torch-tok-")
    it = None
    try:
        path = write_corpus(os.path.join(tmp, "corpus.bin"), cfg.vocab_size)
        it = token_file_batches(path, batch, seq, seed=seed, device=dev,
                                prefetch=prefetch)
        out = _measure_lm(state, cfg, batch, seq, steps, warmup, dev,
                          lambda s: next(it))
    finally:
        if it is not None:
            it.close()
        shutil.rmtree(tmp, ignore_errors=True)
    out["prefetch"] = prefetch
    return out


def train(cfg: TransformerConfig, data_path: str, batch: int = 4,
          seq: int = 2048, steps: int = 10, accum_steps: int = 1,
          bucket_mb: int = DEFAULT_BUCKET_MB, ckpt_dir: Optional[str] = None,
          save_interval: int = 1, max_to_keep: int = 3,
          device: Union[str, torch.device] = "cuda",
          seed: int = 0) -> Dict[str, Any]:
    """The training job's loop, steps ``start..steps-1`` of a job of
    ``steps`` optimizer steps.

    The model is made from ``seed``; with ``ckpt_dir`` holding a
    checkpoint, the newest verified one is restored into it (parameters,
    Adam moments, step count) and the loop resumes after it: the
    checkpoint saved after iteration i holds step count i + 1, and the loop
    starts there. Each iteration reads this process's rows of the global
    ``batch`` from the token file at ``data_path`` (the stream of a resumed
    job is the uninterrupted one's), runs ``train_step_accum`` with
    ``accum_steps`` microbatches and ``bucket_mb``-MiB buckets over the
    ``torch.distributed`` group when one is up, inside ``telemetry.step``,
    then offers the state to the checkpoint manager (``save_interval``
    policy, ``max_to_keep`` retention; the last step is always saved; in a
    group, rank 0 saves). The manager is drained at the end.

    Returns the losses of the steps run, ``start_step``, the restored
    step and restore seconds (None without a restore), the training
    thread's stall per saved step, the writer's seconds per committed step,
    ``coalesced_saves``, ``async_errors``, the bytes of the newest
    checkpoint, tokens/s over the loop and the final ``state``."""
    dev = resolve_device(device)
    state = build_state(cfg, dev, seed)
    dist = torch.distributed
    group = dist.group.WORLD if (dist.is_available()
                                 and dist.is_initialized()) else None
    rank = dist.get_rank() if group is not None else 0
    mgr = CheckpointManager(ckpt_dir, max_to_keep=max_to_keep,
                            save_interval_steps=save_interval) \
        if ckpt_dir else None
    n_params = sum(p.numel() for p in state.model.parameters())
    flops = flops_per_token(cfg, n_params, seq) * batch * seq
    start, restored, restore_s = 0, None, None
    losses = []
    it = None
    try:
        if mgr is not None and mgr.latest_step() is not None:
            t0 = time.perf_counter()
            tree = mgr.restore(None, checkpoint_tree(state))
            load_checkpoint_tree(state, tree)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            restore_s = time.perf_counter() - t0
            start = state.step
            restored = start - 1
        it = token_file_batches(data_path, batch, seq, seed=seed,
                                start_step=start, device=dev)
        t0 = time.perf_counter()
        for i in range(start, steps):
            with telemetry.step(flops=flops, tokens=batch * seq):
                m = train_step_accum(state, next(it), accum_steps,
                                     bucket_mb, group)
            losses.append(m["loss"])
            if mgr is not None and rank == 0 and (i == steps - 1
                                                  or mgr.should_save(i)):
                mgr.save(i, checkpoint_tree(state), force=True)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        if mgr is not None:
            mgr.wait()
    finally:
        if it is not None:
            it.close()
        if mgr is not None:
            mgr.close()
    out: Dict[str, Any] = {
        "losses": [float(x) for x in losses], "start_step": start,
        "steps": steps, "restored_step": restored, "restore_s": restore_s,
        "tokens_per_sec": (batch * seq * len(losses) / wall
                           if losses else None),
        "accum_steps": accum_steps, "bucket_mb": bucket_mb,
        "world": dist.get_world_size() if group is not None else 1,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "state": state,
    }
    if mgr is not None:
        latest = mgr.latest_step()
        out.update(
            save_stall_s=dict(mgr.stall_s), write_s=dict(mgr.write_s),
            coalesced_saves=mgr.coalesced_saves,
            async_errors=list(mgr.async_errors), latest_step=latest,
            checkpoint_bytes=(mgr.step_bytes(latest)
                              if latest is not None else None))
    return out


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
    losses, dt, _, name, peak = _timed_steps(
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
    ap.add_argument("--data", help="token file (uint16 .bin): run the "
                    "training job's loop on the flagship from it")
    ap.add_argument("--accum", type=int, default=1,
                    help="microbatches per optimizer step (with --data)")
    ap.add_argument("--bucket-mb", type=int, default=DEFAULT_BUCKET_MB,
                    help="gradient all-reduce bucket size (with --data)")
    ap.add_argument("--ckpt-dir", help="checkpoint directory: resume from "
                    "it and save into it (with --data)")
    ap.add_argument("--save-every", type=int, default=1,
                    help="save interval in steps (with --ckpt-dir)")
    a = ap.parse_args(argv)
    batch = DEFAULT_BATCH[a.model]
    if a.data:
        if a.model != "flagship":
            ap.error("--data trains the flagship decoder")
        out = train(flagship_config(), a.data, batch=batch, steps=a.steps,
                    accum_steps=a.accum, bucket_mb=a.bucket_mb,
                    ckpt_dir=a.ckpt_dir, save_interval=a.save_every,
                    device=a.device)
        del out["state"]
    elif a.model == "flagship":
        out = measure(flagship_config(), batch=batch, steps=a.steps,
                      device=a.device)
    else:
        out = measure_vision(a.model, batch=batch, steps=a.steps,
                             device=a.device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
