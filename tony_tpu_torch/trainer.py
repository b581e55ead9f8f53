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

``measure(chunked=True, loss_chunk=C)`` is bench's long-context path: the
model returns its final-norm hidden states and ``chunked_causal_lm_loss``
takes the cross-entropy over ``lm_head`` in sequence chunks of C, so the
``[B, S, vocab]`` logits never exist (``bench.py:255-263``). Bench's
decoder points on one chip, one command each:

    python -m tony_tpu_torch.trainer                            # 4 × 2048
    python -m tony_tpu_torch.trainer --matmul-dtype int8        # headline
    python -m tony_tpu_torch.trainer --seq 8192 --chunked       # 4 × 8192
    python -m tony_tpu_torch.trainer --seq 32768 --chunked      # 1 × 32768
    python -m tony_tpu_torch.trainer --model flagship_remat     # 8 × 8192
    python -m tony_tpu_torch.trainer --model big                # 0.95B

``--seq`` picks bench's batch and loss chunk for that length (4 and 2048
at 8192, 1 and 8192 at 32768); ``flagship_remat`` checkpoints every other
layer (``remat_skip_every=2``) and ``big`` is the 0.95B point, trained
with a bf16 Adam first moment (``mu_dtype``); both take the chunked loss.

``measure_token_file`` is the counterpart of ``bench.py``'s
``measure_token_file_point``: the same model trained from a 4,000,000-token
uint16 ``.bin`` corpus through the prefetching iterator, the host read and
the copy to the card inside the timed loop.

``train`` is the loop of ``examples/llama3-8b/train_llama3.py`` at any
width: batches from a token file (uint32 ids for a vocabulary past 65,536,
as Llama-3's 128,256), the whole or the chunked loss (the example's
``_loss_on``: chunked at seq >= 8192, chunks of 2048), microbatch
accumulation and the bucketed gradient all-reduce (over the
``torch.distributed`` group when one is up), AdamW with the job's weight
decay, telemetry step and phase accounting, async checkpoints, and a
resume from the newest verified checkpoint. ``--model llama3_8b`` is the
example's own job: ``TransformerConfig.llama3_8b`` under
``remat_policy="dots_with_no_batch_dims_saveable"``, batch 8 × seq 8192,
the chunked loss and AdamW(3e-4, weight decay 0.1); ``--accum``,
``--bucket-mb`` and ``--matmul-dtype`` are its ``LLAMA_ACCUM_STEPS``,
``LLAMA_BUCKET_MB`` and ``LLAMA_MATMUL_DTYPE``, and ``--mesh
"dp=1,fsdp=-1,tp=4"`` its ``MeshSpec(dp=1, fsdp=-1, tp=TP)``. All 32
layers (about 8.0 B parameters, ~128 GB of f32 parameters, gradients and
Adam moments) need several cards under such a mesh; one card trains the
full width at a cut depth, which the Python API sets
(``dataclasses.replace(llama3_8b_config(), n_layers=2)``):

    python -m tony_tpu_torch.trainer --model llama3_8b --data corpus.bin \\
        --mesh "dp=1,fsdp=-1,tp=4" --ckpt-dir ckpt    # one process a card

``measure(..., mesh="fsdp=1")`` and ``train(..., mesh=...)`` run the same
steps on a ``DeviceMesh`` (``parallel/mesh.py``): the state from
``init_sharded_state`` (the tensor-parallel plan, then FSDP2), each step
``sharded_train_step``, each rank's rows those of its batch coordinate, and
sharded checkpoints written by every rank. With no process group up, a
mesh that resolves to one rank brings up a one-rank group (NCCL on the
card) for the call; a larger mesh needs the caller's group
(``torchrun``-style, one process per card). A mesh with ``sp`` > 1 needs
``--attn-impl ring`` or ``ulysses`` (sequence-parallel attention over the
sp group; ``TransformerConfig.attn_impl``).

``measure_vision`` is the counterpart of ``bench.py``'s
``measure_vision_point``: ResNet-50 (bf16 images ``[B, 224, 224, 3]``, 1000
classes, batch 256 in bench) or ``MnistMLP(hidden=128)`` (f32
``[B, 28, 28, 1]``, 10 classes, batch 4096 in bench), trained with
SGD(0.1, momentum 0.9) on ``classification_loss``; every GroupNorm apply of
ResNet runs through the CUDA convfuse kernel. ResNet's MFU counts bench's
3 · 4.089 GFLOPs · (image/224)² per sample. ``measure_vision(...,
mesh="fsdp=1")`` trains either on a mesh, the counterpart of
``examples/resnet/resnet_fsdp.py`` and ``examples/mnist-jax/mnist_dp.py``
(ResNet's convs over tp on their out channels, the MLP colwise, rowwise,
colwise; ``parallel/sharding.py``).

    python -m tony_tpu_torch.trainer --steps 10                 # flagship
    python -m tony_tpu_torch.trainer --model resnet50 --steps 10
    python -m tony_tpu_torch.trainer --model mnist --steps 20
    python -m tony_tpu_torch.trainer --data corpus.bin --accum 2 \\
        --ckpt-dir ckpt --save-every 50 --steps 200        # the job's loop
    python -m tony_tpu_torch.trainer --mesh "fsdp=1"       # on a mesh
    python -m tony_tpu_torch.trainer --mesh "fsdp=1" --attn-impl ring
    python -m tony_tpu_torch.trainer --mesh "fsdp=1" --matmul-dtype int8
    python -m tony_tpu_torch.trainer --model resnet50 --mesh "fsdp=1"

prints one JSON object with the throughput and MFU (with ``--data``: the
losses, the resume point and the checkpoint costs), each kernel's launches
per step (``launches_per_step``) and the wall times of the start-up
(``startup_ts``: the package's import and ``main`` began;
``first_step_start_ts``: the first step began).

Submitted as a job's command (``python -m tony_tpu_torch.cli submit``),
the trainer runs under the executor's rendezvous env: ``--mesh`` then
joins the gang's group through ``env://`` (``mesh_scope``), ``--ckpt-dir``
defaults to ``$TONY_CHECKPOINT_DIR`` (a job's
``tony.application.checkpoint-dir``, a path or a ``gs://`` URL), and the
final step count and device memory are published to the executor's
telemetry file before the process exits.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch
from torch import nn

import tony_tpu_torch
from tony_tpu_torch import constants, telemetry
from tony_tpu_torch._device import peak_bf16, resolve_device
from tony_tpu_torch.checkpoint import CheckpointManager
from tony_tpu_torch.data import (process_batch_slice, synthetic_lm_batch,
                                 token_file_batches,
                                 write_token_file)
from tony_tpu_torch.models.mlp import MnistMLP, classification_loss
from tony_tpu_torch.models.moe import MoEConfig, MoETransformer, moe_lm_loss
from tony_tpu_torch.models.resnet import ResNet, ResNetConfig
from tony_tpu_torch.models.transformer import (Transformer, TransformerConfig,
                                               causal_lm_loss)
from tony_tpu_torch.ops import _convfuse_cuda, _flash_cuda, quant
from tony_tpu_torch.parallel.grad_sync import (DEFAULT_BUCKET_MB,
                                               train_step_accum)
from tony_tpu_torch.parallel.mesh import (MeshSpec, build_mesh, in_gang,
                                         mesh_shape, process_group)
from tony_tpu_torch.parallel.pipeline import (PipelineTransformer,
                                              pipeline_shard)
from tony_tpu_torch.parallel.sharding import shard_model
from tony_tpu_torch.parallel.train import (TrainState, adamw,
                                           checkpoint_tree,
                                           init_sharded_state,
                                           load_checkpoint_tree, sgd,
                                           sharded_train_step, train_step)


LEARNING_RATE = 3e-4    # bench.py's optax.adamw(3e-4)
ADAMW_WEIGHT_DECAY = 1e-4   # optax.adamw's default
# examples/llama3-8b/train_llama3.py: LLAMA_BATCH, LLAMA_SEQ,
# LLAMA_LOSS_CHUNK (the chunked loss at seq >= LLAMA_CHUNKED_FROM) and its
# optax.adamw(3e-4, weight_decay=0.1).
LLAMA_BATCH, LLAMA_SEQ, LLAMA_LOSS_CHUNK = 8, 8192, 2048
LLAMA_CHUNKED_FROM = 8192
LLAMA_WEIGHT_DECAY = 0.1


def flagship_config(seq: int = 2048,
                    matmul_dtype: Optional[str] = None) -> TransformerConfig:
    """``bench.py:190-212``'s flagship (``build_flagship_config``)."""
    return TransformerConfig(
        vocab_size=32000, dim=1024, n_layers=16, n_heads=8,
        n_kv_heads=4, mlp_dim=4096, max_seq_len=seq, remat=False,
        matmul_dtype=matmul_dtype)


def flagship_remat_config(seq: int = 8192) -> TransformerConfig:
    """``bench.py:1173-1176``'s 8×8192 point: the flagship with selective
    remat, every other layer checkpointed."""
    return TransformerConfig(
        vocab_size=32000, dim=1024, n_layers=16, n_heads=8,
        n_kv_heads=4, mlp_dim=4096, max_seq_len=seq, remat=True,
        remat_skip_every=2)


def llama3_8b_config(seq: int = LLAMA_SEQ) -> TransformerConfig:
    """``examples/llama3-8b/train_llama3.py:52-59``: the Llama-3-8B
    geometry under the selective remat policy, its RoPE bound the longer of
    ``seq`` and Llama-3's 8192."""
    return TransformerConfig.llama3_8b(
        remat=True, remat_policy="dots_with_no_batch_dims_saveable",
        max_seq_len=max(seq, 8192))


def big_config(seq: int = 2048) -> TransformerConfig:
    """``bench.py:1233-1236``'s 0.95B point: dim 1536, 24 layers, 12 / 6
    heads (head_dim 128), mlp 6144, selective remat."""
    return TransformerConfig(
        vocab_size=32000, dim=1536, n_layers=24, n_heads=12,
        n_kv_heads=6, mlp_dim=6144, max_seq_len=seq, remat=True,
        remat_skip_every=2)


def lm_loss(model, batch):
    tokens = batch["tokens"]
    return causal_lm_loss(model(tokens), tokens), {}


def moe_loss(model, batch):
    """``moe_lm_loss``: the cross-entropy plus the model's aux-loss weight
    times its aux loss."""
    tokens = batch["tokens"]
    return moe_lm_loss(model(tokens), tokens, model.cfg.aux_loss_weight), {}


def chunked_lm_loss(model, batch, loss_chunk: int = 2048):
    """``bench.py:255-263``: the final-norm hidden states through
    ``chunked_causal_lm_loss`` over the LM head in ``loss_chunk`` chunks,
    inside the model's forward (``Transformer(..., loss_chunk=)``), where a
    sharded model's head is whole."""
    return model(batch["tokens"], loss_chunk=loss_chunk), {}


def build_state(cfg: TransformerConfig,
                device: Union[str, torch.device] = "cuda",
                seed: int = 0, chunked: bool = False,
                loss_chunk: int = 2048,
                mu_dtype: Optional[torch.dtype] = None,
                mesh: Any = None,
                model: Optional[Callable[..., nn.Module]] = None,
                weight_decay: float = ADAMW_WEIGHT_DECAY
                ) -> TrainState:
    """The model made from ``seed`` on ``device``, AdamW (first moment in
    ``mu_dtype``, None: the parameter's; ``weight_decay``, optax's default
    unless given) and the LM loss (chunked over
    ``loss_chunk`` positions with ``chunked``). ``model`` builds the
    decoder as ``model(cfg, device=, generator=)``: the sequential
    ``Transformer`` (the default), ``MoETransformer`` (the default for a
    ``MoEConfig``, trained on ``moe_loss``; not chunked), or the pipelined
    decoder of ``parallel/pipeline.py``
    (``functools.partial(PipelineTransformer, num_microbatches=M)``: the
    GPipe schedule over the mesh's pp, its f32 head, the whole loss only).
    With ``mesh`` (a ``DeviceMesh`` on ``device``'s kind) the state is
    ``init_sharded_state``'s, with the same values, laid out by
    ``shard_model`` or, for the pipelined decoder, ``pipeline_shard``."""
    dev = resolve_device(device)
    moe = isinstance(cfg, MoEConfig)
    model = model or (MoETransformer if moe else Transformer)
    if moe and chunked:
        raise ValueError("the MoE decoder takes the whole loss, not the "
                         "chunked one")
    loss = (functools.partial(chunked_lm_loss, loss_chunk=loss_chunk)
            if chunked else moe_loss if moe else lm_loss)

    def build(device, generator=None):
        built = model(cfg, device=device, generator=generator)
        if chunked and isinstance(built, PipelineTransformer):
            raise ValueError("the pipelined decoder takes the whole loss, "
                             "not the chunked one")
        return built

    def optimizer(params):
        return adamw(params, LEARNING_RATE, weight_decay=weight_decay,
                     mu_dtype=mu_dtype)

    if mesh is not None:
        state, _ = init_sharded_state(
            lambda d: build(device=d), optimizer, mesh, seed=seed,
            layout=_layout)
        state.loss_fn = loss
        return state
    built = build(dev, torch.Generator(dev).manual_seed(seed))
    return TrainState(built, optimizer(built.parameters()), loss)


def _layout(model: nn.Module, mesh: Any) -> Any:
    """``model`` laid out on ``mesh``: the pipelined decoder by
    ``pipeline_shard``, any other by ``shard_model``."""
    if isinstance(model, PipelineTransformer):
        return pipeline_shard(model, mesh)
    return shard_model(model, mesh)


@contextlib.contextmanager
def mesh_scope(mesh: str, device: torch.device):
    """The ``DeviceMesh`` of the spec string ``mesh`` (``"fsdp=2,tp=2"``;
    "" yields None) over the process group (``parallel.mesh.process_group``:
    the one up, a gang's through ``env://`` where the process has the
    rendezvous env, else a one-rank group, which the spec must resolve
    to). A group brought up here is taken down on exit."""
    if not mesh:
        yield None
        return
    spec = MeshSpec.from_string(mesh)
    if not torch.distributed.is_initialized() and not in_gang():
        spec.resolve(1)
    with process_group(device):
        yield build_mesh(spec, device.type)


def step_fn(mesh: Any) -> Callable[[TrainState, Any], Dict[str, Any]]:
    """``train_step``, or on ``mesh`` ``sharded_train_step``'s metrics."""
    if mesh is None:
        return train_step
    return lambda state, batch: sharded_train_step(
        state.loss_fn, mesh, state, batch)[1]


def _phase_cum(name: str) -> float:
    return telemetry.phase_stats().get("cum", {}).get(name, 0.0)


def _timed_steps(state: TrainState, batch_of: Callable[[int], Any],
                 steps: int, warmup: int, dev: torch.device,
                 flops: float = 0.0, tokens: float = 0.0,
                 step: Callable[[TrainState, Any], Any] = train_step):
    """``step`` (``train_step``) on ``batch_of(s)`` for s < ``steps``, each inside
    ``telemetry.step``: the losses as floats, the synchronised seconds of
    the steps from ``warmup`` on and the telemetry ``data_wait`` and
    ``h2d`` seconds they booked, with the device's name and dense bf16
    peak (None off the card), the wall time the first step began, and the
    host's seconds of each step with the steps an on-demand capture
    (``cli profile``) recorded: ``{"step_s": [...], "profiled_steps":
    [...]}``. A step's host seconds include the card's wait whenever the
    launch queue is full, and the capture's stop and export land in the
    last step it recorded."""
    losses = []
    t0 = time.perf_counter()
    first_ts = time.time()
    phases = ("data_wait", "h2d")
    start = {p: _phase_cum(p) for p in phases}
    walls = {"step_s": [], "profiled_steps": []}
    for s in range(steps):
        if s == warmup:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            start = {p: _phase_cum(p) for p in phases}
        prof = telemetry.profile_state()
        if prof is not None and prof.get("status") == "active":
            walls["profiled_steps"].append(s)
        ts = time.perf_counter()
        with telemetry.step(flops=flops, tokens=tokens):
            losses.append(step(state, batch_of(s))["loss"])
        walls["step_s"].append(time.perf_counter() - ts)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    peak = peak_bf16(name) if dev.type == "cuda" else None
    return ([float(x) for x in losses], dt,
            {p: _phase_cum(p) - start[p] for p in phases}, name, peak,
            first_ts, walls)


def _check_steps(steps: int, warmup: int) -> None:
    if not 0 <= warmup < steps:
        raise ValueError(f"need 0 <= warmup ({warmup}) < steps ({steps})")


def flops_per_token(cfg: TransformerConfig, n_params: int, seq: int) -> int:
    """bench.py's count: 6·params + 12·L·dim·S/2 (fwd + bwd, causal)."""
    return 6 * n_params + 12 * cfg.n_layers * cfg.dim * seq // 2


def _measure_lm(state: TrainState, cfg: TransformerConfig, batch: int,
                seq: int, steps: int, warmup: int, dev: torch.device,
                batch_of: Callable[[int], Any],
                mesh: Any = None) -> Dict[str, Any]:
    n_params = sum(p.numel() for p in state.model.parameters())
    fpt = flops_per_token(cfg, n_params, seq)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, dt, wait, name, peak, first_ts, walls = _timed_steps(
        state, batch_of, steps, warmup, dev, flops=fpt * batch * seq,
        tokens=batch * seq, step=step_fn(mesh))
    tokens_per_sec = batch * seq * (steps - warmup) / dt
    return {
        "losses": losses,
        "tokens_per_sec": tokens_per_sec,
        "mfu_vs_peak_bf16": tokens_per_sec * fpt / peak if peak else None,
        "step_ms": dt / (steps - warmup) * 1e3,
        "data_wait_s_per_step": wait["data_wait"] / (steps - warmup),
        "h2d_s_per_step": wait["h2d"] / (steps - warmup),
        "params": n_params, "batch": batch, "seq": seq, "steps": steps,
        "warmup": warmup, "device": name, "first_step_start_ts": first_ts,
        "mesh": mesh_shape(mesh) if mesh is not None else None,
        # The parameters, moments and the steps' peak, on the card.
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
        **walls,
    }


def measure(cfg: TransformerConfig, batch: int = 4, seq: int = 2048,
            steps: int = 10, warmup: int = 2,
            device: Union[str, torch.device] = "cuda",
            seed: int = 0, chunked: bool = False, loss_chunk: int = 2048,
            mu_dtype: Optional[torch.dtype] = None,
            mesh: str = "",
            model: Optional[Callable[..., nn.Module]] = None,
            weight_decay: float = ADAMW_WEIGHT_DECAY
            ) -> Dict[str, Any]:
    """Train ``steps`` steps (the first ``warmup`` of them untimed) and
    return losses, tokens/s over the timed steps, MFU and, on the card, the
    peak of allocated memory (``peak_memory_bytes``). Each step draws fresh
    synthetic tokens for its step number, made before the loop. ``chunked``,
    ``loss_chunk`` and ``mu_dtype`` are ``bench.py``'s ``measure_point``
    options (see ``build_state``). ``mesh`` (``"fsdp=1"``, see
    ``mesh_scope``) trains the sharded state with ``sharded_train_step``:
    ``batch`` is then the global batch, each rank's rows its batch
    coordinate's, and the losses the global batch's. ``model`` builds the
    decoder (see ``build_state``: the MoE decoder for a ``MoEConfig``; the
    pipelined one runs over the mesh's pp, ``mesh="pp=..."``). Any of them
    takes a mesh, the quantized (``matmul_dtype``) and tied
    (``tie_embeddings``) decoders under its tensor-parallel plan too.
    ``weight_decay`` is AdamW's (optax's default unless given)."""
    _check_steps(steps, warmup)
    dev = resolve_device(device)
    with mesh_scope(mesh, dev) as m:
        state = build_state(cfg, dev, seed, chunked, loss_chunk, mu_dtype,
                            mesh=m, model=model, weight_decay=weight_decay)
        batches = [synthetic_lm_batch(s, batch, seq, cfg.vocab_size,
                                      seed=seed, device=dev, mesh=m)
                   for s in range(steps)]
        out = _measure_lm(state, cfg, batch, seq, steps, warmup, dev,
                          batches.__getitem__, m)
    del out["data_wait_s_per_step"], out["h2d_s_per_step"]
    return out


#: bench.py's token-file corpus: 4,000,000 uint16 ids (8 MB)
CORPUS_TOKENS = 4_000_000


def token_dtype(vocab_size: int, dtype: Any = None) -> Any:
    """The ids' dtype in a token file of a ``vocab_size`` vocabulary:
    uint16 up to 65,536 ids, uint32 past it (``data.write_token_file``
    refuses such ids in uint16). A ``dtype`` too narrow for the
    vocabulary raises: a uint32 file read as uint16 is pairs of wrong
    ids, with no error."""
    need = np.dtype(np.uint16 if vocab_size <= 1 << 16 else np.uint32)
    if dtype is None:
        return need
    if np.iinfo(dtype).max < vocab_size - 1:
        raise ValueError(
            f"a {np.dtype(dtype)} token file cannot hold the ids of a "
            f"{vocab_size}-id vocabulary: read it as {need}")
    return np.dtype(dtype)


def write_corpus(path: str, vocab_size: int) -> str:
    """``bench.py``'s token-file corpus at ``path``: ``CORPUS_TOKENS``
    uniform ids below ``vocab_size`` from ``np.random.default_rng(0)``, as
    ``token_dtype(vocab_size)`` (uint16, uint32 past 65,536 ids)."""
    corpus = np.random.default_rng(0).integers(
        0, vocab_size, size=CORPUS_TOKENS, dtype=np.int64)
    return write_token_file(path, corpus, dtype=token_dtype(vocab_size))


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
        it = token_file_batches(path, batch, seq,
                                dtype=token_dtype(cfg.vocab_size), seed=seed,
                                device=dev, prefetch=prefetch)
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
          seed: int = 0, mesh: str = "", chunked: bool = False,
          loss_chunk: int = 2048,
          weight_decay: float = ADAMW_WEIGHT_DECAY,
          mu_dtype: Optional[torch.dtype] = None,
          dtype: Any = None) -> Dict[str, Any]:
    """The training job's loop, steps ``start..steps-1`` of a job of
    ``steps`` optimizer steps.

    The state is ``build_state``'s: the model made from ``seed``, AdamW
    with ``weight_decay`` (optax's default unless given; the Llama-3-8B
    example's is 0.1) and a first moment in ``mu_dtype``, the loss chunked
    over ``loss_chunk`` positions with ``chunked`` (the example's
    ``_loss_on``). The token file holds ids of ``dtype``, by default
    ``token_dtype(cfg.vocab_size)``: uint32 past 65,536 ids, and a
    narrower ``dtype`` raises. With ``ckpt_dir`` holding a
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

    ``ckpt_dir`` is a local path or a ``gs://`` URL (``CheckpointManager``).
    With it the loop also obeys the drain contract it is launched under
    (an elastic resize or a migration TERMs the process and expects one
    final save): once its first step is done it installs the manager's
    SIGTERM handler for the rest of the loop. The step updates the state
    in place, and the step's save may import and wait for the writer, so
    each iteration (batch, step, save) runs inside ``mgr.updating()``: a
    TERM landing in it is deferred to the step's boundary, and the final
    save holds the state after the last whole step with its step count.
    The process then exits 143. In a group of several processes, ranks
    that each acted on the TERM at their own step would meet in different
    collectives (a save's barrier, a step's). So there a TERM only marks
    the rank, and at each step's boundary the ranks all-reduce the marks
    over a gloo group on the host (``CheckpointManager.preemption_point``;
    it never enters the card's stream): after the same step they all see
    the TERM and save that step together.

    With ``mesh`` (see ``mesh_scope``) the state is sharded: each rank
    reads its batch coordinate's rows, the step is ``train_step_accum`` on
    the mesh (FSDP2 and the explicit ``dcn_dp`` sync), every rank saves
    its shards with the mesh's shape in the manifest, and a resume
    restores them onto this mesh, whatever mesh saved them.

    Returns the losses of the steps run, ``start_step``, the restored
    step and restore seconds (None without a restore), the training
    thread's stall per saved step, the writer's seconds per committed step,
    ``coalesced_saves``, ``async_errors``, the bytes of the newest
    checkpoint, tokens/s over the loop and the final ``state``."""
    dev = resolve_device(device)
    with mesh_scope(mesh, dev) as m:
        return _train(cfg, data_path, batch, seq, steps, accum_steps,
                      bucket_mb, ckpt_dir, save_interval, max_to_keep, dev,
                      seed, m, chunked, loss_chunk, weight_decay, mu_dtype,
                      token_dtype(cfg.vocab_size, dtype))


def _train(cfg, data_path, batch, seq, steps, accum_steps, bucket_mb,
           ckpt_dir, save_interval, max_to_keep, dev, seed, mesh, chunked,
           loss_chunk, weight_decay, mu_dtype, dtype):
    state = build_state(cfg, dev, seed, chunked, loss_chunk, mu_dtype,
                        mesh=mesh, weight_decay=weight_decay)
    dist = torch.distributed
    group = dist.group.WORLD if (mesh is None and dist.is_available()
                                 and dist.is_initialized()) else None
    # A sharded state is saved by every rank, a replicated one by rank 0.
    saves = mesh is not None or group is None or dist.get_rank() == 0
    mgr = CheckpointManager(ckpt_dir, max_to_keep=max_to_keep,
                            save_interval_steps=save_interval) \
        if ckpt_dir else None
    n_params = sum(p.numel() for p in state.model.parameters())
    flops = flops_per_token(cfg, n_params, seq) * batch * seq
    start, restored, restore_s = 0, None, None
    losses = []
    it = None
    # The drain's agreement of a group: a host round trip per step.
    flags = dist.new_group(backend="gloo") if (
        mgr is not None and dist.is_available() and dist.is_initialized()
        and dist.get_world_size() > 1) else None

    def snapshot():
        # The state after the last whole step: iteration step - 1.
        return state.step - 1, checkpoint_tree(state)

    try:
        if mgr is not None and mgr.latest_step() is not None:
            t0 = time.perf_counter()
            tree = mgr.restore(None, checkpoint_tree(state), mesh=mesh)
            load_checkpoint_tree(state, tree)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            restore_s = time.perf_counter() - t0
            start = state.step
            restored = start - 1
        it = token_file_batches(data_path, batch, seq, dtype=dtype,
                                seed=seed, start_step=start, device=dev,
                                mesh=mesh)
        t0 = time.perf_counter()
        for i in range(start, steps):
            # The whole iteration is one busy scope: a TERM is acted on at
            # its end, where this thread holds no lock. Run from the
            # handler mid-iteration, the save could wait for the writer
            # thread while this thread holds a lock the writer needs (the
            # import lock of a module the step's save imports first).
            with mgr.updating() if mgr is not None \
                    else contextlib.nullcontext():
                with telemetry.step(flops=flops, tokens=batch * seq):
                    b = next(it)
                    m = train_step_accum(state, b, accum_steps, bucket_mb,
                                         group, mesh=mesh)
                if mgr is not None and i == start:
                    # From here on a TERM has a whole step to save.
                    mgr.install_preemption_handler(snapshot, mesh=mesh,
                                                   group=flags)
                losses.append(m["loss"])
                if mgr is not None and saves and (i == steps - 1
                                                  or mgr.should_save(i)):
                    mgr.save(i, checkpoint_tree(state), force=True,
                             mesh=mesh)
                if flags is not None:
                    mgr.preemption_point()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        if mgr is not None:
            mgr.wait()
    finally:
        if it is not None:
            it.close()
        if mgr is not None:
            mgr.remove_preemption_handler()
            mgr.close()
        if flags is not None:
            dist.destroy_process_group(flags)
    out: Dict[str, Any] = {
        "losses": [float(x) for x in losses], "start_step": start,
        "steps": steps, "restored_step": restored, "restore_s": restore_s,
        "tokens_per_sec": (batch * seq * len(losses) / wall
                           if losses else None),
        "accum_steps": accum_steps, "bucket_mb": bucket_mb,
        "loss_chunk": loss_chunk if chunked else None,
        "weight_decay": weight_decay, "remat_policy": cfg.remat_policy,
        "token_dtype": str(dtype),
        "world": dist.get_world_size() if dist.is_initialized() else 1,
        "mesh": mesh_shape(mesh) if mesh is not None else None,
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
                       seed: int = 0, mesh: Any = None) -> TrainState:
    """ResNet-50 or ``MnistMLP(hidden=128)`` made from ``seed`` on
    ``device``, SGD(0.1, 0.9) and the classification loss. With ``mesh``,
    ``init_sharded_state`` with the same values, laid out by the
    reference's logical axes (``shard_model``): ResNet's convs over tp on
    their out channels, the MLP's layers colwise, rowwise and colwise over
    tp, each head's kernel over fsdp on its in-dim and over tp on its
    classes, the norms and biases replicated (at tp = 1 the layout of
    ``examples/resnet/resnet_fsdp.py`` and ``examples/mnist-jax/
    mnist_dp.py``)."""
    if kind not in VISION:
        raise ValueError(f"unknown vision model {kind!r}: one of "
                         f"{sorted(VISION)}")

    def optimizer(params):
        return sgd(params, VISION_LR, momentum=VISION_MOMENTUM)

    def build(device, generator=None):
        if kind == "resnet50":
            return ResNet(ResNetConfig.resnet50(), device=device,
                          generator=generator)
        return MnistMLP(hidden=128, device=device, generator=generator)

    if mesh is not None:
        state, _ = init_sharded_state(build, optimizer, mesh, seed=seed)
        state.loss_fn = vision_loss
        return state
    dev = resolve_device(device)
    model = build(dev, torch.Generator(dev).manual_seed(seed))
    return TrainState(model, optimizer(model.parameters()), vision_loss)


def measure_vision(kind: str, batch: int, steps: int, warmup: int = 2,
                   image: int = 224,
                   device: Union[str, torch.device] = "cuda",
                   seed: int = 0, mesh: str = "") -> Dict[str, Any]:
    """Train ``steps`` steps of ``kind`` ("resnet50" or "mnist"), the
    first ``warmup`` untimed, and return losses, samples/s and step ms over
    the timed steps, ResNet's MFU and, on the card, the peak of allocated
    memory (``peak_memory_bytes``). Each step draws its own batch on the
    device inside the timed loop, as bench's scan does. ``mesh``
    (``"fsdp=1"``, see ``mesh_scope``) trains the sharded state
    (``build_vision_state``) with ``sharded_train_step``: ``batch`` is the
    global batch, each rank's rows its batch coordinate's, and the losses
    the global batch's."""
    _check_steps(steps, warmup)
    dev = resolve_device(device)
    with mesh_scope(mesh, dev) as m:
        state = build_vision_state(kind, dev, seed, mesh=m)
        n_params = sum(p.numel() for p in state.model.parameters())
        rows = process_batch_slice(batch, mesh=m) if m is not None \
            else slice(None)

        def batch_of(s):
            return {k: v[rows] for k, v in vision_batch(
                kind, s, batch, image, dev, seed).items()}
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        losses, dt, _, name, peak, first_ts, walls = _timed_steps(
            state, batch_of, steps, warmup, dev, step=step_fn(m))
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
        "warmup": warmup, "device": name, "first_step_start_ts": first_ts,
        "mesh": mesh_shape(m) if m is not None else None,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
        **walls,
    }


# --model -> bench's batch (the example's for llama3_8b)
DEFAULT_BATCH = {"flagship": 4, "flagship_remat": 8, "big": 4,
                 "llama3_8b": LLAMA_BATCH, "resnet50": 256, "mnist": 4096}
# Bench's decoder points and the Llama-3-8B example: --model -> (config,
# seq, loss chunk or None for the unchunked loss, Adam's mu_dtype)
# (bench.py:1127-1190, 1227-1247; train_llama3.py:34-92).
LM_POINTS = {
    "flagship": (flagship_config, 2048, None, None),
    "flagship_remat": (flagship_remat_config, 8192, 2048, None),
    "big": (big_config, 2048, 1024, torch.bfloat16),
    "llama3_8b": (llama3_8b_config, LLAMA_SEQ, LLAMA_LOSS_CHUNK, None),
}
# --model -> AdamW's weight decay where it is not optax's default.
WEIGHT_DECAY = {"llama3_8b": LLAMA_WEIGHT_DECAY}
# The flagship at bench's long-context lengths: seq -> (batch, loss chunk).
LONG_CONTEXT = {8192: (4, 2048), 32768: (1, 8192)}


def main(argv=None) -> int:
    main_ts = time.time()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=sorted(DEFAULT_BATCH),
                    default="flagship")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain path")
    ap.add_argument("--data", help="token file (.bin of uint16 ids, "
                    "uint32 past 65,536): run the training job's loop on "
                    "the decoder from it")
    ap.add_argument("--accum", type=int, default=1,
                    help="microbatches per optimizer step (with --data)")
    ap.add_argument("--bucket-mb", type=int, default=DEFAULT_BUCKET_MB,
                    help="gradient all-reduce bucket size (with --data)")
    ap.add_argument("--ckpt-dir",
                    default=os.environ.get(constants.CHECKPOINT_DIR) or None,
                    help="checkpoint directory, a path or a gs:// URL: "
                    "resume from it and save into it (with --data; "
                    f"default ${constants.CHECKPOINT_DIR}, which a job "
                    "configured with tony.application.checkpoint-dir "
                    "gets)")
    ap.add_argument("--save-every", type=int, default=1,
                    help="save interval in steps (with --ckpt-dir)")
    ap.add_argument("--seq", type=int, help="sequence length of a decoder "
                    "(default bench's: 2048, 8192 for flagship_remat); "
                    "8192 and 32768 take bench's batch and loss chunk")
    ap.add_argument("--chunked", action="store_true",
                    help="chunked cross-entropy (implied by flagship_remat "
                    "and big)")
    ap.add_argument("--loss-chunk", type=int,
                    help="positions per cross-entropy chunk")
    ap.add_argument("--matmul-dtype", choices=["int8", "fp8_e4m3"],
                    help="quantized attention and MLP projections")
    ap.add_argument("--mesh", default="",
                    help="train the model sharded on this mesh, e.g. "
                    "'fsdp=1' on one card or 'fsdp=2,tp=2' under a "
                    "four-rank group (axes: dcn_dp dp fsdp pp ep sp tp)")
    ap.add_argument("--attn-impl", default="flash",
                    choices=["flash", "xla", "ring", "ulysses"],
                    help="the decoder's attention (TransformerConfig."
                    "attn_impl); ring and ulysses run over the mesh's sp "
                    "axis")
    a = ap.parse_args(argv)
    batch = DEFAULT_BATCH[a.model]
    if a.model in LM_POINTS:
        config, seq, chunk, mu_dtype = LM_POINTS[a.model]
        seq = a.seq or seq
        if a.model == "flagship" and seq in LONG_CONTEXT:
            batch = LONG_CONTEXT[seq][0]
            chunk = LONG_CONTEXT[seq][1] if a.chunked else None
        if a.model == "llama3_8b" and seq < LLAMA_CHUNKED_FROM \
                and not a.chunked:
            chunk = None
        chunk = a.loss_chunk or chunk or (2048 if a.chunked else None)
        cfg = dataclasses.replace(config(seq), matmul_dtype=a.matmul_dtype,
                                  attn_impl=a.attn_impl)
    elif (a.seq or a.chunked or a.loss_chunk or a.matmul_dtype
          or a.attn_impl != "flash"):
        ap.error(f"--seq, --chunked, --loss-chunk, --matmul-dtype and "
                 f"--attn-impl are for the decoders, not {a.model}")
    _flash_cuda.reset_launch_counts()
    _convfuse_cuda.reset_launch_counts()
    quant.reset_launch_counts()
    if a.data:
        if a.model not in LM_POINTS:
            ap.error(f"--data trains a decoder, not {a.model}")
        out = train(cfg, a.data, batch=batch, seq=seq, steps=a.steps,
                    accum_steps=a.accum, bucket_mb=a.bucket_mb,
                    ckpt_dir=a.ckpt_dir, save_interval=a.save_every,
                    device=a.device, mesh=a.mesh, chunked=chunk is not None,
                    loss_chunk=chunk or 2048, mu_dtype=mu_dtype,
                    weight_decay=WEIGHT_DECAY.get(a.model,
                                                  ADAMW_WEIGHT_DECAY))
        del out["state"]
    elif a.model in LM_POINTS:
        out = measure(cfg, batch=batch, seq=seq, steps=a.steps,
                      device=a.device, chunked=chunk is not None,
                      loss_chunk=chunk or 2048, mu_dtype=mu_dtype,
                      mesh=a.mesh,
                      weight_decay=WEIGHT_DECAY.get(a.model,
                                                    ADAMW_WEIGHT_DECAY))
    else:
        out = measure_vision(a.model, batch=batch, steps=a.steps,
                             device=a.device, mesh=a.mesh)
    # Wall times of the start-up: the package's import began (before
    # torch), main began, and (in out) the first step began.
    out["startup_ts"] = {"package": tony_tpu_torch.IMPORT_TS,
                         "main": main_ts}
    # Which kernels the run went through: launches of each per step.
    out["launches_per_step"] = {
        name: n / a.steps for name, n in {**_flash_cuda.launch_counts,
                                          **_convfuse_cuda.launch_counts}
        .items()}
    if a.matmul_dtype:
        out["quantized_products_per_step"] = \
            quant.launch_counts[a.matmul_dtype] / a.steps
        out["quant_fallback"] = quant.fallback_events()
    metrics_file = os.environ.get(constants.METRICS_FILE, "")
    if metrics_file:
        # Inside a job: publish the final step count and device memory now.
        # The run can end before the reporter's next tick, and the
        # executor reads this file once more after the process exits.
        telemetry.write_stats_once(metrics_file)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
