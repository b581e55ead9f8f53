"""The multi-card dry run: one real step of each parallel path over a group
of n ranks, one process per card. Counterpart of ``__graft_entry__.py``'s
``dryrun_multichip(n)``.

Every rank runs the reference's parts, in its order, at its sizes
(``TransformerConfig.tiny``: f32, head_dim 16, two layers; tokens
``[max(dp·fsdp, 2), 32]``), n factored as the reference factors it (at
n = 4 the meshes below):

(a) the dense step on ``(dp=1, fsdp=2, tp=2)``: ``init_sharded_state`` and
    ``sharded_train_step`` with AdamW(1e-3), its gradients and updated
    parameters;
(b) the ring forward on ``(dp=2, sp=2)``: the decoder with
    ``attn_impl="ring"`` from (a)'s updated parameters, its logits;
(c) Ulysses attention on ``(dp=2, sp=2)``: ``ulysses_attention_sharded``
    of q, k, v ``[b, 64, 4, 16]`` (b = n / sp), causal;
(d) the GPipe step on ``(dp=2, pp=2)``: ``PipelineTransformer`` of
    ``tiny(n_layers=4)``, two microbatches, Adam(1e-3), tokens
    ``[2·dp, 32]``;
(e) the multislice step on ``(dcn_dp=2, dp=1, tp=2)``: ``monolithic_grads``
    of the global batch against the two slices' gradients (accumulation 2)
    mean-reduced by ``bucketed_sync`` over dcn_dp in 1 MiB buckets
    (``rtol=2e-4, atol=1e-6``, as the reference asserts), then one
    ``train_step_accum`` step (accumulation 2) whose ``comms`` phase must
    take time;
(f) the MoE step on ``(dp=2, ep=2)``: ``models.moe.dryrun_ep_step``.

A part that fails fails the run: none is skipped. Rank 0 prints the
reference's summary line, its fields in the reference's order.

Part (e) takes ``[max(dp·fsdp, 2, dcn·dp·2), 32]`` tokens: every slice's
rows must split into two microbatches. The reference takes the first
shape there too, and at n = 4 (2 rows over two slices of accumulation 2)
its own accumulation raises ("global batch 2 not divisible").

The initial parameters and the data are drawn on the CPU from seed 0
(``inputs`` replaces any of them: the tests hand in the reference's), so
a run on the cards and a run on gloo ranks start from the same values.
On the card attention runs through the flash kernels (f32 at head_dim
16: the FMA family); ``launches`` holds each part's launches of each
kernel on this rank, and ``predicted`` what the layers give
(``predicted_launches``).

Launch. One process per card, each in the ``torch.distributed`` group:

- as a submitted gang (the way to run it on cards):

      python -m tony_tpu_torch.cli submit \\
          --conf tony.application.framework=pytorch \\
          --conf tony.worker.instances=4 \\
          --conf tony.worker.command="python -m tony_tpu_torch.dryrun 4"

  Each task has the pytorch runtime's rendezvous env (``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``,
  ``LOCAL_WORLD_SIZE``) and joins its gang's group: NCCL on
  ``cuda:LOCAL_RANK`` (``parallel.mesh.process_group``); gloo with
  ``--device cpu``;
- or from a caller that has brought the group up itself (the tests: gloo
  ranks on a ``FileStore``).

With neither it raises, naming the gang. It raises without a CUDA device
unless ``device="cpu"`` is asked for, and when the host shows fewer cards
than the ranks it runs (``LOCAL_WORLD_SIZE``).

    python -m tony_tpu_torch.dryrun 4 [--device cpu] [--out DIR]
        [--watchdog-s S]

``--out`` writes each rank's results to ``DIR/dryrun_rank<r>.pt``;
``--watchdog-s`` prints every thread's stack and exits if the run is not
done by then (a collective that one rank never reaches hangs the others
without a word on NCCL).
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import math
import os
import signal
import sys
from typing import Any, Dict, Iterator, Mapping, Optional

import numpy as np
import torch

from tony_tpu_torch import constants, telemetry
from tony_tpu_torch._device import resolve_device
from tony_tpu_torch.data import process_batch_slice
from tony_tpu_torch.models import moe as tmoe
from tony_tpu_torch.models.transformer import (Transformer, TransformerConfig,
                                               causal_lm_loss)
from tony_tpu_torch.ops import _flash_cuda
from tony_tpu_torch.ops.ring import DIAG, FULL, schedule
from tony_tpu_torch.ops.ulysses import ulysses_attention_sharded
from tony_tpu_torch.parallel import grad_sync
from tony_tpu_torch.parallel.mesh import (RENDEZVOUS_ENV, MeshSpec,
                                         build_mesh, in_gang, process_group)
from tony_tpu_torch.parallel.pipeline import (PipelineTransformer,
                                              pipeline_shard,
                                              pipeline_train_step)
from tony_tpu_torch.parallel.train import (adamw, init_sharded_state,
                                           load_whole, sharded_train_step)

PARTS = ("dense", "ring", "ulysses", "gpipe", "multislice", "moe")
LR = 1e-3                 # the reference's optax.adamw(1e-3), optax.adam(1e-3)
SEQ = 32
ACCUM = 2
BUCKET_MB = 1             # forces several buckets at the tiny sizes
# The reference's assertion of bucketed against monolithic gradients.
SYNC_RTOL, SYNC_ATOL = 2e-4, 1e-6
ULYSSES_SHAPE = (64, 4, 16)   # seq, heads, head_dim
GPIPE_MICROBATCHES = 2
LAUNCH = ("python -m tony_tpu_torch.cli submit --conf "
          "tony.application.framework=pytorch --conf "
          "tony.worker.instances={n} --conf tony.worker.command="
          "\"python -m tony_tpu_torch.dryrun {n}\"")


def factors(n: int) -> Dict[str, int]:
    """The reference's factoring of n devices: the dense mesh's dp, fsdp,
    tp, and the sizes of sp, pp, dcn_dp and ep (1 where n does not allow
    the part: the part is then not run, as in the reference)."""
    tp = 2 if n % 2 == 0 else 1
    fsdp = 2 if n % 4 == 0 else 1
    even = 2 if n % 2 == 0 else 1
    return dict(dp=n // (tp * fsdp), fsdp=fsdp, tp=tp, sp=even, pp=even,
                dcn=2 if n % 4 == 0 else 1, ep=even)


def default_inputs(n: int) -> Dict[str, Any]:
    """The parameters and data of every part, drawn on the CPU from seed
    0: ``params`` (the dense decoder's whole state dict),
    ``tokens``, ``dcn_tokens``, ``qkv`` ``[3, b, 64, 4, 16]``,
    ``pipe_params``, ``pipe_tokens`` and ``moe_params``."""
    f = factors(n)
    cfg = TransformerConfig.tiny()
    rng = np.random.default_rng(0)
    batch = max(f["dp"] * f["fsdp"], 2)
    # Part (e)'s mesh is (dcn_dp, dp, tp=2): each rank's rows split into
    # ACCUM microbatches.
    dcn_rows = max(batch, n // 2 * ACCUM)
    pipe_cfg = TransformerConfig.tiny(n_layers=2 * f["pp"])

    def drawn(build):
        gen = torch.Generator().manual_seed(0)
        return {k: v.detach().clone()
                for k, v in build("cpu", gen).state_dict().items()}

    return dict(
        params=drawn(lambda d, g: Transformer(cfg, device=d, generator=g)),
        tokens=rng.integers(0, cfg.vocab_size, (batch, SEQ)),
        dcn_tokens=rng.integers(0, cfg.vocab_size, (dcn_rows, SEQ)),
        qkv=rng.standard_normal((3, n // f["sp"]) + ULYSSES_SHAPE,
                                dtype=np.float32),
        pipe_params=drawn(lambda d, g: PipelineTransformer(
            pipe_cfg, device=d, generator=g)),
        pipe_tokens=rng.integers(0, cfg.vocab_size,
                                 (2 * (n // f["pp"]), SEQ)),
        moe_params=drawn(lambda d, g: tmoe.MoETransformer(
            tmoe.MoEConfig.tiny_moe(), device=d, generator=g)))


def flash_launches(n_layers: int, forwards: int = 1,
                   backward: bool = True) -> Dict[str, int]:
    """Launches of each flash kernel by ``forwards`` passes through
    ``n_layers`` layers without remat, and their backward."""
    back = n_layers * forwards if backward else 0
    return {"flash_fwd": n_layers * forwards, "flash_bwd_dq": back,
            "flash_bwd_dkv": back}


def predicted_launches(n: int, sp_rank: int, ep_layers: int = 2
                       ) -> Dict[str, Dict[str, int]]:
    """What the layers give each part on a rank at ``sp_rank`` of the
    ring's group: (a) one forward and backward of the two layers; (b) the
    ring's hops that are not skipped (the causal ring skips the chunks
    after its own), forward only, in each layer; (c) one forward; (d) each
    stage's two layers in every tick of the GPipe loop (M + S - 1 of them,
    the bubble's included, as the reference's uniform loop computes them)
    and their backward; (e) the global batch once, then two microbatches
    twice (the slices' gradients, then the step); (f) the MoE decoder's
    layers once."""
    f = factors(n)
    tiny = TransformerConfig.tiny().n_layers
    hops = sum(1 for _, _, kind in schedule(sp_rank, f["sp"], True)
               if kind in (DIAG, FULL))
    per_stage = 2
    ticks = GPIPE_MICROBATCHES + f["pp"] - 1
    return {
        "dense": flash_launches(tiny),
        "ring": flash_launches(tiny, hops, backward=False),
        "ulysses": flash_launches(1, backward=False),
        "gpipe": flash_launches(per_stage, ticks),
        "multislice": flash_launches(tiny, 1 + 2 * ACCUM),
        "moe": flash_launches(ep_layers),
    }


def _whole(x: torch.Tensor) -> torch.Tensor:
    """A parameter's whole value on the host (a DTensor's gathered)."""
    if hasattr(x, "full_tensor"):
        x = x.full_tensor()
    return x.detach().cpu().clone()


def _local(x: torch.Tensor) -> torch.Tensor:
    return x.to_local() if hasattr(x, "to_local") else x


def _lm_loss(model, batch):
    tok = batch["tokens"]
    return causal_lm_loss(model(tok), tok), {}


def _finite(x: float, what: str) -> float:
    if not math.isfinite(x):
        raise RuntimeError(f"{what} diverged: {x}")
    return x


@contextlib.contextmanager
def _counted(counts: Dict[str, Dict[str, int]], part: str) -> Iterator[None]:
    """Reset the flash kernels' launch counts before ``part``, keep them
    after."""
    _flash_cuda.reset_launch_counts()
    yield
    counts[part] = dict(_flash_cuda.launch_counts)


def _dense_state(cfg, mesh, params, optimizer):
    state, _ = init_sharded_state(lambda d: Transformer(cfg, device=d),
                                  optimizer, mesh)
    load_whole(state.model, params)
    return state


def _rows(x: np.ndarray, mesh, dev) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(x[process_batch_slice(x.shape[0], mesh=mesh)])
    ).long().to(dev)


def _dense(f, dev, inp) -> Dict[str, Any]:
    mesh = build_mesh(MeshSpec(dp=f["dp"], fsdp=f["fsdp"], tp=f["tp"]),
                      dev.type)
    cfg = TransformerConfig.tiny(attn_impl="flash")
    state = _dense_state(cfg, mesh, inp["params"], lambda g: adamw(g, LR))
    grads: Dict[str, torch.Tensor] = {}

    def keep(*_):
        # The gradients the update applies, after the step's reductions.
        grads.update((k, _whole(p.grad))
                     for k, p in state.model.named_parameters())

    hook = state.optimizer.register_step_pre_hook(keep)
    try:
        _, m = sharded_train_step(_lm_loss, mesh, state,
                                  {"tokens": _rows(inp["tokens"], mesh, dev)})
    finally:
        hook.remove()
    loss = _finite(float(m["loss"]), "dp/fsdp/tp step")
    return dict(loss=loss, grads=grads,
                params={k: _whole(p) for k, p in
                        state.model.named_parameters()})


def _ring(n, f, dev, params, tokens) -> Dict[str, Any]:
    mesh = build_mesh(MeshSpec(dp=n // f["sp"], sp=f["sp"]), dev.type)
    cfg = TransformerConfig.tiny(attn_impl="ring")
    state = _dense_state(cfg, mesh, params, lambda g: adamw(g, LR))
    rows = process_batch_slice(tokens.shape[0], mesh=mesh)
    with torch.no_grad():
        logits = state.model(_rows(tokens, mesh, dev))
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("sp ring path diverged")
    return dict(logits=logits.cpu(), rows=(rows.start, rows.stop),
                sp_rank=mesh.get_local_rank("sp"))


def _ulysses(n, f, dev, qkv) -> Dict[str, Any]:
    mesh = build_mesh(MeshSpec(dp=n // f["sp"], sp=f["sp"]), dev.type)
    rows = process_batch_slice(qkv.shape[1], mesh=mesh)
    r, chunk = mesh.get_local_rank("sp"), qkv.shape[2] // f["sp"]
    q, k, v = (torch.from_numpy(np.ascontiguousarray(
        qkv[i, rows, r * chunk:(r + 1) * chunk])).to(dev) for i in range(3))
    with torch.no_grad():
        out = ulysses_attention_sharded(mesh, q, k, v, causal=True)
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("sp ulysses path diverged")
    return dict(out=out.cpu(), rows=(rows.start, rows.stop),
                seq=(r * chunk, (r + 1) * chunk))


def _gpipe(n, f, dev, inp) -> Dict[str, Any]:
    mesh = build_mesh(MeshSpec(dp=n // f["pp"], pp=f["pp"]), dev.type)
    cfg = TransformerConfig.tiny(n_layers=2 * f["pp"])
    state, _ = init_sharded_state(
        lambda d: PipelineTransformer(cfg, d,
                                      num_microbatches=GPIPE_MICROBATCHES),
        # optax.adam's defaults (eps outside the square root, as optax)
        lambda g: torch.optim.Adam(g, lr=LR), mesh, layout=pipeline_shard)
    load_whole(state.model, inp["pipe_params"])
    _, m = pipeline_train_step(
        mesh, state, {"tokens": _rows(inp["pipe_tokens"], mesh, dev)},
        GPIPE_MICROBATCHES)
    return dict(loss=_finite(float(m["loss"]), "pp train step"))


def _multislice(n, f, dev, inp) -> Dict[str, Any]:
    dcn = f["dcn"]
    mesh = build_mesh(MeshSpec(dcn_dp=dcn, dp=n // (2 * dcn), tp=2),
                      dev.type)
    cfg = TransformerConfig.tiny(attn_impl="flash")
    state = _dense_state(cfg, mesh, inp["params"], lambda g: adamw(g, LR))
    state.loss_fn = _lm_loss
    tokens = inp["dcn_tokens"]
    whole = torch.from_numpy(tokens).long().to(dev)
    local = _rows(tokens, mesh, dev)
    # The gradient of one loss over the global batch, every rank computing
    # it whole (FSDP2 is one rank wide here: nothing to reduce) ...
    mono = grad_sync.monolithic_grads(_lm_loss, state.model,
                                      {"tokens": whole})
    # ... against each slice's own (accumulation 2 over its rows)
    # mean-reduced over dcn_dp in 1 MiB buckets.
    grads, _, _ = grad_sync.accumulate_grads(state, {"tokens": local},
                                             ACCUM)
    bucketed = grad_sync.bucketed_sync(
        {k: _local(g) for k, g in grads.items()}, BUCKET_MB,
        mesh.get_group("dcn_dp"))
    state.optimizer.zero_grad(set_to_none=True)
    worst = 0.0
    for k, g in bucketed.items():
        want = _local(mono[k]).float()
        excess = ((g.float() - want).abs()
                  - (SYNC_ATOL + SYNC_RTOL * want.abs())).max()
        worst = max(worst, float(excess))
    if worst > 0:
        raise RuntimeError(
            f"bucketed grad-sync diverged from the monolithic gradient "
            f"(by {worst} past rtol={SYNC_RTOL}, atol={SYNC_ATOL})")
    # One real accumulated step, its comms phase booked as a job books it.
    telemetry._reset_phase_state()
    with telemetry.step():
        m = grad_sync.train_step_accum(state, {"tokens": local}, ACCUM,
                                       grad_sync.DEFAULT_BUCKET_MB,
                                       mesh=mesh)
        loss = float(m["loss"])
    stats = telemetry.phase_stats()
    comms = (float((stats.get("cum") or {}).get("comms", 0.0))
             / max(float(stats.get("wall_s", 0.0) or 0.0), 1e-9))
    telemetry._reset_phase_state()
    if not comms > 0.0:
        raise RuntimeError("dcn_dp grad sync recorded no comms phase")
    return dict(
        loss=_finite(loss, "dcn_dp step"), comms_fraction=comms,
        sync_excess=worst,
        mono={k: _local(g).detach().cpu().clone() for k, g in mono.items()},
        bucketed={k: g.detach().cpu().clone() for k, g in bucketed.items()})


def _moe(n, f, dev, inp) -> Dict[str, Any]:
    mesh = build_mesh(MeshSpec(dp=n // f["ep"], ep=f["ep"]), dev.type)
    return dict(loss=tmoe.dryrun_ep_step(mesh, params=inp["moe_params"]))


def _check_launch(n: int, dev: torch.device) -> None:
    """Raise unless this process can run as one of n ranks: enough cards
    for the ranks on this host, and a group up or the rendezvous env."""
    dist = torch.distributed
    if dev.type == "cuda":
        local_world = int(os.environ.get(constants.LOCAL_WORLD_SIZE) or 0)
        want = local_world or (n if not dist.is_initialized() else
                               min(n, dist.get_world_size()))
        have = torch.cuda.device_count()
        if have < want:
            raise RuntimeError(
                f"dryrun_multichip({n}): {want} ranks on this host but only "
                f"{have} CUDA device(s) visible")
    if not dist.is_initialized() and not in_gang():
        raise RuntimeError(
            f"dryrun_multichip({n}) runs one process per card in a "
            f"torch.distributed group, and none is up: no process group "
            f"and no rendezvous env ({', '.join(RENDEZVOUS_ENV)}). "
            f"Submit it as a gang: {LAUNCH.format(n=n)}")


def dryrun_multichip(n: int, device: str = "cuda",
                     inputs: Optional[Mapping[str, Any]] = None
                     ) -> Dict[str, Any]:
    """One real step of each parallel path over the group's n ranks (see
    the module docstring), called by every rank. Returns this rank's
    results: each part's numbers by name (``PARTS``), ``launches`` and
    ``predicted`` (each part's flash launches on this rank),
    ``factors`` and the ``summary`` line, which rank 0 prints."""
    dev = resolve_device(device)
    _check_launch(n, dev)
    f = factors(n)
    inp = dict(default_inputs(n))
    inp.update(inputs or {})
    dist = torch.distributed
    with process_group(dev):
        if dist.get_world_size() != n:
            raise RuntimeError(f"dryrun_multichip({n}) in a group of "
                               f"{dist.get_world_size()} ranks")
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        counts: Dict[str, Dict[str, int]] = {}
        out: Dict[str, Any] = {"rank": dist.get_rank(), "factors": f}
        with _counted(counts, "dense"):
            out["dense"] = _dense(f, dev, inp)
        sp_rank = 0
        if f["sp"] > 1:
            with _counted(counts, "ring"):
                out["ring"] = _ring(n, f, dev, out["dense"]["params"],
                                    inp["tokens"])
            with _counted(counts, "ulysses"):
                out["ulysses"] = _ulysses(n, f, dev, inp["qkv"])
            sp_rank = out["ring"]["sp_rank"]
        if f["pp"] > 1:
            with _counted(counts, "gpipe"):
                out["gpipe"] = _gpipe(n, f, dev, inp)
        if f["dcn"] > 1:
            with _counted(counts, "multislice"):
                out["multislice"] = _multislice(n, f, dev, inp)
        # Run unconditionally, as the reference insists: a broken import
        # must fail the run, never skip ep.
        if f["ep"] > 1:
            with _counted(counts, "moe"):
                out["moe"] = _moe(n, f, dev, inp)
        predicted = predicted_launches(
            n, sp_rank, tmoe.MoEConfig.tiny_moe().n_layers)
        out["launches"] = counts
        out["predicted"] = {p: predicted[p] for p in counts}
        out["summary"] = summary(n, out)
        if dist.get_rank() == 0:
            print(out["summary"], flush=True)
        dist.barrier()
    return out


def summary(n: int, out: Mapping[str, Any]) -> str:
    """The reference's summary line (``__graft_entry__.py:220-233``)."""
    f = out["factors"]
    parts = [f"dryrun_multichip({n}): dp={f['dp']} fsdp={f['fsdp']} "
             f"tp={f['tp']} loss={out['dense']['loss']:.4f}"]
    if "ring" in out:
        parts.append(f"sp={f['sp']} ring ok; ulysses ok")
    if "gpipe" in out:
        parts.append(f"pp={f['pp']} gpipe loss={out['gpipe']['loss']:.4f}")
    if "moe" in out:
        parts.append(f"ep={f['ep']} moe loss={out['moe']['loss']:.4f}")
    if "multislice" in out:
        ms = out["multislice"]
        parts.append(
            f"dcn_dp={f['dcn']} multislice loss={ms['loss']:.4f} "
            f"grad_sync=bucketed(accum={ACCUM}, vs-psum-allclose=ok) "
            f"comms_fraction={ms['comms_fraction']:.4f}")
    return "; ".join(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=8,
                    help="ranks in the group (the reference's default: 8)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default: NCCL, one card per rank) or "
                    "'cpu' (gloo)")
    ap.add_argument("--out", help="write each rank's results to "
                    "OUT/dryrun_rank<r>.pt")
    ap.add_argument("--watchdog-s", type=float,
                    help="print every thread's stack and exit 1 if the run "
                    "is not done by then")
    a = ap.parse_args(argv)
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    if a.watchdog_s:
        faulthandler.dump_traceback_later(a.watchdog_s, exit=True)
    try:
        out = dryrun_multichip(a.n, a.device)
    finally:
        faulthandler.cancel_dump_traceback_later()
    if a.out:
        os.makedirs(a.out, exist_ok=True)
        torch.save(out, os.path.join(a.out, f"dryrun_rank{out['rank']}.pt"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
