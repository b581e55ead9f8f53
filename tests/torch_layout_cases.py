"""The layout cases of ``tests/test_torch_rules_last_layouts.py`` and their
rank script, free of JAX: the gloo test and ``chip_smoke.py --cards 4``
(one NCCL rank a card, on a host without JAX) run the same cases.

``CASES``: name -> (model kind, mesh spec, config keywords, table);
``TABLES`` the rules tables they name (``random21`` is
``tests/test_torch_rules.py``'s table of that id, written out);
``HELD`` what each case lays where the port once refused it.

The rank script: ``python tests/torch_layout_cases.py RANK WORLD DIR
[--device cuda] [--out OUT] [--watchdog-s S]``. It joins a ``FileStore``
group in DIR (gloo, or NCCL on ``cuda:RANK`` with ``--device cuda``),
reads each case's whole weights (``DIR/<case>_w.pt``) and its ``[STEPS,
GB, SEQ]`` tokens (``DIR/<case>_data.npy``), and for each case lays the
model out under the case's table on its mesh, takes the first batch's
gradients after the step's reductions, trains ``STEPS`` steps of SGD
with momentum, and writes ``OUT/out<rank>.pt`` (OUT defaults to DIR):
per case the gradients, the losses, the parameters after each step (rank
0; the others the last), the step-0 local shards, each parameter's mesh
dims, the held parameters, the local and the planned shard shapes.
"""

import argparse
import faulthandler
import os
import signal
import sys

import numpy as np
import torch

from tony_tpu_torch.parallel.sharding import DEFAULT_RULES

GB, SEQ, STEPS = 8, 16, 3
SGD_LR, MOMENTUM = 0.1, 0.9

DEFAULT = DEFAULT_RULES
# T4 of tests/test_torch_rules.py: the embed dim over (fsdp, tp), the
# vocab whole.
T4 = tuple(r for r in DEFAULT if r[0] not in ("embed", "vocab")) + (
    ("vocab", None), ("embed", ("fsdp", "tp")), ("embed", "fsdp"))
RANDOM21 = (
    ("norm", ("sp", "dp", "tp")), ("stage", ("ep", "tp")), ("heads", "fsdp"),
    ("vocab_table", "fsdp"), ("expert_logits", ("pp", "fsdp")),
    ("norm", "sp"), ("stage", "dcn_dp"), ("vocab_table", "sp"),
    ("seq", "pp"), ("norm", "sp"), ("seq", None),
    ("norm", ("dcn_dp", "fsdp", "dp")), ("stage", "tp"),
    ("expert_logits", "tp"), ("stage", ("tp", "fsdp")),
    ("embed", ("tp", "pp")), ("mlp", ("sp", "dcn_dp")))
TABLES = {
    "default": DEFAULT, "T4": T4,
    "two_dims": (("mlp", "sp"), ("embed", "fsdp")) + DEFAULT,
    "out_of_order": (("embed", ("sp", "fsdp")),) + DEFAULT,
    "random21": RANDOM21,
    "expert_tp_ep": (("expert", ("tp", "ep")),) + DEFAULT,
}
RING = dict(attn_impl="ring")
TP4, FT, FS, ET = dict(tp=4), dict(fsdp=2, tp=2), dict(fsdp=2, sp=2), \
    dict(ep=2, tp=2)
# name -> (model kind, mesh spec, config keywords, table)
CASES = {
    "dense_tp4": ("dense", TP4, {}, "default"),
    "mqa_fsdp_tp": ("dense", FT, dict(n_heads=4, n_kv_heads=1), "default"),
    "moe_tp4": ("moe", TP4, {}, "default"),
    "dense_two_dims": ("dense", FS, RING, "two_dims"),
    "dense_out_of_order": ("dense", FS, RING, "out_of_order"),
    "moe_two_dims": ("moe", FS, RING, "two_dims"),
    "moe_random21": ("moe", FT, {}, "random21"),
    "moe_expert_tp_ep": ("moe", ET, {}, "expert_tp_ep"),
    "dense_T4": ("dense", FT, {}, "T4"),
}
# What each case lays where the port once refused it, read off rank 0's
# parameters: (parameter, the mesh dims it is held on, in the mesh's order;
# None: not gathered).
HELD = {
    "dense_tp4": ("layers.0.attn.wk.weight", None),
    "mqa_fsdp_tp": ("layers.0.attn.wk.weight", None),
    "moe_tp4": ("layers.0.attn.wv.weight", None),
    "dense_two_dims": ("layers.0.mlp.gate.weight", ("fsdp", "sp")),
    "dense_out_of_order": ("layers.0.attn.wq.weight", ("fsdp", "sp", "tp")),
    "moe_two_dims": ("layers.0.moe.gate", ("fsdp", "ep", "sp")),
    # Its axes off the plan's have one rank each: FSDP2 holds it, and the
    # router beside the experts is an FSDP2 unit on its own mesh.
    "moe_random21": ("layers.0.moe.down", None),
    "moe_expert_tp_ep": ("layers.0.moe.gate", ("fsdp", "ep", "tp")),
    "dense_T4": ("lm_head.weight", ("fsdp", "tp")),
}


def setup(kind, kw):
    """(build(device), loss_fn(model, batch)) of a case's model kind."""
    from tony_tpu_torch.models import moe as tmoe
    from tony_tpu_torch.models import transformer as ttf

    if kind == "dense":
        cfg = ttf.TransformerConfig.tiny(**kw)
        return (lambda d: ttf.Transformer(cfg, device=d),
                lambda m, b: (ttf.causal_lm_loss(m(b["tokens"]),
                                                 b["tokens"]), {}))
    cfg = tmoe.MoEConfig.tiny_moe(**kw)
    return (lambda d: tmoe.MoETransformer(cfg, device=d),
            lambda m, b: (tmoe.moe_lm_loss(m(b["tokens"]), b["tokens"],
                                           cfg.aux_loss_weight), {}))


def seeded_weights(name, seed):
    """A case's whole weights drawn on the CPU from ``seed`` (where the
    reference's initial parameters cannot be had: a host without JAX)."""
    from tony_tpu_torch.models import moe as tmoe
    from tony_tpu_torch.models import transformer as ttf

    kind, _, kw, _ = CASES[name]
    gen = torch.Generator().manual_seed(seed)
    cls, cfg = ((ttf.Transformer, ttf.TransformerConfig.tiny(**kw))
                if kind == "dense" else
                (tmoe.MoETransformer, tmoe.MoEConfig.tiny_moe(**kw)))
    return {k: v.detach().clone() for k, v in
            cls(cfg, device="cpu", generator=gen).state_dict().items()}


def case_tokens(seed):
    """A case's ``[STEPS, GB, SEQ]`` tokens."""
    return np.random.default_rng(seed).integers(
        0, 256, (STEPS, GB, SEQ)).astype(np.int32)


def run_rank(rank, world, tmp, device="cpu", out_dir=None):
    """Every case on this rank of a ``FileStore`` group in ``tmp``; the
    results to ``out_dir/out<rank>.pt``."""
    import torch.distributed as dist
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions, set_model_state_dict)
    from torch.distributed.tensor import DTensor

    from tony_tpu_torch.data import process_batch_slice
    from tony_tpu_torch.parallel import (MeshSpec, build_mesh, grad_sync,
                                         init_sharded_state, sgd,
                                         sharded_train_step)

    out_dir = out_dir or tmp
    if device == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        "nccl" if device == "cuda" else "gloo",
        store=dist.FileStore(os.path.join(
            tmp, f"store_{os.path.basename(os.path.normpath(out_dir))}"),
            world),
        rank=rank, world_size=world)
    dev = torch.device("cuda", rank) if device == "cuda" else \
        torch.device("cpu")

    def whole(x):
        x = x.full_tensor() if isinstance(x, DTensor) else x
        return x.detach().cpu().clone()

    def local(x):
        x = x.to_local() if isinstance(x, DTensor) else x
        return x.detach().cpu().clone()

    def first_grads(state, mesh, loss_fn, batch):
        # The first batch's gradients after the train step's reductions.
        state.loss_fn = loss_fn
        grads, _, _ = grad_sync.accumulate_grads(state, batch, 1)
        grad_sync._mesh_sync(grads, grad_sync.DEFAULT_BUCKET_MB, mesh,
                             state.model.sp_group is not None,
                             state.model.reduced_by_fsdp)
        out = {k: whole(g) for k, g in grads.items()}
        state.optimizer.zero_grad(set_to_none=True)
        return out

    out = {}
    for name, (kind, spec, kw, table) in CASES.items():
        print(f"rank {rank}: case {name}", flush=True)
        build, loss_fn = setup(kind, kw)
        mesh = build_mesh(MeshSpec(**spec), device)
        state, placements = init_sharded_state(
            build, lambda g: sgd(g, SGD_LR, momentum=MOMENTUM), mesh,
            rules=TABLES[table])
        weights = torch.load(os.path.join(tmp, f"{name}_w.pt"))
        set_model_state_dict(
            state.model, {k: v.to(dev) for k, v in weights.items()},
            options=StateDictOptions(full_state_dict=True))
        case = dict(shards0={k: local(p)
                             for k, p in state.model.named_parameters()})
        data = np.load(os.path.join(tmp, f"{name}_data.npy"))
        rows = process_batch_slice(data.shape[1], mesh=mesh)

        def batch(s):
            return {"tokens": torch.from_numpy(data[s, rows]).long().to(dev)}
        case["grads"] = first_grads(state, mesh, loss_fn, batch(0))
        losses, params = [], []
        for s in range(STEPS):
            state, m = sharded_train_step(loss_fn, mesh, state, batch(s))
            losses.append(m["loss"].item())
            params.append({k: whole(p)
                           for k, p in state.model.named_parameters()})
        case.update(
            losses=losses, step=state.step,
            params=params if rank == 0 else params[-1:],
            meshes={k: getattr(p, "device_mesh", None) and
                    p.device_mesh.mesh_dim_names
                    for k, p in state.model.named_parameters()},
            gathered={k for k, p in state.model.named_parameters()
                      if k.rpartition(".")[2] in getattr(
                          state.model.get_submodule(k.rpartition(".")[0]),
                          "_gathered", {})},
            local_shapes={k: tuple(local(p).shape)
                          for k, p in state.model.named_parameters()},
            planned={k: pl.local_shape for k, pl in placements.items()})
        out[name] = case
        del state
    torch.save(out, os.path.join(out_dir, f"out{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description="the layout cases on one rank")
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("dir")
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    ap.add_argument("--out")
    ap.add_argument("--watchdog-s", type=float,
                    help="print every thread's stack and exit 1 if the "
                    "cases are not done by then")
    a = ap.parse_args(argv)
    torch.set_num_threads(1)
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    if a.watchdog_s:
        faulthandler.dump_traceback_later(a.watchdog_s, exit=True)
    run_rank(a.rank, a.world, a.dir, a.device, a.out)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
