#!/usr/bin/env python3
"""How far the decoder's two attention paths part on the CPU, in bf16.

    python3 head_dim_parting.py --head-dim 512

Builds ``tony_tpu_torch``'s decoder at each (dim, seq) given, with heads of
``--head-dim`` over one kv head (MQA, as Gemma-2B), 2 layers, remat off,
bf16 activations, and takes one forward and backward step of
``causal_lm_loss`` under ``attn_impl="flash"`` (on the CPU: the plain
versions the card's kernels are held to) and under ``"xla"`` (the plain
attention) from the same weights and tokens. Prints, for each point, one
JSON line with the loss's relative difference and the largest relative
Frobenius difference of a layer's wq, wk or wv gradient: the parting that
``chip_smoke.py``'s ``TOL_GEMMA_LOSS_REL`` and ``TOL_GEMMA_GRAD_REL`` are
derived from (twice and twenty times its largest reading). The vocabulary
and the MLP are cut (``--vocab``, ``--mlp``) so that a point fits a small
host; neither enters the attention.
"""
import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from tony_tpu_torch.models.transformer import (Transformer,
                                               TransformerConfig,
                                               causal_lm_loss)


def parting(dim, seq, head_dim, vocab, mlp, seed):
    cfg = TransformerConfig(vocab_size=vocab, dim=dim, n_layers=2,
                            n_heads=dim // head_dim, n_kv_heads=1,
                            mlp_dim=mlp, max_seq_len=seq,
                            rope_theta=10_000.0, norm_eps=1e-6, remat=False)
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, (1, seq)))
    names = [f"layers.{i}.attn.{w}.weight" for i in range(cfg.n_layers)
             for w in ("wq", "wk", "wv")]

    def step(model):
        loss = causal_lm_loss(model(tokens), tokens)
        loss.backward()
        params = dict(model.named_parameters())
        return loss.item(), {n: params[n].grad.float() for n in names}

    flash = Transformer(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    xla = Transformer(dataclasses.replace(cfg, attn_impl="xla"),
                      device="cpu")
    xla.load_state_dict(flash.state_dict())
    loss, grads = step(flash)
    loss_x, grads_x = step(xla)
    rels = {n: ((grads[n] - grads_x[n]).norm() / grads_x[n].norm()).item()
            for n in names}
    return {"dim": dim, "seq": seq, "head_dim": head_dim,
            "heads": f"{cfg.n_heads}/1", "loss": loss, "loss_xla": loss_x,
            "loss_rel": abs(loss - loss_x) / abs(loss_x),
            "grad_rel_max": max(rels.values()), "grad_rel": rels}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--head-dim", type=int, default=512)
    ap.add_argument("--dims", default="1024,2048")
    ap.add_argument("--seqs", default="512,1024")
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--mlp", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=23)
    ap.add_argument("--threads", type=int, default=4)
    a = ap.parse_args()
    torch.set_num_threads(a.threads)
    for dim in map(int, a.dims.split(",")):
        for seq in map(int, a.seqs.split(",")):
            t = time.perf_counter()
            r = parting(dim, seq, a.head_dim, a.vocab, a.mlp, a.seed)
            r["seconds"] = round(time.perf_counter() - t, 1)
            print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
