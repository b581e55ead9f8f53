#!/usr/bin/env python3
"""Time one tree's flash kernels on the card, for an A/B of two trees.

    cd <tree> && python3 <path>/flash_ab.py <label>

Imports ``chip_smoke`` and ``tony_tpu_torch`` from the current directory
(so a checkout of another commit times its own kernels), builds the
kernels, and times the forward, dq and dk/dv kernels beside SDPA's forward
and backward at B4 S2048 causal: bf16 H8/4 at D128 and D64 and H16/16 at
D256 (Gemma's heads) on ``wgmma``; f32 H8/4 at d = 16 (the tiny decoders'
head_dim), 64 and 128 and H16/16 at 256, and bf16 H8/4 at d = 100 (off a
multiple of 8), on the FMA kernels; where the tree's ``route`` takes a
head_dim past 256, also f32 and bf16 H8/8 at d = 512 on the split FMA
kernels (inputs drawn on the card). Each twice (``chip_smoke.cuda_ms``:
medians of 20 CUDA-event timings), with the family and width each kernel
is routed to. Prints one line, ``AB`` and a JSON object. Compare two trees
only within one call to the card, in turns (A, B, B, A): the card's speed
moves between calls.
"""
import json
import os
import sys

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from tony_tpu_torch.ops import _flash_cuda as K  # noqa: E402

SHAPES = (("D128", 128, 8, 4, torch.bfloat16),
          ("D64", 64, 8, 4, torch.bfloat16),
          ("D256", 256, 16, 16, torch.bfloat16),
          ("f32 d16", 16, 8, 4, torch.float32),
          ("f32 d64", 64, 8, 4, torch.float32),
          ("f32 d128", 128, 8, 4, torch.float32),
          ("f32 d256", 256, 16, 16, torch.float32),
          ("bf16 d100", 100, 8, 4, torch.bfloat16))
SPLIT_SHAPES = (("f32 d512", 512, 8, 8, torch.float32),
                ("bf16 d512", 512, 8, 8, torch.bfloat16))

C.phase_device()
K.build()
out = {"tree": sys.argv[1]}
F = torch.nn.functional
try:
    K.route(512, torch.float32, "flash_fwd")
    shapes = SHAPES + SPLIT_SHAPES
except ValueError:          # a tree from before the split family
    shapes = SHAPES
for label, d, h, hk, dtype in shapes:
    q, k, v, do = (C.card_case if d > 256 else C.make_case)(
        4, 2048, h, hk, d, dtype, 0)
    scale = d ** -0.5
    o, lse = K.flash_fwd(q, k, v, scale, True)
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    so = sdpa()
    for _ in range(2):
        r = {"fwd": C.cuda_ms(lambda: K.flash_fwd(q, k, v, scale, True)),
             "dq": C.cuda_ms(lambda: K.flash_bwd_dq(q, k, v, do, lse, delta,
                                                     scale, True)),
             "dkv": C.cuda_ms(lambda: K.flash_bwd_dkv(q, k, v, do, lse,
                                                       delta, scale, True)),
             "sdpa": C.cuda_ms(sdpa),
             "sdpa_bwd": C.cuda_ms(lambda: torch.autograd.grad(
                 so, (qt, kt, vt), do.transpose(1, 2), retain_graph=True))}
        out.setdefault(label, []).append(r)
    out[f"{label} routes"] = {n: K.route(d, dtype, n) for n in K.KERNELS}
    del q, k, v, do, o, lse, delta, qt, kt, vt, so
print("AB " + json.dumps(out), flush=True)
