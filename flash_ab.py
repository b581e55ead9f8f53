#!/usr/bin/env python3
"""Time one tree's flash kernels on the card, for an A/B of two trees.

    cd <tree> && python3 <path>/flash_ab.py <label>

Imports ``chip_smoke`` and ``tony_tpu_torch`` from the current directory
(so a checkout of another commit times its own kernels), builds the
kernels, and times the forward, dq and dk/dv kernels and SDPA's forward at
B4 S2048 causal bf16, H8/4 at D128 and D64 and H16/16 at D256 (Gemma's
heads), twice each (``chip_smoke.cuda_ms``: medians of 20 CUDA-event
timings), with the family and width each kernel is routed to. Prints one
line, ``AB`` and a JSON object. Compare two trees only within one call to
the card, in turns (A, B, B, A): the card's speed moves between calls.
"""
import json
import os
import sys

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from tony_tpu_torch.ops import _flash_cuda as K  # noqa: E402

C.phase_device()
K.build()
out = {"tree": sys.argv[1]}
F = torch.nn.functional
for d, h, hk in ((128, 8, 4), (64, 8, 4), (256, 16, 16)):
    q, k, v, do = C.make_case(4, 2048, h, hk, d, torch.bfloat16, 0)
    scale = d ** -0.5
    o, lse = K.flash_fwd(q, k, v, scale, True)
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    for _ in range(2):
        r = {"fwd": C.cuda_ms(lambda: K.flash_fwd(q, k, v, scale, True)),
             "dq": C.cuda_ms(lambda: K.flash_bwd_dq(q, k, v, do, lse, delta,
                                                     scale, True)),
             "dkv": C.cuda_ms(lambda: K.flash_bwd_dkv(q, k, v, do, lse,
                                                       delta, scale, True)),
             "sdpa": C.cuda_ms(lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=True, enable_gqa=True))}
        out.setdefault(f"D{d}", []).append(r)
    out[f"D{d} routes"] = {n: K.route(d, torch.bfloat16, n)
                           for n in K.KERNELS}
print("AB " + json.dumps(out), flush=True)
