#!/usr/bin/env python3
"""Time one tree's main path on the card, for an A/B of two trees.

    cd <tree> && python3 <path>/main_path_ab.py <label>

Imports ``chip_smoke`` and ``tony_tpu_torch`` from the current directory
(so a checkout of another commit runs its own code), builds the kernels,
and runs ``chip_smoke.phase_main_path`` (the flagship decoder through
``trainer.measure``, B4 S2048, 2 warm and 10 timed steps, its checks
included) three times. Prints one line, ``AB`` and a JSON object with each
run's tokens/s and step ms. Compare two trees only within one call to the
card, in turns (A, B, B, A): the card's speed moves between calls.
"""
import json
import os
import sys

sys.path.insert(0, os.getcwd())
import chip_smoke as C  # noqa: E402
from tony_tpu_torch.ops import _flash_cuda as K  # noqa: E402

C.phase_device()
K.build()
out = {"tree": sys.argv[1], "tokens_per_sec": [], "step_ms": []}
for _ in range(3):
    _, r = C.phase_main_path()
    out["tokens_per_sec"].append(r["tokens_per_sec"])
    out["step_ms"].append(r["step_ms"])
print("AB " + json.dumps(out), flush=True)
