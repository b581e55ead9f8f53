#!/usr/bin/env python3
"""A/B of compile-time variants of the FMA flash forward on the card.

    python3 flash_variants_ab.py [variants.json]

Each variant is a list of ``[old, new]`` text replacements applied to a copy
of ``tony_tpu_torch/csrc/flash_fwd.cu`` (``VARIANTS`` below: the designs
measured against the committed one in its FMA design note; a JSON file of
the same form replaces them). Every variant, the committed source as
``committed`` first, is built with its own ``nvcc`` (all at once); each
prints its ``flash_fwd_kernel`` registers and spills, is held against the
plain forward over its own key tile on small f32 and bf16 cases (f32
within ``chip_smoke.TOL_F32``, bf16 within the bf16 tolerances, the lse
mean included), and is timed beside SDPA's forward at B4 S2048 causal:
f32 H8/4 at d = 16, 32, 64 and 128 and H16/16 at 256, bf16 H8/4 at d = 12,
20 and 100 (``chip_smoke.cuda_ms``: medians of 20 CUDA-event timings, the
variants in turn, then in reverse order). A variant that does not build,
or that disagrees, is reported and not timed. The last line is ``AB`` and a
JSON object of the times, with the card's name and power limit. Needs a
CUDA card; on a machine without one it checks that every variant's
replacements apply and exits 1.
"""
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import torch

import chip_smoke as C
from tony_tpu_torch.ops import _build, _flash_cuda as K
from tony_tpu_torch.ops import attention as A


def _traits(w, body):
    return [f"template <> struct FwdFma<{w}> {{ static constexpr int {body}"]


def _retile(w, old, new):
    return _traits(w, old) + _traits(w, new)


TILES = {16: "BM = 64, NTH = 128, GX = 4, TM = 2, TN = 8, MINB = 4",
         32: "BM = 64, NTH = 128, GX = 8, TM = 4, TN = 4, MINB = 4",
         64: "BM = 128, NTH = 256, GX = 8, TM = 4, TN = 4, MINB = 2",
         128: "BM = 128, NTH = 256, GX = 8, TM = 4, TN = 4, MINB = 1",
         256: "BM = 64, NTH = 256, GX = 8, TM = 2, TN = 4, MINB = 1, U = 4"}
WIDEN = ("      widen_tile<BN, W, NTH>(st, kb + (long)k0 * kstride, kstride, n, d);\n"
         "      widen_tile<BN, W, NTH>(st + BN * LD, vb + (long)k0 * kstride, kstride, n, d);")
COPY = ("      copy_tile<T, BN, W, NTH>(st, kb + (long)k0 * kstride, kstride, n, d, false, 1.f);\n"
        "      copy_tile<T, BN, W, NTH>(st + BN * LD, vb + (long)k0 * kstride, kstride, n, d, false, 1.f);")
MINB = "std::is_same<T, float>::value ? FwdFma<W>::MINB : 1)"
VARIANTS = {
    "w16 128-row tiles (TM 4)": [_retile(16, TILES[16], "BM = 128, NTH = 128, GX = 4, TM = 4, TN = 8, MINB = 4")],
    "w32 128-row tiles of 256 threads": [_retile(32, TILES[32], "BM = 128, NTH = 256, GX = 8, TM = 4, TN = 4, MINB = 2")],
    "w32, w64 64-key tiles (TN 8)": [_retile(32, TILES[32], "BM = 64, NTH = 128, GX = 8, TM = 4, TN = 8, MINB = 4"),
                                     _retile(64, TILES[64], "BM = 128, NTH = 256, GX = 8, TM = 4, TN = 8, MINB = 1")],
    "w64 64-row tiles of 128 threads": [_retile(64, TILES[64], "BM = 64, NTH = 128, GX = 8, TM = 4, TN = 4, MINB = 4")],
    "w128 64-row tiles (TM 2, MINB 2)": [_retile(128, TILES[128], "BM = 64, NTH = 256, GX = 8, TM = 2, TN = 4, MINB = 2")],
    "w256 128 threads (TM 4)": [_retile(256, TILES[256], "BM = 64, NTH = 128, GX = 8, TM = 4, TN = 4, MINB = 1, U = 4")],
    "w256 unrolled fully (U 0)": [_retile(256, TILES[256], "BM = 64, NTH = 256, GX = 8, TM = 2, TN = 4, MINB = 1, U = 0")],
    "__expf": [["const float alpha = expf(m[i] - mx);", "const float alpha = __expf(m[i] - mx);"],
               ["const float p = expf(s[i][c] - mx);", "const float p = __expf(s[i][c] - mx);"]],
    "bf16 by copy_tile": [[WIDEN, COPY]],
    "bf16 min-blocks as f32": [[MINB, "FwdFma<W>::MINB)"]],
}
CHECKS = (  # b, s, h, hk, d, dtype, causal, f32 out
    (1, 200, 4, 2, 16, torch.float32, True, False),
    (1, 100, 4, 2, 1, torch.float32, True, False),
    (1, 256, 4, 4, 33, torch.float32, False, False),
    (2, 300, 4, 1, 64, torch.float32, True, False),
    (1, 100, 4, 2, 100, torch.float32, True, False),
    (1, 256, 4, 4, 256, torch.float32, False, False),
    (1, 100, 4, 2, 12, torch.bfloat16, True, False),
    (1, 200, 4, 2, 20, torch.bfloat16, True, False),
    (1, 200, 4, 2, 100, torch.bfloat16, True, True),
    (1, 256, 4, 4, 140, torch.bfloat16, False, False))
SHAPES = ((16, 8, 4, torch.float32), (32, 8, 4, torch.float32),
          (64, 8, 4, torch.float32), (128, 8, 4, torch.float32),
          (256, 16, 16, torch.float32), (12, 8, 4, torch.bfloat16),
          (20, 8, 4, torch.bfloat16), (100, 8, 4, torch.bfloat16))


def patched(variants):
    """name -> the patched flash_fwd.cu text; raises if a replacement does
    not apply."""
    base = open(os.path.join(_build.CSRC_DIR, "flash_fwd.cu")).read()
    out = {"committed": base}
    for name, patches in variants.items():
        src = base
        for old, new in patches:
            if old not in src:
                raise ValueError(f"{name}: {old[:60]!r} not in flash_fwd.cu")
            src = src.replace(old, new)
        out[name] = src
    return out


def key_tiles(src):
    """width -> keys per tile of the FMA forward in ``src`` (GX * TN)."""
    return {int(w): int(re.search(r"\bGX = (\d+)", b).group(1))
            * int(re.search(r"\bTN = (\d+)", b).group(1))
            for w, b in re.findall(r"struct FwdFma<(\d+)> \{([^}]*)\}", src)}


def build(sources, out_dir):
    procs = {}
    for name, text in sources.items():
        d = os.path.join(out_dir, f"v{len(procs)}")
        shutil.copytree(_build.CSRC_DIR, d)
        path = os.path.join(d, "flash_fwd.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(d, "libflash_fwd.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, path]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    fns = {}
    for name, (p, lib) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            print(f"{name}: build failed\n{log[-4000:]}", flush=True)
            continue
        for fn, regs, stores, loads in C.ptxas_report(log):
            if "flash_fwd_kernel" in fn:
                print(f"{name}: {fn}: {regs} registers, spill {stores}/{loads}",
                      flush=True)
        f = ctypes.CDLL(lib).tt_flash_fwd
        f.argtypes = list(K.SPECS["flash_fwd"].argtypes)
        f.restype = ctypes.c_int
        fns[name] = f
    return fns


def launch(f, q, k, v, scale, causal, out_f32=False):
    b, sq, h, d = q.shape
    family, width = K.route(d, q.dtype, "flash_fwd")
    assert family == "fma", (d, q.dtype)
    o = torch.empty(q.shape, device=q.device,
                    dtype=torch.float32 if out_f32 else q.dtype)
    lse = torch.empty((b, h, sq), device=q.device, dtype=torch.float32)
    err = f(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, k.shape[2], sq, k.shape[1], d, width, 1,
            int(q.dtype == torch.float32), int(out_f32), float(scale),
            int(causal), _build.stream(q))
    if err:
        raise RuntimeError(f"tt_flash_fwd returned {err}")
    return o, lse


def agrees(f, tiles, case):
    b, s, h, hk, d, dtype, causal, out_f32 = case
    q, k, v, _ = C.make_case(b, s, h, hk, d, dtype, d + s)
    tile = tiles[K.route(d, dtype, "flash_fwd")[1]]
    out = torch.float32 if out_f32 else None
    o_p, lse_p = A.flash_fwd_plain(q, k, v, d ** -0.5, causal, out, tile, tile)
    o, lse = launch(f, q, k, v, d ** -0.5, causal, out_f32)
    torch.cuda.synchronize()
    e_o, e_l = C.max_err(o, o_p), C.max_err(lse, lse_p)
    mean = (lse - lse_p).abs().mean().item()
    finite = bool(torch.isfinite(o).all() and torch.isfinite(lse).all())
    if dtype == torch.float32:
        ok = e_o <= C.TOL_F32 and e_l <= C.TOL_F32
    else:
        ok = (e_o <= C.TOL_BF16_O and e_l <= C.TOL_BF16_LSE
              and mean <= C.TOL_BF16_LSE_MEAN)
    return ok and finite, f"o {e_o:.3e} lse {e_l:.3e} lse mean {mean:.3e}"


def main():
    variants = VARIANTS
    if len(sys.argv) > 1:
        with open(sys.argv[1]) as f:
            variants = json.load(f)
    sources = patched(variants)
    if not torch.cuda.is_available():
        print("flash_variants_ab: every replacement applies; no CUDA card, "
              "nothing built", flush=True)
        sys.exit(1)
    card = C.phase_device()
    with tempfile.TemporaryDirectory(prefix="flash-variants-") as tmp:
        fns = build(sources, tmp)
        for name in list(fns):
            tiles = key_tiles(sources[name])
            for case in CHECKS:
                ok, errs = agrees(fns[name], tiles, case)
                print(f"{name}: {case[:5]} {case[5]} causal {case[6]}: "
                      f"{'ok' if ok else 'DISAGREES'} {errs}", flush=True)
                if not ok:
                    del fns[name]
                    break
        res = {}
        F = torch.nn.functional
        for d, h, hk, dtype in SHAPES:
            q, k, v, _ = C.make_case(4, 2048, h, hk, d, dtype, 500 + d)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            key = f"{'f32' if dtype == torch.float32 else 'bf16'} d{d} H{h}/{hk}"
            r = res.setdefault(key, {"sdpa": C.cuda_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True))})
            for order in (list(fns), list(fns)[::-1]):
                for name in order:
                    r.setdefault(name, []).append(C.cuda_ms(
                        lambda: launch(fns[name], q, k, v, d ** -0.5, True)))
            print(f"{key}: {json.dumps(r)}", flush=True)
            del q, k, v, qt, kt, vt
    print(f"AB {json.dumps(res)}; {card}", flush=True)


if __name__ == "__main__":
    main()
