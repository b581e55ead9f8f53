#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py          # from the root of the repository

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

1. the device: a CUDA card must be present; prints ``nvidia-smi``'s name
   and power limit; TF32 off, so the f32 checks are full f32;
2. the build: compiles the three flash kernels and the convfuse apply
   kernel from ``tony_tpu_torch/csrc`` (one ``nvcc`` each, all at once) and
   prints the seconds it took and each kernel's registers and spills; the
   bf16 (wgmma) instantiations of the three flash kernels (four of the
   forward, two each of dq and dk/dv) must report 0 spill bytes;
3. each kernel against its plain PyTorch version on the same inputs (made
   with a seeded numpy generator): the flagship attention shape (B=4,
   S=2048, H=8, Hkv=4, D=128, bf16, causal; o, lse, dq, dk and dv must
   also be bitwise equal across two runs), the Llama-3-8B attention shape
   of ``TransformerConfig.llama3_8b`` at batch 1 (S=2048, H=32, Hkv=8,
   D=128, bf16, causal), ragged cases (S=1000: non-causal and causal GQA
   bf16 at D=64, causal bf16 at D=128) and small f32 cases, then
   ``flash_attention_with_lse(out_dtype=f32)`` with its lse cotangent,
   card against CPU, at D=64 (S=256) and D=128 (S=1000) (every bf16
   forward case holds lse in the mean as well as at its maximum, which
   catches a row sum over the wrong P below head_dim 128); times each kernel,
   its plain version and ``scaled_dot_product_attention`` (the library
   yardstick, used nowhere in the port) at the flagship and Llama-3-8B
   shapes with CUDA events; then the convfuse apply kernel against its
   plain version on
   ResNet-50's stem shape ([256, 12544, 64] bf16, relu), its stage-3 shape
   ([256, 49, 2048] bf16, no relu: ragged rows, widest C), channel counts
   that take the scalar path and small f32 cases, timed at the stem shape
   beside ``F.group_norm`` + ``relu`` and the port's whole
   ``fused_groupnorm_relu``; then a small f32 decoder's and a small f32
   ResNet's loss and gradients on the card against the same weights on the
   CPU;
4. the main path: ``tony_tpu_torch.trainer.measure`` trains the flagship
   decoder (16 layers, dim 1024, seq 2048, batch 4) for 10 steps through
   the kernels; every loss must be finite, the first within 0.5 of
   ln(32000) + 0.5 (the logits of the lecun-initialised head have unit
   variance at init, which adds about 1/2 to ln(vocab)), and each kernel's
   launch count must be 16 per step;
5. where a flagship step's device time goes (torch.profiler, kernel time
   by kind and the device's idle share), for the record only;
6. the second path: ``trainer.measure_vision`` trains ResNet-50 (224²
   images, widths 64-2048, 16 bottlenecks, batch 256, SGD 0.1/0.9) for 10
   steps through the convfuse kernel; every loss must be finite and the
   kernel's launch count 53 per step (the stem, 3 norms in each of 16
   bottlenecks and the 4 projections); then the MNIST MLP (batch 4096, 20
   steps, no kernel) must give finite losses; then where a ResNet step's
   device time goes;
7. prints the kernels' JSON line, then the result line.

It imports nothing of JAX and nothing of ``tony_tpu``.
"""

import json
import math
import os
import re
import statistics
import subprocess
import time

import numpy as np
import torch

# Tolerances of phase 3 (kernel against plain version on the same inputs).
# bf16: o is rounded to bf16 by both (one ulp near 1 is 2**-8); lse is f32
# in both; a gradient's relative Frobenius error allows the bf16 rounding of
# ds/p falling on the other side of a tie for a few elements.
TOL_BF16_O = 2e-2
TOL_BF16_LSE = 1e-3
# The mean absolute lse error of a bf16 forward against its plain version
# (both over 128-key tiles): the row sum below head_dim 128 adds the bf16 P,
# and a kernel adding the f32 P there is off by ~1e-4 in the mean, while
# exp2's last-bit noise leaves the maximum near 5e-4 but the mean far lower.
TOL_BF16_LSE_MEAN = 2e-5
TOL_BF16_GRAD_REL = 2e-2
TOL_F32 = 1e-4            # f32 case: o, lse, dq, dk, dv (absolute)
TOL_MODEL_REL = 1e-4      # f32 decoder and ResNet on the card vs the CPU
# Convfuse apply against its plain version: bf16 within one bf16 ulp of the
# plain result (8 significant bits: |err| <= 2**-7 * |y|; the kernel rounds
# x*a and +b separately, as torch does, so it should agree bit for bit);
# f32 within 1e-6 * max|y|.
TOL_CF_BF16_ULP = 2.0 ** -7
TOL_CF_F32 = 1e-6
# Published H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor-core
# FLOP/s, HBM3 bytes/s and f32 FLOP/s outside the tensor cores.
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
SPIN_CYCLES = 40_000_000  # ~20 ms at the H100's ~2 GHz boost clock
STEPS = 10
PROFILE_STEPS = 3
RESNET_BATCH = 256
# The stem, three norms in each of 16 bottlenecks, four projections.
RESNET_LAUNCHES_PER_STEP = 53
MNIST_BATCH, MNIST_STEPS = 4096, 20


def check(ok, msg):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps=20, warm=3):
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events. The
    card first spins for about 20 ms while the host queues the runs, so a
    host slower than a short kernel does not add its launch time to it."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    events = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def phase_device():
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    log(smi[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    return smi[0]


def phase_build():
    from tony_tpu_torch.ops import _build, _convfuse_cuda, _flash_cuda

    t0 = time.perf_counter()
    specs = {**_flash_cuda.SPECS, **_convfuse_cuda.SPECS}
    info = _build.build(specs)
    log(f"build: {time.perf_counter() - t0:.1f} s into {info['dir']}")
    # Registers and spills of every kernel (each source's ``ptxas -v`` log in
    # the build directory). The bf16 flash kernels hold their accumulators
    # in registers: a spill there fails the run. The forward has four bf16
    # instantiations (head_dim 64/128 x o in bf16/f32), dq and dk/dv two.
    wgmma_kernels = {"flash_fwd": 4, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
    for name in specs:
        with open(os.path.join(info["dir"], f"{name}.log")) as f:
            text = f.read()
        report = ptxas_report(text)
        for fn, regs, stores, loads in report:
            log(f"  {name}: {fn}: {regs} registers, {stores} bytes spill "
                f"stores, {loads} bytes spill loads")
        for line in text.splitlines():
            if "serialized" in line:
                log(f"  {name}: {line.strip()}")
        if name in wgmma_kernels:
            bf16 = [r for r in report if "wgmma" in r[0]]
            check(len(bf16) == wgmma_kernels[name],
                  f"{name}: {len(bf16)} ptxas reports of its bf16 kernels, "
                  f"expected {wgmma_kernels[name]}")
            for fn, _, stores, loads in bf16:
                check(stores == 0 and loads == 0, f"{fn} spills registers")


def ptxas_report(text):
    """(entry function, registers, spill store bytes, spill load bytes) for
    each entry function of a ``ptxas -v`` log."""
    out, fn, spills = [], None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.append((fn, int(m.group(1)), *spills))
            fn = None
    return out


def make_case(b, s, h, hk, d, dtype, seed):
    rng = np.random.default_rng(seed)

    def t(*shape):
        x = rng.standard_normal(shape, dtype=np.float32)
        return torch.from_numpy(x).to("cuda", dtype)
    return t(b, s, h, d), t(b, s, hk, d), t(b, s, hk, d), t(b, s, h, d)


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def rel_err(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def check_case(name, b, s, h, hk, d, dtype, causal, seed, timed=False,
               deterministic=False):
    """Kernel against plain version for fwd, dq and dk/dv on one case;
    with ``deterministic``, dq, dk and dv must come out bitwise equal from a
    second run."""
    from tony_tpu_torch.ops import _flash_cuda as K
    from tony_tpu_torch.ops import attention as A

    q, k, v, do = make_case(b, s, h, hk, d, dtype, seed)
    scale = d ** -0.5
    o, lse = K.flash_fwd(q, k, v, scale, causal)
    o_p, lse_p = A.flash_fwd_plain(q, k, v, scale, causal, block_q=128,
                                   block_k=128)
    # The backward kernels and their plain versions get identical inputs.
    delta = (o_p.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    dq = K.flash_bwd_dq(q, k, v, do, lse_p, delta, scale, causal)
    dk, dv = K.flash_bwd_dkv(q, k, v, do, lse_p, delta, scale, causal)
    dq_p = A.flash_bwd_dq_plain(q, k, v, do, lse_p, delta, scale, causal,
                                128, 128)
    dk_p, dv_p = A.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta, scale,
                                       causal, 128, 128)
    torch.cuda.synchronize()
    errs = {"o": max_err(o, o_p), "lse": max_err(lse, lse_p),
            "dq": max_err(dq, dq_p), "dk": max_err(dk, dk_p),
            "dv": max_err(dv, dv_p)}
    lse_mean = (lse - lse_p).abs().mean().item()
    rels ={n: rel_err(x, y) for n, x, y in
            (("dq", dq, dq_p), ("dk", dk, dk_p), ("dv", dv, dv_p))}
    for n, x in (("o", o), ("lse", lse), ("dq", dq), ("dk", dk),
                 ("dv", dv)):
        check(bool(torch.isfinite(x).all()), f"{name}: {n} not finite")
    log(f"{name}: max abs err {json.dumps(errs)} lse mean abs err "
        f"{lse_mean:.3e} grad rel err {json.dumps(rels)}")
    if dtype == torch.float32:
        for n, e in errs.items():
            check(e <= TOL_F32, f"{name}: {n} err {e} > {TOL_F32}")
    else:
        check(errs["o"] <= TOL_BF16_O, f"{name}: o err {errs['o']}")
        check(errs["lse"] <= TOL_BF16_LSE, f"{name}: lse err {errs['lse']}")
        check(lse_mean <= TOL_BF16_LSE_MEAN,
              f"{name}: lse mean abs err {lse_mean}")
        for n, e in rels.items():
            check(e <= TOL_BF16_GRAD_REL, f"{name}: {n} rel err {e}")
    if deterministic:
        o2, lse2 = K.flash_fwd(q, k, v, scale, causal)
        dq2 = K.flash_bwd_dq(q, k, v, do, lse_p, delta, scale, causal)
        dk2, dv2 = K.flash_bwd_dkv(q, k, v, do, lse_p, delta, scale, causal)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in
                   ((o, o2), (lse, lse2), (dq, dq2), (dk, dk2), (dv, dv2)))
        log(f"{name}: o, lse, dq, dk, dv bitwise equal across two runs: "
            f"{same}")
        check(same, f"{name}: the flash kernels are not deterministic")
    if not timed:
        return None

    res = {}
    res["flash_fwd"] = dict(
        ms=cuda_ms(lambda: K.flash_fwd(q, k, v, scale, causal)),
        plain_ms=cuda_ms(lambda: A.flash_fwd_plain(
            q, k, v, scale, causal, block_q=128, block_k=128)),
        max_abs_err=max(errs["o"], errs["lse"]))
    res["flash_bwd_dq"] = dict(
        ms=cuda_ms(lambda: K.flash_bwd_dq(q, k, v, do, lse_p, delta, scale,
                                          causal)),
        plain_ms=cuda_ms(lambda: A.flash_bwd_dq_plain(
            q, k, v, do, lse_p, delta, scale, causal, 128, 128)),
        max_abs_err=errs["dq"])
    res["flash_bwd_dkv"] = dict(
        ms=cuda_ms(lambda: K.flash_bwd_dkv(q, k, v, do, lse_p, delta, scale,
                                           causal)),
        plain_ms=cuda_ms(lambda: A.flash_bwd_dkv_plain(
            q, k, v, do, lse_p, delta, scale, causal, 128, 128)),
        max_abs_err=max(errs["dk"], errs["dv"]))

    # Library yardstick: SDPA on [B,H,S,D] views, GQA by index.
    F = torch.nn.functional
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=True)
    res["flash_fwd"]["library_ms"] = cuda_ms(sdpa)
    out = sdpa()
    sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True))
    check(max_err(out.transpose(1, 2), o) <= TOL_BF16_O,
          "SDPA disagrees with the forward kernel")
    # SDPA's backward computes dq, dk and dv in one call: the yardstick of
    # the pair, given to both backward kernels.
    res["flash_bwd_dq"]["library_ms"] = sdpa_bwd_ms
    res["flash_bwd_dkv"]["library_ms"] = sdpa_bwd_ms

    # Bounds: the larger of FLOPs over the bf16 peak and bytes over HBM.
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    el = q.element_size()
    qb, kb, sb = q.numel() * el, k.numel() * el, b * h * s * 4
    work = {"flash_fwd": (4 * d * pairs, qb + 2 * kb + qb + sb),
            "flash_bwd_dq": (6 * d * pairs, 2 * qb + 2 * kb + 2 * sb + qb),
            "flash_bwd_dkv": (8 * d * pairs,
                              2 * qb + 2 * kb + 2 * sb + 2 * kb)}
    for n, (flops, nbytes) in work.items():
        tf, tb = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
        res[n].update(bound_ms=max(tf, tb),
                      bound_by="operations" if tf >= tb else "bytes",
                      tflops=flops / res[n]["ms"] / 1e9)
    log(f"timing ({name}): " + json.dumps(res))
    log(f"sdpa backward (dq, dk and dv in one call): {sdpa_bwd_ms:.4f} ms "
        f"vs dq + dk/dv kernels "
        f"{res['flash_bwd_dq']['ms'] + res['flash_bwd_dkv']['ms']:.4f} ms")
    return res


def check_with_lse(name, b, s, h, hk, d, seed):
    """``flash_attention_with_lse`` with ``out_dtype=f32`` through autograd
    (o and the lse cotangent), card against CPU on the same bf16 inputs:
    the one path that launches the bf16-in, f32-out forward. The CPU's
    plain version runs over 128-key tiles, as the kernel does, so that the
    bf16 P of the row sum below head_dim 128 is rounded alike on both."""
    from tony_tpu_torch.ops.attention import flash_attention_with_lse

    cpu = [t.cpu() for t in make_case(b, s, h, hk, d, torch.bfloat16, seed)]
    outs = []
    for dev in ("cuda", "cpu"):
        q, k, v, do = (t.to(dev).requires_grad_(i < 3)
                       for i, t in enumerate(cpu))
        o, lse = flash_attention_with_lse(q, k, v, block_q=128, block_k=128,
                                          out_dtype=torch.float32)
        loss = (o * do.float()).sum() + torch.sin(lse).sum()
        grads = torch.autograd.grad(loss, (q, k, v))
        outs.append([t.detach().cpu() for t in (o, lse, *grads)])
    check(outs[0][0].dtype == torch.float32, "out_dtype f32 not honoured")
    errs = {n: rel_err(x, y) for n, x, y in
            zip(("o", "lse", "dq", "dk", "dv"), *outs)}
    lse_mean = (outs[0][1] - outs[1][1]).abs().mean().item()
    log(f"with_lse {name} bf16 -> f32 out, card vs cpu: rel err "
        f"{json.dumps(errs)}, lse mean abs err {lse_mean:.3e}")
    for n, e in errs.items():
        check(e <= TOL_BF16_GRAD_REL, f"with_lse {name} {n} rel err {e}")
    check(lse_mean <= TOL_BF16_LSE_MEAN,
          f"with_lse {name} lse mean abs err {lse_mean}")


def phase_kernels():
    from tony_tpu_torch.models.transformer import TransformerConfig

    res = check_case("flagship bf16 B4 S2048 H8/4 D128 causal",
                     4, 2048, 8, 4, 128, torch.bfloat16, True, 0,
                     timed=True, deterministic=True)
    llama = TransformerConfig.llama3_8b()
    h, hk = llama.n_heads, llama.n_kv_heads
    d = llama.dim // h
    res_llama = check_case(f"llama3-8b bf16 B1 S2048 H{h}/{hk} D{d} causal",
                           1, 2048, h, hk, d, torch.bfloat16, True, 5,
                           timed=True)
    for name, r in res_llama.items():
        res[name]["llama3_8b"] = {k: r[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "tflops",
            "max_abs_err")}
    check_case("ragged bf16 B2 S1000 H8/2 D64 non-causal",
               2, 1000, 8, 2, 64, torch.bfloat16, False, 1)
    check_case("ragged bf16 B2 S1000 H8/2 D64 causal",
               2, 1000, 8, 2, 64, torch.bfloat16, True, 7)
    check_case("ragged bf16 B1 S1000 H4/4 D128 causal",
               1, 1000, 4, 4, 128, torch.bfloat16, True, 2)
    check_case("f32 B1 S256 H4/2 D64 causal",
               1, 256, 4, 2, 64, torch.float32, True, 3)
    check_case("f32 B1 S200 H2/1 D128 non-causal",
               1, 200, 2, 1, 128, torch.float32, False, 4)
    # The f32-out forward at both head dims; S = 1000 leaves a ragged tail.
    check_with_lse("B1 S256 H4/2 D64", 1, 256, 4, 2, 64, 6)
    check_with_lse("ragged B1 S1000 H4/2 D128", 1, 1000, 4, 2, 128, 8)
    return res


def phase_small_model():
    """A small f32 decoder (head_dim 64) on the card, through the kernels,
    against the same weights on the CPU, through the plain versions."""
    from tony_tpu_torch.models.transformer import (Transformer,
                                                   TransformerConfig,
                                                   causal_lm_loss)

    cfg = TransformerConfig.tiny(vocab_size=512, dim=256, n_heads=4,
                                 n_kv_heads=2, mlp_dim=512, max_seq_len=256)
    cpu = Transformer(cfg, device="cpu")
    gpu = Transformer(cfg, device="cuda",
                      generator=torch.Generator("cuda").manual_seed(1))
    gpu.load_state_dict(cpu.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 256)))
    losses = []
    for model, tok in ((cpu, tokens), (gpu, tokens.cuda())):
        loss = causal_lm_loss(model(tok), tok)
        loss.backward()
        losses.append(loss.item())
    worst = max(rel_err(g.grad.cpu(), c.grad) for c, g in
                zip(cpu.parameters(), gpu.parameters()))
    log(f"small f32 decoder: loss card {losses[1]:.6f} cpu {losses[0]:.6f}; "
        f"worst grad rel err {worst:.3e}")
    check(abs(losses[0] - losses[1]) <= TOL_MODEL_REL * abs(losses[0]),
          "small decoder loss differs between card and CPU")
    check(worst <= TOL_MODEL_REL, f"small decoder grad rel err {worst}")


def check_convfuse_case(name, shape, dtype, relu, seed, timed=False):
    """The convfuse apply kernel against its plain version on one case."""
    from tony_tpu_torch.ops import _convfuse_cuda as K
    from tony_tpu_torch.ops import convfuse as C

    bsz, rows, c = shape
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
        "cuda", dtype)
    # a, b as folded_affine makes them: a ~ scale/std, b ~ bias − mean·a.
    a = torch.from_numpy(1.0 + 0.3 * rng.standard_normal(
        (bsz, c), dtype=np.float32)).cuda()
    b = torch.from_numpy(0.3 * rng.standard_normal(
        (bsz, c), dtype=np.float32)).cuda()
    y = K.apply(x, a, b, relu)
    y_p = C.apply_plain(x, a, b, relu)
    torch.cuda.synchronize()
    check(y.dtype == dtype and y.shape == x.shape, f"{name}: dtype/shape")
    check(bool(torch.isfinite(y).all()), f"{name}: y not finite")
    diff = (y.float() - y_p.float()).abs()
    err = diff.max().item()
    if dtype == torch.bfloat16:
        worst = (diff - TOL_CF_BF16_ULP * y_p.float().abs()).max().item()
        check(worst <= 0, f"{name}: more than one bf16 ulp off (max abs "
              f"err {err})")
    else:
        tol = TOL_CF_F32 * y_p.abs().max().item()
        check(err <= tol, f"{name}: max abs err {err} > {tol}")
    log(f"convfuse {name}: max abs err {err}, exact "
        f"{bool(torch.equal(y, y_p))}")
    if not timed:
        return None

    res = dict(ms=cuda_ms(lambda: K.apply(x, a, b, relu)),
               plain_ms=cuda_ms(lambda: C.apply_plain(x, a, b, relu)),
               max_abs_err=err, library_ms=None)
    # Bound: x read once, y written once, a and b read once; 3 flops an
    # element (mul, add, max) at the f32 non-tensor-core rate.
    nbytes = 2 * x.numel() * x.element_size() + 2 * a.numel() * 4
    tb = nbytes / PEAK_BYTES * 1e3
    tf = 3 * x.numel() / PEAK_F32 * 1e3
    res.update(bound_ms=max(tb, tf),
               bound_by="bytes" if tb >= tf else "operations",
               gbytes_per_s=nbytes / res["ms"] / 1e6)
    # Yardsticks at the same shape: F.group_norm + relu on the NCHW view
    # (channels_last memory) against the port's whole fused_groupnorm_relu
    # (stats sweep + folded affine + the kernel). No single PyTorch call
    # computes the apply alone, so library_ms stays null.
    F = torch.nn.functional
    side = math.isqrt(rows)
    x4 = x.view(bsz, side, side, c)                 # NHWC, square images
    scale = torch.ones(c, device="cuda")
    bias = torch.zeros(c, device="cuda")
    with torch.no_grad():
        res["group_norm_relu_ms"] = cuda_ms(lambda: torch.relu(F.group_norm(
            x4.permute(0, 3, 1, 2), 32, scale.to(dtype), bias.to(dtype),
            eps=1e-6)))
        res["fused_groupnorm_relu_ms"] = cuda_ms(
            lambda: C.fused_groupnorm_relu(x4, scale, bias, groups=32))
    log(f"timing (convfuse {name}): " + json.dumps(res))
    return res


def phase_convfuse():
    res = check_convfuse_case("stem bf16 [256, 12544, 64] relu",
                              (256, 112 * 112, 64), torch.bfloat16, True, 10,
                              timed=True)
    check_convfuse_case("stage-3 bf16 [256, 49, 2048] no relu",
                        (256, 49, 2048), torch.bfloat16, False, 11)
    check_convfuse_case("f32 [2, 81, 12] relu", (2, 81, 12), torch.float32,
                        True, 12)
    check_convfuse_case("f32 [3, 100, 64] no relu", (3, 100, 64),
                        torch.float32, False, 13)
    # Channel counts the 16-byte vector does not divide: the scalar path.
    check_convfuse_case("scalar bf16 [2, 81, 12] relu", (2, 81, 12),
                        torch.bfloat16, True, 14)
    check_convfuse_case("scalar f32 [3, 49, 6] no relu", (3, 49, 6),
                        torch.float32, False, 15)
    return res


def phase_small_resnet():
    """A small f32 ResNet (widths 16-128, groups 4: the kernel's vector
    path) on the card, through the convfuse kernel, against the same
    weights on the CPU, through the plain version."""
    from tony_tpu_torch.models import ResNet, ResNetConfig, classification_loss
    from tony_tpu_torch.ops import _convfuse_cuda

    cfg = ResNetConfig.tiny(width=16, norm_groups=4)
    cpu = ResNet(cfg, device="cpu")
    gpu = ResNet(cfg, device="cuda",
                 generator=torch.Generator("cuda").manual_seed(1))
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(7)
    images = torch.from_numpy(rng.standard_normal((2, 32, 32, 3),
                                                  dtype=np.float32))
    labels = torch.from_numpy(rng.integers(0, cfg.num_classes, (2,)))
    before = _convfuse_cuda.launch_counts["convfuse_apply"]
    losses = []
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        loss = classification_loss(model(images.to(dev)), labels.to(dev))
        loss.backward()
        losses.append(loss.item())
    launched = _convfuse_cuda.launch_counts["convfuse_apply"] - before
    worst = max(rel_err(g.grad.cpu(), c.grad) for c, g in
                zip(cpu.parameters(), gpu.parameters()))
    log(f"small f32 resnet: loss card {losses[1]:.6f} cpu {losses[0]:.6f}; "
        f"worst grad rel err {worst:.3e}; {launched} kernel launches")
    check(launched == 1 + 3 * 2 + 2, "small resnet did not run the kernel")
    check(abs(losses[0] - losses[1]) <= TOL_MODEL_REL * abs(losses[0]),
          "small resnet loss differs between card and CPU")
    check(worst <= TOL_MODEL_REL, f"small resnet grad rel err {worst}")


def phase_main_path():
    from tony_tpu_torch import trainer
    from tony_tpu_torch.ops import _flash_cuda

    cfg = trainer.flagship_config(seq=2048)
    torch.cuda.reset_peak_memory_stats()
    _flash_cuda.reset_launch_counts()
    r = trainer.measure(cfg, batch=4, seq=2048, steps=STEPS, warmup=2,
                        device="cuda", seed=0)
    counts = dict(_flash_cuda.launch_counts)
    log(f"main path: {r['params']} params, losses {r['losses']}")
    log(f"main path: {r['tokens_per_sec']:.1f} tokens/s, "
        f"{r['step_ms']:.3f} ms/step, MFU {r['mfu_vs_peak_bf16']}, peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"launches {json.dumps(counts)}")
    check(all(math.isfinite(x) for x in r["losses"]), "non-finite loss")
    expected = math.log(cfg.vocab_size) + 0.5
    check(abs(r["losses"][0] - expected) <= 0.5,
          f"first loss {r['losses'][0]} not near ln(vocab) + 1/2")
    for name, n in counts.items():
        check(n == cfg.n_layers * STEPS,
              f"{name} launched {n} times, expected {cfg.n_layers * STEPS}")
    return counts


def profile(label, run_step, kind_of):
    """Where a step's device time goes: torch.profiler over PROFILE_STEPS
    calls of ``run_step`` (after warm ones); kernel time summed by
    ``kind_of(name)``, and the device's idle share of the host-clock
    window."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            run_step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kinds = {}
    top = []
    ops = []          # host-side aten ops by the device time they launched
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CPU
                and e.key.startswith("aten::")
                and e.self_device_time_total > 0):
            ops.append((e.self_device_time_total, e.count, e.key))
        # Kernels and copies only: a user annotation on the device timeline
        # (the optimizer's step range) spans kernels counted already.
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)
                or e.key.startswith("Optimizer.")):
            continue
        us = e.self_device_time_total
        kind = kind_of(e.key.lower())
        kinds[kind] = kinds.get(kind, 0.0) + us
        top.append((us, e.count, e.key[:100]))
    busy = sum(kinds.values())
    n = PROFILE_STEPS
    log(f"profile ({label}): {n} steps, wall {wall_us / n / 1e3:.3f} "
        f"ms/step, device busy {busy / n / 1e3:.3f} ms/step, idle share "
        f"{1 - busy / wall_us:.4f}")
    for kind, us in sorted(kinds.items(), key=lambda kv: -kv[1]):
        log(f"  {kind}: {us / n / 1e3:.3f} ms/step "
            f"({us / busy:.4f} of device time)")
    for us, count, name in sorted(top, reverse=True)[:15]:
        log(f"  {us / n / 1e3:9.3f} ms/step  x{count // n:<4d} {name}")
    log("  by the aten op that launched it:")
    for us, count, name in sorted(ops, reverse=True)[:12]:
        log(f"  {us / n / 1e3:9.3f} ms/step  x{count // n:<4d} {name}")


def phase_profile():
    """Where a flagship step's device time goes, after two warm steps."""
    from tony_tpu_torch import trainer
    from tony_tpu_torch.data import synthetic_lm_batch
    from tony_tpu_torch.parallel import train_step

    cfg = trainer.flagship_config(seq=2048)
    state = trainer.build_state(cfg, "cuda", seed=0)
    batch = synthetic_lm_batch(0, 4, 2048, cfg.vocab_size, device="cuda")
    for _ in range(2):
        train_step(state, batch)

    def kind_of(low):
        return ("flash_fwd" if "flash_fwd" in low else
                "flash_bwd_dq" if "flash_bwd_dq" in low else
                "flash_bwd_dkv" if "flash_bwd_dkv" in low else
                "matmul" if any(w in low for w in ("gemm", "xmma", "nvjet",
                                                   "cutlass")) else
                "other")
    profile("flagship", lambda: train_step(state, batch), kind_of)


def phase_resnet_path():
    """ResNet-50 through the convfuse kernel, then the MNIST MLP."""
    from tony_tpu_torch import trainer
    from tony_tpu_torch.ops import _convfuse_cuda, _flash_cuda

    torch.cuda.reset_peak_memory_stats()
    _convfuse_cuda.reset_launch_counts()
    r = trainer.measure_vision("resnet50", batch=RESNET_BATCH, steps=STEPS,
                               warmup=2, device="cuda", seed=0)
    counts = dict(_convfuse_cuda.launch_counts)
    log(f"resnet50: {r['params']} params, batch {r['batch']}, losses "
        f"{r['losses']}")
    log(f"resnet50: {r['samples_per_sec']:.1f} samples/s, "
        f"{r['step_ms']:.3f} ms/step, MFU {r['mfu_vs_peak_bf16']}, peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"launches {json.dumps(counts)}")
    check(all(math.isfinite(x) for x in r["losses"]), "non-finite loss")
    want = RESNET_LAUNCHES_PER_STEP * STEPS
    check(counts["convfuse_apply"] == want,
          f"convfuse_apply launched {counts['convfuse_apply']} times, "
          f"expected {want}")

    _flash_cuda.reset_launch_counts()
    _convfuse_cuda.reset_launch_counts()
    m = trainer.measure_vision("mnist", batch=MNIST_BATCH, steps=MNIST_STEPS,
                               warmup=2, device="cuda", seed=0)
    log(f"mnist mlp: {m['params']} params, batch {m['batch']}, "
        f"{m['samples_per_sec']:.1f} samples/s, {m['step_ms']:.3f} ms/step, "
        f"losses {m['losses'][0]:.4f} -> {m['losses'][-1]:.4f}")
    check(all(math.isfinite(x) for x in m["losses"]), "non-finite MNIST loss")
    check(not any({**_flash_cuda.launch_counts,
                   **_convfuse_cuda.launch_counts}.values()),
          "the MNIST MLP launched a kernel")
    return counts


def phase_resnet_profile():
    """Where a ResNet-50 step's device time goes, after two warm steps."""
    from tony_tpu_torch import trainer
    from tony_tpu_torch.parallel import train_step

    state = trainer.build_vision_state("resnet50", "cuda", seed=0)
    batch = trainer.vision_batch("resnet50", 0, RESNET_BATCH, device="cuda")
    for _ in range(2):
        train_step(state, batch)

    def kind_of(low):
        return ("convfuse_apply" if "convfuse_apply" in low else
                "convolutions (cuDNN)" if any(w in low for w in (
                    "xmma", "implicit", "conv", "cudnn", "dgrad", "wgrad",
                    "fprop", "cutlass", "gemm", "nvjet")) else
                "optimizer (SGD)" if "multi_tensor" in low else
                "reductions (stats, da/db, pool)" if "reduce" in low else
                "other elementwise")
    profile("resnet50", lambda: train_step(state, batch), kind_of)


def main():
    phase_device()
    phase_build()
    timing = phase_kernels()
    timing["convfuse_apply"] = phase_convfuse()
    phase_small_model()
    phase_small_resnet()
    counts = phase_main_path()
    phase_profile()
    counts.update(phase_resnet_path())
    phase_resnet_profile()
    from tony_tpu_torch.ops import _convfuse_cuda, _flash_cuda

    kernels = []
    for name, spec in {**_flash_cuda.SPECS, **_convfuse_cuda.SPECS}.items():
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tony_tpu_torch/csrc/{spec.source}",
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            **{k: t[k] for k in ("tflops", "llama3_8b") if k in t}})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


REPLACES = {
    "flash_fwd": "tony_tpu/ops/attention.py:165",
    "flash_bwd_dq": "tony_tpu/ops/attention.py:258",
    "flash_bwd_dkv": "tony_tpu/ops/attention.py:303",
    "convfuse_apply": "tony_tpu/ops/convfuse.py:90",
}

if __name__ == "__main__":
    main()
