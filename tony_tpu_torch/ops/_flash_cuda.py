"""Build, load and launch the hand-written CUDA flash-attention kernels.

The sources are ``tony_tpu_torch/csrc/flash_{fwd,bwd_dq,bwd_dkv}.cu``. At
first use each is compiled by its own ``nvcc`` (all three at once) for
``sm_90a`` into a shared library with a plain C interface, under
``tony_tpu_torch/_build/<hash of the sources and flags>/``, and loaded with
``ctypes``. Nothing is downloaded and nothing is built at import.

Each launch function checks its tensors, allocates the outputs, launches on
PyTorch's current stream, raises if the C function returns a CUDA error, and
adds one to its entry in ``launch_counts``. Callers that want to see which
kernels a run went through reset the counts to 0 before it and read them
after.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional, Tuple

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(PKG_DIR, "_build")
HEADERS = ("flash_common.cuh",)
# kernel name -> (source file, C entry point)
KERNELS = {
    "flash_fwd": ("flash_fwd.cu", "tt_flash_fwd"),
    "flash_bwd_dq": ("flash_bwd_dq.cu", "tt_flash_bwd_dq"),
    "flash_bwd_dkv": ("flash_bwd_dkv.cu", "tt_flash_bwd_dkv"),
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HEAD_DIMS = (64, 128)

# Launches per kernel since the last reset (plain integers, see module doc).
launch_counts: Dict[str, int] = {name: 0 for name in KERNELS}

_lock = threading.Lock()
_fns: Dict[str, ctypes._CFuncPtr] = {}
build_info: Dict[str, object] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {
    # q, k, v, o, lse; B, H, Hkv, Sq, Sk, D, dtype, out_f32; scale, causal,
    # stream
    "flash_fwd": [_P] * 5 + [_I] * 8 + [_F, _I, _P],
    # q, k, v, do, lse, delta, dq; B, H, Hkv, Sq, Sk, D, dtype; scale,
    # causal, stream
    "flash_bwd_dq": [_P] * 7 + [_I] * 7 + [_F, _I, _P],
    # q, k, v, do, lse, delta, dk, dv; B, H, Hkv, Sq, Sk, D, dtype; scale,
    # causal, stream
    "flash_bwd_dkv": [_P] * 8 + [_I] * 7 + [_F, _I, _P],
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the flash kernels are built from source")
    return found


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(HEADERS + tuple(s for s, _ in KERNELS.values())):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build() -> Dict[str, object]:
    """Compile (if not yet built) and load the three kernels; idempotent.

    Returns ``build_info``: the build directory, the seconds the build
    took (0 when the libraries were already there) and each source's
    ``ptxas -v`` report (registers, shared memory, spills)."""
    with _lock:
        if _fns:
            return build_info
        out_dir = os.path.join(BUILD_ROOT, _source_hash())
        os.makedirs(out_dir, exist_ok=True)
        t0 = time.perf_counter()
        procs: Dict[str, Tuple[subprocess.Popen, str, str]] = {}
        for name, (src, _) in KERNELS.items():
            lib = os.path.join(out_dir, f"lib{name}.so")
            if os.path.exists(lib):
                continue
            tmp = f"{lib}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC_DIR, src)]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, lib)
        logs = {}
        failed = []
        for name, (proc, tmp, lib) in procs.items():
            out, _ = proc.communicate()
            logs[name] = out
            with open(os.path.join(out_dir, f"{name}.log"), "w") as f:
                f.write(out)
            if proc.returncode != 0:
                failed.append(f"{name} (nvcc exit {proc.returncode}):\n{out}")
            else:
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError("flash kernel build failed: "
                               + "\n".join(failed))
        seconds = time.perf_counter() - t0
        for name, (_, entry) in KERNELS.items():
            fn = getattr(ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so")),
                         entry)
            fn.argtypes = _ARGTYPES[name]
            fn.restype = ctypes.c_int
            _fns[name] = fn
        build_info.update(dir=out_dir, seconds=seconds, ptxas=logs)
        return build_info


def _check(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got "
                         f"one on {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the CUDA kernel takes contiguous tensors")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def _check_qkv(q, k, v, causal) -> Tuple[int, ...]:
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash CUDA kernels take bf16 or f32, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q.dtype)
        if t.dim() != 4:
            raise ValueError(f"{name}: expected [B, S, H, D], got "
                             f"{tuple(t.shape)}")
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash CUDA kernels take head_dim in {HEAD_DIMS}, "
                         f"got {d}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if h % hk:
        raise ValueError(f"q heads {h} not a multiple of kv heads {hk}")
    if causal and sq != sk:
        raise ValueError(f"causal needs seq_q == seq_k, got {sq} vs {sk}")
    return b, h, hk, sq, sk, d


def _raise_on(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd(q, k, v, scale: float, causal: bool,
              out_dtype: Optional[torch.dtype] = None):
    """q [B,Sq,H,D], k/v [B,Sk,Hkv,D] -> (o [B,Sq,H,D], lse [B,H,Sq] f32)."""
    b, h, hk, sq, sk, d = _check_qkv(q, k, v, causal)
    out_dtype = out_dtype or q.dtype
    if out_dtype not in (q.dtype, torch.float32):
        raise TypeError(f"out_dtype {out_dtype} must be q's dtype or f32")
    build()
    o = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _fns["flash_fwd"](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, hk, sq, sk, d,
            int(q.dtype == torch.float32), int(out_dtype != q.dtype),
            float(scale), int(causal), _stream(q))
    _raise_on("flash_fwd", err)
    launch_counts["flash_fwd"] += 1
    return o, lse


def _check_bwd(q, k, v, do, lse, delta, causal):
    dims = _check_qkv(q, k, v, causal)
    b, h, _, sq, _, _ = dims
    _check("do", do, q.dtype)
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} != q {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        _check(name, t, torch.float32)
        if t.shape != (b, h, sq):
            raise ValueError(f"{name}: expected {(b, h, sq)}, got "
                             f"{tuple(t.shape)}")
    return dims


def flash_bwd_dq(q, k, v, do, lse, delta, scale: float, causal: bool):
    """dq [B,Sq,H,D] in q's dtype; delta = rowsum(o·do) − dlse [B,H,Sq]."""
    b, h, hk, sq, sk, d = _check_bwd(q, k, v, do, lse, delta, causal)
    build()
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _fns["flash_bwd_dq"](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, hk, sq,
            sk, d, int(q.dtype == torch.float32), float(scale), int(causal),
            _stream(q))
    _raise_on("flash_bwd_dq", err)
    launch_counts["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, scale: float, causal: bool):
    """(dk, dv) [B,Sk,Hkv,D] in k's and v's dtype, summed over the group."""
    b, h, hk, sq, sk, d = _check_bwd(q, k, v, do, lse, delta, causal)
    build()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = _fns["flash_bwd_dkv"](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, hk, sq, sk, d, int(q.dtype == torch.float32), float(scale),
            int(causal), _stream(q))
    _raise_on("flash_bwd_dkv", err)
    launch_counts["flash_bwd_dkv"] += 1
    return dk, dv
