"""Build, load and launch the hand-written CUDA flash-attention kernels.

The sources are ``tony_tpu_torch/csrc/flash_{fwd,bwd_dq,bwd_dkv}.cu``, with
``hopper_common.cuh`` (the bf16 kernels: TMA loads, ``mbarrier`` rings and
``wgmma`` products with register accumulators; sm_90a only) and
``flash_common.cuh`` (the f32 kernels: FMA products over shared-memory
tiles). At first use they are compiled (one ``nvcc`` each, all three at
once) and loaded by ``ops/_build.py``. Nothing is downloaded and nothing is
built at import. The bf16 kernels build their TMA tensor maps from the
pointers and shapes given here, so the tensors must be contiguous and
16-byte aligned, as ``_check`` demands.

Each launch function checks its tensors, allocates the outputs, launches on
PyTorch's current stream, raises if the C function returns a CUDA error, and
adds one to its entry in ``launch_counts``. Callers that want to see which
kernels a run went through reset the counts to 0 before it and read them
after.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from tony_tpu_torch.ops import _build
from tony_tpu_torch.ops._build import F as _F, I as _I, P as _P

SPECS = {
    # q, k, v, o, lse; B, H, Hkv, Sq, Sk, D, dtype, out_f32; scale, causal,
    # stream
    "flash_fwd": _build.Kernel("flash_fwd.cu", "tt_flash_fwd",
                               (_P,) * 5 + (_I,) * 8 + (_F, _I, _P)),
    # q, k, v, do, lse, delta, dq; B, H, Hkv, Sq, Sk, D, dtype; scale,
    # causal, stream
    "flash_bwd_dq": _build.Kernel("flash_bwd_dq.cu", "tt_flash_bwd_dq",
                                  (_P,) * 7 + (_I,) * 7 + (_F, _I, _P)),
    # q, k, v, do, lse, delta, dk, dv; B, H, Hkv, Sq, Sk, D, dtype; scale,
    # causal, stream
    "flash_bwd_dkv": _build.Kernel("flash_bwd_dkv.cu", "tt_flash_bwd_dkv",
                                   (_P,) * 8 + (_I,) * 7 + (_F, _I, _P)),
}
# kernel name -> (source file, C entry point)
KERNELS = {name: (k.source, k.entry) for name, k in SPECS.items()}
HEAD_DIMS = (64, 128)

# Launches per kernel since the last reset (plain integers, see module doc).
launch_counts: Dict[str, int] = {name: 0 for name in KERNELS}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def build() -> Dict[str, object]:
    """Compile (if not yet built) and load the three kernels; idempotent.
    Returns ``_build.build``'s report."""
    return _build.build(SPECS)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    _build.check_tensor(name, t, (dtype,))


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
        err = _build.fn("flash_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, hk, sq, sk, d,
            int(q.dtype == torch.float32), int(out_dtype != q.dtype),
            float(scale), int(causal), _build.stream(q))
    _build.raise_on("flash_fwd", err)
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
        err = _build.fn("flash_bwd_dq")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, hk, sq,
            sk, d, int(q.dtype == torch.float32), float(scale), int(causal),
            _build.stream(q))
    _build.raise_on("flash_bwd_dq", err)
    launch_counts["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, scale: float, causal: bool):
    """(dk, dv) [B,Sk,Hkv,D] in k's and v's dtype, summed over the group."""
    b, h, hk, sq, sk, d = _check_bwd(q, k, v, do, lse, delta, causal)
    build()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = _build.fn("flash_bwd_dkv")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, hk, sq, sk, d, int(q.dtype == torch.float32), float(scale),
            int(causal), _build.stream(q))
    _build.raise_on("flash_bwd_dkv", err)
    launch_counts["flash_bwd_dkv"] += 1
    return dk, dv
