"""Build, load and launch the hand-written CUDA flash-attention kernels.

The sources are ``tony_tpu_torch/csrc/flash_{fwd,bwd_dq,bwd_dkv}.cu``, with
``hopper_common.cuh`` (the ``wgmma`` family: TMA loads, ``mbarrier`` rings
and ``wgmma`` products with register accumulators; bf16, sm_90a only) and
``flash_common.cuh`` (the FMA family, bf16 or f32, exact on the CUDA
cores: all three kernels on register micro-tiles fed by a ``cp.async``
ring). At first use they are compiled (one
``nvcc`` each, all three at once) and loaded by ``ops/_build.py``. Nothing is downloaded and
nothing is built at import. The ``wgmma`` kernels build their TMA tensor
maps from the pointers and shapes given here, so the tensors must be
contiguous and 16-byte aligned, as ``_check`` demands.

Every head_dim from 1 up runs on a kernel; ``route`` says which, for each
kernel: bf16 at a multiple of 8 takes ``wgmma`` up to 256 in all three,
every other head_dim up to 256 the FMA family, and every head_dim past 256
(bf16 and f32) the split FMA family, which streams the head dim through the
FMA family's 256-wide tiles in chunks of 256 columns, each block owning
one chunk of the output. Each family is compiled at a few tile widths,
and the true head_dim is a run-time argument: a narrower head (or last
chunk) is zero-filled to the width on its way into shared memory and
stored at its own width. The forward's key tile follows its kernel
(``fwd_key_tile``).

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
    # q, k, v, o, lse; B, H, Hkv, Sq, Sk, d, width, family, dtype, out_f32;
    # scale, causal, stream
    "flash_fwd": _build.Kernel("flash_fwd.cu", "tt_flash_fwd",
                               (_P,) * 5 + (_I,) * 10 + (_F, _I, _P)),
    # q, k, v, do, lse, delta, dq; B, H, Hkv, Sq, Sk, d, width, family,
    # dtype; scale, causal, stream
    "flash_bwd_dq": _build.Kernel("flash_bwd_dq.cu", "tt_flash_bwd_dq",
                                  (_P,) * 7 + (_I,) * 9 + (_F, _I, _P)),
    # q, k, v, do, lse, delta, dk, dv; B, H, Hkv, Sq, Sk, d, width, family,
    # dtype; scale, causal, stream
    "flash_bwd_dkv": _build.Kernel("flash_bwd_dkv.cu", "tt_flash_bwd_dkv",
                                   (_P,) * 8 + (_I,) * 9 + (_F, _I, _P)),
}
# kernel name -> (source file, C entry point)
KERNELS = {name: (k.source, k.entry) for name, k in SPECS.items()}

# The tile widths each kernel's families are compiled at (the C entry
# points' switches).
WGMMA_WIDTHS = {"flash_fwd": (64, 128, 256), "flash_bwd_dq": (64, 128, 256),
                "flash_bwd_dkv": (64, 128, 256)}
# The FMA family's widths: all three have a 16-wide tile (the tiny
# decoders' head_dim 16).
FMA_WIDTHS = {"flash_fwd": (16, 32, 64, 128, 256),
              "flash_bwd_dq": (16, 32, 64, 128, 256),
              "flash_bwd_dkv": (16, 32, 64, 128, 256)}
# Past this width every head_dim runs on the split FMA family, in chunks of
# it (``SPLIT`` in ``csrc/flash_common.cuh``).
SPLIT_WIDTH = 256
FAMILIES = {"wgmma": 0, "fma": 1, "fma_split": 2}


def route(d: int, dtype: torch.dtype, kernel: str) -> Tuple[str, int]:
    """The family and the compiled tile width that ``kernel`` (one of
    ``KERNELS``) runs head_dim ``d`` of ``dtype`` on: ``("wgmma", the
    narrowest of WGMMA_WIDTHS[kernel] that holds d)`` for bf16 at a multiple
    of 8 (a TMA row must be a whole number of 16 bytes; all three kernels
    have a wgmma tile up to 256), else ``("fma", the narrowest of
    FMA_WIDTHS[kernel] that holds d)``; past ``SPLIT_WIDTH``, in either
    dtype, ``("fma_split", SPLIT_WIDTH)``. Raises ``ValueError`` for d < 1,
    ``TypeError`` for another dtype, ``KeyError`` for another kernel."""
    widths = WGMMA_WIDTHS[kernel]
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash CUDA kernels take bf16 or f32, got {dtype}")
    if d < 1:
        raise ValueError(f"flash CUDA kernels take a head_dim of at least 1, "
                         f"got {d}")
    if d > SPLIT_WIDTH:
        return "fma_split", SPLIT_WIDTH
    if dtype == torch.bfloat16 and d % 8 == 0 and d <= widths[-1]:
        return "wgmma", next(w for w in widths if d <= w)
    return "fma", next(w for w in FMA_WIDTHS[kernel] if d <= w)


def fwd_key_tile(d: int, dtype: torch.dtype) -> int:
    """Keys per tile of the forward kernel that ``route(d, dtype,
    "flash_fwd")`` picks: 128 on ``wgmma`` at width 64 and 128, 80 on
    ``wgmma`` at width 256 (``csrc/flash_fwd.cu``'s ``FwdHop``), 32 on FMA
    at every width (``FwdFma``: GX * TN) and on the split FMA family (its
    ``FwdSplit`` takes ``FwdFma<256>``'s tiles).
    Its online softmax rounds P against the running max of these tiles, so
    a plain version held to it in P's rounding runs over the same tiles."""
    family, width = route(d, dtype, "flash_fwd")
    if family in ("fma", "fma_split"):
        return 32
    return 80 if width == 256 else 128

# Launches per kernel since the last reset (plain integers, see module doc),
# and per (kernel, family, tile width): which compiled kernel each ran on.
launch_counts: Dict[str, int] = {name: 0 for name in KERNELS}
route_counts: Dict[Tuple[str, str, int], int] = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
    route_counts.clear()


def _launched(kernel: str, family: str, width: int) -> None:
    launch_counts[kernel] += 1
    key = (kernel, family, width)
    route_counts[key] = route_counts.get(key, 0) + 1


def build() -> Dict[str, object]:
    """Compile (if not yet built) and load the three kernels; idempotent.
    Returns ``_build.build``'s report."""
    return _build.build(SPECS)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    _build.check_tensor(name, t, (dtype,))


def _check_qkv(kernel, q, k, v,
               causal) -> Tuple[int, int, int, int, int, int, int, str]:
    """(B, H, Hkv, Sq, Sk, d, width, family) of a valid call of
    ``kernel``."""
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash CUDA kernels take bf16 or f32, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q.dtype)
        if t.dim() != 4:
            raise ValueError(f"{name}: expected [B, S, H, D], got "
                             f"{tuple(t.shape)}")
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    family, width = route(d, q.dtype, kernel)
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if h % hk:
        raise ValueError(f"q heads {h} not a multiple of kv heads {hk}")
    if causal and sq != sk:
        raise ValueError(f"causal needs seq_q == seq_k, got {sq} vs {sk}")
    return b, h, hk, sq, sk, d, width, family


def flash_fwd(q, k, v, scale: float, causal: bool,
              out_dtype: Optional[torch.dtype] = None):
    """q [B,Sq,H,D], k/v [B,Sk,Hkv,D] -> (o [B,Sq,H,D], lse [B,H,Sq] f32)."""
    q, k, v = map(_build.plain, (q, k, v))
    b, h, hk, sq, sk, d, width, family = _check_qkv("flash_fwd", q, k, v,
                                                    causal)
    out_dtype = out_dtype or q.dtype
    if out_dtype not in (q.dtype, torch.float32):
        raise TypeError(f"out_dtype {out_dtype} must be q's dtype or f32")
    build()
    o = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _build.fn("flash_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, hk, sq, sk, d, width, FAMILIES[family],
            int(q.dtype == torch.float32), int(out_dtype != q.dtype),
            float(scale), int(causal), _build.stream(q))
    _build.raise_on("flash_fwd", err)
    _launched("flash_fwd", family, width)
    return o, lse


def _check_bwd(kernel, q, k, v, do, lse, delta, causal):
    dims = _check_qkv(kernel, q, k, v, causal)
    b, h, _, sq = dims[:4]
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
    q, k, v, do, lse, delta = map(_build.plain, (q, k, v, do, lse, delta))
    b, h, hk, sq, sk, d, width, family = _check_bwd(
        "flash_bwd_dq", q, k, v, do, lse, delta, causal)
    build()
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _build.fn("flash_bwd_dq")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, hk, sq,
            sk, d, width, FAMILIES[family], int(q.dtype == torch.float32),
            float(scale), int(causal), _build.stream(q))
    _build.raise_on("flash_bwd_dq", err)
    _launched("flash_bwd_dq", family, width)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, scale: float, causal: bool):
    """(dk, dv) [B,Sk,Hkv,D] in k's and v's dtype, summed over the group."""
    q, k, v, do, lse, delta = map(_build.plain, (q, k, v, do, lse, delta))
    b, h, hk, sq, sk, d, width, family = _check_bwd(
        "flash_bwd_dkv", q, k, v, do, lse, delta, causal)
    build()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = _build.fn("flash_bwd_dkv")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, hk, sq, sk, d, width, FAMILIES[family],
            int(q.dtype == torch.float32), float(scale), int(causal),
            _build.stream(q))
    _build.raise_on("flash_bwd_dkv", err)
    _launched("flash_bwd_dkv", family, width)
    return dk, dv
