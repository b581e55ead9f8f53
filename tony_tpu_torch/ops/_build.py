"""Build and load the hand-written CUDA kernels of ``tony_tpu_torch/csrc``.

Every kernel is one ``.cu`` source with a plain C entry point. At first use
each source is compiled by its own ``nvcc`` (all that are asked for at
once) for ``sm_90a`` into a shared library under
``tony_tpu_torch/_build/<hash of every csrc file and the flags>/``, and its
entry point is loaded with ``ctypes``. Nothing is downloaded and nothing is
built at import.

The kernel families (``_flash_cuda``, ``_convfuse_cuda``) name their
kernels as ``Kernel`` specs and call ``build`` with them; ``fn`` returns a
loaded entry point. The helpers below are the launch discipline both
families share: check each tensor, launch on PyTorch's current stream,
raise on a non-zero CUDA error.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Mapping, Sequence, Tuple

import torch

from tony_tpu_torch.utils import durable

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


@dataclasses.dataclass(frozen=True)
class Kernel:
    """One kernel: its source under ``csrc/``, its C entry point and the
    entry point's ctypes argument types (``P`` for each pointer and the
    stream, so that ctypes does not cut them to 32 bits)."""
    source: str
    entry: str
    argtypes: Tuple[type, ...]


_lock = threading.Lock()
_fns: Dict[str, ctypes._CFuncPtr] = {}
_out_dir = ""          # the build directory, hashed at the first build


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the CUDA kernels are built from source")
    return found


def source_hash() -> str:
    """Hash of the flags and of every ``.cu``/``.cuh`` file in csrc."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC_DIR)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC_DIR, name), "rb") as f:
                h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build(kernels: Mapping[str, Kernel]) -> Dict[str, object]:
    """Compile the kernels not yet built (one ``nvcc`` each, all at once)
    and load every one of ``kernels``; idempotent.

    Returns the build directory and the seconds this call took. Each
    source's ``nvcc`` output, with its ``ptxas -v`` report (registers,
    shared memory, spills), stays beside its library as ``<name>.log``."""
    global _out_dir
    if all(n in _fns for n in kernels):           # the launch-time path
        return {"dir": _out_dir, "seconds": 0.0}
    with _lock:
        t0 = time.perf_counter()
        out_dir = _out_dir = _out_dir or os.path.join(BUILD_ROOT,
                                                      source_hash())
        todo = {n: k for n, k in kernels.items() if n not in _fns}
        os.makedirs(out_dir, exist_ok=True)
        procs: Dict[str, Tuple[subprocess.Popen, str, str]] = {}
        for name, k in todo.items():
            lib = os.path.join(out_dir, f"lib{name}.so")
            if os.path.exists(lib):
                continue
            tmp = f"{lib}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC_DIR, k.source)]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, lib)
        failed = []
        for name, (proc, tmp, lib) in procs.items():
            out, _ = proc.communicate()
            with open(os.path.join(out_dir, f"{name}.log"), "w") as f:
                f.write(out)
            if proc.returncode != 0:
                failed.append(f"{name} (nvcc exit {proc.returncode}):\n{out}")
            else:
                # A library adopted after a crash must be whole: fsync
                # it before the rename, and the directory after.
                durable.fsync_path(tmp)
                durable.durable_replace(tmp, lib)
        if failed:
            raise RuntimeError("CUDA kernel build failed: "
                               + "\n".join(failed))
        for name, k in todo.items():
            entry = getattr(ctypes.CDLL(os.path.join(out_dir,
                                                     f"lib{name}.so")),
                            k.entry)
            entry.argtypes = list(k.argtypes)
            entry.restype = ctypes.c_int
            _fns[name] = entry
        return {"dir": out_dir, "seconds": time.perf_counter() - t0}


def fn(name: str) -> ctypes._CFuncPtr:
    """The loaded entry point of kernel ``name`` (after ``build``)."""
    return _fns[name]


def check_tensor(name: str, t: torch.Tensor,
                 dtypes: Sequence[torch.dtype]) -> None:
    """A CUDA tensor of one of ``dtypes``, contiguous, 16-byte aligned."""
    if not t.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got "
                         f"one on {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected one of "
                        f"{list(dtypes)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the CUDA kernel takes contiguous tensors")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def raise_on(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
