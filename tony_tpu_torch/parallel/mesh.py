"""Device meshes over ``torch.distributed``.

Counterpart of ``tony_tpu/parallel/mesh.py``. Every parallelism strategy is
a named axis of one ``DeviceMesh`` over the process group, one process per
device:

    dcn_dp  pure data parallelism across hosts or slices (explicit, bucketed
            gradient all-reduce: ``parallel/grad_sync.py``)
    dp      data parallelism with replicated parameters (FSDP2's replicate
            dim, HSDP)
    fsdp    data parallelism with sharded parameters and optimizer state
            (FSDP2's shard dim)
    pp      pipeline stages          (a later slice)
    ep      expert parallelism: the MoE decoder's experts, all-to-all
            dispatch (``models/moe.py``)
    sp      sequence parallelism: ring or Ulysses attention
            (``ops/ring.py``, ``ops/ulysses.py``)
    tp      tensor parallelism (DTensor plans, ``parallel/sharding.py``)

``MESH_AXES``, ``BATCH_AXES`` and ``MeshSpec`` are copies of the reference's,
error messages included. Axes of size 1 stay in the mesh, so the rules are
the same at every size.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# Outermost (slow, DCN-tolerant) → innermost (fast, wants NVLink peers).
MESH_AXES = ("dcn_dp", "dp", "fsdp", "pp", "ep", "sp", "tp")
# Every axis that consumes the batch dim.
BATCH_AXES = ("dcn_dp", "dp", "fsdp")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Sizes for each mesh axis. At most one axis may be -1 (inferred so the
    product equals the device count). Unused axes stay 1 — they are kept in
    the mesh so sharding rules are uniform across strategies."""

    dcn_dp: int = 1
    dp: int = -1
    fsdp: int = 1
    pp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    def sizes(self) -> Sequence[int]:
        return tuple(getattr(self, a) for a in MESH_AXES)

    def resolve(self, n_devices: int) -> "MeshSpec":
        sizes = list(self.sizes())
        bad = [s for s in sizes if s < 1 and s != -1]
        if bad:
            raise ValueError(
                f"axis sizes must be positive or -1 (inferred), got {self}")
        unknown = [i for i, s in enumerate(sizes) if s == -1]
        if len(unknown) > 1:
            raise ValueError(f"at most one axis may be -1, got {self}")
        known = math.prod(s for s in sizes if s != -1)
        if unknown:
            if n_devices % known:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"product {known} in {self}")
            sizes[unknown[0]] = n_devices // known
        elif known != n_devices:
            raise ValueError(
                f"mesh {self} wants {known} devices, have {n_devices}")
        return MeshSpec(**dict(zip(MESH_AXES, sizes)))

    def respec(self, n_devices: int) -> "MeshSpec":
        """Re-solve this spec for a NEW device count: the model axes
        (fsdp/pp/ep/sp/tp) keep their shapes so saved shards stay
        compatible, and the pure-data axis ``dp`` absorbs the delta.
        Raises when the fixed axes don't divide the new count."""
        d = dict(zip(MESH_AXES, self.sizes()))
        d["dp"] = -1
        return MeshSpec(**d).resolve(n_devices)

    @classmethod
    def from_string(cls, s: str) -> "MeshSpec":
        """Parse ``"dp=2,tp=4"`` — the config-file form
        (key ``tony.tpu.mesh-shape``, see ``conf/keys.py``)."""
        kwargs = {}
        for part in filter(None, (p.strip() for p in s.split(","))):
            k, sep, v = part.partition("=")
            if k not in MESH_AXES:
                raise ValueError(f"unknown mesh axis {k!r} (not in "
                                 f"{MESH_AXES})")
            if not sep or not v.lstrip("-").isdigit():
                raise ValueError(
                    f"expected axis=size in {part!r} (e.g. 'tp=4')")
            kwargs[k] = int(v)
        if "dp" not in kwargs:
            kwargs["dp"] = -1
        return cls(**kwargs)


def build_mesh(spec: Optional[MeshSpec] = None,
               device: str = "cuda") -> DeviceMesh:
    """The ``DeviceMesh`` of ``spec`` (resolved against the world size) over
    the initialized process group, axes named ``MESH_AXES``, rank ``r`` at
    the row-major position ``r`` (the innermost axis, tp, over adjacent
    ranks).

    ``device="cuda"`` (the default) needs a CUDA device and an NCCL group
    and raises without either; ``"cpu"`` (gloo) is for the tests. Nothing
    here falls back from one to the other."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("build_mesh needs an initialized "
                           "torch.distributed process group")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("build_mesh(device='cuda'): no CUDA device "
                               "is present; pass device='cpu' for gloo")
        if dist.get_backend() != "nccl":
            raise RuntimeError(
                f"build_mesh(device='cuda') needs an NCCL process group, "
                f"got {dist.get_backend()!r}")
    elif device != "cpu":
        raise ValueError(f"unsupported mesh device {device!r}: 'cuda' or "
                         "'cpu'")
    spec = (spec or MeshSpec()).resolve(dist.get_world_size())
    return init_device_mesh(device, tuple(spec.sizes()),
                            mesh_dim_names=MESH_AXES)


def mesh_shape(mesh: DeviceMesh) -> dict:
    """``{axis: size}`` of a mesh, every axis included."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def batch_rank(mesh: DeviceMesh) -> int:
    """This rank's batch coordinate: its index over the flattened
    ``BATCH_AXES`` (dcn_dp major), the block of the global batch it loads
    (counterpart of ``batch_sharding``). Ranks that differ only in
    pp/ep/sp/tp share it."""
    shape = mesh_shape(mesh)
    i = 0
    for axis in BATCH_AXES:
        i = i * shape[axis] + mesh.get_local_rank(axis)
    return i


def batch_world(mesh: DeviceMesh) -> int:
    """The number of batch coordinates: the product of the batch axes."""
    shape = mesh_shape(mesh)
    return math.prod(shape[axis] for axis in BATCH_AXES)
