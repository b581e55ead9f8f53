"""Configuration keys the port's training loop reads.

The part of ``tony_tpu/conf/keys.py`` that ``parallel/grad_sync.py`` and
``faults.install_from_conf`` read, with the same names, key strings,
defaults and types; the rest of the registry comes with the control plane.
A conf object is anything with ``get(name, default)`` and
``get_int(name, default)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict


@dataclasses.dataclass(frozen=True)
class ConfigKey:
    name: str
    default: Any
    type: type
    doc: str
    multi_value: bool = False  # append-on-merge


_REGISTRY: Dict[str, ConfigKey] = {}


def _key(name: str, default: Any, typ: type, doc: str, multi_value: bool = False) -> str:
    _REGISTRY[name] = ConfigKey(name, default, typ, doc, multi_value)
    return name


# --- training hot loop (parallel/grad_sync.py) -----------------------------
TRAIN_ACCUM_STEPS = _key(
    "tony.train.accum-steps", 1, int,
    "Microbatched gradient accumulation: the global batch is split into "
    "this many microbatches per optimizer step (parallel/grad_sync.py "
    "train_step_accum). Raises the compute:sync ratio. 1 = no "
    "accumulation.")
TRAIN_BUCKET_MB = _key(
    "tony.train.bucket-mb", 32, int,
    "Gradient-sync bucket size in MiB: accumulated grads are all-reduced "
    "bucket-by-bucket in parameter order (order-stable, so results match "
    "the monolithic reduction). A param larger than the bucket gets its "
    "own bucket. Smaller buckets = more collective launches.")
TRAIN_MATMUL_DTYPE = _key(
    "tony.train.matmul-dtype", "", str,
    "Opt-in low-precision matmul path ('int8' | 'fp8_e4m3'). Carried by "
    "GradSyncSpec; the port's models do not read it yet. Empty = "
    "bf16/f32 matmuls.")

# --- fault injection (faults.py) --------------------------------------------
FAULT_SEED = _key(
    "tony.fault.seed", 0, int,
    "Seed for the deterministic fault-injection harness: per-site RNGs "
    "are seeded with (seed, site), and the shared retry-backoff jitter "
    "is seeded too, so a rehearsed failure replays identically.")


def fault_key(site: str) -> str:
    """Conf key for an injection site: 'rpc.send' → 'tony.fault.rpc-send',
    'user.slow_step' → 'tony.fault.user-slow-step' (key names are
    dash-only; site names keep their python-ish underscores)."""
    return f"tony.fault.{site.replace('.', '-').replace('_', '-')}"
