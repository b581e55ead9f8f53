"""Where executors run. ``LocalProcessBackend`` spawns them as local
processes (and ``VirtualExecutorBackend`` simulates wide gangs in one); the
GPU host backend that takes the place of ``cluster/tpu.py`` and
``cluster/gcloud.py`` is ROADMAP A11b."""

from tony_tpu_torch.cluster.base import Backend, TaskLaunchSpec  # noqa: F401
from tony_tpu_torch.cluster.local import LocalProcessBackend  # noqa: F401
