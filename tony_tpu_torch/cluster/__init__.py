"""Where executors run. ``LocalProcessBackend`` spawns them as local
processes (and ``VirtualExecutorBackend`` simulates wide gangs in one);
``GpuHostBackend`` gang-launches them over a leased slice of GPU hosts
(the counterpart of the reference's ``TpuSliceBackend``), with the fake,
ssh and Cloud TPU API provisioners."""

from tony_tpu_torch.cluster.base import Backend, TaskLaunchSpec  # noqa: F401
from tony_tpu_torch.cluster.local import LocalProcessBackend  # noqa: F401
from tony_tpu_torch.cluster.gpu import (  # noqa: F401
    FakeSliceProvisioner, GpuHostBackend, SliceLease, SliceProvisionError,
    SliceProvisioner, StaticSshProvisioner)
from tony_tpu_torch.cluster.gcloud import (  # noqa: F401
    GcloudSliceLease, GcloudTpuProvisioner, TpuApiClient, TpuApiError)
