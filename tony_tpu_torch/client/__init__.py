from tony_tpu_torch.client.client import (  # noqa: F401
    TaskUpdateListener, TonyTpuClient,
)
