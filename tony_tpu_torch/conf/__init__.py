from tony_tpu_torch.conf.config import TonyTpuConfig  # noqa: F401
from tony_tpu_torch.conf import keys  # noqa: F401
