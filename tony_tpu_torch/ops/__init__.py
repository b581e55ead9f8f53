"""Hot-path ops: CUDA kernels on the card, plain PyTorch on the CPU."""

from tony_tpu_torch.ops.attention import (  # noqa: F401
    flash_attention, flash_attention_with_lse, reference_attention,
)
from tony_tpu_torch.ops.convfuse import fused_groupnorm_relu  # noqa: F401
from tony_tpu_torch.ops.quant import (  # noqa: F401
    quantized_matmul, quantize_symmetric, resolve_mode,
)
from tony_tpu_torch.ops.ring import (  # noqa: F401
    ring_attention, ring_attention_sharded,
)
from tony_tpu_torch.ops.ulysses import (  # noqa: F401
    ulysses_attention, ulysses_attention_sharded,
)
