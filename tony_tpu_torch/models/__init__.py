"""The flagship decoder, the MoE decoder, ResNet and the MNIST MLP."""

from tony_tpu_torch.models.transformer import (  # noqa: F401
    Transformer, TransformerConfig, causal_lm_loss, chunked_causal_lm_loss,
)
from tony_tpu_torch.models.mlp import (  # noqa: F401
    MnistMLP, classification_loss,
)
from tony_tpu_torch.models.resnet import ResNet, ResNetConfig  # noqa: F401
from tony_tpu_torch.models.moe import (  # noqa: F401
    MoEConfig, MoETransformer, moe_lm_loss,
)
