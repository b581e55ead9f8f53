"""The flagship decoder."""

from tony_tpu_torch.models.transformer import (  # noqa: F401
    Transformer, TransformerConfig, causal_lm_loss, chunked_causal_lm_loss,
)
