"""Async checkpointing of the training state (``CheckpointManager``)."""

from tony_tpu_torch.checkpoint.manager import CheckpointManager  # noqa: F401
