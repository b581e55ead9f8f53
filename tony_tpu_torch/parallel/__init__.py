"""Training state and the single-device train step."""

from tony_tpu_torch.parallel.train import (  # noqa: F401
    TrainState, adamw, sgd, train_step,
)
