"""Training state, the single-device train step, checkpoint trees and the
bucketed gradient sync."""

from tony_tpu_torch.parallel.grad_sync import (  # noqa: F401
    DEFAULT_BUCKET_MB, GradSyncSpec, accumulate_grads, bucketed_sync,
    monolithic_grads, plan_buckets, train_step_accum,
)
from tony_tpu_torch.parallel.train import (  # noqa: F401
    AdamWLowPrecisionMu, TrainState, adamw, checkpoint_tree,
    fill_missing_grads, load_checkpoint_tree, sgd, train_step,
)
