"""Training state, the train steps on one device and on a mesh, the mesh
and its sharding rules, checkpoint trees and the bucketed gradient sync."""

from tony_tpu_torch.parallel.grad_sync import (  # noqa: F401
    DEFAULT_BUCKET_MB, GradSyncSpec, accumulate_grads, bucketed_sync,
    monolithic_grads, plan_buckets, train_step_accum,
)
from tony_tpu_torch.parallel.mesh import (  # noqa: F401
    BATCH_AXES, MESH_AXES, MeshSpec, batch_rank, batch_world, build_mesh,
    mesh_shape,
)
from tony_tpu_torch.parallel.sharding import (  # noqa: F401
    DEFAULT_RULES, PARAM_AXES, EmbedParallelTable, Placement,
    VocabParallelTable, param_placements, reshard, shard_model, tp_plan,
)
from tony_tpu_torch.parallel.train import (  # noqa: F401
    AdamWLowPrecisionMu, TrainState, adamw, checkpoint_tree,
    fill_missing_grads, init_sharded_state, load_checkpoint_tree, sgd,
    sharded_train_step, train_step,
)
