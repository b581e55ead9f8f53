from tony_tpu_torch.runtimes.base import Runtime, TaskIdentity, get_runtime  # noqa: F401
