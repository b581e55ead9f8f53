from tony_tpu_torch.executor.executor import TaskExecutor  # noqa: F401
