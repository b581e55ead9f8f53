from tony_tpu_torch.coordinator.session import Session, Task, TaskStatus, SessionStatus  # noqa: F401
from tony_tpu_torch.coordinator.scheduler import GangScheduler, SchedulerError  # noqa: F401
from tony_tpu_torch.coordinator.coordinator import Coordinator  # noqa: F401
