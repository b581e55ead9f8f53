from tony_tpu_torch.events.events import Event, EventType, EventHandler  # noqa: F401
from tony_tpu_torch.events import history  # noqa: F401
