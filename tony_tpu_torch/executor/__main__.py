"""`python -m tony_tpu_torch.executor` — the per-task agent entrypoint
(reference ``TaskExecutor.main`` :211)."""

import sys

from tony_tpu_torch.executor.executor import main

sys.exit(main())
