"""tony-tpu in PyTorch and CUDA, for NVIDIA Hopper.

A port of ``tony_tpu``. The training path: the flagship decoder, ResNet,
the MNIST MLP and the MoE decoder (``models``); flash attention and the
fused GroupNorm→ReLU, each with hand-written CUDA kernels for ``sm_90a``
(``ops``, sources in ``csrc/``); the train steps, meshes and gradient sync
(``parallel``); batches (``data``); checkpoints (``checkpoint``); weight
conversion from the flax trees (``convert``) and the trainers
(``trainer``). Entry points run on ``device="cuda"`` and raise without a
CUDA device unless ``"cpu"`` is asked for.

The control plane, the reference's own (``client``, ``cli``,
``coordinator``, ``executor``, ``cluster``, ``runtimes``, ``rpc``,
``events``, ``conf`` and what they use): ``python -m tony_tpu_torch.cli
submit`` stages a job, the coordinator gang-launches executors on the local
backend and runs the cluster-spec barrier, and each executor gives its user
process the PyTorch rendezvous env. The control plane never imports torch.

It imports nothing of JAX or of ``tony_tpu``.

Importing the package inside a task does what ``import tony_tpu`` does
there, each step a no-op (one env read) outside a task: arm the lock
sanitizer and the race detector, start the telemetry reporter, register the
hung-task stack dump and install injected faults.
"""

import time as _time

#: Wall time the package began to import: a job's trainer reports its
#: start-up from it (the interpreter's boot is the time before it).
IMPORT_TS = _time.time()

__version__ = "0.1.0"

# With TONY_LOCK_SANITIZER=1 in the environment, arm the lock sanitizer
# BEFORE any module of the package allocates a lock (telemetry below has
# module-level locks), so executor and coordinator subprocesses of a
# sanitized run join the verdict.
from tony_tpu_torch.devtools import sanitizer as _sanitizer  # noqa: E402

_sanitizer.maybe_enable_from_env()

# Same for the data-race detector (TONY_RACE_DETECTOR=1): it must arm
# BEFORE the @guarded control-plane classes are defined (decoration is the
# instrumentation point) and before any thread starts.
from tony_tpu_torch.devtools import race as _race  # noqa: E402

_race.maybe_enable_from_env()

from tony_tpu_torch import constants  # noqa: E402,F401
from tony_tpu_torch.conf.config import TonyTpuConfig  # noqa: E402,F401

# Inside a task (TONY_METRICS_FILE set by the executor) a bare import is
# enough to start the telemetry reporter: device memory once the process
# has brought CUDA up, and the step counter the executor's first-step span
# and the coordinator's progress liveness read.
from tony_tpu_torch import telemetry as _telemetry  # noqa: E402

_telemetry.maybe_start()

# Inside a task (TONY_STACKDUMP_SIGNAL set by the executor) the same import
# pre-registers the hung-task all-thread stack dump.
_telemetry.install_stack_dump_handler()

# Inside a task whose supervisor exported TONY_FAULTS, arm the fault harness
# for this process too.
from tony_tpu_torch import faults as _faults  # noqa: E402

_faults.install_from_env()
