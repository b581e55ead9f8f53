"""Environment-variable names the port's training loop reads.

The names and strings of ``tony_tpu/constants.py`` that ``telemetry.py`` and
``profiler.py`` touch; the rest of that contract comes with the control
plane.
"""

# File the user process's telemetry reporter writes device stats to; the
# executor's task monitor tails it (see telemetry.py).
METRICS_FILE = "TONY_METRICS_FILE"
# Override for the telemetry reporter's write cadence in seconds (default
# 3.0). Progress-liveness tests tighten it so the step counter publishes
# faster than the configured progress deadline.
TELEMETRY_INTERVAL_ENV = "TONY_TELEMETRY_INTERVAL_S"
# Signal number the executor exports into the user environment for
# hung-task diagnostics: telemetry.install_stack_dump_handler registers a
# faulthandler all-thread stack dump on it, and the executor delivers it to
# the user process group when the coordinator declares the task HUNG.
STACKDUMP_SIGNAL = "TONY_STACKDUMP_SIGNAL"
# Chief-only trace destination (profiler.py contract).
PROFILE_DIR = "TONY_PROFILE_DIR"
# On-demand device profiling: path of the JSON request file the executor
# writes when a PROFILE directive rides the heartbeat response; the user
# process's telemetry reporter polls it and arms torch.profiler at the next
# step boundary (telemetry.py).
PROFILE_REQUEST_ENV = "TONY_PROFILE_REQUEST_FILE"
