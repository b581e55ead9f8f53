"""Shared constant names: environment-variable contract, well-known job names,
file names, and test hooks.

Parity target: reference ``tony-core/src/main/java/com/linkedin/tony/Constants.java``
(env vars :44-62, job names :104-110, test hooks :116-121, file names :139).
The TPU build replaces the four per-framework rendezvous dialects with one
coordinator-address contract, but still exports the legacy framework variables
from the runtimes layer so TF / PyTorch / MXNet user scripts keep working.
"""

# ---------------------------------------------------------------------------
# Core task-identity environment contract (set by the coordinator when
# launching an executor; reference ApplicationMaster.java:1129-1141).
# ---------------------------------------------------------------------------
JOB_NAME = "TONY_JOB_NAME"            # jobtype of this task, e.g. "worker"
TASK_INDEX = "TONY_TASK_INDEX"        # index within the jobtype
TASK_NUM = "TONY_TASK_NUM"            # number of tasks of this jobtype
IS_CHIEF = "TONY_IS_CHIEF"            # "true" iff chief semantics apply
SESSION_ID = "TONY_SESSION_ID"        # retry epoch (reference TonySession.java:51)
APP_ID = "TONY_APP_ID"                # application id
COORDINATOR_HOST = "TONY_COORDINATOR_HOST"
COORDINATOR_PORT = "TONY_COORDINATOR_PORT"
METRICS_PORT = "TONY_METRICS_PORT"    # metrics RPC port on the coordinator
# Coordinator generation this executor was launched under (crash-recovery
# fencing, rpc/wire.py): adopted upward on reconnect, rejected downward.
COORDINATOR_GENERATION = "TONY_COORDINATOR_GENERATION"
# Membership generation of the gang topology this executor was launched
# under (elastic resize fencing, coordinator/elastic.py): bumped on every
# applied resize; survivors adopt the new value from the RESIZE directive
# riding the heartbeat response, and frames carrying a stale value with no
# resize in flight are fenced — a zombie from a pre-resize topology must
# not corrupt the re-meshed gang.
MEMBERSHIP_GEN = "TONY_MEMBERSHIP_GEN"
# Sorted member indices of this executor's jobtype gang at launch/adoption
# time (comma-separated), exported to the user process so elastic-aware
# training loops can map their stable task index to a dense rank.
GANG_MEMBERS = "TONY_GANG_MEMBERS"
# Path to the coordinator's address file (host/port/token JSON). Executors
# re-resolve the coordinator from it after a restart (the recovered
# coordinator binds a fresh ephemeral port and rewrites the file); only
# meaningful where the path is reachable (same host / shared fs) — absent
# or unreadable, reconnects retry the launch-time address.
COORDINATOR_ADDR_FILE = "TONY_COORDINATOR_ADDR_FILE"
# File the user process's telemetry reporter writes device stats to; the
# TaskMonitor tails it (set by the executor; see tony_tpu_torch/telemetry.py).
METRICS_FILE = "TONY_METRICS_FILE"
# Override for the telemetry reporter's write cadence in seconds (default
# 3.0). Progress-liveness tests tighten it so the step counter publishes
# faster than the configured progress deadline.
TELEMETRY_INTERVAL_ENV = "TONY_TELEMETRY_INTERVAL_S"
# Signal number the executor exports into the user environment for
# hung-task diagnostics: `import tony_tpu_torch` pre-registers a faulthandler
# all-thread stack dump on it (telemetry.install_stack_dump_handler), and
# the executor delivers it to the user process group when the coordinator
# declares the task HUNG (progress frozen, heartbeats alive). Default
# SIGUSR1; operators can pre-set it (tony.application.execution-env) to
# move the dump off a signal the user script needs.
STACKDUMP_SIGNAL = "TONY_STACKDUMP_SIGNAL"
# Distributed-tracing context (tony_tpu_torch/tracing.py): the job's trace id
# and the parent span id for this process's root span. The client exports
# them to the coordinator; the coordinator exports them to executors with
# the task's lifecycle span as the parent — one stitched tree per job.
TRACE_ID_ENV = "TONY_TRACE_ID"
TRACE_PARENT_ENV = "TONY_TRACE_PARENT"
TASK_ID = "TONY_TASK_ID"              # "<jobtype>:<index>"
TASK_COMMAND = "TONY_TASK_COMMAND"    # user command for this task
EXECUTOR_CONF = "TONY_EXECUTOR_CONF"  # path to the frozen final config
# Warm-executor-pool adoption (tony_tpu_torch/pool.py): set in the lease env by
# the pool daemon so an adopted executor can mark its spans (register span
# adopted=true, run span pooled=<worker id>) — the trace-visible proof a
# submit skipped the cold spawn. Absent on cold-spawned executors.
POOL_WORKER_ID = "TONY_POOL_WORKER_ID"

# Global-rank contract for the JAX runtime (computed over the whole gang).
GLOBAL_RANK = "TONY_GLOBAL_RANK"
GLOBAL_WORLD = "TONY_GLOBAL_WORLD"

# ---------------------------------------------------------------------------
# Framework rendezvous variables exported by runtimes
# (reference TaskExecutor.java:161-207, Constants.java:44-62).
# ---------------------------------------------------------------------------
TF_CONFIG = "TF_CONFIG"
CLUSTER_SPEC = "CLUSTER_SPEC"
# This task's own reserved rendezvous port (generic servers — notebooks,
# Ray heads — bind it; released to the user process before exec).
TASK_PORT = "TASK_PORT"

# PyTorch (reference Constants.java:50-54)
INIT_METHOD = "INIT_METHOD"
MASTER_ADDR = "MASTER_ADDR"
MASTER_PORT = "MASTER_PORT"
RANK = "RANK"
WORLD = "WORLD"
WORLD_SIZE = "WORLD_SIZE"
# The port's pytorch runtime adds torchrun's per-host pair: this task's
# position among the tasks on its host, and their count. The user process
# takes the card cuda:LOCAL_RANK.
LOCAL_RANK = "LOCAL_RANK"
LOCAL_WORLD_SIZE = "LOCAL_WORLD_SIZE"

# MXNet (reference Constants.java:57-62)
DMLC_PS_ROOT_URI = "DMLC_PS_ROOT_URI"
DMLC_PS_ROOT_PORT = "DMLC_PS_ROOT_PORT"
DMLC_ROLE = "DMLC_ROLE"
DMLC_NUM_SERVER = "DMLC_NUM_SERVER"
DMLC_NUM_WORKER = "DMLC_NUM_WORKER"
DMLC_USE_KUBERNETES = "DMLC_USE_KUBERNETES"

# JAX coordination service (the one uniform TPU-native mechanism; replaces all
# of the above for JAX jobs — SURVEY.md §2.4).
JAX_COORDINATOR_ADDRESS = "JAX_COORDINATOR_ADDRESS"
JAX_NUM_PROCESSES = "JAX_NUM_PROCESSES"
JAX_PROCESS_ID = "JAX_PROCESS_ID"
JAX_COMPILATION_CACHE_DIR = "JAX_COMPILATION_CACHE_DIR"

# TensorBoard (reference Constants.java TB_PORT; TaskExecutor.java:83-95)
TB_PORT = "TB_PORT"

# Shared checkpoint dir for the session-retry resume contract (no reference
# analogue — checkpointing was user-code-only there, SURVEY.md §5).
CHECKPOINT_DIR = "TONY_CHECKPOINT_DIR"

# ---------------------------------------------------------------------------
# Well-known job (task-type) names (reference Constants.java:104-110).
# ---------------------------------------------------------------------------
CHIEF_JOB_NAME = "chief"
PS_JOB_NAME = "ps"
WORKER_JOB_NAME = "worker"
EVALUATOR_JOB_NAME = "evaluator"
SCHEDULER_JOB_NAME = "scheduler"   # MXNet
SERVER_JOB_NAME = "server"         # MXNet
NOTEBOOK_JOB_NAME = "notebook"
DRIVER_JOB_NAME = "driver"

# ---------------------------------------------------------------------------
# File-name constants (reference Constants.java:139 TONY_FINAL_XML and
# HistoryFileUtils.java:12-31 jhist naming).
# ---------------------------------------------------------------------------
FINAL_CONFIG_FILE = "tony-final.json"
# Write-ahead session journal, next to the history stream in the job dir
# (coordinator/journal.py — the crash-recovery source of truth).
JOURNAL_FILE = "session.journal.jsonl"
# Distributed-tracing span log, next to the jhist stream in the job dir
# (tony_tpu_torch/tracing.py): coordinator-written JSON lines; executors ship
# their spans into it over the trace.push RPC.
TRACE_FILE = "trace.spans.jsonl"
# Rendered Prometheus text exposition, refreshed by the coordinator every
# tony.metrics.export-interval-s; the portal's /metrics scrape endpoint
# concatenates these across live jobs.
METRICS_PROM_FILE = "metrics.prom"
# Counter snapshot (tony_tpu_torch/metrics.py save_counters): reloaded by a
# --recover coordinator so counters stay monotonic across recovery.
METRICS_COUNTERS_FILE = "metrics.counters.json"
# Automatic failure diagnosis (tony_tpu_torch/diagnosis/): the incident
# document the coordinator writes on any non-SUCCEEDED finish — verdict
# category, blamed task, evidence, causal timeline. Atomically replaced;
# readers treat a torn/absent file as "recompute from the bundle".
INCIDENT_FILE = "incident.json"
# Warm-executor-pool daemon endpoint (tony_tpu_torch/pool.py): host/port/token
# JSON in the pool dir, 0600 like the coordinator address file. Backends
# try a pool.lease against it before cold-spawning; absent file = no pool.
POOL_ADDR_FILE = "pool.addr"
# Fleet daemon endpoint (tony_tpu_torch/fleet/): host/port/token/generation JSON
# in the fleet dir, 0600 — fleet.submit/status/cancel RPCs resolve it.
FLEET_ADDR_FILE = "fleet.addr"
# Write-ahead fleet journal (tony_tpu_torch/fleet/journal.py): every submission,
# grant, preemption and job state transition, fsync'd BEFORE it is acted
# on — `tony-tpu fleet start --recover` replays it into the same queue
# state (same REC_*/torn-tail discipline as coordinator/journal.py).
FLEET_JOURNAL_FILE = "fleet.journal.jsonl"
# Scheduler status snapshot the daemon atomically replaces every tick
# (queue, grants, tenant occupancy) — the portal's /fleet view and any
# RPC-less reader consume this instead of dialing the daemon.
FLEET_STATUS_FILE = "fleet.status.json"
# Rendered Prometheus exposition of the tony_fleet_* families, refreshed
# every scheduler tick (the fleet-dir analogue of metrics.prom).
FLEET_PROM_FILE = "fleet.prom"
# Counter snapshot (tony_fleet_grants_total etc.), reloaded on
# `fleet start --recover` so fleet counters stay monotonic across daemon
# lives — same contract as METRICS_COUNTERS_FILE.
FLEET_COUNTERS_FILE = "fleet.counters.json"
# Fleet event stream (FLEET_JOB_QUEUED/GRANTED/PREEMPTED/...), JSON lines
# in the fleet dir; append-only across daemon lives (never finalized —
# the fleet is a daemon, not a job).
FLEET_EVENTS_FILE = "fleet.events.jsonl"
# Fleet-level incident document (tony_tpu_torch/fleet/diagnose.py): the rule
# engine's verdict over the goodput ledger + scheduler decision records
# (STARVATION / QUOTA_SATURATED / FRAGMENTATION / PREEMPT_STORM /
# POOL_COLD / FLEET_HEALTHY), atomically replaced by the daemon every
# export and recomputed on demand by `tony-tpu fleet diagnose`. Readers
# treat a torn/absent file as "recompute from the fleet dir".
FLEET_INCIDENT_FILE = "fleet.incident.json"
# Host-health cordon set (tony_tpu_torch/fleet/health.py): {"hosts": {host ->
# state}} atomically replaced by the fleet daemon on every export, in
# BOTH the fleet dir and the warm-pool dir — the pool daemon refuses
# leases for (and discards) workers on listed hosts, and offline tools
# read the live cordon set without dialing the daemon.
FLEET_CORDON_FILE = "health.cordon.json"
# Per-task exit report a POOLED executor writes into its task workdir at
# exit ({"exit_code": N}): the leased process is the pool daemon's child,
# not the backend's, so poll_completions reads this instead of waitpid.
POOL_EXIT_FILE = "pool-exit.json"
EVENTS_SUFFIX = ".jhist.jsonl"
INPROGRESS_SUFFIX = ".jhist.jsonl.inprogress"
HISTORY_INTERMEDIATE = "intermediate"
HISTORY_FINISHED = "finished"

# Env var naming which slice host a task/worker runs on (cluster
# backends set it at exec; pool workers echo it into ready.json so the
# pool daemon can refuse leases on health-cordoned hosts).
HOST_ID_ENV = "TONY_HOST_ID"

# Chief-only XLA trace destination (tony_tpu_torch/profiler.py contract).
PROFILE_DIR = "TONY_PROFILE_DIR"
# Store URL the executor uploads captured traces to post-run (set when a
# remote store is configured — the chief's host can't write the
# coordinator's job dir directly; the coordinator pulls them back at stop).
PROFILE_UPLOAD = "TONY_PROFILE_UPLOAD"
# On-demand device profiling (tony-tpu profile <app>): path of the JSON
# request file the executor writes when a PROFILE directive rides the
# heartbeat response; the user process's telemetry reporter polls it and
# arms jax.profiler at the next step boundary (tony_tpu_torch/telemetry.py).
PROFILE_REQUEST_ENV = "TONY_PROFILE_REQUEST_FILE"
# Basename of that request file in the task working dir (atomic replace;
# the reader tolerates a torn/absent file by ignoring it).
PROFILE_REQUEST_FILE = "profile-request.json"
# Step-time attribution report the coordinator writes into the job dir at
# finish (tony_tpu_torch/profiling/verdict.py): per-phase seconds/fractions and
# the bottleneck verdict. Atomically replaced; torn/absent reads degrade
# to "no perf advisory".
PERF_FILE = "perf.json"

# ---------------------------------------------------------------------------
# Fault-injection test hooks, honoured by production code exactly like the
# reference's (Constants.java:116-121; see SURVEY.md §4.1 hook table).
# ---------------------------------------------------------------------------
TEST_COORDINATOR_CRASH = "TONY_TEST_COORDINATOR_CRASH"
# "<jobtype>" — coordinator kills one task of the type once chief registers
# (reference TEST_WORKER_TERMINATION, ApplicationMaster.java:1224-1235).
TEST_WORKER_TERMINATION = "TONY_TEST_WORKER_TERMINATION"
# "N" — executor silently skips its first N heartbeats
# (reference TaskExecutor.java:330-357).
TEST_NUM_HB_MISS = "TONY_TEST_NUM_HB_MISS"
# "job#idx#seconds" — executor sleeps after the user process exits
# (straggler skew; reference TaskExecutor.java:372-392).
TEST_EXECUTOR_SKEW = "TONY_TEST_EXECUTOR_SKEW"
# "seconds" — delay the coordinator's completion handling (races the
# heartbeat-unregister path; reference ApplicationMaster.java:1029-1038).
TEST_COMPLETION_DELAY = "TONY_TEST_COMPLETION_DELAY"
# any value — executor never registers (simulates an unreachable executor so
# the coordinator-side registration timeout is exercisable E2E; reference
# registration timeout, ApplicationMaster.java:791-888).
TEST_SKIP_REGISTRATION = "TONY_TEST_SKIP_REGISTRATION"
# "<host_id>" or "<host_id>#<path-glob>" — the TpuSliceBackend simulates
# sudden loss of that host (preemption/hardware death), once per job (fake
# provisioner only; exercises slice-lease invalidation → retry). The bare
# form fires on a short post-launch delay; the "#<glob>" form fires only
# once the glob matches an existing path — e.g. a durably committed
# checkpoint step — making preemption-AFTER-checkpoint deterministic
# (reference uses deterministic env-hook faults, Constants.java:116-121).
TEST_SLICE_FAIL_HOST = "TONY_TEST_SLICE_FAIL_HOST"

# Untracked jobtypes: run-forever tasks (parameter servers) whose exit does not
# gate job completion (reference TonyConfigurationKeys.java:252-253).
DEFAULT_UNTRACKED_JOBTYPES = (PS_JOB_NAME,)

# ---------------------------------------------------------------------------
# Kill-chain contract. YARN reaps the whole container process tree for free;
# without a NodeManager the supervisors here must reach the user tree
# themselves (reference stop-with-grace: ApplicationMaster.java:694-711).
# ---------------------------------------------------------------------------
# File (relative to a task's working dir) holding the process-group id of
# the USER command. The executor writes it the moment the user process
# starts, so backends can deliver the TERM→grace→KILL ladder to the user
# tree directly — an executor that was SIGKILLed can forward nothing.
USER_PGID_FILE = "user.pgid"
# Seconds the executor waits after forwarding SIGTERM to the user process
# group before escalating to SIGKILL (env override; default 5).
TASK_KILL_GRACE_ENV = "TONY_TASK_KILL_GRACE_S"

# Exit codes (reference common/TaskStatus semantics, TonySession.java:480-497).
EXIT_SUCCESS = 0
EXIT_FAILURE = 1
EXIT_KILLED = 137     # SIGKILL'd by supervisor / liveness monitor
# 128+SIGTERM: the exit of a task whose user process was TERM'd — the
# preemption-notice path (executor/preemption.py TERMs the user group;
# checkpoint/manager.install_preemption_handler exits with this after its
# final save). Classified as the PREEMPTION failure domain.
EXIT_PREEMPTED = 143
