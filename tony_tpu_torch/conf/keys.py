"""Configuration key registry: every key, its default, type and documentation.

Parity target: reference ``TonyConfigurationKeys.java`` (287 LoC; dynamic
per-jobtype keys by regex :171-239) and ``resources/tony-default.xml``
(108 properties), whose agreement is enforced by
``TestTonyConfigurationFields.java:17-45``. Here the registry *is* the defaults
file — a single source of truth — and the parity test checks that the
documented defaults table (``tony_tpu_torch/conf/defaults.md``) matches this module.

Naming: dotted lowercase, rooted at ``tony.`` like the reference, so that
reference configs translate mechanically (``tony.worker.instances`` keeps its
meaning; GPU resource keys become chip keys).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional, Pattern, Tuple


@dataclasses.dataclass(frozen=True)
class ConfigKey:
    name: str
    default: Any
    type: type
    doc: str
    multi_value: bool = False  # append-on-merge (reference MULTI_VALUE_CONF :285)


_REGISTRY: Dict[str, ConfigKey] = {}


def _key(name: str, default: Any, typ: type, doc: str, multi_value: bool = False) -> str:
    _REGISTRY[name] = ConfigKey(name, default, typ, doc, multi_value)
    return name


# --- application ----------------------------------------------------------
APPLICATION_NAME = _key(
    "tony.application.name", "tony-tpu", str, "Application display name.")
APPLICATION_FRAMEWORK = _key(
    "tony.application.framework", "pytorch", str,
    "ML framework runtime: jax | tensorflow | pytorch | mxnet | horovod | generic "
    "(reference MLFramework enum TonyConfigurationKeys.java:12-17; jax is new). "
    "The port defaults to pytorch: its own jobs join a torch.distributed "
    "group from the runtime's env.")
APPLICATION_QUEUE = _key(
    "tony.application.queue", "default", str, "Scheduler queue / reservation pool.")
APPLICATION_TIMEOUT_S = _key(
    "tony.application.timeout-s", 0, int,
    "Whole-job wall-clock timeout in seconds; 0 disables "
    "(reference tony.application.timeout, TonyClient.java:874-882).")
APPLICATION_RETRY_COUNT = _key(
    "tony.application.retry-count", 0, int,
    "Coordinator-level whole-job retries for INFRA_TRANSIENT failures "
    "(reference tony.am.retry-count, ApplicationMaster.java:356-371). "
    "USER_ERROR failures are terminal on first occurrence unless "
    "retry-user-errors is set; PREEMPTION failures draw on their own "
    "budget (preemption-retry-count) without consuming this one.")
APPLICATION_PREEMPTION_RETRY_COUNT = _key(
    "tony.application.preemption-retry-count", 3, int,
    "Whole-job retries for PREEMPTION failures (slice host reclaimed, "
    "spot notice, save-on-SIGTERM exits). Preemption is expected infra "
    "churn, so these retries do NOT consume tony.application.retry-count "
    "— a job preempted twice still has its full transient-failure budget. "
    "0 disables free preemption retries (preemptions then fail the job "
    "when retry-count is exhausted).")
APPLICATION_RETRY_USER_ERRORS = _key(
    "tony.application.retry-user-errors", False, bool,
    "Reference-compat escape hatch: when true, USER_ERROR failures "
    "(nonzero user exits) also consume tony.application.retry-count, "
    "like TonY's undiscriminating whole-job retry. Default false: a "
    "deterministic user crash burns retry epochs for nothing.")
APPLICATION_BACKEND = _key(
    "tony.application.backend", "local", str,
    "Cluster substrate: local (subprocesses on this host, the MiniCluster "
    "analogue) | gpu-host (gang over a leased slice of GPU hosts, "
    "cluster/gpu.py — the analogue of YARN container allocation, "
    "ApplicationMaster.java:1051-1175). The reference's tpu-slice is "
    "refused with a pointer to gpu-host.")
SLICE_PROVISIONER = _key(
    "tony.slice.provisioner", "fake", str,
    "gpu-host backend only: fake (LocalSimHostChannel inventory for "
    "tests/CI) | ssh (StaticSshProvisioner over tony.slice.hosts) | "
    "gcloud (GcloudTpuProvisioner — the framework creates/deletes TPU "
    "nodes itself via the Cloud TPU API; see tony.gcloud.*).")
SLICE_NUM_HOSTS = _key(
    "tony.slice.num-hosts", 1, int,
    "gpu-host backend only: hosts per slice lease (all-or-nothing grant; "
    "SURVEY.md §7(a) slice-lease atomicity).")
SLICE_HOSTS = _key(
    "tony.slice.hosts", "", str,
    "gpu-host+ssh only: comma-separated ssh targets (GPU host "
    "inventory).")
SLICE_REMOTE_PYTHON = _key(
    "tony.slice.remote-python", "python3", str,
    "gpu-host+ssh only: the interpreter that runs executors ON the GPU "
    "hosts (the coordinator's sys.executable is a path on the wrong "
    "machine).")
SLICE_FAKE_INVENTORY = _key(
    "tony.slice.fake-inventory", 0, int,
    "gpu-host+fake only: total fake hosts in the provisioner inventory; "
    "0 means same as tony.slice.num-hosts (deny-capacity tests set it "
    "lower).")
GCLOUD_PROJECT = _key(
    "tony.gcloud.project", "", str,
    "gpu-host+gcloud only: GCP project the provisioner creates TPU nodes "
    "in (cluster/gcloud.py — the YARN-RM role, "
    "ApplicationMaster.java:1051-1070, re-designed as the Cloud TPU API).")
GCLOUD_ZONE = _key(
    "tony.gcloud.zone", "", str,
    "gpu-host+gcloud only: zone for TPU nodes (e.g. us-central2-b).")
GCLOUD_ACCELERATOR_TYPE = _key(
    "tony.gcloud.accelerator-type", "", str,
    "gpu-host+gcloud only: TPU accelerator type to create (e.g. "
    "v5litepod-16); its host count must equal tony.slice.num-hosts.")
GCLOUD_RUNTIME_VERSION = _key(
    "tony.gcloud.runtime-version", "tpu-ubuntu2204-base", str,
    "gpu-host+gcloud only: TPU VM runtime image version.")
GCLOUD_NODE_PREFIX = _key(
    "tony.gcloud.node-prefix", "tony", str,
    "gpu-host+gcloud only: created node names are "
    "<prefix>-<random>; the random suffix avoids collisions across "
    "concurrent jobs (409s retry with a fresh name).")
GCLOUD_SSH_USER = _key(
    "tony.gcloud.ssh-user", "", str,
    "gpu-host+gcloud only: login user for ssh channels onto the node's "
    "VMs; empty = the coordinator's current user.")
GCLOUD_SPOT = _key(
    "tony.gcloud.spot", False, bool,
    "gpu-host+gcloud only: create preemptible (spot) nodes. Preemption "
    "is detected via the node state and recovers through the normal "
    "re-lease + retry-epoch machinery (plus the in-VM advance-notice "
    "watcher, executor/preemption.py).")
GCLOUD_NETWORK = _key(
    "tony.gcloud.network", "", str,
    "gpu-host+gcloud only: VPC network for the node; empty = project "
    "default.")
GCLOUD_CREATE_TIMEOUT_S = _key(
    "tony.gcloud.create-timeout-s", 900, int,
    "gpu-host+gcloud only: bound on create-operation + READY polling "
    "before the acquire fails (and deletes the half-created node).")
GCLOUD_POLL_INTERVAL_S = _key(
    "tony.gcloud.poll-interval-s", 5.0, float,
    "gpu-host+gcloud only: cadence for operation/READY polling and for "
    "the lease's node-state health checks.")
GCLOUD_QUEUED_RESOURCE = _key(
    "tony.gcloud.queued-resource", False, bool,
    "gpu-host+gcloud only: acquire capacity via the queued-resources "
    "API (request waits in the provider's queue until granted — the "
    "path reservations and spot capacity commonly require) instead of "
    "a direct node create. tony.gcloud.create-timeout-s bounds the "
    "whole wait.")
GCLOUD_CHANNEL = _key(
    "tony.gcloud.channel", "ssh", str,
    "gpu-host+gcloud only: how to reach the node's VMs: ssh (production) "
    "| localsim (test substrate: each API-reported endpoint becomes a "
    "local process host, so the full create/preempt/delete lifecycle is "
    "e2e-testable against the fake API server).")
GCLOUD_API_ENDPOINT = _key(
    "tony.gcloud.api-endpoint", "", str,
    "gpu-host+gcloud only: Cloud TPU API endpoint override (tests point "
    "this at tests/tpu_api_fake_server.py; empty = "
    "https://tpu.googleapis.com, or the TONY_TPU_API_ENDPOINT env var).")
APPLICATION_PROFILER_ENABLED = _key(
    "tony.application.profiler-enabled", False, bool,
    "Export TONY_PROFILE_DIR (under the job history dir) to the chief "
    "task so tony_tpu_torch.profiler.trace_window captures XLA traces there; "
    "the portal lists them per job (SURVEY.md §5 tracing — the TPU-native "
    "complement to the reference's TB-only observability).")
APPLICATION_ENABLE_PREPROCESS = _key(
    "tony.application.enable-preprocess", False, bool,
    "Run the coordinator-local command as a preprocessing stage before "
    "scheduling any gang (reference tony.application.enable-preprocess, "
    "ApplicationMaster.doPreprocessingJob :714-766).")
COORDINATOR_COMMAND = _key(
    "tony.coordinator.command", "", str,
    "Command the coordinator runs in-process: the preprocessing stage when "
    "enable-preprocess is set, or the whole job in single-node mode (no "
    "jobtypes configured). Reference AM-local execution, "
    "ApplicationMaster.java:714.")
APPLICATION_TENSORBOARD_COMMAND = _key(
    "tony.application.tensorboard-command", "", str,
    "Command the CHIEF executor spawns alongside its user process with "
    "TB_PORT exported (e.g. 'tensorboard --logdir ... --port $TB_PORT'); "
    "killed when the task ends. The chief's TB URL is registered with the "
    "coordinator either way (reference TaskExecutor.java:311-319, "
    "ApplicationMaster.java:935-951; launching TB was user-script territory "
    "in the reference examples).")
APPLICATION_CHECKPOINT_DIR = _key(
    "tony.application.checkpoint-dir", "", str,
    "Shared checkpoint directory exported to every task as "
    "TONY_CHECKPOINT_DIR; with whole-job retry, user scripts restore from "
    "CheckpointManager.latest_step() there to resume across session epochs "
    "(the reference leaves this wholly to user code — SURVEY.md §5).")
APPLICATION_PREPARE_STAGE = _key(
    "tony.application.prepare-stage", "", str,
    "Comma list of jobtypes forming the prepare stage of the DAG "
    "(reference Utils.java:372-406).", multi_value=True)
APPLICATION_TRAINING_STAGE = _key(
    "tony.application.training-stage", "", str,
    "Comma list of jobtypes forming the training stage of the DAG.",
    multi_value=True)
APPLICATION_UNTRACKED_JOBTYPES = _key(
    "tony.application.untracked.jobtypes", "ps", str,
    "Jobtypes whose processes run forever and do not gate completion "
    "(reference TonyConfigurationKeys.java:252-253).", multi_value=True)
APPLICATION_STOP_ON_FAILURE_JOBTYPES = _key(
    "tony.application.stop-on-failure-jobtypes", "", str,
    "Jobtypes whose single-task failure fails the whole job immediately "
    "(reference TonySession.java:251-271).", multi_value=True)
APPLICATION_FAIL_ON_WORKER_FAILURE = _key(
    "tony.application.fail-on-worker-failure-enabled", False, bool,
    "If true, any tracked task failure fails the job without waiting "
    "(reference TonySession.java:251-271).")
APPLICATION_NUM_CLIENTS_TO_WAIT = _key(
    "tony.application.wait-for-client-finish", True, bool,
    "Coordinator waits for the client's finish signal before tearing down "
    "(reference ApplicationMaster.java:684).")
APPLICATION_SECURITY_ENABLED = _key(
    "tony.application.security.enabled", False, bool,
    "Enable token auth on the control-plane RPC "
    "(reference ApplicationMaster.java:433-452).")
SECURITY_TLS_CERT = _key(
    "tony.application.security.tls-cert", "", str,
    "PEM certificate path: set together with tls-key to wrap the "
    "control-plane RPC (and the portal, if started with it) in TLS. "
    "Clients PIN this exact cert (self-signed pairs need no CA); the "
    "path must be readable on every host (shared fs or staged).")
SECURITY_TLS_KEY = _key(
    "tony.application.security.tls-key", "", str,
    "PEM private-key path for tls-cert — needed only where servers run "
    "(the coordinator / portal host), never on task hosts.")

JAX_COMPILE_CACHE_DIR = _key(
    "tony.jax.compilation-cache-dir", "~/.cache/tony-tpu/jaxcache", str,
    "Persistent XLA compile cache exported to jax tasks as "
    "JAX_COMPILATION_CACHE_DIR (host-stable path, expanded on the task "
    "host, so repeat jobs skip first-compile — most of the cold "
    "submit-to-first-step). The task's own env wins; empty disables.")

# --- task / executor ------------------------------------------------------
TASK_HEARTBEAT_INTERVAL_MS = _key(
    "tony.task.heartbeat-interval-ms", 1000, int,
    "Executor→coordinator heartbeat cadence "
    "(reference TonyConfigurationKeys.java:143-144).")
TASK_MAX_MISSED_HEARTBEATS = _key(
    "tony.task.max-missed-heartbeats", 25, int,
    "Missed heartbeats before a task is deemed dead "
    "(reference TonyConfigurationKeys.java:145-147).")
TASK_METRICS_INTERVAL_MS = _key(
    "tony.task.metrics-interval-ms", 5000, int,
    "Resource-metrics sampling cadence (reference :149-150).")
TASK_REGISTRATION_TIMEOUT_S = _key(
    "tony.task.registration-timeout-s", 900, int,
    "Gang rendezvous timeout: all tasks must register within this window "
    "(reference tony.application.registration-timeout default 15 min, "
    "TonyConfigurationKeys.java:243-244).")
TASK_EXECUTOR_EXECUTION_TIMEOUT_S = _key(
    "tony.task.execution-timeout-s", 0, int,
    "Per-task user-process timeout; 0 disables "
    "(reference tony.task.executor.execution-timeout-ms).")
TASK_REUSE_PORT = _key(
    "tony.task.reuse-port", False, bool,
    "Hold the rendezvous port with SO_REUSEPORT between registration and "
    "user-process bind (reference ReusablePort.java:151-236).")
TASK_PORT_FILE = _key(
    "tony.task.port-file", "", str,
    "Optional file the executor writes its reserved rendezvous port to.")
TASK_COORDINATOR_LOSS_HEARTBEATS = _key(
    "tony.task.coordinator-loss-heartbeats", 3, int,
    "Consecutive FAILED heartbeat calls before the executor flips from "
    "heartbeating to reconnect mode (re-resolve the coordinator address, "
    "re-register with the existing task_id/port). 0 disables "
    "coordinator-loss detection (an executor then just logs failed "
    "beats, the pre-recovery behaviour).")
TASK_ORPHAN_DEADLINE_S = _key(
    "tony.task.orphan-deadline-s", 120, int,
    "How long an executor keeps the user process alive while it cannot "
    "reach ANY coordinator. A coordinator restart inside this window is "
    "invisible to training (the executor re-registers and carries on); "
    "past it the executor concludes it is orphaned, delivers the "
    "TERM-grace-KILL ladder to the user process group, and exits — no "
    "headless gang may keep burning TPU time forever.")
TASK_PROGRESS_TIMEOUT_S = _key(
    "tony.task.progress-timeout-s", 0, int,
    "Progress-based hang detection (coordinator/liveness.py): a task "
    "whose step counter (telemetry.step() beacons riding heartbeats) "
    "stops advancing for this long is declared HUNG — stack-dumped via "
    "the executor's dump signal, then TERM-grace-KILLed into an "
    "INFRA_TRANSIENT retry epoch. Warmup-aware: the deadline only arms "
    "once a task has reported its FIRST step, so compile/restore time "
    "never counts; tasks with no progress instrumentation keep "
    "heartbeat-only liveness (one-time warning, never a false kill). "
    "0 disables. Size it well above the longest legitimate gap between "
    "steps (eval pauses, checkpoint saves).")
TASK_PROGRESS_WARMUP_S = _key(
    "tony.task.progress-warmup-s", 300, int,
    "How long after registration a task may run without ever reporting "
    "a step counter before the coordinator emits the one-time "
    "TASK_PROGRESS_UNINSTRUMENTED warning and settles for heartbeat-only "
    "liveness. Only a warning gate — an uninstrumented task is never "
    "killed for lack of progress.")
TASK_HANG_DUMP_GRACE_S = _key(
    "tony.task.hang-dump-grace-s", 5, int,
    "Diagnostics window between declaring a task HUNG and killing it: "
    "the dump directive rides the next heartbeat response, the executor "
    "signals the user process group, and the pre-registered faulthandler "
    "dumps all-thread stacks into the task log. A step advance inside "
    "the window cancels the verdict.")
TASK_STRAGGLER_FRACTION = _key(
    "tony.task.straggler-fraction", 0.0, float,
    "Gang-level straggler policing (coordinator/liveness.py): a task "
    "whose step rate stays below this fraction of its jobtype's median "
    "rate for a sustained straggler-window-s emits TASK_STRAGGLER with "
    "its rate vs. the median. 0 disables. A 1-task gang can never "
    "straggle (its own rate is the median). Disable (or keep 0) for "
    "intentionally asymmetric gangs — heterogeneous batch sizes, "
    "pipeline stages with unequal work.")
TASK_STRAGGLER_WINDOW_S = _key(
    "tony.task.straggler-window-s", 60, int,
    "Sliding window for straggler step-rate estimation AND the sustain "
    "requirement: the below-fraction condition must hold continuously "
    "this long before TASK_STRAGGLER fires (momentary dips — GC, a slow "
    "batch — never flag).")
TASK_STRAGGLER_RESTART = _key(
    "tony.task.straggler-restart", False, bool,
    "Proactive straggler restart (off by default): a flagged straggler "
    "is killed into an INFRA_TRANSIENT retry epoch, on the theory that "
    "a fresh process/host beats a gang crawling at the straggler's "
    "pace. Leave off unless step rates are expected to be uniform.")

# --- elastic gangs (coordinator/elastic.py) -------------------------------
ELASTIC_ENABLED = _key(
    "tony.elastic.enabled", False, bool,
    "Elastic gang resizing: on host loss / preemption of a task of the "
    "elastic jobtype (or an explicit `tony-tpu resize`), the coordinator "
    "drains the survivors at a step barrier (a RESIZE directive rides the "
    "heartbeat response; user processes checkpoint-and-park via their "
    "save-on-SIGTERM handlers), re-meshes the gang at the new cardinality "
    "under a bumped, fenced membership generation, and training continues "
    "the SAME epoch from the last checkpoint — a bounded pause instead of "
    "a restart-with-replay. Off (default): host loss fails the epoch into "
    "the ordinary retry machinery.")
ELASTIC_JOBTYPE = _key(
    "tony.elastic.jobtype", "worker", str,
    "The jobtype whose gang is elastic (exactly one; the chief member — "
    "index 0 / the `chief` jobtype — is never shrunk away, and its loss "
    "is NOT absorbable: chief failure keeps its fail-the-epoch policy).")
ELASTIC_MIN_TASKS = _key(
    "tony.elastic.min-tasks", 1, int,
    "Floor on the elastic gang's size: a shrink (host-loss absorption or "
    "explicit resize) below this is refused — the loss then falls through "
    "to the ordinary failure-domain retry machinery. Size it to the "
    "smallest gang whose per-task memory still fits the resharded model.")
ELASTIC_DRAIN_GRACE_S = _key(
    "tony.elastic.drain-grace-s", 15, int,
    "TERM→KILL window for draining a survivor's user process at a resize: "
    "the save-on-SIGTERM handler (checkpoint/manager.py "
    "install_preemption_handler) gets this long to make its final save "
    "durable before the executor escalates. Exported to executors as "
    "the user-process kill grace for resize drains.")
ELASTIC_BARRIER_TIMEOUT_S = _key(
    "tony.elastic.barrier-timeout-s", 120, int,
    "Bound on a whole resize operation: drain of the survivors plus the "
    "re-registration barrier at the new cardinality. A resize that "
    "cannot complete inside this window fails the epoch INFRA_TRANSIENT "
    "into the ordinary retry machinery (which relaunches at the "
    "configured size) — a stuck resize must not hang the job forever.")

# --- tracing / live metrics (tony_tpu_torch/tracing.py, tony_tpu_torch/metrics.py) ---
TRACE_ENABLED = _key(
    "tony.trace.enabled", True, bool,
    "Distributed tracing across the control plane: client submit span, "
    "coordinator lifecycle/epoch/rendezvous/task spans, executor "
    "register/user-process/first-step spans, stitched into one tree per "
    "job via trace context on every RPC frame. The span log "
    "(trace.spans.jsonl) lives in the job history dir next to the jhist "
    "stream; export with `tony-tpu trace <app>` (Perfetto JSON) or the "
    "portal /trace/<app> timeline. Off = zero overhead (null spans).")
TRACE_RPC_SPANS = _key(
    "tony.trace.rpc-spans", "significant", str,
    "Server-side per-RPC spans: 'significant' (default — registration, "
    "results, kill; periodic methods like heartbeats and metrics pushes "
    "are aggregated into the RPC latency histograms instead of spamming "
    "the span log), 'all' (every method — debugging only; heartbeats "
    "arrive once per second per task), or 'off' (histograms only).")
METRICS_RING_POINTS = _key(
    "tony.metrics.ring-points", 512, int,
    "Ring-buffer depth of each in-memory gauge time series in the "
    "coordinator MetricsRegistry (sparklines for `tony-tpu top`, "
    "short-window rates). Bounded by design: Prometheus owns long-term "
    "storage; the registry is the scrape source, not a TSDB.")
METRICS_EXPORT_INTERVAL_S = _key(
    "tony.metrics.export-interval-s", 2.0, float,
    "Cadence at which the coordinator renders the Prometheus exposition "
    "into <job_dir>/metrics.prom (the portal /metrics scrape source) and "
    "snapshots counters for recovery. Control-plane-rate, not per-step.")

# --- alerting & SLOs (tony_tpu_torch/alerts/) ------------------------------------
ALERTS_ENABLED = _key(
    "tony.alerts.enabled", True, bool,
    "Evaluate the default alert packs: job-scope rules on the "
    "coordinator monitor tick, fleet-scope rules on the fleet daemon "
    "tick. Both run behind the never-blocks-the-tick degrade contract "
    "(an evaluator crash disables alerting for that process life with "
    "one warning, never the tick). See docs/operations.md "
    "'Alerting & SLOs'.")
ALERTS_FOR_S = _key(
    "tony.alerts.for-s", 10.0, float,
    "Base for-duration (hysteresis) of the job-scope default pack: a "
    "breach must persist this long in `pending` before the rule fires — "
    "one bad tick never pages. Slower rules (input-bound, fsync-p99) "
    "use a multiple of this.")
ALERTS_FLEET_FOR_S = _key(
    "tony.alerts.fleet-for-s", 60.0, float,
    "For-duration of the fleet-scope default pack. Deliberately long: "
    "a fleet alert is a capacity/goodput story measured in minutes, "
    "not a single-tick blip.")
ALERTS_HEARTBEAT_AGE_S = _key(
    "tony.alerts.heartbeat-age-s", 30.0, float,
    "heartbeat-age rule threshold: page when any task's "
    "tony_task_heartbeat_age_seconds exceeds this — the gang is about "
    "to lose a member (the liveness reaper fires at "
    "max-missed-heartbeats x interval; this alert leads it).")
ALERTS_DATA_WAIT_FRACTION = _key(
    "tony.alerts.data-wait-fraction", 0.5, float,
    "input-bound rule threshold: warn when the windowed rate of the "
    "cumulative data_wait step phase (= fraction of wall time spent "
    "waiting on input) exceeds this — the live form of the post-hoc "
    "INPUT_BOUND verdict.")
ALERTS_FSYNC_P99_S = _key(
    "tony.alerts.fsync-p99-s", 0.05, float,
    "journal-fsync-p99 rule threshold (seconds): warn when the "
    "windowed p99 of tony_journal_fsync_seconds breaches it. Default "
    "aims ROADMAP item 3 by numbers — BENCH_SCALE_r01 measured p99 "
    "63ms at 512 virtual tasks, the JOURNAL_BOUND regime.")
ALERTS_MIN_STEPS_PER_SEC = _key(
    "tony.alerts.min-steps-per-sec", 0.0, float,
    "step-time-slo floor: a task sample below this steps/s rate is "
    "'bad' for the SLO's error budget. 0 disarms the SLO (the default "
    "— a universal floor would misfire across model sizes); set it "
    "per job from the model's known-good rate.")
ALERTS_SLO_OBJECTIVE = _key(
    "tony.alerts.slo-objective", 0.9, float,
    "SLO objective for the default burn-rate rules: the error budget "
    "is 1-objective (0.9 → 10% of samples may breach before the "
    "budget is spent).")
ALERTS_WINDOW_LONG_S = _key(
    "tony.alerts.window-long-s", 300.0, float,
    "Long burn-rate window of the job-scope SLOs (the fleet pack "
    "scales it up). Both windows must burn past the factor to fire — "
    "long resists blips, short makes recovery resolve fast.")
ALERTS_WINDOW_SHORT_S = _key(
    "tony.alerts.window-short-s", 60.0, float,
    "Short burn-rate window of the job-scope SLOs (the fleet pack "
    "scales it up).")
ALERTS_BURN_FACTOR = _key(
    "tony.alerts.burn-factor", 2.0, float,
    "Burn-rate factor: fire when the error budget burns at this "
    "multiple of the steady-state rate on BOTH windows (2.0 = the "
    "budget would be gone in half the objective period).")
ALERTS_GOODPUT_FLOOR = _key(
    "tony.alerts.goodput-floor", 0.5, float,
    "goodput-slo floor: a fleet-wide tony_fleet_goodput_fraction "
    "sample below this is 'bad' for the fleet SLO's budget — "
    "chip-seconds burning on overhead, not train steps.")
ALERTS_QUARANTINE_PER_MIN = _key(
    "tony.alerts.quarantine-rate-per-min", 3.0, float,
    "quarantine-spike rule threshold: warn when host quarantines are "
    "applied faster than this per minute (windowed rate of "
    "tony_fleet_quarantines_total) — a correlated hardware event or a "
    "flapping health scorer.")
ALERTS_QUEUE_WAIT_P99_S = _key(
    "tony.alerts.queue-wait-p99-s", 600.0, float,
    "queue-wait-p99 rule threshold (seconds): warn when the windowed "
    "p99 submit-to-grant wait breaches it — the pool is starved or "
    "fragmented.")

# --- control-plane self-observation (coordinator/coordphases.py) ----------
COORD_PHASE_RING_TICKS = _key(
    "tony.coord.phase-ring-ticks", 256, int,
    "Ring depth of the coordinator's own per-tick phase attribution "
    "(hb_scan / journal_fsync / beacon_fold / prom_export / rpc_serve / "
    "rendezvous_barrier — coordinator/coordphases.py): recent-window "
    "tick duration and phase fractions are computed over this many "
    "monitor ticks. Bounded by design, like the step-phase ring.")

# --- width harness (cluster/local.py virtual mode, bench --suite scale) ---
SCALE_VIRTUAL_EXECUTORS = _key(
    "tony.scale.virtual-executors", False, bool,
    "LocalSim width harness: the local backend launches each task as an "
    "in-process beat-only virtual executor (executor/virtual.py) instead "
    "of a subprocess — real RPC frames, real journal records, real "
    "heartbeat/beacon traffic, NO user process — so rendezvous, "
    "heartbeat and resize paths are exercised at 128–1024 tasks per box "
    "in CI-sized time (bench.py --suite scale). Never for real "
    "training: the tasks only pretend to step.")
SCALE_VIRTUAL_STEPS_PER_S = _key(
    "tony.scale.virtual-steps-per-s", 5.0, float,
    "Synthetic step rate a virtual executor's progress beacon reports "
    "(keeps progress-liveness and the metrics fold exercised at width).")
SCALE_VIRTUAL_RUN_S = _key(
    "tony.scale.virtual-run-s", 0.0, float,
    "How long a virtual executor beats before reporting exit 0 over the "
    "real register_execution_result path; 0 = beat until killed (the "
    "bench's sustain window stops the job explicitly).")
SCALE_VIRTUAL_PUMP_THREADS = _key(
    "tony.scale.virtual-pump-threads", 8, int,
    "Worker threads of the shared virtual-executor beat pump: hundreds "
    "of virtual tasks multiplex their register/heartbeat/result calls "
    "over this many threads (and RPC connections) — a thread per "
    "virtual task would not reach 1024 tasks per box.")

# --- on-demand device profiling (tony_tpu_torch/telemetry.py capture agent) -----
PROFILE_ENABLED = _key(
    "tony.profile.enabled", True, bool,
    "On-demand device profiling: `tony-tpu profile <app>` rides a "
    "PROFILE directive on the heartbeat response, the target task arms "
    "jax.profiler at its next step boundary for N steps, and the trace "
    "artifact lands under <job_dir>/profile/ (portal /profile/<app>). "
    "Off = profile.start RPCs are refused (the static chief-only "
    "tony.application.profiler-enabled contract is unaffected).")
PROFILE_DEFAULT_STEPS = _key(
    "tony.profile.default-steps", 5, int,
    "Steps one on-demand capture brackets when `tony-tpu profile` is "
    "invoked without --steps. Captures start and stop at step "
    "boundaries, so N steps means N whole steps of device timeline.")
PROFILE_MAX_ARTIFACTS = _key(
    "tony.profile.max-artifacts", 8, int,
    "Ceiling on on-demand trace artifacts per job: profile.start is "
    "refused once <job_dir>/profile holds this many ondemand-* capture "
    "dirs (device traces are tens of MB each; an unbounded poll loop "
    "must not fill the history volume). Delete old dirs to make room.")

# --- automatic failure diagnosis (tony_tpu_torch/diagnosis/) --------------------
DIAGNOSIS_ENABLED = _key(
    "tony.diagnosis.enabled", True, bool,
    "On any non-SUCCEEDED finish the coordinator assembles an incident "
    "bundle (events + journal + spans + metrics + log tails with "
    "extracted tracebacks/stack dumps + scrubbed config), runs the rule "
    "engine over it, writes <job_dir>/incident.json and emits "
    "JOB_DIAGNOSED with the verdict (category, blamed task, evidence). "
    "Read it with `tony-tpu diagnose <app>` or the portal "
    "/diagnose/<app>. Off = no automatic diagnosis (the CLI/portal can "
    "still run the engine post-hoc on the history dir).")
DIAGNOSIS_LOG_TAIL_BYTES = _key(
    "tony.diagnosis.log-tail-bytes", 65536, int,
    "How much of each task log's TAIL the diagnosis collector reads "
    "(seek-based — multi-GB logs cost only this much memory) when "
    "hunting tracebacks, stack dumps and OOM markers.")

# --- rpc ------------------------------------------------------------------
RPC_CALL_TIMEOUT_S = _key(
    "tony.rpc.call-timeout-s", 10.0, float,
    "Per-call send/recv deadline on executor control-plane RPCs. A "
    "WEDGED coordinator (accepts connections, never answers) then "
    "surfaces as an INFRA_TRANSIENT RpcTimeout instead of hanging the "
    "heartbeat thread forever — which is what lets coordinator-loss "
    "detection fire at all. 0 disables (unbounded waits).")
RPC_MAX_RETRIES = _key(
    "tony.rpc.max-retries", 10, int,
    "Transport-level reconnect budget per executor RPC call (reference "
    "10 fixed-sleep attempts, ApplicationRpcClient.java:66-76; here with "
    "exponential full-jitter backoff). Recovery tests lower it so "
    "coordinator-loss detection fires in seconds, not minutes.")
RPC_RETRY_SLEEP_S = _key(
    "tony.rpc.retry-sleep-s", 2.0, float,
    "Cap on any one transport retry sleep (the backoff envelope's "
    "max delay; base is a quarter of it).")

# --- coordinator ----------------------------------------------------------
COORDINATOR_MONITOR_INTERVAL_MS = _key(
    "tony.coordinator.monitor-interval-ms", 500, int,
    "Coordinator main monitoring loop cadence (reference AM 5 s loop "
    "ApplicationMaster.java:646; faster here — it is cheap in-process).")
COORDINATOR_HOST_KEY = _key(
    "tony.coordinator.host", "127.0.0.1", str,
    "Bind host for the coordinator control-plane server.")
COORDINATOR_PORT_KEY = _key(
    "tony.coordinator.port", 0, int,
    "Bind port for the coordinator control-plane server (0 = ephemeral).")
COORDINATOR_STOP_GRACE_S = _key(
    "tony.coordinator.stop-grace-s", 15, int,
    "Grace period when stopping running tasks "
    "(reference ApplicationMaster.java:694-711).")
COORDINATOR_JOURNAL_ENABLED = _key(
    "tony.coordinator.journal-enabled", True, bool,
    "Write-ahead session journal (session.journal.jsonl in the job "
    "history dir): every task state transition, registration, epoch "
    "reset and failure verdict is appended fsync'd, so a crashed "
    "coordinator can be restarted with --recover and resume the SAME "
    "epoch instead of losing the job (the YARN "
    "keepContainersAcrossApplicationAttempts analogue). Appends are "
    "control-plane-rate (per task transition, not per step); disable "
    "only on filesystems where fsync is pathological.")
COORDINATOR_REREGISTRATION_GRACE_S = _key(
    "tony.coordinator.reregistration-grace-s", 60, int,
    "Recovery grace window: how long a coordinator started with "
    "--recover waits for the surviving executors to re-register their "
    "existing task_id/host/port before declaring the gang lost "
    "(INFRA_TRANSIENT, normal retry-epoch machinery).")

# --- client ---------------------------------------------------------------
CLIENT_POLL_INTERVAL_MS = _key(
    "tony.client.poll-interval-ms", 1000, int,
    "Client app-report poll cadence (reference TonyClient.java:840-843).")
MAX_TOTAL_INSTANCES = _key(
    "tony.application.max-total-instances", -1, int,
    "Quota: maximum total task instances; -1 = unlimited "
    "(reference TonyClient.java:598-667).")
MAX_TOTAL_CHIPS = _key(
    "tony.application.max-total-chips", -1, int,
    "Quota: maximum total TPU chips across all jobtypes; -1 = unlimited "
    "(replaces the reference's GPU quota keys).")
SRC_DIR = _key(
    "tony.application.src-dir", "", str,
    "Directory of user code zipped and shipped to every task "
    "(reference tony.src.dir, TonyClient.java:189-228).")
PYTHON_VENV = _key(
    "tony.application.python-venv", "", str,
    "Optional archived Python environment localized for tasks "
    "(reference tony.python.venv).")
PYTHON_BINARY_PATH = _key(
    "tony.application.python-binary-path", "python3", str,
    "Python interpreter used to build task commands when `tony.<job>.command` "
    "is not given (reference TonyClient.buildTaskCommand :454-475).")
EXECUTION_ENV = _key(
    "tony.application.execution-env", "", str,
    "Comma list of KEY=VALUE pairs exported into every task environment "
    "(reference tony.execution.env).", multi_value=True)
CONTAINER_RESOURCES = _key(
    "tony.application.resources", "", str,
    "Comma list of extra files (SRC[::NAME][#archive]) localized to all tasks "
    "(reference LocalizableResource.java:20-30).", multi_value=True)

# --- history / events -----------------------------------------------------
HISTORY_LOCATION = _key(
    "tony.history.location", "", str,
    "Root directory for job history (empty = <workdir>/tony-history) "
    "(reference tony.history.location).")
HISTORY_MOVER_INTERVAL_S = _key(
    "tony.history.mover-interval-s", 300, int,
    "Intermediate→finished history mover cadence "
    "(reference HistoryFileMover.java:74-121, 5 min).")
HISTORY_PURGER_INTERVAL_S = _key(
    "tony.history.purger-interval-s", 21600, int,
    "History retention purger cadence (reference 6 h).")
HISTORY_RETENTION_DAYS = _key(
    "tony.history.retention-days", 30, int,
    "Days of finished history kept (reference 30 days).")
KEEP_FAILED_DIRS = _key(
    "tony.keep-failed-task-dirs", False, bool,
    "Keep working dirs of failed tasks for debugging.")

# --- TPU topology ---------------------------------------------------------
TPU_TOPOLOGY = _key(
    "tony.tpu.topology", "", str,
    "Requested slice topology, e.g. 'v5p-32' or '2x2x4'; empty = use all "
    "locally visible devices. The mesh builder consumes this (SURVEY.md §7.7).")
TPU_MESH_SHAPE = _key(
    "tony.tpu.mesh-shape", "", str,
    "Logical mesh axes as 'name=size,name=size' over the canonical axes "
    "dp/fsdp/pp/ep/sp/tp (tony_tpu_torch.parallel.MeshSpec.from_string), e.g. "
    "'fsdp=4,tp=2'. One size may be -1 (inferred). Empty = pure-dp mesh "
    "over all devices.")

# --- training hot loop (parallel/grad_sync.py, ops/quant.py) --------------
TRAIN_ACCUM_STEPS = _key(
    "tony.train.accum-steps", 1, int,
    "Microbatched gradient accumulation: the global batch is split into "
    "this many microbatches per optimizer step (parallel/grad_sync.py "
    "jit_train_step_accum). Raises the compute:sync ratio — the first "
    "knob a COMMS_BOUND verdict prescribes. 1 = no accumulation.")
TRAIN_BUCKET_MB = _key(
    "tony.train.bucket-mb", 32, int,
    "Gradient-sync bucket size in MiB: accumulated grads are cross-slice "
    "all-reduced bucket-by-bucket in tree-flatten order (order-stable, "
    "so results match the monolithic psum), letting XLA overlap "
    "independent bucket collectives instead of serializing one monolith "
    "behind backward. A param larger than the bucket gets its own "
    "bucket. Smaller buckets = more overlap, more collective launches.")
TRAIN_MATMUL_DTYPE = _key(
    "tony.train.matmul-dtype", "", str,
    "Opt-in low-precision matmul path for the flagship transformer's "
    "attention/MLP projections (ops/quant.py): 'int8' (symmetric "
    "per-channel, 2x MXU rate on v5e) | 'fp8_e4m3'. Forward-only: "
    "backward stays in the activation dtype (straight-through), the "
    "embedding/LM head are never quantized, and an unsupported backend "
    "degrades to bf16 with a one-time warning on the metrics beacon. "
    "Empty = bitwise-identical bf16/f32 behaviour (the knob off IS the "
    "old code path). Unsafe for loss-scale-sensitive runs — see "
    "docs/operations.md 'Spending the verdict'.")

# --- fault injection (tony_tpu_torch/faults.py) ---------------------------------
FAULT_SEED = _key(
    "tony.fault.seed", 0, int,
    "Seed for the deterministic fault-injection harness: per-site RNGs "
    "are seeded with (seed, site), and the shared retry-backoff jitter "
    "is seeded too, so a rehearsed failure replays identically.")


def fault_key(site: str) -> str:
    """Conf key for an injection site: 'rpc.send' → 'tony.fault.rpc-send',
    'user.slow_step' → 'tony.fault.user-slow-step' (key names are
    dash-only; site names keep their python-ish underscores)."""
    return f"tony.fault.{site.replace('.', '-').replace('_', '-')}"


# One registered key per injection site (tony_tpu_torch/faults.py SITES); the
# value is a spec like 'first:2', 'at:3', 'every:5', 'p:0.3,session:0'.
FAULT_RPC_CONNECT = _key(
    "tony.fault.rpc-connect", "", str,
    "Inject a connection failure before RPC client connects "
    "(spec grammar: tony_tpu_torch/faults.py).")
FAULT_RPC_SEND = _key(
    "tony.fault.rpc-send", "", str,
    "Inject a dropped-connection failure before an RPC request is sent.")
FAULT_RPC_SLOW = _key(
    "tony.fault.rpc-slow", "", str,
    "Inject latency into RPC client calls: firings delay the request by "
    "'amt:X' seconds before it is sent — the deterministic exercise for "
    "trace spans and the RPC latency histograms (a slow-control-plane "
    "rehearsal that never drops a frame).")
FAULT_HEARTBEAT = _key(
    "tony.fault.heartbeat", "", str,
    "Make the executor silently skip heartbeats that fire this spec "
    "(the conf-driven generalization of TONY_TEST_NUM_HB_MISS).")
FAULT_EXECUTOR_SPAWN = _key(
    "tony.fault.executor-spawn", "", str,
    "Fail the backend's executor process spawn (launch-path fault).")
FAULT_STORAGE_PUT = _key(
    "tony.fault.storage-put", "", str,
    "Inject a transient store error on put_file (absorbed by the shared "
    "retry policy — the GCS 503-burst rehearsal).")
FAULT_STORAGE_GET = _key(
    "tony.fault.storage-get", "", str,
    "Inject a transient store error on get_file.")
FAULT_CHECKPOINT_SAVE = _key(
    "tony.fault.checkpoint-save", "", str,
    "Fail CheckpointManager.save before the write starts.")
FAULT_COORDINATOR_CRASH = _key(
    "tony.fault.coordinator-crash", "", str,
    "Hard-kill the coordinator process (os._exit, no teardown — the "
    "SIGKILL shape) from inside its monitor loop when the spec fires; "
    "the call counter is monitor iterations. Drives the journal + "
    "--recover path from the deterministic harness.")
FAULT_EXECUTOR_REREGISTER = _key(
    "tony.fault.executor-reregister", "", str,
    "Drop an executor's re-registration attempt during coordinator-loss "
    "reconnect (raises like a transport reset; the reconnect loop "
    "retries until the orphan deadline).")
FAULT_USER_HANG = _key(
    "tony.fault.user-hang", "", str,
    "Freeze the user process's PROGRESS while it keeps running (and its "
    "executor keeps heartbeating): telemetry.step recordings that fire "
    "this spec are silently dropped, so the step counter stops advancing "
    "— the exact shape progress-based hang detection must catch. "
    "'after:N' freezes everything past the first N steps.")
FAULT_USER_SLOW_STEP = _key(
    "tony.fault.user-slow-step", "", str,
    "Skew one task's step rate: telemetry.step recordings that fire this "
    "spec are delayed by 'amt:X' seconds, driving the task's rate below "
    "the gang median — the straggler-policing drill. Combine with the "
    "'task:<job>:<idx>' filter to slow a single gang member.")
FAULT_POOL_LEASE = _key(
    "tony.fault.pool-lease", "", str,
    "Fail the backend's warm-pool lease attempt before the RPC (refused "
    "lease / unreachable daemon shape); the launch must degrade to a "
    "cold spawn, never a job failure.")
FAULT_POOL_STALE = _key(
    "tony.fault.pool-stale", "", str,
    "Simulate the pool daemon's stale-generation lease refusal (a "
    "superseded epoch trying to lease); the launch degrades to a cold "
    "spawn. The daemon also enforces the REAL check from the generation "
    "carried in each lease.")
FAULT_POOL_ADOPT = _key(
    "tony.fault.pool-adopt", "", str,
    "Kill a granted lease at adoption time (leased executor dead before "
    "the task starts); the backend discards the lease at the daemon — "
    "a dirty lease is never reused — and cold-spawns.")
FAULT_HOST_LOSS = _key(
    "tony.fault.host-loss", "", str,
    "Simulate sudden host death from inside the executor: a firing "
    "SIGKILLs the user process group and hard-exits the executor "
    "(os._exit 137) — everything on the 'host' dies at once, the shape "
    "elastic shrink-and-continue must absorb. The call counter is "
    "heartbeats, so 'task:worker:2,after:20' kills one virtual host a "
    "deterministic ~20 beats in.")
FAULT_RESIZE_BARRIER = _key(
    "tony.fault.resize-barrier", "", str,
    "Fail the post-remesh re-registration barrier of an elastic resize "
    "(checked once per resize, right after the new topology is applied): "
    "the resize aborts into an INFRA_TRANSIENT epoch failure — the "
    "ordinary retry machinery relaunches at the configured size.")
FAULT_RESIZE_REMESH = _key(
    "tony.fault.resize-remesh", "", str,
    "Fail the application of an elastic resize's new topology (checked "
    "once per resize, before the member set is rebuilt): the resize "
    "aborts into an INFRA_TRANSIENT epoch failure.")
FAULT_QUANT_PROBE = _key(
    "tony.fault.quant-probe", "", str,
    "Fail the quantized-matmul backend support probe (ops/quant.py): a "
    "firing makes resolve_mode treat the requested int8/fp8 path as "
    "unsupported on this backend — the model must degrade to the bf16 "
    "path with a one-time warning riding the metrics beacon, never fail "
    "the job.")
FAULT_COORD_SLOW_TICK = _key(
    "tony.fault.coord-slow-tick", "", str,
    "Inject latency into the coordinator's monitor tick: firings stall "
    "the tick by 'amt:X' seconds before any per-tick work runs — the "
    "overloaded-control-plane shape the coordinator's own phase "
    "accounting (tony_coord_phase_seconds, tick duration in `top`) must "
    "surface. The call counter is monitor iterations, like "
    "coordinator.crash.")
FAULT_FLEET_GRANT = _key(
    "tony.fault.fleet-grant", "", str,
    "Fail a fleet grant at apply time (tony_tpu_torch/fleet/daemon.py), after "
    "the placement decision but before the job is spawned — the "
    "unspawnable-grant shape. The job stays QUEUED and is retried on a "
    "later tick; a grant failure must never lose a submission.")
FAULT_FLEET_PREEMPT = _key(
    "tony.fault.fleet-preempt", "", str,
    "Fail a fleet preempt-to-reclaim at apply time, before the victim's "
    "elastic shrink RPC is issued — the unreachable-victim shape. The "
    "preemption (and the grant waiting on it) is retried on a later "
    "tick; the victim keeps running undisturbed.")
FAULT_FLEET_LEDGER = _key(
    "tony.fault.fleet-ledger", "", str,
    "Fail a fleet goodput-ledger fold (tony_tpu_torch/fleet/ledger.py via the "
    "daemon) — the corrupt-artifact shape. The fleet degrades to "
    "counters-only (no goodput gauges, ledger omitted from status) with "
    "a one-time warning; the scheduler tick never blocks or fails.")
FAULT_FLEET_EXPLAIN = _key(
    "tony.fault.fleet-explain", "", str,
    "Fail the write of a REC_FLEET_DECISION journal record (the "
    "scheduler decision explainer's write-ahead stream) — the full-disk "
    "shape on the observability path. The decision is still applied to "
    "the in-memory ring and the FLEET_JOB_HELD event still fires; one "
    "warning, scheduling unaffected.")
FAULT_CKPT_ASYNC_WRITE = _key(
    "tony.fault.ckpt-async-write", "", str,
    "Fail the checkpoint manager's background writer before a snapshot "
    "is serialized (tony_tpu_torch/checkpoint/manager.py) — the torn "
    "in-flight-async-save shape. The step is NOT committed (no "
    "manifest); restore falls back to the last committed step and "
    "training continues — an async save failure must never crash the "
    "job.")
FAULT_MIGRATE_SNAPSHOT = _key(
    "tony.fault.migrate-snapshot", "", str,
    "Fail a live migration at the snapshot seal (checked once per "
    "migration, after the gang drained but before the topology moves): "
    "the migration aborts into an INFRA_TRANSIENT epoch failure — the "
    "ordinary retry ladder relaunches on the ORIGINAL slice, so a "
    "failed migration is never worse than a plain host loss.")
FAULT_MIGRATE_ADOPT = _key(
    "tony.fault.migrate-adopt", "", str,
    "Fail a live migration at destination adoption (checked once per "
    "migration, after the topology moved but before the destination "
    "executors launch) — the unadoptable-target shape; the migration "
    "aborts into an INFRA_TRANSIENT epoch failure and the retry "
    "machinery relaunches.")
FAULT_SLICE_PREEMPT = _key(
    "tony.fault.slice-preempt", "", str,
    "Mark one fleet-held slice as dying on the reclaim-notice poll "
    "(tony_tpu_torch/fleet/daemon.py) — the queued-resource spot-reclaim "
    "advance notice. The fleet must proactively migrate tenants off "
    "the dying slice instead of absorbing the loss; the call counter "
    "is daemon ticks.")
FAULT_PROFILE_CAPTURE = _key(
    "tony.fault.profile-capture", "", str,
    "Fail an on-demand device capture at the step boundary that would "
    "arm jax.profiler (unsupported runtime / profiler crash shape): the "
    "task reports PROFILE_FAILED on its next beat and training "
    "continues — capture must never kill or stall the job.")
FAULT_RPC_PARTITION = _key(
    "tony.fault.rpc-partition", "", str,
    "Cut the RPC wire asymmetrically (tony_tpu_torch/rpc/wire.py): 'dir:c2s' "
    "drops request frames before they are sent (the callee never sees "
    "them), 'dir:s2c' drops RESPONSE frames after the callee already "
    "processed the request — its side effects land, the caller sees a "
    "reset and retries. 'peer:NAME' scopes the cut to one labelled "
    "wire (coordinator/pool/fleet). No dir: token = both directions.")
FAULT_DISK_FULL = _key(
    "tony.fault.disk-full", "", str,
    "Raise ENOSPC on a durable AppendLog append (utils/durable.py) — "
    "the journal-disk-full shape. Writers must degrade LOUDLY: the "
    "coordinator monitor folds it into a terminal INFRA verdict, the "
    "fleet daemon stops instead of scheduling against a dead journal, "
    "and --recover replays the committed prefix.")
FAULT_DISK_TORN = _key(
    "tony.fault.disk-torn", "", str,
    "Tear a durable write (utils/durable.py): an AppendLog append "
    "writes a partial record then fails EIO, and atomic_write drops "
    "the rename (the old bytes survive) — the power-cut-mid-write "
    "shape the replay-of-prefix readers must absorb.")
FAULT_HOST_FLAKY = _key(
    "tony.fault.host-flaky", "", str,
    "Make one pool host flaky (fleet daemon health tick): each firing "
    "attributes an INFRA_TRANSIENT failure to the host and kills the "
    "job running on it — the recurring-bad-hardware shape. Pin the "
    "host with 'task:<host>' (e.g. 'prob:0.4,task:s0h2'); the health "
    "ledger must quarantine it and retries must route around it.")
FAULT_HEALTH_PROBE = _key(
    "tony.fault.health-probe", "", str,
    "Fail a preflight host probe (fleet/health.preflight_probe), "
    "filtered per host via 'task:<host>'. The grant must self-repair: "
    "cordon the failing host and substitute a spare before anything "
    "spawns on it.")
FAULT_ALERTS_EVAL = _key(
    "tony.fault.alerts-eval", "", str,
    "Fail an alert-pack evaluation (coordinator monitor tick or fleet "
    "daemon tick, tony_tpu_torch/alerts/) — the broken-evaluator shape. The "
    "tick must degrade: alerting disables for the rest of that process "
    "life with one warning; scheduling/monitoring never block.")

# --- warm executor pool (tony_tpu_torch/pool.py) --------------------------------
POOL_DIR = _key(
    "tony.pool.dir", "", str,
    "Directory of a running warm-executor pool (tony-tpu pool start). "
    "When set, the local backend tries to ADOPT a pre-warmed executor "
    "(Python up, tony_tpu_torch + torch imported) via a "
    "pool.lease RPC before cold-spawning; any pool failure degrades to "
    "the cold path. Empty = no pool. Do NOT point jobs at a pool started "
    "under different credentials or execution env — warm workers carry "
    "the environment of their spawn time (see docs/operations.md).")
POOL_SIZE = _key(
    "tony.pool.size", 2, int,
    "Warm executors the pool daemon keeps ready. Each lease consumes one "
    "permanently (used/crashed workers are discarded, never re-pooled); "
    "the daemon replenishes in the background.")
POOL_MAX_LEASE_AGE_S = _key(
    "tony.pool.max-lease-age-s", 600, int,
    "Hygiene ceiling on warm-worker age: a worker older than this is "
    "never leased and is recycled by the daemon (bounds credential/env "
    "drift between pool start and adoption — a rotated storage token or "
    "changed execution env reaches new workers within this window).")
POOL_PRELOAD = _key(
    "tony.pool.preload", "torch", str,
    "Comma-separated modules each warm worker imports while idle (on top "
    "of the always-preloaded executor stack). 'torch' also counts the CUDA "
    "devices (libcuda loaded; no context, which would hold card memory in "
    "the executor). Empty = interpreter + tony_tpu_torch only.")

# --- fleet: persistent multi-job gang scheduler (tony_tpu_torch/fleet/) ---------
FLEET_DIR = _key(
    "tony.fleet.dir", "", str,
    "Directory of a running fleet daemon (tony-tpu fleet start) — the "
    "persistent cluster scheduler that owns a shared slice pool and "
    "gang-schedules many jobs against it with priorities, per-tenant "
    "quotas, bin-packing and preempt-to-reclaim (the YARN-RM role the "
    "reference outsourced, SURVEY §1 L4/L3). Empty = <workdir>/fleet "
    "for the fleet CLI verbs.")
FLEET_SLICES = _key(
    "tony.fleet.slices", 1, int,
    "TPU slices the fleet pool owns. Each slice contributes "
    "tony.fleet.hosts-per-slice hosts; a sub-slice job is bin-packed "
    "into ONE slice (gang locality), a larger job takes whole slices "
    "plus a best-fit remainder.")
FLEET_HOSTS_PER_SLICE = _key(
    "tony.fleet.hosts-per-slice", 8, int,
    "Hosts per pool slice. The policy engine accounts grants in hosts; "
    "granted jobs launch with tony.worker.instances = granted hosts.")
FLEET_QUOTAS = _key(
    "tony.fleet.quotas", "", str,
    "Per-tenant host quotas as 'tenant=hosts,tenant=hosts'. A tenant at "
    "its quota QUEUES (quota-denied submissions never block other "
    "tenants' grants — no head-of-line quota starvation); absent "
    "tenants are unlimited. Empty = no quotas.")
FLEET_TICK_INTERVAL_S = _key(
    "tony.fleet.tick-interval-s", 0.5, float,
    "Fleet scheduler loop cadence: job completion polling, grant/"
    "preempt plan application, grow-back restores, and the fleet.prom/"
    "fleet.status.json export all run on this tick.")
FLEET_POOL_DIR = _key(
    "tony.fleet.pool-dir", "", str,
    "Warm executor pool (tony_tpu_torch/pool.py) the fleet points EVERY "
    "granted job at (tony.pool.dir is set on the grant's conf): each "
    "tenant's resubmit then adopts pre-warmed executors instead of "
    "cold-spawning. Empty = granted jobs keep whatever pool their own "
    "conf names (usually none).")
FLEET_COMPILE_CACHE_ROOT = _key(
    "tony.fleet.compile-cache-root", "", str,
    "Root of the shared per-model XLA compile-cache mounts: a grant "
    "whose submission names a model gets tony.jax.compilation-cache-dir "
    "= <root>/<model>, so every tenant resubmitting the same model — "
    "not just the first — hits the warm-compile path. Empty = no "
    "shared cache injection.")
FLEET_PREEMPT_MIN_HOSTS = _key(
    "tony.fleet.preempt-min-hosts", 1, int,
    "Default floor a preempt-to-reclaim shrink may take an elastic "
    "victim down to when the submission does not name its own "
    "min_hosts. Victims are shrunk via the coordinator's elastic "
    "resize (drain→remesh, no epoch burned), never killed.")
FLEET_DECISION_RING = _key(
    "tony.fleet.decision-ring", 64, int,
    "Bound on the per-job scheduler-decision ring behind `tony-tpu "
    "fleet explain`: the last N hold-reason transitions (quota / "
    "capacity / fragmentation / priority-held / preempt-wait) are kept "
    "in memory per job; the full history is in the REC_FLEET_DECISION "
    "journal records.")
FLEET_LEDGER_INTERVAL_S = _key(
    "tony.fleet.ledger-interval-s", 5.0, float,
    "Cadence of the goodput-ledger refresh for RUNNING jobs (terminal "
    "jobs fold exactly once at finish). Each refresh reads the running "
    "jobs' span trees / perf artifacts into queued/startup/train/stall "
    "phase accounting — too hot for every scheduler tick at 50 jobs, "
    "cheap at this interval.")
FLEET_SIM_PREEMPTION = _key(
    "tony.fleet.sim-preemption", True, bool,
    "What-if simulator toggle (`tony-tpu fleet whatif --set`): False "
    "re-runs the recorded workload with every gang RIGID (min_hosts "
    "forced to 0, so the preemption planner finds no elastic victims "
    "and defrag finds no movers). Measures how much of the recorded "
    "goodput the elastic-shrink machinery actually bought.")
FLEET_SIM_DEFRAG = _key(
    "tony.fleet.sim-defrag", True, bool,
    "What-if simulator toggle: False disables defragmentation "
    "migrations in the counterfactual — a fragmentation-held job waits "
    "for natural drains instead of a planned one-mover consolidation. "
    "Attributes fragmentation-hold seconds to the defrag planner.")
FLEET_SIM_RESTORE = _key(
    "tony.fleet.sim-restore", True, bool,
    "What-if simulator toggle: False disables grow-back restores — "
    "preempted jobs stay at their shrunk size to job end. Shows how "
    "much queue-idle capacity the restore path actually recycles.")

# --- fleet host health (tony_tpu_torch/fleet/health.py) -------------------------
HEALTH_ENABLED = _key(
    "tony.health.enabled", True, bool,
    "Master switch for the fleet host-health subsystem: the "
    "failure-attribution ledger, quarantine state machine, preflight "
    "probes and slice blast-radius detection. Off = every host is "
    "always placeable (the pre-health fleet).")
HEALTH_HALF_LIFE_S = _key(
    "tony.health.score-half-life-s", 300.0, float,
    "Half-life of a host's failure-attribution score: each attributed "
    "infra failure adds its kind weight, and the total decays by half "
    "every this-many seconds — a burst quarantines, ancient history "
    "does not.")
HEALTH_SUSPECT_THRESHOLD = _key(
    "tony.health.suspect-threshold", 1.0, float,
    "Decayed score at which a host turns SUSPECT — still placeable, "
    "but counted toward the slice blast-radius correlation window.")
HEALTH_QUARANTINE_THRESHOLD = _key(
    "tony.health.quarantine-threshold", 3.0, float,
    "Decayed score at which a host is QUARANTINED: removed from the "
    "placement pool (journaled as REC_FLEET_HEALTH so --recover "
    "resumes the same cordon set) until its cooldown expires into "
    "probation.")
HEALTH_QUARANTINE_S = _key(
    "tony.health.quarantine-s", 120.0, float,
    "Base quarantine cooldown. After it expires the host enters "
    "PROBATION and must run one clean canary lease to rejoin the "
    "pool; a failed canary re-quarantines with this cooldown doubled "
    "(exponential backoff).")
HEALTH_PROBATION_PRIORITY = _key(
    "tony.health.probation-canary-priority", 0, int,
    "Maximum job priority allowed to carry a probation canary host: "
    "only jobs at or below it may have one cordoned-but-recovering "
    "host substituted into their placement (at most one per slice), "
    "so re-admission risk lands on preemptible work.")
HEALTH_BLAST_N = _key(
    "tony.health.slice-blast-n", 2, int,
    "Correlated-failure threshold: this many distinct hosts of one "
    "slice going suspect-or-worse inside tony.health.slice-blast-"
    "window-s marks the whole slice sick — it is cordoned and its "
    "jobs are evacuated by live migration.")
HEALTH_BLAST_WINDOW_S = _key(
    "tony.health.slice-blast-window-s", 120.0, float,
    "Sliding window (seconds of attributed-failure evidence age) for "
    "the slice blast-radius correlation above.")

# --- portal ---------------------------------------------------------------
PORTAL_PORT = _key(
    "tony.portal.port", 19886, int,
    "History web portal port (reference tony-portal Play app).")

APPLICATION_EXECUTABLE = _key(
    "tony.application.executable", "", str,
    "User training script; jobtypes without an explicit command run "
    "'<python> <executable> <task-params>' (reference "
    "TonyClient.buildTaskCommand :454-475).")
APPLICATION_TASK_PARAMS = _key(
    "tony.application.task-params", "", str,
    "Extra arguments appended to the default task command.")
REMOTE_STORE = _key(
    "tony.storage.remote-store", "", str,
    "URL prefix of an object store for job staging (gs://bucket/prefix or "
    "file:///mount/prefix). When set, the client PUTs the bundle, "
    "resources, venv, and frozen config under <prefix>/<app_id>/ and "
    "executors GET them — no shared filesystem is assumed (the HDFS "
    "upload/localize analogue, HdfsUtils.java:115-160). Empty = local "
    "job-dir staging.")
STORAGE_TOKEN = _key(
    "tony.storage.token", "", str,
    "Storage credential for submit-time staging. SCRUBBED from the frozen "
    "config before it is written (the artifact is world-readable via the "
    "portal and the store); it reaches executors by env passthrough as "
    "TONY_STORAGE_TOKEN — the separate-token-file discipline of the "
    "reference (security/TokenCache.java:44-51). Empty = read from the "
    "TONY_STORAGE_TOKEN env at submit.")
INTERNAL_CONF_URL = _key(
    "tony.internal.conf-url", "", str,
    "Set by the client at submit when a remote store is configured: store "
    "URL of the frozen config; executors fetch it before reading any "
    "other key (which is why the credential travels by env, not config).")
INTERNAL_BUNDLE_DIR = _key(
    "tony.internal.bundle-dir", "", str,
    "Set by the client at submit: staged src-dir bundle that executors "
    "localize into each task working dir (reference HDFS localization, "
    "LocalizableResource.java / Utils.extractResources :710-723).")
INTERNAL_APP_ID = _key(
    "tony.internal.app-id", "", str,
    "Set by the client at submit: the application id.")
INTERNAL_RESOURCES = _key(
    "tony.internal.resources", "", str,
    "Set by the client at submit: staged SRC[::NAME][#archive] specs for "
    "executors to localize (reference LocalizableResource grammar).",
    multi_value=True)
INTERNAL_VENV = _key(
    "tony.internal.venv", "", str,
    "Set by the client at submit: staged python-venv archive, unpacked to "
    "./venv in every task working dir (reference TonyClient.java:189-228).")
INTERNAL_VERSION = _key(
    "tony.internal.version", "", str,
    "Stamped by the client at submit: framework package version "
    "(reference VersionInfo injection, TonyClient.java:152).")
INTERNAL_REVISION = _key(
    "tony.internal.revision", "", str,
    "Stamped by the client at submit: git revision of the framework build "
    "(reference util/VersionInfo.java:149).")
INTERNAL_BRANCH = _key(
    "tony.internal.branch", "", str,
    "Stamped by the client at submit: git branch of the framework build.")
INTERNAL_FLEET_TRACE_ID = _key(
    "tony.internal.fleet-trace-id", "", str,
    "Stamped by the fleet daemon on every grant's conf: the fleet-wide "
    "trace id (tony_tpu_torch/tracing.py). The client adopts it as the job's "
    "trace id instead of minting a fresh one, so one `tony-tpu trace "
    "--fleet` export renders every job in the pool — queue spans, "
    "grants, job lifetimes, preempt/grow-back resizes — on ONE "
    "timeline. Empty = the job mints its own trace id (non-fleet "
    "submits).")
INTERNAL_FLEET_TRACE_PARENT = _key(
    "tony.internal.fleet-trace-parent", "", str,
    "Stamped by the fleet daemon on every grant's conf: span id of the "
    "fleet.job span this grant opened. Recorded as the fleet_parent "
    "attr on the job's client.submit root span (an attr, not a span "
    "parent — the job's own span tree stays self-contained for the "
    "trace-parent invariant; the --fleet export stitches by shared "
    "trace id).")

# --- per-jobtype dynamic keys (reference TonyConfigurationKeys.java:171-239)
INSTANCES_FORMAT = "tony.{job}.instances"
COMMAND_FORMAT = "tony.{job}.command"
CHIPS_FORMAT = "tony.{job}.chips"          # replaces tony.X.gpus
VCORES_FORMAT = "tony.{job}.vcores"
MEMORY_FORMAT = "tony.{job}.memory"
MAX_INSTANCES_FORMAT = "tony.{job}.max-instances"
DEPENDS_ON_FORMAT = "tony.{job}.depends-on"
ENV_FORMAT = "tony.{job}.env"
# Replaces tony.X.node-label. On the gpu-host backend the reserved pool
# "coordinator" places the jobtype on the coordinator's machine (CPU
# ps/db-style tasks in a GPU gang — heterogeneous DAGs, SURVEY.md §7(d)).
NODE_POOL_FORMAT = "tony.{job}.node-pool"
# Container image for the jobtype's executors (reference per-job docker
# support, TonyConfigurationKeys.java:178-239 + Utils docker env :729-776).
# The backend wraps the executor launch in `docker run` (host networking;
# task workdir bind-mounted; task env passed with -e). TPU device access
# additionally needs a privileged image with /dev/accel* — bake jax[tpu]
# and tony-tpu into the image.
DOCKER_IMAGE_FORMAT = "tony.{job}.docker-image"

_JOB_KEY_RE: Pattern[str] = re.compile(
    r"^tony\.([a-z][a-z0-9_]*)\.(instances|command|chips|vcores|memory|"
    r"max-instances|depends-on|env|node-pool|docker-image)$")

_RESERVED_NON_JOB_SEGMENTS = {
    "application", "task", "coordinator", "client", "history", "tpu", "portal",
    "keep-failed-task-dirs", "internal", "fault", "rpc", "trace", "metrics",
    "diagnosis", "pool", "elastic", "profile", "train", "coord", "scale",
    "fleet", "health", "alerts",
}


def registry() -> Dict[str, ConfigKey]:
    """The static key registry (name → ConfigKey)."""
    return dict(_REGISTRY)


def defaults_markdown() -> str:
    """Render the documented defaults table. ``tony_tpu_torch/conf/defaults.md``
    must be exactly this output — the parity test regenerates and compares
    (the analogue of ``TestTonyConfigurationFields.java:17-45`` enforcing
    keys-class ↔ ``tony-default.xml`` agreement). Regenerate with
    ``python -m tony_tpu_torch.conf.keys``."""
    lines = [
        "# tony-tpu configuration defaults",
        "",
        "Generated from `tony_tpu_torch/conf/keys.py` — do not edit by hand; run",
        "`python -m tony_tpu_torch.conf.keys` to regenerate. Parity with the key",
        "registry is test-enforced (reference discipline:",
        "`TestTonyConfigurationFields.java:17-45`).",
        "",
        "| Key | Default | Type | Multi-value |",
        "|---|---|---|---|",
    ]
    for name in sorted(_REGISTRY):
        k = _REGISTRY[name]
        default = "(empty)" if k.default == "" else repr(k.default)
        lines.append(f"| `{name}` | {default} | {k.type.__name__} | "
                     f"{'yes' if k.multi_value else ''} |")
    lines += [
        "",
        "Dynamic per-jobtype keys (reference "
        "`TonyConfigurationKeys.java:171-239`):",
        "",
    ]
    for fmt in (INSTANCES_FORMAT, COMMAND_FORMAT, CHIPS_FORMAT,
                VCORES_FORMAT, MEMORY_FORMAT, MAX_INSTANCES_FORMAT,
                DEPENDS_ON_FORMAT, ENV_FORMAT, NODE_POOL_FORMAT,
                DOCKER_IMAGE_FORMAT):
        lines.append(f"- `{fmt.format(job='<jobtype>')}`")
    lines.append("")
    return "\n".join(lines)


def is_multi_value(name: str) -> bool:
    k = _REGISTRY.get(name)
    return bool(k and k.multi_value)


def parse_job_key(name: str) -> Optional[Tuple[str, str]]:
    """Return (jobtype, attribute) if `name` is a dynamic per-jobtype key.

    Mirrors the reference's regex-driven jobtype discovery
    (``TonyConfigurationKeys.getJobTypes``, :171-176).
    """
    m = _JOB_KEY_RE.match(name)
    if not m:
        return None
    job = m.group(1)
    if job in _RESERVED_NON_JOB_SEGMENTS:
        return None
    return job, m.group(2)


def coerce(name: str, value: Any) -> Any:
    """Coerce a raw (possibly string) value to the registered key type.
    An empty string means "unset" and falls back to the key's default
    (Hadoop Configuration getInt semantics — found by the config
    round-trip property test)."""
    key = _REGISTRY.get(name)
    if key is None:
        jk = parse_job_key(name)
        if jk and jk[1] in ("instances", "chips", "vcores", "max-instances"):
            if value in ("", None):
                # Empty = unset: keep it empty so each call site's get_int
                # default applies (vcores→1, max-instances→-1/unlimited) —
                # a hardcoded 0 here would turn "no cap" into a zero cap.
                return ""
            try:
                return int(value)
            except (TypeError, ValueError) as e:
                raise ValueError(f"config key {name!r} needs an integer, "
                                 f"got {value!r}") from e
        return value
    if value in ("", None) and key.type in (int, bool, float):
        return key.default
    if key.type is bool and isinstance(value, str):
        return value.strip().lower() in ("true", "1", "yes", "on")
    if key.type is int and not isinstance(value, bool):
        try:
            return int(value)
        except (TypeError, ValueError) as e:
            raise ValueError(f"config key {name!r} needs an integer, "
                             f"got {value!r}") from e
    if key.type is float and not isinstance(value, bool):
        try:
            return float(value)
        except (TypeError, ValueError) as e:
            raise ValueError(f"config key {name!r} needs a number, "
                             f"got {value!r}") from e
    if key.type is str:
        return str(value)
    return value


if __name__ == "__main__":
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "defaults.md")
    with open(path, "w", encoding="utf-8") as f:
        f.write(defaults_markdown())
    print(f"wrote {path}")
