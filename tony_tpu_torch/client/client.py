"""Client library: submit a job, monitor it, mirror task state to listeners.

Reference model: ``TonyClient.java`` (1107 LoC) — merge config layers
(``initTonyConf`` :483), validate quotas (:598-667), stage the job bundle
(``processFinalTonyConf`` :189-228), build default task commands
(``buildTaskCommand`` :454-475), launch the per-job controller, poll the app
report and mirror task status to listeners (``monitorApplication`` :838,
``updateTaskInfos`` :894), signal shutdown (``finishApplication`` :886), and
force-kill on demand (:959). Callback surface mirrors
``client/CallbackHandler.java`` + ``client/TaskUpdateListener.java``.

TPU-first deltas: the "cluster" is a slice/host inventory rather than YARN —
the coordinator is spawned directly (locally today; a TPU-VM provisioner
backend slots in behind the same interface), and staging copies to a local
bundle dir instead of HDFS.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import subprocess
import sys
import time
import uuid
from typing import List, Optional

from tony_tpu_torch import constants, tracing
from tony_tpu_torch.conf.config import ConfigError, TonyTpuConfig
from tony_tpu_torch.conf import keys as K
from tony_tpu_torch.rpc.wire import RpcClient
from tony_tpu_torch.utils import proc as procutil

log = logging.getLogger(__name__)


class TaskUpdateListener:
    """Programmatic-embedding hooks (reference ``TaskUpdateListener.java:14``
    + ``CallbackHandler.java:16``)."""

    def on_application_id_received(self, app_id: str) -> None:  # noqa: B027
        pass

    def on_task_infos_updated(self, task_infos: List[dict]) -> None:  # noqa: B027
        pass

    def on_application_report(self, report: dict) -> None:  # noqa: B027
        """Every poll, the raw coordinator report — mid-run state (tb_url,
        attempt, ...) that the task-info callback doesn't carry. Used by
        the notebook submitter to discover the server endpoint."""

    def on_application_finished(self, status: str, report: dict) -> None:  # noqa: B027
        pass


class TonyTpuClient:
    def __init__(self, conf: TonyTpuConfig,
                 workdir: Optional[str] = None):
        self.conf = conf
        self.workdir = workdir or os.environ.get(
            "TONY_TPU_WORKDIR",
            os.path.join(os.path.expanduser("~"), ".tony-tpu"))
        self.app_id: str = ""
        self.job_dir: str = ""
        self.listeners: List[TaskUpdateListener] = []
        self._coord_proc: Optional[subprocess.Popen] = None
        self._rpc: Optional[RpcClient] = None
        self._last_task_infos: List[dict] = []
        # Distributed tracing: the client is where the job's ONE trace
        # starts — the submit span is the root every coordinator/executor
        # span hangs under, and the anchor bench.py measures
        # submit→first-step from. Buffered locally, shipped over
        # trace.push once the coordinator answers its first report.
        # A FLEET-granted job adopts the fleet's trace id instead of
        # minting one (the daemon stamps tony.internal.fleet-trace-id
        # on the grant's conf), so `tony-tpu trace --fleet` renders the
        # whole pool — queue waits, grants, every job's lifecycle — on
        # one timeline.
        fleet_trace = str(conf.get(K.INTERNAL_FLEET_TRACE_ID, "")
                          or "")
        self._tracer = tracing.Tracer(
            trace_id=fleet_trace or None,
            service="client",
            enabled=conf.get_bool(K.TRACE_ENABLED, True))
        self._submit_span = tracing.NULL_SPAN
        self._trace_pushed = False

    # -- construction ----------------------------------------------------
    @classmethod
    def from_args(cls, config_file: Optional[str] = None,
                  overrides: tuple = (),
                  workdir: Optional[str] = None) -> "TonyTpuClient":
        """Reference ``TonyClient.init(args)`` :346 — parse layers, validate."""
        conf = TonyTpuConfig.from_layers(config_file=config_file,
                                         overrides=overrides)
        return cls(conf, workdir=workdir)

    def add_listener(self, listener: TaskUpdateListener) -> None:
        self.listeners.append(listener)

    # -- submit-time processing ------------------------------------------
    def _build_default_commands(self) -> None:
        """Jobtypes without a command get '<python> <executable> <params>'
        (reference ``buildTaskCommand`` :454-475)."""
        executable = str(self.conf.get(K.APPLICATION_EXECUTABLE, "") or "")
        params = str(self.conf.get(K.APPLICATION_TASK_PARAMS, "") or "")
        python = str(self.conf.get(K.PYTHON_BINARY_PATH, "") or "") \
            or sys.executable
        if str(self.conf.get(K.PYTHON_VENV, "") or "") and \
                not os.path.isabs(python):
            # The venv archive is unpacked to ./venv in every task workdir;
            # a relative interpreter resolves inside it (reference
            # ``TonyClient.buildTaskCommand`` venv interpreter :454-475).
            python = os.path.join("venv", python)
        jobs = self.conf.job_types()
        if not jobs and executable and \
                not str(self.conf.get(K.COORDINATOR_COMMAND, "") or ""):
            # Zero jobtypes → single-node mode: the coordinator runs the
            # command itself (reference ApplicationMaster.java:714).
            cmd = f"{python} {executable}"
            if params:
                cmd += f" {params}"
            self.conf.set(K.COORDINATOR_COMMAND, cmd)
            return
        for job in jobs.values():
            if job.command:
                continue
            if not executable:
                raise ConfigError(
                    f"jobtype {job.name!r} has no command and no "
                    f"{K.APPLICATION_EXECUTABLE} is set")
            cmd = f"{python} {executable}"
            if params:
                cmd += f" {params}"
            self.conf.set(K.COMMAND_FORMAT.format(job=job.name), cmd)

    def _storage_token(self) -> str:
        """Credential for the remote store: explicit conf key, else the
        submit environment (stamped into the frozen config either way —
        the delegation-token-shipped-with-the-job contract,
        ``security/TokenCache.java:44-51``)."""
        from tony_tpu_torch.storage.store import STORAGE_TOKEN_ENV

        return str(self.conf.get(K.STORAGE_TOKEN, "") or "") \
            or os.environ.get(STORAGE_TOKEN_ENV, "")

    def _export_storage_token(self) -> str:
        """Resolve the storage credential and move it into the submit
        environment BEFORE the coordinator is spawned (the coordinator
        inherits this env and re-exports it to executors — the
        separate-token-file discipline of the reference,
        TokenCache.java:44-51). Scrubbed from the config UNCONDITIONALLY:
        the frozen config is world-readable (portal config view, events,
        the store itself), and a token set for e.g. gs:// checkpoint
        access must not freeze just because staging itself is local."""
        from tony_tpu_torch.storage.store import STORAGE_TOKEN_ENV

        token = self._storage_token()
        if token:
            os.environ[STORAGE_TOKEN_ENV] = token
            self.conf.unset(K.STORAGE_TOKEN)
        return token

    def _stage_bundle(self, token: str = "") -> None:
        """Stage src-dir, container resources, and the python venv where
        executors can localize them (the HDFS-upload analogue,
        ``processFinalTonyConf`` :189-228). With ``tony.storage.
        remote-store`` set, everything is PUT to the object store under the
        job prefix and the internal keys carry store URLs — no shared
        filesystem between client and task hosts is assumed. Otherwise the
        job dir itself is the staging area (single-host path).

        The three groups (bundle tree, container resources, venv archive)
        are independent byte-copies, so they run CONCURRENTLY: validation
        happens up front in this thread (fail fast, before any copy
        starts), the copies fan out to a small thread pool, and the
        internal conf keys are set back here in submission order — the
        frozen config never depends on pool scheduling."""
        remote = str(self.conf.get(K.REMOTE_STORE, "") or "")
        store = prefix = None
        if remote:
            from tony_tpu_torch.storage import get_store
            from tony_tpu_torch.storage.store import join as ujoin

            store = get_store(remote, credential=token or None)
            prefix = ujoin(remote, self.app_id)
        src = str(self.conf.get(K.SRC_DIR, "") or "")
        resources = self.conf.get_list(K.CONTAINER_RESOURCES)
        venv = str(self.conf.get(K.PYTHON_VENV, "") or "")
        # Fail-fast validation BEFORE any bytes move.
        if src and not os.path.isdir(src):
            raise ConfigError(f"{K.SRC_DIR}={src!r} is not a directory")
        if venv and not os.path.isfile(venv):
            raise ConfigError(
                f"{K.PYTHON_VENV}={venv!r} is not an archive file")

        def stage_src() -> str:
            if store:
                from tony_tpu_torch.storage.store import join as ujoin

                url = ujoin(prefix, "bundle")
                store.put_tree(src, url)
                return url
            bundle = os.path.join(self.job_dir, "bundle")
            shutil.copytree(src, bundle, dirs_exist_ok=True)
            return bundle

        def stage_res() -> str:
            from tony_tpu_torch.utils.localize import stage_resources

            if store:
                from tony_tpu_torch.storage.store import join as ujoin

                staged = stage_resources(resources, "", store=store,
                                         store_prefix=ujoin(prefix,
                                                            "resources"))
            else:
                staged = stage_resources(
                    resources, os.path.join(self.job_dir, "resources"))
            return ",".join(staged)

        def stage_venv() -> str:
            if store:
                from tony_tpu_torch.storage.store import join as ujoin

                url = ujoin(prefix, os.path.basename(venv))
                store.put_file(venv, url)
                return url
            staged_venv = os.path.join(self.job_dir,
                                       os.path.basename(venv))
            shutil.copy2(venv, staged_venv)
            return staged_venv

        jobs = []
        if src:
            jobs.append((K.INTERNAL_BUNDLE_DIR, stage_src))
        if resources:
            jobs.append((K.INTERNAL_RESOURCES, stage_res))
        if venv:
            jobs.append((K.INTERNAL_VENV, stage_venv))
        if not jobs:
            return
        if len(jobs) == 1:
            # Nothing to overlap; skip the pool machinery.
            key, fn = jobs[0]
            self.conf.set(key, fn())
            return
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=len(jobs),
                                thread_name_prefix="tony-stage") as pool:
            futures = [(key, pool.submit(fn)) for key, fn in jobs]
            # .result() re-raises the first failure; remaining copies
            # finish in the pool's __exit__ — a partial staging area is
            # harmless, the job dir is per-app and about to be abandoned.
            for key, fut in futures:
                self.conf.set(key, fut.result())

    # -- lifecycle -------------------------------------------------------
    def start(self) -> int:
        """Submit + monitor to completion; returns a process exit code
        (reference ``run`` :155)."""
        self.conf.validate()
        self._build_default_commands()
        # Underscore-separated like YARN's application_<ts>_<n>: the history
        # filename grammar (history.py) uses '-' as its field separator.
        self.app_id = "app_%s_%s" % (time.strftime("%Y%m%d_%H%M%S"),
                                     uuid.uuid4().hex[:6])
        self.job_dir = os.path.join(self.workdir, "jobs", self.app_id)
        os.makedirs(self.job_dir, exist_ok=True)
        for lst in self.listeners:
            lst.on_application_id_received(self.app_id)
        # The fleet.job span id rides as an ATTR, not the span parent:
        # the job's own span tree stays self-contained (trace-parent
        # invariant), the --fleet export stitches by shared trace id.
        submit_attrs = {"app": self.app_id}
        fleet_parent = str(self.conf.get(
            K.INTERNAL_FLEET_TRACE_PARENT, "") or "")
        if fleet_parent:
            submit_attrs["fleet_parent"] = fleet_parent
        self._submit_span = self._tracer.start_span(
            "client.submit", attrs=submit_attrs)
        frozen = os.path.join(self.job_dir, constants.FINAL_CONFIG_FILE)
        addr_file = os.path.join(self.job_dir, "coordinator.addr")
        try:
            # Overlap the serial prefix: the coordinator process is
            # spawned FIRST — against a frozen-config path that does not
            # exist yet (its __main__ polls for it, --conf-wait-s) — so
            # its interpreter boot, imports, and backend construction run
            # CONCURRENTLY with the client-side staging copies below.
            # The credential export must precede the spawn (the
            # coordinator inherits this env).
            token = self._export_storage_token()
            self._spawn_coordinator(frozen, addr_file)
            stage_span = self._tracer.start_span(
                "client.stage", parent=self._submit_span,
                attrs={"parallel": True})
            try:
                self._stage_bundle(token)
            finally:
                stage_span.end()
            self.conf.set(K.INTERNAL_APP_ID, self.app_id)
            from tony_tpu_torch.utils.version import version_info

            vi = version_info()
            self.conf.set(K.INTERNAL_VERSION,
                          f"{vi['version']} (torch {vi['torch']})")
            self.conf.set(K.INTERNAL_REVISION, vi["revision"])
            self.conf.set(K.INTERNAL_BRANCH, vi["branch"])
            remote = str(self.conf.get(K.REMOTE_STORE, "") or "")
            conf_url = ""
            if remote:
                # Executors on remote hosts fetch the frozen config itself
                # from the store; the URL must be IN the config for the
                # coordinator to hand out, so set it before freezing.
                from tony_tpu_torch.storage.store import join as ujoin

                conf_url = ujoin(remote, self.app_id,
                                 constants.FINAL_CONFIG_FILE)
                self.conf.set(K.INTERNAL_CONF_URL, conf_url)
            # Atomic (tmp+rename, utils/durable.py): the waiting
            # coordinator must never read a partial config.
            self.conf.freeze(frozen)
            if conf_url:
                from tony_tpu_torch.storage import get_store

                get_store(remote, credential=token or None
                          ).put_file(frozen, conf_url)
            return self._monitor(addr_file)
        except RuntimeError as e:
            # Coordinator died before/while serving (reference returns -1
            # from monitorApplication on a failed app report, :838-892).
            log.error("submission failed: %s", e)
            return constants.EXIT_FAILURE
        finally:
            # Also reached on a staging ConfigError: the already-spawned
            # coordinator (still waiting for the config) must not leak.
            self._cleanup()

    def _spawn_coordinator(self, frozen: str, addr_file: str) -> None:
        history_root = str(self.conf.get(K.HISTORY_LOCATION, "") or "") \
            or os.path.join(self.workdir, "history")
        cmd = [sys.executable, "-m", "tony_tpu_torch.coordinator",
               "--conf", frozen, "--conf-wait-s", "600",
               "--app-id", self.app_id,
               "--history-root", history_root,
               "--workdir", os.path.join(self.job_dir, "tasks"),
               "--addr-file", addr_file,
               "--user", os.environ.get("USER", "unknown")]
        coord_log = open(os.path.join(self.job_dir, "coordinator.log"), "wb")
        env = dict(os.environ)
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = (repo_root + os.pathsep +
                             env.get("PYTHONPATH", "")).rstrip(os.pathsep)
        if self._tracer.enabled:
            # The coordinator's run span parents under this submit span.
            env[constants.TRACE_ID_ENV] = self._tracer.trace_id
            env[constants.TRACE_PARENT_ENV] = self._submit_span.span_id
        self._coord_proc = subprocess.Popen(
            cmd, stdout=coord_log, stderr=subprocess.STDOUT, env=env)
        coord_log.close()

    def _connect(self, addr_file: str) -> RpcClient:
        """Poll for the coordinator endpoint (the RM-report analogue)."""
        def read_addr() -> Optional[dict]:
            if self._coord_proc and self._coord_proc.poll() is not None:
                raise RuntimeError(
                    f"coordinator exited early with "
                    f"{self._coord_proc.returncode}; see "
                    f"{os.path.join(self.job_dir, 'coordinator.log')}")
            if os.path.exists(addr_file):
                with open(addr_file, encoding="utf-8") as f:
                    return json.load(f)
            return None

        # Generous window: since the overlapped-submit change the
        # coordinator only binds its port AFTER the client finishes
        # staging and freezes the config, so big remote stagings push the
        # address file out by minutes. A dead coordinator is still
        # detected within one 0.1 s poll (read_addr raises), so the long
        # timeout only bounds the pathological silent-hang case.
        addr = procutil.poll_till_non_null(read_addr, interval_s=0.1,
                                           timeout_s=600)
        if addr is None:
            raise RuntimeError("coordinator address never appeared")
        tls = None
        if addr.get("tls_cert"):
            from tony_tpu_torch.rpc.wire import client_tls_context
            tls = client_tls_context(addr["tls_cert"])
        # Short INNER retry budget: the monitor loop around this client
        # already retries forever (with a coordinator-liveness check per
        # failure) — stacking the transport's default 10×2 s on top only
        # delayed dead-coordinator detection by ~20 s.
        return RpcClient(addr["host"], addr["port"],
                         token=addr.get("token") or None, tls=tls,
                         max_retries=3, retry_sleep_s=0.5, peer="coordinator")

    def _monitor(self, addr_file: str) -> int:
        """Reference ``monitorApplication`` :838-892 (1 s poll; task-info
        diffs to listeners; terminal status → finishApplication)."""
        self._rpc = self._connect(addr_file)
        interval = self.conf.get_int(K.CLIENT_POLL_INTERVAL_MS, 1000) / 1000.0
        while True:
            try:
                report = self._rpc.call("get_application_report")
            except Exception as e:  # noqa: BLE001
                if self._coord_proc and self._coord_proc.poll() is not None:
                    log.error("coordinator died: %s", e)
                    return constants.EXIT_FAILURE
                time.sleep(interval)
                continue
            if not self._trace_pushed:
                # First answered report: the app is live — close the
                # submit span and ship the client's spans into the job's
                # span log (best-effort; the trace survives without them).
                self._trace_pushed = True
                self._submit_span.end(status=report.get("status", ""))
                records = self._tracer.drain()
                if records:
                    try:
                        self._rpc.call("trace.push", records=records)
                    except Exception:  # noqa: BLE001
                        pass
            tasks = report.get("tasks", [])
            if tasks != self._last_task_infos:
                self._last_task_infos = tasks
                for lst in self.listeners:
                    lst.on_task_infos_updated(tasks)
            for lst in self.listeners:
                try:
                    lst.on_application_report(report)
                except Exception as e:  # noqa: BLE001
                    # A listener failure (e.g. the notebook proxy's local
                    # port already bound) must not tear down a running job.
                    log.warning("listener %s.on_application_report "
                                "failed: %s", type(lst).__name__, e)
            status = report.get("status", "")
            if status in ("SUCCEEDED", "FAILED", "KILLED"):
                for lst in self.listeners:
                    lst.on_application_finished(status, report)
                try:
                    self._rpc.call("finish_application")
                except Exception:  # noqa: BLE001
                    pass
                # Let the coordinator finalize events/history before we
                # return (it tears down after the finish signal,
                # reference stop() :670-688).
                if self._coord_proc is not None:
                    try:
                        self._coord_proc.wait(timeout=30)
                    except subprocess.TimeoutExpired:
                        log.warning("coordinator slow to exit; killing")
                if status != "SUCCEEDED" and report.get("failure_reason"):
                    domain = report.get("failure_domain", "")
                    log.error("application %s%s: %s", status,
                              f" [{domain}]" if domain else "",
                              report["failure_reason"])
                return 0 if status == "SUCCEEDED" else constants.EXIT_FAILURE
            time.sleep(interval)

    def force_kill(self) -> None:
        """Reference ``forceKillApplication`` :959 + the CLI kill-on-exit
        shutdown hook (``ClusterSubmitter.java:69``)."""
        try:
            if self._rpc is not None:
                self._rpc.call("kill_application")
        except Exception:  # noqa: BLE001
            pass
        if self._coord_proc is not None and self._coord_proc.poll() is None:
            # The coordinator's teardown legitimately takes up to TWO
            # grace windows (kill ladder in _monitor, then _stop's
            # client-finish wait when nothing signals finish — the Ctrl-C
            # path) — wait them out before escalating, or the escalation
            # itself orphans user processes mid-preemption-save and
            # leaves history unfinalized.
            from tony_tpu_torch.conf import keys as K

            grace = self.conf.get_int(K.COORDINATOR_STOP_GRACE_S, 15)
            try:
                self._coord_proc.wait(timeout=2 * grace + 15)
            except subprocess.TimeoutExpired:
                self._coord_proc.terminate()

    def _cleanup(self) -> None:
        if self._rpc is not None:
            self._rpc.close()
        if self._coord_proc is not None and self._coord_proc.poll() is None:
            self._coord_proc.terminate()
            try:
                self._coord_proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self._coord_proc.kill()

    # -- introspection ---------------------------------------------------
    @property
    def task_infos(self) -> List[dict]:
        return list(self._last_task_infos)
