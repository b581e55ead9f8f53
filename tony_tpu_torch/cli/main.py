"""CLI: submit and inspect jobs.

Reference model: ``tony-cli`` — ``ClusterSubmitter`` (stage + delegate to the
client with a kill-on-exit hook, :49-74), ``LocalSubmitter`` (zero-install
demo against an in-process cluster, :47-68). The history subcommand covers
the portal's jobs-index view for terminals (``tony-portal/conf/routes:1``).

The port's CLI has the subcommands of the job path: ``submit``, ``kill``,
``status``, ``recover``, ``history``, ``events``, ``logs``, ``trace`` and
``diagnose``; ``resize`` and ``migrate`` (a running elastic job's gang);
``pool`` (``start``, ``status``, ``stop``: the warm executor pool,
``tony_tpu_torch/pool.py``); and the gates ``check`` (a finished job's
artifacts against the protocol invariants) and ``lint`` (tonylint over
``tony_tpu_torch/``). The reference's others (notebook, profile, bench,
top, alerts, portal, gcloud-gc, chaos, fleet) are ROADMAP queue A.

Usage:
    python -m tony_tpu_torch.cli submit --conf-file job.yaml [--conf k=v ...]
    python -m tony_tpu_torch.cli submit --executable train.py --instances 2
    python -m tony_tpu_torch.cli history [--history-root DIR]
    python -m tony_tpu_torch.cli events <app_id>
    python -m tony_tpu_torch.cli pool start --size 1 [--dir DIR]
    python -m tony_tpu_torch.cli migrate <app_id> slice-1
    python -m tony_tpu_torch.cli check <app_id|job_dir> [--json]
    python -m tony_tpu_torch.cli lint [--json] [--rule RULE]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys
from typing import List, Optional

from tony_tpu_torch.client import TaskUpdateListener, TonyTpuClient
from tony_tpu_torch.conf import keys as K


class _LogListener(TaskUpdateListener):
    def on_application_id_received(self, app_id: str) -> None:
        print(f"submitted application {app_id}")

    def on_task_infos_updated(self, task_infos) -> None:
        states = {}
        for t in task_infos:
            states.setdefault(t.get("status", "?"), []).append(
                f"{t.get('name', '?')}:{t.get('index', '?')}")
        print("tasks:", "  ".join(
            f"{s}={','.join(ids)}" for s, ids in sorted(states.items())))

    def on_application_finished(self, status: str, report: dict) -> None:
        print(f"application finished: {status}")
        if report.get("failure_reason"):
            print(f"reason: {report['failure_reason']}")
        if report.get("failure_domain"):
            print(f"failure domain: {report['failure_domain']}")


def _cmd_submit(args: argparse.Namespace) -> int:
    overrides = list(args.conf or [])
    if args.executable:
        overrides.append(f"{K.APPLICATION_EXECUTABLE}={args.executable}")
    if args.task_params:
        overrides.append(f"{K.APPLICATION_TASK_PARAMS}={args.task_params}")
    if args.src_dir:
        overrides.append(f"{K.SRC_DIR}={args.src_dir}")
    if args.instances is not None:
        overrides.append(f"tony.worker.instances={args.instances}")
    client = TonyTpuClient.from_args(config_file=args.conf_file,
                                     overrides=tuple(overrides),
                                     workdir=args.workdir)
    client.add_listener(_LogListener())

    # Kill-on-exit hook (reference ClusterSubmitter.java:69).
    def on_signal(signum, frame):
        print(f"signal {signum}: killing application", file=sys.stderr)
        client.force_kill()
        sys.exit(130)

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    return client.start()


def _default_workdir(arg):
    """Single source for the client workdir default (must match what
    submit used, or kill/history look in the wrong place)."""
    return arg or os.environ.get(
        "TONY_TPU_WORKDIR",
        os.path.join(os.path.expanduser("~"), ".tony-tpu"))


def _cmd_kill(args: argparse.Namespace) -> int:
    """Force-kill a running application by id (reference
    ``forceKillApplication`` TonyClient.java:959, as a standalone command:
    the coordinator's RPC endpoint is discovered from the job dir's
    address file, like the client does at submit)."""
    rpc = _coordinator_rpc(args.app_id, args.workdir)
    if rpc is None:
        print(f"no coordinator address for {args.app_id} under "
              f"{_default_workdir(args.workdir)} (wrong --workdir, or the "
              f"job already finished)", file=sys.stderr)
        return 1
    try:
        rpc.call("kill_application")
    except Exception as e:  # noqa: BLE001
        print(f"kill failed (coordinator gone?): {e}", file=sys.stderr)
        return 1
    print(f"kill signal sent to {args.app_id}")
    return 0


def _cmd_recover(args: argparse.Namespace) -> int:
    """Restart a crashed coordinator in-place with --recover: replay the
    job's write-ahead session journal, re-adopt the surviving executors,
    and block until the job finishes (the operator-facing face of
    coordinator crash recovery — docs/operations.md). Runs the
    coordinator IN this process so its exit code is the job's."""
    job_dir = os.path.join(_default_workdir(args.workdir), "jobs",
                           args.app_id)
    from tony_tpu_torch import constants
    from tony_tpu_torch.conf.config import TonyTpuConfig

    frozen = os.path.join(job_dir, constants.FINAL_CONFIG_FILE)
    if not os.path.exists(frozen):
        print(f"no frozen config for {args.app_id} under {job_dir} "
              f"(wrong --workdir?)", file=sys.stderr)
        return 1
    conf = TonyTpuConfig.load_final(frozen)
    history_root = args.history_root \
        or str(conf.get(K.HISTORY_LOCATION, "") or "") \
        or os.path.join(_default_workdir(args.workdir), "history")
    # Refuse cleanly when there is nothing to replay — better than the
    # coordinator failing after it already rebound the address file.
    journal_path = os.path.join(history_root,
                                constants.HISTORY_INTERMEDIATE,
                                args.app_id, constants.JOURNAL_FILE)
    if not os.path.exists(journal_path):
        print(f"no session journal at {journal_path} — the job was not "
              f"run with tony.coordinator.journal-enabled, or it already "
              f"finished (check `tony-tpu status {args.app_id}`)",
              file=sys.stderr)
        return 1
    from tony_tpu_torch.coordinator.__main__ import main as coordinator_main

    print(f"recovering {args.app_id} from {journal_path}")
    return coordinator_main([
        "--conf", frozen,
        "--app-id", args.app_id,
        "--history-root", history_root,
        "--workdir", os.path.join(job_dir, "tasks"),
        "--addr-file", os.path.join(job_dir, "coordinator.addr"),
        "--user", os.environ.get("USER", "unknown"),
        "--recover",
    ])


def _coordinator_rpc(app_id: str, workdir: Optional[str]):
    """RpcClient for a RUNNING job's coordinator, from the job dir's
    address file (how kill/status reach a job after the submitting
    process is gone); None when the file is absent."""
    import json

    from tony_tpu_torch.rpc.wire import RpcClient

    addr_file = os.path.join(_default_workdir(workdir), "jobs", app_id,
                             "coordinator.addr")
    if not os.path.exists(addr_file):
        return None
    with open(addr_file, encoding="utf-8") as f:
        addr = json.load(f)
    tls = None
    if addr.get("tls_cert"):
        from tony_tpu_torch.rpc.wire import client_tls_context
        tls = client_tls_context(addr["tls_cert"])
    return RpcClient(addr["host"], addr["port"],
                     token=addr.get("token") or None,
                     max_retries=2, retry_sleep_s=0.5, tls=tls,
                     peer="coordinator")


def _cmd_resize(args: argparse.Namespace) -> int:
    """Elastic resize of a RUNNING job's gang (coordinator/elastic.py):
    shrink drains the survivors at a step barrier and re-meshes —
    releasing the highest indices — grow re-admits members through the
    same barrier. Requires tony.elastic.enabled on the job; refused
    below tony.elastic.min-tasks."""
    rpc = _coordinator_rpc(args.app_id, args.workdir)
    if rpc is None:
        print(f"no coordinator address for {args.app_id} under "
              f"{_default_workdir(args.workdir)} (job finished? wrong "
              f"--workdir?) — resize needs a live job", file=sys.stderr)
        return 1
    try:
        res = rpc.call("resize_application", size=args.size,
                       job=args.job or "")
    except Exception as e:  # noqa: BLE001
        print(f"resize failed (coordinator gone?): {e}", file=sys.stderr)
        return 1
    finally:
        rpc.close()
    if not isinstance(res, dict) or not res.get("ok"):
        msg = res.get("message", "refused") if isinstance(res, dict) \
            else str(res)
        print(f"resize refused: {msg}", file=sys.stderr)
        return 1
    print(res.get("message", "resize accepted"))
    print(f"members: {res.get('members')}")
    print(f"watch it land with `python -m tony_tpu_torch.cli events "
          f"{args.app_id}` (GANG_RESIZED)")
    return 0


def _cmd_migrate(args: argparse.Namespace) -> int:
    """Live migration of a RUNNING job's gang to another slice
    (coordinator/migrate.py): fenced DRAIN at a step barrier → final
    durable saves → relaunch/adopt on the target → restore-with-reshard
    — a planned move with steps_lost==0, vs. the crash-shaped path a
    reclaim would force. Requires tony.elastic.enabled on the job."""
    rpc = _coordinator_rpc(args.app_id, args.workdir)
    if rpc is None:
        print(f"no coordinator address for {args.app_id} under "
              f"{_default_workdir(args.workdir)} (job finished? wrong "
              f"--workdir?) — migrate needs a live job", file=sys.stderr)
        return 1
    try:
        res = rpc.call("migrate_application", target=args.target,
                       job=args.job or "")
    except Exception as e:  # noqa: BLE001
        print(f"migrate failed (coordinator gone?): {e}",
              file=sys.stderr)
        return 1
    finally:
        rpc.close()
    if not isinstance(res, dict) or not res.get("ok"):
        msg = res.get("message", "refused") if isinstance(res, dict) \
            else str(res)
        print(f"migrate refused: {msg}", file=sys.stderr)
        return 1
    print(res.get("message", "migration accepted"))
    print(f"members: {res.get('members')}")
    print(f"route:   {res.get('source') or '(default pool)'} -> "
          f"{res.get('target')}")
    print(f"watch it land with `python -m tony_tpu_torch.cli events "
          f"{args.app_id}` (GANG_MIGRATED)")
    return 0


def _cmd_status(args: argparse.Namespace) -> int:
    """Live application report from a running job's coordinator
    (reference: the client's status poll surface, ``TonyClient.java:838``;
    the yarn `application -status` analogue). Falls back to history for
    finished jobs."""
    rpc = _coordinator_rpc(args.app_id, args.workdir)
    if rpc is not None:
        try:
            report = rpc.call("get_application_report")
            print(f"app_id:   {report['app_id']}")
            print(f"status:   {report['status']}")
            print(f"attempt:  {report['attempt']} "
                  f"(retries left: {report['retries_left']}, "
                  f"preemption retries left: "
                  f"{report.get('preemption_retries_left', '?')})")
            if report.get("recovered"):
                print(f"recovered: yes (coordinator generation "
                      f"{report.get('generation', '?')})")
            gang = report.get("gang_size") or {}
            if gang:
                sizes = "  ".join(f"{j}×{n}"
                                  for j, n in sorted(gang.items()))
                el = report.get("elastic") or {}
                suffix = ""
                if el:
                    suffix = f"  (mgen {el.get('mgen', '?')}"
                    if el.get("resizing"):
                        suffix += (f", RESIZING to "
                                   f"{el.get('target_size', '?')}")
                    suffix += ")"
                print(f"gang:     {sizes}{suffix}")
            if report.get("failure_reason"):
                print(f"reason:   {report['failure_reason']}")
            if report.get("failure_domain"):
                print(f"domain:   {report['failure_domain']}")
            if report.get("tb_url"):
                print(f"tb_url:   {report['tb_url']}")
            for t in report.get("tasks", []):
                print(f"  {t['name']}:{t['index']:<3} {t['status']:<10} "
                      f"{t.get('host', '') or ''}{_fmt_hb_age(t)}"
                      f"{_fmt_progress(t)}{_fmt_exit(t)}")
            return 0
        except Exception as e:  # noqa: BLE001
            print(f"(coordinator unreachable: {e}; trying history)",
                  file=sys.stderr)
    from tony_tpu_torch.events import history

    root = _history_root(args)
    for r in history.list_jobs(root):
        if r.app_id == args.app_id:
            print(f"app_id:   {r.app_id}")
            print(f"status:   {r.status or 'RUNNING'}")
            print(f"user:     {r.user}")
            print(f"started:  {r.started_iso}")
            return 0
    print(f"unknown application {args.app_id} (not running under "
          f"{_default_workdir(args.workdir)}, no history under {root})",
          file=sys.stderr)
    return 1


def _fmt_exit(task: dict) -> str:
    """Decoded exit-signal suffix for a failed task's status row —
    '-9'/'137' render as 'SIGKILL (signal 9; likely OOM-killer ...)'
    via the shared decoder the rule engine uses too."""
    code = task.get("exit_code")
    if code in (None, 0):
        return ""
    from tony_tpu_torch.diagnosis.exitcodes import describe_exit

    return f"  {describe_exit(code)}"


def _fmt_hb_age(task: dict) -> str:
    """Heartbeat-age column for a status row, sourced from the same
    liveness map the coordinator's heartbeat monitor expires on (absent
    for terminal/unregistered tasks)."""
    age = task.get("last_heartbeat_age_s")
    if age is None:
        return ""
    return f"  hb={float(age):.1f}s"


def _fmt_progress(task: dict) -> str:
    """One-line progress-liveness suffix for a status row: step counter,
    rate, stall age, and the hang/straggler verdicts (coordinator
    application_report 'progress' field; absent for uninstrumented or
    terminal tasks)."""
    p = task.get("progress") or {}
    if not p:
        return ""
    state = p.get("state", "")
    if "steps" not in p:
        return f"  [{state}]" if state else ""
    out = f"  steps={p['steps']:g}"
    if p.get("rate_steps_per_s") is not None:
        out += f" ({p['rate_steps_per_s']:g}/s)"
    if p.get("stalled_s", 0) and float(p["stalled_s"]) >= 1.0:
        out += f" stalled {float(p['stalled_s']):.0f}s"
    if state in ("hung", "straggler"):
        out += f" {state.upper()}"
    return out


def _cmd_trace(args: argparse.Namespace) -> int:
    """Export a job's span log as Chrome/Perfetto trace_events JSON
    (load at https://ui.perfetto.dev or chrome://tracing). The span log
    lives in the job's history dir next to the jhist stream; works on
    running AND finished jobs."""
    from tony_tpu_torch import constants, tracing
    from tony_tpu_torch.events import history

    root = _history_root(args)
    job_dir = history.list_job_dirs(root).get(args.app_id)
    if job_dir is None:
        print(f"unknown application {args.app_id} under {root}",
              file=sys.stderr)
        return 1
    path = os.path.join(job_dir, constants.TRACE_FILE)
    if not os.path.exists(path):
        print(f"no span log at {path} — the job ran with "
              f"tony.trace.enabled=false, or predates tracing",
              file=sys.stderr)
        return 1
    records = tracing.load_records(path)
    if args.cold_start:
        # Per-phase submit→first-step decomposition (the bench's phase
        # artifact, on demand for any job): consecutive boundary
        # intervals, so the phases sum exactly to the total.
        try:
            bd = tracing.cold_start_breakdown(records)
        except RuntimeError as e:
            print(f"cold-start breakdown unavailable: {e}",
                  file=sys.stderr)
            return 1
        print(f"{args.app_id}  submit -> first step: {bd['total_s']:.2f}s"
              f"  (task {bd['task'] or '?'})")
        for phase, secs in bd["phases"].items():
            bar = "#" * min(60, int(60 * secs / max(bd["total_s"], 1e-9)))
            print(f"  {phase:<10}{secs:>8.2f}s  {bar}")
        if bd["span_durations"]:
            print("  raw span durations (may overlap):")
            for name, secs in sorted(bd["span_durations"].items()):
                print(f"    {name:<28}{secs:>8.2f}s")
        return 0
    payload = tracing.to_trace_events(records)
    text = json.dumps(payload, indent=1)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text)
        print(f"wrote {args.out}", file=sys.stderr)
    else:
        print(text)
    n_spans = sum(1 for e in payload["traceEvents"]
                  if e.get("ph") == "X")
    unclosed = payload.get("unclosedSpans", [])
    print(f"{n_spans} spans, {len(unclosed)} unclosed"
          + (f" ({', '.join(unclosed)})" if unclosed else ""),
          file=sys.stderr)
    return 0


def _cmd_diagnose(args: argparse.Namespace) -> int:
    """Automatic failure diagnosis: print the incident report for a job
    — verdict category, blamed task, evidence lines, the user traceback
    / stack-dump excerpt verbatim, and the causal timeline. Finished
    jobs serve the coordinator-written incident.json (recompute with
    --fresh); live jobs get a PROVISIONAL read computed on the spot.
    Works post-hoc on any history dir, including one copied off a dead
    host."""
    from tony_tpu_torch import constants, diagnosis
    from tony_tpu_torch.events import history

    root = _history_root(args)
    job_dir = history.list_job_dirs(root).get(args.app_id)
    if job_dir is None:
        print(f"unknown application {args.app_id} under {root}",
              file=sys.stderr)
        return 1
    live = history.find_history_file(job_dir) is None
    incident = None
    if not live and not args.fresh:
        incident = diagnosis.load_incident(
            os.path.join(job_dir, constants.INCIDENT_FILE))
    if incident is None:
        incident = diagnosis.diagnose_job_dir(job_dir, app_id=args.app_id,
                                              provisional=live)
    if args.json:
        print(json.dumps(incident, indent=1, sort_keys=True))
        return 0
    if incident.get("status") == "SUCCEEDED":
        print(f"{args.app_id} SUCCEEDED — nothing to diagnose "
              f"(full report follows for the curious)", file=sys.stderr)
    print(diagnosis.render_text(incident))
    return 0


def _history_root(args: argparse.Namespace) -> str:
    """One default for every history-reading subcommand — four diverging
    copies would silently make history/events/logs/portal look in
    different places."""
    return args.history_root or os.path.join(_default_workdir(None),
                                             "history")


def _cmd_history(args: argparse.Namespace) -> int:
    from tony_tpu_torch.events import history

    root = _history_root(args)
    rows = history.list_jobs(root)
    if not rows:
        print(f"no job history under {root}")
        return 0
    fmt = "{:<32} {:<10} {:<12} {:<20}"
    print(fmt.format("APP_ID", "STATUS", "USER", "STARTED"))
    for r in rows:
        print(fmt.format(r.app_id, r.status or "RUNNING", r.user,
                         r.started_iso))
    return 0


def _cmd_events(args: argparse.Namespace) -> int:
    from tony_tpu_torch.events import history

    root = _history_root(args)
    events = history.read_job_events(root, args.app_id)
    if events is None:
        print(f"no history for {args.app_id} under {root}", file=sys.stderr)
        return 1
    for ev in events:
        print(ev)
    return 0


def _cmd_logs(args: argparse.Namespace) -> int:
    """Dump per-task stdout/stderr recorded in the job's TASK_FINISHED
    events — the terminal analogue of `yarn logs -applicationId` (the
    reference surfaced NodeManager log URLs per container,
    ``models/JobLog.java:69-80``; here the paths live in the event
    stream and the files on the submitting host's workdir)."""
    from tony_tpu_torch.events import history

    root = _history_root(args)
    events = history.read_job_events(root, args.app_id)
    if events is None:
        print(f"no history for {args.app_id} under {root}", file=sys.stderr)
        return 1
    shown = 0
    for ev in events:
        if ev.type != "TASK_FINISHED":
            continue
        task = ev.payload.get("task", "?")
        if args.task and task != args.task:
            continue
        for path in ev.payload.get("logs", []):
            print(f"===== {task} — {path} =====")
            try:
                with open(path, "r", encoding="utf-8",
                          errors="replace") as f:
                    sys.stdout.write(f.read())
            except OSError as e:
                # stderr, and NOT counted: purged/deleted logs must not
                # let the command exit 0 having printed no content.
                print(f"{task}: {path} unreadable: {e}", file=sys.stderr)
                continue
            shown += 1
    if not shown:
        print("no readable task logs" +
              (f" for task {args.task}" if args.task else ""),
              file=sys.stderr)
        return 1
    return 0


def _pool_dir(args: argparse.Namespace) -> str:
    return os.path.abspath(os.path.expanduser(
        args.dir or os.path.join(_default_workdir(args.workdir), "pool")))


def _cmd_pool(args: argparse.Namespace) -> int:
    """Warm-executor-pool operations (tony_tpu_torch/pool.py): `start` spawns
    the daemon detached and waits for its endpoint; `status` prints the
    fleet; `stop` asks the daemon to shut idle workers down (leased
    executors belong to their jobs and are left alone). Point submits at
    it with tony.pool.dir=<dir>. No compile cache is mounted: the port's
    kernels persist under tony_tpu_torch/_build/ (ops/_build.py)."""
    import subprocess

    from tony_tpu_torch import constants
    from tony_tpu_torch.pool import PoolClient
    from tony_tpu_torch.utils import proc as procutil

    pool_dir = _pool_dir(args)
    addr_path = os.path.join(pool_dir, constants.POOL_ADDR_FILE)
    if args.action == "start":
        if os.path.exists(addr_path):
            client = PoolClient(pool_dir)
            try:
                st = client.call("pool.status")
                print(f"pool already running under {pool_dir} "
                      f"({st.get('ready', '?')} ready / "
                      f"{st.get('size', '?')} size)")
                return 0
            except Exception:  # noqa: BLE001 — stale addr from a dead pool
                os.unlink(addr_path)
            finally:
                client.close()
        os.makedirs(pool_dir, exist_ok=True)
        from tony_tpu_torch.conf.config import TonyTpuConfig

        conf = TonyTpuConfig.from_layers(config_file=args.conf_file,
                                         overrides=tuple(args.conf or []))
        size = args.size if args.size is not None \
            else conf.get_int(K.POOL_SIZE, 2)
        preload = args.preload if args.preload is not None \
            else str(conf.get(K.POOL_PRELOAD, "torch"))
        max_age = conf.get_int(K.POOL_MAX_LEASE_AGE_S, 600)
        pool_log = open(os.path.join(pool_dir, "pool.log"), "ab")
        cmd = [sys.executable, "-m", "tony_tpu_torch.pool", "serve",
               "--dir", pool_dir, "--size", str(size),
               "--preload", preload, "--max-lease-age-s", str(max_age)]
        proc = subprocess.Popen(cmd, stdout=pool_log,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        pool_log.close()

        def read_addr():
            if proc.poll() is not None:
                raise RuntimeError(
                    f"pool daemon exited with {proc.returncode}; see "
                    f"{os.path.join(pool_dir, 'pool.log')}")
            return os.path.exists(addr_path) or None

        if procutil.poll_till_non_null(read_addr, interval_s=0.1,
                                       timeout_s=60) is None:
            print(f"pool daemon never published its endpoint under "
                  f"{pool_dir}", file=sys.stderr)
            return 1
        print(f"pool running under {pool_dir} (size {size}, "
              f"preload {preload!r}); submit with "
              f"--conf {K.POOL_DIR}={pool_dir}")
        return 0
    client = PoolClient(pool_dir)
    try:
        if args.action == "status":
            st = client.call("pool.status")
            print(f"{pool_dir}  size={st['size']}  ready={st['ready']}  "
                  f"leased={st['leased']}")
            for w in st.get("workers", []):
                print(f"  {w['worker']}  pid={w['pid']:<8}"
                      f"{w['state']:<9}age={w['age_s']:.0f}s"
                      + (f"  task={w['task']}" if w.get("task") else ""))
            return 0
        if args.action == "stop":
            client.call("pool.stop")
            print(f"pool under {pool_dir} stopping (leased executors "
                  f"are left to their jobs)")
            return 0
    except Exception as e:  # noqa: BLE001
        print(f"no reachable pool under {pool_dir}: {e}", file=sys.stderr)
        return 1
    finally:
        client.close()
    return 1


def _cmd_lint(args: argparse.Namespace) -> int:
    """`tony-tpu lint` — the static invariant checker (tonylint)."""
    from tony_tpu_torch.devtools import tonylint

    argv: List[str] = []
    if args.list_rules:
        argv.append("--list")
    if args.json:
        argv.append("--json")
    if args.root:
        argv += ["--root", args.root]
    for rule in args.rule or []:
        argv += ["--rule", rule]
    return tonylint.main(argv)


def _cmd_check(args: argparse.Namespace) -> int:
    """`tony-tpu check` — the cross-artifact trace invariant checker
    (tonycheck's runtime half; devtools/invariants.py)."""
    from tony_tpu_torch.devtools import invariants
    from tony_tpu_torch.events import history

    target = args.target
    if os.path.isdir(target):
        job_dir = target
    else:
        root = _history_root(args)
        job_dir = history.list_job_dirs(root).get(target)
        if job_dir is None:
            print(f"unknown application {target} under {root}",
                  file=sys.stderr)
            return 2
    report = invariants.check_job_dir(job_dir)
    if args.json:
        print(json.dumps(report.to_dict(), indent=1, sort_keys=True))
    else:
        print(invariants.render_text([report]))
    return 0 if report.ok else 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tony-tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("submit", help="submit a job and monitor it")
    s.add_argument("--conf-file", help="job config (json/yaml)")
    s.add_argument("--conf", action="append", metavar="K=V",
                   help="config override (repeatable)")
    s.add_argument("--executable", help="training script (python_binary is "
                   "prepended; reference -executes)")
    s.add_argument("--task-params", help="args appended to the default "
                   "command (reference -task_params)")
    s.add_argument("--src-dir", help="directory staged to every task "
                   "(reference -src_dir)")
    s.add_argument("--instances", type=int,
                   help="shortcut for tony.worker.instances")
    s.add_argument("--workdir", help="client workdir (default ~/.tony-tpu)")
    s.set_defaults(fn=_cmd_submit)

    k = sub.add_parser("kill", help="force-kill a running application")
    k.add_argument("app_id")
    k.add_argument("--workdir", help="client workdir the job was "
                                     "submitted from (default ~/.tony-tpu)")
    k.set_defaults(fn=_cmd_kill)

    rc = sub.add_parser(
        "recover",
        help="restart a crashed coordinator from its session journal and "
             "re-adopt the surviving executors (blocks until the job "
             "finishes)")
    rc.add_argument("app_id")
    rc.add_argument("--workdir", help="client workdir the job was "
                                      "submitted from (default ~/.tony-tpu)")
    rc.add_argument("--history-root",
                    help="override tony.history.location from the frozen "
                         "config")
    rc.set_defaults(fn=_cmd_recover)

    rz = sub.add_parser(
        "resize",
        help="elastically resize a running job's gang — shrink drains "
             "and re-meshes without restarting (no burned epochs), grow "
             "re-admits members live (tony.elastic.* keys)")
    rz.add_argument("app_id")
    rz.add_argument("size", type=int, help="new gang size")
    rz.add_argument("--job", default="",
                    help="jobtype to resize (default: the configured "
                         "tony.elastic.jobtype)")
    rz.add_argument("--workdir", help="client workdir the job was "
                                      "submitted from (default ~/.tony-tpu)")
    rz.set_defaults(fn=_cmd_resize)

    mg = sub.add_parser(
        "migrate",
        help="live-migrate a running job's gang to another slice: "
             "fenced drain at a step barrier, final durable saves, "
             "relaunch/adopt on the target, restore with reshard — "
             "steps_lost==0 spot survival and defrag "
             "(tony.elastic.* keys)")
    mg.add_argument("app_id")
    mg.add_argument("target",
                    help="destination node pool / slice name, e.g. "
                         "slice-1")
    mg.add_argument("--job", default="",
                    help="jobtype to migrate (default: the configured "
                         "tony.elastic.jobtype)")
    mg.add_argument("--workdir", help="client workdir the job was "
                                      "submitted from (default ~/.tony-tpu)")
    mg.set_defaults(fn=_cmd_migrate)

    st = sub.add_parser("status",
                        help="live report for a running job (falls back "
                             "to history for finished ones)")
    st.add_argument("app_id")
    st.add_argument("--workdir", help="client workdir the job was "
                                      "submitted from")
    st.add_argument("--history-root")
    st.set_defaults(fn=_cmd_status)

    tr = sub.add_parser(
        "trace",
        help="export a job's control-plane trace as Chrome/Perfetto "
             "trace_events JSON (submit → rendezvous → first step → "
             "teardown, one stitched tree)")
    tr.add_argument("app_id")
    tr.add_argument("--history-root")
    tr.add_argument("--out", help="write JSON here instead of stdout")
    tr.add_argument("--cold-start", action="store_true",
                    help="print the per-phase submit→first-step "
                         "breakdown (stage/provision/spawn/register/"
                         "launch/user_boot) instead of the full trace")
    tr.set_defaults(fn=_cmd_trace)

    dg = sub.add_parser(
        "diagnose",
        help="why did my job die: verdict category, blamed task, "
             "evidence, traceback/stack-dump excerpts, causal timeline "
             "(post-hoc on history; live jobs get a provisional read)")
    dg.add_argument("app_id")
    dg.add_argument("--history-root")
    dg.add_argument("--json", action="store_true",
                    help="print the raw incident.json document")
    dg.add_argument("--fresh", action="store_true",
                    help="re-run the rule engine even when the "
                         "coordinator already wrote incident.json")
    dg.set_defaults(fn=_cmd_diagnose)

    h = sub.add_parser("history", help="list finished jobs")
    h.add_argument("--history-root")
    h.set_defaults(fn=_cmd_history)

    e = sub.add_parser("events", help="dump a job's event stream")
    e.add_argument("app_id")
    e.add_argument("--history-root")
    e.set_defaults(fn=_cmd_events)

    lg = sub.add_parser("logs",
                        help="dump a job's per-task logs (yarn logs "
                             "analogue)")
    lg.add_argument("app_id")
    lg.add_argument("--task", help="only this task, e.g. worker:0")
    lg.add_argument("--history-root")
    lg.set_defaults(fn=_cmd_logs)

    pl = sub.add_parser(
        "pool",
        help="warm executor pool: keep pre-spawned executors (python + "
             "tony_tpu_torch + torch imported) that submits adopt "
             "(tony.pool.* keys)")
    pl.add_argument("action", choices=("start", "stop", "status"))
    pl.add_argument("--dir", help="pool directory (default: "
                                  "<workdir>/pool)")
    pl.add_argument("--workdir")
    pl.add_argument("--size", type=int, default=None,
                    help="warm executors to keep ready "
                         "(default: tony.pool.size)")
    pl.add_argument("--preload", default=None,
                    help="modules to pre-import per worker "
                         "(default: tony.pool.preload)")
    pl.add_argument("--conf-file")
    pl.add_argument("--conf", action="append", metavar="K=V")
    pl.set_defaults(fn=_cmd_pool)

    ln = sub.add_parser(
        "lint",
        help="run tonylint, the project invariant checker: conf-key / "
             "fault-site / event-type / rpc-parity registries plus the "
             "durable-write, clock, span, thread and lock disciplines. "
             "Exits nonzero on findings.")
    ln.add_argument("--json", action="store_true",
                    help="emit findings as JSON")
    ln.add_argument("--rule", action="append", metavar="RULE",
                    help="run only this rule id (repeatable)")
    ln.add_argument("--root", default=None,
                    help="repo root to lint (default: this install)")
    ln.add_argument("--list", dest="list_rules", action="store_true",
                    help="list rule ids and exit")
    ln.set_defaults(fn=_cmd_lint)

    ck = sub.add_parser(
        "check",
        help="verify a finished job's artifacts against the "
             "control-plane protocol invariants: journal gen/mgen "
             "monotonicity, resize pairing, epoch fences, terminal-"
             "state discipline, span-tree closure, phase sums, and the "
             "metrics registry. Run it BEFORE diagnose: a protocol "
             "violation means the artifacts themselves may be lying. "
             "Exits nonzero on violations.")
    ck.add_argument("target",
                    help="an app id (resolved under the history root) "
                         "or a job-dir path")
    ck.add_argument("--history-root")
    ck.add_argument("--json", action="store_true",
                    help="emit the report as JSON")
    ck.set_defaults(fn=_cmd_check)

    return p


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)
    from tony_tpu_torch.conf.config import ConfigError

    try:
        return args.fn(args)
    except (ConfigError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
