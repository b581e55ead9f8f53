"""CLI: submit and inspect jobs.

Reference model: ``tony-cli`` — ``ClusterSubmitter`` (stage + delegate to the
client with a kill-on-exit hook, :49-74), ``LocalSubmitter`` (zero-install
demo against an in-process cluster, :47-68). The history subcommand covers
the portal's jobs-index view for terminals (``tony-portal/conf/routes:1``).

The port's CLI has every verb of the reference's: the job path
(``submit``, ``kill``, ``status``, ``recover``, ``history``, ``events``,
``logs``, ``trace``, ``diagnose``), ``resize`` and ``migrate`` (a running
elastic job's gang), the observers of a live job (``top``, ``profile``
with ``torch.profiler`` writing a Chrome trace, ``alerts``), ``portal``,
``notebook``, ``bench diff``, ``pool`` (the warm executor pool,
``tony_tpu_torch/pool.py``), ``fleet`` (the multi-job scheduler,
``tony_tpu_torch/fleet/``) with all its verbs, ``gcloud-gc`` (the reaper of
leaked tony-managed Cloud TPU nodes), ``chaos`` (``tony_tpu_torch/chaos/``)
and the gates ``check`` (a finished job's or a fleet dir's artifacts
against the protocol invariants) and ``lint`` (tonylint over
``tony_tpu_torch/``).

Usage:
    python -m tony_tpu_torch.cli submit --conf-file job.yaml [--conf k=v ...]
    python -m tony_tpu_torch.cli submit --executable train.py --instances 2
    python -m tony_tpu_torch.cli history [--history-root DIR]
    python -m tony_tpu_torch.cli events <app_id>
    python -m tony_tpu_torch.cli pool start --size 1 [--dir DIR]
    python -m tony_tpu_torch.cli fleet start --slices 2 --hosts-per-slice 1
    python -m tony_tpu_torch.cli fleet submit --tenant t --hosts 1 --conf ...
    python -m tony_tpu_torch.cli migrate <app_id> slice-1
    python -m tony_tpu_torch.cli check <app_id|job_dir> [--json]
    python -m tony_tpu_torch.cli lint [--json] [--rule RULE]
    python -m tony_tpu_torch.cli top <app_id> --once
    python -m tony_tpu_torch.cli profile <app_id> --steps 3
    python -m tony_tpu_torch.cli alerts <app_id>
    python -m tony_tpu_torch.cli portal [--history-root DIR] [--port N]
    python -m tony_tpu_torch.cli chaos run --seed 17 --schedules 4 --suite e2e
    python -m tony_tpu_torch.cli notebook [--command CMD]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys
import time
from typing import List, Optional

from tony_tpu_torch import faults as _faults
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


def _cmd_notebook(args: argparse.Namespace) -> int:
    from tony_tpu_torch.conf.config import TonyTpuConfig
    from tony_tpu_torch.notebook import submit_notebook

    conf = TonyTpuConfig.from_layers(config_file=args.conf_file,
                                     overrides=tuple(args.conf or []))
    return submit_notebook(conf, workdir=args.workdir,
                           command=args.command or "",
                           local_port=args.port)


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
    print(f"watch it land with `python -m tony_tpu_torch.cli top "
          f"{args.app_id}` (gang=/mgen= columns) or `python -m "
          f"tony_tpu_torch.cli events {args.app_id}` (GANG_RESIZED)")
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
          f"{args.app_id}` (GANG_MIGRATED) or `python -m "
          f"tony_tpu_torch.cli top {args.app_id}` (mgen= column)")
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


def _cmd_profile(args: argparse.Namespace) -> int:
    """On-demand device capture from a RUNNING job: sends a PROFILE
    directive (riding the heartbeat response) to the chosen task, which
    arms torch.profiler at its next step boundary for N steps; polls
    until the Chrome trace (trace.json) lands in the job dir (portal /profile/<app> lists it).
    A failed/unsupported capture reports PROFILE_FAILED and the job
    keeps training — this command can never hurt a live job."""
    rpc = _coordinator_rpc(args.app_id, args.workdir)
    if rpc is None:
        print(f"no coordinator address for {args.app_id} under "
              f"{_default_workdir(args.workdir)} (job finished? wrong "
              f"--workdir?) — on-demand profiling needs a live job",
              file=sys.stderr)
        return 1
    try:
        res = rpc.call("profile.start", steps=args.steps,
                       task=args.task or "")
        if not isinstance(res, dict) or not res.get("ok"):
            msg = res.get("message", "refused") \
                if isinstance(res, dict) else str(res)
            print(f"profile refused: {msg}", file=sys.stderr)
            return 1
        req_id = res["id"]
        print(f"profiling {res['task']} for {res['steps']} step(s) "
              f"(request {req_id}) — waiting for the capture...")
        deadline = time.monotonic() + args.timeout
        while time.monotonic() < deadline:
            st = rpc.call("profile.status")
            req = next((r for r in st.get("requests", [])
                        if r.get("id") == req_id), None)
            if req and req.get("status") == "captured":
                print(f"captured: {req['dir']}")
                print("open its trace.json in Perfetto or "
                      "chrome://tracing; the portal lists it at "
                      f"/profile/{args.app_id}")
                return 0
            if req and req.get("status") == "failed":
                print(f"capture FAILED: {req.get('error', '?')} "
                      f"(the job keeps training)", file=sys.stderr)
                return 1
            time.sleep(args.interval)
        print(f"capture still pending after {args.timeout:.0f}s (is the "
              f"task stepping? check `python -m tony_tpu_torch.cli top "
              f"{args.app_id}`)",
              file=sys.stderr)
        return 1
    except Exception as e:  # noqa: BLE001
        print(f"profile failed (coordinator gone?): {e}", file=sys.stderr)
        return 1
    finally:
        rpc.close()


def _cmd_bench(args: argparse.Namespace) -> int:
    """`tony-tpu bench diff <base.json> <candidate.json>` — the bench
    regression gate (tony_tpu_torch/profiling/benchdiff.py): nonzero exit when
    the candidate regresses any comparable metric (headline throughput,
    cold-start phases, step phases) past the tolerance."""
    from tony_tpu_torch.profiling import benchdiff

    argv = [args.base, args.candidate, "--tolerance",
            str(args.tolerance)]
    if args.json:
        argv.append("--json")
    return benchdiff.main(argv)


_SPARK_BLOCKS = "▁▂▃▄▅▆▇█"


def _sparkline(values) -> str:
    vals = [max(0.0, float(v)) for v in values][-24:]
    if not vals:
        return ""
    hi = max(vals) or 1.0
    return "".join(_SPARK_BLOCKS[min(7, int(7 * v / hi))] for v in vals)


def _fmt_bytes(n) -> str:
    if n is None:
        return "-"
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if n < 1024 or unit == "TiB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024
    return "?"


#: phase → bar glyph, in canonical draw order (tony_tpu_torch/profiling/):
#: d=data_wait h=h2d C=step_compute m=comms k=ckpt_stall e=eval ·=other
_PHASE_GLYPHS = (("data_wait", "d"), ("h2d", "h"), ("step_compute", "C"),
                 ("comms", "m"), ("ckpt_stall", "k"), ("eval", "e"),
                 ("other", "·"))


def _phase_bar(fractions: dict, width: int = 12) -> str:
    """Proportional per-phase bar for a top row: 'dddCCCCCCCC·' means
    ~25% input wait, ~67% compute, ~8% unattributed."""
    if not fractions:
        return ""
    out = []
    for name, glyph in _PHASE_GLYPHS:
        try:
            n = int(round(float(fractions.get(name, 0.0)) * width))
        except (TypeError, ValueError):
            n = 0
        out.append(glyph * n)
    return "".join(out)[:width + 2]


#: coordinator phase → bar glyph (coordinator/coordphases.py order):
#: J=journal_fsync b=beacon_fold h=hb_scan r=rpc_serve z=rendezvous
#: p=prom_export ·=idle/other
_COORD_PHASE_GLYPHS = (("journal_fsync", "J"), ("beacon_fold", "b"),
                       ("hb_scan", "h"), ("rpc_serve", "r"),
                       ("rendezvous_barrier", "z"), ("prom_export", "p"),
                       ("idle", "·"), ("other", "·"))


def _coord_phase_bar(fractions: dict, width: int = 16) -> str:
    """Proportional control-plane phase bar for the top coord row:
    'JJJr············' means ~19% journal fsync, ~6% rpc, rest idle."""
    if not fractions:
        return ""
    out = []
    for name, glyph in _COORD_PHASE_GLYPHS:
        try:
            n = int(round(float(fractions.get(name, 0.0)) * width))
        except (TypeError, ValueError):
            n = 0
        out.append(glyph * n)
    return "".join(out)[:width + 2]


def _render_top(snap: dict) -> str:
    """One frame of the `tony-tpu top` live view from a metrics.live
    snapshot: per-task utilization + heartbeat age + a steps/s sparkline
    (the coordinator's ring-buffer series) + the per-phase step-time
    attribution bar and the live bottleneck verdict."""
    gang = snap.get("gang_size") or {}
    gang_col = "  gang=" + ",".join(
        f"{j}×{n}" for j, n in sorted(gang.items())) if gang else ""
    el = snap.get("elastic") or {}
    mgen_col = f"  mgen={el.get('mgen')}" if el else ""
    if el.get("resizing"):
        mgen_col += f" (resizing->{el.get('target_size', '?')})"
    lines = [f"{snap.get('app_id', '?')}  status={snap.get('status', '?')}"
             f"  epoch={snap.get('session_id', '?')}"
             f"  generation={snap.get('generation', '?')}"
             f"{gang_col}{mgen_col}"]
    perf = snap.get("perf") or {}
    if perf.get("verdict"):
        lines.append(f"perf: {perf['verdict']} — {perf.get('summary', '')}")
    al = snap.get("alerts") or {}
    if al.get("degraded"):
        lines.append("alerts: DEGRADED — evaluation disabled after a "
                     "fault")
    for r in al.get("firing") or []:
        lines.append(f"ALERT [{r.get('severity', '?')}] "
                     f"{r.get('rule', '?')} value={r.get('value')}"
                     + (f" — {r['summary']}" if r.get("summary")
                        else ""))
    coord = snap.get("coord") or {}
    if coord:
        # Control-plane self row: is the COORDINATOR keeping up — tick
        # duration, beat/journal throughput, fsync p99 — visible during
        # an incident, not just in post-hoc metrics.
        tick = coord.get("tick_s")
        p99 = coord.get("journal_fsync_p99_s")
        line = (f"coord: tick="
                f"{(f'{tick * 1e3:.1f}ms' if tick is not None else '-')}"
                f"  beats/s={coord.get('beats_per_s', '-')}"
                f"  journal/s={coord.get('journal_records_per_s', '-')}"
                f"  fsync p99="
                f"{(f'{p99 * 1e3:.1f}ms' if p99 is not None else '-')}"
                f"  reg={coord.get('registered_tasks', '-')}")
        bar = _coord_phase_bar(coord.get("phases") or {})
        if bar:
            line += f"  [{bar}]"
        lines.append(line)
        if coord.get("verdict") and coord["verdict"] != "COORD_HEALTHY":
            lines.append(f"coord verdict: {coord['verdict']} — "
                         f"{coord.get('summary', '')}")
    lines.append(
        f"{'TASK':<14}{'STATUS':<11}{'STEPS':>8}{'STEPS/S':>9}"
        f"{'MFU':>7}{'HBM':>10}{'RSS':>10}{'HB AGE':>8}  "
        f"{'STATE':<11}{'PHASES':<14}TREND")
    for t in snap.get("tasks", []):
        steps = t.get("steps")
        rate = t.get("steps_per_sec")
        mfu = t.get("mfu")
        hb = t.get("heartbeat_age_s")
        lines.append(
            f"{t.get('task', '?'):<14}{t.get('status', '?'):<11}"
            f"{(f'{steps:g}' if steps is not None else '-'):>8}"
            f"{(f'{rate:.2f}' if rate is not None else '-'):>9}"
            f"{(f'{mfu:.3f}' if mfu is not None else '-'):>7}"
            f"{_fmt_bytes(t.get('hbm_bytes')):>10}"
            f"{_fmt_bytes(t.get('rss_bytes')):>10}"
            f"{(f'{hb:.1f}s' if hb is not None else '-'):>8}  "
            f"{t.get('state', '') or '-':<11}"
            f"{_phase_bar(t.get('phases') or {}) or '-':<14}"
            f"{_sparkline(t.get('steps_per_sec_history', []))}")
    return "\n".join(lines)


def _cmd_top(args: argparse.Namespace) -> int:
    """Live utilization view for a RUNNING job (the `top` for a gang):
    polls the coordinator's metrics.live RPC — the same registry behind
    the portal's /metrics exposition — and redraws in place. --once
    prints a single snapshot (scripts, tests)."""
    rpc = _coordinator_rpc(args.app_id, args.workdir)
    if rpc is None:
        print(f"no coordinator address for {args.app_id} under "
              f"{_default_workdir(args.workdir)} (job finished? wrong "
              f"--workdir?) — `tony-tpu metrics` views need a live job",
              file=sys.stderr)
        return 1
    try:
        while True:
            try:
                snap = rpc.call("metrics.live")
            except Exception as e:  # noqa: BLE001
                print(f"coordinator unreachable: {e}", file=sys.stderr)
                return 1
            frame = _render_top(snap)
            if args.once:
                print(frame)
                return 0
            # Clear + home, then one frame: flicker-free enough without
            # curses, and plain pipes just see frames separated by FF.
            print("\x1b[2J\x1b[H" + frame
                  if sys.stdout.isatty() else frame, flush=True)
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def _cmd_trace(args: argparse.Namespace) -> int:
    """Export a job's span log as Chrome/Perfetto trace_events JSON
    (load at https://ui.perfetto.dev or chrome://tracing). The span log
    lives in the job's history dir next to the jhist stream; works on
    running AND finished jobs."""
    from tony_tpu_torch import constants, tracing
    from tony_tpu_torch.events import history

    if args.fleet:
        return _trace_fleet(args)
    if not args.app_id:
        print("trace needs an app_id (or --fleet <fleet_dir>)",
              file=sys.stderr)
        return 2
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


def _trace_fleet(args: argparse.Namespace) -> int:
    """`tony-tpu trace --fleet <fleet_dir>`: merge the fleet daemon's
    own span log (queue spans, fleet.job lifetimes, preempt/restore
    instants) with EVERY job's span log under the fleet's history root
    — all sharing the fleet trace id the grants injected — into one
    Perfetto export of the whole pool."""
    from tony_tpu_torch import constants, tracing
    from tony_tpu_torch.fleet import ledger as fledger

    fleet_dir = os.path.abspath(os.path.expanduser(args.fleet))
    fleet_trace_path = os.path.join(fleet_dir, constants.TRACE_FILE)
    if not os.path.exists(fleet_trace_path):
        print(f"no fleet span log at {fleet_trace_path} — not a fleet "
              f"dir, or the daemon predates fleet tracing",
              file=sys.stderr)
        return 1
    records = tracing.load_records(fleet_trace_path)
    n_jobs = 0
    for app_id, job_dir in sorted(
            fledger.job_history_dirs(fleet_dir).items()):
        path = os.path.join(job_dir, constants.TRACE_FILE)
        if not os.path.exists(path):
            continue
        job_records = tracing.load_records(path)
        # Prefix the task track with the app id so 40 jobs' worker:0
        # rows stay distinguishable on the merged timeline.
        for rec in job_records:
            if rec.get("task"):
                rec["task"] = f"{app_id}/{rec['task']}"
            elif rec.get("svc") in ("client", "coordinator"):
                rec["task"] = app_id
        records.extend(job_records)
        n_jobs += 1
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
    print(f"fleet trace {payload.get('traceId', '?')}: {n_jobs} "
          f"job(s), {n_spans} spans, {len(unclosed)} unclosed"
          + (f" ({', '.join(unclosed[:8])})" if unclosed else ""),
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


def _render_alert_rows(res: dict) -> str:
    """Shared `alerts` table for job and fleet scope: one row per rule
    with its state-machine position, plus firing summaries."""
    lines = []
    if res.get("degraded"):
        lines.append("alerting: DEGRADED — evaluation disabled after a "
                     "fault (restart the evaluator to re-arm)")
    rows = res.get("alerts") or []
    if not rows:
        lines.append("no alert rules evaluated")
        return "\n".join(lines)
    lines.append(f"{'RULE':<22}{'STATE':<9}{'SEV':<6}{'VALUE':>10}  "
                 f"{'FOR':>7}  SERIES")
    for r in rows:
        v = r.get("value")
        since = r.get("since_s")
        lines.append(
            f"{r.get('rule', '?'):<22}{r.get('state', '?'):<9}"
            f"{r.get('severity', '?'):<6}"
            f"{(f'{v:.4g}' if v is not None else '-'):>10}  "
            f"{(f'{since:.0f}s' if since is not None else '-'):>7}  "
            f"{r.get('series', '')}")
    for r in rows:
        if r.get("state") == "firing" and r.get("summary"):
            lines.append(f"  {r['rule']}: {r['summary']}")
    return "\n".join(lines)


def _cmd_alerts(args: argparse.Namespace) -> int:
    """SLO/alert state for one job: a RUNNING job answers live from its
    coordinator's alert engine (the alerts RPC); otherwise the
    write-ahead REC_ALERT records in the session journal are replayed —
    the firing set survives the coordinator, by design."""
    rpc = _coordinator_rpc(args.app_id, args.workdir)
    if rpc is not None:
        try:
            res = rpc.call("alerts")
            if args.json:
                print(json.dumps(res, indent=1, sort_keys=True))
            else:
                print(_render_alert_rows(res))
            return 0
        except Exception as e:  # noqa: BLE001
            print(f"(coordinator unreachable: {e}; replaying the "
                  f"journal)", file=sys.stderr)
    from tony_tpu_torch import constants
    from tony_tpu_torch.coordinator import journal as cjournal
    from tony_tpu_torch.events import history

    root = _history_root(args)
    job_dir = history.list_job_dirs(root).get(args.app_id)
    if job_dir is None:
        print(f"unknown application {args.app_id} under {root}",
              file=sys.stderr)
        return 1
    path = os.path.join(job_dir, constants.JOURNAL_FILE)
    if not os.path.exists(path):
        print(f"no session journal at {path} — the job ran without "
              f"tony.coordinator.journal-enabled, so no alert "
              f"transitions were recorded", file=sys.stderr)
        return 1
    st = cjournal.replay(path)
    doc = {"app_id": args.app_id, "scope": "job", "offline": True,
           "alerts": [{"rule": rule, "state": state}
                      for rule, state in sorted(st.alerts.items())]}
    if args.json:
        print(json.dumps(doc, indent=1, sort_keys=True))
        return 0
    if not st.alerts:
        print("no alert transitions journaled")
        return 0
    print("journal replay (final state per rule):")
    for rule, state in sorted(st.alerts.items()):
        print(f"  {rule:<22}{state}")
    return 0


def _cmd_portal(args: argparse.Namespace) -> int:
    """Serve the history portal (shortcut for python -m tony_tpu_torch.portal).
    The CLI defaults to binding localhost: serving job history + raw task
    logs to every interface is an explicit choice (--host 0.0.0.0), and
    without a token it should stay local."""
    from tony_tpu_torch.portal.server import main as portal_main

    argv = ["--history-root", _history_root(args), "--host", args.host]
    if args.port is not None:
        argv += ["--port", str(args.port)]
    if args.token:
        argv += ["--token", args.token]
    return portal_main(argv)


def _cmd_gcloud_gc(args: argparse.Namespace) -> int:
    """Janitor for leaked tony-managed TPU nodes. The provisioner deletes
    its node on release and on failed acquires, but a HARD-crashed
    coordinator (SIGKILL, power loss) can strand a billing node — the
    reference relied on YARN's ResourceManager to reap containers; with
    no RM, this command is the operator's reaper. Lists nodes carrying
    the ``tony-managed`` label (and matching --prefix); --delete deletes
    them. NEVER touches unlabeled nodes."""
    from tony_tpu_torch.cluster.gcloud import TpuApiClient

    api = TpuApiClient(project=args.project, zone=args.zone,
                       endpoint=args.api_endpoint or None)

    def _rid(res: dict) -> str:
        return res.get("name", "").rsplit("/", 1)[-1]

    def _qr_is_managed(qr: dict) -> bool:
        for spec in (qr.get("tpu") or {}).get("nodeSpec") or []:
            labels = (spec.get("node") or {}).get("labels") or {}
            if labels.get("tony-managed") == "true":
                return True
        return False

    # Queued resources FIRST: a coordinator that died while its request
    # was WAITING leaked something with no node yet — and a granted QR's
    # node can only be deleted through its QR (the API rejects
    # nodes.delete on queued-resource-created nodes).
    all_qrs = api.list_queued_resources()
    managed_qrs = [q for q in all_qrs
                   if _qr_is_managed(q) and _rid(q).startswith(args.prefix)]
    qr_ids = {_rid(q) for q in managed_qrs}
    live_qr_ids = {_rid(q) for q in all_qrs}
    qr_node_names = {
        spec.get("nodeId", "")
        for q in managed_qrs
        for spec in (q.get("tpu") or {}).get("nodeSpec") or []}
    candidates = [
        n for n in api.list_nodes()
        if (n.get("labels", {}).get("tony-managed") == "true"
            and _rid(n).startswith(args.prefix)
            # nodes a managed QR will reap (or that name their QR) are
            # handled on the QR side
            and _rid(n) not in qr_node_names)]
    managed_nodes = [n for n in candidates if not n.get("queuedResource")]
    # Leak shape the two lists above miss: a QR-created node whose QR no
    # longer exists (externally deleted QR, partial force-delete). It has
    # a queuedResource reference, so the node path skipped it; its QR is
    # not in the live set, so the QR path never reaps it. These can only
    # be deleted via their (stale) QR name — and when that 404s, via a
    # last-resort nodes.delete.
    stale_qr_nodes = [
        (n, n["queuedResource"].rsplit("/", 1)[-1]) for n in candidates
        if n.get("queuedResource")
        and n["queuedResource"].rsplit("/", 1)[-1] not in live_qr_ids]
    if not managed_qrs and not managed_nodes and not stale_qr_nodes:
        print("no tony-managed nodes or queued resources found")
        return 0
    for q in managed_qrs:
        print(f"{_rid(q)}\tqueued-resource "
              f"{(q.get('state') or {}).get('state', '?')}")
    for n in managed_nodes:
        print(f"{_rid(n)}\tnode {n.get('state', '?')}\t"
              f"{n.get('acceleratorType', '?')}")
    for n, stale_qr in stale_qr_nodes:
        print(f"{_rid(n)}\tnode {n.get('state', '?')}\t"
              f"{n.get('acceleratorType', '?')}\t"
              f"(stale queued-resource {stale_qr})")
    if not args.delete:
        print(f"{len(managed_qrs)} queued resource(s) + "
              f"{len(managed_nodes) + len(stale_qr_nodes)} node(s); "
              f"re-run with --delete to "
              f"remove them (make sure no tony-tpu job is running "
              f"against them!)")
        return 0
    # The filter cannot tell a LEAKED resource from one a live
    # coordinator holds — repeat the warning where it matters, on the
    # destructive path.
    print("deleting — make sure no tony-tpu job is running against "
          "these resources!", file=sys.stderr)
    # Deletes are independent long-running ops: issue them ALL first,
    # then poll — N stranded resources cost one op latency, not N.
    failures = 0
    pending = []
    for qr_id in sorted(qr_ids):
        try:
            pending.append((qr_id,
                            api.delete_queued_resource(qr_id, force=True)))
        except FileNotFoundError:
            print(f"{qr_id} already gone")
        except Exception as e:  # noqa: BLE001
            failures += 1
            print(f"failed to delete {qr_id}: {e}", file=sys.stderr)
    for n in managed_nodes:
        node_id = _rid(n)
        try:
            pending.append((node_id, api.delete_node(node_id)))
        except FileNotFoundError:
            print(f"{node_id} already gone")
        except Exception as e:  # noqa: BLE001
            failures += 1
            print(f"failed to delete {node_id}: {e}", file=sys.stderr)
    for n, stale_qr in stale_qr_nodes:
        node_id = _rid(n)
        try:
            # QR-created nodes must be deleted through their QR; the stale
            # name may still resolve server-side (partial force-delete).
            pending.append((node_id,
                            api.delete_queued_resource(stale_qr,
                                                       force=True)))
        except FileNotFoundError:
            # The QR really is gone — last resort, try the node directly
            # (some API surfaces allow it once the QR record vanished).
            try:
                pending.append((node_id, api.delete_node(node_id)))
            except FileNotFoundError:
                print(f"{node_id} already gone")
            except Exception as e:  # noqa: BLE001
                failures += 1
                print(f"failed to delete {node_id} (stale qr {stale_qr}):"
                      f" {e}", file=sys.stderr)
        except Exception as e:  # noqa: BLE001
            failures += 1
            print(f"failed to delete {node_id} via stale qr {stale_qr}: "
                  f"{e}", file=sys.stderr)
    for rid, op in pending:
        try:
            api.wait_operation(op, timeout_s=300,
                               interval_s=args.poll_interval)
            print(f"deleted {rid}")
        except Exception as e:  # noqa: BLE001
            failures += 1
            print(f"failed to delete {rid}: {e}", file=sys.stderr)
    return 1 if failures else 0


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


def _chaos_workdir(base: str, schedule) -> str:
    return os.path.join(base, "runs", schedule.name)


def _chaos_run_one(schedule, outdir: str, runs_root: str):
    """Execute one schedule, save its artifact, return the outcome."""
    import shutil

    from tony_tpu_torch.chaos import artifact as chaos_artifact
    from tony_tpu_torch.chaos import runner as chaos_runner

    workdir = _chaos_workdir(runs_root, schedule)
    if os.path.isdir(workdir):
        shutil.rmtree(workdir)
    outcome = chaos_runner.run_schedule(schedule, workdir)
    chaos_artifact.save_artifact(outdir, schedule, outcome)
    # a clean run's scratch tree is noise; a failing run's is evidence
    if outcome.ok:
        shutil.rmtree(workdir, ignore_errors=True)
    return outcome


def _cmd_chaos_run(args: argparse.Namespace) -> int:
    """`tony-tpu chaos run` — seeded multi-fault sweep."""
    from tony_tpu_torch.chaos import schedule as chaos_schedule

    seed = int(args.seed)
    outdir = os.path.abspath(args.out)
    runs_root = os.path.join(outdir, "scratch")
    os.environ[_faults.FAULT_SEED_ENV] = str(seed)
    suites = [args.suite] if args.suite else list(chaos_schedule.SUITES)
    failed = 0
    total = 0
    t0 = time.monotonic()
    for index in range(int(args.schedules)):
        suite = suites[index % len(suites)]
        sched = chaos_schedule.plan(seed, index, suite)
        total += 1
        outcome = _chaos_run_one(sched, outdir, runs_root)
        tag = "ok" if outcome.ok else "FAIL"
        sites = ", ".join(i.site for i in sched.injections)
        print(f"{sched.name} [{suite:8s}] {outcome.status:9s} "
              f"{outcome.failure_domain or '-':16s} {tag}  "
              f"({sites or 'no injections'})")
        if not outcome.ok:
            failed += 1
            for v in outcome.violations:
                print(f"    {v.rung}: {v.detail}")
            if args.fail_fast:
                break
    dt = time.monotonic() - t0
    print(f"chaos: {total} schedule(s), {failed} failing, "
          f"{dt:.1f}s (seed {seed})")
    if failed:
        print(f"artifacts + scratch trees under {outdir}; shrink with "
              f"`tony-tpu chaos shrink <artifact>`")
    return 1 if failed else 0


def _cmd_chaos_replay(args: argparse.Namespace) -> int:
    """`tony-tpu chaos replay` — re-run an artifact's schedule and
    prove the planner regenerates it bit-identically."""
    from tony_tpu_torch.chaos import artifact as chaos_artifact
    from tony_tpu_torch.chaos import schedule as chaos_schedule

    doc = chaos_artifact.load_artifact(args.artifact)
    sched = chaos_artifact.schedule_from_doc(doc)
    os.environ[_faults.FAULT_SEED_ENV] = str(sched.seed)
    if not doc.get("shrunk_from"):
        # full schedules must replan bit-identically — THE determinism
        # contract; shrunk ones are subsets the planner never emits
        replanned = chaos_schedule.plan(sched.seed, sched.index,
                                        sched.suite)
        if replanned.as_dict() != sched.as_dict():
            print("REPLAY MISMATCH: the planner no longer regenerates "
                  "this artifact's schedule — planner drift:",
                  file=sys.stderr)
            print(f"  recorded:  {sched.as_dict()}", file=sys.stderr)
            print(f"  replanned: {replanned.as_dict()}", file=sys.stderr)
            return 2
    outdir = os.path.abspath(args.out)
    outcome = _chaos_run_one(sched, outdir, os.path.join(outdir,
                                                         "scratch"))
    recorded = chaos_artifact.outcome_from_doc(doc)
    print(f"{sched.name}: recorded {recorded.status}"
          f"{'/' + recorded.failure_domain if recorded.failure_domain else ''}"
          f" ({'ok' if recorded.ok else 'FAIL'}), replay "
          f"{outcome.status}"
          f"{'/' + outcome.failure_domain if outcome.failure_domain else ''}"
          f" ({'ok' if outcome.ok else 'FAIL'})")
    for v in outcome.violations:
        print(f"    {v.rung}: {v.detail}")
    return 0 if outcome.ok == recorded.ok else 1


def _cmd_chaos_shrink(args: argparse.Namespace) -> int:
    """`tony-tpu chaos shrink` — ddmin a failing artifact to the
    minimal injection set that still violates the ladder."""
    import dataclasses

    from tony_tpu_torch.chaos import artifact as chaos_artifact
    from tony_tpu_torch.chaos import shrink as chaos_shrink

    doc = chaos_artifact.load_artifact(args.artifact)
    sched = chaos_artifact.schedule_from_doc(doc)
    os.environ[_faults.FAULT_SEED_ENV] = str(sched.seed)
    outdir = os.path.abspath(args.out)
    runs_root = os.path.join(outdir, "scratch")
    attempts = [0]

    def _fails(injections) -> bool:
        attempts[0] += 1
        candidate = dataclasses.replace(sched, injections=list(injections))
        outcome = _chaos_run_one(candidate, outdir, runs_root)
        print(f"  shrink run #{attempts[0]}: "
              f"{len(injections)} injection(s) -> "
              f"{'FAIL' if not outcome.ok else 'ok'}")
        return not outcome.ok

    try:
        minimal = chaos_shrink.ddmin(sched.injections, _fails,
                                     max_runs=int(args.max_runs))
    except ValueError as e:
        print(f"error: {e} — is {args.artifact} a FAILING artifact?",
              file=sys.stderr)
        return 2
    shrunk = dataclasses.replace(sched, injections=minimal)
    final = _chaos_run_one(shrunk, outdir, runs_root)
    path = chaos_artifact.save_artifact(
        outdir, shrunk, final,
        shrunk_from={"injections": len(sched.injections),
                     "artifact": os.path.abspath(args.artifact)},
        note=args.note or "")
    print(f"shrunk {len(sched.injections)} -> {len(minimal)} "
          f"injection(s) in {attempts[0]} run(s):")
    for inj in minimal:
        print(f"  {inj.site} = {inj.spec}")
    print(f"minimal repro saved to {path}")
    return 0


def _fleet_dir(args: argparse.Namespace) -> str:
    return os.path.abspath(os.path.expanduser(
        args.dir or str(args.conf_obj.get(K.FLEET_DIR, "") or "")
        or os.path.join(_default_workdir(getattr(args, "workdir", None)),
                        "fleet")))


def _fleet_conf(args: argparse.Namespace):
    from tony_tpu_torch.conf.config import TonyTpuConfig

    return TonyTpuConfig.from_layers(
        config_file=getattr(args, "conf_file", None),
        overrides=tuple(getattr(args, "conf", None) or []))


def _render_fleet_top(snap: dict) -> str:
    """One frame of `tony-tpu fleet top`: pool occupancy, per-tenant
    usage vs quota WITH ledger goodput%, the fleet goodput headline,
    queue depth + wait quantiles, and one row per job — queued jobs
    show their live wait and a `held:` column (the explainer's
    top-line answer; `fleet explain <job>` has the full timeline)."""
    pool = snap.get("pool") or {}
    qw = snap.get("queue_wait") or {}
    lines = [
        f"{snap.get('fleet_dir', '?')}  generation="
        f"{snap.get('generation', '?')}  hosts: {pool.get('used', '?')}/"
        f"{pool.get('total', '?')} used ({pool.get('free', '?')} free, "
        f"{pool.get('slices', '?')}x{pool.get('hosts_per_slice', '?')})"
        f"  queue={snap.get('queue_depth', '?')}"
        f"  wait p50={qw.get('p50_s', 0)}s p99={qw.get('p99_s', 0)}s"]
    ledger = snap.get("ledger") or {}
    fleet_led = ledger.get("fleet") or {}
    if fleet_led.get("goodput_fraction") is not None:
        warm = fleet_led.get("warm_start_fraction")
        lines.append(
            f"goodput: {float(fleet_led['goodput_fraction']):.1%} of "
            f"{fleet_led.get('held_chip_s', 0)} chip-seconds held"
            + (f"  warm starts: {float(warm):.0%}"
               if warm is not None else "")
            + (f"  preempt-lost: "
               f"{fleet_led.get('lost_preempted_chip_s', 0)} chip-s"
               if fleet_led.get("lost_preempted_chip_s") else ""))
    health = snap.get("health") or {}
    if health.get("cordoned") or health.get("sick_slices"):
        lines.append(
            "health: cordoned "
            + (", ".join(health["cordoned"]) or "-")
            + (f"  sick slices: {health['sick_slices']}"
               if health.get("sick_slices") else ""))
    fal = snap.get("alerts") or {}
    if fal.get("degraded"):
        lines.append("alerts: DEGRADED — evaluation disabled after a "
                     "fault")
    for r in fal.get("firing") or []:
        lines.append(f"ALERT [{r.get('severity', '?')}] "
                     f"{r.get('rule', '?')} value={r.get('value')}"
                     + (f" — {r['summary']}" if r.get("summary")
                        else ""))
    tenants = snap.get("tenants") or {}
    if tenants:
        def _tenant_cell(t, row):
            cell = f"{t}={row.get('used', 0)}/{row.get('quota') or '∞'}"
            if row.get("goodput") is not None:
                cell += f" gp={float(row['goodput']):.0%}"
            return cell
        lines.append("tenants: " + "  ".join(
            _tenant_cell(t, row) for t, row in sorted(tenants.items())))
    lines.append(f"{'JOB':<10}{'TENANT':<10}{'PRI':>4} {'STATE':<11}"
                 f"{'HOSTS':>7}  {'WAIT':>7}  {'APP / HELD'}")
    for row in snap.get("jobs", []):
        wait = row.get("wait_s")
        note = row.get("app_id") or ""
        if row.get("state") == "QUEUED":
            note = row.get("held") or row.get("denial") or note
        hosts = f"{row.get('hosts', 0)}/{row.get('hosts_requested', '?')}"
        lines.append(
            f"{row.get('job', '?'):<10}{row.get('tenant', '?'):<10}"
            f"{row.get('priority', 0):>4} {row.get('state', '?'):<11}"
            f"{hosts:>7}  "
            f"{(f'{wait:.1f}s' if wait is not None else '-'):>7}  "
            f"{note}")
    return "\n".join(lines)


def _cmd_fleet(args: argparse.Namespace) -> int:
    """Fleet operations (tony_tpu_torch/fleet/): the persistent multi-job
    gang scheduler. `start` spawns the daemon detached (use --recover
    after a daemon crash to resume the journaled queue), `submit`
    queues a job through it, `top` watches the scheduler live — see
    the Multi-tenancy runbook in docs/operations.md."""
    import subprocess

    from tony_tpu_torch import constants
    from tony_tpu_torch.fleet.client import FleetClient, FleetClientError
    from tony_tpu_torch.utils import proc as procutil

    args.conf_obj = _fleet_conf(args)
    fleet_dir = _fleet_dir(args)
    addr_path = os.path.join(fleet_dir, constants.FLEET_ADDR_FILE)
    if args.fleet_cmd == "start":
        conf = args.conf_obj
        if os.path.exists(addr_path):
            client = FleetClient(fleet_dir)
            try:
                st = client.status()
                print(f"fleet already running under {fleet_dir} "
                      f"(generation {st.get('generation', '?')}, "
                      f"{st.get('queue_depth', '?')} queued)")
                return 0
            except FleetClientError:
                os.unlink(addr_path)   # stale addr from a dead daemon
            finally:
                client.close()
        os.makedirs(fleet_dir, exist_ok=True)
        slices = args.slices if args.slices is not None \
            else conf.get_int(K.FLEET_SLICES, 1)
        hps = args.hosts_per_slice if args.hosts_per_slice is not None \
            else conf.get_int(K.FLEET_HOSTS_PER_SLICE, 8)
        quotas = args.quotas if args.quotas is not None \
            else str(conf.get(K.FLEET_QUOTAS, "") or "")
        pool_dir = args.pool_dir if args.pool_dir is not None \
            else str(conf.get(K.FLEET_POOL_DIR, "") or "")
        tick_s = float(conf.get(K.FLEET_TICK_INTERVAL_S, 0.5) or 0.5)
        ring = conf.get_int(K.FLEET_DECISION_RING, 64)
        ledger_s = float(conf.get(K.FLEET_LEDGER_INTERVAL_S, 5.0)
                         or 5.0)
        cmd = [sys.executable, "-m", "tony_tpu_torch.fleet", "serve",
               "--dir", fleet_dir, "--slices", str(slices),
               "--hosts-per-slice", str(hps), "--tick-s", str(tick_s),
               "--decision-ring", str(ring),
               "--ledger-interval-s", str(ledger_s),
               "--health-enabled",
               str(int(conf.get_bool(K.HEALTH_ENABLED, True))),
               "--health-half-life-s",
               str(float(conf.get(K.HEALTH_HALF_LIFE_S, 300.0) or 300.0)),
               "--health-suspect-threshold",
               str(float(conf.get(K.HEALTH_SUSPECT_THRESHOLD, 1.0)
                         or 1.0)),
               "--health-quarantine-threshold",
               str(float(conf.get(K.HEALTH_QUARANTINE_THRESHOLD, 3.0)
                         or 3.0)),
               "--health-quarantine-s",
               str(float(conf.get(K.HEALTH_QUARANTINE_S, 120.0)
                         or 120.0)),
               "--health-probation-priority",
               str(conf.get_int(K.HEALTH_PROBATION_PRIORITY, 0)),
               "--health-blast-n",
               str(conf.get_int(K.HEALTH_BLAST_N, 2)),
               "--health-blast-window-s",
               str(float(conf.get(K.HEALTH_BLAST_WINDOW_S, 120.0)
                         or 120.0))]
        if quotas:
            cmd += ["--quotas", quotas]
        if pool_dir:
            cmd += ["--pool-dir", pool_dir]
        if args.recover:
            cmd.append("--recover")
        flog = open(os.path.join(fleet_dir, "fleet.log"), "ab")
        proc = subprocess.Popen(cmd, stdout=flog,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        flog.close()

        def read_addr():
            if proc.poll() is not None:
                raise RuntimeError(
                    f"fleet daemon exited with {proc.returncode}; see "
                    f"{os.path.join(fleet_dir, 'fleet.log')}")
            return os.path.exists(addr_path) or None

        if procutil.poll_till_non_null(read_addr, interval_s=0.1,
                                       timeout_s=60) is None:
            print(f"fleet daemon never published its endpoint under "
                  f"{fleet_dir}", file=sys.stderr)
            return 1
        print(f"fleet running under {fleet_dir} ({slices} slice(s) x "
              f"{hps} hosts"
              + (f", quotas {quotas}" if quotas else "")
              + (", recovered" if args.recover else "") + ")")
        print(f"submit with `tony-tpu fleet submit --dir {fleet_dir} "
              f"--tenant <t> --hosts <n> --conf ...`")
        return 0
    if args.fleet_cmd == "diagnose":
        # Offline by design: the verdict must survive the daemon (a
        # dead scheduler is exactly when you want to diagnose the
        # fleet). The daemon's own periodic fleet.incident.json is the
        # live twin; this recomputes fresh from the fleet dir.
        from tony_tpu_torch.fleet import diagnose as fdiagnose
        from tony_tpu_torch.fleet.journal import FleetJournalError

        try:
            doc = fdiagnose.build_incident(
                fdiagnose.bundle_from_dir(fleet_dir))
        except FleetJournalError as e:
            print(f"{e}", file=sys.stderr)
            return 1
        if args.json:
            print(json.dumps(doc, indent=1, sort_keys=True))
        else:
            print(fdiagnose.render_text(doc))
        return 0
    if args.fleet_cmd == "alerts":
        # Dual-path like explain: a live daemon answers from its
        # engine; otherwise the REC_FLEET_ALERT records are replayed.
        from tony_tpu_torch.fleet import journal as fjournal
        from tony_tpu_torch.fleet.journal import FleetJournalError

        client = FleetClient(fleet_dir)
        try:
            res = client.alerts()
        except FleetClientError:
            try:
                st = fjournal.replay(os.path.join(
                    fleet_dir, constants.FLEET_JOURNAL_FILE))
            except FleetJournalError as e:
                print(f"{e}", file=sys.stderr)
                return 1
            res = {"fleet_dir": fleet_dir, "scope": "fleet",
                   "offline": True,
                   "alerts": [{"rule": rule, "state": state}
                              for rule, state
                              in sorted(st.alerts.items())]}
        finally:
            client.close()
        if args.json:
            print(json.dumps(res, indent=1, sort_keys=True))
        elif res.get("offline"):
            if not res["alerts"]:
                print("no fleet alert transitions journaled")
            else:
                print("journal replay (final state per rule):")
                for row in res["alerts"]:
                    print(f"  {row['rule']:<22}{row['state']}")
        else:
            print(_render_alert_rows(res))
        return 0
    if args.fleet_cmd == "whatif":
        # Offline by design, like diagnose: the time machine replays a
        # RECORDED journal — it never needs (or touches) a live daemon.
        from tony_tpu_torch.fleet import simulator as fsim
        from tony_tpu_torch.fleet.journal import FleetJournalError

        try:
            report = fsim.whatif_from_dir(
                fleet_dir, sets=args.set, quotas=args.quota,
                pool=args.pool or None, priorities=args.priority,
                sweeps=args.sweep)
        except FleetJournalError as e:
            print(f"{e}", file=sys.stderr)
            return 1
        except ValueError as e:
            print(f"whatif: {e}", file=sys.stderr)
            return 2
        if args.json:
            print(json.dumps(report, indent=1, sort_keys=True))
        else:
            print(fsim.render_report(report))
        par = report.get("parity") or {}
        if args.expect_parity and not par.get("ok"):
            return 1
        return 0
    if args.fleet_cmd == "explain":
        from tony_tpu_torch.fleet import diagnose as fdiagnose
        from tony_tpu_torch.fleet.journal import FleetJournalError

        client = FleetClient(fleet_dir)
        try:
            res = client.explain(args.job)
        except FleetClientError:
            # No live daemon: replay the journal's decision records —
            # the ring is bounded, the journal is the full history.
            try:
                res = fdiagnose.offline_explain(fleet_dir, args.job)
            except FleetJournalError as e:
                print(f"{e}", file=sys.stderr)
                return 1
        finally:
            client.close()
        if not res.get("ok"):
            print(f"explain refused: {res.get('message', '?')}",
                  file=sys.stderr)
            return 1
        if args.json:
            print(json.dumps(res, indent=1, sort_keys=True))
        else:
            print(fdiagnose.render_explain(res))
        return 0
    client = FleetClient(fleet_dir)
    try:
        if args.fleet_cmd == "stop":
            client.stop()
            print(f"fleet under {fleet_dir} stopping (running jobs are "
                  f"left to their tenants)")
            return 0
        if args.fleet_cmd == "status":
            print(_render_fleet_top(client.status()))
            return 0
        if args.fleet_cmd == "top":
            while True:
                frame = _render_fleet_top(client.status())
                if args.once:
                    print(frame)
                    return 0
                print("\x1b[2J\x1b[H" + frame
                      if sys.stdout.isatty() else frame, flush=True)
                time.sleep(args.interval)
        if args.fleet_cmd == "cancel":
            res = client.cancel(args.job)
            if not res.get("ok"):
                print(f"cancel refused: {res.get('message', '?')}",
                      file=sys.stderr)
                return 1
            print(f"{args.job}: {res.get('state', '?')}")
            return 0
        if args.fleet_cmd == "migrate":
            res = client.migrate(args.job, args.target)
            if not res.get("ok"):
                print(f"migrate refused: {res.get('message', '?')}",
                      file=sys.stderr)
                return 1
            print(f"{args.job}: migrating slice {res.get('source')} -> "
                  f"{res.get('target')} (placement {res.get('placement')})")
            print(f"watch it land with `tony-tpu fleet status` or the "
                  f"job's own `tony-tpu events` stream (GANG_MIGRATED)")
            return 0
        if args.fleet_cmd == "cordon":
            res = client.cordon(args.host, reason=args.reason)
            if not res.get("ok"):
                print(f"cordon refused: {res.get('message', '?')}",
                      file=sys.stderr)
                return 1
            print(f"{args.host}: {res.get('state', '?')}"
                  + ("" if res.get("was_free")
                     else " (leased — placements stop now, the slot "
                          "leaves the pool when its job releases)"))
            return 0
        if args.fleet_cmd == "uncordon":
            res = client.uncordon(args.host)
            if not res.get("ok"):
                print(f"uncordon refused: {res.get('message', '?')}",
                      file=sys.stderr)
                return 1
            print(f"{args.host}: {res.get('state', '?')}")
            return 0
        if args.fleet_cmd == "health":
            res = client.health()
            if not res.get("ok"):
                print(f"health refused: {res.get('message', '?')}",
                      file=sys.stderr)
                return 1
            if args.json:
                print(json.dumps(res, indent=1, sort_keys=True))
                return 0
            if not res.get("enabled"):
                print("host health: DISABLED (tony.health.enabled)")
                return 0
            print("cordoned: "
                  + (", ".join(res.get("cordoned") or []) or "-"))
            if res.get("sick_slices"):
                print(f"sick slices: {res['sick_slices']}")
            for row in res.get("hosts", []):
                ev = "; ".join(
                    str(e.get("kind", "?"))
                    + (f" in {e['job']}" if e.get("job") else "")
                    for e in row.get("evidence", []))
                print(f"  {row.get('host'):<8} {row.get('state'):<12} "
                      f"score {row.get('score', 0):<6} {ev}")
            return 0
        if args.fleet_cmd == "submit":
            # Ship only the EXPLICIT conf entries: registry defaults
            # would shadow the fleet's own grant-time injections
            # (pool dir, elastic knobs are setdefault'd
            # on the daemon side).
            reg = K.registry()
            explicit = {
                k: v for k, v in args.conf_obj.as_dict().items()
                if k not in reg or v != reg[k].default}
            res = client.submit(
                args.tenant, args.hosts, priority=args.priority,
                min_hosts=args.min_hosts, model=args.model,
                conf=explicit)
            if not res.get("ok"):
                print(f"submit refused: {res.get('message', '?')}",
                      file=sys.stderr)
                return 1
            job = res["job"]
            print(f"queued {job} (tenant {args.tenant}, "
                  f"{args.hosts} host(s), priority {args.priority})")
            if not args.follow:
                return 0
            while True:
                row = next((r for r in client.status().get("jobs", [])
                            if r.get("job") == job), None)
                if row and row.get("state") in ("FINISHED", "FAILED",
                                                "CANCELLED"):
                    print(f"{job}: {row['state']}"
                          + (f" (app {row.get('app_id')})"
                             if row.get("app_id") else ""))
                    return 0 if row["state"] == "FINISHED" else 1
                time.sleep(1.0)
    except FleetClientError as e:
        print(f"{e}", file=sys.stderr)
        return 1
    except KeyboardInterrupt:
        return 0
    finally:
        client.close()
    return 1

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

    n = sub.add_parser(
        "notebook",
        help="run a notebook server as a single-node job and tunnel a "
             "local port to it (reference NotebookSubmitter)")
    n.add_argument("--conf-file", help="job config (json/yaml)")
    n.add_argument("--conf", action="append", metavar="K=V",
                   help="config override (repeatable)")
    n.add_argument("--command",
                   help="server command; $TB_PORT is the port to bind "
                        "(default: jupyter notebook)")
    n.add_argument("--port", type=int, default=0,
                   help="local proxy port (default: auto)")
    n.add_argument("--workdir", help="client workdir (default ~/.tony-tpu)")
    n.set_defaults(fn=_cmd_notebook)

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

    tp = sub.add_parser(
        "top",
        help="live per-task utilization view for a running job "
             "(steps/s, MFU, HBM, RSS, heartbeat age — the gang's `top`)")
    tp.add_argument("app_id")
    tp.add_argument("--workdir", help="client workdir the job was "
                                      "submitted from (default ~/.tony-tpu)")
    tp.add_argument("--interval", type=float, default=2.0,
                    help="refresh cadence in seconds (default 2)")
    tp.add_argument("--once", action="store_true",
                    help="print one snapshot and exit (scripts/tests)")
    tp.set_defaults(fn=_cmd_top)

    pf = sub.add_parser(
        "profile",
        help="capture a device trace from a RUNNING job without "
             "restarting it: the target task arms torch.profiler at its "
             "next step boundary for N steps; a Chrome trace (Perfetto) "
             "lands under the job dir (portal /profile/<app>)")
    pf.add_argument("app_id")
    pf.add_argument("--steps", type=int, default=0,
                    help="steps to capture (default: "
                         "tony.profile.default-steps)")
    pf.add_argument("--task", default="",
                    help="task to profile, e.g. worker:1 (default: the "
                         "chief)")
    pf.add_argument("--workdir", help="client workdir the job was "
                                      "submitted from (default ~/.tony-tpu)")
    pf.add_argument("--timeout", type=float, default=120.0,
                    help="seconds to wait for the capture (default 120)")
    pf.add_argument("--interval", type=float, default=1.0,
                    help="status poll cadence in seconds")
    pf.set_defaults(fn=_cmd_profile)

    bn = sub.add_parser(
        "bench",
        help="bench utilities: `bench diff <base.json> <candidate.json>` "
             "compares headline + per-phase numbers with a tolerance and "
             "exits nonzero on regression (the BENCH_r* gate)")
    bn_sub = bn.add_subparsers(dest="bench_cmd", required=True)
    bd = bn_sub.add_parser("diff", help="compare two bench jsons")
    bd.add_argument("base")
    bd.add_argument("candidate")
    bd.add_argument("--tolerance", type=float, default=0.10)
    bd.add_argument("--json", action="store_true")
    bd.set_defaults(fn=_cmd_bench)

    tr = sub.add_parser(
        "trace",
        help="export a job's control-plane trace as Chrome/Perfetto "
             "trace_events JSON (submit → rendezvous → first step → "
             "teardown, one stitched tree); --fleet <fleet_dir> "
             "exports the WHOLE pool — queue spans, grants, every "
             "job's lifecycle, preempt/grow-back resizes — on one "
             "timeline under the shared fleet trace id")
    tr.add_argument("app_id", nargs="?", default="",
                    help="application id (omit with --fleet)")
    tr.add_argument("--fleet", metavar="FLEET_DIR", default="",
                    help="export a fleet dir's stitched pool-wide "
                         "trace instead of one job's")
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

    al = sub.add_parser(
        "alerts",
        help="SLO/alert state for a job: live rule-engine rows from a "
             "running coordinator, or the journaled REC_ALERT "
             "transitions replayed for a finished/dead one")
    al.add_argument("app_id")
    al.add_argument("--workdir", help="client workdir the job was "
                                      "submitted from (default ~/.tony-tpu)")
    al.add_argument("--history-root")
    al.add_argument("--json", action="store_true")
    al.set_defaults(fn=_cmd_alerts)

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

    po = sub.add_parser("portal", help="serve the history web portal")
    po.add_argument("--history-root")
    po.add_argument("--port", type=int, default=None)
    po.add_argument("--host", default="127.0.0.1",
                    help="bind address (default localhost; widen only "
                         "with --token set)")
    po.add_argument("--token", default=os.environ.get(
        "TONY_PORTAL_TOKEN", ""))
    po.set_defaults(fn=_cmd_portal)

    gc = sub.add_parser(
        "gcloud-gc",
        help="list/delete leaked tony-managed TPU nodes (the RM-reaper "
             "role for hard-crashed coordinators)")
    gc.add_argument("--project", required=True)
    gc.add_argument("--zone", required=True)
    gc.add_argument("--prefix", default="tony",
                    help="only nodes whose id starts with this "
                         "(tony.gcloud.node-prefix)")
    gc.add_argument("--delete", action="store_true",
                    help="actually delete (default: list only)")
    gc.add_argument("--api-endpoint", default="",
                    help="Cloud TPU API endpoint override (tests)")
    gc.add_argument("--poll-interval", type=float, default=5.0,
                    help="delete-operation poll cadence in seconds")
    gc.set_defaults(fn=_cmd_gcloud_gc)

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

    fl = sub.add_parser(
        "fleet",
        help="persistent multi-job gang scheduler over a shared slice "
             "pool: priorities, per-tenant quotas, bin-packing, "
             "preempt-to-reclaim via elastic shrink (tony.fleet.* keys; "
             "docs/operations.md Multi-tenancy)")
    fl_sub = fl.add_subparsers(dest="fleet_cmd", required=True)
    fs = fl_sub.add_parser("start", help="spawn the fleet daemon "
                                         "detached and wait for its "
                                         "endpoint")
    fs.add_argument("--dir", help="fleet state dir (default: "
                                  "<workdir>/fleet)")
    fs.add_argument("--workdir")
    fs.add_argument("--slices", type=int, default=None,
                    help="pool slices (default: tony.fleet.slices)")
    fs.add_argument("--hosts-per-slice", type=int, default=None,
                    help="hosts per slice (default: "
                         "tony.fleet.hosts-per-slice)")
    fs.add_argument("--quotas", default=None,
                    help="tenant=hosts,... (default: tony.fleet.quotas)")
    fs.add_argument("--pool-dir", default=None,
                    help="warm executor pool for every grant "
                         "(default: tony.fleet.pool-dir)")
    fs.add_argument("--recover", action="store_true",
                    help="replay the fleet journal and resume the same "
                         "queue state (after a daemon crash)")
    fs.add_argument("--conf-file")
    fs.add_argument("--conf", action="append", metavar="K=V")
    fs.set_defaults(fn=_cmd_fleet)
    for name, hlp in (("stop", "stop the daemon (running jobs keep "
                               "running)"),
                      ("status", "one scheduler snapshot"),
                      ("top", "live scheduler view (pool occupancy, "
                              "tenants, queue waits)")):
        fx = fl_sub.add_parser(name, help=hlp)
        fx.add_argument("--dir")
        fx.add_argument("--workdir")
        fx.add_argument("--conf-file")
        fx.add_argument("--conf", action="append", metavar="K=V")
        if name == "top":
            fx.add_argument("--interval", type=float, default=2.0)
            fx.add_argument("--once", action="store_true")
        fx.set_defaults(fn=_cmd_fleet)
    fb = fl_sub.add_parser(
        "submit",
        help="queue a job through the fleet: the policy engine grants "
             "it hosts (or queues it behind priorities/quotas) and the "
             "daemon runs it through the ordinary submit stack")
    fb.add_argument("--dir")
    fb.add_argument("--workdir")
    fb.add_argument("--tenant", required=True)
    fb.add_argument("--hosts", type=int, required=True,
                    help="gang size in pool hosts "
                         "(becomes tony.worker.instances)")
    fb.add_argument("--priority", type=int, default=0,
                    help="higher preempts lower (default 0)")
    fb.add_argument("--min-hosts", type=int, default=0,
                    help="elastic shrink floor; >0 marks the job "
                         "preemptible via elastic resize (never killed)")
    fb.add_argument("--model", default="",
                    help="model key recorded with the submission (the "
                         "reference's compile-cache mount has no "
                         "counterpart in the port)")
    fb.add_argument("--follow", action="store_true",
                    help="poll until the job reaches a terminal state")
    fb.add_argument("--conf-file", help="job config (json/yaml)")
    fb.add_argument("--conf", action="append", metavar="K=V",
                    help="job config override (repeatable)")
    fb.set_defaults(fn=_cmd_fleet)
    fc = fl_sub.add_parser("cancel", help="cancel a queued or running "
                                          "fleet job")
    fc.add_argument("job")
    fc.add_argument("--dir")
    fc.add_argument("--workdir")
    fc.add_argument("--conf-file")
    fc.add_argument("--conf", action="append", metavar="K=V")
    fc.set_defaults(fn=_cmd_fleet)
    fm = fl_sub.add_parser(
        "migrate",
        help="live-migrate a RUNNING fleet job to another slice by "
             "hand (defrag, pre-maintenance evacuation): the daemon "
             "drives the job's own drain→move→reshard migration and "
             "re-books the pool — the policy engine also plans these "
             "itself on fragmentation and reclaim notices")
    fm.add_argument("job")
    fm.add_argument("target", type=int, help="destination slice index")
    fm.add_argument("--dir")
    fm.add_argument("--workdir")
    fm.add_argument("--conf-file")
    fm.add_argument("--conf", action="append", metavar="K=V")
    fm.set_defaults(fn=_cmd_fleet)
    fe = fl_sub.add_parser(
        "explain",
        help="why is my job queued: the causal hold timeline — every "
             "scheduler decision transition (quota / capacity / "
             "fragmentation / priority-held / preempt-wait) with the "
             "blocking jobs/tenants named; falls back to journal "
             "replay when the daemon is down")
    fe.add_argument("job")
    fe.add_argument("--dir")
    fe.add_argument("--workdir")
    fe.add_argument("--json", action="store_true",
                    help="print the raw decision/milestone document")
    fe.add_argument("--conf-file")
    fe.add_argument("--conf", action="append", metavar="K=V")
    fe.set_defaults(fn=_cmd_fleet)
    fd = fl_sub.add_parser(
        "diagnose",
        help="fleet-level rule engine over the goodput ledger + "
             "decision records: STARVATION / QUOTA_SATURATED / "
             "FRAGMENTATION / PREEMPT_STORM / POOL_COLD / "
             "FLEET_HEALTHY, evidence-backed (works offline from the "
             "fleet dir; docs/operations.md 'Fleet triage')")
    fd.add_argument("--dir")
    fd.add_argument("--workdir")
    fd.add_argument("--json", action="store_true",
                    help="print the raw fleet.incident.json document")
    fd.add_argument("--conf-file")
    fd.add_argument("--conf", action="append", metavar="K=V")
    fd.set_defaults(fn=_cmd_fleet)
    fw = fl_sub.add_parser(
        "whatif",
        help="fleet time machine: replay the recorded journal through "
             "the real policy engine under counterfactual quotas / "
             "priorities / pool shape and diff goodput, queue waits "
             "and per-tenant hold seconds against the recorded run — "
             "parity-gated, fully offline (docs/operations.md "
             "'Capacity planning and what-if')")
    fw.add_argument("--set", action="append", default=[],
                    metavar="K=V",
                    help="override a tony.fleet.* knob in the replay "
                         "(quotas, slices, hosts-per-slice, "
                         "sim-preemption/defrag/restore; also the "
                         "quota.<tenant> / priority.<job> / pool "
                         "shorthands)")
    fw.add_argument("--quota", action="append", default=[],
                    metavar="TENANT=N",
                    help="counterfactual host quota for one tenant")
    fw.add_argument("--pool", default="",
                    metavar="SxH", help="counterfactual pool shape, "
                    "e.g. 4x8 = 4 slices of 8 hosts")
    fw.add_argument("--priority", action="append", default=[],
                    metavar="JOB=P",
                    help="counterfactual priority for one recorded job")
    fw.add_argument("--sweep", action="append", default=[],
                    metavar="K=a,b,c",
                    help="sweep one key over a value grid (repeat for "
                         "a cartesian product; max 64 combinations)")
    fw.add_argument("--expect-parity", action="store_true",
                    help="exit 1 unless the parity gate reproduces the "
                         "recorded sequence bit-for-bit")
    fw.add_argument("--dir")
    fw.add_argument("--workdir")
    fw.add_argument("--json", action="store_true",
                    help="print the raw whatif report document")
    fw.add_argument("--conf-file")
    fw.add_argument("--conf", action="append", metavar="K=V")
    fw.set_defaults(fn=_cmd_fleet)
    fco = fl_sub.add_parser(
        "cordon",
        help="pull one pool host out of placement by hand "
             "(pre-maintenance, suspected hardware); manual cordons "
             "never auto-expire — close with uncordon "
             "(docs/operations.md 'Host health')")
    fco.add_argument("host", help="pool host id, e.g. s0h3")
    fco.add_argument("--reason", default="", help="recorded in the "
                     "health journal and `fleet health` evidence")
    fco.add_argument("--dir")
    fco.add_argument("--workdir")
    fco.add_argument("--conf-file")
    fco.add_argument("--conf", action="append", metavar="K=V")
    fco.set_defaults(fn=_cmd_fleet)
    fun = fl_sub.add_parser(
        "uncordon", help="return a cordoned host to the placement pool")
    fun.add_argument("host")
    fun.add_argument("--dir")
    fun.add_argument("--workdir")
    fun.add_argument("--conf-file")
    fun.add_argument("--conf", action="append", metavar="K=V")
    fun.set_defaults(fn=_cmd_fleet)
    fh = fl_sub.add_parser(
        "health",
        help="the host-health ledger: per-host state/score/evidence, "
             "the current cordon set and any sick slices "
             "(tony.health.* keys)")
    fh.add_argument("--dir")
    fh.add_argument("--workdir")
    fh.add_argument("--json", action="store_true",
                    help="print the raw ledger document")
    fh.add_argument("--conf-file")
    fh.add_argument("--conf", action="append", metavar="K=V")
    fh.set_defaults(fn=_cmd_fleet)
    fa = fl_sub.add_parser(
        "alerts",
        help="fleet-scope SLO/alert state: live rule-engine rows from "
             "a running daemon, or the journaled REC_FLEET_ALERT "
             "transitions replayed for a dead one")
    fa.add_argument("--dir")
    fa.add_argument("--workdir")
    fa.add_argument("--json", action="store_true",
                    help="print the raw alerts document")
    fa.add_argument("--conf-file")
    fa.add_argument("--conf", action="append", metavar="K=V")
    fa.set_defaults(fn=_cmd_fleet)

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

    ch = sub.add_parser(
        "chaos",
        help="the seeded multi-fault chaos engine (tony_tpu_torch/chaos/): "
             "plan correlated-failure schedules from one seed, run "
             "them against the in-process control plane under the "
             "invariant ladder, replay any artifact bit-identically, "
             "and delta-debug a failing schedule to its minimal repro "
             "(docs/operations.md \u00a7 Chaos drills).")
    ch_sub = ch.add_subparsers(dest="chaos_cmd", required=True)
    cr = ch_sub.add_parser(
        "run", help="sweep N seeded schedules; exit nonzero if any "
                    "run violates the invariant ladder")
    cr.add_argument("--seed", type=int, default=0,
                    help="sweep seed: same seed, same schedules, "
                         "same per-call fault decisions (default 0)")
    cr.add_argument("--schedules", type=int, default=20,
                    help="how many schedules to plan and run")
    cr.add_argument("--suite",
                    choices=["e2e", "fleet", "migrate", "health"],
                    default=None,
                    help="restrict to one suite (default: round-robin "
                         "across all of them)")
    cr.add_argument("--out", default="chaos-artifacts",
                    help="artifact directory (one JSON per schedule)")
    cr.add_argument("--fail-fast", action="store_true",
                    help="stop at the first ladder violation")
    cr.set_defaults(fn=_cmd_chaos_run)
    cp = ch_sub.add_parser(
        "replay", help="re-plan + re-run one artifact's schedule; "
                       "proves planner determinism, then compares the "
                       "ladder verdict against the recording")
    cp.add_argument("artifact", help="a chaos artifact JSON path")
    cp.add_argument("--out", default="chaos-artifacts",
                    help="artifact directory for the re-run")
    cp.set_defaults(fn=_cmd_chaos_replay)
    cs = ch_sub.add_parser(
        "shrink", help="ddmin a FAILING artifact's schedule to the "
                       "1-minimal injection set that still fails; "
                       "saves the minimal repro as a new artifact")
    cs.add_argument("artifact", help="a failing chaos artifact JSON")
    cs.add_argument("--out", default="chaos-artifacts",
                    help="artifact directory for shrink runs")
    cs.add_argument("--max-runs", type=int, default=60,
                    help="shrink budget: predicate re-runs (default 60)")
    cs.add_argument("--note", default="",
                    help="provenance note stored in the shrunk artifact")
    cs.set_defaults(fn=_cmd_chaos_shrink)

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
