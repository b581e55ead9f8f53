"""Elastic-gang drills through the port (tony_tpu_torch/coordinator/
elastic.py): the drills of ``tests/test_e2e_elastic.py`` against ``python
-m tony_tpu_torch.coordinator`` and ``tony_tpu_torch.cli``.

Drill 1: LocalSim, 8 virtual hosts. SIGKILL two of them mid-run, and
training continues at 6 within one checkpoint interval, same epoch, loss
curve continuous against the uninterrupted golden run, zero epochs
burned; then grow 6→8 live through ``cli resize`` and finish. Sample
accounting proves the data re-split across the surviving ranks
(``tony_tpu_torch.data.process_batch_slice``) dropped and duplicated
nothing.

Drill 2: the ``host.loss`` fault site fells one virtual host, and while
the survivors drain (a widened drain window) the coordinator is SIGKILLed.
``--recover`` re-enters the journaled in-flight resize and completes it:
the job finishes in the same epoch instead of restarting.

The user script is written into ``tmp_path``; the shared helpers come
from ``test_torch_e2e_recovery.py``.
"""

import json
import os
import signal
import sys
import time

import pytest

from tony_tpu_torch import constants
from tony_tpu_torch.conf import keys as K
from tony_tpu_torch.conf.config import TonyTpuConfig
from tony_tpu_torch.events import history
from tony_tpu_torch.events.events import EventType

from test_torch_e2e_recovery import (_await_exit, _connect, _dump_logs,
                                     _job_layout, _journal_epochs,
                                     _poll_report, _spawn_coordinator,
                                     check_artifacts, write_script)

# Elastic training stand-in (tests/scripts/train_elastic.py): a
# checkpointing, step-synchronous SPMD gang without collectives. The chief
# (dense rank 0) publishes ckpt.json = {"step": s, "loss": L} once every
# member's sample log shows step s; the others wait for ckpt.step >= s-1
# before step s. The loss is a pure function of the step count. Each rank
# appends "step world start stop" of its process_batch_slice rows to
# samples.<stable index> and, on (re)start, resumes from the checkpoint,
# truncating its logs past it. SIGTERM (the drain) sleeps
# TONY_TEST_DRAIN_DELAY, then exits 143.
ELASTIC_SCRIPT = r"""
import json
import os
import signal
import sys
import time


def _read_ckpt(path):
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _write_ckpt(path, step, loss):
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"step": step, "loss": loss}, f)
    os.replace(tmp, path)


def _truncate_log(path, keep_step):
    # Drop records past the resume point: superseded partial steps are
    # re-run (at the new world size), exactly once in the final log.
    if not os.path.exists(path):
        return
    kept = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            try:
                if parts and int(parts[0]) <= keep_step:
                    kept.append(line)
            except ValueError:
                continue
    with open(path, "w", encoding="utf-8") as f:
        f.writelines(kept)


def _loss_at(step):
    loss = 100.0
    for k in range(1, step + 1):
        loss = loss / (1.0 + 0.1 * k)
    return loss


def main() -> int:
    from tony_tpu_torch.data import process_batch_slice

    total = int(os.environ.get("TONY_TEST_TOTAL_STEPS", "30"))
    dt = float(os.environ.get("TONY_TEST_STEP_SECONDS", "0.25"))
    gb = int(os.environ.get("TONY_TEST_GLOBAL_BATCH", "24"))
    outdir = os.environ["TONY_TEST_ELASTIC_DIR"]
    drain_delay = float(os.environ.get("TONY_TEST_DRAIN_DELAY", "0"))
    rank = int(os.environ["TASK_INDEX"])          # dense rank
    world = int(os.environ["TASK_NUM"])           # current gang size
    ident = os.environ.get("TONY_TASK_INDEX", str(rank))  # stable index
    members = [m for m in os.environ.get(
        "TONY_GANG_MEMBERS", "").split(",") if m != ""]
    if not members:
        members = [str(i) for i in range(world)]

    def on_term(signum, frame):
        if drain_delay:
            time.sleep(drain_delay)
        # os._exit, not sys.exit: the drain's 143 must not depend on
        # what the interpreter's teardown does with torch's threads.
        # All writes below are already closed (context managers) when
        # this fires.
        os._exit(143)

    signal.signal(signal.SIGTERM, on_term)

    ckpt_path = os.path.join(outdir, "ckpt.json")
    samples_path = os.path.join(outdir, f"samples.{ident}")
    loss_path = os.path.join(outdir, "loss.log")

    ckpt = _read_ckpt(ckpt_path)
    start = int(ckpt["step"]) + 1 if ckpt else 1
    loss = _loss_at(start - 1)
    _truncate_log(samples_path, start - 1)
    if rank == 0:
        _truncate_log(loss_path, start - 1)

    deadline = time.monotonic() + 120.0           # wedge-proof
    for step in range(start, total + 1):
        # step-synchronous gang: wait for the chief's previous publish
        while rank != 0:
            c = _read_ckpt(ckpt_path)
            if (int(c["step"]) if c else 0) >= step - 1:
                break
            if time.monotonic() > deadline:
                print(f"rank {rank} wedged waiting for ckpt {step - 1}",
                      file=sys.stderr)
                return 2
            time.sleep(0.02)
        time.sleep(dt)
        loss = loss / (1.0 + 0.1 * step)
        rows = process_batch_slice(gb, rank=rank, world=world)
        with open(samples_path, "a", encoding="utf-8") as f:
            f.write(f"{step} {world} {rows.start} {rows.stop}\n")
        if rank == 0:
            # publish only once EVERY member completed the step at this
            # world size — the checkpoint never runs ahead of the slowest
            # rank, so a resume point is always a fully-covered step. (A
            # member that has not restarted yet still holds its record
            # of the step at the old size: it is not this step's.)
            mine = [str(step), str(world)]
            for m in members:
                mpath = os.path.join(outdir, f"samples.{m}")
                while True:
                    done = False
                    try:
                        with open(mpath, encoding="utf-8") as f:
                            done = any(ln.split()[:2] == mine for ln in f)
                    except OSError:
                        pass
                    if done:
                        break
                    if time.monotonic() > deadline:
                        print(f"chief wedged waiting for member {m} "
                              f"step {step}", file=sys.stderr)
                        return 2
                    time.sleep(0.02)
            with open(loss_path, "a", encoding="utf-8") as f:
                f.write(f"{step} {loss:.12g}\n")
            _write_ckpt(ckpt_path, step, loss)
        deadline = time.monotonic() + 120.0
    with open(os.path.join(outdir, f"result.{ident}"), "w",
              encoding="utf-8") as f:
        f.write(f"{total} {loss:.12g}\n")
    return 0


if __name__ == "__main__":
    # os._exit for the same reason as the TERM handler.
    os._exit(main())
"""

GLOBAL_BATCH = 168            # divisible by every gang size 8/7/6/4/3


def _golden_losses(total):
    loss, out = 100.0, []
    for step in range(1, total + 1):
        loss = loss / (1.0 + 0.1 * step)
        out.append(f"{loss:.12g}")
    return out


def _elastic_conf(tmp_path, workers, total_steps, extra=None,
                  drain_delay=0.0):
    outdir = tmp_path / "elastic"
    outdir.mkdir(exist_ok=True)
    conf = TonyTpuConfig()
    conf.set("tony.worker.instances", workers)
    # `exec`: python replaces the /bin/sh wrapper as the process-group
    # leader, so the drain TERM reaches the handler directly and its
    # delayed 143 (TONY_TEST_DRAIN_DELAY — the mid-resize crash window)
    # actually holds the exit open instead of sh dying instantly.
    script = write_script(tmp_path, "train_elastic.py", ELASTIC_SCRIPT)
    conf.set("tony.worker.command", f"exec {sys.executable} {script}")
    conf.set(K.HISTORY_LOCATION, str(tmp_path / "history"))
    conf.set(K.ELASTIC_ENABLED, True)
    conf.set(K.ELASTIC_MIN_TASKS, 3)
    conf.set(K.ELASTIC_BARRIER_TIMEOUT_S, 90)
    conf.set(K.ELASTIC_DRAIN_GRACE_S, 10)
    conf.set(K.TASK_REGISTRATION_TIMEOUT_S, 90)
    conf.set(K.APPLICATION_TIMEOUT_S, 280)
    conf.set(K.COORDINATOR_MONITOR_INTERVAL_MS, 100)
    conf.set(K.APPLICATION_NUM_CLIENTS_TO_WAIT, False)
    conf.set(K.APPLICATION_RETRY_COUNT, 1)    # budget must stay untouched
    conf.set(K.TASK_HEARTBEAT_INTERVAL_MS, 200)
    conf.set(K.TASK_COORDINATOR_LOSS_HEARTBEATS, 2)
    conf.set(K.TASK_ORPHAN_DEADLINE_S, 90)
    conf.set(K.COORDINATOR_REREGISTRATION_GRACE_S, 60)
    conf.set(K.RPC_MAX_RETRIES, 2)
    conf.set(K.RPC_RETRY_SLEEP_S, 0.2)
    conf.set(K.RPC_CALL_TIMEOUT_S, 5.0)
    conf.set(K.EXECUTION_ENV,
             f"TONY_TEST_TOTAL_STEPS={total_steps},"
             f"TONY_TEST_STEP_SECONDS=0.25,"
             f"TONY_TEST_GLOBAL_BATCH={GLOBAL_BATCH},"
             f"TONY_TEST_ELASTIC_DIR={outdir},"
             f"TONY_TEST_DRAIN_DELAY={drain_delay}")
    for k, v in (extra or {}).items():
        conf.set(k, v)
    return conf, outdir


def _ckpt_step(outdir):
    try:
        with open(outdir / "ckpt.json", encoding="utf-8") as f:
            return int(json.load(f).get("step", 0))
    except (OSError, ValueError):
        return 0


def _wait_ckpt_step(outdir, at_least, timeout=90, job_dir=None):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if _ckpt_step(outdir) >= at_least:
            return
        time.sleep(0.1)
    raise AssertionError(
        f"checkpoint never reached step {at_least} "
        f"(at {_ckpt_step(outdir)})"
        + (f"\n{_dump_logs(job_dir)}" if job_dir else ""))


def _kill_virtual_host(app_id, task_id):
    """SIGKILL everything on a 'virtual host' — the task's executor AND
    its user process (both session leaders), found by their exact
    TONY_APP_ID/TONY_TASK_ID environment. The shape a dead machine
    leaves behind: no teardown, no exit report from anyone."""
    needles = (f"TONY_APP_ID={app_id}\0".encode(),
               f"TONY_TASK_ID={task_id}\0".encode())
    me = os.getpid()
    killed = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit() or int(entry) == me:
            continue
        try:
            with open(f"/proc/{entry}/environ", "rb") as f:
                raw = f.read() + b"\0"
        except OSError:
            continue
        if all(n in raw for n in needles):
            try:
                pgid = os.getpgid(int(entry))
                os.killpg(pgid, signal.SIGKILL)
                killed.append(int(entry))
            except (ProcessLookupError, PermissionError):
                continue
    return killed


def _assert_exact_coverage(outdir, total_steps):
    """For every step, EXACTLY ONE world size's sample records tile the
    global batch with no overlap: no sample dropped, none duplicated,
    at whatever gang size executed (or re-executed) the step. Returns
    {step: winning world}."""
    import glob

    per_step = {}
    for path in glob.glob(str(outdir / "samples.*")):
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.split()
                if len(parts) != 4:
                    continue
                step, world, start, stop = map(int, parts)
                per_step.setdefault(step, {}).setdefault(
                    world, []).append((start, stop))
    worlds = {}
    for step in range(1, total_steps + 1):
        assert step in per_step, f"step {step} has no sample records"
        exact = []
        for world, spans in per_step[step].items():
            covered = [i for a, b in spans for i in range(a, b)]
            assert len(covered) == len(set(covered)), \
                f"step {step}: duplicated rows at world {world}"
            if sorted(covered) == list(range(GLOBAL_BATCH)):
                exact.append(world)
        assert len(exact) == 1, \
            f"step {step}: worlds with exact coverage {exact} " \
            f"(recorded worlds {sorted(per_step[step])})"
        worlds[step] = exact[0]
    return worlds


def _assert_golden_loss(outdir, total_steps):
    """The chief's loss log is EXACTLY the uninterrupted golden curve,
    one line per step — continuity across every resize, zero steps lost
    or double-counted."""
    lines = (outdir / "loss.log").read_text().splitlines()
    got = {}
    for ln in lines:
        step_s, loss_s = ln.split()
        assert int(step_s) not in got, f"step {step_s} logged twice"
        got[int(step_s)] = loss_s
    golden = _golden_losses(total_steps)
    assert sorted(got) == list(range(1, total_steps + 1))
    for step in range(1, total_steps + 1):
        assert got[step] == golden[step - 1], \
            f"loss diverged at step {step}: {got[step]} != " \
            f"{golden[step - 1]}"


@pytest.mark.slow
@pytest.mark.timeout_s(290)
def test_e2e_sigkill_two_hosts_shrink_then_grow_back(tmp_path):
    """Acceptance drill: 8 virtual hosts, SIGKILL 2 mid-run → continue
    at 6 in the SAME epoch (loss curve golden-continuous, zero epochs
    burned), then `cli resize` back to 8 and finish."""
    from tony_tpu_torch.cli.main import main as cli_main

    app_id = "app_elastic_1"
    total = 30
    conf, outdir = _elastic_conf(tmp_path, workers=8, total_steps=total,
                                 drain_delay=0.3)
    job_dir, frozen = _job_layout(tmp_path, conf, app_id)
    hist_root = str(tmp_path / "history")
    proc = _spawn_coordinator(job_dir, frozen, app_id, hist_root)
    try:
        rpc = _connect(job_dir, timeout=60)
        _poll_report(
            rpc, lambda r: len(r.get("tasks", [])) == 8
            and all(t["status"] == "RUNNING" for t in r["tasks"]),
            what="8-host gang running", timeout=90)
        # training underway with a durable checkpoint behind it
        _wait_ckpt_step(outdir, 4, job_dir=job_dir)

        # --- SIGKILL two virtual hosts back to back ------------------
        assert _kill_virtual_host(app_id, "worker:3"), "nothing killed"
        assert _kill_virtual_host(app_id, "worker:4"), "nothing killed"
        shrink_at = _ckpt_step(outdir)

        report = _poll_report(
            rpc, lambda r: (r.get("gang_size") or {}).get("worker") == 6
            and not (r.get("elastic") or {}).get("resizing")
            and all(t["status"] == "RUNNING" for t in r.get("tasks", [])),
            what="shrink to 6 to complete", timeout=90)
        assert report["session_id"] == 0, _dump_logs(job_dir)
        assert report["retries_left"] == 1, \
            "an absorbed host loss must not burn the retry budget"
        assert sorted(t["index"] for t in report["tasks"]) == \
            [0, 1, 2, 5, 6, 7], "survivor indices must be kept"
        # continues at 6: the checkpoint advances within one interval
        _wait_ckpt_step(outdir, shrink_at + 3, job_dir=job_dir)

        # --- grow back 6 -> 8 through the CLI verb -------------------
        assert cli_main(["resize", app_id, "8",
                         "--workdir", str(tmp_path / "work")]) == 0
        _poll_report(
            rpc, lambda r: (r.get("gang_size") or {}).get("worker") == 8
            and not (r.get("elastic") or {}).get("resizing"),
            what="grow back to 8", timeout=90)
        rpc.close()
        _await_exit(proc, job_dir, timeout=150)
    finally:
        if proc.poll() is None:
            proc.kill()

    # Zero epochs burned: the journal holds exactly the launch epoch.
    assert _journal_epochs(hist_root, app_id) == [0]
    # Loss curve continuous against the uninterrupted golden run.
    _assert_golden_loss(outdir, total)
    # No sample dropped or duplicated across the 8 -> 6 -> 8 re-splits.
    worlds = _assert_exact_coverage(outdir, total)
    assert worlds[1] == 8 and worlds[total] == 8
    assert 6 in worlds.values(), "no step ran at the shrunken size"
    # Every final member (including the re-grown 3 and 4) finished.
    for ident in (0, 1, 2, 3, 4, 5, 6, 7):
        result = (outdir / f"result.{ident}").read_text().split()
        assert result[0] == str(total)
        assert result[1] == _golden_losses(total)[-1]

    jobs = [j for j in history.list_jobs(hist_root) if j.app_id == app_id]
    assert [j.status for j in jobs] == ["SUCCEEDED"], _dump_logs(job_dir)
    events = history.read_job_events(hist_root, app_id)
    resizes = [e for e in events if e.type == EventType.GANG_RESIZED]
    phases = [(e.payload["phase"], e.payload["to"]) for e in resizes]
    assert ("completed", 6) in phases, phases
    assert ("completed", 8) in phases, phases
    absorbed = [e for e in events if e.type == EventType.TASK_FINISHED
                and e.payload.get("resize")]
    assert {e.payload["task"] for e in absorbed} >= \
        {"worker:3", "worker:4"}
    assert all(e.payload["session_id"] == 0 for e in events
               if e.type == EventType.TASK_FINISHED)
    from procwatch import assert_no_orphans
    assert_no_orphans(f"TONY_APP_ID={app_id}")
    check_artifacts(tmp_path)


@pytest.mark.slow
@pytest.mark.timeout_s(290)
def test_e2e_mid_resize_coordinator_sigkill_recover_completes_resize(
        tmp_path):
    """The `host.loss` fault fells worker:2; while the survivors drain
    (widened drain window), the coordinator is SIGKILLed. `--recover`
    must RE-ENTER the journaled in-flight resize and complete it — same
    epoch, no restart, loss curve still golden."""
    app_id = "app_elastic_2"
    total = 20
    conf, outdir = _elastic_conf(
        tmp_path, workers=4, total_steps=total, drain_delay=4.0,
        extra={K.ELASTIC_MIN_TASKS: 2,
               # ~35 beats at 200 ms ≈ 7 s in: registered, checkpointing
               K.FAULT_HOST_LOSS: "task:worker:2,after:35"})
    job_dir, frozen = _job_layout(tmp_path, conf, app_id)
    hist_root = str(tmp_path / "history")
    journal_path = os.path.join(hist_root, "intermediate", app_id,
                                constants.JOURNAL_FILE)

    proc1 = _spawn_coordinator(job_dir, frozen, app_id, hist_root)
    proc2 = None
    try:
        rpc = _connect(job_dir, timeout=60)
        _poll_report(
            rpc, lambda r: len(r.get("tasks", [])) == 4
            and all(t["status"] == "RUNNING" for t in r["tasks"]),
            what="4-host gang running", timeout=90)
        rpc.close()

        # Wait for the journaled resize START (the drain window is ~4 s
        # wide thanks to the drain delay), then SIGKILL the coordinator
        # MID-RESIZE — before "applied" can land.
        deadline = time.monotonic() + 120
        started = False
        while time.monotonic() < deadline:
            try:
                with open(journal_path, encoding="utf-8") as f:
                    recs = [json.loads(ln) for ln in f if ln.strip()]
            except (OSError, ValueError):
                recs = []
            if any(r.get("t") == "resize" and r.get("phase") == "start"
                   for r in recs):
                started = True
                break
            time.sleep(0.05)
        assert started, "host.loss never triggered a resize\n" \
            + _dump_logs(job_dir)
        assert not any(r.get("t") == "resize"
                       and r.get("phase") == "applied" for r in recs), \
            "drain completed before the crash could land mid-resize"
        proc1.send_signal(signal.SIGKILL)
        proc1.wait(timeout=10)
        (job_dir / "coordinator.addr").unlink()

        proc2 = _spawn_coordinator(job_dir, frozen, app_id, hist_root,
                                   recover=True)
        _await_exit(proc2, job_dir, timeout=200)
    finally:
        for p in (proc1, proc2):
            if p is not None and p.poll() is None:
                p.kill()

    assert _journal_epochs(hist_root, app_id) == [0], \
        "the recovered resize must not burn a retry epoch"
    with open(journal_path, encoding="utf-8") as f:
        recs = [json.loads(ln) for ln in f if ln.strip()]
    applied = [r for r in recs if r.get("t") == "resize"
               and r.get("phase") == "applied"]
    assert applied and applied[-1]["members"] == [0, 1, 3], applied
    _assert_golden_loss(outdir, total)
    worlds = _assert_exact_coverage(outdir, total)
    assert worlds[total] == 3, "the job must FINISH at the shrunken size"
    for ident in (0, 1, 3):
        assert (outdir / f"result.{ident}").exists()

    jobs = [j for j in history.list_jobs(hist_root) if j.app_id == app_id]
    assert [j.status for j in jobs] == ["SUCCEEDED"], _dump_logs(job_dir)
    events = history.read_job_events(hist_root, app_id)
    types = [e.type for e in events]
    assert EventType.COORDINATOR_RECOVERED in types
    completed = [e for e in events if e.type == EventType.GANG_RESIZED
                 and e.payload["phase"] == "completed"]
    assert completed and completed[-1].payload["to"] == 3
    from procwatch import assert_no_orphans
    assert_no_orphans(f"TONY_APP_ID={app_id}")
    check_artifacts(tmp_path)
