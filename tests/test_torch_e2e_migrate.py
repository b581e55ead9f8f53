"""Live migration through the port (tony_tpu_torch/coordinator/
migrate.py): the drills of ``tests/test_e2e_migrate.py`` against ``python
-m tony_tpu_torch.coordinator`` and ``tony_tpu_torch.cli``.

Drill 1: LocalSim, 4 virtual hosts. Mid-run, ``cli migrate <app>
slice-1`` drains the whole gang (each member's SIGTERM handler lands one
final durable checkpoint), relaunches it on the target, and training
continues in the same epoch: loss curve golden-continuous, zero steps
lost, zero retry budget burned.

Drill 2: while the gang drains toward the target (a widened drain
window), the coordinator is SIGKILLed. ``--recover`` re-enters the
journaled in-flight migration from its REC_MIGRATE start record and
completes the move instead of abandoning it.
"""

import json
import os
import signal

import pytest

from tony_tpu_torch import constants
from tony_tpu_torch.events import history
from tony_tpu_torch.events.events import EventType

from test_torch_e2e_elastic import (_assert_exact_coverage,
                                    _assert_golden_loss, _ckpt_step,
                                    _elastic_conf, _wait_ckpt_step)
from test_torch_e2e_recovery import (_await_exit, _connect, _dump_logs,
                                     _job_layout, _journal_epochs,
                                     _poll_report, _spawn_coordinator,
                                     check_artifacts)


def _migrate_records(hist_root, app_id):
    journal_path = os.path.join(hist_root, "intermediate", app_id,
                                constants.JOURNAL_FILE)
    try:
        with open(journal_path, encoding="utf-8") as f:
            recs = [json.loads(ln) for ln in f if ln.strip()]
    except (OSError, ValueError):
        recs = []
    return [r for r in recs if r.get("t") == "migrate"]


@pytest.mark.slow
@pytest.mark.timeout_s(290)
def test_e2e_live_migration_same_epoch_zero_steps_lost(tmp_path):
    """Acceptance drill: the whole gang moves slices mid-run through
    the CLI verb; training continues in the SAME epoch with the golden
    loss curve — a migration costs one drain window, not an epoch."""
    from tony_tpu_torch.cli.main import main as cli_main

    app_id = "app_migrate_1"
    total = 20
    conf, outdir = _elastic_conf(tmp_path, workers=4, total_steps=total,
                                 drain_delay=0.3)
    job_dir, frozen = _job_layout(tmp_path, conf, app_id)
    hist_root = str(tmp_path / "history")
    proc = _spawn_coordinator(job_dir, frozen, app_id, hist_root)
    try:
        rpc = _connect(job_dir, timeout=60)
        _poll_report(
            rpc, lambda r: len(r.get("tasks", [])) == 4
            and all(t["status"] == "RUNNING" for t in r["tasks"]),
            what="4-host gang running", timeout=90)
        _wait_ckpt_step(outdir, 4, job_dir=job_dir)
        move_at = _ckpt_step(outdir)

        assert cli_main(["migrate", app_id, "slice-1",
                         "--workdir", str(tmp_path / "work")]) == 0
        report = _poll_report(
            rpc, lambda r: not (r.get("elastic") or {}).get("resizing")
            and any(x.get("phase") == "applied"
                    for x in _migrate_records(hist_root, app_id))
            and len(r.get("tasks", [])) == 4
            and all(t["status"] == "RUNNING" for t in r.get("tasks", [])),
            what="migration to complete", timeout=120)
        assert report["session_id"] == 0, _dump_logs(job_dir)
        assert report["retries_left"] == 1, \
            "a live migration must not burn the retry budget"
        # the destination gang advances within one checkpoint interval
        _wait_ckpt_step(outdir, move_at + 3, job_dir=job_dir)
        rpc.close()
        _await_exit(proc, job_dir, timeout=150)
    finally:
        if proc.poll() is None:
            proc.kill()

    # Same epoch end to end: the journal holds exactly the launch epoch.
    assert _journal_epochs(hist_root, app_id) == [0]
    # Write-ahead bracket on disk: start then applied, both slice-1.
    phases = [(r["phase"], r["target"]) for r in
              _migrate_records(hist_root, app_id)]
    assert phases == [("start", "slice-1"), ("applied", "slice-1")], \
        phases
    # Zero steps lost or double-counted across the move.
    _assert_golden_loss(outdir, total)
    worlds = _assert_exact_coverage(outdir, total)
    assert set(worlds.values()) == {4}, \
        "a migration moves the gang, never resizes it"
    for ident in (0, 1, 2, 3):
        result = (outdir / f"result.{ident}").read_text().split()
        assert result[0] == str(total)

    jobs = [j for j in history.list_jobs(hist_root) if j.app_id == app_id]
    assert [j.status for j in jobs] == ["SUCCEEDED"], _dump_logs(job_dir)
    events = history.read_job_events(hist_root, app_id)
    mig = [e for e in events if e.type == EventType.GANG_MIGRATED]
    assert [e.payload["phase"] for e in mig] == ["started", "completed"]
    assert mig[1].payload["target"] == "slice-1"
    assert mig[1].payload["duration_s"] < 60
    from procwatch import assert_no_orphans
    assert_no_orphans(f"TONY_APP_ID={app_id}")
    check_artifacts(tmp_path)


@pytest.mark.slow
@pytest.mark.timeout_s(290)
def test_e2e_mid_migration_coordinator_sigkill_recover_completes_move(
        tmp_path):
    """The coordinator is SIGKILLed while the gang drains toward the
    target. `--recover` re-enters the journaled in-flight migration and
    completes it — same epoch, no restart, loss curve still golden."""
    from tony_tpu_torch.cli.main import main as cli_main

    app_id = "app_migrate_2"
    total = 20
    conf, outdir = _elastic_conf(tmp_path, workers=4, total_steps=total,
                                 drain_delay=4.0)
    job_dir, frozen = _job_layout(tmp_path, conf, app_id)
    hist_root = str(tmp_path / "history")

    proc1 = _spawn_coordinator(job_dir, frozen, app_id, hist_root)
    proc2 = None
    try:
        rpc = _connect(job_dir, timeout=60)
        _poll_report(
            rpc, lambda r: len(r.get("tasks", [])) == 4
            and all(t["status"] == "RUNNING" for t in r["tasks"]),
            what="4-host gang running", timeout=90)
        _wait_ckpt_step(outdir, 3, job_dir=job_dir)
        rpc.close()

        # The CLI journals the REC_MIGRATE start WRITE-AHEAD of any
        # directive, so the op is already re-enterable when this
        # returns; the ~4 s drain delay holds the window open.
        assert cli_main(["migrate", app_id, "slice-1",
                         "--workdir", str(tmp_path / "work")]) == 0
        recs = _migrate_records(hist_root, app_id)
        assert [r["phase"] for r in recs] == ["start"], \
            "crash window missed: " + str(recs)
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
        "the recovered migration must not burn a retry epoch"
    recs = _migrate_records(hist_root, app_id)
    # pre-crash start, the recovery re-entry start, then applied — every
    # start closed, all pointing at the same target
    assert [r["phase"] for r in recs][-1] == "applied", recs
    assert {r["target"] for r in recs} == {"slice-1"}
    applied = [r for r in recs if r["phase"] == "applied"]
    assert applied[-1]["members"] == [0, 1, 2, 3]
    _assert_golden_loss(outdir, total)
    worlds = _assert_exact_coverage(outdir, total)
    assert set(worlds.values()) == {4}
    for ident in (0, 1, 2, 3):
        assert (outdir / f"result.{ident}").exists()

    jobs = [j for j in history.list_jobs(hist_root) if j.app_id == app_id]
    assert [j.status for j in jobs] == ["SUCCEEDED"], _dump_logs(job_dir)
    events = history.read_job_events(hist_root, app_id)
    types = [e.type for e in events]
    assert EventType.COORDINATOR_RECOVERED in types
    mig = [e for e in events if e.type == EventType.GANG_MIGRATED]
    assert any(e.payload.get("resumed") for e in mig
               if e.payload["phase"] == "started"), \
        "recovery must RE-ENTER the journaled migration"
    assert mig[-1].payload["phase"] == "completed"
    from procwatch import assert_no_orphans
    assert_no_orphans(f"TONY_APP_ID={app_id}")
    check_artifacts(tmp_path)
