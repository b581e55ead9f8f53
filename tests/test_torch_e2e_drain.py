"""The drain save of a job of several ranks, end to end: the port's trainer
as a job of two workers (``--device cpu``, a tiny decoder on an ``fsdp=2``
gloo mesh) is moved by ``cli migrate`` mid-run. The drain TERMs both ranks;
they agree on one boundary step, both save their shards of it, and the
relaunched gang resumes at the next step: one epoch, 0 steps re-run.

The checkpoint directory comes from the job's configuration
(``tony.application.checkpoint-dir``, exported as ``$TONY_CHECKPOINT_DIR``,
which ``--ckpt-dir`` defaults to), once as a local path and once as a
``gs://`` URL on ``FakeGcsStore``: ``TONY_FAKE_GCS_ROOT`` is set only in the
coordinator's environment, and reaches the user processes through the
executors. The harness is ``tests/test_torch_e2e_migrate.py``'s.
"""

import json
import os
import re
import sys

import pytest

from tony_tpu_torch.checkpoint import CheckpointManager
from tony_tpu_torch.conf import keys as K
from tony_tpu_torch.conf.config import TonyTpuConfig
from tony_tpu_torch.events import history
from tony_tpu_torch import trainer
from tony_tpu_torch.models.transformer import TransformerConfig

from test_torch_e2e_migrate import _migrate_records
from test_torch_e2e_recovery import (_await_exit, _connect, _dump_logs,
                                     _job_layout, _journal_epochs,
                                     _poll_report, _spawn_coordinator,
                                     check_artifacts, write_script)

#: steps of the job, and the step count at which it is migrated
TOTAL, MIGRATE_AT = 120, 5
#: seconds added to each optimizer step, so that the move lands mid-run
STEP_S = 0.1

# ``trainer.main`` with the flagship's point swapped for the tiny decoder
# at seq 32, batch 4; each optimizer step sleeps STEP_S.
TINY_TRAINER = r"""
import sys, time
import torch
from torch.optim.optimizer import register_optimizer_step_pre_hook
from tony_tpu_torch import trainer
from tony_tpu_torch.models.transformer import TransformerConfig

torch.set_num_threads(1)
trainer.LM_POINTS["flagship"] = (
    lambda seq: TransformerConfig.tiny(max_seq_len=seq), 32, None, None)
trainer.DEFAULT_BATCH["flagship"] = 4
register_optimizer_step_pre_hook(lambda *a: time.sleep(%r))
sys.exit(trainer.main(sys.argv[1:]))
""" % STEP_S


def _conf(tmp_path, ckpt_dir):
    corpus = trainer.write_corpus(str(tmp_path / "corpus.bin"),
                                  TransformerConfig.tiny().vocab_size)
    script = write_script(tmp_path, "tiny_trainer.py", TINY_TRAINER)
    conf = TonyTpuConfig()
    conf.set("tony.worker.instances", 2)
    # `exec`: the drain's TERM reaches python, not a /bin/sh wrapper. No
    # --ckpt-dir: it comes from the job's checkpoint-dir.
    conf.set("tony.worker.command",
             f"exec {sys.executable} {script} --data {corpus} "
             f"--steps {TOTAL} --device cpu --mesh fsdp=2 "
             f"--save-every 10000")
    conf.set(K.APPLICATION_CHECKPOINT_DIR, ckpt_dir)
    conf.set(K.HISTORY_LOCATION, str(tmp_path / "history"))
    conf.set(K.ELASTIC_ENABLED, True)
    conf.set(K.ELASTIC_MIN_TASKS, 1)
    conf.set(K.ELASTIC_BARRIER_TIMEOUT_S, 90)
    conf.set(K.ELASTIC_DRAIN_GRACE_S, 30)
    conf.set(K.TASK_REGISTRATION_TIMEOUT_S, 90)
    conf.set(K.APPLICATION_TIMEOUT_S, 200)
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
    return conf


def _task_log(job_dir, index, name):
    with open(job_dir / "tasks" / f"worker_{index}" / name,
              errors="replace") as f:
        return f.read()


def _steps(rpc):
    live = rpc.call("metrics.live")
    return min([t.get("steps", 0) or 0 for t in live.get("tasks", [])]
               or [0])


@pytest.mark.timeout_s(170)
@pytest.mark.parametrize("where", ["local", "gs"])
def test_trainer_job_of_two_ranks_migrates_with_no_step_rerun(
        tmp_path, monkeypatch, where):
    from tony_tpu_torch.cli.main import main as cli_main

    app_id = f"app_drain_{where}"
    if where == "gs":
        # Only here: the coordinator inherits it, the executors and user
        # processes inherit it from there.
        monkeypatch.setenv("TONY_FAKE_GCS_ROOT", str(tmp_path / "gcs"))
        ckpt = "gs://tony-ckpt/drain"
    else:
        ckpt = str(tmp_path / "ckpt")
    conf = _conf(tmp_path, ckpt)
    job_dir, frozen = _job_layout(tmp_path, conf, app_id)
    hist_root = str(tmp_path / "history")
    proc = _spawn_coordinator(job_dir, frozen, app_id, hist_root)
    mgr = CheckpointManager(ckpt)
    try:
        rpc = _connect(job_dir, timeout=60)
        _poll_report(
            rpc, lambda r: len(r.get("tasks", [])) == 2
            and all(t["status"] == "RUNNING" for t in r["tasks"])
            and _steps(rpc) >= MIGRATE_AT and 0 in mgr.all_steps(),
            what=f"step {MIGRATE_AT} and the first step's save",
            timeout=120)
        assert cli_main(["migrate", app_id, "slice-1",
                         "--workdir", str(tmp_path / "work")]) == 0
        _poll_report(
            rpc, lambda r: not (r.get("elastic") or {}).get("resizing")
            and any(x.get("phase") == "applied"
                    for x in _migrate_records(hist_root, app_id)),
            what="the migration to land", timeout=120)
        rpc.close()
        _await_exit(proc, job_dir, timeout=120)
    finally:
        mgr.close()
        if proc.poll() is None:
            proc.kill()
    # Nothing of the URL landed on local disk (the task dirs are the
    # trainers' working directories).
    assert not [d for _, dirs, _ in os.walk(tmp_path) for d in dirs
                if d == "gs:"]

    assert _journal_epochs(hist_root, app_id) == [0], _dump_logs(job_dir)
    assert [r["phase"] for r in _migrate_records(hist_root, app_id)] == \
        ["start", "applied"]
    jobs = [j for j in history.list_jobs(hist_root) if j.app_id == app_id]
    assert [j.status for j in jobs] == ["SUCCEEDED"], _dump_logs(job_dir)
    saved = set()
    for index in (0, 1):
        err = _task_log(job_dir, index, "stderr.log")
        steps = re.findall(r"saving preemption checkpoint at step (\d+)",
                           err)
        assert len(steps) == 1, err[-4000:]
        saved.add(int(steps[0]))
        run = json.loads(
            _task_log(job_dir, index, "stdout.log").strip().splitlines()[-1])
        k = int(steps[0])
        assert run["restored_step"] == k and run["start_step"] == k + 1, \
            (k, run["restored_step"], run["start_step"])
        assert len(run["losses"]) == TOTAL - k - 1
    # Both ranks saved their shards of one boundary step.
    assert len(saved) == 1, saved
    from procwatch import assert_no_orphans
    assert_no_orphans(f"TONY_APP_ID={app_id}")
    check_artifacts(tmp_path)
