"""The fleet acceptance drills of ``tests/test_e2e_fleet.py`` through the
port's ``cli fleet`` and daemon (slow, as the reference's are).

The reference's account follows, with the port's differences: no
compile-cache mount, and the artifact check is this file's own fixture
(``check_artifacts``: the port's ``check_tree`` and the reference's over
the same tree), since tests/conftest.py arms only ``test_e2e*`` modules.

Fleet acceptance drills (slow): the 50-job synthetic tenant mix
through ONE fleet daemon on the LocalSim substrate with virtual
executors — priorities, per-tenant quotas, preempt-to-reclaim via
elastic shrink (no victim epoch burned), a SIGKILL of the daemon
mid-drain recovered by ``tony-tpu fleet start --recover`` with zero
duplicated or lost grants — plus the warm-path drill: every tenant's
resubmit adopts from the shared warm executor pool. Driven through the real CLI
(``cli.main.main``); the auto-armed artifact fixture (tests/conftest.py)
runs ``tony-tpu check`` over every job dir AND the fleet dir these
drills leave behind.
"""

import json
import os
import signal
import sys
import time

import pytest

from tony_tpu_torch import constants
from tony_tpu_torch.cli.main import main as cli_main
from tony_tpu_torch.conf import keys as K
from tony_tpu_torch.events.events import EventType, read_events
from tony_tpu_torch.fleet.client import FleetClient

from test_torch_e2e_recovery import check_artifacts

pytestmark = pytest.mark.slow


@pytest.fixture(autouse=True)
def _artifacts(tmp_path):
    yield
    # A drill that failed midway leaves its daemon up: stop it first.
    _stop_fleet(str(tmp_path / "fleet"))
    check_artifacts(tmp_path)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TERMINAL = ("FINISHED", "FAILED", "CANCELLED")


def _virtual_conf(run_s=1.0):
    """Conf overrides for a LocalSim virtual-executor job: real
    coordinator, real RPC/journal traffic, no user processes."""
    return {
        "tony.worker.command": "virtual",
        K.SCALE_VIRTUAL_EXECUTORS: "true",
        K.SCALE_VIRTUAL_RUN_S: str(run_s),
        K.TASK_HEARTBEAT_INTERVAL_MS: "300",
        K.COORDINATOR_MONITOR_INTERVAL_MS: "100",
        K.DIAGNOSIS_ENABLED: "false",
    }


def _conf_args(overrides):
    out = []
    for k, v in sorted(overrides.items()):
        out += ["--conf", f"{k}={v}"]
    return out


def _cli_submit(fleet_dir, tenant, hosts, priority=0, min_hosts=0,
                model="", overrides=None):
    argv = ["fleet", "submit", "--dir", fleet_dir, "--tenant", tenant,
            "--hosts", str(hosts), "--priority", str(priority),
            "--min-hosts", str(min_hosts)]
    if model:
        argv += ["--model", model]
    argv += _conf_args(overrides or {})
    assert cli_main(argv) == 0


def _start_fleet(fleet_dir, recover=False, **kw):
    argv = ["fleet", "start", "--dir", fleet_dir,
            "--slices", str(kw.get("slices", 2)),
            "--hosts-per-slice", str(kw.get("hosts_per_slice", 4)),
            "--conf", f"{K.FLEET_TICK_INTERVAL_S}=0.2"]
    if kw.get("quotas"):
        argv += ["--quotas", kw["quotas"]]
    if kw.get("pool_dir"):
        argv += ["--pool-dir", kw["pool_dir"]]
    if recover:
        argv.append("--recover")
    assert cli_main(argv) == 0


def _wait(pred, timeout_s, what, interval=0.25):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {what}")


def _snapshot(fleet_dir):
    try:
        with open(os.path.join(fleet_dir, constants.FLEET_STATUS_FILE),
                  encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _rows(fleet_dir):
    return {r["job"]: r for r in _snapshot(fleet_dir).get("jobs", [])}


def _stop_fleet(fleet_dir):
    try:
        c = FleetClient(fleet_dir)
        c.stop()
        c.close()
    except Exception:  # noqa: BLE001 — already gone is fine
        pass
    # wait for the addr file to vanish (daemon teardown finished) so a
    # following test never races the dying process
    deadline = time.monotonic() + 15
    addr = os.path.join(fleet_dir, constants.FLEET_ADDR_FILE)
    while os.path.exists(addr) and time.monotonic() < deadline:
        time.sleep(0.1)


@pytest.mark.timeout_s(570)
def test_fleet_50_job_tenant_mix_preempt_kill_recover(tmp_path):
    """THE acceptance drill: 50 jobs, 3 tenants, mixed
    priorities and sub-slice sizes, one 8-host pool; a high-priority
    arrival preempts-to-reclaim via elastic shrink (the victim keeps its
    epoch and grows back); the quota-capped tenant queues without
    starving the others; the daemon is SIGKILLed mid-drain and
    `tony-tpu fleet start --recover` resumes the same queue state with
    zero duplicated or lost grants; everything drains FINISHED."""
    fleet_dir = str(tmp_path / "fleet")
    _start_fleet(fleet_dir, slices=2, hosts_per_slice=4,
                 quotas="capped=2")

    # -- phase 1: preempt-to-reclaim -----------------------------------
    # a whole-pool low-priority elastic victim...
    _cli_submit(fleet_dir, "bulk", 8, priority=0, min_hosts=2,
                overrides=_virtual_conf(run_s=12.0))
    victim = "fj-0001"
    _wait(lambda: _rows(fleet_dir).get(victim, {}).get("state")
          == "RUNNING", 60, "victim running")
    _wait(lambda: _rows(fleet_dir).get(victim, {}).get("app_id"), 30,
          "victim app discovered")
    # ...then a high-priority 4-host job into the FULL pool
    _cli_submit(fleet_dir, "prod", 4, priority=10,
                overrides=_virtual_conf(run_s=1.0))
    hi = "fj-0002"
    # the victim is shrunk (8→4) through its coordinator's elastic
    # resize — not killed — and the demander runs on the reclaimed hosts
    _wait(lambda: _rows(fleet_dir).get(victim, {}).get("hosts") == 4,
          90, "victim shrunk to 4")
    _wait(lambda: _rows(fleet_dir).get(hi, {}).get("state")
          == "RUNNING", 60, "high-priority job granted")
    _wait(lambda: _rows(fleet_dir).get(hi, {}).get("state")
          == "FINISHED", 90, "high-priority job finished")
    # the loan is repaid: the victim grows back toward 8
    _wait(lambda: _rows(fleet_dir).get(victim, {}).get("hosts") == 8,
          90, "victim restored to 8")

    # -- phase 2: the 48-job mix + SIGKILL/recover ---------------------
    sizes = [1, 2, 3, 4]
    n_submitted = 2
    for i in range(40):
        tenant = "alpha" if i % 2 == 0 else "bravo"
        _cli_submit(fleet_dir, tenant, sizes[i % 4], priority=i % 3,
                    overrides=_virtual_conf(run_s=0.6))
        n_submitted += 1
    for i in range(8):
        _cli_submit(fleet_dir, "capped", 1 + i % 2,
                    overrides=_virtual_conf(run_s=0.6))
        n_submitted += 1
    assert n_submitted == 50

    # while capped is at quota, OTHER tenants keep being granted — the
    # no-starvation shape, observed live
    def quota_blocked_while_others_run():
        rows = _rows(fleet_dir).values()
        capped_blocked = any(r["tenant"] == "capped"
                             and r["state"] == "QUEUED"
                             and "quota" in (r.get("denial") or "")
                             for r in rows)
        others_running = any(r["tenant"] in ("alpha", "bravo")
                             and r["state"] == "RUNNING" for r in rows)
        return capped_blocked and others_running
    _wait(quota_blocked_while_others_run, 120,
          "quota-capped tenant queueing while others run")
    # the capped tenant never exceeds its 2-host quota
    snap = _snapshot(fleet_dir)
    assert (snap["tenants"].get("capped") or {}).get("used", 0) <= 2

    # -- the decision explainer names the quota blocker ----------------
    held_row = next(r for r in _rows(fleet_dir).values()
                    if r["tenant"] == "capped" and r["state"] == "QUEUED"
                    and "quota" in (r.get("held") or r.get("denial")
                                    or ""))
    c = FleetClient(fleet_dir)
    try:
        explained = c.explain(held_row["job"])
    finally:
        c.close()
    assert explained["ok"], explained
    quota_holds = [d for d in explained["decisions"]
                   if d["action"] == "quota"]
    assert quota_holds, explained["decisions"]
    # the blocker is NAMED: the capped tenant's own running job(s)
    assert quota_holds[-1]["blocking"], quota_holds[-1]
    # the CLI renders the causal timeline (exit 0 through main())
    assert cli_main(["fleet", "explain", held_row["job"],
                     "--dir", fleet_dir]) == 0
    # fleet diagnose (offline rule engine over journal + ledger): the
    # capped mix reads as QUOTA_SATURATED, evidence-backed
    from tony_tpu_torch.fleet import diagnose as fdiagnose

    incident = fdiagnose.build_incident(
        fdiagnose.bundle_from_dir(fleet_dir))
    assert incident["verdict"]["category"] == "QUOTA_SATURATED", \
        incident["verdict"]
    assert any("capped" in e for e in incident["verdict"]["evidence"])
    assert cli_main(["fleet", "diagnose", "--dir", fleet_dir]) == 0
    # the daemon's own periodic incident export agrees on the verdict
    live_incident = fdiagnose.load_incident(fleet_dir)
    assert live_incident is not None
    assert live_incident["verdict"]["category"] in (
        "QUOTA_SATURATED", "STARVATION")

    # SIGKILL the daemon mid-drain...
    with open(os.path.join(fleet_dir, constants.FLEET_ADDR_FILE)) as f:
        daemon_pid = json.load(f)["pid"]
    os.kill(daemon_pid, signal.SIGKILL)
    time.sleep(1.0)
    before = _rows(fleet_dir)          # last exported snapshot
    # ...and recover through the real CLI: same queue state replays
    _start_fleet(fleet_dir, recover=True, slices=2, hosts_per_slice=4,
                 quotas="capped=2")
    after = _rows(fleet_dir)
    assert set(after) == set(before)
    for job, row in before.items():
        if row["state"] in TERMINAL:
            assert after[job]["state"] == row["state"], job

    # the whole mix drains
    def all_done():
        rows = _rows(fleet_dir)
        return len(rows) == 50 and all(
            r["state"] in TERMINAL for r in rows.values())
    _wait(all_done, 300, "all 50 jobs terminal", interval=1.0)
    rows = _rows(fleet_dir)
    bad = {j: r["state"] for j, r in rows.items()
           if r["state"] != "FINISHED"}
    assert not bad, f"non-FINISHED jobs: {bad}"

    # zero duplicated grants: every fleet job ran EXACTLY one app
    for job in rows:
        jobs_dir = os.path.join(fleet_dir, "jobs", job, "jobs")
        assert len(os.listdir(jobs_dir)) == 1, job

    # no victim epoch burned: the preempted job's session journal holds
    # a single epoch, and its event stream shows completed resizes
    victim_app = rows[victim]["app_id"]
    victim_dir = os.path.join(fleet_dir, "history", "intermediate",
                              victim_app)
    if not os.path.isdir(victim_dir):
        from tony_tpu_torch.events import history as hist_mod

        victim_dir = hist_mod.list_job_dirs(
            os.path.join(fleet_dir, "history"))[victim_app]
    epochs = set()
    with open(os.path.join(victim_dir, constants.JOURNAL_FILE),
              "rb") as f:
        for line in f.read().splitlines():
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("t") == "epoch":
                epochs.add(rec.get("session"))
    assert epochs == {0}, f"victim burned epochs: {epochs}"
    hist_file = next((os.path.join(victim_dir, n)
                      for n in os.listdir(victim_dir)
                      if n.endswith(constants.EVENTS_SUFFIX)), None)
    assert hist_file, "victim history never finalized"
    resized = [e for e in read_events(hist_file)
               if e.type == EventType.GANG_RESIZED
               and e.payload.get("phase") == "completed"]
    assert len(resized) >= 2          # the shrink AND the grow-back

    # the real-CLI status surface renders the drained fleet (incl. the
    # per-tenant goodput column riding the ledger rollup)
    assert cli_main(["fleet", "status", "--dir", fleet_dir]) == 0
    snap = _snapshot(fleet_dir)
    fleet_led = (snap.get("ledger") or {}).get("fleet") or {}
    assert fleet_led.get("goodput_fraction") is not None
    assert fleet_led.get("held_chip_s", 0) > 0
    _stop_fleet(fleet_dir)

    # -- one --fleet Perfetto export stitches the whole pool -----------
    out_path = str(tmp_path / "fleet_trace.json")
    assert cli_main(["trace", "--fleet", fleet_dir,
                     "--out", out_path]) == 0
    with open(out_path, encoding="utf-8") as f:
        payload = json.load(f)
    # queue → grant → run → preempt, one shared fleet trace id, ZERO
    # unclosed spans across the daemon (SIGKILLed + recovered life
    # included) and every job's stitched tree
    assert payload["traceId"], "no fleet trace id"
    assert payload["unclosedSpans"] == [], payload["unclosedSpans"]
    x_names = {e["name"] for e in payload["traceEvents"]
               if e.get("ph") == "X"}
    assert {"fleet.queue", "fleet.job", "client.submit",
            "coordinator.run"} <= x_names, sorted(x_names)[:40]
    i_names = {e["name"] for e in payload["traceEvents"]
               if e.get("ph") == "i"}
    assert "fleet.preempt" in i_names
    # every fleet-spawned job adopted the ONE fleet trace id
    trace_ids = {e["args"].get("trace") for e in payload["traceEvents"]
                 if e.get("ph") == "X" and e["args"].get("trace")}
    assert trace_ids == {payload["traceId"]}, trace_ids

    # -- fleet time machine: the recorded drill parity-replays ---------
    # Every grant and preemption the daemon journaled across this run —
    # quota holds, the priority preempt, the SIGKILL + recovery replay —
    # must come back bit-for-bit when the journal is re-executed through
    # the policy engine offline (simulator and daemon share ONE brain).
    # Decision-reason wording may drift across the recovery boundary
    # (soft notes); the grant/preempt gate may not.
    from tony_tpu_torch.fleet import simulator as fsim
    from tony_tpu_torch.fleet import timeline as ftimeline

    par = fsim.parity_replay(ftimeline.load(fleet_dir))
    assert par["supported"], par.get("reason")
    assert par["gate_ok"], par["mismatches"]
    assert par["counts"]["grant"] == 50, par["counts"]
    # ...and the what-if CLI folds the same journal into a
    # counterfactual report (quota bump on the capped tenant)
    assert cli_main(["fleet", "whatif", "--dir", fleet_dir,
                     "--quota", "capped=4", "--json"]) == 0


@pytest.mark.timeout_s(420)
def test_fleet_warm_pool_and_shared_cache_for_every_tenant(tmp_path):
    """The warm-path drill: with the fleet pointing every grant at a
    shared warm executor pool, BOTH tenants' resubmits adopt pre-warmed
    executors (pool-exit reports in their task dirs prove adoption) —
    the warm path is fleet-wide, not first-tenant-only. The reference's
    per-model compile-cache mount has no counterpart in the port: no
    job's frozen conf carries one."""
    pool_dir = str(tmp_path / "pool")
    fleet_dir = str(tmp_path / "fleet")
    # a real (non-virtual) executor pool — no jax preload, these are
    # trivial exit-0 jobs
    assert cli_main(["pool", "start", "--dir", pool_dir, "--size", "2",
                     "--preload", ""]) == 0
    try:
        _start_fleet(fleet_dir, slices=1, hosts_per_slice=2,
                     pool_dir=pool_dir)
        script = os.path.join(REPO, "tests", "scripts", "exit_0.py")
        overrides = {
            "tony.worker.command": f"{sys.executable} {script}",
            K.TASK_HEARTBEAT_INTERVAL_MS: "300",
            K.COORDINATOR_MONITOR_INTERVAL_MS: "100",
            K.DIAGNOSIS_ENABLED: "false",
        }
        jobs = []
        for tenant in ("teamA", "teamB"):
            for resubmit in range(2):
                _cli_submit(fleet_dir, tenant, 1, model="shared-model",
                            overrides=overrides)
                jobs.append(f"fj-{len(jobs) + 1:04d}")

        def all_done():
            rows = _rows(fleet_dir)
            return len(rows) == 4 and all(
                r["state"] in TERMINAL for r in rows.values())
        _wait(all_done, 240, "all 4 jobs terminal", interval=0.5)
        rows = _rows(fleet_dir)
        assert all(r["state"] == "FINISHED" for r in rows.values()), rows

        adopted_jobs = []
        for job, row in rows.items():
            app_dir = os.path.join(fleet_dir, "jobs", job, "jobs",
                                   row["app_id"])
            # no per-model compile cache is injected: the key keeps
            # its registry default
            with open(os.path.join(app_dir,
                                   constants.FINAL_CONFIG_FILE)) as f:
                frozen = json.load(f)
            assert frozen[K.JAX_COMPILE_CACHE_DIR] == \
                K.registry()[K.JAX_COMPILE_CACHE_DIR].default, job
            # adoption proof: a pooled executor writes pool-exit.json
            # into its task workdir (cold spawns never do)
            tasks_dir = os.path.join(app_dir, "tasks")
            for task in os.listdir(tasks_dir):
                if os.path.exists(os.path.join(
                        tasks_dir, task, constants.POOL_EXIT_FILE)):
                    adopted_jobs.append(job)
        # EVERY tenant adopted at least once — and in particular the
        # resubmits (the later submissions) ride the warm path
        by_tenant = {t: [j for j in adopted_jobs
                         if rows[j]["tenant"] == t]
                     for t in ("teamA", "teamB")}
        for t, adopted in sorted(by_tenant.items()):
            assert adopted, f"tenant {t} never adopted a warm executor " \
                            f"(adopted: {adopted_jobs})"
        _stop_fleet(fleet_dir)
    finally:
        cli_main(["pool", "stop", "--dir", pool_dir])
