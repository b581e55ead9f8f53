"""The port's alert engine and ``cli alerts`` (``tony_tpu_torch/alerts/``,
``cli/main.py``).

1. **Parity with the reference.** The same scripted samples (the CI
   fixtures' healthy and breaching expositions, in turns, under one
   injected clock) go through both packages' ``AlertEngine`` with their
   default job and fleet packs: every tick's transitions, the rows
   ``snapshot()`` gives, and the ``alerts`` table each CLI renders from
   them are the same.
2. **The fixtures** of ``tests/test_alerts.py`` through the port.
3. **``cli alerts``** on a live job (the coordinator's ``alerts`` RPC:
   the table and ``--json``) and on the finished one (the journal's
   replay).
4. **The slow drill** of ``tests/test_alerts.py``: a ``user.slow_step``
   stall fires the step-time SLO before a ``user.hang`` kills the job;
   ``diagnose`` cites it and ``cli alerts`` replays the firing set
   offline. The user script (``steps_for.py`` on the port's telemetry)
   lives in ``tmp_path``.
"""

import dataclasses
import json
import os
import threading

import pytest

from tony_tpu.alerts import rules as JAR
from tony_tpu.cli.main import _render_alert_rows as j_render_alert_rows
from tony_tpu_torch import constants
from tony_tpu_torch.alerts import rules as AR
from tony_tpu_torch.alerts.rules import AlertEngine, PromSource
from tony_tpu_torch.cli.main import _render_alert_rows
from tony_tpu_torch.cli.main import main as cli_main
from tony_tpu_torch.conf import keys as K
from tony_tpu_torch.coordinator import journal as cjournal
from tony_tpu_torch.devtools import invariants
from tony_tpu_torch.events import history

from torch_jobs import STEPS_FOR_SCRIPT, make_conf, submit, wait_for

pytestmark = pytest.mark.faults

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")


def _fixture(name):
    with open(os.path.join(FIXTURES, name)) as f:
        return f.read()


class _Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _pack(mod, which):
    return list(mod.default_job_pack() if which == "job"
                else mod.default_fleet_pack())


# ---------------------------------------------------------------------------
# 1. parity of the rule engine's rows
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["job", "fleet"])
def test_rule_rows_equal_the_reference(which):
    """Healthy, breaching (held past every rule's for-duration), then
    healthy again: both engines go pending → firing → resolved alike."""
    from tony_tpu.alerts.rules import AlertEngine as JAlertEngine
    from tony_tpu.alerts.rules import PromSource as JPromSource

    healthy, breaching = (_fixture("alerts_healthy.prom"),
                          _fixture("alerts_breaching.prom"))
    script = [(0.0, healthy), (1.0, breaching), (2.0, breaching),
              (400.0, breaching), (401.0, healthy), (402.0, breaching)]
    clk, jclk = _Clock(), _Clock()
    eng = AlertEngine(_pack(AR, which), clock=clk)
    jeng = JAlertEngine(_pack(JAR, which), clock=jclk)
    states = set()
    for t, text in script:
        clk.t = jclk.t = t
        trs = eng.evaluate(PromSource(text, now=t))
        jtrs = jeng.evaluate(JPromSource(text, now=t))
        assert [dataclasses.asdict(x) for x in trs] == \
            [dataclasses.asdict(x) for x in jtrs], t
        rows, jrows = eng.snapshot(), jeng.snapshot()
        assert rows == jrows, t
        assert eng.firing_count() == jeng.firing_count()
        doc = {"alerts": rows, "degraded": False}
        assert _render_alert_rows(doc) == j_render_alert_rows(
            {"alerts": jrows, "degraded": False})
        states |= {r["state"] for r in rows}
    # the script walks the whole state machine
    assert {"ok", "pending", "firing"} <= states


# ---------------------------------------------------------------------------
# 2. the CI fixtures through the port
# ---------------------------------------------------------------------------
def _both_packs():
    return list(AR.default_job_pack()) + list(AR.default_fleet_pack())


def test_prom_fixture_healthy_is_quiet():
    eng = AlertEngine(_both_packs(), immediate=True)
    assert eng.evaluate(PromSource(_fixture("alerts_healthy.prom"))) == []
    assert eng.firing() == []


def test_prom_fixture_breaching_fires_exactly_the_expected_set():
    eng = AlertEngine(_both_packs(), immediate=True)
    trs = eng.evaluate(PromSource(_fixture("alerts_breaching.prom")))
    assert {t.rule for t in trs if t.state == "firing"} == {
        "heartbeat-age", "journal-fsync-p99", "goodput-slo",
        "queue-wait-p99"}
    by_rule = {r["rule"]: r for r in eng.snapshot()}
    assert by_rule["quarantine-spike"]["state"] == "ok"
    assert by_rule["input-bound"]["state"] == "ok"
    assert by_rule["step-time-slo"]["state"] == "ok"
    assert by_rule["heartbeat-age"]["labels"] == {"task": "worker:0"}
    assert by_rule["heartbeat-age"]["value"] == 121.5


# ---------------------------------------------------------------------------
# 3. cli alerts, live and offline
# ---------------------------------------------------------------------------
@pytest.mark.timeout_s(170)
def test_cli_alerts_live_rows_then_journal_replay(tmp_path, capsys):
    """A running job answers from its coordinator's engine: the table has
    a row per rule of the job pack, ``--json`` the same rows. After the
    job, the journal's replay answers, with no rule left firing."""
    conf = make_conf(tmp_path, "steps_for.py", STEPS_FOR_SCRIPT, workers=1,
                     extra={K.TASK_HEARTBEAT_INTERVAL_MS: 200,
                            K.EXECUTION_ENV: "TONY_TEST_STEPS=500,"
                                             "TONY_TELEMETRY_INTERVAL_S=0.2"})
    workdir = str(tmp_path / "work")
    history_root = str(tmp_path / "history")
    result = {}

    def _run():
        _, rec, code = submit(conf, tmp_path)
        result.update(app_id=rec.app_id, code=code)

    runner = threading.Thread(target=_run, daemon=True)
    runner.start()
    jobs_dir = os.path.join(workdir, "jobs")
    app_id = wait_for(lambda: (os.listdir(jobs_dir)[:1] or [None])[0]
                      if os.path.isdir(jobs_dir) else None, what="job dir")
    wait_for(lambda: os.path.exists(os.path.join(jobs_dir, app_id,
                                                 "coordinator.addr")),
             what="coordinator address")
    names = {r.name for r in AR.default_job_pack()}

    def _live_json():
        if cli_main(["alerts", app_id, "--workdir", workdir,
                     "--json"]) != 0:
            capsys.readouterr()
            return None
        doc = json.loads(capsys.readouterr().out)
        return doc if doc.get("alerts") else None

    doc = wait_for(_live_json, timeout_s=60, what="evaluated alert rows")
    assert {r["rule"] for r in doc["alerts"]} == names
    assert cli_main(["alerts", app_id, "--workdir", workdir]) == 0
    table = capsys.readouterr().out
    assert table.splitlines()[0].split() == ["RULE", "STATE", "SEV",
                                             "VALUE", "FOR", "SERIES"]
    assert all(n in table for n in names)

    runner.join(timeout=120)
    assert not runner.is_alive(), "job did not finish"
    assert result["code"] == 0
    # Offline: the journal's replay. A healthy job journals a transition
    # only when the host's clock makes one (a heartbeat that ages on a
    # loaded host goes pending, then resolves); a SUCCEEDED job never
    # ends with a rule firing.
    assert cli_main(["alerts", app_id, "--workdir", workdir,
                     "--history-root", history_root, "--json"]) == 0
    offline = json.loads(capsys.readouterr().out)
    assert offline["offline"] is True and offline["app_id"] == app_id
    assert {r["rule"] for r in offline["alerts"]} <= names
    assert all(r["state"] != "firing" for r in offline["alerts"])
    assert cli_main(["alerts", app_id, "--workdir", workdir,
                     "--history-root", history_root]) == 0
    text = capsys.readouterr().out
    assert ("no alert transitions journaled" in text if not
            offline["alerts"] else "journal replay" in text)
    assert cli_main(["alerts", "nope", "--workdir", workdir,
                     "--history-root", history_root]) == 1


# ---------------------------------------------------------------------------
# 4. the slow drill: SLO fires BEFORE the failure, diagnose cites it
# ---------------------------------------------------------------------------
@pytest.mark.slow
def test_e2e_slow_step_slo_fires_before_hang_and_diagnose_cites_it(
        tmp_path, capsys):
    """``tests/test_alerts.py``'s acceptance drill through the port:
    ALERT_FIRING before TASK_HUNG, the REC_ALERT firing state in the
    journal, the HANG verdict citing the alert, ``cli alerts`` replaying
    the firing set offline, and ``cli check`` clean of the alert-journal
    rule on the artifact."""
    from tony_tpu_torch import diagnosis

    conf = make_conf(tmp_path, "steps_for.py", STEPS_FOR_SCRIPT, workers=1,
                     extra={
                         K.TASK_HEARTBEAT_INTERVAL_MS: 100,
                         K.TASK_PROGRESS_TIMEOUT_S: 3,
                         K.TASK_PROGRESS_WARMUP_S: 60,
                         K.TASK_HANG_DUMP_GRACE_S: 1,
                         K.APPLICATION_RETRY_COUNT: 0,
                         K.ALERTS_MIN_STEPS_PER_SEC: 5.0,
                         K.ALERTS_WINDOW_LONG_S: 2,
                         K.ALERTS_WINDOW_SHORT_S: 1,
                         K.ALERTS_FOR_S: 0.3,
                     })
    conf.set(K.EXECUTION_ENV,
             "TONY_TELEMETRY_INTERVAL_S=0.2,TONY_TEST_STEPS=1000")
    conf.set(K.fault_key("user.slow_step"), "every:1,amt:0.4")
    conf.set(K.fault_key("user.hang"), "after:6")
    client, rec, code = submit(conf, tmp_path)
    assert code == constants.EXIT_FAILURE
    assert rec.finished[0] == "FAILED"

    evs = history.read_job_events(str(tmp_path / "history"), rec.app_id)
    types = [e.type for e in evs]
    slo_idx = [i for i, e in enumerate(evs)
               if e.type == "ALERT_FIRING"
               and e.payload.get("rule") == "step-time-slo"]
    assert slo_idx, f"step-time-slo never fired; events: {types}"
    assert evs[slo_idx[0]].payload["severity"] == "page"
    assert slo_idx[0] < types.index("TASK_HUNG") \
        < types.index("APPLICATION_FINISHED")

    job_dir = str(tmp_path / "history" / "intermediate" / rec.app_id)
    st = cjournal.replay(os.path.join(job_dir, constants.JOURNAL_FILE))
    assert st.alerts.get("step-time-slo") == "firing"
    eng = AlertEngine(AR.default_job_pack())
    eng.seed(st.alerts)
    assert "step-time-slo" in {r["rule"] for r in eng.firing()}

    inc = diagnosis.load_incident(
        os.path.join(job_dir, constants.INCIDENT_FILE))
    assert inc is not None
    v = inc["verdict"]
    assert v["category"] == "HANG"
    assert any("step-time-slo" in e and "firing before the terminal"
               in e for e in v["evidence"]), v["evidence"]

    assert cli_main(["alerts", rec.app_id,
                     "--history-root", str(tmp_path / "history")]) == 0
    out = capsys.readouterr().out
    assert "step-time-slo" in out and "firing" in out

    rep = invariants.check_job_dir(job_dir)
    assert not [x for x in rep.violations if x.rule == "alert-journal"]
