"""The port's portal (``tony_tpu_torch/portal/``): the nine scenarios of
``tests/test_portal.py`` over a job finished through the port's control
plane (framework ``pytorch``, the user script written into ``tmp_path``),
the portal cases of ``tests/test_tls.py`` (HTTPS through the port's
``rpc.wire``) and ``tests/test_diagnosis.py`` (the ``/diagnose`` view, the
seek-based ``/logfile`` tail) over the reference's golden job dirs, plus
one check across the packages: the reference's ``PortalServer`` and the
port's serve the same finished job's history root, and every JSON view
(``/``, ``/config``, ``/jobs``, ``/metrics``, ``/profile``, ``/trace``,
``/diagnose``) answers with the same body from both.
"""

import json
import os
import shutil
import ssl
import subprocess
import urllib.error
import urllib.request

import pytest

from tony_tpu.portal import PortalServer as JPortalServer
from tony_tpu_torch import constants, diagnosis
from tony_tpu_torch.events import history
from tony_tpu_torch.portal import PortalServer

from test_diagnosis import _fin, _patch_log_path, golden_job
from torch_jobs import EXIT_0_SCRIPT, make_conf, submit


@pytest.fixture(scope="module")
def finished_job(tmp_path_factory):
    """Run one real job to completion so the portal has authentic history."""
    tmp_path = tmp_path_factory.mktemp("portal-job")
    conf = make_conf(tmp_path, "exit_0.py", EXIT_0_SCRIPT, workers=2)
    client, rec, code = submit(conf, tmp_path)
    assert code == 0
    return str(tmp_path / "history"), rec.app_id


@pytest.fixture(scope="module")
def portal(finished_job):
    root, _ = finished_job
    srv = PortalServer(root, port=0, mover_interval_s=3600,
                       purger_interval_s=3600)
    srv.start()
    yield srv
    srv.stop()


def _get(url, as_json=True):
    with urllib.request.urlopen(url, timeout=10) as r:
        data = r.read()
    return json.loads(data) if as_json else data.decode()


def test_jobs_index(portal, finished_job):
    _, app_id = finished_job
    rows = _get(f"{portal.url}/?format=json")
    assert any(r["app_id"] == app_id and r["status"] == "SUCCEEDED"
               for r in rows)
    html_page = _get(portal.url + "/", as_json=False)
    assert app_id in html_page


def test_config_view(portal, finished_job):
    _, app_id = finished_job
    conf = _get(f"{portal.url}/config/{app_id}?format=json")
    assert conf["tony.worker.instances"] == 2
    assert "tony.worker.command" in conf


def test_events_view(portal, finished_job):
    _, app_id = finished_job
    evs = _get(f"{portal.url}/jobs/{app_id}?format=json")
    types = [e["type"] for e in evs]
    assert types[0] == "APPLICATION_INITED"
    assert types[-1] == "APPLICATION_FINISHED"
    assert types.count("TASK_FINISHED") == 2


def test_logs_view_and_logfile(portal, finished_job):
    _, app_id = finished_job
    logs = _get(f"{portal.url}/logs/{app_id}?format=json")
    assert len(logs) == 4  # 2 tasks x (stdout, stderr)
    body = _get(portal.url + logs[0]["url"], as_json=False)
    assert isinstance(body, str)


def test_unknown_job_404(portal):
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(f"{portal.url}/jobs/nope?format=json")
    assert e.value.code == 404


def test_mover_then_views_still_work(portal, finished_job):
    """After the mover relocates the job to finished/yyyy/MM/dd, every view
    must keep resolving it (reference HistoryFileMover.java:74-121)."""
    root, app_id = finished_job
    moved = history.HistoryFileMover(root).move_once()
    assert moved, "mover should have relocated the finished job"
    portal.cache._data.clear()
    rows = _get(f"{portal.url}/?format=json")
    assert any(r["app_id"] == app_id for r in rows)
    conf = _get(f"{portal.url}/config/{app_id}?format=json")
    assert conf["tony.worker.instances"] == 2


def test_profiles_view_empty_and_unknown(portal, finished_job):
    """No traces captured → empty list (json) / friendly message (html);
    unknown job → 404."""
    _, app_id = finished_job
    assert _get(f"{portal.url}/profiles/{app_id}?format=json") == []
    html_body = _get(f"{portal.url}/profiles/{app_id}", as_json=False)
    assert "no traces captured" in html_body
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(f"{portal.url}/profiles/app_does_not_exist?format=json")
    assert e.value.code == 404


def test_metrics_view(portal, finished_job):
    """/metrics/<job>: per-task TASK_FINISHED metrics table."""
    _, app_id = finished_job
    rows = _get(f"{portal.url}/metrics/{app_id}?format=json")
    assert len(rows) == 2   # both workers reported
    assert all("task" in r and isinstance(r["metrics"], dict) for r in rows)
    assert all(r["metrics"].get("MAX_MEMORY_BYTES", 0) > 0 for r in rows)
    html_page = _get(f"{portal.url}/metrics/{app_id}", as_json=False)
    assert "MAX_MEMORY_BYTES" in html_page


def test_portal_bearer_auth(finished_job):
    """Optional bearer token: 401 without it, full service with it; a
    non-ASCII header is a 401, not a failed request (the comparison is on
    bytes)."""
    root, app_id = finished_job
    srv = PortalServer(root, port=0, mover_interval_s=3600,
                       purger_interval_s=3600, token="portal-tok")
    srv.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(f"{srv.url}/?format=json")
        assert e.value.code == 401
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(urllib.request.Request(
                f"{srv.url}/?format=json",
                headers={"Authorization": "Bearer pörtal"}),
                timeout=10)
        assert e.value.code == 401
        req = urllib.request.Request(
            f"{srv.url}/?format=json",
            headers={"Authorization": "Bearer portal-tok"})
        with urllib.request.urlopen(req, timeout=10) as r:
            rows = json.loads(r.read())
        assert any(r["app_id"] == app_id for r in rows)
    finally:
        srv.stop()


def test_json_views_equal_the_reference_portals(finished_job, tmp_path):
    """Both packages' portals over one copy of the port job's history
    root (with a capture dir in it, so /profile lists something): every
    JSON view's body is the same."""
    root, app_id = finished_job
    copy = str(tmp_path / "history")
    shutil.copytree(root, copy)
    job_dir = history.list_job_dirs(copy)[app_id]
    capture = os.path.join(job_dir, "profile", "ondemand-1")
    os.makedirs(capture)
    with open(os.path.join(capture, "trace.json"), "w") as f:
        json.dump({"traceEvents": []}, f)
    views = ["/", f"/config/{app_id}", f"/jobs/{app_id}",
             f"/metrics/{app_id}", f"/profile/{app_id}",
             f"/trace/{app_id}", f"/diagnose/{app_id}"]
    bodies = {}
    for name, cls in (("port", PortalServer), ("reference", JPortalServer)):
        srv = cls(copy, port=0, mover_interval_s=3600,
                  purger_interval_s=3600)
        srv.start()
        try:
            bodies[name] = {v: _get(f"{srv.url}{v}?format=json")
                            for v in views}
        finally:
            srv.stop()
    # a succeeded job has no incident.json: each portal diagnoses it on
    # the request, and stamps the time it did
    for b in bodies.values():
        assert b[f"/diagnose/{app_id}"].pop("generated_ms") > 0
    for v in views:
        assert bodies["port"][v] == bodies["reference"][v], v
    assert [t["name"] for t in bodies["port"][f"/profile/{app_id}"]] \
        == ["ondemand-1"]
    assert bodies["port"][f"/trace/{app_id}"]["traceEvents"]


def test_portal_serves_https(tmp_path):
    """``tls_cert`` / ``tls_key``: HTTPS through the port's
    ``rpc.wire.server_tls_context``; plaintext HTTP is refused."""
    cert, key = str(tmp_path / "cert.pem"), str(tmp_path / "key.pem")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", key, "-out", cert, "-days", "1",
         "-subj", "/CN=tony-tpu-test"],
        check=True, capture_output=True)
    srv = PortalServer(str(tmp_path), port=0, host="127.0.0.1",
                       tls_cert=cert, tls_key=key)
    srv.start()
    try:
        assert srv.url.startswith("https://")
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_REQUIRED
        ctx.load_verify_locations(cert)
        with urllib.request.urlopen(f"https://127.0.0.1:{srv.port}/",
                                    context=ctx, timeout=10) as r:
            assert r.status == 200
        with pytest.raises(Exception):
            urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/", timeout=5)
    finally:
        srv.stop()


def test_portal_diagnose_view(tmp_path):
    """A finished job's incident.json is served; HTML and JSON from the
    same document; an unknown job is a 404."""
    dump = "Current thread 0x1 (most recent call first):\n  File \"t.py\""
    job, _ = golden_job(
        tmp_path, "app_portal",
        [("TASK_HUNG", {"task": "worker:0", "steps": 2, "stalled_s": 5.0,
                        "timeout_s": 3}, 3000),
         ("TASK_FINISHED", {"task": "worker:0", "exit_code": 137,
                            "status": "KILLED",
                            "failure_domain": "INFRA_TRANSIENT",
                            "reason": "task worker:0 hung",
                            "stack_dump_excerpt": dump, "logs": []}, 4000),
         _fin("app_portal", "task worker:0 hung", "INFRA_TRANSIENT")])
    incident = diagnosis.diagnose_job_dir(job, app_id="app_portal")
    diagnosis.save_incident(os.path.join(job, constants.INCIDENT_FILE),
                            incident)
    srv = PortalServer(str(tmp_path / "history"), port=0,
                       mover_interval_s=3600, purger_interval_s=3600)
    srv.start()
    try:
        doc = _get(f"{srv.url}/diagnose/app_portal?format=json")
        assert doc["verdict"]["category"] == "HANG"
        assert doc["verdict"]["blamed_task"] == "worker:0"
        page = _get(f"{srv.url}/diagnose/app_portal", as_json=False)
        assert "HANG" in page and "worker:0" in page
        assert "stack dump excerpt" in page
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{srv.url}/diagnose/nope", timeout=10)
        assert e.value.code == 404
    finally:
        srv.stop()


def test_portal_logfile_tail_param(tmp_path):
    """/logfile/<job>/<i> serves a seek-based tail honouring ?tail=N; a
    bad value is a 400."""
    big = "A" * 50_000 + "TAIL-SENTINEL"
    job, paths = golden_job(
        tmp_path, "app_logs",
        [("TASK_FINISHED", {"task": "worker:0", "exit_code": 1,
                            "status": "FAILED",
                            "failure_domain": "USER_ERROR",
                            "logs": ["<stderr>"]}, 2000),
         _fin("app_logs", "boom", "USER_ERROR")],
        logs={"stderr.log": big})
    _patch_log_path(job, "<stderr>", paths["stderr.log"])
    srv = PortalServer(str(tmp_path / "history"), port=0,
                       mover_interval_s=3600, purger_interval_s=3600)
    srv.start()
    try:
        body = _get(f"{srv.url}/logfile/app_logs/0?tail=100", as_json=False)
        assert len(body) == 100 and body.endswith("TAIL-SENTINEL")
        with urllib.request.urlopen(
                f"{srv.url}/logfile/app_logs/0", timeout=10) as r:
            assert len(r.read()) == len(big)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(
                f"{srv.url}/logfile/app_logs/0?tail=bogus", timeout=10)
        assert e.value.code == 400
    finally:
        srv.stop()
