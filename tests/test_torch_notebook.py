"""Notebook mode and the proxy through the port
(``tony_tpu_torch/notebook.py``, ``proxy.py``, ``cli notebook``): the two
cases of ``tests/test_notebook.py`` (an HTTP echo server submitted as the
"notebook", reached through the local tunnel from the application
report's url; force_kill reaching the server itself), and ``cli notebook``
driving the same path to the same bytes. ``tests/scripts/
notebook_http_server.py`` imports neither package, so both packages' tests
share it."""

import os
import sys
import threading
import urllib.request

from tony_tpu_torch.conf.config import TonyTpuConfig
from tony_tpu_torch.conf import keys as K
from tony_tpu_torch.notebook import NotebookProxyListener
from tony_tpu_torch.proxy import ProxyServer

SCRIPTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts")


def test_proxy_forwards_bytes():
    import http.server

    class H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            body = b"direct"
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), H)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    proxy = ProxyServer("127.0.0.1", srv.server_port).start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{proxy.port}/", timeout=10) as r:
            assert r.read() == b"direct"
    finally:
        proxy.stop()
        srv.shutdown()


def test_e2e_notebook_reachable_through_proxy(tmp_path):
    conf = TonyTpuConfig()
    conf.set(K.APPLICATION_TIMEOUT_S, 60)
    conf.set(K.HISTORY_LOCATION, str(tmp_path / "history"))
    conf.set(K.CLIENT_POLL_INTERVAL_MS, 100)
    conf.set(K.COORDINATOR_MONITOR_INTERVAL_MS, 100)

    # Drive the client directly with our own NotebookProxyListener so the
    # test can observe readiness (submit_notebook wires the same pieces).
    from tony_tpu_torch.client import TonyTpuClient

    listener = NotebookProxyListener()
    result = {}
    conf.set(K.COORDINATOR_COMMAND,
             f"{sys.executable} "
             f"{os.path.join(SCRIPTS, 'notebook_http_server.py')}")
    client = TonyTpuClient(conf, workdir=str(tmp_path / "work"))
    client.add_listener(listener)
    t = threading.Thread(target=lambda: result.update(code=client.start()),
                         daemon=True)
    t.start()
    try:
        assert listener.ready.wait(timeout=60), "proxy never came up"
        # The url is registered just before the server process starts, so
        # the first connect can race the bind — retry briefly.
        body = None
        for _ in range(40):
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{listener.proxy.port}/",
                        timeout=10) as r:
                    body = r.read()
                break
            except (urllib.error.URLError, ConnectionError, OSError):
                import time
                time.sleep(0.25)
        assert body == b"tony-notebook-ok"
    finally:
        client.force_kill()
        t.join(timeout=30)
    # killed by us after successful tunneling — any terminal outcome is
    # fine; what matters is the bytes made the round trip
    assert not t.is_alive()
    # force_kill must reach the notebook server itself (the
    # _do_local_job stop-watcher + user-pgid ladder), not just the
    # coordinator — the leak class the round-3 review caught live.
    from procwatch import assert_no_orphans
    assert_no_orphans(f"TONY_APP_ID={client.app_id}")


def test_cli_notebook_tunnels_to_the_server(tmp_path):
    """``cli notebook --command ...``: the verb submits the server as the
    coordinator's local job and prints the proxy's address; a GET through
    it returns the server's bytes. ``cli kill`` then ends the job, the
    notebook verb returns on its own, and no process of the job is left."""
    import re
    import subprocess
    import time

    from tony_tpu_torch.cli.main import main as cli_main

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    workdir = str(tmp_path / "work")
    cmd = [sys.executable, "-u", "-m", "tony_tpu_torch.cli", "notebook",
           "--workdir", workdir,
           "--command", f"{sys.executable} "
                        f"{os.path.join(SCRIPTS, 'notebook_http_server.py')}",
           "--conf", f"{K.HISTORY_LOCATION}={tmp_path / 'history'}",
           "--conf", f"{K.APPLICATION_TIMEOUT_S}=60",
           "--conf", f"{K.CLIENT_POLL_INTERVAL_MS}=100"]
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    lines, port = [], None
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and port is None:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            m = re.search(r"127\.0\.0\.1:(\d+)", line)
            port = int(m.group(1)) if m else None
        assert port, "".join(lines)
        body = None
        for _ in range(40):
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                            timeout=10) as r:
                    body = r.read()
                break
            except (urllib.error.URLError, ConnectionError, OSError):
                time.sleep(0.25)
        assert body == b"tony-notebook-ok"
        (app_id,) = os.listdir(os.path.join(workdir, "jobs"))
        assert cli_main(["kill", app_id, "--workdir", workdir]) == 0
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            import signal

            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=30)
        proc.stdout.close()
    from procwatch import assert_no_orphans
    assert_no_orphans(f"TONY_APP_ID={app_id}")
