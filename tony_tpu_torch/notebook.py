"""Notebook mode: run a notebook/server command as a single-node job and
tunnel a local port to it.

Reference: ``NotebookSubmitter.java`` — Jupyter as a single-container app
(:46), poll TaskInfos for the notebook task's endpoint, then start a local
``ProxyServer`` so the user's browser reaches it (:118-139). Here the
"container" is the coordinator-local single-node path
(``Coordinator._do_local_job``): the command runs with ``TB_PORT`` set to
a reserved port and the coordinator registers ``http://host:port`` as the
job's url, which the client sees in every application report.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional
from urllib.parse import urlparse

from tony_tpu_torch.client import TaskUpdateListener, TonyTpuClient
from tony_tpu_torch.conf import keys as K
from tony_tpu_torch.proxy import ProxyServer

log = logging.getLogger(__name__)

# --ip=0.0.0.0: the registered url and the proxy target the HOSTNAME
# (the notebook may run on a remote coordinator host), so loopback-only
# binding would make the tunnel connect-refused on any multi-homed host.
DEFAULT_NOTEBOOK_CMD = (
    "jupyter notebook --no-browser --ip=0.0.0.0 --port=$TB_PORT "
    "--NotebookApp.token='' --NotebookApp.password=''")


class NotebookProxyListener(TaskUpdateListener):
    """Starts the local proxy as soon as the report carries the server
    url; fires ``ready`` with the proxied local port."""

    def __init__(self, local_port: int = 0):
        self.local_port = local_port
        self.proxy: Optional[ProxyServer] = None
        self.ready = threading.Event()

    def on_application_report(self, report: dict) -> None:
        url = report.get("tb_url") or ""
        if not url or self.proxy is not None:
            return
        p = urlparse(url)
        if not p.hostname or not p.port:
            log.warning("notebook url %r has no host:port", url)
            return
        self.proxy = ProxyServer(p.hostname, p.port,
                                 local_port=self.local_port).start()
        print(f"notebook available at http://127.0.0.1:{self.proxy.port} "
              f"(proxied to {p.hostname}:{p.port})")
        self.ready.set()

    def on_application_finished(self, status: str, report: dict) -> None:
        if self.proxy is not None:
            self.proxy.stop()


def submit_notebook(conf, workdir: Optional[str] = None,
                    command: str = "", local_port: int = 0,
                    extra_listener: Optional[TaskUpdateListener] = None
                    ) -> int:
    """Submit the notebook job and block until it ends (the user stops the
    server / kills the CLI). Returns the job exit code."""
    conf.set(K.COORDINATOR_COMMAND, command or DEFAULT_NOTEBOOK_CMD)
    client = TonyTpuClient(conf, workdir=workdir)
    client.add_listener(NotebookProxyListener(local_port))
    if extra_listener is not None:
        client.add_listener(extra_listener)
    return client.start()
