"""TCP port forwarder for notebook tunneling.

Reference: ``tony-proxy/.../ProxyServer.java`` — a deliberately dumb
thread-per-connection byte pump (:32-39 accept loop, ``Proxy.run`` :50-88
two-way copy). The notebook submitter starts one locally so the user's
browser reaches a Jupyter server running inside the job
(``NotebookSubmitter.java:118-139``).
"""

from __future__ import annotations

import logging
import socket
import threading

log = logging.getLogger(__name__)


def _pump(src: socket.socket, dst: socket.socket) -> None:
    try:
        while True:
            data = src.recv(65536)
            if not data:
                break
            dst.sendall(data)
    except OSError:
        pass
    finally:
        for s in (src, dst):
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


class ProxyServer:
    """Forward ``localhost:local_port`` → ``target_host:target_port``."""

    def __init__(self, target_host: str, target_port: int,
                 local_port: int = 0):
        self.target = (target_host, target_port)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", local_port))
        self._listener.listen(16)
        self.port = self._listener.getsockname()[1]
        self._stop = threading.Event()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="proxy-accept", daemon=True)

    def start(self) -> "ProxyServer":
        self._accept_thread.start()
        log.info("proxy 127.0.0.1:%d -> %s:%d", self.port, *self.target)
        return self

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            try:
                upstream = socket.create_connection(self.target, timeout=10)
            except OSError as e:
                log.warning("proxy: connect to %s failed: %s", self.target, e)
                conn.close()
                continue
            for a, b in ((conn, upstream), (upstream, conn)):
                threading.Thread(target=_pump, args=(a, b),
                                 daemon=True).start()

    def stop(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
