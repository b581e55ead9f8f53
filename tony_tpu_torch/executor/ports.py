"""Rendezvous-port reservation.

Reference model (``ServerPort.java``/``EphemeralPort.java``/``ReusablePort.java``
+ ``resources/reserve_reusable_port.py``): the executor must pick the port it
advertises to the coordinator *before* the user process exists, then hand that
port over. Two strategies:

- **Ephemeral** (default): bind port 0, read the assigned port, close before
  exec — small race window, identical to ``EphemeralPort`` semantics and the
  release-before-exec dance (``TaskExecutor.java:224-249``).
- **Reusable**: bind with SO_REUSEPORT and *keep holding* while the user
  process binds the same port with SO_REUSEPORT too — no race. The reference
  needed a Python child process to do this from Java
  (``reserve_reusable_port.py:61-89``); in-process here since the executor is
  already Python.
"""

from __future__ import annotations

import logging
import socket
from typing import Optional

log = logging.getLogger(__name__)


class ReservedPort:
    def __init__(self, reuse: bool = False):
        self.reuse = reuse
        self._sock: Optional[socket.socket] = socket.socket(
            socket.AF_INET, socket.SOCK_STREAM)
        if reuse:
            # SO_REUSEPORT is a per-platform/per-kernel nicety, and the
            # reusable strategy is an OPTIMIZATION (no release-before-exec
            # race window). Where it's missing, degrade to the ephemeral
            # strategy with a warning instead of failing the executor —
            # the reference behaves the same by only offering ReusablePort
            # where the helper works (ReusablePort.java:151-236).
            try:
                if not hasattr(socket, "SO_REUSEPORT"):
                    raise OSError(
                        "SO_REUSEPORT not supported on this platform")
                self._sock.setsockopt(socket.SOL_SOCKET,
                                      socket.SO_REUSEPORT, 1)
            except OSError as e:
                log.warning("SO_REUSEPORT unavailable (%s); falling back "
                            "to the ephemeral port strategy", e)
                self.reuse = False
        self._sock.bind(("", 0))
        self._sock.listen(1)
        self.port: int = self._sock.getsockname()[1]

    def release(self) -> None:
        """Close the holding socket. For ephemeral ports call this just before
        exec'ing the user process; for reusable ports call after the user
        process has had a chance to bind (or at executor exit)."""
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def __enter__(self) -> "ReservedPort":
        return self

    def __exit__(self, *exc) -> None:
        self.release()
