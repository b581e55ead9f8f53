"""GCE/TPU-VM preemption-notice watcher: turn the platform's advance
warning into the kill chain's TERM-grace path.

Preemptible/spot TPU VMs get an advance notice before the machine is
reclaimed: the metadata server's ``instance/preempted`` value flips to
``TRUE`` (readable with ``?wait_for_change=true`` as a hanging GET).
Without a watcher that warning is wasted and the job experiences
preemption as sudden SIGKILL — resume rolls back to the last periodic
checkpoint. With it, the executor delivers SIGTERM to the user process
group the moment the notice lands, so a
``CheckpointManager.install_preemption_handler`` save runs inside the
warning window and the retried job resumes at the exact step.

The reference has no analogue (YARN nodes aren't preemptible mid-lease
the way spot TPU VMs are); the closest is its decommission handling via
NM shutdown. This is the TPU-native completion of the story:

    metadata notice → SIGTERM user group → final durable save →
    host dies → slice lease invalid → coordinator retries on a fresh
    lease → script restores latest_step().

Off-GCP the first metadata probe fails (no such host) and the watcher
disables itself silently — zero cost outside the cloud. Tests point
``TONY_METADATA_ENDPOINT`` at an in-process HTTP server.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
from typing import Callable, Optional
from urllib import error as urlerror
from urllib import request as urlrequest

log = logging.getLogger(__name__)

METADATA_ENDPOINT_ENV = "TONY_METADATA_ENDPOINT"
#: set to "0" to disable the watcher entirely
PREEMPTION_WATCH_ENV = "TONY_PREEMPTION_WATCH"
_DEFAULT_ENDPOINT = "http://metadata.google.internal"
_PREEMPTED_PATH = "/computeMetadata/v1/instance/preempted"


class PreemptionWatcher(threading.Thread):
    """Daemon thread: hanging-GET the preempted flag; fire once on TRUE.

    ``on_preempt`` runs on this thread exactly once. The default action
    (see ``start_for_executor``) TERMs the user process group — the same
    signal path as a graceful teardown, so everything downstream
    (handler saves, exit-code reporting, retry) is already tested.
    """

    def __init__(self, on_preempt: Callable[[], None],
                 endpoint: Optional[str] = None,
                 poll_interval_s: float = 5.0):
        super().__init__(name="tony-preemption-watcher", daemon=True)
        self.endpoint = (endpoint
                         or os.environ.get(METADATA_ENDPOINT_ENV)
                         or _DEFAULT_ENDPOINT).rstrip("/")
        self._on_preempt = on_preempt
        self._poll_interval_s = poll_interval_s
        self._stop_evt = threading.Event()
        self.fired = False

    def _probe(self, wait: bool, etag: str = ""):
        """(value, etag). With ``wait`` + a last_etag, GCE parks the GET
        until the value CHANGES FROM THAT ETAG — closing the race where
        the flag flips between a plain read and the next hanging GET (a
        hang keyed only on "next change" would then wait forever while
        the ~30 s spot warning burns)."""
        q = ""
        if wait:
            q = "?wait_for_change=true" + (
                f"&last_etag={etag}" if etag else "")
        req = urlrequest.Request(self.endpoint + _PREEMPTED_PATH + q,
                                 headers={"Metadata-Flavor": "Google"})
        with urlrequest.urlopen(req, timeout=300 if wait else 5) as r:
            return (r.read().decode().strip().upper(),
                    r.headers.get("ETag", "") or "")

    @staticmethod
    def _decisively_absent(err: Exception) -> bool:
        """No-such-host / connection-refused = not on GCE (normal, stay
        quiet); anything else may be a transient on a real TPU VM and
        must NOT silently disable spot protection."""
        import socket as socketlib

        reason = getattr(err, "reason", err)
        return isinstance(reason, (socketlib.gaierror,
                                   ConnectionRefusedError))

    def _initial_probe(self):
        failures = 0
        while not self._stop_evt.is_set():
            try:
                return self._probe(wait=False)
            except (urlerror.URLError, OSError, ValueError) as e:
                if self._decisively_absent(e):
                    log.debug("no metadata server at %s; preemption "
                              "watcher off", self.endpoint)
                    return None, ""
                failures += 1
                if failures >= 3:
                    log.warning(
                        "metadata server at %s unreachable after %d "
                        "attempts (%s) — preemption watcher DISABLED; "
                        "spot reclaim will arrive as SIGKILL",
                        self.endpoint, failures, e)
                    return None, ""
                if self._stop_evt.wait(self._poll_interval_s):
                    return None, ""
        return None, ""

    def run(self) -> None:
        import time as _time

        value, etag = self._initial_probe()
        if value is None:
            return
        while not self._stop_evt.is_set():
            if value == "TRUE":
                self.fired = True
                log.warning("PREEMPTION NOTICE from %s — signalling the "
                            "user process for a final checkpoint",
                            self.endpoint)
                try:
                    self._on_preempt()
                except Exception:  # noqa: BLE001 — never kill the thread
                    log.exception("preemption action failed")
                return
            t0 = _time.monotonic()
            try:
                value, etag = self._probe(wait=True, etag=etag)
            except (urlerror.URLError, OSError, ValueError):
                # transient metadata hiccup (or hanging-GET timeout):
                # back off and re-poll rather than dying
                if self._stop_evt.wait(self._poll_interval_s):
                    return
                try:
                    value, etag = self._probe(wait=False)
                except (urlerror.URLError, OSError, ValueError):
                    value = ""
                continue
            if value != "TRUE" and _time.monotonic() - t0 < 0.5:
                # A "hanging" GET that returns unchanged instantly is a
                # misbehaving proxy; don't let it become a busy spin.
                if self._stop_evt.wait(self._poll_interval_s):
                    return

    def stop(self) -> None:
        # NB: named _stop_evt, not _stop — threading.Thread has a private
        # _stop() method that an attribute would shadow (join() crashes).
        self._stop_evt.set()


def start_for_executor(user_proc_ref) -> Optional[PreemptionWatcher]:
    """Start the watcher wired to TERM the executor's user process group.

    ``user_proc_ref`` is the executor's mutable ``[Popen]`` holder (the
    user command may not have started yet when the watcher does). No-op
    (returns None) when disabled via TONY_PREEMPTION_WATCH=0."""
    if os.environ.get(PREEMPTION_WATCH_ENV, "1") == "0":
        return None

    def _term_user_group() -> None:
        p = user_proc_ref[0] if user_proc_ref else None
        if p is not None and p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGTERM)
                return
            except (ProcessLookupError, PermissionError):
                pass
        # User command not running (yet/anymore): nothing to save —
        # let the platform's reclaim take its course.
        log.warning("preemption notice with no running user process")

    w = PreemptionWatcher(_term_user_group)
    w.start()
    return w
