"""Shared GCP auth: OAuth2 bearer resolution for stdlib-HTTP clients.

One resolution order for every GCP-speaking component (the GCS storage
client, the Cloud TPU provisioner): explicit credential → the
``GOOGLE_OAUTH_ACCESS_TOKEN`` env var → the GCE/TPU-VM metadata server,
cached and refreshed 60 s before expiry, with a 5-minute negative cache
off-GCP (no metadata server → anonymous; paying the connect timeout per
request would turn an N-call anonymous workload into N stalls).

This is the TPU-native analogue of the reference's single delegation-token
fetch shared across its HDFS touchpoints (``security/TokenCache.java:44-51``
feeding both localization and history writes). Factored out of
``storage/store.py`` when the TPU provisioner became the second client.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional, Type
from urllib import error as urlerror
from urllib import request as urlrequest

METADATA_ROOT = "http://metadata.google.internal"
_TOKEN_PATH = ("/computeMetadata/v1/instance/service-accounts/default/token")


class GcpBearer:
    """Bearer-token provider with caching and a 401-invalidated refresh."""

    def __init__(self, credential: Optional[str] = None,
                 metadata_root: Optional[str] = None):
        self.explicit = credential
        self._token: Optional[str] = credential
        self._expiry = float("inf") if credential else 0.0
        self._anon_until = 0.0
        self._root = (metadata_root or METADATA_ROOT).rstrip("/")

    def token(self) -> Optional[str]:
        # Expiry deadlines live on the MONOTONIC clock: expires_in is a
        # relative duration, and an NTP step must not make a live token
        # look expired (or worse, a stale one look fresh).
        if self._token and time.monotonic() < self._expiry - 60:
            return self._token
        env_tok = os.environ.get("GOOGLE_OAUTH_ACCESS_TOKEN")
        if env_tok:
            self._token, self._expiry = env_tok, float("inf")
            return self._token
        if time.monotonic() < self._anon_until:
            return None
        try:
            req = urlrequest.Request(self._root + _TOKEN_PATH,
                                     headers={"Metadata-Flavor": "Google"})
            with urlrequest.urlopen(req, timeout=5) as r:
                body = json.loads(r.read().decode())
            self._token = body.get("access_token")
            self._expiry = time.monotonic() + float(
                body.get("expires_in", 300))
        except Exception:  # noqa: BLE001 — off-GCP: anonymous
            self._token = None
            self._anon_until = time.monotonic() + 300
        return self._token

    def invalidate(self) -> None:
        """Drop the cached token (a 401 on a stale env/metadata token);
        explicit credentials are the caller's problem and stay."""
        if self.explicit is None:
            self._token, self._expiry = None, 0.0


def json_request(method: str, url: str, auth: GcpBearer,
                 body: Optional[dict] = None, retries: int = 4,
                 backoff_s: float = 1.0, timeout_s: float = 60.0,
                 error_cls: Type[Exception] = RuntimeError) -> dict:
    """One JSON-API call with bearer auth and bounded retry — the retry
    discipline shared by GCP control-plane clients (the Cloud TPU
    provisioner today): 429/5xx/transport errors retry with exponential
    backoff, 404 raises FileNotFoundError, 401/403 gets ONE cached-token
    refresh then raises ``error_cls`` (long jobs must survive token expiry
    between their first and last API call), any other 4xx raises
    ``error_cls`` immediately. ``error_cls`` instances carry the HTTP
    status in ``.code`` when their constructor accepts a ``code`` kwarg.

    ``GcsStore._request`` (storage/store.py) keeps its own loop on
    purpose: the *object* plane needs 308/Range resumable handling,
    response headers, and streamed bodies that a JSON helper shouldn't
    grow.
    """
    def _raise(msg: str, code: int, cause: Exception):
        try:
            exc = error_cls(msg, code=code)  # type: ignore[call-arg]
        except TypeError:
            exc = error_cls(msg)
        raise exc from cause

    data = json.dumps(body).encode() if body is not None else None
    delay = backoff_s
    refreshed_auth = False
    attempt = 0
    while True:
        headers = {"Content-Type": "application/json"}
        tok = auth.token()
        if tok:
            headers["Authorization"] = f"Bearer {tok}"
        req = urlrequest.Request(url, data=data, headers=headers,
                                 method=method)
        try:
            with urlrequest.urlopen(req, timeout=timeout_s) as r:
                return json.loads(r.read().decode() or "{}")
        except urlerror.HTTPError as e:
            detail = e.read().decode(errors="replace")[:512]
            if e.code == 404:
                raise FileNotFoundError(f"{method} {url}: not found") from e
            if e.code in (401, 403):
                if not refreshed_auth and auth.explicit is None:
                    refreshed_auth = True
                    auth.invalidate()
                    continue
                _raise(f"API denied {method} {url}: HTTP {e.code} "
                       f"({detail})", e.code, e)
            if e.code not in (408, 429) and e.code < 500:
                # 409 conflict, 400 bad request, … — the caller's
                # problem, not a retry candidate.
                _raise(f"API {method} {url}: HTTP {e.code} ({detail})",
                       e.code, e)
            last: Exception = e
        except (urlerror.URLError, OSError) as e:
            last = e
        if attempt >= retries:
            try:
                exc = error_cls(f"API {method} {url} failed after "
                                f"{retries + 1} attempts: {last}")
            except TypeError:
                exc = error_cls(str(last))
            raise exc from last
        attempt += 1
        time.sleep(delay)
        delay *= 2
