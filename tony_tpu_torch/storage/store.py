"""Remote storage abstraction behind job staging and localization.

The reference stages the job bundle to HDFS and localizes it into every
container (``TonyClient.processFinalTonyConf`` :189-228,
``util/HdfsUtils.java:115-160``), with delegation tokens fetched for every
referenced namenode and shipped with the job
(``security/TokenCache.java:44-51``). The TPU-native analogue is an object
store: the client **puts** the bundle under a job prefix, executors on
remote TPU VMs **get** it — no shared filesystem is ever assumed once a
remote store is configured.

- ``Store`` — the minimal interface (put/get file+tree, list, exists,
  delete object+tree), addressed by URL.
- ``LocalFsStore`` — ``file://`` (and bare paths): the single-host and
  NFS-mount path.
- ``GcsStore`` — ``gs://``: the REAL client, speaking the GCS JSON API
  over HTTPS (stdlib urllib — no SDK dependency): media + resumable
  uploads, ``alt=media`` downloads, paginated listing, bounded retry on
  429/5xx, bearer auth from the job credential / environment / the GCE
  metadata server (the TPU-VM production path). ``TONY_GCS_ENDPOINT``
  overrides the API host so the client's wire behavior is testable against
  an in-process server in egress-free CI (tests/gcs_fake_server.py).
- ``FakeGcsStore`` — ``gs://`` when ``TONY_FAKE_GCS_ROOT`` is set (CI):
  GCS **flat-namespace** semantics — objects are keys, not paths; there
  are no directories, empty or otherwise (a "directory" exists exactly
  while keys live under it) — backed by url-encoded key files under a
  local root, so filesystem habits (mkdir-then-assume, rename) cannot
  silently pass in CI and fail on real GCS. Token checks emulate the
  delegation-token contract: a bucket root marked with ``.require_token``
  rejects access unless the caller presents the matching credential.

Store selection (``get_store``): ``file://``/bare → LocalFsStore; ``gs://``
→ FakeGcsStore iff ``TONY_FAKE_GCS_ROOT`` is set, else the real GcsStore.

Credential passthrough (the TokenCache analogue): the client stamps the
storage credential into the frozen config; the coordinator exports it to
executors as ``TONY_STORAGE_TOKEN`` so they can fetch the frozen config
itself from the store before they have read it. For the real GcsStore the
same env var carries an OAuth2 access token; without it the metadata
server supplies one on GCP.
"""

from __future__ import annotations

import abc
import json
import os
import shutil
import time
from http.client import HTTPException
from typing import Dict, List, Optional, Tuple
from urllib import error as urlerror
from urllib import request as urlrequest
from urllib.parse import quote, unquote, urlparse

from tony_tpu_torch import faults
from tony_tpu_torch.retry import RetryPolicy, call_with_retry
from tony_tpu_torch.utils import durable
from tony_tpu_torch.utils.gcp import GcpBearer

STORAGE_TOKEN_ENV = "TONY_STORAGE_TOKEN"
FAKE_GCS_ROOT_ENV = "TONY_FAKE_GCS_ROOT"
GCS_ENDPOINT_ENV = "TONY_GCS_ENDPOINT"
REQUIRE_TOKEN_MARKER = ".require_token"


class StoreAuthError(PermissionError):
    """Credential missing or rejected by the store."""


def is_url(s: str) -> bool:
    return "://" in (s or "")


def credential_from_env() -> Optional[str]:
    return os.environ.get(STORAGE_TOKEN_ENV) or None


def get_store(url: str, credential: Optional[str] = None) -> "Store":
    """Factory: dispatch on scheme (see module docstring). With fault
    injection active (tony_tpu_torch/faults.py), the store is wrapped so the
    ``storage.put``/``storage.get`` sites fire and injected transients are
    absorbed by the shared retry policy — exactly the path a real GCS
    503 burst takes through GcsStore's own bounded retry."""
    scheme = urlparse(url).scheme if is_url(url) else ""
    if scheme in ("", "file"):
        store: Store = LocalFsStore()
    elif scheme == "gs":
        cred = credential or credential_from_env()
        if os.environ.get(FAKE_GCS_ROOT_ENV):
            store = FakeGcsStore(credential=cred)
        else:
            store = GcsStore(credential=cred)
    else:
        raise ValueError(f"no store for scheme {scheme!r} (url {url!r})")
    if faults.active() is not None:
        return RetryingStore(store)
    return store


class Store(abc.ABC):
    """Minimal object-store surface; paths are URLs of the store's scheme."""

    @abc.abstractmethod
    def put_file(self, local_path: str, url: str) -> None: ...

    @abc.abstractmethod
    def get_file(self, url: str, local_path: str) -> None: ...

    @abc.abstractmethod
    def exists(self, url: str) -> bool: ...

    @abc.abstractmethod
    def isdir(self, url: str) -> bool:
        """True iff the URL is a prefix with anything under it (object
        stores have no directories — this is the prefix question)."""

    @abc.abstractmethod
    def list(self, url: str) -> List[str]:
        """Immediate child names under a prefix (empty if absent)."""

    @abc.abstractmethod
    def _keys_under(self, url: str) -> List[Tuple[str, str]]:
        """(relative_key, full_url) for every object under the prefix —
        the primitive put_tree/get_tree ride on."""

    @abc.abstractmethod
    def delete(self, url: str) -> None:
        """Remove one object; FileNotFoundError when it is absent."""

    def delete_tree(self, url: str) -> None:
        """Remove every object under the prefix (none there: a no-op)."""
        try:
            keys = self._keys_under(url)
        except FileNotFoundError:
            return              # an unknown bucket holds nothing
        for _, full in keys:
            try:
                self.delete(full)
            except FileNotFoundError:
                pass            # another deleter was first

    def put_tree(self, local_dir: str, url: str) -> None:
        for root, _, files in os.walk(local_dir):
            for f in files:
                p = os.path.join(root, f)
                rel = os.path.relpath(p, local_dir).replace(os.sep, "/")
                self.put_file(p, join(url, rel))

    def get_tree(self, url: str, local_dir: str) -> None:
        keys = self._keys_under(url)
        if not keys:
            raise FileNotFoundError(f"{url} not in store")
        os.makedirs(local_dir, exist_ok=True)
        base = os.path.realpath(local_dir)
        for rel, full in keys:
            dest = os.path.realpath(
                os.path.join(local_dir, rel.replace("/", os.sep)))
            if dest != base and not dest.startswith(base + os.sep):
                # '..' (or absolute) segments are legal object-key bytes;
                # a hostile bucket must not become an arbitrary file write
                # on the coordinator (zip-slip).
                raise ValueError(
                    f"object key {rel!r} escapes destination {local_dir!r}")
            self.get_file(full, dest)


#: transfer-level retry for injected/transient faults above any store
#: implementation (the GcsStore additionally retries at the HTTP layer)
STORE_RETRY = RetryPolicy(max_attempts=5, base_delay_s=0.2, max_delay_s=5.0)


class RetryingStore(Store):
    """Fault-site + retry wrapper over any Store (installed by
    ``get_store`` when fault injection is active).

    ``storage.put``/``storage.get`` injections surface here as
    ConnectionError and are absorbed by the shared full-jitter policy;
    real transient transport errors from the inner store ride the same
    path. Genuinely terminal errors (missing object, rejected credential,
    malformed URL) propagate immediately. ``put_tree``/``get_tree`` are
    the base-class per-file loops, so every file of a tree transfer gets
    the same protection."""

    def __init__(self, inner: Store, policy: RetryPolicy = STORE_RETRY):
        self.inner = inner
        self.policy = policy

    def _retrying(self, what: str, fn):
        return call_with_retry(
            fn, self.policy,
            retry_on=(OSError, HTTPException),
            give_up_on=(FileNotFoundError, StoreAuthError, ValueError),
            what=what)

    def put_file(self, local_path: str, url: str) -> None:
        def attempt():
            faults.check("storage.put")
            self.inner.put_file(local_path, url)
        self._retrying(f"put {url}", attempt)

    def get_file(self, url: str, local_path: str) -> None:
        def attempt():
            faults.check("storage.get")
            self.inner.get_file(url, local_path)
        self._retrying(f"get {url}", attempt)

    def exists(self, url: str) -> bool:
        return self.inner.exists(url)

    def isdir(self, url: str) -> bool:
        return self.inner.isdir(url)

    def list(self, url: str) -> List[str]:
        return self.inner.list(url)

    def _keys_under(self, url: str):
        return self.inner._keys_under(url)

    def delete(self, url: str) -> None:
        self._retrying(f"delete {url}", lambda: self.inner.delete(url))

    def delete_tree(self, url: str) -> None:
        # Idempotent: a retry deletes what the failed attempt left.
        self._retrying(f"delete {url}", lambda: self.inner.delete_tree(url))

    def __getattr__(self, name: str):
        # Store-specific extras (LocalFsStore.open, endpoints, ...)
        return getattr(self.inner, name)


class LocalFsStore(Store):
    """``file://`` URLs and bare paths — identity mapping onto the local
    (or NFS-mounted) filesystem."""

    def _resolve(self, url: str) -> str:
        if is_url(url):
            p = urlparse(url)
            if p.scheme != "file":
                raise ValueError(f"LocalFsStore got {url!r}")
            return (p.netloc or "") + p.path
        return url

    def put_file(self, local_path: str, url: str) -> None:
        dest = self._resolve(url)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        shutil.copy2(local_path, dest)

    def get_file(self, url: str, local_path: str) -> None:
        src = self._resolve(url)
        if not os.path.isfile(src):
            raise FileNotFoundError(f"{url} not in store")
        os.makedirs(os.path.dirname(os.path.abspath(local_path)),
                    exist_ok=True)
        shutil.copy2(src, local_path)

    def put_tree(self, local_dir: str, url: str) -> None:
        dest = self._resolve(url)
        os.makedirs(dest, exist_ok=True)
        shutil.copytree(local_dir, dest, dirs_exist_ok=True)

    def get_tree(self, url: str, local_dir: str) -> None:
        src = self._resolve(url)
        if not os.path.isdir(src):
            raise FileNotFoundError(f"{url} not in store")
        os.makedirs(local_dir, exist_ok=True)
        shutil.copytree(src, local_dir, dirs_exist_ok=True)

    def open(self, url: str, mode: str = "rb"):
        path = self._resolve(url)
        if any(m in mode for m in "wa"):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        return open(path, mode)

    def exists(self, url: str) -> bool:
        return os.path.exists(self._resolve(url))

    def isdir(self, url: str) -> bool:
        return os.path.isdir(self._resolve(url))

    def list(self, url: str) -> List[str]:
        path = self._resolve(url)
        if not os.path.isdir(path):
            return []
        return sorted(os.listdir(path))

    def _keys_under(self, url: str):
        src = self._resolve(url)
        out = []
        for root, _, files in os.walk(src):
            for f in files:
                p = os.path.join(root, f)
                rel = os.path.relpath(p, src).replace(os.sep, "/")
                out.append((rel, join(url, rel)))
        return out

    def delete(self, url: str) -> None:
        os.unlink(self._resolve(url))

    def delete_tree(self, url: str) -> None:
        path = self._resolve(url)
        if os.path.isdir(path):
            shutil.rmtree(path)


def _split_gs(url: str) -> Tuple[str, str]:
    p = urlparse(url)
    if p.scheme != "gs" or not p.netloc:
        raise ValueError(f"gs store got {url!r}")
    return p.netloc, p.path.lstrip("/")


def _as_prefix(key: str) -> str:
    """Key → listing prefix: 'a/b' and 'a/b/' both mean everything under
    'a/b/'; the bucket root is the empty prefix."""
    return key.rstrip("/") + "/" if key else ""


class GcsStore(Store):
    """Real ``gs://`` client over the GCS JSON API (stdlib HTTP only).

    Production auth order: explicit credential (the job's
    ``TONY_STORAGE_TOKEN``) → ``GOOGLE_OAUTH_ACCESS_TOKEN`` → the GCE/TPU-VM
    metadata server, cached and refreshed 60 s before expiry — the
    TPU-native analogue of the reference's delegation-token fetch
    (``TokenCache.java:44-51``). Requests without any obtainable token go
    out anonymous (public buckets); 401/403 surface as StoreAuthError.

    Wire behavior deliberately covered by contract tests against a local
    JSON-API server (``TONY_GCS_ENDPOINT`` override): resumable uploads in
    256 KiB-aligned chunks with 308 handling, paginated listing
    (``nextPageToken``), bounded retry with backoff on 429/5xx and
    transport errors.
    """

    #: files at or above this size upload via a resumable session
    RESUMABLE_THRESHOLD = 8 * 1024 * 1024
    #: resumable chunk size — must be a multiple of 256 KiB per the API
    CHUNK = 8 * 1024 * 1024

    def __init__(self, credential: Optional[str] = None,
                 endpoint: Optional[str] = None,
                 retries: int = 4, backoff_s: float = 1.0):
        self.endpoint = (endpoint or os.environ.get(GCS_ENDPOINT_ENV)
                         or "https://storage.googleapis.com").rstrip("/")
        self._auth = GcpBearer(credential)
        self.retries = retries
        self.backoff_s = backoff_s
        # Exponential backoff with FULL JITTER (tony_tpu_torch/retry.py): a
        # whole gang hitting the same 429/503 burst must de-correlate its
        # retries, not re-synchronize on a fixed doubling schedule.
        self._policy = RetryPolicy(max_attempts=retries + 1,
                                   base_delay_s=backoff_s,
                                   max_delay_s=max(backoff_s * 8, 30.0))

    # -- auth ----------------------------------------------------------
    def _bearer(self) -> Optional[str]:
        # Shared resolution (explicit → env → metadata server, cached with
        # negative cache): utils/gcp.py, also used by the TPU provisioner.
        return self._auth.token()

    # -- http ----------------------------------------------------------
    def _request(self, method: str, url: str, data: Optional[bytes] = None,
                 headers: Optional[Dict[str, str]] = None,
                 ok: Tuple[int, ...] = (200,),
                 stream_to: Optional[str] = None,
                 ) -> Tuple[int, bytes, Dict[str, str]]:
        """One HTTP call with auth + bounded retry. Returns
        (status, body, lowercased headers); statuses in ``ok`` (plus 308,
        the resumable-continue signal) return, 404 raises FileNotFoundError,
        401/403 StoreAuthError (after one cached-token refresh — access
        tokens expire mid-job and a >1 h run must not fail its final
        upload on a stale cache), anything retryable retries then raises.
        With ``stream_to`` the body is copied straight to that path instead
        of buffered (multi-GB bundle/checkpoint downloads must not live in
        memory)."""
        refreshed_auth = False
        attempt = 0
        # `attempt` counts RETRYABLE failures only; the single-shot auth
        # refresh must not be able to exhaust the budget (a 401 on the
        # last attempt previously fell through to an assertion).
        while True:
            hdrs = dict(headers or {})
            tok = self._bearer()
            if tok:
                hdrs["Authorization"] = f"Bearer {tok}"
            req = urlrequest.Request(url, data=data, headers=hdrs,
                                     method=method)
            try:
                with urlrequest.urlopen(req, timeout=60) as r:
                    rh = {k.lower(): v for k, v in r.headers.items()}
                    if stream_to is not None:
                        with open(stream_to, "wb") as f:
                            shutil.copyfileobj(r, f, length=1024 * 1024)
                        return (r.status, b"", rh)
                    return (r.status, r.read(), rh)
            except urlerror.HTTPError as e:
                body = e.read()
                if e.code in ok or e.code == 308:
                    return (e.code, body,
                            {k.lower(): v for k, v in e.headers.items()})
                if e.code == 404:
                    raise FileNotFoundError(f"{url} not in store") from e
                if e.code in (401, 403):
                    if not refreshed_auth and self._auth.explicit is None:
                        # Cached env/metadata token may simply have
                        # expired: drop it and retry once with a fresh one.
                        refreshed_auth = True
                        self._auth.invalidate()
                        continue
                    raise StoreAuthError(
                        f"GCS denied {method} {url}: HTTP {e.code} "
                        f"({'token rejected' if tok else 'no credential'})"
                    ) from e
                if e.code not in (408, 429) and e.code < 500:
                    raise
                last = e
            except (urlerror.URLError, OSError, HTTPException) as e:
                # OSError/HTTPException (not just URLError): a reset or
                # truncated read can surface MID-BODY — from r.read() or
                # the stream_to copy — and those long transfers are
                # exactly where transient faults land.
                last = e
            if attempt >= self.retries:
                raise IOError(f"GCS {method} {url} failed after "
                              f"{self.retries + 1} attempts: {last}")
            time.sleep(self._policy.delay_s(attempt))
            attempt += 1

    def _obj_url(self, bucket: str, key: str, media: bool = False) -> str:
        if not key:
            # '…/o/' with an empty name is a 400-class API error; callers
            # that can mean a bucket root (exists) must branch before here.
            raise ValueError(f"gs://{bucket} has no object name")
        return (f"{self.endpoint}/storage/v1/b/{quote(bucket, safe='')}"
                f"/o/{quote(key, safe='')}" + ("?alt=media" if media else ""))

    # -- Store ---------------------------------------------------------
    def put_file(self, local_path: str, url: str) -> None:
        bucket, key = _split_gs(url)
        size = os.path.getsize(local_path)
        if size >= self.RESUMABLE_THRESHOLD:
            return self._put_resumable(local_path, bucket, key, size)
        with open(local_path, "rb") as f:
            data = f.read()
        self._request(
            "POST",
            f"{self.endpoint}/upload/storage/v1/b/{quote(bucket, safe='')}"
            f"/o?uploadType=media&name={quote(key, safe='')}",
            data=data,
            headers={"Content-Type": "application/octet-stream"})

    def _put_resumable(self, local_path: str, bucket: str, key: str,
                       size: int) -> None:
        """Resumable upload: initiate a session, then PUT 256 KiB-aligned
        chunks; 308 + Range tells us how far the server got (so a dropped
        chunk re-sends from the server's watermark, not from zero)."""
        _, _, hdrs = self._request(
            "POST",
            f"{self.endpoint}/upload/storage/v1/b/{quote(bucket, safe='')}"
            f"/o?uploadType=resumable&name={quote(key, safe='')}",
            data=b"",
            headers={"X-Upload-Content-Length": str(size),
                     "Content-Type": "application/json"})
        session = hdrs.get("location")
        if not session:
            raise IOError(f"resumable initiate for gs://{bucket}/{key} "
                          f"returned no session URI")
        offset = 0
        stalled = 0
        with open(local_path, "rb") as f:
            while True:
                if offset >= size:
                    # Every byte acknowledged yet no 2xx finalize — a
                    # nonconforming server; "success" here would leave no
                    # object behind for executors to fetch.
                    raise IOError(
                        f"resumable upload of gs://{bucket}/{key}: server "
                        f"acknowledged all {size} bytes but never "
                        f"finalized the object")
                f.seek(offset)
                chunk = f.read(min(self.CHUNK, size - offset))
                end = offset + len(chunk)
                status, _, hdrs = self._request(
                    "PUT", session, data=chunk,
                    headers={"Content-Range":
                             f"bytes {offset}-{end - 1}/{size}"},
                    ok=(200, 201, 308))
                if status != 308:
                    return          # 200/201: object finalized
                # 308 = not finished; Range carries the server's committed
                # watermark (ABSENT = zero bytes persisted — per the
                # protocol, never advance blindly). Follow the watermark
                # wherever it is, but bound non-progress: a server that
                # never advances must become an error, not a spin.
                rng = hdrs.get("range", "")
                new_offset = (int(rng.rsplit("-", 1)[1]) + 1
                              if "-" in rng else 0)
                if new_offset > offset:
                    stalled = 0
                else:
                    stalled += 1
                    if stalled > 3:
                        raise IOError(
                            f"resumable upload of gs://{bucket}/{key} "
                            f"stalled at byte {offset}/{size} (no "
                            f"watermark progress after {stalled} attempts)")
                offset = new_offset

    def get_file(self, url: str, local_path: str) -> None:
        bucket, key = _split_gs(url)
        os.makedirs(os.path.dirname(os.path.abspath(local_path)),
                    exist_ok=True)
        tmp = local_path + ".tmp-dl"
        try:
            self._request("GET", self._obj_url(bucket, key, media=True),
                          stream_to=tmp)
        except BaseException:
            try:
                os.unlink(tmp)      # no half-downloaded leftovers
            except OSError:
                pass
            raise
        # Promote the finished download durably: the content-hash skip
        # manifest (utils/localize.py) may later trust this file by
        # size+mtime alone, so a torn rename must never look localized.
        durable.fsync_path(tmp)
        durable.durable_replace(tmp, local_path)

    def exists(self, url: str) -> bool:
        bucket, key = _split_gs(url)
        if not key:
            # gs://bucket[/]: there is no object with an empty name (the
            # API would 400 on '…/o/'); answer via the prefix listing like
            # the other stores do (ADVICE r4).
            return self.isdir(url)
        try:
            self._request("GET", self._obj_url(bucket, key))
            return True
        except FileNotFoundError:
            return self.isdir(url)

    def isdir(self, url: str) -> bool:
        bucket, key = _split_gs(url)
        try:
            items, prefixes = self._list_page(bucket, _as_prefix(key),
                                              max_results=1, first_hit=True)
        except FileNotFoundError:
            return False        # unknown bucket: a boolean, not a throw
        return bool(items or prefixes)

    def _list_page(self, bucket: str, prefix: str, max_results: int = 1000,
                   delimiter: str = "/", first_hit: bool = False,
                   ) -> Tuple[List[str], List[str]]:
        """(object names, child prefixes) under a prefix, following
        nextPageToken pagination to the end — or, with ``first_hit``, to
        the first non-empty page (real GCS may return EMPTY pages that
        still carry a continuation token; an empty first page is not
        'nothing there')."""
        names: List[str] = []
        prefixes: List[str] = []
        token = ""
        while True:
            q = (f"prefix={quote(prefix, safe='')}&maxResults={max_results}"
                 + (f"&delimiter={quote(delimiter, safe='')}"
                    if delimiter else "")
                 + (f"&pageToken={quote(token, safe='')}" if token else ""))
            _, body, _ = self._request(
                "GET",
                f"{self.endpoint}/storage/v1/b/{quote(bucket, safe='')}/o?"
                + q)
            page = json.loads(body.decode() or "{}")
            names += [o["name"] for o in page.get("items", [])]
            prefixes += page.get("prefixes", [])
            token = page.get("nextPageToken", "")
            if not token or (first_hit and (names or prefixes)):
                return names, prefixes

    def list(self, url: str) -> List[str]:
        bucket, key = _split_gs(url)
        prefix = _as_prefix(key)
        try:
            names, prefixes = self._list_page(bucket, prefix)
        except FileNotFoundError:
            return []           # unknown bucket lists like a missing prefix
        children = {n[len(prefix):] for n in names if n != prefix}
        children |= {p[len(prefix):].rstrip("/") for p in prefixes}
        return sorted(c for c in children if c)

    def _keys_under(self, url: str):
        bucket, key = _split_gs(url)
        prefix = _as_prefix(key)
        names, _ = self._list_page(bucket, prefix, delimiter="")
        return [(n[len(prefix):], f"gs://{bucket}/{n}")
                for n in names if n != prefix and not n.endswith("/")]

    def delete(self, url: str) -> None:
        bucket, key = _split_gs(url)
        self._request("DELETE", self._obj_url(bucket, key), ok=(200, 204))


class FakeGcsStore(Store):
    """``gs://`` with real GCS *semantics* on a local root (egress-free CI).

    Flat namespace: an object ``jobs/app1/bundle/f.txt`` is ONE key, stored
    as the url-encoded file ``$root/<bucket>/.objects/jobs%2Fapp1%2F...``.
    There are no directories — ``isdir``/``list`` are prefix queries over
    the key set, and an "empty directory" cannot exist (exactly like GCS,
    unlike a filesystem-tree fake, which would let mkdir-then-assume bugs
    pass CI and fail in production)."""

    OBJECTS = ".objects"

    def __init__(self, root: Optional[str] = None,
                 credential: Optional[str] = None):
        self.root = root or os.environ.get(FAKE_GCS_ROOT_ENV, "")
        if not self.root:
            raise ValueError(
                f"gs:// fake needs {FAKE_GCS_ROOT_ENV} (unset it to use the "
                f"real GcsStore client)")
        self.credential = credential

    def _check_auth(self, bucket: str) -> None:
        marker = os.path.join(self.root, bucket, REQUIRE_TOKEN_MARKER)
        if os.path.isfile(marker):
            with open(marker, encoding="utf-8") as f:
                expected = f.read().strip()
            if expected and self.credential != expected:
                raise StoreAuthError(
                    f"bucket {bucket!r} requires a credential "
                    f"({'wrong token' if self.credential else 'none given'})"
                )

    def _obj_path(self, url: str) -> Tuple[str, str, str]:
        bucket, key = _split_gs(url)
        self._check_auth(bucket)
        return (bucket, key,
                os.path.join(self.root, bucket, self.OBJECTS,
                             quote(key, safe="")))

    def _keys(self, bucket: str) -> List[str]:
        d = os.path.join(self.root, bucket, self.OBJECTS)
        if not os.path.isdir(d):
            return []
        return sorted(unquote(f) for f in os.listdir(d))

    def put_file(self, local_path: str, url: str) -> None:
        _, _, path = self._obj_path(url)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp-up"
        shutil.copy2(local_path, tmp)
        # Object visibility is atomic AND durable, like a real GCS PUT.
        durable.fsync_path(tmp)
        durable.durable_replace(tmp, path)

    def get_file(self, url: str, local_path: str) -> None:
        _, _, path = self._obj_path(url)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"{url} not in store")
        os.makedirs(os.path.dirname(os.path.abspath(local_path)),
                    exist_ok=True)
        shutil.copy2(path, local_path)

    def exists(self, url: str) -> bool:
        _, key, path = self._obj_path(url)
        return os.path.isfile(path) or self.isdir(url)

    def isdir(self, url: str) -> bool:
        bucket, key, _ = self._obj_path(url)
        prefix = _as_prefix(key)
        return any(k.startswith(prefix) for k in self._keys(bucket))

    def list(self, url: str) -> List[str]:
        bucket, key, _ = self._obj_path(url)
        prefix = _as_prefix(key)
        children = set()
        for k in self._keys(bucket):
            if not k.startswith(prefix):
                continue
            children.add(k[len(prefix):].split("/", 1)[0])
        return sorted(c for c in children if c)

    def _keys_under(self, url: str):
        bucket, key, _ = self._obj_path(url)
        prefix = _as_prefix(key)
        return [(k[len(prefix):], f"gs://{bucket}/{k}")
                for k in self._keys(bucket) if k.startswith(prefix)]

    def delete(self, url: str) -> None:
        _, _, path = self._obj_path(url)
        try:
            os.unlink(path)
        except FileNotFoundError:
            raise FileNotFoundError(f"{url} not in store") from None

    @staticmethod
    def make_bucket(root: str, bucket: str,
                    require_token: str = "") -> None:
        """Test helper: create a bucket, optionally token-protected."""
        os.makedirs(os.path.join(root, bucket), exist_ok=True)
        if require_token:
            with open(os.path.join(root, bucket, REQUIRE_TOKEN_MARKER),
                      "w", encoding="utf-8") as f:
                f.write(require_token)


def join(url: str, *parts: str) -> str:
    """URL-aware path join (no normalization across the scheme)."""
    out = url.rstrip("/")
    for p in parts:
        out += "/" + p.strip("/")
    return out
