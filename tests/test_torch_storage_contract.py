"""The port's store contract: the cases of ``tests/test_storage_contract.py``
against ``tony_tpu_torch.storage`` — LocalFsStore, FakeGcsStore (the
flat-namespace double) and the real GcsStore client driven against the
in-process GCS JSON-API server (``gcs_fake_server.py`` through the
``TONY_GCS_ENDPOINT`` override) — with the same parametrisation, plus
``delete`` and ``delete_tree`` on all three (the checkpoint manager's
retention on a ``gs://`` directory rides on them). The GcsStore cases run
on ``torch_gcs.GcsDeleteServer``, the same server with the JSON API's
object ``DELETE``.
"""

import os

import pytest

from tony_tpu_torch import faults
from tony_tpu_torch.storage import (FakeGcsStore, GcsStore, LocalFsStore,
                                    StoreAuthError, get_store)
from tony_tpu_torch.storage.store import RetryingStore
from tony_tpu_torch.storage.store import join as ujoin

from torch_gcs import GcsDeleteServer as GcsFakeServer

STORES = ["localfs", "fakegcs", "gcs"]


@pytest.fixture
def store_and_base(request, tmp_path, monkeypatch):
    """(store, base_url) per backend; GcsStore talks to a live local
    JSON-API server."""
    kind = request.param
    if kind == "localfs":
        yield LocalFsStore(), f"file://{tmp_path}/store"
    elif kind == "fakegcs":
        monkeypatch.setenv("TONY_FAKE_GCS_ROOT", str(tmp_path / "gcs"))
        yield FakeGcsStore(), "gs://bucket/base"
    else:
        server = GcsFakeServer().start()
        try:
            yield GcsStore(credential="t0k", endpoint=server.endpoint), \
                "gs://bucket/base"
        finally:
            server.stop()


def _mk_tree(tmp_path):
    d = tmp_path / "tree"
    (d / "sub").mkdir(parents=True)
    (d / "top.txt").write_text("top")
    (d / "sub" / "deep.txt").write_text("deep")
    return d


@pytest.mark.parametrize("store_and_base", STORES, indirect=True)
def test_contract_file_roundtrip(store_and_base, tmp_path):
    s, base = store_and_base
    src = tmp_path / "a.txt"
    src.write_text("hello")
    url = ujoin(base, "stage/a.txt")
    assert not s.exists(url)
    s.put_file(str(src), url)
    assert s.exists(url)
    s.get_file(url, str(tmp_path / "back.txt"))
    assert (tmp_path / "back.txt").read_text() == "hello"
    # overwrite is last-writer-wins
    src.write_text("hello2")
    s.put_file(str(src), url)
    s.get_file(url, str(tmp_path / "back2.txt"))
    assert (tmp_path / "back2.txt").read_text() == "hello2"


@pytest.mark.parametrize("store_and_base", STORES, indirect=True)
def test_contract_missing_reads_raise(store_and_base, tmp_path):
    s, base = store_and_base
    with pytest.raises(FileNotFoundError):
        s.get_file(ujoin(base, "nope.txt"), str(tmp_path / "x"))
    with pytest.raises(FileNotFoundError):
        s.get_tree(ujoin(base, "nodir"), str(tmp_path / "y"))
    assert not s.exists(ujoin(base, "nope.txt"))
    assert not s.isdir(ujoin(base, "nodir"))
    assert s.list(ujoin(base, "nodir")) == []


@pytest.mark.parametrize("store_and_base", STORES, indirect=True)
def test_contract_tree_roundtrip_and_listing(store_and_base, tmp_path):
    s, base = store_and_base
    d = _mk_tree(tmp_path)
    url = ujoin(base, "jobs/app1/bundle")
    s.put_tree(str(d), url)
    assert s.isdir(url)
    assert s.isdir(ujoin(base, "jobs/app1"))
    assert s.list(url) == ["sub", "top.txt"]
    assert s.list(ujoin(base, "jobs/app1")) == ["bundle"]
    s.get_tree(url, str(tmp_path / "out"))
    assert (tmp_path / "out" / "top.txt").read_text() == "top"
    assert (tmp_path / "out" / "sub" / "deep.txt").read_text() == "deep"


@pytest.mark.parametrize("store_and_base",
                         ["fakegcs", "gcs"], indirect=True)
def test_contract_gs_flat_namespace(store_and_base, tmp_path):
    """GCS semantics: a 'directory' exists exactly while keys live under
    it — there is no mkdir, and writing one deep key materializes every
    ancestor prefix at once."""
    s, base = store_and_base
    f = tmp_path / "one.txt"
    f.write_text("1")
    s.put_file(str(f), ujoin(base, "p/q/r/one.txt"))
    assert s.isdir(ujoin(base, "p")) and s.isdir(ujoin(base, "p/q/r"))
    assert s.list(ujoin(base, "p")) == ["q"]
    # an object and a prefix are distinct names
    assert s.exists(ujoin(base, "p/q/r/one.txt"))
    assert not s.exists(ujoin(base, "p/q/r/one"))


@pytest.mark.parametrize("store_and_base",
                         ["fakegcs", "gcs"], indirect=True)
def test_contract_gs_bucket_root_exists_is_boolean(store_and_base, tmp_path):
    """exists() on gs://bucket (empty object name) answers via the prefix
    listing instead of building a malformed '…/o/' URL (ADVICE r4): True
    once the bucket holds anything, False on an empty/unknown bucket —
    never an exception."""
    s, base = store_and_base
    bucket_root = base.rsplit("/", 1)[0]          # gs://bucket
    assert not s.exists(bucket_root)
    assert not s.exists(bucket_root + "/")
    # a bucket the backend has never heard of (real GCS 404s the listing)
    assert not s.exists("gs://never-created-bucket")
    assert not s.isdir("gs://never-created-bucket/p")
    assert s.list("gs://never-created-bucket/p") == []
    f = tmp_path / "seed.txt"
    f.write_text("x")
    s.put_file(str(f), ujoin(base, "seed.txt"))
    assert s.exists(bucket_root)
    assert s.exists(bucket_root + "/")


# ---------------------------------------------------------------------------
# Wire-level behavior of the REAL client (GcsStore only)
# ---------------------------------------------------------------------------
def test_gcs_listing_pagination(tmp_path):
    server = GcsFakeServer(page_size=3).start()   # force many pages
    try:
        s = GcsStore(credential="t", endpoint=server.endpoint)
        f = tmp_path / "x"
        f.write_text("x")
        for i in range(10):
            s.put_file(str(f), f"gs://b/pfx/k{i:02d}")
        assert s.list("gs://b/pfx") == [f"k{i:02d}" for i in range(10)]
        assert len(s._keys_under("gs://b/pfx")) == 10
    finally:
        server.stop()


def test_gcs_resumable_upload_with_partial_acks(tmp_path):
    """Big object goes through the resumable session; the server commits
    only 64 KiB per PUT (simulated dropped connections), so the client
    must resume from the 308 Range watermark every time."""
    server = GcsFakeServer(resumable_ack_bytes=64 * 1024).start()
    try:
        s = GcsStore(credential="t", endpoint=server.endpoint)
        s.RESUMABLE_THRESHOLD = 128 * 1024
        s.CHUNK = 256 * 1024
        blob = os.urandom(700 * 1024)
        src = tmp_path / "big.bin"
        src.write_bytes(blob)
        s.put_file(str(src), "gs://b/big.bin")
        s.get_file("gs://b/big.bin", str(tmp_path / "back.bin"))
        assert (tmp_path / "back.bin").read_bytes() == blob
    finally:
        server.stop()


def test_gcs_resumable_308_without_range_resends(tmp_path):
    """A 308 with no Range header means ZERO bytes persisted — the client
    must resend from the same offset, not skip the chunk."""
    server = GcsFakeServer(resumable_no_range_once=True).start()
    try:
        s = GcsStore(credential="t", endpoint=server.endpoint)
        s.RESUMABLE_THRESHOLD = 64 * 1024
        s.CHUNK = 256 * 1024
        blob = os.urandom(300 * 1024)
        src = tmp_path / "big.bin"
        src.write_bytes(blob)
        s.put_file(str(src), "gs://b/big.bin")
        s.get_file("gs://b/big.bin", str(tmp_path / "back.bin"))
        assert (tmp_path / "back.bin").read_bytes() == blob
    finally:
        server.stop()


def test_get_tree_rejects_key_escaping_destination(tmp_path, monkeypatch):
    """Object keys are arbitrary bytes; '..' segments must not become
    writes outside the localization dir (zip-slip)."""
    from urllib.parse import quote

    root = tmp_path / "gcs"
    monkeypatch.setenv("TONY_FAKE_GCS_ROOT", str(root))
    s = FakeGcsStore()
    objdir = root / "bucket" / FakeGcsStore.OBJECTS
    objdir.mkdir(parents=True)
    (objdir / quote("base/../../evil.txt", safe="")).write_text("gotcha")
    dest = tmp_path / "dest"
    with pytest.raises(ValueError, match="escapes"):
        s.get_tree("gs://bucket/base", str(dest))
    assert not (tmp_path / "evil.txt").exists()


def test_gcs_retries_transient_5xx(tmp_path):
    server = GcsFakeServer(fail_first_n=2).start()
    try:
        s = GcsStore(credential="t", endpoint=server.endpoint,
                     retries=3, backoff_s=0.05)
        f = tmp_path / "x"
        f.write_text("payload")
        s.put_file(str(f), "gs://b/x")         # retried through the 503s
        s.get_file("gs://b/x", str(tmp_path / "y"))
        assert (tmp_path / "y").read_text() == "payload"
    finally:
        server.stop()


def test_gcs_auth_errors_map_to_store_auth_error(tmp_path):
    server = GcsFakeServer(require_token="sesame").start()
    try:
        f = tmp_path / "x"
        f.write_text("x")
        good = GcsStore(credential="sesame", endpoint=server.endpoint)
        good.put_file(str(f), "gs://b/x")
        with pytest.raises(StoreAuthError):
            GcsStore(credential="wrong", endpoint=server.endpoint,
                     retries=0).put_file(str(f), "gs://b/x")
        with pytest.raises(StoreAuthError):
            GcsStore(credential="wrong", endpoint=server.endpoint,
                     retries=0).get_file("gs://b/x", str(tmp_path / "y"))
    finally:
        server.stop()


def test_get_store_selects_real_client_without_fake_root(monkeypatch):
    """Production selection: gs:// resolves to the REAL GcsStore unless the
    CI fake root is configured (the 'swap one class' story is automatic)."""
    monkeypatch.delenv("TONY_FAKE_GCS_ROOT", raising=False)
    assert isinstance(get_store("gs://bucket/x"), GcsStore)
    monkeypatch.setenv("TONY_FAKE_GCS_ROOT", "/tmp/fake")
    assert isinstance(get_store("gs://bucket/x"), FakeGcsStore)


# ---------------------------------------------------------------------------
# delete and delete_tree (the port's checkpoint retention on gs://)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("store_and_base", STORES, indirect=True)
def test_contract_delete_object(store_and_base, tmp_path):
    s, base = store_and_base
    f = tmp_path / "a.txt"
    f.write_text("a")
    url = ujoin(base, "d/a.txt")
    s.put_file(str(f), url)
    s.put_file(str(f), ujoin(base, "d/b.txt"))
    s.delete(url)
    assert not s.exists(url)
    assert s.list(ujoin(base, "d")) == ["b.txt"]
    with pytest.raises(FileNotFoundError):
        s.delete(url)
    with pytest.raises(FileNotFoundError):
        s.get_file(url, str(tmp_path / "back.txt"))


@pytest.mark.parametrize("store_and_base", STORES, indirect=True)
def test_contract_delete_tree(store_and_base, tmp_path):
    """Every object under the prefix goes, a sibling prefix that shares
    its leading characters stays, and a missing prefix is a no-op."""
    s, base = store_and_base
    d = _mk_tree(tmp_path)
    s.put_tree(str(d), ujoin(base, "ckpt/1"))
    s.put_tree(str(d), ujoin(base, "ckpt/10"))
    s.delete_tree(ujoin(base, "ckpt/1"))
    assert not s.isdir(ujoin(base, "ckpt/1"))
    assert not s.exists(ujoin(base, "ckpt/1/top.txt"))
    assert s.list(ujoin(base, "ckpt")) == ["10"]
    s.get_tree(ujoin(base, "ckpt/10"), str(tmp_path / "out"))
    assert (tmp_path / "out" / "sub" / "deep.txt").read_text() == "deep"
    s.delete_tree(ujoin(base, "ckpt/1"))
    s.delete_tree(ujoin(base, "never/there"))
    s.delete_tree(ujoin(base, "ckpt"))
    assert s.list(base) == []


def test_gcs_delete_speaks_the_json_api(tmp_path):
    """``GcsStore.delete_tree`` lists the prefix across pages and sends
    one ``DELETE`` per object; an unknown bucket deletes nothing."""
    server = GcsFakeServer(page_size=2).start()
    try:
        s = GcsStore(credential="t", endpoint=server.endpoint)
        f = tmp_path / "x"
        f.write_text("x")
        for i in range(5):
            s.put_file(str(f), f"gs://b/p/k{i}")
        s.put_file(str(f), "gs://b/q/k")
        s.delete_tree("gs://b/p")
        assert server.deletes == 5
        assert sorted(server.objects["b"]) == ["q/k"]
        s.delete_tree("gs://never-created-bucket/p")
        assert server.deletes == 5
    finally:
        server.stop()


def test_retrying_store_deletes_through_the_inner_store(tmp_path,
                                                        monkeypatch):
    """Under fault injection ``get_store`` wraps the store; its
    ``delete`` and ``delete_tree`` reach the inner one."""
    monkeypatch.setenv("TONY_FAKE_GCS_ROOT", str(tmp_path / "gcs"))
    monkeypatch.setattr(faults, "_active",
                        faults.FaultInjector({"storage.put": "first:1"}))
    s = get_store("gs://bucket/x")
    assert isinstance(s, RetryingStore)
    f = tmp_path / "a"
    f.write_text("a")
    for key in ("x/1/a", "x/1/b", "x/2/a"):
        s.put_file(str(f), f"gs://bucket/{key}")
    s.delete("gs://bucket/x/2/a")
    s.delete_tree("gs://bucket/x/1")
    assert s.list("gs://bucket/x") == []
