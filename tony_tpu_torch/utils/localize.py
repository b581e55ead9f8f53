"""Resource localization: the ``SRC[::NAME][#archive]`` grammar + staging.

Reference model: ``LocalizableResource.java:20-30`` — ``SOURCE::PATH_IN_
CONTAINER#archive``, only SOURCE required; NAME defaults to the source
basename; ``#archive`` marks the file for unpacking at localization time
(parse :75-102). Client-side staging replaces the HDFS upload
(``TonyClient.processFinalTonyConf`` :189-228, venv zip included); executor-
side localization replaces YARN's container localizer: each resource lands
in the task working directory under NAME, archives are unpacked into a
directory called NAME (YARN archive semantics).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import shutil
import threading
from tony_tpu_torch.storage.store import is_url
from typing import Dict, List, Optional

log = logging.getLogger(__name__)

ARCHIVE_SUFFIX = "#archive"
DIVIDER = "::"

#: per-workdir record of what was localized and from which content —
#: the skip index for re-localization into the SAME workdir (retry
#: epochs reuse task dirs; warm-pool hosts reuse cache dirs).
MANIFEST_FILE = ".tony-localized.json"

#: resources/specs localized concurrently per call (bounded: the wins are
#: store-fetch latency overlap and copy pipelining, not raw thread count)
MAX_LOCALIZE_WORKERS = 4


@dataclasses.dataclass(frozen=True)
class LocalizableResource:
    source: str
    name: str
    archive: bool

    @classmethod
    def parse(cls, spec: str) -> "LocalizableResource":
        """Parse ``SRC[::NAME][#archive]`` (reference parse :75-102)."""
        s = spec.strip()
        archive = s.lower().endswith(ARCHIVE_SUFFIX)
        if archive:
            s = s[: -len(ARCHIVE_SUFFIX)]
        parts = s.split(DIVIDER)
        if len(parts) > 2 or not parts[0]:
            raise ValueError(f"failed to parse resource: {spec!r}")
        name = parts[1] if len(parts) == 2 and parts[1] \
            else os.path.basename(parts[0].rstrip("/"))
        return cls(source=parts[0], name=name, archive=archive)

    def unparse(self) -> str:
        out = self.source
        if self.name != os.path.basename(self.source.rstrip("/")):
            out += DIVIDER + self.name
        if self.archive:
            out += ARCHIVE_SUFFIX
        return out


def stage_resources(specs: List[str], stage_dir: str, store=None,
                    store_prefix: str = "") -> List[str]:
    """Client side: copy each resource into the staging area (the HDFS
    upload analogue) and return rewritten specs pointing at the staged
    copies, annotations preserved. With ``store``/``store_prefix`` the
    staged copies are PUT to the object store and the rewritten sources
    are store URLs (``tony_tpu_torch.storage``); sources that are already store
    URLs pass through untouched.

    Resources stage CONCURRENTLY (each lands in its own index-keyed
    directory/prefix, so no two copies can collide); existence is
    validated up front in the calling thread, and the returned specs keep
    submission order regardless of completion order."""
    parsed = [LocalizableResource.parse(spec) for spec in specs]
    for spec, r in zip(specs, parsed):
        if not is_url(r.source) and not os.path.exists(r.source):
            raise FileNotFoundError(
                f"resource {r.source!r} (from {spec!r}) does not exist")

    def stage_one(i: int) -> str:
        r, spec = parsed[i], specs[i]
        if is_url(r.source):
            return spec.strip()
        base = os.path.basename(r.source.rstrip("/"))
        if store is not None:
            from tony_tpu_torch.storage.store import join as ujoin

            url = ujoin(store_prefix, str(i), base)
            if os.path.isdir(r.source):
                store.put_tree(r.source, url)
            else:
                store.put_file(r.source, url)
            return LocalizableResource(url, r.name, r.archive).unparse()
        dest_dir = os.path.join(stage_dir, str(i))
        os.makedirs(dest_dir, exist_ok=True)
        staged = os.path.join(dest_dir, base)
        if os.path.isdir(r.source):
            shutil.copytree(r.source, staged, dirs_exist_ok=True)
        else:
            shutil.copy2(r.source, staged)
        return LocalizableResource(staged, r.name, r.archive).unparse()

    return _run_ordered(stage_one, len(specs))


def _run_ordered(fn, n: int) -> List[str]:
    """Run ``fn(0..n-1)`` over a bounded thread pool, results in index
    order; the first failure re-raises. Serial for n<=1 (no pool tax on
    the common single-resource case)."""
    if n <= 0:
        return []
    if n == 1:
        return [fn(0)]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(
            max_workers=min(MAX_LOCALIZE_WORKERS, n),
            thread_name_prefix="tony-localize") as pool:
        return [f.result() for f in [pool.submit(fn, i) for i in range(n)]]


def file_content_hash(path: str) -> str:
    """sha256 of a file's bytes — the localization skip key."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def tree_signature(path: str) -> str:
    """Cheap content signature for a directory tree: sha256 over the
    sorted (relpath, size, mtime_ns) triples. Not byte-exact like
    file_content_hash (hashing every byte of a big bundle would cost as
    much as the copy it tries to skip), but any file add/remove/rewrite
    changes it — the false-skip window is a same-size same-mtime in-place
    edit, which no staging path here produces."""
    h = hashlib.sha256()
    for root, dirs, files in os.walk(path):
        dirs.sort()
        for name in sorted(files):
            p = os.path.join(root, name)
            try:
                st = os.stat(p)
            except OSError:
                continue
            rel = os.path.relpath(p, path)
            h.update(f"{rel}\0{st.st_size}\0{st.st_mtime_ns}\n".encode())
    return h.hexdigest()


def source_signature(source: str) -> str:
    """Skip key for a local source: content hash for files, tree
    signature for directories."""
    return tree_signature(source) if os.path.isdir(source) \
        else file_content_hash(source)


def load_manifest(workdir: str) -> Dict[str, str]:
    try:
        with open(os.path.join(workdir, MANIFEST_FILE),
                  encoding="utf-8") as f:
            data = json.load(f)
        return data if isinstance(data, dict) else {}
    except (OSError, ValueError):
        return {}


def save_manifest(workdir: str, manifest: Dict[str, str]) -> None:
    try:
        from tony_tpu_torch.utils.durable import atomic_write

        # Durable, not just atomic: the manifest vouches for localized
        # content by hash/signature — it must never claim files whose own
        # writes a crash could still lose.
        atomic_write(os.path.join(workdir, MANIFEST_FILE),
                     json.dumps(manifest, sort_keys=True).encode("utf-8"))
    except OSError as e:  # the manifest is an optimization, never a failure
        log.debug("localization manifest write failed: %s", e)


def localize_resources(specs: List[str], workdir: str,
                       manifest: Optional[Dict[str, str]] = None
                       ) -> List[str]:
    """Executor side: place every staged resource into the task working dir
    under its container name; unpack archives into a directory named NAME
    (YARN ARCHIVE localization semantics; exercised by the reference e2e
    ``TestTonyE2E.java:322-340``). Store-URL sources are fetched through
    ``tony_tpu_torch.storage`` first — a remote task host never dereferences a
    client-local path.

    Two cold-start levers since the parallel-localize change:

    - resources localize CONCURRENTLY (index-keyed fetch dirs + distinct
      target names make the copies independent; store-fetch latency and
      copy I/O overlap instead of queuing);
    - a CONTENT-HASH skip: each placed resource's source signature lands
      in ``.tony-localized.json``; a re-localization into the same
      workdir (retry epoch, pooled-host cache) with an unchanged source
      and a still-present target is a no-op. Store-URL sources are never
      skipped — their bytes live remotely and the URL embeds the job
      prefix anyway.
    """
    # A caller-provided manifest is shared state the CALLER persists (the
    # executor folds bundle/venv/resource entries into one file); without
    # one, this function owns the load/save round trip.
    own_manifest = manifest is None
    if manifest is None:
        manifest = load_manifest(workdir) if specs else {}
    lock = threading.Lock()

    def localize_one(i: int) -> str:
        r = LocalizableResource.parse(specs[i])
        source = r.source
        target = os.path.join(workdir, r.name)
        local_source = not (is_url(source)
                            and not source.startswith("file://"))
        if local_source:
            plain = source[len("file://"):] \
                if source.startswith("file://") else source
            sig = f"{r.name}|{'archive' if r.archive else 'copy'}|" \
                  f"{source_signature(plain)}"
            if manifest.get(r.name) == sig and os.path.exists(target):
                log.debug("localization skip (content unchanged): %s",
                          r.name)
                return target
            source = plain
        else:
            from tony_tpu_torch.storage import get_store

            store = get_store(source)
            # Keyed by index: two resources may share a basename, and a
            # colliding get_tree(dirs_exist_ok) would silently merge them.
            fetched = os.path.join(workdir, ".fetch", str(i),
                                   os.path.basename(source.rstrip("/")))
            if store.isdir(source):
                store.get_tree(source, fetched)
            else:
                store.get_file(source, fetched)
            source = fetched
            sig = ""
        if r.archive:
            os.makedirs(target, exist_ok=True)
            shutil.unpack_archive(source, target)
        elif os.path.isdir(source):
            shutil.copytree(source, target, dirs_exist_ok=True)
        else:
            os.makedirs(os.path.dirname(target) or ".", exist_ok=True)
            shutil.copy2(source, target)
        if sig:
            with lock:
                manifest[r.name] = sig
        return target

    placed = _run_ordered(localize_one, len(specs))
    if specs and own_manifest:
        save_manifest(workdir, manifest)
    return placed
