"""Async checkpointing of the training state on ``torch.distributed.checkpoint``.

Counterpart of ``tony_tpu/checkpoint/manager.py``, which wraps orbax. Here
each step is a ``torch.distributed.checkpoint`` (DCP) directory
``<directory>/<step>``, written under a temporary name and renamed into
place once DCP has written and fsync'd its files, so a step that exists is
a complete write.

Resume contract with the coordinator's whole-job retry: user scripts call
``latest_step()`` at startup and restore if non-None — a retried session
transparently continues from the last completed save.

Integrity contract: every committed step gets a per-file sha256 manifest
(``tony-manifest.json`` inside the step directory), written LAST, and
verified before any restore. A restart trusts nothing about the newest
step: if it is corrupt (bit rot, truncated copy), ``restore(None, like)``
falls back to the newest step whose manifest verifies.

Overlapped mode (``async_save=True``, the default): ``save()`` pays only
the device→host snapshot on the training thread; a writer thread
serialises, fsyncs and writes the manifest, and a queued save that has not
started is superseded by a newer one (newest wins). ``wait()`` is the
durability barrier.

The snapshot finishes before ``save()`` returns. torch updates parameters
and Adam moments IN PLACE, so a device→host copy still in flight when the
next ``optimizer.step()`` runs would be a silently corrupt checkpoint: the
copies go to pinned memory (``non_blocking``) and the current stream is
synchronised before the snapshot is handed on.

A replicated tree (plain tensors) goes through DCP's single-process mode
(``no_dist``): no collective, so the writer thread never interleaves with
the training thread's collectives. Such a state is the same on every
data-parallel rank, so a job in a group saves from one rank
(``trainer.train`` saves from rank 0) and restores on every rank from a
shared directory.

A sharded tree (DTensors: the state of ``parallel.init_sharded_state``) is
written by every rank, each its own shards, through DCP's collective mode
on the default process group, synchronously on the calling thread: every
rank must take part in DCP's planning, and per-rank writer threads could
coalesce different steps. Rank 0 renames the step into place and writes the
manifest between two barriers. Restoring loads each rank's shards of the
target tree from whatever layout saved them, so a restore onto another mesh
shape re-lays the shards.

The ``torch.distributed`` world size at save time is noted in the manifest,
and with ``save(..., mesh=)`` the mesh's ``{axis: size}`` too. A restore
given the current ``mesh`` compares mesh shapes, one without it world
sizes; a difference is logged as a reshard and recorded in
``last_restore_resharded``.

The directory is a local path (bare or ``file://``, the prefix stripped) or
a ``gs://`` URL, served by ``storage.get_store`` (``FakeGcsStore`` under
``TONY_FAKE_GCS_ROOT``, else ``GcsStore``); any other scheme raises
``ValueError``. For a URL each step is written by DCP into a staging
directory private to the manager (a ``tempfile.mkdtemp``, removed by
``close()``; no fsync there, the store's objects are the durable copy),
hashed there, and uploaded object by object, the manifest
LAST: an object store has no rename, so the manifest object is the commit
point, and a step prefix without one (a torn upload) is never listed. A
sharded step is uploaded by every rank, each its own files, hashed where
they were written; rank 0 gathers the hashes and writes the manifest. A
restore downloads the whole step into the staging area (every rank of a
sharded restore its own copy), verifies it there and loads it from there.
The reference turns its manifest off for a URL, because orbax commits on
GCS by itself (``tony_tpu/checkpoint/manager.py:266-268``); here the
manifest is the commit marker, so it stays. Retention and the deletion of
a corrupt step remove the manifest object first, so that a half-deleted
step is never listed.

A job of several ranks agrees on the drain's save
(``install_preemption_handler(..., group=)``): a TERM only marks the rank,
and at each step's boundary ``preemption_point()`` all-reduces the marks
(MAX) over a host (gloo) group, so every rank sees the same answer after
the same step and the ranks save together. A rank that stops by agreement
before its own TERM arrives waits for it, at most the kill grace
(``TONY_TASK_KILL_GRACE_S``), before it exits: an exit reported before its
executor holds the drain directive would be classed as a preemption.
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import json
import logging
import os
import shutil
import tempfile
import threading
import time
import weakref
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple
from urllib.parse import urlparse

import torch
from torch.distributed.tensor import DTensor

from tony_tpu_torch import constants, faults, telemetry
from tony_tpu_torch.storage.store import get_store, is_url
from tony_tpu_torch.storage.store import join as url_join
from tony_tpu_torch.utils.durable import atomic_write, fsync_dir

log = logging.getLogger(__name__)

MANIFEST_NAME = "tony-manifest.json"
#: suffix of a step directory DCP is still writing (never listed as a step)
PARTIAL_SUFFIX = ".partial"


def _hash_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1024 * 1024), b""):
            h.update(chunk)
    return h.hexdigest()


def _world_size() -> int:
    dist = torch.distributed
    return dist.get_world_size() if (dist.is_available()
                                     and dist.is_initialized()) else 1


def _mesh_shape(mesh: Any) -> Optional[Dict[str, int]]:
    """``{axis: size}`` of a ``DeviceMesh`` (or of such a mapping)."""
    if mesh is None:
        return None
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _files_under(root: str) -> List[str]:
    """Root-relative paths of every file under ``root``, the manifest at
    its top excluded."""
    out: List[str] = []
    for base, _, files in os.walk(root):
        for f in files:
            if f == MANIFEST_NAME and base == root:
                continue
            rel = os.path.relpath(os.path.join(base, f), root)
            out.append(rel.replace(os.sep, "/"))
    return sorted(out)


def _file_entry(path: str) -> Dict[str, Any]:
    return {"sha256": _hash_file(path), "size": os.path.getsize(path)}


def _sharded(tree: Any) -> bool:
    """Does the checkpoint tree hold DTensors (a sharded state)?"""
    if isinstance(tree, DTensor):
        return True
    if isinstance(tree, dict):
        return any(_sharded(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_sharded(v) for v in tree)
    return False


def _host_snapshot(tree: Any) -> Any:
    """A frozen host copy of a checkpoint tree: CUDA tensors copied into
    pinned memory, CPU tensors cloned, other leaves deep-copied. Returns
    only after every device→host copy has landed."""
    devices = set()

    def snap(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
                return x.detach().to("cpu", non_blocking=True)
            return x.detach().clone()
        if isinstance(x, dict):
            return {k: snap(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(snap(v) for v in x)
        return copy.deepcopy(x)

    out = snap(tree)
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()
    return out


class CheckpointManager:
    """Save-interval policy, retention, integrity manifests and overlapped
    writes over DCP directories."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1, async_save: bool = True):
        directory = str(directory)
        #: the object store of a URL directory (None: a local directory)
        self._store = None
        if is_url(directory):
            parsed = urlparse(directory)
            if parsed.scheme == "file":
                directory = (parsed.netloc or "") + parsed.path
            else:
                # gs:// → the store; any other scheme raises ValueError.
                self._store = get_store(directory)
        if self._store is None:
            self._directory = os.path.abspath(directory)
            os.makedirs(self._directory, exist_ok=True)
        else:
            self._directory = directory.rstrip("/")
        # The staging area of a URL directory: made on first use, removed
        # by close() (or when the manager is collected).
        self._stage_lock = threading.Lock()
        self._stage_root: Optional[str] = None
        self._unstage: Optional[weakref.finalize] = None
        # Depth of the main thread's busy scopes: inside save()/wait(), or
        # inside a step that updates the checkpoint tree in place.
        self._busy = 0
        self._preempt: Optional[dict] = None
        # (saved, current) mesh shapes (or world sizes, for a restore given
        # no mesh) of the last restore that crossed them; None when they
        # matched (or were unknown).
        self.last_restore_resharded: Optional[tuple] = None
        self._overlap = bool(async_save)
        self._max_to_keep = max(1, int(max_to_keep))
        self._save_interval = max(1, int(save_interval_steps))
        self._wcond = threading.Condition()
        # newest wins: (step, snapshot, manifest note)
        self._wqueue: Optional[Tuple[int, Any, Dict[str, Any]]] = None
        self._winflight: Optional[int] = None
        self._wstop = False
        self._wthread: Optional[threading.Thread] = None
        self._last_queued: Optional[int] = None
        #: failed background writes ("step N: why") — the step was NOT
        #: committed; restore falls back to the last committed manifest.
        self.async_errors: List[str] = []
        #: queued-but-not-started saves replaced by a newer request
        self.coalesced_saves = 0
        #: step → seconds save() stalled the caller (the snapshot; the
        #: write too when synchronous)
        self.stall_s: Dict[int, float] = {}
        #: step → seconds its write took (serialise, fsync, manifest; for
        #: a store the hashing and the upload too)
        self.write_s: Dict[int, float] = {}

    def save(self, step: int, state: Any, force: bool = False,
             mesh: Any = None) -> bool:
        """Save the checkpoint tree ``state`` as ``step``; returns False
        when skipped by the save_interval_steps policy. In overlapped mode
        the training thread pays ONLY the device→host snapshot — the
        serialization, fsync and manifest run on a background writer, so
        a save never stalls a step; ``wait()`` is the durability barrier.
        Synchronous mode writes before returning. Every committed step gets
        an integrity manifest, written strictly AFTER its bytes are durable
        (manifest-last = the commit point). A sharded tree is written
        synchronously by every rank (module docstring), which must all call
        ``save``. ``mesh`` (the ``DeviceMesh``) is noted in the manifest,
        so that a restore onto another mesh shape is detected."""
        faults.check("checkpoint.save")
        step = int(step)
        if not force and not self.should_save(step):
            return False
        note: Dict[str, Any] = {"world": _world_size()}
        if mesh is not None:
            note["mesh"] = _mesh_shape(mesh)
        sharded = _sharded(state)
        # The card's queued work that produces the state is the step's,
        # not the save's: wait for it before the stall is timed.
        telemetry.block_until_ready(state)
        with self.updating():
            # Step-time attribution: the snapshot copy (and, synchronous,
            # the write) is the stall the training thread pays.
            with telemetry.phase("ckpt_stall"):
                t0 = time.perf_counter()
                if sharded:
                    self._write(step, state, note, sharded=True)
                else:
                    snap = _host_snapshot(state)
                    if not self._overlap:
                        self._write(step, snap, note)
                self.stall_s[step] = time.perf_counter() - t0
            if sharded or not self._overlap:
                # Committed: the interval policy need not list the
                # directory (a store's listing is a request per step).
                self._last_queued = step
            # Inside the busy scope: a TERM deferred from the snapshot
            # runs its final save after this step is queued.
            if self._overlap and not sharded:
                self._enqueue(step, snap, note)
        return True

    # -- policy and the overlapped background writer ---------------------
    def should_save(self, step: int) -> bool:
        """Would ``save(step)`` (not forced) save? The save_interval_steps
        policy, applied on the training thread (the writer always writes:
        the decision was already made here).
        Queued-but-unwritten steps count as saved so back-to-back saves
        coalesce instead of double-writing."""
        latest = self._last_queued
        if latest is None:
            latest = self.latest_step()
        if latest is None:
            return True
        if step <= latest:
            return False
        return (step - latest) >= self._save_interval \
            or step % self._save_interval == 0

    def _enqueue(self, step: int, snap: Any, note: Dict[str, Any]) -> None:
        with self._wcond:
            if self._wthread is None:
                self._wthread = threading.Thread(
                    target=self._writer_loop, name="ckpt-async-writer",
                    daemon=True)
                self._wthread.start()
            if self._wqueue is not None:
                # Newest wins: an unstarted queued save is superseded —
                # the writer never falls behind a fast save cadence.
                self.coalesced_saves += 1
                log.info("coalescing queued checkpoint step %d under "
                         "newer step %d", self._wqueue[0], step)
            self._wqueue = (step, snap, note)
            self._last_queued = step
            self._wcond.notify_all()

    def _writer_loop(self) -> None:
        while True:
            with self._wcond:
                while self._wqueue is None and not self._wstop:
                    self._wcond.wait()
                if self._wqueue is None:
                    return
                req = self._wqueue
                self._wqueue = None
                self._winflight = req[0]
            try:
                self._write_one(*req)
            finally:
                with self._wcond:
                    self._winflight = None
                    self._wcond.notify_all()

    def _write_one(self, step: int, snap: Any,
                   note: Dict[str, Any]) -> None:
        """One background save. Any failure leaves the step uncommitted
        (no manifest) — restore falls back to the previous committed
        step; an async write failure must never crash training."""
        try:
            faults.check("ckpt.async-write")
            self._write(step, snap, note)
        except Exception as e:  # noqa: BLE001 — degrade, never crash
            log.warning(
                "async checkpoint write of step %d FAILED (%s); step NOT "
                "committed — restore falls back to the last committed "
                "manifest", step, e)
            self.async_errors.append(f"step {step}: {e}")

    def _write(self, step: int, snap: Any, note: Dict[str, Any],
               sharded: bool = False) -> None:
        """DCP-save ``snap`` under a partial name, rename it into place,
        write the manifest, then drop steps beyond ``max_to_keep``. A
        sharded tree: every rank writes its shards, rank 0 does the rest,
        between barriers."""
        import torch.distributed.checkpoint as dcp

        if self._store is not None:
            return self._write_to_store(step, snap, note, sharded)
        dist = torch.distributed
        lead = not sharded or dist.get_rank() == 0
        final = self._step_dir(step)
        if os.path.exists(final):
            raise FileExistsError(f"checkpoint step {step} already exists "
                                  f"({final})")
        partial = final + PARTIAL_SUFFIX
        if lead:
            shutil.rmtree(partial, ignore_errors=True)
        if sharded:
            dist.barrier()
        t0 = time.perf_counter()
        dcp.save(snap, storage_writer=dcp.FileSystemWriter(partial),
                 no_dist=not sharded)
        if lead:
            os.rename(partial, final)
            fsync_dir(self._directory)
            self._write_manifest(step, note)
            self.write_s[step] = time.perf_counter() - t0
            for old in self.all_steps()[:-self._max_to_keep]:
                self.delete(old)
        if sharded:
            dist.barrier()

    def _write_to_store(self, step: int, snap: Any, note: Dict[str, Any],
                        sharded: bool) -> None:
        """``_write`` for a URL directory: DCP-save into the staging area,
        upload each file with its hash, the manifest last (the commit
        point), then drop steps beyond ``max_to_keep``. A sharded tree:
        every rank uploads and hashes its own files, rank 0 gathers the
        hashes and writes the manifest, between barriers."""
        import torch.distributed.checkpoint as dcp

        dist = torch.distributed
        lead = not sharded or dist.get_rank() == 0
        url = self._step_url(step)
        if self._has_manifest(step):
            raise FileExistsError(f"checkpoint step {step} already exists "
                                  f"({url})")
        if lead:
            self._store.delete_tree(url)    # a torn upload's objects
        if sharded:
            dist.barrier()
        t0 = time.perf_counter()
        stage = self._stage(f"save-{step}")
        try:
            # No fsync: the staged copy is scratch, read back at once and
            # removed; the store's objects are the durable copy.
            dcp.save(snap, storage_writer=dcp.FileSystemWriter(
                stage, sync_files=False), no_dist=not sharded)
            files: Dict[str, Dict[str, Any]] = {}
            for rel in _files_under(stage):
                path = os.path.join(stage, rel.replace("/", os.sep))
                files[rel] = _file_entry(path)
                self._store.put_file(path, url_join(url, rel))
            if sharded:
                # Rank 0 cannot hash files that are on another host's disk.
                gathered: List[Any] = [None] * dist.get_world_size()
                dist.all_gather_object(gathered, files)
                files = {k: v for part in gathered for k, v in part.items()}
            if lead:
                doc = {"step": int(step), "files": files, **note}
                manifest = os.path.join(stage, MANIFEST_NAME)
                with open(manifest, "wb") as f:
                    f.write(json.dumps(doc, sort_keys=True).encode("utf-8"))
                self._store.put_file(manifest, self.manifest_path(step))
                self.write_s[step] = time.perf_counter() - t0
        finally:
            shutil.rmtree(stage, ignore_errors=True)
        if lead:
            for old in self.all_steps()[:-self._max_to_keep]:
                self.delete(old)
        if sharded:
            dist.barrier()

    def _staging(self) -> str:
        """The manager's private staging directory."""
        with self._stage_lock:
            if self._unstage is None or not self._unstage.alive:
                self._stage_root = tempfile.mkdtemp(prefix="tony-ckpt-")
                self._unstage = weakref.finalize(
                    self, shutil.rmtree, self._stage_root, True)
            return self._stage_root

    def _stage(self, name: str) -> str:
        """A path ``name`` in the staging area, with nothing there."""
        path = os.path.join(self._staging(), name)
        shutil.rmtree(path, ignore_errors=True)
        return path

    def _drain_writer(self) -> None:
        """Block until the writer queue is empty and no write is in
        flight (the durability barrier of overlapped mode)."""
        if self._wthread is None:
            return
        with self._wcond:
            while self._wqueue is not None or self._winflight is not None:
                self._wcond.wait()

    # -- steps on disk or in the store -------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self._directory, str(step))

    def _step_url(self, step: int) -> str:
        return url_join(self._directory, str(step))

    def all_steps(self) -> List[int]:
        """Committed steps, oldest first: renamed into place, or in a store
        holding their manifest object."""
        if self._store is not None:
            return sorted(int(n) for n in self._store.list(self._directory)
                          if n.isdigit() and self._has_manifest(int(n)))
        return sorted(int(n) for n in os.listdir(self._directory)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self._directory, n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def delete(self, step: int) -> None:
        if self._store is None:
            shutil.rmtree(self._step_dir(step))
            return
        # Manifest first: a step deleted halfway is no longer listed.
        try:
            self._store.delete(self.manifest_path(step))
        except FileNotFoundError:
            pass
        self._store.delete_tree(self._step_url(step))

    def step_bytes(self, step: int) -> int:
        """Bytes of a committed step's files, its manifest included."""
        if self._store is not None:
            raw = self._manifest_bytes(step)
            if raw is None:
                return 0
            files = json.loads(raw.decode("utf-8")).get("files") or {}
            return len(raw) + sum(int(m["size"]) for m in files.values())
        root = self._step_dir(step)
        return sum(os.path.getsize(os.path.join(base, f))
                   for base, _, files in os.walk(root) for f in files)

    @contextlib.contextmanager
    def _step_root(self, step: int) -> Iterator[str]:
        """A local directory holding the step's files: its own directory,
        or for a store a download of it into the staging area, removed
        afterwards."""
        if self._store is None:
            yield self._step_dir(step)
            return
        root = self._stage(f"restore-{step}")
        try:
            self._store.get_tree(self._step_url(step), root)
            yield root
        finally:
            shutil.rmtree(root, ignore_errors=True)

    # -- integrity -------------------------------------------------------
    def _step_files(self, step: int) -> List[str]:
        """Step-relative paths of every file of a step (manifest excluded)."""
        return _files_under(self._step_dir(step))

    def _write_manifest(self, step: int, note: Dict[str, Any]) -> None:
        root = self._step_dir(step)
        files = {rel: _file_entry(os.path.join(root, rel.replace("/", os.sep)))
                 for rel in self._step_files(step)}
        doc = {"step": int(step), "files": files, **note}
        # The manifest is the verified-restore contract: it must never be
        # adoptable half-written, and it must survive the host crash that
        # the restore is for — full atomic_write discipline.
        atomic_write(os.path.join(root, MANIFEST_NAME),
                     json.dumps(doc, sort_keys=True).encode("utf-8"))

    def manifest_path(self, step: int) -> str:
        """The manifest's path, or its object's URL in a store."""
        if self._store is not None:
            return url_join(self._step_url(step), MANIFEST_NAME)
        return os.path.join(self._step_dir(step), MANIFEST_NAME)

    def _has_manifest(self, step: int) -> bool:
        if self._store is not None:
            return self._store.exists(self.manifest_path(step))
        return os.path.exists(self.manifest_path(step))

    def _manifest_bytes(self, step: int) -> Optional[bytes]:
        """The manifest's bytes (None: the step has none)."""
        if self._store is None:
            try:
                with open(self.manifest_path(step), "rb") as f:
                    return f.read()
            except OSError:
                return None
        fd, tmp = tempfile.mkstemp(dir=self._staging())
        os.close(fd)
        try:
            self._store.get_file(self.manifest_path(step), tmp)
            with open(tmp, "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None
        finally:
            with contextlib.suppress(OSError):
                os.unlink(tmp)

    def _manifest(self, step: int) -> Optional[dict]:
        raw = self._manifest_bytes(step)
        try:
            return None if raw is None else json.loads(raw.decode("utf-8"))
        except ValueError:
            return None

    def verify_step(self, step: int) -> bool:
        """True iff the step has a manifest and every listed file exists
        with matching size+sha256 (extra files are tolerated). A step in a
        store is downloaded to be checked."""
        try:
            with self._step_root(step) as root:
                return self._verify(step, root)
        except FileNotFoundError:
            return False

    def _verify(self, step: int, root: str) -> bool:
        """``verify_step`` on the step's files under ``root``."""
        try:
            with open(os.path.join(root, MANIFEST_NAME),
                      encoding="utf-8") as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return False
        for rel, meta in (manifest.get("files") or {}).items():
            p = os.path.join(root, rel.replace("/", os.sep))
            try:
                if os.path.getsize(p) != meta.get("size"):
                    log.warning("checkpoint step %d: %s size mismatch",
                                step, rel)
                    return False
                if _hash_file(p) != meta.get("sha256"):
                    log.warning("checkpoint step %d: %s checksum mismatch",
                                step, rel)
                    return False
            except OSError:
                log.warning("checkpoint step %d: %s missing/unreadable",
                            step, rel)
                return False
        return True

    def latest_verified_step(self) -> Optional[int]:
        """Newest step whose manifest verifies (None when none do)."""
        self.wait()
        for step in reversed(self.all_steps()):
            if self.verify_step(step):
                return step
        return None

    def saved_world_size(self, step: int) -> Optional[int]:
        """The torch.distributed world size noted in a step's manifest at
        save time (None: no manifest)."""
        try:
            return int(self._manifest(step)["world"])
        except (ValueError, KeyError, TypeError):
            return None

    def saved_mesh_shape(self, step: int) -> Optional[Dict[str, int]]:
        """The ``{axis: size}`` mesh shape noted in a step's manifest at
        save time (None: no manifest, or saved without a mesh)."""
        try:
            return _mesh_shape(self._manifest(step).get("mesh"))
        except (ValueError, AttributeError, TypeError):
            return None

    def _note_reshard(self, step: int, mesh: Any) -> None:
        """Record whether this restore crosses mesh shapes (given ``mesh``,
        the current one) or world sizes (without): the elastic re-mesh
        path, logged as a reshard."""
        self.last_restore_resharded = None
        if mesh is not None:
            saved, current = self.saved_mesh_shape(step), _mesh_shape(mesh)
        else:
            saved, current = self.saved_world_size(step), _world_size()
        if saved is not None and saved != current:
            self.last_restore_resharded = (saved, current)
            log.warning("checkpoint step %d: resharding on restore — saved "
                        "at %s, restoring onto %s", step, saved, current)

    def _load(self, step: int, like: Any, root: str, mesh: Any = None) -> Any:
        import torch.distributed.checkpoint as dcp

        if not os.path.isdir(root):
            raise FileNotFoundError(f"no checkpoint step {step} in "
                                    f"{self._directory}")
        self._note_reshard(step, mesh)
        dcp.load(like, storage_reader=dcp.FileSystemReader(root),
                 no_dist=not _sharded(like))
        return like

    def restore(self, step: Optional[int], like: Any,
                verify: bool = True, mesh: Any = None) -> Any:
        """Restore ``step`` (or the newest GOOD step when None) into
        ``like``, a checkpoint tree of the same structure (for the training
        state: ``parallel.checkpoint_tree`` of a freshly built state). DCP
        loads in place: the tensors of ``like`` receive the saved values,
        its other leaves are replaced, and ``like`` is returned.

        With ``step=None`` and ``verify`` (the default), candidates are
        tried newest-first: a step whose manifest verifies is restored; a
        step whose manifest FAILS verification (truncated/corrupt files)
        is skipped with a warning and deleted; a step with no manifest at
        all (the process died before the manifest was written) is attempted
        and skipped only if DCP itself rejects it. An explicit ``step`` is
        restored as requested — failing loudly if its manifest does not
        verify. A step in a store is downloaded into the staging area,
        checked and loaded there. A sharded ``like`` is loaded by every rank, each its own
        shards, from whatever layout saved them. ``mesh`` (the current
        ``DeviceMesh``) is compared with the mesh shape the step noted
        (``last_restore_resharded``)."""
        if step is not None:
            step = int(step)
            self._drain_writer()   # an in-flight write of THIS step
            with self._step_root(step) as root:
                if verify and os.path.exists(os.path.join(
                        root, MANIFEST_NAME)) \
                        and not self._verify(step, root):
                    raise IOError(
                        f"checkpoint step {step} failed integrity "
                        f"verification ({self.manifest_path(step)})")
                return self._load(step, like, root, mesh)
        self.wait()
        candidates = list(reversed(self.all_steps()))
        if not candidates:
            raise FileNotFoundError("no checkpoint to restore")
        errors: List[str] = []
        for cand in candidates:
            try:
                with self._step_root(cand) as root:
                    corrupt = verify and os.path.exists(
                        os.path.join(root, MANIFEST_NAME)) \
                        and not self._verify(cand, root)
                    out = None if corrupt else self._load(cand, like, root,
                                                          mesh)
            except Exception as e:  # noqa: BLE001 — try the next-older step
                if not verify:
                    raise
                log.warning("restore of step %d failed (%s); trying older",
                            cand, e)
                errors.append(f"step {cand}: {e}")
                continue
            if not corrupt:
                if cand != candidates[0]:
                    log.warning("restored verified step %d (newest was %d)",
                                cand, candidates[0])
                return out
            log.warning(
                "checkpoint step %d is PARTIAL/CORRUPT — falling back "
                "to the previous verified step", cand)
            errors.append(f"step {cand}: integrity check failed")
            # Quarantine: a rejected step would keep shadowing
            # latest_step() AND block the resumed run from re-saving
            # the same step number.
            try:
                self.delete(cand)
                log.warning("deleted corrupt checkpoint step %d", cand)
            except OSError as e:
                log.warning("could not delete corrupt step %d: %s",
                            cand, e)
        raise FileNotFoundError(
            "no restorable checkpoint: " + "; ".join(errors))

    # -- preemption ------------------------------------------------------
    @contextlib.contextmanager
    def updating(self) -> Iterator[None]:
        """Mark the main thread busy: inside a save or wait, or inside a
        training step that updates the checkpoint tree IN PLACE (torch's
        optimizers write parameters and moments one tensor after
        another). A SIGTERM landing inside is deferred, and the final
        save runs when the outermost scope ends, at the step's boundary:
        a snapshot taken between two tensors' updates would be a torn
        checkpoint. (The reference's snapshot is an immutable pytree and
        needs no such scope for the step.)"""
        self._busy += 1
        try:
            yield
        finally:
            self._busy -= 1
            self._run_deferred_preemption()

    def install_preemption_handler(self, snapshot, exit_code: int = 143,
                                   mesh: Any = None,
                                   group: Any = None) -> None:
        """Save-on-SIGTERM: when the job is being torn down, synchronously
        save the state ``snapshot()`` returns, then exit.

        The kill chain's TERM→grace→KILL contract gives the handler the
        grace to make one final durable save, so a resumed job loses zero
        completed steps instead of rolling back to the last periodic save.
        ``snapshot`` must return ``(step, checkpoint tree)`` and be cheap
        to call from the main thread (it runs between Python bytecodes).
        Queued saves are made durable first, and a step they committed is
        not saved again. ``mesh`` is passed to ``save``. Wrap in-place
        updates of the tree in ``updating()``.

        ``group``, a gloo process group of every rank of a job of several
        ranks: a TERM only marks this rank, and the save runs from
        ``preemption_point()``, which every rank calls at each step's
        boundary. The ranks save together there: each its own shards of a
        sharded tree; a replicated tree from rank 0 while the others wait
        at a barrier of ``group``.

        Install from the MAIN thread of the training process. Exits with
        ``exit_code`` (default 143 = 128+SIGTERM).
        ``remove_preemption_handler`` puts the previous handler back.
        """
        import signal

        self._preempt = {"fired": False, "deferred": False,
                         "snapshot": snapshot, "exit_code": exit_code,
                         "mesh": mesh, "group": group,
                         "previous": signal.getsignal(signal.SIGTERM)}

        def _handler(signum, frame):
            st = self._preempt
            st["deferred"] = True
            if st["fired"] or st["group"] is not None:
                # Teardown delivers TERM more than once — first one wins.
                # In a job of several ranks the boundary acts on it.
                return
            if self._busy:
                # TERM landed while the main thread is INSIDE a save, a
                # wait or an in-place update: a re-entrant save would
                # corrupt the in-flight write or snapshot a half-updated
                # tree. Defer: the end of the outermost busy scope runs
                # the final save.
                return
            st["fired"] = True
            self._do_preemption_save()

        signal.signal(signal.SIGTERM, _handler)

    def remove_preemption_handler(self) -> None:
        """Put back the SIGTERM handler that ``install_preemption_handler``
        replaced."""
        import signal

        st, self._preempt = self._preempt, None
        if st is not None:
            # None: the previous handler was not installed from Python.
            signal.signal(signal.SIGTERM, st["previous"] or signal.SIG_DFL)

    def _run_deferred_preemption(self) -> None:
        st = self._preempt
        if (st is not None and st["deferred"] and not st["fired"]
                and st["group"] is None and not self._busy):
            st["fired"] = True
            self._do_preemption_save()

    def preemption_point(self) -> None:
        """The step's boundary in a job of several ranks (a handler
        installed with ``group``; otherwise a no-op). A collective over
        ``group``: every rank calls it after the same step. The ranks
        all-reduce (MAX) whether any of them has taken a TERM; the
        all-reduce is itself in lock-step, so all see the same answer
        after the same step, and on a TERM they all run the final save
        and exit."""
        st = self._preempt
        if st is None or st["group"] is None or st["fired"]:
            return
        dist = torch.distributed
        flag = torch.tensor([int(st["deferred"])], dtype=torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=st["group"])
        if flag.item():
            st["fired"] = True
            self._do_preemption_save()

    def _do_preemption_save(self) -> None:
        import sys

        st = self._preempt
        group = st["group"]
        dist = torch.distributed
        t0 = time.perf_counter()
        try:
            step, state = st["snapshot"]()
            step = int(step)
            self.wait()
            if group is None:
                saves, saved = True, self._has_manifest(step)
            elif _sharded(state):
                # Every rank takes part in a sharded save: all act on rank
                # 0's view of whether the step is already committed.
                flag = torch.tensor([int(dist.get_rank() == 0
                                         and self._has_manifest(step))],
                                    dtype=torch.int32)
                dist.broadcast(flag, src=0, group=group)
                saves, saved = True, bool(flag.item())
            else:
                saves = dist.get_rank() == 0
                saved = saves and self._has_manifest(step)
            if saves and saved:
                log.warning("SIGTERM: step %d is already saved", step)
            elif saves:
                log.warning("SIGTERM: saving preemption checkpoint at "
                            "step %d", step)
                self.save(step, state, force=True, mesh=st["mesh"])
                self.wait()
        except Exception:  # noqa: BLE001 — still exit promptly
            log.exception("preemption save failed")
        if group is not None:
            try:
                dist.barrier(group=group)   # rank 0's save is durable
            except Exception:  # noqa: BLE001 — still exit promptly
                log.exception("preemption barrier failed")
        log.warning("preemption checkpoint durable in %.3f s; exiting",
                    time.perf_counter() - t0)
        if group is not None and not st["deferred"]:
            self._await_term(st)
        sys.exit(st["exit_code"])

    @staticmethod
    def _await_term(st: dict) -> None:
        """Wait, at most the kill grace, for this rank's own TERM: a rank
        that stopped by agreement must not exit before its executor holds
        the drain directive."""
        grace = float(os.environ.get(constants.TASK_KILL_GRACE_ENV, "15")
                      or 15)
        log.warning("stopped by the ranks' agreement; waiting up to %.0f s "
                    "for this rank's own SIGTERM", grace)
        deadline = time.monotonic() + grace
        while not st["deferred"] and time.monotonic() < deadline:
            time.sleep(0.05)

    def wait(self) -> None:
        """Block until queued async saves are durable (call before exit)."""
        # A mid-training wait() is exactly the stall async checkpointing
        # exists to avoid — attribute it.
        with self.updating(), telemetry.phase("ckpt_stall"):
            self._drain_writer()

    def close(self) -> None:
        self._drain_writer()
        with self._wcond:
            self._wstop = True
            self._wcond.notify_all()
        if self._wthread is not None:
            self._wthread.join(timeout=30)
            self._wthread = None
        if self._unstage is not None:
            self._unstage()

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.wait()
        self.close()
