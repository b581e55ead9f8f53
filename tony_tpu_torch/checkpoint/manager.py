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
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import json
import logging
import os
import shutil
import threading
import time
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from tony_tpu_torch import faults, telemetry
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
        self._directory = os.path.abspath(str(directory))
        os.makedirs(self._directory, exist_ok=True)
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
        #: step → seconds its write took (serialise, fsync, manifest)
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

    def _drain_writer(self) -> None:
        """Block until the writer queue is empty and no write is in
        flight (the durability barrier of overlapped mode)."""
        if self._wthread is None:
            return
        with self._wcond:
            while self._wqueue is not None or self._winflight is not None:
                self._wcond.wait()

    # -- steps on disk -----------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self._directory, str(step))

    def all_steps(self) -> List[int]:
        """Committed (renamed-into-place) steps, oldest first."""
        return sorted(int(n) for n in os.listdir(self._directory)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self._directory, n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def delete(self, step: int) -> None:
        shutil.rmtree(self._step_dir(step))

    def step_bytes(self, step: int) -> int:
        """Bytes of a committed step's files, its manifest included."""
        root = self._step_dir(step)
        return sum(os.path.getsize(os.path.join(base, f))
                   for base, _, files in os.walk(root) for f in files)

    # -- integrity -------------------------------------------------------
    def _step_files(self, step: int) -> List[str]:
        """Step-relative paths of every file of a step (manifest excluded)."""
        root = self._step_dir(step)
        out: List[str] = []
        for base, _, files in os.walk(root):
            for f in files:
                if f == MANIFEST_NAME and base == root:
                    continue
                rel = os.path.relpath(os.path.join(base, f), root)
                out.append(rel.replace(os.sep, "/"))
        return sorted(out)

    def _write_manifest(self, step: int, note: Dict[str, Any]) -> None:
        root = self._step_dir(step)
        files: Dict[str, Dict[str, Any]] = {}
        for rel in self._step_files(step):
            p = os.path.join(root, rel.replace("/", os.sep))
            files[rel] = {"sha256": _hash_file(p),
                          "size": os.path.getsize(p)}
        doc = {"step": int(step), "files": files, **note}
        # The manifest is the verified-restore contract: it must never be
        # adoptable half-written, and it must survive the host crash that
        # the restore is for — full atomic_write discipline.
        atomic_write(os.path.join(root, MANIFEST_NAME),
                     json.dumps(doc, sort_keys=True).encode("utf-8"))

    def manifest_path(self, step: int) -> str:
        return os.path.join(self._step_dir(step), MANIFEST_NAME)

    def verify_step(self, step: int) -> bool:
        """True iff the step has a manifest and every listed file exists
        with matching size+sha256 (extra files are tolerated)."""
        try:
            with open(self.manifest_path(step), encoding="utf-8") as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return False
        root = self._step_dir(step)
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
            with open(self.manifest_path(step), encoding="utf-8") as f:
                return int(json.load(f)["world"])
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def saved_mesh_shape(self, step: int) -> Optional[Dict[str, int]]:
        """The ``{axis: size}`` mesh shape noted in a step's manifest at
        save time (None: no manifest, or saved without a mesh)."""
        try:
            with open(self.manifest_path(step), encoding="utf-8") as f:
                return _mesh_shape(json.load(f).get("mesh"))
        except (OSError, ValueError, AttributeError, TypeError):
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

    def _load(self, step: int, like: Any, mesh: Any = None) -> Any:
        import torch.distributed.checkpoint as dcp

        root = self._step_dir(step)
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
        verify. A sharded ``like`` is loaded by every rank, each its own
        shards, from whatever layout saved them. ``mesh`` (the current
        ``DeviceMesh``) is compared with the mesh shape the step noted
        (``last_restore_resharded``)."""
        if step is not None:
            step = int(step)
            self._drain_writer()   # an in-flight write of THIS step
            if verify and os.path.exists(self.manifest_path(step)) \
                    and not self.verify_step(step):
                raise IOError(
                    f"checkpoint step {step} failed integrity "
                    f"verification ({self.manifest_path(step)})")
            return self._load(step, like, mesh)
        self.wait()
        candidates = list(reversed(self.all_steps()))
        if not candidates:
            raise FileNotFoundError("no checkpoint to restore")
        errors: List[str] = []
        for cand in candidates:
            has_manifest = os.path.exists(self.manifest_path(cand))
            if verify and has_manifest and not self.verify_step(cand):
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
                continue
            try:
                out = self._load(cand, like, mesh)
                if cand != candidates[0]:
                    log.warning("restored verified step %d (newest was %d)",
                                cand, candidates[0])
                return out
            except Exception as e:  # noqa: BLE001 — try the next-older step
                if not verify:
                    raise
                log.warning("restore of step %d failed (%s); trying older",
                            cand, e)
                errors.append(f"step {cand}: {e}")
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
                                   mesh: Any = None) -> None:
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

        Install from the MAIN thread of the training process. Exits with
        ``exit_code`` (default 143 = 128+SIGTERM).
        ``remove_preemption_handler`` puts the previous handler back.
        """
        import signal

        self._preempt = {"fired": False, "deferred": False,
                         "snapshot": snapshot, "exit_code": exit_code,
                         "mesh": mesh,
                         "previous": signal.getsignal(signal.SIGTERM)}

        def _handler(signum, frame):
            st = self._preempt
            if st["fired"]:
                # Teardown delivers TERM more than once — first one wins.
                return
            if self._busy:
                # TERM landed while the main thread is INSIDE a save, a
                # wait or an in-place update: a re-entrant save would
                # corrupt the in-flight write or snapshot a half-updated
                # tree. Defer: the end of the outermost busy scope runs
                # the final save.
                st["deferred"] = True
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
                and not self._busy):
            st["fired"] = True
            self._do_preemption_save()

    def _do_preemption_save(self) -> None:
        import sys

        st = self._preempt
        t0 = time.perf_counter()
        try:
            step, state = st["snapshot"]()
            step = int(step)
            self.wait()
            if os.path.exists(self.manifest_path(step)):
                log.warning("SIGTERM: step %d is already saved", step)
            else:
                log.warning("SIGTERM: saving preemption checkpoint at "
                            "step %d", step)
                self.save(step, state, force=True, mesh=st["mesh"])
                self.wait()
            log.warning("preemption checkpoint durable in %.3f s; exiting",
                        time.perf_counter() - t0)
        except Exception:  # noqa: BLE001 — still exit promptly
            log.exception("preemption save failed")
        sys.exit(st["exit_code"])

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

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.wait()
        self.close()
