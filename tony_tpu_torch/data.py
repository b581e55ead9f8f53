"""Per-process input pipeline: deterministic batches, token files, prefetch.

Counterpart of ``tony_tpu/data.py``. Every process loads ONLY its rows of
the global batch (``process_batch_slice``), and row ``r`` of step ``s`` is
a pure function of (seed, s, r), so the tokens are byte-identical to the
reference's for every (seed, step, row), whatever the process layout, and
a restart at ``start_step`` resumes the identical stream.

- ``ShardedBatchIterator`` wraps a per-process loader
  ``load_local(step, rows) -> {name: numpy array}`` and yields this
  process's rows as tensors on ``device``, with a prefetch thread that
  reads ahead while the step computes. Where the reference lays batches
  out over a mesh, the port takes ``rank``/``world`` (from
  ``torch.distributed`` when it is up); meshes come with a later slice.
- ``synthetic_lm_batches`` and ``synthetic_lm_load_local``: random tokens.
- ``TokenFileDataset`` / ``token_file_batches``: random ``seq``-token
  windows of a memory-mapped ``.bin`` corpus; ``pack_documents`` and
  ``write_token_file`` build such corpora.

Integer leaves reach the device as int64, the index dtype of torch's
embedding and loss; the loaders' int32 ids are widened, never changed.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional, Union

import numpy as np
import torch

from tony_tpu_torch import telemetry
from tony_tpu_torch._device import resolve_device


def process_batch_slice(global_batch: int, rank: Optional[int] = None,
                        world: Optional[int] = None) -> slice:
    """This process's contiguous row range of the global batch.

    ``rank``/``world`` default to the initialized ``torch.distributed``
    group, else to a single process. Every row of every step is consumed by
    exactly one process at whatever world size ran that step."""
    dist = torch.distributed
    up = dist.is_available() and dist.is_initialized()
    n = int(world) if world is not None else (dist.get_world_size()
                                              if up else 1)
    i = int(rank) if rank is not None else (dist.get_rank() if up else 0)
    if not 0 <= i < n:
        raise ValueError(f"rank {i} outside world of {n}")
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} not divisible by process count {n}")
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


def _host_tensor(x: Any, pin: bool) -> torch.Tensor:
    """A loader leaf as a CPU tensor: integers widened to int64, pinned
    when it is bound for the card."""
    t = torch.from_numpy(np.asarray(x))
    if not t.is_floating_point() and t.dtype != torch.bool:
        t = t.to(torch.int64)
    return t.pin_memory() if pin else t


@dataclasses.dataclass
class ShardedBatchIterator:
    """Yield this process's rows of each global batch from a loader.

    ``load_local(step, rows)`` returns this process's rows of the global
    batch for ``step`` as a dict of numpy arrays with leading dim
    ``rows.stop - rows.start``; the iterator yields them as tensors on
    ``device``.

    ``prefetch`` (default 2): a daemon thread loads batch N+1..N+prefetch
    into pinned host tensors while step N computes, so the host read hides
    behind the card. The consumer copies each batch to the card with
    ``non_blocking=True`` on its own current stream: the copy is ordered
    before the kernels that read it with no cross-stream wait, and the
    pinned source stays reserved until the copy is done (torch's pinned
    allocator records the copy). A batch is 4 × 2048 ids on the flagship,
    so the copy itself is cheap enough that it need not overlap. The wait
    for a batch is telemetry's ``data_wait`` phase, the copy's enqueue its
    ``h2d`` phase. 0 = fully synchronous. ``step`` reports the next step
    the CONSUMER will see — checkpoint/resume keys off consumed batches,
    not what the buffer got ahead to."""

    global_batch: int
    load_local: Callable[[int, slice], Dict[str, Any]]
    start_step: int = 0
    prefetch: int = 2
    device: Union[str, torch.device] = "cuda"
    rank: Optional[int] = None
    world: Optional[int] = None

    def __post_init__(self):
        self._dev = resolve_device(self.device)
        self._step = self.start_step        # next step the WORKER loads
        self._consumed = self.start_step    # next step the CONSUMER gets
        self._rows = process_batch_slice(self.global_batch, self.rank,
                                         self.world)
        self._q: Optional[queue.Queue] = None
        self._worker: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()

    @property
    def step(self) -> int:
        return self._consumed

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def _assemble(self, step: int) -> Dict[str, torch.Tensor]:
        pin = self._dev.type == "cuda"
        return {k: _host_tensor(v, pin)
                for k, v in self.load_local(step, self._rows).items()}

    def _worker_loop(self, stop: threading.Event, q: "queue.Queue",
                     step: int) -> None:
        # This generation's queue/event/step arrive as ARGUMENTS, bound
        # by __next__ at Thread construction: a worker that outlives a
        # close()+restart (join timeout) must keep talking to ITS queue,
        # never the successor's — and must not read or mutate the shared
        # step counter either (a late `self._step += 1` from an abandoned
        # worker would make the restarted one silently skip a batch).
        # Snapshotting inside the loop body is not enough: an abandoned
        # worker that had not yet been SCHEDULED when the restart happened
        # would snapshot the successor's state and feed duplicate batches
        # into the new queue.
        while not stop.is_set():
            try:
                item = self._assemble(step)
                step += 1
            except BaseException as e:  # noqa: BLE001 — surface on get()
                item = _PrefetchError(e)
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    break
                except queue.Full:
                    continue
            if isinstance(item, _PrefetchError):
                return                  # consumer re-raises; don't spin

    def __next__(self) -> Dict[str, torch.Tensor]:
        # The consumer-side wait — the whole read when synchronous, the
        # queue wait when the prefetch worker is behind, ~0 when it is
        # ahead — IS the training loop's input stall, telemetry's
        # data_wait phase. The copy to the card is booked apart, as h2d:
        # its enqueue can wait for room in the card's launch queue, which
        # is the card being busy, not the input being late.
        if self.prefetch <= 0:
            with telemetry.phase("data_wait"):
                host = self._assemble(self._consumed)
        else:
            if self._worker is None:
                # Fresh event per worker: a close() (or the error path
                # below) sets the old one, and a restarted worker must not
                # inherit a stop signal it would obey before producing
                # anything (the consumer's q.get() would deadlock).
                self._stop_evt = threading.Event()
                self._step = self._consumed  # resume where the consumer is
                self._q = queue.Queue(maxsize=self.prefetch)
                self._worker = threading.Thread(
                    target=self._worker_loop, name="tony-data-prefetch",
                    args=(self._stop_evt, self._q, self._step),
                    daemon=True)
                self._worker.start()
            with telemetry.phase("data_wait"):
                host = self._q.get()
            if isinstance(host, _PrefetchError):
                self.close()
                raise host.exc
        with telemetry.phase("h2d"):
            batch = {k: v.to(self._dev, non_blocking=True)
                     for k, v in host.items()}
        self._consumed += 1
        return batch

    def close(self) -> None:
        """Stop the prefetch thread (idempotent). Iterators die with their
        (daemon) thread anyway; close() makes teardown deterministic for
        tests and bounded-lifetime loops."""
        self._stop_evt.set()
        if self._worker is not None:
            # Unblock a worker parked on a full queue.
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._worker.join(timeout=5)
            self._worker = None


class _PrefetchError:
    """Exception envelope crossing the prefetch queue."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def synthetic_lm_load_local(seq: int, vocab_size: int, seed: int = 0
                            ) -> Callable[[int, slice],
                                          Dict[str, np.ndarray]]:
    """``load_local(step, rows) -> {"tokens": int32 [rows, seq]}``."""

    def load_local(step: int, rows: slice) -> Dict[str, np.ndarray]:
        out = np.empty((rows.stop - rows.start, seq), np.int32)
        for j, r in enumerate(range(rows.start, rows.stop)):
            rng = np.random.default_rng(
                np.random.SeedSequence([seed, step, r]))
            out[j] = rng.integers(0, vocab_size, size=seq, dtype=np.int32)
        return {"tokens": out}

    return load_local


def synthetic_lm_batches(global_batch: int, seq: int, vocab_size: int,
                         seed: int = 0, start_step: int = 0,
                         device: Union[str, torch.device] = "cuda",
                         prefetch: int = 2, rank: Optional[int] = None,
                         world: Optional[int] = None
                         ) -> ShardedBatchIterator:
    """Deterministic synthetic token batches: row ``r`` of step ``s`` is a
    pure function of (seed, s, r), so any process layout — and any restart
    — sees the same global batch."""
    return ShardedBatchIterator(
        global_batch=global_batch,
        load_local=synthetic_lm_load_local(seq, vocab_size, seed),
        start_step=start_step, prefetch=prefetch, device=device, rank=rank,
        world=world)


def synthetic_lm_batch(step: int, global_batch: int, seq: int,
                       vocab_size: int, seed: int = 0,
                       rank: Optional[int] = None,
                       world: Optional[int] = None,
                       device: Union[str, torch.device] = "cuda"
                       ) -> Dict[str, torch.Tensor]:
    """This process's rows of step ``step`` as int64 tensors on
    ``device``."""
    dev = resolve_device(device)
    rows = process_batch_slice(global_batch, rank, world)
    local = synthetic_lm_load_local(seq, vocab_size, seed)(step, rows)
    return {k: torch.from_numpy(v).to(dev, torch.int64)
            for k, v in local.items()}


class TokenFileDataset:
    """Memory-mapped flat token corpus (the nanoGPT/MaxText ``.bin``
    shape: one contiguous array of token ids, uint16 or uint32).

    Each (step, row) of the global batch reads a ``seq``-token window at
    a position that is a pure function of (seed, step, row) — so every
    process computes ONLY its rows (mmap pages the bytes it touches, no
    host ever loads the corpus), any process layout sees the same global
    batch, and a restart at ``start_step`` resumes the identical stream.
    Random windows are the standard LM pretraining sampling; pair with
    ``write_token_file`` for building corpora in tests/tools."""

    def __init__(self, path: str, seq: int, dtype=np.uint16,
                 seed: int = 0):
        # The seed must be explicit, never derived from hash(path) —
        # Python string hashing is salted per process, which would hand
        # every host a different "global" batch.
        self.path = path
        self.seq = seq
        self.seed = seed
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        # A window of exactly ``seq`` tokens is one complete sample — the
        # loss shifts inside the batch (causal_lm_loss: tokens[:, 1:]).
        if len(self.tokens) < seq:
            raise ValueError(
                f"{path}: corpus has {len(self.tokens)} tokens, need at "
                f"least seq = {seq}")

    def load_local(self, step: int, rows: slice) -> Dict[str, np.ndarray]:
        n = rows.stop - rows.start
        out = np.empty((n, self.seq), np.int32)
        span = len(self.tokens) - self.seq + 1   # every window, incl. last
        for j, r in enumerate(range(rows.start, rows.stop)):
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, r]))
            off = int(rng.integers(0, span))
            out[j] = self.tokens[off:off + self.seq].astype(np.int32)
        return {"tokens": out}


def token_file_batches(path: str, global_batch: int, seq: int,
                       dtype=np.uint16, seed: int = 0, start_step: int = 0,
                       device: Union[str, torch.device] = "cuda",
                       prefetch: int = 2, rank: Optional[int] = None,
                       world: Optional[int] = None) -> ShardedBatchIterator:
    """This process's LM batches from a memory-mapped token file."""
    ds = TokenFileDataset(path, seq, dtype=dtype, seed=seed)
    return ShardedBatchIterator(global_batch=global_batch,
                                load_local=ds.load_local,
                                start_step=start_step, prefetch=prefetch,
                                device=device, rank=rank, world=world)


def pack_documents(docs, seq: int, eos_id: int, pad_id: int = 0):
    """Pack variable-length tokenized documents into fixed [N, seq] rows.

    GPT-style greedy packing: documents are concatenated, each terminated
    by ``eos_id``, and the stream is sliced into rows of ``seq``. Returns
    ``(tokens, loss_mask)`` int32/float32 arrays where the mask is 0 only
    on the final row's padding — next-token targets crossing a document
    boundary stay in the loss (standard pretraining practice; the EOS
    token is what the model learns as the boundary). Attention also
    crosses packed-document boundaries (no segment masking).

    Deterministic and order-preserving, so every process packing the same
    corpus sees identical rows. Feed the result through
    ``write_token_file``/``TokenFileDataset`` for the mmap path, or slice
    rows directly for small corpora.
    """
    if seq < 2:
        raise ValueError(f"seq must be >= 2, got {seq}")
    eos = np.asarray([eos_id], np.int32)
    # Vectorized concatenation — a boxed-int Python list would cost ~28
    # bytes/token and dominate wall time on real (1e8+ token) corpora.
    pieces: list = []
    for d in docs:
        pieces.append(np.asarray(d, np.int32).ravel())
        pieces.append(eos)
    if not pieces:
        raise ValueError("no documents to pack")
    stream = np.concatenate(pieces)
    n = -(-len(stream) // seq)
    flat = np.full((n * seq,), pad_id, np.int32)
    flat[:len(stream)] = stream
    mask = np.zeros((n * seq,), np.float32)
    mask[:len(stream)] = 1.0
    return flat.reshape(n, seq), mask.reshape(n, seq)


def write_token_file(path: str, tokens: "np.ndarray",
                     dtype=np.uint16) -> str:
    """Write a flat token array as a ``.bin`` corpus (tooling/tests).
    Ids that overflow ``dtype`` fail loudly — uint16 wraps 128k-vocab ids
    silently otherwise."""
    arr = np.asarray(tokens)
    if arr.ndim != 1:
        raise ValueError(f"corpus must be flat, got shape {arr.shape}")
    info = np.iinfo(dtype)
    if arr.size and (arr.min() < info.min or arr.max() > info.max):
        raise ValueError(
            f"token ids [{arr.min()}, {arr.max()}] overflow {np.dtype(dtype)}"
            f" [{info.min}, {info.max}] — use dtype=np.uint32")
    arr.astype(dtype).tofile(path)
    return path
