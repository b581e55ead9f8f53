"""Port parity: the input pipeline of tony_tpu_torch.data against
tony_tpu.data — the ids of every (seed, step, row), token files, packing,
the prefetching iterator's stream, resume and restart, and its data_wait
phase.

Ids are compared byte for byte: the port carries them as int64 on the
device, the reference as int32; the int32 bytes of the port's ids must
equal the reference's."""

import threading
import time

import numpy as np
import pytest
import torch

from tony_tpu import data as jdata
from tony_tpu.parallel import MeshSpec, build_mesh
from tony_tpu_torch import data as tdata
from tony_tpu_torch import telemetry, trainer
from tony_tpu_torch.models.transformer import TransformerConfig

torch.set_num_threads(2)
GB, SEQ, VOCAB = 8, 16, 1000


@pytest.fixture(scope="module")
def mesh():
    return build_mesh(MeshSpec())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("corpus") / "corpus.bin")
    ids = np.random.default_rng(3).integers(0, VOCAB, size=5000)
    return jdata.write_token_file(path, ids)


def _ids(batch):
    tok = batch["tokens"]
    assert tok.dtype == torch.int64 and tok.device.type == "cpu"
    return tok.numpy().astype(np.int32)


def _iters(source, mesh, corpus, seed, prefetch, start_step=0, **kw):
    if source == "synthetic":
        ref = jdata.synthetic_lm_batches(mesh, GB, SEQ, VOCAB, seed=seed,
                                         start_step=start_step)
        ours = tdata.synthetic_lm_batches(GB, SEQ, VOCAB, seed=seed,
                                          start_step=start_step,
                                          device="cpu", prefetch=prefetch,
                                          **kw)
    else:
        ref = jdata.token_file_batches(mesh, corpus, GB, SEQ, seed=seed,
                                       start_step=start_step)
        ours = tdata.token_file_batches(corpus, GB, SEQ, seed=seed,
                                        start_step=start_step, device="cpu",
                                        prefetch=prefetch, **kw)
    ref.prefetch = 0
    return ref, ours


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("source", ["synthetic", "token_file"])
def test_ids_byte_identical_to_reference(mesh, corpus, source, prefetch):
    ref, ours = _iters(source, mesh, corpus, 5, prefetch)
    _, half = _iters(source, mesh, corpus, 5, prefetch, rank=1, world=2)
    try:
        for step in range(4):
            want = np.asarray(next(ref)["tokens"])
            assert want.dtype == np.int32
            assert _ids(next(ours)).tobytes() == want.tobytes(), step
            # One rank of a two-process world gets exactly its rows.
            assert _ids(next(half)).tobytes() == want[4:].tobytes(), step
        assert ours.step == half.step == 4
    finally:
        ours.close()
        half.close()


@pytest.mark.parametrize("seed,step,rows", [
    (0, 0, slice(0, 8)), (3, 5, slice(2, 6)), (11, 9, slice(7, 8))])
def test_token_file_dataset_load_local_identical(corpus, seed, step, rows):
    ref = jdata.TokenFileDataset(corpus, SEQ, seed=seed).load_local(step,
                                                                   rows)
    ours = tdata.TokenFileDataset(corpus, SEQ, seed=seed).load_local(step,
                                                                    rows)
    assert ours["tokens"].dtype == ref["tokens"].dtype == np.int32
    assert ours["tokens"].tobytes() == ref["tokens"].tobytes()
    # windows are contiguous corpus slices
    flat = np.fromfile(corpus, np.uint16)
    for row in ours["tokens"]:
        hits = np.flatnonzero(np.lib.stride_tricks.sliding_window_view(
            flat, SEQ).astype(np.int32).__eq__(row).all(1))
        assert hits.size >= 1


@pytest.mark.parametrize("docs,seq,eos,pad", [
    ([[5, 6, 7], [8], [9, 10, 11, 12, 13]], 4, 1, 0),
    ([[5, 6]], 4, 1, 0),
    ([[3, 4, 5], [6, 7]], 8, 1, 9),
    ([np.arange(10), [], [2]], 3, 0, 7),
])
def test_pack_documents_identical(docs, seq, eos, pad):
    rt, rm = jdata.pack_documents(docs, seq, eos, pad)
    tt, tm = tdata.pack_documents(docs, seq, eos, pad)
    for a, b in ((tt, rt), (tm, rm)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("docs,seq,match", [
    ([], 4, "no documents"), ([[1, 2]], 1, "seq must be >= 2")])
def test_pack_documents_errors_match(docs, seq, match):
    for mod in (jdata, tdata):
        with pytest.raises(ValueError, match=match):
            mod.pack_documents(docs, seq, eos_id=1)


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
def test_write_token_file_identical_bytes(tmp_path, dtype):
    ids = np.random.default_rng(0).integers(0, 60000, size=777)
    a = jdata.write_token_file(str(tmp_path / "ref.bin"), ids, dtype=dtype)
    b = tdata.write_token_file(str(tmp_path / "ours.bin"), ids, dtype=dtype)
    assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("tokens,match", [
    (np.array([70000], dtype=np.int64), "overflow"),
    (np.zeros((2, 3), np.int64), "must be flat")])
def test_write_token_file_errors_match(tmp_path, tokens, match):
    for mod in (jdata, tdata):
        with pytest.raises(ValueError, match=match):
            mod.write_token_file(str(tmp_path / "x.bin"), tokens)


def test_short_corpus_rejected_and_exact_window(tmp_path):
    short = tdata.write_token_file(str(tmp_path / "short.bin"),
                                   np.arange(8, dtype=np.uint16))
    for mod in (jdata, tdata):
        with pytest.raises(ValueError, match="need at least"):
            mod.TokenFileDataset(short, seq=16)
    exact = tdata.TokenFileDataset(
        tdata.write_token_file(str(tmp_path / "exact.bin"),
                               np.arange(16, dtype=np.uint16)), seq=16)
    np.testing.assert_array_equal(
        exact.load_local(0, slice(0, 2))["tokens"],
        np.broadcast_to(np.arange(16), (2, 16)))


@pytest.mark.parametrize("prefetch", [0, 2])
def test_resume_at_start_step(prefetch):
    a = tdata.synthetic_lm_batches(GB, SEQ, 50, seed=7, device="cpu",
                                   prefetch=prefetch)
    b = tdata.synthetic_lm_batches(GB, SEQ, 50, seed=7, start_step=2,
                                   device="cpu", prefetch=prefetch)
    c = tdata.synthetic_lm_batches(GB, SEQ, 50, seed=8, device="cpu",
                                   prefetch=prefetch)
    try:
        first = [next(a)["tokens"] for _ in range(3)]
        # restart from step 2 (the checkpoint/resume path): same stream
        assert b.step == 2
        assert torch.equal(next(b)["tokens"], first[2])
        assert b.step == 3
        # a different seed is a different stream
        assert not torch.equal(next(c)["tokens"], first[0])
    finally:
        for it in (a, b, c):
            it.close()


def test_prefetch_yields_identical_stream():
    """The prefetching path must hand the consumer exactly the synchronous
    stream and report `step` as CONSUMED batches, not how far the buffer
    ran ahead."""
    sync = tdata.synthetic_lm_batches(GB, SEQ, 50, seed=11, device="cpu",
                                      prefetch=0)
    pre = tdata.synthetic_lm_batches(GB, SEQ, 50, seed=11, device="cpu")
    assert pre.prefetch == 2
    try:
        for i in range(5):
            assert torch.equal(next(pre)["tokens"], next(sync)["tokens"])
            assert pre.step == i + 1
    finally:
        pre.close()


def test_custom_loader_and_multiple_leaves():
    def load_local(step, rows):
        n = rows.stop - rows.start
        return {"x": np.full((n, 4), step, np.float32),
                "y": np.arange(rows.start, rows.stop, dtype=np.int32)}

    it = tdata.ShardedBatchIterator(global_batch=8, load_local=load_local,
                                    device="cpu", prefetch=0)
    b0 = next(it)
    assert b0["x"].dtype == torch.float32 and float(b0["x"][0, 0]) == 0.0
    assert b0["y"].dtype == torch.int64 and b0["y"].shape == (8,)
    assert float(next(it)["x"][0, 0]) == 1.0
    assert it.step == 2


def test_prefetch_surfaces_loader_errors():
    def boom(step, rows):
        if step >= 2:
            raise RuntimeError("corpus truncated")
        return {"x": np.zeros((rows.stop - rows.start, 2), np.float32)}

    it = tdata.ShardedBatchIterator(global_batch=8, load_local=boom,
                                    device="cpu", prefetch=2)
    next(it)
    next(it)
    with pytest.raises(RuntimeError, match="corpus truncated"):
        for _ in range(3):
            next(it)
    it.close()


def test_indivisible_batch_rejected():
    with pytest.raises(ValueError, match="not divisible"):
        tdata.ShardedBatchIterator(global_batch=3, load_local=None,
                                   device="cpu", rank=0, world=2)
    with pytest.raises(ValueError, match="not divisible"):
        jdata.process_batch_slice(3, 0, 2)
    # 8 rows over 4 processes, process 2 → rows 4:6
    assert tdata.process_batch_slice(8, 2, 4) == slice(4, 6)


def test_close_and_restart_neither_skips_nor_repeats():
    """close() while the worker is stuck inside a load abandons it (join
    times out); the restarted generation resumes at the consumer's step,
    and the abandoned worker, released later, feeds nothing into it."""
    gate = threading.Event()
    loaded = []

    def load_local(step, rows):
        loaded.append(step)
        if step == 3:
            gate.wait(timeout=30)
        return {"s": np.full((rows.stop - rows.start,), step, np.int64)}

    it = tdata.ShardedBatchIterator(global_batch=2, load_local=load_local,
                                    device="cpu", prefetch=2)
    seen = [int(next(it)["s"][0]) for _ in range(2)]
    deadline = time.monotonic() + 10
    while 3 not in loaded:
        assert time.monotonic() < deadline, "worker never reached step 3"
        time.sleep(0.01)
    old = it._worker
    it.close()                       # the worker is parked in load(3)
    assert it._worker is None and old.is_alive()
    gate.set()
    seen += [int(next(it)["s"][0]) for _ in range(4)]
    old.join(timeout=10)
    assert not old.is_alive()
    seen += [int(next(it)["s"][0]) for _ in range(2)]
    it.close()
    assert seen == list(range(8))
    assert it.step == 8


def test_data_wait_phase_booked():
    telemetry._reset_phase_state()
    try:
        it = tdata.synthetic_lm_batches(GB, SEQ, 50, device="cpu",
                                        prefetch=0)
        for _ in range(2):
            with telemetry.step():
                next(it)
        stats = telemetry.phase_stats()
        assert stats["steps"] == 2.0
        assert stats["cum"]["data_wait"] > 0.0
        assert stats["cum"]["h2d"] > 0.0
    finally:
        telemetry._reset_phase_state()


@pytest.mark.parametrize("prefetch", [0, 2])
def test_measure_token_file_on_cpu(prefetch):
    cfg = TransformerConfig.tiny(max_seq_len=32)
    r = trainer.measure_token_file(cfg, batch=2, seq=32, steps=3, warmup=1,
                                   device="cpu", prefetch=prefetch)
    assert len(r["losses"]) == 3 and all(np.isfinite(r["losses"]))
    assert r["tokens_per_sec"] > 0 and r["mfu_vs_peak_bf16"] is None
    assert r["data_wait_s_per_step"] >= 0.0 and r["prefetch"] == prefetch
    m = trainer.measure(cfg, batch=2, seq=32, steps=2, warmup=1,
                        device="cpu")
    assert r["h2d_s_per_step"] >= 0.0
    assert set(m) | {"data_wait_s_per_step", "h2d_s_per_step",
                     "prefetch"} == set(r)


def test_default_device_raises_without_cuda(corpus):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdata.token_file_batches(corpus, GB, SEQ)
