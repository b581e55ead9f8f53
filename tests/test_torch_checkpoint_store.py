"""The port's checkpoint manager on a ``gs://`` directory, through the
port's object store: ``FakeGcsStore`` (``TONY_FAKE_GCS_ROOT``) and the real
``GcsStore`` client against the in-process JSON-API server
(``torch_gcs.GcsDeleteServer`` through ``TONY_GCS_ENDPOINT``).

Every case runs on both. A save and restore of the training state equal a
local directory's bit for bit, replicated and sharded (two gloo ranks on
an ``fsdp=2`` mesh, each uploading its own shards), and nothing is written
under the working directory. Any other scheme raises. Retention deletes
in the store; a step whose manifest object is missing (a torn upload) is
never listed; a corrupted object makes the restore fall back to the older
verified step and deletes the bad one; and the overlapped writer's
``write_s`` books the upload while the training thread pays only the
snapshot.
"""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from tony_tpu_torch import trainer
from tony_tpu_torch.checkpoint import CheckpointManager
from tony_tpu_torch.models.transformer import TransformerConfig
from tony_tpu_torch.parallel import checkpoint_tree, load_checkpoint_tree
from tony_tpu_torch.storage import get_store

from torch_gcs import GcsDeleteServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORES = ["fakegcs", "gcs"]
BASE = "gs://ckpt-bucket/run1"
SUBPROCESS_TIMEOUT_S = 150


@pytest.fixture
def store_env(request, tmp_path, monkeypatch):
    """The environment that selects the store for ``gs://``: the fake's
    root, or the JSON-API server's endpoint with an explicit token (so the
    client never looks for the metadata server). Yields the variables."""
    if request.param == "fakegcs":
        monkeypatch.delenv("TONY_GCS_ENDPOINT", raising=False)
        env = {"TONY_FAKE_GCS_ROOT": str(tmp_path / "gcs")}
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        yield env
        return
    server = GcsDeleteServer().start()
    try:
        monkeypatch.delenv("TONY_FAKE_GCS_ROOT", raising=False)
        env = {"TONY_GCS_ENDPOINT": server.endpoint,
               "TONY_STORAGE_TOKEN": "t0k"}
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        yield env
    finally:
        server.stop()


def _state(seed=0, steps=2):
    cfg = TransformerConfig.tiny(max_seq_len=16)
    state = trainer.build_state(cfg, "cpu", seed=seed)
    tok = torch.randint(0, cfg.vocab_size, (2, 16),
                        generator=torch.Generator().manual_seed(0))
    for _ in range(steps):
        trainer.train_step(state, {"tokens": tok})
    return state


def _assert_states_equal(a, b):
    assert a.step == b.step
    for x, y in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(x, y)
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    for k, moments in sa["state"].items():
        for name, v in moments.items():
            assert torch.equal(v, sb["state"][k][name]), (k, name)


def _restored(directory):
    fresh = _state(seed=1, steps=0)
    with CheckpointManager(directory) as mgr:
        load_checkpoint_tree(fresh, mgr.restore(None, checkpoint_tree(fresh)))
    return fresh


@pytest.mark.parametrize("store_env", STORES, indirect=True)
def test_save_restore_bitwise_with_a_local_directory(store_env, tmp_path,
                                                     monkeypatch):
    """The C1 repro as a regression test: the URL's step goes to the
    store, none of it under the working directory, and it restores the
    same tensors as the same state saved to a local directory."""
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    state = _state()
    for directory in (BASE, str(tmp_path / "local")):
        with CheckpointManager(directory, async_save=False) as mgr:
            assert mgr.save(1, checkpoint_tree(state), force=True)
            assert mgr.all_steps() == [1] and mgr.verify_step(1)
    assert os.listdir(cwd) == []
    keys = sorted(k for k, _ in get_store(BASE)._keys_under(BASE))
    assert keys == ["1/.metadata", "1/__0_0.distcp",
                    "1/tony-manifest.json"]
    store = get_store(BASE)
    sizes = 0
    for name in ("__0_0.distcp", ".metadata", "tony-manifest.json"):
        store.get_file(f"{BASE}/1/{name}", str(tmp_path / name))
        sizes += os.path.getsize(tmp_path / name)
    # The tensors' file is the local one byte for byte (.metadata and the
    # manifest name the directory they were written to).
    assert (tmp_path / "__0_0.distcp").read_bytes() == \
        (tmp_path / "local" / "1" / "__0_0.distcp").read_bytes()
    with CheckpointManager(BASE) as mgr:
        assert mgr.step_bytes(1) == sizes
        assert mgr.saved_world_size(1) == 1
    from_store, from_local = _restored(BASE), _restored(str(tmp_path /
                                                             "local"))
    _assert_states_equal(from_store, state)
    _assert_states_equal(from_store, from_local)
    assert os.listdir(cwd) == []


def test_a_url_the_port_cannot_serve_raises(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="s3://x"):
        CheckpointManager("s3://x")
    assert os.listdir(tmp_path) == []


def test_file_url_is_the_local_directory(tmp_path):
    with CheckpointManager(f"file://{tmp_path}/c", async_save=False) as mgr:
        mgr.save(0, {"w": torch.ones(2)}, force=True)
    assert sorted(os.listdir(tmp_path / "c" / "0")) == [
        ".metadata", "__0_0.distcp", "tony-manifest.json"]


def _tree(scale):
    return {"w": torch.arange(6.0) * scale, "step": int(scale)}


def _like():
    return {"w": torch.zeros(6), "step": 0}


@pytest.mark.parametrize("store_env", STORES, indirect=True)
def test_retention_deletes_in_the_store(store_env):
    with CheckpointManager(BASE, max_to_keep=2, async_save=False) as mgr:
        for s in range(4):
            mgr.save(s, _tree(s), force=True)
        assert mgr.all_steps() == [2, 3]
    store = get_store(BASE)
    assert store.list(BASE) == ["2", "3"]
    assert not store.isdir(f"{BASE}/0") and not store.isdir(f"{BASE}/1")


@pytest.mark.parametrize("store_env", STORES, indirect=True)
def test_a_step_without_its_manifest_object_is_never_listed(store_env):
    """A torn upload: every file of step 2 but its manifest. It is not a
    step; a save of the same step replaces its objects."""
    with CheckpointManager(BASE, max_to_keep=5, async_save=False) as mgr:
        mgr.save(1, _tree(1), force=True)
        mgr.save(2, _tree(2), force=True)
        get_store(BASE).delete(mgr.manifest_path(2))
        assert get_store(BASE).isdir(f"{BASE}/2")
        assert mgr.all_steps() == [1] and mgr.latest_step() == 1
        assert mgr.restore(None, _like())["step"] == 1
        assert mgr.save(2, _tree(2), force=True)
        assert mgr.all_steps() == [1, 2] and mgr.verify_step(2)


@pytest.mark.parametrize("store_env", STORES, indirect=True)
def test_a_corrupted_object_falls_back_to_the_older_step(store_env,
                                                         tmp_path):
    with CheckpointManager(BASE, max_to_keep=5, async_save=False) as mgr:
        mgr.save(1, _tree(1), force=True)
        mgr.save(2, _tree(2), force=True)
    store = get_store(BASE)
    bad = tmp_path / "bad"
    store.get_file(f"{BASE}/2/__0_0.distcp", str(bad))
    raw = bytearray(bad.read_bytes())
    raw[-1] ^= 0xFF
    bad.write_bytes(bytes(raw))
    store.put_file(str(bad), f"{BASE}/2/__0_0.distcp")
    with CheckpointManager(BASE, max_to_keep=5) as mgr:
        assert not mgr.verify_step(2) and mgr.verify_step(1)
        got = mgr.restore(None, _like())
        assert got["step"] == 1 and torch.equal(got["w"], _tree(1)["w"])
        # The rejected step is gone from the store, manifest and all.
        assert mgr.all_steps() == [1]
    assert store.list(BASE) == ["1"]


@pytest.mark.parametrize("store_env", STORES, indirect=True)
def test_overlapped_write_s_includes_the_upload(store_env):
    """The writer thread serialises, hashes and uploads: its ``write_s``
    holds the (slowed) upload, while ``save`` returns after the
    snapshot."""
    delay = 0.2
    mgr = CheckpointManager(BASE, async_save=True)
    inner = mgr._store.put_file

    def slow_put(local_path, url):
        time.sleep(delay)
        inner(local_path, url)

    mgr._store.put_file = slow_put
    try:
        t0 = time.perf_counter()
        mgr.save(0, _tree(1), force=True)
        returned = time.perf_counter() - t0
        mgr.wait()
        assert mgr.all_steps() == [0]
        # Three objects (.metadata, the shard file, the manifest).
        assert mgr.write_s[0] >= 3 * delay
        assert returned < delay and mgr.stall_s[0] < delay
    finally:
        mgr.close()


# Two gloo ranks on an fsdp=2 mesh: the tiny decoder trains 2 steps and
# saves its sharded state to URL, then again to LOCAL; each rank restores
# both into a state made from another seed and prints whether its shards
# equal the trained ones.
SHARDED_SCRIPT = r"""
import json, os, sys
import torch
import torch.distributed as dist
from tony_tpu_torch import trainer
from tony_tpu_torch.checkpoint import CheckpointManager
from tony_tpu_torch.models.transformer import TransformerConfig
from tony_tpu_torch.parallel import checkpoint_tree, load_checkpoint_tree

tmp, corpus, url, local, rank = sys.argv[1:6]
rank = int(rank)
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(
    os.path.join(tmp, "rdzv"), 2), rank=rank, world_size=2)
cfg = TransformerConfig.tiny(max_seq_len=16)
kw = dict(batch=4, seq=16, steps=2, device="cpu", seed=0, mesh="fsdp=2")
runs = {d: trainer.train(cfg, corpus, ckpt_dir=d, **kw)
        for d in (url, local)}


def shards(state):
    return [p.to_local() if hasattr(p, "to_local") else p
            for p in state.model.parameters()]


out = {}
with trainer.mesh_scope("fsdp=2", torch.device("cpu")) as mesh:
    for d, run in runs.items():
        fresh = trainer.build_state(cfg, "cpu", seed=1, mesh=mesh)
        with CheckpointManager(d) as mgr:
            load_checkpoint_tree(fresh, mgr.restore(
                None, checkpoint_tree(fresh), mesh=mesh))
        out[d] = {"step": fresh.step, "equal": all(
            torch.equal(a, b) for a, b in zip(shards(fresh),
                                             shards(run["state"])))}
        out[d]["shards"] = [s.tolist() for s in shards(fresh)]
print(json.dumps(out))
dist.destroy_process_group()
"""


@pytest.mark.parametrize("store_env", STORES, indirect=True)
def test_sharded_save_restore_on_two_ranks(store_env, tmp_path):
    """Every rank uploads and hashes its own shard file; rank 0 writes
    the manifest from the gathered hashes. Each rank restores the same
    shards from the store as from a local directory, and they equal the
    trained ones; nothing lands in the ranks' working directory."""
    (tmp_path / "sharded.py").write_text(SHARDED_SCRIPT)
    corpus = trainer.write_corpus(str(tmp_path / "corpus.bin"),
                                  TransformerConfig.tiny().vocab_size)
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    env = dict(os.environ, PYTHONPATH=REPO, **store_env)
    procs = [subprocess.Popen(
        [sys.executable, str(tmp_path / "sharded.py"), str(tmp_path),
         corpus, BASE, str(tmp_path / "local"), str(rank)],
        env=env, cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in range(2)]
    results = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=SUBPROCESS_TIMEOUT_S)
            assert proc.returncode == 0, err[-4000:]
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
    local = str(tmp_path / "local")
    for got in results:
        for d in (BASE, local):
            assert got[d]["step"] == 2 and got[d]["equal"], d
        assert got[BASE]["shards"] == got[local]["shards"]
    assert results[0][BASE]["shards"] != results[1][BASE]["shards"]
    assert os.listdir(cwd) == []
    with CheckpointManager(BASE) as mgr:
        # The first step and the last, each saved by both ranks.
        assert mgr.all_steps() == [0, 1] and mgr.verify_step(1)
        assert mgr.saved_world_size(1) == 2
        assert mgr.saved_mesh_shape(1)["fsdp"] == 2
        manifest = mgr._manifest(1)
    assert {"__0_0.distcp", "__1_0.distcp", ".metadata"} <= set(
        manifest["files"])


def test_trainer_ckpt_dir_defaults_to_the_jobs_checkpoint_dir(
        tmp_path, monkeypatch, capsys):
    """``--ckpt-dir`` defaults to ``$TONY_CHECKPOINT_DIR``, which a job
    configured with ``tony.application.checkpoint-dir`` gets, as
    ``examples/llama3-8b/train_llama3.py`` reads it; the flag wins."""
    seen = []

    def fake_train(cfg, data, **kw):
        seen.append(kw["ckpt_dir"])
        return {"state": None, "losses": []}

    monkeypatch.setattr(trainer, "train", fake_train)
    argv = ["--data", str(tmp_path / "c.bin"), "--device", "cpu",
            "--steps", "1"]
    monkeypatch.delenv("TONY_CHECKPOINT_DIR", raising=False)
    assert trainer.main(argv) == 0
    monkeypatch.setenv("TONY_CHECKPOINT_DIR", "gs://bucket/job/ckpt")
    assert trainer.main(argv) == 0
    assert trainer.main(argv + ["--ckpt-dir", str(tmp_path / "c")]) == 0
    assert seen == [None, "gs://bucket/job/ckpt", str(tmp_path / "c")]
    capsys.readouterr()
