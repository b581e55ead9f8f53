"""Port parity: parallel/grad_sync.py of tony_tpu_torch against
tony_tpu.parallel.grad_sync — bucket plans, the stacked mean, and
train_step_accum against jit_train_step_accum at dp=1 in this process and
at dp=2 through two gloo ranks (spawned, FileStore rendezvous).

Tolerances: the stacked mean within 1e-6 (same addends, same order); the
parameters after two AdamW steps of the f32 tiny decoder within 1e-5
relative Frobenius error per tensor, the accumulation order being the
reference's (microbatch gradients summed in order, then ×1/A); losses
within 1e-5 relative. Per tensor, not per element: Adam's first update is
±lr·sign(g) wherever |g| ≫ eps, so an element whose gradient is a rounding
error away from 0 may move 2·lr the other way in one implementation (seen:
one element of 8192 off by 2e-6, the tensor's relative error ~1e-7)."""

import os
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tony_tpu.models import transformer as jtf
from tony_tpu.parallel import (MeshSpec, build_mesh, init_sharded_state,
                               jit_train_step_accum)
from tony_tpu.parallel import grad_sync as jgs
from tony_tpu_torch import telemetry
from tony_tpu_torch.convert import from_flax_params, to_flax_params
from tony_tpu_torch.models import transformer as ttf
from tony_tpu_torch.parallel import (GradSyncSpec, TrainState, adamw,
                                     bucketed_sync, monolithic_grads,
                                     plan_buckets, train_step_accum)
from tony_tpu_torch.parallel import grad_sync as tgs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)
GB, SEQ, LR, STEPS = 8, 16, 3e-4, 2
RTOL = 1e-5

_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("descs,mb", [
    ([((4, 4), "f32"), ((8,), "f32"), ((2, 2), "f32"), ((16,), "f32")], 1),
    # a dtype change closes the bucket
    ([((4,), "f32"), ((4,), "bf16"), ((4,), "bf16")], 1),
    # one-param-spills edge: a leaf bigger than the bucket goes alone
    ([((4,), "f32"), ((1 << 19,), "f32"), ((4,), "f32")], 1),
    # the cap: 3 × 0.4 MiB leaves over 1 MiB buckets
    ([((100_000,), "f32")] * 3 + [((7, 3), "bf16")], 1),
    ([((1 << 19,), "f32")] * 3 + [((9,), "f32")], 4),
])
def test_plan_buckets_identical(descs, mb):
    ref = jgs.plan_buckets([(s, _DT[d][0]) for s, d in descs], mb)
    ours = plan_buckets([(s, _DT[d][1]) for s, d in descs], mb)
    assert ours == ref
    assert [i for b in ours for i in b] == list(range(len(descs)))


@pytest.mark.parametrize("bucket_mb", [1, 32])
def test_bucketed_sync_stacked_matches_reference(bucket_mb):
    rng = np.random.default_rng(0)
    tree = {"a_small": rng.standard_normal((4, 8), np.float32),
            "b_big": rng.standard_normal((4, 1 << 19), np.float32),
            "c_mat": rng.standard_normal((4, 3, 5), np.float32),
            "d_tail": rng.standard_normal((4, 3), np.float32)}
    ref = jgs.bucketed_sync({k: jnp.asarray(v) for k, v in tree.items()},
                            bucket_mb)
    ours = bucketed_sync({k: torch.from_numpy(v) for k, v in tree.items()},
                         bucket_mb)
    assert list(ours) == list(tree)
    for k, v in tree.items():
        assert tuple(ours[k].shape) == v.shape[1:]
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(ours[k].numpy(), v.mean(0), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("bucket_mb", [1, 32])
def test_bucketed_sync_sum(bucket_mb):
    """``mean=False`` (the sequence-parallel gradient sum) sums the same
    buckets."""
    rng = np.random.default_rng(1)
    tree = {"a_small": rng.standard_normal((3, 8), np.float32),
            "b_big": rng.standard_normal((3, 1 << 19), np.float32),
            "c_mat": rng.standard_normal((3, 3, 5), np.float32)}
    ours = bucketed_sync({k: torch.from_numpy(v) for k, v in tree.items()},
                         bucket_mb, mean=False)
    assert list(ours) == list(tree)
    for k, v in tree.items():
        np.testing.assert_allclose(ours[k].numpy(), v.sum(0), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def rig():
    """The tiny f32 decoder's initial params, a global batch of ids, and
    the reference's params after two accumulated steps, per (dp, accum,
    bucket_mb) — computed on demand and memoised."""
    cfg = jtf.TransformerConfig.tiny()
    model = jtf.Transformer(cfg)
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (STEPS, GB, SEQ)).astype(np.int32)
    params0 = jax.tree.map(np.asarray, fnn.meta.unbox(model.init(
        jax.random.key(0), jnp.zeros((1, SEQ), jnp.int32))["params"]))
    cache = {}

    def loss_fn(params, batch, rng):
        toks = batch["tokens"]
        return jtf.causal_lm_loss(model.apply({"params": params}, toks),
                                  toks), {}

    def reference(dp, accum, bucket_mb):
        key = (dp, accum, bucket_mb)
        if key not in cache:
            mesh = build_mesh(MeshSpec(dp=dp), devices=jax.devices()[:dp])
            state, sh = init_sharded_state(model, jnp.asarray(tokens[0]),
                                           optax.adamw(LR), mesh)
            state = state.replace(params=jax.device_put(params0,
                                                        sh.params))
            step = jit_train_step_accum(
                loss_fn, mesh, sh, {"tokens": jnp.asarray(tokens[0])},
                accum_steps=accum, bucket_mb=bucket_mb, donate=False)
            losses = []
            for s in range(STEPS):
                state, m = step(state, {"tokens": jnp.asarray(tokens[s])},
                                jax.random.key(s))
                losses.append(float(m["loss"]))
            cache[key] = (jax.tree.map(np.asarray, state.params), losses)
        return cache[key]

    return cfg, tokens, params0, reference


def _port_state(params0):
    model = ttf.Transformer(ttf.TransformerConfig.tiny(), device="cpu")
    model.load_state_dict(from_flax_params(params0))

    def lm_loss(m, batch):
        tok = batch["tokens"]
        return ttf.causal_lm_loss(m(tok), tok), {}

    return TrainState(model, adamw(model.parameters(), LR), lm_loss)


def _rel(have, want):
    want = np.asarray(want, np.float64)
    return np.linalg.norm(np.asarray(have, np.float64) - want) / \
        np.linalg.norm(want)


def _assert_params_close(state_dict, ref_params):
    got = to_flax_params(state_dict)
    for path, want in jax.tree_util.tree_leaves_with_path(ref_params):
        have = got
        for key in path:
            have = have[key.key]
        assert _rel(have, want) <= RTOL, jax.tree_util.keystr(path)


@pytest.mark.parametrize("bucket_mb", [1, 32])
@pytest.mark.parametrize("accum", [1, 2, 4])
def test_train_step_accum_matches_reference_dp1(rig, accum, bucket_mb):
    cfg, tokens, params0, reference = rig
    ref_params, ref_losses = reference(1, accum, bucket_mb)
    state = _port_state(params0)
    losses = []
    for s in range(STEPS):
        m = train_step_accum(state, {"tokens": torch.from_numpy(
            tokens[s]).long()}, accum, bucket_mb)
        assert m["step"] == s + 1
        losses.append(m["loss"].item())
    np.testing.assert_allclose(losses, ref_losses, rtol=RTOL)
    _assert_params_close(state.model.state_dict(), ref_params)


_RANK_SCRIPT = r"""
import os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from tony_tpu_torch import telemetry
from tony_tpu_torch.data import process_batch_slice
from tony_tpu_torch.models import transformer as ttf
from tony_tpu_torch.parallel import TrainState, adamw, train_step_accum

rank, world, tmp, accum, bucket_mb = (int(sys.argv[1]), int(sys.argv[2]),
                                      sys.argv[3], int(sys.argv[4]),
                                      int(sys.argv[5]))
dist.init_process_group(
    "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
    rank=rank, world_size=world)
model = ttf.Transformer(ttf.TransformerConfig.tiny(), device="cpu")
model.load_state_dict(torch.load(os.path.join(tmp, "w.pt")))

def lm_loss(m, batch):
    tok = batch["tokens"]
    return ttf.causal_lm_loss(m(tok), tok), {}

state = TrainState(model, adamw(model.parameters(), %(lr)r), lm_loss)
tokens = np.load(os.path.join(tmp, "tokens.npy"))
rows = process_batch_slice(tokens.shape[1])
losses, comms = [], []
for s in range(tokens.shape[0]):
    with telemetry.step():
        m = train_step_accum(state, {"tokens": torch.from_numpy(
            tokens[s, rows]).long()}, accum, bucket_mb,
            group=dist.group.WORLD)
    losses.append(m["loss"].item())
    comms.append(telemetry.phase_stats()["cum"].get("comms", 0.0))
torch.save({"params": model.state_dict(), "losses": losses,
            "comms": comms}, os.path.join(tmp, f"rank{rank}.pt"))
dist.destroy_process_group()
""" % {"lr": LR}


def _run_ranks(tmp_path, world, accum, bucket_mb):
    script = tmp_path / "rank.py"
    script.write_text(_RANK_SCRIPT)
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), str(tmp_path),
         str(accum), str(bucket_mb)], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]


def test_two_gloo_ranks_match_reference_dp2_and_one_rank(rig, tmp_path):
    """Two processes × accum 2 over gloo, 1 MiB buckets: the parameters
    equal the reference's on a dp=2 mesh (virtual host devices), and the
    port's one-process run over the same global batch (accum 4: the same
    four microbatches, summed in one process)."""
    cfg, tokens, params0, reference = rig
    torch.save(from_flax_params(params0), tmp_path / "w.pt")
    np.save(tmp_path / "tokens.npy", tokens)
    results = _run_ranks(tmp_path, 2, accum=2, bucket_mb=1)
    ref_params, ref_losses = reference(2, 2, 1)
    for r in results:
        # every rank ends with the same parameters
        for k, v in results[0]["params"].items():
            assert torch.equal(r["params"][k], v), k
        # the comms phase was booked on every step
        assert all(b > a for a, b in zip([0.0] + r["comms"], r["comms"]))
    _assert_params_close(results[0]["params"], ref_params)
    # each rank's loss is the mean over its own rows; their mean is the
    # reference's global loss
    np.testing.assert_allclose(
        np.mean([r["losses"] for r in results], axis=0), ref_losses,
        rtol=RTOL)
    one = _port_state(params0)
    for s in range(STEPS):
        train_step_accum(one, {"tokens": torch.from_numpy(tokens[s]).long()},
                         4, 1)
    for k, v in one.model.state_dict().items():
        assert _rel(results[0]["params"][k].numpy(), v.numpy()) <= RTOL, k


@pytest.fixture
def world1_group(tmp_path):
    """A one-rank gloo group in this process, torn down after the test."""
    dist = torch.distributed
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_world1_group_reduces_and_books_comms(rig, world1_group,
                                              monkeypatch):
    """World 1 with a group still sends every bucket through the
    all-reduce (and books comms); no group runs no collective; and
    comms_phase=False keeps the phase ring clean."""
    cfg, tokens, params0, _ = rig
    calls = []
    real = torch.distributed.all_reduce

    def counting(t, *a, **kw):
        calls.append(t.numel())
        return real(t, *a, **kw)

    monkeypatch.setattr(torch.distributed, "all_reduce", counting)
    batch = {"tokens": torch.from_numpy(tokens[0]).long()}
    states = [_port_state(params0) for _ in range(3)]
    telemetry._reset_phase_state()
    try:
        with telemetry.step():
            train_step_accum(states[0], batch, 2, 1, group=world1_group)
        stats = telemetry.phase_stats()
        n_params = sum(p.numel() for p in states[0].model.parameters())
        assert sum(calls) == n_params and len(calls) >= 1
        assert stats["cum"].get("comms", 0.0) > 0.0
        telemetry._reset_phase_state()
        del calls[:]
        with telemetry.step():
            train_step_accum(states[1], batch, 2, 1)
            train_step_accum(states[2], batch, 2, 1, group=world1_group,
                             comms_phase=False)
        assert len(calls) >= 1          # only the grouped step reduced
        assert "comms" not in telemetry.phase_stats()["cum"]
    finally:
        telemetry._reset_phase_state()
    for a, b in zip(states[0].model.parameters(),
                    states[1].model.parameters()):
        assert torch.equal(a, b)        # ×1/1 and a one-rank sum are exact


def test_accumulated_grads_match_monolithic(rig):
    cfg, tokens, params0, _ = rig
    state = _port_state(params0)
    batch = {"tokens": torch.from_numpy(tokens[0]).long()}
    full = monolithic_grads(state.loss_fn, state.model, batch)
    assert all(p.grad is None for p in state.model.parameters())
    grads, loss, _ = tgs.accumulate_grads(state, batch, 4)
    assert list(grads) == list(full)
    for k in full:
        np.testing.assert_allclose(grads[k].numpy(), full[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_divisibility_error_names_the_knob(rig):
    cfg, tokens, params0, _ = rig
    state = _port_state(params0)
    with pytest.raises(ValueError, match="accum-steps"):
        train_step_accum(state, {"tokens": torch.from_numpy(
            tokens[0][:6]).long()}, 4)   # 6 rows % 4 != 0


def test_scalar_batch_leaves_ride_along(rig):
    cfg, tokens, params0, _ = rig
    state = _port_state(params0)

    def loss_fn(m, b):
        tok = b["tokens"]
        return ttf.causal_lm_loss(m(tok) * b["scale"], tok), {"n": 1}

    state.loss_fn = loss_fn
    m = train_step_accum(state, {"tokens": torch.from_numpy(
        tokens[0]).long(), "scale": torch.tensor(1.0)}, 2)
    assert np.isfinite(m["loss"].item()) and m["n"].item() == 1.0


def test_grad_sync_spec_from_conf():
    from tony_tpu.conf import keys as JK
    from tony_tpu.conf.config import TonyTpuConfig
    from tony_tpu_torch.conf import keys as K

    for name in ("TRAIN_ACCUM_STEPS", "TRAIN_BUCKET_MB",
                 "TRAIN_MATMUL_DTYPE", "FAULT_SEED"):
        assert getattr(K, name) == getattr(JK, name)
        assert K._REGISTRY[getattr(K, name)].default == \
            JK._REGISTRY[getattr(JK, name)].default
    conf = TonyTpuConfig()
    conf.set(K.TRAIN_ACCUM_STEPS, 4)
    conf.set(K.TRAIN_BUCKET_MB, 8)
    conf.set(K.TRAIN_MATMUL_DTYPE, "int8")
    assert GradSyncSpec.from_conf(conf) == GradSyncSpec(
        accum_steps=4, bucket_mb=8, matmul_dtype="int8")
    assert tgs.GradSyncSpec.from_conf(TonyTpuConfig()) == GradSyncSpec()
    assert GradSyncSpec() == GradSyncSpec(
        **jgs.GradSyncSpec().__dict__)
