"""Port parity: the dense decoder's quantized projections and its tied head
under the tensor-parallel plan (``tony_tpu_torch/ops/quant.py``'s
``quantized_matmul`` on local shards, ``models/transformer.py``'s
``Dense`` and ``tied_logits``) against the reference's ``init_sharded_state`` +
``jit_train_step`` on four of the virtual host devices, where GSPMD lays out
``QDense`` and the tied head by the logical rules.

One spawn of four gloo ranks (``FileStore`` rendezvous in ``tmp_path``, each
rank with its own 120 s timeout) runs every case, each from ``convert.py``'s
copy of the reference's flax parameters for the tiny f32 decoder: int8, fp8
and the tied head at ``(fsdp=2, tp=2)``, int8 at ``(dp=2, tp=2)``. Losses
within 1e-5 relative; each gathered parameter within 1e-5 relative Frobenius
error (per tensor: Adam's first update is ±lr·sign(g), see
``tests/test_torch_grad_sync.py``); every local shard shape the
reference's. The tied head is held to the reference over 3 AdamW steps.
A quantized run is held to the reference's step from the same state (the
first loss, and every parameter after the first update), and over all 3
steps to the port's unsharded run of the same mode: quantization is
discontinuous, so the ~1e-7 relative noise between two frameworks'
updates moves a few elements across a rounding level at the next step. On
these inputs the reference's own parameters after its first int8 step give
the port the reference's second loss to 4e-7 (6.0109262 against
6.0109239), while the port's own, within 1.1e-7 of them, give 6.0110641:
the port's unsharded run leaves the reference by that much too, and a
tensor-parallel one follows the unsharded one. Before its first step the
int8 model at ``(fsdp=2, tp=2)``
gives each rank's rows the logits of the port's unsharded int8 model bit
for bit: the rowwise layers quantize with the tp-wide amax and sum the
int32 accumulators before scaling, which is exact.

In this process: the rowwise shard of one layer (the contraction split in
two) quantized with each half's own amax misses the reference's
``_qmm_forward`` on the whole, which the tp-wide amax exists to match.
"""

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
from tony_tpu.ops import quant as jq
from tony_tpu.parallel import (MeshSpec, build_mesh, init_sharded_state,
                               jit_train_step)
from tony_tpu_torch.convert import from_flax_params, to_flax_params
from tony_tpu_torch.models import transformer as ttf
from tony_tpu_torch.ops import quant as tq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GB, SEQ, LR, STEPS = 8, 16, 3e-4, 3
RTOL = 1e-5
torch.set_num_threads(2)
# The module's fixture runs the JAX reference (compile-bound) while four
# gloo ranks train: more than the default watchdog allows on a loaded
# machine.
pytestmark = pytest.mark.timeout_s(600)
# name -> (mesh spec, TransformerConfig.tiny keywords)
CASES = {
    "int8_fsdp2_tp2": (dict(fsdp=2, tp=2), dict(matmul_dtype="int8")),
    "fp8_fsdp2_tp2": (dict(fsdp=2, tp=2), dict(matmul_dtype="fp8_e4m3")),
    "tied_fsdp2_tp2": (dict(fsdp=2, tp=2), dict(tie_embeddings=True)),
    "int8_dp2_tp2": (dict(dp=2, tp=2), dict(matmul_dtype="int8")),
}
LOGITS_CASE = "int8_fsdp2_tp2"

_RANK_SCRIPT = r"""
import os, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.checkpoint.state_dict import (StateDictOptions,
                                                     set_model_state_dict)
from torch.distributed.tensor import DTensor
torch.set_num_threads(1)
from tony_tpu_torch.data import process_batch_slice
from tony_tpu_torch.models import transformer as ttf
from tony_tpu_torch.ops import quant
from tony_tpu_torch.parallel import (MeshSpec, adamw, build_mesh,
                                     init_sharded_state, sharded_train_step)

rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group(
    "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
    rank=rank, world_size=world)
CASES, LOGITS_CASE = %(cases)r, %(logits_case)r
LR, STEPS = %(lr)r, %(steps)r
tokens = np.load(os.path.join(tmp, "tokens.npy"))


def lm_loss(m, batch):
    tok = batch["tokens"]
    return ttf.causal_lm_loss(m(tok), tok), {}


def whole(x):
    return (x.full_tensor() if isinstance(x, DTensor) else x).detach().clone()


def local(x):
    return x.to_local() if isinstance(x, DTensor) else x


out = {}
for name, (spec, kw) in CASES.items():
    cfg = ttf.TransformerConfig.tiny(**kw)
    mesh = build_mesh(MeshSpec(**spec), "cpu")
    state, placements = init_sharded_state(
        lambda d: ttf.Transformer(cfg, device=d), lambda g: adamw(g, LR),
        mesh)
    weights = "w_tied.pt" if cfg.tie_embeddings else "w.pt"
    # (set_model_state_dict replaces the values of the dict it is given)
    set_model_state_dict(state.model, torch.load(os.path.join(tmp, weights)),
                         options=StateDictOptions(full_state_dict=True))
    rows = process_batch_slice(tokens.shape[1], mesh=mesh)
    case = {"rows": (rows.start, rows.stop)}
    if name == LOGITS_CASE:
        with torch.no_grad():
            case["logits"] = state.model(
                torch.from_numpy(tokens[0, rows]).long()).clone()
    losses = []
    for s in range(STEPS):
        state, m = sharded_train_step(
            lm_loss, mesh, state,
            {"tokens": torch.from_numpy(tokens[s, rows]).long()})
        losses.append(m["loss"].item())
        if s == 0:
            case["first_params"] = {
                k: whole(p) for k, p in state.model.named_parameters()}
    case.update(
        losses=losses, step=state.step,
        local_shapes={k: tuple(local(p).shape)
                      for k, p in state.model.named_parameters()},
        planned={k: pl.local_shape for k, pl in placements.items()},
        params={k: whole(p) for k, p in state.model.named_parameters()})
    out[name] = case
out["fallbacks"] = quant.fallback_events()
torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
dist.barrier()
dist.destroy_process_group()
""" % {"cases": CASES, "logits_case": LOGITS_CASE, "lr": LR, "steps": STEPS}


def _spawn(tmp_path, world=4):
    script = tmp_path / "rank.py"
    script.write_text(_RANK_SCRIPT)
    env = dict(os.environ, PYTHONPATH=REPO)
    return [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), str(tmp_path)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]


def _wait(procs):
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=120)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0] + "\n[timed out]")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]


def _init(kw):
    cfg = jtf.TransformerConfig.tiny(**kw)
    return jax.tree.map(np.asarray, fnn.meta.unbox(
        jtf.Transformer(cfg).init(jax.random.key(0),
                                  jnp.zeros((1, SEQ), jnp.int32))["params"]))


def _reference(params0, tokens, spec, kw):
    """The reference's sharded run: (losses, params, shard shapes)."""
    model = jtf.Transformer(jtf.TransformerConfig.tiny(**kw))
    n = int(np.prod(list(spec.values())))
    mesh = build_mesh(MeshSpec(**spec), devices=jax.devices()[:n])

    def loss_fn(params, batch, rng):
        toks = batch["tokens"]
        return jtf.causal_lm_loss(model.apply({"params": params}, toks),
                                  toks), {}

    first = {"tokens": jnp.asarray(tokens[0])}
    state, sh = init_sharded_state(model, first["tokens"], optax.adamw(LR),
                                   mesh)
    state = state.replace(params=jax.device_put(params0, sh.params))
    # The laid-out shards (the jitted step leaves its outputs' layout to
    # XLA).
    shapes = jax.tree.map(lambda x: x.sharding.shard_shape(x.shape),
                          state.params)
    step = jit_train_step(loss_fn, mesh, sh, first, donate=False)
    losses, params = [], []
    for s in range(STEPS):
        state, m = step(state, {"tokens": jnp.asarray(tokens[s])},
                        jax.random.key(s))
        losses.append(float(m["loss"]))
        params.append(jax.tree.map(np.asarray, state.params))
    return losses, params, shapes


def _unsharded(params0, tokens, kw):
    """The port's run on one process over the whole batch: (losses, state
    dict)."""
    from tony_tpu_torch.parallel import adamw, train_step
    from tony_tpu_torch.parallel.train import TrainState

    model = ttf.Transformer(ttf.TransformerConfig.tiny(**kw), device="cpu")
    model.load_state_dict(from_flax_params(params0))

    def loss_fn(m, batch):
        tok = batch["tokens"]
        return ttf.causal_lm_loss(m(tok), tok), {}
    state = TrainState(model, adamw(model.parameters(), LR), loss_fn)
    losses = [train_step(state, {"tokens": torch.from_numpy(t).long()})
              ["loss"].item() for t in tokens]
    return losses, {k: v.detach().clone()
                    for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results, with the reference's runs and the port's
    unsharded int8 logits computed in this process while the ranks
    train."""
    tmp = tmp_path_factory.mktemp("tp_layouts")
    tokens = np.random.default_rng(1).integers(
        0, 256, (STEPS, GB, SEQ)).astype(np.int32)
    params = {"untied": _init({}), "tied": _init(dict(tie_embeddings=True))}
    torch.save(from_flax_params(params["untied"]), tmp / "w.pt")
    torch.save(from_flax_params(params["tied"]), tmp / "w_tied.pt")
    np.save(tmp / "tokens.npy", tokens)
    procs = _spawn(tmp)
    try:
        ref, one = {}, {}
        for name, (spec, kw) in CASES.items():
            p0 = params["tied" if kw.get("tie_embeddings") else "untied"]
            ref[name] = _reference(p0, tokens, spec, kw)
            one[name] = _unsharded(p0, tokens, kw)
        plain = ttf.Transformer(
            ttf.TransformerConfig.tiny(**CASES[LOGITS_CASE][1]), device="cpu")
        plain.load_state_dict(from_flax_params(params["untied"]))
        with torch.no_grad():
            logits = plain(torch.from_numpy(tokens[0]).long())
    finally:
        _wait(procs)
    return ([torch.load(tmp / f"out{r}.pt") for r in range(4)], ref, logits,
            one)


def _rel(have, want):
    want = np.asarray(want, np.float64)
    return np.linalg.norm(np.asarray(have, np.float64) - want) / \
        np.linalg.norm(want)


def _leaves(tree, paths_of):
    for path, want in jax.tree_util.tree_leaves_with_path(
            paths_of, is_leaf=lambda x: isinstance(x, tuple)):
        have = tree
        for key in path:
            have = have[key.key]
        yield jax.tree_util.keystr(path), have, want


@pytest.mark.parametrize("name", list(CASES))
def test_tp_step_matches_reference(runs, name):
    out, ref, _, _ = runs
    losses, params, _ = ref[name]
    quantized = "matmul_dtype" in CASES[name][1]
    for o in out:
        assert o[name]["step"] == STEPS
        got = o[name]["losses"]
        np.testing.assert_allclose(got[:1] if quantized else got,
                                   losses[:1] if quantized else losses,
                                   rtol=RTOL)
    checks = [("first_params", params[0])]
    if not quantized:
        checks.append(("params", params[-1]))
    for key, want_tree in checks:
        got = to_flax_params(out[0][name][key])
        for path, have, want in _leaves(got, want_tree):
            assert _rel(have, want) <= RTOL, (name, key, path)
    assert all(o["fallbacks"] == {} for o in out)


@pytest.mark.parametrize("name", list(CASES))
def test_tp_run_matches_unsharded(runs, name):
    out, _, _, one = runs
    losses, params = one[name]
    for o in out:
        np.testing.assert_allclose(o[name]["losses"], losses, rtol=RTOL)
    for k, v in params.items():
        assert _rel(out[0][name]["params"][k], v) <= RTOL, (name, k)


@pytest.mark.parametrize("name", list(CASES))
def test_tp_local_shard_shapes_match_reference(runs, name):
    out, ref, _, _ = runs
    for o in out:
        got = o[name]
        assert got["local_shapes"] == got["planned"]
        local = to_flax_params({k: torch.empty(s) for k, s in
                                got["local_shapes"].items()})
        for path, have, want in _leaves(local, ref[name][2]):
            assert tuple(have.shape) == tuple(want), (name, path)
    # The tied model has no head of its own.
    tied = out[0]["tied_fsdp2_tp2"]["params"]
    assert "lm_head.weight" not in tied and "embedding" in tied


def test_int8_logits_at_tp2_equal_unsharded_bit_for_bit(runs):
    out, _, logits, _ = runs
    for o in out:
        start, stop = o[LOGITS_CASE]["rows"]
        assert torch.equal(o[LOGITS_CASE]["logits"], logits[start:stop])


def test_local_amax_on_a_rowwise_shard_misses_the_reference():
    """``wo``/``down`` split on the contraction dim over two ranks: the
    halves' products, each quantized with its own amax, summed, are not the
    reference's quantized product of the whole; the same halves with the
    amax over both (what the MAX all-reduce gives each rank) and the int32
    accumulators summed before the scales are the unsharded product, bit
    for bit."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((32, 64), dtype=np.float32)
    w = rng.standard_normal((48, 64), dtype=np.float32) / 8
    # Make the two halves' ranges differ, as real activations' do.
    x[:, :32] *= 4
    w[:, 32:] *= 3
    want = np.asarray(jq._qmm_forward(jnp.asarray(x), jnp.asarray(w.T),
                                      "int8"))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    halves = [(tx[:, :32], tw[:, :32]), (tx[:, 32:], tw[:, 32:])]
    local = sum(tq._qmm_forward(a, b, "int8") for a, b in halves)
    err = np.abs(local.numpy() - want).max()
    assert err > 1e-2 * np.abs(want).max(), err
    ax, aw = tq._amax(tx, -1), tq._amax(tw, -1)
    acc = sum(tq.product_plain(tq._quantize(a, ax, "int8")[0],
                               tq._quantize(b, aw, "int8")[0], "int8")
              for a, b in halves)
    sx, sw = tq._quantize(tx, ax, "int8")[1], tq._quantize(tw, aw, "int8")[1]
    tp_wide = acc.float() * sx * sw.reshape(-1)
    # The port's unsharded product bit for bit; the reference's to its f32
    # rounding (tests/test_torch_quant.py: one ulp).
    assert torch.equal(tp_wide, tq._qmm_forward(tx, tw, "int8"))
    np.testing.assert_allclose(tp_wide.numpy(), want, rtol=1e-6, atol=1e-6)
