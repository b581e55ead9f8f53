"""Port parity for the rest of bench's decoder points: zero gradients for a
parameter the loss does not reach, AdamW with a bf16 first moment, the
chunked loss and selective remat through ``trainer.measure``, the configs of
bench's long-context and 0.95B points, and the trainer's CLI.

Tolerances: parameters and the f32 second moment after optax-style updates
within rtol 1e-5 per element where the update is large against rounding
(Adam's first step moves every element by ±lr, so the reference's and the
port's parameters agree to f32 rounding of lr-sized steps); the bf16 first
moment bit for bit against the jitted optax step (the same gradients, the
same roundings, in optax's order); chunked against unchunked loss within 1e-5 (the f32 sums of
per-chunk nll differ in order); remat against no remat exactly (the same
ops, recomputed).
"""

import ast
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tony_tpu_torch import trainer
from tony_tpu_torch.checkpoint import CheckpointManager
from tony_tpu_torch.models.transformer import TransformerConfig
from tony_tpu_torch.parallel import (AdamWLowPrecisionMu, TrainState, adamw,
                                     accumulate_grads, checkpoint_tree,
                                     load_checkpoint_tree, monolithic_grads,
                                     train_step, train_step_accum)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)
LR = 3e-4


class _Unused(torch.nn.Module):
    """``w`` carries the loss; ``unused`` is never touched by it."""

    def __init__(self, w, unused):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w.copy()))
        self.unused = torch.nn.Parameter(torch.from_numpy(unused.copy()))


def _unused_loss(model, batch):
    return (batch["x"] @ model.w).square().mean(), {}


def _jax_unused_loss(p, x):
    return jnp.mean(jnp.square(x @ p["w"]))


def _unused_setup():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((8, 4), dtype=np.float32)
    unused = rng.standard_normal((3,), dtype=np.float32)
    xs = [rng.standard_normal((6, 8), dtype=np.float32) for _ in range(3)]
    return w, unused, xs


def _optax_run(params, xs, tx):
    opt = tx.init(params)
    for x in xs:
        g = jax.grad(_jax_unused_loss)(params, jnp.asarray(x))
        upd, opt = tx.update(g, opt, params)
        params = optax.apply_updates(params, upd)
    return jax.tree.map(np.asarray, params), opt


@pytest.mark.parametrize("path", ["train_step", "train_step_accum"])
def test_unused_parameter_decays_as_optax(path):
    """jax.grad gives the unused parameter zeros and optax.adamw decays it
    (weight decay 1e-4 at lr 3e-4); torch skips a parameter without a
    gradient unless the port fills zeros."""
    w, unused, xs = _unused_setup()
    ref, _ = _optax_run({"w": jnp.asarray(w), "unused": jnp.asarray(unused)},
                        xs, optax.adamw(LR))
    model = _Unused(w, unused)
    state = TrainState(model, adamw(model.parameters(), LR), _unused_loss)
    for x in xs:
        batch = {"x": torch.from_numpy(x)}
        if path == "train_step":
            train_step(state, batch)
        else:
            train_step_accum(state, batch, accum_steps=2)
    assert state.step == 3
    assert not np.array_equal(model.unused.detach().numpy(), unused)
    np.testing.assert_allclose(model.unused.detach().numpy(), ref["unused"],
                               rtol=1e-6)
    np.testing.assert_allclose(model.w.detach().numpy(), ref["w"], rtol=1e-5)


def test_accumulate_grads_names_every_parameter():
    w, unused, xs = _unused_setup()
    model = _Unused(w, unused)
    state = TrainState(model, adamw(model.parameters(), LR), _unused_loss)
    batch = {"x": torch.from_numpy(xs[0])}
    grads, _, _ = accumulate_grads(state, batch, 2)
    assert list(grads) == ["w", "unused"]
    assert torch.equal(grads["unused"], torch.zeros(3))
    mono = monolithic_grads(_unused_loss, model, batch)
    assert list(mono) == ["w", "unused"]
    assert torch.equal(mono["unused"], torch.zeros(3))
    # A grads mapping without the parameter is no KeyError either.
    state.apply_gradients({"w": grads["w"]})
    assert state.step == 1


def _mu_bf16_inputs(steps=5):
    rng = np.random.default_rng(1)
    params = {"a": rng.standard_normal((16, 8), dtype=np.float32),
              "b": rng.standard_normal((5,), dtype=np.float32)}
    grads = [{k: rng.standard_normal(v.shape, dtype=np.float32)
              * (0.1 if s % 2 else 1e-3) for k, v in params.items()}
             for s in range(steps)]
    return params, grads


def _torch_mu_bf16(params, grads):
    ps = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = adamw(list(ps.values()), LR, mu_dtype=torch.bfloat16)
    for g in grads:
        for k, p in ps.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    return ps, opt


def test_adamw_bf16_mu_matches_optax_five_steps():
    params, grads = _mu_bf16_inputs()
    tx = optax.adamw(LR, mu_dtype=jnp.bfloat16)
    p = jax.tree.map(jnp.asarray, params)
    opt = tx.init(p)

    @jax.jit        # as the reference's train step always runs it
    def step(p, opt, g):
        upd, opt = tx.update(g, opt, p)
        return optax.apply_updates(p, upd), opt
    for g in grads:
        p, opt = step(p, opt, jax.tree.map(jnp.asarray, g))
    adam = opt[0]
    assert adam.mu["a"].dtype == jnp.bfloat16
    ps, topt = _torch_mu_bf16(params, grads)
    assert isinstance(topt, AdamWLowPrecisionMu)
    for k, tp in ps.items():
        st = topt.state[tp]
        assert st["exp_avg"].dtype == torch.bfloat16
        assert st["exp_avg_sq"].dtype == torch.float32
        np.testing.assert_array_equal(
            st["exp_avg"].float().numpy(),
            np.asarray(adam.mu[k].astype(jnp.float32)), err_msg=k)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(),
                                   np.asarray(adam.nu[k]), rtol=1e-6,
                                   err_msg=k)
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(p[k]),
                                   rtol=1e-5, err_msg=k)


def test_adamw_mu_dtype_none_is_torch_adamw():
    opt = adamw([torch.nn.Parameter(torch.zeros(2))], LR)
    assert type(opt) is torch.optim.AdamW


def test_bf16_mu_state_round_trips_bitwise(tmp_path):
    """The lazy first step of checkpoint_tree (learning rate 0) moves no
    parameter; a trained state's bf16 first moment comes back bit for bit
    through the DCP manager and load_checkpoint_tree, and stays bf16."""
    cfg = TransformerConfig.tiny(max_seq_len=16)
    state = trainer.build_state(cfg, "cpu", seed=0, mu_dtype=torch.bfloat16)
    tok = torch.randint(0, cfg.vocab_size, (2, 16),
                        generator=torch.Generator().manual_seed(0))
    for _ in range(2):
        train_step(state, {"tokens": tok})
    with CheckpointManager(str(tmp_path / "c")) as mgr:
        mgr.save(1, checkpoint_tree(state))
    fresh = trainer.build_state(cfg, "cpu", seed=1, mu_dtype=torch.bfloat16)
    before = [p.detach().clone() for p in fresh.model.parameters()]
    tree = checkpoint_tree(fresh)
    assert all(torch.equal(a, p) for a, p in
               zip(before, fresh.model.parameters()))
    with CheckpointManager(str(tmp_path / "c")) as mgr:
        load_checkpoint_tree(fresh, mgr.restore(None, tree))
    assert fresh.step == 2
    for a, b in zip(state.model.parameters(), fresh.model.parameters()):
        assert torch.equal(a, b)
    sa = state.optimizer.state_dict()["state"]
    sb = fresh.optimizer.state_dict()["state"]
    for k, moments in sa.items():
        assert sb[k]["exp_avg"].dtype == torch.bfloat16
        for name, v in moments.items():
            assert v.dtype == sb[k][name].dtype, (k, name)
            assert torch.equal(v, sb[k][name]), (k, name)
    # And training on from the restored state matches training on.
    nxt = {"tokens": tok.flip(0)}
    la = train_step(state, nxt)["loss"]
    lb = train_step(fresh, nxt)["loss"]
    assert torch.equal(la, lb)


def _measure(cfg, **kw):
    return trainer.measure(cfg, batch=2, seq=64, steps=3, warmup=1,
                           device="cpu", **kw)


def test_measure_chunked_equals_unchunked_loss():
    cfg = TransformerConfig.tiny(max_seq_len=64)
    full = _measure(cfg)
    chunked = _measure(cfg, chunked=True, loss_chunk=16)
    np.testing.assert_allclose(chunked["losses"], full["losses"], rtol=1e-5,
                               atol=1e-5)


def test_measure_selective_remat_equals_no_remat():
    cfg = TransformerConfig.tiny(max_seq_len=64, n_layers=3)
    plain = _measure(cfg, chunked=True, loss_chunk=16)
    remat = _measure(dataclasses.replace(cfg, remat=True, remat_skip_every=2),
                     chunked=True, loss_chunk=16)
    assert remat["losses"] == plain["losses"]


def _bench_configs():
    """The keyword arguments of bench.py's TransformerConfig(...) calls
    that set remat_skip_every: the 8×8192 and 0.95B points."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    found = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "id", None) == "TransformerConfig"):
            kw = {k.arg: ast.literal_eval(k.value) for k in node.keywords
                  if isinstance(k.value, ast.Constant)}
            if "remat_skip_every" in kw:
                found.append(kw)
    return sorted(found, key=lambda kw: kw["dim"])


@pytest.mark.parametrize("which", ["flagship_remat", "big"])
def test_point_configs_match_bench_geometry(which):
    remat8, big = _bench_configs()
    want = remat8 if which == "flagship_remat" else big
    got = (trainer.flagship_remat_config() if which == "flagship_remat"
           else trainer.big_config())
    for f in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
              "mlp_dim", "max_seq_len", "remat", "remat_skip_every"):
        assert getattr(got, f) == want[f], f
    assert got.dtype == torch.bfloat16 and got.param_dtype == torch.float32
    assert got.dim // got.n_heads == 128


@pytest.mark.parametrize("argv,want", [
    ([], dict(batch=4, seq=2048, chunked=False, mu_dtype=None,
              n_layers=16, remat=False, matmul_dtype=None)),
    (["--matmul-dtype", "int8"], dict(batch=4, seq=2048, chunked=False,
                                      matmul_dtype="int8")),
    (["--seq", "8192", "--chunked"], dict(batch=4, seq=8192, chunked=True,
                                          loss_chunk=2048, remat=False)),
    (["--seq", "32768", "--chunked"], dict(batch=1, seq=32768, chunked=True,
                                           loss_chunk=8192)),
    (["--model", "flagship_remat"], dict(batch=8, seq=8192, chunked=True,
                                         loss_chunk=2048, remat=True,
                                         remat_skip_every=2)),
    (["--model", "big"], dict(batch=4, seq=2048, chunked=True,
                              loss_chunk=1024, mu_dtype=torch.bfloat16,
                              dim=1536, n_layers=24)),
    (["--seq", "8192", "--chunked", "--loss-chunk", "4096"],
     dict(batch=4, seq=8192, loss_chunk=4096)),
])
def test_cli_runs_bench_points(monkeypatch, capsys, argv, want):
    seen = {}

    def fake_measure(cfg, **kw):
        seen.update(kw, **dataclasses.asdict(cfg))
        return {}
    monkeypatch.setattr(trainer, "measure", fake_measure)
    assert trainer.main(argv + ["--device", "cpu"]) == 0
    for k, v in want.items():
        assert seen[k] == v, (k, seen[k], v)
    assert seen["max_seq_len"] == seen["seq"]


@pytest.mark.parametrize("argv", [["--model", "mnist", "--seq", "8192"],
                                  ["--model", "resnet50", "--data", "c.bin",
                                   "--chunked"]])
def test_cli_refuses_decoder_flags_elsewhere(capsys, argv):
    with pytest.raises(SystemExit) as e:
        trainer.main(argv + ["--device", "cpu"])
    assert e.value.code == 2
