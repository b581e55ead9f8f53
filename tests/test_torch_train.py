"""Port parity: the train step, AdamW, synthetic batches, weight conversion
and the trainer entry point of tony_tpu_torch against tony_tpu.

The 5-step loss curve matches optax.adamw(3e-4) at rtol 1e-4 on the f32
tiny model; batches and converted weights are compared exactly.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tony_tpu import data as jdata
from tony_tpu.models import transformer as jtf
from tony_tpu.parallel import MeshSpec, build_mesh
from tony_tpu_torch import data as tdata
from tony_tpu_torch import trainer
from tony_tpu_torch.convert import from_flax_params, to_flax_params
from tony_tpu_torch.models import transformer as ttf
from tony_tpu_torch.parallel import TrainState, adamw, train_step

SEQ, BATCH, STEPS = 32, 2, 5
# The shapes are small; two intra-op threads keep this file from crowding
# the timing-sensitive e2e tests that share the host.
torch.set_num_threads(2)


def _flax_params(cfg, seq=SEQ):
    m = jtf.Transformer(cfg)
    p = fnn.meta.unbox(m.init(jax.random.key(0),
                              jnp.zeros((1, seq), jnp.int32))["params"])
    return m, jax.tree.map(np.asarray, p)


def _lm_loss(model, batch):
    tok = batch["tokens"]
    return ttf.causal_lm_loss(model(tok), tok), {"n_tokens": tok.numel()}


def test_five_step_adamw_loss_curve_matches_optax():
    cfg = jtf.TransformerConfig.tiny()
    jm, params = _flax_params(cfg)
    load = tdata.synthetic_lm_load_local(SEQ, cfg.vocab_size, seed=7)
    batches = [load(s, slice(0, BATCH))["tokens"] for s in range(STEPS)]

    tx = optax.adamw(3e-4)
    p, opt = params, tx.init(params)

    @jax.jit
    def jstep(p, opt, tok):
        loss, g = jax.value_and_grad(lambda p: jtf.causal_lm_loss(
            jm.apply({"params": p}, tok), tok))(p)
        upd, opt = tx.update(g, opt, p)
        return optax.apply_updates(p, upd), opt, loss
    jlosses = []
    for tok in batches:
        p, opt, loss = jstep(p, opt, jnp.asarray(tok))
        jlosses.append(float(loss))

    tm = ttf.Transformer(ttf.TransformerConfig.tiny(), device="cpu")
    tm.load_state_dict(from_flax_params(params))
    state = TrainState(tm, adamw(tm.parameters(), 3e-4), _lm_loss)
    tlosses = []
    for s, tok in enumerate(batches):
        m = train_step(state, {"tokens": torch.from_numpy(tok).long()})
        assert m["step"] == s + 1 and m["n_tokens"] == BATCH * SEQ
        tlosses.append(m["loss"].item())
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert tlosses[-1] < tlosses[0]
    # The parameters after five updates agree too.
    final = to_flax_params(tm.state_dict())
    for path, x in jax.tree_util.tree_leaves_with_path(p):
        y = final
        for key in path:
            y = y[key.key]
        np.testing.assert_allclose(y, x, atol=1e-5, rtol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


def test_adamw_has_optax_defaults():
    opt = adamw([torch.nn.Parameter(torch.zeros(2))], 1e-3)
    group = opt.param_groups[0]
    assert group["betas"] == (0.9, 0.999)
    assert group["eps"] == 1e-8
    assert group["weight_decay"] == 1e-4


def test_apply_gradients_with_explicit_grads():
    model = torch.nn.Linear(3, 2, bias=False)
    before = model.weight.detach().clone()
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.5),
                       _lm_loss)
    state.apply_gradients({"weight": torch.ones(2, 3)})
    assert state.step == 1 and model.weight.grad is None
    torch.testing.assert_close(model.weight.detach(), before - 0.5)


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 3), (11, 7)])
def test_synthetic_batches_byte_identical_to_reference(seed, step):
    mesh = build_mesh(MeshSpec())
    it = jdata.synthetic_lm_batches(mesh, 4, 16, 1000, seed=seed)
    ref = it.load_local(step, slice(0, 4))["tokens"]
    ours = tdata.synthetic_lm_load_local(16, 1000, seed)(step,
                                                         slice(0, 4))
    assert ours["tokens"].dtype == ref.dtype
    assert ours["tokens"].tobytes() == ref.tobytes()
    # One rank of a two-process world gets exactly its rows.
    half = tdata.synthetic_lm_batch(step, 4, 16, 1000, seed=seed, rank=1,
                                    world=2, device="cpu")["tokens"]
    assert np.array_equal(half.numpy(), ref[2:4])


@pytest.mark.parametrize("gb,rank,world", [(8, 0, 1), (8, 3, 4), (6, 1, 3)])
def test_process_batch_slice_matches_reference(gb, rank, world):
    assert tdata.process_batch_slice(gb, rank, world) == \
        jdata.process_batch_slice(gb, rank, world)


@pytest.mark.parametrize("gb,rank,world,match", [
    (8, 4, 4, "outside world"), (7, 0, 2, "not divisible")])
def test_process_batch_slice_errors(gb, rank, world, match):
    with pytest.raises(ValueError, match=match):
        tdata.process_batch_slice(gb, rank, world)
    with pytest.raises(ValueError, match=match):
        jdata.process_batch_slice(gb, rank, world)


@pytest.mark.parametrize("tie", [False, True])
def test_convert_round_trip_is_exact(tie):
    _, params = _flax_params(jtf.TransformerConfig.tiny(tie_embeddings=tie))
    sd = from_flax_params(params)
    assert sd["layers.0.attn.wq.weight"].shape == \
        params["layer_0"]["attn"]["wq"]["kernel"].shape[::-1]
    back = to_flax_params(sd)
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for (path, a), b in zip(flat, jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    # And the names are exactly the port model's parameters.
    tm = ttf.Transformer(ttf.TransformerConfig.tiny(tie_embeddings=tie),
                         device="cpu")
    assert set(sd) == set(tm.state_dict())


def test_trainer_measure_on_cpu_small():
    cfg = ttf.TransformerConfig.tiny(max_seq_len=SEQ)
    r = trainer.measure(cfg, batch=BATCH, seq=SEQ, steps=3, warmup=1,
                        device="cpu")
    assert len(r["losses"]) == 3 and all(np.isfinite(r["losses"]))
    assert r["tokens_per_sec"] > 0 and r["mfu_vs_peak_bf16"] is None
    assert r["params"] == sum(x.size for x in jax.tree.leaves(
        _flax_params(jtf.TransformerConfig.tiny())[1]))


def test_flagship_config_matches_bench_geometry():
    import bench

    j = bench.build_flagship_config(2048)
    t = trainer.flagship_config(2048)
    for f in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
              "mlp_dim", "max_seq_len", "remat"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.dtype == torch.bfloat16 and t.param_dtype == torch.float32


def test_peak_lookup_by_device_name():
    assert trainer.peak_bf16("NVIDIA H100 80GB HBM3") == 989e12
    assert trainer.peak_bf16("NVIDIA H100 PCIe") == 756e12
    assert trainer.peak_bf16("Some Other Card") is None


@pytest.mark.parametrize("call", ["measure", "batch", "model"])
def test_default_device_raises_without_cuda(call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    cfg = ttf.TransformerConfig.tiny(max_seq_len=SEQ)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if call == "measure":
            trainer.measure(cfg, batch=BATCH, seq=SEQ, steps=2, warmup=1)
        elif call == "batch":
            tdata.synthetic_lm_batch(0, BATCH, SEQ, cfg.vocab_size)
        else:
            ttf.Transformer(cfg)
