"""Port parity: tony_tpu_torch.ops.quant against tony_tpu.ops.quant, and the
tiny decoder with quantized projections against tony_tpu's.

Tolerances:
- ``quantize_symmetric``: int8 q and the f32 scale exactly equal, fp8 q bit
  for bit (the same f32 ops, round half to even in both);
- ``_qmm_forward``: the int8 int32 accumulator exactly equal, the output
  within one ulp of its dtype (the same three f32 roundings, then the cast);
  fp8 in f32 within rtol 1e-5 (f32 sums of the same products in another
  order);
- the straight-through gradients at f32 within rtol 1e-5 of ``jax.grad``;
- the quantized tiny decoder (f32): the two frameworks quantize activations
  that differ by f32 rounding, so an element a hair from a rounding
  boundary can land on the neighbouring level, and one flipped level moves
  a product by its quantization step (amax_x/127 · amax_w/127 per
  contraction term for int8; fp8's step is up to 1/8 of the value).
  Logits and gradients are held at atol 2e-3 (int8) / 1e-2 (fp8) in the
  maximum and 1e-5 / 1e-4 in the mean: a flip is rare and local, so the
  mean stays near f32 noise while a systematic error would not (on these
  inputs no level flips: max 1.9e-6, mean 1.9e-7, f32 noise);
- the 20-step AdamW loss curve against the JAX package's quantized curve at
  the reference's own parity band (``tests/test_quant.py``): rtol/atol 0.05
  for int8, 0.10 for fp8.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from jax import lax

from tony_tpu.models import transformer as jtf
from tony_tpu.ops import quant as jq
from tony_tpu_torch import faults, telemetry
from tony_tpu_torch.convert import from_flax_params, to_flax_params
from tony_tpu_torch.models import transformer as ttf
from tony_tpu_torch.ops import quant as tq
from tony_tpu_torch.parallel import TrainState, adamw, train_step

torch.set_num_threads(2)
B, S = 2, 32
_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}
# (max abs, mean abs) tolerances of the quantized tiny decoder, see above.
DECODER_TOL = {"int8": (2e-3, 1e-5), "fp8_e4m3": (1e-2, 1e-4)}
CURVE_TOL = {"int8": 0.05, "fp8_e4m3": 0.10}


@pytest.fixture(autouse=True)
def _clean_quant_state():
    tq._reset_fallback_state()
    yield
    faults.uninstall()
    tq._reset_fallback_state()


def _pair_inputs(shape, dt, seed):
    """The same values in both frameworks: f32 from numpy, then each
    framework's cast to the working dtype (both round to nearest even)."""
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    jd, td = _DT[dt]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _bits(q):
    """The raw bytes of a quantized array (int8, or fp8 viewed as uint8)."""
    if isinstance(q, torch.Tensor):
        return q.view(torch.uint8).numpy() if q.dtype != torch.int8 \
            else q.numpy().view(np.uint8)
    return np.asarray(q).view(np.uint8)


def _within_one_ulp(got, want, mantissa_bits):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))
                  - mantissa_bits)
    assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()


@pytest.mark.parametrize("mode", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("axis", [-1, 0])
def test_quantize_symmetric_matches_jax(mode, dt, axis):
    jx, tx = _pair_inputs((16, 64), dt, seed=1)
    # An all-zero row and column take the eps floor of the scale.
    jx = jx.at[3].set(0).at[:, 5].set(0)
    tx[3] = 0
    tx[:, 5] = 0
    jqv, js = jq.quantize_symmetric(jx, mode, axis=axis)
    tqv, ts = tq.quantize_symmetric(tx, mode, axis=axis)
    assert ts.dtype == torch.float32 and tuple(ts.shape) == js.shape
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tqv.dtype == (torch.int8 if mode == "int8"
                         else torch.float8_e4m3fn)
    np.testing.assert_array_equal(_bits(tqv), _bits(jqv))


@pytest.mark.parametrize("mode", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_qmm_forward_matches_jax(mode, dt):
    jx, tx = _pair_inputs((2, 8, 64), dt, seed=2)
    jw, tw = _pair_inputs((64, 32), dt, seed=3)       # reference [in, out]
    tw = tw.t().contiguous()                          # port [out, in]
    ref = np.asarray(jq._qmm_forward(jx, jw, mode).astype(jnp.float32))
    out = tq._qmm_forward(tx, tw, mode)
    assert out.dtype == tx.dtype and tuple(out.shape) == ref.shape
    got = out.float().numpy()
    if mode == "int8":
        # The int32 accumulator itself, exactly.
        jqx, _ = jq.quantize_symmetric(jx, mode, axis=-1)
        jqw, _ = jq.quantize_symmetric(jw, mode, axis=0)
        jacc = lax.dot_general(jqx, jqw, (((2,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
        tqx, _ = tq.quantize_symmetric(tx, mode, axis=-1)
        tqw, _ = tq.quantize_symmetric(tw, mode, axis=-1)
        tacc = tq.product_plain(tqx.reshape(-1, 64), tqw, mode)
        assert tacc.dtype == torch.int32
        np.testing.assert_array_equal(tacc.numpy().reshape(2, 8, 32),
                                      np.asarray(jacc))
    if mode == "fp8_e4m3" and dt == "f32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    else:
        _within_one_ulp(got, ref, 23 if dt == "f32" else 7)


@pytest.mark.parametrize("mode", ["int8", "fp8_e4m3"])
def test_straight_through_gradients_match_jax_grad(mode):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 32), dtype=np.float32)
    w = rng.standard_normal((32, 16), dtype=np.float32)
    cot = rng.standard_normal((2, 3, 16), dtype=np.float32)
    jdx, jdw = jax.grad(
        lambda x, w: (jq.quantized_matmul(x, w, mode) * cot).sum(),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w.T.copy()).requires_grad_(True)
    (tq.quantized_matmul(tx, tw, mode) * torch.from_numpy(cot)).sum() \
        .backward()
    np.testing.assert_allclose(tx.grad.numpy(), jdx, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy().T, jdw, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("off", [None, "", "bf16", "none", "off"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_dense_knob_off_is_bitwise_linear(off, dt):
    td = _DT[dt][1]
    dense = ttf.Dense(24, 16, td, torch.float32, torch.device("cpu"),
                      torch.Generator().manual_seed(1), matmul_dtype=off)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4, 24), dtype=np.float32))
    with torch.no_grad():
        got = dense(x)
        want = F.linear(x.to(td), dense.weight.to(td))
    assert torch.equal(got, want)


def test_typo_raises_value_error():
    with pytest.raises(ValueError, match="matmul-dtype"):
        tq.resolve_mode("int4", "cpu")
    with pytest.raises(ValueError, match="matmul-dtype"):
        ttf.Transformer(ttf.TransformerConfig.tiny(matmul_dtype="int4"),
                        device="cpu")
    assert tq.resolve_mode("", "cpu") is None
    assert tq.resolve_mode(None, "cpu") is None
    assert tq.resolve_mode("bf16", "cpu") is None
    assert tq.resolve_mode("int8", "cpu") == "int8"


@pytest.mark.faults
def test_unsupported_device_degrades_once_not_fatally():
    """quant.probe fires → int8 resolves to None, the fallback is recorded
    once, rides the telemetry beacon, and Dense gives the exact unquantized
    numbers (the reference's tests/test_quant.py:81-110)."""
    faults.install(faults.parse_spec("quant.probe=first:1"))
    assert tq.resolve_mode("int8", "cpu") is None
    fb = tq.fallback_events()
    assert list(fb) == ["int8"] and "injected fault" in fb["int8"]
    faults.uninstall()
    assert tq.resolve_mode("int8", "cpu") is None
    assert tq.fallback_events() == fb
    assert telemetry.collect_device_stats().get("quant_fallback") == fb
    dense = ttf.Dense(24, 16, torch.float32, torch.float32,
                      torch.device("cpu"), torch.Generator().manual_seed(1),
                      matmul_dtype="int8")
    x = torch.randn(4, 24, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        assert torch.equal(dense(x), F.linear(x, dense.weight))


@pytest.mark.faults
def test_probe_recovers_after_reset():
    faults.install(faults.parse_spec("quant.probe=first:1"))
    assert tq.resolve_mode("int8", "cpu") is None
    faults.uninstall()
    tq._reset_fallback_state()
    assert tq.resolve_mode("int8", "cpu") == "int8"
    assert tq.fallback_events() == {}
    assert "quant_fallback" not in telemetry.collect_device_stats()


def _tokens(vocab=256, seed=0, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _pair(mode):
    jm = jtf.Transformer(jtf.TransformerConfig.tiny(matmul_dtype=mode))
    params = fnn.meta.unbox(jm.init(jax.random.key(0),
                                    jnp.asarray(_tokens()))["params"])
    params = jax.tree.map(np.asarray, params)
    tm = ttf.Transformer(ttf.TransformerConfig.tiny(matmul_dtype=mode),
                         device="cpu")
    tm.load_state_dict(from_flax_params(params))
    return jm, params, tm


def _close(got, want, tol, what):
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert err.max() <= tol[0], (what, err.max())
    assert err.mean() <= tol[1], (what, err.mean())


@pytest.mark.parametrize("mode", ["int8", "fp8_e4m3"])
def test_quantized_decoder_logits_and_grads_match_jax(mode):
    jm, params, tm = _pair(mode)
    tok = _tokens(seed=2)

    def jloss(p):
        logits = jm.apply({"params": p}, jnp.asarray(tok))
        return jtf.causal_lm_loss(logits, jnp.asarray(tok)), logits
    (jl, jlogits), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    tt = torch.from_numpy(tok).long()
    tlogits = tm(tt)
    tl = ttf.causal_lm_loss(tlogits, tt)
    tl.backward()
    tol = DECODER_TOL[mode]
    _close(tlogits.detach().numpy(), jlogits, tol, "logits")
    np.testing.assert_allclose(tl.item(), float(jl), atol=tol[0])
    tg = to_flax_params({n: p.grad for n, p in tm.named_parameters()})
    jflat = dict(jax.tree_util.tree_leaves_with_path(jg))
    tflat = dict(jax.tree_util.tree_leaves_with_path(tg))
    assert set(map(str, jflat)) == set(map(str, tflat))
    for path, g in jflat.items():
        _close(tflat[path], g, tol, jax.tree_util.keystr(path))


@pytest.mark.parametrize("mode", ["int8", "fp8_e4m3"])
def test_twenty_step_loss_curve_matches_jax_quantized(mode):
    """The harness of test_torch_train's five-step curve: optax.adamw(3e-4)
    against the port's AdamW, the same weights and tokens each step."""
    steps = 20
    jm, params, tm = _pair(mode)
    batches = [_tokens(seed=100 + s) for s in range(steps)]
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

    def loss_fn(model, batch):
        t = batch["tokens"]
        return ttf.causal_lm_loss(model(t), t), {}
    state = TrainState(tm, adamw(tm.parameters(), 3e-4), loss_fn)
    tlosses = [train_step(state, {"tokens": torch.from_numpy(t).long()})
               ["loss"].item() for t in batches]
    assert np.isfinite(tlosses).all()
    tol = CURVE_TOL[mode]
    np.testing.assert_allclose(tlosses, jlosses, rtol=tol, atol=tol)
