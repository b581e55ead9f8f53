"""Port parity: tony_tpu_torch's ResNet, MNIST MLP, SGD and vision trainer
against tony_tpu's, with the same weights (converted from the flax tree)
and the same numpy inputs.

Tolerances are the reference's own (tests/test_convfuse.py:84-97): f32
logits at rtol/atol 2e-4, every parameter's gradient of
``classification_loss`` at rtol 5e-3, atol 5e-4. The MLP's logits and
gradients at 1e-5; the SGD loss curve against optax.sgd(0.1, momentum 0.9)
at rtol 1e-5.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from tony_tpu.models import MnistMLP as JMLP
from tony_tpu.models import ResNet as JResNet
from tony_tpu.models import ResNetConfig as JConfig
from tony_tpu.models.mlp import classification_loss as jloss
from tony_tpu_torch import trainer
from tony_tpu_torch.convert import (from_flax_mlp_params,
                                    from_flax_resnet_params,
                                    to_flax_mlp_params, to_flax_resnet_params)
from tony_tpu_torch.models import (MnistMLP, ResNet, ResNetConfig,
                                   classification_loss)
from tony_tpu_torch.models import resnet as tres
from tony_tpu_torch.parallel import TrainState, sgd, train_step

TOL = dict(atol=2e-4, rtol=2e-4)
GRAD_TOL = dict(atol=5e-4, rtol=5e-3)
# The shapes are small; two intra-op threads keep this file from crowding
# the timing-sensitive e2e tests that share the host.
torch.set_num_threads(2)


def _images(size, seed=0, batch=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, size, size, 3), dtype=np.float32),
            rng.integers(0, 10, (batch,)).astype(np.int32))


def _flax_tree(tree):
    return jax.tree.map(np.asarray, fnn.meta.unbox(tree))


def _pair(fused, size=32):
    """(flax model, numpy params, port model with the same weights)."""
    jm = JResNet(JConfig.tiny(fused=fused))
    x, _ = _images(size)
    params = _flax_tree(jm.init(jax.random.key(0), jnp.asarray(x))["params"])
    cfg = ResNetConfig.tiny(fused=fused)
    tm = ResNet(cfg, device="cpu")
    tm.load_state_dict(from_flax_resnet_params(params, cfg))
    return jm, params, tm, cfg


def _leaf(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


@pytest.mark.parametrize("size", [32, 33])
@pytest.mark.parametrize("fused", [True, False])
def test_logits_and_every_gradient_match(fused, size):
    """32²: the stride-2 pads are asymmetric ((2, 3) for the stem, (0, 1)
    for the pool and the 3×3/2); 33²: odd sizes, where they are not."""
    jm, params, tm, cfg = _pair(fused, size)
    x, y = _images(size, seed=1)
    jlogits = jm.apply({"params": params}, jnp.asarray(x))
    tlogits = tm(torch.from_numpy(x))
    assert tlogits.dtype == torch.float32 and tlogits.shape == (2, 10)
    np.testing.assert_allclose(tlogits.detach().numpy(), jlogits, **TOL)

    jl, jg = jax.jit(jax.value_and_grad(lambda p: jloss(
        jm.apply({"params": p}, jnp.asarray(x)), jnp.asarray(y))))(params)
    tl = classification_loss(tlogits, torch.from_numpy(y))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), **TOL)
    tg = to_flax_resnet_params({n: p.grad for n, p in tm.named_parameters()},
                               cfg)
    paths = jax.tree_util.tree_leaves_with_path(jg)
    assert jax.tree.structure(tg) == jax.tree.structure(jg)
    for path, g in paths:
        np.testing.assert_allclose(_leaf(tg, path), g, **GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_fused_trunk_is_a_twin_of_the_unfused():
    """The port's two trunks, same weights: same state_dict names, logits
    and gradients allclose (test_convfuse.py:67-97 on the port)."""
    x, y = _images(32, seed=2)
    torch.manual_seed(0)
    fused = ResNet(ResNetConfig.tiny(), device="cpu")
    unfused = ResNet(ResNetConfig.tiny(fused=False), device="cpu")
    assert list(fused.state_dict()) == list(unfused.state_dict())
    unfused.load_state_dict(fused.state_dict())
    outs = []
    for m in (fused, unfused):
        logits = m(torch.from_numpy(x))
        classification_loss(logits, torch.from_numpy(y)).backward()
        outs.append(logits.detach())
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), **TOL)
    for (n, a), b in zip(fused.named_parameters(), unfused.parameters()):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   **GRAD_TOL, err_msg=n)


@pytest.mark.parametrize("size,k,s,pad", [
    (224, 7, 2, (2, 3)),     # the stem conv
    (112, 3, 2, (0, 1)),     # the max pool
    (56, 3, 2, (0, 1)),      # 3×3/2 of stage 1's first block
    (28, 3, 2, (0, 1)),
    (14, 3, 2, (0, 1)),
    (56, 1, 2, (0, 0)),      # the 1×1/2 projection
    (56, 3, 1, (1, 1)),
    (33, 7, 2, (3, 3)),
])
def test_same_padding_matches_xla(size, k, s, pad):
    assert tres.same_pad(size, k, s) == pad
    x = np.random.default_rng(3).standard_normal((1, size, size, 1),
                                                 dtype=np.float32)
    w = np.random.default_rng(4).standard_normal((k, k, 1, 1),
                                                 dtype=np.float32)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (s, s), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = F.conv2d(tres._pad_same(xt, k, s),
                   torch.from_numpy(w).permute(3, 2, 0, 1), stride=s)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                               atol=1e-5, rtol=1e-5)
    if pad[0] != pad[1]:
        # PyTorch's symmetric padding shifts the window: different numbers.
        sym = F.conv2d(xt, torch.from_numpy(w).permute(3, 2, 0, 1),
                       stride=s, padding=k // 2)
        assert not np.allclose(sym.permute(0, 2, 3, 1).numpy(), ref,
                               atol=1e-3)


def test_max_pool_pads_with_minus_inf_like_flax():
    x = -np.abs(np.random.default_rng(5).standard_normal(
        (1, 8, 8, 2), dtype=np.float32)) - 1.0
    ref = fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                       padding="SAME")
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = F.max_pool2d(tres._pad_same(xt, 3, 2, float("-inf")), 3, 2)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)


@pytest.mark.parametrize("fused", [True, False])
def test_convert_round_trip_is_exact(fused):
    _, params, tm, cfg = _pair(fused)
    sd = from_flax_resnet_params(params, cfg)
    assert set(sd) == set(tm.state_dict())
    back = to_flax_resnet_params(sd, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(params),
                            jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b), path


def test_resnet50_tree_shapes_and_count_match_flax():
    """ResNet-50's flax leaf shapes (``jax.eval_shape``: no compile) against
    the port's state_dict carried through the converter."""
    jm = JResNet(JConfig.resnet50())
    shapes = jax.eval_shape(jm.init, jax.random.key(0),
                            jnp.zeros((1, 224, 224, 3), jnp.float32))
    shapes = fnn.meta.unbox(shapes["params"])
    cfg = ResNetConfig.resnet50()
    tm = ResNet(cfg, device="cpu")
    tree = to_flax_resnet_params(tm.state_dict(), cfg)
    assert jax.tree.structure(tree) == jax.tree.structure(shapes)
    for (path, s), leaf in zip(jax.tree_util.tree_leaves_with_path(shapes),
                               jax.tree.leaves(tree)):
        assert leaf.shape == s.shape, jax.tree_util.keystr(path)
    n = sum(p.numel() for p in tm.parameters())
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert n == 25557032
    # Conv weights live channels_last, so cuDNN keeps its outputs so.
    assert tm.stem_conv.weight.is_contiguous(memory_format=torch.channels_last)


def test_configs_carry_the_reference_geometry():
    for name in ("tiny", "resnet50"):
        j, t = getattr(JConfig, name)(), getattr(ResNetConfig, name)()
        for f in ("stage_sizes", "width", "num_classes", "norm_groups",
                  "fused"):
            assert tuple(np.atleast_1d(getattr(t, f))) == \
                tuple(np.atleast_1d(getattr(j, f))), (name, f)
        assert str(t.dtype).split(".")[-1] == jnp.dtype(j.dtype).name


def test_bf16_resnet_logits_match():
    jm = JResNet(JConfig.tiny(dtype=jnp.bfloat16))
    x, _ = _images(32, seed=6)
    params = _flax_tree(jm.init(jax.random.key(0), jnp.asarray(x))["params"])
    cfg = ResNetConfig.tiny(dtype=torch.bfloat16)
    tm = ResNet(cfg, device="cpu")
    tm.load_state_dict(from_flax_resnet_params(params, cfg))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), jm.apply({"params": params},
                                                     jnp.asarray(x)),
                               atol=5e-2, rtol=5e-2)


def _mlp_pair():
    jm = JMLP(hidden=32)
    x = np.random.default_rng(7).standard_normal((8, 28, 28, 1),
                                                 dtype=np.float32)
    params = _flax_tree(jm.init(jax.random.key(0), jnp.asarray(x))["params"])
    tm = MnistMLP(hidden=32, device="cpu")
    tm.load_state_dict(from_flax_mlp_params(params))
    return jm, params, tm, x


def test_mlp_logits_gradients_and_round_trip():
    jm, params, tm, x = _mlp_pair()
    y = np.random.default_rng(8).integers(0, 10, (8,)).astype(np.int32)
    jl, jg = jax.value_and_grad(lambda p: jloss(
        jm.apply({"params": p}, jnp.asarray(x)), jnp.asarray(y)))(params)
    logits = tm(torch.from_numpy(x))
    np.testing.assert_allclose(logits.detach().numpy(),
                               jm.apply({"params": params}, jnp.asarray(x)),
                               atol=1e-5, rtol=1e-5)
    tl = classification_loss(logits, torch.from_numpy(y))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), atol=1e-5, rtol=1e-5)
    tg = to_flax_mlp_params({n: p.grad for n, p in tm.named_parameters()})
    for path, g in jax.tree_util.tree_leaves_with_path(jg):
        np.testing.assert_allclose(_leaf(tg, path), g, atol=1e-5, rtol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))
    back = to_flax_mlp_params(from_flax_mlp_params(params))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        assert np.array_equal(a, b)


def test_sgd_momentum_follows_optax_over_five_steps():
    jm, params, tm, _ = _mlp_pair()
    rng = np.random.default_rng(9)
    batches = [(rng.standard_normal((8, 28, 28, 1), dtype=np.float32),
                rng.integers(0, 10, (8,)).astype(np.int32))
               for _ in range(5)]
    tx = optax.sgd(0.1, momentum=0.9)
    p, opt = params, tx.init(params)
    jlosses = []
    for x, y in batches:
        loss, g = jax.value_and_grad(lambda p: jloss(
            jm.apply({"params": p}, jnp.asarray(x)), jnp.asarray(y)))(p)
        upd, opt = tx.update(g, opt, p)
        p = optax.apply_updates(p, upd)
        jlosses.append(float(loss))
    state = TrainState(tm, sgd(tm.parameters(), 0.1, momentum=0.9),
                       trainer.vision_loss)
    tlosses = [train_step(state, {"images": torch.from_numpy(x),
                                  "labels": torch.from_numpy(y)}
                          )["loss"].item() for x, y in batches]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    final = to_flax_mlp_params(tm.state_dict())
    for path, x in jax.tree_util.tree_leaves_with_path(p):
        np.testing.assert_allclose(_leaf(final, path), x, atol=1e-6,
                                   rtol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


def test_sgd_without_momentum_is_plain_sgd():
    opt = sgd([torch.nn.Parameter(torch.zeros(2))], 0.5)
    group = opt.param_groups[0]
    assert group["momentum"] == 0 and group["dampening"] == 0
    assert not group["nesterov"] and group["weight_decay"] == 0


def test_measure_vision_mnist_on_cpu_and_cli(capsys):
    r = trainer.measure_vision("mnist", batch=16, steps=3, warmup=1,
                               device="cpu")
    assert len(r["losses"]) == 3 and all(np.isfinite(r["losses"]))
    assert r["samples_per_sec"] > 0 and r["mfu_vs_peak_bf16"] is None
    assert r["params"] == 784 * 128 + 128 + 128 * 128 + 128 + 128 * 10 + 10
    assert trainer.main(["--model", "mnist", "--device", "cpu",
                         "--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert '"kind": "mnist"' in out and '"batch": 4096' in out


def test_vision_batches_are_fresh_per_step_and_deterministic():
    a = trainer.vision_batch("resnet50", 0, 2, image=32, device="cpu")
    b = trainer.vision_batch("resnet50", 0, 2, image=32, device="cpu")
    c = trainer.vision_batch("resnet50", 1, 2, image=32, device="cpu")
    assert a["images"].shape == (2, 32, 32, 3)
    assert a["images"].dtype == torch.bfloat16
    assert torch.equal(a["images"], b["images"])
    assert not torch.equal(a["images"], c["images"])
    assert a["labels"].max() < 1000
    m = trainer.vision_batch("mnist", 0, 4, device="cpu")
    assert m["images"].shape == (4, 28, 28, 1)
    assert m["images"].dtype == torch.float32 and m["labels"].max() < 10
    with pytest.raises(ValueError, match="unknown vision model"):
        trainer.build_vision_state("vgg", device="cpu")


@pytest.mark.parametrize("call", ["measure_vision", "resnet", "mlp"])
def test_default_device_raises_without_cuda(call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if call == "measure_vision":
            trainer.measure_vision("resnet50", batch=2, steps=2, warmup=1)
        elif call == "resnet":
            ResNet(ResNetConfig.tiny())
        else:
            MnistMLP()
