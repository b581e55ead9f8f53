"""Port parity: ResNet and the MNIST MLP under the tensor-parallel plan
(``tony_tpu_torch/parallel/sharding.py``'s ``vision_tp_plan``: convs over
tp on their out channels, the norms on the channel shard, the MLP colwise,
rowwise, colwise with its biases replicated) against the reference's
``init_sharded_state`` + ``jit_train_step`` on the conftest's eight virtual
host devices, where GSPMD lays the same models out by the logical rules.

One spawn of eight gloo ranks (``FileStore`` rendezvous in ``tmp_path``,
each rank with its own timeout) runs every case from ``convert.py``'s copy
of one set of weights:

- the tiny ResNet at ``(dp=2, fsdp=2, tp=2)`` with SGD(0.1, 0.9);
- ``tiny(norm_groups=2, num_classes=12)`` at ``(dp=2, tp=4)``: a GroupNorm
  group of 4 channels straddles two tp shards of 2 channels, so the
  statistics are summed over tp; the same with ``fused=False`` (the
  unfused twin, ``nn.GroupNorm`` in the reference);
- the MLP (hidden 64) at ``(dp=4, tp=2)`` and ``(dp=2, fsdp=2, tp=2)`` with
  Adam(1e-3).

Losses within 1e-5 relative; each gathered parameter after 3 steps within
1e-5 relative Frobenius error (per tensor: Adam's first update is
±lr·sign(g), see ``tests/test_torch_grad_sync.py``); every local shard
shape the reference's. A class count tp does not divide (10 at tp=4) is
refused by both packages, for the same reason.

In this process, on a world-1 gloo group: the MLP on a mesh of ones trains
as the unsharded one bit for bit, and ``trainer.build_vision_state("mnist",
mesh=...)`` holds the unsharded model's values.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from tony_tpu.models import MnistMLP as JMnistMLP
from tony_tpu.models import ResNet as JResNet
from tony_tpu.models import ResNetConfig as JResNetConfig
from tony_tpu.models.mlp import classification_loss as jclassification
from tony_tpu.parallel import (MeshSpec, build_mesh, init_sharded_state,
                               jit_train_step)
from tony_tpu_torch.convert import (from_flax_mlp_params,
                                    from_flax_resnet_params,
                                    to_flax_mlp_params,
                                    to_flax_resnet_params)
from tony_tpu_torch.models import MnistMLP, ResNet, ResNetConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, STEPS, RTOL = 8, 3, 1e-5
GB, IMAGE, SGD_LR, MOMENTUM = 8, 32, 0.1, 0.9
MLP_GB, HIDDEN, ADAM_LR = 16, 64, 1e-3
# Adam's update g / (|g| + 1e-8) at a gradient within 100 eps of zero
# moves with the last bits of a sum that cancels there, so the two
# frameworks' (and the port's unsharded and sharded) parameters part at
# such an element by more than the per-tensor tolerance: in the MLP at
# (dp=2, fsdp=2, tp=2) one bias element whose first gradient is -3.3e-7
# ends 1.05e-7 from the reference's (5x the next element; the port's
# unsharded run parts from it the same way). Those elements are held to
# ``ADAM_EPS_ABS`` and left out of the per-tensor error.
ADAM_EPS_WINDOW, ADAM_EPS_ABS = 1e-6, 1e-3 * ADAM_LR
RANK_TIMEOUT_S = 300
torch.set_num_threads(2)
# The reference compiles four sharded steps while eight gloo ranks train.
pytestmark = pytest.mark.timeout_s(600)
# name -> (model, ResNetConfig.tiny keywords, mesh spec)
CASES = {
    "resnet_dp2_fsdp2_tp2": ("resnet", {}, dict(dp=2, fsdp=2, tp=2)),
    "resnet_straddled_dp2_tp4": (
        "resnet", dict(norm_groups=2, num_classes=12), dict(dp=2, tp=4)),
    "resnet_unfused_straddled_dp2_tp4": (
        "resnet", dict(norm_groups=2, num_classes=12, fused=False),
        dict(dp=2, tp=4)),
    "mlp_dp4_tp2": ("mlp", {}, dict(dp=4, tp=2)),
    "mlp_dp2_fsdp2_tp2": ("mlp", {}, dict(dp=2, fsdp=2, tp=2)),
}
REFUSED = ("resnet", dict(num_classes=10), dict(dp=2, tp=4))

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
from tony_tpu_torch.models import (MnistMLP, ResNet, ResNetConfig,
                                   classification_loss)
from tony_tpu_torch.parallel import (MeshSpec, build_mesh,
                                     init_sharded_state, sgd,
                                     sharded_train_step, shard_model)

rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group(
    "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
    rank=rank, world_size=world)
CASES, REFUSED = %(cases)r, %(refused)r
STEPS, SGD_LR, MOMENTUM, ADAM_LR, HIDDEN = %(consts)r


def loss_fn(m, batch):
    return classification_loss(m(batch["x"]), batch["y"]), {}


def whole(x):
    return (x.full_tensor() if isinstance(x, DTensor) else x).detach().clone()


def local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def build(kind, kw):
    if kind == "resnet":
        cfg = ResNetConfig.tiny(**kw)
        return lambda d: ResNet(cfg, device=d)
    return lambda d: MnistMLP(hidden=HIDDEN, device=d)


out = {}
for name, (kind, kw, spec) in CASES.items():
    mesh = build_mesh(MeshSpec(**spec), "cpu")
    if kind == "resnet":
        opt = lambda g: sgd(g, SGD_LR, momentum=MOMENTUM)
    else:
        # optax.adam's defaults; foreach, as on the card, over the DTensor
        # and the plain group alike.
        opt = lambda g: torch.optim.Adam(g, lr=ADAM_LR, foreach=True)
    state, placements = init_sharded_state(build(kind, kw), opt, mesh)
    set_model_state_dict(
        state.model, torch.load(os.path.join(tmp, f"{name}_w.pt")),
        options=StateDictOptions(full_state_dict=True))
    data = np.load(os.path.join(tmp, f"{name}_data.npz"))
    rows = process_batch_slice(data["x"].shape[1], mesh=mesh)
    losses = []
    for s in range(STEPS):
        state, m = sharded_train_step(
            loss_fn, mesh, state,
            {"x": torch.from_numpy(data["x"][s, rows]),
             "y": torch.from_numpy(data["y"][s, rows]).long()})
        losses.append(m["loss"].item())
    out[name] = dict(
        losses=losses, step=state.step,
        layout={k: str(getattr(p, "placements", None))
                for k, p in state.model.named_parameters()},
        local_shapes={k: tuple(local(p).shape)
                      for k, p in state.model.named_parameters()},
        planned={k: pl.local_shape for k, pl in placements.items()},
        params={k: whole(p) for k, p in state.model.named_parameters()})
    del state

kind, kw, spec = REFUSED
try:
    shard_model(build(kind, kw)("meta"), build_mesh(MeshSpec(**spec), "cpu"))
    out["refused"] = None
except ValueError as e:
    out["refused"] = str(e)
torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
dist.barrier()
dist.destroy_process_group()
""" % {"cases": CASES, "refused": REFUSED,
       "consts": (STEPS, SGD_LR, MOMENTUM, ADAM_LR, HIDDEN)}


def _spawn(tmp_path):
    script = tmp_path / "rank.py"
    script.write_text(_RANK_SCRIPT)
    env = dict(os.environ, PYTHONPATH=REPO)
    return [subprocess.Popen(
        [sys.executable, str(script), str(r), str(WORLD), str(tmp_path)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]


def _wait(procs):
    """Every rank's output; a rank still running after the timeout (a hang
    in a collective's backward) is killed and fails the fixture."""
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
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


def _jmodel(kind, kw):
    return (JResNet(JResNetConfig.tiny(**kw)) if kind == "resnet"
            else JMnistMLP(hidden=HIDDEN))


def _to_flax(kind, kw):
    if kind == "resnet":
        cfg = ResNetConfig.tiny(**kw)
        return lambda sd: to_flax_resnet_params(sd, cfg)
    return to_flax_mlp_params


def _case_inputs(name, seed):
    """(flax params, {"x", "y"} of STEPS batches): ResNet's weights are the
    port's seeded init carried to the flax tree (a flax init of the ResNet
    costs seconds); the MLP's labels are a linear probe's, as the
    reference's own MLP test makes them."""
    kind, kw, _ = CASES[name]
    rng = np.random.default_rng(seed)
    if kind == "resnet":
        cfg = ResNetConfig.tiny(**kw)
        params = to_flax_resnet_params(ResNet(cfg, device="cpu").state_dict(),
                                       cfg)
        x = rng.standard_normal((STEPS, GB, IMAGE, IMAGE, 3),
                                dtype=np.float32)
        y = rng.integers(0, cfg.num_classes, (STEPS, GB))
    else:
        params = to_flax_mlp_params(MnistMLP(HIDDEN, device="cpu")
                                    .state_dict())
        x = rng.standard_normal((STEPS, MLP_GB, 28, 28, 1), dtype=np.float32)
        w = rng.standard_normal((784, 10), dtype=np.float32)
        y = np.argmax(x.reshape(STEPS, MLP_GB, -1) @ w, axis=-1)
    return params, {"x": x, "y": y.astype(np.int32)}


def _reference(name, params0, data):
    """The reference's sharded run: (losses, params, shard shapes, the
    elements whose gradient at some step is below ``ADAM_EPS_WINDOW`` under
    Adam, else None)."""
    kind, kw, spec = CASES[name]
    model = _jmodel(kind, kw)
    mesh = build_mesh(MeshSpec(**spec))

    def loss_fn(params, batch, rng):
        return jclassification(model.apply({"params": params}, batch["x"]),
                               batch["y"]), {}

    grad = jax.jit(jax.grad(lambda p, b: loss_fn(p, b, None)[0]))

    first = {"x": jnp.asarray(data["x"][0]), "y": jnp.asarray(data["y"][0])}
    tx = (optax.sgd(SGD_LR, momentum=MOMENTUM) if kind == "resnet"
          else optax.adam(ADAM_LR))
    state, sh = init_sharded_state(model, first["x"], tx, mesh)
    state = state.replace(params=jax.device_put(params0, sh.params))
    shapes = jax.tree.map(lambda x: x.sharding.shard_shape(x.shape),
                          state.params)
    step = jit_train_step(loss_fn, mesh, sh, first, donate=False)
    losses, near = [], None
    for s in range(STEPS):
        batch = {"x": jnp.asarray(data["x"][s]),
                 "y": jnp.asarray(data["y"][s])}
        if kind == "mlp":
            small = jax.tree.map(lambda g: np.abs(np.asarray(g))
                                 < ADAM_EPS_WINDOW, grad(state.params, batch))
            near = small if near is None else jax.tree.map(
                np.logical_or, near, small)
        state, m = step(state, batch, jax.random.key(s))
        losses.append(float(m["loss"]))
    return losses, jax.tree.map(np.asarray, state.params), shapes, near


def _reference_refusal():
    kind, kw, spec = REFUSED
    model = _jmodel(kind, kw)
    try:
        init_sharded_state(model, jnp.zeros((GB, IMAGE, IMAGE, 3)),
                           optax.sgd(SGD_LR), build_mesh(MeshSpec(**spec)))
    except ValueError as e:
        return str(e)
    return None


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The eight ranks' results, with the reference's computed in this
    process while the ranks train."""
    tmp = tmp_path_factory.mktemp("vision_layouts")
    inputs = {}
    for i, name in enumerate(CASES):
        params, data = inputs[name] = _case_inputs(name, i)
        kind, kw, _ = CASES[name]
        sd = (from_flax_resnet_params(params, ResNetConfig.tiny(**kw))
              if kind == "resnet" else from_flax_mlp_params(params))
        torch.save(sd, tmp / f"{name}_w.pt")
        np.savez(tmp / f"{name}_data.npz", **data)
    procs = _spawn(tmp)
    try:
        ref = {name: _reference(name, *inputs[name]) for name in CASES}
        ref["refused"] = _reference_refusal()
    finally:
        _wait(procs)
    return [torch.load(tmp / f"out{r}.pt") for r in range(WORLD)], ref


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
def test_vision_tp_step_matches_reference(runs, name):
    out, ref = runs
    losses, params, _, near = ref[name]
    for o in out:
        assert o[name]["step"] == STEPS
        np.testing.assert_allclose(o[name]["losses"], losses, rtol=RTOL)
    kind, kw, _ = CASES[name]
    got = _to_flax(kind, kw)(out[0][name]["params"])
    for path, have, want in _leaves(got, params):
        have, want = np.asarray(have), np.asarray(want)
        if near is not None:
            mask = _leaves_at(near, path)
            assert np.all(np.abs(have - want)[mask] <= ADAM_EPS_ABS), \
                (name, path)
            have, want = have[~mask], want[~mask]
        assert _rel(have, want) <= RTOL, (name, path)


def _leaves_at(tree, path):
    for key in path.strip("[]").replace("'", "").split("]["):
        tree = tree[key]
    return tree


@pytest.mark.parametrize("name", list(CASES))
def test_vision_tp_local_shard_shapes_match_reference(runs, name):
    out, ref = runs
    kind, kw, spec = CASES[name]
    for o in out:
        got = o[name]
        assert got["local_shapes"] == got["planned"]
        local = _to_flax(kind, kw)({k: torch.empty(s) for k, s in
                                    got["local_shapes"].items()})
        for path, have, want in _leaves(local, ref[name][2]):
            assert tuple(have.shape) == tuple(want), (name, path)
    layout = out[0][name]["layout"]
    if kind == "resnet":
        # The convs over tp alone (FSDP2 leaves them to the step's mean),
        # the norms replicated, the head over fsdp and tp.
        assert layout["stem_conv.weight"] == "(Shard(dim=0),)"
        assert layout["blocks.0.norms.0.scale"] == "None"
        assert "Shard(dim=0)" in layout["head.weight"]
    else:
        assert all(layout[f"dense.{i}.bias"] == "None" for i in range(3))


def test_class_count_tp_does_not_divide_is_refused_as_the_reference(runs):
    out, ref = runs
    want = "divisible by 4, but it is equal to 10"
    assert want in ref["refused"]
    for o in out:
        assert o["refused"] is not None and want in o["refused"]


def test_mlp_on_a_world1_mesh_trains_as_unsharded():
    """``build_vision_state("mnist", mesh=...)``: the MLP laid out by the
    plan at tp = 1 holds the unsharded model's values, and SGD steps on it
    give the unsharded losses and parameters bit for bit."""
    from tony_tpu_torch import trainer
    from tony_tpu_torch.parallel import (MeshSpec as TMeshSpec,
                                         build_mesh as tbuild_mesh,
                                         sharded_train_step, train_step)

    plain = trainer.build_vision_state("mnist", "cpu", seed=3)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = tbuild_mesh(TMeshSpec(), "cpu")
        state = trainer.build_vision_state("mnist", "cpu", seed=3, mesh=mesh)
        assert type(state.model.dense[0].weight).__name__ == "DTensor"
        for (n, p), q in zip(state.model.named_parameters(),
                             plain.model.parameters()):
            full = p.full_tensor() if hasattr(p, "full_tensor") else p
            assert torch.equal(full, q), n
        for s in range(3):
            batch = trainer.vision_batch("mnist", s, 32, device="cpu")
            a = sharded_train_step(state.loss_fn, mesh, state, batch)[1]
            b = train_step(plain, batch)
            assert torch.equal(a["loss"], b["loss"])
        for (n, p), q in zip(state.model.named_parameters(),
                             plain.model.parameters()):
            full = p.full_tensor() if hasattr(p, "full_tensor") else p
            assert torch.equal(full, q), n
    finally:
        dist.destroy_process_group()
