"""Port parity: the job of the reference's MoE example
(``examples/moe/moe_ep.py``) on the port, at ep = 1.

The example trains ``MoEConfig.tiny_moe()`` (f32, dim 64 over 4 heads:
head_dim 16) with ``optax.adam(1e-3)`` on one batch of tokens of shape
(8, 32), the loss ``moe_lm_loss`` with the config's aux-loss weight, for 5
steps, and asserts that the loss fell. Here the reference's own loop (its
``init_sharded_state`` and jitted ``apply_gradients`` step under
``set_mesh``, on one host device) and the port's (``trainer.build_state``'s
model and loss, ``adamw`` at weight decay 0, which is Adam, and
``train_step``) start from the same weights, the reference's init
converted by ``convert.py``, and take the same tokens, made from a numpy
seed. Losses and the parameters after the 5 steps are held within 1e-5
relative, ``tests/test_torch_moe.py``'s limit for its train steps.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tony_tpu import compat
from tony_tpu.models import moe as jmoe
from tony_tpu.parallel import MeshSpec, build_mesh, init_sharded_state
from tony_tpu.parallel import sharding as jsh
from tony_tpu_torch import trainer
from tony_tpu_torch.convert import from_flax_moe_params, to_flax_moe_params
from tony_tpu_torch.models import moe as tmoe
from tony_tpu_torch.parallel import adamw, train_step

STEPS, LR, BATCH, SEQ = 5, 1e-3, 8, 32
RTOL = 1e-5
torch.set_num_threads(2)


def _rules():
    return fnn.logical_axis_rules(list(jsh.DEFAULT_RULES))


@pytest.fixture(scope="module")
def runs():
    """(the reference's losses and final parameters, the port's)."""
    cfg = jmoe.MoEConfig.tiny_moe()
    tokens = np.random.default_rng(36).integers(
        0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    model = jmoe.MoETransformer(cfg)
    mesh = build_mesh(MeshSpec(dp=1, ep=1), devices=jax.devices()[:1])
    state, _ = init_sharded_state(model, jnp.asarray(tokens),
                                  optax.adam(LR), mesh)
    params0 = jax.tree.map(np.asarray, state.params)

    def loss(params):
        with _rules():
            return jmoe.moe_lm_loss(model.apply({"params": params},
                                                jnp.asarray(tokens)),
                                    jnp.asarray(tokens), cfg.aux_loss_weight)

    @jax.jit
    def step(state):
        value, grads = jax.value_and_grad(loss)(state.params)
        return state.apply_gradients(grads=grads), value

    ref = []
    with compat.set_mesh(mesh):
        for _ in range(STEPS):
            state, value = step(state)
            ref.append(float(value))
    ref_params = jax.tree.map(np.asarray, state.params)

    tcfg = tmoe.MoEConfig.tiny_moe()
    port = trainer.build_state(tcfg, device="cpu")
    port.model.load_state_dict(from_flax_moe_params(params0))
    port.optimizer = adamw(port.model.parameters(), LR, weight_decay=0.0)
    tok = torch.from_numpy(tokens).long()
    got = [train_step(port, {"tokens": tok})["loss"].item()
           for _ in range(STEPS)]
    got_params = to_flax_moe_params({k: p.detach() for k, p in
                                     port.model.named_parameters()})
    return (ref, ref_params), (got, got_params)


def test_losses_match_the_reference_loop_and_fall(runs):
    (ref, _), (got, _) = runs
    assert len(got) == STEPS
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    assert got[-1] < got[0], got        # the example's own assertion


def test_parameters_after_the_job_match_the_reference(runs):
    (_, want), (_, have) = runs
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        h = have
        for key in path:
            h = h[key.key]
        w = np.asarray(w, np.float64)
        err = np.linalg.norm(np.asarray(h, np.float64) - w) / \
            np.linalg.norm(w)
        assert err <= RTOL, (jax.tree_util.keystr(path), err)
