"""Port parity: tony_tpu_torch.ops.convfuse against tony_tpu.ops.convfuse on
the same numpy inputs.

The forward is held against the reference's Pallas apply (interpret mode on
the CPU, as tests/test_convfuse.py runs it) and its lax apply, at f32
atol/rtol 2e-5 (test_convfuse.py:31-32) and 2e-2 for bf16. Gradients are
held against ``jax.grad`` through the lax apply at rtol 2e-4, atol 2e-5
(test_convfuse.py:44-45): the Pallas apply has no reverse-mode rule
(``jax.grad`` through ``use_pallas=True`` raises "ValueError: Linearization
failed to produce known values for all output primals" on jax 0.9.0), and
test_convfuse.py shows the two applies agree to 2e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.ops import convfuse as jcf
from tony_tpu_torch.ops import _build, _convfuse_cuda, _flash_cuda
from tony_tpu_torch.ops import convfuse as tcf

TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=2e-5, rtol=2e-4)
# The shapes are small; two intra-op threads keep this file from crowding
# the timing-sensitive e2e tests that share the host.
torch.set_num_threads(2)


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.standard_normal(shape, dtype=np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, scale, bias


def _port(x, scale, bias, dtype=torch.float32, **kw):
    return tcf.fused_groupnorm_relu(
        torch.from_numpy(x).to(dtype), torch.from_numpy(scale),
        torch.from_numpy(bias), **kw)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("relu", [True, False])
def test_forward_matches_reference(use_pallas, relu):
    x, scale, bias = _inputs((2, 9, 9, 16))
    want = jcf.fused_groupnorm_relu(jnp.asarray(x), jnp.asarray(scale),
                                    jnp.asarray(bias), groups=4, relu=relu,
                                    use_pallas=use_pallas)
    got = _port(x, scale, bias, groups=4, relu=relu)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_groups_equal_channels_edge_and_error(use_pallas):
    """groups = C (the min(norm_groups, C) edge of the ResNet) and the
    ValueError when groups does not divide C."""
    x, scale, bias = _inputs((1, 4, 4, 4), seed=1)
    want = jcf.fused_groupnorm_relu(jnp.asarray(x), jnp.asarray(scale),
                                    jnp.asarray(bias), groups=4,
                                    use_pallas=use_pallas)
    got = _port(x, scale, bias, groups=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="divisible"):
        _port(x, scale, bias, groups=3)
    with pytest.raises(ValueError, match="divisible"):
        jcf.fused_groupnorm_relu(jnp.asarray(x), jnp.asarray(scale),
                                 jnp.asarray(bias), groups=3)


def test_bf16_matches_and_keeps_dtype():
    x, scale, bias = _inputs((2, 4, 4, 8), seed=2)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = jcf.fused_groupnorm_relu(xb, jnp.asarray(scale),
                                    jnp.asarray(bias), groups=2,
                                    use_pallas=True)
    got = tcf.fused_groupnorm_relu(
        torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16(),
        torch.from_numpy(scale), torch.from_numpy(bias), groups=2)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("relu", [True, False])
def test_plain_apply_matches_reference_apply(relu):
    """The kernel's plain version against the reference's lax and Pallas
    applies on the same x, a, b."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 25, 12), dtype=np.float32)
    a = rng.standard_normal((3, 12), dtype=np.float32)
    b = rng.standard_normal((3, 12), dtype=np.float32)
    got = tcf.apply_plain(torch.from_numpy(x), torch.from_numpy(a),
                          torch.from_numpy(b), relu).numpy()
    for ref in (jcf._apply_lax(x, a, b, relu),
                jcf._apply_pallas(x, a, b, relu, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(ref), **TOL)


@pytest.mark.parametrize("relu", [True, False])
def test_gradients_match_jax_grad(relu):
    x, scale, bias = _inputs((2, 5, 5, 8), seed=4)
    cot = np.random.default_rng(5).standard_normal(x.shape, dtype=np.float32)

    def jloss(x, s, b):
        y = jcf.fused_groupnorm_relu(x, s, b, groups=4, relu=relu,
                                     use_pallas=False)
        return jnp.sum(y * cot)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    tx, ts, tb = (torch.from_numpy(v).requires_grad_(True)
                  for v in (x, scale, bias))
    y = tcf.fused_groupnorm_relu(tx, ts, tb, groups=4, relu=relu)
    (y * torch.from_numpy(cot)).sum().backward()
    for name, t, j in (("x", tx, jg[0]), ("scale", ts, jg[1]),
                       ("bias", tb, jg[2])):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                   **GRAD_TOL, err_msg=name)


def test_apply_saves_x_a_b_not_y():
    """The apply keeps its inputs for backward, not the normalised output
    (the reference's jax.checkpoint around the apply)."""
    x = torch.randn(2, 9, 8, requires_grad=True)
    a = torch.randn(2, 8, requires_grad=True)
    b = torch.randn(2, 8, requires_grad=True)
    saved = []

    def pack(t):
        saved.append(t)
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = tcf._Apply.apply(x, a, b, True)
    assert len(saved) == 3
    assert [s.data_ptr() for s in saved] == [t.data_ptr() for t in (x, a, b)]
    assert all(s.data_ptr() != y.data_ptr() for s in saved)


def test_stats_and_folded_affine_match_reference():
    x, scale, bias = _inputs((2, 6, 6, 16), seed=6)
    jm, jv = jcf.group_stats(jnp.asarray(x), 4)
    tm, tv = tcf.group_stats(torch.from_numpy(x), 4)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    ja, jb = jcf.folded_affine(jm, jv, jnp.asarray(scale), jnp.asarray(bias),
                               16, 1e-6)
    ta, tb = tcf.folded_affine(tm, tv, torch.from_numpy(scale),
                               torch.from_numpy(bias), 16, 1e-6)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), **TOL)


def test_cpu_takes_plain_version_without_launching():
    x, scale, bias = _inputs((1, 3, 3, 8), seed=7)
    before = dict(_convfuse_cuda.launch_counts)
    _port(x, scale, bias, groups=2)
    assert _convfuse_cuda.launch_counts == before


def test_dispatch_and_wrapper_refuse_what_they_do_not_take():
    x = torch.zeros(1, 4, 8)
    ab = torch.zeros(1, 8)
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        tcf.apply(x.to("meta"), ab.to("meta"), ab.to("meta"), True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _convfuse_cuda.apply(x, ab, ab, True)
    # A layout slip (a non-contiguous NHWC activation) raises, not copies.
    nchw = torch.zeros(1, 8, 3, 3)
    with pytest.raises(RuntimeError, match="view"):
        tcf.fused_groupnorm_relu(nchw.permute(0, 2, 3, 1)[:, :, :2],
                                 torch.ones(8), torch.zeros(8), groups=2)


def test_kernel_families_share_one_build_and_keep_their_own_counts():
    """The convfuse kernel is a family of its own: a flagship run checks
    every entry of the flash family's launch counts, so the convfuse kernel
    must not be one of them. Both families build from sources in csrc."""
    assert set(_flash_cuda.SPECS).isdisjoint(_convfuse_cuda.SPECS)
    assert set(_flash_cuda.launch_counts) == set(_flash_cuda.KERNELS)
    assert set(_convfuse_cuda.launch_counts) == {"convfuse_apply"}
    for name, (src, entry) in _flash_cuda.KERNELS.items():
        assert _flash_cuda.SPECS[name].entry == entry
    for family in (_flash_cuda, _convfuse_cuda):
        for spec in family.SPECS.values():
            assert os.path.exists(os.path.join(_build.CSRC_DIR, spec.source))
