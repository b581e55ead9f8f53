"""Port parity: the MoE decoder with its stacked experts over ep and tp at
once, ``(dp=2, ep=2, tp=2)``, on eight gloo ranks (one spawn:
``FileStore`` rendezvous in ``tmp_path``, 120 s per rank) against the
reference's ``init_sharded_state`` and its jitted step under ``set_mesh``
on the eight virtual host devices: 3 AdamW steps, losses within 1e-5
relative, each gathered parameter within 1e-5 relative Frobenius error,
every local shard shape the reference's. Each expert weight is a DTensor
on the mesh's ``(ep, tp)``: its experts over ep (the all-to-all), its
``mlp`` dim over tp (the partial ``down`` product all-reduced). The
four-rank layouts are ``tests/test_torch_moe_layouts.py``, whose helpers
this file runs.
"""

import pytest

from test_torch_moe_layouts import (check_shard_shapes, check_train_step,
                                    run_cases)

# The module's fixture runs the JAX reference (compile-bound) while eight
# gloo ranks train: more than the default watchdog allows on a loaded
# machine.
pytestmark = pytest.mark.timeout_s(600)
CASES = {"dp2_ep2_tp2": (dict(dp=2, ep=2, tp=2), {})}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("moe_ep_tp"), CASES, 8)


def test_ep_tp_train_step_matches_reference(runs):
    check_train_step(runs, "dp2_ep2_tp2", sp=False)


def test_ep_tp_local_shard_shapes_match_reference(runs):
    check_shard_shapes(runs, "dp2_ep2_tp2")
    out, _ = runs
    shapes = out[0]["dp2_ep2_tp2"]["local_shapes"]
    # Four experts over ep=2, the mlp dim (128) over tp=2.
    assert shapes["layers.0.moe.gate"] == (2, 64, 64)
    assert shapes["layers.0.moe.down"] == (2, 64, 64)
    placed = out[0]["dp2_ep2_tp2"]["placements"]["layers.0.moe.up"]
    assert "Shard(dim=0)" in placed and "Shard(dim=2)" in placed
