"""Port parity: the multi-card dry run (``tony_tpu_torch/dryrun.py``)
against the reference's parts of ``__graft_entry__.py``'s
``dryrun_multichip``.

One spawn of four gloo ranks (a script in ``tmp_path``, ``FileStore``
rendezvous, each rank under a timeout) runs ``dryrun_multichip(4,
device="cpu")`` from the reference's initial parameters (``convert.py``)
and the same tokens, while this process runs the reference's parts on four
of the virtual host devices:

- (a) the dense step on ``(dp=1, fsdp=2, tp=2)``: the loss within 1e-5
  relative, and the step's gradients and each updated parameter within
  1e-5 relative Frobenius error (per tensor: Adam's first update is
  ±lr·sign(g));
- (b) the ring forward's logits on ``(dp=2, sp=2)`` and (c) Ulysses'
  output, within ``test_torch_seqpar.py``'s tolerances (2e-4 and 2e-5);
- (d) the GPipe step's loss within ``test_torch_pipeline.py``'s 2e-4;
- (e) the slices' bucketed gradients against the monolithic gradient at
  the reference's ``rtol=2e-4, atol=1e-6`` on every rank, a booked comms
  phase, and the accumulated step's loss within 1e-5 relative of the
  reference's at the same 4-row batch (the reference's own dry run takes
  2 rows there and raises at n = 4: 2 rows do not split into two slices
  of two microbatches);
- (f) the MoE step's loss finite and the same on every rank, as
  ``test_torch_moe.py::test_dryrun_ep_step`` holds it.

Each part's flash launches, counted on the CPU as calls of the kernels'
plain versions, are what ``predicted_launches`` says the card launches;
rank 0 prints the reference's summary line. Meanwhile a gang of two
submitted through the port's CLI runs ``python -m tony_tpu_torch.dryrun 2
--device cpu`` (the pytorch runtime's rendezvous env, ``env://``). In this
process: the refusals (no CUDA device, fewer cards than ranks, no group),
and ``monolithic_grads`` on a laid-out model (FSDP2 holds the parameters)
against the unsharded model's gradients.
"""

import os
import re
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from tony_tpu.compat import shard_map
from tony_tpu.models import transformer as jtf
from tony_tpu.ops.ulysses import ulysses_attention_sharded as julysses
from tony_tpu.parallel import (MeshSpec, build_mesh, bucketed_sync,
                               init_sharded_state, jit_train_step,
                               jit_train_step_accum, monolithic_grads)
from tony_tpu.parallel import pipeline as jpp
from tony_tpu.parallel.grad_sync import DEFAULT_BUCKET_MB, _build_accum_fn
from tony_tpu.parallel.sharding import DEFAULT_RULES
from tony_tpu import compat
from tony_tpu_torch import dryrun
from tony_tpu_torch.convert import (from_flax_params,
                                    from_flax_pipeline_params,
                                    to_flax_params)
from tony_tpu_torch.models import transformer as ttf
from tony_tpu_torch.parallel import grad_sync as tgs
from tony_tpu_torch.parallel import mesh as tmesh
from tony_tpu_torch.parallel import train as ttrain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
RTOL = 1e-5
LOGIT_TOL, OP_TOL, PIPE_TOL = 2e-4, 2e-5, 2e-4
ADAM_FLAT = 1e-6      # |g| below 100 × AdamW's eps (1e-8)
RANK_TIMEOUT_S = 300
torch.set_num_threads(2)
# The fixture runs the reference's six parts (compile-bound, ~40 s here)
# while four gloo ranks and a gang of two run the port's.
pytestmark = pytest.mark.timeout_s(600)

_RANK_SCRIPT = r"""
import os, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from tony_tpu_torch.ops import _flash_cuda, attention

rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group(
    "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
    rank=rank, world_size=world)
# Each plain version's call counted under its kernel's name: where the CPU
# calls the plain version, the card launches the kernel.
for name in _flash_cuda.KERNELS:
    plain = getattr(attention, name + "_plain")

    def counted(*a, _plain=plain, _name=name, **k):
        _flash_cuda.launch_counts[_name] += 1
        return _plain(*a, **k)
    setattr(attention, name + "_plain", counted)
from tony_tpu_torch.dryrun import dryrun_multichip

inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
out = dryrun_multichip(world, device="cpu", inputs=inputs)
torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
dist.destroy_process_group()
"""


def _spawn(tmp_path, world=N):
    script = tmp_path / "rank.py"
    script.write_text(_RANK_SCRIPT)
    env = dict(os.environ, PYTHONPATH=REPO)
    return [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), str(tmp_path)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]


def _gang(tmp_path, n=2):
    """``python -m tony_tpu_torch.dryrun n --device cpu`` submitted as a
    gang of n pytorch tasks through the port's CLI."""
    out = tmp_path / "gang_out"
    command = (f"{sys.executable} -m tony_tpu_torch.dryrun {n} --device cpu "
               f"--out {out} --watchdog-s {RANK_TIMEOUT_S - 60}")
    argv = [sys.executable, "-m", "tony_tpu_torch.cli", "submit",
            "--conf", "tony.application.framework=pytorch",
            "--conf", f"tony.worker.instances={n}",
            "--conf", f"tony.worker.command={command}",
            "--conf", f"tony.history.location={tmp_path / 'history'}",
            "--conf", f"tony.application.timeout-s={RANK_TIMEOUT_S}",
            "--workdir", str(tmp_path / "work")]
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen(argv, env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), out


def _wait(procs):
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
    return outs


def _inputs():
    """The port's inputs (the reference's initial parameters carried by
    ``convert.py``, the tokens and q/k/v) and the reference's own."""
    cfg = jtf.TransformerConfig.tiny()
    params0 = jax.tree.map(np.asarray, fnn.meta.unbox(
        jtf.Transformer(cfg).init(jax.random.key(0),
                                  jnp.zeros((1, dryrun.SEQ),
                                            jnp.int32))["params"]))
    f = dryrun.factors(N)
    pipe_cfg = jtf.TransformerConfig.tiny(n_layers=2 * f["pp"])
    pipe0 = jax.tree.map(np.asarray,
                         jpp.init_pipeline_params(pipe_cfg,
                                                  jax.random.key(2)))
    port = dryrun.default_inputs(N)
    port.update(params=from_flax_params(params0),
                pipe_params=from_flax_pipeline_params(pipe0))
    for k in ("tokens", "dcn_tokens", "pipe_tokens"):
        port[k] = port[k].astype(np.int32)
    return port, params0, pipe0


def _reference(port, params0, pipe0):
    """The reference's six parts (``__graft_entry__.py:48-233``) on four
    virtual devices from the same inputs."""
    devices = jax.devices()[:N]
    f = dryrun.factors(N)
    ref = {}
    mesh = build_mesh(MeshSpec(dp=f["dp"], fsdp=f["fsdp"], tp=f["tp"]),
                      devices=devices)
    model = jtf.Transformer(jtf.TransformerConfig.tiny(attn_impl="flash"))
    tokens = jnp.asarray(port["tokens"])
    batch = {"tokens": tokens}

    def loss_fn(params, b, rng):
        return jtf.causal_lm_loss(
            model.apply({"params": params}, b["tokens"]), b["tokens"]), {}

    state, sh = init_sharded_state(model, tokens, optax.adamw(1e-3), mesh)
    state = state.replace(params=jax.device_put(params0, sh.params))
    step = jit_train_step(loss_fn, mesh, sh, batch)
    state, metrics = step(state, batch, jax.random.key(1))
    grads = jax.jit(jax.grad(lambda p: loss_fn(p, batch, None)[0]))(params0)
    ref["dense"] = dict(loss=float(metrics["loss"]),
                        params=jax.tree.map(np.asarray, state.params),
                        grads=jax.tree.map(np.asarray, grads))

    mesh_sp = build_mesh(MeshSpec(dp=N // f["sp"], sp=f["sp"]),
                         devices=devices)
    cfg_ring = jtf.TransformerConfig.tiny(attn_impl="ring")
    ring = shard_map(
        lambda p, t: jtf.Transformer(cfg_ring).apply({"params": p}, t),
        mesh=mesh_sp, in_specs=(P(), P(("dp", "fsdp"), "sp")),
        out_specs=P(("dp", "fsdp"), "sp", None), check_vma=False)
    ref["ring"] = np.asarray(jax.jit(ring)(state.params, tokens))
    qkv = jnp.asarray(port["qkv"])
    ref["ulysses"] = np.asarray(jax.jit(lambda q, k, v: julysses(
        mesh_sp, q, k, v, causal=True))(qkv[0], qkv[1], qkv[2]))

    mesh_pp = build_mesh(MeshSpec(dp=N // f["pp"], pp=f["pp"]),
                         devices=devices)
    cfg_pp = jtf.TransformerConfig.tiny(n_layers=2 * f["pp"])
    pparams = jax.device_put(
        pipe0, jpp.pipeline_param_shardings(mesh_pp, pipe0))
    ptx = optax.adam(1e-3)
    popt = ptx.init(pparams)

    @jax.jit
    def pp_step(p, opt, t):
        loss, g = jax.value_and_grad(
            lambda p: jpp.pipeline_loss(cfg_pp, mesh_pp, p, t,
                                        num_microbatches=2))(p)
        upd, opt = ptx.update(g, opt, p)
        return optax.apply_updates(p, upd), opt, loss

    ref["gpipe"] = float(pp_step(pparams, popt,
                                 jnp.asarray(port["pipe_tokens"]))[2])

    dcn = f["dcn"]
    mesh_dcn = build_mesh(MeshSpec(dcn_dp=dcn, dp=N // (2 * dcn), tp=2),
                          devices=devices)
    dtok = jnp.asarray(port["dcn_tokens"])
    dbatch = {"tokens": dtok}
    state_d, sh_d = init_sharded_state(model, dtok, optax.adamw(1e-3),
                                       mesh_dcn)
    state_d = state_d.replace(params=jax.device_put(params0, sh_d.params))
    part_sh = jax.sharding.NamedSharding(mesh_dcn, P("dcn_dp", None))
    with compat.set_mesh(mesh_dcn):
        mono = jax.jit(lambda p, b, r: monolithic_grads(
            loss_fn, p, b, r))(state_d.params, dbatch, jax.random.key(5))
        accum_fn = _build_accum_fn(loss_fn, mesh_dcn, 2, dcn, ("dcn_dp",),
                                   DEFAULT_RULES)
        stacked, _, _ = jax.jit(accum_fn)(state_d.params, dbatch,
                                          jax.random.key(5))
        bucketed = jax.jit(lambda s: bucketed_sync(
            s, 1, part_sharding=part_sh))(stacked)
    for ga, gb in zip(jax.tree.leaves(mono), jax.tree.leaves(bucketed)):
        assert jnp.allclose(ga, gb, rtol=2e-4, atol=1e-6)
    step_d = jit_train_step_accum(
        loss_fn, mesh_dcn, sh_d, dbatch, accum_steps=2,
        bucket_mb=DEFAULT_BUCKET_MB, sync_axes=("dcn_dp",), donate=False)
    _, m_d = step_d(state_d, dbatch, jax.random.key(5))
    ref["multislice"] = float(m_d["loss"])
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results and the gang's, with the reference's parts
    computed in this process while they run."""
    tmp = tmp_path_factory.mktemp("dryrun")
    port, params0, pipe0 = _inputs()
    torch.save(port, tmp / "inputs.pt")
    procs = _spawn(tmp)
    gang, gang_out = _gang(tmp)
    try:
        ref = _reference(port, params0, pipe0)
    finally:
        outs = _wait(procs + [gang])
    for p, text in zip(procs + [gang], outs):
        assert p.returncode == 0, text[-4000:]
    out = [torch.load(tmp / f"out{r}.pt") for r in range(N)]
    gang_res = [torch.load(gang_out / f"dryrun_rank{r}.pt")
                for r in range(2)]
    return out, ref, outs, gang_res, tmp


def _rel(have, want):
    want = np.asarray(want, np.float64)
    return np.linalg.norm(np.asarray(have, np.float64) - want) / \
        np.linalg.norm(want)


def test_dense_step_matches_reference(runs):
    """The loss, the step's gradients (after its reductions) and each
    parameter after the AdamW(1e-3) step, by relative Frobenius error per
    tensor. Adam's first update is lr·g/(|g| + eps): where the reference's
    gradient is nonzero but below ``ADAM_FLAT`` (100 eps) the update is
    not ±lr but depends on g's last bits, which two summation orders set
    differently (one element of layer 1's wo: |g| ~ eps, its update
    -5.45e-4 in the reference and -4.63e-4 in the port); such elements are
    held through their gradient, and the rest of each tensor's update to
    1e-5."""
    out, ref = runs[:2]
    want = ref["dense"]
    for o in out:
        assert abs(o["dense"]["loss"] - want["loss"]) <= RTOL * want["loss"]
    got = to_flax_params(out[0]["dense"]["params"])
    have, tree = jax.tree_util.tree_flatten_with_path(got)
    want_leaves, want_tree = jax.tree_util.tree_flatten(want["params"])
    grads = jax.tree_util.tree_leaves(want["grads"])
    assert tree == want_tree
    for o in out:
        got_g = jax.tree_util.tree_flatten(
            to_flax_params(o["dense"]["grads"]))
        assert got_g[1] == want_tree
        for (path, _), hg, g in zip(have, got_g[0], grads):
            assert _rel(hg, g) <= RTOL, jax.tree_util.keystr(path)
    flat = 0
    for (path, h), w, g in zip(have, want_leaves, grads):
        h, keep = np.asarray(h), (g == 0) | (np.abs(g) >= ADAM_FLAT)
        flat += int((~keep).sum())
        assert _rel(h[keep], w[keep]) <= RTOL, jax.tree_util.keystr(path)
    assert flat <= 1e-3 * sum(g.size for g in grads), flat
    for o in out[1:]:
        for k, v in o["dense"]["params"].items():
            assert torch.equal(v, out[0]["dense"]["params"][k]), k


def test_ring_logits_match_reference(runs):
    out, ref = runs[:2]
    for o in out:
        a, b = o["ring"]["rows"]
        np.testing.assert_allclose(o["ring"]["logits"].numpy(),
                                   ref["ring"][a:b], atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)


def test_ulysses_output_matches_reference(runs):
    out, ref = runs[:2]
    for o in out:
        (a, b), (s0, s1) = o["ulysses"]["rows"], o["ulysses"]["seq"]
        np.testing.assert_allclose(o["ulysses"]["out"].numpy(),
                                   ref["ulysses"][a:b, s0:s1],
                                   atol=OP_TOL, rtol=OP_TOL)


def test_gpipe_loss_matches_reference(runs):
    out, ref = runs[:2]
    for o in out:
        assert abs(o["gpipe"]["loss"] - ref["gpipe"]) <= \
            PIPE_TOL * max(1.0, ref["gpipe"])


def test_multislice_bucketed_is_monolithic_and_loss_matches(runs):
    out, ref = runs[:2]
    for o in out:
        ms = o["multislice"]
        assert list(ms["bucketed"]) == list(ms["mono"])
        for k, g in ms["bucketed"].items():
            np.testing.assert_allclose(g.numpy(), ms["mono"][k].numpy(),
                                       rtol=2e-4, atol=1e-6, err_msg=k)
        assert ms["comms_fraction"] > 0.0
        assert abs(ms["loss"] - ref["multislice"]) <= \
            RTOL * ref["multislice"]


def test_moe_step_is_finite_and_agreed(runs):
    out = runs[0]
    losses = {o["moe"]["loss"] for o in out}
    assert len(losses) == 1 and np.isfinite(losses.pop())


def test_flash_launches_are_the_predicted(runs):
    """Per part and rank, the calls of each kernel's plain version (where
    the card launches the kernel) are ``predicted_launches``'; the causal
    ring skips its future chunks, so sp rank 0 runs half of rank 1's
    hops."""
    out = runs[0]
    for o in out:
        assert set(o["launches"]) == set(dryrun.PARTS)
        assert o["launches"] == o["predicted"], o["rank"]
    ring = {o["ring"]["sp_rank"]: o["launches"]["ring"]["flash_fwd"]
            for o in out}
    assert ring == {0: 2, 1: 4}


def test_rank0_prints_the_reference_summary(runs):
    out, _, texts = runs[:3]
    line = out[0]["summary"]
    assert line in texts[0]
    assert re.fullmatch(
        r"dryrun_multichip\(4\): dp=1 fsdp=2 tp=2 loss=[\d.]+; "
        r"sp=2 ring ok; ulysses ok; pp=2 gpipe loss=[\d.]+; "
        r"ep=2 moe loss=[\d.]+; dcn_dp=2 multislice loss=[\d.]+ "
        r"grad_sync=bucketed\(accum=2, vs-psum-allclose=ok\) "
        r"comms_fraction=[\d.]+", line), line
    assert all(line not in t for t in texts[1:N])


def test_gang_of_two_joins_through_env(runs):
    """The submitted gang: each task joins its group through the pytorch
    runtime's env, both run every part n = 2 allows (no multislice), and
    agree on every loss."""
    gang = runs[3]
    assert [g["rank"] for g in gang] == [0, 1]
    for g in gang:
        assert g["factors"] == dryrun.factors(2)
        assert set(g["launches"]) == set(dryrun.PARTS) - {"multislice"}
    for part in ("dense", "gpipe", "moe"):
        assert gang[0][part]["loss"] == gang[1][part]["loss"], part


def test_refuses_without_cuda():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(N)


def test_refuses_fewer_cards_than_ranks(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(N))
    with pytest.raises(RuntimeError, match="only 1 CUDA device"):
        dryrun.dryrun_multichip(N)


def test_refuses_without_a_group_and_names_the_gang(monkeypatch):
    assert not dist.is_initialized()
    for k in dryrun.RENDEZVOUS_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="Submit it as a gang") as e:
        dryrun.dryrun_multichip(N, device="cpu")
    assert "tony_tpu_torch.cli submit" in str(e.value)
    assert "tony.worker.instances=4" in str(e.value)


def test_monolithic_grads_through_fsdp2_are_the_unsharded():
    """``monolithic_grads`` on a model FSDP2 lays out (a one-rank gloo
    mesh) gives the unsharded model's gradients: autograd with respect to
    FSDP2's sharded parameters finds no path from the loss (FSDP2 writes
    ``.grad`` from its hooks), which read as zeros. The caller's ``.grad``
    is left as it was."""
    cfg = ttf.TransformerConfig.tiny()
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)))
    plain = ttf.Transformer(cfg, device="cpu")

    def loss_fn(m, b):
        return ttf.causal_lm_loss(m(b["tokens"]), b["tokens"]), {}

    want = tgs.monolithic_grads(loss_fn, plain, {"tokens": tokens})
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = tmesh.build_mesh(tmesh.MeshSpec(fsdp=1), "cpu")
        state, _ = ttrain.init_sharded_state(
            lambda d: ttf.Transformer(cfg, device=d),
            lambda g: ttrain.adamw(g, 1e-3), mesh)
        ttrain.load_whole(state.model, plain.state_dict())
        got = tgs.monolithic_grads(loss_fn, state.model, {"tokens": tokens})
        assert all(p.grad is None for p in state.model.parameters())
        assert list(got) == list(want)
        for k, g in got.items():
            g = g.full_tensor() if hasattr(g, "full_tensor") else g
            assert float(g.abs().max()) > 0, k
            torch.testing.assert_close(g, want[k], rtol=1e-5, atol=1e-6)
    finally:
        dist.destroy_process_group()


def test_a_rank_that_raises_aborts_its_nccl_group(monkeypatch):
    """``trainer.mesh_scope`` (``parallel.mesh.process_group``, which the
    dry run's group goes through too) on a rank whose
    body raises: an NCCL group is aborted, not destroyed (NCCL's destroy
    waits for the collectives in flight, which the other ranks, waiting
    for this one, never finish: the failed rank hung there with its error
    unprinted until the gang's watchdog); a gloo group is destroyed."""
    from tony_tpu_torch import trainer

    calls = []
    destroy = dist.destroy_process_group

    def abort(group=None):
        calls.append("abort")
        destroy()

    with pytest.raises(RuntimeError, match="this rank failed"):
        with trainer.mesh_scope("fsdp=1", torch.device("cpu")):
            monkeypatch.setattr(dist, "get_backend", lambda *a: "nccl")
            monkeypatch.setattr(dist.distributed_c10d,
                                "_abort_process_group", abort)
            monkeypatch.setattr(dist, "destroy_process_group",
                                lambda *a: calls.append("destroy"))
            raise RuntimeError("this rank failed")
    assert calls == ["abort"] and not dist.is_initialized()
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="this rank failed"):
        with trainer.mesh_scope("fsdp=1", torch.device("cpu")):
            raise RuntimeError("this rank failed")
    assert not dist.is_initialized()


def test_kernels_take_async_collective_tensors_waited(monkeypatch):
    """A tensor a functional collective returns (``AsyncCollectiveTensor``,
    which DTensor's ``to_local`` gives after a redistribute) reaches the
    CUDA kernels' checks waited for and plain: its ``data_ptr`` is not the
    data, and the flash forward faulted on it on four H100s (the MoE
    under ``random21``, its v). A DTensor is refused."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate

    from tony_tpu_torch.ops import _build, _flash_cuda

    seen = []

    def check(name, t, dtypes):
        seen.append(type(t))
        raise LookupError("checked")

    monkeypatch.setattr(_build, "check_tensor", check)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        x = torch.arange(2 * 8 * 2 * 4, dtype=torch.float32).reshape(
            2, 8, 2, 4)
        act = funcol.all_reduce(x, "sum", dist.group.WORLD)
        assert isinstance(act, funcol.AsyncCollectiveTensor)
        with pytest.raises(LookupError):
            _flash_cuda.flash_fwd(act, act, act, 0.5, True)
        assert seen == [torch.Tensor]
        assert torch.equal(_build.plain(act), x)
        mesh = tmesh.build_mesh(tmesh.MeshSpec(fsdp=1), "cpu")
        with pytest.raises(TypeError, match="plain tensors"):
            _build.plain(DTensor.from_local(x, mesh["fsdp"], [Replicate()]))
    finally:
        dist.destroy_process_group()
