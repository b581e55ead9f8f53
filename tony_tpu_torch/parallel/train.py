"""Training state and the train step, on one device and on a mesh.

Counterpart of ``tony_tpu/parallel/train.py``: ``TrainState``, the step
that ``jit_train_step`` builds (``train_step``: ``loss_fn(model, batch)``
returns ``(loss, aux)``, the step differentiates it, applies the optimizer
and returns ``{"loss", "step", **aux}``), ``init_sharded_state`` and its
sharded step (``sharded_train_step``). On a mesh the model is laid out by
``parallel/sharding.py`` (a tensor-parallel plan, then FSDP2), its
parameters are DTensors, and the optimizers below update them shard by
shard.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor

from tony_tpu_torch.parallel.sharding import (DEFAULT_RULES, Placement,
                                              shard_model)

LossFn = Callable[[nn.Module, Any], Tuple[torch.Tensor, Dict[str, Any]]]


def adamw(params: Iterable[torch.Tensor], learning_rate: float,
          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4,
          mu_dtype: Optional[torch.dtype] = None) -> torch.optim.Optimizer:
    """``optax.adamw`` with its defaults (torch's own weight decay default
    is 1e-2). Decay applies to every parameter, as optax applies it with no
    mask. With ``mu_dtype`` None it is ``torch.optim.AdamW``; with a dtype
    (bench's ``mu_dtype=bf16``) it is ``AdamWLowPrecisionMu``, which stores
    the first moment in that dtype."""
    if mu_dtype is None:
        return torch.optim.AdamW(params, lr=learning_rate, betas=(b1, b2),
                                 eps=eps, weight_decay=weight_decay)
    return AdamWLowPrecisionMu(params, learning_rate, betas=(b1, b2),
                               eps=eps, weight_decay=weight_decay,
                               mu_dtype=mu_dtype)


@functools.lru_cache(maxsize=64)
def _bias_corrections(b1: float, b2: float, count: int) -> Tuple[float, float]:
    """optax's 1 − b^count for both moments, in f32 (exact as floats)."""
    one = torch.ones((), dtype=torch.float32)
    return tuple(float(one - torch.tensor(b, dtype=torch.float32) ** count)
                 for b in (b1, b2))


class AdamWLowPrecisionMu(torch.optim.Optimizer):
    """``optax.adamw(..., mu_dtype=mu_dtype)``, in optax's order of
    operations: the first moment (``exp_avg``) is stored in ``mu_dtype``,
    the second (``exp_avg_sq``) in the parameter's dtype. Each step, per
    parameter:

    - mu = (1 − b1)·g + b1'·mu_stored in the gradient's dtype (f32),
      where b1' is b1 rounded to ``mu_dtype`` (0.8984375 for 0.9 in bf16):
      optax's Python scalar takes the bf16 moment's dtype, and the jitted
      step (as the reference always runs it) keeps the product in f32;
    - nu = (1 − b2)·g² + b2·nu;
    - u = (mu / (1 − b1^t)) / (sqrt(nu / (1 − b2^t)) + eps) + wd·p, the
      bias corrections in f32; p = p + (−lr)·u;
    - only then is mu cast to ``mu_dtype`` for storage.

    Casting mu before the update, or keeping it in f32, gives other
    numbers. ``load_state_dict`` (which casts every floating state to the
    parameter's dtype) casts ``exp_avg`` back to ``mu_dtype``, so the
    stored moment round-trips bit for bit."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 1e-4,
                 mu_dtype: torch.dtype = torch.bfloat16):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))
        self.mu_dtype = mu_dtype

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            b1_mu = float(torch.tensor(b1, dtype=self.mu_dtype))
            lr, eps, wd = float(group["lr"]), group["eps"], \
                group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                if not st:
                    st["step"] = torch.tensor(0.0)
                    st["exp_avg"] = torch.zeros_like(p, dtype=self.mu_dtype)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                st["step"] += 1
                bc1, bc2 = _bias_corrections(b1, b2, int(st["step"]))
                mu = (1 - b1) * g + b1_mu * st["exp_avg"].to(g.dtype)
                nu = st["exp_avg_sq"]
                nu.copy_((1 - b2) * (g * g) + b2 * nu)
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps) + wd * p
                p.add_(u * -lr)
                st["exp_avg"].copy_(mu)
        return loss

    def load_state_dict(self, state_dict):
        super().load_state_dict(state_dict)
        for st in self.state.values():
            if "exp_avg" in st:
                st["exp_avg"] = st["exp_avg"].to(self.mu_dtype)


def sgd(params: Iterable[torch.Tensor], learning_rate: float,
        momentum: Optional[float] = None) -> torch.optim.SGD:
    """``torch.optim.SGD`` as ``optax.sgd``: heavy-ball momentum with no
    dampening and no Nesterov. optax's trace starts at 0, so its first
    update is ``0.9·0 + g = g``, which is torch's first buffer."""
    return torch.optim.SGD(params, lr=learning_rate,
                           momentum=momentum or 0.0, dampening=0.0,
                           nesterov=False)


@dataclasses.dataclass
class TrainState:
    """The model (its parameters), its optimizer and the step count.
    Updates happen in place: the parameters and the optimizer's moments
    are the state's own buffers."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    loss_fn: Optional[LossFn] = None
    step: int = 0

    def apply_gradients(self,
                        grads: Optional[Mapping[str, torch.Tensor]] = None
                        ) -> "TrainState":
        """One optimizer update. ``grads`` (parameter name → gradient)
        replaces the ``.grad`` the backward left; without it the ``.grad``
        fields are used. A parameter with no gradient in either gets zeros
        (``fill_missing_grads``). Clears the gradients and counts the
        step."""
        if grads is not None:
            for name, p in self.model.named_parameters():
                p.grad = grads.get(name)
        fill_missing_grads(self.model)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        return self


def fill_missing_grads(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Give every trainable parameter whose ``.grad`` is None a zero
    gradient, as ``jax.grad`` gives an unused parameter zeros: AdamW then
    decays its moments and its weight as ``optax.adamw`` does (torch skips
    a parameter without a gradient), and every rank packs the same leaves.
    Allocates only for those parameters. Returns the gradients by name."""
    out = {}
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        out[name] = p.grad
    return out


def train_step(state: TrainState, batch: Any) -> Dict[str, Any]:
    """Forward, backward and update: ``{"loss": detached loss tensor,
    "step": the new step, **aux}``. Reads nothing back from the device."""
    loss, aux = state.loss_fn(state.model, batch)
    loss.backward()
    state.apply_gradients()
    return {"loss": loss.detach(), "step": state.step, **aux}


def init_sharded_state(
    build_model: Callable[[Any], nn.Module],
    optimizer_fn: Callable[[Any], torch.optim.Optimizer],
    mesh: DeviceMesh,
    rules=DEFAULT_RULES,
    seed: int = 0,
    layout: Optional[Callable[[nn.Module, DeviceMesh], Dict]] = None,
) -> Tuple[TrainState, Dict[str, Placement]]:
    """The training state laid out on ``mesh`` from the start: no rank ever
    holds the whole model. Counterpart of the reference's
    ``init_sharded_state`` (its ``out_shardings`` init).

    ``build_model(device)`` is built on ``"meta"``, laid out by
    ``sharding.shard_model(model, mesh, rules)`` (the tensor-parallel
    plan, FSDP2 on each block and the root) or by ``layout(model, mesh)``
    where one is given (``pipeline.pipeline_shard`` for a
    ``PipelineTransformer``, which also drops the other stages' layers and,
    as the reference's pipelined decoder, reads no rules table), given
    storage for its shards on the mesh's device (the current CUDA device,
    or the CPU for a gloo mesh), and each shard filled with the values the
    one-rank model ``build_model(device)`` made from a generator seeded
    with ``seed`` has:
    every parameter of the whole model is replayed in order through
    ``model.init_parameter_``, one whole tensor at a time, and each rank
    keeps its own slice of those it holds. ``optimizer_fn(param_groups)``
    makes the optimizer: one group of the DTensor parameters on each mesh
    (FSDP2's shard meshes, the plan's), one of the replicated ones.
    Returns the state (no ``loss_fn``: ``sharded_train_step`` takes it)
    and ``param_placements``."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device("cpu"))
    model = build_model("meta")
    order = [(name, p.shape, p.dtype) for name, p in model.named_parameters()]
    placements = (shard_model(model, mesh, rules) if layout is None
                  else layout(model, mesh))
    model.to_empty(device=dev)
    held = dict(model.named_parameters())
    gen = torch.Generator(dev).manual_seed(seed)
    with torch.no_grad():
        for name, shape, dtype in order:
            whole = torch.empty(shape, dtype=dtype, device=dev)
            model.init_parameter_(name, whole, gen)
            p = held.get(name)
            if p is None:
                continue
            if isinstance(p, DTensor):
                whole = distribute_tensor(whole, p.device_mesh, p.placements,
                                          src_data_rank=None).to_local()
                p = p.to_local()
            p.copy_(whole)
    # One group per mesh, the replicated plain tensors in one more: torch's
    # foreach optimizers (the default on the card) take one kind per call.
    groups: Dict[Any, list] = {}
    for p in model.parameters():
        groups.setdefault(p.device_mesh if isinstance(p, DTensor) else None,
                          []).append(p)
    return TrainState(model, optimizer_fn(
        [{"params": ps} for ps in groups.values()])), placements


def load_whole(model: nn.Module,
               state: Mapping[str, torch.Tensor]) -> None:
    """Copy each parameter of a laid-out ``model`` that this rank holds
    from the whole tensor of the same name in ``state`` (a DTensor keeps
    its own slice, as ``init_sharded_state`` fills it); the layers of other
    pipeline stages, which this rank does not hold, are passed over."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            local = p.to_local() if isinstance(p, DTensor) else p
            whole = state[name].to(device=local.device, dtype=local.dtype)
            if isinstance(p, DTensor):
                whole = distribute_tensor(whole, p.device_mesh, p.placements,
                                          src_data_rank=None).to_local()
            local.copy_(whole)


def sharded_train_step(loss_fn: LossFn, mesh: DeviceMesh, state: TrainState,
                       batch: Any, accum_steps: int = 1,
                       bucket_mb: Optional[int] = None
                       ) -> Tuple[TrainState, Dict[str, Any]]:
    """One step of ``state`` (from ``init_sharded_state`` on ``mesh``) on
    this rank's rows of the global batch (``data.py``'s ``mesh=``): the
    counterpart of the step ``jit_train_step`` builds. FSDP2 reduces the
    gradients over ``(dp, fsdp)`` inside the backward; the replicated
    parameters' gradients, and every gradient over ``dcn_dp``, are
    averaged by ``grad_sync``'s bucketed all-reduce; the optimizer updates
    each shard in place. Returns ``(state, {"loss", "step", **aux})``, the
    loss and aux averaged over the batch axes: the global batch's mean,
    the same on every rank. ``accum_steps`` microbatches per step as
    ``grad_sync.train_step_accum``."""
    from tony_tpu_torch.parallel import grad_sync

    state.loss_fn = loss_fn
    metrics = grad_sync.train_step_accum(
        state, batch, accum_steps,
        bucket_mb or grad_sync.DEFAULT_BUCKET_MB, mesh=mesh)
    return state, metrics


def checkpoint_tree(state: TrainState) -> Dict[str, Any]:
    """The FULL training state as a checkpoint tree, ``{"step", "model",
    "optim"}`` (parameters alone would resume with re-warming Adam moments
    and a reset step counter). ``model`` and ``optim`` come from
    ``torch.distributed.checkpoint.state_dict.get_state_dict``: their
    tensors ARE the live parameters and moments (a restore loads into them
    in place). An optimizer that has not stepped yet has no moments; for
    it ``get_state_dict`` runs one step with zero gradients at learning
    rate 0, which creates them and moves no parameter. Param groups that
    differ in their parameters only (``init_sharded_state``'s, one per
    mesh) are written as one, so that a checkpoint restores under any
    layout, whatever groups that layout makes (``load_checkpoint_tree``
    splits it again)."""
    from torch.distributed.checkpoint.state_dict import get_state_dict

    model_sd, optim_sd = get_state_dict(state.model, state.optimizer)
    groups = optim_sd["param_groups"]
    hyper = [{k: v for k, v in g.items() if k != "params"} for g in groups]
    if all(h == hyper[0] for h in hyper[1:]):
        optim_sd = {**optim_sd, "param_groups": [
            {**hyper[0], "params": [n for g in groups for n in g["params"]]}]}
    return {"step": state.step, "model": model_sd, "optim": optim_sd}


def load_checkpoint_tree(state: TrainState, tree: Mapping[str, Any]
                         ) -> TrainState:
    """Put a (restored) checkpoint tree back into ``state``: parameters,
    optimizer moments and hyper-parameters, and the step count. A tree's
    one param group goes to each of the optimizer's groups."""
    from torch.distributed.checkpoint.state_dict import set_state_dict

    optim = tree["optim"]
    if len(optim["param_groups"]) == 1 < len(state.optimizer.param_groups):
        name = {id(p): n for n, p in state.model.named_parameters()}
        hyper = {k: v for k, v in optim["param_groups"][0].items()
                 if k != "params"}
        optim = {**optim, "param_groups": [
            {**hyper, "params": [name[id(p)] for p in g["params"]]}
            for g in state.optimizer.param_groups]}
    set_state_dict(state.model, state.optimizer,
                   model_state_dict=tree["model"], optim_state_dict=optim)
    state.step = int(tree["step"])
    return state
