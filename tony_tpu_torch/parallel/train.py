"""Training state and the train step, on one device.

Counterpart of ``tony_tpu/parallel/train.py``'s ``TrainState`` and the step
that ``jit_train_step`` builds: ``loss_fn(model, batch)`` returns
``(loss, aux)``, the step differentiates it, applies the optimizer and
returns ``{"loss", "step", **aux}``. Meshes, FSDP and TP come with a later
slice.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Tuple

import torch
from torch import nn

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
    loss_fn: LossFn
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


def checkpoint_tree(state: TrainState) -> Dict[str, Any]:
    """The FULL training state as a checkpoint tree, ``{"step", "model",
    "optim"}`` (parameters alone would resume with re-warming Adam moments
    and a reset step counter). ``model`` and ``optim`` come from
    ``torch.distributed.checkpoint.state_dict.get_state_dict``: their
    tensors ARE the live parameters and moments (a restore loads into them
    in place). An optimizer that has not stepped yet has no moments; for
    it ``get_state_dict`` runs one step with zero gradients at learning
    rate 0, which creates them and moves no parameter."""
    from torch.distributed.checkpoint.state_dict import get_state_dict

    model_sd, optim_sd = get_state_dict(state.model, state.optimizer)
    return {"step": state.step, "model": model_sd, "optim": optim_sd}


def load_checkpoint_tree(state: TrainState, tree: Mapping[str, Any]
                         ) -> TrainState:
    """Put a (restored) checkpoint tree back into ``state``: parameters,
    optimizer moments and hyper-parameters, and the step count."""
    from torch.distributed.checkpoint.state_dict import set_state_dict

    set_state_dict(state.model, state.optimizer,
                   model_state_dict=tree["model"],
                   optim_state_dict=tree["optim"])
    state.step = int(tree["step"])
    return state
