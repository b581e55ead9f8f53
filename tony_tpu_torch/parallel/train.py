"""Training state and the train step, on one device.

Counterpart of ``tony_tpu/parallel/train.py``'s ``TrainState`` and the step
that ``jit_train_step`` builds: ``loss_fn(model, batch)`` returns
``(loss, aux)``, the step differentiates it, applies the optimizer and
returns ``{"loss", "step", **aux}``. Meshes, FSDP and TP come with a later
slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Tuple

import torch
from torch import nn

LossFn = Callable[[nn.Module, Any], Tuple[torch.Tensor, Dict[str, Any]]]


def adamw(params: Iterable[torch.Tensor], learning_rate: float,
          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> torch.optim.AdamW:
    """``torch.optim.AdamW`` with ``optax.adamw``'s defaults (torch's own
    weight decay default is 1e-2). Decay applies to every parameter, as
    optax applies it with no mask."""
    return torch.optim.AdamW(params, lr=learning_rate, betas=(b1, b2),
                             eps=eps, weight_decay=weight_decay)


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
        fields are used. Clears the gradients and counts the step."""
        if grads is not None:
            for name, p in self.model.named_parameters():
                p.grad = grads[name]
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        return self


def train_step(state: TrainState, batch: Any) -> Dict[str, Any]:
    """Forward, backward and update: ``{"loss": detached loss tensor,
    "step": the new step, **aux}``. Reads nothing back from the device."""
    loss, aux = state.loss_fn(state.model, batch)
    loss.backward()
    state.apply_gradients()
    return {"loss": loss.detach(), "step": state.step, **aux}
