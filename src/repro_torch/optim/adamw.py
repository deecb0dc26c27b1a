"""AdamW + global-norm clipping + warmup-cosine schedule over parameter
trees: the port's counterpart of ``repro.optim.adamw``.

Decoupled weight decay (Loshchilov & Hutter) with bias-corrected moments;
b1 0.9, b2 0.95, eps 1e-8; decay applies to every leaf. Moments are
float32 whatever the parameters' dtype. The update is out of place: it
returns new parameter and moment trees and leaves its inputs as they
were, so a caller that declines a step (``TrainLoop``'s NaN skip) keeps
the old state. The step counter and the learning rate stay tensors on the
parameters' device, so a step never waits for the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch

from repro_torch.models.layers import tree_leaves_with_path, tree_map

Tensor = torch.Tensor


@dataclasses.dataclass
class OptState:
    step: Tensor    # () int32
    mu: Any         # float32 tree like the parameters
    nu: Any         # float32 tree like the parameters


def _device_of(params: Any) -> torch.device:
    return next(t for _, t in tree_leaves_with_path(params)).device


def adamw_init(params: Any) -> OptState:
    """Zeroed float32 moments beside the parameters (laid out as each
    parameter is, a DTensor's placements included), step 0."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=_device_of(params)),
        mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def abstract_opt_state(params: Any) -> OptState:
    """The optimiser state's shapes and dtypes on ``meta``."""
    def zeros(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")

    return OptState(step=torch.empty((), dtype=torch.int32, device="meta"),
                    mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def clip_by_global_norm(grads: Any, max_norm: float) -> Tuple[Any, Tensor]:
    """(grads scaled to a global norm of at most ``max_norm``, the global
    norm in float32)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                        for _, g in tree_leaves_with_path(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1) -> Tensor:
    step = torch.as_tensor(step).float()
    warm = peak_lr * step / max(warmup_steps, 1)
    frac = torch.clamp(
        (step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5
                     * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup_steps, warm, cos)


def adamw_update(
    params: Any,
    grads: Any,
    state: OptState,
    *,
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> Tuple[Any, OptState]:
    """One AdamW step: (new parameters, new state); nothing is written in
    place."""
    step = state.step + 1
    t = step.float()
    c1 = 1.0 - torch.pow(b1, t)
    c2 = 1.0 - torch.pow(b2, t)
    new_mu = tree_map(lambda g, m: b1 * m + (1 - b1) * g.float(),
                      grads, state.mu)
    new_nu = tree_map(lambda g, v: b2 * v + (1 - b2) * torch.square(g.float()),
                      grads, state.nu)

    def upd(p, m, v):
        # decoupled weight decay, applied to every leaf as the reference does
        p32 = p.float()
        delta = lr * ((m / c1) / (torch.sqrt(v / c2) + eps)
                      + weight_decay * p32)
        return (p32 - delta).to(p.dtype)

    new_params = tree_map(upd, params, new_mu, new_nu)
    return new_params, OptState(step=step, mu=new_mu, nu=new_nu)
