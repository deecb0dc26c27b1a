"""Step builders: train_step (gradients, global-norm clipping, the
warmup-cosine schedule and AdamW, optionally over microbatches),
prefill_step (forward + cache materialisation) and serve_step (one token
against the cache). The port's counterpart of ``repro.train.step``.

The gradient is autograd's: every parameter leaf is detached, set to
require grad, and ``torch.autograd.grad`` of ``loss_fn`` is taken over
those leaves, so the caller's tree is never touched and the step returns
new parameter and optimiser trees (see ``optim.adamw``). Gradient
accumulation is a loop over ``grad_accum`` microbatches that adds float32
gradients, then divides the loss and the gradients, as the reference's
``lax.scan`` does.

Under a mesh (a ``DeviceMesh`` with "data"/"model" axes, and a rule
table) the parameters and moments are DTensors placed by
``sharding.param_shardings`` and the steps run inside
``models.layers.meshed``: each input is distributed by the batch rule
(the counterpart of the dry run's ``_batch_shardings``), the model's
``Sharder`` lays out its activations, and AdamW and clipping run on the
DTensors, so the global gradient norm is the norm of the whole gradient.
Metrics come back as plain tensors.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode_step, forward, loss_fn
from repro_torch.models.layers import (
    Sharder,
    is_dtensor,
    meshed,
    tree_leaves_with_path,
    tree_map,
)
from repro_torch.optim import adamw_update, clip_by_global_norm, warmup_cosine

# logical axes of the step inputs, as the reference's dry run shards them
INPUT_AXES = {"tokens": ("act_batch", "act_seq"),
              "labels": ("act_batch", "act_seq"),
              "frontend_embeds": ("act_batch", "act_seq", "act_embed")}


def place_input(shd: Sharder, name: str, x, device: torch.device):
    """A batch entry on ``device``, placed by its batch rule under a
    mesh."""
    if x is None:
        return None
    x = torch.as_tensor(x).to(device)
    if not shd.active:
        return x
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.sharding.logical import placements, spec_for

    spec = spec_for(INPUT_AXES[name], shd.rules, shd.mesh, x.shape)
    return distribute_tensor(x, shd.mesh, placements(spec, shd.mesh))


def _plain(x):
    """A metric as a plain tensor (the whole of a DTensor)."""
    return x.full_tensor() if is_dtensor(x) else x


def make_train_step(
    cfg: ModelConfig,
    mesh=None,
    rules=None,
    *,
    grad_accum: int = 1,
    peak_lr: float = 3e-4,
    warmup_steps: int = 100,
    total_steps: int = 10_000,
    max_grad_norm: float = 1.0,
    weight_decay: float = 0.1,
) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params', opt_state',
    metrics). ``batch`` holds ``tokens`` and ``labels`` (B, S) and
    optionally ``frontend_embeds``, as tensors or NumPy arrays; they are
    moved to the parameters' device (and placed by the batch rule under a
    mesh). The metrics are 0-dim tensors: ``loss``, ``ce``, ``aux``,
    ``grad_norm``, ``lr``."""
    shd = Sharder(mesh, rules)

    def value_and_grad(params, tokens, labels, frontend_embeds):
        leaves = []
        for path, t in tree_leaves_with_path(params):
            if not t.dtype.is_floating_point:
                raise ValueError(f"{'/'.join(path)} is {t.dtype}: training "
                                 f"needs floating-point parameters")
            leaves.append(t.detach().requires_grad_(True))
        it = iter(leaves)
        live = tree_map(lambda _: next(it), params)
        with torch.enable_grad():
            loss, metrics = loss_fn(live, cfg, tokens, labels, shd,
                                    frontend_embeds)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # each gradient laid out as its parameter (under a mesh: the FSDP
        # reduce-scatter and the data-parallel all-reduce), so that AdamW's
        # moments and the new parameters keep the parameters' layout
        it = iter(torch.zeros_like(leaf) if g is None
                  else g.redistribute(leaf.device_mesh, leaf.placements)
                  if is_dtensor(g) else g
                  for g, leaf in zip(grads, leaves))
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                tree_map(lambda _: next(it), params))

    def batch_entry(batch, name, device, rows=slice(None)):
        x = batch.get(name)
        return None if x is None else place_input(shd, name, x[rows], device)

    def train_step(params, opt_state, batch: Dict[str, Any]):
        device = opt_state.step.device
        with meshed(shd):
            if grad_accum == 1:
                loss, metrics, grads = value_and_grad(
                    params, batch_entry(batch, "tokens", device),
                    batch_entry(batch, "labels", device),
                    batch_entry(batch, "frontend_embeds", device))
            else:
                b = batch["tokens"].shape[0]
                assert b % grad_accum == 0, (b, grad_accum)
                mb = b // grad_accum
                grads = tree_map(
                    lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)
                loss = torch.zeros((), dtype=torch.float32, device=device)
                for i in range(grad_accum):
                    part = slice(i * mb, (i + 1) * mb)
                    l_i, _, g_i = value_and_grad(
                        params, batch_entry(batch, "tokens", device, part),
                        batch_entry(batch, "labels", device, part), None)
                    grads = tree_map(torch.add, grads, g_i)
                    loss = loss + l_i
                loss = loss / grad_accum
                grads = tree_map(lambda g: g / grad_accum, grads)
                metrics = {"ce": loss,
                           "aux": torch.zeros((), dtype=torch.float32,
                                              device=device)}

            grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
            lr = warmup_cosine(opt_state.step, peak_lr=peak_lr,
                               warmup_steps=warmup_steps,
                               total_steps=total_steps)
            params, opt_state = adamw_update(params, grads, opt_state, lr=lr,
                                             weight_decay=weight_decay)
            out_metrics = {
                "loss": _plain(loss),
                "ce": _plain(metrics["ce"]),
                "aux": _plain(metrics["aux"]),
                "grad_norm": _plain(gnorm),
                "lr": lr,
            }
        return params, opt_state, out_metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, mesh=None, rules=None) -> Callable:
    """Returns prefill(params, batch) -> (last-position logits, cache)."""
    shd = Sharder(mesh, rules)

    def prefill_step(params, batch: Dict[str, Any]):
        device = next(t for _, t in tree_leaves_with_path(params)).device
        tokens = place_input(shd, "tokens", batch["tokens"], device)
        fe = place_input(shd, "frontend_embeds",
                         batch.get("frontend_embeds"), device)
        with meshed(shd):
            logits, _, cache = forward(params, cfg, tokens, shd, fe,
                                       return_cache=True)
            return logits[:, -1, :], cache

    return prefill_step


def make_serve_step(cfg: ModelConfig, mesh=None, rules=None) -> Callable:
    """Returns serve(params, cache, tokens, cur_index) -> (logits, cache')."""
    shd = Sharder(mesh, rules)

    def serve_step(params, cache, tokens, cur_index):
        with meshed(shd):
            if shd.active:
                tokens = place_input(shd, "tokens", tokens, tokens.device)
            return decode_step(params, cfg, cache, tokens, cur_index, shd)

    return serve_step
