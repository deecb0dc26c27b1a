"""Step builders: prefill_step (forward + cache materialisation) and
serve_step (one token against the cache), the two that
``repro_torch.serve`` runs. The port's counterpart of part of
``repro.train.step``; ``make_train_step`` (grads, AdamW, microbatch
accumulation) waits for training, ROADMAP 6c.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode_step, forward
from repro_torch.models.layers import Sharder


def make_prefill_step(cfg: ModelConfig, mesh=None, rules=None) -> Callable:
    """Returns prefill(params, batch) -> (last-position logits, cache)."""
    shd = Sharder(mesh, rules)

    def prefill_step(params, batch: Dict[str, Any]):
        logits, _, cache = forward(
            params, cfg, batch["tokens"], shd,
            batch.get("frontend_embeds"), return_cache=True,
        )
        return logits[:, -1, :], cache

    return prefill_step


def make_serve_step(cfg: ModelConfig, mesh=None, rules=None) -> Callable:
    """Returns serve(params, cache, tokens, cur_index) -> (logits, cache')."""
    shd = Sharder(mesh, rules)

    def serve_step(params, cache, tokens, cur_index):
        return decode_step(params, cfg, cache, tokens, cur_index, shd)

    return serve_step
