"""Batched serving engine: prefill + decode with a fixed-slot KV cache.

The port's counterpart of ``repro.serve.engine``. Static-batch engine:
all slots share a step index. Requests shorter than the batch's prompt
window are left-padded so every slot decodes from the same cur_index;
sampled tokens for already-finished slots are masked. A
continuous-batching scheduler slots in above this engine, its step
function unchanged.

Runs on the card unless ``device="cpu"``; the parameters must already be
on that device. With ``mesh`` (a ``DeviceMesh``) the parameters are
DTensors on it (``sharding.place(params, param_shardings(...))``), the
steps run under ``rules`` (default: the decode rules with the config's
``decode_rule_overrides``), the prompt is placed by the batch rule, the
prefill cache is laid out by ``cache_logical_axes`` under the decode
rules, and decode writes each new position into the rank's local shard
that holds it. Meshed calls run under ``no_grad`` (DTensor views of
inference tensors are refused), unmeshed ones under ``inference_mode``.

Greedy sampling is the first maximum (``torch.argmax``); with
``temperature > 0`` tokens are drawn with a ``torch.Generator`` seeded
from ``seed``, so they are not the reference's ``jax.random`` draws
(ROADMAP Queue C).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import forward
from repro_torch.models.layers import (
    Sharder,
    is_dtensor,
    meshed,
    resolve_device,
    same_device,
    tree_leaves_with_path,
    tree_map_with_path,
)
from repro_torch.models.model import cache_logical_axes
from repro_torch.sharding.logical import make_rules, place, tree_shardings
from repro_torch.train.step import make_serve_step, place_input

# cache leaves with a kv-seq axis (axis 2 of (G, B, S, ...))
_SEQ_LEAVES = ("k", "v", "ckv", "k_rope")


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray        # (B, max_new)
    n_generated: int


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, max_len: int, device=None,
                 mesh=None, rules=None):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.mesh = mesh
        if mesh is not None:
            device = mesh.device_type if device is None else device
            self.cache_rules = make_rules("decode", cfg.decode_rule_overrides)
            rules = self.cache_rules if rules is None else rules
        self.device = resolve_device(device)
        off = [("/".join(p), str(t.device))
               for p, t in tree_leaves_with_path(params)
               if not same_device(t, self.device)]
        if off:
            raise ValueError(f"parameters not on {self.device}: {off[:3]}")
        self.shd = Sharder(mesh, rules)
        self._serve = make_serve_step(cfg, mesh, rules)

    def _prefill(self, params, tokens):
        tokens = place_input(self.shd, "tokens", tokens, self.device)
        with meshed(self.shd):
            logits, _, cache = forward(params, self.cfg, tokens, self.shd,
                                       return_cache=True)
        return logits[:, -1, :], cache

    def _decode_cache(self, cache):
        """The prefill cache grown to max_len and, under a mesh, laid out
        by ``cache_logical_axes`` under the decode rules."""
        cache = self._pad_cache(cache)
        if self.mesh is None:
            return cache
        b = next(t for _, t in tree_leaves_with_path(cache)).shape[1]
        with meshed(self.shd):
            return place(cache, tree_shardings(
                cache_logical_axes(self.cfg, b, self.max_len),
                self.cache_rules, self.mesh, cache))

    def _pad_cache(self, cache):
        """Grow prefill cache entries along the kv-seq axis to max_len."""

        max_len = self.max_len

        def pad(path, leaf):
            if path[-1] not in _SEQ_LEAVES:
                return leaf
            grow = list(leaf.shape)
            grow[2] = max_len - leaf.shape[2]   # (G,B,S,...)
            return torch.cat([leaf, leaf.new_zeros(grow)], dim=2)

        return tree_map_with_path(pad, cache)

    def generate(
        self,
        prompts: np.ndarray,          # (B, prompt_len) int32
        max_new: int,
        temperature: float = 0.0,
        seed: int = 0,
        eos_id: Optional[int] = None,
    ) -> GenerationResult:
        prompts = np.asarray(prompts)
        b, plen = prompts.shape
        if plen + max_new > self.max_len:
            raise ValueError(f"prompt {plen} + max_new {max_new} exceeds "
                             f"max_len {self.max_len}")
        if prompts.size and not (0 <= prompts.min()
                                 and prompts.max() < self.cfg.vocab_size):
            raise ValueError(f"prompt tokens outside [0, "
                             f"{self.cfg.vocab_size})")
        gen = (torch.Generator(self.device).manual_seed(seed)
               if temperature > 0.0 else None)
        out = []
        done = np.zeros(b, bool)
        grad_off = (torch.no_grad() if self.mesh is not None
                    else torch.inference_mode())
        with grad_off:
            tokens = torch.from_numpy(prompts.astype(np.int32)).to(
                self.device)
            logits, cache = self._prefill(self.params, tokens)
            cache = self._decode_cache(cache)
            tok = self._sample(logits, temperature, gen)
            for i in range(max_new):
                out.append(tok)
                if eos_id is not None:
                    done |= tok[:, 0].cpu().numpy() == eos_id
                    if done.all():
                        break
                if i + 1 == max_new:   # the reference's last step is unused
                    break
                logits, cache = self._serve(self.params, cache, tok,
                                            plen + i)
                tok = self._sample(logits, temperature, gen)
            tokens = (torch.cat(out, dim=1).cpu().numpy() if out
                      else np.zeros((b, 0), np.int32))
        return GenerationResult(tokens=tokens, n_generated=len(out))

    @staticmethod
    def _sample(logits, temperature: float, generator):
        """(B, V) logits -> (B, 1) int32 tokens (a plain tensor)."""
        if is_dtensor(logits):
            logits = logits.full_tensor()
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator).to(
            torch.int32)
