"""Deterministic synthetic LM token pipeline (NumPy only): the port's copy
of ``repro.data.synthetic``.

Sequences are generated from a seeded Markov-ish process so that (a) runs
are exactly reproducible across restarts — a step's batch is a pure function
of (seed, step) — which is what makes checkpoint-resume byte-identical, and
(b) there is real learnable structure (bigram preferences), so the ~100M
example run shows a falling loss rather than noise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenDatasetConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # structure knobs
    n_patterns: int = 64
    pattern_len: int = 16


class TokenDataset:
    """Batch = f(seed, step): stateless, shardable by host."""

    def __init__(self, cfg: TokenDatasetConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.patterns = rng.integers(
            0, cfg.vocab_size, size=(cfg.n_patterns, cfg.pattern_len)
        ).astype(np.int32)

    def batch(self, step: int, host_id: int = 0, num_hosts: int = 1
              ) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        assert cfg.global_batch % num_hosts == 0
        per_host = cfg.global_batch // num_hosts
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, host_id])
        )
        n_pat = cfg.seq_len // cfg.pattern_len + 2
        idx = rng.integers(0, cfg.n_patterns, size=(per_host, n_pat))
        seq = self.patterns[idx].reshape(per_host, -1)[:, : cfg.seq_len + 1]
        noise = rng.random((per_host, cfg.seq_len + 1)) < 0.05
        rand_tok = rng.integers(0, cfg.vocab_size, size=(per_host, cfg.seq_len + 1))
        seq = np.where(noise, rand_tok, seq).astype(np.int32)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}

    def iter(self, start_step: int = 0, host_id: int = 0, num_hosts: int = 1
             ) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step, host_id, num_hosts)
            step += 1
