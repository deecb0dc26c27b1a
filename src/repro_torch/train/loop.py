"""Fault-tolerant training loop: the port's counterpart of
``repro.train.loop``, over the port's ``Checkpointer`` (whose files either
package restores).

  * checkpoint cadence + atomic save and auto-resume from the newest
    complete step; data is a pure function of (seed, step), so the token
    stream resumes exactly;
  * step deadline: a step over ``step_timeout_s`` is recorded, and after
    more than ``max_step_retries`` consecutive misses the loop checkpoints
    and raises ``TimeoutError`` so a scheduler can reschedule the job;
  * NaN handling: a step whose loss is not finite is skipped and counted,
    and the old parameters and optimiser state are kept (the step function
    is out of place, ``optim.adamw``);
  * a final save when the loop ends.

The step's time is taken after ``float(metrics["loss"])``, which on the
card waits for the step to finish, so the deadline times the step and not
its launch.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, Iterator, Optional

from repro_torch.checkpoint import Checkpointer


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    keep: int = 3
    log_every: int = 10
    step_timeout_s: float = math.inf
    max_step_retries: int = 3
    async_ckpt: bool = False


class TrainLoop:
    def __init__(
        self,
        step_fn: Callable,
        loop_cfg: TrainLoopConfig,
        log_fn: Callable[[int, Dict[str, float]], None] | None = None,
    ):
        self.step_fn = step_fn
        self.cfg = loop_cfg
        self.log_fn = log_fn or (lambda s, m: print(
            f"step {s}: " + " ".join(f"{k}={v:.4g}" for k, v in m.items())
        ))
        self.ckpt = (
            Checkpointer(loop_cfg.ckpt_dir, keep=loop_cfg.keep,
                         async_save=loop_cfg.async_ckpt)
            if loop_cfg.ckpt_dir else None
        )
        self.nan_skips = 0
        self.deadline_misses = 0

    def resume_or_init(self, params, opt_state):
        """If a complete checkpoint exists, restore it (each leaf onto its
        counterpart's device and dtype); else return the inputs."""
        start = 0
        if self.ckpt is not None:
            latest = self.ckpt.latest_step()
            if latest is not None:
                tree = self.ckpt.restore(latest, {"params": params,
                                                  "opt": opt_state})
                params, opt_state = tree["params"], tree["opt"]
                start = latest
        return params, opt_state, start

    def _save(self, step: int, params, opt_state) -> None:
        self.ckpt.save(step, {"params": params, "opt": opt_state})

    def run(self, params, opt_state, batches: Iterator[Dict],
            start_step: int = 0):
        cfg = self.cfg
        step = start_step
        consecutive_misses = 0
        for batch in batches:
            if step >= cfg.total_steps:
                break
            t0 = time.monotonic()
            new_params, new_opt, metrics = self.step_fn(params, opt_state,
                                                        batch)
            loss = float(metrics["loss"])
            dt = time.monotonic() - t0
            if not math.isfinite(loss):
                self.nan_skips += 1   # skip the update, keep the old state
                step += 1
                continue
            params, opt_state = new_params, new_opt
            if dt > cfg.step_timeout_s:
                self.deadline_misses += 1
                consecutive_misses += 1
                if consecutive_misses > cfg.max_step_retries:
                    if self.ckpt:
                        self._save(step + 1, params, opt_state)
                        self.ckpt.wait()
                    raise TimeoutError(
                        f"{consecutive_misses} consecutive steps over "
                        f"{cfg.step_timeout_s}s deadline — self-evicting "
                        f"for reschedule")
            else:
                consecutive_misses = 0
            step += 1
            if step % cfg.log_every == 0:
                self.log_fn(step, {k: float(v) for k, v in metrics.items()})
            if self.ckpt and step % cfg.ckpt_every == 0:
                self._save(step, params, opt_state)
        if self.ckpt:
            self._save(step, params, opt_state)
            self.ckpt.wait()
        return params, opt_state, step
