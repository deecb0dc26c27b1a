"""Step builders for serving: the prefill and serve steps. Training
(``make_train_step``, ``TrainLoop``) is not ported yet (ROADMAP 6c)."""

from repro_torch.train.step import make_prefill_step, make_serve_step

__all__ = ["make_prefill_step", "make_serve_step"]
