from repro_torch.train.step import (
    make_prefill_step,
    make_serve_step,
    make_train_step,
)
from repro_torch.train.loop import TrainLoop, TrainLoopConfig

__all__ = ["make_train_step", "make_prefill_step", "make_serve_step",
           "TrainLoop", "TrainLoopConfig"]
