"""End-to-end training run: a qwen2-family model trained with the full loop
(checkpointing, resume, metrics).

The port's twin of ``examples/train_lm.py``: a ~100M-parameter
reduced-width qwen2, or with ``--tiny`` a 2M one, from a seeded
generator, on the card unless ``--device cpu``. ``--ckpt`` defaults to a
directory under the system's temporary directory; a second run with the
same ``--ckpt`` resumes.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm [--tiny]
      [--steps 300] [--ckpt DIR] [--device cpu]
"""

import argparse
import os
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.data.synthetic import TokenDataset, TokenDatasetConfig
from repro_torch.models import count_params, init_params
from repro_torch.models.layers import resolve_device
from repro_torch.optim import adamw_init
from repro_torch.train import TrainLoop, TrainLoopConfig, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_lm"))
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; default: the CUDA card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.tiny:
        cfg = get_config("qwen2-0.5b").scaled(
            name="qwen2-2m", num_layers=2, d_model=128, num_heads=4,
            num_kv_heads=2, head_dim=32, d_ff=512, vocab_size=2048,
            param_dtype="float32", activation_dtype="float32",
            remat="none", attn_chunk=256,
        )
        batch, seq = 8, 256
    else:
        cfg = get_config("qwen2-0.5b").scaled(
            name="qwen2-100m", num_layers=8, d_model=512, num_heads=8,
            num_kv_heads=2, head_dim=64, d_ff=2048, vocab_size=32_768,
            param_dtype="float32", activation_dtype="float32",
            remat="none", attn_chunk=512,
        )
        batch, seq = 8, 512

    print(f"model {cfg.name}: {count_params(cfg) / 1e6:.1f}M params on "
          f"{device}")
    params = init_params(cfg, torch.Generator(device).manual_seed(0))
    opt = adamw_init(params)

    ds = TokenDataset(TokenDatasetConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
        n_patterns=256,
    ))
    step = make_train_step(cfg, peak_lr=1e-3, warmup_steps=20,
                           total_steps=args.steps)

    loop = TrainLoop(step, TrainLoopConfig(
        total_steps=args.steps, ckpt_dir=args.ckpt, ckpt_every=100,
        log_every=10,
    ))
    params, opt, start = loop.resume_or_init(params, opt)
    if start:
        print(f"resumed from step {start}")

    def batches():
        i = start
        while True:
            yield ds.batch(i)
            i += 1

    loop.run(params, opt, batches(), start_step=start)
    print(f"done; nan_skips={loop.nan_skips} "
          f"deadline_misses={loop.deadline_misses}")


if __name__ == "__main__":
    main()
