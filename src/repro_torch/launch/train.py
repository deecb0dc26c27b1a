"""The train command: ``--arch <id> [--smoke]`` trains on the card (or the
CPU with ``--device cpu``): the port's counterpart of
``repro.launch.train``.

Weights are drawn from a seeded generator on the device; batches come from
the synthetic ``TokenDataset``, a pure function of (seed, step), so a run
given ``--ckpt`` resumes exactly where it stopped.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --smoke --steps 20 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --steps 20 --batch 8 --seq 256          # the full config, the card
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.configs.archs import smoke_config
from repro_torch.data.synthetic import TokenDataset, TokenDatasetConfig
from repro_torch.models import count_params, init_params
from repro_torch.models.layers import resolve_device, torch_dtype
from repro_torch.optim import adamw_init
from repro_torch.train import TrainLoop, TrainLoopConfig, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config of the same family (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; default: the CUDA card")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device = resolve_device(args.device)
    print(f"{cfg.name}: {count_params(cfg) / 1e6:.2f}M params on {device}")

    params = init_params(cfg, torch.Generator(device).manual_seed(0))
    opt = adamw_init(params)
    ds = TokenDataset(TokenDatasetConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
    ))
    step = make_train_step(
        cfg, peak_lr=args.lr, warmup_steps=max(args.steps // 10, 1),
        total_steps=args.steps, grad_accum=args.grad_accum,
    )
    loop = TrainLoop(step, TrainLoopConfig(
        total_steps=args.steps, ckpt_dir=args.ckpt, log_every=10,
    ))
    params, opt, start = loop.resume_or_init(params, opt)

    def batches():
        i = start
        while True:
            out = dict(ds.batch(i))
            if cfg.frontend != "none" and cfg.frontend_tokens:
                out["frontend_embeds"] = torch.zeros(
                    (args.batch, cfg.frontend_tokens, cfg.d_model),
                    dtype=torch_dtype(cfg.activation_dtype), device=device)
            yield out
            i += 1

    loop.run(params, opt, batches(), start_step=start)


if __name__ == "__main__":
    main()
