"""Twins of the JAX package's examples (the five yCHG ones, ``serve_lm``
and ``train_lm``), each run as ``python -m repro_torch.examples.<name>
[--device cpu]`` (the card unless ``--device cpu``). Importing one runs
nothing."""

import argparse


def parse_device(description: str, argv=None):
    """The examples' one flag: ``--device`` (None: the card)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; default: the CUDA card")
    return ap.parse_args(argv).device
