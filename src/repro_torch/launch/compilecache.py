"""Opt-in shared build directory for the CUDA kernel libraries.

The port's counterpart of ``repro.launch.compilecache``. JAX's persistent
compilation cache lets a restarted fleet worker reload its compiles from
disk; here a process builds each ``csrc/<name>.cu`` with nvcc on first use
into ``kernels/_build.BUILD_DIR`` and loads the library from there, named
by the hash of its inputs. Pointing every process at one directory makes
a restarted worker, or a second process, load the libraries instead of
building them. Builds there are safe across processes: each is written
under a private name and renamed into place.

Opt-in (``serve.py --compile-cache DIR`` / ``fleet.worker --compile-cache
DIR``); without it a process uses the default directory at the root of the
checkout.
"""

from __future__ import annotations

from pathlib import Path


def enable_compile_cache(directory: str) -> bool:
    """Build and load this process's kernel libraries in ``directory``.

    Returns True, as the JAX package's does when its cache is enabled:
    every build of the port reads the directory at call time.
    """
    from repro_torch.kernels import _build

    _build.BUILD_DIR = Path(directory)
    return True
