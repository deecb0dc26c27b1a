"""Build the port's CUDA sources with nvcc at first use and bind them by ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared
library, ``build/repro_torch_kernels/lib<name>-<hash>.so`` at the root of
the checkout. The hash covers the source, every header of ``csrc/``
(``*.cuh``, which the sources include) and the compiler flags, so a library
built from other sources is never loaded. Nothing is built when a
module is imported: :func:`load` builds on the first kernel launch, and
:func:`build` builds several sources at once, one nvcc process each, all
started together. The compiler's ``-Xptxas -v`` report (registers, shared
memory, spills) is kept beside each library as ``.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Mapping, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
# -ftz=true: float32 arithmetic flushes subnormals, as the reference's XLA
# does (csrc/denoise.cu); the kernels' foreground tests read the bits and do
# not depend on it
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-ftz=true", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 600

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of the CUDA compiler; raises when the toolkit is absent."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (searched PATH and $CUDA_HOME/bin): the CUDA "
        "kernels build only where the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, named by the hash of its inputs:
    the source, the headers beside it and the compiler flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every named source that is not built yet, in parallel.

    Returns seconds per source (0.0 for one already built). Raises with the
    compiler's output when a build fails.
    """
    with _LOCK:
        return _build_locked(list(names))


def _build_locked(names: Sequence[str]) -> Dict[str, float]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = None
    jobs = []
    seconds = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        compiler = compiler or nvcc()
        # build under a private name, then rename: a concurrent loader in
        # another process never sees a half-written library
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc, time.perf_counter()))
    failures = []
    for name, out, tmp, proc, t0 in jobs:
        try:
            log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            log += f"\nnvcc timed out after {BUILD_TIMEOUT_S} s"
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"--- {name} (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return seconds


def load(name: str,
         signatures: Mapping[str, Sequence[type]]) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built if needed, with ``argtypes``
    set from ``signatures`` (function name -> ctypes argument types) and an
    int ``restype`` (the CUDA error code) for each function."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"kernel library {name!r} needs a CUDA device and this process "
            "sees none; on the CPU the wrappers run their plain versions")
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _build_locked([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
    return lib


def on_stream(x: torch.Tensor, fn, *args) -> int:
    """``fn(*args, stream)`` on the current stream of ``x``'s device, made
    the current device first only when it is not (the C entry points launch
    on the current device). The stream handle is read with the private
    ``torch._C._cuda_getCurrentRawStream``: the public
    ``torch.cuda.current_stream(index).cuda_stream`` builds a Stream object
    on every call, a few microseconds of host time that a host-bound
    wrapper would pay on every call."""
    index = x.get_device()
    if index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


def loaded() -> tuple[str, ...]:
    """Names of the libraries loaded into this process so far."""
    return tuple(sorted(_LIBS))
