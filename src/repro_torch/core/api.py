"""DEPRECATED shim over :mod:`repro_torch.engine` — use ``Engine`` instead.

The port's counterpart of ``repro.core.api``. ``analyze_image`` was the
JAX package's original entry point with string backend selection; every
call emits a ``DeprecationWarning`` and delegates to a cached engine for
the backend, returning the legacy host-NumPy dict. New code constructs
the engine directly::

    from repro_torch.engine import Engine, EngineConfig
    engine = Engine(EngineConfig(backend="torch"))   # on the card
    result = engine.analyze(img)          # device-resident YCHGResult
    legacy = result.to_host()             # the dict this shim returns

Backend names are the port's registry names ("torch", "fused", "cuda",
"serial", "scalar"): the JAX package's "jax", "fused", "pallas", "serial"
and "scalar" under ``configs.ychg_modis.engine_config_from_jax``. The
engines run on the card unless ``device="cpu"`` is passed (``serial`` and
``scalar`` compute on the host and hand their result back to the device).
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Tuple

import numpy as np

BACKENDS = ("torch", "fused", "cuda", "serial", "scalar")

_ENGINES: Dict[Tuple[str, str], Any] = {}


def _engine(backend: str, device: Any):
    key = (backend, str(device))
    if key not in _ENGINES:
        from repro_torch.engine import Engine, EngineConfig

        _ENGINES[key] = Engine(EngineConfig(backend=backend), device=device)
    return _ENGINES[key]


def analyze_image(img: Any, backend: str = "torch", *,
                  device: Any = None) -> Dict[str, np.ndarray]:
    """DEPRECATED: use ``repro_torch.engine.Engine``. Returns host NumPy
    values; a 3-D input is a (B, H, W) stack."""
    warnings.warn(
        "repro_torch.core.api.analyze_image is deprecated; use "
        "repro_torch.engine.Engine(...).analyze(img) (and .to_host() for "
        "this dict form)",
        DeprecationWarning,
        stacklevel=2,
    )
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    engine = _engine(backend, device)
    if np.ndim(img) == 3:  # the legacy paths accepted (B, H, W) stacks
        return engine.analyze_batch(img).to_host()
    return engine.analyze(img).to_host()
