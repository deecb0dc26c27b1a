"""The LM model zoo, the port's counterpart of ``repro.models``.

Params are plain trees (nested dicts of tensors) with the reference's key
paths and shapes. Every leaf carries a parallel "logical axes" spec
(``param_logical_axes``). Layer stacks carry a leading group axis (the
repeating pattern period). ``convert.params_from_jax`` carries a JAX
parameter tree across.
"""

from repro_torch.models.model import (
    init_params,
    abstract_params,
    param_logical_axes,
    forward,
    init_cache,
    abstract_cache,
    cache_logical_axes,
    decode_step,
    loss_fn,
    count_params,
    active_params,
)

__all__ = [
    "init_params",
    "abstract_params",
    "param_logical_axes",
    "forward",
    "init_cache",
    "abstract_cache",
    "cache_logical_axes",
    "decode_step",
    "loss_fn",
    "count_params",
    "active_params",
]
