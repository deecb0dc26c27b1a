"""`repro_torch.engine` — the port's entry point for image-operator compute.

Build an :class:`Engine` from a frozen :class:`EngineConfig` and a device
(``"cuda"`` unless the caller asks for ``"cpu"``), optionally with a batch
mesh (``mesh=repro_torch.sharding.make_batch_mesh()``); call ``analyze``
(one mask), ``analyze_batch`` (a stack) or ``analyze_stream`` (an
iterable).
Every call returns a result that stays on the device; ``.to_host()`` gives
NumPy arrays, ``.to_summary()`` the op's summary view.

Backend dispatch lives in :mod:`repro_torch.engine.registry`, keyed on
``(op, backend name)``; ``backend="auto"`` resolves from the op and the
engine's device type. What each op *is* lives in
:mod:`repro_torch.engine.ops`.
"""

from repro_torch.engine.engine import (
    Engine,
    EngineConfig,
    YCHGConfig,
    YCHGEngine,
    YCHGResult,
)
from repro_torch.engine.registry import (
    BackendSpec,
    UnknownOpError,
    backend_names,
    get_backend,
    register_backend,
    registered_ops,
    resolve,
)
from repro_torch.engine.ops import (
    CCLResult,
    DenoiseResult,
    OpSpec,
    get_op,
    op_names,
    pipeline_op_key,
    register_op,
    split_pipeline_key,
    validate_pipeline,
)
from repro_torch.engine.ops import register_builtin_ops as _builtin

_builtin()
del _builtin
from repro_torch.engine import backends as _backends  # noqa: E402,F401  (self-registration)

__all__ = [
    "BackendSpec",
    "CCLResult",
    "DenoiseResult",
    "Engine",
    "EngineConfig",
    "OpSpec",
    "UnknownOpError",
    "YCHGConfig",
    "YCHGEngine",
    "YCHGResult",
    "backend_names",
    "get_backend",
    "get_op",
    "op_names",
    "pipeline_op_key",
    "register_backend",
    "register_op",
    "registered_ops",
    "resolve",
    "split_pipeline_key",
    "validate_pipeline",
]
