"""(op, backend) registry for the image-operator engine.

Every implementation of an operator registers itself here as a
:class:`BackendSpec` with capability flags instead of being named in an
if/elif chain. The registry is keyed on ``(op, name)`` — the platform grew
from "a yCHG server" into "an image-operator platform serving yCHG first",
so ``backend="auto"`` resolution is a pure function of (op, platform,
batch shape, mesh attached) over the registered specs:

  * ``op`` — which operator the spec implements (``"ychg"``, ``"ccl"``
    or ``"denoise"`` in this port);
  * ``device_kinds`` — platforms the backend can execute on at all: the
    torch device types ``"cpu"`` and ``"cuda"`` (a kernel backend on
    ``"cpu"`` runs its kernels' plain versions: exact, not fast);
  * ``priority`` — per-platform preference; highest wins for ``auto``.
    This is how "the kernel on the card, plain torch on the CPU" is
    expressed as data: ``torch`` outranks the kernel backend (``fused``
    for ychg, ``cuda`` for ccl and denoise) on cpu, and the kernel backend
    outranks ``torch`` on cuda;
  * ``supports_batch`` — the callable consumes a whole (B, H, W) stack in
    one device computation (vs the engine looping images on host);
  * ``supports_mesh`` — safe to split over a batch-sharded set of devices
    (pure per-image math, no cross-image state).

The platform an engine resolves for is its own device type, not a
process-wide probe. A copy of ``repro.engine.registry`` with those keys.
The in-repo backends self-register on ``import repro_torch.engine`` (see
``repro_torch.engine.backends``). Out-of-tree code may register additional
backends — including whole new ops — with :func:`register_backend`;
``resolve.cache_clear()`` runs automatically on registration and the
generation counter lets engines revalidate cached resolutions.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import warnings
from typing import Callable, Mapping, Optional, Tuple

from repro_torch.obs.histogram import DISPATCH_BOUNDS, Histogram, HistogramSnapshot

__all__ = [
    "BackendSpec",
    "UnknownOpError",
    "backend_names",
    "call_count",
    "dispatch_seconds",
    "get_backend",
    "note_call",
    "note_dispatch",
    "register_backend",
    "registered_ops",
    "reset_call_counts",
    "resolve",
]


class UnknownOpError(ValueError):
    """Raised when resolution names an op with no registered backend."""


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """One registered operator implementation.

    ``run(imgs, config)`` takes a (B, H, W) tensor stack plus an
    ``EngineConfig`` and returns the op's batched summary, bit-identical to
    the op's in-repo reference on the same stack (``core.ychg.analyze``
    for ``op="ychg"``; see ``repro_torch.engine.ops``).

    ``plan(shape, dtype, config)`` reckons what ``run`` does on the card
    for a (B, H, W) stack of that shape and dtype, from the shape alone
    (a ``kernels.plan.Plan``); ``Engine.lower`` reads it. None for a
    backend that runs on the host, which cannot be lowered.
    """

    name: str
    run: Callable
    supports_batch: bool
    supports_mesh: bool
    device_kinds: Tuple[str, ...]
    # per-device-kind preference used by "auto"; kinds absent from the map
    # fall back to 0. Must only contain kinds from device_kinds.
    priority: Mapping[str, int] = dataclasses.field(default_factory=dict)
    # operator this spec implements; the registry key is (op, name)
    op: str = "ychg"
    plan: Optional[Callable] = None

    def priority_on(self, platform: str) -> int:
        return self.priority.get(platform, 0)


_REGISTRY: dict[tuple[str, str], BackendSpec] = {}
_GENERATION = 0  # bumped on registration; engines cache resolution against it


def generation() -> int:
    """Monotonic registry version, for callers that cache resolved specs."""
    return _GENERATION


def register_backend(spec: BackendSpec) -> BackendSpec:
    """Register (or replace) a backend under (spec.op, spec.name)."""
    global _GENERATION
    for kind in spec.priority:
        if kind not in spec.device_kinds:
            raise ValueError(
                f"backend {spec.name!r}: priority for {kind!r} but "
                f"device_kinds={spec.device_kinds}"
            )
    _REGISTRY[(spec.op, spec.name)] = spec
    _GENERATION += 1
    resolve.cache_clear()
    return spec


def unregister_backend(name: str, op: str = "ychg") -> None:
    """Remove a backend (e.g. a benchmark/test stub); unknown names are a
    no-op. Engines revalidate their cached resolution via generation()."""
    global _GENERATION
    if _REGISTRY.pop((op, name), None) is not None:
        _GENERATION += 1
        resolve.cache_clear()


def backend_names(op: str = "ychg") -> tuple[str, ...]:
    return tuple(sorted(n for (o, n) in _REGISTRY if o == op))


def registered_ops() -> tuple[str, ...]:
    """Sorted names of every op with at least one registered backend."""
    return tuple(sorted({o for (o, _n) in _REGISTRY}))


# Per-(op, backend) invocation counters, bumped by the engine on every
# dispatch. Best-effort observability (GIL-atomic enough for tests and
# metrics, not a synchronised billing counter): the service layer uses them
# to prove that cache hits never reach a backend.
_CALL_COUNTS: "collections.Counter[tuple[str, str]]" = collections.Counter()


def note_call(name: str, op: str = "ychg") -> None:
    """Record one dispatch to backend ``name`` (called by the engine)."""
    _CALL_COUNTS[(op, name)] += 1


def call_count(name: Optional[str] = None, op: Optional[str] = None) -> int:
    """Dispatches so far: to backend ``name`` (summed over ops unless
    ``op`` narrows it), or to every backend when both are None."""
    return sum(
        c for (o, n), c in _CALL_COUNTS.items()
        if (name is None or n == name) and (op is None or o == op)
    )


def reset_call_counts() -> None:
    _CALL_COUNTS.clear()
    _DISPATCH_SECONDS.clear()


# Per-(op, backend) dispatch-cost histograms: how long the engine's
# synchronous dispatch call (issue, not device completion — CUDA launches
# are async) took. Same best-effort discipline as _CALL_COUNTS.
_DISPATCH_SECONDS: "dict[tuple[str, str], Histogram]" = {}


def note_dispatch(name: str, seconds: float, op: str = "ychg") -> None:
    """Record the synchronous dispatch cost of one engine call (called by
    the engine next to :func:`note_call`)."""
    key = (op, name)
    hist = _DISPATCH_SECONDS.get(key)
    if hist is None:
        hist = _DISPATCH_SECONDS.setdefault(key, Histogram(DISPATCH_BOUNDS))
    hist.observe(max(0.0, seconds))


def dispatch_seconds() -> "dict[tuple[str, str], HistogramSnapshot]":
    """Frozen dispatch-cost histogram snapshots, keyed (op, backend)."""
    return {key: h.snapshot() for key, h in _DISPATCH_SECONDS.items()}


def get_backend(name: str, op: str = "ychg") -> BackendSpec:
    try:
        return _REGISTRY[(op, name)]
    except KeyError:
        if op not in registered_ops():
            raise UnknownOpError(
                f"unknown op {op!r}; registered ops: {registered_ops()}"
            ) from None
        raise ValueError(
            f"unknown backend {name!r} for op {op!r}; registered: "
            f"{backend_names(op)}"
        ) from None


@functools.lru_cache(maxsize=None)
def resolve(backend: str, *, platform: str, need_mesh: bool = False,
            op: str = "ychg") -> BackendSpec:
    """Resolve a backend name (or ``"auto"``) to a spec for this call.

    ``auto`` picks the highest-priority spec registered for ``op`` that can
    run on ``platform`` (and, when a mesh is attached, that is
    mesh-capable). Explicit names are honoured as-is except that
    ``need_mesh`` rejects backends that cannot be batch-split. An op that
    is registered but has no backend claiming the current platform falls
    back to its best batch-capable backend with a warning — never a bare
    KeyError; an op nobody registered raises :class:`UnknownOpError`.
    """
    if op not in registered_ops():
        raise UnknownOpError(
            f"unknown op {op!r}; registered ops: {registered_ops()}"
        )
    if backend != "auto":
        spec = get_backend(backend, op)
        if need_mesh and not spec.supports_mesh:
            raise ValueError(
                f"backend {backend!r} (op {op!r}) does not support mesh "
                f"execution; mesh-capable backends: "
                f"{tuple(n for (o, n), s in sorted(_REGISTRY.items()) if o == op and s.supports_mesh)}"
            )
        return spec
    pool = [
        s for s in _REGISTRY.values()
        if s.op == op
        and s.supports_batch
        and (s.supports_mesh or not need_mesh)
    ]
    candidates = [s for s in pool if platform in s.device_kinds]
    if not candidates:
        if pool:
            # registered op, no backend claims this platform: pick the best
            # batch-capable spec anyway (plain-version backends are exact
            # everywhere) and say so, rather than dying on a lookup error
            best = max(pool, key=lambda s: (max(s.priority.values(),
                                                default=0), s.name))
            warnings.warn(
                f"op {op!r} has no backend registered for platform "
                f"{platform!r}; falling back to backend {best.name!r} "
                f"(device_kinds={best.device_kinds})",
                RuntimeWarning,
                stacklevel=2,
            )
            return best
        raise ValueError(
            f"no registered backend for op {op!r} can run on platform "
            f"{platform!r} (need_mesh={need_mesh}); registered: "
            f"{backend_names(op)}"
        )
    return max(candidates, key=lambda s: (s.priority_on(platform), s.name))
