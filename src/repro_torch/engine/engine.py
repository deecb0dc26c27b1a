"""`EngineConfig` / `YCHGResult` / `Engine` — the port's entry point.

The counterpart of ``repro.engine.engine``. One engine owns one dispatch
policy (backend selection, kernel knobs) and one torch device over every
registered op (``ychg``, ``ccl``, ``denoise``), and exposes three verbs,
each taking ``op=`` to override the engine's default op:

  * ``analyze(img)``         — one (H, W) mask, as a B=1 view of the batched
                               path;
  * ``analyze_batch(stack)`` — a (B, H, W) stack in one device computation;
  * ``analyze_stream(it)``   — an iterable of masks or stacks, one result
                               yielded per item;

plus ``run_pipeline(stack, stages)``: an ordered op chain run on the
device end to end, each stage's output feeding the next with no host round
trip, bit-identical to issuing the stages as separate calls.

The engine runs on the card unless the caller asks for the CPU:
``Engine()`` means ``device="cuda"`` and raises when there is no CUDA
device; ``Engine(device="cpu")`` is the only way onto the CPU. The backend
registry is asked for the engine's own device type (``"cpu"`` or
``"cuda"``). Results stay on the device; ``.to_host()`` copies them out.

``Engine(cfg, mesh=make_batch_mesh())`` splits every stack over the
devices of a :class:`repro_torch.sharding.BatchMesh`, the counterpart of
the JAX engine's ``shard_map`` path (``_run_meshed``). ``YCHGEngine``
remains as a deprecation shim over ``Engine`` (op pinned to ``"ychg"``).

``lower(stack_shape)`` is the counterpart of ``jax.jit(run).lower``: it
reckons a cell's output types, bytes and launches from the shape alone
and, compiled, builds the route's CUDA kernels, allocating nothing on the
device (``engine.lowering``).
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.ychg import YCHGSummary, narrow_wide_ints
from repro_torch.engine import ops as engine_ops
from repro_torch.engine import registry
from repro_torch.engine.lowering import Lowered, ShapeDtype
from repro_torch.sharding.ychg import BatchMesh, pad_batch

Tensor = torch.Tensor

_FIELDS = ("runs", "cut_vertices", "transitions", "births", "deaths",
           "n_hyperedges", "n_transitions")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Frozen, hashable engine construction knobs.

    The field names are those of the JAX ``YCHGConfig`` less ``interpret``,
    which has no meaning on Hopper (``configs.ychg_modis.engine_config_from_jax``
    maps one onto the other). The class name differs from the JAX one on
    purpose: it is part of every service cache key, so the two packages'
    workers never share cache entries.

    backend            "auto" resolves per (op, device type) from the
                       registry; or a registered name ("torch", "fused").
    block_w            enters only the split-H routing rule (``kernels.ops``).
    block_h            row segment of the split-H kernel.
    dtype              optional dtype name masks are cast to on ingest
                       (None = accept as-is; nonzero = foreground either way).
    mesh_axis          batch axis name used when a mesh is attached.
    stream_vmem_budget the reference's switch to its H-streamed kernel, kept
                       so the port routes as the reference does.
    """

    backend: str = "auto"
    block_w: int = 128
    block_h: int = 2048
    dtype: Optional[str] = None
    mesh_axis: str = "data"
    stream_vmem_budget: int = 4 * 1024 * 1024


# the JAX package's historical spelling of the same knobs
YCHGConfig = EngineConfig


@dataclasses.dataclass(frozen=True)
class YCHGResult:
    """Device-resident batched output of the two-step algorithm.

    Tensors always carry the leading batch dim; a single image is a B=1
    view. ``event`` is a CUDA event recorded after the work that produced
    the tensors (None on the CPU), which ``block_until_ready`` waits on.
    """

    runs: Tensor           # (B, W) int32  step-1 per-column run counts
    cut_vertices: Tensor   # (B, W) int32  2*runs
    transitions: Tensor    # (B, W) bool   step-2 change signal
    births: Tensor         # (B, W) int32
    deaths: Tensor         # (B, W) int32
    n_hyperedges: Tensor   # (B,)   int32  total births
    n_transitions: Tensor  # (B,)   int32  number of transition columns
    batched: bool = True
    event: Optional[Any] = dataclasses.field(default=None, compare=False,
                                             repr=False)

    @property
    def batch_size(self) -> int:
        return self.runs.shape[0]

    def block_until_ready(self) -> "YCHGResult":
        if self.event is not None:
            self.event.synchronize()
        return self

    def to_summary(self) -> YCHGSummary:
        """``core.ychg.YCHGSummary`` view (squeezed to (W,)/() for B=1 input)."""
        if self.batched:
            return YCHGSummary(*(getattr(self, f) for f in _FIELDS))
        return YCHGSummary(*(getattr(self, f)[0] for f in _FIELDS))

    def to_host(self) -> Dict[str, np.ndarray]:
        """Host NumPy values of every field, as the JAX package's ``to_host``."""
        s = self.to_summary()
        return {f: getattr(s, f).cpu().numpy() for f in _FIELDS}


def record_event(device: torch.device) -> Optional[Any]:
    """A CUDA event recorded now on ``device``'s current stream (None on the
    CPU, where every op has finished when it returns)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def _from_summary(s: YCHGSummary, batched: bool,
                  event: Optional[Any] = None) -> YCHGResult:
    return YCHGResult(s.runs, s.cut_vertices, s.transitions, s.births,
                      s.deaths, s.n_hyperedges, s.n_transitions,
                      batched=batched, event=event)


def _zero_pad_region(x: Tensor, valid_hw: Tensor) -> Tensor:
    """Zero rows >= h and cols >= w per image (valid_hw: (B, 2) int32).

    Between pipeline stages this restores the exact canvas a single-op
    submit would see: a stage may write nonzero values into the pad
    region (denoise's RMS does, next to native pixels), and the next stage
    must not observe them.
    """
    _, h, w = x.shape
    rows = torch.arange(h, device=x.device)[None, :, None]
    cols = torch.arange(w, device=x.device)[None, None, :]
    keep = (rows < valid_hw[:, 0, None, None]) & (
        cols < valid_hw[:, 1, None, None])
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def _numpy_dtype_to_torch(name: str) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np.dtype(name))).dtype


def _default_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "Engine runs on the card by default and this process sees no "
            "CUDA device; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


class Engine:
    """The sole dispatch point for image-operator computations.

    ``Engine()`` serves the ``ychg`` op on the card, resolving the best
    backend per call; ``Engine(op="ccl")`` pins another default op, and
    every verb accepts ``op=`` for a per-call override. Attach a batch mesh
    with ``mesh=`` or ``with_mesh`` to split every stack over its devices
    with a mesh-capable backend (padding to the mesh size and stripping the
    pad internally, so callers never see padded-length results). Every
    mesh device must have the engine's device type.
    """

    def __init__(self, config: EngineConfig = EngineConfig(), *,
                 op: str = "ychg", mesh: Optional[BatchMesh] = None,
                 device: Any = None):
        if mesh is not None and config.mesh_axis not in mesh.axis_names:
            raise ValueError(
                f"mesh has axes {mesh.axis_names}, config.mesh_axis="
                f"{config.mesh_axis!r}"
            )
        self.config = config
        self.op = op
        self.device = (_default_device() if device is None
                       else torch.device(device))
        if mesh is not None and any(d.type != self.device.type
                                    for d in mesh.devices):
            raise ValueError(
                f"every mesh device must have the engine's device type "
                f"{self.device.type!r}; mesh has {mesh!r}")
        self.mesh = mesh
        self.platform = self.device.type
        self._cast_dtype = (None if config.dtype is None
                            else _numpy_dtype_to_torch(config.dtype))
        # op -> (registry generation, resolved spec) — revalidated against
        # registry.generation() so late register_backend() calls still apply
        self._spec_cache: Dict[str, tuple[int, registry.BackendSpec]] = {}

    # ------------------------------------------------------------- plumbing

    def with_mesh(self, mesh: Optional[BatchMesh]) -> "Engine":
        """Same policy and device, batch-split over ``mesh`` (None
        detaches)."""
        return Engine(self.config, op=self.op, mesh=mesh, device=self.device)

    def with_config(self, **overrides: Any) -> "Engine":
        """New engine with ``dataclasses.replace``d config, same op, mesh
        and device."""
        return Engine(dataclasses.replace(self.config, **overrides),
                      op=self.op, mesh=self.mesh, device=self.device)

    def resolve_backend(self, op: Optional[str] = None) -> str:
        """Name of the backend this engine dispatches ``op`` to right now."""
        return self._resolve(op or self.op).name

    def _resolve(self, op: str) -> registry.BackendSpec:
        gen = registry.generation()
        cached = self._spec_cache.get(op)
        if cached is not None and cached[0] == gen:
            return cached[1]
        spec = registry.resolve(self.config.backend, platform=self.platform,
                                need_mesh=self.mesh is not None, op=op)
        self._spec_cache[op] = (gen, spec)
        return spec

    def _ingest(self, imgs: Any) -> Tensor:
        # a tensor on the engine's device passes through untouched; a tensor
        # elsewhere, and host data, are copied onto it (never run in place).
        # 64-bit integers keep their low 32 bits, as jnp.asarray does with
        # x64 off: host data before the copy, tensors on the device
        if isinstance(imgs, torch.Tensor):
            return self._conform(imgs.to(self.device))
        a = np.ascontiguousarray(imgs)
        if not a.flags.writeable:
            a = a.copy()
        return self._conform(narrow_wide_ints(torch.from_numpy(a)).to(
            self.device))

    def _conform(self, x: Tensor) -> Tensor:
        """``x`` with 64-bit integers narrowed and the config's cast
        applied: the dtype every backend sees."""
        x = narrow_wide_ints(x)
        if self._cast_dtype is not None and x.dtype != self._cast_dtype:
            x = narrow_wide_ints(x.to(self._cast_dtype))
        return x

    # ------------------------------------------------------------- dispatch

    def analyze(self, img: Any, *, op: Optional[str] = None):
        """One (H, W) mask -> B=1 result (never copies device->host)."""
        x = self._ingest(img)
        if x.ndim != 2:
            raise ValueError(f"analyze expects an (H, W) mask, got "
                             f"{tuple(x.shape)}; use analyze_batch for stacks")
        return self._run(x[None], batched=False, op=op or self.op)

    def analyze_batch(self, stack: Any, *, op: Optional[str] = None):
        """A (B, H, W) stack in one device computation."""
        x = self._ingest(stack)
        if x.ndim != 3:
            raise ValueError(f"analyze_batch expects a (B, H, W) stack, "
                             f"got {tuple(x.shape)}")
        return self._run(x, batched=True, op=op or self.op)

    def analyze_stream(self, items: Iterable[Any], *,
                       op: Optional[str] = None) -> Iterator[Any]:
        """Lazily map ``analyze``/``analyze_batch`` over an iterable.

        Each item may be an (H, W) mask or a (B, H, W) stack; one result is
        yielded per item, strictly in order. The stream runs one item ahead
        of the yield point: item n+1 is pulled and ingested before result n
        is yielded. Ingest is a synchronous host-to-device copy for now
        (pinned memory on a copy stream is a later change).
        """
        run_op = op or self.op
        it = iter(items)
        pending = None
        while True:
            # pull and ingest item n+1 first ...
            try:
                item = next(it)
                x = self._ingest(item)
                if x.ndim == 2:
                    x, batched = x[None], False
                elif x.ndim == 3:
                    batched = True
                else:
                    raise ValueError(
                        f"stream items must be (H, W) or (B, H, W), "
                        f"got {tuple(x.shape)}"
                    )
            except StopIteration:
                break
            except Exception:
                # a bad item — or a source iterator that raises — must not
                # swallow the previous item's computed result: deliver it,
                # then raise on the consumer's next pull
                if pending is not None:
                    yield pending
                    pending = None
                raise
            # ... only then hand result n to the consumer
            if pending is not None:
                yield pending
            pending = self._run(x, batched=batched, op=run_op)
        if pending is not None:
            yield pending

    def run_pipeline(self, stack: Any, stages: Sequence[str], *,
                     valid_hw: Optional[Any] = None, batched: bool = True,
                     on_stage: Optional[Callable[[str, float, float],
                                                 None]] = None):
        """Run an ordered op chain on the device, no host round trips.

        Each stage's ``chain_field`` output becomes the next stage's input
        stack. ``valid_hw`` ((B, 2) int32 of per-image (h, w)) re-zeroes the
        pad region between stages, so a bucket-padded batch stays
        bit-identical to issuing the stages as separate (cropped) submits;
        see :func:`_zero_pad_region`. ``on_stage(name, t0, t1)`` fires
        after each stage's dispatch (launches are asynchronous, so the span
        is the host's time to enqueue them); the service uses it for its
        per-stage ``pipeline.<op>`` spans and stage histograms. Returns the
        LAST stage's result.
        """
        stages = engine_ops.validate_pipeline(stages)
        x = self._ingest(stack)
        if x.ndim != 3:
            raise ValueError(f"run_pipeline expects a (B, H, W) stack, got "
                             f"{tuple(x.shape)}")
        hw = (None if valid_hw is None else torch.as_tensor(
            valid_hw, dtype=torch.int32, device=x.device))
        result = None
        for i, name in enumerate(stages):
            t0 = time.monotonic()
            result = self._run(x, batched=batched, op=name)
            if i + 1 < len(stages):
                x = getattr(result, engine_ops.get_op(name).chain_field)
                if hw is not None:
                    x = _zero_pad_region(x, hw)
            if on_stage is not None:
                on_stage(name, t0, time.monotonic())
        return result

    def _run(self, imgs: Tensor, *, batched: bool, op: str):
        opspec = engine_ops.get_op(op)
        spec = self._resolve(op)
        # counted BEFORE the run so a raising backend still shows up in
        # call_count; the dispatch-cost histogram only sees successes
        registry.note_call(spec.name, op)
        t0 = time.monotonic()
        if self.mesh is not None:
            summary = self._run_meshed(spec, opspec, imgs)
        else:
            summary = spec.run(imgs, self.config)
        out = opspec.from_summary(summary, batched, record_event(imgs.device))
        registry.note_dispatch(spec.name, time.monotonic() - t0, op)
        return out

    def _run_meshed(self, spec: registry.BackendSpec, opspec, imgs: Tensor):
        """Run ``spec`` on one chunk of the stack a mesh device, the
        counterpart of ``shard_map`` over the 1-D batch mesh.

        The stack is padded with blank images (inert end to end for every
        op: zero pixels form no runs, no components, and denoise to zero)
        to a multiple of the mesh size, cut into one chunk a mesh entry,
        each chunk copied to its device and run there (a kernel launches on
        its tensor's device), and the fields gathered back onto the
        engine's device without the pad. A chunk that ran on another CUDA
        device is waited for on the engine's stream before the gather.
        """
        x, b = pad_batch(imgs, self.mesh.shape[self.config.mesh_axis])
        parts = []
        for chunk, device in zip(x.chunk(self.mesh.size), self.mesh.devices):
            s = spec.run(chunk.to(device, non_blocking=True), self.config)
            if device.type == "cuda" and device != imgs.device:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(device))
                torch.cuda.current_stream(imgs.device).wait_event(done)
            parts.append(s)
        return opspec.summary_type(*(
            torch.cat([getattr(s, f).to(imgs.device, non_blocking=True)
                       for s in parts])[:b]
            for f in opspec.fields))

    # ------------------------------------------------------------ tooling

    def lower(self, stack_shape: tuple[int, int, int],
              dtype: Any = torch.uint8, op: Optional[str] = None) -> Lowered:
        """Lower this engine's batched path for an abstract (B, H, W) stack.

        The counterpart of the JAX engine's ``jax.jit(run).lower``: the op
        and backend resolve as ``analyze_batch`` resolves them (the mesh
        aside, as there), the stack's dtype is the one ingest would give
        (64-bit integers narrowed, then the config's cast; float64 stays
        float64, where the JAX package's argument is float32), and the
        result's types, bytes and launches come from the shape alone. No
        tensor of the stack's shape is made. Raises ``ValueError`` for an
        op the backend does not serve, for the host backends ``serial``
        and ``scalar``, for a shape that is not (B, H, W), and wherever
        the route's kernels would refuse the shape.
        """
        run_op = op or self.op
        opspec = engine_ops.get_op(run_op)
        spec = self._resolve(run_op)
        if spec.plan is None or opspec.layout is None:
            raise ValueError(
                f"backend {spec.name!r} (op {run_op!r}) runs on the host and "
                f"cannot be lowered")
        shape = tuple(int(d) for d in stack_shape)
        if len(shape) != 3 or min(shape) < 0:
            raise ValueError(f"lower expects a (B, H, W) stack shape, got "
                             f"{tuple(stack_shape)}")
        dtype = self._conform(torch.empty(0, dtype=_as_torch_dtype(dtype))
                              ).dtype
        out = {f: ShapeDtype(s, d)
               for f, (s, d) in opspec.layout(*shape).items()}
        return Lowered(op=run_op, backend=spec.name,
                       in_info=ShapeDtype(shape, dtype),
                       out_info=opspec.result_type(**out, batched=True),
                       plan=spec.plan(shape, dtype, self.config),
                       device=self.device)


def _as_torch_dtype(dtype: Any) -> torch.dtype:
    """A torch dtype, or a NumPy dtype (or its name) as torch names it."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _numpy_dtype_to_torch(np.dtype(dtype).name)


class YCHGEngine(Engine):
    """Deprecated alias for :class:`Engine` pinned to ``op="ychg"``, as in
    the JAX package; emits a ``DeprecationWarning``."""

    def __init__(self, config: EngineConfig = EngineConfig(), *,
                 mesh: Optional[BatchMesh] = None, device: Any = None):
        warnings.warn(
            "YCHGEngine is deprecated; use repro_torch.engine.Engine "
            "(op defaults to 'ychg')",
            DeprecationWarning,
            stacklevel=2,
        )
        super().__init__(config, op="ychg", mesh=mesh, device=device)
