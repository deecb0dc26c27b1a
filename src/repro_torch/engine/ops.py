"""Operator registry: what the engine can compute, beyond which backend.

The port's counterpart of ``repro.engine.ops``. The backend registry
(``repro_torch.engine.registry``) answers "which implementation of op X runs
here"; this module answers "what IS op X", and how ops chain into
device-resident pipelines:

  * ``fields``      — the result's tensor fields, all leading with the batch
                      dim;
  * ``result_type`` / ``from_summary`` — the frozen result wrapper;
  * ``reference``   — plain torch reference over a (B, H, W) stack; backends
                      must be bit-identical to it (tests enforce this);
  * ``chain_field`` — the result field fed to the next stage of a pipeline
                      (None = terminal op: it cannot appear mid-chain).

Registered: ``ychg``, ``ccl`` and ``denoise``, the JAX package's three ops.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import ychg as _ychg
from repro_torch.engine.registry import UnknownOpError
from repro_torch.kernels import ccl as _ccl
from repro_torch.kernels import denoise as _denoise

Tensor = torch.Tensor

__all__ = [
    "CCLResult",
    "DenoiseResult",
    "OpSpec",
    "PIPELINE_SEP",
    "get_op",
    "op_names",
    "pipeline_op_key",
    "register_op",
    "split_pipeline_key",
    "validate_pipeline",
]

# Separator of pipeline keys ("denoise+ychg"); op names must never contain it.
PIPELINE_SEP = "+"


@dataclasses.dataclass(frozen=True)
class CCLResult:
    """Device-resident batched connected-components labelling output.

    ``event`` is a CUDA event recorded after the work that produced the
    tensors (None on the CPU), which ``block_until_ready`` waits on.
    """

    labels: Tensor        # (B, H, W) int32 canonical labels, 0 = background
    n_components: Tensor  # (B,) int32
    batched: bool = True
    event: Optional[Any] = dataclasses.field(default=None, compare=False,
                                             repr=False)

    @property
    def batch_size(self) -> int:
        return self.labels.shape[0]

    def block_until_ready(self) -> "CCLResult":
        if self.event is not None:
            self.event.synchronize()
        return self

    def to_summary(self) -> _ccl.CCLSummary:
        if self.batched:
            return _ccl.CCLSummary(self.labels, self.n_components)
        return _ccl.CCLSummary(self.labels[0], self.n_components[0])

    def to_host(self) -> Dict[str, np.ndarray]:
        s = self.to_summary()
        return {f: getattr(s, f).cpu().numpy() for f in _ccl.CCL_FIELDS}


@dataclasses.dataclass(frozen=True)
class DenoiseResult:
    """Device-resident batched P-HGRMS denoise output (``event`` as in
    :class:`CCLResult`)."""

    image: Tensor  # (B, H, W) float32
    batched: bool = True
    event: Optional[Any] = dataclasses.field(default=None, compare=False,
                                             repr=False)

    @property
    def batch_size(self) -> int:
        return self.image.shape[0]

    def block_until_ready(self) -> "DenoiseResult":
        if self.event is not None:
            self.event.synchronize()
        return self

    def to_summary(self) -> _denoise.DenoiseSummary:
        if self.batched:
            return _denoise.DenoiseSummary(self.image)
        return _denoise.DenoiseSummary(self.image[0])

    def to_host(self) -> Dict[str, np.ndarray]:
        s = self.to_summary()
        return {f: getattr(s, f).cpu().numpy()
                for f in _denoise.DENOISE_FIELDS}


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """One operator the engine can dispatch."""

    name: str
    fields: Tuple[str, ...]
    result_type: type
    summary_type: type            # field-ordered summary
    from_summary: Callable        # (summary, batched, event) -> result
    reference: Callable           # (B, H, W) stack -> summary (parity bar)
    chain_field: Optional[str] = None  # pipeline output field; None = terminal


_OPS: Dict[str, OpSpec] = {}


def register_op(spec: OpSpec) -> OpSpec:
    if PIPELINE_SEP in spec.name:
        raise ValueError(
            f"op name {spec.name!r} may not contain {PIPELINE_SEP!r} "
            "(reserved for pipeline keys)"
        )
    _OPS[spec.name] = spec
    return spec


def op_names() -> Tuple[str, ...]:
    return tuple(sorted(_OPS))


def get_op(name: str) -> OpSpec:
    try:
        return _OPS[name]
    except KeyError:
        raise UnknownOpError(
            f"unknown op {name!r}; registered ops: {op_names()}"
        ) from None


def pipeline_op_key(stages: Tuple[str, ...]) -> str:
    """Ordered stage names -> the op-qualified key used by cache/buckets."""
    return PIPELINE_SEP.join(stages)


def split_pipeline_key(op_key: str) -> Tuple[str, ...]:
    return tuple(op_key.split(PIPELINE_SEP))


def validate_pipeline(stages) -> Tuple[str, ...]:
    """Check an ordered pipeline spec: known ops, chainable interiors."""
    stages = tuple(stages)
    if not stages:
        raise ValueError("pipeline spec needs at least one op stage")
    for s in stages:
        get_op(s)  # raises UnknownOpError with the registered list
    for s in stages[:-1]:
        if get_op(s).chain_field is None:
            raise ValueError(
                f"op {s!r} is terminal (no chain_field) and cannot feed a "
                f"later pipeline stage"
            )
    return stages


def register_builtin_ops() -> None:
    """Register ``ychg``, ``ccl`` and ``denoise``; called by
    ``repro_torch.engine`` once the yCHG result type is importable
    (engine.engine imports this module)."""
    from repro_torch.engine.engine import YCHGResult, _from_summary

    register_op(OpSpec(
        name="ychg",
        fields=("runs", "cut_vertices", "transitions", "births", "deaths",
                "n_hyperedges", "n_transitions"),
        result_type=YCHGResult,
        summary_type=_ychg.YCHGSummary,
        from_summary=_from_summary,
        reference=_ychg.analyze,
        chain_field=None,   # (B, W) outputs: not an image, cannot feed a stage
    ))
    register_op(OpSpec(
        name="ccl",
        fields=_ccl.CCL_FIELDS,
        result_type=CCLResult,
        summary_type=_ccl.CCLSummary,
        from_summary=lambda s, batched, event=None: CCLResult(
            s.labels, s.n_components, batched=batched, event=event),
        reference=_ccl.labels,
        chain_field="labels",   # nonzero labels = foreground downstream
    ))
    register_op(OpSpec(
        name="denoise",
        fields=_denoise.DENOISE_FIELDS,
        result_type=DenoiseResult,
        summary_type=_denoise.DenoiseSummary,
        from_summary=lambda s, batched, event=None: DenoiseResult(
            s.image, batched=batched, event=event),
        reference=_denoise.denoise,
        chain_field="image",
    ))
