"""Operator registry: what the engine can compute, beyond which backend.

The port's counterpart of ``repro.engine.ops``. The backend registry
(``repro_torch.engine.registry``) answers "which implementation of op X runs
here"; this module answers "what IS op X":

  * ``fields``      — the result's tensor fields, all leading with the batch
                      dim;
  * ``result_type`` / ``from_summary`` — the frozen result wrapper;
  * ``reference``   — plain torch reference over a (B, H, W) stack; backends
                      must be bit-identical to it (tests enforce this);
  * ``chain_field`` — the result field fed to the next stage of a pipeline
                      (None = terminal op).

Only ``ychg`` is registered so far. ``ccl`` and ``denoise`` come with their
kernels; until then naming them raises :class:`UnknownOpError`, as any
unregistered op does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core import ychg as _ychg
from repro_torch.engine.registry import UnknownOpError

__all__ = ["OpSpec", "get_op", "op_names", "register_op", "PIPELINE_SEP"]

# Separator of pipeline keys ("denoise+ychg"); op names must never contain it.
PIPELINE_SEP = "+"


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


def register_builtin_ops() -> None:
    """Register ``ychg``; called by ``repro_torch.engine`` once the result
    type is importable (engine.engine imports this module)."""
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
