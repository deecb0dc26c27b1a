"""What a kernel wrapper does for a stack of a given shape, reckoned from
the shape and dtype alone: nothing is allocated, built or launched.

A :class:`Plan` lists the CUDA sources a route builds, the launches its
wrappers count (the ``LAUNCHES`` keys), the bytes and operations of those
launches (each kernel's work in ``launch.roofline``: the bytes the function
it computes must move, each input read once and each output written once),
the bytes the PyTorch ops around the kernels read and write, and every
tensor the wrappers and those ops allocate, outputs marked. Each kernel
module plans its own wrapper beside it (``ychg_fused.plan_full`` and so
on), and ``kernels.ops`` composes them per route, so the routing rule and
the reckoning come from the same functions as the run. ``Engine.lower``
turns a plan into the cost and memory analyses of a lowered cell.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Alloc:
    """One tensor a route allocates: what it is, its bytes, and whether it
    is (part of) the result."""

    what: str
    nbytes: int
    output: bool = False


@dataclasses.dataclass(frozen=True)
class Plan:
    """A route's work for one stack, from shapes alone.

    ``operation`` is the type the route's operations run at (``int32`` or
    ``float32``, a key of ``launch.roofline.PEAK_OPS_PER_S``); the ops
    around the kernels (compares, casts, copies) are counted at it too, one
    a written element. ``allocations`` is None where the route's tensors
    are not reckoned (the plain ``torch`` backends).
    """

    route: Optional[str] = None
    sources: Tuple[str, ...] = ()
    launches: Mapping[str, int] = dataclasses.field(default_factory=dict)
    kernel_bytes: int = 0
    kernel_ops: int = 0
    op_bytes: int = 0
    op_ops: int = 0
    allocations: Optional[Tuple[Alloc, ...]] = ()
    operation: str = "int32"

    def __add__(self, other: "Plan") -> "Plan":
        launches: Dict[str, int] = dict(self.launches)
        for k, n in other.launches.items():
            launches[k] = launches.get(k, 0) + n
        allocs = (None if self.allocations is None or other.allocations is None
                  else self.allocations + other.allocations)
        return Plan(
            route=self.route or other.route,
            sources=self.sources + tuple(s for s in other.sources
                                         if s not in self.sources),
            launches=launches,
            kernel_bytes=self.kernel_bytes + other.kernel_bytes,
            kernel_ops=self.kernel_ops + other.kernel_ops,
            op_bytes=self.op_bytes + other.op_bytes,
            op_ops=self.op_ops + other.op_ops,
            allocations=allocs,
            operation=self.operation,
        )

    def output_bytes(self) -> int:
        return sum(a.nbytes for a in self.allocations or () if a.output)

    def temp_bytes(self) -> Optional[int]:
        if self.allocations is None:
            return None
        return sum(a.nbytes for a in self.allocations if not a.output)


def launch(kernel: str, count: int, work: Tuple[int, int],
           operation: str = "int32") -> Plan:
    """``count`` launches of ``kernel``, each doing ``work`` (bytes,
    operations); none when ``count`` is 0."""
    if count == 0:
        return Plan(operation=operation)
    nbytes, ops = work
    return Plan(launches={kernel: count}, kernel_bytes=count * nbytes,
                kernel_ops=count * ops, operation=operation)


def passes(numel: int, steps: Sequence[Tuple[str, int, int]], *,
           output: bool = False, operation: str = "int32") -> Plan:
    """Elementwise PyTorch ops over ``numel`` elements, each step (what,
    bytes read an element, bytes written an element) writing a new tensor
    (the last one the result when ``output``)."""
    allocs = tuple(Alloc(what, numel * wrote,
                         output and i == len(steps) - 1)
                   for i, (what, _read, wrote) in enumerate(steps))
    return Plan(op_bytes=numel * sum(r + w for _, r, w in steps),
                op_ops=numel * len(steps), allocations=allocs,
                operation=operation)


def alloc(what: str, nbytes: int, *, output: bool = False,
          operation: str = "int32") -> Plan:
    """One tensor allocated and written by a kernel (no op traffic)."""
    return Plan(allocations=(Alloc(what, nbytes, output),),
                operation=operation)
