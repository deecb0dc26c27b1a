"""repro_torch.obs — tracing, fixed-boundary histograms, Prometheus text tools.

The observability layer the service/fleet/scene tiers share. Import-light
on purpose (stdlib only): ``repro_torch.engine`` and ``repro_torch.service``
both use it, so it must sit below every other package of the port in the
import graph. A copy of ``repro.obs``: the port imports nothing of the JAX
package.
"""

from repro_torch.obs.histogram import (
    DEFAULT_LATENCY_BOUNDS,
    DISPATCH_BOUNDS,
    Histogram,
    HistogramSnapshot,
    empty_snapshot,
)
from repro_torch.obs.promtext import (
    PromBuilder,
    PromPage,
    PromSample,
    base_family,
    escape_label_value,
    format_le,
    format_value,
    parse_prom_text,
    unescape_label_value,
)
from repro_torch.obs.trace import (
    NULL_TRACE,
    FlightRecorder,
    Span,
    Trace,
    auto_dump,
    configure,
    maybe_trace,
    minor_faults,
    mono_to_wall_us,
    new_trace_id,
    recorder,
    tracing_enabled,
)

__all__ = [
    "DEFAULT_LATENCY_BOUNDS",
    "DISPATCH_BOUNDS",
    "Histogram",
    "HistogramSnapshot",
    "empty_snapshot",
    "PromBuilder",
    "PromPage",
    "PromSample",
    "base_family",
    "escape_label_value",
    "format_le",
    "format_value",
    "parse_prom_text",
    "unescape_label_value",
    "NULL_TRACE",
    "FlightRecorder",
    "Span",
    "Trace",
    "auto_dump",
    "configure",
    "maybe_trace",
    "minor_faults",
    "mono_to_wall_us",
    "new_trace_id",
    "recorder",
    "tracing_enabled",
]
