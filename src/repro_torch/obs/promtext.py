"""Prometheus text-exposition building, escaping, and parsing.

One escaping helper shared by the frontend's ``_render_metrics`` and the
fleet rollup (worker and bucket names were previously interpolated raw
into ``{worker="..."}``), one ``PromBuilder`` that emits ``# HELP``/``# TYPE``
exactly once per family, and one parser strict enough for tests and for
the router's rollup to consume worker pages without regex guesswork.

The exposition-format rules implemented here (escaping, le-ordering,
histogram series naming) follow the Prometheus text format v0.0.4.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.obs.histogram import HistogramSnapshot

LabelPairs = Tuple[Tuple[str, str], ...]


def escape_label_value(value: str) -> str:
    """Escape a label value per the exposition format: backslash first
    (so later escapes aren't double-escaped), then quote, then newline."""
    return (str(value)
            .replace("\\", "\\\\")
            .replace('"', '\\"')
            .replace("\n", "\\n"))


def unescape_label_value(value: str) -> str:
    out, i = [], 0
    while i < len(value):
        ch = value[i]
        if ch == "\\" and i + 1 < len(value):
            nxt = value[i + 1]
            out.append({"\\": "\\", '"': '"', "n": "\n"}.get(nxt, nxt))
            i += 2
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def format_labels(labels: Sequence[Tuple[str, str]]) -> str:
    """``{a="x",b="y"}`` with escaped values; empty string for no labels."""
    if not labels:
        return ""
    inner = ",".join(f'{k}="{escape_label_value(v)}"' for k, v in labels)
    return "{" + inner + "}"


def format_value(value) -> str:
    """Integral floats render as ints (``3`` not ``3.0``) so counter lines
    stay byte-compatible with the hand-built format the tests pin."""
    if isinstance(value, bool):
        return str(int(value))
    if isinstance(value, int):
        return str(value)
    f = float(value)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def format_le(bound: float) -> str:
    """Bucket thresholds rendered stably: 0.005 not 5e-03, ints bare."""
    if math.isinf(bound):
        return "+Inf"
    if bound == int(bound):
        return str(int(bound))
    return format(bound, ".12g")


class PromBuilder:
    """Accumulates families; ``render`` emits HELP/TYPE once per family."""

    def __init__(self):
        self._lines: List[str] = []

    def raw(self, line: str) -> None:
        self._lines.append(line)

    def header(self, name: str, kind: str, help_text: str = "") -> None:
        if help_text:
            self._lines.append(f"# HELP {name} {help_text}")
        self._lines.append(f"# TYPE {name} {kind}")

    def sample(self, name: str, labels: Sequence[Tuple[str, str]],
               value) -> None:
        self._lines.append(
            f"{name}{format_labels(labels)} {format_value(value)}")

    def counter(self, name: str, value, help_text: str = "",
                labels: Sequence[Tuple[str, str]] = ()) -> None:
        self.header(name, "counter", help_text)
        self.sample(name, labels, value)

    def gauge(self, name: str, value, help_text: str = "",
              labels: Sequence[Tuple[str, str]] = ()) -> None:
        self.header(name, "gauge", help_text)
        self.sample(name, labels, value)

    def histogram(self, name: str,
                  series: Sequence[Tuple[LabelPairs, HistogramSnapshot]],
                  help_text: str = "") -> None:
        """Emit one histogram family: per label set, cumulative ``_bucket``
        lines (le last, ``+Inf`` included), then ``_sum`` and ``_count``."""
        if not series:
            return
        self.header(name, "histogram", help_text)
        for labels, snap in series:
            cum = snap.cumulative()
            for i, c in enumerate(cum):
                le = (format_le(snap.bounds[i]) if i < len(snap.bounds)
                      else "+Inf")
                self.sample(f"{name}_bucket",
                            tuple(labels) + (("le", le),), c)
            self.sample(f"{name}_sum", labels, snap.sum)
            self.sample(f"{name}_count", labels, snap.count)

    def render(self) -> str:
        return "\n".join(self._lines) + "\n"


_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)\s*$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


class PromSample:
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: LabelPairs, value: float):
        self.name = name
        self.labels = labels
        self.value = value

    def __repr__(self):
        return f"PromSample({self.name!r}, {self.labels!r}, {self.value!r})"


class PromPage:
    """Parsed exposition page: samples in order + TYPE/HELP per family."""

    def __init__(self, samples: List[PromSample], types: Dict[str, str],
                 helps: Dict[str, str]):
        self.samples = samples
        self.types = types
        self.helps = helps

    def get(self, name: str,
            labels: Optional[LabelPairs] = None) -> Optional[float]:
        for s in self.samples:
            if s.name == name and (labels is None or s.labels == labels):
                return s.value
        return None

    def series(self, name: str) -> List[PromSample]:
        return [s for s in self.samples if s.name == name]


def _parse_labels(body: str) -> LabelPairs:
    pairs, pos = [], 0
    while pos < len(body):
        m = _LABEL_RE.match(body, pos)
        if not m:
            raise ValueError(f"malformed label body at {body[pos:]!r}")
        pairs.append((m.group(1), unescape_label_value(m.group(2))))
        pos = m.end()
        if pos < len(body):
            if body[pos] != ",":
                raise ValueError(f"expected ',' in label body {body!r}")
            pos += 1
    return tuple(pairs)


def _parse_value(text: str) -> float:
    if text == "+Inf":
        return math.inf
    if text == "-Inf":
        return -math.inf
    if text == "NaN":
        return math.nan
    return float(text)


def parse_prom_text(text: str) -> PromPage:
    """Parse an exposition page; raises ValueError on any malformed line
    (the test suite uses this as the 'every series parses' assertion)."""
    samples: List[PromSample] = []
    types: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) < 4:
                raise ValueError(f"line {lineno}: malformed TYPE: {line!r}")
            types[parts[2]] = parts[3]
            continue
        if line.startswith("# HELP "):
            parts = line.split(None, 3)
            if len(parts) < 3:
                raise ValueError(f"line {lineno}: malformed HELP: {line!r}")
            helps[parts[2]] = parts[3] if len(parts) > 3 else ""
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {lineno}: malformed sample: {line!r}")
        name, label_body, value_text = m.groups()
        labels = _parse_labels(label_body) if label_body else ()
        try:
            value = _parse_value(value_text)
        except ValueError:
            raise ValueError(
                f"line {lineno}: malformed value {value_text!r}") from None
        samples.append(PromSample(name, labels, value))
    return PromPage(samples, types, helps)


def base_family(name: str) -> str:
    """Histogram series name -> family name (strip _bucket/_sum/_count)."""
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix):
            return name[: -len(suffix)]
    return name
