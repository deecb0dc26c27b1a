"""The reader of a count that spans carry as meta, on synthetic spans."""

import pytest

pytest.importorskip("torch")

from bench import harness  # noqa: E402
from bench.sources import span_meta  # noqa: E402

SPEC = {"spans": ["scheduler.pad_stack"], "meta": "minflt",
        "per": "scheduler.pad_stack"}


def _obs(spans):
    w = harness.Window(t0=1.0, t1=3.0, pixels=1, attempted=1, failed=0)
    return harness.Observations(window=w, spans=spans)


def test_span_meta_sums_a_count_over_per_spans():
    obs = _obs([("scheduler.pad_stack", 1.5, 1.6, {"minflt": 30}),
                ("scheduler.pad_stack", 2.0, 2.1, {"minflt": 0}),
                ("scheduler.pad_stack", 0.5, 1.2, {"minflt": 999}),  # before
                ("scheduler.h2d", 1.6, 1.7, {"minflt": 5})])
    assert span_meta.read(SPEC, obs) == 15.0
    assert span_meta.read(dict(SPEC, scale=2.0), obs) == 30.0


def test_span_meta_reads_a_count_of_zero_as_a_value():
    obs = _obs([("scheduler.pad_stack", 1.5, 1.6, {"minflt": 0})])
    assert span_meta.read(SPEC, obs) == 0.0


def test_span_meta_counts_over_one_span_and_reads_per_another():
    obs = _obs([("cache.key_copy", 1.1, 1.2, {"minflt": 8}),
                ("cache.probe", 1.1, 1.3, {}), ("cache.probe", 2, 2.1, {})])
    assert span_meta.read({"spans": ["cache.key_copy"], "meta": "minflt",
                           "per": "cache.probe"}, obs) == 4.0


@pytest.mark.parametrize("spans", [
    # no per span in the window
    [("scheduler.pad_stack", 0.2, 0.3, {"minflt": 7}),
     ("scheduler.h2d", 1.5, 1.6, {"minflt": 7})],
    # spans that carry no count (a program that keeps none)
    [("scheduler.pad_stack", 1.5, 1.6, {})],
    [],
], ids=["no_per_span", "no_count", "no_spans"])
def test_span_meta_reads_none_where_nothing_is_there(spans):
    assert span_meta.read(SPEC, _obs(spans)) is None
