"""Readers of per-layer metrics, one module a kind of source.

Each module has ``read(spec, obs)``: ``spec`` is the metric's file under
``bench/layer_metrics``, ``obs`` the run's ``harness.Observations``. A
reader that finds nothing to read returns None, and the metric is left
out of the run's line.
"""
