"""The port's deprecated ``analyze_image`` shim against the JAX package's.

Both shims are held to ``tests/test_engine.py::_legacy_analyze_image``,
the pre-engine implementation, on the same seeded mask: keys, dtypes,
shapes and values, exactly. The port's backend names are the JAX
package's under ``configs.ychg_modis.engine_config_from_jax``'s pairing:
``torch``/``jax``, ``fused``/``fused``, ``cuda``/``pallas``,
``serial``/``serial``, ``scalar``/``scalar``. The port's engines run on
``device="cpu"`` here.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import api as japi  # noqa: E402
from repro_torch.core import api  # noqa: E402
from test_engine import _legacy_analyze_image  # noqa: E402

PAIRS = {"torch": "jax", "fused": "fused", "cuda": "pallas",
         "serial": "serial", "scalar": "scalar"}


def _same(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("backend", sorted(PAIRS))
def test_shim_equals_the_legacy_implementation(backend):
    rng = np.random.default_rng(9)
    img = (rng.random((23, 37)) < 0.5).astype(np.uint8)
    with pytest.warns(DeprecationWarning, match="repro_torch.engine.Engine"):
        got = api.analyze_image(img, backend=backend, device="cpu")
    want = _legacy_analyze_image(img, PAIRS[backend])
    _same(got, want)
    with pytest.warns(DeprecationWarning):
        _same(japi.analyze_image(img, backend=PAIRS[backend]), want)


@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_a_stack_goes_to_analyze_batch(backend):
    rng = np.random.default_rng(10)
    imgs = (rng.random((3, 12, 19)) < 0.5).astype(np.uint8)
    with pytest.warns(DeprecationWarning):
        got = api.analyze_image(imgs, backend=backend, device="cpu")
    with pytest.warns(DeprecationWarning):
        want = japi.analyze_image(imgs, backend=PAIRS[backend])
    assert got["runs"].shape == (3, 19) and got["n_hyperedges"].shape == (3,)
    _same(got, want)


def test_unknown_backend_message():
    assert api.BACKENDS == tuple(PAIRS)
    for name in ("jax", "pallas", "nope"):
        with pytest.warns(DeprecationWarning):
            with pytest.raises(ValueError, match="unknown backend") as exc:
                api.analyze_image(np.zeros((2, 2), np.uint8), backend=name,
                                  device="cpu")
        with pytest.warns(DeprecationWarning):
            with pytest.raises(ValueError) as jexc:
                japi.analyze_image(np.zeros((2, 2), np.uint8),
                                   backend="cuda")
        assert str(exc.value).split(";")[0] == (
            f"unknown backend {name!r}")
        assert str(jexc.value).startswith("unknown backend 'cuda'; "
                                          "expected one of")
        assert str(exc.value).endswith(f"expected one of {api.BACKENDS}")


def test_engines_are_cached_per_backend_and_device():
    with pytest.warns(DeprecationWarning):
        api.analyze_image(np.ones((3, 3), np.uint8), "torch", device="cpu")
    first = api._ENGINES["torch", "cpu"]
    with pytest.warns(DeprecationWarning):
        api.analyze_image(np.ones((3, 3), np.uint8), "torch", device="cpu")
    assert api._ENGINES["torch", "cpu"] is first
    assert first.device.type == "cpu"
