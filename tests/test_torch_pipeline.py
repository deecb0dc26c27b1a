"""The port's ``data.pipeline`` against the JAX package's.

``ychg_stats`` (every legacy backend name and an explicit engine),
``filter_empty_tiles``, ``anyres_select`` and ``Prefetcher`` (order,
bounded depth, the timeout counter) on the same seeded masks; the port's
engines run on ``device="cpu"``. Exact everywhere, dtypes included.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import pipeline as jpipe  # noqa: E402
from repro.engine import Engine as JEngine, YCHGConfig  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.engine import Engine, EngineConfig  # noqa: E402


def _masks(seed=11, shape=(6, 16, 20)):
    rng = np.random.default_rng(seed)
    masks = (rng.random(shape) < 0.4).astype(np.uint8)
    masks[2] = 0                   # an empty tile, which the filter drops
    return masks


def _same(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("backend", ["auto", "fused", "jnp"])
def test_ychg_stats_matches_jax(backend):
    masks = _masks()
    _same(pipeline.ychg_stats(masks, backend=backend, device="cpu"),
          jpipe.ychg_stats(masks, backend=backend))


@pytest.mark.parametrize("name", ["torch", "fused", "cuda"])
def test_ychg_stats_with_an_engine(name):
    masks = _masks(12)
    got = pipeline.ychg_stats(masks, engine=Engine(
        EngineConfig(backend=name), device="cpu"))
    _same(got, jpipe.ychg_stats(masks, engine=JEngine(YCHGConfig(
        backend={"torch": "jax", "cuda": "pallas"}.get(name, name)))))
    # a tensor stack gives the same statistics
    _same(pipeline.ychg_stats(torch.from_numpy(masks), engine=Engine(
        EngineConfig(backend=name), device="cpu")), got)


def test_default_engines_are_keyed_by_backend_and_device():
    pipeline.ychg_stats(_masks(), backend="jnp", device="cpu")
    a = pipeline._default_engine("torch", "cpu")
    assert a is pipeline._default_engine("torch", "cpu")
    assert a.resolve_backend() == "torch" and a.device.type == "cpu"
    assert pipeline._default_engine("fused", "cpu").resolve_backend() == (
        "fused")


def test_unknown_backend():
    for mod in (pipeline, jpipe):
        with pytest.raises(ValueError, match="unknown backend 'pallas'"):
            mod.ychg_stats(_masks(), backend="pallas")


@pytest.mark.parametrize("min_hyperedges", [1, 3, 100])
def test_filter_empty_tiles_matches_jax(min_hyperedges):
    masks = _masks(13)
    want = jpipe.filter_empty_tiles(masks, min_hyperedges)
    got = pipeline.filter_empty_tiles(masks, min_hyperedges, device="cpu")
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    stats = pipeline.ychg_stats(masks, device="cpu")
    np.testing.assert_array_equal(
        pipeline.filter_empty_tiles(masks, min_hyperedges, stats=stats), want)
    t = pipeline.filter_empty_tiles(torch.from_numpy(masks), min_hyperedges,
                                    stats=stats)
    assert isinstance(t, torch.Tensor)
    np.testing.assert_array_equal(t.numpy(), want)


@pytest.mark.parametrize("shape,tile,k", [((96, 128), 32, 5),
                                          ((64, 64), 16, 20),
                                          ((10, 10), 32, 3)])
def test_anyres_select_matches_jax(shape, tile, k):
    rng = np.random.default_rng(14)
    image = (rng.random(shape) < 0.45).astype(np.uint8)
    image[: shape[0] // 2, : shape[1] // 2] = 0
    want = jpipe.anyres_select(image, tile, k)
    assert pipeline.anyres_select(image, tile, k, device="cpu") == want
    assert pipeline.anyres_select(torch.from_numpy(image), tile, k,
                                  engine=Engine(EngineConfig(
                                      backend="fused"), device="cpu")) == want


@pytest.mark.parametrize("mod", [pipeline, jpipe], ids=["torch", "jax"])
def test_prefetcher_order_and_bound(mod):
    produced = []

    def source():
        for i in range(7):
            produced.append(i)
            yield i

    p = mod.Prefetcher(source(), depth=2)
    time.sleep(0.05)
    assert len(produced) <= 4          # depth 2, one in hand, one blocked
    assert list(p) == list(range(7)) and p.timeouts == 0
    p.thread.join(timeout=5)
    assert not p.thread.is_alive()


@pytest.mark.parametrize("mod", [pipeline, jpipe], ids=["torch", "jax"])
def test_prefetcher_timeout_counts(mod):
    def slow():
        yield 1
        time.sleep(0.5)
        yield 2

    # the producer thread is a daemon left parked on the full queue, as in
    # the JAX package
    p = mod.Prefetcher(slow(), depth=1, timeout=0.1)
    assert list(p) == [1] and p.timeouts == 1
