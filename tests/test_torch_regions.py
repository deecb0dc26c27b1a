"""The port's ``core.regions`` and the yCHG invariants against the JAX
package's.

Twins of ``tests/test_ychg_properties.py``'s donut and same-count
reconnection cases, and ``tests/ychg_invariants.py``'s decomposition
checks (``check_decomposition_valid``, ``check_births_bound_chain_heads``,
``check_area_estimation``) run over its ``corpus()`` with the port's
``regions`` and ``core.ychg`` in place of the JAX package's. The port's
``decompose`` must equal JAX's hyperedge by hyperedge. The hypothesis
twin skips where ``hypothesis`` is missing. Exact everywhere.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import ychg_invariants  # noqa: E402
from repro.core import regions as jregions  # noqa: E402
from repro.core import ychg as jychg  # noqa: E402
from repro_torch.core import regions  # noqa: E402
from repro_torch.core import ychg as tychg  # noqa: E402
from ychg_invariants import corpus, structured_masks  # noqa: E402

CORPUS = corpus()
DECOMPOSITION_CHECKS = ("check_decomposition_valid",
                        "check_births_bound_chain_heads",
                        "check_area_estimation")


def _t(img):
    return torch.from_numpy(np.array(img))


# core.ychg as the invariant checks call it (they hand over jax arrays)
PORT_YCHG = types.SimpleNamespace(
    analyze=lambda a: tychg.analyze(_t(a)),
    column_runs=lambda a: tychg.column_runs(_t(a)),
    hyperedge_count=lambda a: tychg.hyperedge_count(_t(a)),
    check_conservation=tychg.check_conservation,
)


def _edges(edges):
    return [tuple((r.col, r.row_start, r.row_end) for r in e.runs)
            for e in edges]


def test_branch_merge_donut_counts():
    donut = structured_masks()[6]
    s = tychg.analyze(_t(donut))
    np.testing.assert_array_equal(s.runs.numpy(), [1, 2, 1])
    assert s.runs.dtype == torch.int32
    assert int(s.n_hyperedges) == 2
    assert len(regions.decompose(donut)) == 4


def test_same_count_reconnection_case():
    reconnect = structured_masks()[7]
    s = tychg.analyze(_t(reconnect))
    np.testing.assert_array_equal(s.runs.numpy(), [2, 2])
    assert not bool(s.transitions[1])              # signal misses the event
    assert int(s.n_hyperedges) == 2                # count model: 2
    assert len(regions.decompose(reconnect)) == 4  # reality: 4 chains


@pytest.mark.parametrize("name", DECOMPOSITION_CHECKS)
def test_invariants_over_corpus_with_the_port(name, monkeypatch):
    monkeypatch.setattr(ychg_invariants, "regions", regions)
    monkeypatch.setattr(ychg_invariants, "ychg", PORT_YCHG)
    check = getattr(ychg_invariants, name)
    for img in CORPUS:
        check(img)


def test_decompose_equals_jax_hyperedge_by_hyperedge():
    for img in CORPUS:
        got, want = regions.decompose(img), jregions.decompose(img)
        assert _edges(got) == _edges(want)
        assert [e.col_span for e in got] == [e.col_span for e in want]
        assert [e.area for e in got] == [e.area for e in want]
        labels, n = regions.label_image(img)
        jlabels, jn = jregions.label_image(img)
        assert n == jn and labels.dtype == jlabels.dtype == np.int32
        np.testing.assert_array_equal(labels, jlabels)
        assert regions.total_area(img) == jregions.total_area(img)
        assert [[(r.col, r.row_start, r.row_end) for r in col]
                for col in regions.extract_runs(img)] == [
            [(r.col, r.row_start, r.row_end) for r in col]
            for col in jregions.extract_runs(img)]


def test_tensors_enter_through_one_host_copy():
    img = (np.random.default_rng(4).random((30, 41)) < 0.5).astype(np.uint8)
    want = _edges(jregions.decompose(img))
    for x in (_t(img), _t(img).bool(), _t(img.astype(np.float32))):
        assert _edges(regions.decompose(x)) == want
        assert regions.total_area(x) == jregions.total_area(img)
        np.testing.assert_array_equal(regions.label_image(x)[0],
                                      jregions.label_image(img)[0])


def test_cut_vertices_and_analyze_batched_match_jax():
    rng = np.random.default_rng(5)
    imgs = (rng.random((3, 17, 23)) < 0.5).astype(np.uint8)
    got = tychg.cut_vertices(_t(imgs))
    want = np.asarray(jychg.cut_vertices(jnp.asarray(imgs)))
    assert got.dtype == torch.int32 and str(want.dtype) == "int32"
    np.testing.assert_array_equal(got.numpy(), want)
    s, js = tychg.analyze_batched(_t(imgs)), jychg.analyze_batched(
        jnp.asarray(imgs))
    for f in ychg_invariants.SUMMARY_FIELDS:
        g, w = getattr(s, f).numpy(), np.asarray(getattr(js, f))
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def test_core_exports_match_jax():
    """Every export of ``repro.core`` but ``analyze_jit`` (jax.jit has no
    counterpart), plus ``analyze_batched``."""
    assert set(tcore.__all__) == (set(jcore.__all__) - {"analyze_jit"}
                                  | {"analyze_batched"})
    assert tcore.regions is regions and tcore.serial.__name__ == (
        "repro_torch.core.serial")


def test_decomposition_invariants_fuzzed():
    """The hypothesis twin of ``test_ychg_properties_hypothesis.py`` for
    the decomposition checks, with the port in place of the JAX package."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st
    from hypothesis.extra import numpy as hnp

    masks = hnp.arrays(dtype=np.uint8,
                       shape=st.tuples(st.integers(1, 40),
                                       st.integers(1, 40)),
                       elements=st.integers(0, 1))

    @given(img=masks)
    @settings(max_examples=25, deadline=None)
    def fuzz(img):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ychg_invariants, "regions", regions)
            mp.setattr(ychg_invariants, "ychg", PORT_YCHG)
            for name in DECOMPOSITION_CHECKS:
                getattr(ychg_invariants, name)(img)
        assert _edges(regions.decompose(img)) == _edges(
            jregions.decompose(img))

    fuzz()
