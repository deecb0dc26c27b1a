"""The port's five yCHG example twins, run with ``--device cpu``.

Each ``repro_torch.examples.<name>.main`` runs here in-process with its
own asserts, and the totals it prints (hyperedges, transition columns,
y-convex pieces, kept tiles, anyres offsets, per-granule hyperedges) must
equal what the JAX package's functions give on the same seeded inputs.
The JAX examples themselves are not run.
"""

import ast
import re

import pytest

pytest.importorskip("torch")

from repro.core import regions as jregions  # noqa: E402
from repro.data import modis as jmodis  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.data import scenes as jscenes  # noqa: E402
from repro.engine import Engine as JEngine, YCHGConfig  # noqa: E402
from repro.scene import GranuleReader, SceneRunner  # noqa: E402
from repro.scene import synthetic_manifest  # noqa: E402
from repro_torch.examples import (  # noqa: E402
    quickstart,
    roi_pipeline,
    roi_scene_bulk,
    roi_service_http,
    satellite_roi,
)

CPU = ["--device", "cpu"]


def _run(module, capsys) -> str:
    module.main(CPU)
    return capsys.readouterr().out


def _find(pattern, text):
    m = re.search(pattern, text)
    assert m, (pattern, text)
    return m.groups()


def test_quickstart(capsys):
    out = _run(quickstart, capsys)
    img = jmodis.snowfield(512, seed=7)
    want = JEngine().analyze(img).to_host()
    nt, nh = _find(r"step 2: (\d+) transition columns, (\d+) yConvex", out)
    assert (int(nt), int(nh)) == (int(want["n_transitions"]),
                                  int(want["n_hyperedges"]))
    edges = jregions.decompose(img)
    big = max(edges, key=lambda e: e.area)
    n, span, area, total = _find(
        r"materialised (\d+) y-convex pieces; largest spans cols (\(\d+, \d+\))"
        r" area (\d+)px \(total area (\d+)px\)", out)
    assert int(n) == len(edges) and ast.literal_eval(span) == big.col_span
    assert int(area) == big.area and int(total) == jregions.total_area(img)
    assert "serial baseline agrees exactly" in out
    assert "service: 2 served (1 from cache)" in out


def test_satellite_roi(capsys):
    out = _run(satellite_roi, capsys)
    scene = jmodis.snowfield(1024, seed=11)
    engine = JEngine(YCHGConfig(backend="fused"))
    tiles = kept = edges = 0
    for batch in satellite_roi.tile_stream(scene, 128):
        stats = jpipe.ychg_stats(batch, engine=engine)
        tiles += len(batch)
        kept += len(jpipe.filter_empty_tiles(batch, stats=stats))
        edges += int(stats["n_hyperedges"].sum())
    got = _find(r"processed (\d+) tiles in .*; kept (\d+), total hyperedges "
                r"(\d+)", out)
    assert tuple(map(int, got)) == (tiles, kept, edges)
    assert f"analyze_stream pass agrees: {edges} hyperedges" in out
    assert f"total hyperedges {edges} (matches streaming pass)" in out
    (offs,) = _find(r"anyres-selected crops \(by yCHG hyperedge density\): "
                    r"(\[.*\])", out)
    assert ast.literal_eval(offs) == jpipe.anyres_select(scene, 256, 5)


def test_roi_pipeline(capsys):
    out = _run(roi_pipeline, capsys)
    img = roi_pipeline.speckled_image()
    filtered = JEngine(op="denoise").analyze(img).to_host()["image"]
    want = int(JEngine().analyze(filtered).to_host()["n_hyperedges"])
    (n,) = _find(r"\((\d+) hyperedges in the filtered image\)", out)
    assert int(n) == want
    assert "POST /v1/pipeline bit-identical" in out
    assert out.count("/metrics  ychg_stage_seconds_count") == 2


def test_roi_service_http(capsys):
    out = _run(roi_service_http, capsys)
    masks = roi_service_http.seeded_masks()
    want = [int(JEngine().analyze(m).to_host()["n_hyperedges"])
            for m in masks]
    (single,) = _find(r"single mask: (\d+) hyperedges", out)
    assert int(single) == want[0]
    got = {int(i): int(n) for i, n in
           re.findall(r"  roi-(\d+): (\d+) hyperedges", out)}
    assert got == dict(enumerate(want))
    assert "overload: HTTP 429, retry after" in out


def test_roi_scene_bulk(capsys):
    out = _run(roi_scene_bulk, capsys)
    engine = JEngine()
    mask = jscenes.scene(45, 64, seed=7, cell=8)
    (n,) = _find(r"scene -> (\d+) hyperedges, bit-identical", out)
    assert int(n) == int(engine.analyze(mask).to_host()["n_hyperedges"])
    for spec in synthetic_manifest(3, height=96, width=64, seed=100,
                                   cell=8):
        res = SceneRunner(engine, stack_tiles=2).analyze_scene(
            GranuleReader.open(spec, 16))
        assert (f"  {spec.granule_id}: {int(res.n_hyperedges)} hyperedges "
                f"over 96x64") in out
    assert "resumed run's outputs are byte-identical" in out
    assert "progress: tiles 18/18, granules 3/3, resumes 1" in out
