"""The port's scene tier (``repro_torch.scene``, ``repro_torch.data.scenes``)
against the JAX package's (``repro.scene``, ``repro.data.scenes``).

Scenes are tiny (tens of rows) but always exercise the ragged last strip.
Three bars, all exact:

  * **content** — ``scene_rows`` gives the JAX package's pixels;
  * **stitch bit-identity** — every field of a stitched scene result
    (values, dtypes, shapes) equals the JAX ``SceneRunner``'s and one
    whole-scene ``Engine(device="cpu").analyze`` call;
  * **byte-identity** — a port ``BulkJob`` writes the JAX ``BulkJob``'s
    ``.ychg`` bytes, and a job killed in one package resumes in the other
    to the uninterrupted run's bytes.

Resume points are pinned with ``max_stacks``, never with timers or signals.
Sockets are loopback only, on ephemeral ports.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import scene as jscene  # noqa: E402
from repro.data import scenes as jscenes  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro_torch.data import scenes  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.scene import (  # noqa: E402
    BulkJob,
    BulkJobConfig,
    GranuleReader,
    GranuleSpec,
    SceneProgress,
    SceneResult,
    SceneRunner,
    manifest_from_json,
    manifest_to_json,
    read_scene_result,
    seam_joins,
    stitch_tile_runs,
    synthetic_manifest,
    write_scene_result,
)


def _cpu():
    return Engine(device="cpu")


def _assert_host_identical(got, want, context=""):
    """Dict-of-arrays parity bar: values, dtypes, and shapes all equal."""
    assert set(got) == set(want)
    for field in want:
        g, w = np.asarray(got[field]), np.asarray(want[field])
        assert g.dtype == w.dtype, f"{context}{field}: {g.dtype} != {w.dtype}"
        assert g.shape == w.shape, f"{context}{field}: {g.shape} != {w.shape}"
        np.testing.assert_array_equal(g, w, err_msg=context + field)


def _read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


# -------------------------------------------------------- synthetic scenes


@pytest.mark.parametrize("seed, cell, coverage, window", [
    (0, 64, 0.45, (0, 70)),
    (9, 8, 0.45, (13, 13)),
    (9, 8, 0.45, (7, 50)),
    (3, 1, 0.2, (0, 5)),
    (2**40 + 5, 16, 0.7, (49, 50)),
])
def test_scene_rows_match_jax(seed, cell, coverage, window):
    row0, row1 = window
    kw = dict(seed=seed, cell=cell, coverage=coverage)
    got = scenes.scene_rows(50 if row1 <= 50 else row1, 90, row0, row1, **kw)
    want = jscenes.scene_rows(50 if row1 <= 50 else row1, 90, row0, row1,
                              **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_scene_rows_compose_and_validate():
    whole = scenes.scene(50, 40, seed=9, cell=8)
    for row0, row1 in [(0, 50), (0, 7), (7, 20), (49, 50), (13, 13)]:
        np.testing.assert_array_equal(
            scenes.scene_rows(50, 40, row0, row1, seed=9, cell=8),
            whole[row0:row1])
    with pytest.raises(ValueError, match="outside"):
        scenes.scene_rows(10, 4, 5, 11)
    with pytest.raises(ValueError, match="cell"):
        scenes.scene_rows(10, 4, 0, 1, cell=0)


# ----------------------------------------------------------------- reader


def test_reader_tiles_cover_scene_with_inert_padding():
    mask = scenes.scene(21, 16, seed=2, cell=4)
    reader = GranuleReader.from_array(mask, 8)
    assert reader.n_tiles == 3 and reader.tile_rows(2) == (16, 21)
    rebuilt = np.concatenate([reader.read_tile(t) for t in range(3)])
    np.testing.assert_array_equal(rebuilt[:21], mask)
    assert not rebuilt[21:].any()
    stack = reader.read_stack(1, 2)
    for i in range(2):
        np.testing.assert_array_equal(stack[i], reader.read_tile(1 + i))
    with pytest.raises(IndexError):
        reader.read_stack(2, 2)


def test_memmap_reader_matches_in_memory(tmp_path):
    mask = scenes.scene(25, 10, seed=4, cell=4)
    path = os.path.join(tmp_path, "granule.npy")
    np.save(path, mask)
    mem = GranuleReader.from_array(mask, 6)
    mm = GranuleReader.from_npy(path, 6)
    for t in range(mem.n_tiles):
        np.testing.assert_array_equal(mm.read_tile(t), mem.read_tile(t))
    spec = GranuleSpec(granule_id="g", height=99, width=10, kind="memmap",
                       path=path)
    with pytest.raises(ValueError, match="manifest says"):
        GranuleReader.open(spec, 8)


def test_manifest_json_is_shared_with_jax():
    manifest = synthetic_manifest(3, 64, 32, seed=5, cell=16, coverage=0.3)
    text = manifest_to_json(manifest)
    assert text == jscene.manifest_to_json(jscene.synthetic_manifest(
        3, 64, 32, seed=5, cell=16, coverage=0.3))
    assert manifest_from_json(text) == manifest
    with pytest.raises(ValueError, match="memmap"):
        GranuleSpec(granule_id="g", height=4, width=4, kind="memmap")
    with pytest.raises(ValueError, match="kind"):
        GranuleSpec(granule_id="g", height=4, width=4, kind="tarball")


# ----------------------------------------------------------------- stitch


def test_seam_joins_matches_jax():
    bottom = np.array([1, 0, 1, 0, 5], np.uint8)
    top = np.array([1, 1, 0, 0, 1], np.uint8)
    got = seam_joins(bottom, top)
    want = jscene.seam_joins(bottom, top)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [1, 0, 0, 0, 1])


@pytest.mark.parametrize("h,w,tile_h,stack", [
    (45, 32, 16, 2),   # ragged last strip, mid stack
    (37, 51, 8, 4),    # ragged, stack > strips per granule end
    (64, 24, 64, 1),   # one strip == whole scene
    (5, 9, 2, 3),      # tiny, stack overshoots
    (33, 16, 1, 4),    # single-row strips: every boundary is a seam
])
def test_stitched_scene_matches_jax_and_whole_scene(h, w, tile_h, stack):
    mask = scenes.scene(h, w, seed=h * 100 + w, cell=8)
    engine = _cpu()
    got = SceneRunner(engine, stack_tiles=stack).analyze_scene(
        GranuleReader.from_array(mask, tile_h)).to_host()
    want = jscene.SceneRunner(JEngine(), stack_tiles=stack).analyze_scene(
        jscene.GranuleReader.from_array(mask, tile_h)).to_host()
    _assert_host_identical(got, want, context=f"{h}x{w}/{tile_h} vs JAX: ")
    _assert_host_identical(got, engine.analyze(mask).to_host(),
                           context=f"{h}x{w}/{tile_h} vs whole: ")


def test_float32_subnormal_seams_follow_the_engine():
    """The seam test is the engine's foreground: a float32 subnormal in a
    seam row is background there too, so the stitch still equals one
    whole-scene call."""
    rng = np.random.default_rng(4)
    vals = np.array([0.0, 1e-40, -1e-42, 1.0, 2.5], np.float32)
    mask = vals[rng.integers(0, len(vals), (30, 20))]
    engine = _cpu()
    got = SceneRunner(engine, stack_tiles=2).analyze_scene(
        GranuleReader.from_array(mask, 4)).to_host()
    _assert_host_identical(got, engine.analyze(mask).to_host())


def test_stitch_tile_runs_matches_scene_runs():
    mask = scenes.scene(29, 14, seed=6, cell=4)
    engine = _cpu()
    reader = GranuleReader.from_array(mask, 6)
    tiles = [reader.read_tile(t) for t in range(reader.n_tiles)]
    tile_runs = [engine.analyze(t).to_host()["runs"] for t in tiles]
    got = stitch_tile_runs(tile_runs, tiles)
    np.testing.assert_array_equal(got, jscene.stitch_tile_runs(tile_runs,
                                                               tiles))
    np.testing.assert_array_equal(got, engine.analyze(mask).to_host()["runs"])
    with pytest.raises(ValueError, match="run vectors"):
        stitch_tile_runs(tile_runs[:-1], tiles)


def test_progress_counters_accumulate():
    progress = SceneProgress()
    reader = GranuleReader.from_array(scenes.scene(24, 8, seed=7, cell=4), 8)
    SceneRunner(_cpu(), stack_tiles=2).analyze_scene(reader,
                                                     progress=progress)
    snap = progress.snapshot()
    assert snap.tiles_done == reader.n_tiles
    assert snap.stitch_time_s > 0.0 and snap.resumes == 0


def test_default_engine_runs_on_the_card(tmp_path):
    """``SceneRunner()`` and ``BulkJob(None, ...)`` build ``Engine()``: on
    the card, or a raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SceneRunner()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BulkJob(None, synthetic_manifest(1, 8, 8),
                BulkJobConfig(out_dir=str(tmp_path / "o"),
                              ckpt_dir=str(tmp_path / "c")))


# ------------------------------------------------------------ result files


def test_scene_result_bytes_match_jax(tmp_path):
    mask = scenes.scene(20, 12, seed=8, cell=4)
    result = SceneRunner(_cpu()).analyze_scene(
        GranuleReader.from_array(mask, 8))
    blob = result.to_bytes()
    assert blob == result.to_bytes()   # content-determined, no timestamps
    jres = jscene.SceneResult(**dataclasses.asdict(result))
    assert jres.to_bytes() == blob
    back = SceneResult.from_bytes(blob)
    _assert_host_identical(back.to_host(), result.to_host())
    path = os.path.join(tmp_path, "a", "r.ychg")
    write_scene_result(path, result)
    write_scene_result(path, result)   # rewrite: same bytes, atomic
    assert _read_bytes(path) == blob
    _assert_host_identical(jscene.read_scene_result(path).to_host(),
                           read_scene_result(path).to_host())
    with pytest.raises(ValueError, match="magic"):
        SceneResult.from_bytes(b"not a scene result")
    with pytest.raises(ValueError, match="trailing"):
        SceneResult.from_bytes(blob + b"x")


# -------------------------------------------------------------- bulk jobs


def _config(tmp_path, tag, **cfg):
    knobs = dict(out_dir=os.path.join(tmp_path, tag, "out"),
                 ckpt_dir=os.path.join(tmp_path, tag, "ckpt"),
                 tile_h=8, stack_tiles=1, checkpoint_every=1)
    knobs.update(cfg)
    return knobs


def _job(tmp_path, tag, manifest, progress=None, **cfg):
    return BulkJob(_cpu(), manifest, BulkJobConfig(**_config(tmp_path, tag,
                                                             **cfg)),
                   progress=progress)


def _jax_job(tmp_path, tag, manifest, **cfg):
    return jscene.BulkJob(JEngine(), manifest,
                          jscene.BulkJobConfig(**_config(tmp_path, tag,
                                                         **cfg)))


def _outputs(tmp_path, tag, manifest):
    return [_read_bytes(os.path.join(tmp_path, tag, "out",
                                     f"{s.granule_id}.ychg"))
            for s in manifest]


def test_bulk_job_bytes_match_jax(tmp_path):
    """Synthetic and memmap granules, ragged last strips: the port's files
    are the JAX package's, byte for byte, and equal a whole-scene call."""
    path = os.path.join(tmp_path, "mm.npy")
    np.save(path, scenes.scene(27, 19, seed=4, cell=4))
    manifest = synthetic_manifest(2, 21, 10, seed=20, cell=4) + [
        GranuleSpec(granule_id="mm", height=27, width=19, kind="memmap",
                    path=path)]
    assert _job(tmp_path, "port", manifest, stack_tiles=2).run().completed
    assert _jax_job(tmp_path, "jax", manifest, stack_tiles=2).run().completed
    assert _outputs(tmp_path, "port", manifest) == _outputs(tmp_path, "jax",
                                                            manifest)
    engine = _cpu()
    for spec in manifest:
        got = read_scene_result(os.path.join(tmp_path, "port", "out",
                                             f"{spec.granule_id}.ychg"))
        whole = GranuleReader.open(spec, spec.height).read_tile(0)
        _assert_host_identical(got.to_host(), engine.analyze(whole).to_host(),
                               context=spec.granule_id + ": ")


@pytest.mark.parametrize("first, then", [("jax", "port"), ("port", "jax")])
def test_resume_across_packages_is_byte_identical(tmp_path, first, then):
    """A job killed at ``max_stacks=3`` by one package resumes in the other
    to the uninterrupted run's bytes."""
    manifest = synthetic_manifest(2, 20, 12, seed=30, cell=4)
    assert _job(tmp_path, "straight", manifest).run().completed
    make = {"jax": _jax_job, "port": _job}
    assert make[first](tmp_path, "killed", manifest).run(
        max_stacks=3).status == "interrupted"
    second = make[then](tmp_path, "killed", manifest).run()
    assert second.completed and second.resumes == 1
    assert _outputs(tmp_path, "killed", manifest) == _outputs(
        tmp_path, "straight", manifest)


@pytest.mark.parametrize("stop_after", [1, 3, 5])
def test_bulk_job_resume_is_byte_identical(tmp_path, stop_after):
    manifest = synthetic_manifest(2, 20, 12, seed=30, cell=4)
    assert _job(tmp_path, "straight", manifest).run().completed
    progress = SceneProgress()
    first = _job(tmp_path, "kill", manifest, progress).run(
        max_stacks=stop_after)
    assert first.status == "interrupted"
    second = _job(tmp_path, "kill", manifest, progress).run()
    assert second.completed and second.resumes == 1
    assert progress.snapshot().resumes == 1
    assert _outputs(tmp_path, "kill", manifest) == _outputs(
        tmp_path, "straight", manifest)


def test_bulk_job_resume_after_corrupt_newest_checkpoint(tmp_path):
    """A torn newest checkpoint costs one interval, not the job: resume
    warns, falls back to the previous step, and stays byte-identical."""
    manifest = synthetic_manifest(1, 40, 10, seed=40, cell=4)
    assert _job(tmp_path, "straight", manifest).run().completed
    assert _job(tmp_path, "killed", manifest).run(
        max_stacks=3).status == "interrupted"
    ckpt_dir = os.path.join(tmp_path, "killed", "ckpt")
    newest = sorted(d for d in os.listdir(ckpt_dir)
                    if d.startswith("step_"))[-1]
    shard = [f for f in os.listdir(os.path.join(ckpt_dir, newest))
             if f.endswith(".npz")][0]
    with open(os.path.join(ckpt_dir, newest, shard), "r+b") as f:
        f.truncate(8)
    with pytest.warns(RuntimeWarning):
        second = _job(tmp_path, "killed", manifest).run()
    assert second.completed and second.resumes == 1
    assert _outputs(tmp_path, "killed", manifest) == _outputs(
        tmp_path, "straight", manifest)


def test_bulk_job_gc_noop_rerun_and_bad_manifests(tmp_path):
    manifest = synthetic_manifest(1, 48, 8, seed=50, cell=4)
    assert _job(tmp_path, "gc", manifest, keep=2).run().completed
    steps = [d for d in os.listdir(os.path.join(tmp_path, "gc", "ckpt"))
             if d.startswith("step_") and not d.endswith(".tmp")]
    assert len(steps) == 2
    before = _outputs(tmp_path, "gc", manifest)
    again = _job(tmp_path, "gc", manifest, keep=2).run()
    assert again.completed and again.stacks_done == 0
    assert _outputs(tmp_path, "gc", manifest) == before
    cfg = BulkJobConfig(out_dir=str(tmp_path / "o"),
                        ckpt_dir=str(tmp_path / "c"))
    with pytest.raises(ValueError, match="empty"):
        BulkJob(_cpu(), [], cfg)
    with pytest.raises(ValueError, match="duplicate"):
        BulkJob(_cpu(), manifest + manifest, cfg)
    assert _job(tmp_path, "w", manifest).run(
        max_stacks=1).status == "interrupted"
    wider = [dataclasses.replace(manifest[0], width=16)]
    with pytest.raises(ValueError, match="wide"):
        _job(tmp_path, "w", wider).run()


def test_bulk_job_cuts_compute_into_ingest_then_runs_back(tmp_path):
    """One granule trace: a ``scene.read`` with its ``minflt`` count, then
    ``scene.compute`` holding ``scene.ingest`` then ``scene.runs_back``,
    a stack each; tracing off, the job leaves no trace and the same
    bytes."""
    from repro_torch import obs

    path = os.path.join(tmp_path, "mm.npy")
    np.save(path, scenes.scene(27, 19, seed=4, cell=4))
    manifest = [GranuleSpec(granule_id="mm", height=27, width=19,
                            kind="memmap", path=path)]
    was = obs.tracing_enabled()
    obs.recorder().clear()
    try:
        obs.configure(enabled=True)
        report = _job(tmp_path, "on", manifest, stack_tiles=2).run()
        traces = [t for t in obs.recorder().traces() if t.process == "scene"]
        obs.recorder().clear()
        obs.configure(enabled=False)
        assert _job(tmp_path, "off", manifest, stack_tiles=2).run().completed
        assert obs.recorder().traces() == []
    finally:
        obs.configure(enabled=was)
    assert report.completed and report.stacks_done == 2
    assert _outputs(tmp_path, "on", manifest) == _outputs(tmp_path, "off",
                                                          manifest)
    (tr,) = traces
    spans = {}
    for name, t0, t1, meta in tr.spans():
        spans.setdefault(name, []).append((t0, t1, meta))
    reads, computes, ingests, backs = (
        sorted(spans[n], key=lambda s: s[0]) for n in (
            "scene.read", "scene.compute", "scene.ingest",
            "scene.runs_back"))
    assert len(reads) == len(computes) == len(ingests) == len(backs) == 2
    for (r0, r1, rm), (c0, c1, _), (i0, i1, _), (b0, b1, _) in zip(
            reads, computes, ingests, backs):
        assert r0 <= r1 <= c0 <= i0 <= i1 <= b0 <= b1 <= c1
        assert isinstance(rm["minflt"], int) and rm["minflt"] >= 0


# -------------------------------------------- online/offline (loopback)


def test_scene_gauges_on_metrics_over_loopback():
    """Tiles replayed through the port's HTTP front end match per-tile
    ``engine.analyze`` and stitch to the offline result, and an attached
    ``SceneProgress`` shows on ``/metrics``."""
    from repro_torch.frontend import ServerThread, YCHGClient
    from repro_torch.obs import parse_prom_text
    from repro_torch.service import ServiceConfig, YCHGService

    mask = scenes.scene(20, 16, seed=80, cell=8)
    engine = _cpu()
    reader = GranuleReader.from_array(mask, 8)
    tiles = [reader.read_tile(t) for t in range(reader.n_tiles)]
    offline = SceneRunner(engine).analyze_scene(reader)
    progress = SceneProgress()
    progress.set_totals(tiles=reader.n_tiles, granules=1)
    progress.note_tiles(reader.n_tiles)
    progress.note_resume()
    progress.note_stitch(0.25)
    cfg = ServiceConfig(bucket_sides=(16,), max_batch=len(tiles))
    with YCHGService(engine, cfg) as svc, \
            ServerThread(svc) as srv, \
            YCHGClient("127.0.0.1", srv.port) as client:
        before = client.metrics_text()
        svc.attach_scene_progress(progress)
        items = {it.id: it for it in client.analyze_batch(tiles)}
        assert all(it.ok for it in items.values())
        for i, tile in enumerate(tiles):
            _assert_host_identical(items[i].result,
                                   engine.analyze(tile).to_host(),
                                   context=f"tile {i}: ")
        online = stitch_tile_runs(
            [items[i].result["runs"] for i in range(len(tiles))], tiles)
        np.testing.assert_array_equal(online, offline.runs)
        m = svc.metrics()
        text = client.metrics_text()
    assert (m.scene_tiles_done, m.scene_tiles_total, m.scene_resumes) == (
        reader.n_tiles, reader.n_tiles, 1)
    assert m.scene_stitch_time_s == 0.25
    values = {s.name: s.value for s in parse_prom_text(text).samples
              if not s.labels}
    assert values["ychg_scene_tiles_done"] == reader.n_tiles
    assert values["ychg_scene_tiles_total"] == reader.n_tiles
    assert values["ychg_scene_resumes_total"] == 1
    assert values["ychg_scene_stitch_seconds"] == 0.25
    zero = {s.name: s.value for s in parse_prom_text(before).samples
            if not s.labels}
    assert zero["ychg_scene_tiles_done"] == 0
