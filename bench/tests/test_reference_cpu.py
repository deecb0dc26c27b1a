"""The plain reference against the program on the CPU, the frozen file
format against the program's, and the generators."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bench.gen import modis  # noqa: E402
from bench.reference import ychg as ref  # noqa: E402
from bench.reference import ychg_file  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]


def _engine():
    from repro_torch.engine import Engine

    return Engine(device="cpu")


def _masks():
    rng = np.random.default_rng(7)
    return {
        "random": (rng.random((37, 53)) < 0.5).astype(np.uint8),
        "sparse": (rng.random((70, 9)) < 0.05).astype(np.uint8),
        "zeros": np.zeros((16, 16), np.uint8),
        "ones": np.ones((5, 40), np.uint8),
        "one_row": (rng.random((1, 31)) < 0.5).astype(np.uint8),
        "striped": modis.striped(100, 49),
        "snowfield": modis.snowfield_pool(torch, 1, 96, 2**35 + 1,
                                          device="cpu")[0],
    }


@pytest.mark.parametrize("name", sorted(_masks()))
def test_reference_matches_engine(name):
    mask = _masks()[name]
    got = _engine().analyze(mask).to_host()
    want = ref.analyze(mask)
    assert ref.mismatches(got, want) == 0
    for f in ref.FIELDS:
        assert got[f].dtype == want[f].dtype and got[f].shape == want[f].shape


@pytest.mark.parametrize("block_rows", [1, 2, 3, 64, 4096])
def test_row_blocks_do_not_change_the_answer(block_rows):
    mask = _masks()["random"]
    assert np.array_equal(ref.column_runs(mask, block_rows=block_rows),
                          ref.column_runs(mask))


def test_mismatches_counts_every_wrong_element_and_field():
    want = ref.analyze(_masks()["random"])
    got = {f: v.copy() for f, v in want.items()}
    assert ref.mismatches(got, want) == 0
    got["runs"][:3] += 1
    got["deaths"] = got["deaths"].astype(np.int64)
    del got["n_transitions"]
    assert ref.mismatches(got, want) == 3 + want["deaths"].size + 1


def test_the_control_departs_from_the_reference():
    mask = modis.snowfield_pool(torch, 1, 256, 11, device="cpu")[0]
    patched = modis.patched(mask, 11, 0, 64)
    assert ref.mismatches(ref.analyze(patched, row_step=2),
                          ref.analyze(patched)) > 0


def test_bulk_job_files_match_the_reference_and_both_readers(tmp_path):
    from repro_torch.scene import (BulkJob, BulkJobConfig, GranuleSpec,
                                   read_scene_result)

    scene = modis.striped(150, 100)
    scene[3, :] = 1  # a run across a strip seam
    path = tmp_path / "g.npy"
    np.save(path, scene)
    spec = GranuleSpec(granule_id="g0", height=150, width=150,
                       kind="memmap", path=str(path))
    report = BulkJob(_engine(), [spec], BulkJobConfig(
        out_dir=str(tmp_path / "out"), ckpt_dir=str(tmp_path / "ckpt"),
        tile_h=32, stack_tiles=2)).run()
    header, fields = ychg_file.read(report.written[0])
    assert ref.mismatches(fields, ref.analyze(scene)) == 0
    assert (header["granule_id"], header["height"], header["width"],
            header["tile_h"], header["n_tiles"]) == ("g0", 150, 150, 32, 5)
    theirs = read_scene_result(report.written[0]).to_host()
    assert ref.mismatches(theirs, fields) == 0


def test_frozen_writer_writes_what_the_program_reads(tmp_path):
    from repro_torch.scene import read_scene_result

    fields = ref.analyze(_masks()["random"])
    path = ychg_file.write(str(tmp_path / "r.ychg"), {
        "granule_id": "r", "height": 37, "width": 53, "tile_h": 8,
        "n_tiles": 5}, fields)
    back = read_scene_result(path)
    assert (back.granule_id, back.n_tiles) == ("r", 5)
    assert ref.mismatches(back.to_host(), fields) == 0
    with open(path, "ab") as f:
        f.write(b"x")
    with pytest.raises(ValueError):
        ychg_file.read(path)


@pytest.mark.parametrize("res,n", [(50, 10), (64, 17), (100, 49), (200, 100),
                                   (90, 1), (40, 0)])
def test_striped_is_the_programs_pattern(res, n):
    from repro_torch.data import modis as program_modis

    assert np.array_equal(modis.striped(res, n),
                          program_modis.striped(res, n))


def test_snowfield_pool_follows_the_seed():
    a = modis.snowfield_pool(torch, 2, 64, 2**40 + 3, device="cpu")
    b = modis.snowfield_pool(torch, 2, 64, 2**40 + 3, device="cpu")
    c = modis.snowfield_pool(torch, 2, 64, 2**40 + 4, device="cpu")
    assert a.dtype == np.uint8 and a.shape == (2, 64, 64)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert abs(a.mean() - 0.45) < 0.01


def test_patches_differ_by_request_and_follow_the_seed():
    base = np.zeros((300, 300), np.uint8)
    one = modis.patched(base, 5, 1, 64)
    assert np.array_equal(one, modis.patched(base, 5, 1, 64))
    assert not np.array_equal(one, modis.patched(base, 5, 2, 64))
    assert not np.array_equal(one, modis.patched(base, 6, 1, 64))
    buf = base.copy()
    modis.apply_patch(buf, 5, 1, 64)
    assert np.array_equal(buf, one)


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; import bench.reference.ychg, "
            "bench.reference.ychg_file; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'repro', 'jax', 'jaxlib', 'flax', 'torch'}))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
