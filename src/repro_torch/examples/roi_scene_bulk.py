"""Granule-scale scene analysis with a resumable bulk job, end to end.

The port's twin of ``examples/roi_scene_bulk.py``. A *granule* is one
scene too large to want in a single device call — here synthetic
MODIS-like snow masks, windowed into full-width tile rows and streamed
through the engine with exact seam stitching (the stitched result is
bit-identical to analysing the unsplit scene). The walkthrough:

  1. stitch parity       -> SceneRunner over 8-row strips equals one
                            whole-scene engine.analyze call, bit for bit;
  2. a bulk job          -> a 3-granule manifest run to completion, one
                            deterministic .ychg result file per granule;
  3. kill + resume       -> the same manifest interrupted mid-granule,
                            resumed from its checkpoint, and the output
                            bytes compared equal to the uninterrupted
                            run's — the resume contract;
  4. progress            -> the SceneProgress counters a service would
                            surface on /metrics.

Run:  PYTHONPATH=src python -m repro_torch.examples.roi_scene_bulk [--device cpu]
"""

import os
import tempfile

import numpy as np

from repro_torch.data import scenes
from repro_torch.engine import Engine
from repro_torch.examples import parse_device
from repro_torch.scene import (
    BulkJob,
    BulkJobConfig,
    GranuleReader,
    SceneProgress,
    SceneRunner,
    read_scene_result,
    synthetic_manifest,
)


def main(argv=None):
    device = parse_device(__doc__.splitlines()[0], argv)
    engine = Engine(device=device)

    # 1. stitch parity: strips + seam correction == whole scene, exactly.
    #    45 rows over 8-row strips leaves a ragged, zero-padded last strip.
    mask = scenes.scene(45, 64, seed=7, cell=8)
    reader = GranuleReader.from_array(mask, tile_h=8, granule_id="demo")
    stitched = SceneRunner(engine, stack_tiles=2).analyze_scene(reader)
    whole = engine.analyze(mask).to_host()
    assert all(np.array_equal(whole[f], np.asarray(getattr(stitched, f)))
               for f in whole)
    print(f"stitch parity: {reader.n_tiles} strips of a 45x64 scene -> "
          f"{int(stitched.n_hyperedges)} hyperedges, bit-identical to the "
          f"whole-scene call")

    manifest = synthetic_manifest(3, height=96, width=64, seed=100, cell=8)
    with tempfile.TemporaryDirectory() as tmp:
        def config(tag):
            return BulkJobConfig(out_dir=os.path.join(tmp, tag, "out"),
                                 ckpt_dir=os.path.join(tmp, tag, "ckpt"),
                                 tile_h=16, stack_tiles=2,
                                 checkpoint_every=2)

        # 2. run the manifest to completion: one result file per granule
        job = BulkJob(engine, manifest, config("straight"))
        report = job.run()
        print(f"bulk job: {report.granules_done} granules, "
              f"{report.tiles_done} tiles in {report.elapsed_s:.2f}s")
        for spec in manifest:
            res = read_scene_result(job.output_path(spec))
            print(f"  {spec.granule_id}: {int(res.n_hyperedges)} "
                  f"hyperedges over {res.height}x{res.width}")

        # 3. the resume contract: interrupt mid-granule (max_stacks plays
        #    the part of SIGTERM — `serve.py scene` wires the real one),
        #    restart with the same directories, compare output bytes
        progress = SceneProgress()
        first = BulkJob(engine, manifest, config("killed"),
                        progress=progress).run(max_stacks=3)
        print(f"interrupted after {first.stacks_done} stacks "
              f"({first.status})")
        second = BulkJob(engine, manifest, config("killed"),
                         progress=progress).run()
        assert second.completed and second.resumes == 1
        for spec in manifest:
            a = os.path.join(tmp, "straight", "out",
                             f"{spec.granule_id}.ychg")
            b = os.path.join(tmp, "killed", "out",
                             f"{spec.granule_id}.ychg")
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read()
        print("resumed run's outputs are byte-identical to the "
              "uninterrupted run's")

        # 4. progress counters (a service attaches these to /metrics via
        #    service.attach_scene_progress(progress))
        snap = progress.snapshot()
        print(f"progress: tiles {snap.tiles_done}/{snap.tiles_total}, "
              f"granules {snap.granules_done}/{snap.granules_total}, "
              f"resumes {snap.resumes}, "
              f"stitch {snap.stitch_time_s * 1e3:.1f}ms")


if __name__ == "__main__":
    main()
