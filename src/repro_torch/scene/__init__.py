"""repro_torch.scene — granule-scale streaming analysis and resumable bulk jobs.

The port's counterpart of ``repro.scene``, and the offline/bulk counterpart
of :mod:`repro_torch.service`: where the service micro-batches many small
independent masks, this package takes scenes too large for one device
call, windows them into overlap-free tile rows (:class:`GranuleReader`),
streams tile stacks through a :class:`repro_torch.engine.Engine`, and
stitches per-tile outputs into a whole-scene result **bit-identical** to
analysing the unsplit scene (:class:`SceneRunner`). :class:`BulkJob` runs
a manifest of granules as a resumable batch job: progress is checkpointed
via :class:`repro_torch.checkpoint.Checkpointer`, and a job killed mid-scene
resumes from the last completed tile row with byte-identical output.
"""

from repro_torch.scene.bulk import BulkJob, BulkJobConfig, BulkJobReport
from repro_torch.scene.granule import (
    GranuleReader,
    GranuleSpec,
    manifest_from_json,
    manifest_to_json,
    synthetic_manifest,
)
from repro_torch.scene.result import (
    SceneResult,
    read_scene_result,
    write_scene_result,
)
from repro_torch.scene.runner import (
    SceneProgress,
    SceneProgressSnapshot,
    SceneRunner,
    SceneState,
    seam_joins,
    stitch_tile_runs,
)

__all__ = [
    "BulkJob",
    "BulkJobConfig",
    "BulkJobReport",
    "GranuleReader",
    "GranuleSpec",
    "SceneProgress",
    "SceneProgressSnapshot",
    "SceneResult",
    "SceneRunner",
    "SceneState",
    "manifest_from_json",
    "manifest_to_json",
    "read_scene_result",
    "seam_joins",
    "stitch_tile_runs",
    "synthetic_manifest",
    "write_scene_result",
]
