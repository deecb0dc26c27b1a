"""The check fails what it must: the control in the program's place, and
the program with a fault planted under the timed path.

The control is the reference bent as the configuration says: on every
other row for the service (half of the bytes, which a later change could
be tempted to skip), without the seam correction between strips for the
bulk job. The faults are those a cell
can have: an answer altered where it is produced, half of a batch left
out, and, in a bulk job, the stitch's state left unchanged by a step.
"""

import math

import numpy as np
import pytest

pytest.importorskip("torch")

from bench import harness  # noqa: E402
from bench.tests.small import SECONDS, small  # noqa: E402

SERVE = ["serve8k.open", "serve8k.closed"]
BULK = ["scene21k.bulk"]
SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
# sizes at which every other row already misses runs; the bulk cells'
# control drops the seams of their small strips
CONTROL = {
    "serve8k.open": {"workload": {"params": {"res": 120}}},
    "serve8k.closed": {"workload": {"params": {"res": 120}}},
    "scene21k.bulk": {"config": {"control": {"strip_h": 32}}},
}
FIELDS = ("runs", "cut_vertices", "transitions", "births", "deaths",
          "n_hyperedges", "n_transitions")


def _run(cell, overrides=None):
    over = harness.deep_merge(small(cell), overrides or {})
    return harness.run_cell(cell, 2**35 + 3, SECONDS, False, device="cpu",
                            overrides=over, spec=SPEC)


@pytest.mark.parametrize("cell", SERVE + BULK)
def test_the_control_is_not_correct(cell):
    over = harness.deep_merge(small(cell), CONTROL[cell])
    line = harness.run_cell(cell, 2**35 + 3, SECONDS, False, device="cpu",
                            overrides=over, control=True, spec=SPEC)
    assert not line["correct"]
    assert line["checks"]["wrong_elements"]["value"] > 0
    assert line["checks"]["unanswered"]["value"] == 0


def _altered(inner):
    def analyze_batch(self, stack, **kw):
        res = inner(self, stack, **kw)
        res.runs[0, 0] += 1
        return res
    return analyze_batch


def _half_left_out(inner):
    def analyze_batch(self, stack, **kw):
        res = inner(self, stack, **kw)
        keep = res.runs.shape[0] // 2   # the last ceil(B / 2) rows go
        for f in FIELDS:
            getattr(res, f)[keep:] = 0
        return res
    return analyze_batch


FAULTS = {"altered": _altered, "half_left_out": _half_left_out}


@pytest.mark.parametrize("cell", SERVE + BULK)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_caught(cell, fault, monkeypatch):
    from repro_torch.engine import Engine

    monkeypatch.setattr(Engine, "analyze_batch",
                        FAULTS[fault](Engine.analyze_batch))
    line = _run(cell)
    assert not line["correct"]
    assert line["checks"]["wrong_elements"]["value"] > 0


@pytest.mark.parametrize("cell", BULK)
def test_a_step_that_leaves_the_stitch_unchanged_is_caught(cell,
                                                           monkeypatch):
    from repro_torch.scene import SceneRunner

    def update(self, state, stack, runs_b):
        state.prev_bottom = (np.asarray(stack)[-1, -1] != 0).astype(np.uint8)
        state.next_tile += np.asarray(stack).shape[0]
        return state

    monkeypatch.setattr(SceneRunner, "update", update)
    line = _run(cell)
    assert not line["correct"]
    assert line["checks"]["wrong_elements"]["value"] > 0


def test_an_answer_that_never_comes_is_caught(monkeypatch):
    from repro_torch.service import YCHGService

    def failing(self, mask, **kw):
        raise RuntimeError("refused")

    monkeypatch.setattr(YCHGService, "submit", failing)
    line = _run("serve8k.open")
    assert not line["correct"]
    assert line["checks"]["unanswered"]["value"] == line["attempted"]
    assert "latency_p50_ms" not in line["metrics"]
    assert math.isfinite(line["metrics"]["setup_s"]["value"])
