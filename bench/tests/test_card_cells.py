"""On a CUDA card: every cell at its own sizes, once as the program and
once with the control in its place, over a short window.

    PYTHONPATH=src python -m pytest -q -m card bench/tests

Skips where no card is visible.
"""

import pytest

from bench import harness

CELLS = [w["name"] for w in
         harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_cell_is_correct_and_its_control_is_not(cell, card):
    line = harness.run_cell(cell, 2**34 + 77, 3.0, False)
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    control = harness.run_cell(cell, 2**34 + 77, 3.0, False, control=True)
    assert not control["correct"]
    assert control["checks"]["wrong_elements"]["value"] > 0
