"""The control of the check, the reference with injectivity dropped put
in the program's place, comes out not correct; sound runs come out
correct; and on a card, a run of each cell at a test's size."""
from pathlib import Path

import numpy as np
import pytest

from bench import harness
from bench.control import control_run

ROOT = Path(__file__).resolve().parent.parent.parent


@pytest.mark.parametrize("name", ["lubm1.replay", "lubm1.fresh"])
@pytest.mark.parametrize("seed", [11, 12, 2**33 + 1])
def test_control_is_not_correct(tiny_cell, name, seed):
    out = control_run(tiny_cell(name), seed, 200)
    assert out["checked"] > 0
    assert out["mismatched_answers"] > 0


def test_sound_runs_are_correct_on_many_seeds(tiny_cell):
    for seed in (1, 2, 3, 2**31 + 5):
        out = harness.run_cell(ROOT, "lubm1.fresh", seed, 0.5, False,
                               device="cpu", cell=tiny_cell("lubm1.fresh"))
        assert out["correct"] is True, out["notes"]
    assert np.isfinite(out["metrics"]["qps"]["value"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lubm1.replay", "lubm1.fresh"])
def test_cell_on_the_card_is_correct(cuda_card, tiny_cell, name):
    out = harness.run_cell(ROOT, name, 31, 2.0, True, cell=tiny_cell(name))
    assert out["correct"] is True, out["notes"]
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0
