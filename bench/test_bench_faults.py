"""The comparison catches a broken timed path: each fault a halo cell can
have (:mod:`bench.faults`), planted under a whole run of the cell (on the
CPU at a tiny size, past the harness's look for a card), turns
``correct`` false."""

import json
from pathlib import Path

import pytest

from bench import run
from bench.faults import FAULTS, planted
from bench.system import System

ROOT = Path(__file__).resolve().parents[1]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
TINY = {"config": {"interior": [6, 6, 6]}}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", FAULTS)
def test_fault_makes_the_run_incorrect(cell, fault):
    with planted(fault):
        line = run.run_cell(cell, 2**31 + 3, 0.1, False, device="cpu", overrides=TINY)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    line = run.run_cell(cell, 2**31 + 3, 0.1, False, device="cpu", overrides=TINY)
    assert line["correct"] is True, line["checks"]


def test_a_planted_fault_is_taken_out_again():
    step = System.__dict__["step"]
    with pytest.raises(RuntimeError), planted("unchanged"):
        assert System.__dict__["step"] is not step
        raise RuntimeError
    assert System.__dict__["step"] is step
    with pytest.raises(ValueError):
        with planted("no such fault"):
            pass
