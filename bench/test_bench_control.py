"""The comparison's controls at a size a test run holds: the reference in
the program's place, with the state in bfloat16 (one precision below the
configuration's float32) and its factors in bfloat16 or float32, fails
each cell's limits."""

import json
from pathlib import Path

import pytest

from bench import run
from bench.control import CONTROLS, control_numbers

ROOT = Path(__file__).resolve().parents[1]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("control", sorted(CONTROLS))
@pytest.mark.parametrize("seed", [1, 2**31 + 7])
def test_control_fails_the_limits(cell, control, seed):
    spec = run.load_cell(cell)
    config = dict(spec["config"], interior=[8, 8, 8])
    numbers = control_numbers(config, spec["traffic"]["loop"], seed, 40, "cpu", control,
                              spec["traffic"]["buffers"])
    assert any(numbers[k] > limit for k, limit in spec["limits"].items()), numbers
