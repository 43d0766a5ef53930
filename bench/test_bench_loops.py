"""Each loop of ``bench/loops/`` brings every part a cell runs: ``build``,
``window``, ``end_to_end``, ``judge`` and ``control``.  A loop's control
returns the numbers its judge compares, the ``overlap`` loop's is the
``iterate`` loop's, and ``bench/control.py``'s numbers for the cells that
were there before the loops brought their controls are those it gave
then, bit for bit."""

import importlib
import json
from pathlib import Path

import pytest

from bench import run
from bench.control import CONTROLS, control_numbers
from bench.loops import iterate, overlap

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
LOOPS = sorted(p.stem for p in (ROOT / "bench" / "loops").glob("*.py") if p.stem != "__init__")
#: the first cell of each loop
CELL_OF = {}
for _w in BENCH["workloads"]:
    CELL_OF.setdefault(run.load_cell(_w["name"])["traffic"]["loop"], _w["name"])
#: ``control_numbers`` at interior (8, 8, 8), seed 1, 40 passes, before
#: the controls moved into the loops
PINNED = {
    ("stencil26.iterate", "bf16"): {"max_rel_err": 0.06635760452990945},
    ("stencil26.iterate", "bf16_state"): {"max_rel_err": 0.01023352008096685},
    ("stencil26.iterate.auto", "bf16"): {"max_rel_err": 0.06635760452990945},
    ("stencil26.iterate.auto", "bf16_state"): {"max_rel_err": 0.01023352008096685},
    ("stencil26.exchange", "bf16"): {"mismatched_cells": 27644},
    ("stencil26.exchange", "bf16_state"): {"mismatched_cells": 27644},
}


@pytest.mark.parametrize("loop", LOOPS)
def test_every_loop_brings_its_parts(loop):
    mod = importlib.import_module(f"bench.loops.{loop}")
    for part in ("build", "window", "end_to_end", "judge", "control"):
        assert callable(getattr(mod, part, None)), (loop, part)
    assert loop in CELL_OF, f"no cell runs the {loop} loop"


@pytest.mark.parametrize("loop", LOOPS)
@pytest.mark.parametrize("control", sorted(CONTROLS))
def test_a_loops_control_gives_its_judges_numbers(loop, control):
    spec = run.load_cell(CELL_OF[loop])
    config, traffic, seed = dict(spec["config"], interior=[6, 6, 6]), spec["traffic"], 2**31 + 5
    mod = importlib.import_module(f"bench.loops.{loop}")
    system = mod.build(config, traffic, "cpu", seed)
    for _ in range(2):
        system.step()
    judged = mod.judge(system, system.release(), seed)
    numbers = mod.control(config, traffic, seed, system.calls * system.steps, "cpu", control)
    assert set(numbers) == set(judged) == set(spec["limits"])


@pytest.mark.parametrize("control", sorted(CONTROLS))
def test_the_overlap_control_is_the_iterate_control(control):
    spec = run.load_cell("stencil26.iterate")
    config = dict(spec["config"], interior=[8, 8, 8])
    traffic = run.load_cell("stencil26.overlap")["traffic"]
    assert overlap.control(config, traffic, 7, 40, "cpu", control) == \
        iterate.control(config, spec["traffic"], 7, 40, "cpu", control)


@pytest.mark.parametrize("cell,control", sorted(PINNED))
def test_control_numbers_as_before(cell, control):
    spec = run.load_cell(cell)
    config = dict(spec["config"], interior=[8, 8, 8])
    assert control_numbers(config, spec["traffic"]["loop"], 1, 40, "cpu", control,
                           spec["traffic"]["buffers"]) == PINNED[cell, control]
