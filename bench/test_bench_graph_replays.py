"""The ``graph_replays_per_call`` reader on hand-made contexts: the
program's ``graph_replays`` count over the profiled window, per call;
None where the program does not count replays (a program without CUDA
graphs) or the window made no call.  On the card, the exchange cell at a
small size replays every timed call, and each fault of
:mod:`bench.faults` planted under it still turns ``correct`` false."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from bench import run
from bench.faults import FAULTS, planted

ROOT = Path(__file__).resolve().parents[1]
#: each reader: the end-to-end metric it moves and the cells it lists
READERS = {"graph_replays_per_call": ("exchange_ms", ["stencil26.exchange"])}


def _ctx(before, after, calls=200):
    return SimpleNamespace(counters_before={"launches": before},
                           counters_after={"launches": after},
                           profile={"stats": {"calls": calls}})


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("replays,want", [(200, 1.0), (0, 0.0), (50, 0.25)])
def test_replays_per_call_of_the_window(name, replays, want):
    before = {"pack_rows": 40, "graph_captures": 2, "graph_replays": 3}
    after = {"pack_rows": 40, "graph_captures": 2, "graph_replays": 3 + replays}
    assert run._reader(name)(_ctx(before, after)) == want


@pytest.mark.parametrize("name", READERS)
def test_none_without_the_count_or_without_calls(name):
    read = run._reader(name)
    assert read(_ctx({"pack_rows": 0}, {"pack_rows": 16})) is None
    assert read(_ctx({"graph_replays": 0}, {"graph_replays": 0}, calls=0)) is None


@pytest.mark.parametrize("name", READERS)
def test_the_metrics_are_program_counters_of_the_communicator(name):
    entries = {m["name"]: m for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]}
    moves, cells = READERS[name]
    assert entries[name] == {
        "name": name, "unit": "replays", "better": "higher", "source": "program_counter",
        "layer": "communicator", "moves": moves, "workloads": cells}


SMALL = {"config": {"interior": [16, 16, 16]}}


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the exchange is captured into a CUDA graph only there")


@pytest.mark.cuda
def test_the_exchange_cell_replays_every_timed_call_on_the_card():
    _card()
    line = run.run_cell("stencil26.exchange", 2**31 + 5, 0.3, True, overrides=SMALL)
    assert line["correct"] is True, line["checks"]
    assert line["metrics"]["graph_replays_per_call"]["value"] == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("fault", FAULTS)
def test_a_fault_under_the_replayed_exchange_makes_the_run_incorrect(fault):
    _card()
    with planted(fault):
        line = run.run_cell("stencil26.exchange", 2**31 + 7, 0.3, False, overrides=SMALL)
    assert line["correct"] is False, line["checks"]
