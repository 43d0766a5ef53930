"""The ``stencil26.iterate.auto`` cell and the ``overlap`` loop on the
CPU: the auto configuration's program picks a depth; the ``overlap``
loop ends where the ``iterate`` loop does after the same calls, passes
the iterate cell's comparison and fails it under ``stale_halo``; and the
readers of ``splice_per_iteration`` and ``stencil_runtime_launches``
read the program's counts (None where the program has none)."""

import json
from contextlib import nullcontext
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from bench import run
from bench.faults import planted
from bench.loops import iterate, overlap

ROOT = Path(__file__).resolve().parents[1]
#: the overlapped iteration as ``launch/stencil3d.py --overlap`` runs it
OVERLAP = {"loop": "overlap", "overlap": "monolithic", "buffers": 1}


def _config(interior=(8, 8, 8)):
    config = json.loads((ROOT / "bench" / "configs" / "stencil26_r2_512.json").read_text())
    return dict(config, interior=list(interior))


def test_the_auto_configuration_loads_and_its_program_picks_a_depth():
    from repro_torch.comm import Communicator, policy_for_mode
    from repro_torch.halo import MAX_AUTO_STEPS, StencilOp, build_halo_program

    spec = run.load_cell("stencil26.iterate.auto")
    config = spec["config"]
    assert config["halo_steps"] == "auto" and spec["traffic"]["loop"] == "iterate"
    ops = tuple(StencilOp(tuple(o["radii"]), o["weight"]) for o in config["ops"])
    comm = Communicator(policy=policy_for_mode(config["policy"]), device="cpu")
    prog = build_halo_program(tuple(config["grid"]), tuple(config["interior"]), comm,
                              steps=config["halo_steps"], ops=ops)
    assert 1 <= prog.steps <= MAX_AUTO_STEPS
    assert prog.estimate == min(prog.candidates, key=lambda c: c.per_step)


def test_the_overlap_loop_ends_where_the_iterate_loop_does():
    config, seed = _config(), 2**31 + 29
    systems = [loop.build(config, OVERLAP, "cpu", seed) for loop in (iterate, overlap)]
    for system in systems:
        for _ in range(3):
            system.step()
    plain, hidden = systems
    assert hidden.steps == plain.steps == 2 and hidden.calls == plain.calls == 3
    assert torch.equal(hidden.output(), plain.output())
    assert not torch.equal(plain.output(), iterate.build(config, OVERLAP, "cpu", seed).output())


@pytest.mark.parametrize("fault", [None, "stale_halo"])
def test_the_overlap_loop_against_the_iterate_cells_comparison(fault):
    """The comparison an overlap cell would be judged by (the iterate
    cell's limit): a sound run passes it, a stale halo on the side
    stream's exchange fails it."""
    limit = run.load_cell("stencil26.iterate")["limits"]["max_rel_err"]
    seed = 2**31 + 3
    system = overlap.build(_config((6, 6, 6)), OVERLAP, "cpu", seed)
    with planted(fault) if fault else nullcontext():
        for _ in range(8):
            system.step()
    err = overlap.judge(system, system.release(), seed)["max_rel_err"]
    assert (err > limit) == (fault is not None), err


def _ctx(before, after, calls=4):
    return SimpleNamespace(counters_before={"launches": before},
                           counters_after={"launches": after},
                           profile={"stats": {"calls": calls}})


@pytest.mark.parametrize("metric,key", [("splice_per_iteration", "splice_copies"),
                                        ("stencil_runtime_launches", "stencil_runtime")])
def test_the_count_readers(metric, key):
    read = run._reader(metric)
    assert read(_ctx({key: 3, "stencil": 10}, {key: 7, "stencil": 22})) == 1.0
    assert read(_ctx({key: 5}, {key: 5})) == 0.0
    assert read(_ctx({"stencil": 10}, {"stencil": 22})) is None  # a program without the count
    assert read(_ctx({key: 0}, {key: 0}, calls=0)) is None
