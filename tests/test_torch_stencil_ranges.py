"""The stencil layer's profiler ranges and the model's depth pick at the
benchmark's auto cell, on the CPU.

* An odd chain of applications (:func:`stencil_cycle`) that does not
  end in the fused pair opens one ``tempi.splice`` range around its
  closing copy; an even chain, or one that ends in the pair, opens none.
  Every chain opens one ``tempi.stencil`` per launch: one per
  application, the pair's two in one.
* The overlapped iteration opens ``tempi.interior`` around the interior
  chain and one ``tempi.shell`` per application around a chain block.
* ``build_halo_program(steps="auto")`` with the default tables picks
  s = 3 for 8 ranks of 512^3 (the ``stencil26_auto_512`` deployment) and
  records the three candidates it priced.

The ranges are counted by standing a recorder in for
:func:`repro_torch.obs.trace.region` where the halo layer calls it.
"""

from contextlib import nullcontext

import pytest

torch = pytest.importorskip("torch")

import repro_torch.halo.stencil as st
from repro_torch.comm import Communicator, policy_for_mode
from repro_torch.halo import (
    MAX_AUTO_STEPS,
    STENCIL26,
    HaloSpec,
    StencilOp,
    build_halo_program,
    cycle_halo_radii,
    op_sequence,
    overlapped_stencil_iteration,
)
from repro_torch.kernels import launch_counts, reset_launch_counts


@pytest.fixture
def ranges(monkeypatch):
    """The names of the ranges the halo layer opens, in order."""
    opened = []

    def region(name):
        opened.append(name)
        return nullcontext()

    monkeypatch.setattr(st, "region", region)
    return opened


def _state(spec, seed=3):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((8,) + spec.alloc, generator=gen)


@pytest.mark.parametrize("ops,steps", [((STENCIL26,), 1), ((STENCIL26,), 2), ((STENCIL26,), 3),
                                       ((STENCIL26,), 4), ((StencilOp((2, 1, 1)), STENCIL26), 1)])
def test_only_an_odd_chain_opens_a_splice_range(ranges, monkeypatch, ops, steps):
    spec = HaloSpec(grid=(2, 2, 2), interior=(7, 6, 9), radius=cycle_halo_radii(ops, steps))
    state = _state(spec)
    pairs, pair = [], st.stencil_window_pair

    def counted_pair(*args, **kw):
        pairs.append(args)
        return pair(*args, **kw)

    monkeypatch.setattr(st, "stencil_window_pair", counted_pair)
    reset_launch_counts()
    st.stencil_cycle(state, spec, ops, steps)
    napp = len(op_sequence(ops, steps))
    paired = napp >= 3 and napp % 2 == 1  # the chains of three or more here end in radius-1 boxes
    assert ranges.count("stencil") == napp - paired
    assert ranges.count("splice") == napp % 2 - paired
    if napp % 2 and not paired:  # the copy closes the last application's range
        assert ranges[-2:] == ["stencil", "splice"]
    assert launch_counts()["splice_copies"] == napp % 2 - paired
    assert len(pairs) == paired
    counts = launch_counts()  # the CPU runs no kernel
    assert counts["stencil_pairs"] == counts["stencil_runtime"] == 0


@pytest.mark.parametrize("mode", ["monolithic", "region"])
def test_the_overlapped_iteration_opens_interior_and_shell_ranges(ranges, mode):
    spec = HaloSpec(grid=(2, 2, 2), interior=(6, 6, 6), radius=2)
    comm = Communicator(device="cpu")
    reset_launch_counts()
    overlapped_stencil_iteration(_state(spec), spec, comm, steps=2, mode=mode)
    # monolithic: a shell around both chain blocks; region: the first
    # application's rims as their classes land, then one shell
    shells = 2 if mode == "monolithic" else 1
    assert ranges == ["interior"] + ["shell"] * shells
    assert launch_counts()["splice_copies"] == 0


def test_the_default_tables_pick_three_at_the_auto_cells_shape():
    comm = Communicator(policy=policy_for_mode("tempi"), device="cpu")
    prog = build_halo_program((2, 2, 2), (512,) * 3, comm, steps="auto")
    assert [c.steps for c in prog.candidates] == [1, 2, 3] and MAX_AUTO_STEPS == 3
    prices = [c.per_step for c in prog.candidates]
    assert prices == sorted(prices, reverse=True)  # each depth priced below the last
    assert prices == pytest.approx([2.4586e-4, 2.0650e-4, 1.8125e-4], rel=1e-3)
    assert prog.steps == 3 and prog.spec.radii == (3, 3, 3) and not prog.pinned
    assert prog.plan.wire.wire_bytes == 19_096_416
