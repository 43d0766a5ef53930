"""The stencil layer's fused pair on the CPU: the wrapper, its
refusals, the traced s = 3 iteration's spans and the benchmark's reader
of the pair count.

An odd chain of three or more applications whose last two ops are
radius-(1, 1, 1) boxes ends in one call of
:func:`~repro_torch.kernels.ops.stencil_window_pair`, which reads the
scratch and writes the state, so no window is spliced.  On the CPU the
pair is the two plain updates in turn and launches nothing.  The chains'
dispatch and the whole state they leave are held in
``tests/test_torch_program.py`` (``SCRATCH_CASES``);
``tests/test_torch_stencil_cuda.py`` holds the kernel to its two launches
and to the plain updates on the card.
"""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from repro_torch.comm import Communicator
from repro_torch.halo import STENCIL26, HaloSpec, StencilOp, build_halo_program
from repro_torch.halo.stencil import _view
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.ops import stencil_window_pair, stencil_window_update
from repro_torch.obs import Tracer
from repro_torch.obs.export import to_chrome_trace, validate

ROOT = Path(__file__).resolve().parents[1]
WIDE = StencilOp((2, 1, 1), 0.3)


def _state(spec, seed=3):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((8,) + spec.alloc, generator=gen)


@pytest.mark.parametrize("out", ["new", "view"])
def test_the_pair_on_the_cpu_is_the_two_updates_in_turn(out):
    arr = _state(HaloSpec(grid=(2, 2, 2), interior=(7, 8, 9), radius=1))
    origin, shape = (2, 1, 3), (5, 6, 4)
    grown = (tuple(o - 1 for o in origin), tuple(n + 2 for n in shape))
    want = stencil_window_update(arr, STENCIL26.offsets, 0.4, origin, shape, copy_rim=True)
    inner = stencil_window_update(want, STENCIL26.offsets, 0.25, (2, 2, 2), (3, 4, 2))
    want[..., 2:5, 2:6, 2:4] = inner
    dest = torch.full_like(arr, float("nan"))
    reset_launch_counts()
    got = stencil_window_pair(arr, STENCIL26.offsets, (0.4, 0.25), origin, shape,
                              out=_view(dest, *grown) if out == "view" else None)
    assert torch.equal(got, want)
    assert launch_counts()["stencil_pairs"] == 0  # the CPU launches nothing
    if out == "view":  # nothing outside the grown window is written
        assert torch.isnan(dest).sum() == dest.numel() - got.numel()


def test_the_pair_refuses_other_boxes_and_an_empty_second_window():
    arr = torch.zeros((1, 8, 8, 8))
    with pytest.raises(ValueError, match="radius-"):
        stencil_window_pair(arr, WIDE.offsets, (0.4, 0.4), (2, 2, 2), (4, 4, 4))
    with pytest.raises(ValueError, match="no cell"):
        stencil_window_pair(arr, STENCIL26.offsets, (0.4, 0.4), (2, 2, 2), (4, 2, 4))


def test_an_s3_traced_iteration_has_two_stencil_spans_the_last_holding_two():
    tr = Tracer()
    comm = Communicator(device="cpu", tracer=tr)
    prog = build_halo_program((2, 2, 2), (6, 6, 6), comm, steps=3)
    x = _state(prog.spec)
    plain = x.clone()
    tr.clear()
    prog.iteration(x, comm)
    stencil = [s for s in tr.spans if s.name == "stencil"]
    assert [s.attrs["application"] for s in stencil] == [0, 1]
    assert "applications" not in stencil[0].attrs and stencil[1].attrs["applications"] == 2
    assert sum(s.attrs.get("pred", 0.0) for s in stencil) == pytest.approx(
        stencil[0].attrs["pred"] * 3)
    assert validate(to_chrome_trace(tr)) == []
    untraced = Communicator(device="cpu")
    prog.iteration(plain, untraced)
    assert torch.equal(x, plain)


def _reader():
    path = ROOT / "bench" / "metrics" / "stencil_pairs_per_iteration.py"
    spec = importlib.util.spec_from_file_location("stencil_pairs_per_iteration", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _ctx(before, after, calls=4):
    return SimpleNamespace(counters_before={"launches": before},
                           counters_after={"launches": after},
                           profile={"stats": {"calls": calls}})


def test_the_benchmark_reads_pairs_per_iteration():
    read = _reader()
    assert read(_ctx({"stencil_pairs": 2}, {"stencil_pairs": 6})) == 1.0
    assert read(_ctx({"stencil_pairs": 5}, {"stencil_pairs": 5})) == 0.0
    assert read(_ctx({"stencil": 1}, {"stencil": 9})) is None  # a program without the count
    assert read(_ctx({"stencil_pairs": 0}, {"stencil_pairs": 0}, calls=0)) is None
