"""The stencil kernel (``kernels/csrc/stencil.cu``) on the card, held bit
for bit to its plain torch version run on the same card.

These tests import only torch and the port, carry the ``cuda`` marker
and skip with a reason where there is no card.  Run them there with::

    PYTHONPATH=src python -m pytest tests/test_torch_stencil_cuda.py -m cuda -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.comm import Communicator
from repro_torch.halo import (
    STENCIL26,
    HaloSpec,
    StencilOp,
    build_halo_program,
    cycle_halo_radii,
    from_reference,
    halo_exchange,
    make_halo_plan,
    op_sequence,
    overlapped_stencil_iteration,
    stencil_cycle,
)
import repro_torch.halo.stencil as st
from repro_torch.halo.stencil import _put, _shell_slabs, _view, _window_of
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.ops import (
    stencil_window_pair,
    stencil_window_plain,
    stencil_window_update,
)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _randn(shape, dev, seed=3, dtype=torch.float32):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev, dtype=dtype)


def _plain_cycle(local, spec, ops, repeats):
    """Application by application, each computed by the plain version
    and copied into ``local``: the schedule the scratch chain replaces."""
    valid = spec.radii
    for o in op_sequence(ops, repeats):
        origin, shape = _window_of(spec, valid, o)
        _put(local, origin, stencil_window_plain(local, o.offsets, o.weight, origin, shape))
        valid = tuple(v - r for v, r in zip(valid, o.radii))
    return local


def _unfused_cycle(local, spec, ops, repeats):
    """The scratch chain as separate launches: application by
    application alternating between ``local`` and a scratch, an odd
    chain closed by a splice copy.  What the fused pair replaces."""
    seq = op_sequence(ops, repeats)
    windows, valid = [], spec.radii
    for o in seq:
        windows.append(_window_of(spec, valid, o))
        valid = tuple(v - r for v, r in zip(valid, o.radii))
    scratch = torch.empty_like(local)
    for i, (o, (origin, shape)) in enumerate(zip(seq, windows)):
        if i % 2 == 0:
            stencil_window_update(local, o.offsets, o.weight, origin, shape,
                                  out=_view(scratch, origin, shape))
        else:
            stencil_window_update(scratch, o.offsets, o.weight, origin, shape,
                                  out=_view(local, *windows[i - 1]), copy_rim=True)
    if len(seq) % 2:
        _put(local, windows[-1][0], _view(scratch, *windows[-1]))
    return local


def _two_launches(arr, weights, origin, shape, out):
    """What the fused pair replaces: the first update with its rim
    copied into ``out``, the second from ``out`` into a window of its own,
    copied back."""
    inner = tuple(n - 2 for n in shape)
    stencil_window_update(arr, STENCIL26.offsets, weights[0], origin, shape, out=out,
                          copy_rim=True)
    _view(out, (2, 2, 2), inner).copy_(
        stencil_window_update(out, STENCIL26.offsets, weights[1], (2, 2, 2), inner))
    return out


def _both(arr, op, origin, shape):
    got = stencil_window_update(arr, op.offsets, op.weight, origin, shape)
    want = stencil_window_plain(arr, op.offsets, op.weight, origin, shape)
    torch.cuda.synchronize()
    return got, want


def _check_copied_rim(arr, op, origin, shape):
    """The window grown by the radii, its rim copied from ``arr``: equal
    to ``arr``'s cells there and to the plain update inside."""
    r = op.radii
    lo = tuple(o - x for o, x in zip(origin, r))
    got = stencil_window_update(arr, op.offsets, op.weight, origin, shape, copy_rim=True)
    want = arr[..., lo[0]:lo[0] + shape[0] + 2 * r[0], lo[1]:lo[1] + shape[1] + 2 * r[1],
               lo[2]:lo[2] + shape[2] + 2 * r[2]].clone()
    want[..., r[0]:r[0] + shape[0], r[1]:r[1] + shape[1], r[2]:r[2] + shape[2]] = \
        stencil_window_plain(arr, op.offsets, op.weight, origin, shape)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (op.radii, origin, shape)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 36, 36, 36), (3, 23, 19, 37)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_26_point_update_equals_the_plain_version(shape, dtype):
    dev = _card()
    arr = _randn(shape, dev, dtype=dtype)
    dims = shape[-3:]
    for r in (1, 2, 3, 5):  # windows at every 16-byte phase of the rows
        origin = (r, r, r)
        win = tuple(n - 2 * r for n in dims)
        got, want = _both(arr, STENCIL26, origin, win)
        assert got.shape == want.shape and torch.equal(got, want), (r, dtype)
        _check_copied_rim(arr, STENCIL26, origin, win)


@pytest.mark.cuda
@pytest.mark.parametrize("radii", [(2, 1, 1), (1, 2, 3), (3, 3, 3)])
def test_other_radii_take_the_runtime_path_and_equal_the_plain_version(radii):
    dev = _card()
    op = StencilOp(radii, 0.3)
    arr = _randn((4, 21, 26, 45), dev)
    origin = radii
    win = tuple(n - 2 * r for n, r in zip(arr.shape[-3:], radii))
    got, want = _both(arr, op, origin, win)
    assert torch.equal(got, want)
    _check_copied_rim(arr, op, origin, win)
    out = torch.empty((4, 30, 30, 60), device=dev)  # a strided destination
    o = out[..., 2:2 + win[0], 1:1 + win[1], 3:3 + win[2]]
    assert stencil_window_update(arr, op.offsets, op.weight, origin, win, out=o) is o
    torch.cuda.synchronize()
    assert torch.equal(o, want)


@pytest.mark.cuda
@pytest.mark.parametrize("ops,steps", [((STENCIL26,), 1), ((STENCIL26,), 2), ((STENCIL26,), 3),
                                       ((StencilOp((2, 1, 1)), StencilOp((1, 2, 3), 0.3)), 2)])
def test_scratch_cycle_equals_the_plain_applications_halos_included(ops, steps):
    dev = _card()
    spec = HaloSpec(grid=(2, 2, 2), interior=(20, 17, 35), radius=cycle_halo_radii(ops, steps))
    start = _randn((8,) + spec.alloc, dev, seed=7)
    want = _plain_cycle(start.clone(), spec, ops, steps)
    reset_launch_counts()
    splices = st.splice_copies
    got = stencil_cycle(start.clone(), spec, ops, steps)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    napp = steps * len(ops)
    paired = napp >= 3 and napp % 2 == 1  # every op here ends a chain of radius-1 boxes
    assert launch_counts()["stencil"] == napp - 2 * paired
    assert launch_counts()["stencil_pairs"] == paired
    assert st.splice_copies - splices == napp % 2 - paired


@pytest.mark.cuda
@pytest.mark.parametrize("ops,steps", [((STENCIL26,), 2), ((STENCIL26,), 3),
                                       ((StencilOp((2, 1, 1)), STENCIL26), 1),
                                       ((StencilOp((2, 1, 1)),), 1)])
def test_runtime_launches_and_splice_copies_count_only_their_own(ops, steps):
    """``launch_counts()``: ``stencil_runtime`` rises by the launches of
    radii other than (1, 1, 1) (windows wide enough for the fast path
    take it), ``stencil_pairs`` by one on an odd chain of three or more
    radius-1 boxes, ``splice_copies`` by one on any other odd chain."""
    dev = _card()
    spec = HaloSpec(grid=(2, 2, 2), interior=(20, 17, 35), radius=cycle_halo_radii(ops, steps))
    state = _randn((8,) + spec.alloc, dev, seed=5)
    torch.cuda.synchronize()
    reset_launch_counts()
    stencil_cycle(state, spec, ops, steps)
    torch.cuda.synchronize()
    seq = op_sequence(ops, steps)
    paired = len(seq) >= 3 and len(seq) % 2 == 1 and all(o.radii == (1, 1, 1) for o in seq[-2:])
    counts = launch_counts()
    assert counts["stencil"] == len(seq) - 2 * paired
    assert counts["stencil_pairs"] == paired
    assert counts["stencil_runtime"] == sum(o.radii != (1, 1, 1) for o in seq)
    assert counts["splice_copies"] == len(seq) % 2 - paired


@pytest.mark.cuda
def test_one_cell_thick_shell_slabs_equal_the_plain_version():
    dev = _card()
    arr = _randn((8, 22, 20, 26), dev, seed=9)
    origin, shape = (1, 1, 1), (20, 18, 24)
    inner_origin, inner_shape = (2, 2, 2), (18, 16, 22)
    slabs = _shell_slabs(origin, shape, inner_origin, inner_shape)
    assert len(slabs) == 6 and all(1 in s for _, s in slabs)
    for o, s in slabs:
        got, want = _both(arr, STENCIL26, o, s)
        assert torch.equal(got, want), (o, s)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["monolithic", "region"])
def test_overlapped_iterations_equal_exchange_and_cycle(mode):
    dev = _card()
    spec = HaloSpec(grid=(2, 2, 2), interior=(18, 13, 21), radius=2)
    comm = Communicator(device=dev)
    plan = make_halo_plan(spec, comm)
    start = np.random.default_rng(4).normal(size=(8,) + spec.alloc).astype(np.float32)
    want = from_reference(start, spec, device=dev)
    got = want.clone()
    for _ in range(2):
        _plain_cycle(halo_exchange(want, spec, comm, plan=plan), spec, (STENCIL26,), 2)
        overlapped_stencil_iteration(got, spec, comm, steps=2, plan=plan, mode=mode)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_a_window_whose_offsets_pass_2_to_the_31_bytes():
    dev = _card()
    arr = _randn((1, 520, 1024, 1032), dev, seed=2)  # 2.2 GB, the last plane past 2^31
    origin, shape = (1, 1, 1), (518, 1022, 1030)
    got, want = _both(arr, STENCIL26, origin, shape)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_the_benchmark_shape_two_applications_launch_twice_and_copy_no_window():
    """The iterate cell's state, 8 x 512^3 float32 at halo depth 2: the
    s = 2 cycle launches the kernel twice, pays no splice copy, and leaves
    the whole tensor, halos included, as the plain applications do."""
    dev = _card()
    spec = HaloSpec(grid=(2, 2, 2), interior=(512, 512, 512), radius=2)
    state = _randn((8,) + spec.alloc, dev, seed=31)
    want = _plain_cycle(state.clone(), spec, (STENCIL26,), 2)
    torch.cuda.synchronize()
    reset_launch_counts()
    splices = st.splice_copies
    stencil_cycle(state, spec, STENCIL26, 2)
    torch.cuda.synchronize()
    assert launch_counts()["stencil"] == 2
    assert st.splice_copies == splices
    assert torch.equal(state, want)


@pytest.mark.cuda
@pytest.mark.parametrize("pitch", [518, 516, 37])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("window", ["full", "narrow"])
@pytest.mark.parametrize("batch", [1, 8])
def test_the_fused_pair_equals_its_two_launches(pitch, dtype, window, batch):
    """At the auto cell's 518-element row pitch (row starts at two 16-byte
    phases in turn), an aligned pitch and an odd one: the pair's whole
    destination, its copied rim included, carries the bits of the two
    launches it replaces and of the two plain updates, written into a
    view of a state as the chain writes it or into a new tensor."""
    dev = _card()
    arr = _randn((batch, 11, 9, pitch), dev, seed=pitch, dtype=dtype)
    if window == "full":  # the first update's window grown by one is the whole block
        origin, shape = (1, 1, 1), (9, 7, pitch - 2)
    else:  # a narrow window at an odd offset
        origin, shape = (2, 3, 5), (5, 3, 7)
    grown = (tuple(o - 1 for o in origin), tuple(n + 2 for n in shape))
    weights = (0.4, 0.3)
    want = _two_launches(arr, weights, origin, shape, _view(arr.clone(), *grown).clone())
    inner = tuple(n - 2 for n in shape)
    plain = _view(arr, *grown).clone()
    _view(plain, (1, 1, 1), shape).copy_(
        stencil_window_plain(arr, STENCIL26.offsets, weights[0], origin, shape))
    _view(plain, (2, 2, 2), inner).copy_(
        stencil_window_plain(plain, STENCIL26.offsets, weights[1], (2, 2, 2), inner))
    state = _randn(arr.shape, dev, seed=2, dtype=dtype)
    reset_launch_counts()
    got = stencil_window_pair(arr, STENCIL26.offsets, weights, origin, shape,
                              out=_view(state, *grown))
    fresh = stencil_window_pair(arr, STENCIL26.offsets, weights, origin, shape)
    torch.cuda.synchronize()
    assert torch.equal(want, plain)
    assert torch.equal(got, want) and torch.equal(fresh, want)
    assert launch_counts()["stencil_pairs"] == 2 and launch_counts()["stencil"] == 0


@pytest.mark.cuda
def test_an_s3_program_iteration_equals_the_unfused_chain():
    """A whole ``HaloProgram`` iteration at s = 3 (exchange, one launch,
    the fused pair) against the exchange, three launches and the splice
    copy, on a block whose rows have the auto cell's 518-float pitch."""
    dev = _card()
    comm = Communicator(device=dev)
    program = build_halo_program((2, 2, 2), (10, 9, 512), comm, steps=3)
    assert program.spec.alloc[-1] == 518
    start = np.random.default_rng(8).normal(size=(8,) + program.spec.alloc).astype(np.float32)
    got = from_reference(start, program.spec, device=dev)
    want = got.clone()
    reset_launch_counts()
    for _ in range(2):
        program.iteration(got, comm)
    torch.cuda.synchronize()
    counts = launch_counts()
    for _ in range(2):
        _unfused_cycle(halo_exchange(want, program.spec, comm, plan=program.plan),
                       program.spec, (STENCIL26,), 3)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert (counts["stencil"], counts["stencil_pairs"], counts["splice_copies"]) == (2, 2, 0)


@pytest.mark.cuda
def test_the_auto_cell_shape_pays_one_launch_and_one_pair():
    """The auto cell's state, 8 x 512^3 float32 at halo depth 3: the
    s = 3 cycle launches the single update once and the pair once, copies
    no window, and leaves the whole tensor, halos included, as the three
    launches and the splice copy do."""
    dev = _card()
    spec = HaloSpec(grid=(2, 2, 2), interior=(512, 512, 512), radius=3)
    state = _randn((8,) + spec.alloc, dev, seed=33)
    want = _unfused_cycle(state.clone(), spec, (STENCIL26,), 3)
    torch.cuda.synchronize()
    reset_launch_counts()
    stencil_cycle(state, spec, STENCIL26, 3)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert (counts["stencil"], counts["stencil_pairs"], counts["splice_copies"]) == (1, 1, 0)
    assert torch.equal(state, want)


@pytest.mark.cuda
def test_the_kernel_refuses_what_it_does_not_take():
    dev = _card()
    arr = _randn((2, 8, 8, 8), dev)
    win = ((1, 1, 1), (6, 6, 6))
    with pytest.raises(TypeError, match="float32 or float64"):
        stencil_window_update(arr.half(), STENCIL26.offsets, 0.4, *win)
    with pytest.raises(ValueError, match="full box"):
        stencil_window_update(arr, STENCIL26.offsets[::-1], 0.4, *win)
    with pytest.raises(ValueError, match="leaves"):
        stencil_window_update(arr, STENCIL26.offsets, 0.4, (0, 1, 1), (6, 6, 6))
    with pytest.raises(ValueError, match="overlaps"):
        stencil_window_update(arr, STENCIL26.offsets, 0.4, *win,
                              out=arr[..., 1:7, 1:7, 1:7])
    pair = ((2, 2, 2), (4, 4, 4))
    with pytest.raises(ValueError, match="radius-"):
        stencil_window_pair(arr, StencilOp((2, 1, 1)).offsets, (0.4, 0.4), *pair)
    with pytest.raises(ValueError, match="overlaps"):
        stencil_window_pair(arr, STENCIL26.offsets, (0.4, 0.4), *pair,
                            out=arr[..., 1:7, 1:7, 1:7])
    with pytest.raises(TypeError, match="float32 or float64"):
        stencil_window_pair(arr.half(), STENCIL26.offsets, (0.4, 0.4), *pair)
