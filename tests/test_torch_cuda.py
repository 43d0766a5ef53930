"""The port on the card: tests that need an NVIDIA GPU.

They import only torch and the port (the machine with the card has no
JAX), carry the ``cuda`` marker, and skip with a reason where there is
no card.  Run them there with::

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.comm import Communicator, policy_for_mode
from repro_torch.core import StridedBlock
from repro_torch.halo import (
    OVERLAP_MODES,
    STENCIL26,
    HaloSpec,
    build_halo_program,
    from_reference,
    halo_exchange,
    ihalo_exchange,
    make_halo_plan,
    make_halo_step,
    make_program_step,
    overlapped_stencil_iteration,
    stencil_cycle,
)
from repro_torch.kernels import launch_counts, plan_geometry, reset_launch_counts
from repro_torch.kernels.pack import (
    DMA_PATHS,
    dma_args,
    launch,
    pack_dma,
    pack_plain,
    pack_rows,
    row_args,
)
from repro_torch.kernels.ops import stencil_window_update
from repro_torch.kernels.unpack import unpack_dma, unpack_plain, unpack_rows

BLOCKS = [
    StridedBlock(12, (8, 5, 3), (1, 40, 400)),
    StridedBlock(1, (100, 13), (1, 512)),
    StridedBlock(4, (1040, 4, 3), (1, 2080, 10400)),
    StridedBlock(2, (96, 24), (1, 320)),
    # planes that share rows: the last plane wins
    StridedBlock(4, (8, 6, 3), (1, 16, 32)),
    StridedBlock(1, (5, 4, 5), (1, 7, 7)),
    StridedBlock(2, (6, 3, 4), (1, 10, 20)),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8])
def test_kernels_match_their_plain_versions(batch):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(batch)
    for sb in BLOCKS:
        geom = plan_geometry(sb)
        n = (geom.span_bytes + 8) // 8 * 8
        src = torch.randint(0, 256, (batch, n), dtype=torch.uint8, device=dev, generator=gen)
        want = pack_plain(src, geom, torch.empty((batch, geom.packed_bytes),
                                                 dtype=torch.uint8, device=dev))
        for fn in (pack_rows, pack_dma):
            assert torch.equal(fn(src, geom), want), (fn.__name__, sb)
        dst0 = torch.randint(0, 256, (batch, n), dtype=torch.uint8, device=dev, generator=gen)
        want_dst = unpack_plain(dst0.clone(), want, geom)
        for fn in (unpack_dma,) if geom.interleaved else (unpack_rows, unpack_dma):
            d = dst0.clone()
            fn(d, want, geom)
            assert torch.equal(d, want_dst), (fn.__name__, sb)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["rows", "dma", "tempi"])
def test_halo_exchange_on_the_card_equals_the_cpu(mode):
    dev = _card()
    spec = HaloSpec(grid=(2, 2, 2), interior=(6, 5, 4), radius=2)
    start = np.random.default_rng(4).normal(size=(8,) + spec.alloc).astype(np.float32)
    want = make_halo_step(spec, Communicator(policy=policy_for_mode(mode), device="cpu"),
                          device="cpu")(from_reference(start, spec, device="cpu"))
    reset_launch_counts()
    step = make_halo_step(spec, Communicator(policy=policy_for_mode(mode), device=dev),
                          device=dev)
    got = step(from_reference(start, spec, device=dev))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    counts = launch_counts()
    if mode != "tempi":
        assert counts[f"pack_{mode}"] == 26 and counts[f"unpack_{mode}"] == 26, counts


@pytest.mark.cuda
def test_kernels_take_offsets_past_32_bits():
    """A block whose bytes lie past 1 GiB: the SIMT kernels and the dma
    kernels' narrow path (5-byte rows, V = 1) switch their index
    arithmetic to 64 bits there."""
    dev = _card()
    sb = StridedBlock((1 << 30) + 3, (5, 7, 2), (1, 1000, 40000))
    geom = plan_geometry(sb)
    assert geom.word_bytes == 1 and geom.span_bytes > 1 << 30
    src = torch.randint(0, 256, (1, geom.span_bytes + 5), dtype=torch.uint8, device=dev)
    assert DMA_PATHS[dma_args(geom, src, src[:, :geom.packed_bytes])[1]] == "narrow"
    want = pack_plain(src, geom, torch.empty((1, geom.packed_bytes), dtype=torch.uint8,
                                             device=dev))
    for fn in (pack_rows, pack_dma):
        assert torch.equal(fn(src, geom), want), fn.__name__
    want_dst = unpack_plain(src.clone(), want.flip(1).contiguous(), geom)
    for fn in (unpack_rows, unpack_dma):
        d = src.clone()
        fn(d, want.flip(1).contiguous(), geom)
        assert torch.equal(d, want_dst), fn.__name__
    torch.cuda.synchronize()


# Blocks that drive the row kernels through every vector width and both
# paths: (start, counts, strides, word or None, (vector bytes, path)).
ROW_CASES = [
    (0, (1024, 3, 2), (1, 2048, 8192), None, (16, 1)),
    (16, (48, 5, 3), (1, 64, 512), None, (16, 0)),
    (8, (1024, 4, 2), (1, 1040, 4160), None, (8, 1)),       # a halo face
    (8, (8, 2, 2), (1, 1040, 4160), None, (8, 0)),          # a halo corner
    (4, (1024, 3, 2), (1, 1040, 4160), None, (4, 1)),       # rows at 4 mod 8
    (16, (12, 5, 2), (1, 64, 320), None, (4, 0)),           # 12-byte rows
    (0, (1036, 3, 2), (1, 2048, 8192), None, (4, 1)),       # 3 chunks of a row
    (2, (514, 3, 2), (1, 1030, 4120), None, (2, 1)),
    (6, (10, 4, 3), (1, 30, 150), None, (2, 0)),
    (3, (513, 3, 2), (1, 1027, 4108), None, (1, 1)),
    (1, (13, 4, 2), (1, 100, 500), None, (1, 0)),
    (0, (1024, 3, 2), (1, 2048, 8192), 1, (16, 1)),         # W = 1, V = 16
    (16, (65536, 3), (1, 65552), None, (16, 1)),            # 2D, 32 chunks a row
]


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(len(ROW_CASES)))
@pytest.mark.parametrize("slot_offset", [0, 4])
def test_row_kernels_take_every_vector_width_and_path(k, slot_offset):
    """Bit-exact against the plain versions, 8 buffers per launch, with
    the packed side at ``slot_offset`` bytes into a wider wire (4 drops
    V to at most 4); the wire bytes around the slot stay as they were."""
    dev = _card()
    start, counts, strides, word, want = ROW_CASES[k]
    geom = plan_geometry(StridedBlock(start, counts, strides), word_bytes=word)
    gen = torch.Generator(device=dev).manual_seed(k)
    n = (geom.span_bytes + 15) // 16 * 16
    src = torch.randint(0, 256, (8, n), dtype=torch.uint8, device=dev, generator=gen)
    size = geom.packed_bytes
    wire = torch.full((8, size + 16), 7, dtype=torch.uint8, device=dev)
    slot = wire[:, slot_offset : slot_offset + size]
    if slot_offset == 0:
        assert row_args(geom, src, slot) == want
    want_packed = pack_plain(src, geom, torch.empty((8, size), dtype=torch.uint8, device=dev))
    pack_rows(src, geom, slot)
    assert torch.equal(slot, want_packed)
    assert (wire[:, :slot_offset] == 7).all() and (wire[:, slot_offset + size :] == 7).all()
    dst = torch.randint(0, 256, (8, n), dtype=torch.uint8, device=dev, generator=gen)
    want_dst = unpack_plain(dst.clone(), slot, geom)
    unpack_rows(dst, slot, geom)
    assert torch.equal(dst, want_dst)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_row_kernels_take_offsets_past_32_bits_on_the_warp_path():
    """513-byte rows past 1 GiB: the warp path at V = 1, whose offsets
    pass 2^30 vectors, so it indexes in 64 bits."""
    dev = _card()
    geom = plan_geometry(StridedBlock(1027 * 1045520 + 3, (513, 3, 2), (1, 1027, 4108)))
    src = torch.randint(0, 256, (1, geom.span_bytes + 16), dtype=torch.uint8, device=dev)
    packed = torch.empty((1, geom.packed_bytes), dtype=torch.uint8, device=dev)
    assert row_args(geom, src, packed) == (1, 1)
    want = pack_plain(src, geom, packed.clone())
    assert torch.equal(pack_rows(src, geom, packed), want)
    want_dst = unpack_plain(src.clone(), want.flip(1).contiguous(), geom)
    unpack_rows(src, want.flip(1).contiguous(), geom)
    assert torch.equal(src, want_dst)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_row_kernels_refuse_a_vector_that_does_not_divide_the_rows():
    """The launcher checks V against every address: a halo face's rows
    start at byte 8 mod 16, so a 16-byte launch is refused, not run."""
    dev = _card()
    geom = plan_geometry(StridedBlock(8, (1024, 4, 2), (1, 1040, 4160)))
    src = torch.zeros((1, geom.span_bytes + 8), dtype=torch.uint8, device=dev)
    out = torch.zeros((1, geom.packed_bytes), dtype=torch.uint8, device=dev)
    with pytest.raises(RuntimeError, match="tempi_pack_rows"):
        launch("pack", "tempi_pack_rows", src, out, geom, 16, 1)
    with pytest.raises(RuntimeError, match="tempi_pack_rows"):
        launch("pack", "tempi_pack_rows", src, out, geom, 8, 2)


def _dma_roundtrip(geom, src, wire, offset, dst):
    """Pack ``src`` into the slot ``offset`` bytes into ``wire`` and unpack
    the slot into ``dst`` with the dma kernels, each bit-exact against its
    plain version; the wire bytes around the slot stay as they were."""
    size = geom.packed_bytes
    slot = wire[:, offset : offset + size]
    before = wire.clone()
    want = pack_plain(src, geom, torch.empty_like(slot))
    pack_dma(src, geom, slot)
    assert torch.equal(slot, want)
    assert torch.equal(wire[:, :offset], before[:, :offset])
    assert torch.equal(wire[:, offset + size :], before[:, offset + size :])
    want_dst = unpack_plain(dst.clone(), slot, geom)
    unpack_dma(dst, slot, geom)
    assert torch.equal(dst, want_dst)


def _buffers(dev, geom, batch, odd=0, seed=0):
    """Two seeded ``(batch, n)`` buffers for ``geom`` (n the span rounded
    up to 16 bytes, plus ``odd``) and a wire of the packed size plus 16
    bytes, filled with 7."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = (geom.span_bytes + 15) // 16 * 16 + odd
    src, dst = (torch.randint(0, 256, (batch, n), dtype=torch.uint8, device=dev, generator=gen)
                for _ in range(2))
    wire = torch.full((batch, geom.packed_bytes + 16), 7, dtype=torch.uint8, device=dev)
    return src, dst, wire


# the halo's three dma shapes at a 1,040-byte pitch, planes cut to 4 and
# 16: x faces (2 x 256 x 256 words), dy = 0 (2 x 256 x 2) and dz = 0
# (2 x 2 x 256) edges
HALO_DMA = [
    StridedBlock(8, (8, 256, 4), (1, 1040, 270400)),
    StridedBlock(8, (8, 256, 2), (1, 1040, 270400)),
    StridedBlock(1032, (8, 2, 16), (1, 1040, 270400)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(len(HALO_DMA)))
@pytest.mark.parametrize("batch", [1, 8])
def test_dma_kernels_at_the_halo_shapes(k, batch):
    dev = _card()
    geom = plan_geometry(HALO_DMA[k])
    src, dst, wire = _buffers(dev, geom, batch, seed=k)
    assert dma_args(geom, src, wire[:, : geom.packed_bytes])[:2] == (8, DMA_PATHS.index("narrow"))
    _dma_roundtrip(geom, src, wire, 0, dst)
    torch.cuda.synchronize()


# narrow blocks at every vector width: (start, counts, strides, word or
# None, slot offset, extra bytes per buffer, V)
NARROW_CASES = [
    (16, (16, 5, 3), (1, 64, 512), None, 0, 0, 16),
    (8, (8, 64, 4), (1, 1040, 66560), None, 0, 0, 8),   # a cut x face
    (8, (8, 64, 4), (1, 1040, 66560), None, 4, 0, 4),   # slot 4 B into a wire
    (4, (8, 6, 3), (1, 1040, 6240), None, 0, 0, 4),     # rows at 4 mod 8
    (16, (12, 5, 2), (1, 64, 320), None, 0, 0, 4),      # 12-byte rows: 3 vectors
    (6, (10, 4, 3), (1, 30, 150), None, 0, 0, 2),       # W = 2: 5 vectors
    (8, (8, 64, 4), (1, 1040, 66560), 1, 3, 0, 1),      # slot at an odd offset
    (8, (8, 64, 4), (1, 1040, 66560), 1, 0, 1, 1),      # odd batch stride
    (1, (13, 4, 2), (1, 100, 500), None, 0, 0, 1),      # W = 1: 13 vectors
]


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(len(NARROW_CASES)))
@pytest.mark.parametrize("batch", [1, 8])
def test_dma_narrow_path_takes_every_vector_width(k, batch):
    """(One buffer never uses its batch stride: the odd-stride case then
    runs at V = 8.)"""
    dev = _card()
    start, counts, strides, word, offset, odd, want = NARROW_CASES[k]
    geom = plan_geometry(StridedBlock(start, counts, strides), word_bytes=word)
    src, dst, wire = _buffers(dev, geom, batch, odd, seed=k)
    vec, path, _ = dma_args(geom, src, wire[:, offset : offset + geom.packed_bytes])
    assert (vec, DMA_PATHS[path]) == (8 if odd and batch == 1 else want, "narrow")
    _dma_roundtrip(geom, src, wire, offset, dst)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [4, 5, 6])
@pytest.mark.parametrize("batch", [1, 8])
def test_dma_narrow_path_lets_the_last_plane_win(k, batch):
    """The three interleaved-plane blocks of ``BLOCKS``: their rows are 8,
    5 and 6 bytes long, so both dma kernels take the narrow path."""
    dev = _card()
    geom = plan_geometry(BLOCKS[k])
    assert geom.interleaved
    src, dst, wire = _buffers(dev, geom, batch, seed=k)
    assert DMA_PATHS[dma_args(geom, src, wire[:, : geom.packed_bytes])[1]] == "narrow"
    _dma_roundtrip(geom, src, wire, 0, dst)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("counts,strides,batch,tile_rows", [
    ((8, 200, 200), (1, 40, 8000), 8, 512),    # 40,000 rows: last tile 64 rows, pitch 40
    ((8, 1000), (1, 1040), 1, 32),             # last tile 8 rows
])
def test_dma_narrow_path_takes_a_ragged_last_tile(counts, strides, batch, tile_rows):
    dev = _card()
    geom = plan_geometry(StridedBlock(8, counts, strides))
    src, dst, wire = _buffers(dev, geom, batch)
    assert dma_args(geom, src, wire[:, : geom.packed_bytes]) == (
        8, DMA_PATHS.index("narrow"), tile_rows)
    assert geom.rows * geom.planes % tile_rows
    _dma_roundtrip(geom, src, wire, 0, dst)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_dma_kernels_refuse_a_launch_they_cannot_run():
    """The launcher checks V against every address and the path against
    the rows: an x-face row starts at byte 8 mod 16, so a 16-byte narrow
    launch is refused; rows of 1 KB are too long for the narrow path; the
    tiled path copies words only; a tile past 32 KB does not fit."""
    dev = _card()
    narrow, tiled = DMA_PATHS.index("narrow"), DMA_PATHS.index("tiled")
    x = plan_geometry(StridedBlock(8, (8, 64, 4), (1, 1040, 66560)))
    face = plan_geometry(StridedBlock(8, (1024, 4, 2), (1, 1040, 4160)))
    for geom, args in ((x, (16, narrow, 1024)), (face, (8, narrow, 32)), (x, (8, tiled, 0)),
                       (x, (8, narrow, 8192))):
        src = torch.zeros((1, geom.span_bytes + 8), dtype=torch.uint8, device=dev)
        out = torch.zeros((1, geom.packed_bytes), dtype=torch.uint8, device=dev)
        with pytest.raises(RuntimeError, match="tempi_pack_dma"):
            launch("pack", "tempi_pack_dma", src, out, geom, *args)
        with pytest.raises(RuntimeError, match="tempi_unpack_dma"):
            launch("unpack", "tempi_unpack_dma", src, out, geom, *args)


# ---------------------------------------------------------------------------
# per-class requests on the side stream, overlap and deep-halo programs
# ---------------------------------------------------------------------------

def _small_state(spec, dev, seed=5):
    start = np.random.default_rng(seed).normal(size=(8,) + spec.alloc).astype(np.float32)
    return from_reference(start, spec, device=dev)


@pytest.mark.cuda
def test_class_events_complete_and_wait_any_drains_every_class():
    dev = _card()
    spec = HaloSpec(grid=(2, 2, 2), interior=(6, 5, 4), radius=2)
    comm = Communicator(device=dev)
    plan = make_halo_plan(spec, comm, schedule_policy="exact")  # grouped: one op a class
    local = _small_state(spec, dev)
    req = ihalo_exchange(local, spec, comm, plan=plan)
    assert [c.index for c in req.classes] == list(range(plan.wire.ngroups)) == list(range(7))
    assert all(c.event is not None for c in req.classes)
    while req.pending:
        req.wait_any()
    assert sorted(req.drained) == list(range(7))
    assert req.completed and req.wait() is local
    torch.cuda.synchronize()
    assert all(c.ready() for c in req.classes)
    want = halo_exchange(_small_state(spec, "cpu"), spec, Communicator(device="cpu"),
                         plan=make_halo_plan(spec, Communicator(device="cpu"),
                                             schedule_policy="exact"))
    assert torch.equal(local.cpu(), want)
    assert sorted(comm.wire_class_drains.values()) == list(range(1, 8))
    assert set(comm.wire_class_ops.values()) == {1}


@pytest.mark.cuda
@pytest.mark.parametrize("traced", [False, True])
def test_tempi_ranges_are_host_events_and_no_device_event_carries_their_name(traced):
    """``bench/profiling.py`` counts every device-side event as busy time
    and every one outside the pack/unpack kernels as the wire: a range
    mirrored onto the device would change ``idle_pct.*`` and
    ``wire_ms``."""
    from repro_torch.obs import Tracer
    from torch.profiler import ProfilerActivity, profile

    dev = _card()
    spec = HaloSpec(grid=(2, 2, 2), interior=(16, 16, 16), radius=2)
    comm = Communicator(device=dev, tracer=Tracer() if traced else None)
    step = make_halo_step(spec, comm, device=dev)
    local = step(_small_state(spec, dev))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(local)
        torch.cuda.synchronize()
    events = list(prof.events())
    cuda = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    host = {e.name for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    assert cuda and not [n for n in cuda if n.startswith("tempi.")]
    assert not [e.name for e in events if e.is_user_annotation]
    assert {"tempi.exchange", "tempi.prep", "tempi.pack", "tempi.wire", "tempi.unpack"} <= host


@pytest.mark.cuda
@pytest.mark.parametrize("mode", OVERLAP_MODES)
def test_overlapped_iteration_on_the_card_equals_the_plain_path(mode):
    dev = _card()
    spec = HaloSpec(grid=(2, 2, 2), interior=(10, 9, 8), radius=2)
    comm = Communicator(device=dev)
    plan = make_halo_plan(spec, comm)
    want = _small_state(spec, dev)
    got = want.clone()
    for _ in range(2):
        stencil_cycle(halo_exchange(want, spec, comm, plan=plan), spec, STENCIL26, 2)
        overlapped_stencil_iteration(got, spec, comm, steps=2, plan=plan, mode=mode)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_program_at_three_steps_runs_on_the_card():
    dev = _card()
    comm = Communicator(device=dev)
    program = build_halo_program((2, 2, 2), (12, 10, 9), comm, steps=3)
    step = make_program_step(program, comm, device=dev)
    got = _small_state(program.spec, dev)
    want = got.clone()
    reset_launch_counts()
    for _ in range(2):
        step(got)
        stencil_cycle(halo_exchange(want, program.spec, comm, plan=program.plan),
                      program.spec, program.ops, 3)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.equal(got, want)
    assert sum(launch_counts().values()) > 0  # the kernels, not their plain versions


@pytest.mark.cuda
@pytest.mark.parametrize("weight", [STENCIL26.weight, 1 / 3, 0.9])
def test_stencil_update_on_the_card_equals_the_cpu_bit_for_bit(weight):
    # the scalar factors are rounded on the host, as on the CPU: the card
    # then computes the same float32 values in the same order
    dev = _card()
    arr = torch.from_numpy(
        np.random.default_rng(11).normal(size=(3, 14, 12, 11)).astype(np.float32))
    origin, shape = (1, 1, 1), (12, 10, 9)
    want = stencil_window_update(arr, STENCIL26.offsets, weight, origin, shape)
    got = stencil_window_update(arr.to(dev), STENCIL26.offsets, weight, origin, shape)
    assert got.is_cuda and torch.equal(got.cpu(), want)


# ---------------------------------------------------------------------------
# one process per rank: a world of one under NCCL on this card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nccl_world(tmp_path_factory):
    """A world-size-1 NCCL group in this process over a file store; all
    26 neighbours of a (1, 1, 1) grid are the process itself."""
    dev = _card()
    from repro_torch.launch.procgroup import destroy_process_group, init_process_group

    info = init_process_group("nccl", dev, rank=0, world_size=1,
                              store_path=str(tmp_path_factory.mktemp("nccl") / "store"))
    yield info
    destroy_process_group()


def _one_rank_state(spec, dev, seed=7):
    start = np.random.default_rng(seed).normal(size=(1,) + spec.alloc).astype(np.float32)
    return from_reference(start, spec, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["grouped", "uniform", "ragged"])
def test_world_of_one_nccl_exchange_equals_the_local_mesh(nccl_world, schedule):
    import dataclasses

    from repro_torch.comm import DistributedTransport, reschedule

    dev = nccl_world.device
    spec = HaloSpec(grid=(1, 1, 1), interior=(16, 12, 10), radius=2)
    got, want = _one_rank_state(spec, dev), _one_rank_state(spec, dev)
    comms = (Communicator(transport=DistributedTransport(device=dev)), Communicator(device=dev))
    for comm, x in zip(comms, (got, want)):
        plan = make_halo_plan(spec, comm, schedule_policy="exact")
        plan = dataclasses.replace(plan, wire=reschedule(plan.wire, schedule))
        reset_launch_counts()
        halo_exchange(x, spec, comm, plan=plan)
        torch.cuda.synchronize()
        assert sum(launch_counts().values()) > 0
    assert torch.equal(got, want)
    assert (comms[0].wire_ops, comms[0].wire_payload_bytes) == (
        comms[1].wire_ops, comms[1].wire_payload_bytes)


@pytest.mark.cuda
def test_nccl_unpack_right_after_wait_any_sees_the_payload(nccl_world):
    """The class's event follows the side stream's wait on the NCCL op:
    an unpack enqueued right after ``wait_any()`` reads the landed bytes."""
    from repro_torch.comm import DistributedTransport

    dev = nccl_world.device
    spec = HaloSpec(grid=(1, 1, 1), interior=(128, 128, 128), radius=2)
    want = _one_rank_state(spec, dev)
    halo_exchange(want, spec, Communicator(device=dev))
    comm = Communicator(transport=DistributedTransport(device=dev))
    plan = make_halo_plan(spec, comm)
    for _ in range(3):
        x = _one_rank_state(spec, dev)
        req = ihalo_exchange(x, spec, comm, plan=plan)
        assert all(c.event is not None for c in req.classes)
        while req.pending:
            req.wait_any()
        assert torch.equal(req.buffer.clone(), want)


# the compressed wire on the card
# ---------------------------------------------------------------------------

#: member bytes per rank of the full-width halo's regions (256^3, radius
#: 2, float32): a corner, an edge, a face
HALO_REGION_BYTES = (32, 4096, 524288)


def _member_rows(kind, n, batch=8, seed=3):
    """float32 member bytes (int8wire reads them as floats)."""
    rng = np.random.default_rng(seed)
    if kind == "random":  # normal floats: rle ships them stored
        return rng.normal(size=(batch, n // 4)).astype(np.float32).view(np.uint8)
    if kind == "bytes":  # as floats: NaNs of many payloads, infinities
        b = rng.integers(0, 256, size=(batch, n), dtype=np.uint8)
        b.view(np.uint32)[:, 1] = [0xFFFFFFFF, 0x7F800001, 0x7F800000, 0xFF800000,
                                   0x7FC00000, 0x7FFFFFFF, 0xFFC00000, 0x00000001][:batch]
        return b
    f = np.zeros((batch, n // 4), np.float32)  # a few nonzero floats: ships rle
    f[:, :: 97] = rng.normal(size=f[:, :: 97].shape)
    return f.view(np.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("n", HALO_REGION_BYTES)
@pytest.mark.parametrize("kind", ["random", "sparse", "bytes"])
def test_codecs_on_the_card_equal_the_cpu(kind, n):
    """Both codecs are plain torch: on the card they give the CPU's
    bytes, encoded and decoded (the capacity wire and, for rle, the
    stream prefix of the row with the most runs); on raw bytes too,
    whose NaN and infinite floats the int8 wire writes and decodes to
    fixed bits."""
    from repro_torch.comm import INT8_WIRE, RLE_WIRE

    dev = _card()
    member = torch.from_numpy(_member_rows(kind, n))
    for codec in (RLE_WIRE, INT8_WIRE):
        want = codec.encode_wire(member)
        got = codec.encode_wire(member.to(dev))
        assert torch.equal(got.cpu(), want), codec.name
        assert torch.equal(codec.decode_wire(got, n).cpu(), codec.decode_wire(want, n))
    wire = RLE_WIRE.encode_wire(member)
    nruns = int(wire[:, 4:8].contiguous().view(torch.int32).max())
    stream = 8 + 5 * nruns
    if stream < wire.shape[1]:
        got = RLE_WIRE.decode_wire(wire[:, :stream].to(dev), n)
        assert torch.equal(got.cpu(), RLE_WIRE.decode_wire(wire[:, :stream], n))
        assert torch.equal(got.cpu(), member)


def _point_state(spec, rank=13):
    """Every rank's block of a field that is zero but for seeded values in
    a sixteenth of ``rank``'s +x send region (few enough runs for rle)."""
    start = np.zeros((spec.nranks,) + spec.alloc, np.float32)
    r, n = spec.radius, spec.interior
    vals = np.random.default_rng(9).normal(size=(n[0] // 4, n[1] // 4, r))
    start[rank, r:r + n[0] // 4, r:r + n[1] // 4, n[2]:n[2] + r] = vals
    return start


@pytest.mark.cuda
def test_varlen_exchange_needs_no_host_sync_after_planning():
    """27 ranks, probed on the centre rank: once planned (and its index
    tables made by one exchange), a varlen exchange enqueues everything
    without the host waiting on the card, and equals the CPU's."""
    from repro_torch.comm import reschedule
    from repro_torch.halo import DIRECTIONS, HaloPlan, make_halo_types

    dev = _card()
    spec = HaloSpec(grid=(3, 3, 3), interior=(16, 16, 16), radius=2)
    start = _point_state(spec)
    outs = []
    for device in ("cpu", dev):
        comm = Communicator(device=device)
        types = make_halo_types(spec, comm)
        send = tuple(types[d][0] for d in DIRECTIONS)
        recv = tuple(types[d][1] for d in DIRECTIONS)
        perms = tuple(tuple(spec.perm(d)) for d in DIRECTIONS)
        probe = torch.from_numpy(start[13]).to(device)
        strats, wire = comm.plan_neighbor(send, perms, probe=probe)
        plan = HaloPlan(spec, send, recv, perms, strats, reschedule(wire, "varlen"))
        assert "rlewire" in {s.name for s in strats}
        halo_exchange(from_reference(start, spec, device=device), spec, comm, plan=plan)
        x = from_reference(start, spec, device=device)
        if device != "cpu":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            halo_exchange(x, spec, comm, plan=plan)
        finally:
            if device != "cpu":
                torch.cuda.set_sync_debug_mode(0)
        outs.append(x.cpu())
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
def test_world_of_one_nccl_varlen_exchange_equals_the_local_mesh(nccl_world):
    """One transfer to itself (the +x face region of a seeded point
    source), probed, on the varlen schedule: NCCL sends the stream prefix
    and the buffer equals the local mesh's."""
    from repro_torch.comm import DistributedTransport
    from repro_torch.halo import make_halo_types

    dev = nccl_world.device
    spec = HaloSpec(grid=(1, 1, 1), interior=(32, 32, 32), radius=2)
    start = _point_state(spec, rank=0)
    outs, counts = [], []
    for comm in (Communicator(transport=DistributedTransport(device=dev)),
                 Communicator(device=dev)):
        send, recv = make_halo_types(spec, comm)[(0, 0, 1)]
        x = from_reference(start, spec, device=dev)
        strats, plan = comm.plan_neighbor([send], [[(0, 0)]], probe=x[0])
        assert plan.schedule == "varlen" and strats[0].name == "rlewire"
        comm.neighbor_alltoallv(x, [send], [recv], [[(0, 0)]], plan=plan, strategies=strats)
        torch.cuda.synchronize()
        outs.append(x)
        counts.append((comm.wire_ops, comm.wire_payload_bytes, plan.stream_bytes))
    assert torch.equal(outs[0], outs[1])
    assert counts[0] == counts[1] and counts[0][1] < send.size


# ---------------------------------------------------------------------------
# the two-level machine: the tiered schedule on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_tiered_exchange_at_the_main_path_shapes():
    """The main path's 2x2x2 grid of 256^3 blocks, radius 2, 4 ranks a
    node: ``tiered`` (one bundle of the 4 node-crossing classes, 3
    correction hops) fills the halos ``grouped`` fills, through all four
    kernels, issuing the plan's 7 ops and 4,276,480 bytes a rank."""
    import dataclasses

    from repro_torch.comm import Topology, reschedule

    dev = _card()
    spec = HaloSpec(grid=(2, 2, 2), interior=(256, 256, 256), radius=2)
    comm = Communicator(device=dev, topology=Topology.blocked(8, 4))
    plan = make_halo_plan(spec, comm)
    gen = torch.Generator(device=dev).manual_seed(11)
    start = torch.randn((8,) + spec.alloc, device=dev, generator=gen)
    out = {}
    for sched in ("grouped", "tiered"):
        wire = reschedule(plan.wire, sched)
        x = start.clone()
        ops, nbytes = comm.wire_ops, comm.wire_payload_bytes
        reset_launch_counts()
        halo_exchange(x, spec, comm, plan=dataclasses.replace(plan, wire=wire))
        torch.cuda.synchronize()
        counts = launch_counts()
        assert all(counts[k] > 0 for k in ("pack_rows", "pack_dma", "unpack_rows",
                                           "unpack_dma")), counts
        assert (comm.wire_ops - ops, comm.wire_payload_bytes - nbytes) == (
            7, wire.issued_bytes)
        out[sched] = x
    assert torch.equal(out["tiered"], out["grouped"])
    assert reschedule(plan.wire, "tiered").issued_bytes == 4_276_480


@pytest.mark.cuda
def test_world_of_one_nccl_tiered_exchange_equals_the_local_mesh(nccl_world):
    """A world of one on one node: every class is a self edge on the fast
    tier, so ``tiered`` has no bundle and issues what ``grouped`` does."""
    import dataclasses

    from repro_torch.comm import DistributedTransport, Topology, reschedule

    dev = nccl_world.device
    spec = HaloSpec(grid=(1, 1, 1), interior=(16, 12, 10), radius=2)
    got, want = _one_rank_state(spec, dev), _one_rank_state(spec, dev)
    comms = (Communicator(transport=DistributedTransport(device=dev),
                          topology=Topology.flat(1)),
             Communicator(device=dev, topology=Topology.flat(1)))
    for comm, x in zip(comms, (got, want)):
        plan = make_halo_plan(spec, comm, schedule_policy="exact")
        assert plan.wire.tier_bundles == ()
        plan = dataclasses.replace(plan, wire=reschedule(plan.wire, "tiered"))
        halo_exchange(x, spec, comm, plan=plan)
        torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert (comms[0].wire_ops, comms[0].wire_payload_bytes) == (
        comms[1].wire_ops, comms[1].wire_payload_bytes)


# ---------------------------------------------------------------------------
# observability on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_no_spans_while_a_cuda_graph_is_captured():
    from repro_torch.obs import Tracer
    from repro_torch.obs import trace as trace_mod

    dev = _card()
    tr = Tracer()
    x = torch.zeros(1024, device=dev)
    seen = []
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        x.add_(1.0)  # warm up outside the capture
    torch.cuda.current_stream(dev).wait_stream(stream)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        seen.append((trace_mod._capturing(), tr.active))
        with tr.span("should-not-record") as sp:
            seen.append(sp)
            x.add_(1.0)
    assert seen == [(True, False), None]
    assert len(tr) == 0 and not trace_mod._capturing() and tr.active
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(x, torch.full_like(x, 2.0))


def _traced_program(dev, tracer=None, telemetry=None):
    from repro_torch.comm import Communicator as Comm

    comm = Comm(device=dev, tracer=tracer, telemetry=telemetry)
    return comm, build_halo_program((2, 2, 2), (16, 12, 10), comm, steps=2)


@pytest.mark.cuda
def test_traced_iteration_equals_the_untraced_one_with_the_same_launches():
    from repro_torch.fleet import ExchangeTelemetry
    from repro_torch.obs import Tracer, to_chrome_trace, validate

    dev = _card()
    plain, prog = _traced_program(dev)
    tr = Tracer()
    traced, tprog = _traced_program(dev, tr, ExchangeTelemetry())
    assert tprog.plan.wire.fingerprint == prog.plan.wire.fingerprint
    want = _small_state(prog.spec, dev)
    got = want.clone()
    counts = []
    for p, c, x in ((prog, plain, want), (tprog, traced, got)):
        torch.cuda.synchronize()
        reset_launch_counts()
        for _ in range(3):
            p.iteration(x, c)
        torch.cuda.synchronize()
        counts.append(launch_counts())
    assert torch.equal(got, want)
    assert counts[0] == counts[1] and sum(counts[0].values()) > 0
    assert plain.wire_ops == traced.wire_ops
    assert validate(to_chrome_trace(tr)) == []
    names = [s.name for s in tr.spans]
    assert names.count("program_iteration") == names.count("exchange") == 3
    assert names.count("stencil") == 6
    assert traced.telemetry.get(tprog.plan.wire.fingerprint).count == 3


@pytest.mark.cuda
def test_packed_collectives_in_a_world_of_one_equal_the_local_mesh(nccl_world):
    from repro_torch.comm import DistributedTransport
    from repro_torch.comm.interposer import Interposer
    from repro_torch.core import FLOAT, Vector

    dev = nccl_world.device
    src = torch.randn((1, 12), device=dev)
    out = []
    for ip in (Interposer(transport=DistributedTransport(device=dev)), Interposer(device=dev)):
        ct = ip.commit(Vector(3, 2, 4, FLOAT))
        out.append((ip.all_gather_packed(src, ct), ip.all_to_all_packed(src, [ct]),
                    ip.sendrecv(src, torch.zeros_like(src), ct, [(0, 0)]),
                    ip.stats()["wire_ops"]))
        with pytest.raises(ValueError, match="must be unique"):
            ip.sendrecv(src, torch.zeros_like(src), ct, [(0, 0), (0, 0)])
    (g, a, s, ops), (g2, a2, s2, ops2) = out
    assert g.shape == (1, 1, 24) and a.shape == (1, 1, 24)
    assert torch.equal(g, g2) and torch.equal(a, a2) and torch.equal(s, s2)
    assert ops == ops2 == 3


@pytest.mark.cuda
def test_smoother_on_the_card_equals_the_cpu_run():
    from repro_torch.launch.smoother import run_smoother

    _card()
    reset_launch_counts()
    got = run_smoother(Communicator(device="cuda"), iters=2, interior=(8, 8, 8),
                       cycle="predictor-corrector", halo_steps=1)
    counts = launch_counts()
    want = run_smoother(Communicator(device="cpu"), iters=2, interior=(8, 8, 8),
                        cycle="predictor-corrector", halo_steps=1)
    assert got.program.fingerprint == want.program.fingerprint
    assert got.checksum == pytest.approx(want.checksum, rel=1e-5)
    assert sum(counts.values()) > 0  # the exchange went through the kernels


@pytest.mark.cuda
def test_smoke_serve_on_the_card():
    from repro_torch.configs import smoke_config
    from repro_torch.launch.serve import ServeLoop, make_requests

    _card()
    cfg = smoke_config("qwen2-0.5b")
    outs = []
    for _ in range(2):
        loop = ServeLoop(cfg, 2, 64, device="cuda")
        assert loop.cache["k"].is_cuda
        done = loop.run(make_requests(cfg, 3, 4))
        assert len(done) == 3 and all(len(v) == 4 for v in done.values())
        outs.append(done)
    assert outs[0] == outs[1]
    # float32: the card's decode follows its own forward, teacher-forced
    model = ServeLoop(cfg.replace(dtype="float32", kv_cache_dtype="float32"), 2, 16,
                      device="cuda").model
    toks = torch.randint(0, cfg.vocab_size, (2, 10), device="cuda")
    fwd, _ = model.forward(toks)
    cache = model.init_cache(2, 16)
    for step in range(10):
        lg, cache = model.decode_step(cache, toks[:, step], step)
        torch.testing.assert_close(lg, fwd[:, step], rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,merged", [(torch.float32, False), (torch.float32, True),
                                          (torch.bfloat16, False)])
def test_flash_backward_on_the_card_matches_autograd(dtype, merged):
    """The ``FlashAttention`` function's chunked backward against autograd
    through the plain chunked forward, on the card, at a qwen2 layer's
    attention (14 heads, 2 KV heads, hd 64, causal, two kv chunks):
    float32 to 1e-4, bf16 within 2% of the largest gradient."""
    from repro_torch.models import layers

    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    qkv = [torch.randn(s, generator=gen, device=dev) * 0.5
           for s in ((2, 256, 14, 64), (2, 256, 2, 64), (2, 256, 2, 64))]
    grads = []
    for fn in (lambda q, k, v: layers.flash_attention(q, k, v, chunk=128, merged=merged),
               lambda q, k, v: layers._flash_forward(q, k, v, True, None, 0, 128, merged)[0]):
        ts = [t.to(dtype).clone().requires_grad_(True) for t in qkv]
        torch.sin(fn(*ts).float()).sum().backward()
        grads.append([t.grad.float() for t in ts])
    for got, want in zip(*grads):
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        else:
            assert float((got - want).abs().max()) <= 0.02 * float(want.abs().max())


@pytest.mark.cuda
def test_smoke_train_step_on_the_card_equals_the_cpu_step():
    """One fused train step of the qwen2 smoke config at float32 on the
    card and on the CPU from the same parameters and batch: loss, grad
    norm and updated parameters to 1e-4."""
    from repro_torch.configs import ShapeConfig, smoke_config
    from repro_torch.data import synthetic_batch
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    dev = _card()
    cfg = smoke_config("qwen2-0.5b").replace(dtype="float32", remat=True)
    start = build_model(cfg, device="cpu").init(0).state_dict()
    opt_cfg = AdamWConfig(total_steps=10)
    out = {}
    for d in ("cpu", dev):
        model = build_model(cfg, device=d)
        model.load_state_dict(start)
        params = model.trainable()
        batch = synthetic_batch(cfg, ShapeConfig("train", 32, 4, "train"), 0, device=d)
        params, _, metrics = make_train_step(model, opt_cfg)(
            params, init_opt_state(params, opt_cfg), batch)
        out[str(d)] = ({k: float(v) for k, v in metrics.items()},
                       {k: v.detach().cpu() for k, v in params.items()})
    (m_cpu, p_cpu), (m_gpu, p_gpu) = out["cpu"], out[str(dev)]
    for k in ("loss", "grad_norm"):
        assert m_gpu[k] == pytest.approx(m_cpu[k], rel=1e-4, abs=1e-4), k
    for k in p_cpu:
        torch.testing.assert_close(p_gpu[k], p_cpu[k], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "mixtral-8x22b", "seamless-m4t-large-v2"])
def test_smoke_families_on_the_card_equal_the_cpu(arch):
    """The attention families' smoke configs at float32 from the same
    weights on the card and on the CPU: ``forward`` (vlm with patches
    and M-RoPE positions, encdec with audio embeddings), ``prefill``
    (not encdec, whose reference has none) and 16 decode steps (encdec
    against ``encode`` + ``make_cross_cache``) to 1e-3."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model
    from repro_torch.models.frontends import random_frontend_batch

    dev = _card()
    cfg = smoke_config(arch).replace(dtype="float32", kv_cache_dtype="float32")
    start = build_model(cfg, device="cpu").init(0).state_dict()
    toks = torch.randint(0, cfg.vocab_size, (2, 32), generator=torch.Generator().manual_seed(1))
    stub = random_frontend_batch(cfg, torch.Generator().manual_seed(2), 2, 32)
    out = {}
    for d in ("cpu", dev):
        model = build_model(cfg, device=d)
        model.load_state_dict(start)
        kw = {k: v.to(d) for k, v in stub.items() if k != "positions"}
        got = []
        with torch.no_grad():
            got.append(model.forward(toks.to(d), stub.get("positions"), **kw)[0])
            if cfg.family != "encdec":
                logits, cache = model.prefill(toks.to(d), patch_embeds=kw.get("patch_embeds"))
                got += [logits, cache["k"], cache["v"]]
            cache = model.init_cache(2, 32, enc_len=32)
            if cfg.family == "encdec":
                cache["xk"], cache["xv"] = model.make_cross_cache(model.encode(kw["enc_embeds"]))
            for s in range(16):
                lg, cache = model.decode_step(cache, toks[:, s].to(d), s)
                got.append(lg)
        assert all(g.device.type == torch.device(d).type for g in got)
        out[str(d)] = [g.cpu() for g in got]
    for a, b in zip(out["cpu"], out[str(dev)]):
        torch.testing.assert_close(b, a, rtol=1e-3, atol=1e-3)


@pytest.fixture
def no_tf32():
    """Float32 comparisons on the card with TF32 off (cuDNN's float32
    defaults to it)."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["scalar", "vector"])
def test_chunked_recurrence_on_the_card_equals_its_steps(form, no_tf32):
    """At the full head sizes (Mamba2 at zamba2-2.7b: 80 heads, dk = dv =
    64, B/C shared; RWKV6 at rwkv6-7b: 64 heads of 64), float32 from a
    carried state: the chunked form against 128 single steps, and the
    card against the CPU, each within 1e-4 of the largest value."""
    from repro_torch.models import linear_attn as la

    dev = _card()
    g = torch.Generator().manual_seed(0)
    B, S, dk = 2, 128, 64
    if form == "scalar":
        H = 80
        args = [torch.randn(B, S, dk, generator=g), torch.randn(B, S, dk, generator=g) / 8,
                torch.randn(B, S, H, dk, generator=g), -torch.rand(B, S, H, generator=g)]
    else:
        H = 64
        args = [torch.randn(B, S, H, dk, generator=g), torch.randn(B, S, H, dk, generator=g) / 8,
                torch.randn(B, S, H, dk, generator=g), -1.5 * torch.rand(B, S, H, dk, generator=g),
                torch.randn(H, dk, generator=g) / 10]
    s0 = torch.randn(B, H, dk, dk, generator=g)
    fn = la.chunked_scalar_decay if form == "scalar" else la.chunked_vector_decay
    cpu = fn(*args, s0)
    x = [a.to(dev) for a in args]
    got = fn(*x, s0.to(dev))
    state, ys = s0.to(dev), []
    for s in range(S):
        if form == "scalar":
            y, state = la.step_scalar_decay(x[0][:, s, None].expand(B, H, dk),
                                            x[1][:, s, None].expand(B, H, dk), x[2][:, s],
                                            x[3][:, s], state)
        else:
            y, state = la.step_vector_decay(x[0][:, s], x[1][:, s], x[2][:, s], x[3][:, s], x[4],
                                            state)
        ys.append(y)
    for a, b, c in zip(got, (torch.stack(ys, 1), state), cpu):
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * scale)
        torch.testing.assert_close(a.cpu(), c, rtol=0, atol=1e-4 * scale)


@pytest.mark.cuda
def test_large_decay_gradient_on_the_card_is_finite(no_tf32):
    """One chunk of 64 at a log decay of -1.5 a step (cumulative 96, past
    float32's exp range): the scalar form's gradients are finite on the
    card and equal the CPU's; so is a train step of a one-layer ``ssm``
    model at zamba2-2.7b's width with ``dt_bias`` at 3."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data import synthetic_batch
    from repro_torch.models import build_model, linear_attn as la
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    dev = _card()
    g = torch.Generator().manual_seed(1)
    inputs = [torch.randn(1, 64, 2, 4, generator=g), torch.randn(1, 64, 2, 4, generator=g),
              torch.randn(1, 64, 2, 4, generator=g), torch.full((1, 64, 2), -1.5)]
    w = torch.randn(1, 64, 2, 4, generator=g)
    grads = []
    for d in ("cpu", dev):
        xs = [a.to(d).requires_grad_(True) for a in inputs]
        y, st = la.chunked_scalar_decay(*xs)
        grads.append(torch.autograd.grad((y * w.to(d)).sum() + st.sum(), xs))
    for a, b in zip(*grads):
        assert torch.isfinite(b).all()
        torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-4)
    cfg = get_config("zamba2-2.7b").replace(family="ssm", num_layers=1, dtype="float32")
    model = build_model(cfg, device=dev).init(0)
    with torch.no_grad():
        model.layers[0].ssm.dt_bias.fill_(3.0)
    params = model.trainable()
    opt_cfg = AdamWConfig(total_steps=10)
    batch = synthetic_batch(cfg, ShapeConfig("train", 128, 2, "train"), 0, device=dev)
    params, _, metrics = make_train_step(model, opt_cfg)(params, init_opt_state(params, opt_cfg),
                                                         batch)
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
    assert all(torch.isfinite(p).all() for p in params.values())


@pytest.mark.cuda
@pytest.mark.parametrize("arch,family", [("zamba2-2.7b", "hybrid"), ("rwkv6-7b", "rwkv"),
                                         ("zamba2-2.7b", "ssm")])
def test_smoke_recurrent_on_the_card_equal_the_cpu(arch, family, no_tf32):
    """The recurrent smoke configs at float32 from the same weights on the
    card and on the CPU: ``forward`` over 128 tokens and 16 decode steps
    to 1e-3."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model

    dev = _card()
    cfg = smoke_config(arch).replace(family=family, dtype="float32", kv_cache_dtype="float32")
    start = build_model(cfg, device="cpu").init(0).state_dict()
    toks = torch.randint(0, cfg.vocab_size, (2, 128), generator=torch.Generator().manual_seed(1))
    out = {}
    for d in ("cpu", dev):
        model = build_model(cfg, device=d)
        model.load_state_dict(start)
        with torch.no_grad():
            got = [model.forward(toks.to(d))[0]]
            cache = model.init_cache(2, 32)
            for s in range(16):
                lg, cache = model.decode_step(cache, toks[:, s].to(d), s)
                got.append(lg)
        out[str(d)] = [g.cpu() for g in got]
    for a, b in zip(out["cpu"], out[str(dev)]):
        torch.testing.assert_close(b, a, rtol=1e-3, atol=1e-3)


@pytest.fixture
def card_mesh(nccl_world):
    """The (1, 1) ``("data", "model")`` mesh over the module's world of
    one."""
    from repro_torch.launch.mesh import make_test_mesh

    return make_test_mesh(data=1, model=1, device_type="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen3-32b", "seamless-m4t-large-v2",
                                  "zamba2-2.7b", "mixtral-8x22b", "rwkv6-7b", "qwen2-vl-2b"])
def test_smoke_mesh_step_on_the_card_equals_the_unsharded_step(arch, card_mesh, tmp_path,
                                                               no_tf32):
    """One step of ``train(mesh=...)`` on the card's (1, 1) mesh (every
    family's DTensor path on the card's torch: the placed parameters, the
    sharded lookup and label pick, the attention on shards, the gathered
    routing and recurrences, remat) against ``train()`` without the mesh,
    both from ``Model.init`` (seed 0), float32: loss, grad norm and the
    updated parameters to 1e-4."""
    from repro_torch.configs import smoke_config
    from repro_torch.distributed.sharding import full_tensor
    from repro_torch.launch.train import train

    dev = _card()
    cfg = smoke_config(arch).replace(dtype="float32", remat=True)
    runs = [train(cfg, 1, 32, 4, str(tmp_path / str(i)), ckpt_every=100, device=dev,
                  log_every=100, mesh=mesh) for i, mesh in enumerate((None, card_mesh))]
    plain, meshed = runs
    assert hasattr(meshed["params"]["embed.vocab"], "placements")
    for k in ("losses", "grad_norms"):
        np.testing.assert_allclose(meshed[k], plain[k], rtol=1e-4)
    for k, p in plain["params"].items():
        torch.testing.assert_close(full_tensor(meshed["params"][k]).detach(), p.detach(),
                                   rtol=1e-4, atol=1e-4)
