"""The port's pack/unpack against the JAX reference, bit for bit.

The sweeps of ``tests/test_kernels.py`` (2D vectors, element types,
offsets, 3D subarrays, halo faces, incount, contiguous and 1D, user
buffers) run the same datatypes and the same bytes, made from a seed
with numpy, through ``repro.kernels.pack``/``unpack`` (Pallas in
interpret mode, as the reference's own tests run it) and through
``repro_torch.kernels.pack``/``unpack`` on the CPU, under every strategy
with a kernel (``rows``, ``dma``, ``xla``, ``auto``).  On the CPU the
port's kernel wrappers take their plain versions; the kernels themselves
are held against those plain versions on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import repro.core as rc
import repro_torch.core as tc
from repro.comm.api import DMA as REF_DMA
from repro.comm.api import ROWS as REF_ROWS
from repro.kernels import pack as ref_pack
from repro.kernels import plan_geometry as ref_plan_geometry
from repro.kernels import unpack as ref_unpack
from repro_torch.comm.api import DMA, ROWS
from repro_torch.kernels import (
    launch_counts,
    pack,
    plan_geometry,
    reset_launch_counts,
    unpack,
)
from repro_torch.kernels.pack import (
    DMA_PATHS,
    NARROW_ROW_BYTES,
    SECTOR_BYTES,
    THREADS,
    VECTOR_BYTES,
    block_index,
    block_sectors,
    dma_args,
    narrow_tile_rows,
    pack_dma,
    pack_plain,
    pack_rows,
    row_path,
    vector_bytes,
)
from repro_torch.kernels.unpack import unpack_dma, unpack_plain, unpack_rows

REF_REG = rc.TypeRegistry()
REG = tc.TypeRegistry()
RNG = np.random.default_rng(1234)

STRATEGIES = ("rows", "dma", "xla", "auto")
SEMANTIC_FIELDS = ("word_bytes", "lanes", "rows", "planes", "pitch", "q", "r", "plane_rows")


def port(dt):
    """The port's datatype with the same description as a reference one."""
    cls = getattr(tc, type(dt).__name__)
    fields = {}
    for f in dataclasses.fields(dt):
        v = getattr(dt, f.name)
        fields[f.name] = port(v) if isinstance(v, rc.Datatype) else v
    return cls(**fields)


def port_block(sb):
    return tc.StridedBlock(sb.start, sb.counts, sb.strides)


def rand_bytes(n):
    return RNG.integers(0, 256, size=(n,), dtype=np.uint8)


def check_semantic_geometry(ref_sb, sb):
    ref_geom, geom = ref_plan_geometry(ref_sb), plan_geometry(sb)
    assert (ref_geom is None) == (geom is None)
    if geom is not None:
        for f in SEMANTIC_FIELDS:
            assert getattr(geom, f) == getattr(ref_geom, f), f


def check_roundtrip(dt, strategies=STRATEGIES, incount=1):
    ref_ct, ct = REF_REG.commit(dt), REG.commit(port(dt))
    assert ct.fingerprint == ref_ct.fingerprint
    need = ref_ct.extent * incount
    buf, dst = rand_bytes(need + 37), rand_bytes(need + 37)  # ragged tail
    for strat in strategies:
        want = np.asarray(ref_pack(jnp.asarray(buf), ref_ct, incount=incount, strategy=strat))
        got = pack(torch.from_numpy(buf.copy()), ct, incount, strat)
        assert tuple(got.shape) == (ct.size * incount,)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"pack:{strat}")
        want_dst = np.asarray(
            ref_unpack(jnp.asarray(dst), jnp.asarray(want), ref_ct, incount=incount,
                       strategy=strat)
        )
        d = torch.from_numpy(dst.copy())
        assert unpack(d, got, ct, incount, strat) is d  # in place
        np.testing.assert_array_equal(d.numpy(), want_dst, err_msg=f"unpack:{strat}")
    if ref_ct.block is not None and ref_ct.block.ndims in (2, 3):
        check_semantic_geometry(ref_ct.block, ct.block)


# ---------------------------------------------------------------------------
# the reference's sweeps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("blocklen_bytes", [8, 32, 100, 128])
@pytest.mark.parametrize("count", [1, 2, 13, 64])
def test_pack_2d_vector_sweep(blocklen_bytes, count):
    check_roundtrip(rc.Vector(count, blocklen_bytes, 512, rc.BYTE))


@pytest.mark.parametrize("named", [rc.BYTE, rc.INT16, rc.FLOAT, rc.FLOAT16, rc.INT32])
def test_pack_2d_dtype_sweep(named):
    w = named.extent
    check_roundtrip(rc.Vector(24, 96 // w, 640 // w, named))


@pytest.mark.parametrize("start", [0, 1, 3, 64, 129])
def test_pack_2d_offsets(start):
    check_roundtrip(rc.Subarray((256, 40), (100, 24), (start, 7), rc.BYTE))


@pytest.mark.parametrize(
    "alloc,ext,starts",
    [
        ((64, 32, 16), (40, 13, 7), (8, 3, 2)),
        ((256, 8, 4), (100, 8, 4), (0, 0, 0)),
        ((128, 16, 8), (128, 5, 3), (0, 2, 1)),
        ((512, 4, 4), (12, 3, 2), (64, 1, 1)),
        ((32, 32, 32), (4, 32, 32), (28, 0, 0)),
    ],
)
def test_pack_3d_subarray_sweep(alloc, ext, starts):
    check_roundtrip(rc.Subarray(alloc, ext, starts, rc.BYTE))


@pytest.mark.parametrize("named", [rc.BYTE, rc.FLOAT])
@pytest.mark.parametrize("region", ["face", "edge", "corner"])
def test_pack_3d_halo_faces(named, region):
    n, r = 32, 2
    alloc = (n * named.extent, n, n) if named is rc.BYTE else (n, n, n)
    dt = {
        "face": rc.Subarray(alloc, (r, n, n), (0, 0, 0), named),
        "edge": rc.Subarray(alloc, (r, r, n), (4, 4, 0), named),
        "corner": rc.Subarray(alloc, (r, r, r), (n - r, n - r, n - r), named),
    }[region]
    check_roundtrip(dt)


@pytest.mark.parametrize("incount", [1, 2, 3])
def test_incount(incount):
    check_roundtrip(rc.Vector(6, 20, 50, rc.BYTE), incount=incount)
    check_roundtrip(
        rc.Subarray((64, 8, 4), (16, 4, 2), (4, 1, 1), rc.BYTE),
        strategies=("rows", "dma", "auto"),
        incount=incount,
    )


def test_contig_and_1d():
    check_roundtrip(rc.Contiguous(1000, rc.FLOAT), strategies=("auto",))
    check_roundtrip(rc.Subarray((4096,), (100,), (30,), rc.BYTE), strategies=("auto",))


def test_user_dtype_buffers():
    """pack takes any contiguous tensor (a byte view); unpack writes into
    it in place, keeping its shape and dtype."""
    dt = rc.Vector(8, 16, 48, rc.FLOAT)
    ref_ct, ct = REF_REG.commit(dt), REG.commit(port(dt))
    arr = RNG.normal(size=(64, 64)).astype(np.float32)
    want = np.asarray(ref_pack(jnp.asarray(arr), ref_ct))
    got = pack(torch.from_numpy(arr.copy()), ct)
    np.testing.assert_array_equal(got.numpy(), want)
    want_out = np.asarray(ref_unpack(jnp.zeros((64, 64), jnp.float32), jnp.asarray(want), ref_ct))
    out = torch.zeros((64, 64), dtype=torch.float32)
    assert unpack(out, got, ct) is out
    assert out.shape == (64, 64) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), want_out)


def test_geometry_semantic_fields_match_the_reference():
    ref_ct, ct = REF_REG.commit(rc.Vector(13, 25, 128, rc.FLOAT)), REG.commit(
        port(rc.Vector(13, 25, 128, rc.FLOAT))
    )
    check_semantic_geometry(ref_ct.block, ct.block)
    g = plan_geometry(ct.block)
    assert (g.word_bytes, g.lanes, g.pitch, g.rows, g.planes) == (4, 25, 128, 13, 1)
    assert g.overfetch == pytest.approx(128 / 25)
    assert g.packed_bytes == ct.size and not g.interleaved


def test_planner_rejects_straddle_and_bad_plane_stride():
    assert plan_geometry(tc.StridedBlock(200, (100, 5), (1, 256))) is None
    assert plan_geometry(tc.StridedBlock(0, (8, 4, 2), (1, 32, 100))) is None


# ---------------------------------------------------------------------------
# planes that share rows: the last plane wins, as in the reference's
# sequential grid (rows switches to the dma kernel, the reference's rule)
# ---------------------------------------------------------------------------

INTERLEAVED = [
    rc.StridedBlock(4, (8, 6, 3), (1, 16, 32)),     # W = 4, plane_rows 2 < rows 6
    rc.StridedBlock(1, (5, 4, 5), (1, 7, 7)),       # W = 1, plane_rows 1
    rc.StridedBlock(2, (6, 3, 4), (1, 10, 20)),     # W = 2, plane_rows 2
]


@pytest.mark.parametrize("k", range(len(INTERLEAVED)))
@pytest.mark.parametrize("which", ["dma", "rows"])
def test_interleaved_planes_unpack_like_the_reference(k, which):
    ref_sb = INTERLEAVED[k]
    sb = port_block(ref_sb)
    geom = plan_geometry(sb)
    assert geom is not None and geom.interleaved
    check_semantic_geometry(ref_sb, sb)
    n = geom.span_bytes + 11
    dst, packed = rand_bytes(n), rand_bytes(ref_sb.size)
    ref_strat, strat = {"dma": (REF_DMA, DMA), "rows": (REF_ROWS, ROWS)}[which]
    want = np.asarray(
        ref_strat.unpack_leaf(jnp.asarray(dst), jnp.asarray(packed), ref_sb,
                              ref_plan_geometry(ref_sb), True)
    )
    d = torch.from_numpy(dst.copy()).view(1, -1)
    strat.unpack_leaf(d, torch.from_numpy(packed.copy()).view(1, -1), sb, geom)
    np.testing.assert_array_equal(d.view(-1).numpy(), want)


def test_unpack_rows_refuses_interleaved_planes():
    geom = plan_geometry(port_block(INTERLEAVED[0]))
    dst = torch.zeros((1, geom.span_bytes), dtype=torch.uint8)
    with pytest.raises(ValueError, match="unpack_dma"):
        unpack_rows(dst, torch.zeros((1, geom.packed_bytes), dtype=torch.uint8), geom)


# ---------------------------------------------------------------------------
# the kernel wrappers on the CPU
# ---------------------------------------------------------------------------

def _batch(geom, batch):
    src = torch.from_numpy(RNG.integers(0, 256, size=(batch, geom.span_bytes + 8),
                                        dtype=np.uint8))
    return src


@pytest.mark.parametrize("batch", [1, 8])
def test_wrappers_take_the_plain_version_on_the_cpu(batch):
    """On a CPU tensor every wrapper runs its plain version, launches no
    kernel, and a batch of buffers equals the buffers one by one."""
    geom = plan_geometry(port_block(rc.StridedBlock(12, (8, 5, 3), (1, 40, 400))))
    src = _batch(geom, batch)
    reset_launch_counts()
    want = pack_plain(src, geom, torch.empty((batch, geom.packed_bytes), dtype=torch.uint8))
    for fn in (pack_rows, pack_dma):
        np.testing.assert_array_equal(fn(src, geom).numpy(), want.numpy())
    for b in range(batch):
        np.testing.assert_array_equal(pack_rows(src[b : b + 1], geom).numpy(), want[b : b + 1].numpy())
    dst0 = _batch(geom, batch)
    want_dst = unpack_plain(dst0.clone(), want, geom)
    for fn in (unpack_rows, unpack_dma):
        d = dst0.clone()
        assert fn(d, want, geom) is d
        np.testing.assert_array_equal(d.numpy(), want_dst.numpy())
    from repro_torch.halo import STENCIL26
    from repro_torch.kernels.ops import (
        stencil_window_pair,
        stencil_window_plain,
        stencil_window_update,
    )

    arr = torch.randn((batch, 6, 5, 7), dtype=torch.float32)
    win = ((1, 1, 1), (4, 3, 5))
    assert torch.equal(stencil_window_update(arr, STENCIL26.offsets, 0.4, *win),
                       stencil_window_plain(arr, STENCIL26.offsets, 0.4, *win))
    stencil_window_pair(arr, STENCIL26.offsets, (0.4, 0.3), *win)
    assert launch_counts() == {"pack_rows": 0, "pack_dma": 0, "unpack_rows": 0, "unpack_dma": 0,
                               "stencil": 0, "stencil_runtime": 0, "stencil_pairs": 0,
                               "splice_copies": 0, "graph_captures": 0, "graph_replays": 0}


def test_wrappers_refuse_what_the_kernels_do_not_take():
    geom = plan_geometry(port_block(rc.StridedBlock(12, (8, 5, 3), (1, 40, 400))))
    out = torch.empty((1, geom.packed_bytes), dtype=torch.uint8)
    with pytest.raises(ValueError, match="spans"):
        pack_rows(torch.zeros((1, geom.span_bytes - 1), dtype=torch.uint8), geom, out)
    with pytest.raises(TypeError):
        pack_dma(torch.zeros((1, geom.span_bytes), dtype=torch.int32), geom, out)
    with pytest.raises(ValueError, match="shape"):
        pack_rows(torch.zeros((2, geom.span_bytes), dtype=torch.uint8), geom, out)


# ---------------------------------------------------------------------------
# the stencil window primitives (jnp in the reference, plain torch here)
# ---------------------------------------------------------------------------

def test_stencil_primitives_match_the_reference():
    """Same offsets, same accumulation order; 2e-6 as in the reference's
    stencil test (XLA may contract multiply-adds)."""
    from repro.halo.stencil import StencilOp as RefStencilOp
    from repro.kernels import ops as rops
    from repro_torch.kernels import ops

    arr = RNG.normal(size=(9, 8, 7)).astype(np.float32)
    a, j = torch.from_numpy(arr.copy()), jnp.asarray(arr)
    op, op2 = RefStencilOp((1, 1, 1)), RefStencilOp((2, 1, 1), 0.3)
    origin, shape = (1, 1, 1), (7, 6, 5)
    tol = dict(rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(
        ops.shifted_window_sum(a, op.offsets, origin, shape).numpy(),
        np.asarray(rops.shifted_window_sum(j, op.offsets, origin, shape)), **tol)
    np.testing.assert_allclose(
        ops.stencil_window_update(a, op2.offsets, op2.weight, (2, 1, 1), (5, 6, 5)).numpy(),
        np.asarray(rops.stencil_window_update(j, op2.offsets, op2.weight, (2, 1, 1), (5, 6, 5))),
        **tol)
    stages = [(o.offsets, o.weight, o.radii) for o in (op, op2)]
    got, want = ops.stencil_window_chain(a, stages), rops.stencil_window_chain(j, stages)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want] == [(7, 6, 5), (3, 4, 3)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)
    with pytest.raises(ValueError, match="too small"):
        ops.stencil_window_chain(a, stages * 2)


def test_stencil_primitives_update_every_rank_at_once():
    """A leading rank dimension changes nothing per rank, bit for bit."""
    from repro_torch.halo import STENCIL26
    from repro_torch.kernels import ops

    arr = torch.from_numpy(RNG.normal(size=(3, 8, 7, 6)).astype(np.float32))
    args = (STENCIL26.offsets, STENCIL26.weight, (1, 1, 1), (6, 5, 4))
    batched = ops.stencil_window_update(arr, *args)
    for r in range(3):
        assert torch.equal(batched[r], ops.stencil_window_update(arr[r], *args))


def test_byte_and_word_views_share_storage():
    from repro_torch.kernels import ops

    x = torch.arange(12, dtype=torch.float32).view(3, 4)
    b = ops.byte_view(x)
    assert b.dtype == torch.uint8 and b.numel() == 48 and b.data_ptr() == x.data_ptr()
    words = ops.as_words(b, 4)
    words[5] = 0
    assert x[1, 1] == 0
    assert torch.equal(ops.unbyte_view(b, torch.float32, (3, 4)), x)
    with pytest.raises(ValueError, match="contiguous"):
        ops.byte_view(x.t())


def test_misaligned_operands_take_one_byte_words():
    """A packed slot at an odd wire offset cannot be addressed in 4-byte
    words: the kernels then run the same bytes as 1-byte words."""
    from repro_torch.kernels import ops

    sb = port_block(rc.StridedBlock(64, (8, 4), (1, 16)))
    geom = plan_geometry(sb)
    assert geom.word_bytes == 4
    buf = torch.zeros((2, 256), dtype=torch.uint8)
    wire = torch.zeros((2, 64), dtype=torch.uint8)
    assert ops._fit(geom, sb, buf, wire[:, 16:48]) is geom
    odd = ops._fit(geom, sb, buf, wire[:, 15:47])
    assert odd.word_bytes == 1
    assert (odd.packed_bytes, odd.span_bytes) == (geom.packed_bytes, geom.span_bytes)


# ---------------------------------------------------------------------------
# the row kernels' vector width and path, chosen on the host
# ---------------------------------------------------------------------------


def _row_addresses(geom, a, b):
    """Byte address of every row start the row kernels form on the
    strided ``a`` and the packed ``b`` (all buffers of the batch)."""
    w = geom.word_bytes
    bi = np.arange(a.shape[0], dtype=np.int64).reshape(-1, 1, 1)
    p = np.arange(geom.planes, dtype=np.int64).reshape(1, -1, 1)
    i = np.arange(geom.rows, dtype=np.int64).reshape(1, 1, -1)
    row = geom.q + p * geom.plane_rows + i
    strided = a.data_ptr() + bi * a.stride(0) + (row * geom.pitch + geom.r) * w
    packed = b.data_ptr() + bi * b.stride(0) + (p * geom.rows + i) * geom.lanes * w
    return np.concatenate([strided.ravel(), packed.ravel()])


def check_vector_bytes(geom, a, b):
    """V divides every address the kernel forms and the row length, it is
    the widest width that does, and it lies in [W, 16]."""
    v = vector_bytes(geom, a, b)
    assert v in VECTOR_BYTES and geom.word_bytes <= v <= 16
    addrs, length = _row_addresses(geom, a, b), geom.lanes * geom.word_bytes
    assert length % v == 0 and not (addrs % v).any()
    if v < 16:  # no wider vector divides them all
        assert length % (2 * v) or (addrs % (2 * v)).any()
    return v


@pytest.fixture(scope="module")
def full_width_halo():
    """The 26 send and 26 receive geometries of the full-width halo
    (8 ranks, 256^3 float32 per rank, radius 2) as the ``tempi`` exchange
    hands them to the kernels: the ``(8, n)`` state, and the send slots
    and received payloads at the wire offsets of the local mesh."""
    from repro_torch.comm import Communicator
    from repro_torch.halo import HaloSpec, make_halo_plan
    from repro_torch.kernels import ops

    spec = HaloSpec(grid=(2, 2, 2), interior=(256, 256, 256), radius=2)
    comm = Communicator(device="cpu")
    plan = make_halo_plan(spec, comm)
    state = ops.batch_bytes(torch.empty((spec.nranks,) + spec.alloc), True)  # never touched
    wire = torch.zeros((spec.nranks, plan.wire.wire_bytes), dtype=torch.uint8)
    received = comm.transport.exchange(wire, plan.wire)
    recv_slot = {}
    for g, grp in enumerate(plan.wire.groups):
        for i, off in zip(grp.transfers, grp.offsets):
            recv_slot[i] = received[g][:, off : off + plan.wire.segments[i].nbytes]
    cases = []
    for i, (send_ct, recv_ct) in enumerate(zip(plan.send_cts, plan.recv_cts)):
        seg = plan.wire.segments[i]
        send_slot = wire[:, seg.offset : seg.offset + seg.nbytes]
        for side, ct, slot in (("send", send_ct, send_slot), ("recv", recv_ct, recv_slot[i])):
            sb = ct.block
            cases.append((side, i, ops._fit(plan_geometry(sb), sb, state, slot), slot))
    return plan, state, cases


@pytest.mark.parametrize("k", range(52))
def test_vector_bytes_on_the_full_width_halo(full_width_halo, k):
    """Every region row starts at byte 8 mod 16 or is 8 bytes long, and
    every wire slot is 16-byte aligned: V is 8 for all 52 geometries,
    the y and z faces among them."""
    from repro_torch.halo import DIRECTIONS

    _, state, cases = full_width_halo
    side, i, geom, slot = cases[k]
    assert geom.word_bytes == 4
    assert check_vector_bytes(geom, state, slot) == 8
    d = DIRECTIONS[i]
    if d[2] == 0 and (d[0] == 0) != (d[1] == 0):  # a y or z face
        assert (geom.lanes, geom.lanes * 4 // 8) == (256, 128)
        assert row_path(geom, 8) == "warp"


def test_tempi_plan_launches_the_row_kernels_at_16_regions(full_width_halo):
    """The model still picks ``rows`` for the z and y faces, the dx = 0
    edges and the corners (16 regions), and ``dma`` for the rest."""
    plan, _, _ = full_width_halo
    names = [s.name for s in plan.strategies]
    assert (names.count("rows"), names.count("dma")) == (16, 10)


def _geom(start, counts, strides, word=None):
    return plan_geometry(tc.StridedBlock(start, counts, strides), word_bytes=word)


@pytest.mark.parametrize(
    "geom_args,buf_off,slot_off,batch,bwidth_pad,want",
    [
        # aligned operands: the block alone sets V
        (((0, (1024, 3, 2), (1, 2048, 8192)), None), 0, 0, 8, 0, 16),
        (((8, (1024, 4, 2), (1, 1040, 4160)), None), 0, 0, 8, 0, 8),   # halo face
        (((4, (1024, 3, 2), (1, 1040, 4160)), None), 0, 0, 8, 0, 4),   # rows at 4 mod 8
        (((0, (1036, 3, 2), (1, 2048, 8192)), None), 0, 0, 8, 0, 4),   # 1036-byte rows
        (((2, (514, 3, 2), (1, 1030, 4120)), None), 0, 0, 8, 0, 2),    # W = 2
        (((3, (513, 3, 2), (1, 1027, 4108)), None), 0, 0, 8, 0, 1),    # W = 1
        (((0, (1024, 3, 2), (1, 2048, 8192)), 1), 0, 0, 8, 0, 16),     # W = 1, V = 16
        # misaligned operands: V drops to W
        (((8, (1024, 4, 2), (1, 1040, 4160)), None), 0, 4, 8, 0, 4),   # slot 4 B into a wire
        (((8, (1024, 4, 2), (1, 1040, 4160)), None), 4, 0, 8, 0, 4),   # buffer at 4 mod 8
        (((8, (1024, 4, 2), (1, 1040, 4160)), None), 0, 0, 8, 4, 4),   # batch stride 4 mod 8
        (((8, (1024, 4, 2), (1, 1040, 4160)), 1), 0, 0, 8, 1, 1),      # odd batch stride
        (((2, (514, 3, 2), (1, 1030, 4120)), None), 0, 2, 8, 0, 2),    # W = 2, slot at 2 mod 4
        # one buffer: its batch stride is never used
        (((8, (1024, 4, 2), (1, 1040, 4160)), 1), 0, 0, 1, 1, 8),
    ],
)
def test_vector_bytes_follows_pointers_strides_and_rows(geom_args, buf_off, slot_off, batch,
                                                        bwidth_pad, want):
    (start, counts, strides), word = geom_args
    geom = _geom(start, counts, strides, word)
    n = (geom.span_bytes + 15) // 16 * 16 + bwidth_pad
    buf = torch.zeros((batch, n + 16), dtype=torch.uint8)[:, buf_off : buf_off + n]
    wire = torch.zeros((batch, geom.packed_bytes + 16), dtype=torch.uint8)
    slot = wire[:, slot_off : slot_off + geom.packed_bytes]
    assert buf.data_ptr() % 16 == buf_off and wire.data_ptr() % 16 == 0
    assert check_vector_bytes(geom, buf, slot) == want


@pytest.mark.parametrize(
    "counts,word,vec,want",
    [
        ((1024, 4, 2), None, 8, "warp"),   # y/z face rows: 128 vectors
        ((256, 4, 2), None, 8, "warp"),    # exactly one vector per lane
        ((248, 4, 2), None, 8, "flat"),    # 31 vectors
        ((8, 2, 2), None, 8, "flat"),      # a corner: one vector per row
        ((1024, 4, 2), 1, 1, "warp"),
        ((16, 4, 2), None, 16, "flat"),
    ],
)
def test_row_path_takes_a_warp_per_row_of_32_vectors_or_more(counts, word, vec, want):
    geom = _geom(8 if counts[0] % 8 == 0 else 0, counts, (1, 1040, 4160), word)
    assert row_path(geom, vec) == want


# ---------------------------------------------------------------------------
# the dma kernels' plan: vector width, path and rows per tile
# ---------------------------------------------------------------------------


def narrow_tiles(n, tile_rows):
    """The rows each thread of each tile takes on the narrow path, as
    ``csrc/narrow.cuh`` assigns them: a tile of ``tile_rows`` runs on
    min(THREADS, tile_rows) threads, thread k takes rows j0 + k,
    j0 + k + threads, ... of its tile."""
    threads = min(THREADS, tile_rows)
    return [[list(range(j0 + k, min(j0 + tile_rows, n), threads)) for k in range(threads)]
            for j0 in range(0, n, tile_rows)]


def check_narrow_tiles(geom, batch, tile_rows):
    """The tiles cover every flattened row of a buffer exactly once, and
    every thread of every tile but the last has the same number of rows,
    at least one."""
    n = geom.planes * geom.rows
    tiles = narrow_tiles(n, tile_rows)
    assert sorted(j for tile in tiles for rows in tile for j in rows) == list(range(n))
    for tile in tiles[:-1]:
        assert {len(rows) for rows in tile} == {tile_rows // len(tile)}
        assert tile_rows % len(tile) == 0
    return len(tiles)


@pytest.mark.parametrize("k", range(10))
def test_dma_plan_on_the_full_width_halo(full_width_halo, k):
    """The 10 ``dma`` regions of the ``tempi`` plan (x faces, dy = 0 and
    dz = 0 edges) send and receive 8-byte rows: the narrow path at V = 8.
    The x faces (65,536 rows a buffer) take 512-row tiles, 2 rows a
    thread; the edges (512 rows) 32-row tiles, 128 of them for 8 ranks."""
    from repro_torch.halo import DIRECTIONS

    plan, state, cases = full_width_halo
    regions = [i for i, s in enumerate(plan.strategies) if s.name == "dma"]
    assert len(regions) == 10
    for side, i, geom, slot in cases:
        if i != regions[k]:
            continue
        vec, path, tile_rows = dma_args(geom, state, slot)
        assert (geom.lanes * geom.word_bytes, vec, DMA_PATHS[path]) == (8, 8, "narrow")
        assert vec == check_vector_bytes(geom, state, slot)
        tiles = check_narrow_tiles(geom, state.shape[0], tile_rows)
        if DIRECTIONS[i][0] == 0 and DIRECTIONS[i][1] == 0:  # an x face
            assert (geom.rows * geom.planes, tile_rows, tiles) == (65536, 512, 128)
        else:
            assert (geom.rows * geom.planes, tile_rows) == (512, 32)
            assert state.shape[0] * tiles == 128


# the CPU tests' sweep blocks and the vector cases of the card tests:
# (block, narrow?); the interleaved-plane blocks are all narrow
DMA_BLOCKS = [(port_block(sb), True) for sb in INTERLEAVED] + [
    (tc.StridedBlock(8, (8, 2, 2), (1, 1040, 4160)), True),       # a halo corner
    (tc.StridedBlock(8, (8, 64, 4), (1, 1040, 66560)), True),     # a cut x face
    (tc.StridedBlock(16, (12, 5, 2), (1, 64, 320)), True),        # 12-byte rows, V = 4
    (tc.StridedBlock(16, (16, 5, 3), (1, 64, 512)), True),        # one 16-byte vector
    (tc.StridedBlock(1, (13, 4, 2), (1, 100, 500)), True),        # W = 1
    (tc.StridedBlock(12, (8, 5, 3), (1, 40, 400)), True),
    (tc.StridedBlock(0, (24, 5), (1, 64)), False),                # 24-byte rows: tiled
    (tc.StridedBlock(4, (1040, 4, 3), (1, 2080, 10400)), False),
]


@pytest.mark.parametrize("k", range(len(DMA_BLOCKS)))
@pytest.mark.parametrize("batch", [1, 8])
def test_dma_plan_on_the_sweep_blocks(k, batch):
    """Rows of at most 16 bytes take the narrow path, longer ones the
    tiled path in W-byte words.  On the narrow path the per-row rule of
    the unpack kernel (skip row i of plane p when p + 1 < planes and
    i >= plane_rows) writes each byte once and gives the plain version's
    bytes, whatever order the rows run in."""
    sb, narrow = DMA_BLOCKS[k]
    geom = plan_geometry(sb)
    buf = torch.from_numpy(RNG.integers(0, 256, size=(batch, (geom.span_bytes + 15) // 16 * 16),
                                        dtype=np.uint8))
    packed = torch.from_numpy(RNG.integers(0, 256, size=(batch, geom.packed_bytes),
                                           dtype=np.uint8))
    vec, path, tile_rows = dma_args(geom, buf, packed)
    assert (DMA_PATHS[path] == "narrow") == narrow
    assert (geom.lanes * geom.word_bytes <= NARROW_ROW_BYTES) == narrow
    if not narrow:
        assert (vec, tile_rows) == (geom.word_bytes, 0)
        return
    assert vec == check_vector_bytes(geom, buf, packed)
    check_narrow_tiles(geom, batch, tile_rows)
    idx = block_index(geom, "cpu").reshape(geom.planes * geom.rows, -1)
    rows = packed.reshape(batch, geom.planes * geom.rows, -1)
    got, written = buf.clone(), torch.zeros(buf.shape[1], dtype=torch.int64)
    for j in RNG.permutation(geom.planes * geom.rows):
        p, i = divmod(int(j), geom.rows)
        if p + 1 < geom.planes and i >= geom.plane_rows:
            continue
        got[:, idx[j]] = rows[:, j]
        written[idx[j]] += 1
    assert written.max() == 1
    assert torch.equal(got, unpack_plain(buf.clone(), packed, geom))


@pytest.mark.parametrize(
    "n,batch,want",
    [
        (65536, 8, 512),    # x faces: 2 rows a thread
        (512, 8, 32),       # edges: 128 tiles of a warp
        (512, 1, 32),
        (5000, 8, 256),     # 160 tiles of 256 rows
        (40000, 8, 512),    # a ragged last tile of 64 rows
        (10, 8, 32),        # one ragged tile a buffer
        (4, 1, 32),
    ],
)
def test_narrow_tiles_spread_over_the_sms(n, batch, want):
    geom = plan_geometry(tc.StridedBlock(8, (8, n), (1, 1040)))
    tile_rows = narrow_tile_rows(geom, batch)
    assert tile_rows == want
    tiles = check_narrow_tiles(geom, batch, tile_rows)
    assert batch * tiles >= 128 or tile_rows == 32 or tile_rows // 2 < n <= tile_rows


def brute_sectors(geom):
    """(touched, whole) from every block byte: the plain count."""
    sectors, counts = (block_index(geom, "cpu").reshape(-1).unique() // SECTOR_BYTES).unique(
        return_counts=True)
    return len(sectors), int((counts == SECTOR_BYTES).sum())


@pytest.mark.parametrize(
    "sb,word",
    [
        (tc.StridedBlock(8, (8, 256, 256), (1, 1040, 270400)), None),   # full-width x face
        (tc.StridedBlock(8, (8, 64, 4), (1, 1040, 66560)), None),
        (tc.StridedBlock(8, (1024, 4, 2), (1, 1040, 4160)), None),      # rows cross sectors
        (tc.StridedBlock(8, (8, 200, 200), (1, 40, 8000)), None),
        (tc.StridedBlock(4, (8, 20, 3), (1, 12, 240)), None),           # pitch under 32
        (tc.StridedBlock(0, (4, 50), (1, 8)), None),
        (tc.StridedBlock(0, (64, 10), (1, 64)), None),                  # contiguous rows
        (tc.StridedBlock(48, (48, 10), (1, 48)), None),                 # ... from mid-sector
        (tc.StridedBlock(3, (5, 7, 2), (1, 33, 231)), None),            # W = 1
        (tc.StridedBlock(0, (1024, 3, 2), (1, 2048, 8192)), 1),
    ] + [(port_block(sb), None) for sb in INTERLEAVED],                 # planes share rows
)
def test_block_sectors_counts_what_block_index_touches(sb, word):
    geom = plan_geometry(sb, word_bytes=word)
    assert block_sectors(geom) == brute_sectors(geom)
