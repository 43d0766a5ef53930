"""Strided pack kernels for Hopper, with their plain-torch versions.

Two kernels cover every canonical 2D/3D StridedBlock (paper §3.3: "each
MPI datatype is mapped to one of two kernel implementations
parameterized by W"):

* :func:`pack_rows` — the paper's "device" kernel: a SIMT grid over the
  block's rows in V-byte vectors (``csrc/rows.cuh``, entry
  ``tempi_pack_rows`` in ``csrc/pack.cu``).  The host picks V
  (:func:`vector_bytes`) and the path (:func:`row_path`) at each launch.
* :func:`pack_dma`  — tiles staged through shared memory with
  ``cp.async``, then stored contiguously (``tempi_pack_dma``).  Rows of
  at most 16 bytes take its narrow path (``csrc/narrow.cuh``): a tile is
  a run of rows across planes, one V-byte copy a row.  The host picks V,
  the path and the rows per tile (:func:`dma_args`) at each launch.

Both take a batch: ``src`` is a ``(B, n)`` uint8 tensor and one launch
packs the same block out of all ``B`` buffers into a ``(B, size)``
output (the local mesh packs a region for every rank at once).  Both are
driven by host scalars only (:class:`PackGeometry`) — no per-type
metadata in device memory.

The wrapper runs the kernel for a CUDA tensor and the plain version
(:func:`pack_plain`) only for a CPU tensor; anything else raises.  Each
wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.build import library
from repro_torch.kernels.geometry import PackGeometry

__all__ = [
    "pack_rows",
    "pack_dma",
    "pack_plain",
    "pack_compress_ragged",
    "pack_ragged",
    "aligned",
    "row_args",
    "row_path",
    "vector_bytes",
    "dma_args",
    "narrow_tile_rows",
    "block_index",
    "block_sectors",
    "check_operands",
    "launch",
]


# ---------------------------------------------------------------------------
# shared operand checks and launch
# ---------------------------------------------------------------------------

def _rowwise(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.uint8 or t.dim() != 2:
        raise TypeError(f"{name} must be a 2D uint8 tensor (batch, bytes); got "
                        f"{t.dtype} of shape {tuple(t.shape)}")
    if t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{name} must be contiguous along its last dimension")


def aligned(t: torch.Tensor, w: int) -> bool:
    """Whether the kernels can address ``t`` in ``w``-byte words: its
    pointer and its batch stride are multiples of ``w``."""
    return t.data_ptr() % w == 0 and (t.shape[0] <= 1 or t.stride(0) % w == 0)


def check_operands(
    buf: torch.Tensor, packed: torch.Tensor, geom: PackGeometry,
    buf_name: str = "src", packed_name: str = "out",
) -> None:
    """Raise on anything the kernels do not take: the buffer and the
    packed tensor are ``(B, n)`` / ``(B, packed_bytes)`` uint8 on one
    device, the buffer holds every block byte, and on the card both are
    aligned to the word W (pointer and batch stride)."""
    _rowwise(buf, buf_name)
    _rowwise(packed, packed_name)
    if buf.device != packed.device:
        raise ValueError(f"{buf_name} on {buf.device}, {packed_name} on {packed.device}")
    if buf.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {buf.device}")
    if tuple(packed.shape) != (buf.shape[0], geom.packed_bytes):
        raise ValueError(
            f"{packed_name} has shape {tuple(packed.shape)}; need "
            f"{(buf.shape[0], geom.packed_bytes)}"
        )
    if buf.shape[1] < geom.span_bytes:
        raise ValueError(
            f"{buf_name} holds {buf.shape[1]} bytes; the block spans "
            f"{geom.span_bytes}"
        )
    if buf.is_cuda:
        w = geom.word_bytes
        for t, name in ((buf, buf_name), (packed, packed_name)):
            if not aligned(t, w):
                raise ValueError(f"{name} is not aligned to the {w}-byte word")


def _base_and_plane_stride(geom: PackGeometry):
    """Word offset of block (0, 0) and the word stride between planes."""
    return geom.q * geom.pitch + geom.r, geom.plane_rows * geom.pitch


def launch(lib_name: str, entry: str, a: torch.Tensor, b: torch.Tensor,
           geom: PackGeometry, *extra: int) -> None:
    """Call one C entry on the current stream of ``a``'s device: ``a`` is
    the strided buffer side, ``b`` the packed side, ``extra`` the entry's
    own scalars (:func:`row_args`, :func:`dma_args`).  Raises if the
    launch was refused."""
    fn = getattr(library(lib_name), entry)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0), a.shape[0],
             geom.word_bytes, geom.lanes, geom.rows, geom.planes, geom.pitch,
             *_base_and_plane_stride(geom), *extra, a.device.index, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed with CUDA error {err}")


#: bytes the row kernels may move per load and store, widest first
VECTOR_BYTES = (16, 8, 4, 2, 1)

#: the row kernels' paths, by the number their C entries take
ROW_PATHS = ("flat", "warp")

#: rows of at least this many vectors (one per lane of a warp) take the
#: warp path; shorter rows are spread over a warp, one thread per vector
WARP_ROW_VECTORS = 32


def vector_bytes(geom: PackGeometry, a: torch.Tensor, b: torch.Tensor) -> int:
    """The vector width V, in bytes, of a row-kernel launch on the
    strided buffer ``a`` and the packed tensor ``b``: the widest of
    :data:`VECTOR_BYTES` that divides both pointers, both batch strides
    (when there is more than one buffer), the byte start of every row
    (the block's base, pitch and plane stride, times W) and the row
    length ``lanes * W``.  Every address the kernel forms is then a
    multiple of V, and a row is a whole number of vectors.  Never less
    than W for operands :func:`check_operands` takes."""
    w = geom.word_bytes
    base, plane_stride = _base_and_plane_stride(geom)
    need = [a.data_ptr(), b.data_ptr(), geom.lanes * w, geom.pitch * w,
            base * w, plane_stride * w]
    if a.shape[0] > 1:
        need += [a.stride(0), b.stride(0)]
    return next(v for v in VECTOR_BYTES if all(x % v == 0 for x in need))


def row_path(geom: PackGeometry, vec: int) -> str:
    """``"warp"`` (a warp per row chunk) when a row holds at least
    :data:`WARP_ROW_VECTORS` vectors of ``vec`` bytes, else ``"flat"``
    (one thread per vector, several rows per warp)."""
    nvec = geom.lanes * geom.word_bytes // vec
    return "warp" if nvec >= WARP_ROW_VECTORS else "flat"


def row_args(geom: PackGeometry, a: torch.Tensor, b: torch.Tensor):
    """The row kernels' own C scalars: V in bytes and the path number."""
    vec = vector_bytes(geom, a, b)
    return vec, ROW_PATHS.index(row_path(geom, vec))


#: the dma kernels' paths, by the number their C entries take
DMA_PATHS = ("tiled", "narrow")

#: longest row, in bytes, the dma kernels' narrow path takes
#: (``kNarrowRowBytes`` in ``csrc/narrow.cuh``); longer rows are tiled
NARROW_ROW_BYTES = 16

#: threads of a full thread block (``kThreads`` in ``csrc/common.cuh``);
#: a narrow tile of R rows runs on min(THREADS, R) threads
THREADS = 256

#: rows per thread of a full narrow tile: THREADS * 2 = 512 rows, 4 KB of
#: the halo's 8-byte rows.  Of 2, 4 and 8 rows a thread, 2 was the
#: fastest at the halo's x faces for both kernels (PERF.md)
NARROW_ROWS_PER_THREAD = 2

#: fewest rows per narrow tile: one warp, one row per thread
NARROW_MIN_TILE_ROWS = 32

#: tiles a narrow launch aims for, about one per SM of an H100 (132)
NARROW_MIN_TILES = 128


def narrow_tile_rows(geom: PackGeometry, batch: int) -> int:
    """Rows per tile of a narrow dma launch over ``batch`` buffers: a
    power of two from :data:`NARROW_MIN_TILE_ROWS` to ``THREADS *
    NARROW_ROWS_PER_THREAD``, halved while half a tile still holds all
    of a buffer's rows or the launch has fewer than
    :data:`NARROW_MIN_TILES` tiles.  A tile's threads then all have the
    same number of rows, except in a buffer's last tile."""
    n = geom.planes * geom.rows
    tile = THREADS * NARROW_ROWS_PER_THREAD
    while tile > NARROW_MIN_TILE_ROWS and (
        tile // 2 >= n or batch * -(-n // tile) < NARROW_MIN_TILES
    ):
        tile //= 2
    return tile


def dma_args(geom: PackGeometry, a: torch.Tensor, b: torch.Tensor):
    """The dma kernels' own C scalars for a launch on the strided buffer
    ``a`` and the packed tensor ``b``: V in bytes, the path number and
    the rows per tile.  Rows of at most :data:`NARROW_ROW_BYTES` take the
    narrow path with V from :func:`vector_bytes`; longer rows the tiled
    path, which copies W-byte words in 16 KB tiles that it sizes itself
    (rows per tile 0)."""
    if geom.lanes * geom.word_bytes > NARROW_ROW_BYTES:
        return geom.word_bytes, DMA_PATHS.index("tiled"), 0
    return (vector_bytes(geom, a, b), DMA_PATHS.index("narrow"),
            narrow_tile_rows(geom, a.shape[0]))


def block_index(geom: PackGeometry, device) -> torch.Tensor:
    """Byte index of every block byte in packing order, shape
    ``(planes, rows * lanes * W)`` — the plain versions' gather/scatter
    map, computed from the geometry scalars alone."""
    w = geom.word_bytes
    p = torch.arange(geom.planes, device=device).view(-1, 1, 1)
    i = torch.arange(geom.rows, device=device).view(1, -1, 1)
    l = torch.arange(geom.lanes * w, device=device).view(1, 1, -1)
    rows = geom.q + p * geom.plane_rows + i
    return ((rows * geom.pitch + geom.r) * w + l).reshape(geom.planes, -1)


#: bytes of an L2 sector, the unit of memory traffic the sector bound counts
SECTOR_BYTES = 32


def block_sectors(geom: PackGeometry):
    """``(touched, whole)``: the 32-byte sectors that the block's bytes
    touch in one buffer that starts on a sector boundary, and how many of
    them the block covers whole.  Exact: rows that cross a sector
    boundary, several rows in one sector (pitches under 32 bytes) and
    planes that share rows all count once."""
    w, s = geom.word_bytes, SECTOR_BYTES
    p = torch.arange(geom.planes).view(-1, 1)
    i = torch.arange(geom.rows).view(1, -1)
    rows = torch.unique(geom.q + p * geom.plane_rows + i)  # sorted
    start = (rows * geom.pitch + geom.r) * w
    end = start + geom.lanes * w
    # merge rows whose bytes run on (lanes == pitch) into intervals [a, b)
    gap = torch.ones_like(start, dtype=torch.bool)
    gap[1:] = start[1:] != end[:-1]
    a, b = start[gap], end[torch.cat([gap[1:], gap.new_ones(1)])]
    first, last = a // s, (b - 1) // s
    before = torch.cat([last.new_full((1,), -1), last[:-1]])  # last sector so far
    touched = (last - torch.maximum(first - 1, before)).clamp(min=0).sum()
    # a sector that holds a gap between intervals is never whole
    whole = (b // s - (a + s - 1) // s).clamp(min=0).sum()
    return int(touched), int(whole)


# ---------------------------------------------------------------------------
# pack
# ---------------------------------------------------------------------------

def pack_plain(src: torch.Tensor, geom: PackGeometry, out: torch.Tensor) -> torch.Tensor:
    """Plain version of both pack kernels: gather the block bytes of
    every buffer of ``src`` into ``out`` (any device)."""
    idx = block_index(geom, src.device).reshape(-1)
    out.copy_(src[:, idx])
    return out


def _pack(entry: str, wrapper, src, geom, out, extra=None):
    if out is None:
        out = torch.empty((src.shape[0], geom.packed_bytes), dtype=torch.uint8,
                          device=src.device)
    check_operands(src, out, geom)
    if src.device.type == "cpu":
        return pack_plain(src, geom, out)
    launch("pack", entry, src, out, geom, *(extra(geom, src, out) if extra else ()))
    wrapper.launches += 1
    return out


def pack_rows(src: torch.Tensor, geom: PackGeometry,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pack the block out of every buffer of ``src`` (``(B, n)`` uint8)
    into ``out`` (``(B, packed_bytes)``, allocated if None) with the
    SIMT row kernel.  Returns ``out``."""
    return _pack("tempi_pack_rows", pack_rows, src, geom, out, row_args)


def pack_dma(src: torch.Tensor, geom: PackGeometry,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """As :func:`pack_rows`, with the shared-memory staged tile kernel."""
    return _pack("tempi_pack_dma", pack_dma, src, geom, out, dma_args)


pack_rows.launches = 0
pack_dma.launches = 0


# ---------------------------------------------------------------------------
# ragged wire assembly
# ---------------------------------------------------------------------------

def pack_ragged(buf: torch.Tensor, leaves, total: int) -> torch.Tensor:
    """:func:`pack_compress_ragged` with no encoder: ``leaves`` is a
    sequence of ``(offset, nbytes, pack_fn)``, each leaf's packed bytes
    written straight into its exact slot of the ``(B, total)`` wire."""
    return pack_compress_ragged(buf, [(o, n, f, None) for o, n, f in leaves], total)


def pack_compress_ragged(buf: torch.Tensor, leaves, total: int) -> torch.Tensor:
    """Pack (and encode) every leaf straight into its slot of a flat wire
    buffer.

    ``buf`` has the ranks (or any batch) on its leading dimension;
    ``leaves`` is a sequence of ``(offset, nbytes, pack_fn, encode_fn)``.
    With ``encode_fn=None`` the wire format is the packed bytes:
    ``pack_fn(buf, out)`` writes the leaf's payload into ``out``, the
    ``(B, nbytes)`` view of the wire at its exact byte ``offset``.  With
    an ``encode_fn`` (a wire compressor's encoder) ``pack_fn(buf, None)``
    returns the leaf's ``(B, member bytes)``, and its encoded wire lands
    in the slot.  Offsets come from a wire plan's segments: the buffer is
    exactly ``total`` bytes per rank, with no padding and no
    per-destination concatenation.  Returns the ``(B, total)`` uint8 wire.
    """
    wire = torch.empty((buf.shape[0], total), dtype=torch.uint8, device=buf.device)
    for offset, nbytes, pack_fn, encode_fn in leaves:
        slot = wire[:, offset : offset + nbytes]
        if encode_fn is None:
            pack_fn(buf, slot)
        else:
            slot.copy_(encode_fn(pack_fn(buf, None)))
    return wire
