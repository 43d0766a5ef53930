"""Strided unpack kernels for Hopper — inverses of
``repro_torch.kernels.pack`` — with their plain-torch versions.

Unpack writes *into* an existing buffer: both kernels update ``dst`` in
place and return it, touching only the block bytes.

* :func:`unpack_rows` — SIMT inverse of ``pack_rows``, the same row
  kernel turned round (``csrc/rows.cuh``, entry ``tempi_unpack_rows`` in
  ``csrc/unpack.cu``), with the same choice of vector width and path.
  It takes only geometries whose planes occupy disjoint rows.
* :func:`unpack_dma`  — packed tiles staged through shared memory with
  ``cp.async``, then scattered into their strided windows
  (``tempi_unpack_dma``), with the same narrow path for rows of at most
  16 bytes and the same choice of V, path and rows per tile
  (``dma_args``).  Planes that share rows overlap; each row is written
  only by the last plane that covers it, so the last plane wins exactly
  as in the reference's sequential grid.

As with pack, ``dst`` is ``(B, n)`` uint8 and ``packed`` ``(B, size)``;
the wrapper runs the kernel for a CUDA tensor and the plain version
(:func:`unpack_plain`) only for a CPU tensor.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.geometry import PackGeometry
from repro_torch.kernels.pack import block_index, check_operands, dma_args, launch, row_args

__all__ = ["unpack_rows", "unpack_dma", "unpack_plain", "unpack_ragged", "decode_unpack_ragged"]


def unpack_plain(dst: torch.Tensor, packed: torch.Tensor, geom: PackGeometry) -> torch.Tensor:
    """Plain version of both unpack kernels: scatter ``packed`` into the
    block bytes of every buffer of ``dst``, in place (any device)."""
    idx = block_index(geom, dst.device)
    if geom.interleaved:
        per_plane = packed.reshape(dst.shape[0], geom.planes, -1)
        for p in range(geom.planes):
            dst[:, idx[p]] = per_plane[:, p]
    else:
        dst[:, idx.reshape(-1)] = packed
    return dst


def _unpack(entry: str, wrapper, dst, packed, geom, extra=None):
    check_operands(dst, packed, geom, "dst", "packed")
    if dst.device.type == "cpu":
        return unpack_plain(dst, packed, geom)
    launch("unpack", entry, dst, packed, geom,
           *(extra(geom, dst, packed) if extra else ()))
    wrapper.launches += 1
    return dst


def unpack_rows(dst: torch.Tensor, packed: torch.Tensor, geom: PackGeometry) -> torch.Tensor:
    """Scatter ``packed`` (``(B, packed_bytes)``) into the block of every
    buffer of ``dst`` (``(B, n)`` uint8) in place with the SIMT row
    kernel; returns ``dst``.  Raises for interleaved planes (use
    :func:`unpack_dma`, which orders them)."""
    if geom.interleaved:
        raise ValueError(
            "unpack_rows needs disjoint plane row ranges "
            f"(plane_rows={geom.plane_rows} < rows={geom.rows}); use unpack_dma"
        )
    return _unpack("tempi_unpack_rows", unpack_rows, dst, packed, geom, row_args)


def unpack_dma(dst: torch.Tensor, packed: torch.Tensor, geom: PackGeometry) -> torch.Tensor:
    """As :func:`unpack_rows`, with the shared-memory staged tile
    kernel; takes interleaved planes too.  Returns ``dst``."""
    return _unpack("tempi_unpack_dma", unpack_dma, dst, packed, geom, dma_args)


unpack_rows.launches = 0
unpack_dma.launches = 0


def unpack_ragged(dst: torch.Tensor, wire: torch.Tensor, leaves) -> torch.Tensor:
    """:func:`decode_unpack_ragged` with no decoder: ``leaves`` is a
    sequence of ``(offset, nbytes, unpack_fn)``, each leaf's exact wire
    segment scattered into ``dst`` in place.  Returns ``dst``."""
    return decode_unpack_ragged(dst, wire, [(o, n, None, f) for o, n, f in leaves])


def decode_unpack_ragged(dst: torch.Tensor, wire: torch.Tensor, leaves) -> torch.Tensor:
    """Inverse of :func:`repro_torch.kernels.pack.pack_compress_ragged`:
    hand each leaf its wire segment and let it scatter into ``dst`` in
    place.  ``leaves`` is a sequence of ``(offset, nbytes, decode_fn,
    unpack_fn)``: the ``(B, nbytes)`` view of the received wire at
    ``offset`` (under the ``varlen`` schedule the stream length, not the
    capacity) goes through ``decode_fn`` to its member bytes when the
    leaf has one, and ``unpack_fn(dst, part)`` consumes the result.
    Returns ``dst``."""
    for offset, nbytes, decode_fn, unpack_fn in leaves:
        part = wire[:, offset : offset + nbytes]
        unpack_fn(dst, part if decode_fn is None else decode_fn(part))
    return dst
