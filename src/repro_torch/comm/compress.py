"""Compressed-wire strategies: a strategy's wire extent need not equal
its packed member bytes.

The reference's two wire compressors, transcribed for torch tensors:

* :class:`Int8Wire` ships float32 member bytes as int8 plus one float32
  scale per block of ``block_elems`` elements (lossy, so never picked by
  the model: opt in with ``FixedPolicy("int8wire")``).
  ``Int8Wire(block_elems=None)`` writes the legacy one-scale format, and
  every instance reads both.  A block holding a NaN or an infinity
  carries no values: its scale is NaN (``0x7FC00000``) or infinity and
  its int8s are 0, and every element of it decodes to ``0x7FC00000``,
  the same bytes on every device.
* :class:`RleWire` is lossless: the member bytes as ``(value, length)``
  runs, in a wire of fixed capacity (``8 + member bytes``) with a stored
  mode for payloads whose runs do not fit.  Its run records are
  interleaved (run ``i`` at body offset ``5*i``), so the live stream is
  a prefix of the capacity wire: the ``varlen`` wire schedule ships only
  the prefix a payload probe measured (:meth:`RleWire.probe_stream_bytes`).

Both are ``wire_only``: local pack/unpack calls take the normal kernels.
The codecs are plain torch ops on ``(B, n)`` byte rows, the local mesh's
ranks (or one process's rank) on the leading dimension, with static
shapes and no host synchronization, so the card runs an exchange through
them without waiting on the host.  The member gather before the encoder
and the scatter after the decoder are the pack/unpack kernels.

A varlen class ships the probed prefix whatever every rank holds: a
payload with more runs than the probe decodes to the reference's bytes
for a short stream (each missing run filled with the last record's
value), which are not the payload.  The probe is one rank's buffer.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.comm.api import ROWS, Strategy
from repro_torch.core.commit import CommittedType
from repro_torch.kernels import ops

__all__ = [
    "Int8Wire",
    "INT8_WIRE",
    "BLOCK_ELEMS",
    "RleWire",
    "RLE_WIRE",
    "RLE_HEADER_BYTES",
    "RLE_RUN_BYTES",
]

#: bytes per float32 dequantization scale in the wire header
_SCALE_BYTES = 4

#: default quantization granularity (elements per scale)
BLOCK_ELEMS = 256

#: 1/127 in float32.  The reference divides each block's magnitude by
#: 127 and runs under ``jax.jit``, where XLA turns a division by a
#: constant into a product with its float32 reciprocal; the port computes
#: that product, so its scales are the reference exchange's bit for bit
_INV_127 = float(torch.tensor(1.0, dtype=torch.float32) / 127)

#: the bits of the NaN the int8 wire writes for a block holding a NaN,
#: and decodes every element of a block with a non-finite scale to.
#: Arithmetic on a NaN keeps or drops its payload by device, so both
#: directions write these bits as an integer
_NAN_BITS = 0x7FC00000

#: wire header: uint32 mode (0 = stored, 1 = rle) + uint32 run count
RLE_HEADER_BYTES = 8

#: bytes one RLE run occupies on the wire (uint8 value + uint32 length)
RLE_RUN_BYTES = 5


def _rows(b: torch.Tensor) -> torch.Tensor:
    """``(B, n)`` uint8 rows of a ``(n,)`` or ``(B, n)`` byte tensor."""
    if b.dtype != torch.uint8:
        raise TypeError(f"wire codecs take uint8 bytes, got {b.dtype}")
    return b.unsqueeze(0) if b.dim() == 1 else b


def _bitcast(b: torch.Tensor, dtype) -> torch.Tensor:
    """``(B, k*w)`` bytes -> ``(B, k)`` of the ``w``-byte ``dtype`` (a
    view when the rows are aligned, else of a copy)."""
    w = torch.empty((), dtype=dtype).element_size()
    if (not b.is_contiguous() or b.storage_offset() % w
            or (b.dim() == 2 and b.stride(0) % w)):
        b = b.clone(memory_format=torch.contiguous_format)
    return b.view(dtype)


def _bytes_of(x: torch.Tensor) -> torch.Tensor:
    """``(B, k)`` of a ``w``-byte dtype -> ``(B, k*w)`` little-endian bytes."""
    return x.contiguous().view(torch.uint8)


def _shaped(out: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return out[0] if like.dim() == 1 else out


class _WireCodec(Strategy):
    """What both compressors share: the member bytes are gathered by the
    static-choice kernels, encoded for the wire, and decoded again before
    the receive type's strategy scatters them."""

    wire_only = True

    # -- §5 cost model ----------------------------------------------------
    def model_pack(self, model, ct, incount):
        # pack the members (priced like rows) + the encode sweep: the
        # measured compress table when calibrated, else one extra read
        # and write of the packed bytes
        size = ct.size * incount
        m = model.measured_compress(self.name, size)
        extra = m[0] if m is not None else 2 * size / model.params.hbm_bw
        return ROWS.model_pack(model, ct, incount) + extra

    def model_unpack(self, model, ct, incount):
        size = ct.size * incount
        m = model.measured_compress(self.name, size)
        extra = m[1] if m is not None else 2 * size / model.params.hbm_bw
        return ROWS.model_unpack(model, ct, incount) + extra

    # -- execution --------------------------------------------------------
    def pack(self, buf, ct, incount=1, *, out=None, batched=False):
        wire = self.encode_wire(ops.pack(buf, ct, incount, batched=batched))
        if out is None:
            return wire
        ops._rows_out(out, _rows(wire).shape[0], wire.shape[-1]).copy_(_rows(wire))
        return out

    def unpack_wire(self, comm, dst, wire, recv_ct, send_ct=None, incount=1):
        member = self.decode_wire(wire, recv_ct.size * incount)
        u = comm.select(recv_ct, incount, wire=False)
        return u.unpack(dst, member, recv_ct, incount, batched=True)

    def unpack(self, buf, packed, ct, incount=1, *, batched=False):
        raise TypeError(
            f"{self.name} is wire-only; use unpack_wire on the received payload"
        )


class Int8Wire(_WireCodec):
    """Ship float32 member bytes as int8 + per-block float32 scales."""

    name = "int8wire"
    selectable = False     # lossy: never auto-selected, opt in explicitly

    def __init__(self, block_elems: Optional[int] = BLOCK_ELEMS):
        #: elements per quantization block; None = one scale for the
        #: whole payload (the legacy wire format)
        self.block_elems = block_elems

    def applicable(self, ct: CommittedType) -> bool:
        # the member bytes must re-view as float32 words; the caller
        # opting in asserts the buffer really holds float32 data
        return ct.size % 4 == 0 and ct.word_bytes >= 4

    def _nblocks(self, nfloats: int) -> int:
        if self.block_elems is None or nfloats == 0:
            return 1
        return -(-nfloats // self.block_elems)

    def wire_bytes(self, ct: CommittedType, incount: int = 1) -> int:
        # one int8 per float32 member + one scale per quantization block
        nfloats = (ct.size * incount) // 4
        return _SCALE_BYTES * self._nblocks(nfloats) + nfloats

    def encode_wire(self, member: torch.Tensor) -> torch.Tensor:
        """Packed member bytes (``(n,)`` or ``(B, n)``) -> the quantized
        wire: the scales' bytes, then one int8 per float."""
        b = _rows(member)
        f = _bitcast(b, torch.float32)
        B, n = f.shape
        nb = self._nblocks(n)
        block = self.block_elems if (self.block_elems and nb > 1) else n
        blocks = torch.nn.functional.pad(f, (0, nb * block - n)).view(B, nb, block)
        scales = blocks.abs().amax(dim=2).clamp_min(1e-30) * _INV_127
        # a block holding a NaN or an infinity quotients to NaN (or 0):
        # its int8s are 0, as the reference's conversion gives, and a NaN
        # scale is written with fixed bits whatever NaN the block held
        q = torch.round(blocks / scales[:, :, None]).clamp_(-127, 127).nan_to_num_(0.0)
        q = q.to(torch.int8).view(B, -1)[:, :n]
        bits = torch.where(scales.isnan(), _NAN_BITS, scales.view(torch.int32))
        return _shaped(torch.cat([_bytes_of(bits), q.view(torch.uint8)], dim=1), member)

    def decode_wire(self, wire: torch.Tensor, n: int) -> torch.Tensor:
        """Wire bytes -> the ``n`` dequantized member bytes (lossy)."""
        w = _rows(wire)
        nfloats = n // 4
        nscales = (w.shape[1] - nfloats) // _SCALE_BYTES
        scales = _bitcast(w[:, : _SCALE_BYTES * nscales], torch.float32)
        q = w[:, _SCALE_BYTES * nscales :].view(torch.int8).to(torch.float32)
        if nscales == 1:
            expand = scales[:, :1]  # legacy per-payload scale
        else:
            if self.block_elems is None or nscales != self._nblocks(nfloats):
                raise ValueError(
                    f"wire carries {nscales} scales for {nfloats} floats; "
                    f"expected {self._nblocks(nfloats)} "
                    f"(block_elems={self.block_elems})"
                )
            B = scales.shape[0]
            expand = scales[:, :, None].expand(B, nscales, self.block_elems)
            expand = expand.reshape(B, -1)[:, :nfloats]
        # a non-finite scale carries no values: its elements decode to
        # fixed NaN bits, not to a product whose NaN differs by device
        bits = torch.where(expand.isfinite(), (q * expand).view(torch.int32), _NAN_BITS)
        return _shaped(_bytes_of(bits), wire)


INT8_WIRE = Int8Wire()


class RleWire(_WireCodec):
    """Lossless run-length wire format with a stored-mode fallback.

    The wire always spans ``8 + member bytes`` (:meth:`wire_bytes`): an
    8-byte header ``(mode, nruns)`` as uint32, then either the run
    records (``value:u8 ++ length:u32le`` each, zero beyond the last
    run) or, when the runs would not fit the member bytes, the member
    bytes verbatim (``mode = 0``).  A live rle stream is the prefix
    ``wire[:8 + 5*nruns]``, which is what the ``varlen`` schedule
    ships; :meth:`decode_wire` reads a capacity wire or such a prefix.

    ``selectable``: lossless in both modes, and priced at capacity unless
    a selection carries a probed stream length, so the model picks it
    only where a length-aware transport moves the shorter stream.
    """

    name = "rlewire"
    selectable = True       # lossless; priced at capacity unless probed
    supports_varlen = True  # live stream is a prefix of the capacity wire

    def applicable(self, ct: CommittedType) -> bool:
        return ct.size > 0

    @staticmethod
    def _run_capacity(nbytes: int) -> int:
        """Run slots the fixed layout holds (5 B each, inside the
        member-byte capacity)."""
        return nbytes // RLE_RUN_BYTES

    def wire_bytes(self, ct: CommittedType, incount: int = 1) -> int:
        # capacity layout: header + the member bytes (stored-mode bound)
        return RLE_HEADER_BYTES + ct.size * incount

    # -- length-aware transport -------------------------------------------
    def probe_stream_bytes(self, ct: CommittedType, incount: int, buf) -> int:
        """Exact stream length (header + live run records) of one rank's
        payload: ``buf`` holds one rank's buffer.  Capacity for a
        stored-mode payload (its stream is the capacity) and for a buffer
        the type cannot be packed out of.  Reads one number back from the
        device: call it at plan time."""
        cap = self.wire_bytes(ct, incount)
        try:
            member = ops.pack(buf, ct, incount)
        except (TypeError, ValueError):
            return cap
        n = member.numel()
        if n == 0:
            return cap
        runs = int(torch.count_nonzero(member[1:] != member[:-1])) + 1
        if runs > self._run_capacity(n):
            return cap  # would ship stored: no truncation possible
        return min(RLE_HEADER_BYTES + RLE_RUN_BYTES * runs, cap)

    # -- execution --------------------------------------------------------
    def encode_wire(self, member: torch.Tensor) -> torch.Tensor:
        """Member bytes (``(n,)`` or ``(B, n)``) -> the capacity wire:
        header + run records + zero tail, or header + stored body."""
        b = _rows(member)
        B, n = b.shape
        R = self._run_capacity(n)
        if R == 0:
            header = torch.zeros((B, RLE_HEADER_BYTES), dtype=torch.uint8, device=b.device)
            return _shaped(torch.cat([header, b], dim=1), member)
        # run starts: byte 0 plus every byte differing from its
        # predecessor; run i spans [pos_i, pos_{i+1})
        starts = torch.cat(
            [torch.ones((B, 1), dtype=torch.bool, device=b.device), b[:, 1:] != b[:, :-1]],
            dim=1)
        # pos[i] = where run i starts, n past the live runs (the
        # reference's jnp.where(starts, size=n, fill_value=n)): the first
        # byte by which i + 1 runs have started, for the R + 1 slots the
        # records read
        started = torch.cumsum(starts, dim=1)
        nruns = started[:, -1]
        slots = torch.arange(1, R + 2, device=b.device).expand(B, R + 1).contiguous()
        pos = torch.searchsorted(started, slots)
        counts = pos[:, 1:] - pos[:, :-1]  # 0 past the live runs
        values = torch.where(counts > 0, b.gather(1, pos[:, :R].clamp(max=n - 1)), 0)
        fits = nruns <= R
        records = torch.cat(
            [values[:, :, None].to(torch.uint8),
             _bytes_of(counts.to(torch.int32)).view(B, R, 4)], dim=2,
        ).view(B, RLE_RUN_BYTES * R)  # run i at body offset 5*i
        rle_body = torch.nn.functional.pad(records, (0, n - RLE_RUN_BYTES * R))
        body = torch.where(fits[:, None], rle_body, b)
        header = _bytes_of(torch.stack([fits.to(torch.int32), nruns.to(torch.int32)], dim=1))
        return _shaped(torch.cat([header, body], dim=1), member)

    def decode_wire(self, wire: torch.Tensor, n: int) -> torch.Tensor:
        """Wire bytes -> the ``n`` member bytes.  Takes the capacity wire
        (``8 + n`` bytes) or a truncated varlen stream (``8 + 5*S``
        bytes, always rle; ``S`` from the length).  Runs are expanded as
        ``jnp.repeat(values, counts, total_repeat_length=n)`` does: a
        stream whose counts sum short of ``n`` fills the rest with the
        last record's value."""
        w = _rows(wire)
        B, total = w.shape
        body = w[:, RLE_HEADER_BYTES:]
        if total == RLE_HEADER_BYTES + n:
            R = self._run_capacity(n)
            stream_only = False
        else:
            rec = total - RLE_HEADER_BYTES
            if rec < 0 or rec % RLE_RUN_BYTES or rec > RLE_RUN_BYTES * self._run_capacity(n):
                raise ValueError(
                    f"rle wire carries {total} bytes; expected "
                    f"{RLE_HEADER_BYTES + n} (capacity) for a {n}-byte "
                    f"member payload, or header + whole 5-byte run records"
                )
            R = rec // RLE_RUN_BYTES
            stream_only = True
        if R == 0:
            return _shaped(body, wire)
        records = body[:, : RLE_RUN_BYTES * R].reshape(B, R, RLE_RUN_BYTES)
        values = records[:, :, 0]
        counts = _bitcast(records[:, :, 1:].reshape(B, 4 * R), torch.int32)
        counts = counts.to(torch.long) & 0xFFFFFFFF  # uint32 lengths
        # the run each output byte comes from: 1 at every run start
        # (uint32 sums; a start past n is dropped, into a column of its
        # own so the dropped ones do not contend), cumulated, less one
        start = (torch.cumsum(counts, dim=1) - counts) & 0xFFFFFFFF
        spill = n + torch.arange(R, device=w.device)
        marks = torch.zeros((B, n + R), dtype=torch.long, device=w.device)
        marks.scatter_add_(1, torch.where(start < n, start, spill), torch.ones_like(start))
        src = torch.cumsum(marks[:, :n], dim=1) - 1
        decoded = values.gather(1, src)
        if not stream_only:
            mode = _bitcast(w[:, :RLE_HEADER_BYTES], torch.int32)[:, :1]
            decoded = torch.where(mode == 1, decoded, body)
        return _shaped(decoded, wire)


RLE_WIRE = RleWire()
