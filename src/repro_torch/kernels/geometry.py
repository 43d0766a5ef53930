"""Kernel geometry planning: StridedBlock -> the scalars of the pack and
unpack kernels (paper §3.3).

The paper maps ``counts[0..2]`` onto a CUDA grid and specializes a word
size W; on Hopper the port does exactly that.  A 2D/3D canonical
StridedBlock is described by a handful of scalars in W-byte words: block
``(p, i)`` of plane ``p``, row ``i`` starts at word
``(q + p*plane_rows + i) * pitch + r`` of the buffer and runs ``lanes``
words.  The kernels in ``repro_torch.kernels.pack``/``unpack`` take
nothing else — no per-block metadata ever lives in device memory.

The applicability predicates are those of the reference planner, kept
unchanged so both packages hand the ``rows``/``dma`` strategies exactly
the same types: W is capped at 4 bytes and a pitch row must fit
:data:`PITCH_ROW_BUDGET_BYTES`.  Neither limit binds a Hopper kernel,
and W stays 4 on purpose: each kernel picks its own vector width V (up
to 16 bytes) from the pointers, strides and block at launch
(``kernels/pack.py`` ``vector_bytes``), so a wider W would buy nothing
and the strategy choices would no longer compare with the reference's.

All planning happens on host scalars at commit time.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.core.strided_block import StridedBlock

__all__ = ["PackGeometry", "plan_geometry", "MAX_WORD_BYTES", "PITCH_ROW_BUDGET_BYTES"]

#: widest word the planner picks (the reference's limit; see module doc)
MAX_WORD_BYTES = 4

#: largest pitch row, in bytes, the planner accepts (the reference's
#: per-step working-set budget; see module doc)
PITCH_ROW_BUDGET_BYTES = 4 * 1024 * 1024


@dataclass(frozen=True)
class PackGeometry:
    """Scalar parameters of the strided pack/unpack kernels.

    All units are W-byte words unless suffixed ``_bytes``.  Viewing the
    buffer as rows of ``pitch`` words, block ``(p, i)``'s first word
    lives at row ``q + p*plane_rows + i``, column ``r``.
    """

    word_bytes: int      # W
    lanes: int           # counts[0] // W — words per contiguous block
    rows: int            # counts[1]     — blocks per plane
    planes: int          # counts[2]     — plane count (1 for 2D)
    pitch: int           # strides[1] // W
    q: int               # start row
    r: int               # column offset within a row
    plane_rows: int      # strides[2] // strides[1] (0 for 2D)

    @property
    def out_words(self) -> int:
        return self.planes * self.rows * self.lanes

    @property
    def packed_bytes(self) -> int:
        return self.out_words * self.word_bytes

    @property
    def span_bytes(self) -> int:
        """Bytes from the buffer start to one past the last block byte —
        the least a buffer must hold (a kernel never touches more)."""
        last_row = self.q + (self.planes - 1) * self.plane_rows + self.rows - 1
        return (last_row * self.pitch + self.r + self.lanes) * self.word_bytes

    @property
    def interleaved(self) -> bool:
        """Planes share rows (``plane_rows < rows``): their blocks then
        overlap, and an unpack must write the planes in order."""
        return self.planes > 1 and self.plane_rows < self.rows

    @property
    def overfetch(self) -> float:
        """Words per useful word a full-pitch row read would fetch.
        Feeds the §5 performance model (the reference's pricing)."""
        return self.pitch / max(self.lanes, 1)


def plan_geometry(
    sb: StridedBlock, word_bytes: Optional[int] = None
) -> Optional[PackGeometry]:
    """Plan the kernel geometry for a 2D/3D StridedBlock.

    Returns None when the aligned kernels do not apply; callers fall
    back to the gather path.  Conditions (each on host scalars):

    * 2 <= ndims <= 3
    * W | start, strides, counts[0] (guaranteed by word_bytes selection)
    * the contiguous block does not straddle a pitch boundary
    * 3D: the plane stride is a whole number of pitches
    * one pitch row fits :data:`PITCH_ROW_BUDGET_BYTES`
    """
    if sb.ndims not in (2, 3):
        return None
    w = sb.word_bytes(max_word=MAX_WORD_BYTES) if word_bytes is None else word_bytes
    c0, c1 = sb.counts[0], sb.counts[1]
    s1 = sb.strides[1]
    c2 = sb.counts[2] if sb.ndims == 3 else 1
    s2 = sb.strides[2] if sb.ndims == 3 else 0

    if s1 % w or sb.start % w or c0 % w or (s2 % w):
        return None
    lanes, pitch = c0 // w, s1 // w
    q, r = (sb.start // w) // pitch, (sb.start // w) % pitch
    if r + lanes > pitch:
        return None  # block straddles a pitch row
    if sb.ndims == 3:
        if s2 % s1:
            return None  # plane stride not a whole number of rows
        plane_rows = s2 // s1
    else:
        plane_rows = 0
    if pitch * w > PITCH_ROW_BUDGET_BYTES:
        return None
    return PackGeometry(
        word_bytes=w,
        lanes=lanes,
        rows=c1,
        planes=c2,
        pitch=pitch,
        q=q,
        r=r,
        plane_rows=plane_rows,
    )
