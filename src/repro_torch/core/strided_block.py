"""StridedBlock: the compact canonical representation (paper §3.3, Alg. 4).

A ``StridedBlock`` is semantically a subarray: a byte ``start`` plus
per-dimension ``counts`` and ``strides`` (bytes).  Dimension 0 is the
innermost, contiguous run (stride 1, count = bytes per block); dimension
``k`` repeats dimension ``k-1`` ``counts[k]`` times at ``strides[k]``
bytes apart.

Crucially this is a *scalar* description — the paper's point is that no
per-type metadata need live in device memory; the pack/unpack kernels are
parameterized entirely by these scalars (``repro_torch.kernels``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

from repro_torch.core.canonicalize import simplify
from repro_torch.core.datatypes import Datatype
from repro_torch.core.ir import DenseData, StreamData, Type, translate

__all__ = ["StridedBlock", "strided_block", "strided_block_of", "block_offsets"]


@dataclass(frozen=True)
class StridedBlock:
    start: int                     # byte offset of the first element
    counts: Tuple[int, ...]        # counts[0] = contiguous bytes per block
    strides: Tuple[int, ...]       # strides[0] == 1 (bytes)

    @property
    def ndims(self) -> int:
        return len(self.counts)

    @property
    def size(self) -> int:
        """Total bytes of real data."""
        return math.prod(self.counts)

    @property
    def extent(self) -> int:
        """Bytes from ``start`` to one past the last byte touched."""
        return sum((c - 1) * s for c, s in zip(self.counts, self.strides)) + 1

    @property
    def contig_bytes(self) -> int:
        """Bytes per contiguous block (the paper's 'contiguous block size')."""
        return self.counts[0]

    @property
    def num_blocks(self) -> int:
        return math.prod(self.counts[1:]) if self.ndims > 1 else 1

    def packed_bytes(self, incount: int = 1) -> int:
        """Exact packed wire extent of ``incount`` repetitions: the real
        data bytes only — the ragged wire layouts in ``repro_torch.comm`` are
        built from this, never from the padded ``extent``."""
        return self.size * incount

    def word_bytes(self, max_word: int = 8) -> int:
        """Largest machine word width W that is aligned to the object and a
        factor of the contiguous block (paper §3.3's W specialization,
        each kernel thread moves one W-byte word)."""
        g = self.counts[0]
        g = math.gcd(g, self.start)
        for s in self.strides[1:]:
            g = math.gcd(g, s)
        w = 1
        for cand in (2, 4, 8):
            if cand <= max_word and g % cand == 0:
                w = cand
        return w


def strided_block(ty: Type) -> Optional[StridedBlock]:
    """Alg. 4: convert a *canonicalized* Type tree into a StridedBlock.

    Returns None if the tree is not a pure stream-chain over a dense leaf
    (""Not strided"" in the paper) — callers then fall back to the generic
    block-list path.
    """
    # Walk the chain root -> leaf.
    datas = []
    cur: Optional[Type] = ty
    while cur is not None:
        datas.append(cur.data)
        if len(cur.children) > 1:
            return None  # not a chain (future: struct types)
        cur = cur.child

    # The chain is outermost-first; the leaf must be dense, everything
    # above a stream.
    leaf, streams = datas[-1], datas[:-1]
    if not isinstance(leaf, DenseData):
        return None
    start = leaf.offset
    counts: List[int] = [leaf.extent]
    strides: List[int] = [1]
    for d in reversed(streams):  # inner -> outer
        if not isinstance(d, StreamData):
            return None
        start += d.offset
        counts.append(d.count)
        strides.append(d.stride)
    return StridedBlock(start, tuple(counts), tuple(strides))


def strided_block_of(dt: Datatype) -> Optional[StridedBlock]:
    """Translate + canonicalize + convert in one call."""
    return strided_block(simplify(translate(dt)))


def block_offsets(sb: StridedBlock, incount: int = 1, extent: int = 0) -> Iterator[int]:
    """Yield the byte offset of every contiguous block, innermost-last
    ordering (i.e. the order in which bytes appear in the packed buffer).

    ``incount``/``extent`` implement the Pack/Unpack repetition: the
    datatype repeated ``incount`` times, ``extent`` bytes apart (paper
    §3.3: an extra outer dimension known only at the call).
    Used by the pure-python oracle and the generic fallback; the real
    kernels never materialize this list (that is the point of the paper).
    """
    outer = sb.counts[1:]
    ostr = sb.strides[1:]
    for rep in range(incount):
        base = sb.start + rep * extent
        idx = [0] * len(outer)
        while True:
            off = base
            for i, s in zip(idx, ostr):
                off += i * s
            yield off
            # odometer increment, dimension 0 of `outer` fastest
            d = 0
            while d < len(outer):
                idx[d] += 1
                if idx[d] < outer[d]:
                    break
                idx[d] = 0
                d += 1
            if d == len(outer):
                break
            if not outer:
                break
