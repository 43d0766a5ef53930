"""Internal representation of datatypes and translation (paper §3.1).

Every committed MPI-like datatype is first *translated* into a ``Type``
tree whose nodes carry ``TypeData``:

* ``DenseData(offset, extent)``  — a run of contiguous bytes (plays the
  role of a named type).
* ``StreamData(offset, stride, count)`` — a strided sequence of ``count``
  elements of the (single) child type, ``stride`` bytes apart.

The tree structure mirrors the construction pattern of the MPI datatype;
equivalent datatypes may translate to *different* trees (Fig. 2), which
is exactly why the canonicalization pass (``repro_torch.core.canonicalize``)
exists.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Union

from repro_torch.core.datatypes import (
    Contiguous,
    Datatype,
    Hvector,
    Named,
    Subarray,
    Vector,
)

__all__ = ["DenseData", "StreamData", "Type", "translate"]


@dataclass
class DenseData:
    """A sequence of contiguous bytes (paper §3.1 item 1)."""

    offset: int  # bytes between the lower bound and the first byte
    extent: int  # number of contiguous bytes

    def clone(self) -> "DenseData":
        return DenseData(self.offset, self.extent)


@dataclass
class StreamData:
    """A strided stream of elements of the child type (paper §3.1 item 2)."""

    offset: int  # bytes, as DenseData
    stride: int  # bytes between the start of consecutive elements
    count: int   # number of elements in the stream

    def clone(self) -> "StreamData":
        return StreamData(self.offset, self.stride, self.count)


TypeData = Union[DenseData, StreamData]


@dataclass
class Type:
    """A node of the IR tree.  ``data`` discriminates the node kind; the
    nodes in our subset have zero (DenseData) or one (StreamData) child.
    """

    data: TypeData
    children: List["Type"] = field(default_factory=list)

    @property
    def child(self) -> Optional["Type"]:
        return self.children[0] if self.children else None

    def clone(self) -> "Type":
        return Type(self.data.clone(), [c.clone() for c in self.children])

    # -- debugging helpers --------------------------------------------------
    def pretty(self, indent: int = 0) -> str:
        pad = "  " * indent
        d = self.data
        if isinstance(d, DenseData):
            s = f"{pad}DenseData{{offset:{d.offset}, extent:{d.extent}}}"
        else:
            s = (
                f"{pad}StreamData{{offset:{d.offset}, count:{d.count}, "
                f"stride:{d.stride}}}"
            )
        return "\n".join([s] + [c.pretty(indent + 1) for c in self.children])

    def __str__(self) -> str:  # pragma: no cover - debugging aid
        return self.pretty()


# ---------------------------------------------------------------------------
# Translation (paper §3.1): one case per supported datatype constructor.
# ---------------------------------------------------------------------------

def translate(dt: Datatype) -> Type:
    """Convert an MPI-like datatype description into the ``Type`` IR.

    The recursion mirrors the paper: each constructor maps to a DenseData
    or StreamData node, then its ``oldtype`` is translated and attached as
    the child.  Named types are the base case.
    """
    if isinstance(dt, Named):
        # "translated into a DenseData with the extent field equal to the
        #  extent of the named type, and offset 0"
        return Type(DenseData(0, dt.extent))

    if isinstance(dt, Contiguous):
        # "a special case StreamData where the stride matches the size of
        #  the element.  It is not DenseData as oldtype may not be dense."
        return Type(
            StreamData(offset=0, stride=dt.oldtype.extent, count=dt.count),
            [translate(dt.oldtype)],
        )

    if isinstance(dt, Vector):
        # Two nested StreamData: parent = repeated blocks, child = repeated
        # elements within each block.
        child_stride = dt.oldtype.extent
        child = Type(
            StreamData(offset=0, stride=child_stride, count=dt.blocklength),
            [translate(dt.oldtype)],
        )
        parent = Type(
            StreamData(
                offset=0, stride=child_stride * dt.stride, count=dt.count
            ),
            [child],
        )
        return parent

    if isinstance(dt, Hvector):
        # As Vector, but the parent stride is given directly in bytes.
        child = Type(
            StreamData(
                offset=0, stride=dt.oldtype.extent, count=dt.blocklength
            ),
            [translate(dt.oldtype)],
        )
        parent = Type(
            StreamData(offset=0, stride=dt.stride_bytes, count=dt.count),
            [child],
        )
        return parent

    if isinstance(dt, Subarray):
        # A nest of StreamData equal to the dimension of the subarray.
        # Dimension i's stride is extent(oldtype) * prod(sizes[:i]); its
        # offset (given in elements) is converted to bytes.
        e = dt.oldtype.extent
        node = translate(dt.oldtype)
        for i in range(len(dt.sizes)):
            stride = e * math.prod(dt.sizes[:i])
            node = Type(
                StreamData(
                    offset=dt.starts[i] * stride,
                    stride=stride,
                    count=dt.subsizes[i],
                ),
                [node],
            )
        return node

    raise TypeError(f"cannot translate datatype of kind {type(dt).__name__}")
