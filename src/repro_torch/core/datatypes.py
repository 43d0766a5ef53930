"""MPI-like derived datatype descriptions (paper §2).

This module provides the *user-facing* description language for
non-contiguous data layouts, mirroring the subset of MPI derived
datatypes the paper considers:

* ``Named``      — predefined base types (MPI_BYTE, MPI_FLOAT, ...)
* ``Contiguous`` — ``MPI_Type_contiguous``
* ``Vector``     — ``MPI_Type_vector`` (stride in elements of oldtype)
* ``Hvector``    — ``MPI_Type_create_hvector`` (stride in bytes)
* ``Subarray``   — ``MPI_Type_create_subarray``

Datatypes are immutable and hash-consable so they can key commit caches
(paper §4 "caching layer").  ``extent`` follows MPI semantics (distance
between lower and upper bound, i.e. the stride implied when the type is
repeated), while ``size`` is the number of bytes of actual data.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Tuple

__all__ = [
    "Datatype",
    "Named",
    "Contiguous",
    "Vector",
    "Hvector",
    "Subarray",
    "BYTE",
    "CHAR",
    "INT8",
    "INT16",
    "INT32",
    "INT64",
    "FLOAT16",
    "BFLOAT16",
    "FLOAT",
    "DOUBLE",
    "make_cuboid_subarray",
    "make_cuboid_hvector",
    "make_cuboid_vector_of_hvector",
]


@dataclass(frozen=True)
class Datatype:
    """Base class for all datatype descriptions."""

    @property
    def extent(self) -> int:
        """MPI extent in bytes: lower bound to upper bound."""
        raise NotImplementedError

    @property
    def size(self) -> int:
        """Number of bytes of real data described by one instance."""
        raise NotImplementedError

    # -- composition helpers (fluent construction used in tests/examples) --
    def contiguous(self, count: int) -> "Contiguous":
        return Contiguous(count, self)

    def vector(self, count: int, blocklength: int, stride: int) -> "Vector":
        return Vector(count, blocklength, stride, self)

    def hvector(self, count: int, blocklength: int, stride_bytes: int) -> "Hvector":
        return Hvector(count, blocklength, stride_bytes, self)


@dataclass(frozen=True)
class Named(Datatype):
    """A predefined ("named") MPI type, e.g. MPI_FLOAT (paper §2).

    ``width`` is the byte width of the underlying machine type.
    """

    name: str
    width: int

    def __post_init__(self):
        if self.width <= 0:
            raise ValueError(f"named type width must be positive: {self.width}")

    @property
    def extent(self) -> int:
        return self.width

    @property
    def size(self) -> int:
        return self.width


# Predefined named types (the ones used throughout the paper + bf16).
BYTE = Named("MPI_BYTE", 1)
CHAR = Named("MPI_CHAR", 1)
INT8 = Named("MPI_INT8_T", 1)
INT16 = Named("MPI_INT16_T", 2)
INT32 = Named("MPI_INT32_T", 4)
INT64 = Named("MPI_INT64_T", 8)
FLOAT16 = Named("MPI_FLOAT16", 2)
BFLOAT16 = Named("MPI_BFLOAT16", 2)
FLOAT = Named("MPI_FLOAT", 4)
DOUBLE = Named("MPI_DOUBLE", 8)


@dataclass(frozen=True)
class Contiguous(Datatype):
    """``count`` contiguous repetitions of ``oldtype`` (MPI_Type_contiguous)."""

    count: int
    oldtype: Datatype

    def __post_init__(self):
        if self.count <= 0:
            raise ValueError(f"contiguous count must be positive: {self.count}")

    @property
    def extent(self) -> int:
        return self.count * self.oldtype.extent

    @property
    def size(self) -> int:
        return self.count * self.oldtype.size


@dataclass(frozen=True)
class Vector(Datatype):
    """``count`` blocks of ``blocklength`` oldtypes, block starts separated by
    ``stride`` oldtypes (MPI_Type_vector).
    """

    count: int
    blocklength: int
    stride: int
    oldtype: Datatype

    def __post_init__(self):
        if self.count <= 0 or self.blocklength <= 0:
            raise ValueError("vector count/blocklength must be positive")
        if self.stride < self.blocklength:
            # Overlapping blocks are legal MPI but never useful for packing;
            # the paper's subset excludes them.
            raise ValueError("vector stride must be >= blocklength")

    @property
    def extent(self) -> int:
        e = self.oldtype.extent
        return ((self.count - 1) * self.stride + self.blocklength) * e

    @property
    def size(self) -> int:
        return self.count * self.blocklength * self.oldtype.size


@dataclass(frozen=True)
class Hvector(Datatype):
    """Like Vector but ``stride_bytes`` is given directly in bytes
    (MPI_Type_create_hvector)."""

    count: int
    blocklength: int
    stride_bytes: int
    oldtype: Datatype

    def __post_init__(self):
        if self.count <= 0 or self.blocklength <= 0:
            raise ValueError("hvector count/blocklength must be positive")
        if self.stride_bytes < self.blocklength * self.oldtype.extent:
            raise ValueError("hvector stride_bytes must cover the block")

    @property
    def extent(self) -> int:
        return (self.count - 1) * self.stride_bytes + (
            self.blocklength * self.oldtype.extent
        )

    @property
    def size(self) -> int:
        return self.count * self.blocklength * self.oldtype.size


@dataclass(frozen=True)
class Subarray(Datatype):
    """n-dimensional subarray of an n-dimensional array
    (MPI_Type_create_subarray).

    Following the paper's Fig. 1/2 convention, index 0 of
    ``sizes``/``subsizes``/``starts`` is the *innermost* (fastest-varying,
    contiguous) dimension.  Pass ``order="C"`` to supply outermost-first
    arrays in NumPy/C convention instead; they are normalized on
    construction.
    """

    sizes: Tuple[int, ...]
    subsizes: Tuple[int, ...]
    starts: Tuple[int, ...]
    oldtype: Datatype
    order: str = "paper"

    def __post_init__(self):
        sizes = tuple(self.sizes)
        subsizes = tuple(self.subsizes)
        starts = tuple(self.starts)
        if self.order == "C":
            sizes, subsizes, starts = sizes[::-1], subsizes[::-1], starts[::-1]
        elif self.order != "paper":
            raise ValueError(f"unknown order {self.order!r}")
        object.__setattr__(self, "sizes", sizes)
        object.__setattr__(self, "subsizes", subsizes)
        object.__setattr__(self, "starts", starts)
        object.__setattr__(self, "order", "paper")
        n = len(sizes)
        if not (n == len(subsizes) == len(starts)) or n == 0:
            raise ValueError("sizes/subsizes/starts must have equal nonzero rank")
        for d in range(n):
            if not (0 < subsizes[d] <= sizes[d]):
                raise ValueError(f"subsize out of range in dim {d}")
            if not (0 <= starts[d] <= sizes[d] - subsizes[d]):
                raise ValueError(f"start out of range in dim {d}")

    @property
    def extent(self) -> int:
        # MPI: extent of a subarray type is the extent of the full array.
        return math.prod(self.sizes) * self.oldtype.extent

    @property
    def size(self) -> int:
        return math.prod(self.subsizes) * self.oldtype.size


# ---------------------------------------------------------------------------
# Convenience constructors for the paper's running 3D-object example (Fig. 1)
# ---------------------------------------------------------------------------

def make_cuboid_subarray(
    alloc: Tuple[int, int, int],
    ext: Tuple[int, int, int],
    starts: Tuple[int, int, int] = (0, 0, 0),
    oldtype: Datatype = BYTE,
) -> Subarray:
    """The 3D object of Fig. 1 described as a single 3D subarray of bytes."""
    return Subarray(alloc, ext, starts, oldtype)


def make_cuboid_hvector(
    alloc: Tuple[int, int, int],
    ext: Tuple[int, int, int],
    oldtype: Datatype = BYTE,
) -> Hvector:
    """Fig. 2 middle: hvector of hvector of vector."""
    e = oldtype.extent
    row = Vector(ext[0], 1, 1, oldtype)
    plane = Hvector(ext[1], 1, alloc[0] * e, row)
    return Hvector(ext[2], 1, alloc[0] * alloc[1] * e, plane)


def make_cuboid_vector_of_hvector(
    alloc: Tuple[int, int, int],
    ext: Tuple[int, int, int],
    oldtype: Datatype = BYTE,
) -> Vector:
    """Fig. 2 top: subarray-plane wrapped in a vector (paper's first snippet
    uses a 2D subarray plane and a vector of planes)."""
    plane = Subarray(alloc[:2], ext[:2], (0, 0), oldtype)
    return Vector(ext[2], 1, 1, plane)
