"""Type commit: translation + canonicalization + kernel selection + cache
(paper §3 intro, §3.3, §4 "caching layer").

``MPI_Type_commit`` is the boundary between datatype *construction* and
*use*.  Committing a datatype here runs the three phases once and caches
the result, so every later Pack/Unpack/Send on the type is a dictionary
lookup (amortized "tens of nanoseconds" in the paper):

    1. translate   -> Type IR            (repro_torch.core.ir)
    2. simplify    -> canonical tree     (repro_torch.core.canonicalize)
    3. kernel sel. -> StridedBlock + KernelKind + word width
"""

from __future__ import annotations

import enum
import hashlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.core.canonicalize import simplify
from repro_torch.core.datatypes import Datatype
from repro_torch.core.ir import DenseData, StreamData, Type, translate
from repro_torch.core.strided_block import StridedBlock, strided_block

__all__ = [
    "KernelKind",
    "CommittedType",
    "TypeRegistry",
    "WireSegment",
    "commit",
    "registry",
]

#: bump when the structural description below changes shape, so stale
#: persisted selection caches keyed on old fingerprints never collide
_FINGERPRINT_VERSION = "ct.v1"


def _tree_key(ty: Type) -> Tuple:
    """Pure-data description of a canonical IR tree (GENERIC types have
    no StridedBlock, so the tree itself is the structure)."""
    d = ty.data
    if isinstance(d, DenseData):
        head: Tuple = ("dense", d.offset, d.extent)
    else:
        head = ("stream", d.offset, d.stride, d.count)
    return head + tuple(_tree_key(c) for c in ty.children)


@dataclass(frozen=True)
class WireSegment:
    """One committed type's slot in a flat wire buffer: the *exact*
    packed extent the type occupies on the wire, at a byte offset — no
    class padding, no row equalization.  This is the canonical
    representation's answer to "how many bytes does this object really
    put on the link": a per-peer wire layout is a sequence of these
    (see ``repro_torch.comm.wireplan.WirePlan``).

    ``nbytes`` defaults to the packed member bytes; strategies whose
    wire format differs (a bounding window, a compressed payload) supply
    their own count — the descriptor carries whatever truly crosses the
    wire.
    """

    fingerprint: str   # content hash of the committed type it carries
    offset: int        # byte offset in the flat wire buffer
    nbytes: int        # exact wire extent of this segment

    @property
    def end(self) -> int:
        return self.offset + self.nbytes


class KernelKind(enum.Enum):
    """Which implementation handles the committed type (paper §3.3)."""

    CONTIG = "contig"      # 1D: single contiguous copy (memcpy analogue)
    KERNEL_2D = "kernel2d"  # 2D strided block -> CUDA pack kernel
    KERNEL_3D = "kernel3d"  # 3D strided block -> CUDA pack kernel
    KERNEL_ND = "kernelnd"  # >3D: outer loops around the 3D kernel
    GENERIC = "generic"     # not strided: offset/length list fallback


@dataclass(frozen=True)
class CommittedType:
    """Everything the runtime needs to operate on a datatype, computed
    once at commit time.  All fields are host scalars/tuples — nothing is
    stored in device memory (paper: "No object metadata is stored on the
    GPU").
    """

    datatype: Datatype
    tree: Type                      # canonical IR (for inspection/tests)
    block: Optional[StridedBlock]   # None iff kernel is GENERIC
    kernel: KernelKind
    word_bytes: int                 # W specialization (paper §3.3)

    @property
    def size(self) -> int:
        return self.datatype.size

    @property
    def extent(self) -> int:
        return self.datatype.extent

    @property
    def contiguous(self) -> bool:
        return self.kernel is KernelKind.CONTIG

    def structure_key(self) -> Tuple:
        """Canonical structural description of the committed type: what
        the runtime *does* with it, independent of how it was constructed
        or which registry committed it.  Equal canonical forms (paper
        Fig. 2: different construction, same object) share a key."""
        b = self.block
        blk = None if b is None else (b.start, b.counts, b.strides)
        return (
            _FINGERPRINT_VERSION,
            self.kernel.value,
            self.word_bytes,
            self.size,
            self.extent,
            blk if blk is not None else _tree_key(self.tree),
        )

    def packed_extent(self, incount: int = 1) -> int:
        """Exact bytes of real data ``incount`` repetitions of this type
        pack to — the wire extent of a pack-based transfer.  Never
        includes stride gaps or any per-class padding."""
        return self.size * incount

    def wire_segment(
        self, offset: int = 0, incount: int = 1, nbytes: Optional[int] = None
    ) -> "WireSegment":
        """The :class:`WireSegment` this type occupies in a flat wire
        buffer (``nbytes`` overrides the packed extent for strategies
        with a different wire format)."""
        return WireSegment(
            fingerprint=self.fingerprint,
            offset=offset,
            nbytes=self.packed_extent(incount) if nbytes is None else nbytes,
        )

    @property
    def fingerprint(self) -> str:
        """Stable content hash of :meth:`structure_key` — identical
        across registry re-commits and across processes, so it can key
        persistent caches and plan caches.  ``id(ct)`` cannot."""
        fp = self.__dict__.get("_fingerprint")
        if fp is None:
            digest = hashlib.sha256(
                repr(self.structure_key()).encode()
            ).hexdigest()[:16]
            object.__setattr__(self, "_fingerprint", digest)
            fp = digest
        return fp


def _select_kernel(block: Optional[StridedBlock]) -> KernelKind:
    if block is None:
        return KernelKind.GENERIC
    if block.ndims == 1:
        return KernelKind.CONTIG
    if block.ndims == 2:
        return KernelKind.KERNEL_2D
    if block.ndims == 3:
        return KernelKind.KERNEL_3D
    return KernelKind.KERNEL_ND


class TypeRegistry:
    """Commit cache keyed by the (hashable, frozen) datatype description.

    Mirrors TEMPI's cache of per-committed-type packing strategies; the
    registry also memoizes the IR so benchmarks can separate "create"
    from "commit" cost (Fig. 6).
    """

    def __init__(self) -> None:
        self._cache: Dict[Datatype, CommittedType] = {}
        self.hits = 0
        self.misses = 0

    def commit(self, dt: Datatype) -> CommittedType:
        hit = self._cache.get(dt)
        if hit is not None:
            self.hits += 1
            return hit
        self.misses += 1
        tree = simplify(translate(dt))
        block = strided_block(tree)
        kind = _select_kernel(block)
        word = block.word_bytes() if block is not None else 1
        committed = CommittedType(
            datatype=dt, tree=tree, block=block, kernel=kind, word_bytes=word
        )
        self._cache[dt] = committed
        return committed

    def free(self, dt: Datatype) -> None:
        """MPI_Type_free analogue."""
        self._cache.pop(dt, None)

    def clear(self) -> None:
        self._cache.clear()
        self.hits = self.misses = 0

    def __len__(self) -> int:
        return len(self._cache)


#: Process-global registry, like TEMPI's interposer-internal state.
registry = TypeRegistry()


def commit(dt: Datatype) -> CommittedType:
    """Commit ``dt`` against the global registry."""
    return registry.commit(dt)
