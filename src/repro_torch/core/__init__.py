"""repro_torch.core — TEMPI's canonical datatype engine (paper §2-3).

Public API:

    from repro_torch.core import (
        BYTE, FLOAT, Vector, Subarray, ...   # datatype constructors
        commit, registry,                    # MPI_Type_commit analogue
        StridedBlock, strided_block_of,      # canonical representation
    )
"""

from repro_torch.core.canonicalize import dense_folding, simplify, stream_elision
from repro_torch.core.commit import (
    CommittedType,
    KernelKind,
    TypeRegistry,
    WireSegment,
    commit,
    registry,
)
from repro_torch.core.datatypes import (
    BFLOAT16,
    BYTE,
    CHAR,
    DOUBLE,
    FLOAT,
    FLOAT16,
    INT8,
    INT16,
    INT32,
    INT64,
    Contiguous,
    Datatype,
    Hvector,
    Named,
    Subarray,
    Vector,
    make_cuboid_hvector,
    make_cuboid_subarray,
    make_cuboid_vector_of_hvector,
)
from repro_torch.core.ir import DenseData, StreamData, Type, translate
from repro_torch.core.strided_block import (
    StridedBlock,
    block_offsets,
    strided_block,
    strided_block_of,
)

__all__ = [
    "BFLOAT16", "BYTE", "CHAR", "DOUBLE", "FLOAT", "FLOAT16",
    "INT8", "INT16", "INT32", "INT64",
    "Contiguous", "Datatype", "Hvector", "Named", "Subarray", "Vector",
    "make_cuboid_hvector", "make_cuboid_subarray",
    "make_cuboid_vector_of_hvector",
    "DenseData", "StreamData", "Type", "translate",
    "dense_folding", "simplify", "stream_elision",
    "CommittedType", "KernelKind", "TypeRegistry", "WireSegment",
    "commit", "registry",
    "StridedBlock", "block_offsets", "strided_block", "strided_block_of",
]
