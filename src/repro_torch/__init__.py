"""repro_torch — the TEMPI reproduction on PyTorch and CUDA (Hopper).

A port of the JAX package ``repro`` (which stays as the reference):
MPI-style datatypes -> the canonical StridedBlock (``core``), packed and
unpacked by hand-written CUDA kernels driven only by the block's scalars
(``kernels``), moved by a model-selected strategy and the fused
exact-byte ``neighbor_alltoallv`` (``comm``), in the paper's 26-neighbour
3D halo exchange and stencil (``halo``).  Entry points run on the card
unless the caller passes ``device="cpu"``.
"""
