"""repro_torch.kernels — hand-written Hopper kernels: pack/unpack for
canonical StridedBlocks (paper §3.3) and the halo layer's stencil window
update, with ops.py wrappers, their plain torch versions (the CPU path)
and ref.py oracles.  The kernels are built from ``csrc/`` at first use
(:mod:`repro_torch.kernels.build`)."""

import sys

# import the kernel submodules BEFORE re-exporting ops' pack/unpack
# functions: `repro_torch.kernels.pack`/`.unpack` are also module names,
# and a first-time submodule import would otherwise clobber the function
# bindings on the package.
from repro_torch.kernels import graphs
from repro_torch.kernels import pack as _pack_kernels
from repro_torch.kernels import unpack as _unpack_kernels
from repro_torch.kernels.geometry import PackGeometry, plan_geometry
from repro_torch.kernels.ops import (
    byte_view,
    pack,
    pack_block,
    stencil_window_pair,
    stencil_window_update,
    unpack,
)

#: every kernel wrapper of the package, by name; each counts its
#: launches in ``.launches``
KERNELS = {
    "pack_rows": _pack_kernels.pack_rows,
    "pack_dma": _pack_kernels.pack_dma,
    "unpack_rows": _unpack_kernels.unpack_rows,
    "unpack_dma": _unpack_kernels.unpack_dma,
    "stencil": stencil_window_update,
}


def launch_counts() -> dict:
    """Kernel launches since the last :func:`reset_launch_counts`, by
    :data:`KERNELS` name, and five counts beside them:
    ``stencil_runtime``, the ``stencil`` launches that took the
    runtime-radii kernel; ``stencil_pairs``, the launches of the fused
    pair of stencil applications
    (:func:`~repro_torch.kernels.ops.stencil_window_pair`, two
    applications each, none of them in ``stencil``);
    ``splice_copies``, the halo layer's windows copied into the state
    (:data:`repro_torch.halo.stencil.splice_copies`; 0 before that
    module is loaded); and ``graph_captures`` and ``graph_replays``, the
    calls captured into a CUDA graph and the replays of them
    (:class:`~repro_torch.kernels.graphs.GraphCall`).  A count is moved
    only where its wrapper launches: a replay runs no wrapper, so what
    it launches is its call's :attr:`~repro_torch.kernels.graphs.GraphCall.launches`,
    counted in none of the others."""
    counts = {name: fn.launches for name, fn in KERNELS.items()}
    counts["stencil_runtime"] = stencil_window_update.runtime_launches
    counts["stencil_pairs"] = stencil_window_pair.launches
    halo = sys.modules.get("repro_torch.halo.stencil")
    counts["splice_copies"] = halo.splice_copies if halo is not None else 0
    counts["graph_captures"] = graphs.captures
    counts["graph_replays"] = graphs.replays
    return counts


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    stencil_window_update.runtime_launches = 0
    stencil_window_pair.launches = 0
    halo = sys.modules.get("repro_torch.halo.stencil")
    if halo is not None:
        halo.splice_copies = 0
    graphs.captures = graphs.replays = 0


__all__ = [
    "KERNELS",
    "PackGeometry",
    "plan_geometry",
    "byte_view",
    "launch_counts",
    "pack",
    "pack_block",
    "reset_launch_counts",
    "unpack",
]
