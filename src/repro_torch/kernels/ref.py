"""Plain-torch oracles and the per-block baseline for pack/unpack.

Every function here works on a batch of byte buffers: ``src``/``dst`` is
a ``(B, n)`` uint8 tensor (``B`` buffers of ``n`` bytes, last dimension
contiguous) and packed payloads are ``(B, size)`` uint8.  One call moves
the same datatype out of (or into) all ``B`` buffers.

* ``pack_ref``/``unpack_ref`` — gather/scatter through a host-built
  index of every byte the datatype touches.  This is exactly the "list
  of offsets and lengths" representation the paper criticizes (§2) —
  kept as the oracle and as the GENERIC fallback.
* ``pack_xla_blocks``/``unpack_xla_blocks`` — one ``narrow().copy_()``
  per contiguous block: the one-``cudaMemcpyAsync``-per-block baseline
  that OpenMPI / Spectrum MPI / MVAPICH share (paper §6.2).  The name
  keeps the reference's strategy name (``xla``) so decisions compare.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.strided_block import StridedBlock, block_offsets

__all__ = [
    "offsets_array",
    "pack_ref",
    "unpack_ref",
    "pack_xla_blocks",
    "unpack_xla_blocks",
]

#: (block, incount, extent, device) -> byte index; bounded so a long run
#: over many distinct types cannot grow it without limit
_INDEX_CACHE: Dict[Tuple, torch.Tensor] = {}
_INDEX_CACHE_MAX = 128


def offsets_array(sb: StridedBlock, incount: int = 1, extent: int = 0) -> np.ndarray:
    """Host-side (numpy) array of block offsets in packing order."""
    return np.fromiter(
        block_offsets(sb, incount=incount, extent=extent), dtype=np.int64
    )


def _byte_index(
    sb: StridedBlock, incount: int, extent: int, device: torch.device
) -> torch.Tensor:
    key = (sb, incount, extent, str(device))
    idx = _INDEX_CACHE.get(key)
    if idx is None:
        offs = offsets_array(sb, incount, extent)
        flat = (
            offs[:, None] + np.arange(sb.counts[0], dtype=np.int64)[None, :]
        ).reshape(-1)
        idx = torch.from_numpy(flat).to(device)
        if len(_INDEX_CACHE) >= _INDEX_CACHE_MAX:
            _INDEX_CACHE.pop(next(iter(_INDEX_CACHE)))
        _INDEX_CACHE[key] = idx
    return idx


def _out(src: torch.Tensor, nbytes: int, out: Optional[torch.Tensor]) -> torch.Tensor:
    if out is None:
        return torch.empty((src.shape[0], nbytes), dtype=torch.uint8, device=src.device)
    if tuple(out.shape) != (src.shape[0], nbytes):
        raise ValueError(f"out has shape {tuple(out.shape)}; need {(src.shape[0], nbytes)}")
    return out


def pack_ref(
    src: torch.Tensor,
    sb: StridedBlock,
    incount: int = 1,
    extent: int = 0,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Gather every byte the datatype touches, in packing order."""
    idx = _byte_index(sb, incount, extent, src.device)
    out = _out(src, idx.numel(), out)
    out.copy_(src[:, idx])
    return out


def unpack_ref(
    dst: torch.Tensor,
    packed: torch.Tensor,
    sb: StridedBlock,
    incount: int = 1,
    extent: int = 0,
) -> torch.Tensor:
    """Scatter the packed bytes into ``dst`` in place; returns ``dst``."""
    idx = _byte_index(sb, incount, extent, dst.device)
    dst[:, idx] = packed.reshape(dst.shape[0], -1)
    return dst


def pack_xla_blocks(
    src: torch.Tensor,
    sb: StridedBlock,
    incount: int = 1,
    extent: int = 0,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Baseline: one copy per contiguous block (static offsets)."""
    c0 = sb.counts[0]
    offs = offsets_array(sb, incount, extent)
    out = _out(src, len(offs) * c0, out)
    for i, off in enumerate(offs.tolist()):
        out[:, i * c0 : (i + 1) * c0].copy_(src[:, off : off + c0])
    return out


def unpack_xla_blocks(
    dst: torch.Tensor,
    packed: torch.Tensor,
    sb: StridedBlock,
    incount: int = 1,
    extent: int = 0,
) -> torch.Tensor:
    """Baseline: one copy per contiguous block, in place into ``dst``."""
    c0 = sb.counts[0]
    for i, off in enumerate(offsets_array(sb, incount, extent).tolist()):
        dst[:, off : off + c0].copy_(packed[:, i * c0 : (i + 1) * c0])
    return dst
