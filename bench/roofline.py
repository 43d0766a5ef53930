"""Least bytes of the halo path's kernels, counted from the program's
sizes, and the card's published peaks (``bench/peaks.json``).

Each input byte is read once and each output byte written once, whatever
an implementation reads again, so the count is the same for any kernel
that does the same work.
"""

from __future__ import annotations

import itertools
import json
from math import prod
from pathlib import Path
from typing import Dict, Optional, Sequence

__all__ = ["packed_bytes", "pack_unpack_bytes", "peaks", "stencil_iteration_bytes"]

_PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks(kind: str) -> Optional[Dict[str, float]]:
    """The published peaks of the card named ``kind`` (as
    ``torch.cuda.get_device_name`` names it), or None if not listed."""
    return json.loads(_PEAKS.read_text()).get(kind)


def stencil_iteration_bytes(interior: Sequence[int], halo: Sequence[int],
                            ops: Sequence[Sequence[int]], steps: int, element: int = 4) -> int:
    """Least bytes of one rank's ``steps`` passes of the op cycle (each
    op given by its radii) after one exchange at halo depth ``halo``.
    An application computes the interior plus the shell still valid
    after it, ``valid - radii``; it reads that region and its radius
    shell once (the whole still-valid block) and writes each computed
    cell once."""
    valid = list(halo)
    total = 0
    for _ in range(steps):
        for radii in ops:
            read = prod(n + 2 * v for n, v in zip(interior, valid))
            valid = [v - r for v, r in zip(valid, radii)]
            if min(valid) < 0:
                raise ValueError(f"halo {tuple(halo)} cannot host {steps} passes of {ops}")
            write = prod(n + 2 * v for n, v in zip(interior, valid))
            total += (read + write) * element
    return total


def packed_bytes(interior: Sequence[int], radii: Sequence[int], element: int = 4) -> int:
    """Bytes one rank packs for a 26-neighbour exchange: the send region
    toward each direction is the interior's extent along each axis the
    direction does not cross and the halo radius along each it does."""
    return element * sum(
        prod(n if di == 0 else r for n, r, di in zip(interior, radii, d))
        for d in itertools.product((-1, 0, 1), repeat=3) if d != (0, 0, 0))


def pack_unpack_bytes(interior: Sequence[int], radii: Sequence[int], element: int = 4) -> int:
    """Least bytes of one rank's packs and unpacks in one exchange: each
    packed byte read and written once by the pack, and again by the
    unpack."""
    return 4 * packed_bytes(interior, radii, element)
