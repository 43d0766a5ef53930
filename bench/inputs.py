"""The benchmark's inputs, made from ``--seed`` on the run's device.

Each rank's interior is one ``torch.randn`` call on a generator of its
own, seeded from (seed, rank), so a rank's values do not depend on how
many ranks share a process or on the halo depth the program picks: the
local mesh (every rank in one tensor) and one process per rank start
from the same field, and the reference rebuilds it rank by rank.  The
halo shells start as other random values ("stale"), so a halo that no
exchange wrote never passes for one that did.  A second state buffer
(``buffer=1``, the exchange cells' double buffer) draws its values from
streams of its own, so no cell of it equals the first buffer's.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

__all__ = ["interior", "stale_block", "rank_coords"]

_P = (1 << 61) - 1  # a Mersenne prime: the seeds of (seed, rank, stream) stay distinct


def _generator(seed: int, rank: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed((int(seed) * 1_000_003 + int(rank) * 4 + stream) % _P)
    return g


def interior(seed: int, rank: int, shape: Sequence[int], device, buffer: int = 0) -> torch.Tensor:
    """Rank ``rank``'s interior in state buffer ``buffer``, float32 N(0, 1)."""
    return torch.randn(tuple(shape), generator=_generator(seed, rank, 2 * buffer, device),
                       device=device, dtype=torch.float32)


def stale_block(seed: int, rank: int, shape: Sequence[int], device,
                buffer: int = 0) -> torch.Tensor:
    """A whole local block of other values, which the interior is then
    written into: the halo shells' contents before any exchange."""
    return torch.randn(tuple(shape), generator=_generator(seed, rank, 2 * buffer + 1, device),
                       device=device, dtype=torch.float32)


def rank_coords(rank: int, grid: Sequence[int]) -> Tuple[int, int, int]:
    """(cz, cy, cx) of ``rank`` on a (pz, py, px) grid, row-major, as
    ``MPI_Cart_create`` numbers the ranks."""
    _, py, px = grid
    return (rank // (py * px), (rank // px) % py, rank % px)
