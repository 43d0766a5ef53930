"""Plain-torch reference of the halo cells: what the judged outputs must be.

It imports nothing of the program.  From ``--seed`` it rebuilds the
periodic global field that the ranks' interiors tile (rank ``r`` at
``inputs.rank_coords(r, grid)``), and then:

* after halo exchanges, every cell of a rank's local block, halo shells
  included, is the global field at that cell's periodic position
  (:func:`expected_block`), in each state buffer;
* after ``K`` passes of a stencil cycle, the interiors are the global
  field smoothed ``K`` times (:func:`stencil_fft`).  Each op is linear
  and shift-invariant on the periodic domain, so a pass multiplies each
  Fourier mode by the cycle's symbol; the reference raises it to the
  ``K``-th power in float64 and transforms back, which costs the same
  whatever ``K`` the window reached.  The op's two float32 factors,
  ``w / N`` and ``1 - w``, are what a float32 stencil multiplies by.
  The smoothing shrinks the field, so the gap is judged against the
  largest value that survives (:func:`judge_iterate`).
* :func:`stencil_direct` applies the ops one by one in a given dtype:
  the comparison's controls in bfloat16, and a cross-check of
  :func:`stencil_fft` in float64.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List, Sequence, Tuple

import torch

from bench.inputs import interior, rank_coords

__all__ = [
    "Op",
    "assemble",
    "coefficients",
    "expected_block",
    "global_field",
    "judge_exchange",
    "judge_iterate",
    "stencil_direct",
    "stencil_fft",
]

#: one stencil op: (radii (rz, ry, rx), weight)
Op = Tuple[Tuple[int, int, int], float]


def global_field(seed: int, grid: Sequence[int], n: Sequence[int], device,
                 dtype=torch.float32, buffer: int = 0) -> torch.Tensor:
    """The periodic global field ``(pz*nz, py*ny, px*nx)`` of state
    buffer ``buffer``, in ``dtype``."""
    pz, py, px = grid
    nz, ny, nx = n
    g = torch.empty((pz * nz, py * ny, px * nx), dtype=dtype, device=device)
    for r in range(pz * py * px):
        cz, cy, cx = rank_coords(r, grid)
        g[cz * nz:(cz + 1) * nz, cy * ny:(cy + 1) * ny, cx * nx:(cx + 1) * nx] = \
            interior(seed, r, n, device, buffer).to(dtype)
    return g


def assemble(interiors: torch.Tensor, grid: Sequence[int], dtype=torch.float64) -> torch.Tensor:
    """The global field that ranks' ``(R, nz, ny, nx)`` interiors tile."""
    R, nz, ny, nx = interiors.shape
    pz, py, px = grid
    g = torch.empty((pz * nz, py * ny, px * nx), dtype=dtype, device=interiors.device)
    for r in range(R):
        cz, cy, cx = rank_coords(r, grid)
        g[cz * nz:(cz + 1) * nz, cy * ny:(cy + 1) * ny, cx * nx:(cx + 1) * nx] = \
            interiors[r].to(dtype)
    return g


def expected_block(g: torch.Tensor, grid: Sequence[int], rank: int,
                   radii: Sequence[int]) -> torch.Tensor:
    """Rank ``rank``'s local block with halo shells of ``radii``: each
    cell the global field at its periodic position."""
    c = rank_coords(rank, grid)
    idx = []
    for axis in range(3):
        N = g.shape[axis]
        n = N // grid[axis]
        lo = c[axis] * n - radii[axis]
        idx.append(torch.arange(lo, lo + n + 2 * radii[axis], device=g.device) % N)
    return g.index_select(0, idx[0]).index_select(1, idx[1]).index_select(2, idx[2])


def offsets(radii: Sequence[int]) -> List[Tuple[int, int, int]]:
    rz, ry, rx = radii
    return [d for d in itertools.product(range(-rz, rz + 1), range(-ry, ry + 1),
                                         range(-rx, rx + 1)) if d != (0, 0, 0)]


def coefficients(radii: Sequence[int], weight: float, dtype=torch.float32) -> Tuple[float, float]:
    """(neighbour factor ``w / N``, centre factor ``1 - w``), each
    rounded in ``dtype`` from ``w`` rounded in ``dtype``."""
    w = torch.tensor(weight, dtype=dtype)
    return float(w / len(offsets(radii))), float(1 - w)


def _dirichlet(r: int, k: torch.Tensor) -> torch.Tensor:
    """``sum over j in [-r, r] of exp(i j k)`` = ``1 + 2 sum cos(j k)``."""
    out = torch.ones_like(k)
    for j in range(1, r + 1):
        out += 2 * torch.cos(j * k)
    return out


def stencil_fft(g: torch.Tensor, ops: Sequence[Op], repeats: int) -> torch.Tensor:
    """``repeats`` passes of the op cycle over the periodic field ``g``,
    in float64 through its Fourier symbol."""
    Z, Y, X = g.shape
    dev = g.device
    kz = 2 * math.pi * torch.fft.fftfreq(Z, device=dev, dtype=torch.float64)
    ky = 2 * math.pi * torch.fft.fftfreq(Y, device=dev, dtype=torch.float64)
    kx = 2 * math.pi * torch.fft.rfftfreq(X, device=dev, dtype=torch.float64)
    symbol = None
    for radii, weight in ops:
        a, b = coefficients(radii, weight)
        s = (_dirichlet(radii[0], kz)[:, None, None] * _dirichlet(radii[1], ky)[None, :, None]
             * _dirichlet(radii[2], kx)[None, None, :] - 1.0)
        lam = s.mul_(a).add_(b)
        symbol = lam if symbol is None else symbol.mul_(lam)
    spec = torch.fft.rfftn(g.to(torch.float64))
    spec.mul_(symbol.pow_(repeats))
    del symbol
    return torch.fft.irfftn(spec, s=(Z, Y, X))


def _wrap_pad(u: torch.Tensor, radii: Sequence[int]) -> torch.Tensor:
    for dim, r in zip((0, 1, 2), radii):
        if r:
            n = u.shape[dim]
            u = torch.cat([u.narrow(dim, n - r, r), u, u.narrow(dim, 0, r)], dim)
    return u


def stencil_direct(g: torch.Tensor, ops: Sequence[Op], repeats: int,
                   dtype=torch.float32, coef_dtype=None) -> torch.Tensor:
    """``repeats`` passes of the op cycle over the periodic field ``g``,
    one op at a time with every value held in ``dtype`` and the factors
    rounded in ``coef_dtype`` (default ``dtype``)."""
    u = g.to(dtype)
    Z, Y, X = u.shape
    for _ in range(repeats):
        for radii, weight in ops:
            a, b = coefficients(radii, weight, coef_dtype or dtype)
            p = _wrap_pad(u, radii)
            rz, ry, rx = radii
            acc = torch.zeros_like(u)
            for dz, dy, dx in offsets(radii):
                acc += p[rz + dz:rz + dz + Z, ry + dy:ry + dy + Y, rx + dx:rx + dx + X]
            del p
            u = acc.mul_(a).add_(u * b)
    return u


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def judge_iterate(interiors: torch.Tensor, seed: int, grid: Sequence[int],
                  ops: Sequence[Op], repeats: int) -> Dict[str, float]:
    """The number compared after ``repeats`` cycle passes: the largest
    gap between a judged interior cell and the reference's, over the
    reference's largest magnitude (the smoothing shrinks the initial
    N(0, 1) field, so a gap in its units would loosen as the window
    grows)."""
    n = tuple(interiors.shape[1:])
    ref = stencil_fft(global_field(seed, grid, n, interiors.device, torch.float64), ops, repeats)
    scale = float(ref.abs().max())
    ref.sub_(assemble(interiors, grid)).abs_()
    return {"max_rel_err": _finite(float(ref.max()) / scale)}


def judge_exchange(blocks: torch.Tensor, ranks: Sequence[int], seed: int,
                   grid: Sequence[int], n: Sequence[int], radii: Sequence[int]) -> Dict[str, float]:
    """The number compared after halo exchanges: cells of the judged
    local blocks (``blocks[b, i]`` is rank ``ranks[i]``'s in state
    buffer ``b``, halos included) that differ from that buffer's
    periodic global field, NaN counted as differing."""
    bad = 0
    for b in range(blocks.shape[0]):
        g = global_field(seed, grid, n, blocks.device, buffer=b)
        for i, r in enumerate(ranks):
            bad += int((blocks[b, i] != expected_block(g, grid, r, radii)).sum())
        del g
    return {"mismatched_cells": bad}
