"""Per-dimension-radius stencils with shrinking-region deep-halo
application (paper §6.4: "standard 26 point" stencil, radius-2 halos,
periodic boundaries, 4-byte gridpoints).

A :class:`StencilOp` is one weighted box-neighborhood update with
per-dimension radii ``(rz, ry, rx)``; the paper's 26-point stencil is
``StencilOp((1, 1, 1))``.  After one exchange at halo depth ``valid``,
each application of a radius-``r`` op leaves a region deeper by ``r``
invalid, so :func:`stencil_apply` computes exactly the still-valid
window and :func:`stencil_steps` walks ``valid`` down step by step: one
radius-2 exchange hosts two radius-1 applications.

Every function takes the local block with any leading dimensions — the
local mesh's ``(R, az, ay, ax)`` state updates all R ranks in one call —
and updates it in place.  All window arithmetic goes through the shared
:func:`repro_torch.kernels.ops.stencil_window_update` primitive, which
accumulates in the reference's order.  The stencil is plain torch: the
reference computes it in jnp, with no Pallas kernel.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Sequence, Tuple, Union

import torch

from repro_torch.halo.exchange import HaloSpec
from repro_torch.kernels.ops import stencil_window_update

__all__ = [
    "StencilOp",
    "STENCIL26",
    "as_ops",
    "cycle_halo_radii",
    "cycle_radii",
    "op_sequence",
    "stencil_apply",
    "stencil_cycle",
    "stencil_steps",
    "stencil_iterations",
    "stencil26",
]

#: one op or a heterogeneous cycle of them
Ops = Union["StencilOp", Sequence["StencilOp"]]


@dataclass(frozen=True)
class StencilOp:
    """One weighted box-neighborhood update with per-dimension radii.

    ``new[i] = (1-w) * u[i] + w/N * sum over the N offsets d of u[i+d]``
    where the offsets are every nonzero point of the
    ``[-rz..rz] x [-ry..ry] x [-rx..rx]`` box.
    """

    radii: Tuple[int, int, int] = (1, 1, 1)
    weight: float = 0.4

    def __post_init__(self):
        r = tuple(int(x) for x in self.radii)
        if len(r) != 3 or any(x < 1 for x in r):
            raise ValueError(f"stencil radii must be 3 positive ints, got {r}")
        object.__setattr__(self, "radii", r)

    @property
    def offsets(self) -> Tuple[Tuple[int, int, int], ...]:
        """All nonzero neighbor offsets, in a deterministic order (the
        accumulation order — part of the bit-exactness contract)."""
        rz, ry, rx = self.radii
        return tuple(
            d
            for d in itertools.product(
                range(-rz, rz + 1), range(-ry, ry + 1), range(-rx, rx + 1)
            )
            if d != (0, 0, 0)
        )

    @property
    def nneighbors(self) -> int:
        rz, ry, rx = self.radii
        return (2 * rz + 1) * (2 * ry + 1) * (2 * rx + 1) - 1

    def halo_radii(self, steps: int) -> Tuple[int, int, int]:
        """Per-dimension halo depth that lets ``steps`` applications run
        on one exchange."""
        return tuple(steps * r for r in self.radii)


#: the paper's 26-point stencil (radius 1 in every dimension)
STENCIL26 = StencilOp((1, 1, 1))


def as_ops(op: Ops) -> Tuple[StencilOp, ...]:
    """Normalize one op or an op sequence into a nonempty cycle tuple."""
    ops = (op,) if isinstance(op, StencilOp) else tuple(op)
    if not ops or not all(isinstance(o, StencilOp) for o in ops):
        raise ValueError(f"expected a StencilOp or a nonempty sequence, got {op!r}")
    return ops


def cycle_radii(op: Ops) -> Tuple[int, int, int]:
    """Per-dimension valid-halo depth ONE cycle pass consumes."""
    ops = as_ops(op)
    return tuple(sum(o.radii[d] for o in ops) for d in range(3))


def cycle_halo_radii(op: Ops, repeats: int) -> Tuple[int, int, int]:
    """Per-dimension halo depth that hosts ``repeats`` cycle passes."""
    return tuple(repeats * r for r in cycle_radii(op))


def op_sequence(op: Ops, repeats: int) -> Tuple[StencilOp, ...]:
    """The flattened application schedule: the cycle repeated."""
    if repeats < 1:
        raise ValueError(f"cycle repeats must be >= 1, got {repeats}")
    return as_ops(op) * repeats


def _as_radii(valid, spec: HaloSpec) -> Tuple[int, int, int]:
    if valid is None:
        return spec.radii
    if isinstance(valid, int):
        return (valid, valid, valid)
    return tuple(valid)


def stencil_apply(
    local: torch.Tensor, spec: HaloSpec, valid=None, op: StencilOp = STENCIL26
) -> torch.Tensor:
    """One stencil application over the still-valid window, in place.

    ``valid`` is the per-dimension halo depth whose cells currently hold
    correct values (default: the full ``spec.radii`` — "the exchange
    just ran").  The update writes interior plus a shell of
    ``valid - op.radii``; returns ``local``.
    """
    valid = _as_radii(valid, spec)
    radii = spec.radii
    for v, r, hr in zip(valid, op.radii, radii):
        if v < r:
            raise ValueError(
                f"valid halo depth {valid} is shallower than the stencil "
                f"radii {op.radii}; exchange first"
            )
        if v > hr:
            raise ValueError(f"valid depth {valid} exceeds halo radii {radii}")
    shell = tuple(v - r for v, r in zip(valid, op.radii))
    origin = tuple(hr - s for hr, s in zip(radii, shell))
    shape = tuple(n + 2 * s for n, s in zip(spec.interior, shell))
    updated = stencil_window_update(local, op.offsets, op.weight, origin, shape)
    (z, y, x), (nz, ny, nx) = origin, shape
    local[..., z : z + nz, y : y + ny, x : x + nx] = updated
    return local


def stencil_cycle(local, spec: HaloSpec, op: Ops, repeats: int = 1, valid=None):
    """``repeats`` passes of a (possibly heterogeneous) op cycle on one
    exchange, in place; the valid region shrinks by each op's radii."""
    valid = _as_radii(valid, spec)
    need = cycle_halo_radii(op, repeats)
    if any(n > v for n, v in zip(need, valid)):
        raise ValueError(
            f"{repeats} repeats of cycle radii {cycle_radii(op)} exhaust "
            f"the valid halo depth {valid}"
        )
    for o in op_sequence(op, repeats):
        local = stencil_apply(local, spec, valid, o)
        valid = tuple(v - r for v, r in zip(valid, o.radii))
    return local


def stencil_steps(local, spec: HaloSpec, steps: int, op: StencilOp = STENCIL26,
                  valid=None):
    """``steps`` applications of ONE op on one exchange."""
    return stencil_cycle(local, spec, (op,), steps, valid)


def stencil26(local, spec: HaloSpec):
    """One 26-point update of the still-valid window (halos current)."""
    return stencil_apply(local, spec, op=STENCIL26)


def stencil_iterations(local, spec: HaloSpec, steps: int):
    """``steps`` 26-point applications on one exchange (shrinking valid
    region), in place."""
    return stencil_steps(local, spec, steps, STENCIL26)
