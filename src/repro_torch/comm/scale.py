"""Simulated-scale wire plans: the 3072-process regime without hardware.

The paper's headline number is a 3D halo exchange at 3072 processes; one
card has one GPU.  What it does have is the measured wire tables, and
every term of the model's schedule prices is a pure function of per-rank
bytes, class counts and link classes.  So instead of materializing a
3072-rank :class:`~repro_torch.comm.wireplan.WirePlan` (whose
uniform-collective tables alone would be a 3072 x 3072 matrix),
:func:`build_scale_plan` constructs a :class:`ScalePlan`, a lightweight
stand-in carrying exactly the attributes the pricing paths read,
analytically from the exchange geometry:

* process grid: the pencil decomposition ``(nodes, fy, fx)`` with
  ``(fy, fx)`` a near-square factorization of ``ranks_per_node`` —
  row-major ranking then puts one leading-axis slab per node, so
  leading-axis (``dz != 0``) delta classes cross the inter-node tier
  and all others stay on the fast tier;
* delta classes: the distinct neighbor displacements of the periodic
  ``(2*radius+1)^3 - 1``-direction stencil, merged modulo the grid dims
  (a dim of extent 2 folds +1 and -1 into one class, exactly as
  ``plan_wire``'s destination-vector grouping would);
* class bytes: face/edge/corner cell counts from the interior extents
  and radius, summed over each class's member directions;
* link classes and tier bundles:
  :func:`repro_torch.comm.topology.classify_and_coalesce` over the
  materialized destination vectors (O(classes x ranks)), so the
  simulated plan classifies exactly as a real plan on the same topology.

:meth:`repro_torch.comm.perfmodel.PerfModel.at_scale` prices one scale;
:func:`scale_ladder` sweeps rank counts into the predicted schedule
ladder.  Both equal the reference's (``repro.comm.scale``) on the same
tables.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.comm.topology import Topology, classify_and_coalesce

__all__ = [
    "ScaleGroup",
    "ScalePlan",
    "ScaleEstimate",
    "build_scale_plan",
    "scale_ladder",
]


@dataclass(frozen=True)
class ScaleGroup:
    """One delta class of a simulated exchange: the directions it
    merged and their summed per-rank wire bytes."""

    directions: Tuple[Tuple[int, int, int], ...]
    nbytes: int


@dataclass(frozen=True)
class ScalePlan:
    """Duck-typed stand-in for a :class:`~repro_torch.comm.wireplan.WirePlan`
    carrying only what the pricing paths read — no per-rank segment
    layout, no O(ranks^2) collective tables."""

    nranks: int
    grid: Tuple[int, int, int]
    groups: Tuple[ScaleGroup, ...]
    wire_bytes: int
    seg_bytes: int
    fused: bool
    link_classes: Tuple[str, ...]
    tier_bundles: Tuple[Tuple[int, ...], ...]
    topology: Topology
    schedule: str = "grouped"

    @property
    def ngroups(self) -> int:
        return len(self.groups)

    @property
    def correction_bytes(self) -> int:
        """Same accounting as ``WirePlan.correction_bytes``: bytes every
        non-representative bundle member re-transmits on the fast tier."""
        return sum(
            self.groups[g].nbytes for b in self.tier_bundles for g in b[1:]
        )

    @property
    def class_cum_bytes(self) -> Tuple[int, ...]:
        out, cum = [], 0
        for grp in self.groups:
            cum += grp.nbytes
            out.append(cum)
        return tuple(out)


@dataclass(frozen=True)
class ScaleEstimate:
    """One rung of the simulated-scale ladder (``PerfModel.at_scale``)."""

    ranks: int
    nodes: int
    grid: Tuple[int, int, int]
    schedule: str               # model-cheapest (or pinned) schedule
    costs: Dict[str, float]     # schedule -> predicted seconds
    wire_bytes: int             # exact payload per rank per exchange
    correction_bytes: int       # tiered's extra fast-tier bytes
    inter_messages: Dict[str, int]  # schedule -> slow-tier messages/rank
    fingerprint: str            # the decision row key this scale pins
    pinned: bool                # True: schedule came from an existing pin


def _factor2(n: int) -> Tuple[int, int]:
    """Near-square (a, b) with a * b == n and a >= b."""
    b = int(math.isqrt(n))
    while b > 1 and n % b:
        b -= 1
    return n // b, b


def build_scale_plan(
    ranks: int,
    ranks_per_node: int,
    interior: Tuple[int, int, int] = (8, 8, 8),
    radius: int = 1,
    element_bytes: int = 4,
) -> ScalePlan:
    """Analytic wire plan of the 3D periodic halo exchange on ``ranks``
    processes, ``ranks_per_node`` per node (see the module docstring
    for the geometry)."""
    ranks = int(ranks)
    ranks_per_node = int(ranks_per_node)
    if ranks <= 0 or ranks_per_node <= 0:
        raise ValueError("ranks and ranks_per_node must be > 0")
    if ranks % ranks_per_node:
        raise ValueError(
            f"ranks={ranks} is not a multiple of "
            f"ranks_per_node={ranks_per_node}"
        )
    nodes = ranks // ranks_per_node
    fy, fx = _factor2(ranks_per_node)
    grid = (nodes, fy, fx)
    topology = Topology.blocked(ranks, ranks_per_node)

    # delta classes: directions merged by displacement mod the grid dims
    # (identical destination vector <=> identical displacement mod dims);
    # an all-zero key is a self-send — a local copy, never on the wire
    r = int(radius)
    key_to_dirs: Dict[Tuple[int, int, int], List[Tuple[int, int, int]]] = {}
    for d in itertools.product(range(-r, r + 1), repeat=3):
        if d == (0, 0, 0):
            continue
        key = tuple(di % g for di, g in zip(d, grid))
        if key == (0, 0, 0):
            continue
        key_to_dirs.setdefault(key, []).append(d)

    groups: List[ScaleGroup] = []
    dsts: List[Tuple[int, ...]] = []
    strides = (fy * fx, fx, 1)
    for key, dirs in key_to_dirs.items():
        nbytes = sum(
            math.prod(
                r if di else n for di, n in zip(d, interior)
            ) * int(element_bytes)
            for d in dirs
        )
        groups.append(ScaleGroup(directions=tuple(dirs), nbytes=nbytes))
        kz, ky, kx = key
        dsts.append(
            tuple(
                ((rank // strides[0] + kz) % grid[0]) * strides[0]
                + ((rank // strides[1] % grid[1] + ky) % grid[1]) * strides[1]
                + ((rank % grid[2] + kx) % grid[2])
                for rank in range(ranks)
            )
        )
    link_classes, tier_bundles = classify_and_coalesce(dsts, topology)
    return ScalePlan(
        nranks=ranks,
        grid=grid,
        groups=tuple(groups),
        wire_bytes=sum(g.nbytes for g in groups),
        seg_bytes=max((g.nbytes for g in groups), default=0),
        fused=len(groups) <= ranks,
        link_classes=link_classes,
        tier_bundles=tier_bundles,
        topology=topology,
    )


def scale_ladder(
    model,
    rank_counts: Sequence[int],
    ranks_per_node: int,
    interior: Tuple[int, int, int] = (8, 8, 8),
    radius: int = 1,
    element_bytes: int = 4,
    axis: Optional[str] = None,
    native: Optional[bool] = None,
    pin: bool = True,
) -> Tuple[ScaleEstimate, ...]:
    """The predicted schedule ladder: ``model.at_scale`` at each rank
    count (ascending), fixed ranks-per-node: the paper's scaling-study
    sweep run entirely on the measured tables."""
    return tuple(
        model.at_scale(
            n,
            ranks_per_node=ranks_per_node,
            interior=interior,
            radius=radius,
            element_bytes=element_bytes,
            axis=axis,
            native=native,
            pin=pin,
        )
        for n in sorted(int(n) for n in rank_counts)
    )
