"""3D stencil halo exchange on datatype-described halo regions
(paper §6.4 case study).

Each rank owns an interior block of ``(nz, ny, nx)`` gridpoints inside a
local allocation ``(nz+2r, ny+2r, nx+2r)`` (halo shells of radius ``r``).
The 26 neighbor regions (6 faces, 12 edges, 8 corners, periodic domain)
are each described by an MPI-style ``Subarray`` datatype, committed once
and exchanged every iteration through one fused
:meth:`~repro_torch.comm.api.Communicator.neighbor_alltoallv`: all 26
regions packed at their exact wire extents into one flat buffer laid out
by a :class:`~repro_torch.comm.wireplan.WirePlan` — on a periodic 2x2x2
grid the 26 directions collapse into 7 displacement classes.  The whole
layout (committed types, strategies, wire plan) is built once at
:func:`make_halo_step` time (:class:`HaloPlan`).

On the local-mesh transport the state of all R ranks is one tensor
``(R, az, ay, ax)`` on one device: every pack and unpack kernel launch
serves all ranks at once, and the exchange fills the halo shells in
place.  Under one process per rank
(:class:`~repro_torch.comm.distributed.DistributedTransport`) each
process holds its own rank's ``(1, az, ay, ax)`` block and builds the
same global plan as every other rank.

On a two-level machine (a communicator built with a
:class:`~repro_torch.comm.topology.Topology`) the same planning pass
annotates each delta class with the link tier it crosses, and the model
may pick the ``tiered`` schedule: the classes bound for one peer node
coalesced into one slow-tier message, forwarded to their true ranks by
intra-node hops.  The topology rides ``Communicator.plan_neighbor`` into
the wire plan; nothing here changes but that every rank must hold the
same one.

Switching the communicator policy between ``baseline`` and ``tempi``
reproduces the paper's comparison with zero changes here.
"""

from __future__ import annotations

import itertools
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.comm.api import Communicator, Request, Strategy
from repro_torch.comm.wireplan import WirePlan
from repro_torch.core.commit import CommittedType
from repro_torch.core.datatypes import FLOAT, Named, Subarray
from repro_torch.device import resolve_device

__all__ = [
    "HaloSpec",
    "HaloPlan",
    "DIRECTIONS",
    "from_reference",
    "halo_exchange",
    "ihalo_exchange",
    "make_halo_types",
    "make_halo_plan",
    "make_halo_step",
    "CAPTURED_BUFFERS",
]

#: the 26 neighbor directions (dz, dy, dx)
DIRECTIONS: Tuple[Tuple[int, int, int], ...] = tuple(
    d for d in itertools.product((-1, 0, 1), repeat=3) if d != (0, 0, 0)
)


@dataclass(frozen=True)
class HaloSpec:
    """Geometry of one rank's local block.

    ``radius`` is either one scalar (the paper's symmetric radius-2
    setup) or a per-dimension ``(rz, ry, rx)`` tuple.
    """

    grid: Tuple[int, int, int]     # process grid (pz, py, px)
    interior: Tuple[int, int, int]  # (nz, ny, nx) gridpoints per rank
    radius: Union[int, Tuple[int, int, int]] = 2  # paper: stencil radius 2
    element: Named = FLOAT          # paper: 4-byte gridpoints

    @property
    def radii(self) -> Tuple[int, int, int]:
        if isinstance(self.radius, tuple):
            return self.radius
        return (self.radius, self.radius, self.radius)

    @property
    def alloc(self) -> Tuple[int, int, int]:
        return tuple(n + 2 * r for n, r in zip(self.interior, self.radii))

    @property
    def nranks(self) -> int:
        return int(np.prod(self.grid))

    def coords(self, rank: int) -> Tuple[int, int, int]:
        pz, py, px = self.grid
        return (rank // (py * px), (rank // px) % py, rank % px)

    def rank_of(self, c: Sequence[int]) -> int:
        pz, py, px = self.grid
        return (c[0] % pz) * py * px + (c[1] % py) * px + (c[2] % px)

    def perm(self, d: Tuple[int, int, int]) -> List[Tuple[int, int]]:
        """(src, dst) edges: every rank sends toward direction ``d``
        (periodic)."""
        return [
            (r, self.rank_of(tuple(ci + di for ci, di in zip(self.coords(r), d))))
            for r in range(self.nranks)
        ]


def _region_type(spec: HaloSpec, d, kind: str) -> Subarray:
    """Subarray datatype for the send/recv region of direction ``d``.

    kind="send": the interior slab facing ``d``.
    kind="recv": the halo shell on side ``-d`` (filled by the neighbor at
    ``-d`` during round ``d``).
    """
    radii = spec.radii
    sub, start = [], []
    for axis in range(3):
        n = spec.interior[axis]
        r = radii[axis]
        di = d[axis]
        if di == 0:
            sub.append(n)
            start.append(r)
        else:
            sub.append(r)
            if kind == "send":
                start.append(r if di < 0 else n)       # low/high interior slab
            else:
                start.append(n + r if di < 0 else 0)   # halo shell on side -d
    # paper order: index 0 = innermost (x); local arrays are (z, y, x)
    return Subarray(
        tuple(reversed(spec.alloc)),
        tuple(reversed(sub)),
        tuple(reversed(start)),
        spec.element,
    )


def make_halo_types(
    spec: HaloSpec, comm: Communicator
) -> Dict[Tuple[int, int, int], Tuple[CommittedType, CommittedType]]:
    """Commit all 26 (send, recv) datatypes once."""
    return {
        d: (comm.commit(_region_type(spec, d, "send")),
            comm.commit(_region_type(spec, d, "recv")))
        for d in DIRECTIONS
    }


@dataclass(frozen=True)
class HaloPlan:
    """Everything a halo exchange needs, computed once: the committed
    (send, recv) types, their permutations, the selected strategies, and
    the exact-byte wire plan."""

    spec: HaloSpec
    send_cts: Tuple[CommittedType, ...]
    recv_cts: Tuple[CommittedType, ...]
    perms: Tuple[Tuple[Tuple[int, int], ...], ...]
    strategies: Tuple[Strategy, ...]
    wire: WirePlan

    @property
    def wire_bytes(self) -> int:
        """Exact bytes one exchange puts on the wire per rank."""
        return self.wire.wire_bytes


def make_halo_plan(
    spec: HaloSpec, comm: Communicator, types=None,
    schedule_policy: Optional[str] = None,
) -> HaloPlan:
    """Commit the 26 region types, select strategies, and lay out the
    exact-byte wire plan — the full setup cost of a halo exchange, paid
    once.  Pass ``schedule_policy="exact"`` for the byte-exact ladder."""
    if types is None:
        types = make_halo_types(spec, comm)
    send_cts = tuple(types[d][0] for d in DIRECTIONS)
    recv_cts = tuple(types[d][1] for d in DIRECTIONS)
    perms = tuple(tuple(spec.perm(d)) for d in DIRECTIONS)
    strategies, wire = comm.plan_neighbor(
        send_cts, perms, schedule_policy=schedule_policy
    )
    return HaloPlan(spec, send_cts, recv_cts, perms, strategies, wire)


def _check_local(local: torch.Tensor, spec: HaloSpec, comm: Communicator) -> None:
    rows = comm.transport.local_ranks
    want = (spec.nranks if rows is None else rows,) + spec.alloc
    if tuple(local.shape) != want:
        raise ValueError(f"local has shape {tuple(local.shape)}; need {want}")
    if local.element_size() != spec.element.width:
        raise ValueError(
            f"local elements are {local.element_size()} bytes; the spec's "
            f"{spec.element.name} is {spec.element.width}"
        )


def ihalo_exchange(local: torch.Tensor, spec: HaloSpec, comm: Communicator,
                   types=None, plan: Optional[HaloPlan] = None) -> Request:
    """Nonblocking 26-neighbor halo exchange of the blocks ``local``
    holds (``(R, az, ay, ax)`` on the local mesh, this rank's
    ``(1, az, ay, ax)`` under one process per rank): the fused wire
    transport is issued now; ``wait()`` runs the 26 unpacks in place."""
    _check_local(local, spec, comm)
    if plan is None:
        plan = make_halo_plan(spec, comm, types)
    return comm.ineighbor_alltoallv(
        local, plan.send_cts, plan.recv_cts, plan.perms,
        plan=plan.wire, strategies=plan.strategies,
    )


def halo_exchange(local: torch.Tensor, spec: HaloSpec, comm: Communicator,
                  types=None, plan: Optional[HaloPlan] = None) -> torch.Tensor:
    """One full 26-neighbor halo exchange; fills every halo shell of
    ``local`` in place and returns it.  The blocking
    :meth:`Communicator.neighbor_alltoallv`: under a tracer the whole
    ``exchange`` span tree, with ``unpack``."""
    _check_local(local, spec, comm)
    if plan is None:
        plan = make_halo_plan(spec, comm, types)
    return comm.neighbor_alltoallv(
        local, plan.send_cts, plan.recv_cts, plan.perms,
        plan=plan.wire, strategies=plan.strategies,
    )


#: state buffers a halo step keeps a persistent exchange for, the least
#: recently used let go first
CAPTURED_BUFFERS = 4


def make_halo_step(spec: HaloSpec, comm: Optional[Communicator] = None, *,
                   device="cuda", schedule_policy: Optional[str] = None):
    """A plain callable ``step(local) -> local`` that exchanges the
    halos of the state in place (``(R, az, ay, ax)`` on the local mesh,
    this rank's ``(1, az, ay, ax)`` under one process per rank).  The
    halo plan is built here, once: the whole global plan, on every
    process, and every rank must hold the same one (checked through the
    transport).  Runs on the card unless ``device="cpu"``; a given
    ``comm`` must live on the same device.

    Each state buffer gets a persistent exchange
    (:meth:`Communicator.neighbor_alltoallv_init`), keyed by its address,
    shape, strides, dtype and device, so a buffer the step sees a third
    time replays its exchange from a CUDA graph where nothing blocks
    that (:attr:`~repro_torch.comm.api.PersistentRequest.blockers`); the
    address is in the key because a graph holds addresses and the pack
    kernels' vector width follows the pointer's alignment.  At most
    :data:`CAPTURED_BUFFERS` requests are kept (``step.requests``), each
    holding its buffer."""
    dev = resolve_device(device)
    if comm is None:
        comm = Communicator(device=dev)
    elif comm.device != dev:
        raise ValueError(f"communicator on {comm.device}; step asked for {dev}")
    plan = make_halo_plan(spec, comm, schedule_policy=schedule_policy)
    topo = comm.model.topology
    comm.transport.agree("the topology", topo.fingerprint if topo is not None else "flat")
    comm.transport.agree("the halo plan", plan.wire.fingerprint)

    requests: "OrderedDict[tuple, object]" = OrderedDict()

    def step(local: torch.Tensor) -> torch.Tensor:
        _check_local(local, spec, comm)
        key = (local.data_ptr(), tuple(local.shape), local.stride(), local.dtype, local.device)
        req = requests.pop(key, None)
        if req is None:
            req = comm.neighbor_alltoallv_init(local, plan.send_cts, plan.recv_cts, plan.perms,
                                               plan=plan.wire, strategies=plan.strategies)
            if len(requests) == CAPTURED_BUFFERS:
                requests.popitem(last=False)
        requests[key] = req
        req.start()
        return local

    step.plan = plan
    step.comm = comm
    step.requests = requests
    return step


def from_reference(local_np: np.ndarray, spec: HaloSpec, device="cuda",
                   rank: Optional[int] = None) -> torch.Tensor:
    """The state tensor from the reference's layout (``(R*az, ay, ax)``,
    sharded on the leading axis) or from an ``(R, az, ay, ax)`` array, on
    ``device`` (the card by default): all ranks' ``(R, az, ay, ax)``, or
    with ``rank`` that rank's ``(1, az, ay, ax)`` block, the state of
    one process per rank."""
    dev = resolve_device(device)
    arr = np.asarray(local_np).reshape((spec.nranks,) + spec.alloc)
    if rank is not None:
        if not 0 <= rank < spec.nranks:
            raise ValueError(f"rank {rank} is not one of the grid's {spec.nranks}")
        arr = arr[rank : rank + 1]
    return torch.from_numpy(np.array(arr, copy=True)).to(dev)
