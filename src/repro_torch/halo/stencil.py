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

Ops also compose into *cycles*: a heterogeneous sequence applied in
order and repeated; one pass consumes :func:`cycle_radii` of valid halo.

Overlap (:func:`overlapped_stencil_iteration`): the exchange is issued,
and while it is on the wire :func:`stencil_interior_chain` computes each
fused application's deep interior, the cells that read no halo at all.
Each application then computes only what the chain did not: the shell
around its chain block (six slabs), or, in ``region`` mode, the first
application's rim regions (:func:`halo_regions`) as their delta classes
land.  No cell of an application is computed twice.

Every function takes the local block with any leading dimensions — the
local mesh's ``(R, az, ay, ax)`` state updates all R ranks in one call,
one process per rank passes its ``(1, az, ay, ax)`` block — and updates
it in place.  All window arithmetic goes through the shared
:func:`repro_torch.kernels.ops.stencil_window_update` /
:func:`~repro_torch.kernels.ops.stencil_window_chain` primitives, which
accumulate in the reference's order, element by element, so a cell
comes out bit-identical whichever window computed it: that is what makes
the chain, the slabs and the regions splice into the plain path's
result.  On the card that primitive is one hand-written kernel
(``kernels/csrc/stencil.cu``) that reads each input cell from device
memory once; on the CPU it is the plain torch version, with the same
arithmetic.  The reference computes the stencil in jnp, with no Pallas
kernel.  :func:`stencil_cycle` chains its applications through one
scratch tensor, so no application of an even-length cycle copies its
window into the state, and an odd chain of radius-1 applications ends in
one fused launch of its last two
(:func:`~repro_torch.kernels.ops.stencil_window_pair`), which copies none
either.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Callable, ContextManager, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.halo.exchange import (
    DIRECTIONS,
    HaloPlan,
    HaloSpec,
    ihalo_exchange,
    make_halo_plan,
)
from repro_torch.kernels.ops import (
    stencil_window_chain,
    stencil_window_pair,
    stencil_window_update,
)
from repro_torch.obs.trace import region

#: stencil applications whose whole window was written aside and then
#: copied into the state (:func:`stencil_apply`, the last application of
#: an odd :func:`stencil_cycle` that does not end in the fused pair,
#: inside a ``tempi.splice`` range); readers take differences
splice_copies = 0

__all__ = [
    "StencilOp",
    "STENCIL26",
    "as_ops",
    "cycle_halo_radii",
    "cycle_radii",
    "op_sequence",
    "stencil_apply",
    "stencil_steps",
    "stencil_cycle",
    "stencil_interior_chain",
    "max_pipeline_depth",
    "stencil26",
    "stencil26_interior",
    "stencil_iterations",
    "OVERLAP_MODES",
    "HaloRegion",
    "halo_regions",
    "overlap_region_descriptors",
    "resolve_overlap_mode",
    "overlapped_stencil_iteration",
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


def _put(local: torch.Tensor, origin, values: torch.Tensor) -> None:
    """Write ``values`` into ``local``'s window at ``origin`` (last three
    dimensions), in place."""
    (z, y, x), (nz, ny, nx) = origin, values.shape[-3:]
    local[..., z : z + nz, y : y + ny, x : x + nx] = values


def _window_of(spec: HaloSpec, valid, op: StencilOp):
    """``(origin, shape)`` of the window one application of ``op`` may
    write when ``valid`` halo cells per side hold correct values:
    interior plus a shell of ``valid - op.radii``."""
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
    return origin, shape


def stencil_apply(
    local: torch.Tensor, spec: HaloSpec, valid=None, op: StencilOp = STENCIL26
) -> torch.Tensor:
    """One stencil application over the still-valid window, in place.

    ``valid`` is the per-dimension halo depth whose cells currently hold
    correct values (default: the full ``spec.radii`` — "the exchange
    just ran").  The update writes interior plus a shell of
    ``valid - op.radii``; returns ``local``.  The window is computed
    aside and copied in: one splice copy.
    """
    global splice_copies
    origin, shape = _window_of(spec, _as_radii(valid, spec), op)
    _put(local, origin, stencil_window_update(local, op.offsets, op.weight, origin, shape))
    splice_copies += 1
    return local


def _view(t: torch.Tensor, origin, shape) -> torch.Tensor:
    (z, y, x), (nz, ny, nx) = origin, shape
    return t[..., z : z + nz, y : y + ny, x : x + nx]


def stencil_cycle(local, spec: HaloSpec, op: Ops, repeats: int = 1, valid=None,
                  span: Optional[Callable[[int], ContextManager]] = None):
    """``repeats`` passes of a (possibly heterogeneous) op cycle on one
    exchange, in place; the valid region shrinks by each op's radii.

    The applications alternate between ``local`` and one scratch tensor
    of its shape.  Every window lies inside the one before it, grown by
    its own op's radii: application 1 reads ``local`` and writes its
    window into the scratch; application 2 reads the scratch and writes
    into ``local`` its window together with the rim around it, application
    1's cells that no later window covers, copied unchanged
    (``copy_rim``); and so on.  No application of an even chain copies a
    window back.  Any other odd chain ends with a copy of the last window
    from the scratch (a splice copy, counted in :data:`splice_copies`).
    An odd chain of three or more whose last two ops are radius-(1, 1, 1)
    boxes ends instead in the fused pair
    (:func:`~repro_torch.kernels.ops.stencil_window_pair`): its last two
    applications read the scratch once and write ``local``, so it copies
    nothing.  ``local`` then holds what applying each op in place would
    leave, halos included.  The scratch
    comes from the caching allocator, which hands the same block back at
    the next call of the same shape.

    Each application runs inside ``span(i)`` (default: one
    ``tempi.stencil`` range, :func:`~repro_torch.obs.trace.region`), the
    fused pair inside one ``span(i, 2)`` (applications ``i`` and ``i +
    1``); the copy at the end belongs to the last application's span, in
    a ``tempi.splice`` range of its own inside it."""
    global splice_copies
    valid = _as_radii(valid, spec)
    need = cycle_halo_radii(op, repeats)
    if any(n > v for n, v in zip(need, valid)):
        raise ValueError(
            f"{repeats} repeats of cycle radii {cycle_radii(op)} exhaust "
            f"the valid halo depth {valid}"
        )
    seq = op_sequence(op, repeats)
    windows = []
    for o in seq:
        windows.append(_window_of(spec, valid, o))
        valid = tuple(v - r for v, r in zip(valid, o.radii))
    paired = len(seq) >= 3 and len(seq) % 2 == 1 and all(o.radii == (1, 1, 1) for o in seq[-2:])
    singles = len(seq) - 2 if paired else len(seq)
    scratch = torch.empty_like(local)
    for i, (o, (origin, shape)) in enumerate(zip(seq[:singles], windows)):
        with (span or _stencil_region)(i):
            if i % 2 == 0:
                stencil_window_update(local, o.offsets, o.weight, origin, shape,
                                      out=_view(scratch, origin, shape))
            else:
                stencil_window_update(scratch, o.offsets, o.weight, origin, shape,
                                      out=_view(local, *windows[i - 1]), copy_rim=True)
            if i == len(seq) - 1 and i % 2 == 0:
                with region("splice"):
                    _put(local, origin, _view(scratch, origin, shape))
                splice_copies += 1
    if paired:
        first, second = seq[-2:]
        with (span or _stencil_region)(singles, 2):
            stencil_window_pair(scratch, first.offsets, (first.weight, second.weight),
                                *windows[-2], out=_view(local, *windows[-3]))
    return local


def _stencil_region(i: int, applications: int = 1) -> ContextManager:
    return region("stencil")


def stencil_steps(local, spec: HaloSpec, steps: int, op: StencilOp = STENCIL26,
                  valid=None):
    """``steps`` applications of ONE op on one exchange."""
    return stencil_cycle(local, spec, (op,), steps, valid)


def _cum_shrink(op: Ops, applications: int) -> List[Tuple[int, int, int]]:
    """Cumulative per-dimension shrink after each of the first
    ``applications`` applications of the repeating cycle."""
    cum = (0, 0, 0)
    out = []
    for o in itertools.islice(itertools.cycle(as_ops(op)), applications):
        cum = tuple(c + r for c, r in zip(cum, o.radii))
        out.append(cum)
    return out


def max_pipeline_depth(spec: HaloSpec, op: Ops, steps: int) -> int:
    """How many of the ``steps * len(ops)`` fused applications have a
    nonempty deep interior (every dim keeps >= 1 cell after the
    cumulative shrink from each side) — the depth
    :func:`stencil_interior_chain` can compute while the exchange is on
    the wire.  ``steps`` counts cycle repeats."""
    ops = as_ops(op)
    depth = 0
    for k, cum in enumerate(_cum_shrink(ops, steps * len(ops)), 1):
        if any(n - 2 * c < 1 for n, c in zip(spec.interior, cum)):
            break
        depth = k
    return depth


def stencil_interior_chain(
    local: torch.Tensor, spec: HaloSpec, depth: int, op: Ops = STENCIL26
) -> List[torch.Tensor]:
    """Applications ``1..depth`` of the repeating op cycle, restricted to
    the cells that need no halo data at all.

    Block ``k`` (1-indexed) holds the application-``k`` values of the
    interior shrunk by the cycle's cumulative radii per side, computed
    from ``local``'s interior alone, before any exchange completes.  An
    exchange only writes halo shells, so each block is bit-identical to
    the same region of the post-exchange application, which is what
    makes it legal to splice the chain into the iteration.  ``local`` is
    only read.
    """
    r, n = spec.radii, spec.interior
    x = local[..., r[0] : r[0] + n[0], r[1] : r[1] + n[1], r[2] : r[2] + n[2]]
    seq = list(itertools.islice(itertools.cycle(as_ops(op)), depth))
    try:
        return stencil_window_chain(x, [(o.offsets, o.weight, o.radii) for o in seq])
    except ValueError as e:
        raise ValueError(
            f"interior {spec.interior} too small for a depth-{depth} "
            f"chain of the cycle {[o.radii for o in as_ops(op)]}: {e}"
        ) from None


def stencil26(local, spec: HaloSpec):
    """One 26-point update of the still-valid window (halos current)."""
    return stencil_apply(local, spec, op=STENCIL26)


def stencil26_interior(local, spec: HaloSpec) -> torch.Tensor:
    """First-application update of the deep interior (no halo reads);
    returns the ``interior - 2`` block at origin ``radii + 1``."""
    return stencil_interior_chain(local, spec, 1, STENCIL26)[0]


def stencil_iterations(local, spec: HaloSpec, steps: int):
    """``steps`` 26-point applications on one exchange (shrinking valid
    region), in place."""
    return stencil_steps(local, spec, steps, STENCIL26)


# ---------------------------------------------------------------------------
# region decomposition: core + faces/edges/corners of the first application
# ---------------------------------------------------------------------------

#: how :func:`overlapped_stencil_iteration` consumes the wire:
#: ``monolithic`` waits for the fused exchange, then applies every rim
#: at once; ``region`` drains delta classes and computes each rim region
#: as its classes land; ``auto`` lets the model pick (pinned as an
#: ``overlap/mode=...`` decision)
OVERLAP_MODES = ("monolithic", "region", "auto")


@dataclass(frozen=True)
class HaloRegion:
    """One region of the FIRST fused application's output window.

    ``sig`` places it in the 3^3 core/face/edge/corner decomposition:
    ``sig[a] == 0`` means the region's axis-``a`` span reads no halo in
    that axis; ``-1``/``+1`` mean it reads the low/high halo shell.  The
    core is ``(0, 0, 0)`` (regions that come out empty for the geometry
    are dropped).  ``origin``/``shape`` locate the region in the local
    allocation; ``bands`` lists the halo-shell bands its cells may read
    and ``transfers`` the ``DIRECTIONS`` indices of the receive transfers
    that fill them: the region is computable once exactly those
    transfers have been unpacked.
    """

    sig: Tuple[int, int, int]
    origin: Tuple[int, int, int]
    shape: Tuple[int, int, int]
    bands: Tuple[Tuple[int, int, int], ...]
    transfers: Tuple[int, ...]

    @property
    def cells(self) -> int:
        return self.shape[0] * self.shape[1] * self.shape[2]


def halo_regions(spec: HaloSpec, op: Ops) -> Tuple[HaloRegion, ...]:
    """Decompose the first application's output window into core +
    faces/edges/corners.

    Per axis the window ``[0, w)`` (``w = n + 2 * (hr - r)``, origin
    ``r`` in the allocation) splits at ``m1 = min(hr, w)`` and
    ``m2 = max(w - hr, m1)``: cells below ``m1`` read the low halo
    shell, cells at ``m2`` and above the high one, the middle neither.
    The three intervals partition ``[0, w)`` — also when the interior is
    shallower than ``2r`` and the boundary intervals' dependency sets
    widen to both sides — so the nonempty regions exactly partition the
    window.  The dependency set is the per-axis product of
    ``{0} | sides`` minus the all-zero band: a superset of the bands
    actually read, which can only delay a region, never corrupt it.
    """
    ops = as_ops(op)
    first = ops[0]
    axes = []
    for n, hr, r in zip(spec.interior, spec.radii, first.radii):
        shell = hr - r
        o = r
        w = n + 2 * shell
        m1 = min(hr, w)
        m2 = max(w - hr, m1)
        low_sides = {-1} | ({+1} if m1 > w - hr else set())
        high_sides = {+1} | ({-1} if m2 < hr else set())
        axes.append({
            -1: (o, m1, low_sides),
            0: (o + m1, m2 - m1, set()),
            +1: (o + m2, w - m2, high_sides),
        })
    regions = []
    for sig in itertools.product((-1, 0, 1), repeat=3):
        origin, shape, sides = [], [], []
        for a, s in enumerate(sig):
            start, length, sd = axes[a][s]
            origin.append(start)
            shape.append(length)
            sides.append(sorted({0} | sd))
        if any(length <= 0 for length in shape):
            continue
        bands = tuple(b for b in itertools.product(*sides) if b != (0, 0, 0))
        transfers = tuple(sorted(
            DIRECTIONS.index((-b[0], -b[1], -b[2])) for b in bands
        ))
        regions.append(HaloRegion(sig, tuple(origin), tuple(shape), bands, transfers))
    return tuple(regions)


def _transfer_classes(wire) -> dict:
    """Transfer index -> delta-class index of the exchange's WirePlan."""
    out = {}
    for g, grp in enumerate(wire.groups):
        for i in grp.transfers:
            out[i] = g
    return out


def overlap_region_descriptors(
    spec: HaloSpec, op: Ops, wire
) -> Tuple[int, List[Tuple[int, Tuple[int, ...]]]]:
    """Reduce the geometry to what the model prices: the core window
    bytes plus one ``(window_bytes, dep_class_ids)`` pair per rim region
    (:meth:`repro_torch.comm.perfmodel.PerfModel.price_overlap`)."""
    eb = spec.element.size
    cls_of = _transfer_classes(wire)
    core_bytes = 0
    rims: List[Tuple[int, Tuple[int, ...]]] = []
    for reg in halo_regions(spec, op):
        nb = reg.cells * eb
        if reg.sig == (0, 0, 0):
            core_bytes += nb
        else:
            deps = tuple(sorted({cls_of[i] for i in reg.transfers}))
            rims.append((nb, deps))
    return core_bytes, rims


def resolve_overlap_mode(spec: HaloSpec, comm, plan: HaloPlan, op: Ops = STENCIL26) -> str:
    """Model-priced monolithic-vs-region choice for this exchange,
    pinned as an ``overlap/mode=...`` decision
    (:meth:`~repro_torch.comm.perfmodel.PerfModel.choose_overlap_mode`)."""
    ops = as_ops(op)
    core_bytes, rims = overlap_region_descriptors(spec, ops, plan.wire)
    mode, _, _ = comm.model.choose_overlap_mode(
        plan.wire, rims, core_bytes, ops[0].nneighbors
    )
    return mode


def _shell_slabs(origin, shape, inner_origin, inner_shape):
    """The six boxes (z, then y, then x slabs; empty ones dropped) that
    partition the window ``origin + shape`` minus the box
    ``inner_origin + inner_shape`` inside it, as ``(origin, shape)``."""
    (oz, oy, ox), (nz, ny, nx) = origin, shape
    (iz, iy, ix), (mz, my, mx) = inner_origin, inner_shape
    boxes = [
        ((oz, oy, ox), (iz - oz, ny, nx)),
        ((iz + mz, oy, ox), (oz + nz - iz - mz, ny, nx)),
        ((iz, oy, ox), (mz, iy - oy, nx)),
        ((iz, iy + my, ox), (mz, oy + ny - iy - my, nx)),
        ((iz, iy, ox), (mz, my, ix - ox)),
        ((iz, iy, ix + mx), (mz, my, ox + nx - ix - mx)),
    ]
    return [(o, s) for o, s in boxes if all(d > 0 for d in s)]


def _apply_around(local: torch.Tensor, spec: HaloSpec, valid, op: StencilOp,
                  block_origin, block: torch.Tensor) -> None:
    """One application over the still-valid window, in place, whose
    values inside the box at ``block_origin`` are already known
    (``block``, a chain block): only the shell around it is computed.
    Every slab reads the pre-application values, so all are computed
    before any is written."""
    origin, shape = _window_of(spec, valid, op)
    patches = [
        (o, stencil_window_update(local, op.offsets, op.weight, o, s))
        for o, s in _shell_slabs(origin, shape, block_origin, block.shape[-3:])
    ]
    for o, values in patches:
        _put(local, o, values)
    _put(local, block_origin, block)


def _apply_region_split(req, spec: HaloSpec, ops: Tuple[StencilOp, ...], wire,
                        chain_core: Optional[torch.Tensor], probe: Optional[dict]):
    """The first fused application, region-split: drain delta classes in
    completion order (``NeighborRequest.wait_any``) and compute each rim
    region the moment its dependency classes have been unpacked.

    Rim windows read overlapping cells (a face's neighborhood reaches
    into the adjacent edges), so the computed windows are kept as
    deferred patches and written only after every class has drained:
    each region reads pre-application values exactly like the full
    window update.  The core, when nonempty, is the interior chain's
    first block, computed while the wire was in flight; the rims and the
    core partition the window.
    """
    first = ops[0]
    cls_of = _transfer_classes(wire)
    rims = [r for r in halo_regions(spec, ops) if r.sig != (0, 0, 0)]
    deps = [frozenset(cls_of[i] for i in r.transfers) for r in rims]
    landed: set = set()
    done = [False] * len(rims)
    patches = []
    order: List[Tuple[int, int, int]] = []

    def sweep() -> None:
        for i, reg in enumerate(rims):
            if not done[i] and deps[i] <= landed:
                win = stencil_window_update(
                    req.buffer, first.offsets, first.weight, reg.origin, reg.shape
                )
                patches.append((reg.origin, win))
                done[i] = True
                order.append(reg.sig)

    while req.pending:
        landed.add(req.wait_any().index)
        sweep()
    full = req.wait()
    for origin, win in patches:
        _put(full, origin, win)
    if chain_core is not None:
        _put(full, tuple(hr + r for hr, r in zip(spec.radii, first.radii)), chain_core)
    if probe is not None:
        probe["rim_regions"] = len(rims)
        probe["region_order"] = tuple(order)
        probe["class_drain_order"] = tuple(req.drained)
    return full


# ---------------------------------------------------------------------------
# overlap: the exchange hidden behind the interior chain
# ---------------------------------------------------------------------------

def overlapped_stencil_iteration(
    local: torch.Tensor,
    spec: HaloSpec,
    comm,
    types=None,
    steps: int = 2,
    probe: Optional[dict] = None,
    plan: Optional[HaloPlan] = None,
    op: Ops = STENCIL26,
    mode: str = "monolithic",
) -> torch.Tensor:
    """One exchange + ``steps`` cycle repeats, in place, with the wire
    hidden behind the interior chain.

    ``op`` is one op or a heterogeneous cycle; ``steps`` counts cycle
    repeats.  The fused exchange is issued first (:func:`ihalo_exchange`;
    on the card its packs and wire ops run on the communicator's side
    stream); while it is in flight :func:`stencil_interior_chain`
    computes every fused application's deep interior on the caller's
    stream.  ``mode`` (:data:`OVERLAP_MODES`) picks how the first
    application consumes the wire:

    ``monolithic``  ``wait()`` for every class, then each application
                    computes the shell around its chain block.
    ``region``      drain delta classes in completion order and compute
                    each rim region of the first application as its
                    classes land (:func:`halo_regions`); applications
                    ``2..`` follow the monolithic path.
    ``auto``        the model prices both and the choice is pinned as an
                    ``overlap/mode=...`` decision.

    Every mode is bit-identical to ``halo_exchange`` + ``stencil_cycle``
    and computes each cell of an application once.  No application
    writes the state before every class has drained: the side stream's
    packs read the interior cells the applications write.  The chain is
    enqueued inside a ``tempi.interior`` range, and each application's
    shell around its chain block inside a ``tempi.shell`` range.

    ``probe``, when given, records ``pending_during_interior`` (the
    exchange was still pending when the chain was enqueued),
    ``pipeline_depth`` and ``overlap_mode`` (the resolved mode); region
    mode adds ``rim_regions``, ``region_order`` and
    ``class_drain_order``.
    """
    ops = as_ops(op)
    if mode not in OVERLAP_MODES:
        raise ValueError(f"unknown overlap mode {mode!r}; expected one of {OVERLAP_MODES}")
    if any(n > v for n, v in zip(cycle_halo_radii(ops, steps), spec.radii)):
        raise ValueError(
            f"halo radii {spec.radii} cannot host {steps} repeats of "
            f"cycle radii {cycle_radii(ops)}"
        )
    if plan is None:
        plan = make_halo_plan(spec, comm, types)
    if mode == "auto":
        mode = resolve_overlap_mode(spec, comm, plan, ops)
    depth = max_pipeline_depth(spec, ops, steps)
    req = ihalo_exchange(local, spec, comm, plan=plan)  # the wire, now
    with region("interior"):
        chain = stencil_interior_chain(local, spec, depth, ops)  # beside the wire
    if probe is not None:
        probe["pending_during_interior"] = not req.completed
        probe["pipeline_depth"] = depth
        probe["overlap_mode"] = mode
    valid = spec.radii
    seq = op_sequence(ops, steps)
    shrink = _cum_shrink(ops, len(seq))
    if mode == "region":
        full = _apply_region_split(
            req, spec, ops, plan.wire, chain[0] if depth >= 1 else None, probe
        )
        valid = tuple(v - r for v, r in zip(valid, ops[0].radii))
        first_k = 2
    else:
        full = req.wait()
        first_k = 1
    for k, o in enumerate(seq, 1):
        if k < first_k:
            continue
        if k <= depth:
            origin = tuple(hr + c for hr, c in zip(spec.radii, shrink[k - 1]))
            with region("shell"):
                _apply_around(full, spec, valid, o, origin, chain[k - 1])
        else:
            stencil_apply(full, spec, valid, o)
        valid = tuple(v - r for v, r in zip(valid, o.radii))
    return full
