"""Runtime performance model for datatype transfer strategies (paper §5).

The paper models three ways to move a non-contiguous GPU object between
ranks — "device" (Eq. 1), "one-shot" (Eq. 2), "staged" (Eq. 3) — from
once-measured system parameters, then picks the cheapest per call site.
The strategy menu and its cost formulas are the reference's, so both
packages make the same choice from the same parameter values:

    rows      pack with the SIMT row kernel, then one send  ≙ "device"
    dma       pack with the staged-tile kernel, then send   ≙ "staged"
    xla       one copy per contiguous block (the naive
              CUDA-aware-MPI baseline every MPI shares)     ≙ baseline
    bounding  send the *contiguous bounding extent* of the object with
              no pack; the receiver extracts             ≙ "one-shot"

Each strategy time decomposes as  T = T_pack + T_link(bytes) + T_unpack,
with terms read from a :class:`SystemParams` table: either the analytic
H100 constants or the measured tables ``repro_torch.measure`` records
on the card (the paper's "binary that records system performance
parameters").  The lookups (interpolation on sparse log2 grids, the
fitted link latency and bandwidth past the grid) are the reference's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.comm.topology import Topology
from repro_torch.core.commit import CommittedType

__all__ = [
    "SystemParams",
    "StrategyEstimate",
    "ProgramEstimate",
    "OverlapEstimate",
    "PerfModel",
    "H100_ANALYTIC",
    "synthetic_two_tier",
]

#: 2D measured table rows: (log2_contig_block_bytes, log2_total_bytes, sec)
Table2D = Tuple[Tuple[float, float, float], ...]
#: 1D measured table rows: (log2_total_bytes, sec)
Table1D = Tuple[Tuple[float, float], ...]

#: reference field name -> port field name (the link terms follow the card)
_REFERENCE_FIELDS = {"ici_bw": "link_bw", "ici_latency": "link_latency"}
_TO_REFERENCE = {v: k for k, v in _REFERENCE_FIELDS.items()}


def _freeze_tables(v) -> Optional[Dict[str, Tuple]]:
    """A dict of tables (2D per strategy, or 1D per axis or link class)
    frozen into tuples."""
    if not v:
        return None
    return {k: tuple(tuple(row) for row in rows) for k, rows in v.items()}


def _freeze1d(v) -> Optional[Table1D]:
    if not v:
        return None
    return tuple(tuple(row) for row in v)


def _freeze_fits(v) -> Optional[Dict[str, Tuple]]:
    if not v:
        return None
    return {k: tuple(fit) for k, fit in v.items()}


@dataclass(frozen=True)
class SystemParams:
    """Measured or analytic system parameters of the §5 model.

    The analytic defaults are those of one H100 SXM and are
    **unmeasured**: ``hbm_bw`` (3.35 TB/s) and ``link_bw`` (NVLink 4:
    900 GB/s per card, 450 GB/s each way) are NVIDIA data-sheet figures;
    the latency and per-operation constants are placeholders of the right
    order.  A calibration (``repro_torch.measure``) fills the measured
    tables, and the model then reads every term of T = T_pack + T_link +
    T_unpack from them; the constants stay as fallbacks for whatever the
    tables do not cover.
    """

    name: str
    hbm_bw: float = 3.35e12           # bytes/s of device memory
    link_bw: float = 450e9            # bytes/s per direction of one link
    link_latency: float = 2.0e-6      # per-hop collective latency floor
    kernel_launch: float = 3.0e-6     # fixed cost of one kernel launch
    dma_setup: float = 1.0e-8         # per staged tile of the dma kernel
    xla_copy_overhead: float = 2.0e-6  # per-block copy (cudaMemcpyAsync)
    # measured tables ({strategy: rows} / rows) — sparse grids in log2
    # space, interpolated at query time (nearest-neighbour off-grid)
    pack_table: Optional[Dict[str, Table2D]] = None
    unpack_table: Optional[Dict[str, Table2D]] = None
    wire_table: Optional[Table1D] = None   # one-hop collective time
    copy_table: Optional[Table1D] = None   # contiguous device copy time
    # least-squares (latency, bandwidth) fit of wire_table: the per-extra-
    # hop latency and the rate past the measured grid
    wire_latency: Optional[float] = None
    wire_bw: Optional[float] = None
    # per-mesh-axis wire sweeps: a mesh whose axes ride different links
    # prices t_link(axis=...) from the matching table; the flat
    # wire_table stays the axis-agnostic fallback
    wire_tables: Optional[Dict[str, Table1D]] = None
    wire_fits: Optional[Dict[str, Tuple]] = None  # axis -> (latency, bw)
    # per-link-class wire sweeps of a two-level machine (a fast intra-node
    # and a slow inter-node tier): t_link(link_class=...) reads these
    # before the per-axis and flat tables.  Keys are "<class>" or
    # "<axis>/<class>" for class in repro_torch.comm.topology.LINK_CLASSES;
    # without them the flat table prices every class as ``intra``
    link_tables: Optional[Dict[str, Table1D]] = None
    link_fits: Optional[Dict[str, Tuple]] = None  # key -> (latency, bw)
    # one stencil application over (log2 neighbours, log2 window bytes):
    # prices the deep-halo programs' redundant compute and the overlap
    # modes' regions
    stencil_table: Optional[Table2D] = None
    # per wire compressor, rows (log2 member bytes, encode sec, decode
    # sec, ratio sample): the codec's cost on top of the member pack and
    # unpack.  The ratio column records what the sweep's payload gave;
    # the ratio a schedule is priced at comes from a payload probe
    compress_table: Optional[Dict[str, Table2D]] = None

    def __post_init__(self):
        # normalize list-of-lists (JSON) into hashable tuple tables
        object.__setattr__(self, "pack_table", _freeze_tables(self.pack_table))
        object.__setattr__(self, "unpack_table", _freeze_tables(self.unpack_table))
        object.__setattr__(self, "wire_table", _freeze1d(self.wire_table))
        object.__setattr__(self, "copy_table", _freeze1d(self.copy_table))
        object.__setattr__(self, "wire_tables", _freeze_tables(self.wire_tables))
        object.__setattr__(self, "wire_fits", _freeze_fits(self.wire_fits))
        object.__setattr__(self, "link_tables", _freeze_tables(self.link_tables))
        object.__setattr__(self, "link_fits", _freeze_fits(self.link_fits))
        object.__setattr__(self, "stencil_table", _freeze1d(self.stencil_table))
        object.__setattr__(self, "compress_table", _freeze_tables(self.compress_table))

    def to_json(self) -> str:
        """JSON under the reference's field names (``ici_bw``,
        ``ici_latency``), so ``repro.comm.perfmodel.SystemParams`` reads
        it."""
        d = {_TO_REFERENCE.get(k, k): v for k, v in dataclasses.asdict(self).items()}
        return json.dumps(d, indent=2)

    @staticmethod
    def from_json(s: str) -> "SystemParams":
        return SystemParams.from_reference(**json.loads(s))

    @staticmethod
    def from_reference(**fields) -> "SystemParams":
        """Parameters from the reference's ``SystemParams`` field values
        (``ici_bw``/``ici_latency`` become ``link_bw``/``link_latency``).
        A non-empty value of a field the port does not know raises."""
        known = {f.name for f in dataclasses.fields(SystemParams)}
        out = {}
        for k, v in fields.items():
            k = _REFERENCE_FIELDS.get(k, k)
            if k in known:
                out[k] = v
            elif v:
                raise ValueError(f"unknown reference field {k!r}")
        return SystemParams(**out)


#: the default table: one H100 SXM, analytic and unmeasured
H100_ANALYTIC = SystemParams(name="h100_sxm_analytic_unmeasured")


def synthetic_two_tier(
    params: SystemParams,
    latency_factor: float = 20.0,
    bandwidth_factor: float = 4.0,
) -> SystemParams:
    """A two-tier parameter set from single-tier measurements.

    One card has no second node, but simulated-scale pricing needs an
    ``inter`` tier to price.  This takes the params' flat wire sweep as
    the ``intra`` table and makes the ``inter`` table by degrading it:
    each row's time becomes ``t * bandwidth_factor + (latency_factor - 1)
    * lat0``, with ``lat0`` the fitted (or analytic) one-hop latency: a
    link ``bandwidth_factor`` x thinner and ``latency_factor`` x laggier.
    ``latency_factor = bandwidth_factor = 1`` gives ``inter == intra``
    exactly, the oracle under which tier-aware pricing must reproduce
    flat pricing bit for bit.
    """
    table = params.wire_table
    lat0 = params.wire_latency
    bw0 = params.wire_bw
    if not table:
        # no sweep calibrated: a two-point analytic table keeps the tiers
        # priceable
        lat0 = params.link_latency
        bw0 = params.link_bw
        table = tuple(
            (float(x), lat0 + (2.0 ** x) / bw0) for x in (10.0, 22.0)
        )
    if lat0 is None:
        lat0 = params.link_latency
    extra_lat = (latency_factor - 1.0) * lat0
    inter = tuple(
        (x, t * bandwidth_factor + extra_lat) for x, t in table
    )
    link_fits = {}
    if lat0 is not None and bw0 is not None:
        link_fits["intra"] = (lat0, bw0)
        link_fits["inter"] = (lat0 * latency_factor, bw0 / bandwidth_factor)
    return dataclasses.replace(
        params,
        link_tables={"intra": table, "inter": inter},
        link_fits=link_fits or None,
    )


@dataclass(frozen=True)
class StrategyEstimate:
    strategy: str
    t_pack: float
    t_link: float
    t_unpack: float
    #: exact bytes this strategy puts on the wire
    wire_bytes: int = 0

    @property
    def total(self) -> float:
        return self.t_pack + self.t_link + self.t_unpack


@dataclass(frozen=True)
class ProgramEstimate:
    """Predicted cost of one deep-halo iteration: a single exchange at
    halo depth ``steps * cycle_radii`` amortized over ``steps`` repeats
    of a (possibly heterogeneous) op cycle, plus the redundant
    ghost-shell re-evaluation the shrinking-region schedule pays instead
    of the saved exchanges.

    ``steps`` counts cycle repeats; :attr:`applications` counts the
    stencil applications (``steps * cycle_len``).  :attr:`op_redundant`
    splits :attr:`t_redundant` per op position in the cycle, summed over
    the repeats.  The figure of merit is :attr:`per_step`, seconds per
    stencil application, which ``steps="auto"`` minimizes.
    """

    steps: int
    t_exchange: float   # one deep exchange: member pack/unpack + wire
    t_redundant: float  # ghost-region re-evaluation across the fused steps
    wire_bytes: int     # bytes that one exchange puts on the wire
    cycle_len: int = 1  # ops per cycle pass (1 = the single-op program)
    #: redundant seconds per cycle position, summed over the repeats
    op_redundant: Tuple[float, ...] = ()

    @property
    def applications(self) -> int:
        """Stencil applications one iteration performs."""
        return self.steps * max(self.cycle_len, 1)

    @property
    def total(self) -> float:
        return self.t_exchange + self.t_redundant

    @property
    def per_step(self) -> float:
        """Seconds per stencil application (the argmin of the auto
        chooser)."""
        return self.total / max(self.applications, 1)

    @property
    def per_cycle(self) -> float:
        """Seconds per cycle repeat."""
        return self.total / max(self.steps, 1)


@dataclass(frozen=True)
class OverlapEstimate:
    """Predicted cost of hiding one halo exchange behind compute, for
    one overlap mode.

    ``monolithic`` waits for the fused collective then applies every
    rim region: ``max(wire, core) + sum(rims)``.  ``region`` drains
    delta classes as they complete and computes each rim region as soon
    as its dependency classes have landed, on a single compute resource:
    the core first, then rims in ready order, each starting at
    ``max(busy, ready)``.  ``class_completions`` is the per-class wire
    completion profile the region simulation consumed."""

    mode: str
    t_total: float
    t_core: float
    t_wire: float
    t_rims: Tuple[float, ...] = ()
    class_completions: Tuple[float, ...] = ()


class _Interp2D:
    """Bilinear interpolation on a sparse (log2 block, log2 total) grid.

    The axis vectors, the dense grid (NaN holes) and the point list are
    built once per table.  Cells with a missing corner, and degenerate
    one-row or one-column grids, answer with the nearest measured point.
    """

    def __init__(self, table: Table2D):
        import numpy as np

        self._np = np
        pts = np.asarray(table, dtype=float)
        self.pts = pts
        self.xs = np.unique(pts[:, 0])
        self.ys = np.unique(pts[:, 1])
        grid = np.full((len(self.xs), len(self.ys)), np.nan)
        xi = np.searchsorted(self.xs, pts[:, 0])
        yi = np.searchsorted(self.ys, pts[:, 1])
        grid[xi, yi] = pts[:, 2]
        self.grid = grid

    def _nearest(self, x: float, y: float) -> float:
        np = self._np
        d = (self.pts[:, 0] - x) ** 2 + (self.pts[:, 1] - y) ** 2
        return float(self.pts[int(np.argmin(d)), 2])

    def __call__(self, x: float, y: float) -> float:
        np = self._np
        xs, ys = self.xs, self.ys
        if len(xs) < 2 or len(ys) < 2:
            return self._nearest(x, y)
        x = min(max(x, xs[0]), xs[-1])
        y = min(max(y, ys[0]), ys[-1])
        i = min(int(np.searchsorted(xs, x, side="right") - 1), len(xs) - 2)
        j = min(int(np.searchsorted(ys, y, side="right") - 1), len(ys) - 2)
        q = self.grid[i : i + 2, j : j + 2]
        if np.isnan(q).any():
            return self._nearest(x, y)
        tx = (x - xs[i]) / (xs[i + 1] - xs[i])
        ty = (y - ys[j]) / (ys[j + 1] - ys[j])
        return float(
            q[0, 0] * (1 - tx) * (1 - ty)
            + q[1, 0] * tx * (1 - ty)
            + q[0, 1] * (1 - tx) * ty
            + q[1, 1] * tx * ty
        )


class _Interp1D:
    """Piecewise-linear interpolation on a (log2 total) -> seconds table,
    clamped at the ends."""

    def __init__(self, table: Table1D):
        import numpy as np

        self._np = np
        pts = np.asarray(sorted(table), dtype=float)
        self.xs = pts[:, 0]
        self.vs = pts[:, 1]

    def __call__(self, x: float) -> float:
        return float(self._np.interp(x, self.xs, self.vs))


def _interp2d(table, x, y) -> Optional[float]:
    """Interpolated lookup on a measured 2D table (None iff empty), with
    a fresh interpolator; model queries go through the per-model cache."""
    if not table:
        return None
    return _Interp2D(tuple(tuple(r) for r in table))(x, y)


class PerfModel:
    """Strategy selection per (committed type, incount, hop count).

    The per-strategy cost formulas live on the
    :class:`~repro_torch.comm.api.Strategy` plugins; this model supplies
    the shared terms (link time, measured tables, system parameters) and
    picks the cheapest among whatever strategies are registered.  Queries
    are pure functions of their arguments, so results are cached (paper
    §4/§6.3).  With a ``decisions`` cache
    (:class:`repro_torch.measure.DecisionCache`) a recorded selection is
    pinned instead of re-derived, and every new one is recorded.

    ``axis`` names the mesh axis whose wire table prices ``t_link`` by
    default (a per-call ``axis`` overrides it).  ``topology`` (a
    :class:`~repro_torch.comm.topology.Topology`, rank -> node) annotates
    the plans the communicator lays out: each delta class is priced by
    the slowest tier it crosses, and the ``tiered`` schedule becomes a
    candidate; ``repro_torch.train.elastic.replan_on_remesh`` rebinds it
    when the machine reshapes.
    """

    def __init__(self, params: SystemParams = H100_ANALYTIC, decisions=None,
                 axis: Optional[str] = None, topology: Optional[Topology] = None):
        self.params = params
        self.decisions = decisions
        self.axis = axis
        self.topology = topology
        self._cache: Dict[Tuple, StrategyEstimate] = {}
        # interpolators, built once per measured table and keyed by the
        # (frozen, hashable) table, so they live as long as this model
        self._interp: Dict[Tuple, object] = {}
        self.lookups = 0
        self.hits = 0

    @staticmethod
    def _resolve(strategy, registry=None):
        from repro_torch.comm.api import resolve_strategy

        return resolve_strategy(strategy, registry)

    # -- measured tables ------------------------------------------------
    def _interp_for(self, table, cls):
        it = self._interp.get(table)
        if it is None:
            it = cls(table)
            self._interp[table] = it
        return it

    def _lookup2d(self, tables, strategy: str, contig: int, total: int) -> Optional[float]:
        if not tables or strategy not in tables or not tables[strategy]:
            return None
        return self._interp_for(tables[strategy], _Interp2D)(
            math.log2(max(contig, 1)), math.log2(max(total, 1))
        )

    def measured(self, strategy: str, contig: int, total: int) -> Optional[float]:
        """Interpolated measured pack time for a named strategy, or None
        when no calibration table covers it."""
        return self._lookup2d(self.params.pack_table, strategy, contig, total)

    def measured_unpack(self, strategy: str, contig: int, total: int) -> Optional[float]:
        """Interpolated measured unpack time, or None when uncovered."""
        return self._lookup2d(self.params.unpack_table, strategy, contig, total)

    def measured_copy(self, nbytes: int) -> Optional[float]:
        """Interpolated measured contiguous-copy time, or None."""
        t = self.params.copy_table
        if not t:
            return None
        return self._interp_for(t, _Interp1D)(math.log2(max(nbytes, 1)))

    def measured_compress(self, strategy: str, nbytes: int) -> Optional[Tuple[float, float]]:
        """Interpolated measured ``(encode sec, decode sec)`` of ``nbytes``
        member bytes under the named wire compressor, or None when no
        compress sweep covers it (the compressors then price their codec
        as one more read and write of the bytes)."""
        tables = self.params.compress_table
        if not tables or strategy not in tables or not tables[strategy]:
            return None
        rows = tables[strategy]
        x = math.log2(max(nbytes, 1))
        enc = self._interp_for(tuple((r[0], r[1]) for r in rows), _Interp1D)(x)
        dec = self._interp_for(tuple((r[0], r[2]) for r in rows), _Interp1D)(x)
        return enc, dec

    def measured_stencil(self, n_neighbors: int, nbytes: int) -> Optional[float]:
        """Interpolated measured time of one stencil application with
        ``n_neighbors`` neighbor reads over a window of ``nbytes``, or
        None when no stencil sweep was calibrated (the redundant-compute
        term then falls back to the contiguous-copy proxy)."""
        t = self.params.stencil_table
        if not t:
            return None
        return self._interp_for(t, _Interp2D)(
            math.log2(max(n_neighbors, 1)), math.log2(max(nbytes, 1))
        )

    # -- per-strategy terms (delegate to the registered plugin) ---------
    def t_pack(self, ct, incount: int, strategy) -> float:
        return self._resolve(strategy).model_pack(self, ct, incount)

    def t_unpack(self, ct, incount: int, strategy) -> float:
        return self._resolve(strategy).model_unpack(self, ct, incount)

    # -- link term ------------------------------------------------------
    def _axis_wire(self, axis: Optional[str]):
        """(table, fitted latency, fitted bw) pricing one link on
        ``axis`` (default: the model's bound axis): the per-axis sweep
        when one covers the axis, else the flat axis-agnostic table."""
        p = self.params
        axis = axis if axis is not None else self.axis
        if axis is not None and p.wire_tables and axis in p.wire_tables:
            fit = (p.wire_fits or {}).get(axis) or (None, None)
            return p.wire_tables[axis], fit[0], fit[1]
        return p.wire_table, p.wire_latency, p.wire_bw

    def _class_wire(self, axis: Optional[str], link_class: Optional[str]):
        """(table, fitted latency, fitted bw) for one link class of the
        two-level hierarchy: the ``"<axis>/<class>"`` sweep when one
        covers it, else the class-wide ``"<class>"`` sweep, else the
        per-axis and flat fallback, so a flat calibration prices every
        class as ``intra`` and ``link_class=None`` is the flat model."""
        p = self.params
        if link_class is not None and p.link_tables:
            a = axis if axis is not None else self.axis
            keys = ((f"{a}/{link_class}",) if a is not None else ())
            for key in keys + (link_class,):
                if p.link_tables.get(key):
                    fit = (p.link_fits or {}).get(key) or (None, None)
                    return p.link_tables[key], fit[0], fit[1]
        return self._axis_wire(axis)

    def _hop_latency(self, axis: Optional[str] = None) -> float:
        _, lat, _ = self._axis_wire(axis)
        return lat if lat is not None else self.params.link_latency

    def t_link(self, nbytes: int, hops: int = 1, axis: Optional[str] = None,
               link_class: Optional[str] = None) -> float:
        p = self.params
        table, wire_lat, wire_bw = self._class_wire(axis, link_class)
        if table:
            # measured one-hop collective time; extra hops add the fitted
            # (or analytic) latency floor, not another bandwidth term
            interp = self._interp_for(table, _Interp1D)
            x = math.log2(max(nbytes, 1))
            t = interp(x)
            end = float(interp.xs[-1])
            if x > end:
                # past the measured grid: the fitted (or analytic) rate
                # for the excess bytes instead of a flat clamp
                bw = wire_bw if wire_bw else p.link_bw
                t += (nbytes - 2.0 ** end) / bw
            lat = wire_lat if wire_lat is not None else p.link_latency
            return t + (hops - 1) * lat
        return hops * p.link_latency + nbytes / p.link_bw

    # -- exchange pricing (exact-byte wire plans) -----------------------
    def _tier_surcharge(self, nbytes: int, axis: Optional[str]) -> float:
        """Extra seconds ``nbytes`` cost for crossing the slow tier
        instead of the fast one: exactly 0.0 when the tiers price equally
        (the inter == intra oracle), clamped at 0 so a noisy calibration
        never pays a plan to cross nodes."""
        return max(
            0.0,
            self.t_link(nbytes, 1, axis, link_class="inter")
            - self.t_link(nbytes, 1, axis, link_class="intra"),
        )

    def _price_schedule(self, plan, schedule: str, axis: Optional[str] = None) -> float:
        """Predicted seconds of ``plan``'s layout under ``schedule``.

        A flat plan (no ``link_classes``) pays the link term on the bytes
        the schedule issues plus one hop latency per extra collective.
        An annotated plan prices each delta class by the slowest tier it
        crosses: the base stays on the fast (``intra``) tier, and every
        inter class (grouped, varlen), coalesced bundle (tiered) or whole
        fused collective with an inter edge (uniform, ragged) adds the
        tier surcharge for its bytes.  With ``inter == intra`` tables
        every surcharge is 0.0 and the annotated prices equal the flat
        ones bit for bit.
        """
        lat = self._hop_latency(axis)
        lc = getattr(plan, "link_classes", None)
        base_class = "intra" if lc else None
        if schedule == "grouped":
            t = self.t_link(plan.wire_bytes, 1, axis, link_class=base_class)
            t += (plan.ngroups - 1) * lat
            if lc:
                for g, c in enumerate(lc):
                    if c == "inter":
                        t += self._tier_surcharge(plan.groups[g].nbytes, axis)
            return t
        if schedule == "tiered":
            if not lc:
                raise ValueError("schedule 'tiered' needs a topology-annotated plan")
            # grouped's price with the per-class slow-tier surcharges
            # swapped for per-bundle ones (one slow message per peer
            # node), plus the fast tier for the correction bytes every
            # non-representative member re-sends on its node
            t = self._price_schedule(plan, "grouped", axis)
            for g, c in enumerate(lc):
                if c == "inter":
                    t -= self._tier_surcharge(plan.groups[g].nbytes, axis)
            for b in plan.tier_bundles:
                t += self._tier_surcharge(
                    sum(plan.groups[g].nbytes for g in b), axis
                )
            t += max(
                0.0,
                self.t_link(plan.wire_bytes + plan.correction_bytes, 1,
                            axis, link_class="intra")
                - self.t_link(plan.wire_bytes, 1, axis, link_class="intra"),
            )
            return t
        if schedule == "varlen":
            # the grouped transport with each class cut at its probed
            # stream length: the link term on the stream bytes, the
            # per-class latencies stay (the codec's cost rides the
            # strategy estimates, as pack costs do for every schedule)
            stream = getattr(plan, "stream_bytes", ())
            if len(stream) != plan.ngroups:
                raise ValueError("schedule 'varlen' needs a stream-annotated plan")
            t = self.t_link(sum(stream), 1, axis, link_class=base_class)
            t += (plan.ngroups - 1) * lat
            if lc:
                for g, c in enumerate(lc):
                    if c == "inter":
                        t += self._tier_surcharge(stream[g], axis)
            return t
        if schedule == "uniform":
            issued = plan.nranks * plan.seg_bytes
        elif schedule == "ragged":
            issued = plan.wire_bytes
        else:
            raise ValueError(f"unknown wire schedule {schedule!r}")
        t = self.t_link(issued, 1, axis, link_class=base_class)
        if lc and any(c == "inter" for c in lc):
            # one fused collective completes at its slowest edge: the
            # whole issued payload pays the slow tier
            t += self._tier_surcharge(issued, axis)
        return t

    def price_exchange(self, plan, note: str = "") -> StrategyEstimate:
        """Price a :class:`~repro_torch.comm.wireplan.WirePlan`: the link
        term for the bytes its schedule actually issues, plus the
        per-extra-collective latency of the grouped schedule (and the
        slow-tier surcharges of a topology-annotated plan).  The estimate
        is recorded once per plan fingerprint in the attached decision
        cache, with ``topo=<fingerprint>`` when a topology annotated the
        plan; ``note`` is appended to its signature."""
        t = self._price_schedule(plan, plan.schedule)
        est = StrategyEstimate(
            f"wire/{plan.schedule}", 0.0, t, 0.0, wire_bytes=plan.issued_bytes
        )
        if self.decisions is not None:
            key = (plan.fingerprint, plan.ngroups, plan.wire_ops, True)
            if self.decisions.lookup(*key) is None:
                topo = getattr(plan, "topology", None)
                topo_tag = f" topo={topo.fingerprint}" if topo is not None else ""
                stream_tag = ""
                if plan.schedule == "varlen":
                    stream_tag = (f" stream_bytes={plan.effective_wire_bytes}"
                                  f" ratio={plan.stream_ratio:.4f}")
                self.decisions.record(
                    *key,
                    est,
                    signature=(
                        f"exchange schedule={plan.schedule}"
                        f" groups={plan.ngroups} ranks={plan.nranks}"
                        f" ragged_bytes={plan.wire_bytes}"
                        f"{stream_tag}{topo_tag}{note}"
                    ),
                )
        return est

    def price_wire_schedules(self, plan, native: bool = False,
                             axis: Optional[str] = None) -> Dict[str, float]:
        """Predicted seconds for every wire schedule that could carry the
        plan's layout: ``grouped`` always; ``varlen`` when a probe
        annotated the plan with streams shorter than its capacity;
        ``tiered`` when a topology annotated it with tier bundles;
        ``uniform`` (and ``ragged`` when the transport has it natively)
        for a fused plan below the large-grid threshold.  ``grouped``
        comes first so exact ties resolve to it: coalescing must win,
        not draw, to buy its correction hops."""
        from repro_torch.comm.wireplan import GROUPED_FALLBACK_RANK_FACTOR

        costs = {"grouped": self._price_schedule(plan, "grouped", axis)}
        stream = getattr(plan, "stream_bytes", ())
        if len(stream) == plan.ngroups and sum(stream) < plan.wire_bytes:
            costs["varlen"] = self._price_schedule(plan, "varlen", axis)
        lc = getattr(plan, "link_classes", None)
        if lc and plan.tier_bundles:
            costs["tiered"] = self._price_schedule(plan, "tiered", axis)
        oversize = (
            plan.ngroups
            and plan.nranks > GROUPED_FALLBACK_RANK_FACTOR * plan.ngroups
        )
        if plan.fused and not oversize:
            costs["uniform"] = self._price_schedule(plan, "uniform", axis)
            if native:
                costs["ragged"] = self._price_schedule(plan, "ragged", axis)
        return costs

    def choose_wire_schedule(self, plan, native: bool = False):
        """Re-schedule a plan onto the model-cheapest feasible wire
        schedule.  Returns ``(plan, costs)``."""
        from repro_torch.comm.wireplan import reschedule

        costs = self.price_wire_schedules(plan, native)
        best = min(costs, key=costs.get)
        return reschedule(plan, best), costs

    # -- simulated-scale pricing -----------------------------------------
    def at_scale(
        self,
        ranks: int,
        nodes: Optional[int] = None,
        *,
        ranks_per_node: Optional[int] = None,
        interior: Tuple[int, int, int] = (8, 8, 8),
        radius: int = 1,
        element_bytes: int = 4,
        axis: Optional[str] = None,
        native: Optional[bool] = None,
        pin: bool = True,
    ):
        """Price the halo exchange of the paper's scaling study, a 3D
        periodic stencil on a ``ranks``-process grid, from the tables
        alone, with no devices.  ``nodes`` (or ``ranks_per_node``) shapes
        the two-level topology; the process grid is the pencil
        decomposition ``(nodes, fy, fx)`` with one leading-axis slab per
        node (see :mod:`repro_torch.comm.scale`).  ``native``: whether the
        transport has a native ragged all-to-all (None: no, as on the
        local mesh).

        The winning schedule is pinned as a ``wire/<schedule>`` decision
        keyed by a fingerprint that includes the topology's: an existing
        pin short-circuits the choice (``pinned=True``), so an elastic
        replan (:func:`repro_torch.train.elastic.replan_on_remesh`)
        provably re-prices.  Returns a
        :class:`repro_torch.comm.scale.ScaleEstimate`.
        """
        from repro_torch.comm.scale import ScaleEstimate, build_scale_plan

        ranks = int(ranks)
        if ranks_per_node is None:
            nodes = int(nodes) if nodes else 1
            if ranks % nodes:
                raise ValueError(f"ranks={ranks} does not split over nodes={nodes}")
            ranks_per_node = ranks // nodes
        plan = build_scale_plan(
            ranks, ranks_per_node, interior=interior, radius=radius,
            element_bytes=element_bytes,
        )
        costs = self.price_wire_schedules(plan, bool(native), axis)
        best = min(costs, key=costs.get)
        key_src = (
            "atscale.v1", ranks, plan.topology.nnodes, plan.grid,
            tuple(interior), int(radius), int(element_bytes),
            plan.topology.fingerprint,
        )
        fp = hashlib.sha256(repr(key_src).encode()).hexdigest()[:16]
        pinned = False
        if pin and self.decisions is not None:
            row = self.decisions.lookup(fp, 0, 1, True)
            if row is not None and row.strategy.startswith("wire/"):
                sched = row.strategy.split("/", 1)[1]
                if sched in costs:
                    best, pinned = sched, True
            if not pinned:
                self.decisions.record(
                    fp, 0, 1, True,
                    StrategyEstimate(
                        f"wire/{best}", 0.0, costs[best], 0.0,
                        wire_bytes=plan.wire_bytes,
                    ),
                    signature=(
                        f"atscale ranks={ranks} nodes={plan.topology.nnodes}"
                        f" grid={plan.grid} classes={plan.ngroups}"
                        f" topo={plan.topology.fingerprint} "
                        + " ".join(f"{s}:{c:.3e}" for s, c in sorted(costs.items()))
                    ),
                )
        n_inter = sum(1 for c in plan.link_classes if c == "inter")
        return ScaleEstimate(
            ranks=ranks,
            nodes=plan.topology.nnodes,
            grid=plan.grid,
            schedule=best,
            costs=dict(costs),
            wire_bytes=plan.wire_bytes,
            correction_bytes=plan.correction_bytes,
            inter_messages={"grouped": n_inter, "tiered": len(plan.tier_bundles)},
            fingerprint=fp,
            pinned=pinned,
        )

    # -- region-split overlap pricing -----------------------------------
    def _stencil_seconds(self, n_neighbors: int, nbytes: int) -> float:
        """Seconds of one ``n_neighbors``-point stencil application over
        a window of ``nbytes``: the measured stencil sweep when
        calibrated, else the contiguous-copy / HBM proxy the
        redundant-compute term falls back to."""
        if nbytes <= 0:
            return 0.0
        t_app = self.measured_stencil(n_neighbors, nbytes)
        if t_app is not None:
            return t_app
        touches = n_neighbors + 2
        copy = self.measured_copy(nbytes)
        per_touch = (
            copy / 2.0 if copy is not None else nbytes / self.params.hbm_bw
        )
        return touches * per_touch

    def price_class_completions(self, plan) -> Tuple[float, ...]:
        """Predicted completion time of each delta class of ``plan``,
        measured from issue.  Under the grouped schedule class ``k``
        rides the ``k``-th per-class wire op: it cannot complete before
        every earlier class's bytes are on the link
        (``class_cum_bytes``) plus one launch latency per earlier op.
        The fused schedules (uniform/ragged) complete every class
        together at the whole-collective time."""
        lat = self._hop_latency()
        if plan.schedule == "grouped":
            return tuple(
                self.t_link(cum, 1) + k * lat
                for k, cum in enumerate(plan.class_cum_bytes)
            )
        t = self._price_schedule(plan, plan.schedule)
        return (t,) * plan.ngroups

    def price_overlap(
        self,
        plan,
        regions: Sequence[Tuple[int, Sequence[int]]],
        core_bytes: int,
        n_neighbors: int,
    ) -> Dict[str, OverlapEstimate]:
        """Price both overlap modes for one exchange-hiding stencil
        application.  ``regions`` describes the rim regions as
        ``(window_bytes, dep_class_ids)`` pairs — the model only sees
        bytes and dependencies; ``core_bytes`` is the core window
        (computable with no halo) and ``n_neighbors`` the stencil's
        neighbor count.

        Both modes run compute on a single resource.  ``monolithic``
        blocks on the fused wire: ``max(wire, core) + sum(rims)``.
        ``region`` starts the core at issue and each rim at
        ``max(resource free, its classes' completion)``.
        """
        completions = self.price_class_completions(plan)
        t_wire = max(completions) if completions else 0.0
        t_core = self._stencil_seconds(n_neighbors, core_bytes)
        rims = tuple(
            self._stencil_seconds(n_neighbors, rb) for rb, _ in regions
        )

        def ready(i: int) -> float:
            deps = regions[i][1]
            return max((completions[c] for c in deps), default=0.0)

        mono = max(t_wire, t_core) + sum(rims)
        busy = t_core
        for i in sorted(range(len(regions)), key=ready):
            busy = max(busy, ready(i)) + rims[i]
        return {
            "monolithic": OverlapEstimate(
                "monolithic", mono, t_core, t_wire, rims, completions
            ),
            "region": OverlapEstimate(
                "region", max(busy, t_wire), t_core, t_wire, rims,
                completions
            ),
        }

    def choose_overlap_mode(
        self,
        plan,
        regions: Sequence[Tuple[int, Sequence[int]]],
        core_bytes: int,
        n_neighbors: int,
    ) -> Tuple[str, Dict[str, OverlapEstimate], bool]:
        """Pick monolithic vs region-split overlap for one exchange,
        pinned as an ``overlap/mode=...`` decision like the
        ``program/s=N`` depth choice: a cache hit with that strategy
        prefix short-circuits the choice (``pinned=True``); a miss
        records the choice with both prices in the signature.  Ties go
        to ``monolithic``: region-split must win, not draw.  Returns
        ``(mode, estimates, pinned)``."""
        regions = tuple(
            (int(rb), tuple(sorted(int(c) for c in deps)))
            for rb, deps in regions
        )
        key_src = (
            "overlap.v1", plan.fingerprint, int(core_bytes),
            int(n_neighbors), regions,
        )
        fp = hashlib.sha256(repr(key_src).encode()).hexdigest()[:16]
        ests = self.price_overlap(plan, regions, core_bytes, n_neighbors)
        if self.decisions is not None:
            pin = self.decisions.lookup(fp, 0, 1, True)
            if pin is not None and pin.strategy.startswith("overlap/mode="):
                mode = pin.strategy.split("=", 1)[1]
                if mode in ests:
                    return mode, ests, True
        mode = (
            "region"
            if ests["region"].t_total < ests["monolithic"].t_total
            else "monolithic"
        )
        if self.decisions is not None:
            best = ests[mode]
            self.decisions.record(
                fp, 0, 1, True,
                StrategyEstimate(
                    f"overlap/mode={mode}",
                    t_pack=best.t_core + sum(best.t_rims),
                    t_link=best.t_wire,
                    t_unpack=0.0,
                    wire_bytes=plan.issued_bytes,
                ),
                signature=(
                    f"overlap plan={plan.fingerprint}"
                    f" classes={plan.ngroups} regions={len(regions)}"
                    f" core_B={int(core_bytes)} "
                    + " ".join(
                        f"{m}:{e.t_total:.3e}"
                        for m, e in sorted(ests.items())
                    )
                ),
            )
        return mode, ests, False

    # -- deep-halo program pricing (exchange vs redundant compute) ------
    def _redundant_time(
        self, n_neighbors: int, window_bytes: int, red_bytes: int
    ) -> float:
        """Seconds of redundant ghost-shell work inside one application
        whose full window is ``window_bytes``, of which ``red_bytes`` are
        shell cells some neighbor also computes: the measured stencil
        sweep's rate at this window size times the redundant bytes, else
        the contiguous-copy proxy (``n_neighbors + 2`` touches per cell,
        a touch being half a measured copy, else analytic HBM)."""
        t_app = self.measured_stencil(n_neighbors, window_bytes)
        if t_app is not None and window_bytes > 0:
            return t_app * (red_bytes / window_bytes)
        touches = n_neighbors + 2
        copy = self.measured_copy(red_bytes)
        per_touch = (
            copy / 2.0 if copy is not None else red_bytes / self.params.hbm_bw
        )
        return touches * per_touch

    def price_program(
        self,
        plan,
        interior: Tuple[int, int, int],
        op_radii,
        n_neighbors,
        steps: int,
        element_bytes: int = 4,
        t_members: float = 0.0,
    ) -> ProgramEstimate:
        """Price one deep-halo iteration: ONE exchange at halo depth
        ``steps * cycle_radii`` (wire plan ``plan``, member pack/unpack
        time ``t_members``) amortized over ``steps`` repeats of an op
        cycle, against the redundant ghost-shell re-evaluation the
        shrinking valid region pays.

        ``op_radii`` is one per-dimension radii tuple or a sequence of
        them (the cycle, in application order), with ``n_neighbors`` an
        int or a matching sequence.  Application ``j`` of the flattened
        ``steps * k`` schedule writes interior plus a shell of
        ``total - cum_j`` per dimension; every shell cell is one some
        neighbor also computes.  Compare ``per_step`` across depths to
        pick ``s``.
        """
        if op_radii and isinstance(op_radii[0], (tuple, list)):
            cycle = [tuple(r) for r in op_radii]
        else:
            cycle = [tuple(op_radii)]
        if isinstance(n_neighbors, (tuple, list)):
            neighbors = [int(n) for n in n_neighbors]
        else:
            neighbors = [int(n_neighbors)] * len(cycle)
        if len(neighbors) != len(cycle):
            raise ValueError(
                f"n_neighbors ({len(neighbors)}) must match the cycle "
                f"length ({len(cycle)})"
            )
        wire = self._price_schedule(plan, plan.schedule)
        t_exchange = t_members + wire
        interior_cells = math.prod(interior)
        total = tuple(steps * sum(r[d] for r in cycle) for d in range(3))
        op_red = [0.0] * len(cycle)
        cum = (0, 0, 0)
        for j in range(steps * len(cycle)):
            pos = j % len(cycle)
            cum = tuple(c + r for c, r in zip(cum, cycle[pos]))
            shell = tuple(t - c for t, c in zip(total, cum))
            cells = math.prod(n + 2 * s for n, s in zip(interior, shell))
            red_bytes = (cells - interior_cells) * element_bytes
            if red_bytes <= 0:
                continue
            op_red[pos] += self._redundant_time(
                neighbors[pos], cells * element_bytes, red_bytes
            )
        return ProgramEstimate(
            steps=steps,
            t_exchange=t_exchange,
            t_redundant=sum(op_red),
            wire_bytes=plan.issued_bytes,
            cycle_len=len(cycle),
            op_redundant=tuple(op_red),
        )

    # -- full strategy estimates (Eqs. 1-3 analogue) ----------------------
    def estimate(
        self, ct: CommittedType, incount: int, strategy, hops: int = 1
    ) -> StrategyEstimate:
        return self._resolve(strategy).plan(self, ct, incount, hops)

    def select(
        self,
        ct: CommittedType,
        incount: int = 1,
        hops: int = 1,
        allow_bounding: bool = True,
        registry=None,
        probe=None,
    ) -> StrategyEstimate:
        """Pick the cheapest applicable registered strategy (cached per
        call signature).  ``allow_bounding`` admits wire-only strategies
        (data actually crosses a link, so shipping the bounding window
        is meaningful).  A selection pinned in the decision cache is
        replayed when its strategy is registered; a new one is
        recorded.

        ``probe`` (one rank's buffer, concrete) prices every
        ``supports_varlen`` candidate's link term at its probed stream
        length instead of its capacity; the streams key the cache, and a
        probed pick records ``stream_bytes=`` and ``ratio=`` in its
        decision signature."""
        if registry is None:
            from repro_torch.comm.api import default_registry

            registry = default_registry()
        # keyed on the type's CONTENT fingerprint and the registry's
        # mutation counter, so a newly registered plugin invalidates
        sig = ct.fingerprint
        streams = {}
        if probe is not None:
            for s in registry.selectable():
                if s.supports_varlen and s.applicable(ct):
                    stream = int(s.probe_stream_bytes(ct, incount, probe))
                    if stream < s.wire_bytes(ct, incount):
                        streams[s.name] = stream
        key = (sig, incount, hops, allow_bounding, id(registry), registry.version,
               tuple(sorted(streams.items())))
        self.lookups += 1
        hit = self._cache.get(key)
        if hit is not None:
            self.hits += 1
            return hit
        pinned = None
        if self.decisions is not None:
            pinned = self.decisions.lookup(sig, incount, hops, allow_bounding)

        def plan_est(s):
            e = s.plan(self, ct, incount, hops)
            stream = streams.get(s.name)
            if stream is None:
                return e
            # the link term at the probed stream length; the codec's
            # cost stays in t_pack and t_unpack
            return StrategyEstimate(e.strategy, e.t_pack, self.t_link(stream, hops),
                                    e.t_unpack, wire_bytes=stream)

        if pinned is not None and pinned.strategy in registry:
            best = plan_est(registry.get(pinned.strategy))
        else:
            cands = [
                s
                for s in registry.selectable()
                if (allow_bounding or not s.wire_only) and s.applicable(ct)
            ]
            if not cands:
                raise ValueError(f"no applicable strategy registered for {ct!r}")
            best = min((plan_est(s) for s in cands), key=lambda e: e.total)
            if self.decisions is not None:
                signature = None
                if best.strategy in streams:
                    from repro_torch.measure.decisions import describe_type

                    ratio = streams[best.strategy] / max(
                        registry.get(best.strategy).wire_bytes(ct, incount), 1)
                    signature = (f"{describe_type(ct)} stream_bytes={streams[best.strategy]}"
                                 f" ratio={ratio:.4f}")
                self.decisions.record(sig, incount, hops, allow_bounding, best, ct=ct,
                                      signature=signature)
        self._cache[key] = best
        return best
