"""The Communicator API: pluggable datatype strategies, request-based
transfers, and the fused neighborhood collective.

This module is the single home of every strategy and mode name of the
port, and the names are the reference's (``rows``, ``dma``, ``xla``,
``ref``, ``auto``, ``bounding``; modes ``baseline`` and ``tempi``), so a
decision made here compares one to one with ``repro.comm.api``:

* a :class:`Strategy` bundles the §5 cost model terms (``model_pack`` /
  ``model_unpack`` / ``wire_bytes`` -> :meth:`Strategy.plan`) with the
  execution paths (``pack`` / ``unpack`` / ``unpack_wire`` and the leaf
  kernels ``pack_leaf`` / ``unpack_leaf`` that
  ``repro_torch.kernels.ops`` drives);
* a :class:`StrategyRegistry` holds the installed strategies, and the
  :class:`~repro_torch.comm.perfmodel.PerfModel` selects among whatever
  is registered;
* a :class:`Communicator` binds a transport and a model and exposes
  MPI-shaped entry points: ``commit``, ``pack``/``unpack``,
  ``isend``/``irecv``/``sendrecv``, and the fused
  :meth:`Communicator.neighbor_alltoallv` — the paper's
  ``MPI_Alltoallv`` halo transport — which packs every region at its
  exact wire extent into one flat buffer laid out by a
  :class:`~repro_torch.comm.wireplan.WirePlan` and hands it to the
  transport under the plan's schedule.

Buffers carry the ranks on their leading dimension, as many as the
transport's ``local_ranks``: the local-mesh transport keeps all R ranks
in one tensor, so every entry point moves a datatype for all ranks at
once; under one process per rank
(:class:`~repro_torch.comm.distributed.DistributedTransport`) the
dimension is 1, this process's rank, and every rank calls the same entry
points with the same arguments.  Unpacks write in place.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable, Dict, FrozenSet, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.comm.perfmodel import (
    H100_ANALYTIC,
    PerfModel,
    StrategyEstimate,
    SystemParams,
)
from repro_torch.comm.transport import RECORDERS, LocalMeshTransport
from repro_torch.comm.wireplan import WireGroup, WirePlan, plan_wire
from repro_torch.core.commit import CommittedType, TypeRegistry, WireSegment
from repro_torch.core.datatypes import Datatype
from repro_torch.core.strided_block import StridedBlock
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels import ref as refk
from repro_torch.kernels.geometry import PackGeometry, plan_geometry
from repro_torch.kernels.graphs import GraphCall
from repro_torch.kernels.pack import pack_compress_ragged, pack_dma, pack_rows
from repro_torch.kernels.unpack import decode_unpack_ragged, unpack_dma, unpack_rows
from repro_torch.obs.trace import region, synchronize

__all__ = [
    "Strategy",
    "StrategyRegistry",
    "default_registry",
    "register_strategy",
    "resolve_strategy",
    "static_choice",
    "Policy",
    "ModelPolicy",
    "BaselinePolicy",
    "FixedPolicy",
    "policy_for_mode",
    "MODES",
    "Request",
    "SendRequest",
    "ClassRequest",
    "NeighborRequest",
    "PersistentRequest",
    "Communicator",
    "as_communicator",
    "WirePlan",
    "WireGroup",
    "DEFAULT_SCHEDULE_POLICY",
    "plan_neighbor_alltoallv",
]

StrategyLike = Union[str, "Strategy", None]

#: the baseline's per-block copies degrade to the gather path past this
#: many blocks (the reference's cap, kept so baseline decisions compare)
BASELINE_BLOCK_CAP = 1024


# ===========================================================================
# Strategy protocol
# ===========================================================================

class Strategy:
    """One way to move a committed datatype: cost model + execution.

    Override points:

    ``applicable``    can this strategy handle the type at all?
    ``model_pack`` /  the §5 cost terms (seconds); ``plan`` assembles the
    ``model_unpack``  full T = T_pack + T_link + T_unpack estimate
    ``wire_bytes``    bytes this strategy puts on the wire
    ``pack``          produce the wire payload from the user buffer
    ``unpack``        scatter *packed member bytes* into the buffer
    ``unpack_wire``   consume the wire payload (differs from ``unpack``
                      only when the wire format isn't the packed bytes,
                      e.g. :class:`Bounding`'s contiguous window)
    ``pack_leaf`` /   per-repetition 2D/3D kernel dispatch on ``(B, n)``
    ``unpack_leaf``   byte rows, used by ``repro_torch.kernels.ops``
    """

    name: str = "abstract"
    #: only meaningful when bytes cross the wire (no local pack/unpack)
    wire_only: bool = False
    #: participates in automatic PerfModel selection
    selectable: bool = True
    #: the wire format is length-aware: the live payload is a prefix of
    #: the capacity wire, cut at :meth:`probe_stream_bytes`; the
    #: ``varlen`` schedule forms only over such strategies
    supports_varlen: bool = False
    #: calibration sweep cap on block count (None = unbounded); the
    #: measured tables never answer for more blocks than this
    calibration_cap: Optional[int] = None

    def applicable(self, ct: CommittedType) -> bool:
        return True

    # -- §5 cost model ----------------------------------------------------
    def model_pack(self, model: PerfModel, ct: CommittedType, incount: int) -> float:
        raise NotImplementedError

    def model_unpack(self, model: PerfModel, ct: CommittedType, incount: int) -> float:
        sb = ct.block
        if sb is not None and self._table_covers(sb, incount):
            m = model.measured_unpack(self.name, sb.counts[0], ct.size * incount)
            if m is not None:
                return m
        # no measured unpack table: strided writes are slower than pack
        # (paper §6.3 observes the same pack/unpack asymmetry)
        return 1.5 * self.model_pack(model, ct, incount)

    def _table_covers(self, sb: StridedBlock, incount: int) -> bool:
        """Whether this strategy's measured tables may answer for an
        object of this many blocks: the sweep never measures past
        ``calibration_cap``, so past it the analytic model prices."""
        cap = self.calibration_cap
        return cap is None or sb.num_blocks * incount <= cap

    def wire_bytes(self, ct: CommittedType, incount: int = 1) -> int:
        return ct.packed_extent(incount)

    def probe_stream_bytes(self, ct: CommittedType, incount: int, buf) -> int:
        """Wire bytes a concrete payload (one rank's buffer ``buf``)
        needs.  The default format is not length-aware, so this is the
        capacity; ``supports_varlen`` strategies measure the stream."""
        return self.wire_bytes(ct, incount)

    def wire_segment(
        self, ct: CommittedType, incount: int = 1, offset: int = 0
    ) -> WireSegment:
        return ct.wire_segment(
            offset=offset, incount=incount, nbytes=self.wire_bytes(ct, incount)
        )

    def plan(
        self, model: PerfModel, ct: CommittedType, incount: int, hops: int = 1
    ) -> StrategyEstimate:
        """Full strategy estimate (paper Eqs. 1-3 analogue), priced on
        the exact wire-segment extent."""
        seg = self.wire_segment(ct, incount)
        return StrategyEstimate(
            self.name,
            self.model_pack(model, ct, incount),
            model.t_link(seg.nbytes, hops),
            self.model_unpack(model, ct, incount),
            wire_bytes=seg.nbytes,
        )

    # -- execution --------------------------------------------------------
    def pack(self, buf, ct, incount=1, *, out=None, batched=False):
        return ops.pack(buf, ct, incount, self, out=out, batched=batched)

    def unpack(self, buf, packed, ct, incount=1, *, batched=False):
        return ops.unpack(buf, packed, ct, incount, self, batched=batched)

    def unpack_wire(self, comm: "Communicator", dst, wire, recv_ct,
                    send_ct=None, incount=1):
        """Consume received wire bytes (``(R, n)``) into ``dst`` in
        place.  Default: the wire carries packed member bytes; scatter
        them with the strategy the communicator selects for the receive
        type."""
        u = comm.select(recv_ct, incount, wire=False)
        return u.unpack(dst, wire, recv_ct, incount, batched=True)

    def pack_leaf(self, b, sb: StridedBlock, geom: Optional[PackGeometry], out):
        raise TypeError(f"strategy {self.name!r} has no local pack kernel")

    def unpack_leaf(self, b, packed, sb: StridedBlock, geom: Optional[PackGeometry]):
        raise TypeError(f"strategy {self.name!r} has no local unpack kernel")

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<Strategy {self.name}>"


def _analytic_prologue(model, strategy, ct, incount):
    """Shared cost-model prologue: generic-type fallback and measured
    pack-table lookup.  Returns (params, size, block, measured|None)."""
    p = model.params
    size = ct.size * incount
    sb = ct.block
    if sb is None:
        return p, size, None, p.kernel_launch + 2 * size / p.hbm_bw
    if not strategy._table_covers(sb, incount):
        return p, size, sb, None
    return p, size, sb, model.measured(strategy.name, sb.counts[0], size)


class Rows(Strategy):
    """SIMT row kernel, then one contiguous send ≙ the paper's "device"
    method."""

    name = "rows"

    def applicable(self, ct):
        return ct.block is not None and plan_geometry(ct.block) is not None

    def model_pack(self, model, ct, incount):
        p, size, sb, m = _analytic_prologue(model, self, ct, incount)
        if sb is None or m is not None:
            return m
        geom = plan_geometry(sb)
        over = geom.overfetch if geom else 1.0
        touched = size * over + size  # pitched read + contiguous write
        return p.kernel_launch + touched / p.hbm_bw

    def pack_leaf(self, b, sb, geom, out):
        if geom is None:
            return refk.pack_ref(b, sb, out=out)
        return ops.run_pack_kernel(b, sb, geom, pack_rows, out)

    def unpack_leaf(self, b, packed, sb, geom):
        if geom is None:
            return refk.unpack_ref(b, packed, sb)
        # interleaved planes: the planes' rows overlap and must land in
        # order, which the staged kernel does (the reference's rule)
        kernel = unpack_dma if geom.interleaved else unpack_rows
        return ops.run_unpack_kernel(b, packed, sb, geom, kernel)


class Dma(Strategy):
    """Staged-tile kernel ≙ the paper's "staged" method."""

    name = "dma"

    def applicable(self, ct):
        return ct.block is not None and plan_geometry(ct.block) is not None

    def model_pack(self, model, ct, incount):
        p, size, sb, m = _analytic_prologue(model, self, ct, incount)
        if sb is None or m is not None:
            return m
        nblocks = sb.num_blocks * incount
        chunks = max(nblocks // 128, 1)  # tiles per ~128-row chunk
        return p.kernel_launch + chunks * p.dma_setup + 2 * size / p.hbm_bw

    def pack_leaf(self, b, sb, geom, out):
        if geom is None:
            return refk.pack_ref(b, sb, out=out)
        return ops.run_pack_kernel(b, sb, geom, pack_dma, out)

    def unpack_leaf(self, b, packed, sb, geom):
        if geom is None:
            return refk.unpack_ref(b, packed, sb)
        return ops.run_unpack_kernel(b, packed, sb, geom, unpack_dma)


class XlaBlocks(Strategy):
    """One copy per contiguous block — the naive CUDA-aware-MPI baseline
    every implementation shares (the reference's ``xla`` strategy)."""

    name = "xla"
    calibration_cap = 512  # one host-issued copy per block: slow past this

    def model_pack(self, model, ct, incount):
        p, size, sb, m = _analytic_prologue(model, self, ct, incount)
        if sb is None or m is not None:
            return m
        nblocks = sb.num_blocks * incount
        return nblocks * p.xla_copy_overhead + 2 * size / p.hbm_bw

    def pack_leaf(self, b, sb, geom, out):
        if geom is None:
            return refk.pack_ref(b, sb, out=out)
        return refk.pack_xla_blocks(b, sb, out=out)

    def unpack_leaf(self, b, packed, sb, geom):
        if geom is None:
            return refk.unpack_ref(b, packed, sb)
        return refk.unpack_xla_blocks(b, packed, sb)


class Gather(Strategy):
    """Oracle gather/scatter (offset-list walk).  Correct for every
    type; never auto-selected."""

    name = "ref"
    selectable = False

    def model_pack(self, model, ct, incount):
        p, size, sb, m = _analytic_prologue(model, self, ct, incount)
        if sb is None or m is not None:
            return m
        return sb.num_blocks * incount * p.xla_copy_overhead + 2 * size / p.hbm_bw

    def pack_leaf(self, b, sb, geom, out):
        return refk.pack_ref(b, sb, out=out)

    def unpack_leaf(self, b, packed, sb, geom):
        return refk.unpack_ref(b, packed, sb)


class Auto(Strategy):
    """Static geometry heuristic used when no model drives the choice:
    defers to :func:`static_choice` per leaf."""

    name = "auto"
    selectable = False

    def model_pack(self, model, ct, incount):
        geom = plan_geometry(ct.block) if ct.block is not None else None
        return static_choice(geom).model_pack(model, ct, incount)

    def pack_leaf(self, b, sb, geom, out):
        return static_choice(geom).pack_leaf(b, sb, geom, out)

    def unpack_leaf(self, b, packed, sb, geom):
        return static_choice(geom).unpack_leaf(b, packed, sb, geom)


class Bounding(Strategy):
    """The paper's "one-shot" analogue: ship the contiguous bounding
    window of the object with no sender-side pack; the receiver extracts
    the member bytes.  Wins when the object is dense in its extent."""

    name = "bounding"
    wire_only = True

    def applicable(self, ct):
        return ct.block is not None

    def model_pack(self, model, ct, incount):
        return 0.0

    def model_unpack(self, model, ct, incount):
        return 0.0  # extraction is priced in plan(), not here

    def wire_bytes(self, ct, incount=1):
        sb = ct.block
        if sb is None:
            return ct.extent * incount
        return sb.extent + (incount - 1) * ct.extent

    def plan(self, model, ct, incount, hops=1):
        sb = ct.block
        if sb is not None and sb.size == sb.extent:
            t_extract = 0.0  # fully dense: the wire bytes ARE the data
        else:
            # receiver extracts the member bytes from the window and
            # splices them into the destination (two kernels)
            t_extract = ROWS.model_pack(model, ct, incount) + ROWS.model_unpack(
                model, ct, incount
            )
        nbytes = self.wire_bytes(ct, incount)
        return StrategyEstimate(
            self.name, 0.0, model.t_link(nbytes, hops), t_extract,
            wire_bytes=nbytes,
        )

    def pack(self, buf, ct, incount=1, *, out=None, batched=False):
        sb = ct.block
        if sb is None:
            raise ValueError(f"{self.name} needs a strided block")
        b = ops.batch_bytes(buf, batched)
        window = b[:, sb.start : sb.start + self.wire_bytes(ct, incount)]
        if out is None:
            return window.clone() if batched else window[0].clone()
        ops._rows_out(out, b.shape[0], window.shape[1]).copy_(window)
        return out

    def unpack_wire(self, comm, dst, wire, recv_ct, send_ct=None, incount=1):
        # extract member bytes from the received window: same geometry
        # as the send type, rebased to start 0
        send_ct = send_ct or recv_ct
        sb = send_ct.block
        rb = StridedBlock(0, sb.counts, sb.strides)
        packed = torch.empty((wire.shape[0], sb.size * incount),
                             dtype=torch.uint8, device=wire.device)
        for r in range(incount):
            start = r * send_ct.extent
            ops.pack_block(
                wire[:, start : start + sb.extent], rb, batched=True,
                out=packed[:, r * sb.size : (r + 1) * sb.size],
            )
        u = comm.select(recv_ct, incount, wire=False)
        return u.unpack(dst, packed, recv_ct, incount, batched=True)

    def unpack(self, buf, packed, ct, incount=1, *, batched=False):
        raise TypeError(
            f"{self.name} has no local unpack; use unpack_wire on the "
            "received window"
        )


# ===========================================================================
# registry
# ===========================================================================

class StrategyRegistry:
    """Installed strategies, by name."""

    def __init__(self, strategies: Sequence[Strategy] = ()):
        self._by_name: Dict[str, Strategy] = {}
        self._version = 0  # bumped on mutation; invalidates model caches
        for s in strategies:
            self.register(s)

    @property
    def version(self) -> int:
        return self._version

    def register(self, strategy: Union[Strategy, type]) -> Strategy:
        if isinstance(strategy, type):
            strategy = strategy()
        if not strategy.name or strategy.name == Strategy.name:
            raise ValueError("strategy needs a distinct .name")
        if strategy.name in self._by_name:
            raise ValueError(f"strategy {strategy.name!r} already registered")
        self._by_name[strategy.name] = strategy
        self._version += 1
        return strategy

    def get(self, name: StrategyLike) -> Strategy:
        if isinstance(name, Strategy):
            return name
        if name is None:
            name = Auto.name
        s = self._by_name.get(name)
        if s is None:
            raise ValueError(f"unknown strategy {name!r}; registered: {self.names()}")
        return s

    def names(self) -> Tuple[str, ...]:
        return tuple(self._by_name)

    def selectable(self) -> Tuple[Strategy, ...]:
        return tuple(s for s in self._by_name.values() if s.selectable)

    def measurable(self) -> Tuple[Strategy, ...]:
        """Strategies with a real pack path worth calibrating."""
        return tuple(
            s for s in self._by_name.values() if s.selectable and not s.wire_only
        )

    def copy(self) -> "StrategyRegistry":
        """A registry of the same strategies that registers apart from this one."""
        return StrategyRegistry(tuple(self._by_name.values()))

    def __iter__(self):
        return iter(self._by_name.values())

    def __contains__(self, name: object) -> bool:
        return name in self._by_name

    def __len__(self) -> int:
        return len(self._by_name)


ROWS = Rows()
DMA = Dma()
XLA = XlaBlocks()
REF = Gather()
AUTO = Auto()
BOUNDING = Bounding()

_DEFAULT_REGISTRY = StrategyRegistry((ROWS, DMA, XLA, REF, AUTO, BOUNDING))


def default_registry() -> StrategyRegistry:
    """The process-global strategy registry."""
    return _DEFAULT_REGISTRY


def register_strategy(strategy: Union[Strategy, type]) -> Strategy:
    """Install a strategy plugin into the default registry."""
    return _DEFAULT_REGISTRY.register(strategy)


def resolve_strategy(
    strategy: StrategyLike, registry: Optional[StrategyRegistry] = None
) -> Strategy:
    """Name -> Strategy (None resolves to the static-auto strategy)."""
    return (registry or _DEFAULT_REGISTRY).get(strategy)


def static_choice(geom: Optional[PackGeometry]) -> Strategy:
    """Geometry-only kernel choice used by :class:`Auto`: the row kernel
    while a full-pitch read would over-fetch at most 4x, else dma (the
    reference's crossover, kept so the choices compare)."""
    if geom is None:
        return REF
    return ROWS if geom.overfetch <= 4.0 else DMA


# ===========================================================================
# policies (strategy-selection behaviours)
# ===========================================================================

class Policy:
    """Decides the strategy per (committed type, incount, wire?) call."""

    def select(self, comm: "Communicator", ct: CommittedType, incount: int,
               wire: bool) -> Strategy:
        raise NotImplementedError


class ModelPolicy(Policy):
    """Performance-model selection over the registered strategies (§5) —
    the paper's TEMPI behaviour."""

    def select(self, comm, ct, incount, wire):
        est = comm.model.select(ct, incount, allow_bounding=wire,
                                registry=comm.strategies)
        return comm.strategies.get(est.strategy)


class BaselinePolicy(Policy):
    """Naive per-block copies, degrading to the gather path past the
    block cap."""

    def __init__(self, block_cap: int = BASELINE_BLOCK_CAP):
        self.block_cap = block_cap

    def select(self, comm, ct, incount, wire):
        if ct.block is not None and ct.block.num_blocks * incount > self.block_cap:
            return comm.strategies.get(REF.name)
        return comm.strategies.get(XLA.name)


class FixedPolicy(Policy):
    """Force one strategy.  Wire-only strategies (bounding) cannot serve
    local pack/unpack calls; those fall back to the static-auto choice."""

    def __init__(self, strategy: StrategyLike):
        self.strategy = resolve_strategy(strategy)

    def select(self, comm, ct, incount, wire):
        s = comm.strategies.get(self.strategy)
        if s.wire_only and not wire:
            return comm.strategies.get(AUTO.name)
        return s


#: mode names (CLI flags and the benchmark's comparison)
MODES = ("baseline", "tempi", Rows.name, Dma.name, XlaBlocks.name, Gather.name)


def policy_for_mode(mode: str) -> Policy:
    """Map a mode string to a Policy (ValueError on unknown)."""
    if mode == "baseline":
        return BaselinePolicy()
    if mode == "tempi":
        return ModelPolicy()
    if mode in MODES:
        return FixedPolicy(mode)
    raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")


# ===========================================================================
# requests
# ===========================================================================

_PENDING = object()


class Request:
    """Handle to a pending communication: the wire op was issued when
    the request was made; :meth:`wait` runs the receive-side unpack."""

    def __init__(self, thunk: Optional[Callable[[], torch.Tensor]] = None,
                 value=_PENDING):
        self._thunk = thunk
        self._value = value

    @property
    def completed(self) -> bool:
        return self._value is not _PENDING

    def wait(self) -> torch.Tensor:
        if self._value is _PENDING:
            self._value = self._thunk()
            self._thunk = None
        return self._value


class SendRequest(Request):
    """An issued wire transfer: the received ``(R, n)`` payload plus what
    ``irecv`` needs to unpack it; ``segment`` is the exact wire segment
    the payload occupied."""

    def __init__(self, wire: torch.Tensor, strategy: Strategy,
                 send_ct: CommittedType, incount: int,
                 segment: Optional[WireSegment] = None):
        super().__init__(value=wire)
        self.strategy = strategy
        self.send_ct = send_ct
        self.incount = incount
        self.segment = segment


class ClassRequest(Request):
    """One delta class of a fused neighborhood exchange: the class's
    received ``(R, nbytes)`` payload plus exactly the unpacks that
    consume it.  Classes complete independently of each other — the
    receive regions of distinct transfers never overlap, so classes may
    be unpacked in any order and the buffer comes out the same.

    ``transfers`` names the plan's transfer indices riding in this class
    (for the halo they map one to one onto ``DIRECTIONS``), which lets a
    region scheduler turn "this class landed" into "these rim regions
    are computable".  On the card ``event`` is recorded on the
    communicator's side stream right after the class's wire op.  ``hold``
    keeps the tensors the wire op reads (the flat send buffer) alive until
    the class is unpacked."""

    def __init__(self, index: int, payload: torch.Tensor, transfers: Sequence[int],
                 nbytes: int, unpack: Callable[[torch.Tensor, torch.Tensor], None],
                 event: Optional["torch.cuda.Event"] = None, hold=None):
        super().__init__(value=payload)
        self.index = int(index)
        self.transfers = tuple(transfers)
        self.nbytes = int(nbytes)
        self._unpack = unpack
        self.event = event
        self._hold = hold
        #: set once the class's unpacks have been enqueued into the buffer
        self.applied = False

    def ready(self) -> bool:
        """Whether the class's wire op has finished on the device (its
        event has completed).  Without a card there is no stream: the
        payload exists when the request does, and this is True."""
        return True if self.event is None else self.event.query()

    def unpack_into(self, buf: torch.Tensor) -> torch.Tensor:
        """Enqueue this class's unpacks into ``buf`` (in place) and
        return it.  On the card the caller's stream first waits on the
        class's event — the device waits, not the host — and the payload,
        made on the side stream, is marked as used by the caller's
        stream so the allocator does not hand its memory out again while
        the unpacks still read it."""
        if self.event is not None:
            stream = torch.cuda.current_stream(buf.device)
            stream.wait_event(self.event)
            self._value.record_stream(stream)
        self._unpack(buf, self._value)
        self.applied = True
        self._hold = None
        return buf


class NeighborRequest(Request):
    """The request :meth:`Communicator.ineighbor_alltoallv` returns: a
    fused exchange split into independently completable per-class
    :class:`ClassRequest` handles.

    ``wait()`` keeps the monolithic contract — drain every class,
    return the buffer.  Overlap-aware callers (the region-split stencil)
    instead call :meth:`wait_any` in a loop and read :attr:`buffer`
    between drains: each drained class has written its receive
    regions, and every other region of the buffer is untouched.  An
    exchange with no classes is complete at once."""

    def __init__(self, buf: torch.Tensor, classes: Sequence[ClassRequest],
                 plan: Optional[WirePlan] = None,
                 on_drain: Optional[Callable[["NeighborRequest", ClassRequest], None]] = None):
        super().__init__()
        self._buf = buf
        self.classes = tuple(classes)
        self.plan = plan
        #: class indices in the order they were drained
        self.drained: List[int] = []
        #: called after each drain with the request and the drained class
        #: (the communicator records the drain order there, and with
        #: telemetry or a tracer attached the class's drain latency)
        self._on_drain = on_drain
        #: issued while a CUDA graph is captured: an event recorded on a
        #: capturing stream cannot be queried, so classes drain in order
        self._in_order = bool(self.classes) and self.classes[0].event is not None and \
            torch.cuda.is_current_stream_capturing()
        if not self.classes:
            self._value = buf

    @property
    def buffer(self) -> torch.Tensor:
        """The exchange buffer with every *drained* class unpacked."""
        return self._buf

    @property
    def pending(self) -> Tuple[ClassRequest, ...]:
        return tuple(c for c in self.classes if not c.applied)

    def wait_any(self) -> ClassRequest:
        """Drain one class: the first whose wire op has already finished,
        else the first pending one in plan order; enqueue its unpacks
        into :attr:`buffer` and return it.  Under a CUDA graph's capture
        no event is asked whether it finished: the first pending class
        in plan order (the same buffer either way: the classes' receive
        regions are disjoint).  Raises ``ValueError`` once every class
        is drained.  Each drain is one ``tempi.unpack`` range
        (:func:`~repro_torch.obs.trace.region`)."""
        with region("unpack"):
            pend = self.pending
            if not pend:
                raise ValueError("wait_any() on a fully drained request")
            pick = pend[0] if self._in_order else next((c for c in pend if c.ready()), pend[0])
            pick.unpack_into(self._buf)
            self.drained.append(pick.index)
            if self._on_drain is not None:
                self._on_drain(self, pick)
            if len(self.drained) == len(self.classes):
                self._value = self._buf
            return pick

    def wait(self) -> torch.Tensor:
        while self._value is _PENDING:
            self.wait_any()
        return self._value


class PersistentRequest:
    """The request :meth:`Communicator.neighbor_alltoallv_init` returns,
    after MPI-4's ``MPI_Neighbor_alltoallv_init``: one blocking fused
    exchange bound to its buffer, types, permutations, strategies and
    wire plan, run in place by each :meth:`start`.

    On the card the first start runs the eager
    :meth:`Communicator.neighbor_alltoallv` (it loads the kernels and
    fills the plan's caches), the second captures one call into a CUDA
    graph (:class:`~repro_torch.kernels.graphs.GraphCall`) and launches
    it, and every later start replays the graph inside a
    ``tempi.exchange`` range: the same packs, wire ops and per-class
    unpacks on the same addresses, the side stream's fork and the
    per-class events as the graph's edges, and none of the Python.  The
    transport's ``ops`` and ``bytes``, ``wire_class_ops``,
    ``wire_class_bytes`` and ``wire_class_drains`` read as many exchanges
    as were started.  A replay advances no other counter: the kernel
    launch counts (the graph's own launches are :attr:`graph`'s
    ``launches`` times its ``replays``), and :meth:`Communicator.stats`'
    ``commit_hits``, ``model_lookups`` and ``model_hits``.

    A start runs the eager call whenever :attr:`blockers` is not empty.
    The buffer stays bound, and alive, as long as the request."""

    def __init__(self, comm: "Communicator", buf: torch.Tensor, send_cts, recv_cts, perms,
                 plan: WirePlan, strategies):
        self.comm = comm
        self.buf = buf
        self.plan = plan
        self._args = (tuple(send_cts), tuple(recv_cts), tuple(perms), plan, tuple(strategies))
        self._fixed = comm._fixed_blockers(buf, plan, strategies)
        self._keys = tuple(f"{plan.fingerprint}/c{g}" for g in range(plan.ngroups))
        self._warm = False
        #: the captured call, once the second start has captured it
        self.graph: Optional[GraphCall] = None
        #: the wire counters before and after the captured call
        self._moved = None

    @property
    def blockers(self) -> FrozenSet[str]:
        """Why a start now runs the eager call; empty where it may
        capture or replay.  ``device``: the buffer is not on a card;
        ``transport``: the transport is not ``capturable``; ``varlen``:
        the plan's class lengths depend on the data; ``compressor``: a
        strategy encodes or decodes its wire; ``tracer``, ``telemetry``,
        ``recorder``: the call is observed (an active tracer, telemetry,
        an open :func:`~repro_torch.comm.wireplan.collective_payload_bytes`),
        which wants each phase synchronized, timed or counted."""
        return self._fixed | self.comm._observers()

    def start(self) -> torch.Tensor:
        """Run the exchange on the bound buffer, in place; returns it."""
        blocked = self.blockers
        if blocked or not self._warm:
            self._warm |= not blocked
            return self.comm.neighbor_alltoallv(self.buf, *self._args)
        with region("exchange"):
            if self.graph is None:
                before = self._read_wire()
                self.graph = GraphCall(self._joined, self.buf.device)
                self._moved = (before, self._read_wire())
            else:
                self.graph.replay()
                self._apply_wire(*self._moved)
        return self.buf

    def _joined(self) -> None:
        # the eager call, then the side stream joined back into the
        # caller's: a capture may end with no forked stream's work
        # unjoined, whatever the transport issued after a class's event
        self.comm.neighbor_alltoallv(self.buf, *self._args)
        torch.cuda.current_stream(self.buf.device).wait_stream(self.comm._side_stream())

    def _read_wire(self):
        comm = self.comm
        return (comm.transport.ops, comm.transport.bytes,
                [comm.wire_class_ops.get(k, 0) for k in self._keys],
                [comm.wire_class_bytes.get(k, 0) for k in self._keys],
                [comm.wire_class_drains.get(k) for k in self._keys])

    def _apply_wire(self, before, after) -> None:
        # what the captured call moved, once more: ops and bytes add up,
        # a drain position is the one the captured call drained at
        comm = self.comm
        comm.transport.ops += after[0] - before[0]
        comm.transport.bytes += after[1] - before[1]
        for k, b_ops, a_ops, b_bytes, a_bytes, pos in zip(
                self._keys, before[2], after[2], before[3], after[3], after[4]):
            comm.wire_class_ops[k] = comm.wire_class_ops.get(k, 0) + a_ops - b_ops
            comm.wire_class_bytes[k] = comm.wire_class_bytes.get(k, 0) + a_bytes - b_bytes
            comm.wire_class_drains[k] = pos


# ===========================================================================
# the Communicator
# ===========================================================================

#: how :meth:`Communicator.plan_neighbor` picks a wire schedule when the
#: caller does not say: ``"model"`` prices the candidates; ``"exact"`` is
#: the byte-exact ladder
DEFAULT_SCHEDULE_POLICY = "model"


def plan_neighbor_alltoallv(
    sizes: Tuple[int, ...],
    perms: Tuple[Tuple[Tuple[int, int], ...], ...],
    fingerprints: Optional[Tuple[str, ...]] = None,
    uniform_waste_tolerance: float = 0.0,
    native: bool = False,
) -> WirePlan:
    """Group ``len(sizes)`` transfers (one full permutation each) into an
    exact-byte :class:`WirePlan`: a thin alias over
    :func:`repro_torch.comm.wireplan.plan_wire`, kept as this module's
    public planning entry point.  ``native`` says whether the transport
    has a native ragged all-to-all (the local mesh has not)."""
    return plan_wire(
        tuple(sizes),
        tuple(tuple(map(tuple, p)) for p in perms),
        fingerprints=fingerprints,
        uniform_waste_tolerance=uniform_waste_tolerance,
        native=native,
    )


def _send_leaves(plan, strategies, send_cts) -> list:
    """The ``(offset, nbytes, pack_fn, encode_fn)`` leaf of each transfer
    of a fused exchange, for
    :func:`~repro_torch.kernels.pack.pack_compress_ragged`.  A compressor
    (a strategy with ``encode_wire``) has its member bytes gathered by
    the static choice's kernels and encoded into the slot; every other
    strategy packs its wire format straight into the slot."""
    return [(seg.offset, seg.nbytes, functools.partial(_pack_leaf, strat, ct),
             getattr(strat, "encode_wire", None))
            for seg, strat, ct in zip(plan.segments, strategies, send_cts)]


def _class_leaves(comm, plan, strategies, send_cts, recv_cts) -> List[list]:
    """Per delta class of a fused exchange, the ``(offset, nbytes,
    decode_fn, unpack_fn)`` leaves of
    :func:`~repro_torch.kernels.unpack.decode_unpack_ragged`.  A
    compressor's leaf decodes the wire to member bytes and scatters them
    with ``comm.unpack``; every other leaf hands its wire bytes to the
    send strategy's ``unpack_wire``.  Both select at unpack time.  Under
    ``varlen`` a single-transfer class's payload is the cut stream, read
    at its received length."""
    tables = []
    for grp, class_bytes in zip(plan.groups, _class_bytes(plan)):
        leaves = []
        for i, off in zip(grp.transfers, grp.offsets):
            strat, recv_ct = strategies[i], recv_cts[i]
            nbytes = class_bytes if len(grp.transfers) == 1 else plan.segments[i].nbytes
            decode = getattr(strat, "decode_wire", None)
            if decode is None:
                leaves.append((off, nbytes, None, functools.partial(
                    strat.unpack_wire, comm, recv_ct=recv_ct, send_ct=send_cts[i])))
            else:
                leaves.append((off, nbytes, functools.partial(decode, n=recv_ct.size),
                               functools.partial(comm.unpack, ct=recv_ct)))
        tables.append(leaves)
    return tables


def _class_bytes(plan) -> Tuple[int, ...]:
    """Each delta class's payload bytes: its stream length under ``varlen``, else its capacity."""
    return plan.stream_bytes if plan.schedule == "varlen" else tuple(
        g.nbytes for g in plan.groups)


def _pack_leaf(strat, ct, buf, out):
    # pack_compress_ragged asks a leaf with an encoder (out=None) for its
    # member bytes, and any other leaf for its wire format in the slot
    if out is None:
        return ops.pack(buf, ct, batched=True)
    return strat.pack(buf, ct, out=out, batched=True)


def _record_class_event(events, stream, g):
    # the transport's on_class hook, called right after class g's wire op
    events[g] = torch.cuda.Event()
    events[g].record(stream)


class Communicator:
    """Datatype-aware communication endpoint.

    Parameters
    ----------
    params: system parameter table for the performance model.
    registry: datatype commit cache (``MPI_Type_commit`` analogue).
    strategies: strategy registry; defaults to the process-global one.
    policy: strategy-selection behaviour; defaults to model selection.
    transport: what moves the wire bytes; defaults to the local mesh on
        ``device``.
    device: where the buffers live: ``"cuda"`` (the default; raises when
        no card is present) or ``"cpu"``.  With a transport given it
        defaults to the transport's device (under one process per rank,
        the process's own card), and a device that differs raises.
    decisions: optional :class:`repro_torch.measure.DecisionCache` —
        pins strategy selections (fingerprint-keyed) and records them
        with every priced wire plan in its audit log.
    topology: optional :class:`repro_torch.comm.topology.Topology`, the
        rank -> node map of a two-level machine.  Wire plans of as many
        ranks carry link classes and tier bundles, the model charges the
        slow tier per crossing class, the ``tiered`` schedule joins the
        candidates, and every wire and program decision gains the
        topology fingerprint (``repro_torch.train.elastic.replan_on_remesh``
        re-prices when it changes).
    axis_name: the mesh axis whose measured wire table
        (``SystemParams.wire_tables``) prices the links by default.
    telemetry: optional :class:`repro_torch.fleet.ExchangeTelemetry`, the
        runtime half of the feedback loop.  Planning registers the
        model's predicted seconds per decision key; the blocking entry
        points (:meth:`sendrecv`, :meth:`neighbor_alltoallv`) also observe
        wall time, synchronizing the buffer's device first, and every
        drained delta class observes its drain latency.
    tracer: optional :class:`repro_torch.obs.Tracer`: structured
        per-phase spans on the same paths, recorded only while the tracer
        is active (never while a CUDA graph is being captured).  A traced
        call runs the untraced call's code: each phase (:meth:`_phase`)
        is a span instead of a ``tempi.*`` range, synchronized at its end,
        with the decision signature and the model's predictions as span
        attributes; planning records a ``plan`` span and each drained
        class a ``wire_class`` span.

    With neither attached the entry points add no synchronization and no
    timing; a program step stays free of host stream synchronizations.
    """

    def __init__(
        self,
        params: SystemParams = H100_ANALYTIC,
        registry: Optional[TypeRegistry] = None,
        strategies: Optional[StrategyRegistry] = None,
        policy: Optional[Policy] = None,
        transport=None,
        device=None,
        decisions=None,
        topology=None,
        axis_name: Optional[str] = None,
        telemetry=None,
        tracer=None,
    ):
        if transport is None:
            self.device = resolve_device("cuda" if device is None else device)
            transport = LocalMeshTransport(self.device)
        else:
            self.device = transport.device
            if device is not None and resolve_device(device) != self.device:
                raise ValueError(
                    f"device {device!r} differs from the transport's {self.device}")
        self.transport = transport
        self.registry = registry or TypeRegistry()
        self.strategies = strategies or default_registry()
        self.model = PerfModel(params, decisions=decisions, axis=axis_name, topology=topology)
        self.policy = policy or ModelPolicy()
        self.telemetry = telemetry
        self.tracer = tracer
        # per-delta-class wire accounting, keyed "<plan fp>/c<class>":
        # issue counts and exact bytes per class, and the 1-based drain
        # position wait_any() last saw the class at
        self.wire_class_ops: Dict[str, int] = {}
        self.wire_class_bytes: Dict[str, int] = {}
        self.wire_class_drains: Dict[str, int] = {}
        # varlen exchanges: their count, the capacity bytes each rank's
        # plan holds and the stream bytes it moved
        self.compress_exchanges = 0
        self.compress_capacity_bytes = 0
        self.compress_stream_bytes = 0
        self._side: Optional["torch.cuda.Stream"] = None

    def _side_stream(self) -> "torch.cuda.Stream":
        """The stream this communicator issues its packs and wire ops on
        (on the card; made at first use)."""
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        return self._side

    def _tracing_spans(self) -> bool:
        """Whether this call records spans: a tracer is attached and
        active (the current stream is not capturing a CUDA graph)."""
        return self.tracer is not None and self.tracer.active

    @contextlib.contextmanager
    def _phase(self, name: str, sync: Optional[torch.Tensor] = None, **attrs):
        """One phase of an operation, traced or not: under an active
        tracer a ``name`` span carrying ``attrs``, ``sync``'s device
        synchronized before it closes; else a ``tempi.<name>`` range
        (:func:`~repro_torch.obs.trace.region`).  Yields the span, or None
        when none records (untraced, or past the tracer's span cap)."""
        if not self._tracing_spans():
            with region(name):
                yield None
            return
        with self.tracer.span(name, **attrs) as sp:
            yield sp
            if sync is not None:
                synchronize(sync)

    def _fixed_blockers(self, buf: torch.Tensor, plan: WirePlan,
                        strategies: Sequence[Strategy]) -> FrozenSet[str]:
        """What keeps a persistent exchange of ``buf`` under ``plan`` from
        ever being captured (:attr:`PersistentRequest.blockers`)."""
        out = set()
        if not buf.is_cuda:
            out.add("device")
        if not getattr(self.transport, "capturable", False):
            out.add("transport")
        if plan.schedule == "varlen":
            out.add("varlen")
        if any(getattr(s, "encode_wire", None) is not None
               or getattr(s, "decode_wire", None) is not None for s in strategies):
            out.add("compressor")
        return frozenset(out)

    def _observers(self) -> FrozenSet[str]:
        """What observes this communicator's calls now, so that a
        persistent exchange runs eagerly (:attr:`PersistentRequest.blockers`)."""
        out = set()
        if self._tracing_spans():
            out.add("tracer")
        if self.telemetry is not None:
            out.add("telemetry")
        if RECORDERS:
            out.add("recorder")
        return frozenset(out)

    @property
    def wire_ops(self) -> int:
        """Wire ops the transport issued for this communicator."""
        return self.transport.ops

    @property
    def wire_payload_bytes(self) -> int:
        """Bytes each rank put on the wire, as the transport counted."""
        return self.transport.bytes

    def _check(self, *bufs: torch.Tensor) -> None:
        rows = self.transport.local_ranks
        for b in bufs:
            if b.device != self.device:
                raise ValueError(f"buffer on {b.device}; communicator on {self.device}")
            if rows is not None and (b.dim() == 0 or b.shape[0] != rows):
                raise ValueError(
                    f"buffer of shape {tuple(b.shape)}: the transport's buffers hold "
                    f"{rows} rank(s) on the leading dimension")

    # -- commit / selection ---------------------------------------------
    def commit(self, dt: Datatype) -> CommittedType:
        return self.registry.commit(dt)

    def select(self, ct: CommittedType, incount: int = 1, wire: bool = True) -> Strategy:
        """The strategy the active policy picks for this call site."""
        return self.policy.select(self, ct, incount, wire)

    # -- MPI_Pack / MPI_Unpack on every rank of the buffer ----------------
    def pack(self, buf: torch.Tensor, ct: CommittedType, incount: int = 1) -> torch.Tensor:
        self._check(buf)
        return self.select(ct, incount, wire=False).pack(buf, ct, incount, batched=True)

    def unpack(self, buf: torch.Tensor, packed: torch.Tensor, ct: CommittedType,
               incount: int = 1) -> torch.Tensor:
        self._check(buf, packed)
        return self.select(ct, incount, wire=False).unpack(
            buf, packed, ct, incount, batched=True
        )

    # -- point-to-point (requests; paper §6.3) ----------------------------
    def isend(self, buf: torch.Tensor, ct: CommittedType,
              perm: Sequence[Tuple[int, int]], incount: int = 1) -> SendRequest:
        """Pack ``ct`` out of every rank of ``buf`` and send along
        ``perm`` now; the request carries the received payload.  With
        telemetry attached the send type's price (through the chosen
        strategy, recording no decision) is registered under its
        fingerprint."""
        self._check(buf)
        s = self.select(ct, incount, wire=True)
        seg = s.wire_segment(ct, incount)
        if self.telemetry is not None:
            est = s.plan(self.model, ct, incount)
            self.telemetry.register(ct.fingerprint, est.total, s.name)
        payload = s.pack(buf, ct, incount, batched=True)
        wire = self.transport.permute(payload, perm)
        return SendRequest(wire, s, ct, incount, segment=seg)

    def irecv(self, buf: torch.Tensor, ct: CommittedType, send_req: SendRequest,
              incount: Optional[int] = None) -> Request:
        """Bind a destination buffer + receive type to an issued send;
        ``wait()`` unpacks into ``buf`` in place."""
        inc = send_req.incount if incount is None else incount
        return Request(
            thunk=lambda: send_req.strategy.unpack_wire(
                self, buf, send_req.wait(), ct, send_req.send_ct, inc
            )
        )

    def sendrecv(self, src_buf, dst_buf, send_ct, perm, recv_ct=None, incount=1):
        """Blocking pack -> send -> unpack; returns ``dst_buf``, updated
        in place.  One ``exchange`` :meth:`_phase` around ``pack``,
        ``wire`` and ``unpack`` phases; traced, the spans carry the send
        type's decision signature and the model's predictions.  With
        telemetry attached the call is timed against the send type's
        fingerprint, from the first pack to the synchronized unpack."""
        self._check(src_buf)
        s = self.select(send_ct, incount, wire=True)
        seg = s.wire_segment(send_ct, incount)
        pred = t_pack = t_link = t_unpack = None
        if self.telemetry is not None or self._tracing_spans():
            est = s.plan(self.model, send_ct, incount)
            pred, t_pack, t_link, t_unpack = est.total, est.t_pack, est.t_link, est.t_unpack
            if self.telemetry is not None:
                self.telemetry.register(send_ct.fingerprint, est.total, s.name)
        t0 = time.perf_counter()
        with self._phase("exchange", fingerprint=send_ct.fingerprint, strategy=s.name,
                         wire_bytes=seg.nbytes, incount=incount, pred=pred):
            with self._phase("pack", sync=src_buf, pred=t_pack):
                payload = s.pack(src_buf, send_ct, incount, batched=True)
            with self._phase("wire", sync=src_buf, pred=t_link, wire_bytes=seg.nbytes):
                wire = self.transport.permute(payload, perm)
            with self._phase("unpack", sync=dst_buf, pred=t_unpack):
                out = s.unpack_wire(self, dst_buf, wire, recv_ct or send_ct, send_ct, incount)
        if self.telemetry is not None:
            synchronize(out)  # asynchronous launches would under-report
            self.telemetry.observe(send_ct.fingerprint, time.perf_counter() - t0)
        return out

    # -- fused neighborhood alltoallv (the paper's MPI_Alltoallv) ----------
    def plan_neighbor(
        self,
        send_cts: Sequence[CommittedType],
        perms: Sequence[Sequence[Tuple[int, int]]],
        strategies: Optional[Sequence[Strategy]] = None,
        uniform_waste_tolerance: float = 0.0,
        schedule_policy: Optional[str] = None,
        probe: Optional[torch.Tensor] = None,
    ) -> Tuple[Tuple[Strategy, ...], WirePlan]:
        """Select a strategy per transfer and lay the exchange out as an
        exact-byte :class:`WirePlan`.  Call once at setup time and hand
        the result to :meth:`ineighbor_alltoallv`.

        ``schedule_policy``: ``"model"`` (default) lets the performance
        model price the feasible schedules; ``"exact"`` keeps the
        byte-exact ladder.  Whether a native ragged collective exists is
        the transport's answer (``transport.native_ragged``).  The plan is
        priced and, with a decision cache, recorded with the prices of
        the schedules the model rejected.  With telemetry attached the
        plan's price is registered under its fingerprint (and, for a plan
        of more than one class, each class's predicted completion under
        ``<fp>/c<g>``; for a probed plan the probed ratio under
        ``<fp>/ratio``); with an active tracer the planning is recorded
        as a ``plan`` span.

        ``probe`` (one rank's buffer, concrete) turns on length-aware
        planning: under model selection a ``supports_varlen`` compressor
        is priced at the probe's stream length; the plan carries per-class
        ``stream_bytes`` (single-transfer classes only: a cut
        multi-transfer class would lose its later segments) when they sum
        below the capacity, and the model-priced schedule may then be
        ``varlen``.  Every rank's payload must fit the probe's streams:
        the ``varlen`` schedule cuts each class at its stream length.
        Probing reads a number back from the device per probed type."""
        if schedule_policy is None:
            schedule_policy = DEFAULT_SCHEDULE_POLICY
        if schedule_policy not in ("exact", "model"):
            raise ValueError(
                f"unknown schedule_policy {schedule_policy!r}; "
                "expected 'exact' or 'model'"
            )
        t_plan0 = time.perf_counter() if self._tracing_spans() else None
        if strategies is not None:
            strats = tuple(strategies)
        elif probe is not None and isinstance(self.policy, ModelPolicy):
            # probed selection: varlen-capable compressors are priced at
            # the payload's stream length
            strats = tuple(
                self.strategies.get(self.model.select(
                    ct, 1, allow_bounding=True, registry=self.strategies, probe=probe,
                ).strategy)
                for ct in send_cts
            )
        else:
            strats = tuple(self.select(ct, 1, wire=True) for ct in send_cts)
        segs = [s.wire_segment(ct) for s, ct in zip(strats, send_cts)]
        native = self.transport.native_ragged
        plan = plan_wire(
            tuple(s.nbytes for s in segs),
            tuple(tuple(map(tuple, p)) for p in perms),
            fingerprints=tuple(s.fingerprint for s in segs),
            uniform_waste_tolerance=uniform_waste_tolerance,
            native=native,
            topology=self.model.topology,
        )
        if probe is not None and any(s.supports_varlen for s in strats):
            # stream lengths attach after planning, so plan_wire stays
            # payload-independent; only single-transfer classes may be cut
            per_transfer = [s.probe_stream_bytes(ct, 1, probe)
                            for s, ct in zip(strats, send_cts)]
            per_group = tuple(
                min(per_transfer[grp.transfers[0]], grp.nbytes)
                if len(grp.transfers) == 1 else grp.nbytes
                for grp in plan.groups
            )
            if sum(per_group) < plan.wire_bytes:
                plan = plan.with_stream_bytes(per_group)
        note = ""
        if schedule_policy == "model":
            plan, costs = self.model.choose_wire_schedule(plan, native)
            note = " priced[" + " ".join(
                f"{k}={v:.3e}" for k, v in sorted(costs.items())
            ) + "]"
        est = self.model.price_exchange(plan, note=note)
        if self.telemetry is not None:
            # the prediction is on file before the first observation
            self.telemetry.register(plan.fingerprint, est.total, est.strategy)
            # per-class completions beside the whole-exchange key, so
            # drift can name the slow direction, not just the exchange
            if plan.ngroups > 1:
                for g, t_c in enumerate(self.model.price_class_completions(plan)):
                    self.telemetry.register(f"{plan.fingerprint}/c{g}", t_c,
                                            f"class/{plan.schedule}")
            if plan.stream_bytes:
                # achieved-ratio ring: predicted = the probed ratio
                self.telemetry.register(f"{plan.fingerprint}/ratio", plan.stream_ratio,
                                        "compress/ratio")
        if t_plan0 is not None:
            self.tracer.add_manual(
                "plan", t_plan0, time.perf_counter() - t_plan0,
                fingerprint=plan.fingerprint, strategy=est.strategy,
                schedule=plan.schedule, wire_bytes=plan.issued_bytes,
                nsegments=len(plan.segments), pred=est.total,
            )
        return strats, plan

    def _phase_predictions(self, send_cts, strategies, plan) -> Tuple[float, float, float]:
        """Model-predicted (pack, wire, unpack) seconds of one fused
        exchange: the member estimates through the plan's strategies and
        the model's price of the plan's own schedule — the ``pred``
        attributes of the phase spans.  Computed only on traced calls."""
        t_pack = t_unpack = 0.0
        for ct, strat in zip(send_cts, strategies):
            est = strat.plan(self.model, ct, 1)
            t_pack += est.t_pack
            t_unpack += est.t_unpack
        return t_pack, self.model._price_schedule(plan, plan.schedule), t_unpack

    def _drained(self, issued_at: Optional[float], tracing: bool,
                 req: NeighborRequest, cls: ClassRequest) -> None:
        """The drain hook of a fused exchange: the class's 1-based drain
        position; on an observed exchange (``issued_at``, the wire's issue
        time, given) also, after synchronizing the buffer's device, the
        class's latency from issue, observed under ``<fp>/c<g>`` with
        telemetry and recorded as a ``wire_class`` span when ``tracing``."""
        key = f"{req.plan.fingerprint}/c{cls.index}"
        self.wire_class_drains[key] = len(req.drained)
        if issued_at is None:
            return
        synchronize(req.buffer)
        dt = time.perf_counter() - issued_at
        if self.telemetry is not None:
            self.telemetry.observe(key, dt)
        if tracing:
            self.tracer.add_manual(
                "wire_class", issued_at, dt, fingerprint=req.plan.fingerprint,
                nbytes=cls.nbytes, transfers=len(cls.transfers),
                drain_order=len(req.drained), **{"class": cls.index},
            )

    def ineighbor_alltoallv(
        self,
        buf: torch.Tensor,
        send_cts: Sequence[CommittedType],
        recv_cts: Sequence[CommittedType],
        perms: Sequence[Sequence[Tuple[int, int]]],
        plan: Optional[WirePlan] = None,
        strategies: Optional[Sequence[Strategy]] = None,
    ) -> "NeighborRequest":
        """Fused neighborhood exchange: transfer ``i`` packs
        ``send_cts[i]`` out of every rank of ``buf``, ships it along
        ``perms[i]``, and unpacks into ``recv_cts[i]`` of the same
        buffer.  Every region is packed at its exact wire extent straight
        into one flat buffer laid out by the plan, and the transport
        moves exactly those bytes.  The wire is issued now.

        Returns a :class:`NeighborRequest`: one :class:`ClassRequest` per
        delta class, each completable on its own through ``wait_any()``;
        ``wait()`` runs every unpack (in place into ``buf``).

        On the card the packs and the wire ops run on the communicator's
        side stream, after the caller's stream has reached this call, and
        one event per class is recorded right after its wire op (under
        NCCL, after the side stream has waited on the op), so the
        caller's stream may go on (an interior stencil chain) while the
        exchange is on the wire.  The packs read only interior cells and
        the unpacks write only halo cells; no unpack runs before the
        caller's stream has waited on its class's event, and whatever
        writes the packed cells must first drain every class.

        The pack and the wire are one :meth:`_phase` each; the rest of
        the host's work lies in ``tempi.prep`` ranges (before the first
        pack and after the wire) and each drained class in one
        ``tempi.unpack``.  With telemetry or an active tracer attached
        each drained class is observed (:meth:`_drained`)."""
        with region("prep"):
            if not (len(send_cts) == len(recv_cts) == len(perms)):
                raise ValueError("send_cts, recv_cts, perms must align")
            self._check(buf)
            n = len(send_cts)
            if n == 0:
                return NeighborRequest(buf, ())
            if strategies is None:
                strategies = tuple(self.select(ct, 1, wire=True) for ct in send_cts)
            if plan is None:
                _, plan = self.plan_neighbor(send_cts, perms, strategies=strategies)
            elif len(plan.segments) != n:
                raise ValueError(
                    f"wire plan describes {len(plan.segments)} transfers, got {n} send types"
                )
            leaves = _send_leaves(plan, strategies, send_cts)
            events: List[Optional[torch.cuda.Event]] = [None] * plan.ngroups
            stream, on_class = contextlib.nullcontext(), None
            if buf.is_cuda:
                side = self._side_stream()
                side.wait_stream(torch.cuda.current_stream(buf.device))
                # the side stream reads buf: keep its memory from being
                # handed out again before those reads are done
                buf.record_stream(side)
                stream = torch.cuda.stream(side)
                on_class = functools.partial(_record_class_event, events, side)
            tracing = self._tracing_spans()
            t_pack = t_wire = None
            if tracing:
                t_pack, t_wire, _ = self._phase_predictions(send_cts, strategies, plan)
        with stream:
            with self._phase("pack", sync=buf, pred=t_pack, nbytes=plan.wire_bytes):
                wire = pack_compress_ragged(buf, leaves, plan.wire_bytes)
            with self._phase("wire", sync=buf, pred=t_wire, wire_bytes=plan.issued_bytes,
                             schedule=plan.schedule):
                group_rows = self.transport.exchange(wire, plan, on_class)
        with region("prep"):
            sizes = _class_bytes(plan)
            if plan.schedule == "varlen":
                self.compress_exchanges += 1
                self.compress_capacity_bytes += plan.wire_bytes
                self.compress_stream_bytes += plan.effective_wire_bytes
                if self.telemetry is not None:
                    self.telemetry.observe(f"{plan.fingerprint}/ratio", plan.stream_ratio)
            fp = plan.fingerprint
            for g, nbytes in enumerate(sizes):
                key = f"{fp}/c{g}"
                self.wire_class_ops[key] = self.wire_class_ops.get(key, 0) + 1
                self.wire_class_bytes[key] = self.wire_class_bytes.get(key, 0) + nbytes
            tables = _class_leaves(self, plan, strategies, send_cts, recv_cts)
            classes = [ClassRequest(g, group_rows[g], grp.transfers, sizes[g],
                                    functools.partial(decode_unpack_ragged, leaves=tables[g]),
                                    events[g], hold=wire)
                       for g, grp in enumerate(plan.groups)]
            observed = tracing or self.telemetry is not None
            issued_at = time.perf_counter() if observed else None
            return NeighborRequest(buf, classes, plan,
                                   functools.partial(self._drained, issued_at, tracing))

    def neighbor_alltoallv(self, buf, send_cts, recv_cts, perms, plan=None,
                           strategies=None) -> torch.Tensor:
        """Blocking :meth:`ineighbor_alltoallv`; returns ``buf``, updated
        in place.  One ``exchange`` :meth:`_phase`; traced, its span
        carries the decision signature (``fingerprint``,
        ``strategy=wire/<schedule>``, ``schedule``, ``wire_bytes``,
        ``ngroups``, ``pred``) around ``plan`` (when planned here),
        ``pack``, ``wire`` and one ``unpack`` span around the drains.
        With telemetry attached the call is timed against the wire plan's
        fingerprint (the key the decision cache records the schedule
        under), from the exchange's issue to the synchronized unpack."""
        if len(send_cts) == 0:  # nothing to plan, move or observe
            with region("exchange"):
                return self.ineighbor_alltoallv(
                    buf, send_cts, recv_cts, perms, plan, strategies).wait()
        with self._phase("exchange") as sp:
            if strategies is None:
                strategies = tuple(self.select(ct, 1, wire=True) for ct in send_cts)
            if plan is None:
                strategies, plan = self.plan_neighbor(send_cts, perms, strategies=strategies)
            unpack = contextlib.nullcontext()
            if sp is not None:
                t_pack, t_wire, t_unpack = self._phase_predictions(send_cts, strategies, plan)
                sp.attrs.update(fingerprint=plan.fingerprint, strategy=f"wire/{plan.schedule}",
                                schedule=plan.schedule, wire_bytes=plan.issued_bytes,
                                ngroups=len(plan.groups), pred=t_pack + t_wire + t_unpack)
                # untraced, each drained class is its own tempi.unpack
                unpack = self._phase("unpack", sync=buf, pred=t_unpack)
            t0 = time.perf_counter()
            req = self.ineighbor_alltoallv(buf, send_cts, recv_cts, perms, plan, strategies)
            with unpack:
                out = req.wait()
        if self.telemetry is not None:
            synchronize(out)  # asynchronous launches would under-report
            self.telemetry.observe(plan.fingerprint, time.perf_counter() - t0)
        return out

    def neighbor_alltoallv_init(self, buf, send_cts, recv_cts, perms, plan: WirePlan,
                                strategies: Sequence[Strategy]) -> PersistentRequest:
        """The persistent :meth:`neighbor_alltoallv` (MPI-4's
        ``MPI_Neighbor_alltoallv_init``): bind the exchange to ``buf``,
        its wire ``plan`` and ``strategies`` (:meth:`plan_neighbor`'s) and
        return a :class:`PersistentRequest` whose ``start()`` runs it in
        place, replayed from a CUDA graph from its third start on where
        nothing blocks that."""
        if not (len(send_cts) == len(recv_cts) == len(perms)):
            raise ValueError("send_cts, recv_cts, perms must align")
        self._check(buf)
        return PersistentRequest(self, buf, send_cts, recv_cts, perms, plan, strategies)

    # -- collectives on datatypes ----------------------------------------
    def all_gather_packed(self, buf: torch.Tensor, ct: CommittedType,
                          incount: int = 1) -> torch.Tensor:
        """Pack the datatype out of every rank of ``buf``, then all-gather
        the packed payloads: returns ``(local ranks, R, size * incount)``
        bytes, every rank holding every rank's payload in rank order (the
        local mesh's ``(R, R, n)``; under one process per rank this rank's
        ``(1, R, n)``).  One wire op."""
        return self.transport.all_gather(self.pack(buf, ct, incount))

    def all_to_all_packed(self, buf: torch.Tensor,
                          cts: Sequence[CommittedType]) -> torch.Tensor:
        """MPI_Alltoall over equal-size segments: pack one datatype per
        peer out of every rank of ``buf`` into ``(local ranks, npeers,
        seg)``, then all-to-all along the peers: the ``npeers`` rows split
        into R equal chunks, chunk ``c`` goes to rank ``c``, and each rank
        receives the chunks in source-rank order.  Every ``cts`` must have
        the same packed size (pad types to match).  One wire op."""
        if len({ct.size for ct in cts}) != 1:
            raise ValueError("all_to_all_packed needs equal-size segments")
        sendbuf = torch.stack([self.pack(buf, ct) for ct in cts], dim=1)
        return self.transport.all_to_all(sendbuf)

    # --------------------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        """Cumulative counters for this communicator, under the
        reference's keys.  Every call also publishes them into the process
        metrics registry (:func:`repro_torch.obs.metrics.publish_comm_stats`),
        so ``default_metrics().snapshot()`` — and the ``metrics.json``
        the production ``save()`` persists — reflects the latest totals."""
        out = {
            "committed_types": len(self.registry),
            "commit_hits": self.registry.hits,
            "model_lookups": self.model.lookups,
            "model_hits": self.model.hits,
            "strategies": len(self.strategies),
            "wire_ops": self.wire_ops,
            "wire_payload_bytes": self.wire_payload_bytes,
            "wire_classes": len(self.wire_class_bytes),
            "wire_class_ops": dict(self.wire_class_ops),
            "wire_class_bytes": dict(self.wire_class_bytes),
            "wire_class_drains": dict(self.wire_class_drains),
            "compress_exchanges": self.compress_exchanges,
            "compress_capacity_bytes": self.compress_capacity_bytes,
            "compress_stream_bytes": self.compress_stream_bytes,
            "compress_ratio": (
                self.compress_stream_bytes / self.compress_capacity_bytes
                if self.compress_capacity_bytes else 1.0
            ),
            "telemetry_keys": len(self.telemetry) if self.telemetry is not None else 0,
        }
        from repro_torch.obs.metrics import publish_comm_stats

        publish_comm_stats(out, self.telemetry)
        return out


def as_communicator(obj) -> Communicator:
    """Accept a Communicator or anything wrapping one (the
    :class:`~repro_torch.comm.interposer.Interposer` shim exposes
    ``.comm``)."""
    if isinstance(obj, Communicator):
        return obj
    comm = getattr(obj, "comm", None)
    if isinstance(comm, Communicator):
        return comm
    raise TypeError(f"expected a Communicator (or shim), got {type(obj)!r}")
