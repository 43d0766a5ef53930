"""WirePlan: exact-byte wire layout for fused neighborhood exchanges.

TEMPI's canonical representation tells the library exactly how many
bytes a committed datatype really occupies once packed; this module
turns that knowledge into the wire layout itself.  A :class:`WirePlan`
lays every transfer out at its *exact* packed extent — a flat
per-destination buffer of :class:`~repro_torch.core.commit.WireSegment`
descriptors, no class padding, no row equalization — and then picks the
cheapest wire **schedule** that can carry that ragged layout:

``ragged``
    one ragged all-to-all (MPI_Alltoallv): exact bytes, one wire op.
    Picked by the exact ladder only when the transport has it natively
    (``native=True``; see ``repro_torch.comm.transport``).
``uniform``
    one plain all-to-all over destination-ordered rows.  A uniform
    collective *must* equalize rows, so this schedule is only chosen
    when the padding it would add stays within
    ``uniform_waste_tolerance`` (default 0: byte-exact or not at all).
``grouped``
    one permutation send per delta class, each carrying exactly that
    class's concatenated segments.  Always available, always
    byte-exact; this is also the large-grid fallback: past
    ``grouped_fallback_rank_factor`` x the class count, most fused rows
    would be zero, so the plan degrades to per-class sends regardless of
    primitive availability.
``varlen``
    the length-aware ``grouped``: each class is cut at its probed stream
    length (``stream_bytes``), so the compressed bytes, not the
    capacity, are the bytes on the wire.
``tiered``
    the hierarchy-aware ``grouped``.  With a
    :class:`~repro_torch.comm.topology.Topology` annotation, a class
    whose edges stay on one node rides its own send, but the classes
    crossing the inter-node tier are coalesced per peer node: each tier
    bundle travels as one slow-tier message along its representative's
    permutation, then each other member is forwarded to its true rank by
    an intra-node correction hop.  Fewer slow-tier messages, bought with
    ``correction_bytes`` of fast-tier traffic; the model prices the
    trade, and the exact ladder never picks it.

The layout and the schedule choice are host-side and cached; the
payload accounting (:attr:`WirePlan.wire_bytes` = the sum of per-peer
packed extents, and :attr:`WirePlan.issued_bytes` = what the chosen
schedule puts on the wire) is what ``PerfModel.price_exchange`` prices
and what the transport's own byte counter must reproduce.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.commit import WireSegment
from repro_torch.comm.topology import Topology, classify_and_coalesce
from repro_torch.comm.transport import RECORDERS

__all__ = [
    "WireGroup",
    "WirePlan",
    "plan_wire",
    "reschedule",
    "GROUPED_FALLBACK_RANK_FACTOR",
    "WIRE_COLLECTIVES",
    "WIRE_SCHEDULES",
    "collective_payload_bytes",
]

#: past ``factor * ngroups`` ranks the fused single-collective layout is
#: mostly zero rows (non-neighbor peers); the plan then always takes the
#: grouped per-class schedule (ROADMAP: grid-size threshold fallback)
GROUPED_FALLBACK_RANK_FACTOR = 4.0

#: primitive names that put payload on the wire in our schedules (the
#: reference's jaxpr names: a permutation send, a uniform all-to-all, a
#: ragged all-to-all)
WIRE_COLLECTIVES = ("ppermute", "all_to_all", "ragged_all_to_all")

#: every wire schedule a plan can carry ("tiered" needs a topology
#: annotation, "varlen" a stream-length annotation; the exact ladder
#: only ever picks the first three)
WIRE_SCHEDULES = ("ragged", "uniform", "grouped", "tiered", "varlen")


@dataclass(frozen=True)
class WireGroup:
    """One delta class of a rank-uniform exchange: the transfers whose
    destination is the same rank *for every rank* share one wire payload
    of exactly ``nbytes`` (the sum of their segment extents)."""

    transfers: Tuple[int, ...]        # transfer ids riding this class
    offsets: Tuple[int, ...]          # group-local byte offset per transfer
    nbytes: int                       # exact payload — no padding
    perm: Tuple[Tuple[int, int], ...]  # the class's (src, dst) edges


@dataclass(frozen=True)
class WirePlan:
    """Host-computed exact-byte layout of a fused neighborhood exchange.

    ``segments[i]`` is transfer ``i``'s :class:`WireSegment` with its
    *global* offset in the flat send buffer; ``groups[g]`` carries the
    group-local offsets the receive side unpacks at.  ``wire_bytes`` is
    the ragged optimum (sum of segment extents); ``issued_bytes`` is
    what the chosen schedule actually transfers (equal to
    ``wire_bytes`` for the exact schedules, ``nranks * seg_bytes`` for
    the padded uniform collective).
    """

    nranks: int
    groups: Tuple[WireGroup, ...]
    segments: Tuple[WireSegment, ...]
    group_offsets: Tuple[int, ...]
    schedule: str                # "ragged" | "uniform" | "grouped" | "tiered"
    fused: bool                       # group -> peer injective per rank
    wire_bytes: int                   # sum of exact segment extents
    seg_bytes: int                    # uniform row size (largest group)
    send_rows: Tuple[Tuple[int, ...], ...]   # [rank][dest] -> group|G
    recv_rows: Tuple[Tuple[int, ...], ...]   # [rank][group] -> source
    # two-level hierarchy annotation (None/() when planned flat): the
    # per-class link class, the inter-tier coalescing bundles, and the
    # topology that derived them (hashable; keys the plan fingerprint)
    link_classes: Optional[Tuple[str, ...]] = None
    tier_bundles: Tuple[Tuple[int, ...], ...] = ()
    topology: Optional[Topology] = None
    # per-class *effective* (stream) lengths for the length-aware
    # "varlen" schedule — () when no payload probe annotated the plan.
    # stream_bytes[g] <= groups[g].nbytes always; a class whose payload
    # cannot truncate (multi-transfer group, stored-mode stream, or a
    # strategy without varlen support) carries its full capacity here.
    stream_bytes: Tuple[int, ...] = ()

    @property
    def ngroups(self) -> int:
        return len(self.groups)

    @property
    def wire_ops(self) -> int:
        """Collectives the schedule issues.  ``tiered`` issues one
        send per intra class, one per tier bundle, and one
        correction hop per non-representative bundle member — which
        totals ``ngroups`` exactly like ``grouped``; the win is *which
        tier* the ops cross, not how many there are."""
        if self.schedule in ("ragged", "uniform"):
            return 1
        return len(self.groups)

    @property
    def correction_bytes(self) -> int:
        """Extra fast-tier bytes the ``tiered`` schedule re-transmits:
        every non-representative bundle member crosses the wire twice
        (once inside the coalesced slow-tier message, once on the
        intra-node correction hop)."""
        return sum(
            self.groups[g].nbytes for b in self.tier_bundles for g in b[1:]
        )

    @property
    def inter_messages(self) -> int:
        """Slow-tier messages per rank per exchange: what the 3072-rank
        regime is bought down by.  Each inter-crossing class is its own
        slow message under ``grouped`` (and still crosses to its own
        peer inside the fused collectives); ``tiered`` sends one per
        peer-node bundle.  0 when the plan was laid out flat."""
        if not self.link_classes:
            return 0
        n_inter = sum(1 for c in self.link_classes if c == "inter")
        if self.schedule == "tiered":
            return len(self.tier_bundles)
        return n_inter

    @property
    def effective_wire_bytes(self) -> int:
        """Sum of per-class stream lengths — what a length-aware
        transport would actually move.  Equals ``wire_bytes`` (the
        capacity) when the plan carries no stream annotation."""
        if not self.stream_bytes:
            return self.wire_bytes
        return sum(self.stream_bytes)

    @property
    def stream_ratio(self) -> float:
        """``effective_wire_bytes / wire_bytes`` — the achieved
        compression ratio of the probed payload (1.0 unannotated)."""
        if not self.wire_bytes:
            return 1.0
        return self.effective_wire_bytes / self.wire_bytes

    @property
    def issued_bytes(self) -> int:
        """Bytes the chosen schedule actually puts on the wire."""
        if self.schedule == "uniform":
            return self.nranks * self.seg_bytes
        if self.schedule == "tiered":
            return self.wire_bytes + self.correction_bytes
        if self.schedule == "varlen":
            return self.effective_wire_bytes
        return self.wire_bytes

    @property
    def padding_bytes(self) -> int:
        return max(0, self.issued_bytes - self.wire_bytes)

    def with_stream_bytes(self, stream: Tuple[int, ...]) -> "WirePlan":
        """Annotate the plan with per-class stream lengths (probed from
        a concrete payload) — attached *after* planning so the
        :func:`plan_wire` cache stays payload-independent.  Lengths are
        clamped to each class's capacity; a short tuple raises."""
        if len(stream) != self.ngroups:
            raise ValueError(
                f"stream_bytes needs one length per delta class "
                f"({self.ngroups}); got {len(stream)}"
            )
        clamped = tuple(
            min(int(s), g.nbytes) for s, g in zip(stream, self.groups)
        )
        return dataclasses.replace(self, stream_bytes=clamped)

    @property
    def class_cum_bytes(self) -> Tuple[int, ...]:
        """Cumulative wire bytes through each delta class, in issue
        order.  Under the grouped schedule the k-th per-class collective
        cannot complete before every earlier class's bytes have been on
        the wire, so ``class_cum_bytes[k]`` is the byte term of class
        ``k``'s completion time (``PerfModel.price_class_completions``);
        fused schedules complete all classes together at
        ``issued_bytes``."""
        out, cum = [], 0
        for grp in self.groups:
            cum += grp.nbytes
            out.append(cum)
        return tuple(out)

    @property
    def fingerprint(self) -> str:
        """Stable content hash of the layout (keys DecisionCache rows
        for exchange pricing, as ``CommittedType.fingerprint`` keys
        per-type selections)."""
        fp = self.__dict__.get("_fingerprint")
        if fp is None:
            key = (
                "wireplan.v1",
                self.nranks,
                self.schedule,
                tuple((s.fingerprint, s.offset, s.nbytes) for s in self.segments),
                tuple(g.perm for g in self.groups),
            )
            if self.topology is not None:
                # appended only when a topology annotated the plan, so
                # every pre-hierarchy fingerprint (and its pinned
                # decision rows) survives unchanged
                key = key + (self.topology.fingerprint,)
            if self.stream_bytes:
                # likewise: stream lengths key the fingerprint only on
                # probe-annotated plans, so a pinned varlen row is
                # specific to the payload shape it was probed on
                key = key + (self.stream_bytes,)
            fp = hashlib.sha256(repr(key).encode()).hexdigest()[:16]
            object.__setattr__(self, "_fingerprint", fp)
        return fp


def _choose_schedule(
    nranks: int,
    ngroups: int,
    fused: bool,
    wire_bytes: int,
    uniform_bytes: int,
    uniform_waste_tolerance: float,
    native: bool,
    rank_factor: float,
) -> str:
    """The fallback ladder described in the module docstring."""
    if ngroups and nranks > rank_factor * ngroups:
        # grid-size threshold: most fused rows would be zero (or, for
        # the native ragged op, dead per-peer metadata) — per-class
        # sends win outright on large grids
        return "grouped"
    if native and fused:
        return "ragged"
    if fused and wire_bytes > 0:
        waste = (uniform_bytes - wire_bytes) / wire_bytes
        if waste <= uniform_waste_tolerance:
            return "uniform"
    return "grouped"


@functools.lru_cache(maxsize=256)
def plan_wire(
    sizes: Tuple[int, ...],
    perms: Tuple[Tuple[Tuple[int, int], ...], ...],
    fingerprints: Optional[Tuple[str, ...]] = None,
    uniform_waste_tolerance: float = 0.0,
    native: bool = False,
    rank_factor: float = GROUPED_FALLBACK_RANK_FACTOR,
    topology: Optional[Topology] = None,
) -> WirePlan:
    """Lay ``len(sizes)`` transfers (one full permutation each) out as an
    exact-byte wire plan.  ``sizes[i]`` is transfer ``i``'s wire-segment
    extent (the selected strategy's exact wire bytes); ``fingerprints``
    optionally carries the committed types' content hashes into the
    segment descriptors.

    ``topology`` (hashable, rides the plan cache) annotates the plan
    with per-class link classes and inter-tier coalescing bundles; it is
    ignored — the plan stays flat — when its rank count does not match
    the permutations' (e.g. a single-host test mesh planned against a
    production topology)."""
    n = len(perms)
    if len(sizes) != n:
        raise ValueError("sizes and perms must align")
    ranks = sorted({s for p in perms for s, _ in p})
    nranks = len(ranks)
    if ranks != list(range(nranks)):
        raise ValueError("perms must cover ranks 0..R-1")
    dst: List[Dict[int, int]] = []
    src: List[Dict[int, int]] = []
    for i, p in enumerate(perms):
        d = dict(p)
        if sorted(d) != ranks or sorted(d.values()) != ranks:
            raise ValueError(f"perm {i} is not a permutation of the ranks")
        dst.append(d)
        src.append({v: k for k, v in d.items()})

    # group transfers by their full destination vector (rank-uniform)
    key_to_group: Dict[Tuple[int, ...], int] = {}
    members_per_group: List[List[int]] = []
    for i in range(n):
        key = tuple(dst[i][r] for r in range(nranks))
        g = key_to_group.setdefault(key, len(members_per_group))
        if g == len(members_per_group):
            members_per_group.append([])
        members_per_group[g].append(i)
    ngroups = len(members_per_group)

    fps = fingerprints or ("",) * n
    groups: List[WireGroup] = []
    group_offsets: List[int] = []
    seg_list: List[Optional[WireSegment]] = [None] * n
    flat = 0
    for members in members_per_group:
        offs, acc = [], 0
        for i in members:
            offs.append(acc)
            seg_list[i] = WireSegment(
                fingerprint=fps[i], offset=flat + acc, nbytes=sizes[i]
            )
            acc += sizes[i]
        groups.append(
            WireGroup(
                transfers=tuple(members),
                offsets=tuple(offs),
                nbytes=acc,
                perm=tuple((r, dst[members[0]][r]) for r in range(nranks)),
            )
        )
        group_offsets.append(flat)
        flat += acc
    seg_bytes = max((g.nbytes for g in groups), default=0)

    # per-rank uniform-collective tables (destination-ordered rows)
    send_rows, recv_rows = [], []
    fused = ngroups <= nranks
    for r in range(nranks):
        dests = [dst[g.transfers[0]][r] for g in groups]
        if len(set(dests)) != ngroups:
            fused = False
        row = [ngroups] * nranks  # ngroups = the zero dummy row
        for g, d in enumerate(dests):
            row[d] = g
        send_rows.append(tuple(row))
        recv_rows.append(tuple(src[g.transfers[0]][r] for g in groups))

    schedule = _choose_schedule(
        nranks,
        ngroups,
        fused,
        flat,
        nranks * seg_bytes,
        uniform_waste_tolerance,
        native,
        rank_factor,
    )
    link_classes: Optional[Tuple[str, ...]] = None
    tier_bundles: Tuple[Tuple[int, ...], ...] = ()
    if topology is not None and topology.nranks == nranks:
        link_classes, tier_bundles = classify_and_coalesce(
            tuple(
                tuple(dst[g.transfers[0]][r] for r in range(nranks))
                for g in groups
            ),
            topology,
        )
    else:
        topology = None
    return WirePlan(
        nranks=nranks,
        groups=tuple(groups),
        segments=tuple(seg_list),
        group_offsets=tuple(group_offsets),
        schedule=schedule,
        fused=fused,
        wire_bytes=flat,
        seg_bytes=seg_bytes,
        send_rows=tuple(send_rows),
        recv_rows=tuple(recv_rows),
        link_classes=link_classes,
        tier_bundles=tier_bundles,
        topology=topology,
    )


def reschedule(plan: WirePlan, schedule: str) -> WirePlan:
    """The same layout under a different wire schedule.

    The segment layout, groups, and byte accounting are schedule-
    independent; only the transport differs — so a model-priced schedule
    choice (``PerfModel.choose_wire_schedule``) swaps the schedule
    without replanning.  ``ragged``/``uniform`` require a fused plan
    (group -> peer injective per rank); the returned plan's fingerprint
    and ``issued_bytes`` reflect the new schedule.
    """
    if schedule == plan.schedule:
        return plan
    if schedule not in WIRE_SCHEDULES:
        raise ValueError(f"unknown wire schedule {schedule!r}")
    if schedule in ("ragged", "uniform") and not plan.fused:
        raise ValueError(
            f"schedule {schedule!r} needs a fused plan (group->peer "
            "injective per rank)"
        )
    if schedule == "tiered" and plan.link_classes is None:
        raise ValueError(
            "schedule 'tiered' needs a topology-annotated plan "
            "(plan_wire(..., topology=...))"
        )
    if schedule == "varlen" and len(plan.stream_bytes) != plan.ngroups:
        raise ValueError(
            "schedule 'varlen' needs a stream-annotated plan "
            "(WirePlan.with_stream_bytes, one probed length per class)"
        )
    return dataclasses.replace(plan, schedule=schedule)


# ===========================================================================
# payload accounting (tests + CI regression gate)
# ===========================================================================

def collective_payload_bytes(fn, *args) -> Dict[str, int]:
    """Run ``fn(*args)`` once and total the bytes a rank put on the wire
    in every wire op the transports issued meanwhile, by primitive.

    Returns ``{"ops": <wire op count>, "total": <bytes>, <primitive>:
    <bytes>, ...}`` under :data:`WIRE_COLLECTIVES`' names, the reference's
    dict.  The reference traces ``fn`` and reads its jaxpr; here the
    transports count what they did (a grouped class is one ``ppermute``
    of its exact bytes, a uniform exchange one padded ``all_to_all``, a
    ragged one ``ragged_all_to_all``), so ``fn`` really runs."""
    counts: Dict[str, int] = {"ops": 0}
    RECORDERS.append(counts)
    try:
        fn(*args)
    finally:
        RECORDERS.remove(counts)
    counts["total"] = sum(v for k, v in counts.items() if k != "ops")
    return counts
