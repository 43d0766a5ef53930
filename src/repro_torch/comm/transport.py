"""Wire transports: what puts packed bytes on the link.

The reference moves bytes with ``lax.ppermute`` / ``all_to_all`` /
``ragged_all_to_all`` inside ``shard_map``.  A transport is the port's
counterpart.  The :class:`~repro_torch.comm.api.Communicator` uses it
through this interface:

``permute(payload, perm)``
    one permutation send of the ``(local_ranks, n)`` payload: global
    rank ``src`` sends its row to ``dst`` for every ``(src, dst)`` edge
    of ``perm``.  Returns the received ``(local_ranks, n)`` rows; a rank
    that no edge reaches receives zeros, as under ``lax.ppermute``.
``all_gather(rows)`` / ``all_to_all(rows)``
    the packed collectives: every rank receives every rank's
    ``(local_ranks, n)`` row (``(local_ranks, R, n)``, as under
    ``lax.all_gather``); and the ``(local_ranks, npeers, seg)`` rows
    split into R equal chunks along the peers, chunk ``c`` to rank ``c``,
    received in source-rank order (``lax.all_to_all``).  Each is one wire
    op and, as in the reference, adds no payload bytes to ``bytes``;
``exchange(wire, plan, on_class)``
    put the flat ``(local_ranks, plan.wire_bytes)`` wire buffer of a
    :class:`~repro_torch.comm.wireplan.WirePlan` on the link under the
    plan's schedule; returns, per delta class, the payload every local
    rank received.  ``on_class(g)`` is called once per class, after the
    op that completes class ``g`` is issued and ordered on the current
    stream.
``ops`` / ``bytes``
    the wire ops issued and the bytes each rank put on the wire (the
    unit of ``WirePlan.wire_bytes``), so byte accounting is what the
    transport did, not what the plan promised.
``native_ragged``
    whether a ragged all-to-all is one native op; the exact schedule
    ladder takes ``ragged`` only then.
``capturable``
    whether a call's wire ops may be captured into a CUDA graph and
    replayed (:meth:`~repro_torch.comm.api.Communicator.neighbor_alltoallv_init`):
    on-device copies may, collectives of a process group do not.
``local_ranks``
    how many ranks a buffer holds on its leading dimension: ``None`` on
    the local mesh, where a buffer holds every rank of the exchange, and
    1 for one process per rank.
``rank``
    the global rank of row 0.
``device``
    where the buffers live.
``agree(what, key)``
    raise unless every process holds the same ``key`` (a no-op within
    one process).

Two backends implement it: :class:`LocalMeshTransport` here, all R ranks
in one process on one device as the leading dimension of one tensor,
every wire op an on-device copy (the 8-rank halo exchange on one card,
and on the CPU in the tests); and
:class:`~repro_torch.comm.distributed.DistributedTransport`, one process
per rank through ``torch.distributed`` (NCCL on the card, gloo on the
CPU).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["LocalMeshTransport", "check_perm", "stream_sizes", "tier_members",
           "correction_perm"]


#: the byte counts of the open :func:`repro_torch.comm.wireplan.collective_payload_bytes`
#: calls, each ``{"ops": n, <primitive>: bytes, ...}``
RECORDERS: List[Dict[str, int]] = []


def record_wire(primitive: str, nbytes: int) -> None:
    """Count one wire op of ``nbytes`` bytes a rank under the primitive
    the reference's traced program names (``ppermute``, ``all_to_all``,
    ``ragged_all_to_all``) in every open recorder."""
    for counts in RECORDERS:
        counts["ops"] += 1
        counts[primitive] = counts.get(primitive, 0) + nbytes


def check_perm(perm: Sequence[Tuple[int, int]]) -> None:
    """Raise the reference's error (``lax.ppermute``'s, word for word)
    when a source or a destination repeats in ``perm``: such a send has
    no single meaning, and under one process per rank it would leave a
    send unmatched."""
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        edges = tuple((int(s), int(d)) for s, d in perm)
        raise ValueError(f"ppermute sources and destinations must be unique, got {edges}.")


def check_chunks(npeers: int, nranks: int) -> int:
    """Rows per chunk of an all-to-all over ``npeers`` rows and
    ``nranks`` ranks; raises unless they split evenly."""
    if npeers % nranks:
        raise ValueError(
            f"all_to_all splits {npeers} rows among {nranks} ranks: not a multiple")
    return npeers // nranks


def stream_sizes(plan) -> tuple:
    """Bytes each delta class ships under the ``varlen`` schedule: its
    probed stream length (a prefix of its capacity slot)."""
    if len(plan.stream_bytes) != plan.ngroups:
        raise ValueError("varlen schedule on a stream-unannotated plan")
    return plan.stream_bytes


def tier_members(plan) -> Dict[int, int]:
    """Under the ``tiered`` schedule, each bundled delta class -> its
    bundle's representative (the first member).  Raises on a plan that
    no topology annotated."""
    if plan.link_classes is None:
        raise ValueError("tiered schedule on an unannotated plan")
    return {g: b[0] for b in plan.tier_bundles for g in b}


def correction_perm(plan, g: int, g0: int) -> List[Tuple[int, int]]:
    """The intra-node correction hop of bundle member ``g`` whose bundle
    rode representative ``g0``'s permutation: rank ``r``'s class-``g``
    part landed on ``dst_g0(r)``, which forwards it to ``dst_g(r)``.  It
    composes two full permutations, so it is one too, over every rank,
    and its edges stay on one node (the bundle key)."""
    d0, dg = dict(plan.groups[g0].perm), dict(plan.groups[g].perm)
    return [(d0[r], dg[r]) for r in range(plan.nranks)]


class LocalMeshTransport:
    """R ranks as the leading dimension of one tensor on one device.

    ``native_ragged`` is False: on the local mesh a ragged all-to-all
    costs the same copies as the grouped schedule, so the exact schedule
    ladder is not steered to it (it still runs a plan rescheduled to
    ``ragged`` explicitly).
    """

    native_ragged = False
    capturable = True
    local_ranks = None
    rank = 0

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.ops = 0    # wire ops issued
        self.bytes = 0  # bytes each rank put on the wire
        # a plan's index tensors, made on the device once and kept: a
        # copy from host memory on every call would synchronize the
        # stream it runs on, so the host could not run ahead of the
        # device, and a CUDA graph captured under a plan reads them by
        # address on every replay
        self._plan_index: Dict[Tuple, Tuple[torch.Tensor, ...]] = {}

    def _count(self, nbytes: int, primitive: str = "ppermute") -> None:
        self.ops += 1
        self.bytes += nbytes
        if RECORDERS:
            record_wire(primitive, nbytes)

    def _rows(self, table, device) -> torch.Tensor:
        return torch.as_tensor(table, dtype=torch.long, device=device)

    def _index(self, plan, device) -> Tuple[torch.Tensor, ...]:
        """The plan's index tensors on ``device``, made once per plan:
        per delta class, the source rank of every row (grouped, varlen;
        under tiered, a non-representative bundle member's correction
        hop); the send and receive row tables (uniform); or the flat
        source byte of every received byte (ragged)."""
        key = (plan.fingerprint, plan.schedule, str(device))
        index = self._plan_index.get(key)
        if index is None and plan.schedule == "ragged":
            total = plan.wire_bytes
            src = torch.empty((plan.nranks, total), dtype=torch.long)
            for g, (goff, grp) in enumerate(zip(plan.group_offsets, plan.groups)):
                for r in range(plan.nranks):
                    src[r, goff : goff + grp.nbytes] = plan.recv_rows[r][g]
            index = self._plan_index[key] = ((src * total + torch.arange(total)).to(device),)
        elif index is None:
            if plan.schedule in ("grouped", "varlen"):
                tables = [[row[g] for row in plan.recv_rows] for g in range(plan.ngroups)]
            elif plan.schedule == "tiered":
                rep = tier_members(plan)
                tables = []
                for g in range(plan.ngroups):
                    src = [row[g] for row in plan.recv_rows]
                    if rep.get(g, g) != g:
                        src = [0] * plan.nranks
                        for s, d in correction_perm(plan, g, rep[g]):
                            src[d] = s
                    tables.append(src)
            else:
                tables = [plan.send_rows, plan.recv_rows]
            index = tuple(self._rows(t, device) for t in tables)
            self._plan_index[key] = index
        return index

    def agree(self, what: str, key: str) -> None:
        """Every rank lives in this process: they agree."""

    def permute(self, payload: torch.Tensor, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """One permutation send: rank ``src`` sends its row to ``dst``
        for every edge of ``perm``.  Returns the received ``(R, n)``; a
        rank that no edge reaches gets a zero row."""
        check_perm(perm)
        src: List[Optional[int]] = [None] * payload.shape[0]
        for s, d in perm:
            src[d] = s
        self._count(payload.shape[1])
        out = payload.index_select(
            0, self._rows([0 if s is None else s for s in src], payload.device))
        missing = [r for r, s in enumerate(src) if s is None]
        if missing:
            out[missing] = 0
        return out

    def all_gather(self, rows: torch.Tensor) -> torch.Tensor:
        """Every rank receives every rank's row: ``(R, n)`` ->
        ``(R, R, n)``."""
        self.ops += 1
        return rows.unsqueeze(0).expand(rows.shape[0], *rows.shape).contiguous()

    def all_to_all(self, rows: torch.Tensor) -> torch.Tensor:
        """``(R, npeers, seg)``: rank ``r``'s chunk ``c`` (``npeers / R``
        rows) goes to rank ``c``, which holds what it received in source
        order — a transpose of the ``(R, R)`` chunk grid."""
        R, npeers = rows.shape[0], rows.shape[1]
        k = check_chunks(npeers, R)
        self.ops += 1
        if RECORDERS:
            record_wire("all_to_all", rows[0].numel() * rows.element_size())
        chunks = rows.reshape(R, R, k, *rows.shape[2:])
        return chunks.transpose(0, 1).reshape(rows.shape).contiguous()

    def exchange(self, wire: torch.Tensor, plan,
                 on_class: Optional[Callable[[int], None]] = None) -> List[torch.Tensor]:
        """Put ``wire`` (``(R, plan.wire_bytes)`` uint8) on the link with
        the plan's schedule; returns one received payload per delta
        class (exact ``nbytes`` wide, the ``varlen`` stream prefix, or the
        padded uniform row).  ``on_class(g)`` is called once per class,
        right after the wire op that completes class ``g`` is issued (the
        per-class schedules' own op; the fused schedules' one op for every
        class)."""
        sched = plan.schedule
        if sched in ("grouped", "varlen"):
            sizes = (stream_sizes(plan) if sched == "varlen"
                     else [grp.nbytes for grp in plan.groups])
            out = []
            index = self._index(plan, wire.device)
            for g, (goff, n) in enumerate(zip(plan.group_offsets, sizes)):
                self._count(n)
                out.append(wire[:, goff : goff + n].index_select(0, index[g]))
                if on_class is not None:
                    on_class(g)
            return out
        if sched == "tiered":
            return self._tiered(wire, plan, on_class)
        if sched == "uniform":
            out = self._uniform(wire, plan)
        elif sched == "ragged":
            out = self._ragged(wire, plan)
        else:
            raise ValueError(f"unknown wire schedule {sched!r}")
        if on_class is not None:
            for g in range(len(out)):
                on_class(g)
        return out

    def _tiered(self, wire: torch.Tensor, plan,
                on_class: Optional[Callable[[int], None]]) -> List[torch.Tensor]:
        # each class that rides no bundle is one gather, as under grouped;
        # each bundle is one gather of its members' slots, concatenated,
        # along the representative's permutation; each other member then
        # takes one intra-node correction gather to its true rank
        rep = tier_members(plan)
        index = self._index(plan, wire.device)

        def slot(g):
            goff = plan.group_offsets[g]
            return wire[:, goff : goff + plan.groups[g].nbytes]

        def done(g, rows):
            out[g] = rows
            if on_class is not None:
                on_class(g)

        out: List[Optional[torch.Tensor]] = [None] * plan.ngroups
        for g in range(plan.ngroups):
            if g not in rep:
                self._count(plan.groups[g].nbytes)
                done(g, slot(g).index_select(0, index[g]))
        for b in plan.tier_bundles:
            payload = torch.cat([slot(g) for g in b], 1) if len(b) > 1 else slot(b[0])
            self._count(payload.shape[1])
            got = payload.index_select(0, index[b[0]])
            off = 0
            for g in b:
                n = plan.groups[g].nbytes
                part = got[:, off : off + n]
                off += n
                if g != b[0]:
                    self._count(n)
                    part = part.index_select(0, index[g])
                done(g, part)
        return out

    def _uniform(self, wire: torch.Tensor, plan) -> List[torch.Tensor]:
        # destination-ordered rows padded to seg_bytes, plus the zero
        # dummy row, then one all-to-all: a transpose of (R, R, seg)
        R, G, seg = plan.nranks, plan.ngroups, plan.seg_bytes
        stacked = torch.zeros((R, G + 1, seg), dtype=torch.uint8, device=wire.device)
        for g, (goff, grp) in enumerate(zip(plan.group_offsets, plan.groups)):
            stacked[:, g, : grp.nbytes] = wire[:, goff : goff + grp.nbytes]
        send_rows, recv_rows = self._index(plan, wire.device)
        ranks = torch.arange(R, device=wire.device).view(-1, 1)
        sendbuf = stacked[ranks, send_rows]
        got = sendbuf.transpose(0, 1).contiguous()
        self._count(R * seg, "all_to_all")
        by_group = got[ranks, recv_rows]
        return [by_group[:, g] for g in range(G)]

    def _ragged(self, wire: torch.Tensor, plan) -> List[torch.Tensor]:
        # one gather of exactly the plan's bytes: byte j of rank r comes
        # from the rank that sends j's delta class to r.  The index holds
        # 8 bytes per wire byte, so this suits the small meshes where a
        # plan is rescheduled to ragged on purpose; it is kept per plan.
        (index,) = self._index(plan, wire.device)
        got = wire.reshape(-1)[index.reshape(-1)].view(plan.nranks, -1)
        self._count(plan.wire_bytes, "ragged_all_to_all")
        return [
            got[:, goff : goff + grp.nbytes]
            for goff, grp in zip(plan.group_offsets, plan.groups)
        ]
