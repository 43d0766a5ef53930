"""One process per rank: the wire through ``torch.distributed``.

:class:`DistributedTransport` is the second backend of the transport
interface (``repro_torch.comm.transport``).  Each process holds its own
rank's buffers, so their leading dimension is 1 (``local_ranks``), and
every wire op is a collective or a pair of point-to-point ops of the
process group: NCCL on the card, gloo on the CPU.  It maps the
reference's ``_issue_wire`` (``repro.comm.api``) one schedule at a time:

``grouped``  one ``batch_isend_irecv`` per delta class: send to this
             rank's destination under the class's permutation and
             receive from ``plan.recv_rows[rank][g]`` (``lax.ppermute``);
``uniform``  one ``all_to_all_single`` over the ``(R, seg_bytes)``
             destination-ordered rows, the zero row where this rank
             sends nothing (``lax.all_to_all``);
``ragged``   one ``all_to_all_single`` with input and output split sizes,
             the MPI_Alltoallv shape (``ragged_all_to_all``), so
             ``native_ragged`` is True;
``varlen``   the same with each class's probed stream length as its
             split size on a fused plan, else one pair per class as
             ``grouped`` cut at the stream lengths;
``tiered``   one pair per class that rides no tier bundle, as
             ``grouped``; one pair per bundle carrying its members'
             payloads concatenated, to the representative's destination
             (the right peer node); then one pair per other member, the
             intra-node correction hop that forwards its part to its true
             rank;
``permute``  one ``batch_isend_irecv`` to this rank's destination and
             from its source; a rank that no edge reaches gets zeros;
             a permutation whose sources or destinations repeat raises
             on every rank before any op is issued;
packed collectives  ``all_gather_into_tensor`` and ``all_to_all_single``
             (``lax.all_gather`` / ``lax.all_to_all``).

Every op is issued with ``async_op`` and waited on at once.  Under NCCL
``Work.wait()`` makes the current stream wait for the op without
blocking the host, so ``on_class(g)`` runs after the current stream is
ordered behind class ``g``: an event recorded there completes only once
the payload has landed.  Under gloo the wait blocks until the bytes are
there.

gloo has no connection from a process to itself, so under gloo a self
edge (a periodic grid one rank wide) is an on-device copy, counted as
the op it stands for.  Under NCCL a self edge is a real send and
receive.

``ops`` and ``bytes`` count per process; for the same plan they equal
the local mesh's figures, which are per rank, except that a fused
``varlen`` plan is one op here and one per class there.
"""

from __future__ import annotations

import hashlib
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.comm.transport import (RECORDERS, check_chunks, check_perm, correction_perm,
                                        record_wire, stream_sizes, tier_members)
from repro_torch.device import resolve_device

__all__ = ["DistributedTransport", "BACKEND_DEVICE", "check_backend_device"]

#: the device type each backend moves
BACKEND_DEVICE = {"nccl": "cuda", "gloo": "cpu"}


def check_backend_device(backend: str, device: torch.device) -> None:
    """Raise unless ``backend`` moves tensors on ``device``'s type: NCCL
    only the card, gloo only the CPU.  Nothing swaps one for the other."""
    want = BACKEND_DEVICE.get(backend)
    if want is None:
        raise ValueError(f"unsupported backend {backend!r}; expected nccl or gloo")
    if device.type != want:
        raise ValueError(
            f"the {backend} backend moves {want} tensors; the device is {device}"
        )


class DistributedTransport:
    """This process's rank of a ``torch.distributed`` process group.

    ``group`` is the process group (``None``: the default group, which
    must be initialized); ``device`` is where this process's buffers
    live: its card under NCCL (default the current card), the CPU under
    gloo (the default there).  Its collectives are not captured into CUDA
    graphs (``capturable``).
    """

    native_ragged = True
    capturable = False
    local_ranks = 1

    def __init__(self, group=None, device=None):
        if not dist.is_initialized():
            raise RuntimeError(
                "torch.distributed is not initialized; see "
                "repro_torch.launch.procgroup.init_process_group"
            )
        self.group = group
        self.backend = str(dist.get_backend(group))
        if device is None:
            device = BACKEND_DEVICE.get(self.backend, "cpu")
        check_backend_device(self.backend, torch.device(device))
        self.device = resolve_device(device)
        self.rank = dist.get_rank(group)
        self.nranks = dist.get_world_size(group)
        # P2P ops name their peer by its rank in the default group
        self._global = [r if group is None else dist.get_global_rank(group, r)
                        for r in range(self.nranks)]
        self.ops = 0    # wire ops issued
        self.bytes = 0  # bytes this rank put on the wire

    def _count(self, nbytes: int, primitive: str = "ppermute") -> None:
        self.ops += 1
        self.bytes += nbytes
        if RECORDERS:
            record_wire(primitive, nbytes)

    def _check(self, rows: torch.Tensor, nranks: Optional[int] = None) -> None:
        if rows.dim() != 2 or rows.shape[0] != 1:
            raise ValueError(
                f"one process per rank: the payload must be (1, n), got {tuple(rows.shape)}")
        if rows.device != self.device:
            raise ValueError(f"payload on {rows.device}; transport on {self.device}")
        if nranks is not None and nranks != self.nranks:
            raise ValueError(
                f"the plan spans {nranks} ranks; the process group holds {self.nranks}")

    def _p2p(self, send: torch.Tensor, dst: Optional[int], recv: torch.Tensor,
             src: Optional[int]) -> list:
        """Issue this rank's half of one permutation: ``send`` to rank
        ``dst`` and ``recv`` from rank ``src`` (either may be None).
        Returns the works to wait on."""
        if dst == self.rank and self.backend == "gloo":
            recv.copy_(send)  # gloo has no pair to itself; src == dst == rank
            return []
        ops = []
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, send, self._global[dst], self.group))
        if src is not None:
            ops.append(dist.P2POp(dist.irecv, recv, self._global[src], self.group))
        return dist.batch_isend_irecv(ops) if ops else []

    @staticmethod
    def _wait(works) -> None:
        for w in works:
            w.wait()

    def agree(self, what: str, key: str) -> None:
        """Raise unless every rank of the group holds the same ``key``:
        one ``all_gather`` of its SHA-256 digest."""
        digest = torch.tensor(list(hashlib.sha256(key.encode()).digest()),
                              dtype=torch.uint8, device=self.device)
        every = [torch.empty_like(digest) for _ in range(self.nranks)]
        dist.all_gather(every, digest, group=self.group)
        every = [e.cpu() for e in every]
        others = [r for r in range(self.nranks) if not torch.equal(every[r], every[self.rank])]
        if others:
            raise RuntimeError(
                f"{what} differs across ranks: rank {self.rank} holds {key!r}, ranks "
                f"{others} hold another; every rank must build the same one"
            )

    def permute(self, payload: torch.Tensor, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """One permutation send of this rank's ``(1, n)`` row; returns the
        row received, zeros where no edge of ``perm`` reaches this rank.
        Every rank of the group calls it with the same ``perm``."""
        self._check(payload)
        check_perm(perm)
        payload = payload.contiguous()
        dst = src = None
        for s, d in perm:
            if s == self.rank:
                dst = d
            if d == self.rank:
                src = s
        out = torch.zeros_like(payload) if src is None else torch.empty_like(payload)
        works = self._p2p(payload[0], dst, out[0], src)
        self._count(payload.shape[1])
        self._wait(works)
        return out

    def all_gather(self, rows: torch.Tensor) -> torch.Tensor:
        """This rank's ``(1, n)`` row to every rank: returns ``(1, R, n)``,
        every rank's row in rank order."""
        self._check(rows)
        out = torch.empty((1, self.nranks, rows.shape[1]), dtype=rows.dtype,
                          device=rows.device)
        work = dist.all_gather_into_tensor(out.view(-1), rows.contiguous().view(-1),
                                           group=self.group, async_op=True)
        self.ops += 1
        self._wait([work])
        return out

    def all_to_all(self, rows: torch.Tensor) -> torch.Tensor:
        """This rank's ``(1, npeers, seg)`` rows: chunk ``c`` (``npeers /
        R`` rows) to rank ``c``; returns the chunks received, in source
        order, as ``(1, npeers, seg)``."""
        if rows.dim() < 2 or rows.shape[0] != 1:
            raise ValueError(
                f"one process per rank: the rows must be (1, npeers, ...), got "
                f"{tuple(rows.shape)}")
        check_chunks(rows.shape[1], self.nranks)
        send = rows.contiguous()
        out = torch.empty_like(send)
        work = dist.all_to_all_single(out.view(-1), send.view(-1), group=self.group,
                                      async_op=True)
        self.ops += 1
        if RECORDERS:
            record_wire("all_to_all", send.numel() * send.element_size())
        self._wait([work])
        return out

    def exchange(self, wire: torch.Tensor, plan,
                 on_class: Optional[Callable[[int], None]] = None) -> List[torch.Tensor]:
        """Put this rank's ``(1, plan.wire_bytes)`` wire on the link with
        the plan's schedule; returns one received ``(1, n)`` payload per
        delta class (exact ``nbytes`` wide, the ``varlen`` stream prefix, or
        the padded uniform row).  ``on_class(g)`` is called once per class,
        after the op that completes class ``g`` has been waited on.
        ``varlen`` is one all-to-all with the streams' split sizes on a
        fused plan, else one send/receive pair per class."""
        self._check(wire, plan.nranks)
        sched = plan.schedule
        sizes = [grp.nbytes for grp in plan.groups]
        if sched == "varlen":
            sizes = list(stream_sizes(plan))
            if plan.fused:
                sched = "ragged"
        if sched in ("grouped", "varlen"):
            out = []
            for g, (goff, grp, n) in enumerate(zip(plan.group_offsets, plan.groups, sizes)):
                recv = torch.empty((1, n), dtype=torch.uint8, device=wire.device)
                works = self._p2p(wire[0, goff : goff + n], dict(grp.perm)[self.rank],
                                  recv[0], plan.recv_rows[self.rank][g])
                self._count(n)
                self._wait(works)
                out.append(recv)
                if on_class is not None:
                    on_class(g)
            return out
        if sched == "tiered":
            return self._tiered(wire, plan, on_class)
        if sched == "uniform":
            out = self._uniform(wire, plan)
        elif sched == "ragged":
            out = self._ragged(wire, plan, sizes)
        else:
            raise ValueError(f"unknown wire schedule {sched!r}")
        if on_class is not None:
            for g in range(len(out)):
                on_class(g)
        return out

    def _tiered(self, wire: torch.Tensor, plan,
                on_class: Optional[Callable[[int], None]]) -> List[torch.Tensor]:
        # the reference's two-level transport, from this rank's side: the
        # bundle's receive must land before its parts are forwarded, so
        # each op is waited on before the next is issued
        rep = tier_members(plan)
        me = self.rank
        out: List[Optional[torch.Tensor]] = [None] * plan.ngroups

        def slot(g):
            goff = plan.group_offsets[g]
            return wire[0, goff : goff + plan.groups[g].nbytes]

        def send(payload, perm):
            dst = dict(perm)[me]
            src = next(s for s, d in perm if d == me)
            recv = torch.empty((1, payload.shape[0]), dtype=torch.uint8, device=wire.device)
            works = self._p2p(payload, dst, recv[0], src)
            self._count(payload.shape[0])
            self._wait(works)
            return recv

        def done(g, rows):
            out[g] = rows
            if on_class is not None:
                on_class(g)

        for g, grp in enumerate(plan.groups):
            if g not in rep:
                done(g, send(slot(g), grp.perm))
        for b in plan.tier_bundles:
            g0 = b[0]
            payload = torch.cat([slot(g) for g in b]) if len(b) > 1 else slot(g0)
            got = send(payload.contiguous(), plan.groups[g0].perm)
            off = 0
            for g in b:
                n = plan.groups[g].nbytes
                part = got[:, off : off + n]
                off += n
                if g != g0:
                    part = send(part[0].contiguous(), correction_perm(plan, g, g0))
                done(g, part)
        return out

    def _uniform(self, wire: torch.Tensor, plan) -> List[torch.Tensor]:
        # destination-ordered rows padded to seg_bytes, the zero row where
        # this rank sends nothing, then one all-to-all: row s of what
        # comes back is what rank s sent here
        R, G, seg = plan.nranks, plan.ngroups, plan.seg_bytes
        sendbuf = torch.zeros((R, seg), dtype=torch.uint8, device=wire.device)
        for d, g in enumerate(plan.send_rows[self.rank]):
            if g < G:
                goff, n = plan.group_offsets[g], plan.groups[g].nbytes
                sendbuf[d, :n] = wire[0, goff : goff + n]
        got = torch.empty_like(sendbuf)
        work = dist.all_to_all_single(got, sendbuf, group=self.group, async_op=True)
        self._count(R * seg, "all_to_all")
        self._wait([work])
        return [got[s : s + 1] for s in plan.recv_rows[self.rank]]

    def _ragged(self, wire: torch.Tensor, plan, sizes) -> List[torch.Tensor]:
        # MPI_Alltoallv: each destination's class at ``sizes[g]`` bytes
        # (its exact size, or its varlen stream), in destination order;
        # what arrives is in source order
        R, G = plan.nranks, plan.ngroups
        in_splits, parts = [0] * R, []
        for d, g in enumerate(plan.send_rows[self.rank]):
            if g < G:
                goff, n = plan.group_offsets[g], sizes[g]
                in_splits[d] = n
                parts.append(wire[0, goff : goff + n])
        send = torch.cat(parts) if parts else wire.new_empty((0,))
        recv_rows = plan.recv_rows[self.rank]
        out_splits = [0] * R
        for g, s in enumerate(recv_rows):
            out_splits[s] = sizes[g]
        got = torch.empty(sum(out_splits), dtype=torch.uint8, device=wire.device)
        work = dist.all_to_all_single(got, send, out_splits, in_splits, group=self.group,
                                      async_op=True)
        self._count(sum(sizes), "ragged_all_to_all")
        self._wait([work])
        starts = [sum(out_splits[:s]) for s in range(R)]
        return [got[starts[s] : starts[s] + sizes[g]].view(1, -1)
                for g, s in enumerate(recv_rows)]
