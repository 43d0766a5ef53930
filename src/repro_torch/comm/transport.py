"""Wire transports: what puts packed bytes on the link.

The reference moves bytes with ``lax.ppermute`` / ``all_to_all`` /
``ragged_all_to_all`` inside ``shard_map``.  A transport is the port's
counterpart: it takes the flat ``(R, total)`` wire buffer of a
:class:`~repro_torch.comm.wireplan.WirePlan` and returns, per delta
class, the ``(R, nbytes)`` payload every rank received — row ``r`` is
what rank ``r`` got.  It counts the wire ops and the bytes it issues
(per rank, the unit of ``WirePlan.wire_bytes``), so byte accounting is
what the transport did, not what the plan promised.

This slice has one backend, :class:`LocalMeshTransport`: all R ranks
live in one process on one device as the leading dimension of one
tensor, and every wire op is an on-device copy.  That runs the 8-rank
halo exchange on one card (and on the CPU in the tests).  A backend with
one process per rank (``torch.distributed``, NCCL or gloo) implements the
same two methods on the rank's own row; it is not in this slice.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["LocalMeshTransport"]


class LocalMeshTransport:
    """R ranks as the leading dimension of one tensor on one device.

    ``native_ragged`` is False: on the local mesh a ragged all-to-all
    costs the same copies as the grouped schedule, so the exact schedule
    ladder is not steered to it (it still runs a plan rescheduled to
    ``ragged`` explicitly).
    """

    native_ragged = False

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.ops = 0    # wire ops issued
        self.bytes = 0  # bytes each rank put on the wire
        self._ragged_index: Tuple = (None, None)
        # a plan's row-index tensors, made on the device once: a copy
        # from host memory on every call would synchronize the stream
        # it runs on, so the host could not run ahead of the device
        self._plan_index: Dict[Tuple, Tuple[torch.Tensor, ...]] = {}

    def _count(self, nbytes: int) -> None:
        self.ops += 1
        self.bytes += nbytes

    def _rows(self, table, device) -> torch.Tensor:
        return torch.as_tensor(table, dtype=torch.long, device=device)

    def _index(self, plan, device) -> Tuple[torch.Tensor, ...]:
        """The plan's index tensors on ``device``, made once per plan:
        per delta class, the source rank of every row (grouped); or the
        send and receive row tables (uniform)."""
        key = (plan.fingerprint, plan.schedule, str(device))
        index = self._plan_index.get(key)
        if index is None:
            if plan.schedule == "grouped":
                tables = [[row[g] for row in plan.recv_rows] for g in range(plan.ngroups)]
            else:
                tables = [plan.send_rows, plan.recv_rows]
            index = tuple(self._rows(t, device) for t in tables)
            self._plan_index[key] = index
        return index

    def permute(self, payload: torch.Tensor, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """One permutation send: rank ``src`` sends its row to ``dst``
        for every edge of ``perm``.  Returns the received ``(R, n)``."""
        src = [0] * payload.shape[0]
        for s, d in perm:
            src[d] = s
        self._count(payload.shape[1])
        return payload.index_select(0, self._rows(src, payload.device))

    def exchange(self, wire: torch.Tensor, plan,
                 on_class: Optional[Callable[[int], None]] = None) -> List[torch.Tensor]:
        """Put ``wire`` (``(R, plan.wire_bytes)`` uint8) on the link with
        the plan's schedule; returns one received payload per delta
        class (exact ``nbytes`` wide, or the padded uniform row).
        ``on_class(g)`` is called once per class, right after the wire op
        that completes class ``g`` is issued (the grouped schedule's own
        op; the fused schedules' one op for every class)."""
        sched = plan.schedule
        if sched == "grouped":
            out = []
            index = self._index(plan, wire.device)
            for g, (goff, grp) in enumerate(zip(plan.group_offsets, plan.groups)):
                self._count(grp.nbytes)
                out.append(wire[:, goff : goff + grp.nbytes].index_select(0, index[g]))
                if on_class is not None:
                    on_class(g)
            return out
        if sched == "uniform":
            out = self._uniform(wire, plan)
        elif sched == "ragged":
            out = self._ragged(wire, plan)
        elif sched == "varlen":
            raise NotImplementedError(
                "the varlen schedule is not ported yet (ROADMAP Queue 1, compressed "
                "wire and the varlen schedule)"
            )
        elif sched == "tiered":
            raise NotImplementedError(
                "the tiered schedule is not ported yet (ROADMAP Queue 1, hierarchy "
                "and scale)"
            )
        else:
            raise ValueError(f"unknown wire schedule {sched!r}")
        if on_class is not None:
            for g in range(len(out)):
                on_class(g)
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
        self._count(R * seg)
        by_group = got[ranks, recv_rows]
        return [by_group[:, g] for g in range(G)]

    def _ragged(self, wire: torch.Tensor, plan) -> List[torch.Tensor]:
        # one gather of exactly the plan's bytes: byte j of rank r comes
        # from the rank that sends j's delta class to r.  The index holds
        # 8 bytes per wire byte, so this suits the small meshes where a
        # plan is rescheduled to ragged on purpose; it is kept per plan.
        key, index = self._ragged_index
        if key != (plan.fingerprint, str(wire.device)):
            total = plan.wire_bytes
            src = torch.empty((plan.nranks, total), dtype=torch.long)
            for g, (goff, grp) in enumerate(zip(plan.group_offsets, plan.groups)):
                for r in range(plan.nranks):
                    src[r, goff : goff + grp.nbytes] = plan.recv_rows[r][g]
            index = (src * total + torch.arange(total)).to(wire.device)
            self._ragged_index = ((plan.fingerprint, str(wire.device)), index)
        got = wire.reshape(-1)[index.reshape(-1)].view(plan.nranks, -1)
        self._count(plan.wire_bytes)
        return [
            got[:, goff : goff + grp.nbytes]
            for goff, grp in zip(plan.group_offsets, plan.groups)
        ]
