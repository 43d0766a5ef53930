"""DEPRECATED shim: the string-mode ``Interposer`` over the Communicator.

The interposer seam (paper §4) lives in :mod:`repro_torch.comm.api`: a
:class:`~repro_torch.comm.api.Communicator` with a pluggable strategy
registry, request-based transfers, and a fused neighborhood alltoallv.
This class is the reference's ``repro.comm.interposer.Interposer`` kept
for call sites written against it: every method delegates to an
underlying Communicator (exposed as ``.comm``), and the legacy ``mode``
strings map onto :class:`~repro_torch.comm.api.Policy` objects via
:func:`~repro_torch.comm.api.policy_for_mode`.  As on the port's
Communicator, the methods take no mesh axis name: the transport is the
communicator's (the local mesh on ``device``, the card unless
``device="cpu"``, or one given ``transport``).

Migration:

    Interposer(mode="tempi")     -> Communicator()
    Interposer(mode="baseline")  -> Communicator(policy=BaselinePolicy())
    Interposer(mode=<strategy>)  -> Communicator(policy=FixedPolicy(...))
    ip.sendrecv(...)             -> comm.sendrecv(...) (or isend/irecv)
    26x ip.sendrecv halo loop    -> comm.neighbor_alltoallv(...)
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.comm.api import Communicator, policy_for_mode
from repro_torch.comm.perfmodel import H100_ANALYTIC, SystemParams
from repro_torch.core.commit import CommittedType, TypeRegistry
from repro_torch.core.datatypes import Datatype

__all__ = ["Interposer", "Mode"]

Mode = str  # legacy alias; see repro_torch.comm.api.MODES for the valid names


class Interposer:
    """Deprecated facade over :class:`~repro_torch.comm.api.Communicator`.

    Parameters
    ----------
    mode: "tempi" (canonical kernels + model selection), "baseline"
        (per-block copies), or a forced strategy name for experiments.
    params: system parameter table for the performance model.
    device, transport: as for the Communicator.
    """

    def __init__(
        self,
        mode: Mode = "tempi",
        params: SystemParams = H100_ANALYTIC,
        registry: Optional[TypeRegistry] = None,
        device=None,
        transport=None,
    ):
        self.mode = mode
        self.comm = Communicator(
            params=params, registry=registry, policy=policy_for_mode(mode),
            device=device, transport=transport,
        )

    # -- state passthroughs -------------------------------------------
    @property
    def registry(self) -> TypeRegistry:
        return self.comm.registry

    @property
    def model(self):
        return self.comm.model

    # ------------------------------------------------------------------
    def commit(self, dt: Datatype) -> CommittedType:
        return self.comm.commit(dt)

    def _strategy(self, ct: CommittedType, incount: int, wire: bool) -> str:
        return self.comm.select(ct, incount, wire=wire).name

    def pack(self, buf: torch.Tensor, ct: CommittedType, incount: int = 1) -> torch.Tensor:
        return self.comm.pack(buf, ct, incount)

    def unpack(self, buf: torch.Tensor, packed: torch.Tensor, ct: CommittedType,
               incount: int = 1) -> torch.Tensor:
        return self.comm.unpack(buf, packed, ct, incount)

    def sendrecv(
        self,
        src_buf: torch.Tensor,
        dst_buf: torch.Tensor,
        send_ct: CommittedType,
        perm: Sequence[Tuple[int, int]],
        recv_ct: Optional[CommittedType] = None,
        incount: int = 1,
    ) -> torch.Tensor:
        return self.comm.sendrecv(src_buf, dst_buf, send_ct, perm, recv_ct, incount)

    def all_gather_packed(self, buf: torch.Tensor, ct: CommittedType,
                          incount: int = 1) -> torch.Tensor:
        return self.comm.all_gather_packed(buf, ct, incount)

    def all_to_all_packed(self, buf: torch.Tensor,
                          cts: Sequence[CommittedType]) -> torch.Tensor:
        return self.comm.all_to_all_packed(buf, cts)

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        return self.comm.stats()
