"""Model-priced gradient wire: the optimizer's gradient exchange routed
through a :class:`~repro_torch.comm.api.Communicator` as a committed
datatype (the port of the reference's ``repro.train.grad_wire``).

The gradients are flattened to one contiguous byte vector (each leaf's
:func:`~repro_torch.kernels.ops.byte_view`, in the dict's order),
committed once as ``Vector(1, n, n, BYTE)``, and planned with
:meth:`Communicator.plan_neighbor` using a **probe** of one rank's
concrete first-step gradient bytes, so a compressible payload can select
the lossless RLE wire and the ``varlen`` transport while a dense payload
stays on the plain wire.  The decision rows (``wire/varlen`` with
``stream_bytes=``/``ratio=``) are pinned and drift-audited like any
other.  Pass the leaves in the reference's tree order
(:meth:`~repro_torch.models.model.Model.trainable` gives it) and the
byte stream, hence the probed ratio, is the reference's.

On the local mesh the buffer is ``(nranks, n)`` uint8 with every rank
holding the same gradient, as under the reference's replicated
``shard_map``.  The exchange is a there-and-back ring rotation: each
rank ships its bytes to the next and receives them back on the return
hop, so a lossless wire is the identity on the gradients while the bytes
cross the planned, possibly compressed, schedule twice.  A one-rank ring
is two self-permutes through the same path.

Modes (:data:`GRAD_WIRE_MODES`): ``off`` (no wire: the gradients are
returned as given), ``auto`` (model-priced with the probe), ``rle``
(forced lossless RLE, probe-annotated) and ``int8`` (the opt-in lossy
wire, never probed or auto-picked).  The int8 wire quantizes float32
words, so under ``int8`` every leaf rides the wire widened to float32
and is narrowed back to its dtype after; the reference ships the raw
bytes, which reads a bf16 pair as one float32 word (ROADMAP Queue 3).
For float32 gradients the two are the same bytes.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from repro_torch.comm.compress import BLOCK_ELEMS
from repro_torch.core import BYTE, Vector
from repro_torch.kernels.ops import byte_view, unbyte_view

__all__ = ["GRAD_WIRE_MODES", "GradWire", "int8_block_bound"]

GRAD_WIRE_MODES: Tuple[str, ...] = ("off", "auto", "rle", "int8")

#: mode -> forced strategy name (None = model-priced selection)
_MODE_STRATEGY = {"auto": None, "rle": "rlewire", "int8": "int8wire"}


class GradWire:
    """Plan once from a concrete gradient sample, exchange every step.

    ``nranks`` is the ring size along the communicator's local mesh (1
    on one card: a self-permute ring, the same code path)."""

    def __init__(self, comm, mode: str = "auto", nranks: int = 1):
        if mode not in GRAD_WIRE_MODES:
            raise ValueError(f"unknown grad-wire mode {mode!r}; expected one of "
                             f"{GRAD_WIRE_MODES}")
        self.comm = comm
        self.mode = mode
        self.nranks = int(nranks)
        self._ct = None
        self._strats = None
        self._plan_fwd = None
        self._plan_back = None
        n = self.nranks
        self._fwd_perm = [[(i, (i + 1) % n) for i in range(n)]]
        self._back_perm = [[((i + 1) % n, i) for i in range(n)]]

    # -- planning --------------------------------------------------------
    @property
    def planned(self) -> bool:
        return self._plan_fwd is not None

    def _flat(self, grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """One rank's gradient bytes: the leaves' byte views, concatenated
        in order (widened to float32 under ``int8``)."""
        wide = self.mode == "int8"
        return torch.cat([byte_view((g.to(torch.float32) if wide else g).contiguous())
                          for g in grads.values()])

    def plan_for(self, grads: Mapping[str, torch.Tensor]) -> None:
        """Host-side planning from a concrete gradient dict (the first
        step's): commit the flat byte type, probe the payload, and
        record/pin both hops' wire decisions."""
        if self.mode == "off":
            return
        probe = self._flat(grads)
        n = int(probe.numel())
        self._ct = self.comm.commit(Vector(1, n, n, BYTE))
        name = _MODE_STRATEGY[self.mode]
        strategies = None if name is None else [self.comm.strategies.get(name)]
        # the int8 wire is lossy: it has no stream to probe, and "auto"
        # never reaches it
        use_probe = probe if self.mode != "int8" else None
        self._strats, self._plan_fwd = self.comm.plan_neighbor(
            [self._ct], self._fwd_perm, strategies=strategies, probe=use_probe)
        _, self._plan_back = self.comm.plan_neighbor(
            [self._ct], self._back_perm, strategies=list(self._strats), probe=use_probe)

    # -- the per-step exchange ------------------------------------------
    def _roundtrip(self, buf: torch.Tensor) -> torch.Tensor:
        ct = self._ct
        self.comm.neighbor_alltoallv(buf, [ct], [ct], self._fwd_perm,
                                     plan=self._plan_fwd, strategies=self._strats)
        return self.comm.neighbor_alltoallv(buf, [ct], [ct], self._back_perm,
                                            plan=self._plan_back, strategies=self._strats)

    def exchange(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Round-trip the gradient bytes through the planned wire:
        lossless modes return the leaves bit-exact, ``int8`` the
        quantize/dequantize round trip of each hop; ``off`` returns
        ``grads`` itself.  The leaves of the result are views into the
        received row of rank 0."""
        if self.mode == "off":
            return grads
        if not self.planned:
            self.plan_for(grads)
        flat = self._flat(grads)
        n = flat.numel()
        buf = flat.unsqueeze(0) if self.nranks == 1 else flat.expand(self.nranks, n).contiguous()
        row = self._roundtrip(buf)[0]
        wire_dtype = torch.float32 if self.mode == "int8" else None
        out, off = {}, 0
        for name, g in grads.items():
            dt = wire_dtype or g.dtype
            nb = g.numel() * dt.itemsize
            part = row[off:off + nb]
            if off % dt.itemsize:  # a view needs the leaf's alignment
                part = part.clone()
            out[name] = unbyte_view(part, dt, g.shape).to(g.dtype)
            off += nb
        return out

    # -- reporting -------------------------------------------------------
    def describe(self) -> str:
        if not self.planned:
            return f"grad-wire mode={self.mode} (unplanned)"
        p = self._plan_fwd
        return (f"grad-wire mode={self.mode} strategy={self._strats[0].name} "
                f"schedule={p.schedule} wire_bytes={p.wire_bytes} "
                f"issued={p.issued_bytes} ratio={p.stream_ratio:.4f} ring={self.nranks}")


def int8_block_bound(grads: Mapping[str, torch.Tensor],
                     block: int = BLOCK_ELEMS) -> Dict[str, torch.Tensor]:
    """The ``int8`` wire's own error bound, element by element, for the
    leaves ``grads`` in the order they ride the wire: two quantize hops
    of the ``block``-float block an element rides in (``2 (max|block| /
    127 + 1e-7)``, the reference test's bound taken per block), plus half
    a bf16 ulp (at most ``|g| 2**-8``) for a leaf narrowed back to bf16.
    Equal to the per-leaf bound where no block straddles two leaves."""
    flat = torch.cat([g.float().reshape(-1) for g in grads.values()])
    n = flat.numel()
    pad = torch.nn.functional.pad(flat.abs(), (0, -n % block)).view(-1, block)
    per = (2 * (pad.amax(1) / 127 + 1e-7)).repeat_interleave(block)[:n]
    del flat, pad
    out, off = {}, 0
    for k, g in grads.items():
        b = per[off:off + g.numel()].view(g.shape)
        if g.dtype == torch.bfloat16:
            b = b + g.float().abs() * 2.0 ** -8
        out[k] = b
        off += g.numel()
    return out
