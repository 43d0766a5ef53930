"""Faults that a halo cell's timed path can have, planted under a whole
run of the cell: each has to turn ``correct`` false.

* ``unchanged``: a call that returns the state as it was;
* ``half_the_ranks``: half of the ranks' blocks left as they were;
* ``wire_left_out``: the transport delivers zeros instead of the rows;
* ``one_cell_altered``: one interior cell of rank 0 off by one after a call;
* ``stale_halo``: every call after the first receives the rows of the
  call before it, the fault a captured or reordered exchange risks.

``bench/test_bench_faults.py`` runs each at a tiny size on the CPU;
``bench/control.py --fault`` runs one at a cell's own size on the card.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator

import torch

from bench.system import System

__all__ = ["FAULTS", "planted"]

FAULTS = ("unchanged", "half_the_ranks", "wire_left_out", "one_cell_altered", "stale_halo")


def _unchanged(step):
    def fault(self):
        self.calls += 1
    return fault


def _half_the_ranks(step):
    def fault(self):
        buf = self.state
        keep = buf[buf.shape[0] // 2:].clone()
        step(self)
        buf[buf.shape[0] // 2:] = keep
    return fault


def _one_cell_altered(step):
    def fault(self):
        buf = self.state
        step(self)
        rz, ry, rx = self.radii
        buf[0, rz, ry + 1, rx + 2] += 1.0
    return fault


def _wire_left_out(exchange):
    def fault(self, wire, plan, on_class=None):
        return [torch.zeros_like(rows) for rows in exchange(self, wire, plan, on_class)]
    return fault


def _stale_halo(exchange):
    def fault(self, wire, plan, on_class=None):
        rows = exchange(self, wire, plan, on_class)
        before = getattr(self, "_bench_stale_rows", None)
        self._bench_stale_rows = [r.clone() for r in rows]
        return rows if before is None else before
    return fault


_ON_STEP = {"unchanged": _unchanged, "half_the_ranks": _half_the_ranks,
            "one_cell_altered": _one_cell_altered}
_ON_WIRE = {"wire_left_out": _wire_left_out, "stale_halo": _stale_halo}


@contextmanager
def planted(name: str) -> Iterator[None]:
    """Run the block with fault ``name`` planted in every call."""
    if name in _ON_STEP:
        owner, attr, make = System, "step", _ON_STEP[name]
    elif name in _ON_WIRE:
        from repro_torch.comm.transport import LocalMeshTransport

        owner, attr, make = LocalMeshTransport, "exchange", _ON_WIRE[name]
    else:
        raise ValueError(f"unknown fault {name!r}; expected one of {FAULTS}")
    real = owner.__dict__[attr]
    setattr(owner, attr, make(real))
    try:
        yield
    finally:
        setattr(owner, attr, real)
