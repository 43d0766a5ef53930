"""``overlap``: the ``iterate`` loop's program iterations with the
exchange hidden behind the interior chain, as
``repro_torch.launch.stencil3d --overlap`` runs them: each call starts
the fused exchange on the communicator's side stream, computes the
interior chain beside it, waits, then computes the shell around each
chain block (``make_program_step(..., overlap=traffic["overlap"])``).

The system is :mod:`bench.loops.iterate`'s, built the same way, with
its step swapped for the overlapped one; the window, the end-to-end
metrics and the judge are that loop's own, so the two loops' cells
read the same clocks against the same reference.
"""

from __future__ import annotations

from typing import Dict

from bench.loops import iterate
from bench.loops.iterate import end_to_end, judge, window
from bench.system import System

__all__ = ["build", "window", "end_to_end", "judge"]


def build(config: Dict, traffic: Dict, device, seed: int) -> System:
    from repro_torch.halo import make_program_step

    system = iterate.build(config, traffic, device, seed)
    system._step = make_program_step(system.program, system.comm, device=system.device,
                                     overlap=traffic["overlap"])
    return system
