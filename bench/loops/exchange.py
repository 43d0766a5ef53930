"""``exchange``: blocking halo exchanges back to back, no stencil: each
call is the port's fused 26-neighbour ``neighbor_alltoallv`` of the
halo plan (``repro_torch.halo.make_halo_step``), ended by
``torch.cuda.synchronize()``, the blocking call's semantics.

The calls alternate between the traffic's ``buffers`` state buffers,
each seeded with a field of its own, as a double-buffered stencil code
exchanges: a halo that a call leaves stale, or fills from the other
buffer, shows.  ``exchange_ms`` is the window over the exchanges it
completed; ``exchange_p95_ms`` the 95th percentile of every exchange's
host-clock time.  What is judged is every cell of every rank's block in
every buffer, halo shells included, after the last call: the shells
start stale, so they must hold their buffer's periodic global field
(:func:`bench.reference.judge_exchange`).  Its control is each buffer's
blocks rebuilt by the reference from the field rounded to a precision
below float32 (:data:`bench.reference.CONTROLS`) and judged alike; it
makes no call, so it takes no passes.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from bench import reference, timing
from bench.system import System


def build(config: Dict, traffic: Dict, device, seed: int) -> System:
    return System(config, "exchange", device, seed, traffic["buffers"])


def window(system: System, seconds: float) -> Dict:
    """Exchange for ``seconds``."""
    dev = system.device
    per: List[float] = []
    t0 = end = time.perf_counter()
    deadline = t0 + seconds
    while not per or end < deadline:
        a = time.perf_counter()
        system.step()
        timing.sync(dev)
        end = time.perf_counter()
        per.append((end - a) * 1e3)
    return {"calls": len(per), "window_s": end - t0, "per_call_ms": per}


def end_to_end(stats: Dict) -> Dict[str, float]:
    return {"exchange_ms": stats["window_s"] * 1e3 / stats["calls"],
            "exchange_p95_ms": timing.p95(stats["per_call_ms"])}


def judge(system: System, output, seed: int) -> Dict[str, float]:
    return reference.judge_exchange(output, system.ranks, seed, system.grid, system.interior,
                                    system.radii)


def control(config: Dict, traffic: Dict, seed: int, passes: int, device,
            control: str) -> Dict[str, float]:
    """:func:`judge`'s numbers for every rank's block in each of the
    traffic's ``buffers``, halos included, built from the global field
    rounded to the control's state precision."""
    dtype, _ = reference.CONTROLS[control]
    grid, n = tuple(config["grid"]), tuple(config["interior"])
    radii = (config["radius"],) * 3
    ranks = list(range(grid[0] * grid[1] * grid[2]))
    blocks = []
    for b in range(traffic["buffers"]):
        g = reference.global_field(seed, grid, n, device, buffer=b).to(dtype).float()
        blocks.append(torch.stack([reference.expected_block(g, grid, r, radii) for r in ranks]))
        del g
    return reference.judge_exchange(torch.stack(blocks), ranks, seed, grid, n, radii)
