"""``iterate``: deep-halo program iterations back to back, as
``repro_torch.launch.stencil3d`` runs them: one fused exchange and the
program's ``steps`` passes of the op cycle each, nothing synchronized
inside the window, the window closed by a device synchronization.

``iteration_ms`` is the window over the iterations it completed;
``iteration_p95_ms`` the 95th percentile of the device's time between
consecutive iteration ends (CUDA events, read after the window).  What
is judged is every rank's interior after every call made, warm-up
included, against ``calls * steps`` passes of the cycle over the
periodic global field, over the largest value that survives
(:func:`bench.reference.judge_iterate`).  Its control is those passes
computed by the reference in a precision below float32
(:data:`bench.reference.CONTROLS`), cut into the ranks' interiors and
judged alike.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from bench import reference, timing
from bench.system import System


def build(config: Dict, traffic: Dict, device, seed: int) -> System:
    return System(config, "iterate", device, seed)


def window(system: System, seconds: float) -> Dict:
    """Iterate for ``seconds``."""
    marks = timing.Marks(system.device)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    n = 0
    while n == 0 or time.perf_counter() < deadline:
        system.step()
        marks.mark()
        n += 1
    timing.sync(system.device)
    return {"calls": n, "window_s": time.perf_counter() - t0,
            "per_call_ms": marks.intervals_ms()}


def end_to_end(stats: Dict) -> Dict[str, float]:
    return {"iteration_ms": stats["window_s"] * 1e3 / stats["calls"],
            "iteration_p95_ms": timing.p95(stats["per_call_ms"])}


def judge(system: System, output, seed: int) -> Dict[str, float]:
    return reference.judge_iterate(output, seed, system.grid, system.ops,
                                   system.calls * system.steps)


def control(config: Dict, traffic: Dict, seed: int, passes: int, device,
            control: str) -> Dict[str, float]:
    """:func:`judge`'s numbers for ``passes`` passes of the cycle over the
    periodic global field, computed by :func:`bench.reference.stencil_direct`
    in the control's precision."""
    dtype, coef_dtype = reference.CONTROLS[control]
    grid, n = tuple(config["grid"]), tuple(config["interior"])
    ops = [(tuple(o["radii"]), float(o["weight"])) for o in config["ops"]]
    low = reference.global_field(seed, grid, n, device).to(dtype)
    out = reference.stencil_direct(low, ops, passes, dtype, coef_dtype)
    del low
    pz, py, px = grid
    interiors = torch.stack([
        out[cz * n[0]:(cz + 1) * n[0], cy * n[1]:(cy + 1) * n[1], cx * n[2]:(cx + 1) * n[2]]
        for cz in range(pz) for cy in range(py) for cx in range(px)]).float()
    del out
    return reference.judge_iterate(interiors, seed, grid, ops, passes)
