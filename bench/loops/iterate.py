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
(:func:`bench.reference.judge_iterate`).
"""

from __future__ import annotations

import time
from typing import Dict

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
