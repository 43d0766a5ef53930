"""Clocks of the measured window: host time, and on the card CUDA events
read after the window."""

from __future__ import annotations

import math
import time
from typing import List, Sequence

import torch

__all__ = ["Marks", "p95", "sync"]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def p95(values: Sequence[float]) -> float:
    """The 95th percentile of every value, nearest rank: the least value
    that at least 95% of the values do not exceed."""
    if not values:
        raise ValueError("no samples")
    ordered = sorted(values)
    return ordered[max(math.ceil(0.95 * len(ordered)), 1) - 1]


class Marks:
    """Points in the device's stream (CUDA events on the card, the host
    clock on the CPU), read only after the window: :meth:`intervals_ms`
    gives the time between consecutive marks, the first from the mark
    made at construction."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self._marks: List[object] = []
        self.mark()

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._marks.append(ev)
        else:
            self._marks.append(time.perf_counter())

    def intervals_ms(self) -> List[float]:
        m = self._marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]
