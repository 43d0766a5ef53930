"""The traced run's device profile: ``torch.profiler`` over a window of
the cell's own loop, reduced to what the per-layer readers and the
result's ``device``/``breakdown`` take.

* ``busy_s``: the union of the intervals in which an operation ran on
  the device (kernels, copies, sets), so two streams at once count once;
  ``window_s``: the host's time over the profiled window, which ends in
  a device synchronization; the idle share is ``1 - busy_s / window_s``.
* ``device_s``: the device seconds of each operation, by name.
* ``idle_gaps``: the gaps between busy intervals, each charged to what
  the host was doing at the gap's middle: the innermost host operation
  running then, or ``host (no op)`` where none was.
* ``device_s_by_range``: the device seconds of each operation, by the
  innermost ``tempi.*`` range of the program's around its launch, or
  ``(no range)`` outside every range.  A device operation's ``id`` is
  its correlation id, which the CUDA call that launched it (a host event
  named ``cu*``) shares; that call's ``cpu_parent`` chain gives the
  range.  The device side's own copies of the ranges (user annotations)
  are left out.  Absent where no device operation links to a launch.
"""

from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, List, Tuple

import torch

__all__ = ["PACK_UNPACK_KERNELS", "device_seconds", "profile_window", "reduce_events", "top"]

#: the kernels of ``repro_torch/kernels/csrc/`` that pack and unpack
PACK_UNPACK_KERNELS = ("rows_warp_kernel", "rows_flat_kernel", "narrow_kernel",
                       "pack_tiled_kernel", "unpack_tiled_kernel")

#: gaps charged to host operations, longest first
_MAX_GAPS = 5000
#: host operations looked back through for one that spans a gap's middle
_LOOK_BACK = 256
#: the program's host ranges (``repro_torch.obs.trace.region``)
_RANGE = "tempi."
#: ``device_s_by_range``'s key for operations launched outside every range
NO_RANGE = "(no range)"


def _merge(spans: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """Busy µs of sorted intervals, and the gaps between them."""
    busy, gaps = 0.0, []
    lo, hi = spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            gaps.append((hi, a))
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return busy + hi - lo, gaps


def _gap_owners(gaps, host) -> Dict[str, float]:
    """Seconds of the longest gaps, by the innermost host operation at
    each gap's middle."""
    host.sort()
    starts = [h[0] for h in host]
    out: Dict[str, float] = {}
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:_MAX_GAPS]:
        mid = 0.5 * (a + b)
        name = "host (no op)"
        j = bisect.bisect_right(starts, mid) - 1
        for k in range(j, max(j - _LOOK_BACK, -1), -1):
            if host[k][1] >= mid:
                name = host[k][2]
                break
        out[name] = out.get(name, 0.0) + (b - a) * 1e-6
    return out


def profile_window(run: Callable[[], Dict], device: torch.device) -> Dict:
    """Profile ``run()`` (the cell's window, which ends synchronized) and
    reduce the profile; ``run``'s own result is under ``"stats"``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        stats = run()
        window_s = time.perf_counter() - t0
    return dict(reduce_events(prof.events()), stats=stats, window_s=window_s)


def _range_of(launch) -> str:
    """The innermost ``tempi.*`` range around a host event."""
    e = launch.cpu_parent
    while e is not None and not e.name.startswith(_RANGE):
        e = e.cpu_parent
    return NO_RANGE if e is None else e.name


def reduce_events(events) -> Dict:
    """A profile's events (``torch.profiler``'s ``FunctionEvent`` objects,
    their ``cpu_parent`` links built) reduced to every output of
    :func:`profile_window` but ``stats`` and ``window_s``."""
    dev_spans, host, ops, launches = [], [], [], {}
    device_s: Dict[str, float] = {}
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev_spans.append((a, b))
            seconds = (b - a) * 1e-6
            device_s[e.name] = device_s.get(e.name, 0.0) + seconds
            if not getattr(e, "is_user_annotation", False):
                ops.append((e.id, seconds))
        else:
            host.append((a, b, e.name))
            if e.name.startswith("cu"):
                launches[e.id] = e
    out = {"device_s": device_s}
    by_range: Dict[str, float] = {}
    for op_id, seconds in ops:
        if op_id in launches:
            key = _range_of(launches[op_id])
            by_range[key] = by_range.get(key, 0.0) + seconds
    if by_range:
        out["device_s_by_range"] = by_range
    if dev_spans:
        dev_spans.sort()
        busy_us, gaps = _merge(dev_spans)
        out["busy_s"] = busy_us * 1e-6
        out["idle_gaps"] = _gap_owners(gaps, host)
    return out


def device_seconds(prof: Dict, names, inside: bool = True) -> float:
    """Device seconds of the profiled window's operations whose name
    holds one of ``names`` (``inside=False``: of every other operation)."""
    return sum(s for op, s in prof["device_s"].items()
               if any(n in op for n in names) == inside)


def top(seconds: Dict[str, float], n: int = 10, width: int = 160) -> List[List[object]]:
    """The ``n`` largest ``[name, seconds]`` pairs, names cut to ``width``
    characters (a kernel's template arguments run to thousands)."""
    return [[k[:width], v] for k, v in sorted(seconds.items(), key=lambda kv: -kv[1])[:n]]
