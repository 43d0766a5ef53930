"""A call captured once into a CUDA graph and replayed.

:class:`GraphCall` captures ``fn()`` — Python that issues its work on
the current stream, forking to other streams and joining them again as
it likes — into one ``torch.cuda.CUDAGraph``, then launches the graph
once, so the captured call's work is done.  Each later
:meth:`GraphCall.replay` launches the graph again on the caller's
stream: the same kernels on the same addresses, with none of the
Python.

A replay runs no Python, so no wrapper counts a launch.  The kernel
launches the captured call's wrappers counted are kept on the call
(:attr:`GraphCall.launches`) beside its replays (:attr:`GraphCall.replays`):
what the graph launched is their product, and
:func:`repro_torch.kernels.launch_counts` does not include it.  Captures
and replays are counted here and read beside the launch counts
(``graph_captures``, ``graph_replays``); the launch that ends a capture
is part of the captured call, not a replay.

Nothing here runs at import time.
"""

from __future__ import annotations

import gc
from typing import Callable, Dict

import torch

__all__ = ["GraphCall"]

#: graphs captured and replays launched since the last
#: :func:`repro_torch.kernels.reset_launch_counts`
captures = 0
replays = 0


class GraphCall:
    """``fn()`` captured on ``device`` into a CUDA graph with a memory
    pool of its own, launched once.  The graph holds raw addresses: a
    replay is only right where every tensor ``fn`` touched from outside
    the capture still lives at the same address with the same layout.
    The call keeps no reference to ``fn``, so whatever owns the call is
    freed, and its graph with it, as soon as it is dropped."""

    def __init__(self, fn: Callable[[], object], device: torch.device):
        global captures
        from repro_torch.kernels import launch_counts

        launched = launch_counts()
        # no garbage collection during the capture: a collected object
        # that frees CUDA resources (another call's graph, say) would
        # make a call the capture forbids, and the capture would fail
        collecting = gc.isenabled()
        gc.disable()
        try:
            self._graph = self._record(fn, device)
        finally:
            if collecting:
                gc.enable()
        #: the kernel launches of the captured call, by
        #: :func:`~repro_torch.kernels.launch_counts` name: what each
        #: replay launches again
        self.launches: Dict[str, int] = {
            k: n - launched[k] for k, n in launch_counts().items() if n != launched[k]}
        #: replays of this graph
        self.replays = 0
        captures += 1
        self._graph.replay()

    @staticmethod
    def _record(fn: Callable[[], object], device: torch.device) -> "torch.cuda.CUDAGraph":
        # torch.cuda.graph synchronizes the device and captures on a
        # stream of its own (the legacy default stream cannot capture)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device), torch.cuda.graph(graph):
            fn()
        return graph

    def replay(self) -> None:
        """Launch the captured work on the current stream."""
        global replays
        self._graph.replay()
        self.replays += 1
        replays += 1
