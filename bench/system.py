"""The system under test, built from a configuration file.

This is the only module of the benchmark that imports the program
(``repro_torch``).  It builds what one process runs: the port's
``Communicator`` (default tables, no calibration, no decisions file), and
either the deep-halo program step (``iterate`` traffic) or the blocking
halo-exchange step (``exchange`` traffic), with the state seeded from
``--seed`` (:mod:`bench.inputs`).  On the local mesh one process holds
every rank in one ``(R, az, ay, ax)`` tensor.  With ``buffers=2`` it
holds two such states and the calls alternate between them, as a
double-buffered stencil code exchanges.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from bench import inputs

__all__ = ["System"]


class System:
    """One process's share of a configuration under one traffic mix.

    ``step()`` runs one call of the timed path in place on the state
    buffer whose turn it is (:attr:`state`); ``calls`` counts every call
    made, warm-up included.  ``output()`` is what is judged,
    ``counters()`` the program's counters."""

    def __init__(self, config: Dict, loop: str, device, seed: int, buffers: int = 1):
        from repro_torch.comm import Communicator, policy_for_mode
        from repro_torch.halo import (HaloSpec, StencilOp, build_halo_program, make_halo_step,
                                      make_program_step)

        t0 = time.perf_counter()
        self.loop = loop
        self.grid = tuple(config["grid"])
        self.interior = tuple(config["interior"])
        self.comm = Communicator(policy=policy_for_mode(config["policy"]), device=device)
        device = self._device = self.comm.device
        self.ranks = list(range(self.grid[0] * self.grid[1] * self.grid[2]))
        self.ops = tuple((tuple(o["radii"]), float(o["weight"])) for o in config["ops"])
        if loop == "iterate":
            ops = tuple(StencilOp(r, w) for r, w in self.ops)
            self.program = build_halo_program(self.grid, self.interior, self.comm,
                                              steps=config["halo_steps"], ops=ops)
            self.spec = self.program.spec
            self.steps = self.program.steps
            self._step = make_program_step(self.program, self.comm, device=device)
        elif loop == "exchange":
            self.program = None
            self.spec = HaloSpec(self.grid, self.interior, config["radius"])
            self.steps = 0
            self._step = make_halo_step(self.spec, self.comm, device=device)
        else:
            raise ValueError(f"unknown loop {loop!r}; expected iterate or exchange")
        self.radii = self.spec.radii
        t1 = time.perf_counter()
        self.states: List[torch.Tensor] = []
        (rz, ry, rx), (nz, ny, nx) = self.radii, self.interior
        for b in range(buffers):
            state = torch.empty((len(self.ranks),) + self.spec.alloc, dtype=torch.float32,
                                device=device)
            for i, r in enumerate(self.ranks):
                state[i] = inputs.stale_block(seed, r, self.spec.alloc, device, b)
                state[i, rz:rz + nz, ry:ry + ny, rx:rx + nx] = \
                    inputs.interior(seed, r, self.interior, device, b)
            self.states.append(state)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        #: seconds of set-up: planning (communicator, committed types,
        #: strategies, wire plan, program depth) and seeding the state
        self.setup_parts = {"plan_s": t1 - t0, "seed_s": time.perf_counter() - t1}
        self.calls = 0

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def state(self) -> torch.Tensor:
        """The state buffer the next call works on."""
        return self.states[self.calls % len(self.states)]

    def step(self) -> None:
        self._step(self.state)
        self.calls += 1

    def counters(self) -> Dict[str, object]:
        from repro_torch.kernels import launch_counts

        return {"wire_ops": self.comm.wire_ops,
                "wire_payload_bytes": self.comm.wire_payload_bytes,
                "launches": launch_counts()}

    def new_tracer(self):
        """A fresh span recorder of the program's (``repro_torch.obs``)."""
        from repro_torch.obs import Tracer

        return Tracer()

    def attach_tracer(self, tracer) -> None:
        """Record the program's spans from now on (``None`` detaches:
        an attached tracer, even a disabled one, makes each call
        synchronize as it drains)."""
        self.comm.tracer = tracer

    def output(self) -> torch.Tensor:
        """What is judged: the interiors after ``iterate`` calls
        (``(R, nz, ny, nx)``), every buffer's whole blocks, halo shells
        included, after ``exchange`` calls (``(buffers, R, az, ay, ax)``)."""
        if self.loop == "exchange":
            return torch.stack(self.states)
        (rz, ry, rx), (nz, ny, nx) = self.radii, self.interior
        return self.states[0][:, rz:rz + nz, ry:ry + ny, rx:rx + nx].clone()

    def release(self) -> torch.Tensor:
        """Free everything but a copy of :meth:`output`, which is returned."""
        out = self.output()
        self.states = []
        self._step = self.program = self.comm = None
        return out
