"""3D stencil with a deep-halo HaloProgram, one process per rank (paper
§6.4): the port's counterpart of the reference's ``examples/stencil3d.py``.

Each process holds one rank's block of a periodic domain, and the
26-point stencil's halo regions, each an MPI-style subarray datatype,
are packed by the port's kernels and exchanged through the
Communicator's fused neighbourhood alltoallv over ``torch.distributed``
(:class:`~repro_torch.comm.distributed.DistributedTransport`): NCCL on
the card, gloo on the CPU.  The iteration is a ``HaloProgram``: one
exchange at halo depth ``s * r`` amortized over ``s`` local stencil
applications.

The interiors are seeded as the reference example seeds them
(``np.random.default_rng(0).normal(size=(R, nz, ny, nx))``, rank ``r``
takes row ``r``), so the printed interior checksum compares with the
reference's and with the local mesh's when the iterations and
applications match.  The checksum is reduced in a fixed order: the
interiors are gathered to rank 0 and summed there in numpy.  Rank 0
prints, and alone writes the decisions file.

``--cycle`` picks the op cycle fused per repeat, as in the reference
example: the paper's single 26-point op, or the smoother's
predictor-corrector pair (a ``(2, 1, 1)`` predictor then a 26-point
corrector on one exchange, :func:`repro_torch.launch.smoother.smoother_cycle`).

Run on the CPU in N local processes, or under ``torchrun`` on the card::

    python -m repro_torch.launch.stencil3d --nprocs 8 --backend gloo --device cpu \\
        --interior 8 --iters 1 --ranks-per-node 4
    torchrun --nproc-per-node 1 -m repro_torch.launch.stencil3d --interior 256
"""

from __future__ import annotations

import argparse
import math
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["CYCLES", "dims_create", "main", "run", "parse_args"]

#: the op cycles ``--cycle`` names: the paper's single op, or the pair the
#: in-launch smoother fuses
CYCLES = ("single", "predictor-corrector")


def cycle_ops(name: str):
    """The op cycle a ``--cycle`` name denotes."""
    from repro_torch.halo import STENCIL26
    from repro_torch.launch.smoother import smoother_cycle

    return (STENCIL26,) if name == "single" else smoother_cycle(name)


def dims_create(nprocs: int) -> Tuple[int, int, int]:
    """A balanced (pz, py, px) process grid of ``nprocs`` ranks, largest
    extent first, as ``MPI_Dims_create`` chooses one."""
    dims = [1, 1, 1]
    n = nprocs
    primes: List[int] = []
    p = 2
    while n > 1:
        while n % p == 0:
            primes.append(p)
            n //= p
        p += 1
    for q in sorted(primes, reverse=True):
        dims[dims.index(min(dims))] *= q
    return tuple(sorted(dims, reverse=True))


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    from repro_torch.comm import MODES

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.stencil3d",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="tempi", choices=list(MODES))
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--interior", type=int, default=24)
    ap.add_argument("--halo-steps", default="2", metavar="auto|N",
                    help="cycle repeats fused per exchange; 'auto' prices the depth "
                         "with PerfModel.price_program")
    ap.add_argument("--cycle", default="single", choices=CYCLES,
                    help="op cycle fused per repeat (predictor-corrector = a (2,1,1) "
                         "predictor then a 26-point corrector on one exchange)")
    ap.add_argument("--decisions", default=None, metavar="FILE",
                    help="decision-cache file: records the auto depth choice (and every "
                         "strategy selection); reruns pin it; rank 0 writes it")
    ap.add_argument("--overlap", nargs="?", const="monolithic", default=False,
                    choices=["monolithic", "region", "auto"],
                    help="hide the exchange behind the interior chain (default mode: "
                         "monolithic)")
    ap.add_argument("--grid", default=None, metavar="PZ,PY,PX",
                    help="process grid (default: a balanced grid of the world size)")
    ap.add_argument("--backend", default="nccl", choices=["nccl", "gloo"])
    ap.add_argument("--device", default=None,
                    help="this process's device (default: cuda:LOCAL_RANK under nccl, "
                         "cpu under gloo)")
    ap.add_argument("--nprocs", type=int, default=None, metavar="N",
                    help="spawn N local processes over a file store; without it the "
                         "rendezvous comes from the environment (torchrun)")
    ap.add_argument("--ranks-per-node", type=int, default=None, metavar="N",
                    help="declare the two-level machine shape: ranks are blocked N per "
                         "node (repro_torch.comm.topology), the model prices intra- and "
                         "inter-node links apart, and wire and program pins are keyed by "
                         "the topology fingerprint (default: flat)")
    ap.add_argument("--out", default=None, metavar="FILE.npy",
                    help="rank 0 saves the gathered (R, nz, ny, nx) interiors here")
    args = ap.parse_args(argv)
    if args.grid is not None:
        args.grid = tuple(int(x) for x in args.grid.split(","))
        if len(args.grid) != 3 or min(args.grid) < 1:
            ap.error(f"--grid needs three positive extents, got {args.grid}")
    return args


def _seed_block(spec, rank: int) -> np.ndarray:
    """This rank's ``(1, az, ay, ax)`` block: the interior is row
    ``rank`` of ``default_rng(0).normal(size=(R, nz, ny, nx))`` (drawn
    rank by rank, the same stream), the shells zero."""
    rng = np.random.default_rng(0)
    nz, ny, nx = spec.interior
    rz, ry, rx = spec.radii
    block = np.zeros((1,) + spec.alloc, np.float32)
    for r in range(rank + 1):
        x = rng.normal(size=(nz, ny, nx))
    block[0, rz:rz + nz, ry:ry + ny, rx:rx + nx] = x.astype(np.float32)
    return block


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args: argparse.Namespace, device) -> Optional[np.ndarray]:
    """One process's run inside an initialized default group: build the
    program, iterate, gather the interiors and, on rank 0, print the
    reference example's lines.  Returns the gathered ``(R, nz, ny, nx)``
    interiors on rank 0 (None elsewhere)."""
    import torch
    import torch.distributed as dist

    from repro_torch.comm import Communicator, DistributedTransport, Topology, policy_for_mode
    from repro_torch.halo import build_halo_program, make_program_step, parse_halo_steps
    from repro_torch.measure import DecisionCache

    transport = DistributedTransport(device=device)
    rank, world = transport.rank, transport.nranks
    grid = args.grid or dims_create(world)
    if math.prod(grid) != world:
        raise ValueError(f"grid {grid} holds {math.prod(grid)} ranks; the group has {world}")
    n = args.interior
    steps = parse_halo_steps(args.halo_steps)
    decisions = DecisionCache.load(args.decisions) if args.decisions else None
    topology = (Topology.blocked(world, args.ranks_per_node)
                if args.ranks_per_node else None)
    comm = Communicator(policy=policy_for_mode(args.mode), decisions=decisions,
                        transport=transport, topology=topology)
    program = build_halo_program(grid, (n, n, n), comm, steps=steps, ops=cycle_ops(args.cycle))
    spec = program.spec
    step = make_program_step(program, comm, device=transport.device, overlap=args.overlap)
    state = torch.from_numpy(_seed_block(spec, rank)).to(transport.device)

    step(state.clone())  # first call: builds and loads the kernels (state not advanced)
    _sync(transport.device)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        step(state)
    _sync(transport.device)
    dist.barrier()
    dt = (time.perf_counter() - t0) / max(args.iters, 1)

    nz, ny, nx = spec.interior
    rz, ry, rx = spec.radii
    interior = state[0, rz:rz + nz, ry:ry + ny, rx:rx + nx].contiguous()
    parts = [torch.empty_like(interior) for _ in range(world)] if rank == 0 else None
    dist.gather(interior, parts, dst=0)
    if rank != 0:
        return None
    gathered = np.stack([p.cpu().numpy() for p in parts])
    est, wire = program.estimate, program.plan.wire
    print(f"mode={args.mode} overlap={args.overlap} ranks={world} "
          f"interior={spec.interior} halo-radius={spec.radii} grid={tuple(grid)} "
          f"backend={transport.backend} device={transport.device}"
          + (f" topo={topology.fingerprint}({topology.nnodes} nodes)"
             if topology is not None else ""))
    print(f"program: cycle={args.cycle} ({program.cycle_len} op"
          f"{'s' if program.cycle_len > 1 else ''}) steps={program.steps} "
          f"({'pinned' if program.pinned else args.halo_steps}), "
          f"exchanges/step={program.exchanges_per_step:.3f}, "
          f"exchanges/cycle={program.exchanges_per_cycle:.3f}, "
          f"predicted per-step {est.per_step * 1e6:.2f} us "
          f"(exchange {est.t_exchange * 1e6:.2f} us, "
          f"redundant {est.t_redundant * 1e6:.2f} us)")
    print(f"committed datatypes: {len(comm.registry)} (52 send/recv regions)")
    print(f"wire schedule: {wire.schedule} ({wire.wire_ops} collectives per exchange, "
          f"{program.plan.wire_bytes} exact bytes, padding {wire.padding_bytes})")
    print(f"time per iteration (1 exchange + {program.applications} stencil "
          f"applications): {dt * 1e3:.2f} ms")
    print(f"stencil applications: {args.iters * program.applications}")
    print(f"interior checksum: {float(gathered.sum()):.6e}")
    if decisions is not None:
        path = decisions.save(args.decisions)
        print(f"decisions ({len(decisions)} rows, "
              f"{decisions.pinned_hits} pinned hits) -> {path}")
    if args.out:
        np.save(args.out, gathered)
    return gathered


def _worker(rank: int, nprocs: int, store_path: str, args: argparse.Namespace) -> None:
    from repro_torch.launch.procgroup import destroy_process_group, init_process_group

    info = init_process_group(args.backend, args.device, store_path=store_path,
                              rank=rank, world_size=nprocs)
    try:
        run(args, info.device)
    finally:
        destroy_process_group()


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    if args.nprocs is not None:
        from repro_torch.launch.procgroup import spawn

        if args.nprocs < 1:
            raise SystemExit("--nprocs must be >= 1")
        spawn(_worker, args.nprocs, (args,))
        return 0
    from repro_torch.launch.procgroup import destroy_process_group, init_process_group

    info = init_process_group(args.backend, args.device)
    try:
        run(args, info.device)
    finally:
        destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
