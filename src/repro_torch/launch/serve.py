"""Batched serving driver for every family (dense, vlm, moe, encdec,
ssm, rwkv, hybrid): a decode loop over a request queue with slot-based
continuous batching and greedy sampling.

The port of the reference's ``repro.launch.serve``::

    python -m repro_torch.launch.serve --arch qwen2-0.5b --scale full   # on the card
    python -m repro_torch.launch.serve --scale smoke --device cpu

Slots are refilled from the queue as sequences finish; every slot is fed
its next prompt token (prefill by decode) or its last generated token,
all at the loop's one global position ``t``, as in the reference (a
request admitted into a freed slot therefore also sees the K/V rows its
predecessor left in the slot's cache, and continues from its recurrent
state: ``conv``/``ssm``, ``wkv``, ``shift_*``).  The loop is family-agnostic,
as the reference's: a vlm serves text without patches, and an
encoder-decoder serves against the zero cross-attention K/V of its fresh
cache, since the reference's loop never calls ``encode``.  The decode
step runs eagerly.

As in the reference, the server's datatype-communication seam is a
production Communicator (calibrated tables plus a pinned decisions
file), and the deployment runs the data-axis smoother
(:mod:`repro_torch.launch.smoother`) through it once at startup, which
exercises the port's pack/unpack kernels and pins the ``--halo-steps``
choice.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCHS, get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model

__all__ = ["Request", "ServeLoop", "main", "make_requests"]


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    out: List[int] = field(default_factory=list)
    done: bool = False


class ServeLoop:
    """Slot-based continuous batching over a fixed decode batch.

    The model is built on ``device`` (the card unless ``device="cpu"``)
    and drawn from ``seed`` unless ``params`` (e.g.
    :func:`~repro_torch.models.model.params_from_reference`'s) is
    given."""

    def __init__(self, cfg: ModelConfig, batch_size: int, max_len: int, comm=None, *,
                 device="cuda", seed: int = 0,
                 params: Optional[Mapping[str, torch.Tensor]] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg, device=self.device)
        if params is None:
            self.model.init(seed)
        else:
            self.model.load_state_dict(params)
        self.B = batch_size
        self.max_len = max_len
        self.cache = self.model.init_cache(batch_size, max_len)
        self.slots: List[Optional[Request]] = [None] * batch_size
        self.slot_pos = np.zeros(batch_size, np.int32)
        self._decode = self.model.decode_step
        #: datatype-communication seam (production Communicator); every
        #: cross-device exchange a deployment adds goes through it
        self.comm = comm

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def admit(self, req: Request) -> bool:
        slot = self._free_slot()
        if slot is None:
            return False
        self.slots[slot] = req
        self.slot_pos[slot] = 0
        return True

    @torch.inference_mode()
    def step(self, t: int):
        """One global decode step: each active slot feeds its next prompt
        token (teacher-forced prefill by decode) or its last generated
        token; greedy argmax takes the first maximal index."""
        toks = np.zeros(self.B, np.int32)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            p = self.slot_pos[i]
            if p < len(req.prompt):
                toks[i] = req.prompt[p]
            else:
                toks[i] = req.out[-1] if req.out else 0
        logits, self.cache = self._decode(
            self.cache, torch.from_numpy(toks).to(self.device), t)
        nxt = logits.argmax(-1).cpu().numpy()
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            self.slot_pos[i] += 1
            if self.slot_pos[i] >= len(req.prompt):
                req.out.append(int(nxt[i]))
                if len(req.out) >= req.max_new:
                    req.done = True
                    self.slots[i] = None

    def run(self, queue: List[Request]) -> Dict[int, List[int]]:
        pending = list(queue)
        t = 0
        done: Dict[int, List[int]] = {}
        while pending or any(self.slots):
            while pending and self.admit(pending[0]):
                pending.pop(0)
            self.step(t)
            t += 1
            for r in queue:
                if r.done and r.rid not in done:
                    done[r.rid] = r.out
            if t >= self.max_len:
                break
        return done


def make_requests(cfg: ModelConfig, n: int, max_new: int, seed: int = 0) -> List[Request]:
    """The serve CLI's prompts: ``n`` requests of 4-11 tokens from
    ``default_rng(seed)``, drawn as the reference draws them."""
    rng = np.random.default_rng(seed)
    return [
        Request(rid=i,
                prompt=[int(x) for x in rng.integers(0, cfg.vocab_size,
                                                     size=rng.integers(4, 12))],
                max_new=max_new)
        for i in range(n)
    ]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b", choices=list(ARCHS))
    ap.add_argument("--scale", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--comm-cache", default=None, metavar="DIR",
                    help="measure-store root for the production communicator")
    ap.add_argument("--no-comm-cache", action="store_true",
                    help="skip calibration/decision pinning entirely")
    ap.add_argument("--halo-steps", default="auto", metavar="auto|N",
                    help="fusion depth for any deep-halo stencil program the deployment "
                         "builds; 'auto' is model-priced and pinned through the decisions file")
    ap.add_argument("--smoother-iters", type=int, default=1,
                    help="iterations of the data-axis smoother workload (the in-launch "
                         "HaloProgram exercising --halo-steps end to end; 0 disables)")
    ap.add_argument("--smoother-cycle", default="smooth",
                    help="op cycle the smoother fuses (see repro_torch.launch.smoother.CYCLES)")
    ap.add_argument("--ranks-per-node", type=int, default=None, metavar="N",
                    help="declare the two-level machine shape: ranks blocked N per node; the "
                         "model prices intra- and inter-node links apart and keys wire/program "
                         "pins by the topology fingerprint (default: flat)")
    ap.add_argument("--telemetry", action="store_true",
                    help="attach the runtime exchange probe: observed-vs-predicted wall time "
                         "per decision key, persisted to telemetry.json in the measure store")
    ap.add_argument("--drift-report", default=None, metavar="FILE",
                    help="write a DriftReport JSON after the run (implies --telemetry)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record hierarchical exchange spans and export a Chrome-trace JSON "
                         "here (python -m repro_torch.obs summary PATH)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model and the smoother run (default: the card)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    from repro_torch.halo.program import parse_halo_steps, set_default_halo_steps

    halo_steps = parse_halo_steps(args.halo_steps)
    cfg = get_config(args.arch) if args.scale == "full" else smoke_config(args.arch)
    device = resolve_device(args.device)
    comm = save_decisions = None
    want_telemetry = bool(args.telemetry or args.drift_report)
    if not args.no_comm_cache:
        from repro_torch.measure.bench import RANKS
        from repro_torch.measure.production import production_communicator

        topology = None
        if args.ranks_per_node:
            from repro_torch.comm.topology import Topology

            topology = Topology.blocked(RANKS, args.ranks_per_node)
        comm, save_decisions = production_communicator(
            args.comm_cache, device=device, halo_steps=halo_steps,
            telemetry=want_telemetry or None, tracer=bool(args.trace) or None,
            topology=topology,
        )
        dc = comm.model.decisions
        topo_note = (f" topo={topology.fingerprint}({topology.nnodes} nodes)"
                     if topology is not None else "")
        print(f"comm: params={comm.model.params.name} pinned_decisions={len(dc)} "
              f"halo_steps={halo_steps} pinned_programs={len(dc.program_rows())}{topo_note}")
    else:
        set_default_halo_steps(halo_steps)
    if args.smoother_iters > 0 and comm is not None:
        # the deployment's deep-halo workload: a state-smoothing pass over
        # the data axis through the same production communicator
        from repro_torch.launch.smoother import run_smoother

        report = run_smoother(comm, iters=args.smoother_iters, cycle=args.smoother_cycle)
        print(report.summary)
    loop = ServeLoop(cfg, args.batch, args.max_len, comm=comm, device=device)
    reqs = make_requests(cfg, args.requests, args.max_new)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    done = loop.run(reqs)
    dt = time.perf_counter() - t0
    total_new = sum(len(v) for v in done.values())
    print(f"served {len(done)}/{args.requests} requests, {total_new} tokens in {dt:.1f}s "
          f"({total_new / dt:.1f} tok/s, batch={args.batch}, {cfg.name})")
    for rid in sorted(done)[:3]:
        print(f"  req {rid}: {done[rid][:8]}...")
    if save_decisions is not None:
        print(f"comm: decisions -> {save_decisions()}")
    if args.trace and comm is not None and comm.tracer is not None:
        from repro_torch.obs.export import save_chrome_trace

        tpath = save_chrome_trace(comm.tracer, args.trace)
        print(f"trace ({len(comm.tracer)} spans) -> {tpath}")
    if comm is not None and want_telemetry:
        print(comm.telemetry.report())
        if args.drift_report:
            from repro_torch.fleet.drift import DriftDetector

            drift = DriftDetector().audit(comm.model.decisions, comm.model.params,
                                          telemetry=comm.telemetry, system="serve")
            print(f"drift report -> {drift.save(args.drift_report)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
