"""End-to-end training entry point (the port of the reference's
``repro.launch.train``)::

    python -m repro_torch.launch.train --arch qwen2-0.5b --scale full   # on the card
    python -m repro_torch.launch.train --arch qwen2-0.5b --scale smoke --device cpu

Wires together: config -> model -> parameters and AdamW state -> data
pipeline -> the train step (eager; fused, or split around the gradient
wire) -> checkpoint manager (restore on start, periodic atomic saves in
the reference's format) -> straggler monitor.

Datatype communication goes through a production Communicator
(:mod:`repro_torch.measure.production`): the first run on a machine
calibrates the system tables once and records every strategy selection
in the measure store's decisions file; later runs load and pin them
(``--no-comm-cache`` skips all of it).  Before training, the data-axis
smoother (:mod:`repro_torch.launch.smoother`) runs through it, and so
through the port's pack/unpack kernels.

Everything runs on one device, the card unless ``--device cpu``, or on
a device mesh (``train(mesh=...)``, :mod:`repro_torch.launch.mesh`): the
parameters are then DTensors placed by the reference's logical-axis
rules (:mod:`repro_torch.distributed.sharding`), the batch is sharded
over the batch axes and the model's activations are constrained at the
reference's sites.  As the reference meshes itself on four devices or
more, ``train`` builds the (2, 2) test mesh when a process group of a
world of 4 is up; in any larger world it raises and asks for ``mesh=``.
Starting parameters come from :meth:`Model.init` (seed 0, the port's own
generator) unless the checkpoint directory holds a checkpoint.  As in
the reference, a checkpoint saved after step ``s`` holds the state after
``s + 1`` updates and a resumed run starts at step ``s``, so it applies
batch ``s`` a second time (ROADMAP Queue 3).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.configs.registry import ARCHS, get_config, smoke_config
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import DEFAULT_RULES, full_tensor, shard_model, use_rules
from repro_torch.models.model import build_model
from repro_torch.train.checkpoint import (
    CheckpointManager,
    load_train_state,
    train_state,
    train_state_shardings,
)
from repro_torch.train.elastic import StragglerMonitor
from repro_torch.train.grad_wire import GRAD_WIRE_MODES, GradWire
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_step import make_grad_step, make_train_step

__all__ = ["REPRO_100M", "main", "resolve_config", "train"]

#: ~100M-parameter config for the end-to-end example
REPRO_100M = ModelConfig(
    name="repro-100m", family="dense",
    num_layers=12, d_model=512, num_heads=8, num_kv_heads=4,
    d_ff=2048, vocab_size=32000, remat=False,
)


def resolve_config(arch: str, scale: str) -> ModelConfig:
    if arch == "repro-100m":
        return REPRO_100M
    return get_config(arch) if scale == "full" else smoke_config(arch)


def train(
    cfg: ModelConfig,
    steps: int,
    seq_len: int,
    global_batch: int,
    ckpt_dir: str,
    log_every: int = 10,
    ckpt_every: int = 100,
    comm=None,
    grad_wire: str = "off",
    device="cuda",
    mesh=None,
) -> dict:
    """Train ``cfg`` for ``steps`` steps of ``global_batch`` x ``seq_len``
    synthetic tokens.  Returns ``losses``, ``grad_norms`` and ``step_s``
    (one per step run), ``params`` (the model's, by port name),
    ``opt_state``, the ``model`` and, with a communicator,
    ``comm_stats``.

    ``mesh``: a named ``DeviceMesh`` over the whole process group (every
    rank calls ``train``), on ``device``'s type.  Without one, a process
    group of world 4 trains on ``make_test_mesh(2, 2)`` as the reference
    does on four devices; a world larger than 4 raises ``ValueError``
    (the reference would take 4 of its devices; here every rank of the
    group must be on the mesh, so pass one built for the whole world),
    and a smaller one trains each rank alone.  The gradient wire needs
    one device."""
    dev = resolve_device(device)
    mesh = _default_mesh(mesh, dev)
    if mesh is not None and grad_wire != "off":
        raise ValueError(f"--grad-wire {grad_wire} exchanges one device's gradients; on a mesh "
                         f"the gradients are reduced by their placements")
    shape = ShapeConfig("train", seq_len, global_batch, "train")
    model = build_model(cfg, device=dev)
    opt_cfg = AdamWConfig(moment_dtype=cfg.opt_moment_dtype, total_steps=max(steps, 10))
    # "off" keeps the fused step; any other mode splits it so the
    # gradient exchange runs through the communicator's wire stack
    # between the halves (model-priced, pinned, audited)
    wire = None
    if grad_wire != "off":
        if comm is None:
            raise ValueError(f"--grad-wire {grad_wire} needs a communicator "
                             "(incompatible with --no-comm-cache)")
        wire = GradWire(comm, mode=grad_wire)
        grad_fn, update_fn = make_grad_step(model, opt_cfg)
    else:
        step_fn = make_train_step(model, opt_cfg)
    mgr = CheckpointManager(ckpt_dir, every=ckpt_every)
    monitor = StragglerMonitor()

    with use_rules(mesh, DEFAULT_RULES):
        start, params, opt_state = _start(model, mgr, opt_cfg, mesh)
        if start:
            print(f"restored checkpoint at step {start}")

        def state():
            return train_state(model, params, opt_state)

        history, gnorms, step_s = [], [], []
        for step in range(start, steps):
            t0 = time.perf_counter()
            batch = synthetic_batch(cfg, shape, step, device=dev, mesh=mesh)
            if wire is not None:
                loss, metrics0, grads = grad_fn(params, batch)
                if not wire.planned:
                    # the first concrete gradients are the calibration probe:
                    # the ratio is measured, never assumed
                    wire.plan_for(grads)
                    print(wire.describe())
                grads = wire.exchange(grads)
                params, opt_state, metrics = update_fn(params, opt_state, grads, loss, metrics0)
                del grads
            else:
                params, opt_state, metrics = step_fn(params, opt_state, batch)
            metrics = {k: float(full_tensor(v)) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            verdict = monitor.observe(step, dt)
            if verdict == "remesh":
                print(f"straggler policy escalation at step {step} "
                      f"(persistently slow steps) — checkpoint + remesh")
            history.append(metrics["loss"])
            gnorms.append(metrics["grad_norm"])
            step_s.append(dt)
            if step % log_every == 0 or step == steps - 1:
                print(f"step {step:5d} loss {metrics['loss']:.4f} "
                      f"gnorm {metrics['grad_norm']:.3f} "
                      f"lr {metrics['lr']:.2e} {dt * 1e3:.0f}ms [{verdict}]")
            mgr.maybe_save(step, state)

        mgr.maybe_save(steps, state)
        out = {"losses": history, "grad_norms": gnorms, "step_s": step_s, "params": params,
               "opt_state": opt_state, "model": model}
        if comm is not None:
            out["comm_stats"] = comm.stats()
        return out


def _default_mesh(mesh, dev: torch.device):
    """``mesh``, or the (2, 2) test mesh when a process group of world 4
    is up (raising above 4), as the reference meshes itself."""
    import torch.distributed as dist

    if mesh is not None or not dist.is_available() or not dist.is_initialized():
        return mesh
    world = dist.get_world_size()
    if world < 4:
        return None
    if world > 4:
        raise ValueError(f"train() builds its own (2, 2) mesh in a world of 4; this world has "
                         f"{world} ranks: pass mesh= built over all of them "
                         f"(repro_torch.launch.mesh.make_test_mesh)")
    from repro_torch.launch.mesh import make_test_mesh

    return make_test_mesh(data=2, model=2, device_type=dev.type)


def _start(model, mgr: CheckpointManager, opt_cfg: AdamWConfig, mesh):
    """``(start step, params, opt_state)``: restored from the newest
    checkpoint (onto the mesh's placements, the parameters placed first
    so the restored leaves load into their shards) or drawn by
    ``Model.init`` (seed 0) and then placed."""
    shardings = train_state_shardings(model, mesh, DEFAULT_RULES) if mesh is not None else None
    start, restored = mgr.restore_or_init(lambda: None, shardings=shardings)
    if restored is None:
        model.init(seed=0)
    if mesh is not None:
        shard_model(model, mesh, DEFAULT_RULES)
    if restored is None:
        params = model.trainable()
        return start, params, init_opt_state(params, opt_cfg)
    params, opt_state = load_train_state(model, restored)
    return start, params, opt_state


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="repro-100m", choices=["repro-100m", *ARCHS])
    ap.add_argument("--scale", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"),
                    help="checkpoint directory (default: repro_torch_ckpt in the temporary "
                         "directory)")
    ap.add_argument("--comm-cache", default=None, metavar="DIR",
                    help="measure-store root for the production communicator (default: "
                         "$REPRO_TORCH_MEASURE_DIR or the user cache dir)")
    ap.add_argument("--no-comm-cache", action="store_true",
                    help="skip calibration/decision pinning entirely (analytic model, "
                         "nothing persisted)")
    ap.add_argument("--grad-wire", default="off", choices=GRAD_WIRE_MODES,
                    help="route the optimizer's gradient exchange through the production "
                         "communicator as a committed type: 'auto' is model-priced from a "
                         "probe of the first step's gradients (a compressible payload rides "
                         "the lossless varlen RLE wire), 'rle' forces it, 'int8' opts into "
                         "the lossy quantized wire (never auto-picked)")
    ap.add_argument("--halo-steps", default="auto", metavar="auto|N",
                    help="fusion depth for any deep-halo stencil program the job builds; "
                         "'auto' is model-priced and pinned through the decisions file")
    ap.add_argument("--smoother-iters", type=int, default=1,
                    help="iterations of the data-axis smoother run before training (the "
                         "in-launch HaloProgram exercising --halo-steps end to end; 0 "
                         "disables)")
    ap.add_argument("--smoother-cycle", default="predictor-corrector",
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
                    help="where the model, the optimizer and the smoother run (default: the "
                         "card)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the CLI; returns :func:`train`'s result."""
    args = parse_args(argv)
    from repro_torch.halo.program import parse_halo_steps, set_default_halo_steps

    halo_steps = parse_halo_steps(args.halo_steps)
    cfg = resolve_config(args.arch, args.scale)
    device = resolve_device(args.device)
    n = cfg.param_count()
    print(f"training {cfg.name} ({n / 1e6:.1f}M params, family={cfg.family}) "
          f"for {args.steps} steps @ seq={args.seq_len} batch={args.global_batch}")

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
        # the in-launch deep-halo workload: smooth a data-axis field before
        # training so the fusion-depth seam runs end to end on every job
        from repro_torch.launch.smoother import run_smoother

        report = run_smoother(comm, iters=args.smoother_iters, cycle=args.smoother_cycle)
        print(report.summary)

    out = train(cfg, args.steps, args.seq_len, args.global_batch, args.ckpt_dir, comm=comm,
                grad_wire=args.grad_wire, device=device)
    losses = out["losses"]
    if losses:
        print(f"loss: first={losses[0]:.4f} last={losses[-1]:.4f} "
              f"(delta {losses[0] - losses[-1]:+.4f})")
    if save_decisions is not None:
        path = save_decisions()
        dc = comm.model.decisions
        print(f"comm: recorded {len(dc)} decisions ({dc.pinned_hits} pinned hits) -> {path}")
    if args.trace and comm is not None and comm.tracer is not None:
        from repro_torch.obs.export import save_chrome_trace

        tpath = save_chrome_trace(comm.tracer, args.trace)
        print(f"trace ({len(comm.tracer)} spans) -> {tpath}")
    if comm is not None and want_telemetry:
        print(comm.telemetry.report())
        if args.drift_report:
            from repro_torch.fleet.drift import DriftDetector

            drift = DriftDetector().audit(comm.model.decisions, comm.model.params,
                                          telemetry=comm.telemetry, system="train")
            print(f"drift report -> {drift.save(args.drift_report)}")
    return out


if __name__ == "__main__":
    main()
