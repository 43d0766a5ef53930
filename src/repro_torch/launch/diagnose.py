"""Hillclimb diagnosis: walk one cell and print the per-op byte breakdown
and the collective split (the port of the reference's
``repro.launch.diagnose``).

    PYTHONPATH=src python -m repro_torch.launch.diagnose --arch mixtral-8x22b \\
        --shape train_4k [--multi-pod] [--set microbatches=4 fsdp=False] [--dump ops.txt]

The cell is built and walked as :mod:`repro_torch.launch.dryrun` walks it,
on a fake process group of 256 or 512 ranks (started here when none is
up).  ``--dump`` writes the walk's op list, one line per op with its
local shapes, bytes and FLOPs, where the reference writes HLO text.
"""

from __future__ import annotations

import argparse

from repro_torch.configs.base import shape_for
from repro_torch.configs.registry import get_config
from repro_torch.distributed.sharding import DEFAULT_RULES, use_rules
from repro_torch.launch.dryrun import build_cell, mesh_name, production_mesh
from repro_torch.roofline.analysis import analyze
from repro_torch.roofline.op_cost import walk_cost

__all__ = ["main", "parse_overrides"]


def parse_overrides(pairs):
    out = {}
    for p in pairs or ():
        k, v = p.split("=", 1)
        if v in ("True", "False"):
            v = v == "True"
        else:
            try:
                v = int(v)
            except ValueError:
                try:
                    v = float(v)
                except ValueError:
                    pass
        out[k] = v
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--set", nargs="*", default=[])
    ap.add_argument("--dump", default=None, help="write the walk's op list here")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    over = parse_overrides(args.set)
    if over:
        cfg = cfg.replace(**over)
        print(f"overrides: {over}")
    shape = shape_for(args.shape)
    mesh = production_mesh(args.multi_pod)

    with use_rules(mesh, DEFAULT_RULES):
        fn, a = build_cell(cfg, shape, mesh, DEFAULT_RULES)
        _, cost = walk_cost(fn, *a, record=args.dump is not None)
    if args.dump:
        with open(args.dump, "w") as f:
            f.write("\n".join(cost.ops) + "\n")
    rep = analyze(args.arch, args.shape, mesh_name(mesh), mesh.size(), cost, cfg, shape)
    print(f"\nroofline: compute={rep.t_compute*1e3:.1f}ms "
          f"memory={rep.t_memory*1e3:.1f}ms "
          f"collective={rep.t_collective*1e3:.1f}ms -> {rep.bottleneck}")
    print(f"flops/dev={cost.flops:.3e}  bytes/dev={cost.bytes:.3e}  "
          f"coll/dev={cost.coll_bytes:.3e}")
    print("\ntop byte contributors (per device, per step):")
    for op, b in cost.top_ops(20):
        print(f"  {op:24s} {b:.3e} B  ({b/cost.bytes*100:5.1f}% of memory)")
    print("\ncollectives:")
    for k, v in sorted(cost.coll.items(), key=lambda kv: -kv[1]):
        if v:
            print(f"  {k:24s} {v:.3e} B/dev")
    print("\ntop collective shapes (bytes/dev, every call):")
    for k, v in sorted(cost.coll_shapes.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {v:.3e}  {k}")
    print(f"\nmemory: args={cost.argument_size_in_bytes/2**30:.2f}GiB "
          f"temp={cost.temp_size_in_bytes/2**30:.2f}GiB")


if __name__ == "__main__":
    main()
