#!/usr/bin/env python3
"""Train on a mesh of several cards against one card.

For each arch (default: qwen2-0.5b, whole, weights drawn from seed 0),
in float32 with TF32 off, remat on, seq 256 x batch 8: ``--steps``
steps of ``train()`` on one card, in a process of its own with no
process group; then the same steps in ``data x model`` processes, one
card each, through NCCL over a ``file://`` store, on the ``("data",
"model")`` mesh, from the same ``Model.init``.  Prints one JSON line per
arch: both runs' losses, grad norms and ms per step, their largest
relative differences, the final parameters' largest difference as a
share of each leaf's largest entry (the biases' apart, absolute: they
start at zero and AdamW normalizes their near-zero gradients), the peak
memory of every rank and
the placements of three leaves.  Exits 1 when the losses or grad norms
differ by more than ``REL``.  Needs ``data x model`` cards::

    PYTHONPATH=src python3 scripts/mesh_train_cards.py [--data 2] [--model 2] [ARCH ...]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

SEQ, BATCH = 256, 8
REL = 1e-4  # largest relative difference of a loss or grad norm against one card
LEAVES = ("embed.vocab", "layers.0.attn.wq", "layers.0.mlp.w_out")


def _cfg(arch):
    from repro_torch.configs import get_config

    return get_config(arch).replace(dtype="float32", remat=True)


def _run(args, root, mesh):
    """One ``train()`` run; returns its record and the final parameters
    (whole, on the host)."""
    import torch

    from repro_torch.distributed.sharding import full_tensor
    from repro_torch.launch.train import train

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.reset_peak_memory_stats()
    out = train(_cfg(args.arch), args.steps, SEQ, BATCH, os.path.join(root, "ckpt"),
                ckpt_every=10 * args.steps, device=dev, mesh=mesh, log_every=100)
    torch.cuda.synchronize()
    rec = {"losses": out["losses"], "grad_norms": out["grad_norms"],
           "step_ms": [s * 1e3 for s in out["step_s"]],
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    if mesh is not None:
        rec["placements"] = {k: [repr(p) for p in out["params"][k].placements] for k in LEAVES}
    return rec, {k: full_tensor(v).detach().cpu() for k, v in out["params"].items()}


def child(args) -> None:
    """``--one``: the run on one card; ``--rank R``: rank R of the mesh."""
    import torch

    if args.rank is None:
        rec, params = _run(args, args.out, None)
    else:
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.launch.procgroup import destroy_process_group, init_process_group

        init_process_group("nccl", store_path=os.path.join(args.out, "store"), rank=args.rank,
                           world_size=args.data * args.model)
        try:
            mesh = make_test_mesh(data=args.data, model=args.model, device_type="cuda")
            rec, params = _run(args, os.path.join(args.out, "mesh"), mesh)
            mems = [None] * (args.data * args.model)
            torch.distributed.all_gather_object(mems, rec["max_memory_allocated"])
            rec["max_memory_allocated"] = mems
        finally:
            destroy_process_group()
        if args.rank:
            return
    tag = "one" if args.rank is None else "mesh"
    torch.save({"rec": rec, "params": params}, os.path.join(args.out, f"{tag}.pt"))


def _start(args, extra, env=None):
    cmd = [sys.executable, os.path.abspath(__file__), "--arch", args.arch, "--steps",
           str(args.steps), "--data", str(args.data), "--model", str(args.model), *extra]
    return subprocess.Popen(cmd, env=env)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("archs", nargs="*", default=["qwen2-0.5b"])
    ap.add_argument("--data", type=int, default=2)
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--arch", help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.out is not None:
        child(args)
        return 0

    import torch

    ok = True
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    for arch in args.archs:
        args.arch = arch
        with tempfile.TemporaryDirectory(prefix="mesh_cards_") as root:
            if _start(args, ["--out", root]).wait(timeout=900):
                raise SystemExit(f"{arch}: the one-card run failed")
            procs = [_start(args, ["--out", root, "--rank", str(r)],
                            env=dict(os.environ, LOCAL_RANK=str(r)))
                     for r in range(args.data * args.model)]
            if any(p.wait(timeout=900) for p in procs):
                raise SystemExit(f"{arch}: a rank of the mesh run failed")
            one = torch.load(os.path.join(root, "one.pt"))
            mesh = torch.load(os.path.join(root, "mesh.pt"))
        rel = {k: max(abs(a - b) / abs(a) for a, b in zip(one["rec"][k], mesh["rec"][k]))
               for k in ("losses", "grad_norms")}
        # zero-initialized biases move by AdamW's normalized noise: apart
        diff = {k: float((mesh["params"][k] - p).abs().max()) for k, p in one["params"].items()}
        params = max(diff[k] / max(float(p.abs().max()), 1e-30)
                     for k, p in one["params"].items() if "bias" not in k)
        biases = max([d for k, d in diff.items() if "bias" in k], default=0.0)
        ok &= all(v <= REL for v in rel.values())
        print(json.dumps({"mesh_cards": {
            "arch": arch, "layers": _cfg(arch).num_layers, "card": card,
            "mesh": [["data", "model"], [args.data, args.model]], "seq": SEQ, "batch": BATCH,
            "dtype": "float32", "one": one["rec"], "mesh_run": mesh["rec"], "rel": rel,
            "params_rel_to_largest": params, "bias_abs": biases}}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
