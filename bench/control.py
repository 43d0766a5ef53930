"""The comparison's control and its planted faults, at a cell's own size.

The control is the reference in the program's place, computed one
precision below the configuration's float32: the state in bfloat16 with
the stencil's factors rounded to bfloat16 too (``--control bf16``) or
kept in float32, as a bfloat16 torch stencil computes (``--control
bf16_state``).  A fault (``--fault``, :mod:`bench.faults`) is planted in
the program under a run of the cell.  Each prints the numbers the cell
compares, which must come out above the cell's limits.

    python bench/control.py --workload stencil26.iterate --seeds 11,12,13 --control bf16 --passes 356
    python bench/control.py --workload stencil26.iterate --seeds 11,12,13 --fault stale_halo --seconds 51

``--passes`` is the number of cycle passes a full run of the cell
judges (its ``judged`` line); exchange cells need none.  The benchmark's
own runs never run this; ``bench/test_bench_control.py`` and
``bench/test_bench_faults.py`` run it at a small size.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "bench":
    del sys.path[0]
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

from bench import reference  # noqa: E402

__all__ = ["CONTROLS", "control_numbers"]

#: control name -> (state dtype, factor dtype)
CONTROLS = {"bf16": (torch.bfloat16, torch.bfloat16),
            "bf16_state": (torch.bfloat16, torch.float32)}


def control_numbers(config: Dict, loop: str, seed: int, passes: int, device,
                    control: str = "bf16", buffers: int = 1) -> Dict[str, float]:
    """The numbers a cell compares, for the control's output."""
    dtype, coef_dtype = CONTROLS[control]
    grid, n = tuple(config["grid"]), tuple(config["interior"])
    ops = [(tuple(o["radii"]), float(o["weight"])) for o in config["ops"]]
    if loop == "iterate":
        low = reference.global_field(seed, grid, n, device).to(dtype)
        out = reference.stencil_direct(low, ops, passes, dtype, coef_dtype)
        del low
        pz, py, px = grid
        interiors = torch.stack([
            out[cz * n[0]:(cz + 1) * n[0], cy * n[1]:(cy + 1) * n[1], cx * n[2]:(cx + 1) * n[2]]
            for cz in range(pz) for cy in range(py) for cx in range(px)]).float()
        del out
        return reference.judge_iterate(interiors, seed, grid, ops, passes)
    radii = (config["radius"],) * 3
    ranks = list(range(grid[0] * grid[1] * grid[2]))
    blocks = []
    for b in range(buffers):
        g = reference.global_field(seed, grid, n, device, buffer=b).to(dtype).float()
        blocks.append(torch.stack([reference.expected_block(g, grid, r, radii) for r in ranks]))
        del g
    return reference.judge_exchange(torch.stack(blocks), ranks, seed, grid, n, radii)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--control", choices=sorted(CONTROLS), default="bf16")
    ap.add_argument("--passes", type=int, default=0)
    ap.add_argument("--fault", default=None, help="a fault of bench.faults, run in the program")
    ap.add_argument("--seconds", type=float, default=51.0, help="the faulty run's window")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from bench import run

    spec = run.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.fault is not None:
            from bench.faults import planted

            with planted(args.fault):
                line = run.run_cell(args.workload, seed, args.seconds, False, args.device)
            numbers = {k: c["value"] for k, c in line["checks"].items()}
            what = {"fault": args.fault, "judged": line["judged"]}
        else:
            numbers = control_numbers(spec["config"], spec["traffic"]["loop"], seed,
                                      args.passes, args.device, args.control,
                                      spec["traffic"].get("buffers", 1))
            what = {"control": args.control, "passes": args.passes}
        print(json.dumps({"workload": args.workload, "seed": seed, **what,
                          "numbers": numbers, "limits": spec["limits"]}), flush=True)
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
