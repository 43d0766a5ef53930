"""Time the port's main path — the full-width 26-neighbour halo exchange
plus two stencil applications — in one tree or in two trees in turns.

    python scripts/time_main_path.py                  # this checkout, one process
    python scripts/time_main_path.py --src DIR        # the checkout at DIR
    python scripts/time_main_path.py --compare DIR --rounds 3

With ``--compare`` every round runs DIR, this checkout, this checkout,
DIR, each in a process of its own (two versions of ``repro_torch`` cannot
share one), and prints every reading and then the range per tree.  DIR
is a checkout of another commit (``git archive <commit> | tar -x -C
DIR``) inside a directory that git ignores; its kernels are built there
on its first run.  It needs one CUDA card.

One process: 8 ranks on the periodic 2x2x2 grid, 256^3 float32 interior
per rank, radius 2, the default (``tempi``) communicator, as
``chip_smoke.py``'s main phase.  After two warm-up iterations it reads,
each a median of ``--reps`` readings:

* ``issue_ms``: host time until one exchange call returns, the card idle
  before it (what the host pays to enqueue an exchange);
* ``exchange_ms``: the same call through ``torch.cuda.synchronize()``;
* ``exchange_event_ms``: CUDA events on the caller's stream around it;
* ``iteration_ms``: exchange + 2 applications, synchronized each
  iteration; ``back_to_back_ms``: the same over ``--reps`` iterations
  with one synchronization at the end.

It prints one JSON line with those numbers and the card's name and power
limit (``nvidia-smi``)."""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def measure(src: str, reps: int) -> dict:
    sys.path.insert(0, os.path.join(src, "src"))
    import torch

    from repro_torch.halo import HaloSpec, make_halo_step, stencil_iterations

    if not torch.cuda.is_available():
        raise SystemExit("time_main_path: no CUDA device is available")
    dev = torch.device("cuda", 0)
    spec = HaloSpec(grid=(2, 2, 2), interior=(256, 256, 256), radius=2)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((spec.nranks,) + spec.alloc, generator=gen, device=dev)
    step = make_halo_step(spec, device=dev)

    def iteration():
        step(x)
        stencil_iterations(x, spec, steps=2)

    for _ in range(2):
        iteration()
    torch.cuda.synchronize()
    issue, exchange, event, it = [], [], [], []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        step(x)
        e1.record()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        issue.append((t1 - t0) * 1e3)
        exchange.append((t2 - t0) * 1e3)
        event.append(e0.elapsed_time(e1))
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        iteration()
        torch.cuda.synchronize()
        it.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        iteration()
    torch.cuda.synchronize()
    b2b = (time.perf_counter() - t0) * 1e3 / reps
    if not torch.isfinite(x).all():
        raise SystemExit("time_main_path: non-finite values after the iterations")
    med = statistics.median
    return {"src": src, "issue_ms": med(issue), "exchange_ms": med(exchange),
            "exchange_event_ms": med(event), "iteration_ms": med(it),
            "back_to_back_ms": b2b, "reps": reps, "card": card_line(),
            "torch": torch.__version__}


def compare(other: str, rounds: int, reps: int) -> None:
    order = [("parent", other), ("change", HERE), ("change", HERE), ("parent", other)]
    rows = []
    for rnd in range(rounds):
        for label, src in order:
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--src", src, "--reps", str(reps)],
                capture_output=True, text=True, timeout=600)
            if out.returncode != 0:
                raise SystemExit(f"time_main_path: {label} run failed:\n{out.stderr[-4000:]}")
            row = dict(json.loads(out.stdout.strip().splitlines()[-1]), tree=label, round=rnd)
            rows.append(row)
            print(json.dumps(row), flush=True)
    keys = ("issue_ms", "exchange_ms", "exchange_event_ms", "iteration_ms", "back_to_back_ms")
    summary = {label: {k: [min(r[k] for r in rows if r["tree"] == label),
                           max(r[k] for r in rows if r["tree"] == label)] for k in keys}
               for label in ("parent", "change")}
    print(json.dumps({"main_path_in_turns": summary, "rounds": rounds,
                      "card": rows[0]["card"]}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=HERE, help="the checkout whose src/ to time")
    ap.add_argument("--compare", metavar="DIR",
                    help="time DIR's checkout and this one in turns")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=9)
    args = ap.parse_args()
    if args.compare:
        compare(os.path.abspath(args.compare), args.rounds, args.reps)
    else:
        print(json.dumps(measure(os.path.abspath(args.src), args.reps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
