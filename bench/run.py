"""Run one cell of the port's benchmark once.

    python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``; everything
it names is a file found by name:

* ``bench/configs/<config>.json``: the deployment (grid, interior,
  ops, halo depth, policy), the file ``configs[].file`` names;
* ``bench/traffic/<traffic>.json``: the loop (``bench/loops/<loop>.py``),
  its state buffers and its warm-up and traced windows;
* ``bench/cells/<cell>.json``: the limits of the numbers compared;
* ``bench/metrics/<metric>.py``: one reader per per-layer metric.

A run builds the system on the card (:mod:`bench.system`), warms up
every shape the loop uses, then measures for ``--seconds`` (``--trace
0``: the cell's end-to-end metrics) or profiles the loop and, where the
traffic asks for spans, runs it under the program's span recorder
(``--trace 1``: its per-layer metrics).  Then it frees the program,
judges what the loop produced against the plain reference
(:mod:`bench.reference`), prints each number compared beside its limit
as the last lines of standard error, and prints one JSON line last on
standard output.  It exits 2, printing no result, without as many cards
as the cell asks for, and 3 if a module of JAX or of the JAX package
(``repro``) is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.time()  # the process's start, for setup_s

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "bench":
    del sys.path[0]  # run as a script: import the harness as ``bench.*``
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# every kernel cache of a run stays in the checkout, at fixed paths (the
# program builds its own kernels into build/repro_torch/)
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "cuda_cache")

#: top-level module names no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is
    one of :data:`FORBIDDEN`."""
    return sorted(m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN)


def load_cell(workload: str, root: Path = ROOT) -> Dict:
    """Everything a cell names, read from its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no cell {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return {
        "cell": workload,
        "chips": w["chips"],
        "config": json.loads((root / conf["file"]).read_text()),
        "traffic": json.loads((root / "bench" / "traffic" / f"{w['traffic']}.json").read_text()),
        "limits": json.loads((root / "bench" / "cells" / f"{workload}.json").read_text())["limits"],
        "end_to_end": e2e,
        "per_layer": per_layer,
    }


def _reader(name: str):
    path = ROOT / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _card() -> Optional[str]:
    """``name, power limit`` as ``nvidia-smi`` reads them."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        out = subprocess.run([exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides: Optional[Dict[str, Dict]] = None, t_start: float = T_START) -> Dict:
    """Run a cell once and return its result line (a dict) with the
    numbers compared under ``"checks"``.  ``overrides`` replaces keys of
    the cell's ``config`` and ``traffic`` (a rehearsal at a small size)."""
    import torch

    from bench import profiling, roofline, timing

    spec = load_cell(workload)
    for part, keys in (overrides or {}).items():
        spec[part] = dict(spec[part], **keys)
    traffic = spec["traffic"]
    loop = importlib.import_module(f"bench.loops.{traffic['loop']}")
    parts = {"start_to_build_s": time.time() - t_start}
    if torch.device(device).type == "cuda":
        t0 = time.perf_counter()
        torch.cuda.init()
        torch.empty(1, device=device)
        parts["cuda_context_s"] = time.perf_counter() - t0
    system = loop.build(spec["config"], traffic, device, seed)
    dev = system.device
    parts.update(system.setup_parts)
    t0 = time.perf_counter()
    system.step()  # loads the program's kernels, building them on a checkout's first run
    timing.sync(dev)
    t1 = time.perf_counter()
    for _ in range(traffic["warmup_calls"] - 1):
        system.step()
    timing.sync(dev)
    parts.update(first_call_s=t1 - t0, warmup_s=time.perf_counter() - t1)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    if not trace:
        setup_s = time.time() - t_start
        stats = loop.window(system, seconds)
        values = dict(loop.end_to_end(stats), setup_s=setup_s)
        attempted = stats["calls"]
    else:
        # the profiled window runs the timed path itself, with no tracer
        before = system.counters()
        prof = profiling.profile_window(lambda: loop.window(system, traffic["profile_seconds"]),
                                        dev)
        after = system.counters()
        spans, span_calls = [], 0
        if traffic["span_seconds"] > 0:
            tracer = system.new_tracer()
            system.attach_tracer(tracer)
            span_calls = loop.window(system, traffic["span_seconds"])["calls"]
            system.attach_tracer(None)
            spans = tracer.spans
        ctx = SimpleNamespace(
            spans=spans, span_calls=span_calls, counters_before=before, counters_after=after,
            profile=prof, interior=system.interior, halo=system.radii, steps=system.steps,
            op_radii=[r for r, _ in system.ops], ranks_here=len(system.ranks),
            peaks=roofline.peaks(kind))
        values = {m["name"]: _reader(m["name"])(ctx) for m in spec["per_layer"]}
        attempted = prof["stats"]["calls"] + span_calls
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    result = system.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = loop.judge(system, result, seed)
    del result

    checks = {k: {"value": v, "limit": spec["limits"][k]} for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    units = {m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]}
    want = spec["per_layer"] if trace else spec["end_to_end"]
    metrics = {m["name"]: {"value": values[m["name"]], "unit": units[m["name"]]}
               for m in want if values.get(m["name"]) is not None}
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
                   "count": 1, "memory_peak_bytes": peak}
    line = {"correct": correct, "attempted": attempted, "failed": 0,
            "metrics": metrics, "device": device_info}
    if trace:
        device_info.update(busy_s=prof.get("busy_s"), window_s=prof["window_s"])
        line["breakdown"] = {"device_ops": profiling.top(prof["device_s"]),
                             "idle_gaps": profiling.top(prof.get("idle_gaps", {}))}
        card = _card() if dev.type == "cuda" else None
        if card:
            line["card"] = card
    line["setup_parts"] = parts
    line["judged"] = {"calls": system.calls, "passes": system.calls * system.steps}
    line["forbidden"] = forbidden_modules()
    line["checks"] = checks
    return line


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python bench/run.py", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: {args.workload} needs {spec['chips']} CUDA device(s); found {have}",
              file=sys.stderr)
        return 2
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = sorted(set(line.pop("forbidden")) | set(forbidden_modules()))
    if bad:
        print(f"bench: modules of JAX or the JAX package are loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(f"setup parts {json.dumps(line['setup_parts'])}; judged {json.dumps(line['judged'])}",
          file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
