"""CLI: run the full-term calibration and write a store envelope.

    PYTHONPATH=src python -m repro_torch.measure [--reduced] [--name NAME]
        [--ranks R] [--device cuda|cpu] [out.json]

Runs on the card unless ``--device cpu``.  Without an output path the
envelope lands in the default store (``$REPRO_TORCH_MEASURE_DIR`` or
``~/.cache/repro_torch/measure``) under the running system's
fingerprint, where ``load_or_calibrate()`` finds it.
"""

from __future__ import annotations

import argparse
import time

from repro_torch.measure.bench import RANKS, calibrate_params
from repro_torch.measure.fingerprint import system_description
from repro_torch.measure.store import ParamsStore


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.measure")
    ap.add_argument("out", nargs="?", default=None,
                    help="output JSON path (default: the params store)")
    ap.add_argument("--reduced", action="store_true",
                    help="small CPU-test grid instead of the full sweep")
    ap.add_argument("--name", default=None, help="params table name")
    ap.add_argument("--ranks", type=int, default=RANKS,
                    help="local-mesh ranks every launch serves")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    store = ParamsStore(ranks=args.ranks, device=args.device)
    t0 = time.perf_counter()
    params = calibrate_params(name=args.name, reduced=args.reduced,
                              ranks=args.ranks, device=args.device)
    secs = time.perf_counter() - t0
    path = store.save(params, path=args.out)
    print(f"system: {store.system()} "
          f"{list(system_description(args.ranks, args.device))}")
    print(f"calibrated in {secs:.2f} s; measured strategies: "
          f"{sorted((params.pack_table or {}).keys())}")
    print(f"wire fit: latency={params.wire_latency} bw={params.wire_bw}; "
          f"hbm_bw={params.hbm_bw}")
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
