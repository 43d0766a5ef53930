"""DEPRECATED shim: system calibration lives in :mod:`repro_torch.measure`.

The reference's ``repro.comm.calibrate`` measured pack times only; the
measurement package (:mod:`repro_torch.measure.bench`) measures every
model term — pack, unpack, wire, contiguous copy, compress and stencil —
and :mod:`repro_torch.measure.store` persists the result keyed by a
system fingerprint.  This module keeps the old entry points working:

    measure_pack_table()  -> repro_torch.measure.bench.measure_pack_table
    calibrate()           -> repro_torch.measure.bench.calibrate_params
    python -m repro_torch.comm.calibrate [out.json] [--device cpu]
        (writes bare SystemParams JSON; prefer
        ``python -m repro_torch.measure``)

Calibration runs on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

from repro_torch.comm.perfmodel import SystemParams
from repro_torch.device import resolve_device
from repro_torch.measure.bench import calibrate_params, measure_pack_table

__all__ = ["measure_pack_table", "calibrate", "main"]


def calibrate(name: Optional[str] = None, device="cuda") -> SystemParams:
    """Full-term calibration on ``device`` (see
    :func:`repro_torch.measure.bench.calibrate_params`)."""
    return calibrate_params(name=name, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.comm.calibrate",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("out", nargs="?", default="system_params.json")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    params = calibrate(device=dev)
    with open(args.out, "w") as f:
        f.write(params.to_json())
    print(f"wrote {args.out} ({dev.type} backend)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
