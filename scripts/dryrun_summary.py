#!/usr/bin/env python3
"""One markdown table of the dry run's records, a row per (arch x shape)
with the 16x16 and 2x16x16 meshes side by side ("a / b"): report.py's
two tables folded into one, with each cell's walk seconds.

    python3 scripts/dryrun_summary.py dryrun.jsonl [more.jsonl ...]

The records are ``python -m repro_torch.launch.dryrun --out``'s (or the
reference's: the same keys).
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Tuple

MESHES = ("16x16", "2x16x16")


#: per column, a record's entry
_COLS = (
    lambda r: f"{r['flops_per_device']:.2e}",
    lambda r: f"{r['bytes_per_device']:.2e}",
    lambda r: f"{r['coll_bytes_per_device']:.2e}",
    lambda r: f"{r['argument_size_in_bytes'] / 2**30:.2f}, {r['temp_size_in_bytes'] / 2**30:.2f}",
    lambda r: f"{r['t_compute_ms']:.2f}, {r['t_memory_ms']:.2f}, {r['t_collective_ms']:.2f}",
    lambda r: r["bottleneck"],
    lambda r: f"{r['useful_flops_ratio']:.2f}",
    lambda r: str(r["walk_s"]),
)


def _pair(recs, fmt) -> str:
    return " / ".join(fmt(r) if r and r["status"] == "OK" else (r["status"] if r else "-")
                      for r in recs)


def summary(records: List[Dict]) -> str:
    cells: Dict[Tuple[str, str], Dict[str, Dict]] = {}
    for r in records:
        cells.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r
    rows = [
        "| arch | shape | flops/dev | bytes/dev | coll bytes/dev | args / temp GiB a dev | "
        "compute / memory / collective ms | bottleneck | MODEL/HLO flops | walk s |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for (arch, shape), by_mesh in cells.items():
        recs = [by_mesh.get(m) for m in MESHES]
        if all(r and r["status"] == "SKIP" for r in recs):
            rows.append(f"| {arch} | {shape} | SKIP: {recs[0]['reason']} | | | | | | | |")
            continue
        rows.append(f"| {arch} | {shape} | " + " | ".join(_pair(recs, c) for c in _COLS) + " |")
    return "\n".join(rows)


def main() -> None:
    records = []
    for path in sys.argv[1:]:
        with open(path) as f:
            records.extend(json.loads(line) for line in f if line.strip())
    print(summary(records))


if __name__ == "__main__":
    main()
