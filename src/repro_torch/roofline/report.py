"""Render the dry run's tables from its JSONL records (the port of the
reference's ``repro.roofline.report``; the same records give the same
strings, so either package's records render here).

    PYTHONPATH=src python -m repro_torch.roofline.report results/*.jsonl
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List


def load(paths) -> List[Dict]:
    recs = []
    for p in paths:
        with open(p) as f:
            recs.extend(json.loads(l) for l in f if l.strip())
    return recs


def fmt_bytes(n) -> str:
    return f"{n/2**30:.2f}"


def dryrun_table(recs: List[Dict]) -> str:
    rows = [
        "| arch | shape | mesh | status | args GiB/dev | temp GiB/dev | "
        "flops/dev | bytes/dev | coll bytes/dev | top collectives |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["status"] != "OK":
            rows.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                f"{r['status']}: {r.get('reason', r.get('error', ''))[:60]} "
                f"| | | | | | |"
            )
            continue
        coll = r.get("coll_by_kind", {})
        top = ", ".join(
            f"{k}:{v:.2e}" for k, v in
            sorted(coll.items(), key=lambda kv: -kv[1])[:2]
        )
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | OK | "
            f"{fmt_bytes(r.get('argument_size_in_bytes', 0))} | "
            f"{fmt_bytes(r.get('temp_size_in_bytes', 0))} | "
            f"{r['flops_per_device']:.2e} | {r['bytes_per_device']:.2e} | "
            f"{r['coll_bytes_per_device']:.2e} | {top} |"
        )
    return "\n".join(rows)


def roofline_table(recs: List[Dict]) -> str:
    rows = [
        "| arch | shape | mesh | compute ms | memory ms | collective ms | "
        "bottleneck | MODEL/HLO flops | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["status"] != "OK":
            rows.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                f"{r['status']} | | | | | |"
            )
            continue
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r['t_compute_ms']:.2f} | {r['t_memory_ms']:.2f} | "
            f"{r['t_collective_ms']:.2f} | {r['bottleneck']} | "
            f"{r['useful_flops_ratio']:.2f} | {r['roofline_fraction']:.2f} |"
        )
    return "\n".join(rows)


def main():
    recs = load(sys.argv[1:])
    print("## Dry-run\n")
    print(dryrun_table(recs))
    print("\n## Roofline\n")
    print(roofline_table(recs))


if __name__ == "__main__":
    main()
