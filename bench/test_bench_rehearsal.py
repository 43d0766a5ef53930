"""Each cell rehearsed on the CPU at a tiny size through the same
runner, in a process of its own: it comes out correct, reports the
cell's metrics, and loads no module of JAX or of the JAX package.  The
command itself exits 2, printing nothing, where there is no card."""

import json
import subprocess
import sys
from pathlib import Path

from bench import run

ROOT = Path(__file__).resolve().parents[1]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]

REHEARSE = """
import json, sys
from bench import run
out = {}
for cell in sys.argv[1:]:
    spans = 0.2 if run.load_cell(cell)["traffic"]["span_seconds"] else 0
    for trace in (False, True):
        out[f"{cell}/{int(trace)}"] = run.run_cell(
            cell, 2**31 + 11, 0.3, trace, device="cpu",
            overrides={"config": {"interior": [6, 6, 6]},
                       "traffic": {"profile_seconds": 0.2, "span_seconds": spans}})
print(json.dumps({"lines": out, "loaded": run.forbidden_modules()}))
"""


def test_one_chip_cells_rehearse_on_the_cpu():
    proc = subprocess.run([sys.executable, "-c", REHEARSE, *CELLS], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["loaded"] == []
    for cell in CELLS:
        spec = run.load_cell(cell)
        plain, traced = res["lines"][f"{cell}/0"], res["lines"][f"{cell}/1"]
        for line in (plain, traced):
            assert line["correct"] is True, (cell, line["checks"])
            assert line["forbidden"] == []
            assert list(line)[-1] == "checks"
            assert line["attempted"] > 0 and line["failed"] == 0
        assert set(plain["metrics"]) == {m["name"] for m in spec["end_to_end"]}
        # spans and counters read on the CPU; device shares need the card
        spans = {m["name"] for m in spec["per_layer"] if m["source"] != "device_trace"}
        assert spans - {"stencil_roofline"} <= set(traced["metrics"]), (cell, traced["metrics"])
        assert traced["device"]["busy_s"] is None


def test_no_result_without_a_card(tmp_path):
    proc = subprocess.run([sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed",
                           "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and proc.stdout == ""
    assert "CUDA device" in proc.stderr
