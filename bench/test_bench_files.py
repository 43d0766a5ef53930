"""The benchmark's files: every cell's configuration, traffic, limits and
per-layer readers found by name, ``BENCHMARK.json`` within its contract,
and the harness's own arithmetic (the 95th percentile, the roofline
bytes) against hand counts."""

import json
import re
from pathlib import Path

import pytest

from bench import roofline, run, timing

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_keys_and_names():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["bench"] and BENCH["command"] == ["python3", "bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [e["name"] for part in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[part]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25, m
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    spec = run.load_cell(cell)
    loop = spec["traffic"]["loop"]
    assert (ROOT / "bench" / "loops" / f"{loop}.py").is_file()
    assert set(spec["limits"]) and all(v >= 0 for v in spec["limits"].values())
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec["per_layer"]
    for m in spec["per_layer"]:
        assert m["moves"] in e2e, (cell, m["name"])
        assert callable(run._reader(m["name"]))
    assert spec["traffic"]["buffers"] >= 1
    for key in ("grid", "interior", "ops", "policy", "source"):
        assert key in spec["config"], key


def test_every_config_is_used_and_its_file_is_its_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("bench/configs/")
        assert json.loads((ROOT / c["file"]).read_text())["source"] == c["source"]


def test_p95_takes_every_sample():
    assert timing.p95(list(range(1, 101))) == 95
    assert timing.p95([5.0] * 19 + [100.0]) == 5.0
    assert timing.p95([5.0] * 18 + [100.0, 200.0]) == 100.0
    assert timing.p95([3.0, 1.0, 2.0]) == 3.0
    with pytest.raises(ValueError):
        timing.p95([])


def test_stencil_bytes_against_a_hand_count():
    # interior 4^3 behind a radius-2 halo, two radius-1 applications:
    # the first reads 8^3 and writes 6^3, the second reads 6^3, writes 4^3
    assert roofline.stencil_iteration_bytes((4, 4, 4), (2, 2, 2), [(1, 1, 1)], 2) == \
        4 * (8 ** 3 + 6 ** 3 + 6 ** 3 + 4 ** 3)
    # a (2, 1, 1) then (1, 1, 1) cycle once behind a (3, 2, 2) halo
    assert roofline.stencil_iteration_bytes((4, 4, 4), (3, 2, 2), [(2, 1, 1), (1, 1, 1)], 1) \
        == 4 * (10 * 8 * 8 + 6 * 6 * 6 + 6 * 6 * 6 + 4 * 4 * 4)
    with pytest.raises(ValueError):
        roofline.stencil_iteration_bytes((4, 4, 4), (1, 1, 1), [(1, 1, 1)], 2)


def test_pack_bytes_against_a_hand_count():
    # 6 faces of 4x4x1, 12 edges of 4x1x1, 8 corners of 1: 152 cells
    assert roofline.packed_bytes((4, 4, 4), (1, 1, 1)) == 4 * 152
    assert roofline.pack_unpack_bytes((4, 4, 4), (1, 1, 1)) == 16 * 152
    # 256^3 at radius 2: 3,195,136 bytes a rank; 512^3: 12,712,064
    assert roofline.packed_bytes((256,) * 3, (2, 2, 2)) == 3_195_136
    assert roofline.packed_bytes((512,) * 3, (2, 2, 2)) == \
        4 * (6 * 512 * 512 * 2 + 12 * 512 * 2 * 2 + 8 * 2 * 2 * 2)


def test_peaks_by_card_name():
    assert roofline.peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == 3.35e12
    assert roofline.peaks("cpu") is None
