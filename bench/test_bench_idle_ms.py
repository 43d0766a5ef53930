"""The ``idle_ms.*`` readers on hand-made profiles: the device idle
seconds the harness charged to the program's ``tempi.<phase>`` range, in
milliseconds per exchange; 0.0 for a phase charged nothing; None without
a device trace (the CPU) or where no gap is charged to any ``tempi.*``
range (a program without the ranges)."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from bench import run

ROOT = Path(__file__).resolve().parents[1]
PHASES = {"prep": "communicator", "pack": "kernels", "wire": "transport", "unpack": "kernels"}


def _ctx(gaps, calls=200):
    prof = {"stats": {"calls": calls}, "window_s": 3.0, "device_s": {}}
    if gaps is not None:
        prof.update(busy_s=0.5, idle_gaps=gaps)
    return SimpleNamespace(profile=prof)


@pytest.mark.parametrize("phase", PHASES)
def test_milliseconds_per_call_of_the_gaps_charged_to_the_range(phase):
    gaps = {f"tempi.{p}": 0.01 * (i + 1) for i, p in enumerate(PHASES)}
    gaps.update({"host (no op)": 0.5, "aten::view": 0.25, "tempi.exchange": 0.125})
    got = run._reader(f"idle_ms.{phase}")(_ctx(gaps))
    assert got == pytest.approx(1e3 * gaps[f"tempi.{phase}"] / 200, rel=1e-12)


@pytest.mark.parametrize("phase", PHASES)
def test_a_phase_charged_no_gap_reads_zero(phase):
    gaps = {f"tempi.{p}": 0.02 for p in PHASES if p != phase}
    assert run._reader(f"idle_ms.{phase}")(_ctx(gaps)) == 0.0


@pytest.mark.parametrize("phase", PHASES)
def test_none_without_a_device_trace_or_without_ranges(phase):
    read = run._reader(f"idle_ms.{phase}")
    assert read(_ctx(None)) is None
    assert read(_ctx({"host (no op)": 0.7, "aten::view": 0.08})) is None


def test_the_four_metrics_are_the_exchange_cells_and_read_the_device_trace():
    entries = {m["name"]: m for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]}
    for phase, layer in PHASES.items():
        assert entries[f"idle_ms.{phase}"] == {
            "name": f"idle_ms.{phase}", "unit": "ms", "better": "lower",
            "source": "device_trace", "layer": layer, "moves": "exchange_ms",
            "workloads": ["stencil26.exchange"]}
