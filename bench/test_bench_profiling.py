"""The traced run's reduction (:func:`bench.profiling.reduce_events`) on
a hand-built event tree, and the ``shell_ms`` reader: device seconds by
the innermost ``tempi.*`` range around each operation's launch, the
profile's other outputs as they were, and None where nothing links."""

from types import SimpleNamespace

import pytest
import torch

from bench import profiling, run

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _ev(name, id, a, b, dev=CPU, parent=None, annotation=False):
    return SimpleNamespace(name=name, id=id, time_range=SimpleNamespace(start=a, end=b),
                           device_type=dev, cpu_parent=parent, is_user_annotation=annotation)


def _events(linked=True):
    """A kernel launched under an op inside ``tempi.shell`` and one
    launched in the range itself; one under ``tempi.interior`` on a side
    stream, overlapping; one under an op outside both; the device side's
    copy of the shell range; and a kernel whose id only a host op shares
    (no launch).  Times in microseconds, as the profiler gives them."""
    shell = _ev("tempi.shell", 1, 0.0, 100.0)
    copy = _ev("aten::copy_", 2, 10.0, 40.0, parent=shell)
    interior = _ev("tempi.interior", 3, 120.0, 200.0)
    add = _ev("aten::add", 4, 210.0, 240.0)
    launch = "cudaLaunchKernel" if linked else "aten::empty"
    host = [shell, copy, _ev(launch, 101, 15.0, 20.0, parent=copy),
            _ev(launch, 102, 50.0, 55.0, parent=shell), interior,
            _ev(launch, 103, 130.0, 135.0, parent=interior), add,
            _ev(launch, 104, 215.0, 220.0, parent=add),
            _ev("cudaDeviceSynchronize", 105, 250.0, 400.0)]
    device = [_ev("copy_kernel", 101, 30.0, 90.0, CUDA),
              _ev("shell_kernel", 102, 95.0, 160.0, CUDA),
              _ev("chain_kernel", 103, 150.0, 300.0, CUDA),
              _ev("add_kernel", 104, 320.0, 380.0, CUDA),
              _ev("tempi.shell", 1, 30.0, 160.0, CUDA, annotation=True),
              _ev("unlinked_kernel", 2, 390.0, 395.0, CUDA)]
    return host + device


@pytest.mark.parametrize("linked", [True, False])
def test_the_existing_outputs_as_before(linked):
    # the values the reduction gave before it split device time by range
    out = profiling.reduce_events(_events(linked))
    assert out["device_s"] == {"copy_kernel": 5.9999999999999995e-05, "shell_kernel": 6.5e-05,
                               "chain_kernel": 0.00015, "add_kernel": 5.9999999999999995e-05,
                               "tempi.shell": 0.00013, "unlinked_kernel": 4.9999999999999996e-06}
    assert out["busy_s"] == 0.000335
    assert out["idle_gaps"] == {"cudaDeviceSynchronize": 2.9999999999999997e-05}


def test_device_seconds_by_the_range_around_the_launch():
    by_range = profiling.reduce_events(_events())["device_s_by_range"]
    assert by_range == pytest.approx({"tempi.shell": 125e-6, "tempi.interior": 150e-6,
                                      profiling.NO_RANGE: 60e-6}, rel=1e-12)


def test_no_output_where_nothing_links():
    assert "device_s_by_range" not in profiling.reduce_events(_events(linked=False))
    host_only = profiling.reduce_events([e for e in _events() if e.device_type == CPU])
    assert host_only == {"device_s": {}}


def _ctx(by_range, calls=4):
    prof = {"stats": {"calls": calls}, "window_s": 1.0, "device_s": {}}
    if by_range is not None:
        prof["device_s_by_range"] = by_range
    return SimpleNamespace(profile=prof)


def test_shell_ms_reads_the_shell_ranges_per_iteration():
    read = run._reader("shell_ms")
    by_range = profiling.reduce_events(_events())["device_s_by_range"]
    assert read(_ctx(by_range, calls=2)) == pytest.approx(0.0625, rel=1e-12)
    assert read(_ctx(None)) is None  # no device trace
    assert read(_ctx({"tempi.interior": 0.5, profiling.NO_RANGE: 0.1})) is None
    assert read(_ctx(by_range, calls=0)) is None
