"""The port's in-launch smoother (``repro_torch.launch.smoother``) against
the JAX reference, on the CPU.

* The reference's ``test_smoother.py`` cases: the named cycles, a first
  run that records a ``program/s=N`` row and a rerun over the same store
  that pins it with a bit-equal checksum, a fixed depth and the summary.
* The checksum against the reference's to 1e-5 relative: at R = 1 in
  process, and at R = 8 against the reference in one subprocess with 8
  host devices (planned without the native ragged collective, which
  XLA:CPU cannot run).  The diffusion conserves the interior sum, so the
  field after the run is also held against a ``torch.roll`` oracle of
  the cycle on the global periodic field (rtol = atol = 1e-5).
* Overlap modes give the plain run's field bit for bit.
* The observed path: per-iteration telemetry against the program's
  prediction, one attributed span tree per iteration (the reference's
  ``test_run_smoother_traced_exchanges_bounded_by_iterations``), and the
  tracer's aggregates feeding the drift audit (the smoother half of the
  reference's ``test_tracer_aggregates_feed_audit_end_to_end``).
* The CLI: ``--assert-decision`` prints ``SMOOTHER_DECISION_OK``, and
  ``launch.stencil3d --cycle predictor-corrector`` in one process gives
  the local mesh's field.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.comm.api import Communicator as RefCommunicator
from repro.launch.smoother import run_smoother as ref_run_smoother
from repro_torch.comm import Communicator
from repro_torch.fleet import DriftDetector, ExchangeTelemetry
from repro_torch.halo import (
    STENCIL26,
    build_halo_program,
    get_default_halo_steps,
    set_default_halo_steps,
)
from repro_torch.launch import smoother as smoother_cli
from repro_torch.launch.smoother import CYCLES, run_smoother, smoother_cycle
from repro_torch.measure import DecisionCache, production_communicator
from repro_torch.obs import Tracer
from tests._subproc import run_with_devices


@pytest.fixture
def default_steps():
    before = get_default_halo_steps()
    yield
    set_default_halo_steps(before)


def roll_oracle(R, interior, cycle, applications_per_iter, iters, seed=0):
    """The smoother's field after ``iters`` iterations, computed on the
    global periodic (R*nz, ny, nx) field with ``torch.roll``."""
    nz, ny, nx = interior
    g = torch.from_numpy(
        np.random.default_rng(seed).normal(size=(R, nz, ny, nx)).astype(np.float32)
    ).reshape(R * nz, ny, nx)
    ops = smoother_cycle(cycle)
    for i in range(iters * applications_per_iter):
        op = ops[i % len(ops)]
        acc = torch.zeros_like(g)
        for dz, dy, dx in op.offsets:
            acc += torch.roll(g, (-dz, -dy, -dx), (0, 1, 2))
        g = (1 - op.weight) * g + (op.weight / op.nneighbors) * acc
    return g.reshape(R, nz, ny, nx)


class TestSmootherCycle:
    def test_named_cycles(self):
        assert smoother_cycle("smooth") == (STENCIL26,)
        pc = smoother_cycle("predictor-corrector")
        assert len(pc) == 2
        assert pc[0].radii == (2, 1, 1) and pc[1].radii == (1, 1, 1)
        assert (pc[0].weight, pc[1].weight) == (0.5, 0.25)
        assert set(CYCLES) == {"smooth", "predictor-corrector"}
        with pytest.raises(ValueError, match="unknown smoother cycle"):
            smoother_cycle("laplacian")
        with pytest.raises(ValueError, match="unknown overlap"):
            run_smoother(Communicator(device="cpu"), overlap="sometimes")


class TestRunSmoother:
    def test_records_program_decision_and_pins_rerun(self, tmp_path, default_steps):
        comm, save = production_communicator(tmp_path, device="cpu", calibrate=False,
                                              halo_steps="auto")
        report = run_smoother(comm, iters=1, interior=(8, 8, 8), cycle="predictor-corrector")
        assert report.decision_recorded
        assert not report.program.pinned  # first run prices, not pins
        assert report.program.cycle_len == 2
        assert report.program.spec.grid == (8, 1, 1)  # the local mesh's 8 ranks
        assert np.isfinite(report.checksum)
        rows = comm.model.decisions.program_rows()
        assert len(rows) == 1
        assert rows[0].strategy == f"program/s={report.program.steps}"
        save()

        # the rerun: a fresh production communicator over the same store
        # pins the depth and reproduces the field bit-exactly
        comm2, _ = production_communicator(tmp_path, device="cpu", calibrate=False,
                                           halo_steps="auto")
        report2 = run_smoother(comm2, iters=1, interior=(8, 8, 8), cycle="predictor-corrector")
        assert report2.program.pinned
        assert report2.program.steps == report.program.steps
        assert report2.checksum == report.checksum
        assert report2.decision_recorded

    def test_fixed_depth_and_summary(self, tmp_path, default_steps):
        comm, _ = production_communicator(tmp_path, device="cpu", calibrate=False, halo_steps=1)
        report = run_smoother(comm, iters=2, interior=(6, 6, 6), cycle="smooth")
        assert report.program.steps == 1
        assert report.iterations == 2
        assert "smoother:" in report.summary
        assert "exchanges/cycle=1.00" in report.summary
        assert not report.decision_recorded  # a fixed depth records no row

    @pytest.mark.parametrize("cycle,steps", [("predictor-corrector", 2)])
    def test_checksum_matches_the_reference_one_rank(self, cycle, steps):
        got = run_smoother(Communicator(device="cpu"), iters=2, interior=(8, 8, 8),
                           cycle=cycle, halo_steps=steps, ranks=1)
        want = ref_run_smoother(RefCommunicator(axis_name="data"), iters=2,
                                interior=(8, 8, 8), cycle=cycle, halo_steps=steps)
        assert got.summary.replace(f"{got.checksum:.6e}", "") == want.summary.replace(
            f"{want.checksum:.6e}", "")
        assert got.program.fingerprint == want.program.fingerprint
        assert got.checksum == pytest.approx(want.checksum, rel=1e-5)

    @pytest.mark.parametrize("cycle,steps", [("smooth", 2), ("predictor-corrector", 1)])
    def test_field_matches_the_roll_oracle(self, cycle, steps):
        rep = run_smoother(Communicator(device="cpu"), iters=2, interior=(6, 6, 6),
                           cycle=cycle, halo_steps=steps, keep_state=True)
        rz, ry, rx = rep.program.spec.radii
        got = rep.state[:, rz:rz + 6, ry:ry + 6, rx:rx + 6]
        want = roll_oracle(8, (6, 6, 6), cycle, rep.program.applications, 2)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        assert rep.checksum == float(got.numpy().sum())

    @pytest.mark.parametrize("overlap", ["monolithic", "region", "auto"])
    def test_overlap_modes_are_bit_identical(self, overlap):
        plain = run_smoother(Communicator(device="cpu", decisions=DecisionCache()), iters=2,
                             interior=(6, 6, 6), cycle="predictor-corrector", halo_steps=1)
        comm = Communicator(device="cpu", decisions=DecisionCache())
        over = run_smoother(comm, iters=2, interior=(6, 6, 6), cycle="predictor-corrector",
                            halo_steps=1, overlap=overlap)
        assert over.checksum == plain.checksum
        modes = [d.strategy for d in comm.model.decisions.log
                 if d.strategy.startswith("overlap/mode=")]
        assert len(modes) == (overlap == "auto")  # auto records its pick

    def test_runs_on_the_card_unless_asked(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the smoother runs on it")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_smoother()
        assert np.isfinite(run_smoother(device="cpu", ranks=2, halo_steps=1).checksum)


REFERENCE_CODE = r"""
import json
import repro.compat
repro.compat.has_ragged_all_to_all = lambda: False
from repro.comm.api import Communicator
from repro.launch.smoother import run_smoother

out = {{}}
for cycle, steps in {cases!r}:
    rep = run_smoother(Communicator(axis_name="data"), iters=2, interior=(6, 6, 6),
                       cycle=cycle, halo_steps=steps)
    out[f"{{cycle}}/{{steps}}"] = [rep.checksum, rep.program.fingerprint, rep.program.steps]
print("JSON " + json.dumps(out))
"""

CASES_8 = (("predictor-corrector", 1),)


def test_checksum_matches_the_reference_8_ranks():
    log = run_with_devices(REFERENCE_CODE.format(cases=CASES_8), ndev=8)
    want = json.loads(next(l for l in log.splitlines() if l.startswith("JSON "))[5:])
    for cycle, steps in CASES_8:
        got = run_smoother(Communicator(device="cpu"), iters=2, interior=(6, 6, 6),
                           cycle=cycle, halo_steps=steps)
        checksum, fingerprint, ref_steps = want[f"{cycle}/{steps}"]
        assert (got.program.fingerprint, got.program.steps) == (fingerprint, ref_steps)
        assert got.checksum == pytest.approx(checksum, rel=1e-5)


class TestObserved:
    def test_traced_exchanges_bounded_by_iterations(self):
        tr = Tracer()
        comm = Communicator(device="cpu", decisions=DecisionCache(), tracer=tr)
        report = run_smoother(comm, iters=3, interior=(8, 8, 8), cycle="smooth", halo_steps=2)
        iters = [s for s in tr.spans if s.name == "program_iteration"]
        ex = [s for s in tr.spans if s.name == "exchange"]
        assert len(iters) == 3
        assert len(ex) <= len(iters)
        assert all(s.attrs["fingerprint"] == report.program.fingerprint for s in ex)
        assert all(s.attrs.get("attributed") for s in iters)
        assert comm.tracer is tr  # reattached after the timed loop

    def test_tracer_aggregates_feed_audit_end_to_end(self):
        tr = Tracer()
        decisions = DecisionCache()
        comm = Communicator(device="cpu", decisions=decisions, tracer=tr)
        run_smoother(comm, iters=4, interior=(8, 8, 8), cycle="smooth", halo_steps="auto")
        rep = DriftDetector(min_samples=2).audit(decisions, comm.model.params,
                                                 trace=tr.phase_aggregates())
        prog = [f for f in rep.findings if f.strategy.startswith("program/")]
        assert len(prog) == 1
        assert prog[0].source == "trace"
        assert prog[0].phase_ratios
        assert prog[0].samples >= 4

    def test_telemetry_observes_each_iteration(self):
        tel = ExchangeTelemetry()
        comm = Communicator(device="cpu", decisions=DecisionCache(), telemetry=tel)
        report = run_smoother(comm, iters=3, interior=(6, 6, 6), halo_steps=1)
        agg = tel.get(report.program.fingerprint)
        assert agg.count == 3 and agg.strategy == f"program/s={report.program.steps}"
        assert agg.predicted > 0 and agg.ratio is not None
        assert comm.telemetry is tel  # reattached after the timed loop

    def test_class_attribution_under_overlap(self):
        tr = Tracer()
        comm = Communicator(device="cpu", decisions=DecisionCache(), tracer=tr)
        run_smoother(comm, iters=2, interior=(6, 6, 6), halo_steps=1, overlap="region")
        assert len([s for s in tr.spans if s.name == "program_iteration"]) == 2
        assert [s for s in tr.spans if s.name == "wire_class"]


def test_cli_assert_decision(tmp_path, capsys, default_steps):
    argv = ["--device", "cpu", "--comm-cache", str(tmp_path), "--assert-decision",
            "--trace", str(tmp_path / "t.json"), "--telemetry"]
    assert smoother_cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "SMOOTHER_DECISION_OK" in out and "decision: program/s=" in out
    assert "trace (" in out and (tmp_path / "t.json").exists()
    assert smoother_cli.main(argv) == 0
    assert " (pinned) " in capsys.readouterr().out


def test_stencil3d_predictor_corrector_one_process(tmp_path):
    from repro_torch.launch import stencil3d

    out = tmp_path / "field.npy"
    assert stencil3d.main(["--nprocs", "1", "--backend", "gloo", "--device", "cpu",
                           "--interior", "6", "--iters", "1", "--halo-steps", "1",
                           "--cycle", "predictor-corrector", "--out", str(out)]) == 0
    comm = Communicator(device="cpu")
    prog = build_halo_program((1, 1, 1), (6, 6, 6), comm, steps=1,
                              ops=smoother_cycle("predictor-corrector"))
    want = roll_oracle(1, (6, 6, 6), "predictor-corrector", prog.applications, 1)
    torch.testing.assert_close(torch.from_numpy(np.load(out)), want, rtol=1e-5, atol=1e-5)
