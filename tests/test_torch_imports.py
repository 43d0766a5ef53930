"""The port stands alone and defaults to the card.

* In a fresh interpreter, importing every module of ``repro_torch``
  pulls in neither ``jax`` nor any module of the reference package
  ``repro``, builds or loads no kernel, and starts no process group
  (``repro_torch.launch`` included, the mesh modules
  ``repro_torch.distributed`` and ``repro_torch.launch.mesh``, and the dry
  run and roofline, ``repro_torch.launch.{dryrun,diagnose}`` and
  ``repro_torch.roofline``).
* Every entry point runs on the card unless the caller passes
  ``device="cpu"``: without a card it raises instead of quietly running
  on the host.  That holds for the observed entry points too
  (``production_communicator(tracer=True, telemetry=True)``, the
  ``Interposer`` shim), the serving path (``ServeLoop``,
  ``run_smoother``, ``build_model`` and both CLIs) and the training path
  (``synthetic_batch``, ``train`` and its CLI, which runs with
  ``--device cpu``).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.comm import Communicator, as_communicator
from repro_torch.comm.interposer import Interposer
from repro_torch.device import resolve_device
from repro_torch.halo import HaloSpec, from_reference, make_halo_step
from repro_torch.configs import smoke_config
from repro_torch.launch.serve import ServeLoop
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.smoother import main as smoother_main
from repro_torch.launch.smoother import run_smoother
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import train
from repro_torch.data import synthetic_batch
from repro_torch.configs import ShapeConfig
from repro_torch.measure import production_communicator
from repro_torch.models import build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IMPORT_ALL = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [
    m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
]
for name in names:
    importlib.import_module(name)
from repro_torch.kernels import build
import torch.distributed as dist
assert not build._LIBS, "a kernel library was loaded at import time"
assert not dist.is_initialized(), "a process group was started at import time"
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "repro"
             or m.startswith("repro."))
print("MODULES", len(names))
print("HALO", sorted(m for m in names if m.startswith("repro_torch.halo.")))
print("LAUNCH", sorted(m for m in names if m.startswith(("repro_torch.launch.",
                                                         "repro_torch.comm.d"))))
print("COMPRESS", "repro_torch.comm.compress" in names)
print("SCALE", sorted(m for m in names if m in ("repro_torch.comm.scale", "repro_torch.train",
                                               "repro_torch.train.elastic")))
print("OBS", sorted(m for m in names if m.startswith(("repro_torch.obs", "repro_torch.fleet"))))
print("SHIMS", sorted(m for m in names if m in ("repro_torch.comm.interposer",
                                               "repro_torch.comm.calibrate")))
print("SERVING", sorted(m for m in names if m.startswith(("repro_torch.models",
                                                          "repro_torch.configs"))))
print("TRAIN", sorted(m for m in names if m.startswith(("repro_torch.data",
                                                        "repro_torch.train."))))
print("MESH", sorted(m for m in names if m.startswith(("repro_torch.distributed",
                                                       "repro_torch.launch.mesh"))))
print("ROOFLINE", sorted(m for m in names if m.startswith(("repro_torch.roofline",
                                                           "repro_torch.launch.d"))))
print("FORBIDDEN", bad)
"""


def test_no_module_imports_jax_or_the_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(IMPORT_ALL)],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines())
    assert int(lines["MODULES"]) >= 20
    assert lines["HALO"] == str(["repro_torch.halo.exchange", "repro_torch.halo.program",
                                 "repro_torch.halo.stencil"])
    assert lines["LAUNCH"] == str(["repro_torch.comm.distributed",
                                   "repro_torch.launch.diagnose",
                                   "repro_torch.launch.dryrun",
                                   "repro_torch.launch.mesh",
                                   "repro_torch.launch.procgroup",
                                   "repro_torch.launch.serve",
                                   "repro_torch.launch.smoother",
                                   "repro_torch.launch.stencil3d",
                                   "repro_torch.launch.train"])
    assert lines["COMPRESS"] == "True"
    assert lines["SCALE"] == str(["repro_torch.comm.scale", "repro_torch.train",
                                  "repro_torch.train.elastic"])
    assert lines["OBS"] == str([
        "repro_torch.fleet", "repro_torch.fleet.__main__", "repro_torch.fleet.bundle",
        "repro_torch.fleet.drift", "repro_torch.fleet.telemetry", "repro_torch.obs",
        "repro_torch.obs.__main__", "repro_torch.obs.export", "repro_torch.obs.metrics",
        "repro_torch.obs.trace"])
    assert lines["SHIMS"] == str(["repro_torch.comm.calibrate", "repro_torch.comm.interposer"])
    arch_modules = ["grok_1_314b", "h2o_danube_1_8b", "mixtral_8x22b", "qwen2_0_5b",
                    "qwen2_vl_2b", "qwen3_32b", "rwkv6_7b", "seamless_m4t_large_v2", "yi_6b",
                    "zamba2_2_7b"]
    assert lines["SERVING"] == str(sorted(
        ["repro_torch.configs", "repro_torch.configs.base", "repro_torch.configs.registry",
         "repro_torch.models", "repro_torch.models.blocks", "repro_torch.models.frontends",
         "repro_torch.models.layers", "repro_torch.models.linear_attn",
         "repro_torch.models.model"] + [f"repro_torch.configs.{m}" for m in arch_modules]))
    assert lines["TRAIN"] == str([
        "repro_torch.data", "repro_torch.data.pipeline", "repro_torch.train.checkpoint",
        "repro_torch.train.elastic", "repro_torch.train.grad_wire",
        "repro_torch.train.optimizer", "repro_torch.train.train_step"])
    assert lines["MESH"] == str(["repro_torch.distributed", "repro_torch.distributed.sharding",
                                 "repro_torch.launch.mesh"])
    assert lines["ROOFLINE"] == str(["repro_torch.launch.diagnose", "repro_torch.launch.dryrun",
                                     "repro_torch.roofline", "repro_torch.roofline.analysis",
                                     "repro_torch.roofline.op_cost",
                                     "repro_torch.roofline.report"])
    assert lines["FORBIDDEN"] == "[]"


def test_entry_points_default_to_the_card():
    spec = HaloSpec(grid=(2, 2, 2), interior=(4, 4, 4), radius=2)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Communicator()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_halo_step(spec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_reference(np.zeros((8,) + spec.alloc, np.float32), spec)
    with pytest.raises(ValueError, match="cuda or cpu"):
        resolve_device("meta")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Interposer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        production_communicator(calibrate=False, tracer=True, telemetry=True)
    cfg = smoke_config("qwen2-0.5b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeLoop(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_smoother()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        smoother_main(["--comm-cache", "unused"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_main(["--no-comm-cache"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_main(["--no-comm-cache", "--scale", "smoke", "--arch", "qwen2-0.5b"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(cfg, 1, 8, 2, "unused")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthetic_batch(cfg, ShapeConfig("t", 8, 2, "train"), 0)


def test_entry_points_run_on_the_cpu_when_asked():
    spec = HaloSpec(grid=(2, 2, 2), interior=(4, 4, 4), radius=2)
    comm = Communicator(device="cpu")
    step = make_halo_step(spec, comm, device="cpu")
    local = from_reference(np.zeros((8,) + spec.alloc, np.float32), spec, device="cpu")
    assert step(local).device.type == "cpu"
    assert comm.device == torch.device("cpu")


def test_observed_entry_points_run_on_the_cpu_when_asked(tmp_path):
    ip = Interposer(device="cpu")
    assert ip.comm.device == torch.device("cpu")
    comm, save = production_communicator(tmp_path, device="cpu", calibrate=False,
                                          tracer=True, telemetry=True)
    spec = HaloSpec(grid=(2, 2, 2), interior=(4, 4, 4), radius=1)
    local = from_reference(np.zeros((8,) + spec.alloc, np.float32), spec, device="cpu")
    assert make_halo_step(spec, comm, device="cpu")(local).device.type == "cpu"
    assert as_communicator(ip) is ip.comm
    save()
    assert (tmp_path / "metrics.json").exists() and (tmp_path / "telemetry.json").exists()


def test_serving_entry_points_run_on_the_cpu_when_asked():
    loop = ServeLoop(smoke_config("qwen2-0.5b"), 1, 8, device="cpu")
    assert loop.model.device == torch.device("cpu") and loop.cache["k"].device.type == "cpu"
    report = run_smoother(Communicator(device="cpu"), ranks=2, halo_steps=1)
    assert report.program.spec.grid == (2, 1, 1)


def test_training_entry_point_runs_on_the_cpu_when_asked(tmp_path):
    from repro_torch.halo.program import get_default_halo_steps, set_default_halo_steps

    before = get_default_halo_steps()  # the CLI installs the process-wide depth
    try:
        out = train_main(["--arch", "qwen2-0.5b", "--scale", "smoke", "--device", "cpu",
                         "--no-comm-cache", "--steps", "1", "--seq-len", "8",
                         "--global-batch", "2", "--ckpt-dir", str(tmp_path)])
    finally:
        set_default_halo_steps(before)
    assert out["model"].device == torch.device("cpu") and len(out["losses"]) == 1
    assert all(p.device.type == "cpu" for p in out["params"].values())


def test_chip_smoke_imports_neither_jax_nor_the_reference():
    """``chip_smoke.py`` names no import of ``jax`` or ``repro``, and
    loading it (its phases import the port lazily) pulls in neither."""
    import re

    path = os.path.join(REPO, "chip_smoke.py")
    src = open(path).read()
    assert not re.findall(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?:\.|\s|$)", src, re.M)
    code = (f"import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location('chip_smoke', {path!r})\n"
            f"spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
