"""Training on a device mesh: the port's ``train(mesh=...)`` in 4 gloo
processes on a (2, 2) ``("data", "model")`` mesh, against the JAX
reference's own 4-device ``train()`` and against the port's world of one.

Everything starts together, once for the module, under one deadline:
4 gloo processes over a ``file://`` store (no TCP port), the reference
on 4 host devices (it builds its (2, 2) test mesh itself), and one
process under a fake process group of 8.  Meanwhile this process runs
the world-of-one baselines.

* qwen2-0.5b and mixtral-8x22b (smoke, float32, seq 32 x batch 4), 2
  steps from the reference's initial checkpoint: the port's ``train()``
  builds the (2, 2) mesh itself in the world of 4, as the reference does
  on 4 devices.  Losses to rtol 1e-5, final parameters within 1e-4 of
  each leaf's largest entry (the zero-initialized biases, whose
  gradients are near zero, within 1e-4 absolute: see
  ``_close_to_largest``).
* Every one of the ten smoke configs (float32, remat on), and qwen2-0.5b
  with a vocabulary of 512 that the model axis shards, takes one step
  on an explicit (2, 2) mesh: loss and gradient norm to rtol 1e-5 of
  its world-of-one run, parameters within 1e-5 of each leaf's largest
  entry (the biases as above).
* The qwen2-0.5b checkpoint saved under (2, 2) restores bit-equal onto
  a (4, 1) mesh (``restore_checkpoint(shardings=...)``) and, without
  ``shardings``, in a world of one; the file holds the gathered state.
* ``train()`` in a world of 8 raises, naming the mesh it wants.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

import repro.configs.registry as rreg
import repro.train.checkpoint as rckpt
import repro.train.optimizer as ropt
from repro.models.model import build_model as ref_build_model

from repro_torch.configs import smoke_config
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.launch import train as ptrain
from repro_torch.models.model import params_to_reference
from repro_torch.train import checkpoint as pckpt
from tests._subproc import REPO

#: every process of this module ends within this many seconds
TIMEOUT_S = 150
WORLD = 4
SLICE = dict(seq_len=32, global_batch=4)
#: trained 2 steps against the reference's 4-device run
AGAINST_REF = ("qwen2-0.5b", "mixtral-8x22b")
#: one step on the mesh against the world of one: every smoke config, and
#: qwen2-0.5b with a vocabulary that the model axis shards (the smoke
#: vocabulary, 503, shards on no axis larger than 1)
ONE_STEP = {**{arch: (arch, {}) for arch in ARCH_IDS},
            "qwen2-0.5b+vocab512": ("qwen2-0.5b", {"vocab_size": 512})}


def _cfg(arch, **kw):
    return smoke_config(arch).replace(dtype="float32", **kw)


WORKER = r'''
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch.configs import smoke_config
from repro_torch.distributed.sharding import full_tensor
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.procgroup import destroy_process_group, init_process_group
from repro_torch.launch.train import train
from repro_torch.models.model import build_model
from repro_torch.train import checkpoint as ck

rank, world, store, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
cfgs = json.load(open(os.path.join(root, "config.json")))
init_process_group("gloo", device="cpu", store_path=store, rank=rank, world_size=world)


def full(tree):
    return {k: full_tensor(v).detach() for k, v in tree.items()}


def save(name, arrays):
    if rank == 0:
        np.savez(os.path.join(root, name), **{k: v.numpy() for k, v in arrays.items()})


res = {}
# 1. against the reference: train() meshes itself in a world of 4
for arch in cfgs["against_ref"]:
    cfg = smoke_config(arch).replace(dtype="float32")
    out = train(cfg, 2, cfgs["seq_len"], cfgs["global_batch"], os.path.join(root, arch, "port"),
                ckpt_every=2, device="cpu", log_every=100)
    mesh = next(iter(out["params"].values())).device_mesh
    res[arch] = {"losses": out["losses"], "mesh": [list(mesh.mesh_dim_names),
                                                   list(mesh.shape)]}
    save(f"port_{arch}.npz", full(out["params"]))
    if arch == "qwen2-0.5b":
        state = ck.train_state(out["model"], out["params"], out["opt_state"])
        save("saved_state.npz", {k: full_tensor(v).detach()
                                 for k, v in ck._flatten(state).items()})

# 2. every smoke config, one step on an explicit (2, 2) mesh
mesh22 = make_test_mesh(data=2, model=2, device_type="cpu")
for case, (arch, over) in cfgs["one_step"].items():
    cfg = smoke_config(arch).replace(dtype="float32", remat=True, **over)
    out = train(cfg, 1, cfgs["seq_len"], cfgs["global_batch"], os.path.join(root, "one", case),
                ckpt_every=100, device="cpu", log_every=100, mesh=mesh22)
    res[case + "/step"] = {"losses": out["losses"], "grad_norms": out["grad_norms"],
                           "vocab": [repr(p) for p in out["params"]["embed.vocab"].placements]}
    save(f"step_{case}.npz", full(out["params"]))

# 3. the (2, 2) checkpoint onto a (4, 1) mesh
mesh41 = make_test_mesh(data=4, model=1, device_type="cpu")
model = build_model(smoke_config("qwen2-0.5b").replace(dtype="float32"), device="cpu")
shardings = ck.train_state_shardings(model, mesh41)
step, tree = ck.restore_checkpoint(os.path.join(root, "qwen2-0.5b", "port"), shardings=shardings)
flat = ck._flatten(tree)
res["restore41"] = {"step": step, "placements": {
    k: [repr(p) for p in v.placements] for k, v in flat.items() if hasattr(v, "placements")}}
save("restored41.npz", {k: full_tensor(v).detach() for k, v in flat.items()})
if rank == 0:
    json.dump(res, open(os.path.join(root, "worker.json"), "w"))
dist.barrier()
destroy_process_group()
print("WORKER_OK", rank)
'''

REFERENCE = r'''
import json, os
import numpy as np
import jax
import repro.configs.registry as rreg
import repro.launch.train as rtrain
from repro.distributed.sharding import tree_paths

root = {root!r}
assert jax.device_count() == 4
out = {{}}
for arch in {archs!r}:
    cfg = rreg.smoke_config(arch).replace(dtype="float32")
    run = rtrain.train(cfg, steps=2, seq_len={seq}, global_batch={batch},
                       ckpt_dir=os.path.join(root, arch, "ref"), ckpt_every=100)
    out[arch] = run["losses"]
    np.savez(os.path.join(root, f"ref_{{arch}}.npz"),
             **{{k.replace("/", "."): np.asarray(v, np.float32)
                 for k, v in tree_paths(run["params"]).items()}})
json.dump(out, open(os.path.join(root, "ref.json"), "w"))
print("REFERENCE_OK")
'''

WORLD8 = r'''
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import smoke_config
from repro_torch.launch.train import train

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
try:
    train(smoke_config("qwen2-0.5b"), 1, 32, 4, {ckdir!r}, device="cpu")
except ValueError as e:
    print("RAISED", e)
'''


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _wait_all(procs, deadline):
    """Wait for every ``(name, Popen)``; on the deadline end them all and
    fail.  Returns ``{name: stdout}``."""
    outs = {}
    try:
        for name, p in procs:
            out, err = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            if p.returncode != 0:
                raise AssertionError(f"{name} failed (rc={p.returncode})\n{out}\n{err}")
            outs[name] = out
    except subprocess.TimeoutExpired:
        raise AssertionError(f"processes still running after {TIMEOUT_S} s") from None
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's initial checkpoints, then the gloo world, the
    reference and the world of 8 started together; the world-of-one
    baselines run here meanwhile."""
    root = tmp_path_factory.mktemp("mesh")
    for arch in AGAINST_REF:
        rcfg = rreg.smoke_config(arch).replace(dtype="float32")
        params = ref_build_model(rcfg).init(jax.random.PRNGKey(0))
        opt_cfg = ropt.AdamWConfig(moment_dtype=rcfg.opt_moment_dtype, total_steps=10)
        rckpt.save_checkpoint(str(root / arch / "init"), 0, {
            "params": params, "opt": ropt.init_opt_state(params, opt_cfg)})
        for who in ("ref", "port"):
            shutil.copytree(root / arch / "init", root / arch / who)
    (root / "config.json").write_text(json.dumps(
        {"against_ref": AGAINST_REF, "one_step": ONE_STEP, **SLICE}))
    (root / "worker.py").write_text(WORKER)
    env, deadline = _env(), time.monotonic() + TIMEOUT_S
    pipe = dict(stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=str(root))
    procs = [(f"rank {r}", subprocess.Popen(
        [sys.executable, str(root / "worker.py"), str(r), str(WORLD), str(root / "store"),
         str(root)], env=env, **pipe)) for r in range(WORLD)]
    ref_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref_env.setdefault("JAX_PLATFORMS", "cpu")
    code = REFERENCE.format(root=str(root), archs=AGAINST_REF, seq=SLICE["seq_len"],
                            batch=SLICE["global_batch"])
    procs.append(("reference", subprocess.Popen([sys.executable, "-c", code], env=ref_env,
                                                **pipe)))
    procs.append(("world of 8", subprocess.Popen(
        [sys.executable, "-c", WORLD8.format(ckdir=str(root / "w8"))], env=env, **pipe)))
    try:
        one = {}
        for case, (arch, over) in ONE_STEP.items():
            run = ptrain.train(_cfg(arch, remat=True, **over), 1,
                               ckpt_dir=str(root / "w1" / case), ckpt_every=100, device="cpu",
                               log_every=100, **SLICE)
            one[case] = {"losses": run["losses"], "grad_norms": run["grad_norms"],
                         "params": {k: v.detach().numpy() for k, v in run["params"].items()}}
    finally:
        outs = _wait_all(procs, deadline)
    return {"root": root, "one": one, "out": outs,
            "worker": json.loads((root / "worker.json").read_text()),
            "ref": json.loads((root / "ref.json").read_text())}


def _close_to_largest(got, want, frac, what):
    """Each leaf within ``frac`` of its largest entry, but the biases.
    They start at zero and their gradients are near zero (a key bias
    shifts every score of a query alike: its exact gradient is zero), and
    AdamW's first steps scale any float noise in such a gradient up to a
    full step: the reference's own 1- and 4-device runs end 7.1e-8 apart
    on the key bias, 0.8% of its largest entry.  A bias is held to
    test_torch_train's absolute 1e-4."""
    assert sorted(got) == sorted(want), what
    for k in want:
        if "bias" in k.rpartition(".")[2]:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4, err_msg=f"{what} {k}")
            continue
        w = np.asarray(want[k], np.float64)
        np.testing.assert_allclose(np.asarray(got[k], np.float64), w, rtol=0,
                                   atol=frac * max(np.abs(w).max(), 1e-30), err_msg=f"{what} {k}")


@pytest.mark.parametrize("arch", AGAINST_REF)
def test_mesh_train_is_the_references_4_device_run(runs, arch):
    got = runs["worker"][arch]
    assert got["mesh"] == [["data", "model"], [2, 2]]  # train() built it in the world of 4
    np.testing.assert_allclose(got["losses"], runs["ref"][arch], rtol=1e-5)
    port = dict(np.load(runs["root"] / f"port_{arch}.npz"))
    ref = dict(np.load(runs["root"] / f"ref_{arch}.npz"))
    cfg = _cfg(arch)
    stacked = {}

    def walk(prefix, node):
        for k, v in node.items():
            key = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                walk(key, v)
            else:
                stacked[key] = v.numpy()

    walk("", params_to_reference(cfg, {k: torch.from_numpy(v) for k, v in port.items()}))
    _close_to_largest(stacked, ref, 1e-4, f"{arch} final params")


@pytest.mark.parametrize("case", list(ONE_STEP))
def test_one_mesh_step_is_the_world_of_one(runs, case):
    got, one = runs["worker"][case + "/step"], runs["one"][case]
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norms"], one["grad_norms"], rtol=1e-5)
    _close_to_largest(dict(np.load(runs["root"] / f"step_{case}.npz")), one["params"], 1e-5,
                      f"{case} params after one step")
    # the lookup and the label pick run on vocab shards where the axis divides it
    sharded = case.endswith("vocab512")
    assert got["vocab"] == ["Replicate()", "Shard(dim=0)" if sharded else "Replicate()"]


def test_checkpoint_saved_on_2x2_restores_on_4x1_and_one_device(runs):
    root = runs["root"]
    saved = dict(np.load(root / "saved_state.npz"))
    on41 = dict(np.load(root / "restored41.npz"))
    step, tree = pckpt.restore_checkpoint(str(root / "qwen2-0.5b" / "port"))
    one = {k: v.numpy() for k, v in pckpt._flatten(tree).items()}
    assert step == 2 and runs["worker"]["restore41"]["step"] == 2
    assert sorted(saved) == sorted(on41) == sorted(one)
    for k in saved:
        assert saved[k].dtype == on41[k].dtype == one[k].dtype, k
        assert saved[k].tobytes() == on41[k].tobytes() == one[k].tobytes(), k
    pl = runs["worker"]["restore41"]["placements"]
    assert "opt.step" not in pl  # the step stays on the host
    # (4, 1): the model axis has one rank, so the rules shard the vocab on
    # it (503 % 1 == 0) and the batch axis places no parameter
    assert pl["params.layers.attn.wq"] == ["Replicate()", "Shard(dim=2)"]
    assert pl["opt.mu.embed.vocab"] == ["Replicate()", "Shard(dim=0)"]


def test_train_in_a_world_of_8_raises(runs):
    out = runs["out"]["world of 8"]
    assert "RAISED" in out and "8 ranks" in out and "mesh=" in out, out
