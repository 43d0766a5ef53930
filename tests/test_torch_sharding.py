"""The port's sharding rules and meshes against the reference's
``repro.distributed.sharding`` and ``repro.launch.mesh``, on the CPU.

* ``resolve``, ``param_logical_axes`` and ``param_partition_spec`` equal
  the reference's on every case of ``tests/test_sharding.py`` and on its
  fake meshes (axis names and sizes only).
* For every registry config at full width, the port model's per-layer
  specs (built on the ``meta`` device) equal the reference's
  ``tree_partition_specs`` over ``jax.eval_shape(model.init)``, leaf by
  leaf through ``_split_name`` (the stacked leaf's spec without its
  layer entry), on fake (4, 2), (2, 4, 2), (16, 16) and (2, 16, 16)
  meshes; each spec has DTensor placements.
* ``placements()`` raises on a tuple out of mesh order; ``constrain``,
  ``replicated`` and ``local_call`` are the identity (the same object)
  without a mesh.
* Under a fake process group of 256 and of 512 (one process, in a
  subprocess): ``make_production_mesh`` gives (16, 16) and (2, 16, 16)
  and the placements on that ``DeviceMesh`` equal those on the fake
  mesh; a world of one raises.
* ``input_specs_train`` equals the reference's names, shapes and dtypes
  for every config at the train shapes of ``SHAPES``.
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.data.pipeline as rdata
import repro.distributed.sharding as rsh
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.registry import get_config as ref_get_config
from repro.models.model import build_model as ref_build_model

from repro_torch.configs import ShapeConfig
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.data import input_specs_train
from repro_torch.distributed import sharding as psh
from repro_torch.models.model import _split_name, build_model
from tests._subproc import REPO


def fake_mesh(**sizes):
    """Axis names and sizes only, as ``tests/test_sharding.py``'s."""
    class M:
        axis_names = tuple(sizes)
        shape = dict(sizes)
    return M()


MESHES = {
    "4x2": dict(data=4, model=2),
    "2x4x2": dict(pod=2, data=4, model=2),
    "16x16": dict(data=16, model=16),
    "2x16x16": dict(pod=2, data=16, model=16),
}

RESOLVE_CASES = [("batch", None), ("batch", 1), ("batch", 2), ("batch", 8), (None, None),
                 ("heads", 14), ("heads", 16), ("vocab", 503), ("moe_groups", 32),
                 ("moe_groups_ff", 4), ("fsdp", 64), ("state", 3), ("seq", 4096)]

LOGICAL_CASES = [("layers/attn/wq", 2), ("layers/attn/wo", 2), ("layers/attn/wq", 3),
                 ("layers/attn/norm", 1), ("layers/attn/bias_q", 1), ("layers/rwkv/mu_r", 1),
                 ("layers/rwkv/ln_x", 1), ("layers/moe/w_in", 4), ("layers/rwkv/cv", 2),
                 ("layers/rwkv/wr", 2), ("embed/vocab", 2), ("lm_head", 2),
                 ("layers/ssm/A_log", 2), ("layers/rwkv/u", 3), ("layers/rwkv/w0", 2),
                 ("shared/attn/wk", 2), ("encoder/final_norm", 1), ("unmatched", 3)]

SPEC_CASES = [("layers/attn/wk", 2, (64, 3)), ("layers/attn/wk", 2, (64, 4)),
              ("layers/moe/w_out", 4, (2, 8, 16, 8)), ("embed/vocab", 2, (503, 64)),
              ("lm_head", 2, (64, 504)), ("layers/attn/wq", 2, None)]


@pytest.mark.parametrize("mesh", ["4x2", "2x4x2"])
@pytest.mark.parametrize("logical,dim", RESOLVE_CASES)
def test_resolve_is_the_references(mesh, logical, dim):
    m = fake_mesh(**MESHES[mesh])
    assert psh.DEFAULT_RULES.resolve(logical, m, dim) == rsh.DEFAULT_RULES.resolve(logical, m, dim)


@pytest.mark.parametrize("path,ndim", LOGICAL_CASES)
def test_param_logical_axes_are_the_references(path, ndim):
    assert psh.param_logical_axes(path, ndim) == rsh.param_logical_axes(path, ndim)


@pytest.mark.parametrize("mesh", ["4x2", "2x4x2"])
@pytest.mark.parametrize("path,ndim,shape", SPEC_CASES)
def test_param_partition_spec_is_the_references(mesh, path, ndim, shape):
    m = fake_mesh(**MESHES[mesh])
    got = psh.param_partition_spec(path, ndim, psh.DEFAULT_RULES, m, shape=shape)
    want = rsh.param_partition_spec(path, ndim, rsh.DEFAULT_RULES, m, shape=shape)
    assert tuple(got) == tuple(want)


_REF_SPECS = {}


def _ref_specs(arch, mesh):
    """The reference's specs of ``arch`` at full width, by '/' path."""
    if arch not in _REF_SPECS:
        model = ref_build_model(ref_get_config(arch))
        _REF_SPECS[arch] = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    specs = rsh.tree_partition_specs(_REF_SPECS[arch], rsh.DEFAULT_RULES, mesh)
    return {k: tuple(v) for k, v in rsh.tree_paths(specs).items()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_placements_are_the_references_at_full_width(arch, mesh):
    m = fake_mesh(**MESHES[mesh])
    want = _ref_specs(arch, m)
    model = build_model(get_config(arch), device="meta")
    got = psh.param_specs(model, psh.DEFAULT_RULES, m)
    seen = set()
    for name, spec in got.items():
        ref, stack, _ = _split_name(name)
        path = ref.replace(".", "/")
        seen.add(path)
        w = want[path]
        if stack is not None:
            assert w[0] is None, (name, w)
            w = w[1:]
        assert tuple(spec) == w, (name, tuple(spec), w)
        assert len(psh.placements(spec, m)) == len(MESHES[mesh])
    assert seen == set(want)
    if mesh == "16x16":  # the rules shard something at production size
        assert any(any(e is not None for e in s) for s in got.values())


def test_placements_follow_mesh_order_and_raise_out_of_it():
    from torch.distributed.tensor import Replicate, Shard

    m = fake_mesh(**MESHES["2x4x2"])
    assert psh.placements(psh.PartitionSpec(("pod", "data"), None, "model"), m) == (
        Shard(0), Shard(0), Shard(2))
    assert psh.placements(psh.PartitionSpec(None, None), m) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        psh.placements(psh.PartitionSpec(("data", "pod"), None), m)
    with pytest.raises(ValueError, match="not in mesh"):
        psh.placements(psh.PartitionSpec("expert"), m)
    with pytest.raises(ValueError, match="twice"):
        psh.placements(psh.PartitionSpec("model", "model"), m)


def test_annotations_are_the_identity_without_a_mesh():
    assert psh.active()[0] is None
    x = torch.ones(2, 3, 4)
    assert psh.constrain(x, "batch", "seq", None) is x
    assert psh.replicated(x) is x
    assert psh.local_call(lambda t: t, x) is x
    with psh.use_rules(fake_mesh(**MESHES["4x2"])):
        assert psh.logical_spec(("batch", "vocab")) == ("data", "model")
    assert psh.logical_spec(("batch",)) == ()


PLANNING = r'''
import json, sys
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs.registry import get_config
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import batch_axes, make_production_mesh, make_test_mesh
from repro_torch.models.model import build_model

world = int(sys.argv[1])
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
out = {}
if world == 1:
    for build in (make_production_mesh, make_test_mesh):
        try:
            build(device_type="cpu")
        except ValueError as e:
            out[build.__name__] = str(e)
else:
    mesh = make_production_mesh(multi_pod=world == 512, device_type="cpu")
    out["mesh"] = [list(mesh.mesh_dim_names), list(mesh.shape), list(batch_axes(mesh))]

    class Fake:
        axis_names = tuple(mesh.mesh_dim_names)
        shape = {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}

    model = build_model(get_config("mixtral-8x22b"), device="meta")
    on_mesh = sh.param_placements(model, sh.DEFAULT_RULES, mesh)
    on_fake = sh.param_placements(model, sh.DEFAULT_RULES, Fake())
    out["equal"] = on_mesh == on_fake
    out["sharded"] = sum(any(p.is_shard() for p in v) for v in on_mesh.values())
print(json.dumps(out))
'''


def _planning(world):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", PLANNING, str(world)], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("world,shape", [(256, [16, 16]), (512, [2, 16, 16])])
def test_production_mesh_under_a_fake_process_group(world, shape):
    out = _planning(world)
    names = ["data", "model"] if world == 256 else ["pod", "data", "model"]
    assert out["mesh"] == [names, shape, names[:-1]]
    assert out["equal"] and out["sharded"] > 0


def test_meshes_raise_in_a_world_of_one():
    out = _planning(1)
    assert "exactly 256 ranks" in out["make_production_mesh"]
    assert "a world of 1" in out["make_production_mesh"]
    assert "exactly 4 ranks" in out["make_test_mesh"]


TRAIN_SHAPES = [s for s in REF_SHAPES if s.kind == "train"]


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape", TRAIN_SHAPES, ids=lambda s: s.name)
def test_input_specs_train_are_the_references(arch, shape):
    want = rdata.input_specs_train(ref_get_config(arch), shape)
    got = input_specs_train(get_config(arch),
                            ShapeConfig(shape.name, shape.seq_len, shape.global_batch, shape.kind))
    assert list(got) == list(want)
    for k, spec in got.items():
        assert tuple(spec.shape) == tuple(want[k].shape), k
        assert str(spec.dtype).replace("torch.", "") == jnp.dtype(want[k].dtype).name, k
