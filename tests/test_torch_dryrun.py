"""The port's dry run (``repro_torch.launch.dryrun``, ``.diagnose``)
against the reference's, and decode on a device mesh.

* ``cell_skip_reason`` over every (arch x shape) pair and
  ``parse_overrides``, equal to the reference's; ``_CACHE_AXES`` equal,
  and every arch's batch and decode-cache shardings on stand-ins of the
  16 x 16 and 2 x 16 x 16 meshes the placements of ``P(*(resolve(a,
  mesh, d) ...))`` under the reference's rules.
* Started together, under one deadline: the six cells of
  ``tests/test_dryrun_small.py`` (dense and MoE train, RWKV6 and Zamba2
  decode, a sliding-window long decode, the encoder-decoder's prefill)
  built at their smoke configs and walked on the (2, 2, 2) mesh of a
  fake process group of 8, in three processes of two cells each (each
  OK with FLOPs > 0; the dense train cell's per-device FLOPs against the
  reference's ``parse_hlo_cost`` of the same cell compiled on 8 host
  devices, in a fourth process); and 4 gloo processes on a (2, 2) mesh,
  where every smoke config (float32, float32 caches; qwen2-0.5b also
  under ``deferred`` and ``onehot`` writes) takes 8 greedy decode steps
  against the unsharded decode of the same parameters: equal tokens,
  logits within 1e-5, every cache tensor within 1e-5 of its largest
  entry (or of 1 where that is smaller); and ``ring_update`` /
  ``ring_update_stacked`` on a batch- and slot-sharded cache write
  exactly the unsharded result, into the owning rank's block alone.
"""

import json
import os
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

import repro.distributed.sharding as rsh
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.registry import get_config as ref_get_config

# the reference's dry-run modules set XLA_FLAGS for their own process at
# import; keep this process's environment (subprocesses inherit it)
_saved = os.environ.get("XLA_FLAGS")
try:
    import repro.launch.diagnose as rdiag
    import repro.launch.dryrun as rdry
finally:
    if _saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = _saved

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.data.pipeline import input_specs_train
from repro_torch.distributed import sharding as psh
from repro_torch.launch import diagnose as pdiag
from repro_torch.launch import dryrun as pdry
from repro_torch.models.model import build_model
from tests._subproc import REPO

#: every process of the module's fixture ends within this many seconds
#: (about 60 s alone; the deadline only ends a hang, and a run under
#: pytest-xdist shares the host with the other workers)
TIMEOUT_S = 420
DECODE_ATOL = 1e-5


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape", range(len(SHAPES)), ids=[s.name for s in SHAPES])
def test_cell_skip_reason_is_the_references(arch, shape):
    assert pdry.cell_skip_reason(get_config(arch), SHAPES[shape]) == \
        rdry.cell_skip_reason(ref_get_config(arch), REF_SHAPES[shape])


@pytest.mark.parametrize("pairs", [
    [], ["microbatches=4", "fsdp=False"], ["remat=True", "moe_capacity_factor=1.5"],
    ["cache_update=deferred", "num_layers=8"], ["x=1e-3", "y=abc", "z=2=3"]])
def test_parse_overrides_is_the_references(pairs):
    got = pdiag.parse_overrides(pairs)
    assert got == rdiag.parse_overrides(pairs)
    assert [type(v) for v in got.values()] == [type(v) for v in
                                                rdiag.parse_overrides(pairs).values()]


def _stand_in(**sizes):
    class Mesh:
        axis_names = tuple(sizes)
        shape = dict(sizes)
    return Mesh()


MESHES = {"16x16": _stand_in(data=16, model=16), "2x16x16": _stand_in(pod=2, data=16, model=16)}


def test_cache_axes_are_the_references():
    assert pdry._CACHE_AXES == rdry._CACHE_AXES


def _want(axes, shape, mesh):
    spec = tuple(rsh.DEFAULT_RULES.resolve(a, mesh, d) for a, d in zip(axes, shape))
    return psh.placements(spec, mesh)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_shardings_are_the_references(arch, mesh):
    m, cfg = MESHES[mesh], get_config(arch)
    model = build_model(cfg, device="meta")
    for shape in SHAPES:
        if shape.kind == "train":
            specs = input_specs_train(cfg, shape)
        elif shape.kind == "prefill":
            specs = {"tokens": torch.empty((shape.global_batch, shape.seq_len), device="meta")}
        else:
            specs = model.init_cache(shape.global_batch, shape.seq_len, enc_len=pdry.ENC_LEN)
            got = pdry._cache_shardings(specs, psh.DEFAULT_RULES, m)
            assert sorted(got) == sorted(specs)
            for k, v in specs.items():
                assert got[k].placements == _want(rdry._CACHE_AXES[k], v.shape, m), (k, shape)
            continue
        got = pdry._batch_sharding(specs, psh.DEFAULT_RULES, m)
        for k, v in specs.items():
            axes = ((None, "batch", None) if k == "positions"
                    else ("batch",) + (None,) * (len(v.shape) - 1))
            assert got[k].placements == _want(axes, v.shape, m), (k, shape)


#: tests/test_dryrun_small.py's cells: (arch, (name, seq, batch, kind))
SMALL_CELLS = [
    ("qwen2-0.5b", ("train", 64, 8, "train")),
    ("mixtral-8x22b", ("train", 64, 8, "train")),
    ("rwkv6-7b", ("decode", 64, 8, "decode")),
    ("h2o-danube-1.8b", ("long", 128, 8, "long-decode")),
    ("seamless-m4t-large-v2", ("prefill", 64, 8, "prefill")),
    ("zamba2-2.7b", ("decode", 64, 8, "decode")),
]

WALK = r'''
import json, sys, time
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import smoke_config
from repro_torch.distributed.sharding import DEFAULT_RULES, use_rules
from repro_torch.launch.dryrun import build_cell
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.roofline.op_cost import walk_cost

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = make_test_mesh(data=2, model=2, pod=2, device_type="cpu")
for arch, shape in json.loads(sys.argv[1]):
    t0 = time.time()
    with use_rules(mesh, DEFAULT_RULES):
        fn, args = build_cell(smoke_config(arch), ShapeConfig(*shape), mesh, DEFAULT_RULES)
        _, cost = walk_cost(fn, *args)
    print(json.dumps({"arch": arch, "kind": shape[3], "flops": cost.flops, "bytes": cost.bytes,
                      "coll": cost.coll, "s": time.time() - t0}))
'''

REFERENCE = r'''
import json
import jax
from repro.configs.base import ShapeConfig
from repro.configs.registry import smoke_config
from repro.distributed.sharding import DEFAULT_RULES, use_rules
from repro.launch.dryrun import build_cell
from repro.launch.mesh import make_test_mesh
from repro.roofline.hlo_cost import parse_hlo_cost

mesh = make_test_mesh(data=2, model=2, pod=2)
with use_rules(mesh, DEFAULT_RULES):
    fn, args, shardings, donate = build_cell(smoke_config("qwen2-0.5b"),
                                             ShapeConfig("train", 64, 8, "train"), mesh,
                                             DEFAULT_RULES)
    hlo = jax.jit(fn, in_shardings=shardings, donate_argnums=donate).lower(*args).compile()
print(json.dumps({"flops": parse_hlo_cost(hlo.as_text()).flops}))
'''

DECODE = r'''
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch.configs import smoke_config
from repro_torch.distributed import sharding as sh
from repro_torch.launch.dryrun import _cache_shardings, place
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.procgroup import destroy_process_group, init_process_group
from repro_torch.models import layers
from repro_torch.models.model import build_model

rank, world, store, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
cases = json.load(open(os.path.join(root, "cases.json")))
STEPS, B, MAX_LEN, ENC = 8, 4, 64, 16
init_process_group("gloo", device="cpu", store_path=store, rank=rank, world_size=world)
mesh = make_test_mesh(data=2, model=2, device_type="cpu")
rows = sh.placements((sh.DEFAULT_RULES.resolve("batch", mesh, B),), mesh)


def decode(model, cache, tokens, on_mesh):
    logits, caches = [], []
    for t in range(STEPS):
        with torch.no_grad():
            lg, cache = model.decode_step(cache, tokens, t)
        lg = sh.full_tensor(lg)
        logits.append(lg.numpy().copy())
        caches.append({k: sh.full_tensor(v).float().numpy().copy() for k, v in cache.items()})
        tokens = lg.argmax(-1).to(torch.int32)
        if on_mesh:
            tokens = sh.distribute(tokens, mesh, rows)
    return np.stack(logits), caches


res = {}
for case, (arch, over) in cases.items():
    cfg = smoke_config(arch).replace(dtype="float32", kv_cache_dtype="float32", **over)
    model = build_model(cfg, device="cpu").init(0)
    first = torch.arange(B, dtype=torch.int32) * 7 % cfg.vocab_size
    want, want_caches = decode(model, model.init_cache(B, MAX_LEN, enc_len=ENC), first, False)
    sh.shard_model(model, mesh)
    with sh.use_rules(mesh):
        cache = model.init_cache(B, MAX_LEN, enc_len=ENC)
        cache = place(cache, _cache_shardings(cache, sh.DEFAULT_RULES, mesh))
        placed = {k: [repr(p) for p in v.placements] for k, v in cache.items()}
        got, got_caches = decode(model, cache, sh.distribute(first, mesh, rows), True)
    res[case] = {
        "logit_err": float(np.abs(got - want).max()),
        "tokens": [got.argmax(-1).tolist(), want.argmax(-1).tolist()],
        "cache_err": max(float(np.abs(g[k] - w[k]).max() / max(1.0, np.abs(w[k]).max()))
                         for g, w in zip(got_caches, want_caches) for k in w),
        "placements": placed}

# ring_update / ring_update_stacked on a (L, B, S, KV, hd) cache sharded
# on batch rows and slots: each rank reports which of its slots changed
L, S, KV, hd = 3, 16, 2, 8
gen = torch.Generator().manual_seed(0)
base = torch.randn(L, B, S, KV, hd, generator=gen)
new = torch.randn(L, B, 1, KV, hd, generator=gen)
ring = {}
for slot in (0, 5, 8, 15):
    for stacked in (False, True):
        with sh.use_rules(mesh):
            c = place({"k": base.clone()}, _cache_shardings({"k": base}, sh.DEFAULT_RULES, mesh))["k"]
            before = c.to_local().clone()
            if stacked:
                layers.ring_update_stacked(c, sh.replicated(new), slot)
            else:
                layers.ring_update(c[1], sh.replicated(new[1]), slot)
            full = sh.full_tensor(c)
        want = base.clone()
        if stacked:
            want[:, :, slot:slot + 1] = new
        else:
            want[1, :, slot:slot + 1] = new[1]
        ring[f"{slot}/{stacked}"] = {
            "equal": bool(torch.equal(full, want)),
            "changed": sorted({int(i) for i in (before != c.to_local()).nonzero()[:, 2]}),
            "offset": sh.local_offset(c)[2], "slots": before.shape[2],
            "placements": [repr(p) for p in c.placements]}
every = [None] * world
dist.all_gather_object(every, ring)
if rank == 0:
    res["ring"] = every
    json.dump(res, open(os.path.join(root, "decode.json"), "w"))
dist.barrier()
destroy_process_group()
print("WORKER_OK", rank)
'''

DECODE_CASES = {**{arch: (arch, {}) for arch in ARCH_IDS},
                "qwen2-0.5b/deferred": ("qwen2-0.5b", {"cache_update": "deferred"}),
                "qwen2-0.5b/onehot": ("qwen2-0.5b", {"cache_update": "onehot"})}


def _env(**extra):
    env = dict(os.environ, **extra)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dryrun")
    (root / "cases.json").write_text(json.dumps(DECODE_CASES))
    (root / "decode.py").write_text(DECODE)
    pipe = dict(stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=str(root))
    env, deadline = _env(), time.monotonic() + TIMEOUT_S
    procs = [(f"walk {i}", subprocess.Popen(
        [sys.executable, "-c", WALK, json.dumps(SMALL_CELLS[i:i + 2])], env=env, **pipe))
        for i in range(0, len(SMALL_CELLS), 2)]
    procs += [(f"rank {r}", subprocess.Popen(
        [sys.executable, str(root / "decode.py"), str(r), "4", str(root / "store"), str(root)],
        env=env, **pipe)) for r in range(4)]
    ref_env = _env(XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref_env.setdefault("JAX_PLATFORMS", "cpu")
    procs.append(("reference", subprocess.Popen([sys.executable, "-c", REFERENCE], env=ref_env,
                                                **pipe)))
    outs = {}
    try:
        for name, p in procs:
            out, err = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            assert p.returncode == 0, f"{name} failed (rc={p.returncode})\n{out}\n{err}"
            outs[name] = out
    except subprocess.TimeoutExpired:
        raise AssertionError(f"processes still running after {TIMEOUT_S} s") from None
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    walks = [json.loads(line) for name, out in outs.items() if name.startswith("walk")
             for line in out.splitlines() if line.startswith("{")]
    return {"walks": walks, "reference": json.loads(outs["reference"].splitlines()[-1]),
            "decode": json.loads((root / "decode.json").read_text())}


@pytest.mark.parametrize("cell", range(len(SMALL_CELLS)), ids=[a for a, _ in SMALL_CELLS])
def test_small_cells_walk_on_the_2x2x2_mesh(runs, cell):
    arch, shape = SMALL_CELLS[cell]
    rec = runs["walks"][cell]
    assert (rec["arch"], rec["kind"]) == (arch, shape[3])
    assert rec["flops"] > 0 and rec["bytes"] > 0
    assert rec["coll"], "a cell on the mesh issues collectives"


def test_dense_train_flops_against_the_references_parse(runs):
    """Per device, the port's walk of the smoke qwen2-0.5b train cell on
    the (2, 2, 2) mesh against the reference's loop-aware HLO count of the
    same cell: 1.038e8 against 1.335e8 when this was written (22% fewer;
    the two count different programs, XLA's partitioned and fused one
    against the port's eager operators).  Held within 30%."""
    port = runs["walks"][0]["flops"]
    ref = runs["reference"]["flops"]
    assert port == pytest.approx(ref, rel=0.3), (port, ref)


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_on_a_2x2_mesh_is_unsharded_decode(runs, case):
    got = runs["decode"][case]
    assert got["tokens"][0] == got["tokens"][1]
    assert got["logit_err"] <= DECODE_ATOL, got["logit_err"]
    assert got["cache_err"] <= DECODE_ATOL, got["cache_err"]
    # the batch on "data" (dim 1 of the stacked caches), the slots on "model"
    pl = got["placements"]
    for key in ("k", "shared_k", "ssm", "wkv"):
        if key in pl:
            assert pl[key] == ["Shard(dim=1)", "Shard(dim=2)"], (key, pl[key])


@pytest.mark.parametrize("slot", [0, 5, 8, 15])
@pytest.mark.parametrize("stacked", [False, True], ids=["ring_update", "ring_update_stacked"])
def test_ring_update_writes_only_the_owning_shard(runs, slot, stacked):
    for rank, ring in enumerate(runs["decode"]["ring"]):
        r = ring[f"{slot}/{stacked}"]
        assert r["equal"], rank
        assert r["placements"] == ["Shard(dim=1)", "Shard(dim=2)"]
        owns = r["offset"] <= slot < r["offset"] + r["slots"]
        assert r["changed"] == ([slot - r["offset"]] if owns else []), (rank, r)
