"""The port's roofline (``repro_torch.roofline``) against the reference's
``repro.roofline``, and its per-device walk against analytic counts.

* ``model_flops_estimate`` over every (arch x shape) pair, equal.
* ``RooflineReport``'s terms, bottleneck, ratios and ``row()`` from the
  same inputs, equal, with a ``Hardware`` built from the reference's v5e
  numbers (the port carries no TPU constant: they are read from
  ``repro``).
* ``report.py``'s two tables from one set of OK, SKIP and FAIL records,
  equal strings.
* ``walk_cost`` exactly: a Python loop of L matmuls is 2 D^3 L FLOPs
  (the reference's loop-aware ``parse_hlo_cost`` is within its own 25%),
  a batched einsum 2 B M K N, a loop of row reads costs the rows (not
  the operand), a write into a slice twice the slice.
* In one subprocess under a fake process group of 8: the collectives a
  redistribution issues, by kind at the local shape, and their wire
  bytes through ``_COLLECTIVES``' multipliers; and the sharded ``(64,
  128) @ (128, 256)`` on a (2, 4) mesh counts one device's product, 2 *
  32 * 128 * 64 FLOPs, on its first walk (when DTensor's sharding
  propagation runs the global product) and on its second (when its cache
  answers).
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax import lax

import repro.roofline.analysis as ran
import repro.roofline.report as rrep
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.registry import get_config as ref_get_config
from repro.roofline.hlo_cost import parse_hlo_cost

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.roofline import analysis as pan
from repro_torch.roofline import report as prep
from repro_torch.roofline.op_cost import walk_cost
from tests._subproc import REPO

V5E = pan.Hardware(ran.HW_V5E.name, peak_flops=ran.HW_V5E.peak_flops,
                   hbm_bw=ran.HW_V5E.hbm_bw, link_bw=ran.HW_V5E.link_bw,
                   dcn_bw=ran.HW_V5E.dcn_bw)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape", range(len(SHAPES)), ids=[s.name for s in SHAPES])
def test_model_flops_estimate_is_the_references(arch, shape):
    assert pan.model_flops_estimate(get_config(arch), SHAPES[shape]) == \
        ran.model_flops_estimate(ref_get_config(arch), REF_SHAPES[shape])


REPORTS = [  # (chips, flops, bytes, coll by kind, model flops)
    (256, 3.2e14, 1.1e12, {"all-gather": 4e9, "all-reduce": 1e9}, 5e16),
    (512, 1e9, 4e11, {"reduce-scatter": 2e8}, 1e11),
    (256, 1e12, 1e9, {"all-to-all": 9e12, "collective-permute": 1e3}, 1e14),
    (1, 0.0, 0.0, {}, 0.0),
]


@pytest.mark.parametrize("case", range(len(REPORTS)))
def test_roofline_report_is_the_references(case):
    chips, flops, nbytes, coll, model = REPORTS[case]
    kw = dict(arch="a", shape="s", mesh="16x16", chips=chips, hlo_flops=flops,
              hlo_bytes=nbytes, coll_bytes=sum(coll.values()), coll_by_kind=coll,
              model_flops=model)
    got, want = pan.RooflineReport(**kw, hw=V5E), ran.RooflineReport(**kw, hw=ran.HW_V5E)
    for attr in ("t_compute", "t_memory", "t_collective", "bottleneck", "useful_flops_ratio",
                 "roofline_fraction"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert got.row() == want.row()


def test_collective_bytes_take_the_references_multipliers():
    assert pan._COLLECTIVES == ran._COLLECTIVES
    got = pan.collective_bytes({"all-reduce": 1024 * 4, "all-gather": 8 * 256 * 2,
                                "collective-permute": 512 * 4})
    # the reference's own regex case (tests/test_roofline.py), from its HLO text
    hlo = """
ENTRY %main () -> f32[] {
  %ar = f32[1024]{0} all-reduce(f32[1024]{0} %x), replica_groups={}
  %ag = bf16[8,256]{1,0} all-gather(bf16[8,16]{1,0} %y), dimensions={1}
  %cp = f32[512]{0} collective-permute(f32[512]{0} %z)
}
"""
    assert got == ran.collective_bytes(hlo)


RECORDS = [
    {"arch": "qwen2-0.5b", "shape": "train_4k", "mesh": "16x16", "chips": 256, "status": "OK",
     "flops_per_device": 3.5e13, "bytes_per_device": 1.25e13, "coll_bytes_per_device": 1.1e11,
     "coll_by_kind": {"all-gather": 6e10, "all-reduce": 4e10, "reduce-scatter": 1e10},
     "argument_size_in_bytes": 3 * 2**30, "temp_size_in_bytes": 17 * 2**29,
     "t_compute_ms": 35.4, "t_memory_ms": 3731.3, "t_collective_ms": 244.4,
     "bottleneck": "memory", "useful_flops_ratio": 0.2, "roofline_fraction": 0.0095},
    {"arch": "qwen2-0.5b", "shape": "long_500k", "mesh": "2x16x16", "chips": 512,
     "status": "SKIP", "reason": "full-attention arch: 500k decode needs sub-quadratic path"},
    {"arch": "yi-6b", "shape": "decode_32k", "mesh": "16x16", "status": "FAIL",
     "error": "RuntimeError: " + "x" * 80},
    {"arch": "rwkv6-7b", "shape": "decode_32k", "mesh": "2x16x16", "chips": 512, "status": "OK",
     "flops_per_device": 1.0, "bytes_per_device": 2.0, "coll_bytes_per_device": 0.0,
     "coll_by_kind": {}, "t_compute_ms": 0.0, "t_memory_ms": 1e-9, "t_collective_ms": 0.0,
     "bottleneck": "memory", "useful_flops_ratio": 12.5, "roofline_fraction": 0.0},
]


def test_report_tables_are_the_references(tmp_path):
    assert prep.dryrun_table(RECORDS) == rrep.dryrun_table(RECORDS)
    assert prep.roofline_table(RECORDS) == rrep.roofline_table(RECORDS)
    assert prep.fmt_bytes(3 * 2**30 + 1) == rrep.fmt_bytes(3 * 2**30 + 1)
    path = tmp_path / "r.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in RECORDS) + "\n")
    assert prep.load([str(path)]) == rrep.load([str(path)]) == RECORDS


def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_a_python_loop_of_matmuls_counts_every_trip():
    D, L = 128, 12

    def unrolled(x, ws):
        for i in range(L):
            x = x @ ws[i]
        return x

    _, cost = walk_cost(unrolled, _meta(D, D), _meta(L, D, D))
    assert cost.flops == 2 * D**3 * L
    assert cost.bytes == L * 3 * D * D * 4  # each product reads two D x D and writes one
    # the reference's parser on the scanned program: within its own 25%
    ref = parse_hlo_cost(jax.jit(lambda x, ws: lax.scan(lambda c, w: (c @ w, None), x, ws)[0])
                         .lower(jax.ShapeDtypeStruct((D, D), jnp.float32),
                                jax.ShapeDtypeStruct((L, D, D), jnp.float32))
                         .compile().as_text())
    assert ref.flops == pytest.approx(cost.flops, rel=0.25)


def test_a_batched_einsum_counts_exactly():
    B, M, K, N = 4, 32, 64, 16
    _, cost = walk_cost(lambda a, b: torch.einsum("bmk,bkn->bmn", a, b),
                        _meta(B, M, K), _meta(B, K, N))
    assert cost.flops == 2 * B * M * K * N


def test_row_reads_count_the_rows_not_the_operand():
    L, D = 64, 256

    def fn(big):
        total = torch.zeros((), device=big.device)
        for i in range(L):
            total = total + big[i].sum()
        return total

    _, cost = walk_cost(fn, _meta(L, D))
    rows = L * D * 4
    assert rows <= cost.bytes < 1.1 * rows  # the slices, once each (plus scalars)
    assert cost.bytes < 0.5 * L * L * D * 4  # not the operand a trip


def test_a_write_into_a_slice_counts_twice_the_slice():
    cache, new = _meta(4, 16, 2, 8), _meta(4, 1, 2, 8)
    _, cost = walk_cost(lambda c, n: c.narrow(1, 5, 1).copy_(n), cache, new, record=True)
    assert cost.bytes == 2 * new.numel() * 4
    assert cost.ops == [f"copy_ float32[4,1,2,8] float32[4,1,2,8] -> float32[4,1,2,8] "
                        f"bytes={2 * new.numel() * 4} flops={new.numel()}"]
    assert cost.argument_size_in_bytes == (cache.numel() + new.numel()) * 4
    assert cost.temp_size_in_bytes == 0


MESHED = r'''
import json
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.roofline.analysis import analyze, collective_bytes
from repro_torch.roofline.op_cost import walk_cost

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))


def placed(shape, pl):
    return DTensor.from_local(torch.empty(shape, device="meta"), mesh, pl, run_check=False)


out = {}
A = placed((32, 128), [Shard(0), Replicate()])
W = placed((128, 64), [Replicate(), Shard(1)])
out["mm"] = [walk_cost(lambda a, w: a @ w, A, W, record=True)[1].__dict__ for _ in range(2)]
x = placed((8, 16), [Shard(0), Shard(1)])
out["gather"] = walk_cost(lambda t: t.redistribute(mesh, [Replicate(), Replicate()]), x)[1].coll
p = placed((16, 64), [Partial(), Replicate()])
out["reduce"] = walk_cost(lambda t: t.redistribute(mesh, [Replicate(), Replicate()]), p)[1].coll
out["scatter"] = walk_cost(lambda t: t.redistribute(mesh, [Shard(0), Replicate()]), p)[1].coll
out["wire"] = collective_bytes({**out["gather"], **out["reduce"]})
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def meshed():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", MESHED], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_a_sharded_matmul_counts_one_device_on_every_walk(meshed):
    first, second = meshed["mm"]
    assert first == second
    assert first["flops"] == 2 * 32 * 128 * 64  # the local (32, 128) @ (128, 64)
    assert first["ops"] == ["mm float32[32,128] float32[128,64] -> float32[32,64] "
                            "bytes=57344 flops=524288"]
    assert first["coll"] == {}


def test_collectives_are_counted_by_kind_at_the_local_shape(meshed):
    # (16, 64) sharded 2 x 4: a (8, 16) block gathered over model, then data
    assert meshed["gather"] == {"all-gather": (8 * 64 + 16 * 64) * 4}
    assert meshed["reduce"] == {"all-reduce": 16 * 64 * 4}
    assert meshed["scatter"] == {"reduce-scatter": 8 * 64 * 4}
    assert meshed["wire"] == {"all-reduce": 2 * 16 * 64 * 4, "all-gather": (8 * 64 + 16 * 64) * 4,
                              "reduce-scatter": 0.0, "all-to-all": 0.0,
                              "collective-permute": 0.0}
