"""Multi-pod dry run: walk every (architecture x input shape) cell on the
production meshes and emit the roofline terms (the port of the
reference's ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun                  # all cells, 16x16
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --both-meshes --out dryrun.jsonl

The reference lowers and compiles each cell on 256 or 512 forced host
devices without running it.  Here each cell is built on the ``meta``
device (parameters, AdamW state, batch or decode cache: shapes alone),
placed as DTensors on ``make_production_mesh`` (16x16, or 2x16x16 with
``--multi-pod``) over a fake process group of 256 or 512 ranks, and its
step runs once under :func:`repro_torch.roofline.op_cost.walk_cost`,
which counts what one device does (rank 0's blocks).  No device is
touched, by design, as the reference's compile touches none; the card
enters through :data:`repro_torch.roofline.analysis.HW_H100`.  Started
without a process group, this module starts the fake one itself.

Skip rules (recorded as SKIP rows, the reference's):
  * long_500k on pure full-attention archs (quadratic; no sub-quadratic
    path) — runs for SSM/hybrid/SWA archs with rolling/state caches.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, shape_for
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.data.pipeline import input_specs_train
from repro_torch.distributed.sharding import (
    DEFAULT_RULES,
    Sharding,
    ShardingRules,
    distribute,
    placements,
    shard_model,
    use_rules,
)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import build_model
from repro_torch.roofline.analysis import analyze
from repro_torch.roofline.op_cost import walk_cost
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_step import make_train_step

__all__ = ["ENC_LEN", "build_cell", "cell_skip_reason", "fake_world", "main", "mesh_name", "place",
           "production_mesh", "run_cell"]

ENC_LEN = 4096  # cross-attention context for encdec decode shapes


# ---------------------------------------------------------------------------
# cell applicability
# ---------------------------------------------------------------------------

def cell_skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    if shape.kind == "long-decode" and not cfg.sub_quadratic:
        return "full-attention arch: 500k decode needs sub-quadratic path"
    return None


# ---------------------------------------------------------------------------
# shardings: where each input lives
# ---------------------------------------------------------------------------

def _batch_sharding(specs: Dict[str, Any], rules, mesh) -> Dict[str, Sharding]:
    """Each batch entry sharded over the batch axes on its batch dim
    (dim 1 of the vision ``positions`` ``(3, B, S)``), replicated where
    the batch does not divide them."""
    out = {}
    for k, v in specs.items():
        if k == "positions":  # (3, B, S)
            spec = (None, rules.resolve("batch", mesh, v.shape[1]), None)
        else:
            spec = (rules.resolve("batch", mesh, v.shape[0]), *([None] * (len(v.shape) - 1)))
        out[k] = Sharding(mesh, placements(spec, mesh))
    return out


_CACHE_AXES = {
    "k": (None, "batch", "kv_seq", None, None),
    "v": (None, "batch", "kv_seq", None, None),
    "xk": (None, "batch", "kv_seq", None, None),
    "xv": (None, "batch", "kv_seq", None, None),
    "shared_k": (None, "batch", "kv_seq", None, None),
    "shared_v": (None, "batch", "kv_seq", None, None),
    "kpos": (None,),
    "conv": (None, "batch", None, "heads"),
    "ssm": (None, "batch", "state", None, None),
    "wkv": (None, "batch", "state", None, None),
    "shift_t": (None, "batch", None),
    "shift_c": (None, "batch", None),
}


def _cache_shardings(cache_shapes, rules, mesh) -> Dict[str, Sharding]:
    out = {}
    for k, v in cache_shapes.items():
        axes = _CACHE_AXES[k]
        spec = tuple(rules.resolve(a, mesh, d) for a, d in zip(axes, v.shape))
        out[k] = Sharding(mesh, placements(spec, mesh))
    return out


def place(tree: Dict[str, torch.Tensor], shardings: Dict[str, Sharding]) -> Dict[str, torch.Tensor]:
    """Every tensor of ``tree``, which each rank holds alike, as a DTensor
    placed by its sharding (each rank keeps its block, no collective)."""
    return {k: distribute(v, shardings[k].mesh, shardings[k].placements) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# cell construction: (fn, args), the args placed on the mesh
# ---------------------------------------------------------------------------

def _meta_batch(specs) -> Dict[str, torch.Tensor]:
    return {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in specs.items()}


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, rules: ShardingRules):
    """``(fn, args)`` of one cell on the ``meta`` device: the model's
    parameters (and for ``train`` the AdamW state and a batch from
    ``input_specs_train``; for ``prefill`` the tokens, and the patch or
    encoder embeddings; for ``decode``/``long-decode`` the cache of
    ``seq_len`` slots, the tokens and the last position) placed on
    ``mesh`` by ``rules``.  ``fn(*args)`` is the step."""
    model = build_model(cfg, device="meta")
    shard_model(model, mesh, rules)

    if shape.kind == "train":
        params = model.trainable()
        opt_cfg = AdamWConfig(moment_dtype=cfg.opt_moment_dtype)
        opt = init_opt_state(params, opt_cfg)
        specs = input_specs_train(cfg, shape)
        batch = place(_meta_batch(specs), _batch_sharding(specs, rules, mesh))
        return make_train_step(model, opt_cfg), (params, opt, batch)

    params = dict(model.named_parameters())
    B = shape.global_batch
    if shape.kind == "prefill":
        specs = {"tokens": torch.empty((B, shape.seq_len), dtype=torch.int32, device="meta")}
        if cfg.frontend == "vision":
            specs["patch_embeds"] = torch.empty((B, cfg.num_patches, cfg.d_model),
                                                dtype=torch.bfloat16, device="meta")
        if cfg.family == "encdec":
            specs["enc_embeds"] = torch.empty((B, shape.seq_len, cfg.d_model),
                                              dtype=torch.bfloat16, device="meta")
        batch = place(specs, _batch_sharding(specs, rules, mesh))
        if cfg.family in ("ssm", "rwkv", "hybrid", "encdec"):
            # recurrent/encdec prefill == forward pass producing last
            # logits (their decode caches are built stepwise)
            def fn(params, batch):
                logits, _ = model.forward(batch["tokens"], enc_embeds=batch.get("enc_embeds"))
                return logits[:, -1]
        else:
            def fn(params, batch):
                return model.prefill(batch["tokens"], patch_embeds=batch.get("patch_embeds"))
        return torch.no_grad()(fn), (params, batch)

    # decode / long-decode: one token at the last position of seq_len
    cache = model.init_cache(B, max_len=shape.seq_len, enc_len=ENC_LEN)
    cache = place(cache, _cache_shardings(cache, rules, mesh))
    tok_spec = placements((rules.resolve("batch", mesh, B),), mesh)
    tokens = distribute(torch.empty((B,), dtype=torch.int32, device="meta"), mesh, tok_spec)

    def fn(params, cache, tokens, t):
        return model.decode_step(cache, tokens, t)

    return torch.no_grad()(fn), (params, cache, tokens, shape.seq_len - 1)


# ---------------------------------------------------------------------------
# walk + analyze one cell
# ---------------------------------------------------------------------------

def mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.shape)


def run_cell(
    arch: str,
    shape_name: str,
    mesh,
    rules: ShardingRules = DEFAULT_RULES,
    verbose: bool = True,
    cfg: Optional[ModelConfig] = None,
) -> Dict[str, Any]:
    """One cell's record (``cfg`` defaults to ``get_config(arch)``)."""
    cfg = cfg or get_config(arch)
    shape = shape_for(shape_name)
    name = mesh_name(mesh)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": name, "chips": mesh.size(),
    }
    reason = cell_skip_reason(cfg, shape)
    if reason:
        rec["status"] = "SKIP"
        rec["reason"] = reason
        if verbose:
            print(f"[{arch} x {shape_name} x {name}] SKIP: {reason}")
        return rec

    t0 = time.time()
    with use_rules(mesh, rules):
        fn, args = build_cell(cfg, shape, mesh, rules)
        t_build = time.time() - t0
        _, cost = walk_cost(fn, *args)
        t_walk = time.time() - t0 - t_build

    report = analyze(arch, shape_name, name, mesh.size(), cost, cfg, shape)
    rec.update(
        status="OK",
        build_s=round(t_build, 1),
        walk_s=round(t_walk, 1),
        hw=report.hw.name,
        flops_per_device=report.hlo_flops,
        bytes_per_device=report.hlo_bytes,
        coll_bytes_per_device=report.coll_bytes,
        coll_by_kind={k: v for k, v in report.coll_by_kind.items() if v},
        model_flops=report.model_flops,
        t_compute_ms=report.t_compute * 1e3,
        t_memory_ms=report.t_memory * 1e3,
        t_collective_ms=report.t_collective * 1e3,
        bottleneck=report.bottleneck,
        useful_flops_ratio=report.useful_flops_ratio,
        roofline_fraction=report.roofline_fraction,
        temp_size_in_bytes=cost.temp_size_in_bytes,
        argument_size_in_bytes=cost.argument_size_in_bytes,
        output_size_in_bytes=cost.output_size_in_bytes,
    )
    if verbose:
        print(f"[{arch} x {shape_name} x {name}] OK build {t_build:.0f}s walk {t_walk:.0f}s")
        print(f"  memory: args={rec['argument_size_in_bytes']/2**30:.2f}GiB "
              f"temp={rec['temp_size_in_bytes']/2**30:.2f}GiB "
              f"out={rec['output_size_in_bytes']/2**30:.2f}GiB (per device)")
        print(f"  walk: flops/dev={report.hlo_flops:.3e} "
              f"bytes/dev={report.hlo_bytes:.3e} coll/dev={report.coll_bytes:.3e}")
        print(f"  roofline: compute={report.t_compute*1e3:.2f}ms "
              f"memory={report.t_memory*1e3:.2f}ms "
              f"collective={report.t_collective*1e3:.2f}ms "
              f"-> {report.bottleneck}-bound; useful={report.useful_flops_ratio:.2f} "
              f"roofline_frac={report.roofline_fraction:.2f}")
        sys.stdout.flush()
    return rec


def fake_world(world: int) -> None:
    """A fake process group of ``world`` ranks (this process is rank 0)
    unless a group of that world is up; a fake group of another world is
    replaced.  Runs no collective: the walk's collectives act on meta
    tensors."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        if dist.get_backend() != "fake":
            raise ValueError(f"a process group of {dist.get_world_size()} ranks is up; the dry "
                             f"run needs {world}")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def production_mesh(multi_pod: bool):
    """``make_production_mesh`` over a fake world of 256 or 512 ranks."""
    fake_world(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None, help="one arch (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="2x16x16 mesh (default: 16x16 single pod)")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None, help="append JSON records here")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else [s.name for s in SHAPES]
    pods = [False, True] if args.both_meshes else [args.multi_pod]

    records = []
    for multi_pod in pods:
        mesh = production_mesh(multi_pod)
        for arch in archs:
            for shape in shapes:
                try:
                    rec = run_cell(arch, shape, mesh)
                except Exception as e:  # a cell failure is a bug; record it
                    rec = {
                        "arch": arch, "shape": shape, "mesh": mesh_name(mesh),
                        "status": "FAIL", "error": f"{type(e).__name__}: {e}",
                    }
                    print(f"[{arch} x {shape} ] FAIL: {e}")
                    traceback.print_exc()
                records.append(rec)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")

    ok = sum(r["status"] == "OK" for r in records)
    skip = sum(r["status"] == "SKIP" for r in records)
    fail = sum(r["status"] == "FAIL" for r in records)
    print(f"\ndry-run complete: {ok} OK, {skip} SKIP, {fail} FAIL "
          f"of {len(records)} cells")
    if fail:
        sys.exit(1)


if __name__ == "__main__":
    main()
