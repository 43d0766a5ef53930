"""Data pipeline: deterministic sharded synthetic token streams.

The port of the reference's ``repro.data.pipeline``.  Each host draws
only its slice of the global batch (``host_batch = global_batch /
num_hosts``), keyed by (seed, step, host) so restarts resume mid-stream
with no coordination.  The draws are numpy's, with the reference's
generator and seed formula, so tokens, labels and embeddings are bit for
bit the reference's; they are handed over as tensors on ``device`` (the
card unless ``device="cpu"``).  On a device mesh every rank draws the
same global batch and keeps its rows (:func:`shard_batch`), as the
reference's dry run places a batch.  :func:`input_specs_train` gives
the dry run's shape stand-ins.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import DEFAULT_RULES, ShardingRules, distribute, placements
from repro_torch.models.frontends import TensorSpec

__all__ = ["DataConfig", "batch_iterator", "input_specs_train", "shard_batch",
           "synthetic_batch"]


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0


def synthetic_batch(
    cfg: ModelConfig,
    shape: ShapeConfig,
    step: int,
    data: DataConfig = DataConfig(),
    device="cuda",
    mesh=None,
) -> Dict[str, torch.Tensor]:
    """Deterministic per-(step, host) batch: ``tokens`` and ``labels``
    (the tokens rolled left by one) as int32 ``(host_batch, seq_len)``,
    plus bf16 ``enc_embeds`` (audio) or ``patch_embeds`` (vision) drawn
    after the tokens from the same generator.  The token stream is a
    zipf-ish draw so the loss curve is non-degenerate.  With a ``mesh``
    (one host: every rank draws the global batch) the batch comes back
    placed by :func:`shard_batch`."""
    dev = resolve_device(device)
    if mesh is not None and data.num_hosts != 1:
        raise ValueError("on a mesh every rank draws the whole global batch (num_hosts=1) and "
                         "keeps its rows")
    host_batch = shape.global_batch // data.num_hosts
    rng = np.random.default_rng((data.seed * 1_000_003 + step) * 4099 + data.host_id)
    u = rng.random((host_batch, shape.seq_len))
    toks = np.minimum(
        (u ** -1.2).astype(np.int64) % cfg.vocab_size, cfg.vocab_size - 1
    ).astype(np.int32)
    batch = {
        "tokens": torch.from_numpy(toks).to(dev),
        "labels": torch.from_numpy(np.roll(toks, -1, axis=1)).to(dev),
    }
    if cfg.frontend == "audio":
        emb = rng.standard_normal((host_batch, shape.seq_len, cfg.d_model)) * 0.02
        batch["enc_embeds"] = torch.from_numpy(emb).to(dev, torch.bfloat16)
    elif cfg.frontend == "vision":
        emb = rng.standard_normal((host_batch, cfg.num_patches, cfg.d_model)) * 0.02
        batch["patch_embeds"] = torch.from_numpy(emb).to(dev, torch.bfloat16)
    return batch if mesh is None else shard_batch(batch, mesh)


def shard_batch(batch: Dict[str, torch.Tensor], mesh,
                rules: ShardingRules = DEFAULT_RULES) -> Dict[str, torch.Tensor]:
    """A global batch every rank holds alike, as DTensors sharded over the
    batch axes (the reference's ``_batch_sharding``): dim 0, dim 1 for
    M-RoPE ``positions`` (3, B, S), replicated where the batch does not
    divide the axes."""
    out = {}
    for k, v in batch.items():
        dim = 1 if k == "positions" else 0
        spec = [None] * v.dim()
        spec[dim] = rules.resolve("batch", mesh, v.shape[dim])
        out[k] = distribute(v, mesh, placements(spec, mesh))
    return out


def input_specs_train(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, TensorSpec]:
    """The shapes and dtypes of a global training batch, without data
    (the dry run's stand-ins): the reference's names, shapes and dtypes
    as :class:`~repro_torch.models.frontends.TensorSpec` s."""
    B, S = shape.global_batch, shape.seq_len
    specs = {"tokens": TensorSpec((B, S), torch.int32),
             "labels": TensorSpec((B, S), torch.int32)}
    if cfg.frontend == "audio":
        specs["enc_embeds"] = TensorSpec((B, S, cfg.d_model), torch.bfloat16)
    elif cfg.frontend == "vision":
        specs["patch_embeds"] = TensorSpec((B, cfg.num_patches, cfg.d_model), torch.bfloat16)
        specs["positions"] = TensorSpec((3, B, S), torch.int32)
    return specs


def batch_iterator(
    cfg: ModelConfig,
    shape: ShapeConfig,
    start_step: int = 0,
    data: DataConfig = DataConfig(),
    device="cuda",
) -> Iterator[Dict[str, torch.Tensor]]:
    step = start_step
    while True:
        yield synthetic_batch(cfg, shape, step, data, device)
        step += 1
