"""Data pipeline: deterministic sharded synthetic token streams.

The port of the reference's ``repro.data.pipeline``.  Each host draws
only its slice of the global batch (``host_batch = global_batch /
num_hosts``), keyed by (seed, step, host) so restarts resume mid-stream
with no coordination.  The draws are numpy's, with the reference's
generator and seed formula, so tokens, labels and embeddings are bit for
bit the reference's; they are handed over as tensors on ``device`` (the
card unless ``device="cpu"``).  ``input_specs_train`` (the dry run's
shape stand-ins) is not ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device

__all__ = ["DataConfig", "batch_iterator", "synthetic_batch"]


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
) -> Dict[str, torch.Tensor]:
    """Deterministic per-(step, host) batch: ``tokens`` and ``labels``
    (the tokens rolled left by one) as int32 ``(host_batch, seq_len)``,
    plus bf16 ``enc_embeds`` (audio) or ``patch_embeds`` (vision) drawn
    after the tokens from the same generator.  The token stream is a
    zipf-ish draw so the loss curve is non-degenerate."""
    dev = resolve_device(device)
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
    return batch


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
