"""Modality frontend stubs: the backbone consumes precomputed
``(B, S, d_model)`` frame or patch embeddings, and these helpers describe
their shapes and, for smoke runs, draw random ones.

The port of the reference's ``repro.models.frontends``.  A spec is a
:class:`TensorSpec` (a shape and a torch dtype) where the reference
gives a ``jax.ShapeDtypeStruct``; :func:`random_frontend_batch` draws
from a :class:`torch.Generator` on its device, and its M-RoPE position
ids are the reference's.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig

__all__ = ["TensorSpec", "audio_frame_spec", "mrope_position_spec", "random_frontend_batch",
           "vision_patch_spec"]


class TensorSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def audio_frame_spec(cfg: ModelConfig, batch: int, frames: int) -> TensorSpec:
    """Precomputed audio frame embeddings (the seamless-m4t speech
    encoder's input after the conformer feature stub)."""
    return TensorSpec((batch, frames, cfg.d_model), torch.bfloat16)


def vision_patch_spec(cfg: ModelConfig, batch: int) -> TensorSpec:
    """Precomputed vision patch embeddings (the qwen2-vl ViT stub)."""
    return TensorSpec((batch, cfg.num_patches, cfg.d_model), torch.bfloat16)


def mrope_position_spec(batch: int, seq: int) -> TensorSpec:
    """(3, B, S) t/h/w position ids for M-RoPE (text tokens share all
    three streams; patch tokens get spatial ids)."""
    return TensorSpec((3, batch, seq), torch.int32)


def random_frontend_batch(cfg: ModelConfig, gen: torch.Generator, batch: int,
                          seq: int) -> Dict[str, torch.Tensor]:
    """Random stub tensors on ``gen``'s device: bf16 ``enc_embeds``
    ``(batch, seq, D)`` for an audio frontend; for a vision frontend bf16
    ``patch_embeds`` ``(batch, num_patches, D)`` and int32 ``positions``
    ``(3, batch, ·)``: the patches on a ``side x side`` grid at t = 0
    (h the row, w the column), then text advancing all three streams
    from 1.  Normal draws scaled by 0.02."""
    dev = gen.device
    out: Dict[str, torch.Tensor] = {}
    if cfg.frontend == "audio":
        out["enc_embeds"] = (torch.randn((batch, seq, cfg.d_model), generator=gen, device=dev)
                             * 0.02).to(torch.bfloat16)
    elif cfg.frontend == "vision":
        npatch = cfg.num_patches
        out["patch_embeds"] = (torch.randn((batch, npatch, cfg.d_model), generator=gen,
                                           device=dev) * 0.02).to(torch.bfloat16)
        side = int(npatch ** 0.5)
        i32 = dict(dtype=torch.int32, device=dev)
        text = torch.arange(1, max(seq - npatch + 1, 1), **i32)  # empty when seq <= npatch
        grid = torch.arange(side, **i32)
        t = torch.cat([torch.zeros((npatch,), **i32), text])
        h = torch.cat([grid.repeat_interleave(side), text])
        w = torch.cat([grid.repeat(side), text])
        out["positions"] = torch.stack([t, h, w])[:, None, :].repeat(1, batch, 1)
    return out
