"""Model/run configuration schema for all assigned architectures: a copy
of the reference's ``repro.configs.base`` (pure dataclasses, no JAX)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "shape_for"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | ssm | rwkv | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: Optional[int] = None
    rope_theta: float = 1e4
    mrope: bool = False
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 128
    # "tp": expert FFN hidden sharded over model (tokens re-partitioned
    #       to (pod,data) groups) — GShard-style baseline.
    # "dp": tokens stay fully sharded through the expert FFN; expert
    #       weights are gathered on use (expert-DP / pure-FSDP MoE).
    moe_parallel: str = "tp"
    # SSM / linear attention
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    attn_every: int = 0        # hybrid: shared attention every k layers
    # encoder-decoder
    encoder_layers: int = 0
    # frontends (stubs per assignment)
    frontend: Optional[str] = None   # "audio" | "vision"
    num_patches: int = 256           # vlm: vision tokens per sample
    # numerics / scale
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # distribution knobs (overridable per run)
    fsdp: bool = False               # shard weight d_model over "data"
    microbatches: int = 1            # gradient accumulation steps
    remat: bool = True
    opt_moment_dtype: str = "float32"  # bf16 moments for the giants
    kv_cache_dtype: str = "bfloat16"
    # decode KV-cache write: "onehot" (masked full rewrite — the naive
    # baseline) or "dus" (in-place dynamic-update-slice on the donated
    # cache; touches only the written row)
    cache_update: str = "dus"
    activation: str = "silu"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def attention_free(self) -> bool:
        return self.family in ("ssm", "rwkv")

    @property
    def sub_quadratic(self) -> bool:
        """Can decode at 500k context with O(window|state) memory?"""
        return self.attention_free or self.family == "hybrid" or (
            self.sliding_window is not None
        )

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter counting (roofline §: MODEL_FLOPS = 6 N D) --------------
    def param_count(self, active_only: bool = False) -> int:
        D, F, H, KV, hd = self.d_model, self.d_ff, self.num_heads, self.num_kv_heads, self.hd
        embed = self.vocab_size * D * (1 if self.tie_embeddings else 2)
        attn = D * (H * hd) + 2 * D * (KV * hd) + (H * hd) * D
        mlp = 3 * D * F
        if self.family == "moe":
            e = self.experts_per_token if active_only else self.num_experts
            mlp = 3 * D * F * e + D * self.num_experts  # + router
        per_layer = attn + mlp + 2 * D
        if self.family in ("ssm", "rwkv"):
            d_inner = 2 * D
            per_layer = (
                D * (2 * d_inner + 2 * self.ssm_state + 32)
                + d_inner * D
                + 3 * D * F
            ) if self.family == "ssm" else (
                6 * D * D + 3 * D * F  # rwkv time-mix + channel-mix approx
            )
        if self.family == "hybrid":
            d_inner = 2 * D
            mamba = D * (2 * d_inner + 2 * self.ssm_state + 32) + d_inner * D
            shared = attn + mlp
            return self.num_layers * mamba + shared + embed
        total = self.num_layers * per_layer + embed
        if self.family == "encdec":
            # encoder layers + decoder cross-attention
            total += self.encoder_layers * per_layer + self.num_layers * attn
        return total


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode" | "long-decode"


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "long-decode"),
)


def shape_for(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
