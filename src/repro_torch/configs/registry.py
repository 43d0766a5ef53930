"""Architecture registry: the 10 assigned configs (one module per arch in
this package) + reduced smoke variants, copied from the reference's
``repro.configs.registry``.  ``--arch <id>`` everywhere
resolves through here.

Assigned sources:
  qwen2-0.5b [arXiv:2407.10671; hf]     h2o-danube-1.8b [arXiv:2401.16818; hf]
  qwen3-32b [hf:Qwen/Qwen3-8B; hf]      yi-6b [arXiv:2403.04652; hf]
  seamless-m4t-large-v2 [arXiv:2308.11596; hf]
  zamba2-2.7b [arXiv:2411.15242; hf]    grok-1-314b [hf:xai-org/grok-1; unverified]
  mixtral-8x22b [arXiv:2401.04088; hf]  rwkv6-7b [arXiv:2404.05892; hf]
  qwen2-vl-2b [arXiv:2409.12191; hf]
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.configs import (  # noqa: F401  (one module per assigned arch)
    grok_1_314b,
    h2o_danube_1_8b,
    mixtral_8x22b,
    qwen2_0_5b,
    qwen2_vl_2b,
    qwen3_32b,
    rwkv6_7b,
    seamless_m4t_large_v2,
    yi_6b,
    zamba2_2_7b,
)

__all__ = ["ARCHS", "get_config", "smoke_config", "ARCH_IDS"]

ARCHS: Dict[str, ModelConfig] = {}


def _reg(cfg: ModelConfig) -> ModelConfig:
    ARCHS[cfg.name] = cfg
    return cfg


for _mod in (
    qwen2_0_5b, h2o_danube_1_8b, qwen3_32b, yi_6b, seamless_m4t_large_v2,
    zamba2_2_7b, grok_1_314b, mixtral_8x22b, rwkv6_7b, qwen2_vl_2b,
):
    _reg(_mod.CONFIG)

ARCH_IDS = tuple(ARCHS.keys())


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: small layers/width,
    few experts, tiny vocab — structure preserved."""
    cfg = get_config(name)
    kw = dict(
        num_layers=4 if cfg.family != "hybrid" else 4,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=16,
        d_ff=128,
        vocab_size=503,
        microbatches=1,
        fsdp=False,
        remat=False,
        moe_group_size=32,
    )
    if cfg.family == "moe":
        kw.update(num_experts=4, experts_per_token=2)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_head_dim=16)
    if cfg.family == "rwkv":
        kw.update(ssm_head_dim=16, num_heads=4, num_kv_heads=4)
    if cfg.family == "hybrid":
        kw.update(attn_every=2)
    if cfg.family == "encdec":
        kw.update(encoder_layers=2)
    if cfg.family == "vlm":
        kw.update(num_patches=16, mrope_sections=(2, 3, 3))  # head_dim 16
    if cfg.sliding_window:
        kw.update(sliding_window=32)
    return cfg.replace(**kw)
