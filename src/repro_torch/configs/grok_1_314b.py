"""Assigned architecture config: grok-1-314b (see registry for the
source tier annotations in the assignment; a copy of the reference
package's module of the same name)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=32768, vocab_size=131072,
    num_experts=8, experts_per_token=2, activation="gelu",
    fsdp=True, microbatches=16, opt_moment_dtype="bfloat16",
)
