"""Assigned architecture config: mixtral-8x22b (see registry for the
source tier annotations in the assignment; a copy of the reference
package's module of the same name)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=32768,
    num_experts=8, experts_per_token=2, sliding_window=4096,
    fsdp=True, microbatches=8, opt_moment_dtype="bfloat16",
)
