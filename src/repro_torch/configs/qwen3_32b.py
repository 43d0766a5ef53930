"""Assigned architecture config: qwen3-32b (see registry for the
source tier annotations in the assignment; a copy of the reference
package's module of the same name)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=64, num_kv_heads=8,
    d_ff=25600, vocab_size=151936,
    qk_norm=True, head_dim=128, rope_theta=1e6,
    fsdp=True, microbatches=8, opt_moment_dtype="bfloat16",
)
