"""Assigned architecture config: rwkv6-7b (see registry for the
source tier annotations in the assignment; a copy of the reference
package's module of the same name)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="rwkv",
    num_layers=32, d_model=4096, num_heads=64, num_kv_heads=64,
    d_ff=14336, vocab_size=65536,
    ssm_head_dim=64, microbatches=2,
)
