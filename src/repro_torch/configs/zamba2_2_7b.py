"""Assigned architecture config: zamba2-2.7b (see registry for the
source tier annotations in the assignment; a copy of the reference
package's module of the same name)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, attn_every=6, microbatches=2,
)
