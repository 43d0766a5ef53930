"""Assigned architecture config: qwen2-vl-2b (see registry for the
source tier annotations in the assignment; a copy of the reference
package's module of the same name)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
    d_ff=8960, vocab_size=151936,
    qkv_bias=True, mrope=True, mrope_sections=(16, 24, 24),
    frontend="vision", rope_theta=1e6, tie_embeddings=True,
)
