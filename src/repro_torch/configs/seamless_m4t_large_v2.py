"""Assigned architecture config: seamless-m4t-large-v2 (see registry for the
source tier annotations in the assignment; a copy of the reference
package's module of the same name)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=8192, vocab_size=256206,
    encoder_layers=24, frontend="audio", activation="gelu",
)
