"""Assigned architecture config: h2o-danube-1.8b (see registry for the
source tier annotations in the assignment; a copy of the reference
package's module of the same name)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    num_layers=24, d_model=2560, num_heads=32, num_kv_heads=8,
    d_ff=6912, vocab_size=32000,
    sliding_window=4096, rope_theta=1e4,
)
