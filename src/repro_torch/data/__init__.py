"""repro_torch.data — deterministic sharded synthetic token streams (the
port of the reference's ``repro.data``)."""

from repro_torch.data.pipeline import (
    DataConfig,
    batch_iterator,
    input_specs_train,
    shard_batch,
    synthetic_batch,
)

__all__ = ["DataConfig", "batch_iterator", "input_specs_train", "shard_batch", "synthetic_batch"]
