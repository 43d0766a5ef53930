"""repro_torch.distributed — sharding rules and DTensor placements for a
device mesh (the port of ``repro.distributed``)."""

from repro_torch.distributed.sharding import (
    DEFAULT_RULES,
    ShardingRules,
    constrain,
    param_partition_spec,
    tree_partition_specs,
    use_rules,
)
