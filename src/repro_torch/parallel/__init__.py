# Parallelism substrate: logical-axis sharding rules + pipeline parallelism.
from repro_torch.parallel.sharding import (AxisRules, DEFAULT_RULES,
                                           axis_rules, current_rules,
                                           logical_to_spec, shard, spec_tree)

__all__ = ["AxisRules", "DEFAULT_RULES", "axis_rules", "current_rules",
           "logical_to_spec", "shard", "spec_tree"]
