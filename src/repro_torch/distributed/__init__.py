from repro_torch.distributed.sharding import (  # noqa: F401
    MULTI_POD_RULES, SINGLE_POD_RULES, Sharded, ShardingRules, active_mesh,
    active_rules, gather, place, place_tree, tree_specs, use_rules,
)
