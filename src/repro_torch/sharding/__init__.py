from repro_torch.sharding.rules import (ShardingRules, logical_to_pspec,
                                        make_rules, placements_for)

__all__ = ["ShardingRules", "make_rules", "logical_to_pspec",
           "placements_for"]
