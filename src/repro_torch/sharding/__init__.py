"""Sharding plans of the port (`partition.ShardingPlan`): the reference's
specs, and the blocks each rank holds under them."""
from repro_torch.sharding.partition import ShardingPlan

__all__ = ["ShardingPlan"]
