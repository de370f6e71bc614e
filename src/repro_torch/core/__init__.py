"""The DMR API and the elastic machinery under it (counterpart of
``repro.core``): actions and the DMR endpoint, meshes of slices, logical
sharding rules and sharded tensors, the Listing-3 redistribution plans,
and resharding of a whole train state between meshes."""
from repro_torch.core.actions import Action, Decision, ResizeHandler
from repro_torch.core.dmr import DMR, RMSProtocol
from repro_torch.core.meshes import (Mesh, make_mesh, mesh_model_ways,
                                     mesh_num_slices, resized_mesh,
                                     slice_devices, slice_of_rank)
from repro_torch.core.redistribute import (Transfer, expand_plan,
                                           migrate_slice, plan_stats,
                                           shrink_plan, transfer_time_s)
from repro_torch.core.reshard import (checkpoint_reshard, ownership_map,
                                      reshard, state_shardings,
                                      timed_reshard)
from repro_torch.core.sharding import (FSDP_RULES, LONG_CONTEXT_RULES,
                                       TP_DP_RULES, NamedSharding,
                                       PartitionSpec, ShardedTensor,
                                       ShardingRules, gather,
                                       logical_to_sharding, place)

__all__ = ["Action", "DMR", "Decision", "FSDP_RULES", "LONG_CONTEXT_RULES",
           "Mesh", "NamedSharding", "PartitionSpec", "RMSProtocol",
           "ResizeHandler", "ShardedTensor", "ShardingRules", "TP_DP_RULES",
           "Transfer", "checkpoint_reshard", "expand_plan", "gather",
           "logical_to_sharding", "make_mesh", "mesh_model_ways",
           "mesh_num_slices", "migrate_slice", "ownership_map", "place",
           "plan_stats", "reshard", "resized_mesh", "shrink_plan",
           "slice_devices", "slice_of_rank", "state_shardings",
           "timed_reshard", "transfer_time_s"]
