"""Distribution over ``torch.distributed``.

Port of ``repro/distributed``: ``sharding`` holds the language-model rules
(param, optimizer-state, batch and cache specs over a ('data', 'model')
or ('pod', 'data', 'model') ``DeviceMesh``, their ``DTensor`` placements,
and the explicit reshardings the model code calls on a mesh) and the
flow-table mesh ('shard', 'data') of the sharded streaming tier (one
process per device, NCCL on the card and gloo on the CPU); ``collectives``
holds the tier's psum, reduce-scatter, all-gather and broadcast, each
counted by kind.
"""

from repro_torch.distributed.collectives import (all_gather, broadcast,
                                                 counts, psum, psum_scatter,
                                                 reset_counts)
from repro_torch.distributed.sharding import (NamedSharding, P, as_flow_mesh,
                                              batch_specs, cache_specs,
                                              distribute_tree,
                                              flow_shard_mesh,
                                              hint_batch_heads, mesh_device,
                                              mesh_group, mesh_rank,
                                              named_sharding_tree,
                                              opt_state_specs, param_specs,
                                              placements, shard_hint,
                                              spec_for_param)

__all__ = ["NamedSharding", "P", "all_gather", "as_flow_mesh",
           "batch_specs", "broadcast", "cache_specs", "counts",
           "distribute_tree", "flow_shard_mesh", "hint_batch_heads",
           "mesh_device", "mesh_group", "mesh_rank", "named_sharding_tree",
           "opt_state_specs", "param_specs", "placements", "psum",
           "psum_scatter", "reset_counts", "shard_hint", "spec_for_param"]
