"""Distribution for the sharded flow-table tier, over ``torch.distributed``.

Port of the flow-table half of ``repro/distributed``: ``sharding`` builds
the ('shard', 'data') ``DeviceMesh`` (one process per device, NCCL on the
card and gloo on the CPU), and ``collectives`` holds the tier's psum,
reduce-scatter, all-gather and broadcast, each counted by kind. The
language-model sharding rules of the reference are not ported yet.
"""

from repro_torch.distributed.collectives import (all_gather, broadcast,
                                                 counts, psum, psum_scatter,
                                                 reset_counts)
from repro_torch.distributed.sharding import (as_flow_mesh, flow_shard_mesh,
                                              mesh_device, mesh_group,
                                              mesh_rank)

__all__ = ["all_gather", "as_flow_mesh", "broadcast", "counts",
           "flow_shard_mesh", "mesh_device", "mesh_group", "mesh_rank",
           "psum", "psum_scatter", "reset_counts"]
