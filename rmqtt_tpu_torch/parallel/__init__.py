"""Multi-device parallelism: the automaton over a list of devices.

The reference scales routing by replicating the route table per node (raft
mode) or sharding it per node with scatter-gather (broadcast mode). Over
the devices of one process the same two strategies map to a 2-D mesh
(``sharded.Mesh``, a list of torch devices reshaped ``(dp, fp)``):

- ``dp`` (data parallel): the publish batch is sharded — each device
  matches its slice of topics against its copy of the table;
- ``fp`` (filter parallel): the filter table is sharded — each device
  matches its topics against its slice of filters and the per-topic counts
  are summed over the fp shards.
"""

from rmqtt_tpu_torch.parallel.sharded import (Mesh, ShardedMatcher,
                                              ShardedPartitionedMatcher, make_mesh)

__all__ = ["Mesh", "ShardedMatcher", "ShardedPartitionedMatcher", "make_mesh"]
