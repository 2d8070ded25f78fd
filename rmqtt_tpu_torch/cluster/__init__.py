"""Multi-node clustering.

The reference offers two cluster modes (SURVEY.md §2.3): raft-replicated
routing (`rmqtt-plugins/rmqtt-cluster-raft`) and scatter-gather broadcast
(`rmqtt-plugins/rmqtt-cluster-broadcast`). The node-to-node data plane is a
message-passing RPC with a 19-variant vocabulary (`rmqtt/src/grpc.rs:506-535`).

Here the control plane is an asyncio TCP mesh with a compact binary wire
format (`cluster.wire`, `cluster.transport`) and the same message taxonomy
(`cluster.messages`); broadcast mode (`cluster.broadcast`) swaps into the
broker through the same seams the reference plugins use (router/registry).
On multi-chip TPU deployments the routing *table* itself is additionally
sharded over the device mesh (`rmqtt_tpu_torch.parallel`) — host RPC for session
ownership, ICI collectives for match aggregation.
"""
