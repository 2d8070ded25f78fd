"""Host data plane: the broker around the TPU routing core.

The equivalent of the reference's broker core crate (`rmqtt/`),
re-designed for the asyncio host + TPU-matcher split: listeners, the MQTT
v3.1/v3.1.1/v5 codec, per-connection session state machines, the shared
session registry and fan-out, retained/delayed/will messages, hooks, ACL —
with `Router::matches()` served by a micro-batched routing service
(`rmqtt_tpu_torch.broker.routing`) instead of an inline trie walk.
"""
