"""Bridging: connect this broker to external MQTT brokers.

Mirrors the reference's bridge plugin family (SURVEY.md §2.3:
bridge-ingress-mqtt / bridge-egress-mqtt and the kafka/pulsar/nats
equivalents). The MQTT bridges are built on `bridge.client.MqttClient`,
an asyncio client over the same wire codec with auto-reconnect.
"""
