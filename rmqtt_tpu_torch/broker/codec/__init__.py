"""MQTT v3.1 / v3.1.1 / v5.0 wire codec.

The equivalent of the reference's `rmqtt-codec` crate
(`rmqtt-codec/src/lib.rs:46-67`: a version-unified
``MqttCodec``/``MqttPacket``): one packet model for all protocol versions,
with version-dependent encode/decode and CONNECT version sniffing
(`rmqtt-codec/src/version.rs`). Size-capped decoding mirrors
``set_max_inbound_size`` (`rmqtt-codec/src/v5/codec.rs:250`).
"""

from rmqtt_tpu_torch.broker.codec.packets import (
    Auth,
    Connack,
    Connect,
    Disconnect,
    Packet,
    Pingreq,
    Pingresp,
    Puback,
    Pubcomp,
    Publish,
    Pubrec,
    Pubrel,
    Subscribe,
    Suback,
    SubOpts,
    Unsuback,
    Unsubscribe,
    Will,
)
from rmqtt_tpu_torch.broker.codec.codec import MqttCodec, ProtocolError
from rmqtt_tpu_torch.broker.codec import props
