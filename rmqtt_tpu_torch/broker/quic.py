"""QUIC listener seam (reference `rmqtt-net/src/quic.rs:1-60`,
`rmqtt-net/src/builder.rs:486-583` ``bind_quic``).

The reference serves MQTT over one bidirectional QUIC stream per
connection (quinn). This image ships no QUIC stack — stdlib ``ssl``
cannot drive a QUIC handshake and pip installs are off — so the
decision, recorded here and in COMPONENTS.md, is a **stubbed seam**:

- the broker accepts ``quic_port`` config and will serve MQTT over any
  registered :class:`QuicBackend` exactly like its TCP path (the session
  layer is transport-agnostic: it consumes an asyncio reader/writer
  pair, which is also what one QUIC bidi stream presents);
- without a backend, configuring ``quic_port`` fails fast at startup
  with :class:`QuicUnavailableError` naming this module — nothing
  silently listens on UDP without QUIC semantics.

To slot a real stack in later (aioquic, an MsQuic C binding, ...):
implement ``QuicBackend.serve`` to run the QUIC handshake, accept the
first client-opened bidi stream, and invoke ``handler(reader, writer)``
per connection; then call :func:`register_backend` at import time.
``tests/test_transports.py::test_quic_seam`` pins the contract with an
in-memory backend.
"""

from __future__ import annotations

from typing import Awaitable, Callable, Optional, Protocol

# handler((reader, writer)) — the same shape MqttBroker._on_connection takes
StreamHandler = Callable[..., Awaitable[None]]


class QuicUnavailableError(RuntimeError):
    """quic_port configured but no QUIC backend is registered."""

    def __init__(self) -> None:
        super().__init__(
            "quic_port is configured but no QUIC stack is available in this "
            "environment (see rmqtt_tpu_torch/broker/quic.py for the backend "
            "contract; the reference uses quinn, rmqtt-net/src/quic.rs)"
        )


class QuicBackend(Protocol):
    """The pluggable QUIC stack."""

    async def serve(self, host: str, port: int, handler: StreamHandler,
                    tls_cert: str, tls_key: str) -> "QuicServerHandle":
        """Bind UDP ``host:port``, run QUIC+TLS, and call ``handler`` with
        an asyncio (reader, writer) pair per accepted connection's first
        bidirectional stream."""
        ...


class QuicServerHandle(Protocol):
    async def close(self) -> None: ...

    @property
    def bound_port(self) -> int: ...


_backend: Optional[QuicBackend] = None


def register_backend(backend: QuicBackend) -> None:
    global _backend
    _backend = backend


def get_backend() -> QuicBackend:
    if _backend is None:
        raise QuicUnavailableError()
    return _backend


def backend_available() -> bool:
    return _backend is not None
