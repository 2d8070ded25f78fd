"""The broker server: listeners + CONNECT handshake.

Mirrors `rmqtt/src/server.rs` (accept loop, task per
connection) and the v3/v5 handshake front-ends (`v3.rs:63-183`,
`v5.rs:79-410`): busy check, CONNECT receive with timeout, hooks
(client_connect → client_authenticate → client_connack → client_connected),
session-takeover kick, fitter negotiation, CONNACK with v5 properties, then
hand-off to the session run loop.

Run standalone:  python -m rmqtt_tpu_torch.broker --port 1883 [--router xla]
"""

from __future__ import annotations

import asyncio
import logging
import os
import sys
import time
import uuid
from typing import Optional

from rmqtt_tpu_torch.broker.codec import MqttCodec, packets as pk, props as P
from rmqtt_tpu_torch.broker.codec.primitives import ProtocolViolation
from rmqtt_tpu_torch.broker.executor import ExecutorFull
from rmqtt_tpu_torch.broker.context import BrokerConfig, ServerContext
from rmqtt_tpu_torch.broker.hooks import HookType
from rmqtt_tpu_torch.broker.session import SessionState
from rmqtt_tpu_torch.broker.types import (
    ConnectInfo,
    HandshakeLockedError,
    RC_BAD_USERNAME_PASSWORD,
    RC_NOT_AUTHORIZED,
    RC_SUCCESS,
    RC_UNSUPPORTED_PROTOCOL_VERSION,
    V3_ACCEPTED,
    V3_BAD_USERNAME_PASSWORD,
    V3_NOT_AUTHORIZED,
)
from rmqtt_tpu_torch.router.base import Id

log = logging.getLogger("rmqtt_tpu_torch.broker")

_UNSET = object()  # sentinel: _on_connection called as the raw listener callback


def _build_ssl_context(cert: str, key, client_ca: str = ""):
    """Server-side TLS context; with ``client_ca`` set, mutual TLS
    (builder.rs tls_cross_certificate): require and verify client certs —
    metadata lands in ConnectInfo."""
    import ssl

    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert, key or None)
    if client_ca:
        ctx.load_verify_locations(client_ca)
        ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def extract_cert_info(writer):
    """TLS client-certificate metadata from the connection, if any
    (cert_extractor.rs semantics over stdlib ssl: populated only when the
    listener verifies client certs)."""
    from rmqtt_tpu_torch.broker.types import CertInfo

    ssl_obj = writer.get_extra_info("ssl_object")
    if ssl_obj is None:
        return None
    try:
        cert = ssl_obj.getpeercert()
    except ValueError:
        return None
    if not cert:
        return None
    fields = {}
    for rdn in cert.get("subject", ()):  # ((('commonName','x'),), ...)
        for key, value in rdn:
            fields.setdefault(key, value)
    subject = ",".join(f"{k}={v}" for rdn in cert.get("subject", ()) for k, v in rdn)
    return CertInfo(
        common_name=fields.get("commonName"),
        subject=subject or None,
        serial=cert.get("serialNumber"),
        organization=fields.get("organizationName"),
    )


class MqttBroker:
    def __init__(self, ctx: Optional[ServerContext] = None, **cfg_kwargs) -> None:
        self.ctx = ctx or ServerContext(BrokerConfig(**cfg_kwargs))
        self._server: Optional[asyncio.base_events.Server] = None
        self._ws_server: Optional[asyncio.base_events.Server] = None
        self._tls_server: Optional[asyncio.base_events.Server] = None
        self._wss_server: Optional[asyncio.base_events.Server] = None
        self._quic_server = None  # QuicServerHandle (broker/quic.py)
        # named extra listeners (listener.rs sub-tables): name → Server
        self._extra_servers: dict = {}

    def _bound(self, srv) -> int:
        return srv.sockets[0].getsockname()[1]

    @property
    def ws_port(self) -> int:
        return self._bound(self._ws_server)

    @property
    def tls_port(self) -> int:
        return self._bound(self._tls_server)

    @property
    def wss_port(self) -> int:
        return self._bound(self._wss_server)

    @property
    def port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    def extra_port(self, name: str) -> int:
        """Bound port of a named extra listener."""
        return self._bound(self._extra_servers[name])

    async def start(self) -> None:
        await self.ctx.hooks.fire(HookType.BEFORE_STARTUP)
        self.ctx.start()
        if self.ctx.fabric is not None:
            # the intra-node fabric's UDS server must listen before the
            # client listeners accept (a CONNECT may need the directory)
            await self.ctx.fabric.start()
        await self.ctx.plugins.start_all()
        if self.ctx.durability is not None:
            # cold-start recovery (broker/durability.py) BEFORE any
            # listener accepts — mirroring the fabric warm-up gate: a
            # CONNECT must never race a half-replayed session/retained
            # store. Runs after plugin start so retainer-loaded retained
            # rows (possibly staler) are superseded; the session-storage
            # plugin refuses to coexist (one owner of session durability).
            await self.ctx.durability.recover()
        cfg = self.ctx.cfg
        rp = {"reuse_port": True} if cfg.reuse_port else {}
        self._server = await asyncio.start_server(
            self._on_connection, cfg.host, cfg.port, **rp
        )
        log.info("listening on %s:%s", cfg.host, self.port)
        sslctx = None
        if cfg.tls_port is not None or cfg.wss_port is not None:
            if not cfg.tls_cert:
                raise ValueError(
                    "listener.tls_port/wss_port configured without listener.tls_cert"
                )
            sslctx = _build_ssl_context(cfg.tls_cert, cfg.tls_key, cfg.tls_client_ca)
        if cfg.ws_port is not None:
            self._ws_server = await asyncio.start_server(
                self._on_ws_connection, cfg.host, cfg.ws_port, **rp
            )
            log.info("ws listening on %s:%s", cfg.host, self.ws_port)
        if cfg.tls_port is not None and sslctx:
            self._tls_server = await asyncio.start_server(
                self._on_connection, cfg.host, cfg.tls_port, ssl=sslctx, **rp
            )
            log.info("tls listening on %s:%s", cfg.host, self.tls_port)
        if cfg.wss_port is not None and sslctx:
            self._wss_server = await asyncio.start_server(
                self._on_ws_connection, cfg.host, cfg.wss_port, ssl=sslctx, **rp
            )
            log.info("wss listening on %s:%s", cfg.host, self.wss_port)
        if cfg.quic_port is not None:
            # MQTT over one bidi QUIC stream (server.rs listen_quic path);
            # raises QuicUnavailableError when no stack is registered
            from rmqtt_tpu_torch.broker.quic import get_backend

            self._quic_server = await get_backend().serve(
                cfg.host, cfg.quic_port, self._on_connection,
                cfg.tls_cert, cfg.tls_key,
            )
            log.info("quic listening on %s:%s", cfg.host,
                     self._quic_server.bound_port)
        # named extra listeners (reference [listener.tcp.<name>] blocks,
        # rmqtt-conf/src/listener.rs): each its own addr + TLS material
        for spec in cfg.extra_listeners:
            kind = spec.get("kind", "tcp")
            name = spec.get("name", f"{kind}:{spec.get('port')}")
            if name in self._extra_servers:
                raise ValueError(f"duplicate listener name {name!r}")
            handler = (self._on_ws_connection if kind in ("ws", "wss")
                       else self._on_connection)
            lss = None
            if kind in ("tls", "wss"):
                # cert+key fall back from the global listener AS A PAIR —
                # a per-listener cert must never pair with the global key
                if spec.get("tls_cert"):
                    cert, ckey = spec["tls_cert"], spec.get("tls_key")
                else:
                    cert, ckey = cfg.tls_cert, cfg.tls_key
                if not cert:
                    raise ValueError(f"listener {name!r}: tls without a cert")
                lss = _build_ssl_context(
                    cert, ckey, spec.get("tls_client_ca") or cfg.tls_client_ca
                )
            srv = await asyncio.start_server(
                handler, spec.get("host", cfg.host), int(spec["port"]),
                ssl=lss, **rp,
            )
            self._extra_servers[name] = srv
            log.info("%s listener %r on %s:%s", kind, name,
                     spec.get("host", cfg.host), self._bound(srv))

    async def stop(self) -> None:
        # close sessions BEFORE wait_closed(): in py3.12 Server.wait_closed
        # waits for all connection handlers, which only return once their
        # session loops end
        for session in self.ctx.registry.sessions():
            if session.state is not None:
                await session.state.close()
        for srv in (self._server, self._ws_server, self._tls_server, self._wss_server,
                    *self._extra_servers.values()):
            if srv is not None:
                srv.close()
                await srv.wait_closed()
        if self._quic_server is not None:
            await self._quic_server.close()
        await self.ctx.plugins.stop_all()
        await self.ctx.stop()

    async def serve_forever(self) -> None:
        await self.start()
        async with self._server:
            await self._server.serve_forever()

    # ---------------------------------------------------------- per-conn
    async def _on_ws_connection(self, reader, writer):
        """WS/WSS listener: upgrade, then serve the same MQTT handler
        (rmqtt-net ws.rs equivalent). The upgrade itself is gated by the
        overload check — slow-header floods must not bypass it."""
        from rmqtt_tpu_torch.broker.ws import WsReader, WsWriter, websocket_accept

        ctx = self.ctx
        if ctx.is_busy():
            ctx.metrics.inc("handshake.refused_busy")
            writer.close()
            return
        # the upgrade occupies an executor slot too: slow-header WS floods
        # must hit the same 35% busy rule as raw MQTT handshakes
        entry = await self._acquire_handshake_slot(writer)
        if entry is None:
            return
        try:
            peer = writer.get_extra_info("peername")
            if ctx.cfg.proxy_protocol and writer.get_extra_info("ssl_object") is None:
                # the PROXY header precedes the HTTP upgrade on the raw stream
                peer = await self._read_proxy(reader, writer, peer)
                if peer is None:
                    return
            ok = await websocket_accept(reader, writer)
        finally:
            entry.release()
        if not ok:
            writer.close()
            return
        ws_writer = WsWriter(writer)
        ws_reader = WsReader(reader, ws_writer)
        await self._on_connection(ws_reader, ws_writer, peer=peer)

    async def _acquire_handshake_slot(self, writer):
        """Take a slot in the listener's bounded handshake executor; → the
        entry (caller must release()), or None after refusing + closing."""
        sockname = writer.get_extra_info("sockname")
        entry = self.ctx.hs_executor.entry(sockname[1] if sockname else 0)
        try:
            await entry.acquire()
        except ExecutorFull:
            self.ctx.metrics.inc("handshake.refused_full")
            writer.close()
            return None
        return entry

    async def _read_proxy(self, reader, writer, peer):
        """Parse a PROXY v1/v2 header; → effective peer addr, or None after
        closing a connection with a malformed/timed-out header."""
        from rmqtt_tpu_torch.broker.proxy_protocol import ProxyProtocolError, read_proxy_header

        try:
            src = await asyncio.wait_for(
                read_proxy_header(reader), timeout=self.ctx.cfg.max_handshake_delay
            )
            return src if src is not None else peer
        except (ProxyProtocolError, asyncio.TimeoutError, asyncio.IncompleteReadError,
                ConnectionError, OSError):
            self.ctx.metrics.inc("proxy_protocol.errors")
            writer.close()
            return None

    async def _on_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter, peer=_UNSET
    ):
        ctx = self.ctx
        codec = MqttCodec(max_inbound_size=ctx.cfg.max_packet_size)
        ctx.metrics.inc("connections.accepted")
        # overload protection: refuse before reading ANY bytes — including a
        # PROXY header, so slow-header floods cannot bypass the gate
        # (v5.rs:120-125 busy check)
        if ctx.is_busy():
            ctx.metrics.inc("handshake.refused_busy")
            writer.close()
            return
        # per-listener bounded executor (executor.rs:66-137): handshakes
        # beyond the worker bound queue up to queue_max, then refuse
        entry = await self._acquire_handshake_slot(writer)
        if entry is None:
            return
        ctx.handshake_rate.inc()
        # connect-handshake latency stage: slot acquired → CONNACK decided
        # (covers PROXY header, CONNECT read, auth hooks, takeover wait)
        t0 = time.perf_counter_ns() if ctx.telemetry.enabled else 0
        try:
            if peer is _UNSET:
                peer = writer.get_extra_info("peername")
                if ctx.cfg.proxy_protocol and writer.get_extra_info("ssl_object") is None:
                    peer = await self._read_proxy(reader, writer, peer)
                    if peer is None:
                        return
            try:
                got = await asyncio.wait_for(
                    self._read_connect(reader, codec), timeout=ctx.cfg.max_handshake_delay
                )
            except (asyncio.TimeoutError, ProtocolViolation, ConnectionError):
                ctx.metrics.inc("handshake.failures")
                writer.close()
                return
            if got is None:
                writer.close()
                return
            connect, early = got
            state = await self._handshake(connect, reader, writer, codec, peer, early)
            if t0:
                ctx.telemetry.record(
                    "connect.handshake", time.perf_counter_ns() - t0,
                    {"client": connect.client_id,
                     "ok": state is not None},
                )
        finally:
            entry.release()
        if state is not None:
            state.early_packets = early
            try:
                await state.run()
            finally:
                ctx.metrics.inc("connections.closed")

    async def _read_first(self, reader, codec):
        """Read until at least one packet decodes; → (first, trailing) or
        None on EOF. Trailing packets a client pipelined into the same TCP
        segment are preserved for replay, never dropped."""
        while True:
            data = await reader.read(65536)
            if not data:
                return None
            packets = codec.feed(data)
            if packets:
                return packets[0], packets[1:]

    async def _read_connect(self, reader, codec):
        """Returns (Connect, trailing packets) or None. Clients may legally
        pipeline SUBSCRIBE/PUBLISH behind CONNECT in one TCP segment without
        waiting for CONNACK; trailing packets decoded from the same feed are
        replayed into the session read loop after the handshake."""
        got = await self._read_first(reader, codec)
        if got is None or not isinstance(got[0], pk.Connect):
            return None
        return got

    async def _handshake(self, connect: pk.Connect, reader, writer, codec, peer,
                         early: Optional[list] = None):
        """v5.rs `_handshake` :191-410 (v3 mirror). Returns the ready
        SessionState (caller runs it), or None if refused."""
        ctx = self.ctx
        v5 = connect.protocol == pk.V5
        # overload admission, second tier after the pre-read busy gate
        # (broker/overload.py): CRITICAL state or an exhausted per-listener
        # CONNECT bucket refuses with a REASON CODE the client can act on —
        # v5 Quota Exceeded (0x97), v3 Server Unavailable (0x03) — instead
        # of the busy gate's silent close
        if ctx.overload.enabled:
            sockname = writer.get_extra_info("sockname")
            if not ctx.overload.admit_connect(sockname[1] if sockname else 0):
                ctx.metrics.inc("handshake.refused_overload")
                from rmqtt_tpu_torch.broker.types import RC_QUOTA_EXCEEDED

                await self._refuse(writer, codec, v5, RC_QUOTA_EXCEEDED, 3)
                return None
        assigned_id = None
        if not connect.client_id:
            if not v5 and not connect.clean_start:
                await self._refuse(writer, codec, v5, 0x85, 2)
                return None
            assigned_id = uuid.uuid4().hex
            connect.client_id = assigned_id
        id = Id(ctx.node_id, connect.client_id)
        ci = ConnectInfo(
            id=id,
            protocol=connect.protocol,
            keepalive=connect.keepalive,
            clean_start=connect.clean_start,
            username=connect.username,
            password=connect.password,
            properties=connect.properties,
            remote_addr=peer,
            will=connect.will,
            cert_info=extract_cert_info(writer),
        )
        await ctx.hooks.fire(HookType.CLIENT_CONNECT, ci, None, None)
        # v5 enhanced authentication (spec §4.12, codec auth.rs): a CONNECT
        # carrying an Authentication Method runs the AUTH challenge loop
        # BEFORE basic auth; its success replaces the password check
        auth_method = connect.properties.get(P.AUTHENTICATION_METHOD) if v5 else None
        enhanced_ok = False
        auth_final_data = None
        if auth_method is not None:
            rc, auth_final_data = await self._auth_exchange(
                ci, auth_method, connect.properties.get(P.AUTHENTICATION_DATA),
                reader, writer, codec, early if early is not None else [],
            )
            if rc != RC_SUCCESS:
                ctx.metrics.inc("auth.failures")
                if rc >= 0:
                    await self._refuse(writer, codec, True, rc, 2)
                else:
                    writer.close()
                return None
            enhanced_ok = True
        # authenticate (client_authenticate hook; default allows anonymous
        # per config — auth plugins override via higher-priority handlers)
        default_auth = enhanced_ok or ctx.cfg.allow_anonymous or ci.username is not None
        allowed = await ctx.hooks.fire(HookType.CLIENT_AUTHENTICATE, ci, None, initial=default_auth)
        if not allowed:
            ctx.metrics.inc("auth.failures")
            await self._refuse(
                writer, codec, v5, RC_NOT_AUTHORIZED, V3_NOT_AUTHORIZED
            )
            return None
        if connect.keepalive == 0 and not ctx.cfg.allow_zero_keepalive:
            await self._refuse(writer, codec, v5, 0x8D, 2)
            return None
        limits = ctx.fitter.fit(ci)
        try:
            session, session_present = await ctx.registry.take_or_create(
                ctx, id, ci, limits, connect.clean_start
            )
        except HandshakeLockedError:
            # distributed handshake lock held elsewhere (raft mode): refuse
            # with Server Busy so the client retries (shared.rs:71-106)
            ctx.metrics.inc("handshake.lock_refused")
            await self._refuse(writer, codec, v5, 0x89, 3)
            return None
        # CONNACK (v5.rs:393-409)
        ack_props = {}
        if v5:
            if assigned_id:
                ack_props[P.ASSIGNED_CLIENT_IDENTIFIER] = assigned_id
            if limits.server_keepalive:
                ack_props[P.SERVER_KEEP_ALIVE] = limits.keepalive
            ack_props[P.TOPIC_ALIAS_MAXIMUM] = limits.max_topic_aliases_in
            ack_props[P.RECEIVE_MAXIMUM] = limits.max_inflight
            ack_props[P.SESSION_EXPIRY_INTERVAL] = int(limits.session_expiry)
            ack_props[P.RETAIN_AVAILABLE] = 1 if ctx.cfg.retain_enable else 0
            ack_props[P.SHARED_SUBSCRIPTION_AVAILABLE] = (
                1 if ctx.cfg.shared_subscription else 0
            )
            ack_props[P.MAXIMUM_QOS] = ctx.cfg.max_qos
            ack_props[P.MAXIMUM_PACKET_SIZE] = ctx.cfg.max_packet_size
        if auth_method is not None:
            # the CONNACK of a successful enhanced auth echoes the method and
            # carries any server-final data (e.g. SCRAM server proof)
            ack_props[P.AUTHENTICATION_METHOD] = auth_method
            if auth_final_data is not None:
                ack_props[P.AUTHENTICATION_DATA] = auth_final_data
        reason = await ctx.hooks.fire(
            HookType.CLIENT_CONNACK, ci, session_present, initial=RC_SUCCESS
        )
        connack = pk.Connack(
            session_present=session_present and reason == RC_SUCCESS,
            reason_code=reason if v5 else (V3_ACCEPTED if reason == 0 else reason),
            properties=ack_props,
        )
        if reason != RC_SUCCESS:
            writer.write(codec.encode(connack))
            await writer.drain()
            writer.close()
            return None
        # mark the session live BEFORE the CONNACK goes out: the client may
        # act on the CONNACK immediately (counters/kick/cluster queries race
        # otherwise)
        state = SessionState(ctx, session, reader, writer, codec)
        session.state = state
        session.connected = True
        try:
            writer.write(codec.encode(connack))
            await writer.drain()
        except (ConnectionError, OSError):
            # client vanished mid-handshake: unwind the just-activated
            # session instead of leaking a zombie 'connected' entry
            session.connected = False
            session.state = None
            session.on_disconnect(clean=False)
            writer.close()
            return None
        ctx.metrics.inc("connections.established")
        await ctx.hooks.fire(HookType.CLIENT_CONNECTED, ci, None, None)
        return state

    async def _auth_exchange(self, ci, method, data, reader, writer, codec, early: list):
        """Run the server side of the AUTH challenge loop. Returns
        (reason_code, server_final_data): 0x00 accept, failure codes refuse,
        -1 = close without CONNACK. Packets the client pipelined behind its
        AUTH replies are appended to ``early`` for session replay."""
        from rmqtt_tpu_torch.broker import auth as ea

        authenticator = self.ctx.enhanced_auth
        if authenticator is None:
            return ea.RC_BAD_AUTHENTICATION_METHOD, None
        try:
            rc, out = await authenticator.start(ci, method, data)
            while rc == ea.RC_CONTINUE_AUTHENTICATION:
                props = {P.AUTHENTICATION_METHOD: method}
                if out is not None:
                    props[P.AUTHENTICATION_DATA] = out
                writer.write(codec.encode(pk.Auth(rc, props)))
                await writer.drain()
                got = await asyncio.wait_for(
                    self._read_first(reader, codec), timeout=self.ctx.cfg.max_handshake_delay
                )
                if got is None:
                    return -1, None
                reply, rest = got
                early.extend(rest)
                if (
                    not isinstance(reply, pk.Auth)
                    or reply.properties.get(P.AUTHENTICATION_METHOD) != method
                ):
                    return 0x82, None  # Protocol Error: non-AUTH / method switch
                rc, out = await authenticator.continue_(
                    ci, method, reply.properties.get(P.AUTHENTICATION_DATA)
                )
            return rc, out
        except (asyncio.TimeoutError, ConnectionError, OSError, ProtocolViolation):
            return -1, None

    async def _refuse(self, writer, codec, v5: bool, rc5: int, rc3: int) -> None:
        try:
            writer.write(codec.encode(pk.Connack(False, rc5 if v5 else rc3)))
            await writer.drain()
        except Exception:
            pass
        writer.close()


async def _amain(args) -> None:
    from rmqtt_tpu_torch import conf

    # CLI flags become the highest config layer (file < env < cli); only
    # explicitly-passed flags override (argparse defaults are None).
    cli: dict = {}
    if args.host is not None:
        cli.setdefault("listener", {})["host"] = args.host
    if args.port is not None:
        cli.setdefault("listener", {})["port"] = args.port
    if args.node_id is not None:
        cli.setdefault("node", {})["id"] = args.node_id
    if args.router is not None:
        cli.setdefault("node", {})["router"] = args.router
    if args.cluster_listen is not None:
        cli.setdefault("cluster", {})["listen"] = args.cluster_listen
    if args.cluster_mode is not None:
        cli.setdefault("cluster", {})["mode"] = args.cluster_mode
    if args.peer:
        # "<node_id>@<host>:<port>" (reference NodeAddr format,
        # rmqtt-utils/src/lib.rs:121); CLI peers replace file peers
        cli.setdefault("cluster", {})["peers"] = list(args.peer)
    if args.reuse_port:
        cli.setdefault("listener", {})["reuse_port"] = True
    if args.fabric:
        cli.setdefault("fabric", {})["enable"] = True
    if args.fabric_dir is not None:
        cli.setdefault("fabric", {})["dir"] = args.fabric_dir
    if args.fabric_worker_id is not None:
        cli.setdefault("fabric", {})["worker_id"] = args.fabric_worker_id
    if args.fabric_workers is not None:
        cli.setdefault("fabric", {})["workers"] = args.fabric_workers
    settings = conf.load(args.config, cli=cli)
    # [log] section (file/console targets + level, logging.rs analogue);
    # replaces the bootstrap basicConfig from main()
    conf.setup_logging(settings.log, verbose=getattr(args, "verbose", False))
    broker = MqttBroker(ServerContext(settings.broker))
    conf.instantiate_plugins(broker.ctx, settings)
    cluster = None
    if settings.cluster_listen:
        if settings.broker.cluster_mode == "raft":
            from rmqtt_tpu_torch.cluster.raft_mode import RaftCluster

            cluster = RaftCluster(
                broker.ctx, settings.cluster_listen, settings.peers,
                raft_db=settings.raft_db,
                retain_sync_mode=settings.retain_sync_mode,
                **settings.cluster_tuning,
            )
        else:
            from rmqtt_tpu_torch.cluster.broadcast import BroadcastCluster

            cluster = BroadcastCluster(
                broker.ctx, settings.cluster_listen, settings.peers,
                retain_sync_mode=settings.retain_sync_mode,
                **settings.cluster_tuning,
            )
        await cluster.start()
    api = None
    if settings.http_api and not getattr(args, "no_http_api", False):
        # under --workers only worker 1 serves the admin API (one port)
        from rmqtt_tpu_torch.broker.http_api import HttpApi

        api = HttpApi(broker.ctx, **settings.http_api)
    await broker.start()
    if api is not None:
        await api.start()
    if cluster is not None:
        await cluster.start_sync()
        log.info(
            "cluster node %s listening on %s", settings.broker.node_id,
            settings.cluster_listen,
        )
    async with broker._server:
        await broker._server.serve_forever()


def _worker_passthrough(argv: list) -> list:
    """CLI args forwarded verbatim to each worker process (the supervisor
    re-adds the per-worker role flags itself)."""
    passthrough = []
    skip = 0
    supervisor_flags = ("--workers", "--cluster-port-base", "--fabric-dir",
                        "--fabric-worker-id", "--fabric-workers")
    for a in argv:
        if skip:
            skip -= 1
            continue
        if a in supervisor_flags:
            skip = 1
            continue
        if a == "--fabric" or any(a.startswith(f + "=")
                                  for f in supervisor_flags):
            continue
        passthrough.append(a)
    return passthrough


def _worker_cmds(args, argv: list, fabric_dir=None) -> list:
    """The N worker command lines for ``--workers N``.

    Without a fabric dir this is EXACTLY the historical shape — worker i
    gets node id i+1 and peers over a localhost broadcast cluster on RPC
    port base+i (the zero-behavior-change pin, tests/test_fabric.py). With
    one, workers carry fabric role flags instead: same node ids, no
    cluster peering — cross-worker routing rides the UDS mesh."""
    n = args.workers
    passthrough = _worker_passthrough(argv)
    cmds = []
    if fabric_dir is None:
        if args.cluster_port_base:
            base = args.cluster_port_base
        else:
            # the client port may come from the config file, not the CLI —
            # resolve the effective port before deriving RPC ports off it
            from rmqtt_tpu_torch import conf

            cli = ({"listener": {"port": args.port}}
                   if args.port is not None else {})
            base = conf.load(args.config, cli=cli).broker.port + 1000
        for i in range(n):
            cmd = [sys.executable, "-m", "rmqtt_tpu_torch.broker", *passthrough,
                   "--reuse-port", "--node-id", str(i + 1),
                   "--cluster-listen", f"127.0.0.1:{base + i}",
                   "--cluster-mode", "broadcast"]
            for j in range(n):
                if j != i:
                    cmd += ["--peer", f"{j + 1}@127.0.0.1:{base + j}"]
            if i > 0:
                cmd.append("--no-http-api")
            cmds.append(cmd)
        return cmds
    for i in range(n):
        cmd = [sys.executable, "-m", "rmqtt_tpu_torch.broker", *passthrough,
               "--reuse-port", "--node-id", str(i + 1),
               "--fabric", "--fabric-dir", fabric_dir,
               "--fabric-worker-id", str(i + 1),
               "--fabric-workers", str(n)]
        if i > 0:
            cmd.append("--no-http-api")
        cmds.append(cmd)
    return cmds


def _supervise_workers(args, argv: list) -> None:
    """--workers N: spawn N broker processes sharing the client port via
    SO_REUSEPORT (kernel load-balances accepts — the multi-core analogue of
    the reference's multi-thread tokio accept loop, server.rs:229). Without
    [fabric] they peer as a localhost broadcast cluster for cross-worker
    delivery — exactly the historical behavior; with it they wire into the
    intra-node routing fabric (broker/fabric.py: worker 1 owns the device
    table, the rest submit over UDS). Worker i gets node id i+1; only
    worker 1 serves the admin API. The supervisor forwards SIGTERM/SIGINT.

    Death policy: in broadcast mode any unrequested worker death stops the
    group (restart policy is external, e.g. systemd). In fabric mode the
    supervisor RESPAWNS the dead worker — owner included: survivors detect
    the dead owner on the UDS link, park submits, and re-register their
    session/subscription state with the respawn, so sessions on the other
    workers survive an owner crash. A crash loop (>5 deaths of one worker
    inside 30s) still stops the group."""
    import signal
    import subprocess

    if args.cluster_mode or args.cluster_listen or args.node_id or args.peer:
        sys.exit("--workers manages node ids and the cluster itself; it "
                 "cannot combine with --cluster-mode/--cluster-listen/"
                 "--node-id/--peer")
    if args.config:
        from rmqtt_tpu_torch import conf

        if conf.load(args.config).broker.durability_enable:
            # every worker would recover + journal into ONE store file:
            # duplicated sessions per process and colliding journal seqs
            # (upserts overwrite each other). Same class of guard as
            # fabric+cluster — fail at launch, not at the first kill -9.
            sys.exit("[durability] cannot combine with --workers: each "
                     "worker process would recover and journal into the "
                     "same store (run the durability plane single-process)")
    fabric_dir = None
    fabric_tmp = None
    fabric_on = args.fabric or args.fabric_dir
    if not fabric_on and args.config:
        from rmqtt_tpu_torch import conf

        fabric_on = conf.load(args.config).broker.fabric_enable
    if fabric_on:
        if args.fabric_dir:
            fabric_dir = args.fabric_dir
            os.makedirs(fabric_dir, exist_ok=True)
        else:
            import tempfile

            fabric_dir = fabric_tmp = tempfile.mkdtemp(prefix="rmqtt-fabric-")
    cmds = _worker_cmds(args, argv, fabric_dir=fabric_dir)
    procs = {i: subprocess.Popen(cmd) for i, cmd in enumerate(cmds)}
    deaths: dict = {i: [] for i in procs}  # slot → recent death times
    stopping = False

    def stop(_sig, _frm):
        nonlocal stopping
        stopping = True
        for p in procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)

    signal.signal(signal.SIGTERM, stop)
    signal.signal(signal.SIGINT, stop)
    rc = 0
    try:
        while True:
            alive = 0
            for i, p in list(procs.items()):
                r = p.poll()
                if r is None:
                    alive += 1
                    continue
                if stopping:
                    continue
                if fabric_dir is not None:
                    now = time.monotonic()
                    deaths[i] = [t for t in deaths[i] if now - t < 30.0] + [now]
                    if len(deaths[i]) <= 5:
                        log.warning("worker %d died (rc=%s); respawning",
                                    i + 1, r)
                        procs[i] = subprocess.Popen(cmds[i])
                        alive += 1
                        continue
                    log.error("worker %d crash-looping; stopping the group",
                              i + 1)
                # broadcast mode (or a crash loop): an unrequested worker
                # death degrades the whole listener group — stop the rest
                rc = rc or (r if r > 0 else 1)
                stopping = True
                for q in procs.values():
                    if q.poll() is None:
                        q.send_signal(signal.SIGTERM)
            if stopping and alive == 0:
                break
            time.sleep(0.3)
    finally:
        for p in procs.values():
            p.wait()
        if fabric_tmp is not None:
            import shutil

            shutil.rmtree(fabric_tmp, ignore_errors=True)
    sys.exit(rc)


def parse_args(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="rmqtt_tpu_torch broker")
    ap.add_argument("--config", default=None, help="TOML settings file (rmqtt.toml)")
    ap.add_argument("--host", default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--node-id", type=int, default=None)
    ap.add_argument("--router", choices=["trie", "native", "xla"], default=None)
    ap.add_argument("--cluster-listen", default=None, help="host:port for cluster RPC")
    ap.add_argument("--cluster-mode", choices=["broadcast", "raft"], default=None)
    ap.add_argument(
        "--peer", action="append", default=[],
        help="peer node as <node_id>@<host>:<port>; repeatable",
    )
    ap.add_argument(
        "--workers", type=int, default=1,
        help="worker processes sharing the client port via SO_REUSEPORT",
    )
    ap.add_argument("--reuse-port", action="store_true",
                    help="set SO_REUSEPORT on the client listeners")
    ap.add_argument("--cluster-port-base", type=int, default=None,
                    help="first cluster RPC port for --workers (default port+1000)")
    ap.add_argument("--fabric", action="store_true",
                    help="intra-node routing fabric: with --workers, wire "
                         "the workers to one router owner over a UDS mesh "
                         "instead of a localhost broadcast cluster")
    ap.add_argument("--fabric-dir", default=None,
                    help="fabric UDS socket directory (default: a temp dir "
                         "managed by the --workers supervisor)")
    ap.add_argument("--fabric-worker-id", type=int, default=None,
                    help="this process's fabric worker id (default: node id)")
    ap.add_argument("--fabric-workers", type=int, default=None,
                    help="expected fabric worker count (informational)")
    ap.add_argument("--no-http-api", action="store_true",
                    help="do not start the admin HTTP API in this process")
    ap.add_argument("-v", "--verbose", action="store_true")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO)
    if args.workers and args.workers > 1:
        _supervise_workers(args, sys.argv[1:] if argv is None else list(argv))
        return
    asyncio.run(_amain(args))


if __name__ == "__main__":
    main()
