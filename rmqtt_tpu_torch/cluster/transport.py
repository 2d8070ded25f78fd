"""Asyncio TCP mesh: the cluster's node-to-node RPC transport.

The reference's data plane is handy-grpc/tonic with duplex + fire-and-forget
mailboxes, 2 MB chunking, 4 MB caps, priority queues and a per-client tower
circuit breaker (`rmqtt/src/grpc.rs:107-172, 286-354`). The equivalents here:

- length-prefixed frames (cap enforced) over one TCP connection per peer,
  with lazy connect + exponential backoff reconnect;
- ``notify`` (fire-and-forget) and ``call`` (request/reply with correlation
  ids + timeout);
- a simple circuit breaker per peer (open after N consecutive failures,
  half-open probe after a cooldown) mirroring the reference's breaker config
  (`rmqtt/src/context.rs:585-677`);
- broadcast helpers with the reference's combinator semantics
  (`join_all`/`select_ok`, grpc.rs:718-890).
"""

from __future__ import annotations

import asyncio
import itertools
import logging
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple

from rmqtt_tpu_torch.broker.overload import CircuitBreaker
from rmqtt_tpu_torch.cluster import wire
from rmqtt_tpu_torch.utils.failpoints import FAILPOINTS, FailpointError

log = logging.getLogger("rmqtt_tpu_torch.cluster")

#: chaos seam (utils/failpoints.py): fires on outbound publish-forward
#: frames only (FORWARDS / FORWARDS_TO) — an injected error is surfaced as
#: PeerUnavailable and feeds the peer breaker, exactly like a dropped link
_FP_FORWARD = FAILPOINTS.register("cluster.forward")
_FORWARD_TYPES = ("forwards", "forwards_to")  # messages.M constants

#: partition seam: fires on EVERY cluster frame — outbound sends fail fast
#: as PeerUnavailable (feeding the breaker), inbound frames are dropped
#: before dispatch so the sender times out like a blackholed link. Arming
#: ``error`` on one process therefore cuts it off symmetrically: its calls
#: fail, and calls TO it stall to timeout — a network partition the
#: membership detector (cluster/membership.py) must detect and heal from
_FP_RPC = FAILPOINTS.register("cluster.rpc")

MAX_FRAME = wire.MAX_FRAME  # reference caps messages at 4MB (grpc.rs:154)


class PeerUnavailable(ConnectionError):
    pass


class ClusterReplyError(RuntimeError):
    """The peer's handler failed (its error travels as a ``__err`` reply)."""


# length-prefixed framing shared with the intra-node fabric (cluster/wire.py)
async def _read_frame(reader: asyncio.StreamReader) -> Any:
    return await wire.read_frame(reader)


def _frame(obj: Any) -> bytes:
    return wire.frame(obj)


# The per-peer breaker is the SHARED overload-subsystem implementation
# (broker/overload.py CircuitBreaker): closed/open/half-open with
# exponential backoff + jitter. Same contract as the old inline breaker —
# rejected-while-open attempts never re-arm the cooldown (a fast retry loop
# like the raft heartbeat must not be able to hold a peer open forever) —
# plus bounded-backoff probing and snapshot() for /api/v1/overload; the
# import above keeps `transport.CircuitBreaker` a valid name for callers.


class PeerClient:
    """Outbound connection to one peer node (lazy, auto-reconnect)."""

    def __init__(self, node_id: int, host: str, port: int, timeout: float = 5.0) -> None:
        self.node_id = node_id
        self.host = host
        self.port = port
        self.timeout = timeout
        self.breaker = CircuitBreaker()
        self._writer: Optional[asyncio.StreamWriter] = None
        self._reader_task: Optional[asyncio.Task] = None
        self._pending: Dict[int, asyncio.Future] = {}
        self._corr = itertools.count(1)
        self._lock = asyncio.Lock()
        self._connect_lock = asyncio.Lock()

    @property
    def connected(self) -> bool:
        return self._writer is not None

    async def _ensure(self) -> None:
        if self._writer is not None:
            return
        # serialize, as the fabric's _Link does: concurrent callers on a
        # fresh link (a heartbeat vs the startup retain pull, several
        # publish forwards) must not open duplicate connections — the
        # loser's writer is dropped and closed, and its read loop then
        # tears down the winner with every call pending on it
        async with self._connect_lock:
            if self._writer is not None:
                return
            if not self.breaker.allow():
                raise PeerUnavailable(f"circuit open to node {self.node_id}")
            try:
                reader, writer = await asyncio.wait_for(
                    asyncio.open_connection(self.host, self.port), self.timeout
                )
            except (OSError, asyncio.TimeoutError) as e:
                self.breaker.fail()
                raise PeerUnavailable(f"connect to node {self.node_id} failed: {e}") from e
            self._writer = writer
            self._reader_task = asyncio.get_running_loop().create_task(self._read_loop(reader))
            self.breaker.ok()

    async def _read_loop(self, reader: asyncio.StreamReader) -> None:
        try:
            while True:
                frame = await _read_frame(reader)
                corr = frame.get("corr")
                fut = self._pending.pop(corr, None)
                if fut is not None and not fut.done():
                    fut.set_result(frame.get("reply"))
        except (ConnectionError, asyncio.IncompleteReadError, ValueError):
            pass
        finally:
            self._teardown(ConnectionError("peer connection lost"))

    def _teardown(self, exc: Exception) -> None:
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:
                pass
            self._writer = None
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(PeerUnavailable(str(exc)))
        self._pending.clear()

    async def _send(self, obj: dict) -> None:
        if _FP_RPC.action is not None:
            try:
                await _FP_RPC.fire_async()
            except FailpointError as e:
                self.breaker.fail()
                raise PeerUnavailable(str(e)) from e
        if _FP_FORWARD.action is not None and obj.get("t") in _FORWARD_TYPES:
            try:
                await _FP_FORWARD.fire_async()
            except FailpointError as e:
                self.breaker.fail()
                raise PeerUnavailable(str(e)) from e
        await self._ensure()
        assert self._writer is not None
        try:
            async with self._lock:
                self._writer.write(_frame(obj))
                await self._writer.drain()
        except (OSError, ConnectionError) as e:
            self.breaker.fail()
            self._teardown(e)
            raise PeerUnavailable(str(e)) from e

    async def notify(self, mtype: str, body: Any = None) -> None:
        """Fire-and-forget (reference fire-and-forget mailbox)."""
        await self._send({"t": mtype, "b": body})

    async def call(self, mtype: str, body: Any = None, timeout: Optional[float] = None) -> Any:
        """Request/reply with correlation id (reference duplex mailbox)."""
        corr = next(self._corr)
        fut = asyncio.get_running_loop().create_future()
        self._pending[corr] = fut
        try:
            try:
                await self._send({"t": mtype, "b": body, "corr": corr})
            except PeerUnavailable as e:
                # _send counted this failure on the breaker already: a
                # second count opened it after half its threshold of calls
                raise PeerUnavailable(f"call {mtype} to node {self.node_id}: {e}") from e
            try:
                result = await asyncio.wait_for(fut, timeout or self.timeout)
            except (asyncio.TimeoutError, PeerUnavailable) as e:
                self.breaker.fail()
                raise PeerUnavailable(f"call {mtype} to node {self.node_id}: {e}") from e
            self.breaker.ok()
            if isinstance(result, dict) and "__err" in result:
                raise ClusterReplyError(result["__err"])
            return result
        finally:
            self._pending.pop(corr, None)

    async def close(self) -> None:
        task, self._reader_task = self._reader_task, None
        if task is not None:
            task.cancel()
        self._teardown(ConnectionError("closed"))
        if task is not None:
            # await the cancelled reader so interpreter teardown never sees
            # a half-dead task ("Task was destroyed but it is pending")
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass


# handler(mtype, body, from_node) -> reply value (or None)
Handler = Callable[[str, Any, Optional[int]], Awaitable[Any]]


class ClusterServer:
    """Inbound side: accepts peer connections, dispatches to the handler."""

    def __init__(self, host: str, port: int, handler: Handler) -> None:
        self.host = host
        self.port = port
        self.handler = handler
        self._server: Optional[asyncio.base_events.Server] = None
        self._conns: set[asyncio.StreamWriter] = set()
        self._closing = False

    @property
    def bound_port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._on_conn, self.host, self.port)

    async def stop(self) -> None:
        if self._server is not None:
            # drop live peer connections first: wait_closed (py3.12) waits
            # for the handlers, which would otherwise serve forever; a link
            # accepted before close() whose handler starts after this loop
            # closes itself in _on_conn (the flag)
            self._closing = True
            self._server.close()
            for w in list(self._conns):
                try:
                    w.close()
                except Exception:
                    pass
            await self._server.wait_closed()

    async def _on_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        if self._closing:
            writer.close()
            return
        self._conns.add(writer)
        wlock = asyncio.Lock()
        pending: set = set()

        async def dispatch(frame: dict) -> None:
            # handlers run concurrently: a slow handler (e.g. a raft-mode
            # KICK that itself awaits consensus) must not stall heartbeats
            # and votes multiplexed on the same peer connection
            mtype, body, corr = frame.get("t"), frame.get("b"), frame.get("corr")
            try:
                reply = await self.handler(mtype, body, frame.get("node"))
            except ClusterReplyError as e:  # expected, travels to caller
                reply = {"__err": str(e)}
            except Exception as e:  # handler bugs become error replies
                log.exception("cluster handler error for %s", mtype)
                reply = {"__err": str(e)}
            if corr is not None:
                try:
                    async with wlock:
                        writer.write(_frame({"corr": corr, "reply": reply}))
                        await writer.drain()
                except (ConnectionError, OSError):
                    pass

        try:
            while True:
                frame = await _read_frame(reader)
                if _FP_RPC.action is not None:
                    # partition seam, inbound half: drop the frame silently
                    # (the sender sees a stall, not an error — blackhole)
                    try:
                        await _FP_RPC.fire_async()
                    except FailpointError:
                        continue
                task = asyncio.get_running_loop().create_task(dispatch(frame))
                pending.add(task)
                task.add_done_callback(pending.discard)
        except (ConnectionError, asyncio.IncompleteReadError, ValueError):
            pass
        finally:
            self._conns.discard(writer)
            for t in pending:
                t.cancel()
            try:
                writer.close()
            except Exception:
                pass


class Broadcaster:
    """Fan-out combinators over a peer set (grpc.rs MessageBroadcaster)."""

    def __init__(self, peers: List[PeerClient]) -> None:
        self.peers = peers

    async def join_all_notify(self, mtype: str, body: Any = None) -> List[Optional[Exception]]:
        async def one(p: PeerClient):
            try:
                await p.notify(mtype, body)
                return None
            except Exception as e:
                return e

        return list(await asyncio.gather(*(one(p) for p in self.peers)))

    async def join_all_call(
        self, mtype: str, body: Any = None, timeout: Optional[float] = None
    ) -> List[Tuple[int, Any]]:
        """All replies as (node_id, reply-or-exception)."""

        async def one(p: PeerClient):
            try:
                return p.node_id, await p.call(mtype, body, timeout)
            except Exception as e:
                return p.node_id, e

        return list(await asyncio.gather(*(one(p) for p in self.peers)))

    async def select_ok(self, mtype: str, body: Any = None, timeout: Optional[float] = None) -> Any:
        """First successful reply wins (grpc.rs select_ok)."""
        errs = []
        for node_id, reply in await self.join_all_call(mtype, body, timeout):
            if not isinstance(reply, Exception):
                return reply
            errs.append((node_id, reply))
        raise PeerUnavailable(f"no peer answered {mtype}: {errs}")
