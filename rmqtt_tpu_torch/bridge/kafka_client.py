"""Dependency-free Kafka wire-protocol client (asyncio).

The reference's Kafka bridges (`rmqtt-plugins/rmqtt-bridge-ingress-kafka`,
`-egress-kafka`) sit on rdkafka; no Kafka stack ships in this image, so this
is an independent implementation of the protocol subset a bridge needs
(kafka.apache.org/protocol, non-flexible message versions to keep the
encoding simple):

- Metadata v1 (key 3) — topic → partition leaders,
- Produce v3 (key 0) — RecordBatch (magic 2, CRC32C) publishing,
- Fetch v4 (key 1) — RecordBatch consumption,
- ListOffsets v1 (key 2) — earliest/latest offset resolution.

Like the reference bridge, partition assignment is explicit/manual (its
``start_partition``/``stop_partition`` config) — no consumer-group
coordination. One connection per broker node, requests serialized per
connection (bridge volumes don't need pipelining).
"""

from __future__ import annotations

import asyncio
import logging
import struct
from typing import Dict, List, Optional, Sequence, Tuple

log = logging.getLogger("rmqtt_tpu_torch.bridge.kafka")

API_PRODUCE = 0
API_FETCH = 1
API_LIST_OFFSETS = 2
API_METADATA = 3

EARLIEST = -2
LATEST = -1


class KafkaError(Exception):
    def __init__(self, code: int, where: str) -> None:
        super().__init__(f"kafka error {code} in {where}")
        self.code = code


# ------------------------------------------------------------------- crc32c
def _make_crc32c_table():
    poly = 0x82F63B78
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C_TABLE = _make_crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC32C_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# ------------------------------------------------------------------ varints
def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def _unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def write_varint(out: bytearray, n: int) -> None:
    n = _zigzag(n) & 0xFFFFFFFFFFFFFFFF
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    shift = result = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return _unzigzag(result), pos
        shift += 7


# ----------------------------------------------------------- wire primitives
class Writer:
    def __init__(self) -> None:
        self.b = bytearray()

    def i8(self, v):
        self.b += struct.pack(">b", v)

    def i16(self, v):
        self.b += struct.pack(">h", v)

    def i32(self, v):
        self.b += struct.pack(">i", v)

    def i64(self, v):
        self.b += struct.pack(">q", v)

    def string(self, s: Optional[str]):
        if s is None:
            self.i16(-1)
        else:
            raw = s.encode()
            self.i16(len(raw))
            self.b += raw

    def bytes_(self, v: Optional[bytes]):
        if v is None:
            self.i32(-1)
        else:
            self.i32(len(v))
            self.b += v


class Reader:
    def __init__(self, buf: bytes) -> None:
        self.buf = buf
        self.pos = 0

    def _unpack(self, fmt, size):
        v = struct.unpack_from(fmt, self.buf, self.pos)[0]
        self.pos += size
        return v

    def i8(self):
        return self._unpack(">b", 1)

    def i16(self):
        return self._unpack(">h", 2)

    def i32(self):
        return self._unpack(">i", 4)

    def i64(self):
        return self._unpack(">q", 8)

    def string(self) -> Optional[str]:
        n = self.i16()
        if n < 0:
            return None
        v = self.buf[self.pos : self.pos + n].decode()
        self.pos += n
        return v

    def bytes_(self) -> Optional[bytes]:
        n = self.i32()
        if n < 0:
            return None
        v = bytes(self.buf[self.pos : self.pos + n])
        self.pos += n
        return v


# --------------------------------------------------------------- recordbatch
def encode_record_batch(
    records: Sequence[Tuple[Optional[bytes], Optional[bytes], Sequence[Tuple[str, bytes]]]],
    first_timestamp_ms: int,
    base_offset: int = 0,
) -> bytes:
    """records: [(key, value, headers)] → one RecordBatch (magic 2).
    ``base_offset`` is 0 for produce (the broker assigns); a broker-side
    encoder (the test fake) passes the log position."""
    body = bytearray()
    recs = bytearray()
    for i, (key, value, headers) in enumerate(records):
        rec = bytearray()
        rec.append(0)  # attributes
        write_varint(rec, 0)  # timestampDelta
        write_varint(rec, i)  # offsetDelta
        if key is None:
            write_varint(rec, -1)
        else:
            write_varint(rec, len(key))
            rec += key
        if value is None:
            write_varint(rec, -1)
        else:
            write_varint(rec, len(value))
            rec += value
        write_varint(rec, len(headers))
        for hk, hv in headers:
            hkr = hk.encode()
            write_varint(rec, len(hkr))
            rec += hkr
            write_varint(rec, len(hv))
            rec += hv
        write_varint(recs, len(rec))
        recs += rec
    n = len(records)
    # fields covered by the CRC (attributes .. records)
    crc_body = bytearray()
    crc_body += struct.pack(">h", 0)  # attributes (no compression)
    crc_body += struct.pack(">i", n - 1)  # lastOffsetDelta
    crc_body += struct.pack(">q", first_timestamp_ms)
    crc_body += struct.pack(">q", first_timestamp_ms)
    crc_body += struct.pack(">q", -1)  # producerId
    crc_body += struct.pack(">h", -1)  # producerEpoch
    crc_body += struct.pack(">i", -1)  # baseSequence
    crc_body += struct.pack(">i", n)
    crc_body += recs
    body += struct.pack(">q", base_offset)
    batch_len = 4 + 1 + 4 + len(crc_body)  # leaderEpoch + magic + crc + rest
    body += struct.pack(">i", batch_len)
    body += struct.pack(">i", -1)  # partitionLeaderEpoch
    body += struct.pack(">b", 2)  # magic
    body += struct.pack(">I", crc32c(bytes(crc_body)))
    body += crc_body
    return bytes(body)


def decode_record_batches(buf: bytes):
    """→ [(offset, timestamp_ms, key, value, headers)] across all batches."""
    out = []
    pos = 0
    while pos + 17 <= len(buf):
        base_offset = struct.unpack_from(">q", buf, pos)[0]
        batch_len = struct.unpack_from(">i", buf, pos + 8)[0]
        if batch_len <= 0 or pos + 12 + batch_len > len(buf):
            break  # partial batch at the end of a fetch response
        magic = buf[pos + 16]
        if magic != 2:
            log.warning("skipping record batch with magic %s", magic)
            pos += 12 + batch_len
            continue
        p = pos + 12 + 4 + 1 + 4  # skip leaderEpoch, magic, crc
        # attributes(2) lastOffsetDelta(4) firstTs(8) maxTs(8) producerId(8)
        # producerEpoch(2) baseSequence(4) count(4) = 40 bytes to the records
        attributes = struct.unpack_from(">h", buf, p)[0]
        first_ts = struct.unpack_from(">q", buf, p + 6)[0]
        count = struct.unpack_from(">i", buf, p + 36)[0]
        p += 40
        if attributes & 0x07:
            log.warning("skipping compressed record batch (codec %s)", attributes & 0x07)
            pos += 12 + batch_len
            continue
        for _ in range(count):
            rec_len, p = read_varint(buf, p)
            rec_end = p + rec_len
            p += 1  # attributes
            ts_delta, p = read_varint(buf, p)
            off_delta, p = read_varint(buf, p)
            klen, p = read_varint(buf, p)
            key = bytes(buf[p : p + klen]) if klen >= 0 else None
            p += max(0, klen)
            vlen, p = read_varint(buf, p)
            value = bytes(buf[p : p + vlen]) if vlen >= 0 else None
            p += max(0, vlen)
            nh, p = read_varint(buf, p)
            headers = []
            for _h in range(nh):
                hklen, p = read_varint(buf, p)
                hk = buf[p : p + hklen].decode()
                p += hklen
                hvlen, p = read_varint(buf, p)
                hv = bytes(buf[p : p + hvlen]) if hvlen >= 0 else b""
                p += max(0, hvlen)
                headers.append((hk, hv))
            out.append((base_offset + off_delta, first_ts + ts_delta, key, value, headers))
            p = rec_end
        pos += 12 + batch_len
    return out


# ------------------------------------------------------------------- client
class _Conn:
    def __init__(self, host: str, port: int, client_id: str) -> None:
        self.host, self.port = host, port
        self.client_id = client_id
        self.reader: Optional[asyncio.StreamReader] = None
        self.writer: Optional[asyncio.StreamWriter] = None
        self._corr = 0
        self._lock = asyncio.Lock()

    async def connect(self) -> None:
        self.reader, self.writer = await asyncio.open_connection(self.host, self.port)

    def close(self) -> None:
        if self.writer is not None:
            try:
                self.writer.close()
            except Exception:
                pass
        self.reader = self.writer = None

    async def call(self, api_key: int, api_version: int, body: bytes,
                   timeout: float = 30.0) -> Reader:
        async with self._lock:
            if self.writer is None:
                await self.connect()
            self._corr += 1
            corr = self._corr
            head = Writer()
            head.i16(api_key)
            head.i16(api_version)
            head.i32(corr)
            head.string(self.client_id)
            frame = bytes(head.b) + body
            self.writer.write(struct.pack(">i", len(frame)) + frame)
            await self.writer.drain()
            try:
                raw = await asyncio.wait_for(self.reader.readexactly(4), timeout)
                (size,) = struct.unpack(">i", raw)
                payload = await asyncio.wait_for(self.reader.readexactly(size), timeout)
            except (asyncio.TimeoutError, asyncio.IncompleteReadError):
                self.close()
                raise ConnectionError(f"kafka {self.host}:{self.port} request failed")
            r = Reader(payload)
            got_corr = r.i32()
            if got_corr != corr:
                self.close()
                raise ConnectionError(f"kafka correlation mismatch {got_corr} != {corr}")
            return r


class KafkaClient:
    """Bootstrap + per-leader connections + the 4 APIs a bridge needs."""

    def __init__(self, servers: str, client_id: str = "rmqtt-bridge") -> None:
        # "host1:9092,host2:9092" (reference Bridge.servers format)
        self.bootstrap: List[Tuple[str, int]] = []
        for part in servers.split(","):
            host, _, port = part.strip().rpartition(":")
            self.bootstrap.append((host or part.strip(), int(port or 9092)))
        self.client_id = client_id
        self._conns: Dict[Tuple[str, int], _Conn] = {}
        # topic → {partition: (host, port)}
        self._leaders: Dict[str, Dict[int, Tuple[str, int]]] = {}

    def _conn(self, addr: Tuple[str, int]) -> _Conn:
        c = self._conns.get(addr)
        if c is None:
            c = self._conns[addr] = _Conn(addr[0], addr[1], self.client_id)
        return c

    async def close(self) -> None:
        for c in self._conns.values():
            c.close()
        self._conns.clear()

    async def _bootstrap_call(self, api, ver, body) -> Reader:
        last: Optional[Exception] = None
        for addr in self.bootstrap:
            try:
                return await self._conn(addr).call(api, ver, body)
            except (ConnectionError, OSError) as e:
                last = e
        raise last if last is not None else ConnectionError("no kafka bootstrap servers")

    # ------------------------------------------------------------- metadata
    async def metadata(self, topics: Sequence[str]) -> Dict[str, Dict[int, Tuple[str, int]]]:
        w = Writer()
        w.i32(len(topics))
        for t in topics:
            w.string(t)
        r = await self._bootstrap_call(API_METADATA, 1, bytes(w.b))
        nodes: Dict[int, Tuple[str, int]] = {}
        for _ in range(r.i32()):
            node_id = r.i32()
            host = r.string()
            port = r.i32()
            r.string()  # rack
            nodes[node_id] = (host, port)
        r.i32()  # controller id
        for _ in range(r.i32()):
            terr = r.i16()
            name = r.string()
            r.i8()  # is_internal
            parts: Dict[int, Tuple[str, int]] = {}
            for _p in range(r.i32()):
                perr = r.i16()
                pid = r.i32()
                leader = r.i32()
                for _x in range(r.i32()):
                    r.i32()  # replicas
                for _x in range(r.i32()):
                    r.i32()  # isr
                if perr == 0 and leader in nodes:
                    parts[pid] = nodes[leader]
            if terr == 0:
                self._leaders[name] = parts
        return {t: self._leaders.get(t, {}) for t in topics}

    async def _leader(self, topic: str, partition: int) -> Tuple[str, int]:
        parts = self._leaders.get(topic)
        if not parts or partition not in parts:
            await self.metadata([topic])
            parts = self._leaders.get(topic) or {}
        if partition not in parts:
            raise KafkaError(3, f"no leader for {topic}[{partition}]")  # UNKNOWN_TOPIC
        return parts[partition]

    async def partitions(self, topic: str) -> List[int]:
        if topic not in self._leaders:
            await self.metadata([topic])
        return sorted(self._leaders.get(topic, {}))

    # -------------------------------------------------------------- produce
    async def produce(
        self, topic: str, value: bytes, key: Optional[bytes] = None,
        partition: int = 0, headers: Sequence[Tuple[str, bytes]] = (),
        timestamp_ms: int = 0, acks: int = -1,
    ) -> int:
        """→ assigned base offset."""
        batch = encode_record_batch([(key, value, headers)], timestamp_ms)
        w = Writer()
        w.string(None)  # transactional_id
        w.i16(acks)
        w.i32(30_000)  # timeout
        w.i32(1)  # one topic
        w.string(topic)
        w.i32(1)  # one partition
        w.i32(partition)
        w.bytes_(batch)
        addr = await self._leader(topic, partition)
        try:
            r = await self._conn(addr).call(API_PRODUCE, 3, bytes(w.b))
        except ConnectionError:
            self._leaders.pop(topic, None)  # leadership may have moved
            raise
        r.i32()  # topic count (1)
        r.string()
        r.i32()  # partition count (1)
        r.i32()  # partition
        err = r.i16()
        base_offset = r.i64()
        if err != 0:
            self._leaders.pop(topic, None)
            raise KafkaError(err, f"produce {topic}[{partition}]")
        return base_offset

    # ---------------------------------------------------------------- fetch
    async def fetch(
        self, topic: str, partition: int, offset: int,
        max_wait_ms: int = 500, min_bytes: int = 1, max_bytes: int = 1 << 20,
    ):
        """→ (records [(offset, ts, key, value, headers)], high_watermark)."""
        w = Writer()
        w.i32(-1)  # replica_id
        w.i32(max_wait_ms)
        w.i32(min_bytes)
        w.i32(max_bytes)
        w.i8(0)  # isolation: read uncommitted
        w.i32(1)
        w.string(topic)
        w.i32(1)
        w.i32(partition)
        w.i64(offset)
        w.i32(max_bytes)
        addr = await self._leader(topic, partition)
        r = await self._conn(addr).call(API_FETCH, 4, bytes(w.b))
        r.i32()  # throttle
        r.i32()  # topic count (1)
        r.string()
        r.i32()  # partition count (1)
        r.i32()  # partition
        err = r.i16()
        high_watermark = r.i64()
        r.i64()  # last stable offset
        for _ in range(r.i32()):  # aborted transactions
            r.i64()
            r.i64()
        record_set = r.bytes_() or b""
        if err != 0:
            self._leaders.pop(topic, None)
            raise KafkaError(err, f"fetch {topic}[{partition}]")
        records = [rec for rec in decode_record_batches(record_set) if rec[0] >= offset]
        return records, high_watermark

    # --------------------------------------------------------- list offsets
    async def list_offset(self, topic: str, partition: int, at: int = LATEST) -> int:
        w = Writer()
        w.i32(-1)  # replica_id
        w.i32(1)
        w.string(topic)
        w.i32(1)
        w.i32(partition)
        w.i64(at)
        addr = await self._leader(topic, partition)
        r = await self._conn(addr).call(API_LIST_OFFSETS, 1, bytes(w.b))
        r.i32()  # topic count
        r.string()
        r.i32()  # partition count
        r.i32()  # partition
        err = r.i16()
        r.i64()  # timestamp
        off = r.i64()
        if err != 0:
            raise KafkaError(err, f"list_offset {topic}[{partition}]")
        return off
