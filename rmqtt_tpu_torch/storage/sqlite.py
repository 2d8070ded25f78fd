"""SQLite-backed KV/table store for broker persistence.

The sled-equivalent embedded backend (reference `rmqtt-storage`): small
synchronous operations on the event loop are acceptable at broker-control
rates; bulk scans run in the default executor. WAL mode keeps writers from
blocking readers across broker restarts/chaos tests.

Transient-fault hardening: SQLITE_BUSY/SQLITE_LOCKED (another process on
the same WAL file — multi-worker brokers share raft/session DBs) retries
with the breaker's bounded exponential-backoff schedule
(`broker/overload.backoff_delays`) before surfacing; the ``storage.write``
/ ``storage.read`` failpoints (utils/failpoints.py) fire inside that loop
so chaos tests can prove both the retry and the exhaustion path.
"""

from __future__ import annotations

import asyncio
import sqlite3
import threading
import time
from pathlib import Path
from typing import Any, Iterable, List, Optional, Tuple

from rmqtt_tpu_torch.cluster import wire
from rmqtt_tpu_torch.utils.failpoints import FAILPOINTS, FailpointError

_FP_WRITE = FAILPOINTS.register("storage.write")
_FP_READ = FAILPOINTS.register("storage.read")

#: bounded retry for busy/locked: 5 sleeps of 10/20/40/80/100ms (+jitter),
#: ~0.3s worst case — long enough to ride out a peer's WAL checkpoint,
#: short enough that a genuinely wedged DB errors out while callers still
#: hold context (no infinite retry; exhaustion surfaces the original error)
_RETRY_ATTEMPTS = 6
_RETRY_BASE_S = 0.01
_RETRY_CAP_S = 0.1
#: per-sleep cap when the calling thread runs an asyncio event loop —
#: blocking the loop 0.3s per busy op would stall every connection
_RETRY_CAP_LOOP_S = 0.01

#: sqlite-side lock wait (PRAGMA busy_timeout, ms): the common WAL-
#: checkpoint / cross-process write contention resolves INSIDE sqlite in
#: well under this, so `_with_retry` never spins its backoff schedule for
#: it; kept small because the wait blocks the calling thread (which may be
#: the event loop) before SQLITE_BUSY even surfaces. Genuinely long
#: contention still falls through to the bounded retry loop.
_BUSY_TIMEOUT_MS = 20

#: observability for the retry loop: total backoff sleeps taken process-
#: wide. tests/test_failpoints.py asserts real two-connection contention
#: resolves via busy_timeout with this counter flat.
RETRY_STATS = {"sleeps": 0}


def _transient(e: BaseException) -> bool:
    if isinstance(e, FailpointError):
        return True  # injected faults model busy/locked: exercise the retry
    if not isinstance(e, sqlite3.OperationalError):
        return False
    s = str(e).lower()
    return "locked" in s or "busy" in s


def _with_retry(fp, op):
    """Run one store op; transient errors sleep through the bounded
    backoff schedule, anything else (or exhaustion) raises.

    Small synchronous ops legitimately run ON the event loop (the store's
    documented contract), so when this thread has a running loop the
    schedule is truncated to ``_RETRY_CAP_LOOP_S`` per sleep (~tens of ms
    total) — enough to ride out a WAL-checkpoint SQLITE_BUSY, but a busy
    peer can never freeze every connection for the full ~0.3s worst case.
    Executor-thread callers (expire sweeps, network-parity paths) keep the
    full schedule."""
    from rmqtt_tpu_torch.broker.overload import backoff_delays

    try:
        asyncio.get_running_loop()
        cap = _RETRY_CAP_LOOP_S
    except RuntimeError:
        cap = _RETRY_CAP_S
    delays = backoff_delays(_RETRY_ATTEMPTS, _RETRY_BASE_S, cap)
    while True:
        try:
            if fp.action is not None:
                fp.fire_sync()
            return op()
        except (sqlite3.OperationalError, FailpointError) as e:
            if not _transient(e):
                raise
            d = next(delays, None)
            if d is None:
                raise
            RETRY_STATS["sleeps"] += 1
            time.sleep(min(d, cap))


class SqliteStore:
    #: embedded backend: small synchronous ops are event-loop safe
    network = False

    def __init__(self, path: str | Path = ":memory:",
                 synchronous: str = "normal") -> None:
        self.path = str(path)
        if self.path != ":memory:":
            Path(self.path).parent.mkdir(parents=True, exist_ok=True)
        sync = synchronous.upper()
        if sync not in ("OFF", "NORMAL", "FULL"):
            raise ValueError(
                f"synchronous must be off|normal|full, got {synchronous!r}")
        # callers occasionally hop store work to executor threads (expire
        # sweeps, network-parity paths): one connection, externally
        # serialized by _lock (sqlite3 objects must not be used
        # concurrently), created thread-agnostic
        self._lock = threading.Lock()
        self._db = sqlite3.connect(self.path, check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        # NORMAL (default): fsync at checkpoint only — fine for caches and
        # replayable stores. FULL: fsync per commit — the durability
        # journal's group commits need it to mean anything across kill -9.
        self._db.execute(f"PRAGMA synchronous={sync}")
        # resolve short cross-connection write contention inside sqlite
        # instead of surfacing SQLITE_BUSY into _with_retry backoff rounds
        self._db.execute(f"PRAGMA busy_timeout={_BUSY_TIMEOUT_MS}")
        self._db.executescript(
            """
            CREATE TABLE IF NOT EXISTS kv (
                ns TEXT NOT NULL, k TEXT NOT NULL, v BLOB NOT NULL,
                expire_at REAL, PRIMARY KEY (ns, k)
            );
            CREATE INDEX IF NOT EXISTS kv_expire ON kv (expire_at)
                WHERE expire_at IS NOT NULL;
            """
        )
        self._db.commit()

    def close(self) -> None:
        with self._lock:
            self._db.close()

    # ------------------------------------------------------------------ kv
    def put(self, ns: str, key: str, value: Any, ttl: Optional[float] = None) -> None:
        expire = time.time() + ttl if ttl else None
        blob = wire.dumps(value)

        def op():
            with self._lock:
                self._db.execute(
                    "INSERT OR REPLACE INTO kv (ns, k, v, expire_at) VALUES (?,?,?,?)",
                    (ns, key, blob, expire),
                )
                self._db.commit()

        _with_retry(_FP_WRITE, op)

    def put_many(self, ns: str, items) -> None:
        """Bulk upsert in ONE transaction (large raft appends must not pay a
        commit per row)."""
        self.put_many_expire(ns, [(k, v, None) for k, v in items])

    def put_many_expire(self, ns: str, items) -> None:
        """Bulk upsert with per-item absolute expiry: (key, value,
        expire_at_or_None) triples, one transaction."""
        rows = [(ns, k, wire.dumps(v), exp) for k, v, exp in items]

        def op():
            with self._lock:
                self._db.executemany(
                    "INSERT OR REPLACE INTO kv (ns, k, v, expire_at) VALUES (?,?,?,?)",
                    rows,
                )
                self._db.commit()

        _with_retry(_FP_WRITE, op)

    def get(self, ns: str, key: str) -> Optional[Any]:
        def op():
            with self._lock:
                return self._db.execute(
                    "SELECT v, expire_at FROM kv WHERE ns=? AND k=?", (ns, key)
                ).fetchone()

        row = _with_retry(_FP_READ, op)
        if row is None:
            return None
        value, expire = row
        if expire is not None and expire <= time.time():
            self.delete(ns, key)
            return None
        return wire.loads(value)

    def get_many(self, ns: str, keys) -> List[Optional[Any]]:
        """Batch get (surface parity with the network backend's MGET)."""
        return [self.get(ns, k) for k in keys]

    def delete(self, ns: str, key: str) -> bool:
        def op():
            with self._lock:
                cur = self._db.execute("DELETE FROM kv WHERE ns=? AND k=?", (ns, key))
                self._db.commit()
                return cur.rowcount > 0

        return _with_retry(_FP_WRITE, op)

    def delete_many(self, ns: str, keys) -> int:
        """Bulk delete in ONE transaction (snapshot-row reaping must not
        pay a commit per key)."""
        rows = [(ns, k) for k in keys]
        if not rows:
            return 0

        def op():
            with self._lock:
                cur = self._db.executemany(
                    "DELETE FROM kv WHERE ns=? AND k=?", rows)
                self._db.commit()
                return cur.rowcount

        return _with_retry(_FP_WRITE, op)

    def delete_int_upto(self, ns: str, n: int) -> int:
        """Delete every key whose integer value is <= n (raft log compaction:
        keys are 1-based absolute log indices)."""
        def op():
            with self._lock:
                cur = self._db.execute(
                    "DELETE FROM kv WHERE ns = ? AND CAST(k AS INTEGER) <= ?", (ns, n)
                )
                self._db.commit()
                return cur.rowcount

        return _with_retry(_FP_WRITE, op)

    def scan(self, ns: str) -> List[Tuple[str, Any]]:
        nw = time.time()

        def op():
            with self._lock:
                return self._db.execute(
                    "SELECT k, v, expire_at FROM kv WHERE ns=?", (ns,)
                ).fetchall()

        rows = _with_retry(_FP_READ, op)
        out = []
        for k, v, expire in rows:
            if expire is not None and expire <= nw:
                continue
            out.append((k, wire.loads(v)))
        return out

    def count(self, ns: str) -> int:
        def op():
            with self._lock:
                (n,) = self._db.execute(
                    "SELECT COUNT(*) FROM kv WHERE ns=?", (ns,)).fetchone()
            return int(n)

        return _with_retry(_FP_READ, op)

    def expire_sweep(self) -> int:
        def op():
            with self._lock:
                cur = self._db.execute(
                    "DELETE FROM kv WHERE expire_at IS NOT NULL AND expire_at <= ?",
                    (time.time(),)
                )
                self._db.commit()
                return cur.rowcount

        return _with_retry(_FP_WRITE, op)
