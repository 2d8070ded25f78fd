"""Retained-message store.

Mirrors the reference's `RetainStorage` trait + in-memory default
(`rmqtt/src/retain.rs:100-213`): set (empty payload clears,
MQTT-3.3.1-10/11), wildcard lookup on SUBSCRIBE, per-message expiry, count
and max limits. Backed by the CPU ``RetainTree``; with ``tpu=True``, once
the store grows past ``tpu_threshold`` the wildcard lookup switches to the
partitioned inverse-match kernels (`rmqtt_tpu_torch.ops.retained_part`)
over a mirrored chunk-tiled row table on ``device`` — the same pruned
automaton the router uses. The device is the current CUDA device unless
one is given; with ``tpu=True``, none given and no CUDA device the store
refuses to start. A fault of the kernels propagates from ``matches``: the
lookup never falls back to the tree.
"""

from __future__ import annotations

import hashlib
import time
from typing import Dict, List, Optional, Tuple

from rmqtt_tpu_torch.core.topic import filter_valid, topic_valid
from rmqtt_tpu_torch.core.trie import RetainTree
from rmqtt_tpu_torch.broker.types import Message, now


class RetainStore:
    def __init__(
        self,
        enable: bool = True,
        max_retained: int = 1_000_000,
        max_payload: int = 1024 * 1024,
        tpu: bool = False,
        tpu_threshold: int = 50_000,
        device=None,
    ) -> None:
        self.enable = enable
        self.max_retained = max_retained
        self.max_payload = max_payload
        self._tree: RetainTree[Message] = RetainTree()
        self._tpu = tpu
        self._tpu_threshold = tpu_threshold
        self._device = None
        if tpu:
            from rmqtt_tpu_torch.ops._build import kernel_library
            from rmqtt_tpu_torch.ops.partitioned import resolve_device

            # the device the mirror will live on, decided now: no CUDA
            # device (and none given) refuses the start, and so does a
            # kernel that does not build. With none given the card is
            # counted from a subprocess first, so a wedged one refuses
            # the start instead of hanging it
            if device is None:
                from rmqtt_tpu_torch.utils.cudaprobe import require_cuda

                require_cuda()
            self._device = resolve_device(device)
            if self._device.type == "cuda":
                kernel_library()
        self._table = None  # lazily-built ops.retained_part.RetainedTable mirror
        self._scanner = None
        # device-scan gauges (/api/v1/stats): lookups served by the scanner
        # and the wall time of the mirror's first build (on the event loop)
        self.scans = 0
        self.mirror_build_ms = 0.0
        self._rowid_by_topic: Dict[str, int] = {}
        self._msg_by_rowid: Dict[int, Tuple[str, Message]] = {}
        # cluster hook: called as on_set(topic, msg_or_None) after a local
        # mutation (broadcast-mode retain_set_broadcast analogue)
        self.on_set = None
        # store revision: bumped on every content mutation so digest()
        # recomputes only when the store actually changed (the membership
        # API polls the digest — an O(n log n) pass per poll would stall
        # the event loop at scale)
        self._rev = 0
        self._digest_cache: Optional[Tuple[int, Dict[str, object]]] = None

    def count(self) -> int:
        return self._tree.count()

    def set(self, topic: str, msg: Message) -> bool:
        """Store/replace/clear; returns False if refused (limits/disabled)."""
        ok = self.set_local(topic, msg)
        if ok and self.on_set is not None:
            self.on_set(topic, msg if msg.payload else None)
        return ok

    def set_local(self, topic: str, msg: Message) -> bool:
        """Like `set` but without the cluster broadcast (inbound sync path)."""
        if not self.enable:
            return False
        if not topic_valid(topic):
            # a wildcard/invalid publish topic (reachable via the HTTP API,
            # which skips the wire codec's validation) must be refused, not
            # half-inserted: the TPU mirror rejects wildcard rows and the
            # tree would diverge from it permanently
            return False
        if not msg.payload:  # empty payload clears (MQTT-3.3.1-10)
            self.remove_local(topic)
            return True
        if len(msg.payload) > self.max_payload:
            return False
        if self._tree.get(topic) is None and self._tree.count() >= self.max_retained:
            return False
        self._tree.insert(topic, msg)
        self._rev += 1
        if self._tpu:
            self._set_row(topic, msg)
        return True

    def remove_local(self, topic: str) -> None:
        self._tree.remove(topic)
        self._rev += 1
        self._drop_row(topic)

    def all_items(self) -> List[Tuple[str, Message]]:
        """Every retained (topic, message), including ``$``-topics."""
        return [("/".join(levels), m) for levels, m in self._tree.items()]

    def get(self, topic: str) -> Optional[Message]:
        msg = self._tree.get(topic)
        if msg is not None and msg.is_expired():
            self.remove_local(topic)
            return None
        return msg

    def matches(self, topic_filter: str) -> List[Tuple[str, Message]]:
        """All retained (topic, message) matching a new subscription's filter."""
        if not self.enable or not filter_valid(topic_filter):
            return []
        if self._tpu and self.count() >= self._tpu_threshold:
            out = self._matches_tpu(topic_filter)
        else:
            out = [("/".join(levels), msg) for levels, msg in self._tree.matches(topic_filter)]
        fresh = []
        for topic, msg in out:
            if msg.is_expired():
                self.remove_local(topic)
            else:
                fresh.append((topic, msg))
        return fresh

    def digest(self) -> Dict[str, object]:
        """Content digest over every live retained (topic, create_time,
        payload): byte-equal across nodes iff the stores converged —
        ``create_time`` rides the retain-sync wire, so replicas agree after
        a successful sync. The anti-entropy exchange
        (cluster/membership.py) compares this before moving any payloads.
        Cached against the store revision, so membership-API polls only
        recompute after an actual mutation (expired entries still drop out:
        their removal on first touch bumps the revision)."""
        if (self._digest_cache is not None
                and self._digest_cache[0] == self._rev):
            return dict(self._digest_cache[1])
        h = hashlib.sha1()
        n = 0
        expired = []
        for topic, m in sorted(self.all_items()):
            if m.is_expired():
                expired.append(topic)
                continue
            h.update(topic.encode())
            h.update(b"\x00")
            h.update(repr(m.create_time).encode())
            h.update(hashlib.sha1(m.payload).digest())
            n += 1
        for t in expired:
            # reap now (bumps the revision) so the cached digest stays
            # consistent with what a recompute would produce
            self.remove_local(t)
        out = {"count": n, "digest": h.hexdigest()}
        self._digest_cache = (self._rev, dict(out))
        return out

    def summary(self) -> Dict[str, list]:
        """Per-topic repair summary ``{topic: [create_time, payload_hash]}``
        — what the anti-entropy delta plan compares instead of shipping
        payloads (cluster/membership.py retain_delta)."""
        out: Dict[str, list] = {}
        for topic, m in self.all_items():
            if m.is_expired():
                continue
            out[topic] = [m.create_time,
                          hashlib.sha1(m.payload).hexdigest()[:12]]
        return out

    def expire_sweep(self) -> int:
        """Periodic expiry cleanup (retainer plugin's cleanup loop)."""
        expired = ["/".join(levels) for levels, msg in self._tree.items() if msg.is_expired()]
        for t in expired:
            self.remove_local(t)
        return len(expired)

    # ---- TPU mirror -------------------------------------------------------
    def _ensure_tpu(self):
        if self._scanner is None:
            from rmqtt_tpu_torch.ops.retained_part import (
                PartitionedRetainedScanner,
                RetainedTable,
            )

            t0 = time.perf_counter()
            self._table = RetainedTable()
            self._scanner = PartitionedRetainedScanner(self._table, self._device)
            # backfill current tree contents (incl. $-topics)
            for levels, msg in self._tree.items():
                self._set_row("/".join(levels), msg)
            self.mirror_build_ms = (time.perf_counter() - t0) * 1e3

    def _set_row(self, topic: str, msg: Message) -> None:
        if self._scanner is None:
            return  # rows are built lazily on first TPU lookup
        rid = self._rowid_by_topic.get(topic)
        if rid is None:
            try:
                rid = self._table.add(topic)
            except ValueError:
                # pre-existing invalid tree entry (e.g. loaded from an old
                # persisted store): leave it to the tree path rather than
                # poisoning every future scan
                return
            self._rowid_by_topic[topic] = rid
        self._msg_by_rowid[rid] = (topic, msg)

    def _drop_row(self, topic: str) -> None:
        rid = self._rowid_by_topic.pop(topic, None)
        if rid is not None:
            self._msg_by_rowid.pop(rid, None)
            if self._table is not None:
                self._table.remove(rid)

    def _matches_tpu(self, topic_filter: str) -> List[Tuple[str, Message]]:
        self._ensure_tpu()
        (row,) = self._scanner.scan([topic_filter])
        self.scans += 1
        return [self._msg_by_rowid[rid] for rid in row.tolist() if rid in self._msg_by_rowid]

    def device_stats(self) -> Dict[str, float]:
        """Retained-scan gauges for ``/api/v1/stats``: device lookups, the
        hand kernels' launches in this process and the mirror's build
        time."""
        from rmqtt_tpu_torch.ops.retained_part import (
            retained_scan_full,
            retained_scan_gather,
        )

        return {
            "retained_scans": self.scans,
            "retained_scan_launches_gather": retained_scan_gather.launches,
            "retained_scan_launches_full": retained_scan_full.launches,
            "retained_mirror_build_ms": self.mirror_build_ms,
        }
