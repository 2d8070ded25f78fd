"""The GPU router: subscription matching on an NVIDIA card.

Swaps the reference's trie DFS (`rmqtt/src/router.rs:174-265`) for the
batched matcher over the flattened filter table in device memory (see
``rmqtt_tpu_torch.ops.partitioned``). Publish ingress is micro-batched:
``matches_batch_raw()`` encodes B topics and resolves all of them in one
fused device pass; matched *filter ids* come back from one fetch and are
expanded host-side to clients via the relations map — the kernel/host
split the reference keeps between trie and ``AllRelationsMap``
(router.rs:121-139).

The port of the JAX package's ``XlaRouter``: the host trie mirror, the
small-batch hybrid (``ops/hybrid.py``), the ``kernel.dispatch`` telemetry
and the failover plane's seams (``broker/failover.py``) around one of three
matchers: the partitioned matcher on one device (the default), the dense
full-scan ``DenseMatcher`` (``backend="dense"``, ``ops/match.py``) or the
partitioned matcher over a mesh of devices (``mesh``,
``parallel/sharded.py``).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rmqtt_tpu_torch.ops._build import kernel_library
from rmqtt_tpu_torch.ops.compact_tail import compact_global, fused_compact_decode
from rmqtt_tpu_torch.ops.encode import FilterTable
from rmqtt_tpu_torch.ops.hybrid import AdaptiveHybrid
from rmqtt_tpu_torch.ops.match import DenseMatcher
from rmqtt_tpu_torch.ops.match_words import match_words_legacy, match_words_packed
from rmqtt_tpu_torch.ops.partitioned import PartitionedMatcher, PartitionedTable
from rmqtt_tpu_torch.parallel.sharded import ShardedPartitionedMatcher, make_mesh
from rmqtt_tpu_torch.router.base import (
    ClientId,
    Id,
    Router,
    SharedChoiceFn,
    SubscriptionOptions,
    round_robin_choice_factory,
)
from rmqtt_tpu_torch.router.relations import RelationsMap, expand_matches_raw
from rmqtt_tpu_torch.utils.failpoints import FAILPOINTS

#: above this many filters the Python-tree mirror is dropped (the native
#: trie is kept at any size)
PY_MIRROR_MAX = 200_000


class _TreeSide:
    """Python-trie fallback for the hybrid mirror (NativeTrie API subset)."""

    def __init__(self, tree) -> None:
        self._tree = tree

    def add(self, topic_filter: str, fid: int) -> None:
        self._tree.insert(topic_filter, fid)

    def remove(self, topic_filter: str, fid: int) -> None:
        self._tree.remove(topic_filter, fid)

    def match(self, topic: str):
        vals = [v for _lv, vs in self._tree.matches(topic) for v in vs]
        return np.asarray(vals, dtype=np.int64)


class TorchRouter(Router):
    epochs_tracked = True  # add/remove bump the match-cache epochs

    def __init__(
        self,
        shared_choice: Optional[SharedChoiceFn] = None,
        is_online: Callable[[ClientId], bool] = lambda cid: True,
        table=None,
        device=None,
        backend: str = "partitioned",
        mesh="auto",
    ) -> None:
        """``device``: where the table and the matching live — the current
        CUDA device when None (raises without one), ``"cpu"`` for the plain
        PyTorch twins of the kernels (tests). With no device the card is
        first counted from a subprocess (``utils/cudaprobe.py``), so a
        wedged card raises instead of hanging. On CUDA the kernels are
        built here, so a kernel that does not build refuses the start.

        ``backend``: ``"partitioned"`` (a ``PartitionedTable``) or
        ``"dense"`` (a ``FilterTable`` scanned whole by ``DenseMatcher``).
        ``mesh``: a ``parallel.Mesh`` to run the partitioned matcher over
        (batch sharded, table replicated; its devices are where the
        matching lives, so no CUDA probe runs); ``"auto"`` uses every CUDA
        device when the probe counts more than one and no device was given
        (one card keeps the local matcher); ``None`` forces one device."""
        explicit_mesh = mesh not in (None, "auto")
        if explicit_mesh and (backend != "partitioned" or device is not None):
            raise ValueError(
                "mesh is only supported with backend='partitioned' and no "
                "explicit device (use parallel.ShardedMatcher for dense)")
        ncuda = 0
        if device is None and not explicit_mesh:
            from rmqtt_tpu_torch.utils.cudaprobe import require_cuda

            ncuda = require_cuda()
        if backend == "partitioned":
            self.table = table or PartitionedTable()
            use_mesh = None if mesh == "auto" else mesh
            if mesh == "auto" and device is None and ncuda > 1:
                use_mesh = make_mesh([torch.device("cuda", i) for i in range(ncuda)],
                                     dp=ncuda)
            if use_mesh is not None:
                self.matcher = ShardedPartitionedMatcher(self.table, use_mesh)
            else:
                self.matcher = PartitionedMatcher(self.table, device=device)
        elif backend == "dense":
            self.table = table or FilterTable()
            self.matcher = DenseMatcher(self.table, device=device)
        else:
            raise ValueError(f"unknown backend {backend!r}")
        self._devices = list(getattr(self.matcher, "devices", None)
                             or [self.matcher.device])
        if any(d.type == "cuda" for d in self._devices):
            kernel_library()
        self._relations = RelationsMap()
        self._fid_to_filter: Dict[int, str] = {}
        self._filter_to_fid: Dict[str, int] = {}
        self._shared_choice = shared_choice or round_robin_choice_factory()
        self._is_online = is_online
        # small-batch hybrid: the host trie mirror answers batches of at
        # most RMQTT_HYBRID_MAX topics inline (a lone publish would pay a
        # whole device round trip); bursts go to the device
        self._hybrid_max = int(os.environ.get("RMQTT_HYBRID_MAX", "64"))
        # the mirror is built even with the hybrid off (RMQTT_HYBRID_MAX=0):
        # it is the failover plane's host table, which must stay current
        # exactly when every batch depends on the device. Only add()'s drop
        # of a large Python-tree mirror removes it.
        self._side = None
        self._side_native = False
        from rmqtt_tpu_torch.runtime import NativeTrie, available

        if available():
            self._side = NativeTrie()
            self._side_native = True
        else:
            from rmqtt_tpu_torch.core.trie import TopicTree

            self._side = _TreeSide(TopicTree())
        # large batches route adaptively between the mirror and the device
        # (ops/hybrid.py), which needs the µs-scale native trie;
        # RMQTT_HYBRID_ADAPT=0 or the hybrid off pins them to the device
        probe = int(os.environ.get("RMQTT_PROBE_EVERY", "64"))
        if (self._hybrid_max <= 0 or not self._side_native
                or os.environ.get("RMQTT_HYBRID_ADAPT", "1") != "1"):
            probe = 0
        self._hybrid = AdaptiveHybrid(
            self._side, self.matcher, small_max=self._hybrid_max,
            probe_every=probe,
        )
        # the hybrid fires these on its device branch; the canary fires
        # them itself, since it bypasses the hybrid on purpose
        self._fp_dispatch = FAILPOINTS.register("device.dispatch")
        self._fp_complete = FAILPOINTS.register("device.complete")

    def add(self, topic_filter: str, id: Id, opts: SubscriptionOptions) -> None:
        if self._relations.add(topic_filter, id, opts):
            fid = self.table.add(topic_filter)
            self._fid_to_filter[fid] = topic_filter
            self._filter_to_fid[topic_filter] = fid
            if self._side is not None:
                if not self._side_native and len(self._fid_to_filter) > PY_MIRROR_MAX:
                    # a Python-tree mirror of a million-filter table costs
                    # GBs of dict nodes for a fast path that no longer is
                    # one: drop it, the device serves every batch size
                    self._side = None
                    self._hybrid.side = None
                else:
                    self._side.add(topic_filter, fid)
        # version the match cache on real relations mutations; identical
        # re-subscribes don't bump
        if self._relations.last_add_changed:
            self.epochs.bump(topic_filter)

    def remove(self, topic_filter: str, id: Id) -> bool:
        existed, empty = self._relations.remove(topic_filter, id)
        if empty:
            fid = self._filter_to_fid.pop(topic_filter)
            del self._fid_to_filter[fid]
            self.table.remove(fid)
            if self._side is not None:
                self._side.remove(topic_filter, fid)
        if existed:
            self.epochs.bump(topic_filter)
        return existed

    def inline_ok(self, batch_size: int) -> bool:
        # batches the native trie serves are µs-scale: run them on the
        # event loop. The Python-tree mirror also serves small batches
        # (matches_batch_raw) but its ms-scale walk keeps the executor hop.
        return (self._side is not None and self._side_native
                and batch_size <= self._hybrid_max)

    def matches_raw(self, from_id: Optional[Id], topic: str):
        return self.matches_batch_raw([(from_id, topic)])[0]

    def matches_batch_raw(self, items: Sequence[Tuple[Optional[Id], str]]):
        topics = [topic for _, topic in items]
        tele = self.telemetry
        t0 = time.perf_counter_ns() if tele is not None and tele.enabled else 0
        rows = self._hybrid.match(topics)
        if t0:
            # recorder, not record(): executor threads record this stage
            # concurrently with the loop
            tele.recorder("kernel.dispatch")(
                time.perf_counter_ns() - t0,
                {"backend": "torch", "batch": len(items)})
        return self._expand(items, rows)

    def _expand(self, items, fid_rows):
        out = []
        f2f = self._fid_to_filter
        for (from_id, _topic), fids in zip(items, fid_rows):
            matched = [f2f[fid] for fid in fids.tolist()]
            out.append(
                expand_matches_raw(matched, self._relations, from_id, self._is_online)
            )
        return out

    # pipelined halves: submit encodes + queues the device work, complete
    # fetches + expands — batch N+1's submit runs while batch N is still on
    # the device. submit returns (True, results) when the hybrid served the
    # batch from the host trie, else (False, handle) for complete_batch_raw.
    def submit_batch_raw(self, items: Sequence[Tuple[Optional[Id], str]]):
        items = list(items)
        topics = [topic for _, topic in items]
        tele = self.telemetry
        t0 = time.perf_counter_ns() if tele is not None and tele.enabled else 0
        h = self._hybrid.match_submit(topics)
        if h[0] == "sync":
            out = True, self._expand(items, h[1])
            if t0:
                tele.recorder("kernel.dispatch")(
                    time.perf_counter_ns() - t0,
                    {"backend": "torch-sync", "batch": len(items)})
            return out
        # the device's kernel.dispatch stage closes at complete time
        return False, (items, h, t0)

    def complete_batch_raw(self, handle):
        items, h, t0 = handle
        rows = self._hybrid.match_complete(h)
        if t0:
            tele = self.telemetry
            if tele is not None:
                tele.recorder("kernel.dispatch")(
                    time.perf_counter_ns() - t0,
                    {"backend": "torch", "batch": len(items)})
        return self._expand(items, rows)

    def prewarm(self, batch_sizes=(1, 8)) -> None:
        """Latch the matcher's sticky pad floor and, on CUDA, match each
        small size once against the live table (results discarded), so the
        first lone publish after start does not pay a first launch — the
        counterpart of the JAX package's compile-ahead (the kernels were
        built at construction). ``RoutingService.start()`` calls it on a
        background thread."""
        m = self.matcher
        if hasattr(m, "prewarm"):
            m.prewarm(batch_sizes)
        if any(d.type == "cuda" for d in self._devices):
            for s in sorted({int(s) for s in batch_sizes if s > 0}):
                m.match(["\x00prewarm/nomatch"] * s)

    def set_hybrid_max(self, n: int) -> int:
        """Knob seam (broker/knobs.py): move the trie-vs-device batch
        threshold live — the inline_ok gate and the hybrid's own small_max
        together. → the old value."""
        old = self._hybrid_max
        self._hybrid_max = max(0, int(n))
        self._hybrid.set_small_max(self._hybrid_max)
        return old

    def last_match_was_device(self) -> bool:
        """Did the most recent synchronously resolved match run on the
        device? The routing service credits only device successes to the
        failover breaker; trie-served batches say nothing of its health."""
        return self._hybrid.last_backend == "device"

    # ---- host fallback plane (device-plane failover, broker/failover.py).
    # The mirror is updated on every add/remove, so the fallback routes
    # against the current table; without a mirror (the dropped Python tree)
    # host_available() is False and failover cannot engage.
    def host_available(self) -> bool:
        return self._side is not None

    def host_inline_ok(self) -> bool:
        # the native trie is µs-scale: failover batches run on the event
        # loop; the Python tree keeps the executor hop
        return self._side_native

    def host_matches_batch_raw(self, items: Sequence[Tuple[Optional[Id], str]]):
        """Match a batch on the host trie mirror only — no device dispatch,
        no device failpoints: the failover plane's routing while the
        breaker around the device is open."""
        side = self._side
        if side is None:
            raise RuntimeError("no host-side trie mirror to fail over to")
        topics = [topic for _, topic in items]
        if len(topics) > 1 and hasattr(side, "match_batch"):
            rows = side.match_batch(list(topics))
        else:
            rows = [side.match(t) for t in topics]
        return self._expand(items, rows)

    def device_rewarm(self) -> None:
        """Force the next device refresh down the full pack + upload path
        (the half-open probe's prelude): the table's layout-epoch bump
        closes the delta gate, so no delta from before the outage is
        scattered into a device table that may be torn."""
        self.table.force_full_refresh()

    def canary_topics(self, k: int = 3) -> List[str]:
        """Concrete topics from up to ``k`` live filters (wildcard levels
        replaced by a literal), so the failover canary compares non-empty
        rows whenever the table has routes. ``$``-filters are skipped; an
        empty result tells the caller to use its static topic."""
        out: List[str] = []
        for filt in self._filter_to_fid:
            if len(out) >= k:
                break
            if filt.startswith("$"):
                continue
            out.append("/".join(
                "canary" if lvl in ("+", "#") else lvl
                for lvl in filt.split("/")))
        return out

    def device_canary(self, topics: Sequence[str]) -> bool:
        """One match through the device matcher (bypassing the hybrid),
        checked against the host trie. The device failpoints stay armed
        here so a fault still injected keeps the breaker open; the first
        canary after ``device_rewarm`` performs the full re-upload."""
        if self._fp_dispatch.action is not None:
            self._fp_dispatch.fire_sync()
        rows = self.matcher.match(list(topics))
        if self._fp_complete.action is not None:
            self._fp_complete.fire_sync()
        if self._side is None:
            return True
        for topic, fids in zip(topics, rows):
            want = np.sort(np.asarray(self._side.match(topic), dtype=np.int64))
            got = np.sort(np.asarray(fids, dtype=np.int64))
            if want.shape != got.shape or not np.array_equal(want, got):
                return False
        return True

    def device_stats(self) -> Dict[str, float]:
        """Device-table lifecycle counters for RoutingService.stats():
        upload/compaction activity of the device mirror, per-stage wall
        totals (zeros while the matcher's ``stage_timing`` is off) and the
        words kernels' launch counts."""
        m, t = self.matcher, self.table
        # the dense and sharded matchers keep no stage split and their
        # tables no compactions: zeros, as the JAX router reports them
        sn = getattr(m, "stage_ns", None) or {}
        return {
            "uploads": m.uploads,
            "delta_uploads": m.delta_uploads,
            "upload_bytes": m.upload_bytes,
            "compactions": getattr(t, "compactions", 0),
            "compact_ms": round(getattr(t, "compact_ms", 0.0), 3),
            "cand_cache_invalidations": getattr(t, "cand_cache_invalidations", 0),
            "fused_batches": getattr(m, "fused_batches", 0),
            "stage_encode_ms_total": round(sn.get("encode", 0) / 1e6, 3),
            "stage_dispatch_ms_total": round(sn.get("dispatch", 0) / 1e6, 3),
            "stage_fetch_ms_total": round(sn.get("fetch", 0) / 1e6, 3),
            "stage_decode_ms_total": round(sn.get("decode", 0) / 1e6, 3),
            # process-wide launch counters of the words kernels and of the
            # compaction tails
            "kernel_launches_packed": match_words_packed.launches,
            "kernel_launches_legacy": match_words_legacy.launches,
            "kernel_launches_fused_tail": fused_compact_decode.launches,
            "kernel_launches_compact_global": compact_global.launches,
        }

    def device_hbm(self) -> Dict[str, float]:
        """Device-memory model of the table mirror (tiles, fid map): the
        device profiler's provider seam (broker/devprof.py); {} for a
        matcher without a breakdown."""
        f = getattr(self.matcher, "hbm_breakdown", None)
        return f() if callable(f) else {}

    def is_match(self, topic: str) -> bool:
        if self._side is not None:
            return self._side.match(topic).size > 0
        (fids,) = self.matcher.match([topic])
        return fids.size > 0

    def gets(self, limit: int) -> List[dict]:
        out: List[dict] = []
        for tf, rels in self._relations.items():
            for cid in rels:
                if len(out) >= limit:
                    return out
                out.append({"topic_filter": tf, "client_id": cid})
        return out

    def subscribers_count(self, topic_filter: str, exclude_client=None) -> int:
        rels = self._relations.get(topic_filter)
        n = len(rels)
        if exclude_client is not None and exclude_client in rels:
            n -= 1
        return n

    def topics_count(self) -> int:
        return len(self._relations)

    def routes_count(self) -> int:
        return self._relations.edge_count
