"""The GPU router: subscription matching on an NVIDIA card.

Swaps the reference's trie DFS (`rmqtt/src/router.rs:174-265`) for the
batched matcher over the flattened filter table in device memory (see
``rmqtt_tpu_torch.ops.partitioned``). Publish ingress is micro-batched:
``matches_batch_raw()`` encodes B topics and resolves all of them in one
fused device pass; matched *filter ids* come back from one fetch and are
expanded host-side to clients via the relations map — the kernel/host
split the reference keeps between trie and ``AllRelationsMap``
(router.rs:121-139).

The port of the JAX package's ``XlaRouter`` with every batch on the device
(its ``RMQTT_HYBRID_MAX=0``, ``RMQTT_HYBRID_ADAPT=0``, ``mesh=None``
behaviour): the host-trie hybrid, the failover seams and multi-device
meshes are not ported.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from rmqtt_tpu_torch.ops.partitioned import PartitionedMatcher, PartitionedTable
from rmqtt_tpu_torch.router.base import (
    ClientId,
    Id,
    Router,
    SharedChoiceFn,
    SubscriptionOptions,
    round_robin_choice_factory,
)
from rmqtt_tpu_torch.router.relations import RelationsMap, expand_matches_raw


class TorchRouter(Router):
    epochs_tracked = True  # add/remove bump the match-cache epochs

    def __init__(
        self,
        shared_choice: Optional[SharedChoiceFn] = None,
        is_online: Callable[[ClientId], bool] = lambda cid: True,
        table: Optional[PartitionedTable] = None,
        device=None,
    ) -> None:
        """``device``: where the table and the matching live — the current
        CUDA device when None (raises without one), ``"cpu"`` for the plain
        PyTorch twins of the kernels (tests)."""
        self.table = table or PartitionedTable()
        self.matcher = PartitionedMatcher(self.table, device=device)
        self._relations = RelationsMap()
        self._fid_to_filter: Dict[int, str] = {}
        self._filter_to_fid: Dict[str, int] = {}
        self._shared_choice = shared_choice or round_robin_choice_factory()
        self._is_online = is_online

    def add(self, topic_filter: str, id: Id, opts: SubscriptionOptions) -> None:
        if self._relations.add(topic_filter, id, opts):
            fid = self.table.add(topic_filter)
            self._fid_to_filter[fid] = topic_filter
            self._filter_to_fid[topic_filter] = fid
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
        if existed:
            self.epochs.bump(topic_filter)
        return existed

    def matches_raw(self, from_id: Optional[Id], topic: str):
        return self.matches_batch_raw([(from_id, topic)])[0]

    def matches_batch_raw(self, items: Sequence[Tuple[Optional[Id], str]]):
        topics = [topic for _, topic in items]
        return self._expand(items, self.matcher.match(topics))

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
    # the device. Every batch goes to the device, so submit always returns
    # (False, handle) for complete_batch_raw.
    def submit_batch_raw(self, items: Sequence[Tuple[Optional[Id], str]]):
        items = list(items)
        h = self.matcher.match_submit([topic for _, topic in items])
        return False, (items, h)

    def complete_batch_raw(self, handle):
        items, h = handle
        return self._expand(items, self.matcher.match_complete(h))

    def device_stats(self) -> Dict[str, float]:
        """Device-table lifecycle counters: upload/compaction activity of
        the device mirror and per-stage wall totals (zeros while the
        matcher's ``stage_timing`` is off)."""
        m, t = self.matcher, self.table
        sn = m.stage_ns
        return {
            "uploads": m.uploads,
            "delta_uploads": m.delta_uploads,
            "upload_bytes": m.upload_bytes,
            "compactions": t.compactions,
            "compact_ms": round(t.compact_ms, 3),
            "cand_cache_invalidations": t.cand_cache_invalidations,
            "fused_batches": m.fused_batches,
            "stage_encode_ms_total": round(sn["encode"] / 1e6, 3),
            "stage_dispatch_ms_total": round(sn["dispatch"] / 1e6, 3),
            "stage_fetch_ms_total": round(sn["fetch"] / 1e6, 3),
            "stage_decode_ms_total": round(sn["decode"] / 1e6, 3),
        }

    def is_match(self, topic: str) -> bool:
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
