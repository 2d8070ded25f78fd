"""Native (C++) trie-backed router.

Same shape as ``DefaultRouter`` with the hot match loop in C++
(`runtime/topics.cc`): the host-side production router when no TPU is
attached, and the honest CPU baseline for the routing benchmark (the
reference's DefaultRouter is native Rust; a Python-trie baseline would
flatter the TPU numbers).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from rmqtt_tpu_torch.router.base import (
    ClientId,
    Id,
    Router,
    SharedChoiceFn,
    SubscriptionOptions,
    round_robin_choice_factory,
)
from rmqtt_tpu_torch.router.relations import RelationsMap, expand_matches_raw
from rmqtt_tpu_torch.runtime import NativeTrie


class NativeRouter(Router):
    prefer_inline = True  # C++ trie match is µs-scale: no executor hop
    epochs_tracked = True  # add/remove bump the match-cache epochs

    def __init__(
        self,
        shared_choice: Optional[SharedChoiceFn] = None,
        is_online: Callable[[ClientId], bool] = lambda cid: True,
    ) -> None:
        self._trie = NativeTrie()
        self._relations = RelationsMap()
        self._filter_by_vid: Dict[int, str] = {}
        self._vid_by_filter: Dict[str, int] = {}
        self._next_vid = 0
        self._shared_choice = shared_choice or round_robin_choice_factory()
        self._is_online = is_online

    def add(self, topic_filter: str, id: Id, opts: SubscriptionOptions) -> None:
        if self._relations.add(topic_filter, id, opts):
            vid = self._next_vid
            self._next_vid += 1
            self._filter_by_vid[vid] = topic_filter
            self._vid_by_filter[topic_filter] = vid
            self._trie.add(topic_filter, vid)
        # a real relations change versions the match cache even when the
        # filter already existed (opts changes count: the cache holds
        # expansions) — identical re-subscribes don't bump
        if self._relations.last_add_changed:
            self.epochs.bump(topic_filter)

    def remove(self, topic_filter: str, id: Id) -> bool:
        existed, empty = self._relations.remove(topic_filter, id)
        if empty:
            vid = self._vid_by_filter.pop(topic_filter)
            del self._filter_by_vid[vid]
            self._trie.remove(topic_filter, vid)
        if existed:
            self.epochs.bump(topic_filter)
        return existed

    def matches_raw(self, from_id: Optional[Id], topic: str):
        matched = [self._filter_by_vid[v] for v in self._trie.match(topic).tolist()]
        return expand_matches_raw(matched, self._relations, from_id, self._is_online)

    def matches_batch_raw(self, items: Sequence[Tuple[Optional[Id], str]]):
        tele = self.telemetry
        t0 = time.perf_counter_ns() if tele is not None and tele.enabled else 0
        rows = self._trie.match_batch([topic for _, topic in items])
        if t0:
            # recorder, not record(): this can run on an executor thread
            # concurrently with loop-side records — the recorder's append
            # + locked fold keeps totals exact across threads (memoized,
            # so the lookup is one dict hit per batch)
            tele.recorder("kernel.dispatch")(
                time.perf_counter_ns() - t0,
                {"backend": "native", "batch": len(items)})
        out = []
        for (from_id, _topic), vids in zip(items, rows):
            matched = [self._filter_by_vid[v] for v in vids.tolist()]
            out.append(expand_matches_raw(matched, self._relations, from_id, self._is_online))
        return out

    def is_match(self, topic: str) -> bool:
        return self._trie.match(topic).size > 0

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
