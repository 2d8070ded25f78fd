"""CPU trie-backed router — the faithful baseline implementation.

Mirrors `DefaultRouter` (`rmqtt/src/router.rs:121-265`):
a topic trie over filter shapes plus a relations map, per-publish trie DFS
in `matches()`. This is the CPU oracle the TPU path is benchmarked against
(BASELINE.md: the reference publishes no routing microbenchmark, so this
implementation *is* the baseline).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

from rmqtt_tpu_torch.core.trie import TopicTree
from rmqtt_tpu_torch.router.base import (
    ClientId,
    Id,
    Router,
    SharedChoiceFn,
    SubRelationsMap,
    SubscriptionOptions,
    round_robin_choice_factory,
)
from rmqtt_tpu_torch.router.relations import RelationsMap, expand_matches_raw


class DefaultRouter(Router):
    prefer_inline = True  # trie match is µs-scale: no executor hop needed
    epochs_tracked = True  # add/remove bump the match-cache epochs

    def __init__(
        self,
        shared_choice: Optional[SharedChoiceFn] = None,
        is_online: Callable[[ClientId], bool] = lambda cid: True,
    ) -> None:
        self._trie: TopicTree[str] = TopicTree()
        self._relations = RelationsMap()
        self._shared_choice = shared_choice or round_robin_choice_factory()
        self._is_online = is_online

    def add(self, topic_filter: str, id: Id, opts: SubscriptionOptions) -> None:
        if self._relations.add(topic_filter, id, opts):
            self._trie.insert(topic_filter, topic_filter)
        # any REAL relations mutation versions the match cache (the cache
        # holds expansions, so opts changes count too) — but an identical
        # re-subscribe (reconnect storms) must not trash hot entries
        if self._relations.last_add_changed:
            self.epochs.bump(topic_filter)

    def remove(self, topic_filter: str, id: Id) -> bool:
        existed, empty = self._relations.remove(topic_filter, id)
        if empty:
            self._trie.remove(topic_filter, topic_filter)
        if existed:
            self.epochs.bump(topic_filter)
        return existed

    def matches_raw(self, from_id: Optional[Id], topic: str):
        matched = [tf for _levels, vals in self._trie.matches(topic) for tf in vals]
        return expand_matches_raw(matched, self._relations, from_id, self._is_online)

    def is_match(self, topic: str) -> bool:
        return self._trie.is_match(topic)

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
