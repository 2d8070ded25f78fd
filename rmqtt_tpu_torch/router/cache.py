"""Epoch-versioned publish→relations match-result cache.

Zipf-skewed IoT publish traffic re-routes the same hot topics continuously
(MQTT+ motivates broker-side reuse of per-topic routing work, arxiv
1810.00773; the broker benchmarking study 2603.21600 shows hot-topic skew
dominating real traces), yet every publish pays full matcher cost — trie DFS,
or a device round trip on the XLA path. This module caches the EXPANDED raw
match result per topic and validates entries with subscription-table epochs
so a cache can never serve stale relations:

- ``SubscriptionEpochs``: ``Router.add()/remove()`` bump a per-first-level-
  segment epoch for exact filters and one global wildcard epoch for filters
  containing ``+``/``#``. A subscribe to ``sensor/1/temp`` therefore
  invalidates only cached ``sensor/...`` topics, while wildcard churn
  invalidates broadly. Correct by construction: an entry is served only when
  BOTH epochs it was built under are still current.
- ``MatchCache``: LRU of ``topic → CacheEntry``. Entries are built from a
  ``from_id=None`` ``matches_raw`` result with shared-group candidates kept
  RAW (pre-choice) and liveness flags stripped; ``derive()`` re-applies v5
  No-Local for the actual publisher, re-evaluates ``is_online`` and returns
  fresh containers — so the shared-subscription round-robin choice point
  (``Router.collapse``) still runs per publish and rotates on cache hits.

Epoch snapshots are taken BEFORE the matcher runs (``snapshot()``): if a
subscribe lands while a match is in flight, the entry is stored under the
pre-match epochs and the next ``get()`` drops it — a racing entry can be
wastefully invalidated, never wrongly served.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple


def _first_level(topic: str) -> str:
    return topic.split("/", 1)[0]


def _is_wild(topic_filter: str) -> bool:
    return any(lv in ("+", "#") for lv in topic_filter.split("/"))


class SubscriptionEpochs:
    """Subscription-table version counters bumped by ``Router.add/remove``."""

    # distinct first-level segments tracked before folding into the global
    # wildcard epoch (first levels are attacker-chosen — any client can
    # subscribe/unsubscribe unique prefixes — so the map must be bounded)
    SEG_CAP = 65_536

    __slots__ = ("wild", "_seg")

    def __init__(self) -> None:
        self.wild = 0
        self._seg: Dict[str, int] = {}

    def bump(self, topic_filter: str) -> None:
        """One subscription-table mutation for ``topic_filter`` ($share
        already stripped). Exact filters can only change match results of
        topics sharing their first level; wildcard filters may match
        anything, so they version the whole cache."""
        if _is_wild(topic_filter):
            self.wild += 1
        else:
            seg = _first_level(topic_filter)
            if seg not in self._seg and len(self._seg) >= self.SEG_CAP:
                # overflow: treat like wildcard churn — the wild bump
                # invalidates every live entry, and clearing resets segment
                # epochs to 0, so surviving stale entries (seg_epoch > 0)
                # can still never validate. Conservative, never wrong.
                self.wild += 1
                self._seg.clear()
            self._seg[seg] = self._seg.get(seg, 0) + 1

    def segment(self, topic: str) -> int:
        return self._seg.get(_first_level(topic), 0)


class CacheEntry:
    __slots__ = ("out", "shared", "_nl", "wild_epoch", "seg_epoch", "stored")

    @property
    def has_no_local(self) -> bool:
        """Lazily computed: most publishes carry a ``from_id`` whose
        No-Local check short-circuits on this flag, but on the miss path
        (from_id=None fan-out, uniform streams) the double relation scan
        would be pure overhead — so it only runs when first consulted."""
        nl = self._nl
        if nl is None:
            nl = self._nl = any(
                r.opts.no_local for rels in self.out.values() for r in rels
            ) or any(
                opts.no_local for cands in self.shared.values()
                for _sid, opts, _on in cands
            )
        return nl


class MatchCache:
    """LRU ``topic → CacheEntry`` validated by :class:`SubscriptionEpochs`.

    Admission is doorkeeper-gated (TinyLFU-lite) by default: the FIRST miss
    for an unseen topic only registers it; storing waits for a repeat. A
    one-shot topic stream (uniform, miss-heavy) then never churns the LRU —
    churn is what costs on that path: every stored entry's containers get
    promoted to CPython's older GC generations and repeatedly re-scanned —
    while genuinely hot topics are cached from their second publish on."""

    def __init__(
        self,
        epochs: SubscriptionEpochs,
        capacity: int = 8192,
        shared_bypass: bool = False,
        admission: bool = True,
        is_online: Callable[[str], bool] = lambda cid: True,
    ) -> None:
        self._epochs = epochs
        self.capacity = max(1, capacity)
        self.shared_bypass = shared_bypass
        self.admission = admission
        self._is_online = is_online
        self._lru: "OrderedDict[str, CacheEntry]" = OrderedDict()
        self._door: set = set()  # topics missed once since the last reset
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self.evictions = 0
        self.door_rejects = 0

    def __len__(self) -> int:
        return len(self._lru)

    def clear(self) -> None:
        self._lru.clear()
        self._door.clear()

    def snapshot(self, topic: str) -> Tuple[int, int]:
        """Epoch pair to build an entry under — take it BEFORE matching."""
        return self._epochs.wild, self._epochs.segment(topic)

    def get(self, topic: str) -> Optional[CacheEntry]:
        e = self._lru.get(topic)
        if e is None:
            self.misses += 1
            return None
        if (e.wild_epoch != self._epochs.wild
                or e.seg_epoch != self._epochs.segment(topic)):
            del self._lru[topic]
            if self.admission:
                # the topic proved hot once — let ONE miss re-admit it
                # instead of making it pass the doorkeeper from scratch
                self._door.add(topic)
            self.invalidations += 1
            self.misses += 1
            return None
        self._lru.move_to_end(topic)
        self.hits += 1
        return e

    def put(self, topic: str, raw, snapshot: Tuple[int, int]) -> CacheEntry:
        """Build (and usually store) an entry from a ``from_id=None``
        ``matches_raw`` result. Always returns the entry so the missing
        publish can be served through the same ``derive`` path even when
        storage is rejected (doorkeeper, shared_bypass) or the entry is
        born stale."""
        out, shared = raw
        store = True
        if self.shared_bypass and shared:
            store = False
        elif self.admission and topic not in self._lru:
            if topic in self._door:
                self._door.discard(topic)  # promoted: second miss
            else:
                self._door.add(topic)
                if len(self._door) > (self.capacity << 1):
                    self._door.clear()
                self.door_rejects += 1
                store = False
        e = CacheEntry()
        e._nl = None
        e.stored = store
        if not store:
            # transient entry: ALIAS the raw containers — it only serves the
            # missing publish and dies with the call, so no copy (and no
            # epoch validation, hence no snapshot fields) is needed
            # (consumers must not hand the raw to collapse AND derive from
            # this entry; RoutingService honors that via ``stored``)
            e.out, e.shared = out, shared
            return e
        e.wild_epoch, e.seg_epoch = snapshot
        # tuples: stored relations are shared across publishes; derive()
        # hands out fresh lists so collapse() can't mutate the entry
        e.out = {nid: tuple(rels) for nid, rels in out.items()}
        e.shared = {key: tuple(cands) for key, cands in shared.items()}
        self._lru[topic] = e
        self._lru.move_to_end(topic)
        while len(self._lru) > self.capacity:
            self._lru.popitem(last=False)
            self.evictions += 1
        return e

    def derive(self, entry: CacheEntry, from_id) -> tuple:
        """Per-publish raw result from a cached entry: No-Local filtered for
        THIS publisher, shared candidates re-flagged with CURRENT liveness,
        fresh containers throughout (``collapse`` appends into ``out``)."""
        cid = from_id.client_id if from_id is not None else None
        nl = entry.has_no_local and cid is not None
        out = {}
        for nid, rels in entry.out.items():
            if nl:
                lst = [r for r in rels
                       if not (r.opts.no_local and r.id.client_id == cid)]
            else:
                lst = list(rels)
            if lst:
                out[nid] = lst
        shared = {}
        online = self._is_online
        for key, cands in entry.shared.items():
            # the liveness flag a candidate was built under is stale by
            # definition — re-evaluate per publish
            lst = [(sid, opts, online(sid.client_id)) for sid, opts, _on in cands
                   if not (nl and opts.no_local and sid.client_id == cid)]
            if lst:
                shared[key] = lst
        return out, shared


def cached_matches_raw(router, cache: MatchCache, from_id, topic: str):
    """Synchronous get-or-build helper (bench / oracle tests / sync callers):
    the exact protocol ``RoutingService`` runs — snapshot before match, build
    from a ``from_id=None`` result, derive per publisher."""
    entry = cache.get(topic)
    if entry is None:
        snap = cache.snapshot(topic)
        raw = router.matches_raw(None, topic)
        entry = cache.put(topic, raw, snap)
        if from_id is None or not entry.has_no_local:
            # the fresh raw is already exact for this publish (No-Local has
            # nothing to filter; liveness flags were just evaluated) and its
            # containers are unaliased — skip the derive copy on the miss
            # path, where the full match was the cost anyway
            return raw
    return cache.derive(entry, from_id)
