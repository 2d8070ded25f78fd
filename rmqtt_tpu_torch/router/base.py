"""Router interface and routing data types.

Mirrors the reference's `Router` trait and DTOs:
`rmqtt/src/router.rs:65-112` (add/remove/matches/gets/
query_subscriptions/topics/routes), `rmqtt/src/types.rs:476-486`
(``AllRelationsMap``, ``SubRelation``, ``SubRelationsMap``) and the
``SubscriptionOptions`` carried on every subscription (types.rs).

The shared-subscription *choice point* lives in `matches()` exactly as in the
reference (`router.rs:236-255`): matched relations in a ``$share`` group are
collapsed to one subscriber by the pluggable strategy, with liveness supplied
by the session layer.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

NodeId = int
ClientId = str


@dataclass(frozen=True)
class Id:
    """Session identity: owning node + client id (reference types.rs Id)."""

    node_id: NodeId
    client_id: ClientId


@dataclass(frozen=True)
class SubscriptionOptions:
    """Per-subscription options (reference types.rs ``SubscriptionOptions``)."""

    qos: int = 0
    no_local: bool = False
    retain_as_published: bool = False
    retain_handling: int = 0
    subscription_ids: Tuple[int, ...] = ()
    shared_group: Optional[str] = None

    def merge_sub_id(self, sub_id: Optional[int]) -> "SubscriptionOptions":
        if sub_id is None:
            return self
        return replace(self, subscription_ids=(sub_id,))


@dataclass(frozen=True)
class SubRelation:
    """One matched (filter → subscriber) edge (reference types.rs:485)."""

    topic_filter: str
    id: Id
    opts: SubscriptionOptions


# node_id → relations to deliver there (reference types.rs:486 SubRelationsMap)
SubRelationsMap = Dict[NodeId, List[SubRelation]]

# choice(group, candidates[(id, opts, is_online)]) -> index or None
# (reference rmqtt/src/subscribe.rs:71-96 SharedSubscription::choice)
SharedChoiceFn = Callable[[str, str, List[Tuple[Id, SubscriptionOptions, bool]]], Optional[int]]


def round_robin_choice_factory() -> SharedChoiceFn:
    """Default shared-sub strategy: round-robin over online candidates
    (reference rmqtt/src/subscribe.rs:98-107 default impl)."""
    counters: Dict[Tuple[str, str], int] = {}

    def choice(group: str, topic_filter: str, candidates):
        online = [i for i, (_, _, is_on) in enumerate(candidates) if is_on]
        pool = online or list(range(len(candidates)))
        if not pool:
            return None
        key = (group, topic_filter)  # tuple key: no per-publish f-string
        n = counters.get(key, 0)
        counters[key] = n + 1
        return pool[n % len(pool)]

    return choice


class Router(abc.ABC):
    """The swappable routing seam (reference router.rs:65-112)."""

    # True for µs-scale CPU matchers (trie/C++): the RoutingService then
    # dispatches small batches inline instead of paying a thread-pool hop;
    # device-backed routers leave this False (their kernels block)
    prefer_inline: bool = False

    # latency telemetry registry (broker/telemetry.py), injected by
    # ServerContext at broker startup; None for standalone routers. The
    # native/xla routers record their ``kernel.dispatch`` stage through it.
    telemetry = None

    # True ONLY for routers whose add()/remove() bump ``epochs`` on every
    # mutation — the bundled trie/native/xla routers do. RoutingService
    # keys its match cache on THIS flag, not on ``epochs`` existing (the
    # lazy property below makes that non-None for every subclass): a
    # custom router that never bumps would otherwise serve stale entries
    # forever. Subclasses honoring the contract opt in explicitly.
    epochs_tracked: bool = False

    @property
    def epochs(self):
        """Subscription-table epochs (router/cache.py): every ``add()`` /
        successful ``remove()`` must bump them so the match-result cache in
        front of this router can validate entries — and the subclass must
        set ``epochs_tracked = True`` to enable that cache. Lazy so routers
        without a cache pay nothing."""
        ep = getattr(self, "_sub_epochs", None)
        if ep is None:
            from rmqtt_tpu_torch.router.cache import SubscriptionEpochs

            ep = self._sub_epochs = SubscriptionEpochs()
        return ep

    def inline_ok(self, batch_size: int) -> bool:
        """May this batch run on the event loop (µs-scale, non-blocking)?
        Routers with a per-size fast path (a router with a host-trie hybrid)
        override this; the default follows ``prefer_inline``."""
        return self.prefer_inline and batch_size <= 256

    @abc.abstractmethod
    def add(self, topic_filter: str, id: Id, opts: SubscriptionOptions) -> None:
        """Register a subscription (filter already stripped of ``$share``)."""

    @abc.abstractmethod
    def remove(self, topic_filter: str, id: Id) -> bool:
        """Remove a subscription; True if it existed."""

    @abc.abstractmethod
    def matches_raw(self, from_id: Optional[Id], topic: str):
        """→ (non-shared SubRelationsMap, shared-group candidates).

        Shared groups are left un-collapsed so cluster modes can merge
        candidates across nodes before choosing (broadcast-mode global
        choice, `rmqtt-cluster-broadcast/src/shared.rs:516-560`).
        """

    def matches_batch_raw(self, items: Sequence[Tuple[Optional[Id], str]]):
        """Batched `matches_raw` — the device router overrides with one launch."""
        return [self.matches_raw(fid, topic) for fid, topic in items]

    def collapse(self, raw) -> SubRelationsMap:
        """Collapse shared-group candidates with this router's strategy."""
        from rmqtt_tpu_torch.router.relations import collapse_shared

        out, shared = raw
        return collapse_shared(out, shared, self._shared_choice)

    def matches(self, from_id: Optional[Id], topic: str) -> SubRelationsMap:
        """All deliverable relations for one publish topic."""
        return self.collapse(self.matches_raw(from_id, topic))

    def matches_batch(self, items: Sequence[Tuple[Optional[Id], str]]) -> List[SubRelationsMap]:
        """Batched `matches` — single kernel launch on the device router."""
        return [self.collapse(raw) for raw in self.matches_batch_raw(items)]

    # --- admin / introspection surface (router.rs gets/query/topics) ---
    def shared_groups_count(self) -> int:
        """Distinct ($share group, filter) pairs (stats gauge; O(1))."""
        return len(self._relations.shared_index)

    def dump_routes(self):
        """Every route edge as (topic_filter, Id, opts) — snapshot/transfer
        surface (raft compaction serializes the full table through this).
        Default walks the ``_relations`` map all bundled routers keep; a
        router with a different store must override."""
        for tf, rels in self._relations.items():
            for _cid, (sid, opts) in rels.items():
                yield tf, sid, opts

    @abc.abstractmethod
    def gets(self, limit: int) -> List[dict]:
        """List (topic_filter, client) routes up to limit."""

    @abc.abstractmethod
    def topics_count(self) -> int:
        """Number of distinct stored topic filters."""

    @abc.abstractmethod
    def routes_count(self) -> int:
        """Number of stored (filter, client) subscription edges."""

    @abc.abstractmethod
    def is_match(self, topic: str) -> bool:
        """Does any subscription match this topic?"""

    @abc.abstractmethod
    def subscribers_count(self, topic_filter: str, exclude_client: Optional[str] = None) -> int:
        """Current subscriber count for one exact filter ($limit/$exclusive
        enforcement; cluster-wide under raft's replicated table). When
        ``exclude_client`` is given, that client's own relation is not
        counted (re-subscribing must not trip the cap, session.rs:1292-1306)."""
