"""Relation bookkeeping shared by the routers.

The reference keeps the trie (filter shapes) separate from the relations map
(filter → {client: (Id, opts)}), `rmqtt/src/router.rs:121-139`
(``AllRelationsMap``, types.rs:476). Both router backends here reuse that
split: the matcher (trie or device table) yields matched *filters*; this module
expands filters to clients, applies v5 No-Local (router.rs:196-201), and
collapses ``$share`` groups through the strategy (router.rs:236-255).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from rmqtt_tpu_torch.router.base import (
    ClientId,
    Id,
    SharedChoiceFn,
    SubRelation,
    SubRelationsMap,
    SubscriptionOptions,
)


class RelationsMap:
    """filter → {client_id: (Id, opts)} with counters."""

    def __init__(self) -> None:
        self._map: Dict[str, Dict[ClientId, Tuple[Id, SubscriptionOptions]]] = {}
        self.edge_count = 0
        # (group, filter) → member count, maintained incrementally so the
        # stats gauge never walks the full table (stats.rs keeps counters)
        self.shared_index: Dict[Tuple[str, str], int] = {}

    def _shared_dec(self, topic_filter: str, opts: SubscriptionOptions) -> None:
        if opts.shared_group:
            key = (opts.shared_group, topic_filter)
            n = self.shared_index.get(key, 0) - 1
            if n <= 0:
                self.shared_index.pop(key, None)
            else:
                self.shared_index[key] = n

    # one-call-back state for Router.add: did the last add() actually
    # mutate the relation (new edge, or same client with different
    # Id/opts)? An identical re-subscribe — reconnect storms re-subscribing
    # defensively — must NOT version the match cache, or hot-segment
    # entries are invalidated on every reconnect with no routing change.
    last_add_changed: bool = True

    def add(self, topic_filter: str, id: Id, opts: SubscriptionOptions) -> bool:
        """Returns True if the filter is new (needs matcher insertion)."""
        rels = self._map.get(topic_filter)
        is_new = rels is None
        if is_new:
            rels = self._map[topic_filter] = {}
        prev = rels.get(id.client_id)
        if prev is None:
            self.edge_count += 1
        else:
            self._shared_dec(topic_filter, prev[1])  # re-subscribe may change group
        if opts.shared_group:
            key = (opts.shared_group, topic_filter)
            self.shared_index[key] = self.shared_index.get(key, 0) + 1
        self.last_add_changed = prev is None or prev != (id, opts)
        rels[id.client_id] = (id, opts)
        return is_new

    def remove(self, topic_filter: str, id: Id) -> Tuple[bool, bool]:
        """Returns (existed, filter_now_empty)."""
        rels = self._map.get(topic_filter)
        if not rels or id.client_id not in rels:
            return False, False
        self._shared_dec(topic_filter, rels[id.client_id][1])
        del rels[id.client_id]
        self.edge_count -= 1
        if not rels:
            del self._map[topic_filter]
            return True, True
        return True, False

    def get(self, topic_filter: str) -> Dict[ClientId, Tuple[Id, SubscriptionOptions]]:
        return self._map.get(topic_filter, {})

    def __len__(self) -> int:
        return len(self._map)

    def items(self):
        return self._map.items()


# (group, filter) → candidates [(Id, opts, online)]
SharedCandidates = Dict[Tuple[str, str], List[Tuple[Id, SubscriptionOptions, bool]]]


def expand_matches_raw(
    matched_filters: List[str],
    relations: RelationsMap,
    from_id: Optional[Id],
    is_online: Callable[[ClientId], bool],
) -> Tuple[SubRelationsMap, SharedCandidates]:
    """Filters → (non-shared relations, shared-group candidates).

    Shared groups are NOT collapsed here — the cluster layer merges
    candidates across nodes before choosing (the reference's broadcast-mode
    global choice, `rmqtt-cluster-broadcast/src/shared.rs:516-560`);
    single-node callers collapse immediately via `collapse_shared`.
    """
    out: SubRelationsMap = {}
    shared: SharedCandidates = {}
    for tf in matched_filters:
        for cid, (sid, opts) in relations.get(tf).items():
            if opts.no_local and from_id is not None and cid == from_id.client_id:
                continue  # v5 No-Local (router.rs:196-201)
            if opts.shared_group is not None:
                shared.setdefault((opts.shared_group, tf), []).append(
                    (sid, opts, is_online(cid))
                )
            else:
                out.setdefault(sid.node_id, []).append(SubRelation(tf, sid, opts))
    return out, shared


def collapse_shared(
    out: SubRelationsMap,
    shared: SharedCandidates,
    shared_choice: SharedChoiceFn,
) -> SubRelationsMap:
    """Pick one subscriber per shared group and merge into the relation map
    (router.rs:236-255)."""
    for (group, tf), candidates in shared.items():
        idx = shared_choice(group, tf, candidates)
        if idx is None:
            continue
        sid, opts, _ = candidates[idx]
        out.setdefault(sid.node_id, []).append(SubRelation(tf, sid, opts))
    return out


def expand_matches(
    matched_filters: List[str],
    relations: RelationsMap,
    from_id: Optional[Id],
    shared_choice: SharedChoiceFn,
    is_online: Callable[[ClientId], bool],
) -> SubRelationsMap:
    """Filters → SubRelationsMap with No-Local + local shared-group collapse."""
    out, shared = expand_matches_raw(matched_filters, relations, from_id, is_online)
    return collapse_shared(out, shared, shared_choice)
