"""CPU topic tries — the reference-semantics oracle and host-side baseline.

``TopicTree`` mirrors the reference's subscription trie
(`rmqtt/src/trie.rs`): a node per level with a value set and
child branches keyed by level (trie.rs:84-87); ``insert`` is O(depth)
(:113-126); ``remove`` prunes empty nodes (:129-149); ``matches`` is a DFS that
expands ``#`` (including the parent match, :330-338), ``+`` (:358-362) and
isolates ``$``-topics from wildcard-first filters (:342-347).

``RetainTree`` mirrors the reference's retained-message trie
(`rmqtt/src/retain.rs:198-213, 373-450`): one value slot per
*topic name* node; lookup is the inverse match — a wildcard *filter* is walked
against the stored topic names.

These are used as (a) the differential-test oracle for the GPU matcher and
(b) the CPU baseline implementation behind ``DefaultRouter``.
"""

from __future__ import annotations

from typing import Dict, Generic, Hashable, Iterator, List, Optional, Sequence, Tuple, TypeVar

from rmqtt_tpu_torch.core.topic import HASH, PLUS, as_levels, is_metadata

V = TypeVar("V", bound=Hashable)


class _Node(Generic[V]):
    """TopicTree node: multi-value set + branches."""

    __slots__ = ("values", "branches")

    def __init__(self) -> None:
        self.values: set[V] = set()
        self.branches: Dict[str, _Node[V]] = {}

    def is_empty(self) -> bool:
        return not self.values and not self.branches


class _RNode(Generic[V]):
    """RetainTree node: one (possibly unhashable) value slot + branches."""

    __slots__ = ("value", "has_value", "branches")

    def __init__(self) -> None:
        self.value: Optional[V] = None
        self.has_value = False
        self.branches: Dict[str, _RNode[V]] = {}

    def is_empty(self) -> bool:
        return not self.has_value and not self.branches


class TopicTree(Generic[V]):
    """Subscription trie keyed by topic-filter levels.

    Matching a publish topic yields ``(filter_levels, values)`` pairs for every
    stored filter that matches, with full MQTT wildcard semantics.
    """

    def __init__(self) -> None:
        self._root: _Node[V] = _Node()
        self._values_count = 0

    def insert(self, topic_filter: str | Sequence[str], value: V) -> None:
        node = self._root
        for lev in as_levels(topic_filter):
            nxt = node.branches.get(lev)
            if nxt is None:
                nxt = _Node()
                node.branches[lev] = nxt
            node = nxt
        if value not in node.values:
            node.values.add(value)
            self._values_count += 1

    def remove(self, topic_filter: str | Sequence[str], value: V) -> bool:
        """Remove one value; prunes empty nodes (trie.rs:129-149)."""
        levels = as_levels(topic_filter)
        path: List[Tuple[_Node[V], str]] = []
        node = self._root
        for lev in levels:
            nxt = node.branches.get(lev)
            if nxt is None:
                return False
            path.append((node, lev))
            node = nxt
        if value not in node.values:
            return False
        node.values.discard(value)
        self._values_count -= 1
        # prune empty chain bottom-up
        for parent, lev in reversed(path):
            child = parent.branches[lev]
            if child.is_empty():
                del parent.branches[lev]
            else:
                break
        return True

    def values_size(self) -> int:
        return self._values_count

    def is_empty(self) -> bool:
        return self._root.is_empty()

    def matches(self, topic: str | Sequence[str]) -> List[Tuple[Tuple[str, ...], List[V]]]:
        """All stored filters matching publish topic ``topic``.

        DFS mirroring trie.rs ``MatchedIter`` (:288-408): at each node expand
        the ``#`` branch (terminal), recurse into ``+`` and the exact branch;
        when the topic is exhausted collect the node's own values plus a
        child-``#`` parent match; skip wildcard branches at the root for
        ``$``-topics.
        """
        path = as_levels(topic)
        out: List[Tuple[Tuple[str, ...], List[V]]] = []
        self._match(self._root, path, 0, [], out)
        return out

    def is_match(self, topic: str | Sequence[str]) -> bool:
        return bool(self.matches(topic))

    def _match(
        self,
        node: _Node[V],
        path: List[str],
        i: int,
        prefix: List[str],
        out: List[Tuple[Tuple[str, ...], List[V]]],
    ) -> None:
        if i == len(path):
            # topic exhausted: parent '#' match (trie.rs:330-338) ...
            hnode = node.branches.get(HASH)
            if hnode is not None and hnode.values:
                out.append((tuple(prefix + [HASH]), list(hnode.values)))
            # ... and exact match on this node
            if node.values:
                out.append((tuple(prefix), list(node.values)))
            return
        lev = path[i]
        # $-topic isolation: at the first level, a metadata topic level is not
        # matched by wildcard branches (trie.rs:342-347).
        wildcards_ok = not (i == 0 and lev != "" and is_metadata(lev))
        if wildcards_ok:
            hnode = node.branches.get(HASH)
            if hnode is not None and hnode.values:
                out.append((tuple(prefix + [HASH]), list(hnode.values)))
            pnode = node.branches.get(PLUS)
            if pnode is not None:
                prefix.append(PLUS)
                self._match(pnode, path, i + 1, prefix, out)
                prefix.pop()
        enode = node.branches.get(lev)
        if enode is not None:
            prefix.append(lev)
            self._match(enode, path, i + 1, prefix, out)
            prefix.pop()

    # --- introspection (reference trie.rs `list`, used by admin API) ---
    def list(self, limit: int = 1000) -> List[str]:
        out: List[str] = []
        self._list(self._root, [], out, limit)
        return out

    def _list(self, node: _Node[V], prefix: List[str], out: List[str], limit: int) -> None:
        if len(out) >= limit:
            return
        if node.values:
            out.append("/".join(prefix) + f"  ({len(node.values)})")
        for lev, child in sorted(node.branches.items()):
            self._list(child, prefix + [lev], out, limit)

    def filters(self) -> Iterator[Tuple[Tuple[str, ...], set]]:
        """Iterate (filter_levels, values) for all stored filters."""
        yield from self._iter(self._root, [])

    def _iter(self, node: _Node[V], prefix: List[str]) -> Iterator[Tuple[Tuple[str, ...], set]]:
        if node.values:
            yield tuple(prefix), node.values
        for lev, child in node.branches.items():
            yield from self._iter(child, prefix + [lev])


class RetainTree(Generic[V]):
    """Retained-message trie: one value per *topic name* node.

    The inverse lookup of ``TopicTree``: ``matches(filter)`` walks a wildcard
    filter against the stored topic names (retain.rs:373-450). ``#`` collects
    the whole subtree including the current node (parent semantics mirror the
    forward direction); ``$``-topics are isolated from wildcard-first filters.
    """

    def __init__(self) -> None:
        self._root: _RNode[V] = _RNode()
        self._count = 0

    def insert(self, topic: str | Sequence[str], value: V) -> Optional[V]:
        """Store/overwrite; returns the previous value if any."""
        node = self._root
        for lev in as_levels(topic):
            nxt = node.branches.get(lev)
            if nxt is None:
                nxt = _RNode()
                node.branches[lev] = nxt
            node = nxt
        prev = node.value if node.has_value else None
        if not node.has_value:
            self._count += 1
        node.value = value
        node.has_value = True
        return prev

    def remove(self, topic: str | Sequence[str]) -> Optional[V]:
        levels = as_levels(topic)
        path: List[Tuple[_RNode[V], str]] = []
        node = self._root
        for lev in levels:
            nxt = node.branches.get(lev)
            if nxt is None:
                return None
            path.append((node, lev))
            node = nxt
        if not node.has_value:
            return None
        prev = node.value
        node.value = None
        node.has_value = False
        self._count -= 1
        for parent, lev in reversed(path):
            child = parent.branches[lev]
            if child.is_empty():
                del parent.branches[lev]
            else:
                break
        return prev

    def get(self, topic: str | Sequence[str]) -> Optional[V]:
        node = self._root
        for lev in as_levels(topic):
            node = node.branches.get(lev)  # type: ignore[assignment]
            if node is None:
                return None
        return node.value if node.has_value else None

    def count(self) -> int:
        return self._count

    def matches(self, topic_filter: str | Sequence[str]) -> List[Tuple[Tuple[str, ...], V]]:
        """All stored (topic_levels, value) whose topic matches ``topic_filter``."""
        filt = as_levels(topic_filter)
        out: List[Tuple[Tuple[str, ...], V]] = []
        self._rmatch(self._root, filt, 0, [], out)
        return out

    def items(self) -> List[Tuple[Tuple[str, ...], V]]:
        """All stored (topic_levels, value) pairs, including ``$``-topics."""
        out: List[Tuple[Tuple[str, ...], V]] = []
        self._collect_all(self._root, [], out, skip_meta_first=False)
        return out

    def _collect_all(self, node: _RNode[V], prefix: List[str], out, skip_meta_first: bool) -> None:
        if node.has_value:
            out.append((tuple(prefix), node.value))
        for lev, child in node.branches.items():
            if skip_meta_first and not prefix and lev != "" and is_metadata(lev):
                continue
            prefix.append(lev)
            self._collect_all(child, prefix, out, skip_meta_first)
            prefix.pop()

    def _rmatch(
        self,
        node: _RNode[V],
        filt: List[str],
        i: int,
        prefix: List[str],
        out: List[Tuple[Tuple[str, ...], V]],
    ) -> None:
        if i == len(filt):
            if node.has_value:
                out.append((tuple(prefix), node.value))
            return
        lev = filt[i]
        if lev == HASH:
            # '#' matches this node (parent match) and the whole subtree;
            # at the first level it must not descend into $-topics.
            self._collect_all(node, prefix, out, skip_meta_first=(i == 0))
            return
        if lev == PLUS:
            for blev, child in node.branches.items():
                if i == 0 and blev != "" and is_metadata(blev):
                    continue
                prefix.append(blev)
                self._rmatch(child, filt, i + 1, prefix, out)
                prefix.pop()
            return
        child = node.branches.get(lev)
        if child is not None:
            prefix.append(lev)
            self._rmatch(child, filt, i + 1, prefix, out)
            prefix.pop()
