"""MQTT topic model: levels, validation, wildcard matching.

Semantics mirror the reference broker's topic layer
(`rmqtt/src/topic.rs`):

- A topic string is split on ``/`` into *levels*. Level kinds (reference
  ``Level`` enum, topic.rs:97-103): Normal, Metadata (starts with ``$``),
  Blank (empty string), SingleWildcard ``+``, MultiWildcard ``#``.
- Filter validity (topic.rs ``Topic::is_valid``, :231-243): ``#`` must be the
  last level; a level containing ``+``/``#`` must be exactly that wildcard;
  a ``$``-prefixed (metadata) level may only appear as the first level.
- Matching (canonical semantics = the routing trie, trie.rs:327-408):
  * ``+`` matches exactly one level, including a Blank level
    (trie.rs test: ``/ddl/+/+`` matches ``/ddl/22/``).
  * ``#`` matches the remaining levels *including zero* — the "parent match":
    ``sport/#`` matches ``sport`` (trie.rs:330-338).
  * Topic names whose first level starts with ``$`` are not matched by
    filters whose first level is a wildcard (trie.rs:342-347); the
    isolation applies to the first level only.

Note: the reference has a second, slightly stricter direct matcher
(topic.rs ``match_level``: wildcards never match a metadata level at any
position, :341). The two disagree only on topics that fail topic-name
validation (metadata level at position > 0), so we implement the trie
semantics as canonical everywhere.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

PLUS = "+"
HASH = "#"
SEP = "/"

# $share/<group>/<filter> prefix (reference rmqtt/src/types.rs Subscribe parsing)
SHARED_PREFIX = "$share"


def is_metadata(level: str) -> bool:
    """True if the level is a metadata ($-prefixed) level (topic.rs:85-88)."""
    return level.startswith("$")


def split_levels(topic: str) -> list[str]:
    """Split a topic string into its levels. ``/a/b`` → ``['', 'a', 'b']``."""
    return topic.split(SEP)


def as_levels(topic: str | Sequence[str]) -> list[str]:
    """Normalize a topic given as string or level sequence to a level list."""
    return split_levels(topic) if isinstance(topic, str) else list(topic)


def _level_valid(level: str, pos: int) -> bool:
    if level in (PLUS, HASH, ""):
        return True
    if PLUS in level or HASH in level:
        return False
    if level.startswith("$") and pos != 0:
        # Metadata levels only valid as the first level (topic.rs:237-243).
        return False
    return True


def filter_valid(filter_: str | Sequence[str]) -> bool:
    """Validate a subscription topic filter (topic.rs ``Topic::is_valid``)."""
    if isinstance(filter_, str) and not filter_:
        return False  # MQTT-5.0 4.7.3: topic filters must be ≥1 char
    levels = as_levels(filter_)
    if not levels:
        return False
    for i, lev in enumerate(levels):
        if not _level_valid(lev, i):
            return False
        if lev == HASH and i != len(levels) - 1:
            return False
    return True


def topic_valid(topic: str | Sequence[str]) -> bool:
    """Validate a publish topic name: no wildcards, ``$`` only first."""
    if isinstance(topic, str) and not topic:
        return False  # MQTT-5.0 4.7.3: topic names must be ≥1 char
    levels = as_levels(topic)
    if not levels:
        return False
    for i, lev in enumerate(levels):
        if lev in (PLUS, HASH) or PLUS in lev or HASH in lev:
            return False
        if lev.startswith("$") and i != 0:
            return False
    return True


def match_filter(filter_: str | Sequence[str], topic: str | Sequence[str]) -> bool:
    """Does ``filter_`` (may contain wildcards) match topic name ``topic``?

    Canonical routing-trie semantics (trie.rs ``MatchedIter``, :327-408).
    """
    f = as_levels(filter_)
    t = as_levels(topic)
    if not f or not t:
        return False
    # $-topic isolation from wildcard-first filters (trie.rs:342-347).
    if t[0] and is_metadata(t[0]) and f[0] in (PLUS, HASH):
        return False
    tl = len(t)
    for i, lev in enumerate(f):
        if lev == HASH:
            # '#' is last by validation; matches the rest incl. zero levels
            # ("parent match", trie.rs:330-338).
            return tl >= i
        if i >= tl:
            return False
        if lev == PLUS:
            continue
        if lev != t[i]:
            return False
    return tl == len(f)


class InvalidSharedFilter(ValueError):
    """A ``$share/...`` filter with a missing/empty group or filter part."""


def parse_shared(topic_filter: str) -> Tuple[Optional[str], str]:
    """Parse ``$share/<group>/<filter>`` → ``(group, filter)``.

    Returns ``(None, topic_filter)`` when not a shared subscription. Raises
    :class:`InvalidSharedFilter` on a malformed ``$share`` filter (missing
    group or filter), as the reference's Subscribe parsing does
    (rmqtt/src/types.rs:554-566) — with one deliberate divergence: the
    reference's ``splitn`` accepts an *empty* share group (``$share//x``),
    which violates MQTT-5.0 §4.8.2 (ShareName must be ≥1 char); we reject it.
    """
    if topic_filter != SHARED_PREFIX and not topic_filter.startswith(SHARED_PREFIX + SEP):
        return None, topic_filter
    rest = topic_filter[len(SHARED_PREFIX) + 1 :]
    idx = rest.find(SEP)
    if idx <= 0 or not rest[idx + 1 :]:
        raise InvalidSharedFilter(f"malformed shared subscription filter: {topic_filter!r}")
    return rest[:idx], rest[idx + 1 :]


def parse_limit(topic_filter: str) -> Tuple[Optional[int], str]:
    """Parse ``$limit/<n>/<filter>`` and ``$exclusive/<filter>`` prefixes.

    The reference's limit-subscription feature
    (rmqtt/src/types.rs parse_topic_filter: ``$limit`` caps the number of
    subscribers for a filter; ``$exclusive`` is the 1-subscriber case).
    Returns ``(None, topic_filter)`` when no prefix is present.
    """
    if topic_filter.startswith("$exclusive/"):  # see strip_prefixes below
        rest = topic_filter[len("$exclusive/") :]
        if not rest:
            raise InvalidSharedFilter(f"malformed $exclusive filter: {topic_filter!r}")
        return 1, rest
    if topic_filter.startswith("$limit/"):
        rest = topic_filter[len("$limit/") :]
        idx = rest.find(SEP)
        if idx <= 0 or not rest[idx + 1 :]:
            raise InvalidSharedFilter(f"malformed $limit filter: {topic_filter!r}")
        try:
            n = int(rest[:idx])
        except ValueError as e:
            raise InvalidSharedFilter(f"malformed $limit count: {topic_filter!r}") from e
        if n < 1:
            raise InvalidSharedFilter(f"$limit count must be >= 1: {topic_filter!r}")
        return n, rest[idx + 1 :]
    return None, topic_filter


def strip_prefixes(topic_filter: str) -> str:
    """Stripped routing filter: removes ``$limit``/``$exclusive`` and
    ``$share`` prefixes (the filter actually stored in the router). Raises
    :class:`InvalidSharedFilter` on malformed prefixes."""
    _limit, rest = parse_limit(topic_filter)
    _group, stripped = parse_shared(rest)
    return stripped
