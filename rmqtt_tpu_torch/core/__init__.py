"""Core topic model and CPU reference structures (the correctness oracle).

Copies of the JAX package's ``core`` modules (the port imports nothing of
that package). They mirror the semantics of the reference broker's topic
layer (`rmqtt/src/topic.rs`, `rmqtt/src/trie.rs`); ``TopicTree`` is the
oracle the GPU matcher is checked against.
"""

from rmqtt_tpu_torch.core.topic import (
    HASH,
    PLUS,
    filter_valid,
    is_metadata,
    match_filter,
    parse_shared,
    split_levels,
    topic_valid,
)
from rmqtt_tpu_torch.core.trie import RetainTree, TopicTree
