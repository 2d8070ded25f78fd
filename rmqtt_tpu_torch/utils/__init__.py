"""Utilities: counters with cluster merge modes, sliding-window rates.

Mirrors `rmqtt-utils` (`rmqtt-utils/src/counter.rs:39-343`,
`src/rate_counter.rs`): ``Counter`` tracks (current, max) and merges across
cluster nodes under a ``StatsMergeMode``; ``RateCounter`` measures events/sec
over a sliding window.
"""

from rmqtt_tpu_torch.utils.counter import Counter, RateCounter, StatsMergeMode
