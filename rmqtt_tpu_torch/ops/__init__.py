"""Device side of PUBLISH routing and of the retained scan: host table
encoding (``encode``, ``partitioned``), the CUDA match-words kernels and
their plain twins (``match_words``, built by ``_build``), the fused matcher
(``partitioned.PartitionedMatcher``) and the retained-scan kernels, twins
and scanner (``retained_part``)."""
