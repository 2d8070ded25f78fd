"""Device side of PUBLISH routing: host table encoding (``encode``,
``partitioned``), the CUDA match-words kernels and their plain twins
(``match_words``, built by ``_build``), and the fused matcher
(``partitioned.PartitionedMatcher``)."""
