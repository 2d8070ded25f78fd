"""Device side of PUBLISH routing and of the retained scan: host table
encoding (``encode``: the partitioned layout's pieces and the dense
``FilterTable``, ``partitioned``), the CUDA match-words kernels and their
plain twins (``match_words``, built by ``_build``), the fused matcher
(``partitioned.PartitionedMatcher``), the retained-scan kernels, twins and
scanner (``retained_part``), and the dense backend: the full-scan kernels,
their twins and ``DenseMatcher`` (``match``) and the dense
``RetainedScanner`` (``retained``). The multi-device matchers live in
``rmqtt_tpu_torch.parallel``."""
