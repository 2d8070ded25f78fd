"""rmqtt_tpu_torch — the PyTorch/CUDA port of rmqtt_tpu's PUBLISH routing.

The subscription table lives in GPU memory as tiles of a flattened topic
automaton; a batch of publish topics is matched against it by hand-written
CUDA kernels (``ops/match_words.py``, sources in ``csrc/``) followed by a
fused on-device compaction and row→fid decode (``ops/partitioned.py``).
``router.TorchRouter`` is the router over it. The package imports torch
and numpy, never jax and nothing of ``rmqtt_tpu``.
"""
