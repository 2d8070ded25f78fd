"""rmqtt_tpu_torch — the PyTorch/CUDA port of rmqtt_tpu.

The subscription table lives in GPU memory as tiles of a flattened topic
automaton; a batch of publish topics is matched against it by hand-written
CUDA kernels (``ops/match_words.py``, sources in ``csrc/``) followed by a
fused on-device compaction and row→fid decode (``ops/partitioned.py``).
``router.TorchRouter`` is the router over it, with a host trie mirror for
small batches and device failover (``ops/hybrid.py``). ``broker/`` is the
MQTT broker around it: ``python -m rmqtt_tpu_torch.broker --router xla``
routes every PUBLISH through ``TorchRouter``. ``runtime/`` binds the
repo's C++ host runtime (``runtime/*.cc``). The package imports torch and
numpy, never jax and nothing of ``rmqtt_tpu``.
"""

__version__ = "0.1.0"
