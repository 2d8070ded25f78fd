"""Subscription routing: the ``Router`` seam and the GPU router.

``TorchRouter`` keeps the subscription table in GPU memory and matches
publish batches through ``rmqtt_tpu_torch.ops``; relations (filter →
clients) stay host-side, as in the reference's split between the trie and
``AllRelationsMap`` (`rmqtt/src/router.rs:121-139`).
"""

from rmqtt_tpu_torch.router.base import Id, Router, SubRelation, SubscriptionOptions
from rmqtt_tpu_torch.router.torch_router import TorchRouter
