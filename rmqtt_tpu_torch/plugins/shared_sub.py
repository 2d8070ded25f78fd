"""Shared-subscription strategies plugin.

Mirrors `rmqtt-plugins/rmqtt-shared-subscription`
(`src/strategies.rs:56-341`): the seven group-selection strategies —
random, round_robin, round_robin_per_group, sticky, local, hash_clientid,
hash_topic — replacing the default round-robin
(`rmqtt/src/subscribe.rs:98-107`). Installed by swapping the router's
shared-choice function (the same seam the reference plugin uses).
"""

from __future__ import annotations

import hashlib
import random
from typing import Dict, List, Optional, Tuple

from rmqtt_tpu_torch.plugins import Plugin
from rmqtt_tpu_torch.router.base import Id, SharedChoiceFn, SubscriptionOptions


def _online_pool(candidates) -> List[int]:
    online = [i for i, (_, _, on) in enumerate(candidates) if on]
    return online or list(range(len(candidates)))


def make_strategy(name: str, node_id: int = 0, seed: Optional[int] = None) -> SharedChoiceFn:
    rng = random.Random(seed)
    rr_counter = {"n": 0}
    rr_group: Dict[str, int] = {}
    sticky: Dict[Tuple[str, str], str] = {}

    def choice(group: str, topic_filter: str, candidates):
        if not candidates:
            return None
        pool = _online_pool(candidates)
        if name == "random":
            return rng.choice(pool)
        if name == "round_robin":
            rr_counter["n"] += 1
            return pool[rr_counter["n"] % len(pool)]
        if name == "round_robin_per_group":
            key = f"{group}\x00{topic_filter}"
            n = rr_group.get(key, 0)
            rr_group[key] = n + 1
            return pool[n % len(pool)]
        if name == "sticky":
            key = (group, topic_filter)
            stuck = sticky.get(key)
            if stuck is not None:
                for i in pool:
                    if candidates[i][0].client_id == stuck:
                        return i
            i = rng.choice(pool)
            sticky[key] = candidates[i][0].client_id
            return i
        if name == "local":
            local = [i for i in pool if candidates[i][0].node_id == node_id]
            return rng.choice(local or pool)
        if name == "hash_clientid":
            # stable across nodes: hash the candidate set + first candidate
            h = int(hashlib.blake2s(
                ",".join(sorted(c[0].client_id for c in candidates)).encode()
            ).hexdigest(), 16)
            return pool[h % len(pool)]
        if name == "hash_topic":
            h = int(hashlib.blake2s(topic_filter.encode()).hexdigest(), 16)
            return pool[h % len(pool)]
        raise ValueError(f"unknown shared-subscription strategy {name!r}")

    return choice


class SharedSubscriptionPlugin(Plugin):
    name = "rmqtt-shared-subscription"
    descr = "pluggable shared-subscription group selection strategy"

    def __init__(self, ctx, config=None) -> None:
        super().__init__(ctx, config)
        self.strategy = self.config.get("strategy", "round_robin_per_group")
        self._prev: Optional[SharedChoiceFn] = None

    async def start(self) -> None:
        router = self.ctx.router
        self._prev = router._shared_choice
        router._shared_choice = make_strategy(self.strategy, node_id=self.ctx.node_id)

    async def stop(self) -> bool:
        if self._prev is not None:
            self.ctx.router._shared_choice = self._prev
            self._prev = None
        return True

    def attrs(self):
        return {"strategy": self.strategy}
