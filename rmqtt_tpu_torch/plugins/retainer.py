"""Persistent retainer plugin.

Mirrors `rmqtt-plugins/rmqtt-retainer`: retained messages survive restarts.
On start, retained messages load from SQLite into the in-memory store; every
local mutation is written through (chained with the cluster's ``on_set`` so
both persistence and broadcast fire).
"""

from __future__ import annotations

from typing import Optional

from rmqtt_tpu_torch.broker.types import Message
from rmqtt_tpu_torch.cluster.messages import msg_from_wire, msg_to_wire
from rmqtt_tpu_torch.plugins import Plugin
from rmqtt_tpu_torch.storage import make_store

NS = "retain"


class RetainerPlugin(Plugin):
    name = "rmqtt-retainer"
    descr = "persistent retained-message store (sqlite or redis)"

    def __init__(self, ctx, config=None) -> None:
        super().__init__(ctx, config)
        # storage = "redis://host:port/db" selects the RESP backend
        # (retainer lib.rs:26-94 StorageType parity); default sqlite
        self.store = make_store(self.config)
        self._prev_on_set = None
        # network backend: write-behind on ONE worker thread — on_set fires
        # synchronously inside the publish path, and a blocking socket RTT
        # there would stall the event loop; a single thread keeps per-topic
        # write ordering
        self._wb = None
        if getattr(self.store, "network", False):
            from concurrent.futures import ThreadPoolExecutor

            self._wb = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="retainer-wb")

    def _persist(self, topic: str, msg: Optional[Message]) -> None:
        if msg is None:
            self.store.delete(NS, topic)
        else:
            self.store.put(NS, topic, msg_to_wire(msg), ttl=msg.expiry_interval)

    async def start(self) -> None:
        retain = self.ctx.retain
        # expired rows are reaped by the context-wide store sweep
        self.ctx.add_store(self.store)
        # load persisted retains
        for topic, mw in self.store.scan(NS):
            msg = msg_from_wire(mw)
            if not msg.is_expired():
                retain.set_local(topic, msg)
        self._prev_on_set = retain.on_set

        def on_set(topic: str, msg: Optional[Message]) -> None:
            if self._wb is not None:
                self._wb.submit(self._persist, topic, msg)
            else:
                self._persist(topic, msg)
            if self._prev_on_set is not None:  # chain (cluster broadcast)
                self._prev_on_set(topic, msg)

        retain.on_set = on_set

    async def stop(self) -> bool:
        self.ctx.retain.on_set = self._prev_on_set
        if self._wb is not None:
            self._wb.shutdown(wait=True)  # drain pending write-behinds
        self.ctx.remove_store(self.store)
        self.store.close()
        return True

    def attrs(self):
        return {"persisted": self.store.count(NS)}
