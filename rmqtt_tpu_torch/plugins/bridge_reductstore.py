"""ReductStore egress bridge.

Mirrors `rmqtt-plugins/rmqtt-bridge-egress-reductstore` over ReductStore's
HTTP API (no client stack in this image; the API is plain HTTP):

- bucket ensured at start: ``POST /api/v1/b/{bucket}`` with FIFO quota
  settings (409 = already exists, honored like the reference's exist_ok —
  bridge.rs:63-71);
- each matching local publish becomes ``POST /api/v1/b/{bucket}/{entry}``
  with the record timestamp in micros and metadata as
  ``x-reduct-label-*`` headers: always ``topic``, plus the publisher
  identity (forward_all_from) and publish flags (forward_all_publish) —
  bridge.rs:98-140.

Config::

    [plugins.rmqtt-bridge-egress-reductstore]
    url = "http://127.0.0.1:8383"
    api_token = ""              # optional Bearer token
    forwards = [
      { filter = "iot/#", bucket = "mqtt", entry = "events",
        quota_size = 1000000000, forward_all_from = true,
        forward_all_publish = true },
    ]
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import List, Optional

from rmqtt_tpu_torch.broker.hooks import HookType
from rmqtt_tpu_torch.core.topic import match_filter
from rmqtt_tpu_torch.plugins import Plugin
from rmqtt_tpu_torch.utils import httpc

log = logging.getLogger("rmqtt_tpu_torch.bridge.reductstore")


async def _http(url: str, method: str, path: str, body: bytes = b"",
                headers: Optional[dict] = None, timeout: float = 10.0) -> int:
    status, _ = await httpc.request(
        url, method, path=path, body=body, headers=headers, timeout=timeout
    )
    return status


class BridgeEgressReductstorePlugin(Plugin):
    name = "rmqtt-bridge-egress-reductstore"
    descr = "local MQTT topics → ReductStore records"

    def __init__(self, ctx, config=None) -> None:
        super().__init__(ctx, config)
        self.url = self.config.get("url", "http://127.0.0.1:8383").rstrip("/")
        self.api_token = self.config.get("api_token", "")
        self.forwards: List[dict] = self.config.get("forwards", [])
        self.max_queue = int(self.config.get("max_queue", 10_000))
        self._q: Optional[asyncio.Queue] = None
        self._pump: Optional[asyncio.Task] = None
        self._unhooks = []

    def _auth(self) -> dict:
        return {"Authorization": f"Bearer {self.api_token}"} if self.api_token else {}

    async def start(self) -> None:
        for entry in self.forwards:
            settings = {"quota_type": "FIFO"}
            if entry.get("quota_size"):
                settings["quota_size"] = int(entry["quota_size"])
            try:
                status = await _http(
                    self.url, "POST", f"/api/v1/b/{entry['bucket']}",
                    json.dumps(settings).encode(),
                    {"Content-Type": "application/json", **self._auth()},
                )
                if status not in (200, 409):  # 409 = exists (exist_ok)
                    log.warning("reductstore bucket %s: status %s", entry["bucket"], status)
            except (OSError, asyncio.TimeoutError, ValueError) as e:
                log.warning("reductstore bucket %s: %s", entry["bucket"], e)
        self._q = asyncio.Queue(maxsize=self.max_queue)
        self._pump = asyncio.get_running_loop().create_task(self._drain())

        async def on_publish(_ht, args, prev):
            msg = prev if prev is not None else args[1]
            for entry in self.forwards:
                if match_filter(entry.get("filter", "#"), msg.topic):
                    try:
                        self._q.put_nowait((entry, msg))
                    except asyncio.QueueFull:
                        self.ctx.metrics.inc("bridge.reductstore.dropped")
            return None

        self._unhooks = [
            self.ctx.hooks.register(HookType.MESSAGE_PUBLISH, on_publish, priority=-100)
        ]

    async def _drain(self) -> None:
        while True:
            entry, msg = await self._q.get()
            labels = {"x-reduct-label-topic": msg.topic}
            if entry.get("forward_all_from", True) and msg.from_id is not None:
                labels["x-reduct-label-from_node"] = str(msg.from_id.node_id)
                labels["x-reduct-label-from_clientid"] = msg.from_id.client_id
            if entry.get("forward_all_publish", True):
                labels["x-reduct-label-qos"] = str(msg.qos)
                labels["x-reduct-label-retain"] = "true" if msg.retain else "false"
            ts = int(time.time() * 1_000_000)
            path = f"/api/v1/b/{entry['bucket']}/{entry['entry']}?ts={ts}"
            try:
                status = await _http(
                    self.url, "POST", path, msg.payload,
                    {"Content-Type": "application/octet-stream", **self._auth(), **labels},
                )
                ok = status == 200
            except asyncio.CancelledError:
                raise
            except (OSError, asyncio.TimeoutError, ValueError) as e:
                log.warning("reductstore write: %s", e)
                ok = False
            self.ctx.metrics.inc(
                "bridge.reductstore.forwarded" if ok else "bridge.reductstore.errors"
            )

    async def stop(self) -> bool:
        for un in self._unhooks:
            un()
        self._unhooks = []
        if self._pump is not None:
            self._pump.cancel()
            self._pump = None
        return True

    def attrs(self):
        return {"url": self.url, "entries": len(self.forwards)}
