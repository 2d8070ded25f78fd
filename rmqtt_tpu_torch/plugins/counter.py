"""Hook-event counter plugin (mirror of `rmqtt-plugins/rmqtt-counter`):
counts every fired hook event into the broker metrics."""

from __future__ import annotations

from rmqtt_tpu_torch.broker.hooks import HookType
from rmqtt_tpu_torch.plugins import Plugin


class CounterPlugin(Plugin):
    name = "rmqtt-counter"
    descr = "count hook events into metrics"

    def __init__(self, ctx, config=None) -> None:
        super().__init__(ctx, config)
        self._unhooks = []

    async def init(self) -> None:
        metrics = self.ctx.metrics

        def make(ht: HookType):
            async def count(_ht, _args, _prev):
                metrics.inc(f"hook.{ht.value}")
                return None

            return count

        self._unhooks = [
            self.ctx.hooks.register(ht, make(ht), priority=1000) for ht in HookType
        ]

    async def stop(self) -> bool:
        for un in self._unhooks:
            un()
        self._unhooks = []
        return True
