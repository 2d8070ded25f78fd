"""$SYS topics plugin.

Mirrors `rmqtt-plugins/rmqtt-sys-topic` (SURVEY.md §2.3): periodic
``$SYS/brokers/...`` status publishes plus session/message event topics
(client connected/disconnected/subscribed/unsubscribed).
"""

from __future__ import annotations

import asyncio
import json
from typing import Optional

from rmqtt_tpu_torch import __version__
from rmqtt_tpu_torch.broker.hooks import HookType
from rmqtt_tpu_torch.broker.types import Message, now
from rmqtt_tpu_torch.plugins import Plugin
from rmqtt_tpu_torch.router.base import Id


class SysTopicPlugin(Plugin):
    name = "rmqtt-sys-topic"
    descr = "periodic $SYS broker status + client event topics"

    def __init__(self, ctx, config=None) -> None:
        super().__init__(ctx, config)
        self.interval = float(self.config.get("publish_interval", 60.0))
        self._task: Optional[asyncio.Task] = None
        self._unhooks = []

    @property
    def _prefix(self) -> str:
        return f"$SYS/brokers/{self.ctx.node_id}"

    async def _publish(self, topic: str, payload: bytes, retain: bool = False) -> None:
        msg = Message(
            topic=topic, payload=payload, qos=0, retain=retain,
            from_id=Id(self.ctx.node_id, "$SYS"),
        )
        if retain:
            self.ctx.retain.set(topic, msg)
        await self.ctx.registry.forwards(msg)

    async def init(self) -> None:
        hooks = self.ctx.hooks

        async def on_connected(_ht, args, _prev):
            ci = args[0]
            await self._publish(
                f"{self._prefix}/clients/{ci.id.client_id}/connected",
                json.dumps({"clientid": ci.id.client_id, "username": ci.username,
                            "ts": now()}).encode(),
            )
            return None

        async def on_disconnected(_ht, args, _prev):
            id, reason = args[0], args[1]
            await self._publish(
                f"{self._prefix}/clients/{id.client_id}/disconnected",
                json.dumps({"clientid": id.client_id, "reason": reason, "ts": now()}).encode(),
            )
            return None

        async def on_subscribed(_ht, args, _prev):
            id, tf = args[0], args[1]
            await self._publish(
                f"{self._prefix}/session/{id.client_id}/subscribed",
                json.dumps({"clientid": id.client_id, "topic": tf}).encode(),
            )
            return None

        async def on_unsubscribed(_ht, args, _prev):
            id, tf = args[0], args[1]
            await self._publish(
                f"{self._prefix}/session/{id.client_id}/unsubscribed",
                json.dumps({"clientid": id.client_id, "topic": tf}).encode(),
            )
            return None

        self._unhooks = [
            hooks.register(HookType.CLIENT_CONNECTED, on_connected),
            hooks.register(HookType.CLIENT_DISCONNECTED, on_disconnected),
            hooks.register(HookType.SESSION_SUBSCRIBED, on_subscribed),
            hooks.register(HookType.SESSION_UNSUBSCRIBED, on_unsubscribed),
        ]

    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._loop())

    async def stop(self) -> bool:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        for un in self._unhooks:
            un()
        self._unhooks = []
        return True

    async def _loop(self) -> None:
        while True:
            # overload tier (broker/overload.py): at ELEVATED the periodic
            # status fan-out is deferrable work and pauses; the overload
            # topics themselves keep publishing — they're the diagnostic an
            # operator needs exactly then
            if self.ctx.overload.allow_sys():
                stats = self.ctx.stats()
                await self._publish(f"{self._prefix}/version", __version__.encode(), retain=True)
                await self._publish(
                    f"{self._prefix}/stats", json.dumps(stats.to_json()).encode()
                )
                await self._publish(
                    f"{self._prefix}/metrics", json.dumps(self.ctx.metrics.to_json()).encode()
                )
                await self._publish_latency()
                await self._publish_tracing()
                await self._publish_device()
                await self._publish_autotune()
                await self._publish_host()
                await self._publish_hotkeys()
                await self._publish_durability()
            await self._publish_slo()
            await self._publish_overload()
            await self._publish_failover()
            await self._publish_cluster()
            await asyncio.sleep(self.interval)

    async def _publish_latency(self) -> None:
        """$SYS/brokers/<node>/latency/<stage path>: one compact row per
        telemetry stage (dots become topic levels, so ``latency/#``
        subscribes to all of them and ``latency/publish/#`` to the publish
        stages) plus the slow-op ring under ``latency/slow_ops``."""
        tele = getattr(self.ctx, "telemetry", None)
        if tele is None or not tele.enabled:
            return
        snap = tele.snapshot()
        for stage, row in snap["histograms"].items():
            if not row["count"]:
                continue  # quiet stages publish nothing, not zeros
            await self._publish(
                f"{self._prefix}/latency/{stage.replace('.', '/')}",
                json.dumps({k: row[k] for k in
                            ("count", "sum", "unit", "mean",
                             "p50", "p90", "p99", "p999")}).encode(),
            )
        if snap["slow_ops"]:
            await self._publish(
                f"{self._prefix}/latency/slow_ops",
                json.dumps(snap["slow_ops"]).encode(),
            )

    async def _publish_device(self) -> None:
        """$SYS/brokers/<node>/device/#: the device-plane profiler's
        compile registry under ``device/compile`` (traces, cache hits,
        retrace storms), the HBM occupancy model under ``device/hbm`` and
        the latest dispatch rollup under ``device/dispatch``
        (broker/devprof.py). Published only while the profiler is enabled
        — trie-only / profiler-off brokers keep their $SYS tree unchanged."""
        from rmqtt_tpu_torch.broker.devprof import DEVPROF

        if not DEVPROF.enabled:
            return
        snap = DEVPROF.snapshot()
        compile_row = dict(snap["compile"])
        compile_row.pop("kernels", None)  # per-key detail stays on the API
        await self._publish(
            f"{self._prefix}/device/compile", json.dumps(compile_row).encode()
        )
        await self._publish(
            f"{self._prefix}/device/hbm", json.dumps(snap["hbm"]).encode()
        )
        disp = dict(snap["dispatch"])
        disp["rollups"] = disp.get("rollups", [])[-6:]  # bounded payload
        await self._publish(
            f"{self._prefix}/device/dispatch", json.dumps(disp).encode()
        )

    async def _publish_autotune(self) -> None:
        """$SYS/brokers/<node>/autotune: the autotuner's state + counters
        + the newest journal entries (broker/autotune.py). Published only
        while the plane is enabled — the disabled default keeps the $SYS
        tree unchanged (the zero-behavior-change pin); the full journal
        and knob table stay on the HTTP API."""
        at = getattr(self.ctx, "autotune", None)
        if at is None or not at.enabled:
            return
        snap = at.snapshot()
        snap.pop("knobs", None)
        snap["journal"] = snap.get("journal", [])[-8:]  # bounded payload
        await self._publish(
            f"{self._prefix}/autotune", json.dumps(snap).encode()
        )

    async def _publish_host(self) -> None:
        """$SYS/brokers/<node>/host/{loop,gc,incidents}: the host-plane
        profiler's loop-lag summary, GC per-generation pauses and the
        blocking-call incident summary (broker/hostprof.py). Published
        only while the profiler is enabled — host_profile=false brokers
        keep their $SYS tree unchanged. Incident frame stacks stay on the
        HTTP API (they're large and operator-eyes-only)."""
        from rmqtt_tpu_torch.broker.hostprof import HOSTPROF

        if not HOSTPROF.enabled:
            return
        snap = HOSTPROF.snapshot()
        loop_row = dict(snap["loop"])
        loop_row.pop("lag_hist", None)  # raw buckets stay on the API
        await self._publish(
            f"{self._prefix}/host/loop", json.dumps(loop_row).encode()
        )
        await self._publish(
            f"{self._prefix}/host/gc", json.dumps(snap["gc"]).encode()
        )
        blk = dict(snap["block"])
        blk["incidents"] = [
            {k: v for k, v in inc.items() if k != "stack"}
            for inc in blk.get("incidents", [])[-8:]
        ]
        await self._publish(
            f"{self._prefix}/host/incidents", json.dumps(blk).encode()
        )

    async def _publish_hotkeys(self) -> None:
        """$SYS/brokers/<node>/hotkeys/{topics,clients,prefixes}: the
        hot-key attribution plane's bounded top-8 views (broker/
        hotkeys.py) — hot topics by count AND bytes, top publishing /
        subscribing clients, hot namespace prefixes + the reason:key
        drop view. Published only while the plane is enabled
        (hotkeys=false must change nothing, incl. $SYS)."""
        hk = getattr(self.ctx, "hotkeys", None)
        if hk is None or not hk.enabled:
            return
        for leaf, payload in hk.sys_payloads().items():
            await self._publish(
                f"{self._prefix}/hotkeys/{leaf}",
                json.dumps(payload).encode(),
            )

    async def _publish_durability(self) -> None:
        """$SYS/brokers/<node>/durability: journal health + the last
        cold-start recovery's replay counters (broker/durability.py).
        Published only when the plane is enabled — disabled brokers keep
        their $SYS tree unchanged (the zero-behavior-change pin)."""
        dur = getattr(self.ctx, "durability", None)
        if dur is None:
            return
        snap = dur.snapshot()
        snap.pop("retain_digest", None)  # digest stays on the HTTP API
        await self._publish(
            f"{self._prefix}/durability", json.dumps(snap).encode()
        )

    async def _publish_slo(self) -> None:
        """$SYS/brokers/<node>/slo/#: ``slo/state`` carries the worst
        state + windows, ``slo/objectives/<name>`` one row per objective
        (budget remaining, fast/slow burn rates). Like the overload tree,
        published only while the engine is enabled — and kept publishing
        at ELEVATED (budget burn is exactly what an operator needs then),
        which is why this sits outside the ``allow_sys`` gate."""
        slo = getattr(self.ctx, "slo", None)
        if slo is None or not slo.enabled:
            return
        snap = slo.snapshot()
        objectives = snap.pop("objectives", [])
        await self._publish(
            f"{self._prefix}/slo/state", json.dumps(snap).encode()
        )
        for row in objectives:
            await self._publish(
                f"{self._prefix}/slo/objectives/{row['name']}",
                json.dumps(row).encode(),
            )

    async def _publish_overload(self) -> None:
        """$SYS/brokers/<node>/overload/#: ``overload/state`` carries the
        watermark state + signals + admission/shed counters, ``overload/
        breakers`` the circuit registry. Published only when the subsystem
        is enabled (enable=false must change nothing, incl. $SYS)."""
        ov = getattr(self.ctx, "overload", None)
        if ov is None or not ov.enabled:
            return
        snap = ov.snapshot()
        breakers = snap.pop("breakers", {})
        await self._publish(
            f"{self._prefix}/overload/state", json.dumps(snap).encode()
        )
        if breakers:
            await self._publish(
                f"{self._prefix}/overload/breakers", json.dumps(breakers).encode()
            )

    async def _publish_failover(self) -> None:
        """$SYS/brokers/<node>/routing/failover: device-plane failover
        state (broker/failover.py). Published only when the failover plane
        is wired (device routers with a host fallback) — trie-only brokers
        keep their $SYS tree unchanged."""
        fo = getattr(self.ctx.routing, "failover", None)
        if fo is None:
            return
        await self._publish(
            f"{self._prefix}/routing/failover",
            json.dumps(fo.snapshot()).encode(),
        )

    async def _publish_cluster(self) -> None:
        """$SYS/brokers/<node>/cluster/membership: the failure detector's
        per-peer view + anti-entropy counters (cluster/membership.py).
        Published only on clustered brokers — single-node $SYS trees are
        unchanged. Kept publishing at ELEVATED like the overload topics:
        partition state is exactly what an operator needs under stress."""
        cluster = getattr(self.ctx.registry, "cluster", None)
        ms = getattr(cluster, "membership", None)
        if ms is None:
            return
        await self._publish(
            f"{self._prefix}/cluster/membership",
            json.dumps(ms.snapshot()).encode(),
        )

    async def _publish_tracing(self) -> None:
        """$SYS/brokers/<node>/tracing/#: the tracer's counters/config
        under ``tracing/stats`` and the latest slow-trace summaries under
        ``tracing/slow`` (ids are fetchable via /api/v1/traces/<id>)."""
        tracer = getattr(self.ctx, "tracer", None)
        if tracer is None or not tracer.enabled:
            return
        await self._publish(
            f"{self._prefix}/tracing/stats",
            json.dumps(tracer.snapshot()).encode(),
        )
        slow = tracer.slow_traces(10)
        if slow:
            await self._publish(
                f"{self._prefix}/tracing/slow", json.dumps(slow).encode()
            )
