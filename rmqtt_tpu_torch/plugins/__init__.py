"""Plugin framework.

Mirrors the reference's plugin system (`rmqtt/src/plugin.rs`):
a ``Plugin`` lifecycle (init/start/stop + package info + attrs) and a
``PluginManager`` registry tracking active state (plugin.rs:159-262, 296+).
Plugins extend the broker exclusively through the public seams: the hook
registry, the swappable router/registry, and per-plugin config.
"""

from __future__ import annotations

import abc
import logging
from typing import Any, Dict, List, Optional

log = logging.getLogger("rmqtt_tpu_torch.plugins")


class Plugin(abc.ABC):
    """Lifecycle + metadata (reference `Plugin` + `PackageInfo` traits)."""

    name: str = "unnamed"
    version: str = "0.1.0"
    descr: str = ""

    def __init__(self, ctx, config: Optional[Dict[str, Any]] = None) -> None:
        self.ctx = ctx
        self.config = config or {}
        self.active = False

    async def init(self) -> None:
        """One-time setup (register hooks etc.)."""

    async def start(self) -> None:
        """Activate (spawn tasks, swap managers)."""

    async def stop(self) -> bool:
        """Deactivate; return False if the plugin refuses to stop
        (cluster plugins do, reference cluster `stop()` returns false)."""
        return True

    def attrs(self) -> Dict[str, Any]:
        return {}


class PluginManager:
    def __init__(self, ctx) -> None:
        self.ctx = ctx
        self._plugins: Dict[str, Plugin] = {}
        self._inited: set = set()

    def register(self, plugin: Plugin) -> None:
        self._plugins[plugin.name] = plugin

    def get(self, name: str) -> Optional[Plugin]:
        return self._plugins.get(name)

    async def start_all(self) -> None:
        for p in self._plugins.values():
            if p.name not in self._inited:
                await p.init()
                self._inited.add(p.name)
            await p.start()
            p.active = True
            log.info("plugin %s v%s started", p.name, p.version)

    async def stop_all(self) -> None:
        for p in self._plugins.values():
            if p.active and await p.stop():
                p.active = False

    async def start(self, name: str) -> bool:
        p = self._plugins.get(name)
        if p is None:
            return False
        if p.name not in self._inited:
            await p.init()
            self._inited.add(p.name)
        await p.start()
        p.active = True
        return True

    async def stop(self, name: str) -> bool:
        p = self._plugins.get(name)
        if p is None or not p.active:
            return False
        if await p.stop():
            p.active = False
            # stop() unregisters whatever init() installed (hooks, ctx
            # seams); a later start() must re-run init or the plugin comes
            # back hookless (plugin.rs re-inits on load after unload)
            self._inited.discard(name)
            return True
        return False

    def describe(self) -> List[dict]:
        return [
            {
                "name": p.name,
                "version": p.version,
                "descr": p.descr,
                "active": p.active,
                "inited": p.name in self._inited,
                "attrs": p.attrs(),
            }
            for p in self._plugins.values()
        ]
