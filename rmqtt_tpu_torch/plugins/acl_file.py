"""File/config-based ACL plugin (mirror of `rmqtt-plugins/rmqtt-acl`):
rule list loaded from config (the reference's rmqtt-acl.toml rows), installed
into the broker's ACL engine; first match wins, evaluated in order."""

from __future__ import annotations

from typing import List

from rmqtt_tpu_torch.broker.acl import Action, AclEngine, Permission, Rule, Who
from rmqtt_tpu_torch.plugins import Plugin


def rule_from_config(row: dict) -> Rule:
    """{"permission": "allow", "action": "publish", "user"/"clientid"/"ipaddr":
    ..., "topics": [...]}; reference shorthand {"permission": "allow",
    "who": "all"} maps to a match-everything rule."""
    return Rule(
        permission=Permission(row.get("permission", "allow")),
        action=Action(row.get("action", "all")),
        who=Who(
            user=row.get("user"),
            clientid=row.get("clientid"),
            ipaddr=row.get("ipaddr"),
        ),
        topics=tuple(row.get("topics", ())),
    )


class AclFilePlugin(Plugin):
    name = "rmqtt-acl"
    descr = "rule-based authorization from config"

    def __init__(self, ctx, config=None) -> None:
        super().__init__(ctx, config)
        self.rules: List[Rule] = [rule_from_config(r) for r in self.config.get("rules", [])]
        self.default_allow = bool(self.config.get("default_allow", True))
        self._prev: AclEngine | None = None

    async def start(self) -> None:
        self._prev = self.ctx.acl
        self.ctx.acl = AclEngine(self.rules, default_allow=self.default_allow)

    async def stop(self) -> bool:
        if self._prev is not None:
            self.ctx.acl = self._prev
            self._prev = None
        return True

    def attrs(self):
        return {"rules": len(self.rules)}
