"""Rule-based authorization (ACL).

Mirrors the reference's ACL primitives (`rmqtt/src/acl.rs`)
and the rmqtt-acl plugin's first-match-wins evaluation: rules carry a
permission (allow/deny), an action (publish/subscribe/all), a *who* matcher
(user/clientid/ip/any) and topic filters with ``%u``/``%c`` placeholder
expansion (acl.rs:250-306) and the ``eq `` literal prefix (acl.rs:362-423).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from rmqtt_tpu_torch.core.topic import match_filter


class Permission(enum.Enum):
    ALLOW = "allow"
    DENY = "deny"


class Action(enum.Enum):
    ALL = "all"
    PUBLISH = "publish"
    SUBSCRIBE = "subscribe"


@dataclass
class Who:
    """Rule subject: any / user / clientid / ipaddr (rmqtt-acl.toml rows)."""

    user: Optional[str] = None
    clientid: Optional[str] = None
    ipaddr: Optional[str] = None

    def matches(self, username: Optional[str], client_id: str, ip: Optional[str]) -> bool:
        if self.user is not None and self.user != username:
            return False
        if self.clientid is not None and self.clientid != client_id:
            return False
        if self.ipaddr is not None and self.ipaddr != ip:
            return False
        return True


@dataclass
class Rule:
    permission: Permission
    action: Action = Action.ALL
    who: Who = field(default_factory=Who)
    topics: Sequence[str] = ()  # empty = any topic

    def topic_matches(self, topic: str, username: Optional[str], client_id: str) -> bool:
        if not self.topics:
            return True
        for pattern in self.topics:
            p = pattern.replace("%u", username or "").replace("%c", client_id)
            if p.startswith("eq "):
                if p[3:] == topic:
                    return True
            elif match_filter(p, topic):
                return True
        return False


@dataclass
class AclResult:
    allow: bool
    matched: bool  # False = no rule matched (caller may fall through)


class AclEngine:
    """Ordered first-match-wins rule list (rmqtt-acl plugin semantics)."""

    def __init__(self, rules: Optional[List[Rule]] = None, default_allow: bool = True) -> None:
        self.rules = rules or []
        self.default_allow = default_allow

    def check(
        self,
        action: Action,
        topic: str,
        username: Optional[str],
        client_id: str,
        ip: Optional[str] = None,
        superuser: bool = False,
    ) -> AclResult:
        if superuser:
            return AclResult(True, True)
        for rule in self.rules:
            if rule.action is not Action.ALL and rule.action is not action:
                continue
            if not rule.who.matches(username, client_id, ip):
                continue
            if not rule.topic_matches(topic, username, client_id):
                continue
            return AclResult(rule.permission is Permission.ALLOW, True)
        return AclResult(self.default_allow, False)
