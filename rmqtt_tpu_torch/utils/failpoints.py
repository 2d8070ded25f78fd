"""Failpoint fault-injection registry: named sites, runtime-togglable faults.

Chaos testing a broker needs faults that can be *provoked*, not waited for:
an XLA dispatch error, a hung kernel completion, a flaky sqlite lock, a
dropped peer RPC. Each such seam registers a **failpoint** — a named site
whose behavior is ``off`` in production and can be flipped at runtime to
inject a fault (the classic failpoints/fail-rs pattern; TiKV and sled ship
the same discipline). The catalog of sites is fixed and documented (README
"Failure domains & failover"; a test diffs it against this registry).

Action grammar (one spec string per site)::

    off                      no effect (the default)
    error                    raise FailpointError at the site
    error(message)           ... with a custom message
    delay(ms)                sleep that many milliseconds, then continue
    hang                     block until the site is reconfigured (a "hung
                             device" that heals when the operator flips the
                             point off — never an unkillable thread)
    prob(p, action)          fire `action` with probability p, else off
    times(n, action)         fire `action` for the next n evaluations, off after

Configuration surfaces, lowest to highest:

- ``[failpoints]`` conf section (``"device.dispatch" = "error"``) applied by
  ``ServerContext`` from ``BrokerConfig.failpoints``;
- ``RMQTT_FAILPOINTS`` env string (``site=spec;site=spec``), applied at
  import so even non-broker harnesses (bench, scripts) honor it;
- ``PUT /api/v1/failpoints`` (broker/http_api.py) for live chaos drills.

Hot-path discipline (the ``enable=false`` rule): a site holds a direct
reference to its ``Failpoint`` and guards with ``if fp.action is not None``
— one attribute load + ``is`` test when every point is off, pinned by
tests/test_failpoints.py. ``fire_sync``/``fire_async`` are only entered
when an action is armed.
"""

from __future__ import annotations

import asyncio
import os
import random
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = [
    "FAILPOINTS", "Failpoint", "FailpointError", "FailpointRegistry", "SITES",
]


class FailpointError(RuntimeError):
    """The injected error (``error`` action). Sites that already classify
    transport faults treat it like any other failure of that seam."""


#: the documented site catalog: name → where it fires (README parity is
#: test-enforced, so adding a site here requires documenting it there)
SITES: List[Tuple[str, str]] = [
    ("device.dispatch", "XlaRouter batch submit (kernel dispatch / host encode)"),
    ("device.complete", "XlaRouter batch completion (device fetch / decode)"),
    ("device.upload", "device-table HBM refresh (delta scatter or full pack+put)"),
    ("storage.write", "sqlite/redis store mutations (put/delete/bulk)"),
    ("storage.read", "sqlite/redis store reads (get/scan/count)"),
    ("storage.fsync", "durability journal group commit (the batched fsync "
                      "window; error = commit retried, hang = acks park)"),
    ("storage.torn_write", "durability journal append (truncates the last "
                           "record mid-write and wedges the journal — "
                           "recovery must drop the torn tail by CRC)"),
    ("cluster.forward", "cross-node publish forwarding (broadcast + raft)"),
    ("cluster.rpc", "every cluster frame, both directions (partition: "
                    "outbound fails fast, inbound is blackholed)"),
    ("fabric.submit", "intra-node fabric publish submission to the router "
                      "owner (failure degrades to worker-local match)"),
    ("bridge.egress", "bridge producer sends (kafka/pulsar/nats egress pumps)"),
    ("net.egress", "per-connection coalesced egress flush (the vectored "
                   "write; error = connection drops, its read loop reaps it)"),
    ("history.collect", "telemetry-history sample collection (delay = a "
                        "provokable latency step on the history.collect_ms "
                        "series for anomaly drills)"),
    ("hotkeys.rotate", "hot-key sketch epoch rotation (a provokable "
                       "rotation stall/fault — the previous epoch keeps "
                       "serving while the rotator misbehaves)"),
]


class _Action:
    """One parsed action node (``prob``/``times`` wrap an inner node)."""

    __slots__ = ("kind", "message", "delay_s", "p", "n", "inner")

    def __init__(self, kind: str, message: str = "", delay_s: float = 0.0,
                 p: float = 0.0, n: int = 0, inner: "Optional[_Action]" = None):
        self.kind = kind
        self.message = message
        self.delay_s = delay_s
        self.p = p
        self.n = n
        self.inner = inner


def _parse_action(spec: str) -> Optional[_Action]:
    """Spec string → action tree (None = off). Raises ValueError on typos —
    a chaos drill must fail loudly at configure time, not silently no-op."""
    s = spec.strip()
    if not s or s == "off":
        return None
    if s == "error":
        return _Action("error")
    if s == "hang":
        return _Action("hang")
    if "(" in s and s.endswith(")"):
        head, _, body = s.partition("(")
        head = head.strip()
        body = body[:-1]
        if head == "error":
            return _Action("error", message=body.strip())
        if head == "delay":
            ms = float(body)
            if ms < 0:
                raise ValueError(f"delay(ms) must be >= 0, got {spec!r}")
            return _Action("delay", delay_s=ms / 1000.0)
        if head in ("prob", "times"):
            arg, _, inner_s = body.partition(",")
            if not inner_s.strip():
                raise ValueError(f"{head}(x, action) needs an inner action: {spec!r}")
            inner = _parse_action(inner_s)
            if inner is None:
                raise ValueError(f"{head}(..., off) is meaningless: {spec!r}")
            if inner.kind in ("prob", "times"):
                raise ValueError(f"{head} cannot nest {inner.kind}: {spec!r}")
            if head == "prob":
                p = float(arg)
                if not 0.0 <= p <= 1.0:
                    raise ValueError(f"prob p must be in [0,1]: {spec!r}")
                return _Action("prob", p=p, inner=inner)
            n = int(arg)
            if n <= 0:
                raise ValueError(f"times n must be > 0: {spec!r}")
            return _Action("times", n=n, inner=inner)
    raise ValueError(
        f"bad failpoint spec {spec!r} (off | error[(msg)] | delay(ms) | "
        f"hang | prob(p, action) | times(n, action))"
    )


class Failpoint:
    """One named injection site.

    ``action`` is ``None`` when off — the ONLY hot-path state. Everything
    else (trigger counters, the times-remaining budget) lives behind the
    armed check and a small lock."""

    __slots__ = ("name", "help", "spec", "action", "triggers", "evaluations",
                 "_times_left", "_lock", "_rng")

    def __init__(self, name: str, help: str = "",
                 rng: Optional[random.Random] = None) -> None:
        self.name = name
        self.help = help
        self.spec = "off"
        self.action: Optional[_Action] = None
        self.triggers = 0  # times a fault actually fired
        self.evaluations = 0  # armed-site passes (incl. prob misses)
        self._times_left = 0
        self._lock = threading.Lock()
        self._rng = rng if rng is not None else random

    # ------------------------------------------------------------ configure
    def set(self, spec: str) -> None:
        act = _parse_action(spec)
        with self._lock:
            self.spec = spec.strip() or "off"
            self._times_left = act.n if act is not None and act.kind == "times" else 0
            # publish the action LAST: a concurrent fire sees a consistent
            # (spec, budget) once it observes the new action
            self.action = act

    def clear(self) -> None:
        self.set("off")

    # --------------------------------------------------------------- firing
    def _resolve(self) -> Optional[_Action]:
        """One evaluation under the armed check: unwrap prob/times to the
        concrete action to run now (None = this pass does nothing)."""
        act = self.action
        if act is None:
            return None
        with self._lock:
            self.evaluations += 1
            if act.kind == "times":
                if self._times_left <= 0:
                    return None
                self._times_left -= 1
                act = act.inner
            elif act.kind == "prob":
                if self._rng.random() >= act.p:
                    return None
                act = act.inner
            self.triggers += 1
            return act

    def _raise(self, act: _Action) -> None:
        raise FailpointError(
            act.message or f"failpoint {self.name!r}: injected error")

    def fire_sync(self) -> None:
        """Blocking form (executor threads, storage backends). Callers guard
        with ``if fp.action is not None`` so this is never on the off path."""
        act = self._resolve()
        if act is None:
            return
        if act.kind == "error":
            self._raise(act)
        elif act.kind == "delay":
            time.sleep(act.delay_s)
        elif act.kind == "hang":
            marker = self.action  # hang until the site is reconfigured
            while self.action is marker:
                time.sleep(0.02)

    async def fire_async(self) -> None:
        """Event-loop form: identical semantics, cooperative sleeps."""
        act = self._resolve()
        if act is None:
            return
        if act.kind == "error":
            self._raise(act)
        elif act.kind == "delay":
            await asyncio.sleep(act.delay_s)
        elif act.kind == "hang":
            marker = self.action
            while self.action is marker:
                await asyncio.sleep(0.02)

    def snapshot(self) -> dict:
        with self._lock:
            out = {"action": self.spec, "triggers": self.triggers,
                   "evaluations": self.evaluations}
            if self.action is not None and self.action.kind == "times":
                out["times_left"] = self._times_left
            return out


async def fire_async_as(fp: Failpoint, exc_type=ConnectionError) -> None:
    """Fire an armed failpoint, translating an injected FailpointError into
    ``exc_type`` so the site's existing transient-fault handling (breaker,
    reconnect, retry) treats it exactly like the real fault it models."""
    try:
        await fp.fire_async()
    except FailpointError as e:
        raise exc_type(str(e)) from e


def fire_sync_as(fp: Failpoint, exc_type=ConnectionError) -> None:
    """Sync sibling of :func:`fire_async_as` — same translation contract
    (message text, ``__cause__`` chain) for synchronous store surfaces.
    Includes the armed check, so call sites stay one attribute test when
    every point is off."""
    if fp.action is not None:
        try:
            fp.fire_sync()
        except FailpointError as e:
            raise exc_type(str(e)) from e


class FailpointRegistry:
    """Process-global site registry (one per process, like the metrics
    registry): sites self-register at import, chaos surfaces configure."""

    def __init__(self, rng: Optional[random.Random] = None) -> None:
        self._points: Dict[str, Failpoint] = {}
        self._rng = rng
        for name, help_ in SITES:
            self.register(name, help_)

    def register(self, name: str, help: str = "") -> Failpoint:
        """Idempotent: the catalog pre-registers every standard site, so
        module-level ``register`` calls just fetch the shared instance
        (tests may register extra throwaway sites)."""
        fp = self._points.get(name)
        if fp is None:
            fp = self._points[name] = Failpoint(name, help, rng=self._rng)
        return fp

    def point(self, name: str) -> Failpoint:
        fp = self._points.get(name)
        if fp is None:
            raise ValueError(
                f"unknown failpoint {name!r} (catalog: {sorted(self._points)})")
        return fp

    def set(self, name: str, spec: str) -> None:
        self.point(name).set(spec)

    def clear_all(self) -> None:
        for fp in self._points.values():
            fp.clear()

    def configure(self, mapping: Dict[str, str]) -> None:
        """Apply a conf-section dict (``[failpoints]``); unknown names and
        bad specs raise, so typos fail at load. All-or-nothing: every name
        and spec is validated BEFORE any site is armed, so a 400 on the
        HTTP surface (or a load-time typo) never leaves a half-applied
        request live on a production broker."""
        parsed = [(self.point(name), str(spec)) for name, spec in mapping.items()]
        for _fp, spec in parsed:
            _parse_action(spec)
        for fp, spec in parsed:
            fp.set(spec)

    def configure_env(self, env: str) -> None:
        """``RMQTT_FAILPOINTS="a=error;b=delay(5)"`` (';'-separated);
        validated as one batch like :meth:`configure`."""
        mapping: Dict[str, str] = {}
        for part in env.split(";"):
            part = part.strip()
            if not part:
                continue
            name, eq, spec = part.partition("=")
            if not eq:
                raise ValueError(f"RMQTT_FAILPOINTS entry needs site=spec: {part!r}")
            mapping[name.strip()] = spec
        self.configure(mapping)

    def names(self) -> List[str]:
        return sorted(self._points)

    def snapshot(self) -> Dict[str, dict]:
        return {name: fp.snapshot() for name, fp in sorted(self._points.items())}

    def armed(self) -> Dict[str, str]:
        return {name: fp.spec for name, fp in sorted(self._points.items())
                if fp.action is not None}


#: the process-wide registry; sites bind their Failpoint once at import
FAILPOINTS = FailpointRegistry()

# env-string configuration at import: bench/scripts/chaos harnesses honor
# RMQTT_FAILPOINTS without any broker config plumbing
_env = os.environ.get("RMQTT_FAILPOINTS", "")
if _env:
    FAILPOINTS.configure_env(_env)
