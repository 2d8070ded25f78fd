"""Runtime knob registry: the device plane's kill-switches, consolidated.

Every performance-critical toggle grown over the kernel PRs lived in its
own corner: ``RMQTT_FUSED`` / ``RMQTT_PACKED`` / ``RMQTT_PALLAS`` as env
reads inside ``ops/partitioned.py``, ``RMQTT_DELTA_UPLOADS`` duplicated
across three matchers, ``RMQTT_HYBRID_MAX`` in ``router/xla.py``, the
sticky pad floor latched by ``prewarm()``, the batcher window on
``RoutingService``. An operator (or the autotuner, broker/autotune.py)
had no single place to ask "what is this broker actually running with,
and who set it?".

This module is that place: one :class:`KnobRegistry` per broker context
binding each knob to getter/setter closures over the LIVE objects —
reading a knob reads the live attribute, writing one writes through the
subsystem's own seam (``set_pad_floor`` / ``set_hybrid_max`` /
``set_batch_window`` / plain attribute). Each row carries its **source**:

``default``   nothing overrode the built-in
``env``       the kill-switch env var was set at process start
``conf``      the TOML section changed it from the dataclass default
``autotune``  the closed-loop controller chose it (broker/autotune.py)

Surfaced at ``GET /api/v1/routing/knobs``; the README knob table is kept
honest by a catalog-diff test (tests/test_autotune.py) against
:data:`KNOB_CATALOG`.

Binding is read-only — building a registry mutates nothing (the
autotune-disabled zero-behavior-change pin depends on that).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, List, Optional

#: the canonical knob names (and their order on every surface). The
#: README "Self-tuning device plane" table must list exactly these —
#: diffed by tests/test_autotune.py. Routers without a device matcher
#: bind only the host-side subset; the catalog is the superset.
KNOB_CATALOG = (
    "fused",          # fused match→compact→decode pipeline (RMQTT_FUSED)
    "packed",         # bit-packed automaton tiles (RMQTT_PACKED)
    "pallas",         # hand-pipelined Pallas kernel (RMQTT_PALLAS)
    "delta_uploads",  # incremental HBM scatter vs full repack (RMQTT_DELTA_UPLOADS)
    "hybrid_max",     # trie-vs-device batch threshold (RMQTT_HYBRID_MAX)
    "prewarm",        # pre-compile small shapes at start ([routing] prewarm)
    "pad_floor",      # sticky small-batch pad floor (RMQTT_PAD_FLOOR / prewarm)
    "max_batch",      # batcher dispatch cap ([routing] batch_max)
    "linger_ms",      # batch-wait window ([routing] linger_ms)
)


class Knob:
    __slots__ = ("name", "kind", "get", "set", "source")

    def __init__(self, name: str, kind: str, get: Callable[[], Any],
                 set: Optional[Callable[[Any], None]], source: str) -> None:
        self.name = name
        self.kind = kind  # "bool" | "int" | "float" | "tristate"
        self.get = get
        self.set = set
        self.source = source

    def row(self) -> dict:
        v = self.get()
        if self.kind == "tristate" and v is None:
            v = "auto"  # None = decide-on-first-use (fused/pallas verify)
        return {"name": self.name, "value": v, "source": self.source,
                "writable": self.set is not None, "kind": self.kind}


class KnobRegistry:
    """Ordered name → :class:`Knob` map; the autotuner's single
    read/write seam and the ``/api/v1/routing/knobs`` body."""

    def __init__(self) -> None:
        self._knobs: Dict[str, Knob] = {}
        self._lock = threading.Lock()

    def register(self, name: str, get: Callable[[], Any],
                 set: Optional[Callable[[Any], None]] = None,
                 source: str = "default", kind: str = "int") -> None:
        self._knobs[name] = Knob(name, kind, get, set, source)

    def __contains__(self, name: str) -> bool:
        return name in self._knobs

    def names(self) -> List[str]:
        return list(self._knobs)

    def value(self, name: str) -> Any:
        return self._knobs[name].get()

    def source(self, name: str) -> str:
        return self._knobs[name].source

    def set(self, name: str, value: Any, source: str = "autotune") -> Any:
        """Write ``value`` through the knob's seam; → the OLD value (the
        autotuner's rollback token). Raises KeyError on an unknown name
        and ValueError on a read-only knob."""
        with self._lock:
            k = self._knobs[name]
            if k.set is None:
                raise ValueError(f"knob {name!r} is read-only")
            old = k.get()
            k.set(value)
            k.source = source
            return old

    def restore(self, name: str, value: Any, source: str) -> None:
        """Rollback write: value AND provenance go back together, so a
        rolled-back canary leaves no 'autotune' fingerprint on the row."""
        with self._lock:
            k = self._knobs[name]
            if k.set is not None:
                k.set(value)
            k.source = source

    def snapshot(self) -> List[dict]:
        return [k.row() for k in self._knobs.values()]


def _tristate(v: Any) -> Optional[bool]:
    """'auto'/None → None; anything else coerces to bool."""
    if v is None or v == "auto":
        return None
    return bool(v)


def build_registry(router, routing, cfg=None, environ=None) -> KnobRegistry:
    """Bind the live knob set of ``router``/``routing``. Duck-typed: trie
    and native routers (no device matcher) get the host-side subset;
    every attribute is read through closures so the registry never holds
    a stale copy. ``cfg`` (BrokerConfig) resolves conf-vs-default
    provenance; ``environ`` is injectable for tests."""
    env = environ if environ is not None else os.environ

    def src(env_var: Optional[str], conf_changed: bool = False) -> str:
        if env_var and env.get(env_var, "") != "":
            return "env"
        return "conf" if conf_changed else "default"

    def changed(field: str) -> bool:
        """Does ``cfg`` carry a non-default value for ``field``? The
        default comes from the dataclass itself — a duplicated literal
        here would silently drift when BrokerConfig's default moves."""
        if cfg is None:
            return False
        import dataclasses

        try:
            default = next(f.default for f in dataclasses.fields(type(cfg))
                           if f.name == field)
        except (StopIteration, TypeError):
            return False
        return getattr(cfg, field, default) != default

    reg = KnobRegistry()
    matcher = getattr(router, "matcher", None)
    # --- device-matcher knobs (ops/partitioned.py seams)
    if matcher is not None and hasattr(matcher, "_fused"):
        reg.register(
            "fused", lambda m=matcher: m._fused,
            lambda v, m=matcher: setattr(m, "_fused", _tristate(v)),
            source=src("RMQTT_FUSED"), kind="tristate")
    if matcher is not None and hasattr(matcher, "_packed_pref"):
        reg.register(
            "packed", lambda m=matcher: m._packed_pref,
            # applies at the next FULL device refresh (tile re-pack);
            # the resident array keeps its layout until then
            lambda v, m=matcher: setattr(m, "_packed_pref", bool(v)),
            source=src("RMQTT_PACKED"), kind="bool")
    if matcher is not None and hasattr(matcher, "_pallas"):
        reg.register(
            "pallas", lambda m=matcher: m._pallas,
            lambda v, m=matcher: setattr(m, "_pallas", _tristate(v)),
            source=src("RMQTT_PALLAS"), kind="tristate")
    if matcher is not None and hasattr(matcher, "delta_enabled"):
        reg.register(
            "delta_uploads", lambda m=matcher: m.delta_enabled,
            lambda v, m=matcher: setattr(m, "delta_enabled", bool(v)),
            source=src("RMQTT_DELTA_UPLOADS",
                       changed("routing_delta_uploads")),
            kind="bool")
    if callable(getattr(router, "set_hybrid_max", None)):
        reg.register(
            "hybrid_max", lambda r=router: r._hybrid_max,
            lambda v, r=router: router.set_hybrid_max(int(v)),
            source=src("RMQTT_HYBRID_MAX"), kind="int")
    if routing is not None:
        reg.register(
            "prewarm", lambda s=routing: s.prewarm,
            lambda v, s=routing: setattr(s, "prewarm", bool(v)),
            source=src(None, changed("routing_prewarm")), kind="bool")
    if matcher is not None and callable(getattr(matcher, "set_pad_floor",
                                                None)):
        reg.register(
            "pad_floor", lambda m=matcher: m._pad_floor,
            lambda v, m=matcher: matcher.set_pad_floor(int(v)),
            source=src("RMQTT_PAD_FLOOR"), kind="int")
    # --- batcher knobs (broker/routing.py seam)
    if routing is not None:
        reg.register(
            "max_batch", lambda s=routing: s.max_batch,
            lambda v, s=routing: s.set_batch_window(max_batch=int(v)),
            source=src(None, changed("batch_max")), kind="int")
        reg.register(
            "linger_ms", lambda s=routing: round(s.linger * 1000.0, 3),
            lambda v, s=routing: s.set_batch_window(linger_ms=float(v)),
            source=src(None, changed("batch_linger_ms")), kind="float")
    return reg
