"""Layered configuration: TOML file + environment overrides + CLI merge.

Mirrors `rmqtt-conf` (`rmqtt-conf/src/lib.rs:42-145`):
a TOML settings file (sections: node / listener / mqtt / retain / cluster /
log / plugins), ``RMQTT_``-prefixed environment overrides with ``__``
section separators and list support (reference env override w/ list-keys),
and command-line arguments merged last (options.rs). Per-plugin config
lives under ``[plugins.<name>]`` (the reference uses one TOML per plugin in
``plugins.dir``; a single file with sections is the same surface). The
``[log]`` section (to/level/dir/file) mirrors
`rmqtt-conf/src/logging.rs`.
"""

from __future__ import annotations

import os

try:
    import tomllib
except ModuleNotFoundError:  # Python < 3.11: tomllib landed in 3.11
    import tomli as tomllib  # type: ignore[no-redef]
from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, Optional, Tuple

from rmqtt_tpu_torch.broker.context import BrokerConfig
from rmqtt_tpu_torch.broker.fitter import FitterConfig

ENV_PREFIX = "RMQTT_"


def _env_overrides(environ=None) -> Dict[str, Any]:
    """``RMQTT_MQTT__MAX_QOS=1`` → {"mqtt": {"max_qos": 1}}. Values parse as
    TOML scalars (ints/bools/strings); comma lists become lists."""
    environ = environ if environ is not None else os.environ
    out: Dict[str, Any] = {}
    for key, raw in environ.items():
        if not key.startswith(ENV_PREFIX):
            continue
        path = key[len(ENV_PREFIX) :].lower().split("__")
        value: Any
        low = raw.strip()
        if "," in low:
            value = [_scalar(x.strip()) for x in low.split(",") if x.strip()]
        else:
            value = _scalar(low)
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value
    return out


def _scalar(s: str) -> Any:
    if s.lower() in ("true", "false"):
        return s.lower() == "true"
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    return s


def _deep_merge(base: Dict[str, Any], over: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


@dataclass
class LogConfig:
    """The ``[log]`` section (`rmqtt-conf/src/logging.rs` Log struct):
    destination (off/file/console/both), severity, file placement, and the
    line format — ``plain`` (human) or ``json`` (one JSON object per line
    with level/logger/msg and, when a publish trace is in scope, its trace
    id — so broker logs join with `/api/v1/traces`)."""

    to: str = "console"  # off | file | console | both
    level: str = "info"  # off | error | warn | info | debug | trace
    dir: str = "logs"  # reference default is /var/log/rmqtt; keep writable
    file: str = "rmqtt.log"
    format: str = "plain"  # plain | json

    def filename(self) -> str:
        """dir + file joined (logging.rs ``Log::filename``)."""
        if not self.file:
            return ""
        if not self.dir:
            return self.file
        return f"{self.dir.rstrip('/')}/{self.file}"


_LOG_LEVELS = {
    # trace has no stdlib tier; map to DEBUG like tracing→log bridges do
    "off": None, "error": 40, "warn": 30, "warning": 30, "info": 20,
    "debug": 10, "trace": 10,
}


class _JsonLogFormatter:
    """``[log] format = "json"``: one JSON object per line. The active
    publish trace id (broker/tracing.py contextvar) is stamped on records
    emitted inside a traced pipeline, so log lines and spans join on it."""

    def format(self, record) -> str:
        import json as _json

        out = {
            "ts": round(record.created, 3),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        try:
            from rmqtt_tpu_torch.broker.tracing import CURRENT_TRACE

            trace = CURRENT_TRACE.get()
            if trace is not None:
                out["trace"] = trace.tid
        except Exception:
            pass
        if record.exc_info:
            import logging as _logging

            out["exc"] = _logging.Formatter().formatException(record.exc_info)
        return _json.dumps(out, default=str)


def setup_logging(log: LogConfig, verbose: bool = False) -> None:
    """Apply the ``[log]`` section to the root logger (file/console
    handlers, severity, plain/json line format); ``verbose`` (CLI ``-v``)
    forces DEBUG on top."""
    import logging

    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
        try:
            h.close()  # reconfiguration must not leak the old file handle
        except Exception:
            pass
    to = log.to.lower()
    if to not in ("off", "file", "console", "both"):
        raise ValueError(f"log.to must be off|file|console|both, got {log.to!r}")
    fmt_kind = log.format.lower()
    if fmt_kind not in ("plain", "json"):
        raise ValueError(f"log.format must be plain|json, got {log.format!r}")
    level = _LOG_LEVELS.get(log.level.lower())
    if log.level.lower() not in _LOG_LEVELS:
        raise ValueError(f"log.level {log.level!r} not recognized")
    if verbose:
        level = logging.DEBUG
    if to == "off" or level is None:
        root.addHandler(logging.NullHandler())
        root.setLevel(logging.CRITICAL + 1)
        return
    if fmt_kind == "json":
        fmt = _JsonLogFormatter()
    else:
        fmt = logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s %(message)s")
    if to in ("console", "both"):
        h = logging.StreamHandler()
        h.setFormatter(fmt)
        root.addHandler(h)
    if to in ("file", "both") and log.filename():
        os.makedirs(log.dir or ".", exist_ok=True)
        h = logging.FileHandler(log.filename())
        h.setFormatter(fmt)
        root.addHandler(h)
    if not root.handlers:
        # to="file" with an empty filename: without a handler the bare
        # setLevel below would leak WARNING+ records to stderr through
        # logging.lastResort — pin a NullHandler so "file sink, nowhere to
        # write" stays silent like to="off"
        root.addHandler(logging.NullHandler())
    root.setLevel(level)


@dataclass
class Settings:
    """The resolved configuration tree."""

    broker: BrokerConfig
    http_api: Optional[Dict[str, Any]]  # {"host":..., "port":...} or None
    cluster_listen: Optional[Tuple[str, int]]
    raft_db: Optional[str]
    retain_sync_mode: str  # "full" | "topic_only" (retain.rs:162)
    peers: List[Tuple[int, str, int]]
    plugins: Dict[str, Dict[str, Any]]  # name → config
    default_startups: List[str]
    raw: Dict[str, Any]
    log: LogConfig = field(default_factory=LogConfig)
    # membership/anti-entropy knobs ([cluster] heartbeat_interval /
    # suspect_timeout / dead_timeout / alive_hold / anti_entropy), passed
    # straight into the cluster constructors (cluster/membership.py)
    cluster_tuning: Dict[str, Any] = field(default_factory=dict)


def _apply_section(tree: Dict[str, Any], section: str,
                   keys: Dict[str, Tuple[str, Any]],
                   broker_kwargs: Dict[str, Any]) -> None:
    """Map one flat TOML section onto BrokerConfig kwargs.

    ``keys`` is ``toml_key → (field_name, converter)``; any key outside the
    map raises, so typos fail at load instead of silently defaulting."""
    body = tree.get(section, {})
    unknown = set(body) - set(keys)
    if unknown:
        raise ValueError(f"unknown [{section}] keys: {sorted(unknown)}")
    for key, (field_name, conv) in keys.items():
        if key in body:
            broker_kwargs[field_name] = conv(body[key])


def load(path: Optional[str] = None, cli: Optional[Dict[str, Any]] = None,
         environ=None) -> Settings:
    """file (lowest) ← env ← cli (highest), like Settings::init + merge."""
    tree: Dict[str, Any] = {}
    if path:
        with open(path, "rb") as f:
            tree = tomllib.load(f)
    tree = _deep_merge(tree, _env_overrides(environ))
    if cli:
        tree = _deep_merge(tree, {k: v for k, v in cli.items() if v is not None})

    node = tree.get("node", {})
    listener = tree.get("listener", {})
    mqtt = tree.get("mqtt", {})
    retain = tree.get("retain", {})
    cluster = tree.get("cluster", {})

    fitter_fields = {f.name for f in fields(FitterConfig)}
    fitter = FitterConfig(**{k: v for k, v in mqtt.items() if k in fitter_fields})
    broker_kwargs: Dict[str, Any] = {
        "host": listener.get("host", "0.0.0.0"),
        "port": int(listener.get("port", 1883)),
        "ws_port": int(listener["ws_port"]) if "ws_port" in listener else None,
        "tls_port": int(listener["tls_port"]) if "tls_port" in listener else None,
        "quic_port": int(listener["quic_port"]) if "quic_port" in listener else None,
        "wss_port": int(listener["wss_port"]) if "wss_port" in listener else None,
        "tls_cert": listener.get("tls_cert", ""),
        "tls_key": listener.get("tls_key", ""),
        "tls_client_ca": listener.get("tls_client_ca", ""),
        "proxy_protocol": bool(listener.get("proxy_protocol", False)),
        "reuse_port": bool(listener.get("reuse_port", False)),
        "node_id": int(node.get("id", 1)),
        "router": node.get("router", "trie"),
        "fitter": fitter,
    }
    # reference-style named sub-listeners ([listener.tcp.external] etc.,
    # rmqtt-conf/src/listener.rs) → BrokerConfig.extra_listeners; the flat
    # [listener] keys above stay the primary listener
    extra_listeners = []
    for kind in ("tcp", "ws", "tls", "wss"):
        sub = listener.get(kind)
        if not isinstance(sub, dict):
            continue
        for lname, spec in sub.items():
            if not isinstance(spec, dict):
                raise ValueError(
                    f"listener.{kind}.{lname}: sub-listeners are NAMED "
                    f"tables ([listener.{kind}.<name>] with a port); for a "
                    f"single listener use the flat [listener] keys"
                )
            if "port" not in spec:
                raise ValueError(f"listener.{kind}.{lname} needs a 'port'")
            if kind in ("tcp", "ws") and (
                spec.get("tls_cert") or spec.get("tls_key")
            ):
                raise ValueError(
                    f"listener.{kind}.{lname}: tls_cert/tls_key on a "
                    f"plaintext {kind!r} listener (use kind "
                    f"{'wss' if kind == 'ws' else 'tls'})"
                )
            extra_listeners.append({
                "kind": kind, "name": f"{kind}.{lname}",
                **{k: v for k, v in spec.items()
                   if k in ("host", "port", "tls_cert", "tls_key",
                            "tls_client_ca")},
            })
    if extra_listeners:
        broker_kwargs["extra_listeners"] = extra_listeners

    broker_fields = {f.name for f in fields(BrokerConfig)}
    for k, v in {**mqtt, **retain}.items():
        if k in broker_fields:
            broker_kwargs[k] = v
    if retain:
        if "enable" in retain:
            broker_kwargs["retain_enable"] = bool(retain["enable"])
        if "max_retained" in retain:
            broker_kwargs["retain_max"] = int(retain["max_retained"])
        if "tpu" in retain:
            broker_kwargs["retain_tpu"] = bool(retain["tpu"])
        if "tpu_threshold" in retain:
            broker_kwargs["retain_tpu_threshold"] = int(retain["tpu_threshold"])

    # flat-key config sections that map straight onto BrokerConfig fields:
    # key → (field, converter); unknown keys in a section are an error
    # [routing] — batcher + match-result cache knobs (broker/routing.py,
    # router/cache.py)
    _apply_section(tree, "routing", {
        "cache": ("route_cache", bool),
        "cache_capacity": ("route_cache_capacity", int),
        "cache_shared_bypass": ("route_cache_shared_bypass", bool),
        "batch_max": ("batch_max", int),
        "linger_ms": ("batch_linger_ms", float),
        "pipeline_depth": ("routing_pipeline_depth", int),
        "prewarm": ("routing_prewarm", bool),
        # device-table churn resilience (ops/partitioned.py): incremental
        # HBM delta uploads + background compaction trigger
        "delta_uploads": ("routing_delta_uploads", bool),
        "compact_async": ("routing_compact_async", bool),
        "compact_min_ops": ("routing_compact_min_ops", int),
        "compact_ratio": ("routing_compact_ratio", int),
        # device-plane failover (broker/failover.py): breaker + watchdog +
        # switchback knobs around the device router's host fallback
        "failover": ("failover_enable", bool),
        "failover_timeout_s": ("failover_timeout_s", float),
        "failover_threshold": ("failover_threshold", int),
        "failover_cooldown": ("failover_cooldown", float),
        "failover_max_cooldown": ("failover_max_cooldown", float),
        "failover_k_successes": ("failover_k_successes", int),
        # device-plane autotuner (broker/autotune.py): closed-loop knob
        # selection from devprof rollups. Default OFF (pinned zero change).
        "autotune": ("autotune_enable", bool),
        "autotune_interval_s": ("autotune_interval_s", float),
        "autotune_canary_k": ("autotune_canary_k", int),
        "autotune_cooldown_s": ("autotune_cooldown_s", float),
        "autotune_p99_guard": ("autotune_p99_guard", float),
        "autotune_confirm_ticks": ("autotune_confirm_ticks", int),
        "autotune_journal_max": ("autotune_journal_max", int),
    }, broker_kwargs)
    # [fabric] — intra-node routing fabric (broker/fabric.py): one router
    # owner per node serving every SO_REUSEPORT worker over a UDS mesh.
    # `--workers N` arms this per worker automatically when enabled; the
    # dir/worker_id/owner_id knobs matter for hand-wired topologies.
    _apply_section(tree, "fabric", {
        "enable": ("fabric_enable", bool),
        "dir": ("fabric_dir", str),
        "worker_id": ("fabric_worker_id", int),
        "owner_id": ("fabric_owner_id", int),
        "workers": ("fabric_workers", int),
        "batch_max": ("fabric_batch_max", int),
        "call_timeout_s": ("fabric_call_timeout_s", float),
        "submit_deadline_s": ("fabric_submit_deadline_s", float),
        "warm_grace_s": ("fabric_warm_grace_s", float),
    }, broker_kwargs)
    # [network] — syscall-batched data plane (broker/egress.py): the
    # per-connection egress coalescer (one vectored send per loop tick)
    # and the hashed keepalive timer wheel (one ticking task per worker).
    # RMQTT_EGRESS_COALESCE=0 / RMQTT_KEEPALIVE_WHEEL=0 env kill-switches
    # outrank these knobs (AND-composed in ServerContext).
    _apply_section(tree, "network", {
        "egress_coalesce": ("egress_coalesce", bool),
        "egress_high_water": ("egress_high_water", int),
        "keepalive_wheel": ("keepalive_wheel", bool),
        "keepalive_wheel_tick": ("keepalive_wheel_tick", float),
    }, broker_kwargs)
    # [durability] — crash-safe durability plane (broker/durability.py):
    # group-committed journal of retained/session/subscription/inflight
    # state + cold-start recovery. Default off (zero behavior change).
    _apply_section(tree, "durability", {
        "enable": ("durability_enable", bool),
        "path": ("durability_path", str),
        "storage": ("durability_storage", str),
        "flush_interval_ms": ("durability_flush_interval_ms", float),
        "flush_max": ("durability_flush_max", int),
        "compact_min": ("durability_compact_min", int),
        "sync": ("durability_sync", str),
    }, broker_kwargs)
    # [failpoints] — fault-injection sites (utils/failpoints.py): quoted
    # site name → action spec. Validated at load (unknown sites / bad specs
    # raise when ServerContext applies them); listed here as a free-form
    # section since the site catalog lives with the registry.
    fp_tree = tree.get("failpoints", {})
    if fp_tree:
        broker_kwargs["failpoints"] = {
            str(k): str(v) for k, v in fp_tree.items()}
    # [observability] — latency telemetry knobs (broker/telemetry.py):
    # histograms + slow-op ring; enable=false makes every span a no-op.
    # trace_* configure the per-publish tracing layer (broker/tracing.py):
    # head-sampling probability + bounded trace/span store caps (tracing
    # shares enable and slow_ms — a slow publish is always recorded)
    # device_* knobs configure the device-plane profiler + flight recorder
    # (broker/devprof.py): jit shape-key registry / retrace-storm detector,
    # dispatch rollups, bounded flight ring + auto-dump triggers
    # host_profile/block_ms/lag_storm_* configure the host-plane profiler
    # (broker/hostprof.py): event-loop lag sampler + lag storms, GC pause
    # forensics, blocking-call watchdog with frame-stack incident ring
    _apply_section(tree, "observability", {
        "enable": ("telemetry_enable", bool),
        "slow_ms": ("telemetry_slow_ms", float),
        "slow_log_max": ("telemetry_slow_log_max", int),
        "trace_sample": ("trace_sample", float),
        "trace_max_traces": ("trace_max_traces", int),
        "trace_max_spans": ("trace_max_spans", int),
        "device_profile": ("device_profile", bool),
        "device_ring": ("device_ring", int),
        "recompile_storm_n": ("device_storm_n", int),
        "recompile_storm_window": ("device_storm_window", float),
        "host_profile": ("host_profile", bool),
        "block_ms": ("host_block_ms", float),
        "lag_storm_n": ("host_lag_storm_n", int),
        "lag_storm_window": ("host_lag_storm_window", float),
        # devprof/hostprof rollup-ring retention (intervals kept; at the
        # default 5 s interval 120 rollups = a 10-minute window)
        "device_rollup_max": ("device_rollup_max", int),
        "host_rollup_max": ("host_rollup_max", int),
        # history_* configure the telemetry-history plane
        # (broker/history.py): fixed-interval cross-plane collector,
        # bounded sample ring, CRC-framed on-disk segments with
        # retention, and the EWMA+MAD anomaly annotator
        "history": ("history_enable", bool),
        "history_interval_s": ("history_interval_s", float),
        "history_ring_max": ("history_ring_max", int),
        "history_dir": ("history_dir", str),
        "history_segment_rows": ("history_segment_rows", int),
        "history_retention_segments": ("history_retention_segments", int),
        "history_anomaly": ("history_anomaly_enable", bool),
        "history_anomaly_k": ("history_anomaly_k", float),
        "history_anomaly_warmup": ("history_anomaly_warmup", int),
        # hotkeys* configure the hot-key attribution plane
        # (broker/hotkeys.py): Space-Saving top-k + Count-Min sketches
        # over topics / clients / filter prefixes, epoch-rotated decay
        # windows and the top-1-share alert
        "hotkeys": ("hotkeys_enable", bool),
        "hotkeys_k": ("hotkeys_k", int),
        "hotkeys_cms_width": ("hotkeys_cms_width", int),
        "hotkeys_cms_depth": ("hotkeys_cms_depth", int),
        "hotkeys_window_s": ("hotkeys_window_s", float),
        "hotkeys_alert_share": ("hotkeys_alert_share", float),
    }, broker_kwargs)
    # [slo] — the live SLO engine (broker/slo.py): error budgets +
    # multi-window burn rates over the telemetry histograms and drop
    # counters. ``objectives`` is an array-of-tables ([[slo.objectives]])
    # of declarative objective rows, validated when the engine is
    # constructed; the scalar knobs map like every other flat section.
    slo_tree = tree.get("slo")
    if slo_tree is not None:
        slo_tree = dict(slo_tree)
        objectives = slo_tree.pop("objectives", None)
        if objectives is not None:
            if not isinstance(objectives, list) or not all(
                isinstance(o, dict) for o in objectives
            ):
                raise ValueError(
                    "[[slo.objectives]] must be an array of tables")
            broker_kwargs["slo_objectives"] = [dict(o) for o in objectives]
        _apply_section({"slo": slo_tree}, "slo", {
            "enable": ("slo_enable", bool),
            "sample_interval": ("slo_sample_interval", float),
            "fast_window_s": ("slo_fast_window_s", float),
            "slow_window_s": ("slo_slow_window_s", float),
            "burn_alert": ("slo_burn_alert", float),
        }, broker_kwargs)
    # [overload] — the overload-control subsystem (broker/overload.py):
    # watermark states + admission buckets + degradation tiers + breakers
    _apply_section(tree, "overload", {
        "enable": ("overload_enable", bool),
        "sample_interval": ("overload_sample_interval", float),
        "clear_ratio": ("overload_clear_ratio", float),
        "hold": ("overload_hold", int),
        "queue_elevated": ("overload_queue_elevated", float),
        "queue_critical": ("overload_queue_critical", float),
        "mqueue_elevated": ("overload_mqueue_elevated", float),
        "mqueue_critical": ("overload_mqueue_critical", float),
        "inflight_elevated": ("overload_inflight_elevated", float),
        "inflight_critical": ("overload_inflight_critical", float),
        "rss_elevated_mb": ("overload_rss_elevated_mb", float),
        "rss_critical_mb": ("overload_rss_critical_mb", float),
        "connect_rate_elevated": ("overload_connect_rate_elevated", float),
        "connect_rate_critical": ("overload_connect_rate_critical", float),
        "connect_rate_limit": ("overload_connect_rate_limit", float),
        "connect_burst": ("overload_connect_burst", float),
        "publish_rate_limit": ("overload_publish_rate_limit", float),
        "publish_burst": ("overload_publish_burst", float),
        "shed_slow_fraction": ("overload_shed_slow_fraction", float),
        "batch_shrink": ("overload_batch_shrink", int),
        "breaker_threshold": ("overload_breaker_threshold", int),
        "breaker_cooldown": ("overload_breaker_cooldown", float),
        "breaker_max_cooldown": ("overload_breaker_max_cooldown", float),
    }, broker_kwargs)

    cluster_listen = None
    raft_db = None
    # every [cluster] key is named here; typos fail at load like the other
    # sections (membership knobs feed cluster/membership.py)
    _cluster_known = {
        "listen", "mode", "peers", "raft_db", "retain_sync_mode",
        "heartbeat_interval", "suspect_timeout", "dead_timeout",
        "alive_hold", "anti_entropy",
    }
    unknown = set(cluster) - _cluster_known
    if unknown:
        raise ValueError(f"unknown [cluster] keys: {sorted(unknown)}")
    retain_sync_mode = str(cluster.get("retain_sync_mode", "full"))
    if retain_sync_mode not in ("full", "topic_only"):
        raise ValueError(
            f"cluster.retain_sync_mode must be 'full' or 'topic_only', "
            f"got {retain_sync_mode!r}"
        )
    cluster_tuning: Dict[str, Any] = {}
    for key, conv in (("heartbeat_interval", float),
                      ("suspect_timeout", float),
                      ("dead_timeout", float),
                      ("alive_hold", int),
                      ("anti_entropy", bool)):
        if key in cluster:
            cluster_tuning[key] = conv(cluster[key])
    peers: List[Tuple[int, str, int]] = []
    if cluster.get("listen"):
        host, _, port = str(cluster["listen"]).rpartition(":")
        cluster_listen = (host or "0.0.0.0", int(port))
        broker_kwargs["cluster"] = True
        broker_kwargs["cluster_mode"] = cluster.get("mode", "broadcast")
        raft_db = cluster.get("raft_db")
        for spec in cluster.get("peers", []):
            nid, _, addr = str(spec).partition("@")
            phost, _, pport = addr.rpartition(":")
            peers.append((int(nid), phost, int(pport)))

    http_cfg = tree.get("http_api")
    http_api = None
    if http_cfg and http_cfg.get("enable", True):
        http_api = {"host": http_cfg.get("host", "127.0.0.1"),
                    "port": int(http_cfg.get("port", 6060))}

    plugins_tree = tree.get("plugins", {})
    default_startups = list(plugins_tree.get("default_startups", []))
    plugin_cfgs = {k: v for k, v in plugins_tree.items() if isinstance(v, dict)}

    log_tree = tree.get("log", {})
    log_fields = {f.name for f in fields(LogConfig)}
    unknown = set(log_tree) - log_fields
    if unknown:
        raise ValueError(f"unknown [log] keys: {sorted(unknown)}")
    log_cfg = LogConfig(**{k: str(v) for k, v in log_tree.items()})

    return Settings(
        broker=BrokerConfig(**broker_kwargs),
        http_api=http_api,
        cluster_listen=cluster_listen,
        raft_db=raft_db,
        retain_sync_mode=retain_sync_mode,
        peers=peers,
        plugins=plugin_cfgs,
        default_startups=default_startups,
        raw=tree,
        log=log_cfg,
        cluster_tuning=cluster_tuning,
    )


# registry of loadable plugins: name → import path of the Plugin class
PLUGIN_REGISTRY: Dict[str, str] = {
    "rmqtt-sys-topic": "rmqtt_tpu_torch.plugins.sys_topic:SysTopicPlugin",
    "rmqtt-topic-rewrite": "rmqtt_tpu_torch.plugins.topic_rewrite:TopicRewritePlugin",
    "rmqtt-auto-subscription": "rmqtt_tpu_torch.plugins.auto_subscription:AutoSubscriptionPlugin",
    "rmqtt-counter": "rmqtt_tpu_torch.plugins.counter:CounterPlugin",
    "rmqtt-shared-subscription": "rmqtt_tpu_torch.plugins.shared_sub:SharedSubscriptionPlugin",
    "rmqtt-p2p-messaging": "rmqtt_tpu_torch.plugins.p2p:P2pPlugin",
    "rmqtt-acl": "rmqtt_tpu_torch.plugins.acl_file:AclFilePlugin",
    "rmqtt-web-hook": "rmqtt_tpu_torch.plugins.web_hook:WebHookPlugin",
    "rmqtt-auth-http": "rmqtt_tpu_torch.plugins.auth_http:AuthHttpPlugin",
    "rmqtt-auth-jwt": "rmqtt_tpu_torch.plugins.auth_jwt:AuthJwtPlugin",
    "rmqtt-auth-cram": "rmqtt_tpu_torch.plugins.auth_cram:AuthCramPlugin",
    "rmqtt-session-storage": "rmqtt_tpu_torch.plugins.session_storage:SessionStoragePlugin",
    "rmqtt-message-storage": "rmqtt_tpu_torch.plugins.message_storage:MessageStoragePlugin",
    "rmqtt-retainer": "rmqtt_tpu_torch.plugins.retainer:RetainerPlugin",
    "rmqtt-bridge-ingress-mqtt": "rmqtt_tpu_torch.plugins.bridge_mqtt:BridgeIngressMqttPlugin",
    "rmqtt-bridge-egress-mqtt": "rmqtt_tpu_torch.plugins.bridge_mqtt:BridgeEgressMqttPlugin",
    "rmqtt-bridge-ingress-nats": "rmqtt_tpu_torch.plugins.bridge_nats:BridgeIngressNatsPlugin",
    "rmqtt-bridge-egress-nats": "rmqtt_tpu_torch.plugins.bridge_nats:BridgeEgressNatsPlugin",
    "rmqtt-bridge-ingress-kafka": "rmqtt_tpu_torch.plugins.bridge_kafka:BridgeIngressKafkaPlugin",
    "rmqtt-bridge-egress-kafka": "rmqtt_tpu_torch.plugins.bridge_kafka:BridgeEgressKafkaPlugin",
    "rmqtt-bridge-egress-reductstore": "rmqtt_tpu_torch.plugins.bridge_reductstore:BridgeEgressReductstorePlugin",
    "rmqtt-bridge-ingress-pulsar": "rmqtt_tpu_torch.plugins.bridge_pulsar:BridgeIngressPulsarPlugin",
    "rmqtt-bridge-egress-pulsar": "rmqtt_tpu_torch.plugins.bridge_pulsar:BridgeEgressPulsarPlugin",
}


def instantiate_plugins(ctx, settings: Settings) -> None:
    """Register configured plugins on the context's PluginManager."""
    import importlib

    for name in settings.default_startups:
        spec = PLUGIN_REGISTRY.get(name)
        if spec is None:
            raise ValueError(f"unknown plugin {name!r}")
        mod_name, _, cls_name = spec.partition(":")
        cls = getattr(importlib.import_module(mod_name), cls_name)
        ctx.plugins.register(cls(ctx, settings.plugins.get(name, {})))
