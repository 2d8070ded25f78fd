"""Persistent storage backends.

The reference persists retained messages, offline messages and sessions via
`rmqtt-storage` (unified sled/redis KV, SURVEY.md §2.3). Here the embedded
backend is SQLite (stdlib) and the network backend is a dependency-free
RESP (redis) client; both expose the same surface, selected by
:func:`make_store`. Payloads serialize with the cluster wire format
(no pickle).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from rmqtt_tpu_torch.storage.sqlite import SqliteStore


def make_store(config: Optional[Dict[str, Any]] = None, *,
               default_path: str = ":memory:"):
    """Backend factory for the storage-backed plugins.

    ``config["storage"] = "redis://host:port/db"`` selects the RESP
    backend (`rmqtt-retainer`'s ``StorageType::Redis`` analogue,
    `rmqtt-plugins/rmqtt-retainer/src/lib.rs:26-94`); otherwise
    ``config["path"]`` (or ``default_path``) selects SQLite — the
    sled-equivalent embedded store. A ``sqlite://`` URL in ``storage``
    maps to its path for symmetry.
    """
    config = config or {}
    url = config.get("storage")
    if url:
        if url.startswith(("redis://", "resp://")):
            from rmqtt_tpu_torch.storage.redis import RedisStore

            return RedisStore(url, prefix=str(config.get("prefix", "rmqtt")))
        if url.startswith("sqlite://"):
            return SqliteStore(url[len("sqlite://"):] or default_path)
        raise ValueError(f"unknown storage url {url!r}")
    return SqliteStore(config.get("path", default_path))
