"""Device→host fetch: the one copy of a batch's result back to the host,
with an optional wedge guard.

A card can wedge mid-run: a copy from it then blocks forever, taking the
whole process with it. When ``RMQTT_FETCH_TIMEOUT`` (seconds) is set, the
copy runs on a daemon worker thread and raises ``TimeoutError`` instead of
hanging, so callers (the routing service's failover, a bench) can record
the failure and go on. Unset (the default) it is one plain copy: no
thread, no overhead.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import numpy as np
import torch

_timeout: Optional[float] = None
_loaded = False


def fetch_timeout() -> Optional[float]:
    global _timeout, _loaded
    if not _loaded:
        raw = os.environ.get("RMQTT_FETCH_TIMEOUT", "")
        _timeout = float(raw) if raw else None
        _loaded = True
    return _timeout


def set_fetch_timeout(seconds: Optional[float]) -> None:
    global _timeout, _loaded
    _timeout = seconds
    _loaded = True


def fetch(t: torch.Tensor, what: str = "device fetch") -> np.ndarray:
    """``t`` as a host numpy array, with the configured wedge guard. On a
    CUDA tensor the copy waits for the work queued before it on the
    caller's current stream (``np.asarray`` would raise)."""
    limit = fetch_timeout()
    if limit is None:
        return t.cpu().numpy()
    # the current stream is per thread: the worker copies on the caller's,
    # so it stays ordered after the caller's work on any stream
    stream = torch.cuda.current_stream(t.device) if getattr(t, "is_cuda", False) else None
    box: dict = {}

    def run() -> None:
        try:
            if stream is None:
                box["v"] = t.cpu().numpy()
            else:
                with torch.cuda.stream(stream):
                    box["v"] = t.cpu().numpy()
        except BaseException as e:  # surfaced on the caller thread
            box["e"] = e

    th = threading.Thread(target=run, daemon=True, name="devfetch")
    th.start()
    th.join(limit)
    if "v" in box:
        return box["v"]
    if "e" in box:
        raise box["e"]
    # the worker stays parked on the wedged copy; daemon=True means it
    # cannot block process exit
    raise TimeoutError(f"{what} exceeded {limit:.0f}s (wedged card?)")
