"""Adaptive hybrid matcher: host trie vs device kernel, chosen by measurement.

The deployed router keeps two match engines for the same filter set: a
host-side trie (µs-scale per topic, the reference's own data structure,
`rmqtt/src/trie.rs:288-408`) and the batched device
automaton (`ops/partitioned.py`). Which one is faster depends on scale and
placement: at small tables or over a high-RTT tunnel the trie wins at any
batch size; at 1M+ wildcard subs the device path wins on bursts (NOTES.md
measured both regimes). A fixed size threshold can't know which regime it
is in — so the hybrid measures.

Policy:
- batches ≤ ``small_max`` always take the trie (per-message latency
  contract of `rmqtt/src/shared.rs:735-820`; a device dispatch per 1-topic
  publish costs a full round trip);
- larger batches go to whichever path's throughput EMA is higher; every
  ``probe_every``-th large batch runs on the slower path to refresh its
  EMA, so regime changes (table growth, co-located vs tunneled chip) flip
  the routing within a bounded number of batches;
- with no device matcher (or no trie side) the surviving path serves
  everything.

``match_submit``/``match_complete`` preserve the device path's pipelining
(dispatch N+1 overlaps compute N) — the bench and the RoutingService both
drive it; trie-served batches complete synchronously inside submit.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence

import numpy as np

from rmqtt_tpu_torch.utils.failpoints import FAILPOINTS

EMA_ALPHA = 0.3  # weight of the newest rate sample

#: chaos seams (utils/failpoints.py): fired ONLY on the device branch —
#: trie-served batches are host-side work and genuinely unaffected by a
#: dead/hung accelerator, so injected device faults must not touch them
#: (in particular, `hang` must never run on the event-loop inline path,
#: which is trie-only). One attribute test per batch when off.
_FP_DISPATCH = FAILPOINTS.register("device.dispatch")
_FP_COMPLETE = FAILPOINTS.register("device.complete")


class AdaptiveHybrid:
    def __init__(self, side, matcher, small_max: int = 64,
                 probe_every: int = 64) -> None:
        self.side = side  # NativeTrie-like: .match(topic) -> fid ndarray
        self.matcher = matcher  # device matcher: .match(list) / submit/complete
        self.small_max = small_max
        self.probe_every = probe_every
        self._rate = {"side": None, "device": None}  # EMA topics/s
        self._n_large = 0
        self._dev_samples = 0  # first device sample includes XLA compile
        self._last_dev_complete = None  # for pipelined-rate attribution
        # which backend served the most recent synchronous match — read by
        # the routing service right after a dispatch (serialized there) so
        # only DEVICE successes reset the failover breaker's consecutive-
        # failure count; trie-served batches are not device evidence
        self.last_backend: Optional[str] = None
        # EMA state is touched from both the submit and the completion
        # executor threads (RoutingService pipelining); the GIL keeps it
        # memory-safe but probe cadence / rate attribution would skew —
        # RLock because _bump_device nests into _bump
        self._lock = threading.RLock()

    # ------------------------------------------------------------- internals
    def _bump(self, key: str, rate: float) -> None:
        with self._lock:
            cur = self._rate[key]
            if cur is None or rate > 2.5 * cur or rate < cur / 2.5:
                # regime jump (compile finished, chip co-located, table grew):
                # converge immediately instead of over many EMA steps
                self._rate[key] = rate
            else:
                self._rate[key] = (1 - EMA_ALPHA) * cur + EMA_ALPHA * rate

    def _bump_device(self, n: int, dt: float) -> None:
        """Device samples skip the first call — it includes JIT compile
        (seconds to minutes at scale) and would pin routing to the trie
        for hundreds of probe cycles."""
        with self._lock:
            self._dev_samples += 1
            if self._dev_samples > 1 and dt > 0:
                self._bump("device", n / dt)

    def _side_match(self, topics: Sequence[str]) -> List[np.ndarray]:
        self.last_backend = "side"
        t0 = time.perf_counter()
        if len(topics) > 1 and hasattr(self.side, "match_batch"):
            # one native call for the whole batch: the per-topic ctypes
            # round trip (~7µs) would otherwise dominate and misprice the
            # trie side at large batch sizes
            rows = self.side.match_batch(list(topics))
        else:
            rows = [self.side.match(t) for t in topics]
        dt = time.perf_counter() - t0
        if len(topics) > self.small_max and dt > 0:
            self._bump("side", len(topics) / dt)
        return rows

    def _device_match(self, topics: Sequence[str]) -> List[np.ndarray]:
        self.last_backend = "device"
        if _FP_DISPATCH.action is not None:
            _FP_DISPATCH.fire_sync()
        t0 = time.perf_counter()
        rows = self.matcher.match(topics)
        if _FP_COMPLETE.action is not None:
            _FP_COMPLETE.fire_sync()
        with self._lock:
            self._bump_device(len(topics), time.perf_counter() - t0)
            self._last_dev_complete = time.perf_counter()
        return rows

    def _pick(self) -> str:
        """Route a large batch; probes keep the loser's EMA fresh."""
        if self.probe_every <= 0:
            return "device"  # adaptivity off: fixed size threshold only
        with self._lock:
            self._n_large += 1
            s, d = self._rate["side"], self._rate["device"]
            if d is None:
                return "device"
            if s is None:
                return "side"
            if self._n_large % self.probe_every == 0:
                return "side" if s < d else "device"  # probe the slower path
            return "side" if s >= d else "device"

    # ------------------------------------------------------------------ api
    def set_small_max(self, n: int) -> int:
        """Knob seam (broker/knobs.py via XlaRouter.set_hybrid_max): move
        the trie-vs-device threshold live; → the old value. The EMA state
        deliberately survives — the rates measured per path stay valid,
        only the boundary between them moves."""
        old = self.small_max
        self.small_max = max(0, int(n))
        return old

    @property
    def choice(self) -> Optional[str]:
        """Current steady-state routing for large batches (None = unprimed)."""
        s, d = self._rate["side"], self._rate["device"]
        if s is None or d is None:
            return None
        return "side" if s >= d else "device"

    def match(self, topics: Sequence[str]) -> List[np.ndarray]:
        if self.side is None:
            return self._device_match(topics)
        if self.matcher is None or len(topics) <= self.small_max:
            return self._side_match(topics)
        if self._pick() == "side":
            return self._side_match(topics)
        return self._device_match(topics)

    def match_submit(self, topics: Sequence[str]):
        """Pipelined form: device submissions stay asynchronous; trie-served
        batches resolve inside submit (they are µs-scale)."""
        if self.side is None or (
            self.matcher is not None and len(topics) > self.small_max
            and self._pick() == "device"
        ):
            if hasattr(self.matcher, "match_submit"):
                self.last_backend = "device"
                if _FP_DISPATCH.action is not None:
                    _FP_DISPATCH.fire_sync()
                return ("device", self.matcher.match_submit(topics),
                        len(topics), time.perf_counter())
            return ("sync", self._device_match(topics))
        return ("sync", self._side_match(topics))

    def match_complete(self, handle) -> List[np.ndarray]:
        if handle[0] == "sync":
            return handle[1]
        _kind, payload, n, t_submit = handle
        if _FP_COMPLETE.action is not None:
            _FP_COMPLETE.fire_sync()
        rows = self.matcher.match_complete(payload)
        now = time.perf_counter()
        with self._lock:
            last = self._last_dev_complete
            if last is not None and last > t_submit:
                # a device completion landed after this submit: the pipeline
                # is overlapped, so the inter-completion gap IS the per-batch
                # cost
                self._bump_device(n, now - last)
            else:
                # lone dispatch (e.g. a probe among trie-served batches): the
                # serial round trip is the honest rate
                self._bump_device(n, now - t_submit)
            self._last_dev_complete = now
        return rows
