#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rmqtt_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # cfg3 scale: 1M filters, 32,768 topics;
                                     # cfg5's retained side: 1M retained draws

Phases, each of which fails the run (nonzero exit, no result line):

1. device — requires CUDA; prints the card's name and power limit;
2. build — compiles ``rmqtt_tpu_torch/csrc/*.cu`` (the match-words, the
   retained-scan, the dense full-scan and the compaction-tail kernels),
   one nvcc a source, all at once, then a link, and prints the build time
   and the ptxas register / shared-memory / spill lines;
3. kernels — each match-words kernel against its plain PyTorch twin
   (``torch.equal``) at cfg3's shapes (B=16384, NC=32) on the real cfg3
   table and on random tiles, plus edge cases (odd B, NC=1, padded topics,
   chunk 0, $-topics, a 2-byte level) and ``bench/words_cases.py``'s
   ``EDGE_CASES`` (NC=33 and 64, B=1 and 3, chunk 0 at the front, in the
   middle and repeated, a nonzero id repeated, out-of-range ids giving zero
   words, every packed group count up to 30 levels / 16 groups, legacy L
   up to 40); each kernel and twin timed with CUDA events at B=16384,
   NC=32, and the kernel at the NC split's bucket shapes of that batch
   (their per-batch sum) and on a small set of tiles; bounds
   (``bench/roofline_model.py``: the bytes and the instructions issued,
   with the real table's literal levels);
3t. compaction tails — ``fused_compact_decode`` and ``compact_global``
   against their plain twins (``torch.equal`` over the whole ``[budget +
   B]`` wire) on ``bench/tail_cases.py``'s ``CARD_CASES`` (a topic matching
   every row past a warp's and past a block's shared memory, 65,536 routes
   sorted in device memory, budgets cutting inside a topic, ``-1`` fids,
   B = 0 and 1, both wire widths) and on phase 4's table
   (``bench/tail_kernels.py``): cfg3's words of 16,384 topics with the
   matcher's budget and with half of it (topics cut), the NC split's
   buckets of that batch and the broker's batches of 1, 2 and 4 topics
   (budget 256); each kernel and twin timed by CUDA events and graph
   replay beside the bounds; the device operations of one wrapper call at
   each shape counted with ``torch.profiler``: one kernel at the broker's
   shapes (the one-launch path) and one memset and one kernel for a larger
   call (the single pass), or the run fails;
3r. retained kernels — the gather and the full-stream retained-scan kernels
   against their twins (``torch.equal``) at the scanner's real shapes on
   the 1M-topic retained table (a 64-filter batch of ``run_retained``'s
   mix) and at the broker's one-filter scans on the same table (the narrow
   filter with the longest candidate list; a broad filter with a literal
   first level), on ``bench/retained_cases.py``'s ``RETAINED_CASES``
   (random tiles; NC=1, 33 and hundreds, B=1 and 3, chunk 0 as padding and
   repeated, lists of padding only, out-of-range ids, int32 tiles, every
   level range, odd tile counts, literal levels past level 1, filter values
   past int16, more filters than one shared-memory group) and on tables of
   real topics ($SYS rows against wildcard-first filters, a bare ``#``,
   ``+/#``, filters deeper than ``max_levels``, a vocabulary past 0x7FFF);
   timed at each real shape by CUDA-graph replay (the kernel's time on the
   card) and per call through the wrapper by CUDA events, beside their
   bounds;
4. cfg3 end to end through ``TorchRouter`` on packed tiles: 1M ``gen_mixed``
   filters (seed 0), 32,768 ``gen_topics_uniform`` topics in batches of
   16,384, pipelined (depth 2) and serial, encoded by the native topic
   encoder (the run fails if the table fell back to the Python encode);
   two pipelined passes with the fetch guard on (``set_fetch_timeout(60)``:
   each fetch on a worker thread), equal to the unguarded passes; a
   2,048-topic sample checked against the ``TopicTree`` oracle, every topic
   against the same router path run with the plain words twin on the card;
   2,000 removes + 2,000 adds (delta uploads), then the sample again;
   ``bench/roofline_model.py``'s ``model_table`` of the live table (the
   candidate counts of the first 2,048 topics) at the card's 3,350 GB/s
   beside the better warm pipelined pass: the modeled ceiling in topics/s
   and the measured fraction of it;
4e. the topic encode alone on phase 4's table: the 32,768 topics in batches
   of 16,384 through ``_encode_native`` and ``_encode_py``, each from a
   cold candidate cache and then warm; the tuples equal array for array
   (group ids as partitions of the batch); ms per 32,768 topics for each,
   beside phase 4's encode stage and topics/s;
4r. cfg5's retained side through ``PartitionedRetainedScanner``: every
   filter of the 512-filter mix in batches of 64 (kernels), equal to the
   same scanner with the plain twins on the card; a 64-filter sample with
   every broad filter equal to the ``RetainTree`` oracle; scans/s alone and
   interleaved with 1,024-topic publish batches on phase 4's router
   (``run_retained``'s pattern, 8 rounds), and publish topics/s there;
5. the same topics through a ``TorchRouter`` on legacy tiles
   (``RMQTT_PACKED=0``), equal to phase 4's results;
3d. the dense kernels, after phase 5 — ``dense_match_packed`` and
   ``dense_match_retained`` against their plain twins (``torch.equal``) on
   the whole dense tables of 4d (1,024 topics against the 1M filters' 2^20
   rows; the 64-filter batch against the 2^20 rows of cfg5's retained
   draws) and on ``bench/dense_cases.py``'s ``DENSE_CASES`` (B = 1 and 3,
   a capacity of 1,024, two blocks of topics, 200 topics unpadded, L = 9,
   20 and 40, padded topics and filters, ``$SYS`` rows and topics against
   ``+``/``#``-first filters, a bare ``#``, ``+/#``, blank levels);
   ``dense_match_words`` against its twin (word indices, bits and counts
   ``torch.equal``) on the forward bitmaps of ``WORDS_CASES`` (B = 1,
   padded topics, a topic that matches nothing, topics past K, W below
   ``max_words``) and of 4d's 16,384-topic words batch; the forward timed
   at B = 16,384 (its twin once, also held to the kernel there) and at the
   bitmap path's 1 and 8, the inverse at the 64-filter batch and at 1 and
   8 filters (each small shape of both held to its twin), the words kernel
   at the 16,384-topic batch beside its twin and ``torch.topk`` on the
   twin's keys, by CUDA events and graph replay (warm: the 1M-row tables
   fit the L2), beside the bounds, warm and cold; the small shapes also
   with the L2 flushed before each call, beside the device-memory bound;
4d. ``TorchRouter(backend="dense")`` over the same 1M filters
   (``RMQTT_HYBRID_MAX=0``): the 32,768 topics in batches of 16,384 (the
   words path; it prints how many overflowed to the bitmap path), 64
   batches of 1 and of 8 (the bitmap path), every topic's filters equal to
   phase 4's; 2,000 removes + 2,000 adds as one delta upload, then a
   2,048-topic sample equal to the router's native trie mirror, which took
   the same churn; the dense ``RetainedScanner`` over a ``FilterTable`` of
   cfg5's retained draws: the 512-filter mix in batches of 64, each
   filter's topics equal to 4r's (rows mapped to the same topic list);
   topics/s, scans/s and the three dense kernels' launches;
4s. the multi-device matchers over ``[cuda:0] x 2`` (one card standing in
   for two: the code path, not multi-card scaling): ``ShardedMatcher`` at
   fp = 2 on 4d's table, its assembled bitmap and counts equal to
   ``DenseMatcher``'s; ``ShardedPartitionedMatcher`` at dp = 2 on phase 4's
   table, fused, unfused and topk, the 32,768 topics equal to phase 4's
   matcher, the legacy words launches and the tails' (``compact_words``
   for topk) counted; a ``TorchRouter(mesh=...)``
   of 20,000 filters routing 4 batches of 512 equal to its native trie
   mirror; the same over every card when there is more than one;
4m. the matcher's hand-selected modes, after phase 4s, each a
   ``PartitionedMatcher`` built with its environment over phase 4's packed
   table or phase 5's legacy table: (a) the unfused global path
   (``RMQTT_FUSED=0``), (b) topk (``RMQTT_COMPACT=topk``), (c) fused on
   segments (``RMQTT_SEG_BYTES=2097152``: 4), (d) unfused on segments (4),
   (e) legacy on segments (``RMQTT_SEG_BYTES=8388608``: 3); each routes the
   32,768 topics in batches of 16,384 once (the NC split engages; the
   pass pays the full upload) and 64 batches of 1 and of 8, every
   topic equal to the reference router's matcher at the same table
   version, then takes 2,000 removes and 2,000 adds as one delta upload
   (into its segments) and routes the topics again, equal; it prints
   topics/s, the words-kernel launches and ``hbm_breakdown()``; then the
   topk mode's ``compact_words`` kernel against its twin (``torch.equal``
   over the wire) on phase 4's words of 16,384 topics at ``max_words`` 32
   and a regrow's 64 and of the broker's 1 and 8 topics, timed by CUDA
   events and graph replay beside its twin, ``torch.topk`` on the unique
   keys ``2W - idx`` / ``W - idx`` (its indices must equal the twin's) and
   its bound; the delta scatter of 64 chunks into a 2,048-chunk segment by
   CUDA events;
6. the broker: ``python -m rmqtt_tpu_torch.broker --router xla`` as a child
   process with ``RMQTT_HYBRID_MAX=0`` (every batch on the device), driven
   over TCP by the load client of ``bench/mqtt_load.py``. 6a: 64 subscriber
   connections subscribe the 1M filters (dealt round-robin, SUBSCRIBE
   packets of 1,000; to this broker and 6c's second one at once), 4
   publishers publish the first ``--wave`` (4,096) of
   the topics at QoS 0 with unique payloads; what the subscribers receive
   must equal, as a multiset of (client, topic, payload), what the port's
   ``DefaultRouter`` resolves for the same subscriptions, and
   ``/api/v1/stats`` must show every batch on the device, and
   ``/api/v1/device`` the matcher's profiler seams: the words kernel's
   first launch noted as a trace and later ones as hits, a full upload,
   one dispatch record per routing batch of the wave, a non-empty flight
   ring and the CUDA allocator's census; each broker's log gives the
   seconds its CUDA probe took at start. 6b:
   ``device.dispatch`` armed with ``times(4,error)`` over ``PUT
   /api/v1/failpoints``, a wave of 1,000 topics: deliveries still equal the
   oracle, the breaker opens, then closes with a full re-upload, and the
   next wave is served by the device. 6c: the round trip of 200 lone
   publishes, on this broker and on a second one started with the default
   hybrid (both hold the same 1M subscriptions). 6d: a third broker with
   ``[retain] tpu = true`` (default threshold 50,000): 8 connections publish
   60,000 retained messages (the first 60,000 cfg5 topics, unique
   payloads), then 64 subscribers each SUBSCRIBE one filter of the mix; the
   replay must equal, as a multiset, what ``RetainTree`` gives, through the
   retained kernels, with no message dropped. 6e: ``--workers 4 --fabric
   --router xla`` (``RMQTT_HYBRID_MAX=0``) carrying the subscriptions of
   the first 16 of 6a's 64 subscribers (250,000 filters) and 6a's wave,
   one publisher at least on another worker than the owner (one is
   reconnected until the kernel places it there), so publishes take the
   submit path: the deliveries equal the oracle, the owner (worker 1) matched
   every publish (none degraded to a worker's own table) with one
   words-kernel launch a routing batch, no worker died; it prints the
   subscribe time, deliveries/s, the owner's batches and topics a batch,
   each worker's CUDA probe and the owner's ``/api/v1/device``. 6f: a
   broker with ``[retain] tpu = true`` and ``[durability]`` on a sqlite
   store in the run's temp directory (compaction past 2,000,000 journal
   rows, so never within the phase; messages live an hour) takes 6d's
   60,000 retained messages,
   then 6e's 250,000 filters on 16 persistent MQTT 5 sessions (no retained
   replay), and is killed with SIGKILL; restarted on the same store with
   every batch on the device, it must recover 250,000 subscriptions,
   60,000 retained messages and 16 sessions, deliver a wave of the first
   ``RECOVERY_WAVE`` topics of 6a's exactly, one words-kernel launch a
   batch, and replay each session's retained filter exactly on the
   retained kernels; it prints the recovery, the restart to listening and
   the first publish after the restart (the full upload). 6f runs while
   6e's workers take their subscriptions (its times are taken beside that
   load); 6e's wave runs alone. 6g: the plugin broker, ``--router xla``
   (``RMQTT_HYBRID_MAX=0``, ``[retain] tpu = true``, messages live an
   hour) with the counter, retainer (sqlite), sys-topic, ACL, auth-http,
   web-hook, topic-rewrite, auto-subscription and shared-subscription
   plugins and the MQTT ingress and egress bridges to a ``--router trie``
   broker of the port; auth-http and the web hook (connect, subscribe and
   disconnect events) post to an HTTP server in this process. Beside 6a's
   subscribes it stores 6d's 60,000 retained messages, then takes the 1M
   filters on 64 MQTT 5 sessions (no retained replay) with sys-topic and
   the web hook unloaded over the plugin API (each acts once a filter:
   a ``$SYS`` publish routed on the card, an HTTP post), and loads them
   again. After 6a-c (their brokers stopped): a shared group of 4, an
   auto-subscribed inbox, a rewritten namespace, an ACL-denied publisher
   and filter (SUBACK 0x80), a refused user, 256 messages in through the
   ingress bridge and 256 out through the egress bridge, all equal to the
   oracle (``DefaultRouter`` for the 64 subscribers, ``match_filter`` for
   the plugin clients, one delivery per shared group); ``$SYS`` device/hbm
   with the allocator's census; then the first ``RECOVERY_WAVE`` topics of
   6a's wave, exact; every batch on the card; the counter plugin's counts
   and the web hook's events equal to the client side; the retainer
   persisted the 60,000 (and sys-topic's version). SIGTERM, then start B
   on the same configuration: the retainer loads the store into the
   card's retained table before the listeners open, and 16 subscribers of
   6d's mix (one broad) replay exactly against ``RetainTree`` on both
   retained kernels. 6h: ``bench/scenarios.py``'s
   ``run_profile("storm_churn_overload_kill")``, a ``--router xla`` broker
   (``RMQTT_HYBRID_MAX=0``, ``[routing] cache = false``) taking a connect
   storm of 60, subscribe churn (4 clients, 6 rounds), a 5,000-message QoS
   0 burst at a subscriber that never reads (judged once the broker has
   received all of it, one dispatch a publish) and a ``device.dispatch``
   failpoint kill (``times(6, error)``, 14 QoS 1 publishes through it) at
   once, within 150 s: the broker's SLO engine finds both objectives met,
   every phase passes, the kill fails over to the host trie and switches
   back to the device with every QoS 1 message delivered, and
   ``kernel.dispatch`` and the broker's words-kernel launches count more
   than 0 (its ``/api/v1/stats``, read just before the profile stops it);
7. one pipelined packed-tile pass under ``torch.profiler``: the device's
   busy share and its time by kernel;
8. the kernel summary line (launches on each main path, equality with the
   plain twins, times beside the bound). Each compaction tail must have
   launched on each of its paths (4, 5, 4s, 4m and the brokers 6a, 6e-6h,
   whose counts come from their ``/api/v1/stats``:
   ``routing_kernel_launches_fused_tail``).

Cut to fit the 1,200 s a run may take (PERF.md §4): 6a's and 6e's wave
to 4,096 of the cfg3 topics (``--wave``), 6f's wave after the restart to
2,048 (``RECOVERY_WAVE``), 6g's wave to the same, 4m to one pass before
its churn, 6e's and 6f's subscriptions to those of 16 of the 64
subscribers (``FABRIC_SUBSCRIBERS``: 250,000 filters). The 1M filters
elsewhere and the 60,000 retained messages are not cut.

The tables and the oracles are built before the phases that use them, and
the garbage collector is then frozen, as ``bench.py`` does for the same
tables. The last line is ``{"ok": true, "device": {...}}``. Sizes can be cut
with the options (for a quick look); the defaults are cfg3's and cfg5's.
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import contextlib
import gc
import json
import os
import random
import re
import signal
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

from rmqtt_tpu_torch.bench.dense_cases import (DENSE_CASES, WORDS_CASES, as_tensors,
                                               make_dense_case, make_words_case)
from rmqtt_tpu_torch.bench import scenarios as SC
from rmqtt_tpu_torch.bench import tail_kernels as TK
from rmqtt_tpu_torch.bench.mqtt_load import (LoadClient, connect_and_subscribe,
                                             expected_deliveries, oracle_router,
                                             publish_wave)
from rmqtt_tpu_torch.bench.words_cases import (EDGE_CASES, make_case,
                                               random_legacy_tiles,
                                               random_packed_tiles, random_topics)
from rmqtt_tpu_torch.bench.retained_cases import (RETAINED_CASES, TABLE_FILTERS,
                                                  make_retained_case, table_inputs,
                                                  table_topics)
from rmqtt_tpu_torch.bench.retained_kernels import RETAINED_BATCH, card_line, real_shapes
from rmqtt_tpu_torch.bench.roofline_model import (chunk_literals, dense_bound_ms,
                                                  dense_words_bound_ms, literal_levels,
                                                  model_table, retained_bound_ms,
                                                  words_bound_ms)
from rmqtt_tpu_torch.bench.timing import HBM_BYTES_PER_S, time_cold, time_cuda, time_graph
from rmqtt_tpu_torch.bench.workloads import (gen_mixed, gen_retained_topics,
                                             gen_topics_uniform, retained_sub_filters)
from rmqtt_tpu_torch.core.topic import match_filter, parse_shared, split_levels
from rmqtt_tpu_torch.core.trie import RetainTree, TopicTree
from rmqtt_tpu_torch.ops import compact_tail as CT
from rmqtt_tpu_torch.ops import match as DM
from rmqtt_tpu_torch.ops import match_words as MW
from rmqtt_tpu_torch.ops import retained_part as RP
from rmqtt_tpu_torch.ops._build import SOURCES, kernel_library
from rmqtt_tpu_torch.ops.encode import FilterTable, PackedLayout
from rmqtt_tpu_torch.ops import partitioned as PP
from rmqtt_tpu_torch.ops.partitioned import PartitionedMatcher, split_buckets
from rmqtt_tpu_torch.ops.retained import RetainedScanner
from rmqtt_tpu_torch.parallel import ShardedMatcher, ShardedPartitionedMatcher, make_mesh
from rmqtt_tpu_torch.router import Id, SubscriptionOptions, TorchRouter
from rmqtt_tpu_torch.runtime import NativeEncoder
from rmqtt_tpu_torch.utils.devfetch import fetch, set_fetch_timeout

SMALL_SET = 64  # tiles: 64 KB packed, 176 KB legacy int16 (an SM's L1 is 256 KB)
KERNEL_SOURCE = {
    "match_words_packed": "rmqtt_tpu_torch/csrc/match_words.cu",
    "match_words_legacy": "rmqtt_tpu_torch/csrc/match_words.cu",
    "retained_scan_gather": "rmqtt_tpu_torch/csrc/retained_scan.cu",
    "retained_scan_full": "rmqtt_tpu_torch/csrc/retained_scan.cu",
    "dense_match_packed": "rmqtt_tpu_torch/csrc/dense_match.cu",
    "dense_match_retained": "rmqtt_tpu_torch/csrc/dense_match.cu",
    "dense_match_words": "rmqtt_tpu_torch/csrc/dense_match.cu",
    "fused_compact_decode": "rmqtt_tpu_torch/csrc/compact_tail.cu",
    "compact_global": "rmqtt_tpu_torch/csrc/compact_tail.cu",
    "compact_words": "rmqtt_tpu_torch/csrc/dense_match.cu",
}
REPLACES = {
    "match_words_packed": "rmqtt_tpu/ops/pallas_match.py:288",
    "match_words_legacy": "rmqtt_tpu/ops/pallas_match.py:141",
    "retained_scan_gather": "rmqtt_tpu/ops/retained_part.py:181",
    "retained_scan_full": "rmqtt_tpu/ops/retained_part.py:234",
    "dense_match_packed": "rmqtt_tpu/ops/match.py:82",
    "dense_match_retained": "rmqtt_tpu/ops/match.py:176",
    "dense_match_words": "rmqtt_tpu/ops/match.py:151",
    "fused_compact_decode": "rmqtt_tpu/ops/partitioned.py:1356",
    "compact_global": "rmqtt_tpu/ops/partitioned.py:1251",
    "compact_words": "rmqtt_tpu/ops/partitioned.py:1492",
}
#: the compaction tails' wrappers, their launches counted by path
TAILS = (CT.fused_compact_decode, CT.compact_global, CT.compact_words)


def log(msg: str) -> None:
    print(msg, flush=True)


# ----------------------------------------------------------------- timing
class GcTime:
    """Wall time the cyclic garbage collector spends and the full
    (generation 2) collections it runs, from ``gc.callbacks`` (registered
    by :meth:`install`, in ``main``)."""

    def __init__(self) -> None:
        self.ns = 0
        self.full = 0
        self._t0 = 0

    def install(self) -> None:
        gc.callbacks.append(self._callback)

    def _callback(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter_ns()
        else:
            self.ns += time.perf_counter_ns() - self._t0
            self.full += info["generation"] == 2


GC_TIME = GcTime()


PHASE_S: dict = {}  # wall seconds of each phase, printed at the end


def timed(name: str, fn, *args):
    """``fn(*args)``, its wall time kept in :data:`PHASE_S` under ``name``."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        PHASE_S[name] = time.perf_counter() - t0


# ------------------------------------------------------------ phase 1, 2
def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    log(f"[1] device: {name}, {torch.cuda.device_count()} visible; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    log(card_line())
    return {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = kernel_library()
    log(f"[2] build: {' + '.join(p.name for p in SOURCES)} -> {lib.path.name} in "
        f"{lib.build_s:.2f}s "
        f"(load {time.perf_counter() - t0:.2f}s)")
    for line in lib.log.splitlines():
        if any(k in line for k in ("registers", "spill", "smem", "stack frame",
                                   "Compiling entry")):
            log("    " + line.strip())


# ---------------------------------------------------------------- phase 3
def _put(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)


def _compare(name: str, kernel, plain, args, stats: dict, bad=None) -> None:
    """Kernel words against the plain twin's. ``bad``: a ``[B, NC]`` mask of
    out-of-range ids, whose words must be zero; ``args`` is then a pair
    (the kernel's arguments, the twin's), the twin's ids with the bad ones
    set to 0, since the twin indexes the tiles with them."""
    kargs, pargs = args if bad is not None else (args, args)
    got = kernel(*kargs)
    want = plain(*pargs)
    if bad is not None:
        badw = torch.from_numpy(np.repeat(bad, MW.WORDS_PER_CHUNK, axis=1)).to(got.device)
        want = torch.where(badw, torch.zeros_like(want), want)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if got.numel() else 0
    stats["max_abs_err"] = max(stats.get("max_abs_err", 0), err)
    stats["cases"] = stats.get("cases", 0) + 1
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel words differ from the plain twin "
                             f"(max abs err {err})")
    log(f"    {name}: equal, {int((got != 0).sum())} nonzero words of "
        f"{got.numel()}" + (f", {int(bad.sum())} out-of-range slots zero"
                            if bad is not None else ""))


def _kernel_pair(layout):
    if layout is not None:
        return (lambda *a: MW.match_words_packed(*a, layout=layout),
                lambda *a: MW.match_words_packed_plain(*a, layout=layout))
    return MW.match_words_legacy, MW.match_words_legacy_plain


def _time_real(name: str, matcher, real, kern, plain, s: dict, dev) -> None:
    """Times on the real table at cfg3's shapes: the kernel, its twin, the
    bounds; the kernel at the NC split's bucket shapes for this batch (what
    one router batch launches) and with the real ids folded onto
    ``SMALL_SET`` tiles (the same integer work, with tile reads that the
    L1 caches serve)."""
    tiles, ttok, tlen, tdollar, cids = real
    s["ms"] = time_cuda(lambda: kern(*real), reps=50)
    s["graph_ms"] = time_graph(lambda: kern(*real), reps=10)
    s["plain_ms"] = time_cuda(lambda: plain(*real), reps=3, warmup=1)
    s["bound_ms"], s["bound_by"], s["bound_term"] = words_bound_ms(
        tiles, ttok, cids, chunk_literals(matcher.table))
    b = cids.shape[0]
    np_in = [a.cpu().numpy() for a in (ttok, tlen, tdollar, cids)]
    split = matcher._split_plan(np_in[3], b)
    buckets = [] if split is None else split_buckets(*np_in, split)
    s["bucket_ms"] = []
    for arrs, (nb, pb, tier) in buckets:
        args = (tiles, *(_put(a, dev) for a in arrs))
        _compare(f"{name} bucket {nb} topics (B={pb}) NC={tier}", kern, plain, args, s)
        s["bucket_ms"].append((pb, tier, time_graph(lambda: kern(*args), reps=10)))
    small = torch.where(cids != 0, cids % SMALL_SET + 1, cids).contiguous()
    s["small_set_ms"] = time_cuda(lambda: kern(tiles, ttok, tlen, tdollar, small),
                                  reps=50)
    log(f"    {name}: {s['ms']:.4f} ms at B={b} NC={cids.shape[1]} ({s['graph_ms']:.4f} "
        f"ms by graph replay); NC-split "
        f"buckets by graph replay {[(pb, tier, round(ms, 4)) for pb, tier, ms in s['bucket_ms']]} "
        f"sum {sum(ms for *_, ms in s['bucket_ms']):.4f} ms per batch; real ids "
        f"folded onto {SMALL_SET} tiles {s['small_set_ms']:.4f} ms")


def phase_kernels(packed_router: TorchRouter, legacy_router: TorchRouter,
                  topics, batch: int, dev) -> dict:
    """Each kernel against its plain twin; timings at cfg3's shapes on the
    real table."""
    log("[3] kernels against their plain twins")
    rng = np.random.default_rng(3)
    stats = {"match_words_packed": {}, "match_words_legacy": {}}

    # --- packed, real cfg3 table
    pm = packed_router.matcher
    st = pm._refresh()
    t = packed_router.table
    ttok, tlen, tdollar, cids, nc = t.encode_topics(topics[:batch], pad_batch_to=batch)
    lay, tt = t.translate_packed(ttok)
    assert lay == st.layout, (lay, st.layout)
    real_p = (st.tiles, *(_put(a, dev) for a in (tt, tlen, tdollar, cids)))
    log(f"    real packed table: tiles {tuple(st.tiles.shape)} layout "
        f"{lay.widths}, B={batch} NC={nc}, {int((cids != 0).sum())} real slots")
    sp = stats["match_words_packed"]
    kern_p, plain_p = _kernel_pair(lay)
    _compare("packed real B=%d NC=%d" % (batch, nc), kern_p, plain_p, real_p, sp)
    # a 2-byte level on the real table: topics whose level-5 tokens use
    # the high byte (local ids >= 256)
    hi = tt.copy()
    hi[:, -1] = rng.integers(256, 400, len(hi))
    _compare("packed real, 2-byte level ids",
             kern_p, plain_p, (st.tiles, _put(hi, dev), *real_p[2:]), sp)
    _time_real("packed real", pm, real_p, kern_p, plain_p, sp, dev)
    # packed, random tiles incl. a 2-byte level; edge shapes
    for widths, b, nck in (((1, 1, 1, 1, 1, 2), batch, nc), ((2, 1, 2), 1023, 1),
                           ((1,), 7, 5), ((1, 2, 1, 1, 1, 1, 1, 1), 4097, 3)):
        layr = PackedLayout(widths)
        tiles = torch.from_numpy(random_packed_tiles(rng, layr, 512)).to(dev)
        tops = random_topics(rng, b, layr.nlvl)
        args = (tiles, *(_put(a, dev) for a in tops),
                _put(rng.integers(0, 512, (b, nck)), dev))  # includes chunk 0
        _compare(f"packed random widths={widths} B={b} NC={nck}",
                 *_kernel_pair(layr), args, sp)

    # --- legacy, real cfg3 table (int16) and as int32
    lm = legacy_router.matcher
    lst = lm._refresh()
    lt = legacy_router.table
    ltok, ltlen, ltd, lcids, lnc = lt.encode_topics(topics[:batch], pad_batch_to=batch)
    real_l = (lst.tiles, *(_put(a, dev) for a in (ltok, ltlen, ltd, lcids)))
    log(f"    real legacy table: tiles {tuple(lst.tiles.shape)} {lst.tiles.dtype}")
    sl = stats["match_words_legacy"]
    kern_l, plain_l = _kernel_pair(None)
    _compare(f"legacy real {lst.tiles.dtype} B={batch} NC={lnc}", kern_l, plain_l,
             real_l, sl)
    _compare("legacy real as int32", kern_l, plain_l,
             (lst.tiles.to(torch.int32).contiguous(), *real_l[1:]), sl)
    _time_real("legacy real", lm, real_l, kern_l, plain_l, sl, dev)
    for dtype, b, nck in ((np.int16, batch, nc), (np.int32, batch, nc),
                          (np.int16, 1023, 1), (np.int32, 9, 4)):
        tiles = torch.from_numpy(random_legacy_tiles(rng, 8, 512, dtype)).to(dev)
        args = (tiles, *(_put(a, dev) for a in random_topics(rng, b, 8)),
                _put(rng.integers(0, 512, (b, nck)), dev))
        _compare(f"legacy random {np.dtype(dtype).name} B={b} NC={nck}",
                 kern_l, plain_l, args, sl)

    # --- edge cases: chunk 0 front / mid / repeated, repeated ids, NC > 32,
    # tiny B, out-of-range ids, every packed group count and legacy L range
    for case in EDGE_CASES:
        tiles, ttok_, tlen_, td_, ids, layc, bad, pids = make_case(case)
        tiles = torch.from_numpy(tiles).to(dev)
        tops = [_put(a, dev) for a in (ttok_, tlen_, td_)]
        args = (tiles, *tops, _put(ids, dev))
        if bad is not None:
            args = (args, (tiles, *tops, _put(pids, dev)))
        s = stats["match_words_packed" if layc is not None else "match_words_legacy"]
        _compare(case.name, *_kernel_pair(layc), args, s, bad)
    for name, s in stats.items():
        log(f"    {name}: {s['ms']:.4f} ms (plain {s['plain_ms']:.3f} ms, bound "
            f"{s['bound_ms']:.4f} ms by {s['bound_by']} ({s['bound_term']})) over "
            f"{s['cases']} equal cases")
    return stats


def phase_tail_kernels(router: TorchRouter, topics, batch: int) -> dict:
    """3t: both compaction-tail kernels against their plain twins
    (``torch.equal`` over the whole wire) on ``CARD_CASES`` and on phase 4's
    table (``bench/tail_kernels.py``): cfg3's words with the matcher's
    budget and with half of it, the NC split's buckets, the broker's 1, 2
    and 4 topics; timed by CUDA events and graph replay beside the twins
    and the bounds."""
    log("[3t] the compaction-tail kernels against their plain twins")
    card = card_line()
    stats = TK.run(router.matcher, topics, batch, log=log)
    for name, s in stats.items():
        log(f"    {name}: {s['ms']:.4f} ms ({s['graph_ms']:.4f} by graph replay) at "
            f"{s['shape']}, budget {s['budget']} (plain {s['plain_ms']:.3f} ms, "
            f"{s['plain_graph_ms']} by graph replay; bound {s['bound_ms']:.5f} ms by "
            f"{s['bound_by']}); the NC split's buckets "
            f"{s['bucket_graph_ms_per_batch']:.4f} ms a batch by graph replay; "
            f"{s['cases']} equal cases; device operations a call by shape "
            f"{ {k: r['ops']['kernels'] + r['ops']['memsets'] for k, r in s['shapes'].items()} }; "
            f"{card}")
    return stats


# ---------------------------------------------------------- phase 3r, 4r
RETAINED_ROUNDS = 8  # run_retained's rounds
PUBLISH_BATCH = 1024  # run_retained's publish batch
RETAINED_PAIRS = {
    "gather": (RP.retained_scan_gather, RP.retained_scan_words_plain),
    "full": (RP.retained_scan_full, RP.retained_scan_full_plain),
}


def _retained_args(tiles, arrs, dev):
    """One tier's arguments on ``dev``: the tiles (numpy or already there)
    and its numpy inputs."""
    t = tiles if isinstance(tiles, torch.Tensor) else torch.from_numpy(tiles).to(dev)
    return (t, *(_put(a, dev) for a in arrs))


def phase_retained_kernels(scanner, filters, dev) -> dict:
    """Both retained kernels against their plain twins; timings at the
    scanner's real shapes on the 1M-topic table (its 64-filter batch in
    each kernel's stats, the broker's one-filter scans under
    ``"one_filter"``): ``graph_ms`` by CUDA-graph replay, the kernel's time
    on the card; ``ms`` per call through the wrapper by CUDA events. A
    kernel's ``cases`` and ``max_abs_err`` count every check of it: both
    shapes, the cases and the tables."""
    log("[3r] retained kernels against their plain twins")
    stats = {"retained_scan_gather": {}, "retained_scan_full": {}}
    st, shapes = real_shapes(scanner, filters)
    for label, mode, arrs, shape in shapes:
        name = f"retained_scan_{mode}"
        s = stats[name] if label == "batch" else stats[name].setdefault(label, {})
        kern, plain = RETAINED_PAIRS[mode]
        args = _retained_args(st.rows, arrs, dev)
        _compare(f"{name} real 1M table, {label}: {shape}", kern, plain, args,
                 stats[name])
        s["ms"] = time_cuda(lambda: kern(*args), reps=50)
        s["graph_ms"] = time_graph(lambda: kern(*args), reps=20)
        s["plain_ms"] = time_cuda(lambda: plain(*args), reps=3, warmup=1)
        s["bound_ms"], s["bound_by"], s["bound_term"] = retained_bound_ms(
            st.rows, args[1:6], args[6] if mode == "gather" else None)
        s["shape"] = shape
        log(f"    {name} {label}: {s['graph_ms']:.5f} ms by graph replay at {shape}, "
            f"{s['ms']:.4f} ms per call through the wrapper, plain {s['plain_ms']:.3f} ms, "
            f"bound {s['bound_ms']:.5f} ms by {s['bound_by']} ({s['bound_term']})")
    for case in RETAINED_CASES:
        tiles, fields, ids, bad, pids = make_retained_case(case)
        kern, plain = RETAINED_PAIRS[case.tier]
        if case.tier == "full":
            args = _retained_args(tiles, fields, dev)
        else:
            args = _retained_args(tiles, (*fields, ids), dev)
            if bad is not None:
                args = (args, (*args[:6], _put(pids, dev)))
        _compare(f"retained {case.name}", kern, plain, args,
                 stats[f"retained_scan_{case.tier}"], bad)
    # tables of real topics: $SYS rows, a bare '#', '+/#', deep filters;
    # then a vocabulary past 0x7FFF (int32 tiles)
    rng = np.random.default_rng(4)
    for kind in ("dollar", "wide"):
        table = RP.RetainedTable()
        for t in table_topics(kind, rng):
            table.add(t)
        cpu = RP.PartitionedRetainedScanner(table, device="cpu")
        for nc in (None, 33, 1):
            tiles, gather, full = table_inputs(cpu, TABLE_FILTERS, nc)
            tiles_d = torch.from_numpy(tiles).to(dev)
            for mode, arrs in (("gather", gather), ("full", full)):
                if mode == "full" and nc is not None:
                    continue
                _compare(f"retained {mode} table '{kind}' {tiles.dtype} "
                         f"B={arrs[0].shape[0]}" + (f" NC={arrs[5].shape[1]}"
                                                    if mode == "gather" else ""),
                         *RETAINED_PAIRS[mode], _retained_args(tiles_d, arrs, dev),
                         stats[f"retained_scan_{mode}"])
    for name, s in stats.items():
        log(f"    {name}: {s['cases']} equal cases")
    return stats


def build_retained(topics, dev):
    """The 1M-draw retained table (fids in draw order), its scanner on the
    card and the ``RetainTree`` oracle (value = fid)."""
    t0 = time.perf_counter()
    table = RP.RetainedTable()
    for t in topics:
        table.add(t)
    t1 = time.perf_counter()
    scanner = RP.PartitionedRetainedScanner(table, device=dev)
    scanner._refresh()
    t2 = time.perf_counter()
    tree = RetainTree()
    for fid, t in enumerate(topics):
        tree.insert(t, fid)
    log(f"    retained table: {len(topics)} topics, {table.nchunks} chunks (tiles "
        f"{tuple(scanner._dev.rows.shape)} {scanner._dev.rows.dtype}), built in "
        f"{t1 - t0:.2f}s, compacted + uploaded in {t2 - t1:.2f}s; RetainTree "
        f"oracle in {time.perf_counter() - t2:.2f}s")
    return table, scanner, tree


def _scan_all(scanner, filters):
    """Every filter, in batches of 64 → (results, per-batch (submit ms,
    complete ms, matched fids))."""
    out, times = [], []
    for lo in range(0, len(filters), RETAINED_BATCH):
        t0 = time.perf_counter()
        h = scanner.scan_submit(filters[lo:lo + RETAINED_BATCH])
        t1 = time.perf_counter()
        res = scanner.scan_complete(h)
        times.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3,
                      sum(len(r) for r in res)))
        out.extend(res)
    return out, times


def phase_retained_scanner(table, scanner, tree, filters, router, pub_topics) -> dict:
    """→ the numbers of cfg5's retained side (``launches``: each retained
    kernel's launches over the kernel-path passes, counted from zero)."""
    log("[4r] cfg5's retained side through PartitionedRetainedScanner")
    out: dict = {}
    RP.retained_scan_gather.launches = 0
    RP.retained_scan_full.launches = 0
    kern_res, times = _scan_all(scanner, filters)
    log(f"    all {len(filters)} filters in batches of {RETAINED_BATCH}: per batch "
        f"submit / complete ms and matched fids "
        f"{[(round(a, 3), round(b, 3), n) for a, b, n in times]}")
    # run_retained's interleave against phase 4's resident cfg3 router
    m = router.matcher
    sb, pb = RETAINED_BATCH, PUBLISH_BATCH

    def scan_slice(r):
        lo = (r * sb) % (len(filters) - sb)
        return filters[lo:lo + sb]

    scanner.scan(filters[:sb])
    m.match(pub_topics[:pb])  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in range(RETAINED_ROUNDS):
        ph = m.match_submit(pub_topics[r * pb:(r + 1) * pb])
        sh = scanner.scan_submit(scan_slice(r))
        m.match_complete(ph)
        scanner.scan_complete(sh)
    total = time.perf_counter() - t0
    t1 = time.perf_counter()
    split = []
    for r in range(RETAINED_ROUNDS):
        ta = time.perf_counter()
        h = scanner.scan_submit(scan_slice(r))
        tb = time.perf_counter()
        scanner.scan_complete(h)
        split.append(((tb - ta) * 1e3, (time.perf_counter() - tb) * 1e3))
    scan_only = time.perf_counter() - t1
    out["launches"] = {"retained_scan_gather": RP.retained_scan_gather.launches,
                       "retained_scan_full": RP.retained_scan_full.launches}
    out["results"] = kern_res  # each filter's fids, for 4d's dense scanner
    out.update(publish_topics_per_s=RETAINED_ROUNDS * pb / total,
               scans_per_s_interleaved=RETAINED_ROUNDS * sb / total,
               scans_per_s_alone=RETAINED_ROUNDS * sb / scan_only)
    log(f"    {card_line()}: interleaved ({RETAINED_ROUNDS} rounds of {pb} publish "
        f"topics + {sb} filters) {total * 1e3:.3f} ms: "
        f"{out['scans_per_s_interleaved']:.1f} scans/s, "
        f"{out['publish_topics_per_s']:.1f} publish topics/s; scan only "
        f"{scan_only * 1e3:.3f} ms: {out['scans_per_s_alone']:.1f} scans/s "
        f"(per batch submit / complete ms "
        f"{[(round(a, 3), round(b, 3)) for a, b in split]}); launches {out['launches']}")
    # the same scanner with the plain twins on the card
    scanner.use_kernel = False
    try:
        plain_res, _ = _scan_all(scanner, filters)
    finally:
        scanner.use_kernel = True
    for f, a, b in zip(filters, kern_res, plain_res):
        if not np.array_equal(a, b):
            raise AssertionError(f"retained kernel path vs plain path differ on "
                                 f"{f!r}: {len(a)} vs {len(b)} fids")
    log(f"    all {len(set(filters))} distinct filters equal to the plain-twin path "
        f"on the card ({sum(len(r) for r in kern_res)} fids)")
    # a 64-filter sample holding every broad filter of the mix, against the
    # RetainTree oracle
    broad_floor = max(16, int(table.nchunks * scanner.BROAD_FRAC))
    distinct = list(dict.fromkeys(filters))
    res_of = dict(zip(filters, kern_res))
    broad = [f for f in distinct if len(table.candidates_for_filter(f)) > broad_floor]
    narrow = [f for f in distinct if f not in broad]
    if len(broad) < 4:
        raise AssertionError(f"the mix has {len(broad)} broad filters, want >= 4")
    sample = (broad + narrow)[:RETAINED_BATCH]
    t0 = time.perf_counter()
    for f in sample:
        want = np.sort(np.fromiter((fid for _lv, fid in tree.matches(f)), dtype=np.int64))
        if not np.array_equal(res_of[f], want):
            raise AssertionError(f"retained scan of {f!r}: {len(res_of[f])} fids, "
                                 f"RetainTree {len(want)}")
    log(f"    sample of {len(sample)} filters ({len(broad)} broad: {broad[:6]}...) equal to "
        f"the RetainTree oracle ({sum(len(res_of[f]) for f in sample)} fids; oracle "
        f"{time.perf_counter() - t0:.2f}s)")
    return out


# ------------------------------------------------------------- phase 4, 5
@contextlib.contextmanager
def environment(env: dict):
    """``env`` set in ``os.environ`` inside the block, restored after."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def build_router(filters, device, packed: bool) -> TorchRouter:
    """A router with every batch on the device (``RMQTT_HYBRID_MAX=0``)."""
    with environment({"RMQTT_PACKED": "1" if packed else "0",
                      "RMQTT_HYBRID_MAX": "0"}):
        router = TorchRouter(device=device)
    opts = SubscriptionOptions()
    t0 = time.perf_counter()
    for i, f in enumerate(filters):
        router.add(f, Id(1, f"c{i}"), opts)
    router.table.compact()  # the steady layout; no background rebuild mid-run
    router.matcher._refresh()
    log(f"    table ({'packed' if packed else 'legacy'}): {len(filters)} filters, "
        f"{router.table.nchunks} chunks, built + compacted + uploaded in "
        f"{time.perf_counter() - t0:.2f}s; uploaded {router.matcher.upload_bytes} B; "
        f"{router.matcher.hbm_breakdown()}")
    return router


def _routed_filters(raw) -> list:
    """The matched filters of one routed topic, from its relations (each
    filter of this workload has one subscriber and no $share group)."""
    out, shared = raw
    return sorted([r.topic_filter for rels in out.values() for r in rels]
                  + [tf for _group, tf in shared])


def route_all(router: TorchRouter, topics, batch: int, depth: int,
              matcher_only: bool = False):
    """Route ``topics`` in ``batch``-sized batches through the router's
    entry points ``submit_batch_raw`` / ``complete_batch_raw`` (matching
    plus the relations expand), keeping up to ``depth`` batches in flight.
    ``matcher_only`` times the matcher's ``match_submit`` /
    ``match_complete`` instead, without the expand. → (per-topic results:
    matched filter lists, or fid arrays when ``matcher_only``; seconds;
    per-batch ms; the garbage collector's time and full collections)."""
    m = router.matcher
    if matcher_only:
        batches = [topics[i:i + batch] for i in range(0, len(topics), batch)]
        submit, complete = m.match_submit, m.match_complete
    else:
        batches = [[(None, t) for t in topics[i:i + batch]]
                   for i in range(0, len(topics), batch)]
        submit = lambda items: router.submit_batch_raw(items)[1]  # noqa: E731
        complete = router.complete_batch_raw
    out, inflight, per_batch = [], [], []
    if m.device.type == "cuda":
        torch.cuda.synchronize(m.device)
    gc0, full0 = GC_TIME.ns, GC_TIME.full
    t0 = time.perf_counter()
    for bt in batches:
        inflight.append((time.perf_counter(), submit(bt)))
        if len(inflight) >= depth:
            ts, h = inflight.pop(0)
            out.extend(complete(h))
            per_batch.append((time.perf_counter() - ts) * 1e3)
    for ts, h in inflight:
        out.extend(complete(h))
        per_batch.append((time.perf_counter() - ts) * 1e3)
    if m.device.type == "cuda":
        torch.cuda.synchronize(m.device)
    secs = time.perf_counter() - t0
    gc_note = (f"gc {(GC_TIME.ns - gc0) / 1e6:.3f} ms, "
               f"{GC_TIME.full - full0} full collections")
    if not matcher_only:
        out = [_routed_filters(raw) for raw in out]
    return out, secs, per_batch, gc_note


def _log_pass(what: str, n: int, secs: float, per_batch, gc_note: str) -> None:
    log(f"    {what}: {n} topics in {secs * 1e3:.3f} ms = {n / secs:.1f} topics/s; "
        f"per-batch ms {[round(x, 3) for x in per_batch]}; {gc_note}")


def profile_device(fn):
    """Run ``fn`` under ``torch.profiler`` → (device busy share of the wall
    time, wall s, [(name, device ms, count)] by device time). The profiler
    adds host overhead, so the busy share it gives is a lower bound."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us:
            rows.append((e.key, us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    return busy_ms / 1e3 / wall, wall, rows


def check_oracle(tree: TopicTree, topics, got, what: str) -> None:
    for topic, g in zip(topics, got):
        want = sorted(v for _lv, vs in tree.matches(topic) for v in vs)
        if g != want:
            raise AssertionError(f"{what}: {topic!r} routed {g[:8]}... expected "
                                 f"{want[:8]}... ({len(g)} vs {len(want)})")
    log(f"    {what}: {len(topics)} topics equal to the TopicTree oracle "
        f"({sum(len(g) for g in got)} routes)")


def phase_cfg3(router: TorchRouter, tree: TopicTree, filters, topics, batch: int,
               sample: int, churn: int, seed: int):
    """→ (the per-topic matched filter lists, as routed before the churn;
    the pass numbers 4e prints: warm topics/s, guarded topics/s, the
    serial split's encode ms)."""
    log("[4] cfg3 end to end through TorchRouter (packed tiles)")
    m = router.matcher
    n = len(topics)
    # each pass's results are checked and dropped before the next pass: a
    # broker keeps no results across batches, and every retained result
    # is heap the garbage collector's full collections rescan
    kernel_filters, *timing = route_all(router, topics, batch, 2)
    _log_pass("cold pass (empty candidate cache), pipelined depth 2", n, *timing)
    if not isinstance(router.table._nenc, NativeEncoder):
        raise AssertionError("the table encodes in Python: the native topic "
                             "encoder (runtime/encode.cc, g++) did not load")
    log(f"    encoder: {type(router.table._nenc).__name__} (runtime/encode.cc)")
    nums = {"pipelined": [], "serial": []}
    for depth in (2, 2, 1, 1):
        rows, *timing = route_all(router, topics, batch, depth)
        _log_pass("pipelined depth 2" if depth == 2 else "serial", n, *timing)
        nums["pipelined" if depth == 2 else "serial"].append(n / timing[0])
        same = rows == kernel_filters
        del rows
        if not same:
            raise AssertionError("repeated passes routed differently")
    nums["guarded"] = []
    set_fetch_timeout(60)
    try:
        for _ in range(2):
            rows, *timing = route_all(router, topics, batch, 2)
            _log_pass("pipelined depth 2 with the fetch guard "
                      "(set_fetch_timeout(60))", n, *timing)
            nums["guarded"].append(n / timing[0])
            same = rows == kernel_filters
            del rows
            if not same:
                raise AssertionError("the guarded pass routed differently")
    finally:
        set_fetch_timeout(None)
    log(f"    {sum(len(r) for r in kernel_filters)} routes per pass")
    # the device-memory model of this table against the better warm
    # pipelined pass, at the card's memory rate (bench.py's sample: the
    # candidate counts of the first 2,048 topics)
    ncs = [len(router.table._candidates_for(split_levels(t))) for t in topics[:2048]]
    nums["roofline"] = model_table(router.table, ncs,
                                   measured_topics_per_sec=max(nums["pipelined"]))
    model = nums["roofline"]
    log(f"    roofline model (bench/roofline_model.py) at {model['hbm_gbps']:.0f} GB/s: "
        f"ceiling {model['ceiling_topics_per_sec']} topics/s, measured "
        f"{model['measured_topics_per_sec']} topics/s = "
        f"{model['measured_topics_per_sec'] / model['ceiling_topics_per_sec']:.3e} of it; "
        f"{json.dumps(model, sort_keys=True)}")
    for depth in (2, 1):
        rows, *timing = route_all(router, topics, batch, depth, matcher_only=True)
        del rows
        _log_pass(f"matcher only (no relations expand), "
                  f"{'pipelined depth 2' if depth == 2 else 'serial'}", n, *timing)
    n0 = MW.match_words_packed.launches
    m.match(topics[:batch])
    log(f"    launches for one batch of {batch}: "
        f"{MW.match_words_packed.launches - n0} (one per NC-split bucket)")
    m.stage_timing = True
    m.stage_ns = dict.fromkeys(m.stage_ns, 0)
    rows, secs, _, gc_note = route_all(router, topics, batch, 1)
    del rows
    m.stage_timing = False
    nums["encode_ms"] = m.stage_ns["encode"] / 1e6
    expand = secs * 1e9 - sum(m.stage_ns.values())
    log(f"    stage split (serial pass, {secs * 1e3:.3f} ms): "
        + ", ".join(f"{k} {v / 1e6:.3f} ms" for k, v in m.stage_ns.items())
        + f", expand + rest {expand / 1e6:.3f} ms ({gc_note})")

    # every topic: the same router path with the plain words twin on the card
    m.use_kernel = False
    try:
        plain_filters, *_ = route_all(router, topics, batch, 1)
    finally:
        m.use_kernel = True
    for i, (a, b) in enumerate(zip(kernel_filters, plain_filters)):
        if a != b:
            raise AssertionError(f"kernel path vs plain path differ at topic "
                                 f"{i} {topics[i]!r}: {a[:4]} vs {b[:4]}")
    del plain_filters
    log(f"    all {n} topics equal to the plain-words path on the card")

    rng = random.Random(seed)
    idx = sorted(rng.sample(range(n), min(sample, n)))
    sample_topics = [topics[i] for i in idx]
    check_oracle(tree, sample_topics, [kernel_filters[i] for i in idx], "sample")

    # churn: removes + adds in rounds, each followed by a re-match of the
    # sample (a broker interleaves mutations with publishes; each round's
    # dirty chunks go up as one delta upload)
    d0, f0 = m.delta_uploads, m.full_uploads
    live = {f: i for i, f in enumerate(filters)}
    gone = rng.sample(filters, min(churn, len(filters)))
    fresh = [f for f in gen_mixed(random.Random(seed + 1), 2 * churn)
             if f not in live][:len(gone)]
    opts = SubscriptionOptions()
    rounds = 4
    for r in range(rounds):
        for f in gone[r::rounds]:
            router.remove(f, Id(1, f"c{live.pop(f)}"))
            tree.remove(f, f)
        for j in range(r, len(fresh), rounds):
            router.add(fresh[j], Id(1, f"n{j}"), opts)
            tree.insert(fresh[j], fresh[j])
        got = [_routed_filters(raw) for raw in
               router.matches_batch_raw([(None, t) for t in sample_topics])]
        check_oracle(tree, sample_topics, got, f"after churn round {r + 1}")
    if m.delta_uploads <= d0:
        raise AssertionError(f"churn did not delta-upload ({m.delta_uploads} <= {d0})")
    log(f"    churn: -{len(gone)} +{len(fresh)} filters in {rounds} rounds, delta "
        f"uploads {d0} -> {m.delta_uploads}, full uploads {f0} -> {m.full_uploads}")
    return kernel_filters, nums


def _same_encode(got, want) -> bool:
    """Two encode tuples equal array for array (dtypes too), group ids
    compared as partitions of the batch (padded rows 0 on both sides)."""
    if got[4] != want[4] or any(g.dtype != w.dtype or not np.array_equal(g, w)
                                for g, w in zip(got[:4], want[:4])):
        return False
    pairs = set(zip(got[5].tolist(), want[5].tolist()))
    return (len({a for a, _ in pairs}) == len({b for _, b in pairs}) == len(pairs)
            and all((a == 0) == (b == 0) for a, b in pairs))


def phase_encode(router: TorchRouter, topics, batch: int, nums: dict) -> dict:
    """4e → ms per 32,768 topics of each encoder, cold and warm."""
    log("[4e] the topic encode on phase 4's table: native against Python")
    t = router.table
    batches = [topics[i:i + batch] for i in range(0, len(topics), batch)]
    scale = 32_768 / len(topics)

    def cold() -> None:
        t._cand_cache.clear()
        t._cand_keys_of.clear()
        t._nenc.cache_clear()
        t._nenc_entries = 0

    out, encs = {}, {}
    with t._mu:  # as encode_topics_versioned holds it
        for name, fn in (("native", t._encode_native), ("python", t._encode_py)):
            cold()
            for state in ("cold", "warm"):
                t0 = time.perf_counter()
                encs[name, state] = [fn(bt, batch, True) for bt in batches]
                out[f"{name}_{state}_ms"] = (time.perf_counter() - t0) * 1e3 * scale
        cold()  # both caches cold and consistent for the phases after
    want = encs["python", "cold"]
    for key, got in encs.items():
        if not all(_same_encode(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"4e: the {key[0]} encode ({key[1]}) differs "
                                 "from the cold Python encode")
    del encs, want
    log(f"    {len(topics)} topics in {len(batches)} batches of {batch}: tuples "
        "equal array for array (groups as partitions), native and Python, cold "
        "and warm")
    log(f"    ms per 32,768 topics: native cold {out['native_cold_ms']:.3f}, warm "
        f"{out['native_warm_ms']:.3f}; Python cold {out['python_cold_ms']:.3f}, "
        f"warm {out['python_warm_ms']:.3f}")
    log(f"    phase 4 (native encode): encode stage {nums['encode_ms']:.3f} ms in "
        f"the serial split pass; warm topics/s pipelined "
        f"{[round(x, 1) for x in nums['pipelined']]}, serial "
        f"{[round(x, 1) for x in nums['serial']]}, pipelined with the fetch guard "
        f"{[round(x, 1) for x in nums['guarded']]} (the Python encode's warm range in PERF.md §5: "
        "pipelined 22,776-27,892, serial 22,626-29,707)")
    log(f"    {card_line()}")
    return out


def phase_legacy(router: TorchRouter, topics, batch: int, want_filters) -> None:
    log("[5] the same topics through TorchRouter on legacy tiles")
    for what in ("cold pass", "warm"):
        got, *timing = route_all(router, topics, batch, 2)
        _log_pass(f"{what}, pipelined depth 2", len(topics), *timing)
        for i, (g, w) in enumerate(zip(got, want_filters)):
            if g != w:
                raise AssertionError(f"legacy path differs at {topics[i]!r}")
        del got
    log(f"    all {len(topics)} topics equal to phase 4's packed-tile results "
        f"in both passes")


# --------------------------------------------------------------- phase 4m
MODE_SMALL_BATCHES = 64  # 4m: batches of 1 and of 8 after the full pass
#: 4m's modes: (label, environment while the matcher is built, table);
#: SEG_BYTES over phase 4's 8,388,608 B of packed tiles and phase 5's
#: 23,068,672 B of legacy tiles gives 4, 4 and 3 segments
MODES_4M = (
    ("a unfused global", {"RMQTT_FUSED": "0"}, "packed"),
    ("b topk", {"RMQTT_COMPACT": "topk"}, "packed"),
    ("c fused, segmented", {"RMQTT_SEG_BYTES": "2097152"}, "packed"),
    ("d unfused, segmented", {"RMQTT_SEG_BYTES": "2097152", "RMQTT_FUSED": "0"},
     "packed"),
    ("e legacy, segmented", {"RMQTT_PACKED": "0", "RMQTT_SEG_BYTES": "8388608"},
     "legacy"),
)


def _same_fids(what: str, batch, got, want) -> None:
    for topic, g, w in zip(batch, got, want):
        if not np.array_equal(g, w):
            raise AssertionError(f"4m {what}: {topic!r} routed {g[:8]}... expected "
                                 f"{w[:8]}... ({len(g)} vs {len(w)})")


def _mode_pass(m, ref, topics, batch: int, what: str) -> tuple:
    """Every topic through the mode's matcher (pipelined depth 2) and then
    the reference router's matcher, the same batches at the same table
    version → (mode topics/s, the mode's words-kernel launches)."""
    counters = (MW.match_words_packed, MW.match_words_legacy)
    n0 = sum(c.launches for c in counters)
    batches = [topics[i:i + batch] for i in range(0, len(topics), batch)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [m.match_submit(batches[0])]
    got = []
    for bt in batches[1:]:
        handles.append(m.match_submit(bt))
        got.extend(m.match_complete(handles.pop(0)))
    got.extend(m.match_complete(handles.pop(0)))
    secs = time.perf_counter() - t0
    launches = sum(c.launches for c in counters) - n0
    want = [r for bt in batches for r in ref.matcher.match(bt)]
    _same_fids(what, topics, got, want)
    return len(topics) / secs, launches


def _churn_router(router, filters, n: int, rng, tag: str) -> None:
    """``n`` removes of live filters and ``n`` adds of fresh ones, through
    the router so its relations stay whole."""
    live = [(i, f) for i, f in enumerate(filters) if f in router._filter_to_fid]
    opts = SubscriptionOptions()
    for i, f in rng.sample(live, n):
        router.remove(f, Id(1, f"c{i}"))
    fresh = [f for f in gen_mixed(rng, 2 * n) if f not in router._filter_to_fid][:n]
    for j, f in enumerate(fresh):
        router.add(f, Id(1, f"{tag}{j}"), opts)


def phase_modes(packed_router: TorchRouter, legacy_router: TorchRouter, filters,
                topics, batch: int, churn: int, seed: int) -> dict:
    """4m: the matcher's hand-selected modes over phases 4's and 5's tables,
    each held to that table's reference router on every topic before and
    after a churn, which each must take as a delta upload."""
    log("[4m] the hand-selected matcher modes on phase 4's and 5's tables")
    card = card_line()
    rng = random.Random(seed + 4)
    out = {"launches_packed": 0, "launches_legacy": 0, "modes": {}}
    for label, env, kind in MODES_4M:
        t0 = time.perf_counter()
        ref = packed_router if kind == "packed" else legacy_router
        ref_bytes = ref.matcher.hbm_breakdown()["tiles_bytes"]
        with environment(env):  # the matcher reads it when it is built
            m = PartitionedMatcher(ref.table, device=ref.matcher.device)
        # the pass pays the full upload and, where a churn before it dropped
        # candidate-cache entries, the cold encode (one pass, to fit the
        # run's time: PERF.md §4)
        tps0, n = _mode_pass(m, ref, topics, batch, label)
        small = 0
        for size in (1, 8):
            for k in range(MODE_SMALL_BATCHES):
                bt = topics[k * size:(k + 1) * size]
                c0 = MW.match_words_packed.launches + MW.match_words_legacy.launches
                got = m.match(bt)
                small += (MW.match_words_packed.launches
                          + MW.match_words_legacy.launches - c0)
                _same_fids(f"{label} batch of {size}", bt, got, ref.matcher.match(bt))
        hbm = m.hbm_breakdown()
        seg_bytes = int(env.get("RMQTT_SEG_BYTES", 0))
        want_segs = -(-ref_bytes // seg_bytes) if 0 < seg_bytes < ref_bytes else 0
        if hbm["segments"] != want_segs:
            raise AssertionError(f"4m {label}: {hbm['segments']} segments, the "
                                 f"tiles' {ref_bytes} B give {want_segs}")
        full0, delta0 = m.full_uploads, m.delta_uploads
        _churn_router(ref, filters, churn, rng, f"m{label[0]}")
        tps2, n2 = _mode_pass(m, ref, topics, batch, f"{label} after the churn")
        if m.full_uploads != full0 or m.delta_uploads <= delta0:
            raise AssertionError(f"4m {label}: the churn took {m.full_uploads - full0} "
                                 f"full and {m.delta_uploads - delta0} delta uploads")
        if m.hbm_breakdown()["segments"] != want_segs:
            raise AssertionError(f"4m {label}: the segments changed in the churn")
        launches = n + small + n2
        if launches <= 0:
            raise AssertionError(f"4m {label}: no words kernel launched")
        out["launches_" + kind] += launches
        out["modes"][label] = {"topics_per_s": [tps0, tps2], "launches": launches,
                               "hbm": hbm, "fused_batches": m.fused_batches}
        log(f"    ({label}) {'; '.join(f'{k}={v}' for k, v in env.items())}: "
            f"{len(topics)} topics in batches of {batch} at {tps0:.1f} topics/s "
            f"(the full upload), {tps2:.1f} after -{churn} "
            f"+{churn} filters (1 delta upload, no full; the churn's dropped "
            f"candidate-cache entries encode cold); {MODE_SMALL_BATCHES} batches of 1 and of 8; all equal to "
            f"the {kind} reference router; words-kernel launches {launches} "
            f"({small} for the small batches); fused batches {m.fused_batches}; "
            f"hbm {hbm}; {time.perf_counter() - t0:.1f} s; {card}")
        del m
    out["programs"] = _time_mode_programs(packed_router, topics, batch, card)
    return out


def _mode_words(router, topics, dev) -> torch.Tensor:
    """The packed words kernel's ``[B, 4 NC]`` words for ``topics`` on the
    router's table (timing and check inputs, not a path's launch)."""
    t = router.table
    st = router.matcher._refresh()
    ttok, tlen, tdollar, cids, _nc = t.encode_topics(topics, pad_batch_to=len(topics))
    _lay, tt = t.translate_packed(ttok)
    n0 = MW.match_words_packed.launches
    words = MW.match_words_packed(st.tiles, *(_put(a, dev) for a in (tt, tlen, tdollar, cids)),
                                  st.layout)
    MW.match_words_packed.launches = n0
    return words


def _time_mode_programs(router, topics, batch: int, card: str) -> dict:
    """The topk mode's ``compact_words`` kernel against its twin
    (``torch.equal`` over the wire) on phase 4's words of one batch at the
    topk mode's ``max_words`` of 32 and a regrow's 64, and of the broker's
    1 and 8 topics; timed at the batch's shape by CUDA events and graph
    replay beside its twin, ``torch.topk`` on the unique keys ``2W - idx``
    / ``W - idx`` (whose indices must equal the twin's) and its bound, and
    at the other shapes by graph replay. The delta scatter of 64 chunks
    into a 2,048-chunk segment by CUDA events, beside its bound by bytes
    (``compact_global`` is timed in 3t)."""
    st = router.matcher._refresh()
    dev = st.tiles.device
    words = _mode_words(router, topics[:batch], dev)
    b, w = words.shape
    n0 = CT.compact_words.launches
    cw = {"small_ms": {}, "small_graph_ms": {}}
    shapes = {"regrow K=64": (words, 64), 1: (_mode_words(router, topics[:1], dev), 32),
              8: (_mode_words(router, topics[:8], dev), 32)}
    for what, (wds, k) in ((f"B={b} K=32", (words, 32)), *shapes.items()):
        got = CT.compact_words(wds, k)
        want = CT.topk_wire_plain(wds, k)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        cw["max_abs_err"] = max(cw.get("max_abs_err", 0), err)
        cw["cases"] = cw.get("cases", 0) + 1
        if not torch.equal(got, want):
            raise AssertionError(f"compact_words {what}: the kernel's wire differs from the "
                                 f"twin's (max abs err {err})")
        if what in shapes:
            cw["small_ms"][what] = time_cuda(lambda: CT.compact_words(wds, k),
                                             reps=50)
            cw["small_graph_ms"][what] = time_graph(
                lambda: CT.compact_words(wds, k), reps=10)
        log(f"    compact_words {what}: equal, [{wds.shape[0]}, {wds.shape[1]}], "
            f"{int((wds != 0).sum())} nonzero words")
    kw = min(32, w)
    idx = torch.arange(w, dtype=torch.int32, device=dev)
    keys = torch.where(words != 0, 2 * w - idx, w - idx)
    want_idx = CT.match_words_plain(words, 32)[0]
    if not torch.equal(torch.topk(keys, kw, dim=1).indices.to(torch.int32), want_idx):
        raise AssertionError("torch.topk on the unique keys differs from compact_words")
    cw["ms"] = time_cuda(lambda: CT.compact_words(words, 32), reps=50)
    cw["graph_ms"] = time_graph(lambda: CT.compact_words(words, 32), reps=10)
    cw["plain_ms"] = time_cuda(lambda: CT.topk_wire_plain(words, 32), reps=20)
    cw["library_ms"] = time_cuda(lambda: torch.topk(keys, kw, dim=1), reps=20)
    cw["bound_ms"], cw["bound_by"], cw["bound_term"] = dense_words_bound_ms(b, w, kw)
    cw["shape"] = [b, w, kw]
    CT.compact_words.launches = n0  # checks and timings, not a path's launches
    log(f"    compact_words: {cw['ms']:.4f} ms at [{b}, {w}] K={kw} by CUDA events "
        f"({cw['graph_ms']:.4f} by graph replay), plain {cw['plain_ms']:.4f} ms, "
        f"torch.topk on the unique keys {cw['library_ms']:.4f} ms (the same indices), "
        f"bound {cw['bound_ms']:.5f} ms by {cw['bound_by']}; by graph replay "
        f"{ {k: round(v, 4) for k, v in cw['small_graph_ms'].items()} }; "
        f"{cw['cases']} equal cases; {card}")
    seg = st.tiles[:2049].clone()  # a segment of 2,048 chunks and its lead chunk
    k = 64
    idx = torch.arange(1, seg.shape[0], max(1, (seg.shape[0] - 1) // k),
                       device=dev)[:k]
    rows = st.tiles[:k].clone()
    tile_bytes = st.tiles[0].numel() * st.tiles.element_size()
    r = {"ms": time_cuda(lambda: PP._scatter_rows(seg, idx, rows), reps=50),
         "bound_ms": (2 * k * tile_bytes + k * 8) / HBM_BYTES_PER_S * 1e3,
         "library_ms": "the same call (index_copy_)", "chunks": k}
    log(f"    delta_scatter: {r['ms']:.4f} ms by CUDA events, bound {r['bound_ms']:.5f} ms "
        f"by bytes; library {r['library_ms']}; {k} chunks; {card}")
    return {"compact_words": cw, "delta_scatter": r}


# ------------------------------------------------------ phase 3d, 4d, 4s
DENSE_SAMPLE = 1_024  # 3d: topics against the whole dense table
DENSE_SMALL_BATCHES = 64  # 4d: batches of 1 and of 8 after the full pass
MESH_FILTERS = 20_000  # 4s: filters of the TorchRouter(mesh=...) check
DENSE_PAIRS = {
    "dense_match_packed": (DM.match_packed, DM.match_packed_plain),
    "dense_match_retained": (DM.match_retained, DM.match_retained_plain),
}


def build_dense(filters, retained_topics, dev):
    """4d's router: ``TorchRouter(backend="dense")`` over the 1M filters
    with every batch on the card; the dense ``FilterTable`` of cfg5's
    retained draws and its ``RetainedScanner``; ``perm`` maps a dense
    retained row to the topic's index in ``retained_topics`` (4r's fid)."""
    t0 = time.perf_counter()
    with environment({"RMQTT_HYBRID_MAX": "0"}):
        router = TorchRouter(device=dev, backend="dense")
    opts = SubscriptionOptions()
    for i, f in enumerate(filters):
        router.add(f, Id(1, f"c{i}"), opts)
    router.matcher._refresh()
    t1 = time.perf_counter()
    rtable = FilterTable()
    perm = np.empty(len(retained_topics), dtype=np.int64)
    for i, t in enumerate(retained_topics):
        perm[rtable.add(t)] = i
    scanner = RetainedScanner(rtable, device=dev)
    scanner._refresh()
    log(f"    dense table: {len(filters)} filters, capacity {router.table.capacity} x "
        f"{router.table.max_levels} levels, built + uploaded in {t1 - t0:.2f}s "
        f"({router.matcher.upload_bytes} B); retained FilterTable: "
        f"{len(retained_topics)} topics, capacity {rtable.capacity} x "
        f"{rtable.max_levels}, built + uploaded in {time.perf_counter() - t1:.2f}s")
    return router, scanner, perm


def _compare_words(what: str, packed, max_words: int, s: dict) -> None:
    """The words kernel against ``match_words_plain`` on one bitmap: word
    indices, bits and counts ``torch.equal``."""
    got = DM.match_words(packed, max_words)
    want = DM.match_words_plain(packed, max_words)
    torch.cuda.synchronize()
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    s["max_abs_err"] = max(s.get("max_abs_err", 0), err)
    s["cases"] = s.get("cases", 0) + 1
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"dense_match_words {what}: kernel differs from the plain "
                             f"twin (max abs err {err})")
    log(f"    dense_match_words {what}: equal, [{packed.shape[0]}, {packed.shape[1]}] K="
        f"{got[0].shape[1]}, {int((packed != 0).sum())} nonzero words, "
        f"{int((want[2] > max_words).sum())} topics past K")


def phase_dense_kernels(router, scanner, topics, sub_filters, batch: int, dev) -> dict:
    """3d: both dense full-scan kernels against their twins on the whole
    1M-row tables (1,024 topics; the 64-filter batch) and on
    ``DENSE_CASES``, the words kernel on the forward bitmap of ``batch``
    topics and of ``WORDS_CASES``; timed by CUDA events and graph replay
    beside the twins' times and the bounds: the forward at B = ``batch``, 1
    and 8 (the words and bitmap paths of 4d), the inverse at the 64-filter
    batch, 1 and 8 (each small shape held to the twin too), the words
    kernel at ``batch`` beside ``torch.topk`` on its twin's keys."""
    log("[3d] the dense kernels against their plain twins")
    stats = {name: {} for name in (*DENSE_PAIRS, "dense_match_words")}
    fwd_rows = router.matcher._refresh()
    t = router.table
    real = {
        "dense_match_packed": (*fwd_rows, *as_tensors(
            t.encode_topics(topics[:DENSE_SAMPLE]), dev)),
        "dense_match_retained": (*scanner._refresh(), *as_tensors(
            scanner.table.encode_filters(sub_filters[:RETAINED_BATCH]), dev)),
    }
    for name, args in real.items():
        kern, plain = DENSE_PAIRS[name]
        _compare(f"{name} whole table ({args[0].shape[0]} rows x {args[0].shape[1]} "
                 f"levels), B={args[-1].shape[0]}", kern, plain, args, stats[name])
    for case in DENSE_CASES:
        inp = make_dense_case(case)
        for name, arrs in (("dense_match_packed", inp.forward),
                           ("dense_match_retained", inp.inverse)):
            _compare(f"{name} {case.name}", *DENSE_PAIRS[name], as_tensors(arrs, dev),
                     stats[name])
    for wc in WORDS_CASES:
        packed = DM.match_packed(*as_tensors(make_words_case(wc).forward, dev))
        _compare_words(wc.name, packed, wc.max_words, stats["dense_match_words"])
    # timings: the forward at the words path's batch and the bitmap path's
    # 1 and 8, the inverse at the scanner's; the forward's twin, timed
    # once, is also held to the kernel
    timed_args = {
        "dense_match_packed": (*fwd_rows, *as_tensors(t.encode_topics(topics[:batch]), dev)),
        "dense_match_retained": real["dense_match_retained"],
    }
    for name, args in timed_args.items():
        kern, plain = DENSE_PAIRS[name]
        s = stats[name]
        b = args[-1].shape[0]
        big = name == "dense_match_packed"
        s["ms"] = time_cuda(lambda: kern(*args), reps=5 if big else 50, warmup=1)
        s["graph_ms"] = time_graph(lambda: kern(*args), reps=2 if big else 10,
                                   per_graph=2 if big else 20)
        if big:
            torch.cuda.synchronize()
            ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            ev0.record()
            want = plain(*args)
            ev1.record()
            torch.cuda.synchronize()
            s["plain_ms"] = ev0.elapsed_time(ev1)
            got = kern(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{name}: kernel differs from the twin at B={b}")
            s["cases"] += 1
            del want
            packed = got
        else:
            s["plain_ms"] = time_cuda(lambda: plain(*args), reps=3, warmup=1)
        rows, lvl = args[0].shape
        s["bound_ms"], s["bound_by"], s["bound_term"] = _dense_bound(name, args)
        s["warm_bound_ms"] = _dense_bound(name, args, warm=True)[0]
        s["shape"] = [b, rows, lvl]
        # the bitmap path's batches (forward) and a SUBSCRIBE's one filter
        # and 8 (inverse), each held to the twin; by CUDA events and graph
        # replay (warm: each call finds the ~42 MB table in the 50 MB L2)
        # beside the warm bound, and with the L2 flushed before each call
        # beside the device-memory bound
        for key in ("small_ms", "small_graph_ms", "small_cold_ms", "small_bound_ms",
                    "small_warm_bound_ms"):
            s[key] = {}
        for sb in (1, 8):
            sargs = (*args[:5], *as_tensors(t.encode_topics(topics[:sb]), dev)) if big else (
                *args[:3], *as_tensors(scanner.table.encode_filters(sub_filters[:sb]), dev))
            _compare(f"{name} B={sb}", kern, plain, sargs, s)
            s["small_ms"][sb] = time_cuda(lambda: kern(*sargs), reps=50)
            s["small_graph_ms"][sb] = time_graph(lambda: kern(*sargs), reps=10)
            s["small_cold_ms"][sb] = time_cold(lambda: kern(*sargs), reps=20)
            s["small_bound_ms"][sb] = _dense_bound(name, sargs)[0]
            s["small_warm_bound_ms"][sb] = _dense_bound(name, sargs, warm=True)[0]
        log(f"    {name}: {s['ms']:.4f} ms at B={b} x {rows} rows x {lvl} levels "
            f"({s['graph_ms']:.4f} ms by graph replay), plain {s['plain_ms']:.3f} ms, "
            f"bound {s['bound_ms']:.4f} ms by {s['bound_by']} ({s['bound_term']}), warm "
            f"{s['warm_bound_ms']:.4f}; {s['cases']} equal cases; at B=1 / 8 "
            f"{s['small_ms'][1]:.4f} / {s['small_ms'][8]:.4f} ms "
            f"({s['small_graph_ms'][1]:.4f} / {s['small_graph_ms'][8]:.4f} by graph "
            f"replay, warm bound {s['small_warm_bound_ms'][1]:.4f} / "
            f"{s['small_warm_bound_ms'][8]:.4f}; {s['small_cold_ms'][1]:.4f} / "
            f"{s['small_cold_ms'][8]:.4f} with the L2 flushed, bound "
            f"{s['small_bound_ms'][1]:.4f} / {s['small_bound_ms'][8]:.4f})")
    # the words kernel on the forward bitmap of the words path's batch
    s = stats["dense_match_words"]
    k = router.matcher.max_matches
    _compare_words(f"words path batch of the 1M-row table (B={batch})", packed, k, s)
    bw, w = packed.shape
    kw = min(k, w)
    s["ms"] = time_cuda(lambda: DM.match_words(packed, k), reps=20)
    s["graph_ms"] = time_graph(lambda: DM.match_words(packed, k), reps=5, per_graph=5)
    s["plain_ms"] = time_cuda(lambda: DM.match_words_plain(packed, k), reps=3, warmup=1)
    idx = torch.arange(w, dtype=torch.int32, device=dev)
    keys = torch.where(packed != 0, 2 * w - idx, w - idx)
    s["library_ms"] = time_cuda(lambda: torch.topk(keys, kw, dim=1), reps=5, warmup=1)
    del keys
    s["bound_ms"], s["bound_by"], s["bound_term"] = dense_words_bound_ms(bw, w, kw)
    s["shape"] = [bw, w, kw]
    log(f"    dense_match_words: {s['ms']:.4f} ms at [{bw}, {w}] words, K={kw} "
        f"({s['graph_ms']:.4f} ms by graph replay), plain {s['plain_ms']:.3f} ms, "
        f"torch.topk on the twin's keys {s['library_ms']:.4f} ms, bound "
        f"{s['bound_ms']:.4f} ms by {s['bound_by']}; {s['cases']} equal cases")
    del packed
    stats["programs"] = _time_dense_programs(router, topics, dev)
    DM.match_words.launches = 0  # checks and timings, not a path's launches
    torch.cuda.empty_cache()
    log(f"    {card_line()}")
    return stats


def _dense_bound(name: str, args, warm: bool = False):
    """``dense_bound_ms`` of one dense scan call on its wrapper's arguments,
    with the literal levels its pairs compare: the forward's rows' (the
    filters) for every topic, the inverse's filters' for every row; cold,
    or ``warm`` for a call repeated on the same inputs."""
    rows, lvl = args[0].shape
    b = args[5].shape[0] if name == "dense_match_packed" else args[3].shape[0]
    if name == "dense_match_packed":
        literal = b * int(literal_levels(args[0], args[2], args[1] >= 0).sum())
    else:
        literal = rows * int(literal_levels(args[3], args[5], args[4] != -2).sum())
    return dense_bound_ms(rows, lvl, b, literal, warm)


def _time_dense_programs(router, topics, dev) -> dict:
    """The torch ops over the dense bitmap that no main path runs, by CUDA
    events: ``match_compact`` at 1,024 topics, beside its bound by bytes
    (the bitmap read once, the outputs written once)."""
    m = router.matcher
    n0 = DM.match_packed.launches
    packed = m.match_encoded(*router.table.encode_topics(topics[:DENSE_SAMPLE]))
    bw, w = packed.shape
    ms = time_cuda(lambda: DM.match_compact(packed, m.chunk, m.max_matches), reps=3, warmup=1)
    out = {"match_compact": {
        "ms": ms, "library_ms": None, "shape": [bw, w],
        "bound_ms": (packed.numel() * 4 + bw * (m.max_matches + 1) * 4)
        / HBM_BYTES_PER_S * 1e3}}
    del packed
    log(f"    match_compact: {ms:.4f} ms at [{bw}, {w}] words by CUDA events, bound "
        f"{out['match_compact']['bound_ms']:.4f} ms by bytes; library none")
    DM.match_packed.launches = n0  # timing inputs, not a path's launches
    return out


def _dense_pass(router, topics, batch: int):
    """``topics`` through the router's ``matches_batch_raw`` in batches of
    ``batch`` → (matched filter lists, seconds)."""
    out = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(0, len(topics), batch):
        out.extend(_routed_filters(raw) for raw in
                   router.matches_batch_raw([(None, t) for t in topics[i:i + batch]]))
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_dense(router, scanner, perm, filters, topics, batch: int, want_filters,
                churn: int, seed: int, sub_filters, retained_res) -> dict:
    """4d: ``TorchRouter(backend="dense")`` over the 1M filters (words path
    at ``batch``, bitmap path at 1 and 8), a churn as one delta upload, and
    the dense ``RetainedScanner`` over cfg5's retained draws → launches."""
    log("[4d] TorchRouter(backend='dense') over the 1M filters, and the dense "
        "RetainedScanner")
    m = router.matcher
    n = len(topics)
    DM.match_packed.launches = DM.match_retained.launches = DM.match_words.launches = 0
    got, secs = _dense_pass(router, topics, batch)
    over = sum(len(g) > m.max_matches for g in got)
    for i, (g, w) in enumerate(zip(got, want_filters)):
        if g != w:
            raise AssertionError(f"4d: dense router differs from phase 4 at {topics[i]!r}: "
                                 f"{len(g)} vs {len(w)} filters")
    words_launches = DM.match_packed.launches
    words_kernel_launches = DM.match_words.launches
    words_tps = n / secs
    log(f"    {n} topics in batches of {batch} (words path): {secs * 1e3:.3f} ms = "
        f"{n / secs:.1f} topics/s; {over} topics overflowed the {m.max_matches} "
        f"words to the bitmap path; {words_launches} forward and {words_kernel_launches} "
        f"words launches; all equal to phase 4's "
        f"({sum(len(g) for g in got)} routes)")
    del got
    small_t = {}
    for size in (1, 8):
        bts = [topics[k * size:(k + 1) * size] for k in range(DENSE_SMALL_BATCHES)]
        res, secs = _dense_pass(router, [t for bt in bts for t in bt], size)
        idx = [i for k in range(DENSE_SMALL_BATCHES) for i in range(k * size, (k + 1) * size)]
        if res != [want_filters[i] for i in idx]:
            raise AssertionError(f"4d: batches of {size} differ from phase 4")
        small_t[size] = len(res) / secs
    log(f"    {DENSE_SMALL_BATCHES} batches of 1 and of 8 (bitmap path), equal to "
        f"phase 4's: {small_t[1]:.1f} / {small_t[8]:.1f} topics/s")
    # churn: removes and adds through the router, one delta upload
    rng = random.Random(seed + 10)
    full0, delta0 = m.full_uploads, m.delta_uploads
    _churn_router(router, filters, churn, rng, "d")
    sample = sorted(rng.sample(range(n), min(2_048, n)))
    stopics = [topics[i] for i in sample]
    got, secs = _dense_pass(router, stopics, len(stopics))
    if (m.full_uploads, m.delta_uploads) != (full0, delta0 + 1):
        raise AssertionError(f"4d: the churn took {m.full_uploads - full0} full and "
                             f"{m.delta_uploads - delta0} delta uploads, not one delta")
    want = [_routed_filters(raw) for raw in
            router.host_matches_batch_raw([(None, t) for t in stopics])]
    if got != want:
        raise AssertionError("4d: after the churn the dense router differs from its "
                             "host trie mirror (the same churn)")
    log(f"    churn -{churn} +{churn}: one delta upload ({m.upload_bytes} B uploaded in "
        f"all); {len(stopics)} topics at {len(stopics) / secs:.1f} topics/s equal to the "
        f"native trie mirror through the same churn")
    # the dense retained scan: every filter of the mix against 4r's results,
    # the rows mapped to the same topic list
    t0 = time.perf_counter()
    res = []
    for lo in range(0, len(sub_filters), RETAINED_BATCH):
        res.extend(scanner.scan(sub_filters[lo:lo + RETAINED_BATCH]))
    ssecs = time.perf_counter() - t0
    for f, g, w in zip(sub_filters, res, retained_res):
        if not np.array_equal(np.sort(perm[g]), w):
            raise AssertionError(f"4d: dense retained scan of {f!r}: {len(g)} topics, "
                                 f"4r {len(w)}")
    out = {"topics_per_s": words_tps, "small_topics_per_s": small_t,
           "churn_topics_per_s": len(stopics) / secs, "overflowed": over,
           "scans_per_s": len(sub_filters) / ssecs,
           "launches_packed": DM.match_packed.launches,
           "launches_retained": DM.match_retained.launches,
           "launches_words": DM.match_words.launches}
    log(f"    dense RetainedScanner: {len(sub_filters)} filters in batches of "
        f"{RETAINED_BATCH}, {out['scans_per_s']:.1f} scans/s, every filter's topics "
        f"equal to 4r's ({sum(len(r) for r in res)} topics)")
    log(f"    launches: dense_match_packed {out['launches_packed']}, "
        f"dense_match_words {out['launches_words']}, "
        f"dense_match_retained {out['launches_retained']}; {card_line()}")
    return out


def _mesh_checks(devs, dense_router, packed_router, topics, batch: int, filters,
                 what: str) -> dict:
    """4s over one device list: ``ShardedMatcher`` at fp = len(devs) against
    ``DenseMatcher``; ``ShardedPartitionedMatcher`` at dp = len(devs) in each
    compaction mode against phase 4's matcher; a ``TorchRouter(mesh=...)``."""
    out = {"launches_packed": 0, "launches_legacy": 0, "modes": {}}
    nd = len(devs)
    dt = dense_router.table
    ttok, tlen, td = dt.encode_topics(topics[:DENSE_SAMPLE])
    n0 = DM.match_packed.launches
    sm = ShardedMatcher(dt, make_mesh(devs, dp=1, fp=nd))
    packed, counts = sm.assemble(sm.match_encoded(ttok, tlen, td))
    out["launches_packed"] = DM.match_packed.launches - n0
    out["sharded_dense_ms"] = time_cuda(lambda: sm.match_encoded(ttok, tlen, td), reps=5)
    DM.match_packed.launches = n0 + out["launches_packed"]  # timing, not the path
    want = fetch(dense_router.matcher.match_encoded(ttok, tlen, td))
    if not np.array_equal(packed, want):
        raise AssertionError(f"4s {what}: ShardedMatcher's bitmap differs from DenseMatcher's")
    if not np.array_equal(counts, np.unpackbits(want.view(np.uint8), axis=1).sum(1)):
        raise AssertionError(f"4s {what}: ShardedMatcher's counts differ")
    del packed, want
    log(f"    {what}: ShardedMatcher (dp=1, fp={nd}) on 4d's table, B={len(ttok)}: "
        f"bitmap and counts equal to DenseMatcher's ({int(counts.sum())} matches); "
        f"match_encoded {out['sharded_dense_ms']:.4f} ms by CUDA events (the shards' "
        f"kernels, popcounts and the count sum)")
    ref = packed_router.matcher
    mesh = make_mesh(devs, dp=nd)
    for mode, kw in (("fused", {}), ("unfused", {}), ("topk", {"compact": "topk"})):
        spm = ShardedPartitionedMatcher(packed_router.table, mesh, **kw)
        if mode == "unfused":
            spm._fused = False
        n0 = MW.match_words_legacy.launches
        want = [r for i in range(0, len(topics), batch)
                for r in ref.match(topics[i:i + batch])]
        tps = []
        for _ in range(2):  # the first pass pays the replicated full upload
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = [r for i in range(0, len(topics), batch)
                   for r in spm.match(topics[i:i + batch])]
            tps.append(len(topics) / (time.perf_counter() - t0))
            _same_fids(f"4s {what} {mode}", topics, got, want)
        launches = MW.match_words_legacy.launches - n0
        out["launches_legacy"] += launches
        out["modes"][mode] = tps
        log(f"    {what}: ShardedPartitionedMatcher (dp={nd}) {mode}: {len(topics)} "
            f"topics in batches of {batch} at {tps[0]:.1f} topics/s (the full upload), "
            f"{tps[1]:.1f} warm, equal to phase 4's matcher; {launches} legacy words "
            f"launches; fused batches {spm.fused_batches}; hbm {spm.hbm_breakdown()}")
        del spm
    with environment({"RMQTT_HYBRID_MAX": "0"}):
        mr = TorchRouter(mesh=mesh)
    opts = SubscriptionOptions()
    for i, f in enumerate(filters[:MESH_FILTERS]):
        mr.add(f, Id(1, f"c{i}"), opts)
    n0 = MW.match_words_legacy.launches
    for lo in range(0, 4 * 512, 512):
        items = [(None, t) for t in topics[lo:lo + 512]]
        got = [_routed_filters(raw) for raw in mr.matches_batch_raw(items)]
        want = [_routed_filters(raw) for raw in mr.host_matches_batch_raw(items)]
        if got != want:
            raise AssertionError(f"4s {what}: TorchRouter(mesh=...) differs from its "
                                 "host trie mirror")
    out["launches_legacy"] += MW.match_words_legacy.launches - n0
    log(f"    {what}: TorchRouter(mesh=make_mesh(dp={nd})) with {MESH_FILTERS} filters: "
        f"4 batches of 512 equal to its native trie mirror "
        f"({MW.match_words_legacy.launches - n0} launches)")
    return out


def phase_sharded(dense_router, packed_router, topics, batch: int, filters, dev) -> dict:
    """4s: the multi-device matchers over ``[dev] * 2`` (one card standing in
    for two), and over every card when there is more than one."""
    log("[4s] the multi-device matchers over a list of devices")
    log("    one card standing in for two shows the code path, not multi-card "
        "scaling")
    out = _mesh_checks([dev, dev], dense_router, packed_router, topics, batch, filters,
                       "[cuda:0] x 2")
    ncards = torch.cuda.device_count()
    if ncards > 1:
        out["all_cards"] = _mesh_checks(
            [torch.device("cuda", i) for i in range(ncards)], dense_router,
            packed_router, topics, batch, filters, f"{ncards} cards")
    log(f"    {card_line()}")
    return out


# ---------------------------------------------------------------- phase 6
ROOT = Path(__file__).resolve().parent
BROKER_CMD = (sys.executable, "-m", "rmqtt_tpu_torch.broker")
BROKER_ROUTER = "xla"
BROKER_SUBSCRIBERS = 64  # 6a: connections the filters are dealt over
BROKER_PUBLISHERS = 4
FAULT_WAVE = 1000  # 6b: topics per wave
LONE_PUBLISHES = 200  # 6c: round trips per broker


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _children(pid: int) -> list:
    """Pids of the live (not zombie) children of process ``pid``, from
    /proc."""
    out = []
    for d in Path("/proc").iterdir():
        if d.name.isdigit():
            try:
                state, ppid = (d / "stat").read_text().rsplit(")", 1)[1].split()[:2]
            except OSError:
                continue
            if int(ppid) == pid and state != "Z":
                out.append(int(d.name))
    return out


def _signal(pid: int, sig) -> None:
    try:
        os.kill(pid, sig)
    except ProcessLookupError:
        pass


class BrokerProcess:
    """``python -m rmqtt_tpu_torch.broker --router xla`` (or ``router``) as a
    child process with ``[http_api]`` on a port of its own (with
    ``--workers``, worker 1's), plus ``args``; its output, and its workers',
    goes to a log file in ``workdir``. ``stop`` ends it and every worker
    (``main``'s ``finally``)."""

    def __init__(self, name: str, workdir: Path, env: dict, toml: str = "",
                 args=(), router: str = "") -> None:
        self.name = name
        self.port, self.http_port = _free_port(), _free_port()
        cfg = workdir / f"{name}.toml"
        cfg.write_text(
            '[listener]\nhost = "127.0.0.1"\n'
            f'[http_api]\nhost = "127.0.0.1"\nport = {self.http_port}\n'
            # no queue-full drops: every delivery is checked (the default
            # session queue holds 1,000, and a retained replay is enqueued
            # at once)
            "[mqtt]\nmax_mqueue = 100000000\n" + toml)
        self.log_path = workdir / f"{name}.log"
        self._log = open(self.log_path, "wb")
        full_env = {**os.environ, **env, "PYTHONFAULTHANDLER": "1",
                    "PYTHONPATH": os.pathsep.join(
                        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p)}
        self.started = time.perf_counter()
        self.proc = subprocess.Popen(
            [*BROKER_CMD, "--router", router or BROKER_ROUTER, "--port", str(self.port),
             "--config",
             str(cfg), *args],
            stdout=self._log, stderr=subprocess.STDOUT, env=full_env, cwd=ROOT)
        self._workers: list = []

    def tail(self, n: int = 40) -> str:
        return "\n".join(self.log_path.read_text(errors="replace").splitlines()[-n:])

    def wait_ready(self, timeout: float = 300.0) -> None:
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            if self.proc.poll() is not None:
                raise RuntimeError(f"broker {self.name} exited "
                                   f"({self.proc.returncode}):\n{self.tail()}")
            try:
                with socket.create_connection(("127.0.0.1", self.port), timeout=1):
                    pass
                with socket.create_connection(("127.0.0.1", self.http_port), timeout=1):
                    return
            except OSError:
                time.sleep(0.2)
        raise TimeoutError(f"broker {self.name} not listening after {timeout}s:\n"
                           f"{self.tail()}")

    def abort_with_stacks(self) -> None:
        """On a failed phase: SIGABRT makes the broker's fault handler
        write every thread's stack to its log before it dies. A ``--workers``
        supervisor is held stopped meanwhile (it would respawn them), then
        told to stop the group."""
        if self.proc.poll() is not None:
            return
        workers = _children(self.proc.pid)
        self._workers = workers
        if workers:
            self.proc.send_signal(signal.SIGSTOP)
        for pid in workers or [self.proc.pid]:
            _signal(pid, signal.SIGABRT)
        deadline = time.perf_counter() + 30
        while workers and _children(self.proc.pid) and time.perf_counter() < deadline:
            time.sleep(0.2)
        if workers:
            # pending until SIGCONT: the supervisor stops instead of respawning
            self.proc.send_signal(signal.SIGTERM)
            self.proc.send_signal(signal.SIGCONT)
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass

    def kill(self) -> None:
        """SIGKILL, as a crash: no shutdown of any kind."""
        self.proc.kill()
        self.proc.wait(timeout=30)

    def _http(self, method: str, path: str, body=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.http_port}{path}", method=method,
            data=None if body is None else json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())

    def stats(self) -> dict:
        """The broker's ``/api/v1/stats`` gauges."""
        (node,) = self._http("GET", "/api/v1/stats")
        return node["stats"]

    def metrics(self) -> dict:
        """The broker's ``/api/v1/metrics`` counters."""
        return self._http("GET", "/api/v1/metrics")["metrics"]

    def set_failpoints(self, specs: dict) -> None:
        self._http("PUT", "/api/v1/failpoints", specs)

    def device(self) -> dict:
        """The broker's ``/api/v1/device`` (device profiler), flight ring
        included."""
        return self._http("GET", "/api/v1/device?flight=1")

    def fabric(self) -> dict:
        """The owner's ``/api/v1/fabric``."""
        return self._http("GET", "/api/v1/fabric")

    def probes_s(self) -> list:
        """Seconds each process's CUDA probe took at start, from the log."""
        return [float(s) for s in re.findall(
            r"cuda probe: \d+ device\(s\) in ([\d.]+) s",
            self.log_path.read_text(errors="replace"))]

    def probe_s(self) -> float:
        """Seconds the broker's CUDA probe took at start, from its log."""
        probes = self.probes_s()
        if not probes:
            raise AssertionError(f"broker {self.name}: no CUDA probe in its log")
        return probes[0]

    def stop(self) -> None:
        workers = self._workers or (_children(self.proc.pid)
                                    if self.proc.poll() is None else [])
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)
        for pid in workers:  # a supervisor that did not stop its group
            _signal(pid, signal.SIGKILL)
        self._log.close()


def _device_delta(before: dict, after: dict) -> dict:
    keys = ("routing_dispatches", "routing_fused_batches", "routing_failovers",
            "routing_switchbacks", "routing_failover_host_routed",
            "routing_uploads", "routing_delta_uploads",
            "routing_kernel_launches_packed", "routing_kernel_launches_legacy",
            "routing_kernel_launches_fused_tail", "routing_kernel_launches_compact_global")
    return {k: after[k] - before[k] for k in keys}


def _log_split(before: dict, after: dict, secs: float) -> None:
    """Where a wave's time went, from the broker's own gauges: the
    matcher's stage totals (host clocks; fetch includes the wait for the
    device), the collector's pauses, and the routing and publish latency
    percentiles (histograms since the broker started)."""
    def dlt(k):
        return after.get(k, 0) - before.get(k, 0)

    n = max(1, dlt("routing_dispatches"))
    stages = {k: dlt(f"routing_stage_{k}_ms_total")
              for k in ("encode", "dispatch", "fetch", "decode")}
    log(f"    split over {n} batches ({dlt('routing_dispatched_items')} items, "
        f"{secs * 1e3 / n:.3f} ms of wave per batch): matcher stages "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in stages.items())
        + f" ({sum(stages.values()) / n:.3f} ms per batch); collector "
        f"{dlt('host_gc_pauses')} pauses, {dlt('host_gc_pause_ms_total'):.3f} ms; "
        f"routing match p50/p99 {after['routing_match_p50_ms']}/"
        f"{after['routing_match_p99_ms']} ms, queue wait p50/p99 "
        f"{after['routing_queue_wait_p50_ms']}/{after['routing_queue_wait_p99_ms']} ms, "
        f"publish e2e p50/p99 {after['publish_e2e_p50_ms']}/"
        f"{after['publish_e2e_p99_ms']} ms; event-loop lag p99 "
        f"{after.get('host_loop_lag_p99_ms', 0)} ms")


def _check_device_profile(p0: dict, p1: dict, s0: dict, s1: dict) -> dict:
    """6a's ``/api/v1/device`` before (``p0``) and after (``p1``) the wave
    against the routing gauges ``s0`` / ``s1`` → the counts it prints."""
    kern = p1["compile"]["kernels"]
    flight = p1.get("flight", [])
    got = {
        "words_traces": kern.get("match_words_packed", {}).get("traces", 0),
        "kernels": sorted(kern),
        "cache_hits_wave": p1["compile"]["cache_hits"] - p0["compile"]["cache_hits"],
        "traces_wave": p1["compile"]["traces"] - p0["compile"]["traces"],
        "full_uploads": p1["uploads"]["full"],
        "delta_uploads": p1["uploads"]["delta"],
        "dispatches_wave": p1["dispatch"]["dispatches"] - p0["dispatch"]["dispatches"],
        "routing_dispatches_wave": s1["routing_dispatches"] - s0["routing_dispatches"],
        "flight_len": p1["flight_len"],
        "flight_hits": sum(r.get("compile") == "hit" for r in flight),
        "pad_waste": p1["dispatch"]["pad_waste"],
        "dispatch_p50_p99_ms": (p1["dispatch"]["p50_ms"], p1["dispatch"]["p99_ms"]),
        "hbm": {k: p1["hbm"].get(k) for k in ("modeled_bytes", "live_arrays",
                                              "live_arrays_bytes",
                                              "device_bytes_in_use")},
    }
    ok = (got["words_traces"] >= 1 and got["cache_hits_wave"] > 0
          and got["flight_hits"] > 0 and got["full_uploads"] >= 1
          and got["dispatches_wave"] == got["routing_dispatches_wave"] > 0
          and got["flight_len"] > 0 and (got["hbm"]["live_arrays_bytes"] or 0) > 0)
    if not ok:
        raise AssertionError(f"6a: /api/v1/device does not show the matcher's "
                             f"profiler seams: {got}")
    return got


def _all_on_device(d: dict, after: dict) -> bool:
    """Every routing batch of a wave ran on the device: as many device
    batches as dispatches or more (the start-up prewarm also matches), the
    fused tail's kernel launched, no item routed on the host trie, no
    failover, the breaker closed."""
    return (d["routing_fused_batches"] >= d["routing_dispatches"] > 0
            and d["routing_kernel_launches_fused_tail"] > 0
            and d["routing_failover_host_routed"] == 0
            and d["routing_failovers"] == 0 and after["routing_failover_state"] == 0)


def _check_wave(what: str, got, want) -> None:
    if got != want:
        missing, extra = want - got, got - want
        raise AssertionError(
            f"{what}: deliveries differ from the DefaultRouter oracle: "
            f"{sum(missing.values())} missing (e.g. {list(missing)[:3]}), "
            f"{sum(extra.values())} extra (e.g. {list(extra)[:3]})")
    log(f"    {what}: {sum(got.values())} deliveries equal to the DefaultRouter "
        f"oracle (multiset of client, topic, payload)")


async def _lone_publishes(port: int, n: int, tag: str) -> tuple:
    """``n`` lone QoS 0 publishes, each waiting for its delivery, from one
    publisher to one subscriber on ``lat/+`` → (p50 ms, p99 ms)."""
    sub = await LoadClient.connect(port, f"lat-sub-{tag}")
    await sub.subscribe(["lat/+"])
    pub = await LoadClient.connect(port, f"lat-pub-{tag}")
    rtt = []
    for i in range(n):
        t0 = time.perf_counter()
        pub.publish(f"lat/{i}", b"%d" % i)
        await sub.wait_count(i + 1, 30.0)
        topic, payload, t1 = sub.received[i]
        if (topic, payload) != (f"lat/{i}", b"%d" % i):
            raise AssertionError(f"lone publish {i}: got {topic!r} {payload!r}")
        rtt.append((t1 - t0) * 1e3)
    await sub.close()
    await pub.close()
    return float(np.percentile(rtt, 50)), float(np.percentile(rtt, 99))


async def _broker_drive(dev_broker, hybrid_broker, subs, waves, plugin) -> dict:
    """6a, 6b and 6c against the two running brokers, with 6g's
    ``plugin.prepare`` beside their subscribes; then those two brokers
    stop and ``plugin.run`` runs alone → the numbers (6g's under
    ``"plugin"``)."""
    out: dict = {}
    n_filters = sum(len(f) for f in subs.values())
    # the three brokers at once (each a process of its own), to fit the
    # run's time since 6e and 6f: each time runs from its first CONNECT to
    # its last SUBACK
    async def subscribe(port: int) -> tuple:
        t0 = time.perf_counter()
        clients = await connect_and_subscribe(port, subs)
        return clients, time.perf_counter() - t0

    (subscribers, out["subscribe_s"]), (hybrid_subscribers,
                                        out["subscribe_s_hybrid_broker"]), \
        plugin_subscribers = await asyncio.gather(subscribe(dev_broker.port),
                                                  subscribe(hybrid_broker.port),
                                                  plugin.prepare())
    log(f"    subscribe: {n_filters} filters over {len(subs)} connections in "
        f"{out['subscribe_s']:.3f} s (device broker) and, at the same time, "
        f"{out['subscribe_s_hybrid_broker']:.3f} s (hybrid broker) and 6g's ingest "
        f"and subscribe")
    loop = asyncio.get_running_loop()

    async def stats():
        return await loop.run_in_executor(None, dev_broker.stats)

    pubs = [await LoadClient.connect(dev_broker.port, f"pub{k}")
            for k in range(BROKER_PUBLISHERS)]

    # 6a: the cfg3 topics through the broker, every batch on the device
    (topics, payloads, want), wave_fail, wave_next = waves[:3]
    p0 = await loop.run_in_executor(None, dev_broker.device)
    s0 = await stats()
    got, secs = await publish_wave(pubs, subscribers, topics, payloads, want,
                                   timeout=900.0)
    s1 = await stats()
    p1 = await loop.run_in_executor(None, dev_broker.device)
    _check_wave("6a cfg3 wave", got, want)
    d = _device_delta(s0, s1)
    n_del = sum(got.values())
    out.update(publishes=len(topics), deliveries=n_del, publish_s=secs,
               deliveries_per_s=n_del / secs, publishes_per_s=len(topics) / secs,
               launches_packed=d["routing_kernel_launches_packed"],
               launches_legacy=d["routing_kernel_launches_legacy"],
               launches_tail=d["routing_kernel_launches_fused_tail"],
               dispatches=d["routing_dispatches"], fused_batches=d["routing_fused_batches"])
    log(f"    6a: {len(topics)} publishes -> {n_del} deliveries, first publish to "
        f"last delivery {secs:.3f} s = {n_del / secs:.1f} messages/s delivered "
        f"({len(topics) / secs:.1f} publishes/s); {d['routing_dispatches']} "
        f"routing batches, {d['routing_fused_batches']} on the device, words kernel "
        f"launches {d['routing_kernel_launches_packed']} (packed)")
    _log_split(s0, s1, secs)
    if not _all_on_device(d, s1) or d["routing_kernel_launches_packed"] <= 0:
        raise AssertionError(f"6a: not every batch ran on the device: {d}, "
                             f"failover state {s1['routing_failover_state']}")
    out["devprof"] = _check_device_profile(p0, p1, s0, s1)
    log(f"    6a /api/v1/device (profiler seams): {out['devprof']}")

    # 6b: device.dispatch fails 4 times; no delivery lost, the breaker opens,
    # closes with a full re-upload, and the device serves the next wave
    (ftopics, fpayloads, fwant) = wave_fail
    await loop.run_in_executor(None, dev_broker.set_failpoints,
                               {"device.dispatch": "times(4,error)"})
    got, _ = await publish_wave(pubs, subscribers, ftopics, fpayloads, fwant,
                                timeout=300.0)
    s2 = await stats()
    _check_wave("6b wave with device.dispatch armed", got, fwant)
    d = _device_delta(s1, s2)
    if d["routing_failovers"] < 1:
        raise AssertionError(f"6b: the breaker never opened: {d}")
    t0 = time.perf_counter()
    while True:
        s3 = await stats()
        if s3["routing_failover_state"] == 0 and s3["routing_switchbacks"] > s1["routing_switchbacks"]:
            break
        if time.perf_counter() - t0 > 120:
            raise AssertionError(f"6b: the breaker did not close in 120 s: "
                                 f"state {s3['routing_failover_state']}")
        await asyncio.sleep(0.2)
    close_s = time.perf_counter() - t0
    d = _device_delta(s1, s3)
    full = d["routing_uploads"] - d["routing_delta_uploads"]
    if full < 1:
        raise AssertionError(f"6b: no full re-upload on the switchback: {d}")
    log(f"    6b: breaker opened ({d['routing_failovers']} failover, "
        f"{s3['routing_failover_host_routed'] - s1['routing_failover_host_routed']} "
        f"items routed on the host trie), closed {close_s:.3f} s after the wave "
        f"with {full} full re-upload(s)")
    (ntopics, npayloads, nwant) = wave_next
    got, _ = await publish_wave(pubs, subscribers, ntopics, npayloads, nwant,
                                timeout=300.0)
    s4 = await stats()
    _check_wave("6b next wave", got, nwant)
    d = _device_delta(s3, s4)
    if not _all_on_device(d, s4):
        raise AssertionError(f"6b: the next wave was not served by the device: {d}")
    log(f"    6b next wave: {d['routing_dispatches']} batches, all on the device")
    out["launches_packed_6b"] = (s4["routing_kernel_launches_packed"]
                                 - s1["routing_kernel_launches_packed"])
    out["failover_close_s"] = close_s

    # 6c: lone publishes, hybrid off (the device) and the default hybrid
    out["lone_ms_device"] = await _lone_publishes(dev_broker.port, LONE_PUBLISHES, "dev")
    out["lone_ms_hybrid"] = await _lone_publishes(hybrid_broker.port, LONE_PUBLISHES, "hyb")
    log(f"    6c: lone publish round trip over {LONE_PUBLISHES} publishes: p50 / p99 "
        f"{out['lone_ms_device'][0]:.3f} / {out['lone_ms_device'][1]:.3f} ms with "
        f"RMQTT_HYBRID_MAX=0 (device), {out['lone_ms_hybrid'][0]:.3f} / "
        f"{out['lone_ms_hybrid'][1]:.3f} ms with the default hybrid (host trie)")
    for c in [*subscribers, *hybrid_subscribers, *pubs]:
        await c.close()
    # 6g's traffic and wave run alone: 6a's brokers stop first
    for b in (dev_broker, hybrid_broker):
        await loop.run_in_executor(None, b.stop)
    t0 = time.perf_counter()
    out["plugin"] = await plugin.run(plugin_subscribers)
    PHASE_S["6g after 6a-c"] = time.perf_counter() - t0
    return out


def broker_waves(filters, topics, seed: int, wave: int) -> tuple:
    """The brokers' subscriptions (the filters dealt over 64 client ids)
    and waves, each (topics, payloads, expected deliveries): 6a's (the
    first ``wave`` cfg3 topics, also 6e's, 6f's and 6g's), 6b's two, and
    6g's plugin traffic (``plugin_traffic``: what the 64 subscribers must
    receive of the publishes the broker routes, as rewritten)."""
    t0 = time.perf_counter()
    subs = {f"s{k}": filters[k::BROKER_SUBSCRIBERS] for k in range(BROKER_SUBSCRIBERS)}
    oracle = oracle_router(subs)
    rng = random.Random(seed + 2)
    waves = []
    for name, tops in (("cfg3", topics[:wave]),
                       ("fail", gen_topics_uniform(rng, FAULT_WAVE)),
                       ("next", gen_topics_uniform(rng, FAULT_WAVE))):
        payloads = [b"%s-%d" % (name.encode(), i) for i in range(len(tops))]
        waves.append((tops, payloads, expected_deliveries(oracle, tops, payloads)))
    routed = [(t.routed, t.payload) for t in plugin_traffic() if t.routed is not None]
    waves.append(([t for t, _ in routed], [p for _, p in routed],
                  expected_deliveries(oracle, *zip(*routed))))
    del oracle
    gc.collect()
    gc.freeze()
    log(f"    DefaultRouter oracle: {len(filters)} filters, expected deliveries "
        f"{[sum(w[2].values()) for w in waves]} in {time.perf_counter() - t0:.2f}s")
    return subs, waves


def wave_prefix(wave, n: int) -> tuple:
    """The first ``n`` publishes of ``wave`` and their expected deliveries."""
    topics, payloads, want = wave
    keep = set(payloads[:n])
    return (topics[:n], payloads[:n],
            collections.Counter({k: v for k, v in want.items() if k[2] in keep}))


def phase_broker(subs, waves, retained_topics, sub_filters) -> dict:
    """Phase 6a-c and 6g → their numbers (``launches_packed``: the words
    kernel's launches in the broker process over 6a, from its stats before
    and after the wave of the first ``wave`` topics; 6g's under
    ``"plugin"``)."""
    log("[6] the broker: python -m rmqtt_tpu_torch.broker --router xla, and [6g] "
        "the plugin broker")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_broker_") as tmp:
        brokers = []
        plugin = None
        try:
            # every batch on the device; and the default hybrid (64)
            brokers.append(BrokerProcess("device", Path(tmp), {"RMQTT_HYBRID_MAX": "0"}))
            brokers.append(BrokerProcess("hybrid", Path(tmp), {"RMQTT_HYBRID_MAX": "64"}))
            plugin = PluginPhase(Path(tmp), subs, waves, retained_topics, sub_filters)
            t0 = time.perf_counter()
            for b in brokers:
                b.wait_ready()
            probe = {b.name: b.probe_s() for b in brokers}
            log(f"    two brokers listening in {time.perf_counter() - t0:.2f}s "
                f"(ports {[b.port for b in brokers]}); CUDA probe at start (s): "
                f"{probe}")
            out = asyncio.run(_broker_drive(*brokers, subs, waves, plugin))
            out["probe_s"] = probe
        except BaseException:
            for b in [*brokers, *(plugin.brokers if plugin else [])]:
                b.abort_with_stacks()
                log(f"    --- broker {b.name} log (tail) ---\n{b.tail(120)}")
            raise
        finally:
            for b in brokers:
                b.stop()
            if plugin is not None:
                plugin.stop()
    log(f"    {card_line()}: subscribe {out['subscribe_s']:.3f} s, publish to last "
        f"delivery {out['publish_s']:.3f} s ({out['deliveries_per_s']:.1f} messages/s), "
        f"lone publish p50/p99 {out['lone_ms_device'][0]:.3f}/"
        f"{out['lone_ms_device'][1]:.3f} ms (device) "
        f"{out['lone_ms_hybrid'][0]:.3f}/{out['lone_ms_hybrid'][1]:.3f} ms (hybrid)")
    return out


RETAINED_BROKER_TOPICS = 60_000  # 6d: retained messages, past the 50,000 threshold
RETAINED_PUBLISHERS = 8
RETAINED_SUBSCRIBERS = 64
RETAINED_INGEST_S = 120.0  # 6d: the limit on storing the retained messages
RETAINED_PACE = 256  # 6d: publishes a connection sends between PINGREQ round trips


def proc_cpu_s(pid: int) -> float:
    """CPU seconds (user + system) process ``pid`` has used, from /proc."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def _check_retained_scans(what: str, d: dict, n_filters: int) -> None:
    """Every SUBSCRIBE's retained lookup ran on the scanner, and both
    retained kernels launched."""
    if d["retained_scans"] != n_filters or d["retained_scan_launches_gather"] <= 0 \
            or d["retained_scan_launches_full"] <= 0:
        raise AssertionError(f"{what}: not every lookup ran on the retained kernels: {d}")


def _retained_delta(before: dict, after: dict) -> dict:
    keys = ("retained_scans", "retained_scan_launches_gather",
            "retained_scan_launches_full")
    return {k: after[k] - before[k] for k in keys}


async def _retained_ingest(broker, topics, payloads, what: str, base: int = 0,
                           publishers: int = RETAINED_PUBLISHERS) -> tuple:
    """``topics`` published retained at QoS 0 by ``publishers`` connections,
    each waiting for a PINGREQ round trip every ``RETAINED_PACE`` publishes
    → (seconds until the broker stores them all, past the ``base`` it held
    before, the publishers, its stats then)."""
    loop = asyncio.get_running_loop()
    pubs = [await LoadClient.connect(broker.port, f"rpub{k}")
            for k in range(publishers)]
    t0 = time.perf_counter()

    async def run(k: int, pub: LoadClient) -> None:
        for n, i in enumerate(range(k, len(topics), len(pubs))):
            pub.publish(topics[i], payloads[i], retain=True)
            if n % RETAINED_PACE == RETAINED_PACE - 1:
                # flow control: the broker has read what this connection
                # sent before it sends more. A publisher that runs a whole
                # socket buffer ahead of the broker stalls on the card's
                # host at ~10 publishes/s a connection (PERF.md §7).
                await pub.ping(RETAINED_INGEST_S)
        await pub.ping(RETAINED_INGEST_S)

    await asyncio.gather(*(run(k, p) for k, p in enumerate(pubs)))
    while (s := await loop.run_in_executor(None, broker.stats))["retaineds"] < base + len(topics):
        if time.perf_counter() - t0 > RETAINED_INGEST_S:
            raise AssertionError(f"{what}: {s['retaineds']} of {len(topics)} retained")
        await asyncio.sleep(0.1)
    return time.perf_counter() - t0, pubs, s


def retained_want(topics, payloads, filters, client_ids) -> collections.Counter:
    """The replay each client of ``client_ids`` must get when it subscribes
    its filter of ``filters`` over the retained ``topics``: a multiset of
    (client id, topic, payload), from ``RetainTree``."""
    oracle = RetainTree()
    for i, t in enumerate(topics):
        oracle.insert(t, i)
    want = collections.Counter()
    for cid, f in zip(client_ids, filters):
        for _lv, i in oracle.matches(f):
            want[(cid, topics[i], payloads[i])] += 1
    return want


async def _replays(port: int, client_ids, filters, want, out: dict) -> tuple:
    """Each client of ``client_ids`` connects and SUBSCRIBEs its filter of
    ``filters``; the first alone (its lookup builds the device mirror of
    the whole store on the broker's event loop), then the rest at once;
    each waits for its share of ``want`` → (received multiset of
    (client id, topic, payload) after a quiet window, the clients), the
    times in ``out``."""
    per_client = collections.Counter()
    for (cid, _t, _p), n in want.items():
        per_client[cid] += n
    subs = [await LoadClient.connect(port, cid) for cid in client_ids]
    t0 = time.perf_counter()
    await subs[0].subscribe([filters[0]])
    out["first_suback_s"] = time.perf_counter() - t0
    await subs[0].wait_count(per_client[subs[0].client_id], 300.0)
    out["first_replay_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    await asyncio.gather(*(c.subscribe([f]) for c, f in zip(subs[1:], filters[1:])))
    await asyncio.gather(*(c.wait_count(per_client[c.client_id], 600.0)
                           for c in subs[1:]))
    out["rest_replay_s"] = time.perf_counter() - t0
    await asyncio.sleep(0.5)  # a quiet window for extras
    got = collections.Counter()
    for c in subs:
        for topic, payload, _t in c.received:
            got[(c.client_id, topic, payload)] += 1
    return got, subs


async def _retained_drive(broker, topics, payloads, filters, want) -> dict:
    """6d against the running broker → its numbers."""
    out: dict = {}
    loop = asyncio.get_running_loop()

    async def stats():
        return await loop.run_in_executor(None, broker.stats)

    s_pre = await stats()
    cpu0 = proc_cpu_s(broker.proc.pid)
    out["publish_s"], pubs, s0 = await _retained_ingest(broker, topics, payloads, "6d")
    out["ingest_cpu_s"] = proc_cpu_s(broker.proc.pid) - cpu0
    log(f"    6d: {len(topics)} retained publishes stored in {out['publish_s']:.3f} s "
        f"({len(topics) / out['publish_s']:.1f} publishes/s) by "
        f"{RETAINED_PUBLISHERS} connections, each pausing for a PINGREQ round trip "
        f"every {RETAINED_PACE}; the broker's CPU time {out['ingest_cpu_s']:.2f} s")
    _log_split(s_pre, s0, out["publish_s"])
    m0 = await loop.run_in_executor(None, broker.metrics)
    got, subs = await _replays(broker.port, [f"rsub{j}" for j in range(len(filters))],
                               filters, want, out)
    s1 = await stats()
    m1 = await loop.run_in_executor(None, broker.metrics)
    for c in [*pubs, *subs]:
        await c.close()
    out["deliveries"] = sum(got.values())
    out["delta"] = _retained_delta(s0, s1)
    out["mirror_build_ms"] = s1["retained_mirror_build_ms"]
    out["retaineds"] = s1["retaineds"]
    out["drops"] = {k: m1.get(k, 0) - m0.get(k, 0) for k in m1
                    if k.startswith("messages.dropped") or k == "overload.retained_scans_paused"}
    out["got"] = got
    return out


def phase_retained_broker(retained_topics, filters) -> dict:
    """6d → its numbers (``delta``: the broker's retained-scan counters
    across the subscribes, from ``/api/v1/stats``)."""
    log("[6d] the broker's retained replay: [retain] tpu = true")
    topics = retained_topics[:RETAINED_BROKER_TOPICS]
    filters = filters[:RETAINED_SUBSCRIBERS]
    payloads = [b"r%d" % i for i in range(len(topics))]
    want = retained_want(topics, payloads, filters,
                         [f"rsub{j}" for j in range(len(filters))])
    # the client loop below allocates per publish: the ~0.6M expected
    # replays must not be rescanned by every full collection it triggers
    gc.collect()
    gc.freeze()
    log(f"    RetainTree oracle: {len(topics)} retained topics, {len(filters)} "
        f"subscriber filters, {sum(want.values())} replayed messages expected")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_retain_") as tmp:
        broker = BrokerProcess("retain", Path(tmp), {}, "[retain]\ntpu = true\n")
        try:
            broker.wait_ready()
            probe_s = broker.probe_s()
            log(f"    broker listening; CUDA probe at start {probe_s:.3f} s")
            out = asyncio.run(_retained_drive(broker, topics, payloads, filters, want))
            out["probe_s"] = probe_s
        except BaseException:
            broker.abort_with_stacks()
            log(f"    --- broker {broker.name} log (tail) ---\n{broker.tail(120)}")
            raise
        finally:
            broker.stop()
    got = out.pop("got")
    if got != want:
        missing, extra = want - got, got - want
        raise AssertionError(
            f"6d: the retained replay differs from the RetainTree oracle: "
            f"{sum(missing.values())} missing (e.g. {list(missing)[:3]}), "
            f"{sum(extra.values())} extra (e.g. {list(extra)[:3]})")
    d = out["delta"]
    _check_retained_scans("6d", d, len(filters))
    if any(out["drops"].values()):
        raise AssertionError(f"6d: messages dropped: {out['drops']}")
    log(f"    6d: first SUBSCRIBE: SUBACK after {out['first_suback_s']:.3f} s, replay done "
        f"after {out['first_replay_s']:.3f} s (mirror build "
        f"{out['mirror_build_ms']:.3f} ms on the event loop); the other "
        f"{len(filters) - 1} subscribers' replays in {out['rest_replay_s']:.3f} s; "
        f"{out['deliveries']} replayed messages equal to the RetainTree oracle "
        f"(multiset of client, topic, payload); scans {d}; drops {out['drops']}")
    log(f"    {card_line()}")
    return out


FABRIC_WORKERS = 4  # 6e: worker processes; worker 1 owns the table
FABRIC_SUBSCRIBERS = 16  # 6e, 6f: the first of 6a's 64 subscribers (the cut, PERF.md §4)
SESSION_EXPIRY_S = 7200  # 6f: the persistent sessions outlive the crash
RECOVERY_WAVE = 2_048  # 6f: publishes after the restart (cut from 6a's wave)


def _poll(cond, what: str, timeout: float) -> float:
    """Until ``cond()`` (polled every 0.2 s) → seconds it took; raises
    after ``timeout``."""
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"{what}: not within {timeout} s")
        time.sleep(0.2)
    return time.perf_counter() - t0


def _owner_wave_checks(what: str, s0: dict, s1: dict, n_topics: int) -> dict:
    """A wave's routing at the broker that owns the table: every publish
    matched there (no degraded publish, which a worker would match on its
    own table), every batch on the device, one words-kernel launch a batch."""
    d = _device_delta(s0, s1)
    d["items"] = s1["routing_dispatched_items"] - s0["routing_dispatched_items"]
    if d["items"] != n_topics:
        raise AssertionError(f"{what}: the owner matched {d['items']} of "
                             f"{n_topics} publishes")
    if not _all_on_device(d, s1) or not (
            d["routing_kernel_launches_packed"] == d["routing_dispatches"] > 0):
        raise AssertionError(f"{what}: words-kernel launches are not one a routing "
                             f"batch on the device: {d}")
    return d


async def _fabric_drive(broker, subs, wave, alongside) -> tuple:
    """6e against the running workers, with the coroutine ``alongside``
    (6f) run while they take their subscriptions → (6e's numbers, what
    ``alongside`` returned)."""
    out: dict = {}
    loop = asyncio.get_running_loop()

    async def stats():
        return await loop.run_in_executor(None, broker.stats)

    n_filters = sum(len(f) for f in subs.values())
    t0 = time.perf_counter()

    async def subscribe():
        clients = await connect_and_subscribe(broker.port, subs)
        out["subscribe_s"] = time.perf_counter() - t0
        # the other workers forward their sessions' filters to the owner
        while (s := await stats())["subscriptions"] < n_filters:
            if time.perf_counter() - t0 > 900:
                raise AssertionError(f"6e: the owner holds {s['subscriptions']} of "
                                     f"{n_filters} subscriptions")
            await asyncio.sleep(0.2)
        out["owner_table_s"] = time.perf_counter() - t0
        log(f"    6e subscribe: {n_filters} filters over {len(subs)} connections in "
            f"{out['subscribe_s']:.3f} s; the owner's table complete after "
            f"{out['owner_table_s']:.3f} s")
        return clients

    subscribers, other = await asyncio.gather(subscribe(), alongside)
    # the kernel places each connection on a worker; the submit path needs a
    # publisher on another worker than the owner, whose stats count its own
    base = (await stats())["connections"]
    pubs = [await LoadClient.connect(broker.port, f"pub{k}")
            for k in range(BROKER_PUBLISHERS)]
    for _ in range(100):
        if (await stats())["connections"] - base < len(pubs):
            break
        await pubs[-1].close()
        while (await stats())["connections"] - base >= len(pubs):
            await asyncio.sleep(0.05)
        pubs[-1] = await LoadClient.connect(broker.port, pubs[-1].client_id)
    else:
        raise AssertionError("6e: every publisher on the owner")
    topics, payloads, want = wave
    p0 = await loop.run_in_executor(None, broker.device)
    s0, f0 = await stats(), await loop.run_in_executor(None, broker.fabric)
    got, secs = await publish_wave(pubs, subscribers, topics, payloads, want,
                                   timeout=900.0)
    s1, f1 = await stats(), await loop.run_in_executor(None, broker.fabric)
    p1 = await loop.run_in_executor(None, broker.device)
    _check_wave("6e fabric wave", got, want)
    d = _owner_wave_checks("6e", s0, s1, len(topics))
    n_del = sum(got.values())
    served = {k: f1["counters"][k] - f0["counters"][k] for k in ("batches", "items")}
    if served["items"] <= 0:
        raise AssertionError(f"6e: no publish was submitted to the owner: {served}")
    out.update(publishes=len(topics), deliveries=n_del, publish_s=secs,
               deliveries_per_s=n_del / secs, launches_packed=d["routing_kernel_launches_packed"],
               launches_tail=d["routing_kernel_launches_fused_tail"],
               dispatches=d["routing_dispatches"], topics_per_batch=len(topics) / d["routing_dispatches"],
               submitted=served, owner_submit_fallbacks=f1["counters"]["submit_fallbacks"],
               registered_workers=f1["registered_workers"])
    log(f"    6e: {len(topics)} publishes -> {n_del} deliveries, first publish to last "
        f"delivery {secs:.3f} s = {n_del / secs:.1f} messages/s delivered "
        f"({len(topics) / secs:.1f} publishes/s); the owner: {d['routing_dispatches']} "
        f"routing batches ({out['topics_per_batch']:.2f} topics a batch), words "
        f"kernel launches {d['routing_kernel_launches_packed']}, every publish matched "
        f"there ({d['items']}; {served['items']} of them submitted by the other "
        f"workers in {served['batches']} fabric batches)")
    _log_split(s0, s1, secs)
    out["devprof"] = _check_device_profile(p0, p1, s0, s1)
    log(f"    6e owner /api/v1/device: {out['devprof']}")
    for c in [*subscribers, *pubs]:
        await c.close()
    return out, other


async def _recovery_write(broker, subs, rtopics, rpayloads) -> dict:
    """6f up to the crash: the retained store, then the persistent
    sessions' subscriptions (no retained replay; every SUBACK follows the
    journal's commit of its filters and of every record before them), then
    SIGKILL with the sessions connected."""
    out: dict = {}
    out["ingest_s"], pubs, _s = await _retained_ingest(broker, rtopics, rpayloads, "6f")
    for c in pubs:
        await c.close()
    t0 = time.perf_counter()
    sessions = await connect_and_subscribe(broker.port, subs, session_expiry=SESSION_EXPIRY_S,
                                           retain_handling=2)
    out["subscribe_s"] = time.perf_counter() - t0
    s = await asyncio.get_running_loop().run_in_executor(None, broker.stats)
    out["journal"] = {k: s[k] for k in ("durability_appends", "durability_commits",
                                        "durability_compactions", "durability_journal_len")}
    log(f"    6f: {len(rtopics)} retained stored in {out['ingest_s']:.3f} s, then "
        f"{sum(len(f) for f in subs.values())} filters subscribed on {len(subs)} "
        f"persistent sessions in {out['subscribe_s']:.3f} s; journal {out['journal']}")
    broker.kill()
    log(f"    SIGKILL: exit status {broker.proc.returncode}")
    for c in sessions:
        await c.close()
    return out


async def _recovery_drive(broker, subs, wave, filters, replay_want) -> dict:
    """6f after the restart: the sessions return, a wave over the recovered
    routes, then each session's retained replay."""
    out: dict = {}
    loop = asyncio.get_running_loop()

    async def stats():
        return await loop.run_in_executor(None, broker.stats)

    sessions = [await LoadClient.connect(broker.port, cid, session_expiry=SESSION_EXPIRY_S)
                for cid in subs]
    if not all(c.session_present for c in sessions):
        raise AssertionError("6f: a session was not recovered")
    pubs = [await LoadClient.connect(broker.port, f"pub{k}")
            for k in range(BROKER_PUBLISHERS)]
    topics, payloads, want = wave
    s0 = await stats()
    # the first publish after the restart pays the table's full upload
    first = collections.Counter({k: v for k, v in want.items() if k[2] == payloads[0]})
    got1, out["first_publish_s"] = await publish_wave(pubs[:1], sessions, topics[:1],
                                                      payloads[:1], first, timeout=300.0)
    p1 = await loop.run_in_executor(None, broker.device)
    rec = [r for r in p1.get("flight", []) if not r.get("abandoned")]
    out["first_dispatch"] = ({k: rec[-1].get(k) for k in ("batch", "total_ms",
                                                          "submit_ns", "stage_ns")}
                             if rec else None)
    out["full_upload_bytes"] = p1["uploads"]["full_bytes"]
    rest = want - first
    got, secs = await publish_wave(pubs, sessions, topics[1:], payloads[1:], rest,
                                   timeout=900.0)
    s1 = await stats()
    _check_wave("6f post-recovery wave", got + got1, want)
    d = _owner_wave_checks("6f", s0, s1, len(topics))
    n_del = sum(got.values()) + sum(got1.values())
    out.update(publishes=len(topics), deliveries=n_del, publish_s=secs,
               deliveries_per_s=n_del / secs, launches_packed=d["routing_kernel_launches_packed"],
               launches_tail=d["routing_kernel_launches_fused_tail"],
               dispatches=d["routing_dispatches"])
    log(f"    6f: first publish after the restart delivered in "
        f"{out['first_publish_s'] * 1e3:.3f} ms (its dispatch record {out['first_dispatch']}; "
        f"full uploads so far {p1['uploads']['full']}, {out['full_upload_bytes']} B); "
        f"the rest of the wave: {len(topics) - 1} publishes -> {sum(got.values())} "
        f"deliveries in {secs:.3f} s; {d['routing_dispatches']} routing batches, "
        f"words kernel launches {d['routing_kernel_launches_packed']}")
    # each session's retained replay, from the recovered store
    m0 = await loop.run_in_executor(None, broker.metrics)
    marks = {c.client_id: len(c.received) for c in sessions}
    per_client = collections.Counter()
    for (cid, _t, _p), n in replay_want.items():
        per_client[cid] += n
    t0 = time.perf_counter()
    await asyncio.gather(*(c.subscribe([f]) for c, f in zip(sessions, filters)))
    await asyncio.gather(*(c.wait_count(marks[c.client_id] + per_client[c.client_id], 600.0)
                           for c in sessions))
    out["replay_s"] = time.perf_counter() - t0
    await asyncio.sleep(0.5)  # a quiet window for extras
    replay = collections.Counter()
    for c in sessions:
        for topic, payload, _t in c.received[marks[c.client_id]:]:
            replay[(c.client_id, topic, payload)] += 1
    s2 = await stats()
    m1 = await loop.run_in_executor(None, broker.metrics)
    if replay != replay_want:
        missing, extra = replay_want - replay, replay - replay_want
        raise AssertionError(
            f"6f: the replay differs from the RetainTree oracle: "
            f"{sum(missing.values())} missing (e.g. {list(missing)[:3]}), "
            f"{sum(extra.values())} extra (e.g. {list(extra)[:3]})")
    out["retained"] = _retained_delta(s1, s2)
    r = out["retained"]
    _check_retained_scans("6f", r, len(filters))
    drops = {k: m1.get(k, 0) - m0.get(k, 0) for k in m1
             if k.startswith("messages.dropped")}
    if any(drops.values()):
        raise AssertionError(f"6f: messages dropped: {drops}")
    log(f"    6f: {len(sessions)} replays, {sum(replay.values())} messages equal to the "
        f"RetainTree oracle in {out['replay_s']:.3f} s; scans {r}; mirror build "
        f"{s2['retained_mirror_build_ms']:.3f} ms")
    for c in [*sessions, *pubs]:
        await c.close()
    return out


async def _recovery(brokers, tmp: Path, toml: str, subs, wave, retained, filters) -> dict:
    """All of 6f: its first broker's journal (``_recovery_write``), the
    SIGKILL, a restart on the same store, the recovered counts, then
    ``_recovery_drive`` → its numbers. Each broker started is appended to
    ``brokers`` (the caller stops them)."""
    loop = asyncio.get_running_loop()
    rtopics, rpayloads, replay_want = retained
    # before the crash, the default hybrid: the retained ingest meets an
    # empty table
    brokers.append(BrokerProcess("durable", tmp, {}, toml))
    await loop.run_in_executor(None, brokers[-1].wait_ready)
    out = await _recovery_write(brokers[-1], subs, rtopics, rpayloads)
    brokers.append(BrokerProcess("recovered", tmp, {"RMQTT_HYBRID_MAX": "0"}, toml))
    recovered = brokers[-1]
    await loop.run_in_executor(None, recovered.wait_ready, 900.0)
    out["restart_to_listening_s"] = time.perf_counter() - recovered.started
    s = await loop.run_in_executor(None, recovered.stats)
    rec = {k: s[f"durability_recovered_{k}"]
           for k in ("subs", "retained", "sessions", "inflight")}
    out.update(recovered=rec, recovery_ms=s["durability_recovery_ms"],
               probe_s=recovered.probe_s())
    log(f"    6f restarted: listening {out['restart_to_listening_s']:.3f} s after "
        f"the start (CUDA probe {out['probe_s']:.3f} s), recovery "
        f"{out['recovery_ms']:.3f} ms: {rec}")
    n_filters = sum(len(f) for f in subs.values())
    if (rec["subs"], rec["retained"], rec["sessions"]) != (
            n_filters, len(rtopics), len(subs)) or s["subscriptions"] != n_filters:
        raise AssertionError(f"6f: recovered {rec}, table {s['subscriptions']}")
    out.update(await _recovery_drive(recovered, subs, wave_prefix(wave, RECOVERY_WAVE),
                                     filters, replay_want))
    await loop.run_in_executor(None, recovered.stop)
    return out


def phase_fabric_recovery(subs, wave, retained_topics, filters) -> tuple:
    """6e and 6f → their numbers. 6e: ``--workers 4 --fabric --router xla``
    carrying the subscriptions of 6a's first ``FABRIC_SUBSCRIBERS``
    subscribers and ``wave`` (``launches_packed``: the owner's words-kernel
    launches over it). 6f: ``[durability]`` with ``--router xla`` and
    ``[retain] tpu = true``, the same subscribers' filters on as many
    persistent sessions, SIGKILL, then a restart on the same store, a wave
    of ``RECOVERY_WAVE`` of the same topics and a replay a session. To fit
    the run's time, all of 6f runs while 6e's workers take their
    subscriptions (the fabric forwards each filter to the owner: the
    longest part of the run); 6e's wave runs alone after both."""
    log(f"[6e] the fabric: --workers {FABRIC_WORKERS} --fabric --router xla, and "
        f"[6f] recovery: [durability] on a sqlite store, SIGKILL, restart")
    # cut to fit the run's time: the first FABRIC_SUBSCRIBERS subscribers
    # and their deliveries of the wave
    subs = dict(list(subs.items())[:FABRIC_SUBSCRIBERS])
    topics, payloads, want = wave
    wave = (topics, payloads,
            collections.Counter({k: n for k, n in want.items() if k[0] in subs}))
    rtopics = retained_topics[:RETAINED_BROKER_TOPICS]
    rpayloads = [b"r%d" % i for i in range(len(rtopics))]
    filters = filters[:len(subs)]
    retained = (rtopics, rpayloads, retained_want(rtopics, rpayloads, filters, list(subs)))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fabric_") as ftmp, \
            tempfile.TemporaryDirectory(prefix="chip_smoke_recovery_") as tmp:
        # compaction above the 1.06M records the phase journals: at the
        # default 4,096 each compaction re-folds the whole 1M-filter state on
        # a thread of the broker's process (PERF.md §7), and the run
        # measures the recovery, which folds the journal either way. The
        # first lines go to the [mqtt] section BrokerProcess opens: retained
        # messages without an expiry live an hour, not the default 5
        # minutes, so the ones stored before the crash outlive the phase
        toml = ("max_message_expiry = 3600.0\n[retain]\ntpu = true\n"
                f'[durability]\nenable = true\npath = "{tmp}/durability.db"\n'
                "compact_min = 2000000\n")
        brokers = []
        try:
            brokers.append(BrokerProcess("fabric", Path(ftmp), {"RMQTT_HYBRID_MAX": "0"},
                                         args=("--workers", str(FABRIC_WORKERS),
                                               "--fabric")))
            fabric = brokers[0]
            fabric.wait_ready()
            others = list(range(2, FABRIC_WORKERS + 1))
            _poll(lambda: fabric.fabric().get("registered_workers") == others,
                  "6e: workers registered with the owner", 300)
            ready_s = time.perf_counter() - fabric.started
            probes = fabric.probes_s()
            if len(probes) != FABRIC_WORKERS:
                raise AssertionError(f"6e: {len(probes)} CUDA probes in the log")
            log(f"    6e: {FABRIC_WORKERS} workers up and registered {ready_s:.2f} s "
                f"after the start; CUDA probe at each start (s): {probes}")
            out_e, out = asyncio.run(_fabric_drive(
                fabric, subs, wave,
                _recovery(brokers, Path(tmp), toml, subs, wave, retained, filters)))
            text = fabric.log_path.read_text(errors="replace")
            if "died" in text or "crash-looping" in text:
                raise AssertionError("6e: a worker died during the run")
            out_e.update(probe_s=probes, ready_s=ready_s)
        except BaseException:
            for b in brokers:
                b.abort_with_stacks()
                log(f"    --- broker {b.name} log (tail) ---\n{b.tail(160)}")
            raise
        finally:
            for b in brokers:
                b.stop()
    log(f"    {card_line()}: 6e subscribe {out_e['subscribe_s']:.3f} s, "
        f"{out_e['deliveries_per_s']:.1f} deliveries/s through {FABRIC_WORKERS} workers")
    return out_e, out


# --------------------------------------------------------------- phase 6g
PLUGIN_WAVE = RECOVERY_WAVE  # 6g: publishes of 6a's wave after the plugin checks
PLUGIN_REPLAYS = 16  # 6g start B: subscribers, one filter of 6d's mix each
#: 6g: connections of its retained ingest. Every batch is on the card
#: there, one routing batch a few ms whatever it holds, so the batches
#: must be wide: 8 connections took 92.6 s for the 60,000 on an H100
#: (PERF.md §5)
PLUGIN_INGEST_PUBLISHERS = 32
BRIDGE_MESSAGES = 256  # 6g: in through the ingress bridge, out through the egress
SHARE_MEMBERS = 4
SYS_INTERVAL_S = 2.0  # 6g: sys-topic's publish_interval
DENIED_USER = "blocked"  # 6g: the one user the auth-http endpoint refuses
#: 6g's plugins in their start order: the counter first, so that the
#: retainer's load at start lies between two plugins' "started" log lines
PLUGIN_STARTUPS = ("rmqtt-counter", "rmqtt-retainer", "rmqtt-sys-topic", "rmqtt-acl",
                   "rmqtt-auth-http", "rmqtt-web-hook", "rmqtt-topic-rewrite",
                   "rmqtt-auto-subscription", "rmqtt-shared-subscription",
                   "rmqtt-bridge-ingress-mqtt", "rmqtt-bridge-egress-mqtt")
#: the plugins that act once for every subscribed filter (sys-topic
#: publishes a $SYS event, routed on the card; the web hook posts it), held
#: unloaded over the plugin API while the 1M filters are subscribed
PER_FILTER_PLUGINS = ("rmqtt-sys-topic", "rmqtt-web-hook")
HOOK_EVENTS = ("client_connected", "session_subscribed", "client_disconnected")
SHARE_FILTER = "$share/g6/plug/work/+"
REWRITE = ("plug/legacy/#", r"^plug/legacy/(.+)$", "plug/v2/$1")  # filter, regex, dest
ACL_CLIENT = "plug-mallory"
ACL_DENIED_FILTER = "plug/acl/secret/#"
AUTO_FILTER = "plug/inbox/%c"
INGRESS_PREFIX = "plug/from-remote/"
EGRESS_PREFIX = "card/"


def rewritten(topic: str) -> str:
    """6g's topic-rewrite rule applied to a published topic."""
    src, rx, dest = REWRITE
    m = re.match(rx, topic)
    return dest.replace("$1", m.group(1)) if m and match_filter(src, topic) else topic


#: the plugin clients of 6g and the filters each SUBSCRIBEs (the
#: auto-subscription adds ``AUTO_FILTER`` to every client at CONNECT)
PLUGIN_SUBS = {
    **{f"plug-share{k}": [SHARE_FILTER] for k in range(SHARE_MEMBERS)},
    "plug-auto": [],
    # the rewrite applies to publishes: the new namespace receives them, the
    # old one nothing
    "plug-rewrite": [rewritten("plug/legacy/+/temp"), "plug/legacy/#"],
    ACL_CLIENT: [ACL_DENIED_FILTER, "plug/acl/open/+"],
    "plug-bridge": [INGRESS_PREFIX + "#"],
}
Traffic = collections.namedtuple("Traffic", "publisher topic routed payload")


def plugin_traffic() -> list:
    """6g's publishes, each (publisher, topic as published, topic the
    broker routes or None where the ACL drops it, payload): a shared group's
    namespace, the auto-subscribed inbox of ``plug-auto``, the rewritten
    namespace, the ACL's namespace from an allowed and the denied
    publisher, the ingress bridge's messages (published on the remote
    broker, routed here under ``INGRESS_PREFIX``) and the egress bridge's."""
    out = []
    for i in range(64):
        out.append(Traffic("plug-pub", f"plug/work/{i}", f"plug/work/{i}", b"share-%d" % i))
    for i in range(8):
        out.append(Traffic("plug-pub", "plug/inbox/plug-auto", "plug/inbox/plug-auto",
                           b"auto-%d" % i))
    for i in range(32):
        t = f"plug/legacy/d{i}/temp"
        out.append(Traffic("plug-pub", t, rewritten(t), b"rewrite-%d" % i))
    for i in range(32):
        out.append(Traffic("plug-pub", f"plug/acl/open/{i}", f"plug/acl/open/{i}",
                           b"acl-%d" % i))
        out.append(Traffic(ACL_CLIENT, f"plug/acl/open/m{i}", None, b"denied-%d" % i))
    for i in range(BRIDGE_MESSAGES):
        out.append(Traffic("remote-pub", f"bridge/in/{i}", f"{INGRESS_PREFIX}bridge/in/{i}",
                           b"ingress-%d" % i))
        out.append(Traffic("plug-pub", f"plug/to-remote/{i}", f"plug/to-remote/{i}",
                           b"egress-%d" % i))
    return out


def plugin_client_want(traffic) -> collections.Counter:
    """What 6g's plugin clients must receive of ``traffic``: each holds its
    filters, less the one the ACL refuses, plus its auto-subscribed inbox;
    a shared group takes one delivery of each matching topic, counted under
    its filter. → multiset of (client id or the group's filter, topic,
    payload)."""
    held = {cid: [f for f in fs if f != ACL_DENIED_FILTER]
            + [AUTO_FILTER.replace("%c", cid)] for cid, fs in PLUGIN_SUBS.items()}
    want = collections.Counter()
    for t in traffic:
        if t.routed is None:
            continue
        keys = set()
        for cid, filters in held.items():
            for f in filters:
                group, stripped = parse_shared(f)
                if match_filter(stripped, t.routed):
                    keys.add(f if group else cid)
        for k in keys:
            want[(k, t.routed, t.payload)] += 1
    return want


class HookServer:
    """The HTTP endpoint of 6g's auth-http and web-hook plugins, on a thread
    of this process: ``/auth`` allows every user but ``DENIED_USER``,
    ``/hook`` records each event as (action, client id)."""

    def __init__(self) -> None:
        import http.server
        import threading
        import urllib.parse

        events, lock = [], threading.Lock()

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                if self.path == "/auth":
                    form = urllib.parse.parse_qs(body.decode())
                    allowed = form.get("username", [""])[0] != DENIED_USER
                    code, out = (200, b"allow") if allowed else (403, b"deny")
                else:
                    event = json.loads(body)
                    with lock:
                        events.append((event["action"], event.get("clientid")))
                    code, out = 200, b"ok"
                self.send_response(code)
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

            def log_message(self, *_args):
                pass

        self.events, self._lock = events, lock
        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.server.server_address[1]
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def take(self) -> collections.Counter:
        """The events recorded so far, cleared."""
        with self._lock:
            out = collections.Counter(self.events)
            self.events.clear()
        return out

    def count(self) -> int:
        with self._lock:
            return len(self.events)

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()


def plugin_toml(tmp: Path, hook_port: int, remote_port: int) -> str:
    """6g's broker configuration after BrokerProcess's ``[mqtt]`` line:
    messages live an hour (the retained ones outlive the restart), the
    retained store on the card past 50,000, and ``PLUGIN_STARTUPS``."""
    http = f"http://127.0.0.1:{hook_port}"
    src, rx, dest = REWRITE
    acl = ", ".join(
        f'{{ permission = "deny", action = "{a}", clientid = "{ACL_CLIENT}", '
        f'topics = ["{t}"] }}' for a, t in (("publish", "plug/acl/#"),
                                             ("subscribe", ACL_DENIED_FILTER)))
    startups = ", ".join(f'"{p}"' for p in PLUGIN_STARTUPS)
    return (
        "max_message_expiry = 3600.0\n[retain]\ntpu = true\n"
        f"[plugins]\ndefault_startups = [{startups}]\n"
        f"[plugins.rmqtt-sys-topic]\npublish_interval = {SYS_INTERVAL_S}\n"
        f'[plugins.rmqtt-retainer]\npath = "{tmp}/retainer.db"\n'
        f'[plugins.rmqtt-acl]\nrules = [{acl}, {{ permission = "allow" }}]\n'
        f'[plugins.rmqtt-auth-http]\nhttp_auth_req = "{http}/auth"\n'
        f'[plugins.rmqtt-web-hook]\nurls = ["{http}/hook"]\n'
        f"events = {json.dumps(list(HOOK_EVENTS))}\n"
        f"[plugins.rmqtt-topic-rewrite]\nrules = [{{ source_topic_filter = \"{src}\", "
        f"dest_topic = \"{dest}\", regex = '{rx}' }}]\n"
        f'[plugins.rmqtt-auto-subscription]\nsubscribes = [["{AUTO_FILTER}", 0]]\n'
        '[plugins.rmqtt-shared-subscription]\nstrategy = "round_robin_per_group"\n'
        f"[plugins.rmqtt-bridge-ingress-mqtt]\nport = {remote_port}\n"
        f'local_prefix = "{INGRESS_PREFIX}"\n'
        'subscribes = [{ filter = "bridge/in/#", qos = 0 }]\n'
        f"[plugins.rmqtt-bridge-egress-mqtt]\nport = {remote_port}\n"
        f'remote_prefix = "{EGRESS_PREFIX}"\nforwards = ["plug/to-remote/#"]\n')


def _plugin_log_gap_ms(log_text: str, first: str, second: str) -> float:
    """Milliseconds between the "plugin <first> ... started" and "plugin
    <second> ... started" lines of a broker's log (their timestamps)."""
    def at(name):
        m = re.search(r"^(\S+ \S+) .*plugin %s v\S+ started" % re.escape(name), log_text,
                      re.M)
        if m is None:
            raise AssertionError(f"6g: no start of {name} in the broker's log")
        day, clock = m.group(1).split(" ")[0], m.group(1).split(" ")[1]
        hms, ms = clock.split(",")
        return time.mktime(time.strptime(f"{day} {hms}", "%Y-%m-%d %H:%M:%S")) * 1e3 + int(ms)

    return at(second) - at(first)


def _check_plugin_routing(what: str, s0: dict, s1: dict) -> dict:
    """Every routing batch between the two stats ran on the device and the
    words kernel launched (counts compared as at least: sys-topic's own
    publishes are routing batches too)."""
    d = _device_delta(s0, s1)
    if not _all_on_device(d, s1) or d["routing_kernel_launches_packed"] <= 0:
        raise AssertionError(f"{what}: not every batch ran on the device: {d}")
    return d


def _check_sys_hbm(payload: bytes) -> dict:
    """sys-topic's ``device/hbm``: the occupancy model and the CUDA
    allocator's census."""
    hbm = json.loads(payload)
    if not (hbm.get("modeled_bytes", 0) > 0 and hbm.get("live_arrays_bytes", 0) > 0):
        raise AssertionError(f"6g: $SYS device/hbm without the census: {hbm}")
    return {k: hbm.get(k) for k in ("modeled_bytes", "live_arrays_bytes",
                                    "device_bytes_in_use")}


class PluginPhase:
    """6g, the plugin broker: ``--router xla`` (``RMQTT_HYBRID_MAX=0``)
    with ``PLUGIN_STARTUPS`` configured, the MQTT bridges pointed at a
    ``--router trie`` broker of the port, auth-http and the web hook at a
    ``HookServer``. ``prepare`` (run beside 6a's subscribes): 6d's 60,000
    retained messages, then 6a's 1M filters on 64 MQTT 5 sessions (no
    retained replay) with the per-filter plugins unloaded. ``run`` (after
    6a-c): the plugin clients and traffic, a ``PLUGIN_WAVE`` wave, SIGTERM,
    then start B on the retainer's store and ``PLUGIN_REPLAYS`` replays."""

    def __init__(self, tmp: Path, subs, waves, retained_topics, sub_filters) -> None:
        self.tmp, self.subs = tmp, subs
        self.wave = wave_prefix(waves[0], PLUGIN_WAVE)
        self.traffic_want = waves[3][2]
        self.rtopics = retained_topics[:RETAINED_BROKER_TOPICS]
        self.rpayloads = [b"r%d" % i for i in range(len(self.rtopics))]
        broad = next(f for f in sub_filters if f.startswith("+"))
        self.replay_filters = [*sub_filters[:PLUGIN_REPLAYS - 1], broad]
        self.hooks = HookServer()
        self.out: dict = {}
        self.brokers: list = []
        self.remote = self._start("remote", {}, "", router="trie")
        self.toml = plugin_toml(tmp, self.hooks.port, self.remote.port)
        self.broker = self._start("plugins", {"RMQTT_HYBRID_MAX": "0"}, self.toml)
        self.expected_events: collections.Counter = collections.Counter()

    def _start(self, name, env, toml, router="") -> "BrokerProcess":
        b = BrokerProcess(name, self.tmp, env, toml, router=router)
        self.brokers.append(b)
        return b

    def stop(self) -> None:
        for b in self.brokers:
            b.stop()
        self.hooks.stop()

    async def _api(self, method: str, path: str):
        return await asyncio.get_running_loop().run_in_executor(
            None, self.broker._http, method, path)

    async def _stats(self, broker=None) -> dict:
        return await asyncio.get_running_loop().run_in_executor(
            None, (broker or self.broker).stats)

    async def _metrics(self) -> dict:
        return await asyncio.get_running_loop().run_in_executor(None, self.broker.metrics)

    async def _hook_events(self, what: str) -> None:
        """The web hook posted exactly ``expected_events`` (cleared)."""
        want, t0 = self.expected_events, time.perf_counter()
        while self.hooks.count() < sum(want.values()):
            if time.perf_counter() - t0 > 120:
                break
            await asyncio.sleep(0.1)
        await asyncio.sleep(0.3)  # a quiet window for extras
        got = self.hooks.take()
        if got != want:
            raise AssertionError(f"6g {what}: web-hook events differ from the client "
                                 f"side: missing {want - got}, extra {got - want}")
        self.expected_events = collections.Counter()

    async def connect(self, cid: str, **kw) -> LoadClient:
        c = await LoadClient.connect(self.broker.port, cid, **kw)
        self.expected_events[("client_connected", cid)] += 1
        return c

    async def close(self, clients) -> None:
        for c in clients:
            await c.close()
            self.expected_events[("client_disconnected", c.client_id)] += 1

    async def prepare(self) -> list:
        """Start A up to the plugin checks → the 64 subscribers."""
        out = self.out
        b = self.broker
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, self.remote.wait_ready)
        await loop.run_in_executor(None, b.wait_ready)
        out["probe_s"] = b.probe_s()
        # sys-topic retains its version at its first tick
        while (base := (await self._stats())["retaineds"]) < 1:
            await asyncio.sleep(0.1)
        out["ingest_s"], pubs, _s = await _retained_ingest(
            b, self.rtopics, self.rpayloads, "6g", base=base,
            publishers=PLUGIN_INGEST_PUBLISHERS)
        for c in pubs:
            self.expected_events[("client_connected", c.client_id)] += 1
        await self.close(pubs)
        await self._hook_events("retained ingest")
        for name in PER_FILTER_PLUGINS:
            if not (await self._api("PUT", f"/api/v1/plugins/{name}/unload"))["unloaded"]:
                raise AssertionError(f"6g: {name} did not unload")
        m0 = await self._metrics()
        t0 = time.perf_counter()
        subscribers = await connect_and_subscribe(b.port, self.subs,
                                                  session_expiry=SESSION_EXPIRY_S,
                                                  retain_handling=2)
        out["subscribe_s"] = time.perf_counter() - t0
        m1 = await self._metrics()
        n_filters = sum(len(f) for f in self.subs.values())
        counted = {k: m1.get(f"hook.{k}", 0) - m0.get(f"hook.{k}", 0)
                   for k in ("client_connected", "session_subscribed")}
        if counted != {"client_connected": len(self.subs), "session_subscribed": n_filters}:
            raise AssertionError(f"6g: the counter plugin counted {counted} over the "
                                 f"subscribe of {n_filters} filters")
        for name in PER_FILTER_PLUGINS:
            if not (await self._api("PUT", f"/api/v1/plugins/{name}/load"))["loaded"]:
                raise AssertionError(f"6g: {name} did not load again")
        log(f"    6g: {len(self.rtopics)} retained stored in {out['ingest_s']:.3f} s by "
            f"{PLUGIN_INGEST_PUBLISHERS} connections, "
            f"then {n_filters} filters on {len(self.subs)} MQTT 5 sessions in "
            f"{out['subscribe_s']:.3f} s with {', '.join(PER_FILTER_PLUGINS)} unloaded; "
            f"the counter plugin: {counted}")
        return subscribers

    async def _plugin_checks(self, subscribers) -> None:
        """The plugin clients and ``plugin_traffic`` on the card's table."""
        out, b = self.out, self.broker
        pubs = {}
        clients = {}
        granted = {}
        for cid, filters in PLUGIN_SUBS.items():
            clients[cid] = await self.connect(cid)
            if filters:
                granted[cid] = await clients[cid].subscribe(filters, check=False)
                self.expected_events.update(("session_subscribed", cid)
                                            for rc in granted[cid] if rc < 0x80)
        want_codes = {cid: [0x80 if f == ACL_DENIED_FILTER else 0 for f in fs]
                      for cid, fs in PLUGIN_SUBS.items() if fs}
        if granted != want_codes:
            raise AssertionError(f"6g: SUBACK codes {granted}, want {want_codes}")
        try:
            await LoadClient.connect(b.port, "plug-blocked", username=DENIED_USER)
            raise AssertionError("6g: auth-http let the denied user connect")
        except ConnectionError:
            pass
        sysc = await self.connect("plug-sys")
        await sysc.subscribe(["$SYS/brokers/+/device/#"])
        self.expected_events[("session_subscribed", "plug-sys")] += 1
        pubs["plug-pub"] = await self.connect("plug-pub")
        pubs[ACL_CLIENT] = clients[ACL_CLIENT]
        pubs["remote-pub"] = await LoadClient.connect(self.remote.port, "remote-pub")
        rsub = await LoadClient.connect(self.remote.port, "remote-sub")
        await rsub.subscribe([EGRESS_PREFIX + "#"])
        traffic = plugin_traffic()
        want = self.traffic_want + plugin_client_want(traffic)
        group = [f"plug-share{k}" for k in range(SHARE_MEMBERS)]
        watched = [*subscribers, *(c for cid, c in clients.items())]
        marks = {c.client_id: len(c.received) for c in watched}
        per_key = collections.Counter()
        for (k, _t, _p), n in want.items():
            per_key[k] += n
        s0 = await self._stats()
        t0 = time.perf_counter()
        for t in traffic:
            pubs[t.publisher].publish(t.topic, t.payload)
        for p in pubs.values():
            await p.ping()

        def key(cid):
            return SHARE_FILTER if cid in group else cid

        while True:
            have = collections.Counter()
            for c in watched:
                have[key(c.client_id)] += len(c.received) - marks[c.client_id]
            if all(have[k] >= n for k, n in per_key.items()) and \
                    len(rsub.received) >= BRIDGE_MESSAGES:
                break
            if time.perf_counter() - t0 > 300:
                raise AssertionError(f"6g: plugin traffic not delivered: "
                                     f"{ {k: (have[k], n) for k, n in per_key.items() if have[k] < n} }"
                                     f", egress {len(rsub.received)}")
            await asyncio.sleep(0.05)
        out["traffic_s"] = time.perf_counter() - t0
        await asyncio.sleep(1.0)  # a quiet window for extras
        got = collections.Counter()
        for c in watched:
            for topic, payload, _t in c.received[marks[c.client_id]:]:
                got[(key(c.client_id), topic, payload)] += 1
        _check_wave("6g plugin traffic", got, want)
        remote_want = collections.Counter(
            (EGRESS_PREFIX + t.topic, t.payload) for t in traffic
            if t.topic.startswith("plug/to-remote/"))
        remote_got = collections.Counter((t, p) for t, p, _ in rsub.received)
        if remote_got != remote_want:
            raise AssertionError(f"6g: the egress bridge delivered {sum(remote_got.values())}"
                                 f" of {BRIDGE_MESSAGES} to the remote broker")
        s1 = await self._stats()
        out["traffic"] = _check_plugin_routing("6g plugin traffic", s0, s1)
        # sys-topic's device/hbm: the occupancy model and the allocator's census
        while not any(t.endswith("/device/hbm") for t, _p, _ in sysc.received):
            if time.perf_counter() - t0 > 60:
                raise AssertionError(f"6g: no $SYS device/hbm: {[t for t, *_ in sysc.received]}")
            await asyncio.sleep(0.1)
        out["sys_hbm"] = _check_sys_hbm(next(p for t, p, _ in reversed(sysc.received)
                                             if t.endswith("/device/hbm")))
        out["sys_leaves"] = sorted({t.rsplit("/", 1)[1] for t, *_ in sysc.received})
        n_del = sum(got.values())
        log(f"    6g plugins: {len(traffic)} publishes ({BRIDGE_MESSAGES} in through the "
            f"ingress bridge) -> {n_del} deliveries equal to the oracle in "
            f"{out['traffic_s']:.3f} s; {BRIDGE_MESSAGES} out through the egress bridge; "
            f"SUBACK {granted[ACL_CLIENT]} for {ACL_CLIENT}; {DENIED_USER!r} refused; "
            f"routing {out['traffic']}; $SYS device leaves {out['sys_leaves']}, "
            f"hbm {out['sys_hbm']}")
        await rsub.close()
        await pubs["remote-pub"].close()
        self._plugin_clients = [*clients.values(), sysc, pubs["plug-pub"]]

    async def run(self, subscribers) -> dict:
        """Start A from the plugin checks, the SIGTERM, start B → 6g's
        numbers."""
        out, b = self.out, self.broker
        m0 = await self._metrics()
        await self._plugin_checks(subscribers)
        # the wave, every batch on the card
        wpubs = [await self.connect(f"pub{k}") for k in range(BROKER_PUBLISHERS)]
        topics, payloads, want = self.wave
        s0 = await self._stats()
        got, secs = await publish_wave(wpubs, subscribers, topics, payloads, want,
                                       timeout=900.0)
        s1 = await self._stats()
        _check_wave("6g wave", got, want)
        d = _check_plugin_routing("6g wave", s0, s1)
        out.update(wave_s=secs, wave_deliveries=sum(got.values()),
                   wave_deliveries_per_s=sum(got.values()) / secs,
                   wave_batches=d["routing_dispatches"],
                   launches_packed=(d["routing_kernel_launches_packed"]
                                    + out["traffic"]["routing_kernel_launches_packed"]),
                   launches_tail=(d["routing_kernel_launches_fused_tail"]
                                  + out["traffic"]["routing_kernel_launches_fused_tail"]))
        log(f"    6g wave: {len(topics)} publishes -> {sum(got.values())} deliveries in "
            f"{secs:.3f} s ({sum(got.values()) / secs:.1f} messages/s); "
            f"{d['routing_dispatches']} routing batches (sys-topic's among them), "
            f"words kernel launches {d['routing_kernel_launches_packed']}")
        plugin = await self._api("GET", "/api/v1/plugins/rmqtt-retainer")
        s = await self._stats()
        out["persisted"] = plugin["attrs"]["persisted"]
        if not (plugin["active"] and out["persisted"] == s["retaineds"]
                == len(self.rtopics) + 1):
            raise AssertionError(f"6g: the retainer persisted {out['persisted']}, the store "
                                 f"holds {s['retaineds']} (want {len(self.rtopics)} and "
                                 f"$SYS version)")
        await self.close([*self._plugin_clients, *wpubs, *subscribers])
        m1 = await self._metrics()
        counted = {k: m1.get(f"hook.{k}", 0) - m0.get(f"hook.{k}", 0) for k in HOOK_EVENTS}
        client_side = {k: sum(n for (a, _c), n in self.expected_events.items() if a == k)
                       for k in HOOK_EVENTS}
        if counted != client_side:
            raise AssertionError(f"6g: the counter plugin counted {counted}, the client "
                                 f"side {client_side}")
        await self._hook_events("plugin checks")
        log(f"    6g: the retainer persisted {out['persisted']} messages; the counter "
            f"plugin and the web hook agree with the client side: {client_side}")
        # SIGTERM: the retainer's stop closes its store
        t0 = time.perf_counter()
        await asyncio.get_running_loop().run_in_executor(None, b.stop)
        out["stop_s"] = time.perf_counter() - t0
        await self._restart()
        return out

    async def _restart(self) -> None:
        """Start B: the same configuration on the retainer's store, and
        ``PLUGIN_REPLAYS`` retained replays on the card's kernels."""
        out = self.out
        loop = asyncio.get_running_loop()
        b = self.broker = self._start("plugins-restart", {"RMQTT_HYBRID_MAX": "0"},
                                      self.toml)
        await loop.run_in_executor(None, b.wait_ready)
        out["restart_to_listening_s"] = time.perf_counter() - b.started
        out["retainer_load_ms"] = _plugin_log_gap_ms(
            b.log_path.read_text(errors="replace"), PLUGIN_STARTUPS[0], "rmqtt-retainer")
        s0 = await self._stats()
        if s0["retaineds"] != len(self.rtopics) + 1:
            raise AssertionError(f"6g start B: {s0['retaineds']} retained messages loaded")
        from rmqtt_tpu_torch import __version__
        sys_topic = "$SYS/brokers/1/version"  # node id 1, the default
        cids = [f"replay{j}" for j in range(len(self.replay_filters))]
        want = retained_want([*self.rtopics, sys_topic],
                             [*self.rpayloads, __version__.encode()],
                             self.replay_filters, cids)
        got, subs = await _replays(b.port, cids, self.replay_filters, want, out)
        s1 = await self._stats()
        for c in subs:
            await c.close()
        if got != want:
            missing, extra = want - got, got - want
            raise AssertionError(
                f"6g start B: the replay differs from the RetainTree oracle: "
                f"{sum(missing.values())} missing (e.g. {list(missing)[:3]}), "
                f"{sum(extra.values())} extra (e.g. {list(extra)[:3]})")
        out["retained"] = r = _retained_delta(s0, s1)
        out["mirror_build_ms"] = s1["retained_mirror_build_ms"]
        _check_retained_scans("6g start B", r, len(self.replay_filters))
        if not out["mirror_build_ms"] > 0:
            raise AssertionError("6g start B: no retained mirror was built")
        out["replayed"] = sum(got.values())
        log(f"    6g start B (start A stopped in {out['stop_s']:.3f} s after its SIGTERM): "
            f"listening {out['restart_to_listening_s']:.3f} s after the "
            f"start (the retainer's load of {s0['retaineds']} rows "
            f"{out['retainer_load_ms']:.0f} ms, before the listeners); "
            f"{len(subs)} replays, {out['replayed']} messages equal to the RetainTree "
            f"oracle: the first {out['first_replay_s']:.3f} s (mirror build "
            f"{out['mirror_build_ms']:.3f} ms), the rest {out['rest_replay_s']:.3f} s; "
            f"scans {r}")
        await loop.run_in_executor(None, b.stop)


# --------------------------------------------------------------- phase 6h
SCENARIO_PROFILE = "storm_churn_overload_kill"
SCENARIO_LIMIT_S = 150.0  # 6h: the phase's own hard limit


def check_scenario(report: dict, stats: dict) -> None:
    """6h's verdict on the scenario report and the broker's last
    ``/api/v1/stats``: raises unless the run is green by its own SLO
    engine, every phase passed, the device kill failed over and switched
    back with no QoS 1 message lost, and batches reached the card."""
    if not report["ok"] or report["errors"]:
        raise AssertionError(f"6h: the profile failed: ok={report['ok']}, errors "
                             f"{report['errors']}, phases {report['phases']}")
    bad = [p["name"] for p in report["phases"] if not p.get("ok")]
    if bad:
        raise AssertionError(f"6h: phases failed: {bad}")
    kill = next(p for p in report["phases"] if p["name"] == "failpoint_kill")
    if not ((kill["failovers"] or 0) >= 1 and kill["triggers"] > 0
            and kill["delivered"] == kill["published"]
            and kill["failover_state"] == "device"):
        raise AssertionError(f"6h: the device kill did not fail over and back "
                             f"losslessly: {kill}")
    if report["latency"].get("kernel.dispatch", {}).get("count", 0) <= 0:
        raise AssertionError("6h: no kernel.dispatch recorded: no batch reached the card")
    if min(stats.get("routing_kernel_launches_packed", 0),
           stats.get("routing_kernel_launches_fused_tail", 0)) <= 0:
        raise AssertionError(f"6h: the broker launched no words or fused-tail kernel: "
                             f"{ {k: v for k, v in stats.items() if 'kernel' in k} }")


def phase_scenario() -> dict:
    """6h: the scenario matrix's all-device profile through the port's
    ``run_profile``: a ``--router xla`` broker subprocess
    (``RMQTT_HYBRID_MAX=0``, no routing cache) takes a connect storm,
    subscribe churn, a QoS 0 overload burst and a ``device.dispatch``
    failpoint kill at once, judged by its own SLO engine. The broker's
    ``/api/v1/stats`` is read just before the profile stops it, for its
    words-kernel launches. → the report, with those stats under
    ``"broker_stats"``."""
    log(f"[6h] the scenario matrix: run_profile({SCENARIO_PROFILE!r}) on a "
        f"--router xla broker")
    stats: dict = {}
    stop = SC.ScenarioBroker.stop

    async def stop_after_stats(broker) -> None:
        try:
            stats.update((await broker.api("/api/v1/stats"))[0]["stats"])
        except (OSError, RuntimeError) as e:  # a timeout is an OSError
            log(f"    the broker's stats could not be read: {type(e).__name__}: {e}")
        finally:
            await stop(broker)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_scenario_") as tmp:
        SC.ScenarioBroker.stop = stop_after_stats
        try:
            report = asyncio.run(asyncio.wait_for(
                SC.run_profile_async(SCENARIO_PROFILE, workdir=tmp), SCENARIO_LIMIT_S))
            check_scenario(report, stats)
        except BaseException:
            broker_log = Path(tmp) / "broker.log"
            if broker_log.exists():
                tail = broker_log.read_bytes()[-6000:].decode(errors="replace")
                log(f"    --- scenario broker log (tail) ---\n{tail}")
            raise
        finally:
            SC.ScenarioBroker.stop = stop
    for p in report["phases"]:
        log(f"    phase {json.dumps(p, sort_keys=True)}")
    lat = {k: report["latency"][k] for k in ("publish.e2e", "kernel.dispatch")}
    log(f"    {card_line()}: goodput {json.dumps(report['goodput'], sort_keys=True)}; "
        f"p50/p99 ms " + ", ".join(f"{k} {v['p50_ms']}/{v['p99_ms']} ({v['count']})"
                                   for k, v in lat.items())
        + f"; drops {report['drops']}; duration {report['duration_s']} s; words "
        f"kernel launches {stats['routing_kernel_launches_packed']}")
    for o in report["slo"]["objectives"]:
        log(f"    slo {o['name']} ({o['kind']}): compliant {o['compliant']}, ratio "
            f"{o['ratio']} against {o['target']}, state {o['state']}")
    report["broker_stats"] = stats
    return report


def phase_profile(router: TorchRouter, topics, batch: int) -> None:
    """One pipelined pass through the packed-tile router under the profiler,
    after every timed pass (the profiler adds host overhead)."""
    log("[7] device profile of one pipelined pass (packed tiles)")
    share, wall, prof_rows = profile_device(lambda: route_all(router, topics, batch, 2))
    log(f"    wall {wall * 1e3:.3f} ms, device busy {share * 100:.2f}% (idle "
        f"{100 - share * 100:.2f}%)" if prof_rows
        else "    no device time recorded (not measured)")
    for i, (name, ms, cnt) in enumerate(prof_rows):
        if i < 10 or "match_words" in name or "tail_" in name:
            log(f"      {ms:9.3f} ms  x{cnt:<5d} {name[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--filters", type=int, default=1_000_000)
    ap.add_argument("--topics", type=int, default=32_768)
    ap.add_argument("--batch", type=int, default=16_384)
    ap.add_argument("--sample", type=int, default=2_048)
    ap.add_argument("--churn", type=int, default=2_000)
    ap.add_argument("--retained", type=int, default=1_000_000,
                    help="cfg5 retained draws of phases 3r and 4r")
    ap.add_argument("--wave", type=int, default=4_096,
                    help="publishes of the brokers' waves 6a and 6e (host-bound "
                         "at 1-4 topics a batch: per-batch numbers need no more)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    device = phase_device()
    phase_build()
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    rng = random.Random(args.seed)
    filters = gen_mixed(rng, args.filters)
    topics = gen_topics_uniform(rng, args.topics)
    retained_topics = gen_retained_topics(random.Random(args.seed + 5), args.retained)
    sub_filters = retained_sub_filters(random.Random(5))
    log(f"    workload: {len(filters)} filters, {len(topics)} topics, "
        f"{len(retained_topics)} retained topics ({args.retained} draws), "
        f"{len(sub_filters)} subscriber filters generated in "
        f"{time.perf_counter() - t0:.2f}s")
    packed_router = build_router(filters, dev, packed=True)
    legacy_router = build_router(filters, dev, packed=False)
    assert packed_router.matcher._dev.layout is not None
    assert legacy_router.matcher._dev.layout is None
    t0 = time.perf_counter()
    tree = TopicTree()
    for f in filters:
        tree.insert(f, f)
    log(f"    TopicTree oracle built in {time.perf_counter() - t0:.2f}s")
    # daemon GC hygiene, as bench.py does for the same tables: the ~10^7
    # long-lived objects of two 1M-filter routers and the oracle must not
    # be re-scanned by every full collection the routing passes trigger
    gc.collect()
    gc.freeze()
    GC_TIME.install()

    stats = timed("3", phase_kernels, packed_router, legacy_router, topics, args.batch, dev)
    stats.update(timed("3t", phase_tail_kernels, packed_router, topics, args.batch))

    MW.match_words_packed.launches = 0
    MW.match_words_legacy.launches = 0
    for k in TAILS:
        k.launches = 0
    want_filters, cfg3_nums = timed("4", phase_cfg3, packed_router, tree, filters,
                                    topics, args.batch, args.sample, args.churn,
                                    args.seed)
    launches = {"match_words_packed": MW.match_words_packed.launches,
                "match_words_legacy": MW.match_words_legacy.launches,
                "fused_compact_decode": CT.fused_compact_decode.launches}
    del tree
    encode = timed("4e", phase_encode, packed_router, topics, args.batch, cfg3_nums)

    # cfg5's retained side: the table, its scanner and the oracle, frozen
    # like the routers before the phases that use them
    rtable, rscanner, rtree = timed("retained table", build_retained, retained_topics, dev)
    gc.collect()
    gc.freeze()
    stats.update(timed("3r", phase_retained_kernels, rscanner, sub_filters, dev))
    retained = timed("4r", phase_retained_scanner, rtable, rscanner, rtree, sub_filters,
                     packed_router, topics)
    launches.update(retained["launches"])
    del rtable, rscanner, rtree

    MW.match_words_packed.launches = 0
    MW.match_words_legacy.launches = 0
    for k in TAILS:
        k.launches = 0
    timed("5", phase_legacy, legacy_router, topics, args.batch, want_filters)
    launches["match_words_legacy"] = MW.match_words_legacy.launches
    tails = {"5": {k.__name__: k.launches for k in TAILS}}
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was never launched on its path")

    # the dense backend (3d, 4d) and the multi-device matchers (4s)
    dense_router, dscanner, perm = timed("dense tables", build_dense, filters,
                                         retained_topics, dev)
    gc.collect()
    gc.freeze()
    dstats = timed("3d", phase_dense_kernels, dense_router, dscanner, topics,
                   sub_filters, args.batch, dev)
    dense_programs = dstats.pop("programs")
    stats.update(dstats)
    dense = timed("4d", phase_dense, dense_router, dscanner, perm, filters, topics,
                  args.batch, want_filters, args.churn, args.seed, sub_filters,
                  retained.pop("results"))
    del want_filters
    for k in TAILS:
        k.launches = 0
    sharded = timed("4s", phase_sharded, dense_router, packed_router, topics,
                    args.batch, filters, dev)
    tails["4s"] = {k.__name__: k.launches for k in TAILS}
    del dense_router, dscanner, perm
    torch.cuda.empty_cache()
    MW.match_words_packed.launches = 0
    MW.match_words_legacy.launches = 0
    for k in TAILS:
        k.launches = 0
    modes = timed("4m", phase_modes, packed_router, legacy_router, filters, topics,
                  args.batch, args.churn, args.seed)
    tails["4m"] = {k.__name__: k.launches for k in TAILS}
    stats["compact_words"] = modes["programs"]["compact_words"]
    del legacy_router  # the broker phase needs the room

    # the brokers run in child processes: their launches are the
    # differences of their own counters (/api/v1/stats) across 6a and 6d
    subs, waves = timed("broker oracle", broker_waves, filters, topics, args.seed,
                        args.wave)
    broker = timed("6a-c+6g", phase_broker, subs, waves, retained_topics, sub_filters)
    if broker["launches_packed"] <= 0:
        raise AssertionError("match_words_packed was never launched in the broker")
    plugin = broker["plugin"]
    scenario = timed("6h", phase_scenario)
    rbroker = timed("6d", phase_retained_broker, retained_topics, sub_filters)
    fabric, recovered = timed("6e+6f", phase_fabric_recovery, subs, waves[0],
                              retained_topics, sub_filters)
    del subs, waves
    by_path = {
        "match_words_packed": {"router, phase 4": launches["match_words_packed"],
                               "broker, phase 6a": broker["launches_packed"],
                               "fabric owner, phase 6e": fabric["launches_packed"],
                               "recovered broker, phase 6f": recovered["launches_packed"],
                               "plugin broker, phase 6g": plugin["launches_packed"],
                               "scenario broker, phase 6h":
                               scenario["broker_stats"]["routing_kernel_launches_packed"]},
        "match_words_legacy": {"router with RMQTT_PACKED=0, phase 5":
                               launches["match_words_legacy"],
                               "router modes, phase 4m": modes["launches_legacy"]},
    }
    by_path["match_words_packed"]["router modes, phase 4m"] = modes["launches_packed"]
    by_path["match_words_legacy"]["sharded partitioned matcher and mesh router, "
                                  "phase 4s"] = sharded["launches_legacy"]
    by_path["dense_match_packed"] = {"dense router, phase 4d": dense["launches_packed"],
                                     "sharded dense matcher, phase 4s":
                                     sharded["launches_packed"]}
    by_path["dense_match_retained"] = {"dense retained scanner, phase 4d":
                                       dense["launches_retained"]}
    by_path["dense_match_words"] = {"dense router, phase 4d": dense["launches_words"]}
    if "all_cards" in sharded:
        by_path["match_words_legacy"]["mesh over every card, phase 4s"] = \
            sharded["all_cards"]["launches_legacy"]
        by_path["dense_match_packed"]["sharded dense matcher over every card, phase 4s"] = \
            sharded["all_cards"]["launches_packed"]
    for name, paths in by_path.items():
        for path, n in paths.items():
            if n <= 0 and ("4d" in path or "4s" in path):
                raise AssertionError(f"{name} was never launched on its path {path}")
    by_path["fused_compact_decode"] = {
        "router, phase 4": launches["fused_compact_decode"],
        "router with RMQTT_PACKED=0, phase 5": tails["5"]["fused_compact_decode"],
        "sharded partitioned matcher and mesh router, phase 4s":
        tails["4s"]["fused_compact_decode"],
        "router modes, phase 4m": tails["4m"]["fused_compact_decode"],
        "broker, phase 6a": broker["launches_tail"],
        "fabric owner, phase 6e": fabric["launches_tail"],
        "recovered broker, phase 6f": recovered["launches_tail"],
        "plugin broker, phase 6g": plugin["launches_tail"],
        "scenario broker, phase 6h":
        scenario["broker_stats"]["routing_kernel_launches_fused_tail"]}
    by_path["compact_global"] = {
        "router modes, phase 4m": tails["4m"]["compact_global"],
        "sharded partitioned matcher, phase 4s": tails["4s"]["compact_global"]}
    by_path["compact_words"] = {
        "router modes, phase 4m (b)": tails["4m"]["compact_words"],
        "sharded partitioned matcher, phase 4s": tails["4s"]["compact_words"]}
    for name in ("fused_compact_decode", "compact_global", "compact_words"):
        for path, n in by_path[name].items():
            if n <= 0:
                raise AssertionError(f"{name} was never launched on its path {path}")
    for mode in ("gather", "full"):
        name = f"retained_scan_{mode}"
        by_path[name] = {"scanner at 1M, phase 4r": launches[name],
                         "broker, phase 6d":
                         rbroker["delta"][f"retained_scan_launches_{mode}"],
                         "recovered broker, phase 6f":
                         recovered["retained"][f"retained_scan_launches_{mode}"],
                         "plugin broker, phase 6g":
                         plugin["retained"][f"retained_scan_launches_{mode}"]}
    timed("7", phase_profile, packed_router, topics, args.batch)

    kernels = []
    for name, s in stats.items():
        row = {
            "name": name, "route": "cuda", "source": KERNEL_SOURCE[name],
            "replaces": REPLACES[name], "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s.get("library_ms"),
            "equal_to_plain": True, "cases": s["cases"],
            "bound_term": s["bound_term"], "graph_ms": s["graph_ms"],
        }
        if "small_set_ms" in s:
            row.update(small_set_ms=s["small_set_ms"],
                       bucket_ms_per_batch=sum(ms for *_, ms in s["bucket_ms"]))
        elif "plain_graph_ms" in s:  # the tails
            row.update(shape=s["shape"], budget=s["budget"],
                       plain_graph_ms=s["plain_graph_ms"],
                       bucket_graph_ms_per_batch=s["bucket_graph_ms_per_batch"],
                       graph_ms_by_shape={k: r["graph_ms"] for k, r in s["shapes"].items()},
                       ops_by_shape={k: r["ops"]["kernels"] + r["ops"]["memsets"]
                                     for k, r in s["shapes"].items()})
        else:
            row.update({k: s[k] for k in ("shape", "one_filter", "warm_bound_ms", "small_ms",
                                          "small_graph_ms", "small_warm_bound_ms",
                                          "small_cold_ms", "small_bound_ms") if k in s})
        kernels.append(row)
    log(f"[8] kernels (total run {time.perf_counter() - t_start:.1f}s; seconds by "
        f"phase {({k: round(v, 1) for k, v in PHASE_S.items()})}); retained "
        f"scans/s alone {retained['scans_per_s_alone']:.1f}, interleaved "
        f"{retained['scans_per_s_interleaved']:.1f} with "
        f"{retained['publish_topics_per_s']:.1f} publish topics/s; encode ms per "
        f"32,768 topics native / Python (warm) {encode['native_warm_ms']:.3f} / "
        f"{encode['python_warm_ms']:.3f}; 4m topics/s first / after the churn "
        f"{ {k[0]: [round(x, 1) for x in v['topics_per_s']] for k, v in modes['modes'].items()} }; "
        f"4d dense router {dense['topics_per_s']:.1f} topics/s at {args.batch} a batch "
        f"({dense['overflowed']} overflowed), "
        f"{ {k: round(v, 1) for k, v in dense['small_topics_per_s'].items()} } at 1 and 8, "
        f"dense retained {dense['scans_per_s']:.1f} scans/s; 3d forward / inverse / words "
        f"/ match_compact ms {stats['dense_match_packed']['graph_ms']:.4f} / "
        f"{stats['dense_match_retained']['graph_ms']:.4f} / "
        f"{stats['dense_match_words']['graph_ms']:.4f} / "
        f"{dense_programs['match_compact']['ms']:.4f}; 4m compact_words ms "
        f"{stats['compact_words']['graph_ms']:.4f} by graph replay (plain "
        f"{stats['compact_words']['plain_ms']:.4f}, torch.topk "
        f"{stats['compact_words']['library_ms']:.4f}); 3t fused tail / compact_global "
        f"ms {stats['fused_compact_decode']['ms']:.4f} / {stats['compact_global']['ms']:.4f} "
        f"(graph {stats['fused_compact_decode']['graph_ms']:.4f} / "
        f"{stats['compact_global']['graph_ms']:.4f}; plain "
        f"{stats['fused_compact_decode']['plain_ms']:.3f} / "
        f"{stats['compact_global']['plain_ms']:.3f}); 4s topics/s first / warm "
        f"{ {k: [round(x, 1) for x in v] for k, v in sharded['modes'].items()} }; "
        f"6a deliveries/s {broker['deliveries_per_s']:.1f} "
        f"with the profiler seams live; 6e deliveries/s {fabric['deliveries_per_s']:.1f} "
        f"through {FABRIC_WORKERS} fabric workers; 6f recovery "
        f"{recovered['recovery_ms']:.3f} ms, restart to listening "
        f"{recovered['restart_to_listening_s']:.3f} s; 6g plugin broker: subscribe "
        f"{plugin['subscribe_s']:.3f} s, wave {plugin['wave_deliveries_per_s']:.1f} "
        f"deliveries/s, restart to listening {plugin['restart_to_listening_s']:.3f} s "
        f"(retainer load {plugin['retainer_load_ms']:.0f} ms); 6h {SCENARIO_PROFILE} "
        f"{scenario['duration_s']} s, kernel.dispatch p50/p99 "
        f"{scenario['latency']['kernel.dispatch']['p50_ms']}/"
        f"{scenario['latency']['kernel.dispatch']['p99_ms']} ms; 6c lone p50/p99 "
        f"{broker['lone_ms_device'][0]:.3f}/{broker['lone_ms_device'][1]:.3f} ms "
        f"(device); CUDA probe s "
        f"{broker['probe_s']} {rbroker['probe_s']:.3f} {fabric['probe_s']} "
        f"{recovered['probe_s']:.3f} {plugin['probe_s']:.3f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
