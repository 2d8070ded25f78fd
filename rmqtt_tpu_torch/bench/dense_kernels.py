"""The dense kernels (``csrc/dense_match.cu``) at the dense backend's
shapes, and against other versions of their source, in turns on one card.

The shapes, on the dense table of cfg3's 1,000,000 ``gen_mixed`` filters
(seed 0) in a ``TorchRouter(backend="dense")`` (a ``FilterTable`` of 2^20
rows x 8 levels, every batch on the card): the forward scan at the words
path's batch (16,384 ``gen_topics_uniform`` topics) and at the bitmap
path's batches of 1, 8, 33 and 64 (``DenseMatcher.match`` fetches the
bitmap while it is at most 8 MiB: batches padded to a power of two up to
64, and an overflow re-match of any size), and the words kernel on the
forward bitmap of the 16,384 topics; and the inverse scan on chip_smoke
4d's retained table (a ``FilterTable`` of cfg5's 1,000,000 retained draws,
seed 5: 2^20 rows x 8 levels) at its scanner's batch of 64 filters of
``retained_sub_filters`` and at 1 (a SUBSCRIBE's shape) and 8.
``dense_bound_ms`` and ``dense_words_bound_ms`` (``bench/roofline_model.py``)
are the least time the card could take.

    python -m rmqtt_tpu_torch.bench.dense_kernels [--other OLD.cu ...] [--passes N]

builds each ``OLD.cu`` (another ``dense_match.cu``, for example an earlier
commit's: ``git show <commit>:rmqtt_tpu_torch/csrc/dense_match.cu``) into a
library of its own beside the current one, holds every library's forward
bitmap to the plain twin at B = 1, 8, 33, 64 and 1,024 and to the current
library's at 16,384, every library's inverse bitmap to the twin, and the
words kernel to its twin; then times each library's forward and inverse
in turns (the others, this, this, the others reversed) by CUDA events and
CUDA-graph replay (the inverse also with the L2 cache flushed before each
call: its 2^20 x 8 table, ~37 MB, fits the 50 MB L2), and the words
kernel beside its twin and ``torch.topk`` on the twin's keys, and
samples the SM clock and the
power draw (``nvidia-smi``) while this forward runs at 16,384 topics for
about two seconds. With ``--passes N`` and an ``--other`` it times the
dense words path end to end in turns: N passes of the 32,768 topics in
batches of 16,384 through ``DenseMatcher.match`` (the matcher alone) and
N through the router's ``matches_batch_raw`` (chip_smoke 4d's path, with
the relations expand), first with the first other's forward and the
words twin (the path before the words kernel), then with this source's
two kernels, then both again in reverse order; every pass's results
equal the first's. It prints the card's name and power limit, a line a
shape, then one JSON line. It needs one GPU.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import random
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from rmqtt_tpu_torch.bench.retained_kernels import card_line
from rmqtt_tpu_torch.bench.roofline_model import (dense_bound_ms, dense_words_bound_ms,
                                                  literal_levels)
from rmqtt_tpu_torch.bench.timing import time_cold, time_cuda, time_graph
from rmqtt_tpu_torch.bench.workloads import (gen_mixed, gen_retained_topics,
                                             gen_topics_uniform, retained_sub_filters)
from rmqtt_tpu_torch.ops import match as DM
from rmqtt_tpu_torch.ops._build import kernel_library, load_library
from rmqtt_tpu_torch.ops.encode import FilterTable
from rmqtt_tpu_torch.router import Id, SubscriptionOptions, TorchRouter

BATCH = 16_384  # the words path's batch (chip_smoke.py 4d)
SMALL = (1, 8, 33, 64)  # the bitmap path's batches (4d: 1 and 8)
CHECK = 1_024  # the batch the twin checks every library at
FILTERS = 1_000_000  # cfg3's filters (chip_smoke.py 4d)
RETAINED = 1_000_000  # cfg5's retained draws (chip_smoke.py 4d)
INVERSE = (1, 8, 64)  # the inverse's batches: a SUBSCRIBE, 8, the scanner's 64


def forward_call(lib, args):
    """A launch of ``lib``'s ``launch_dense_match_packed`` on ``args`` (the
    forward wrapper's eight tensors) through ctypes, on the current stream
    → (call, its output tensor)."""
    ftok, flen, pre, hh, fw, ttok, tlen, td = args
    f, lvl = ftok.shape
    b = ttok.shape[0]
    out = torch.empty((b, f // 32), dtype=torch.int32, device=ftok.device)

    def call():
        err = lib.launch_dense_match_packed(
            ftok.data_ptr(), flen.data_ptr(), pre.data_ptr(), hh.data_ptr(), fw.data_ptr(),
            f, lvl, ttok.data_ptr(), tlen.data_ptr(), td.data_ptr(), b, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch_dense_match_packed: CUDA error {err}")
    return call, out


def inverse_call(lib, args):
    """A launch of ``lib``'s ``launch_dense_match_retained`` on ``args`` (the
    inverse wrapper's eight tensors), as :func:`forward_call`."""
    rtok, rlen, rdollar, ftok, flen, fpre, fh, fw = args
    f, lvl = rtok.shape
    b = ftok.shape[0]
    out = torch.empty((b, f // 32), dtype=torch.int32, device=rtok.device)

    def call():
        err = lib.launch_dense_match_retained(
            rtok.data_ptr(), rlen.data_ptr(), rdollar.data_ptr(), f, lvl, ftok.data_ptr(),
            flen.data_ptr(), fpre.data_ptr(), fh.data_ptr(), fw.data_ptr(), b,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch_dense_match_retained: CUDA error {err}")
    return call, out


def on_card(arrays, dev):
    """numpy arrays (int32, or bool flags) → contiguous tensors on ``dev``."""
    return tuple(torch.from_numpy(np.ascontiguousarray(
        a, dtype=bool if a.dtype == np.bool_ else np.int32)).to(dev) for a in arrays)


def retained_table(dev, seed: int):
    """4d's retained table on the card: a ``FilterTable`` of cfg5's
    :data:`RETAINED` draws → (its rows ``(rtok, rlen, rdollar)``, the
    table, the subscriber mix)."""
    t0 = time.perf_counter()
    table = FilterTable()
    for topic in gen_retained_topics(random.Random(seed + 5), RETAINED):
        table.add(topic)
    print(f"retained table: capacity {table.capacity} x {table.max_levels} levels, "
          f"built in {time.perf_counter() - t0:.1f}s", flush=True)
    return (on_card((table.tok, table.flen, table.row_dollar), dev), table,
            retained_sub_filters(random.Random(5)))


def inverse_shapes(libs, others, rows, table, subs, dev) -> list:
    """The inverse on 4d's retained table (:func:`retained_table`) at
    :data:`INVERSE`: every library held to the twin, then timed in turns
    (the others, this, this, the others reversed) by CUDA events, graph
    replay (the table warm in the L2 cache) and with the L2 cache flushed
    before each call → a row a batch."""
    out = []
    for b in INVERSE:
        iargs = (*rows, *on_card(table.encode_filters(subs[:b]), dev))
        calls = {name: inverse_call(lib, iargs) for name, lib in libs.items()}
        for call, _out in calls.values():
            call()
        want = DM.match_retained_plain(*iargs)
        torch.cuda.synchronize()
        for name, (_call, got) in calls.items():
            if not torch.equal(got, want):
                raise AssertionError(f"{name}'s inverse differs from the twin at B={b}")
        row = {"kernel": "dense_match_retained", "b": b,
               **{name: {"ms": [], "graph_ms": [], "cold_ms": []} for name in libs}}
        for name in [*others, "this", "this", *others[::-1]]:  # in turns
            call = calls[name][0]
            row[name]["ms"].append(time_cuda(call, reps=50))
            row[name]["graph_ms"].append(time_graph(call, reps=10))
            row[name]["cold_ms"].append(time_cold(call, reps=20))
        lit = int(literal_levels(iargs[3], iargs[5], iargs[4] != -2).sum())
        f, lvl = rows[0].shape
        row["bound_ms"], row["bound_by"], row["bound_term"] = dense_bound_ms(f, lvl, b,
                                                                             f * lit)
        row["warm_bound_ms"] = dense_bound_ms(f, lvl, b, f * lit, warm=True)[0]
        print(f"dense_match_retained B={b}: " + "; ".join(f"{n} {row[n]}" for n in libs)
              + f"; bound {row['bound_ms']:.5f} ms by {row['bound_by']} "
              f"({row['bound_term']}) for cold_ms, {row['warm_bound_ms']:.5f} warm for "
              "ms and graph_ms; all equal to the twin", flush=True)
        out.append(row)
        del calls, want
    return out


def packed_with(lib):
    """A stand-in for ``match.match_packed`` that launches ``lib``'s forward."""
    def run(*args):
        call, out = forward_call(lib, args)
        call()
        return out
    return run


def ptxas_lines(log: str, key: str) -> list:
    """The ``-Xptxas -v`` register and spill lines of the kernels named
    ``key`` in a build log."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry" in line:
            name = line.split("'")[1] if key in line else None
        elif name and ("registers" in line or "spill" in line):
            out.append(f"{name[-40:]}: {line.strip()}")
    return out


def words_path(route, topics, passes: int):
    """``passes`` passes of ``topics`` through ``route`` (a batch of topics →
    per-topic results) in batches of :data:`BATCH` → (seconds of each pass,
    the first pass's results)."""
    secs, rows = [], None
    for _ in range(passes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = []
        for i in range(0, len(topics), BATCH):
            got.extend(route(topics[i:i + BATCH]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        rows = rows if rows is not None else got
    return secs, rows


def routed_filters(raw) -> list:
    """One routed topic's matched filters, from the router's relations."""
    out, shared = raw
    return sorted([r.topic_filter for rels in out.values() for r in rels]
                  + [tf for _group, tf in shared])


def same_results(a, b) -> bool:
    """Per-topic results (fid arrays, or the router's relations) all equal."""
    if len(a) != len(b):
        return False
    if isinstance(a[0], np.ndarray):
        return all(np.array_equal(x, y) for x, y in zip(a, b))
    return all(routed_filters(x) == routed_filters(y) for x, y in zip(a, b))


def sample_clocks(fn, seconds: float) -> dict:
    """Run ``fn`` back to back for ``seconds`` while a thread samples
    ``nvidia-smi``'s SM clock (MHz) and power draw (W) → their medians."""
    samples, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                  "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True, timeout=30).stdout
            samples.append([float(x) for x in out.splitlines()[0].split(",")])
            time.sleep(0.1)

    th = threading.Thread(target=poll, daemon=True)
    fn()
    torch.cuda.synchronize()
    th.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        fn()
        torch.cuda.synchronize()
    stop.set()
    th.join()
    if not samples:
        return {"sm_mhz": None, "power_w": None, "samples": 0}
    return {"sm_mhz": float(np.median([x[0] for x in samples])),
            "power_w": float(np.median([x[1] for x in samples])),
            "samples": len(samples)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, action="append", default=[],
                    help="another dense_match.cu to time against the current one")
    ap.add_argument("--passes", type=int, default=0,
                    help="words-path passes a turn (needs an --other)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dense_kernels: no CUDA device; this run needs one GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    this = kernel_library()
    libs = {}
    for o in args.other:
        built = load_library((o.resolve(),))
        libs[str(o)] = built.lib
        print("\n".join([f"{o}: {x}" for x in ptxas_lines(built.log, "dense_packed")]),
              flush=True)
    others = list(libs)
    libs["this"] = this.lib
    print("\n".join(f"this: {x}" for x in ptxas_lines(this.log, "dense_")), flush=True)

    t0 = time.perf_counter()
    rng = random.Random(args.seed)
    filters = gen_mixed(rng, FILTERS)
    topics = gen_topics_uniform(rng, 2 * BATCH)
    hybrid = os.environ.get("RMQTT_HYBRID_MAX")
    os.environ["RMQTT_HYBRID_MAX"] = "0"  # every batch on the card
    try:
        router = TorchRouter(device=dev, backend="dense")
    finally:
        if hybrid is None:
            del os.environ["RMQTT_HYBRID_MAX"]
        else:
            os.environ["RMQTT_HYBRID_MAX"] = hybrid
    opts = SubscriptionOptions()
    for i, f in enumerate(filters):
        router.add(f, Id(1, f"c{i}"), opts)
    table, matcher = router.table, router.matcher
    rows = matcher._refresh()
    gc.collect()
    gc.freeze()  # the router's ~10^7 objects stay out of the collector's passes
    print(f"table: {len(filters)} filters, capacity {table.capacity} x {table.max_levels} "
          f"levels, built in {time.perf_counter() - t0:.1f}s", flush=True)

    def batch_args(b):
        return (*rows, *on_card(table.encode_topics(topics[:b]), dev))

    lit_rows = int(literal_levels(rows[0], rows[2], rows[1] >= 0).sum())

    shapes = []
    for b in (*SMALL, CHECK, BATCH):
        fargs = batch_args(b)
        calls = {name: forward_call(lib, fargs) for name, lib in libs.items()}
        for call, _out in calls.values():
            call()
        torch.cuda.synchronize()
        ref = calls["this"][1]
        if b != BATCH or not others:
            want = DM.match_packed_plain(*fargs)
            torch.cuda.synchronize()
            if not torch.equal(ref, want):
                raise AssertionError(f"this forward differs from the twin at B={b}")
            del want
        for name, (_call, out) in calls.items():
            if not torch.equal(out, ref):
                raise AssertionError(f"{name}'s forward differs from this one's at B={b}")
        row = {"kernel": "dense_match_packed", "b": b,
               **{name: {"ms": [], "graph_ms": []} for name in libs}}
        big = b == BATCH
        for name in [*others, "this", "this", *others[::-1]]:  # in turns
            call = calls[name][0]
            row[name]["ms"].append(time_cuda(call, reps=3 if big else 50, warmup=1))
            row[name]["graph_ms"].append(time_graph(call, reps=2 if big else 10,
                                                    per_graph=2 if big else 20))
        row["bound_ms"], row["bound_by"], row["bound_term"] = dense_bound_ms(
            rows[0].shape[0], rows[0].shape[1], b, b * lit_rows)
        print(f"dense_match_packed B={b}: " + "; ".join(f"{n} {row[n]}" for n in libs)
              + f"; bound {row['bound_ms']:.5f} ms by {row['bound_by']} "
              f"({row['bound_term']}); all equal", flush=True)
        shapes.append(row)
        if big:
            packed = ref
            row["clocks"] = sample_clocks(calls["this"][0], 2.0)
            print(f"    this forward at B={b}, run for 2 s: {row['clocks']}", flush=True)
        del calls, ref

    # the words kernel on the forward bitmap of the words path's batch
    k = min(matcher.max_matches, packed.shape[1])
    got = DM.match_words(packed, k)
    want = DM.match_words_plain(packed, k)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("the words kernel differs from its twin")
    del got, want
    bw, w = packed.shape
    idx = torch.arange(w, dtype=torch.int32, device=dev)
    keys = torch.where(packed != 0, 2 * w - idx, w - idx)
    row = {"kernel": "dense_match_words", "b": bw, "w": w, "k": k,
           "nonzero_words": int((packed != 0).sum()),
           "ms": time_cuda(lambda: DM.match_words(packed, k), reps=20),
           "graph_ms": time_graph(lambda: DM.match_words(packed, k), reps=5, per_graph=5),
           "plain_ms": time_cuda(lambda: DM.match_words_plain(packed, k), reps=3, warmup=1),
           "library_ms": time_cuda(lambda: torch.topk(keys, k, dim=1), reps=5, warmup=1)}
    del keys
    row["bound_ms"], row["bound_by"], _ = dense_words_bound_ms(bw, w, k)
    print(f"dense_match_words [{bw}, {w}] K={k}: {row}", flush=True)
    shapes.append(row)
    del packed
    torch.cuda.empty_cache()
    shapes.extend(inverse_shapes(libs, others, *retained_table(dev, args.seed), dev))

    passes = {}
    if args.passes and others:
        kernel_fwd, kernel_words = DM.match_packed, DM.match_words_wire
        before = (packed_with(libs[others[0]]), DM.topk_wire_plain)
        routes = {"matcher": matcher.match,
                  "router": lambda bt: router.matches_batch_raw([(None, t) for t in bt])}
        first = {}
        for turn, name in enumerate(("before", "this", "this", "before")):
            DM.match_packed, DM.match_words_wire = before if name == "before" else (
                kernel_fwd, kernel_words)
            try:
                for what, route in routes.items():
                    secs, got = words_path(route, topics, args.passes)
                    if what not in first:
                        first[what] = got
                    elif not same_results(got, first[what]):
                        raise AssertionError(f"the words path's {what} results differ in "
                                             f"turn {turn} ({name})")
                    passes.setdefault(what, {}).setdefault(name, []).extend(
                        len(topics) / x for x in secs)
                    print(f"words path turn {turn} ({name}), {what}: topics/s "
                          f"{[round(len(topics) / x, 1) for x in secs]}", flush=True)
            finally:
                DM.match_packed, DM.match_words_wire = kernel_fwd, kernel_words
    print(json.dumps({"card": card, "others": others, "shapes": shapes,
                      "words_path_topics_per_s": passes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
