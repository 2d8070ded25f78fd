"""The compaction-tail kernels (``csrc/compact_tail.cu``) at the main
path's shapes, beside their plain twins and their bounds, on one card.

The shapes, on a packed ``PartitionedTable`` of ``gen_mixed`` filters (cfg3:
1,000,000, seed 0): phase 4's words of one batch of 16,384
``gen_topics_uniform`` topics (NC=32, ``W=128``) with the matcher's budget
for that shape regrown to hold every route, as the matcher would; the
same words with half that budget (topics cut); the words of the NC
split's buckets of that batch (what one router batch launches); and the
broker's batches of 1, 2 and 4 topics (budget 256).
:func:`~rmqtt_tpu_torch.bench.roofline_model.fused_tail_bound_ms` and
``compact_global_bound_ms`` are the least time the card could take.

    python -m rmqtt_tpu_torch.bench.tail_kernels [--filters N] [--batch B]

builds the table, holds both kernels to their twins (``torch.equal`` over
the whole wire) on ``bench/tail_cases.py``'s ``CARD_CASES`` and at every
shape, then times each kernel by CUDA events (per call, through the
wrapper) and by CUDA-graph replay (the card's time), and each twin the
same way, and counts the device operations one call issues at each shape
(``torch.profiler``: kernels and memsets). A call on the kernels' one-launch
path (B <= 64 and a budget <= 16,384: the broker's shapes) must issue one
kernel and nothing else; a larger call one memset and one kernel. It
prints the card's name and power limit, a line a shape, then one JSON
line. It needs one GPU. ``chip_smoke.py`` phase 3t runs the
same checks, counts and timings on its own table.

Then :func:`dispatch_ab` shows the fused tail's share of the matcher end
to end, in turns in the one process (twin, kernel, kernel, twin): the
same matcher with its fused tail as the plain twin (torch ops, what the
matcher ran before the kernel) or as the kernel, timing lone dispatches
(``match([topic])``, the broker's one-topic batches) and warm
matcher-only passes over the batch's topics.

    python -m rmqtt_tpu_torch.bench.tail_kernels --other OLD.cu [--other ...]

also builds each ``OLD.cu`` (another ``compact_tail.cu``, for example an
earlier commit's: ``git show <commit>:rmqtt_tpu_torch/csrc/compact_tail.cu``)
into a library of its own, holds its kernels to the twins at every shape,
and times both kernels of every library at every shape in turns (the
others, this, this, the others reversed) by graph replay and by CUDA
events; :func:`dispatch_ab` then runs the other libraries' fused tail and
this one's in the same turns, in place of the twin.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import random
import sys
import time
from pathlib import Path

import numpy as np
import torch

from rmqtt_tpu_torch.bench.retained_kernels import card_line
from rmqtt_tpu_torch.bench.roofline_model import (compact_global_bound_ms,
                                                  fused_tail_bound_ms)
from rmqtt_tpu_torch.bench.tail_cases import CARD_CASES, make_tail_case
from rmqtt_tpu_torch.bench.timing import time_cuda, time_graph
from rmqtt_tpu_torch.bench.workloads import gen_mixed, gen_topics_uniform
from rmqtt_tpu_torch.ops import compact_tail as CT
from rmqtt_tpu_torch.ops import match_words as MW
from rmqtt_tpu_torch.ops import partitioned as PP
from rmqtt_tpu_torch.ops._build import kernel_library, load_library
from rmqtt_tpu_torch.ops.partitioned import PartitionedMatcher, PartitionedTable

BROKER_BATCHES = (1, 2, 4)  # the broker's padded batches of lone publishes
# the kernels' one-launch path (csrc/compact_tail.cu kSmallB, kSmallBudget)
SMALL_B, SMALL_BUDGET = 64, 16384
PAIRS = {
    "fused_compact_decode": (CT.fused_compact_decode, CT.fused_compact_decode_plain),
    "compact_global": (CT.compact_global, CT.compact_global_plain),
}


def _put(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32, copy=False)).to(dev)


def _args(name: str, words, fids, cids, budget: int):
    return (words, fids, cids, budget) if name == "fused_compact_decode" else (words, budget)


def _routes_budget(matcher, words, key) -> int:
    """The matcher's budget for the batch shape ``key``, regrown (sticky
    pow2) until it holds the words' routes."""
    n = int(CT._popcount32(words).sum())
    g = matcher._budget_for(*key)
    return g if n <= g else max(g, 1 << max(8, (n - 1).bit_length()))


def words_of(matcher, topics, pad: int, nc=None):
    """The packed words kernel's words for ``topics`` padded to ``pad``
    (``nc`` cuts the candidate columns, as an NC split bucket does) →
    (words, chunk_ids) on the matcher's device; the launch is not counted."""
    st = matcher._refresh()
    t = matcher.table
    ttok, tlen, tdollar, cids, _nc = t.encode_topics(topics, pad_batch_to=pad)
    if nc is not None:
        cids = cids[:, :nc]
    _lay, tt = t.translate_packed(ttok)
    dev = st.tiles.device
    args = [_put(a, dev) for a in (tt, tlen, tdollar, cids)]
    n0 = MW.match_words_packed.launches
    words = MW.match_words_packed(st.tiles, *args, st.layout)
    MW.match_words_packed.launches = n0
    return words, args[3]


def real_shapes(matcher, topics, batch: int):
    """→ ``[(label, words, fid_rows, chunk_ids, budget)]``: the cfg3 batch
    with the matcher's budget and with half of it, the NC split's buckets
    of that batch (label ``"bucket ..."``), then the broker's batches."""
    st = matcher._refresh()
    words, cids = words_of(matcher, topics[:batch], batch)
    g = _routes_budget(matcher, words, (batch, cids.shape[1]))
    n = int(CT._popcount32(words).sum())
    out = [(f"cfg3 B={batch} NC={cids.shape[1]}", words, st.fids, cids, g),
           (f"cfg3 B={batch}, budget {n // 2} (cut)", words, st.fids, cids, n // 2)]
    _tt, _tl, _td, host_cids, _nc = matcher.table.encode_topics(topics[:batch],
                                                                pad_batch_to=batch)
    split = matcher._split_plan(host_cids, batch)
    if split is not None:
        order, sizes, tiers = split
        pos = 0
        for tier, s in zip(tiers, sizes):
            s = int(s)
            if not s:
                continue
            pb = 1 << (s - 1).bit_length() if s > 1 else 1
            bt = [topics[i] for i in order[pos:pos + s]]
            pos += s
            bw, bc = words_of(matcher, bt, pb, tier)
            out.append((f"bucket {s} topics B={pb} NC={tier}", bw, st.fids, bc,
                        _routes_budget(matcher, bw, (pb, tier))))
    for k in BROKER_BATCHES:
        bw, bc = words_of(matcher, topics[:k], k)
        out.append((f"broker B={k}", bw, st.fids, bc, matcher._budget_for(k, bc.shape[1])))
    return out


def check(name: str, words, fids, cids, budget: int, what: str) -> int:
    """The kernel's wire against the twin's, ``torch.equal`` → max abs err;
    raises on any difference. The launch is not counted."""
    kern, plain = PAIRS[name]
    n0 = kern.launches
    got = kern(*_args(name, words, fids, cids, budget))
    kern.launches = n0
    want = plain(*_args(name, words, fids, cids, budget))
    torch.cuda.synchronize()
    err = (int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
           if got.numel() else 0)
    if got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"{name} {what}: the kernel's wire differs from the "
                             f"twin's (max abs err {err})")
    return err


def check_cases(dev) -> dict:
    """Both kernels against their twins on every ``CARD_CASES`` entry →
    {name: max abs err}."""
    errs = dict.fromkeys(PAIRS, 0)
    for case in CARD_CASES:
        words, fids, cids, budget = make_tail_case(case)
        args = (_put(words.view(np.int32), dev), _put(fids, dev), _put(cids, dev), budget)
        for name in PAIRS:
            errs[name] = max(errs[name], check(name, *args, what=case.name))
    return errs


def time_pair(name: str, words, fids, cids, budget: int, plain: bool = True) -> dict:
    """Kernel (and twin) ms by CUDA events and by graph replay, and the
    bound; launches made here are not counted."""
    kern, twin = PAIRS[name]
    a = _args(name, words, fids, cids, budget)
    n0 = kern.launches
    r = {"ms": time_cuda(lambda: kern(*a), reps=50),
         "graph_ms": time_graph(lambda: kern(*a), reps=10)}
    kern.launches = n0
    if plain:
        r["plain_ms"] = time_cuda(lambda: twin(*a), reps=5, warmup=1)
        r["plain_graph_ms"] = time_graph(lambda: twin(*a), reps=3, per_graph=2)
    cnts = kern(*a)[budget:]
    kern.launches = n0
    if name == "fused_compact_decode":
        bound = fused_tail_bound_ms(words, cids, cnts, budget)
    else:
        bound = compact_global_bound_ms(words, cnts, budget)
    r["bound_ms"], r["bound_by"], r["bound_term"] = bound
    r["library_ms"] = None  # no PyTorch call computes either wire
    return r


def ops_per_call(fn) -> dict:
    """The device operations one call of ``fn`` issues (after a warm-up
    call), by ``torch.profiler`` (CUPTI sees the ctypes launches) →
    {"kernels": n, "memsets": n, "names": [...]}."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {"kernels": 0, "memsets": 0, "names": []}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if not us:
            continue
        out["memsets" if "memset" in e.key.lower() else "kernels"] += e.count
        out["names"].append(e.key[:80])
    return out


def op_limits(name: str, b: int, budget: int) -> tuple:
    """→ (most kernels, most memsets) a call of ``name`` may issue at this
    shape: one kernel on the one-launch path, else one memset and one
    kernel (the single pass), for either tail."""
    return (1, 0) if b <= SMALL_B and budget <= SMALL_BUDGET else (1, 1)


def check_ops(name: str, words, fids, cids, budget: int, what: str) -> dict:
    """:func:`ops_per_call` of the wrapper at this shape, held to
    :func:`op_limits`; raises past them or where no kernel was seen. The
    launches are not counted."""
    kern, _ = PAIRS[name]
    a = _args(name, words, fids, cids, budget)
    n0 = kern.launches
    ops = ops_per_call(lambda: kern(*a))
    kern.launches = n0
    most_k, most_m = op_limits(name, words.shape[0], budget)
    if not 1 <= ops["kernels"] <= most_k or ops["memsets"] > most_m:
        raise AssertionError(f"{name} {what}: a call issued {ops['kernels']} kernels and "
                             f"{ops['memsets']} memsets ({ops['names']}); at most "
                             f"{most_k} and {most_m} allowed")
    return ops


def run(matcher, topics, batch: int, log=print) -> dict:
    """Check and time both kernels at the real shapes → {name: stats} with
    the cfg3 shape's numbers at the top level (``ms``, ``graph_ms``,
    ``plain_ms``, ``bound_ms``, ...), ``shapes`` (every shape's), the
    buckets' per-batch sum by graph replay, ``max_abs_err`` and
    ``cases``."""
    dev = matcher.device
    errs = check_cases(dev)
    stats = {name: {"max_abs_err": errs[name], "cases": len(CARD_CASES), "shapes": {}}
             for name in PAIRS}
    for label, words, fids, cids, budget in real_shapes(matcher, topics, batch):
        n = int(CT._popcount32(words).sum())
        for name, s in stats.items():
            s["max_abs_err"] = max(s["max_abs_err"], check(name, words, fids, cids, budget, label))
            s["cases"] += 1
            r = time_pair(name, words, fids, cids, budget,
                          plain=not label.startswith("bucket"))
            r.update(budget=budget, routes=n, shape=list(words.shape),
                     ops=check_ops(name, words, fids, cids, budget, label))
            s["shapes"][label] = r
            log(f"    {name} {label}: {n} routes, budget {budget}: kernel "
                f"{r['ms']:.4f} ms ({r['graph_ms']:.4f} by graph replay), twin "
                + (f"{r['plain_ms']:.4f} ms ({r['plain_graph_ms']})"
                   if "plain_ms" in r else "not timed")
                + f", bound {r['bound_ms']:.5f} ms by {r['bound_by']}; equal; a call "
                f"{r['ops']['kernels']} kernels + {r['ops']['memsets']} memsets "
                f"{r['ops']['names']}")
    for s in stats.values():
        first = next(iter(s["shapes"].values()))
        s.update({k: first[k] for k in ("ms", "graph_ms", "plain_ms", "plain_graph_ms",
                                        "bound_ms", "bound_by", "bound_term",
                                        "library_ms", "shape", "budget")})
        s["bucket_graph_ms_per_batch"] = sum(
            r["graph_ms"] for k, r in s["shapes"].items() if k.startswith("bucket"))
    return stats


def _pass_topics_per_s(matcher, topics, batch: int) -> float:
    """One matcher-only pass, pipelined depth 2 → topics/s."""
    batches = [topics[i:i + batch] for i in range(0, len(topics), batch)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [matcher.match_submit(batches[0])]
    for bt in batches[1:]:
        handles.append(matcher.match_submit(bt))
        matcher.match_complete(handles.pop(0))
    matcher.match_complete(handles.pop(0))
    return len(topics) / (time.perf_counter() - t0)


# the C interface of a source from before the one-launch path: the scratch
# is an argument of its own, sized by B alone
_P, _I = ctypes.c_void_p, ctypes.c_int
_OLD_SIGNATURES = {
    "compact_tail_scratch_bytes": (_I,),
    "launch_fused_compact_decode": (_P, _I, _P, _I, _P, _I, _I, _I, _P, _P, _P),
    "launch_compact_global": (_P, _I, _I, _I, _P, _I, _P, _P),
}


def _old_calls(lib) -> dict:
    """Launches of a library of the older interface, as :func:`library_calls`."""
    for name, argtypes in _OLD_SIGNATURES.items():
        getattr(lib, name).argtypes = list(argtypes)

    def run(name, words, budget, dtype, before, after):
        b, w = words.shape
        out = torch.empty(budget + b, dtype=dtype, device=words.device)
        scratch = torch.empty(lib.compact_tail_scratch_bytes(b), dtype=torch.uint8,
                              device=words.device)
        err = getattr(lib, f"launch_{name}")(
            words.data_ptr(), w, *before, b, budget, out.data_ptr(), *after,
            scratch.data_ptr(), torch.cuda.current_stream(words.device).cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
        return out

    def fused(words, fids, cids, budget):
        return run("fused_compact_decode", words, budget, torch.int32,
                   (fids.data_ptr(), fids.numel() // MW.CHUNK, cids.data_ptr(), cids.shape[1]),
                   ())

    def glob(words, budget):
        wide = words.shape[1] * 32 >= 0x10000
        return run("compact_global", words, budget, torch.int32 if wide else torch.int16,
                   (), (int(wide),))

    return {"fused_compact_decode": fused, "compact_global": glob}


def library_calls(lib) -> dict:
    """{kernel name: a function of the wrapper's arguments that launches
    ``lib``'s kernel (not counted)}, for a library of this interface."""
    return {"fused_compact_decode": lambda *a: CT.launch_fused(lib, *a),
            "compact_global": lambda *a: CT.launch_global(lib, *a)}


def other_library(path: Path) -> dict:
    """Build and load another ``compact_tail.cu`` beside the current one →
    :func:`library_calls` of it (an older source through its own
    interface)."""
    lib = load_library((path.resolve(),)).lib
    if "compact_tail_scratch_bytes(int b)" in path.read_text():
        return _old_calls(lib)
    return library_calls(lib)


def turns(names) -> list:
    """The others, this, this, the others reversed ("this" last in ``names``)."""
    others = [n for n in names if n != "this"]
    return [*others, "this", "this", *others[::-1]]


def ab_shapes(libs: dict, shapes, log=print) -> dict:
    """Both kernels of every library (``{name: library_calls}``, the
    current one as "this") held to the twins (``torch.equal``) at every
    shape of :func:`real_shapes`, then timed there in :func:`turns` by
    graph replay and CUDA events → {kernel: {shape: {library: {"graph_ms":
    [...], "ms": [...]}}}}."""
    out = {name: {} for name in PAIRS}
    for label, words, fids, cids, budget in shapes:
        for name, (_kern, twin) in PAIRS.items():
            a = _args(name, words, fids, cids, budget)
            want = twin(*a)
            calls = {ln: (lambda f: lambda: f(*a))(c[name]) for ln, c in libs.items()}
            for ln, call in calls.items():
                got = call()
                torch.cuda.synchronize()
                if got.dtype != want.dtype or not torch.equal(got, want):
                    raise AssertionError(f"{ln}'s {name} differs from the twin at {label}")
            row = {ln: {"graph_ms": [], "ms": []} for ln in libs}
            for ln in turns(libs):
                row[ln]["graph_ms"].append(time_graph(calls[ln], reps=10))
                row[ln]["ms"].append(time_cuda(calls[ln], reps=50))
            out[name][label] = row
            log(f"    A/B {name} {label}: " + "; ".join(
                f"{ln} graph {[round(x, 5) for x in r['graph_ms']]} events "
                f"{[round(x, 4) for x in r['ms']]}" for ln, r in row.items())
                + "; all equal")
    return out


def dispatch_ab(matcher, topics, batch: int, lone: int = 200, arms=None) -> dict:
    """The matcher's fused tail as each arm in :func:`turns` (by default
    the twin and this kernel: twin, kernel, kernel, twin; or another
    library's kernel and this one) → per arm: lone dispatch ms (p50, mean)
    of ``matcher.match([topic])`` over the first ``lone`` topics, and the
    warm matcher-only pass's topics/s over ``topics`` in batches of
    ``batch``. The kernel arm's launches are not counted."""
    arms = arms or {"twin": CT.fused_compact_decode_plain, "this": CT.fused_compact_decode}
    out = {name: {"lone_p50_ms": [], "lone_mean_ms": [], "pass_topics_per_s": []}
           for name in arms}
    n0 = CT.fused_compact_decode.launches
    _pass_topics_per_s(matcher, topics, batch)  # warm the candidate cache
    try:
        for name in turns(arms):
            PP.fused_compact_decode = arms[name]
            ms = []
            for t in topics[:lone]:
                t0 = time.perf_counter()
                matcher.match([t])
                ms.append((time.perf_counter() - t0) * 1e3)
            out[name]["lone_p50_ms"].append(float(np.median(ms)))
            out[name]["lone_mean_ms"].append(float(np.mean(ms)))
            out[name]["pass_topics_per_s"].append(_pass_topics_per_s(matcher, topics, batch))
    finally:
        PP.fused_compact_decode = CT.fused_compact_decode
        CT.fused_compact_decode.launches = n0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--filters", type=int, default=1_000_000)
    ap.add_argument("--topics", type=int, default=16_384)
    ap.add_argument("--batch", type=int, default=16_384)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--other", type=Path, action="append", default=[],
                    help="another compact_tail.cu to time against the current one")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tail_kernels: no CUDA device; this run needs one GPU", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    rng = random.Random(args.seed)
    filters = gen_mixed(rng, args.filters)
    topics = gen_topics_uniform(rng, args.topics)
    table = PartitionedTable()
    for f in filters:
        table.add(f)
    table.compact()
    matcher = PartitionedMatcher(table, device=dev)
    matcher._refresh()
    print(f"table: {len(filters)} filters, {table.nchunks} chunks, built in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    stats = run(matcher, topics, args.batch)
    shapes_ab, arms = None, None
    if args.other:
        libs = {str(o): other_library(o) for o in args.other}
        libs["this"] = library_calls(kernel_library().lib)
        shapes_ab = ab_shapes(libs, real_shapes(matcher, topics, args.batch))
        arms = {ln: c["fused_compact_decode"] for ln, c in libs.items() if ln != "this"}
        arms["this"] = CT.fused_compact_decode
    ab = dispatch_ab(matcher, topics, args.batch, arms=arms)
    for name, r in ab.items():
        print(f"{name} tail: lone dispatch p50 {r['lone_p50_ms']} ms, mean "
              f"{r['lone_mean_ms']} ms; matcher-only pass {r['pass_topics_per_s']} "
              f"topics/s; {card}", flush=True)
    print(json.dumps({"card": card, "kernels": stats, "shapes_ab": shapes_ab,
                      "dispatch_ab": ab}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
