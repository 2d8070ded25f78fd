"""The compaction tails' design choices (``csrc/compact_tail.cu``), each
undone in turn, timed at the main path's shapes on one card.

    python -m rmqtt_tpu_torch.bench.tail_variants

builds, beside the current source, variants of it that each undo one
choice of the single pass:

- ``no_speculation``: the topics of at most 32 routes are gathered after
  the block's prefix is known, not while it waits for it;
- ``packed_groups``: the group sums 8 bytes apart, not a 128-byte line each;
- ``rows_1`` / ``rows_4``: one / four topics a warp at every batch, not
  four only where the one-topic grid would not fit on the card at once;

and two knock-outs that time parts of the single pass (their wires are
wrong and are not checked): ``no_place`` (counts and prefixes, no place)
and ``counts_only`` (no prefix either). It holds every other variant to
the twins (``torch.equal``) at every shape of
:func:`~rmqtt_tpu_torch.bench.tail_kernels.real_shapes` on cfg3's table
(1,000,000 ``gen_mixed`` filters, 16,384 ``gen_topics_uniform`` topics),
times all of them there in turns (the variants, this, this, the variants
reversed) by CUDA-graph replay, and gives the device time of each
operation of one call of this source at cfg3 and at the broker's one
topic (``torch.profiler``). It prints the card's name and power limit, a
line a shape, then one JSON line. It needs one GPU.
"""

from __future__ import annotations

import json
import random
import sys
import time
from pathlib import Path

import torch

from rmqtt_tpu_torch.bench import tail_kernels as TK
from rmqtt_tpu_torch.bench.retained_kernels import card_line
from rmqtt_tpu_torch.bench.timing import time_graph
from rmqtt_tpu_torch.bench.workloads import gen_mixed, gen_topics_uniform
from rmqtt_tpu_torch.ops._build import BUILD_DIR, SOURCES, kernel_library
from rmqtt_tpu_torch.ops.partitioned import PartitionedMatcher, PartitionedTable

_SPECULATE = ("if (t < b && cnt[r] > 0 && cnt[r] <= 32) spec[r] =",
              "if (false) spec[r] =")
_SPEC_STORE = ("if (k > 0 && k == cnt[r] && k <= 32) {", "if (false) {")
_PLACE = ("if (t < b) {\n      const long long off = off_s[wid + r * kPassWarps];",
          "if (t < 0) {\n      const long long off = off_s[wid + r * kPassWarps];")
_PREFIX = ("const long long base = prefix(flags, groups, bid, lane);",
           "const long long base = 0;")
#: variant → the (text, replacement) edits of the source that make it
VARIANTS = {
    "no_speculation": (_SPECULATE, _SPEC_STORE),
    "packed_groups": (("constexpr int kGroupPad = 16;", "constexpr int kGroupPad = 1;"),),
    "rows_1": (("if (pass_blocks(b) <= wave) {", "if (true) {"),),
    "rows_4": (("if (pass_blocks(b) <= wave) {", "if (false) {"),),
    "no_place": (_SPECULATE, _SPEC_STORE, _PLACE),
    "counts_only": (_SPECULATE, _SPEC_STORE, _PLACE, _PREFIX),
}
KNOCKOUTS = ("no_place", "counts_only")


def variant_source(name: str) -> Path:
    """Write variant ``name`` of the current ``compact_tail.cu`` under the
    build directory → its path; raises where the source no longer has the
    text a variant edits."""
    src = next(p for p in SOURCES if p.name == "compact_tail.cu").read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise ValueError(f"variant {name}: the source no longer has {old!r}")
        src = src.replace(old, new)
    out = BUILD_DIR / "variants" / name / "compact_tail.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(src)
    return out


def device_us(fn) -> dict:
    """{operation: device µs} of one call of ``fn`` (after a warm-up call),
    by ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us:
            out[e.key[:60]] = us / e.count
    return out


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("tail_variants: no CUDA device; this run needs one GPU", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    libs = {name: TK.other_library(variant_source(name)) for name in VARIANTS}
    libs["this"] = TK.library_calls(kernel_library().lib)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    rng = random.Random(0)
    filters = gen_mixed(rng, 1_000_000)
    topics = gen_topics_uniform(rng, 16_384)
    table = PartitionedTable()
    for f in filters:
        table.add(f)
    table.compact()
    matcher = PartitionedMatcher(table, device=dev)
    matcher._refresh()
    print(f"table: {len(filters)} filters built in {time.perf_counter() - t0:.1f}s",
          flush=True)
    shapes = TK.real_shapes(matcher, topics, len(topics))
    out = {"card": card, "shapes": {}, "profile": {}}
    for label, words, fids, cids, budget in shapes:
        for name, (_kern, twin) in TK.PAIRS.items():
            a = TK._args(name, words, fids, cids, budget)
            want = twin(*a)
            calls = {ln: (lambda f: lambda: f(*a))(c[name]) for ln, c in libs.items()}
            for ln, call in calls.items():
                got = call()
                torch.cuda.synchronize()
                if ln not in KNOCKOUTS and not torch.equal(got, want):
                    raise AssertionError(f"{ln}'s {name} differs from the twin at {label}")
            row = {ln: [] for ln in libs}
            for ln in TK.turns(libs):
                row[ln].append(time_graph(calls[ln], reps=10))
            out["shapes"][f"{name} {label}"] = row
            print(f"{name} {label}: " + "; ".join(
                f"{ln} {[round(x, 5) for x in v]}" for ln, v in row.items()), flush=True)
            if label.startswith("cfg3 B=") and "cut" not in label or label == "broker B=1":
                prof = device_us(calls["this"])
                out["profile"][f"{name} {label}"] = prof
                print(f"    this, device µs a call: {prof}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
