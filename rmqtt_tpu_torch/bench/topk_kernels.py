"""The topk mode's compaction (``compact_words``: one launch of
``csrc/dense_match.cu``'s ``launch_dense_match_words`` writing the wire's
three slices) at the partitioned matcher's shapes, beside its torch-ops
twin and ``torch.topk`` on unique keys, and against other versions of the
source, in turns on one card.

The shapes: the match words (``words_any``, ``[B, 4 NC]``, NC the batch's
candidate width) of cfg3's 1,000,000 ``gen_mixed`` filters (seed 0) in a
packed ``PartitionedTable`` for ``gen_topics_uniform`` topics: 16,384 of
them (chip_smoke 4m's batch) at the topk mode's ``max_words`` of 32 and a
regrow's 64, and 1 and 8 (the broker's batches) at 32.
``dense_words_bound_ms`` (``bench/roofline_model.py``) is the least time
the card could take.

    python -m rmqtt_tpu_torch.bench.topk_kernels [--other OLD.cu ...]

builds each ``OLD.cu`` (another ``dense_match.cu``, for example an earlier
commit's: ``git show <commit>:rmqtt_tpu_torch/csrc/dense_match.cu``) into a
library of its own beside the current one, holds every library's wire and
``torch.topk``'s indices on the keys ``2W - idx`` (a nonzero word) and ``W -
idx`` (a zero word) to the plain twin, then times every library in turns
(the others, this, this, the others reversed) by CUDA events and CUDA-graph
replay, beside the twin and ``torch.topk``. It prints the card's name and
power limit, a line a shape, then one JSON line. It needs one GPU.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path

import numpy as np
import torch

from rmqtt_tpu_torch.bench.retained_kernels import card_line
from rmqtt_tpu_torch.bench.roofline_model import dense_words_bound_ms
from rmqtt_tpu_torch.bench.timing import time_cuda, time_graph
from rmqtt_tpu_torch.bench.workloads import gen_mixed, gen_topics_uniform
from rmqtt_tpu_torch.ops import compact_tail as CT
from rmqtt_tpu_torch.ops import match_words as MW
from rmqtt_tpu_torch.ops._build import kernel_library, load_library
from rmqtt_tpu_torch.ops.partitioned import PartitionedMatcher, PartitionedTable

FILTERS = 1_000_000  # cfg3's filters
BATCH = 16_384  # chip_smoke 4m's batch
SHAPES = ((BATCH, 32), (BATCH, 64), (1, 32), (8, 32))  # (topics, max_words)


def match_words(matcher, topics, dev) -> torch.Tensor:
    """The packed words kernel's ``[B, 4 NC]`` output for ``topics``."""
    t = matcher.table
    st = matcher._refresh()
    ttok, tlen, tdollar, cids, _nc = t.encode_topics(topics, pad_batch_to=len(topics))
    _lay, tt = t.translate_packed(ttok)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)  # noqa: E731
    n0 = MW.match_words_packed.launches
    words = MW.match_words_packed(st.tiles, put(tt), put(tlen), put(tdollar), put(cids),
                                  st.layout)
    MW.match_words_packed.launches = n0
    return words


def unique_keys(words: torch.Tensor) -> torch.Tensor:
    """``torch.topk``'s keys that give ``compact_words``'s order: a nonzero
    word ``2W - idx``, a zero word ``W - idx``, all distinct."""
    w = words.shape[1]
    idx = torch.arange(w, dtype=torch.int32, device=words.device)
    return torch.where(words != 0, 2 * w - idx, w - idx)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, action="append", default=[],
                    help="another dense_match.cu to time against the current one")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("topk_kernels: no CUDA device; this run needs one GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    libs = {str(o): load_library((o.resolve(),)).lib for o in args.other}
    others = list(libs)
    libs["this"] = kernel_library().lib

    t0 = time.perf_counter()
    rng = random.Random(args.seed)
    table = PartitionedTable()
    for f in gen_mixed(rng, FILTERS):
        table.add(f)
    table.compact()
    topics = gen_topics_uniform(rng, BATCH)
    matcher = PartitionedMatcher(table, device=dev)
    print(f"table: {FILTERS} filters, {table.nchunks} chunks, built in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    rows = []
    for b, k in SHAPES:
        words = match_words(matcher, topics[:b], dev)
        w = words.shape[1]
        kw = min(k, w)
        want = CT.topk_wire_plain(words, k)
        wi = want[:b * kw].view(b, kw)
        keys = unique_keys(words)
        calls = {name: (lambda lib=lib: CT.launch_words(lib, words, kw))
                 for name, lib in libs.items()}
        for name, call in calls.items():
            if not torch.equal(call(), want):
                raise AssertionError(f"{name}'s wire differs from the twin at [{b}, {w}] "
                                     f"K={kw}")
        if not torch.equal(torch.topk(keys, kw, dim=1).indices.to(torch.int32), wi):
            raise AssertionError(f"torch.topk on unique keys differs at [{b}, {w}] K={kw}")
        row = {"kernel": "compact_words", "b": b, "w": w, "k": kw,
               "nonzero_words": int((words != 0).sum()),
               **{name: {"ms": [], "graph_ms": []} for name in libs}}
        for name in [*others, "this", "this", *others[::-1]]:  # in turns
            row[name]["ms"].append(time_cuda(calls[name], reps=50))
            row[name]["graph_ms"].append(time_graph(calls[name], reps=10))
        row["plain_ms"] = time_cuda(lambda: CT.topk_wire_plain(words, k), reps=20)
        row["plain_graph_ms"] = time_graph(lambda: CT.topk_wire_plain(words, k), reps=5)
        row["library_ms"] = time_cuda(lambda: torch.topk(keys, kw, dim=1), reps=20)
        row["library_graph_ms"] = time_graph(lambda: torch.topk(keys, kw, dim=1), reps=5)
        row["bound_ms"], row["bound_by"], row["bound_term"] = dense_words_bound_ms(b, w, kw)
        print(f"compact_words [{b}, {w}] K={kw}: {row}; all equal to the twin; {card}",
              flush=True)
        rows.append(row)
    print(json.dumps({"card": card, "others": others, "shapes": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
