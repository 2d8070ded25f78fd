"""The retained-scan kernels at the shapes of cfg5's retained side, and
against another version of their source, in turns on one card.

The shapes (:func:`real_shapes`), on the 1M-draw table: the scanner's
64-filter batch (the first slice of ``run_retained``'s mix whose plan has
both tiers), and the broker's one-filter scans (``broker/retain.py`` scans
each SUBSCRIBE's filter alone): the narrow filter of the mix with the
longest candidate list (gather, B = 1) and the first broad filter that
compares a literal level (full, B = 1). :func:`retained_bound_ms`
(``bench/roofline_model.py``) is the least time the card could take for a
call.

    python -m rmqtt_tpu_torch.bench.retained_kernels --other OLD.cu [--other ...]

builds each ``OLD.cu`` (another ``retained_scan.cu``, for example an
earlier commit's: ``git show <commit>:rmqtt_tpu_torch/csrc/retained_scan.cu``)
beside the current ``match_words.cu`` into a library of its own, checks
every library's words equal to the plain twins at every shape, and times
them in turns (the others, this, this, the others in reverse) by CUDA-graph
replay and per call (a direct launch through ctypes, the same Python for
all). It prints the card's name and power limit, then one JSON line. It
needs one GPU.
"""

from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from rmqtt_tpu_torch.bench.roofline_model import retained_bound_ms
from rmqtt_tpu_torch.bench.timing import time_cuda, time_graph
from rmqtt_tpu_torch.bench.workloads import gen_retained_topics, retained_sub_filters
from rmqtt_tpu_torch.core.topic import HASH, PLUS, split_levels
from rmqtt_tpu_torch.ops import retained_part as RP
from rmqtt_tpu_torch.ops._build import SOURCES, kernel_library, load_library

RETAINED_BATCH = 64  # run_retained's scan batch


def both_tier_batch(scanner, filters):
    """The first 64-filter slice of the mix whose plan has both tiers →
    (its first index, the resident state, the plan's tiers)."""
    for lo in range(0, len(filters) - RETAINED_BATCH + 1, RETAINED_BATCH):
        st, tiers, _ = scanner.plan(filters[lo:lo + RETAINED_BATCH])
        if len(tiers) == 2:
            return lo, st, tiers
    raise AssertionError("no 64-filter slice of the mix has both tiers")


def one_filter_scans(scanner, filters):
    """The broker's shapes: ``[(filter, tier)]`` for the narrow filter of
    ``filters`` with the longest candidate list (a gather tier, B = 1) and
    the first broad one whose level 0 is a literal (a full tier, B = 1; on
    a table too small for such a filter to be broad, the first broad one),
    each tier ``(mode, encoded arrays, nc)`` as ``scanner.plan([filter])``
    gives it."""
    longest, broad, literal = None, None, None
    for f in dict.fromkeys(filters):
        _st, tiers, _ = scanner.plan([f])
        mode, _arrs, nc = tiers[0]
        if mode == "gather" and (longest is None or nc > longest[1][2]):
            longest = (f, tiers[0])
        if mode == "full":
            broad = broad or (f, tiers[0])
            if literal is None and split_levels(f)[0] not in (PLUS, HASH):
                literal = (f, tiers[0])
    if longest is None or broad is None:
        raise AssertionError("the mix lacks a narrow or a broad filter")
    return [longest, literal or broad]


def real_shapes(scanner, filters):
    """→ (resident state, ``[(label, mode, encoded arrays, shape text)]``):
    both tiers of the 64-filter batch (label ``"batch"``), then the two
    one-filter scans (label ``"one_filter"``)."""
    lo, st, tiers = both_tier_batch(scanner, filters)
    out = []
    for mode, arrs, nc in tiers:
        b = arrs[0].shape[0]
        shape = f"B={b} NC={nc}" if mode == "gather" else f"B={b} over {nc} tiles"
        out.append(("batch", mode, arrs,
                    f"{shape}, filters {lo}..{lo + RETAINED_BATCH - 1} of the mix"))
    for f, (mode, arrs, nc) in one_filter_scans(scanner, filters):
        shape = f"B=1 NC={nc}" if mode == "gather" else f"B=1 over {nc} tiles"
        out.append(("one_filter", mode, arrs, f"{shape}, '{f}'"))
    return st, out


# ------------------------------------------------------------ comparison
def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def direct_call(lib, mode: str, args):
    """A launch of ``lib``'s kernel for ``mode`` on ``args`` (tiles, the
    five filter fields, chunk ids for the gather) through ctypes, on the
    current stream → (call, its output tensor)."""
    tiles, fields = args[0], args[1:6]
    ptrs = [f.data_ptr() for f in fields]
    dims = (tiles.data_ptr(), tiles.element_size(), tiles.shape[0], tiles.shape[1] - 3)
    b = fields[0].shape[0]
    if mode == "gather":
        ids = args[6]
        nc = ids.shape[1]
        out = torch.empty((b, nc * RP.WORDS_PER_CHUNK), dtype=torch.int32, device=tiles.device)

        def call():
            err = lib.launch_retained_scan_gather(*dims, *ptrs, ids.data_ptr(), b, nc,
                                                  out.data_ptr(),
                                                  torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch_retained_scan_gather: CUDA error {err}")
    else:
        out = torch.empty((b, tiles.shape[0] * RP.WORDS_PER_CHUNK), dtype=torch.int32,
                          device=tiles.device)

        def call():
            err = lib.launch_retained_scan_full(*dims, *ptrs, b, out.data_ptr(),
                                                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch_retained_scan_full: CUDA error {err}")
    return call, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path, action="append",
                    help="another retained_scan.cu to time against the current one")
    ap.add_argument("--retained", type=int, default=1_000_000, help="cfg5 retained draws")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("retained_kernels: no CUDA device; this run needs one GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    libs = {str(o): load_library((SOURCES[0], o.resolve())).lib for o in args.other}
    others = list(libs)
    libs["this"] = kernel_library().lib
    t0 = time.perf_counter()
    table = RP.RetainedTable()
    for t in gen_retained_topics(random.Random(args.seed + 5), args.retained):
        table.add(t)
    scanner = RP.PartitionedRetainedScanner(table, device=dev)
    st, shapes = real_shapes(scanner, retained_sub_filters(random.Random(5)))
    print(f"table: {table.size} topics, tiles {tuple(st.rows.shape)} {st.rows.dtype}, "
          f"built in {time.perf_counter() - t0:.1f}s", flush=True)
    rows = []
    for label, mode, arrs, shape in shapes:
        dargs = (st.rows, *(torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)
                            for a in arrs))
        plain = (RP.retained_scan_words_plain if mode == "gather"
                 else RP.retained_scan_full_plain)(*dargs)
        calls = {}
        for name, lib in libs.items():
            call, out = direct_call(lib, mode, dargs)
            call()
            torch.cuda.synchronize()
            if not torch.equal(out, plain):
                raise AssertionError(f"{name} {mode} at {shape}: words differ from the twin")
            calls[name] = call
        row = {"label": label, "kernel": f"retained_scan_{mode}", "shape": shape,
               **{name: {"graph_ms": [], "call_ms": []} for name in libs}}
        for name in [*others, "this", "this", *others[::-1]]:  # in turns
            row[name]["graph_ms"].append(time_graph(calls[name], reps=20))
            row[name]["call_ms"].append(time_cuda(calls[name], reps=50))
        row["bound_ms"], row["bound_by"], row["bound_term"] = retained_bound_ms(
            st.rows, dargs[1:6], dargs[6] if mode == "gather" else None)
        print(f"{label} {mode} {shape}: " + "; ".join(f"{n} {row[n]}" for n in libs)
              + f"; bound {row['bound_ms']:.5f} ms by {row['bound_by']} "
              f"({row['bound_term']}); all equal to the twin",
              flush=True)
        rows.append(row)
    print(json.dumps({"card": card, "others": others, "shapes": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
