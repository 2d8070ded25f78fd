"""The multi-device matchers on every card of the host.

    python -m rmqtt_tpu_torch.bench.mesh_cards [--filters 200000]

Run from the repository's root on a machine with one or more NVIDIA cards.
It builds ``chip_smoke.py``'s packed router and a dense router over
``gen_mixed`` filters, runs ``chip_smoke.py`` phase 4s (over ``[cuda:0] x
2``, then over every card when there is more than one: ``ShardedMatcher``
against ``DenseMatcher``, ``ShardedPartitionedMatcher`` fused, unfused and
topk against the local matcher, a ``TorchRouter(mesh=...)``), then a
``TorchRouter()`` with ``mesh="auto"`` and no device, which must take every
card when there is more than one, routing 4 batches of 1,024 equal to its
native trie mirror. Any difference fails the run; the last line is
``{"ok": true, ...}`` with the card count and each mode's topics/s.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--filters", type=int, default=200_000)
    ap.add_argument("--topics", type=int, default=32_768)
    ap.add_argument("--batch", type=int, default=16_384)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mesh_cards: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from rmqtt_tpu_torch.parallel import ShardedPartitionedMatcher
    from rmqtt_tpu_torch.router import Id, SubscriptionOptions, TorchRouter

    dev = torch.device("cuda", 0)
    ncards = torch.cuda.device_count()
    C.log(f"{ncards} card(s); {C.card_line()}")
    C.phase_build()
    rng = random.Random(0)
    filters = C.gen_mixed(rng, args.filters)
    topics = C.gen_topics_uniform(rng, args.topics)
    packed = C.build_router(filters, dev, packed=True)
    with C.environment({"RMQTT_HYBRID_MAX": "0"}):
        dense = TorchRouter(device=dev, backend="dense")
    opts = SubscriptionOptions()
    for i, f in enumerate(filters):
        dense.add(f, Id(1, f"c{i}"), opts)
    t0 = time.perf_counter()
    out = C.phase_sharded(dense, packed, topics, args.batch, filters, dev)
    C.log(f"    4s in {time.perf_counter() - t0:.1f} s")
    with C.environment({"RMQTT_HYBRID_MAX": "0"}):
        auto = TorchRouter()
    m = auto.matcher
    if ncards > 1 and not (isinstance(m, ShardedPartitionedMatcher) and m.ndev == ncards):
        raise AssertionError(f"mesh='auto' on {ncards} cards built {type(m).__name__}")
    for i, f in enumerate(filters[:20_000]):
        auto.add(f, Id(1, f"c{i}"), opts)
    for lo in range(0, 4 * 1024, 1024):
        items = [(None, t) for t in topics[lo:lo + 1024]]
        got = [C._routed_filters(r) for r in auto.matches_batch_raw(items)]
        want = [C._routed_filters(r) for r in auto.host_matches_batch_raw(items)]
        if got != want:
            raise AssertionError("mesh='auto' router differs from its trie mirror")
    C.log(f"    TorchRouter() with mesh='auto': {type(m).__name__} over "
          f"{[str(d) for d in getattr(m, 'devices', [getattr(m, 'device', None)])]}; "
          f"4 batches of 1,024 equal to its native trie mirror; hbm {auto.device_hbm()}")
    print(json.dumps({"ok": True, "cards": ncards, "modes": out["modes"],
                      "all_cards": out.get("all_cards", {}).get("modes")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
