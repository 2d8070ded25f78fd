"""The dense inverse's design choices (``csrc/dense_match.cu``
``dense_inverse_kernel``), each changed in turn, timed at chip_smoke 4d's
shapes on one card.

    python -m rmqtt_tpu_torch.bench.dense_variants

builds, beside the current source, variants of it that each change one
choice of the inverse at up to 8 levels (the 4d table's):

- ``rows_2`` / ``rows_8``: two or eight rows a lane, not four;
- ``warps_8``: eight warps a block, not four;

holds each to the twin (``torch.equal``) on 4d's retained table (a
``FilterTable`` of cfg5's 1,000,000 retained draws, seed 5) at 1, 8 and 64
filters of ``retained_sub_filters`` and times all of them there in turns
(the variants, this, this, the variants reversed) by CUDA-graph replay (the
table warm in the L2 cache) and with the L2 cache flushed before each
call. It prints the card's name and power limit, a line a
shape, then one JSON line. It needs one GPU.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

from rmqtt_tpu_torch.bench import dense_kernels as DK
from rmqtt_tpu_torch.bench.retained_kernels import card_line
from rmqtt_tpu_torch.ops._build import BUILD_DIR, SOURCES, kernel_library, load_library

_ROWS = "return launch_inverse<8, 4>(DENSE_RETAINED_ARGS);"
#: variant → the (text, replacement) edits of the source that make it
VARIANTS = {
    "rows_2": ((_ROWS, "return launch_inverse<8, 2>(DENSE_RETAINED_ARGS);"),),
    "rows_8": ((_ROWS, "return launch_inverse<8, 8>(DENSE_RETAINED_ARGS);"),),
    "warps_8": (("constexpr int INV_WARPS = 4;", "constexpr int INV_WARPS = 8;"),),
}


def variant_source(name: str) -> Path:
    """Write variant ``name`` of the current ``dense_match.cu`` under the
    build directory → its path; raises where the source no longer has the
    text a variant edits."""
    src = next(p for p in SOURCES if p.name == "dense_match.cu").read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise ValueError(f"variant {name}: the source no longer has {old!r}")
        src = src.replace(old, new)
    out = BUILD_DIR / "variants" / name / "dense_match.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(src)
    return out


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("dense_variants: no CUDA device; this run needs one GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    libs = {name: load_library((variant_source(name),)).lib for name in VARIANTS}
    others = list(libs)
    libs["this"] = kernel_library().lib
    rows = DK.inverse_shapes(libs, others, *DK.retained_table(dev, 0), dev)
    print(json.dumps({"card": card, "variants": others, "shapes": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
