"""The port's roofline numbers in one place: the analytic device-memory
model of the partitioned match (``model_table``), and the least time the
card could take for one call of each hand-written kernel
(``words_bound_ms``, ``dense_bound_ms``, ``dense_words_bound_ms``,
``retained_bound_ms``, ``fused_tail_bound_ms``, ``compact_global_bound_ms``).

``chip_smoke.py`` phase 4 calls ``model_table`` against the live 1M-filter
packed table with the candidate counts of the first 2,048 topics and the
pass's measured topics/s, so each run prints its modeled ceiling beside
its measured rate. The model (see ``ops/partitioned.pack_device_rows`` /
``pack_device_rows_packed`` for the layouts):

    tile_bytes_legacy  = (L+3) * CHUNK * dtype_size      # int16 field-major
    tile_bytes_packed  = groups * CHUNK * 4              # int32 byte planes
    bytes_per_topic    = NC_eff * tile_bytes             # the scan's gathers
                       + NC_eff * WPC * 4                # packed words out
    ceiling            = HBM_BW / bytes_per_topic        # topics/s if bound

plus the fused pipeline's deltas: the words array no longer round-trips
between two launches, and the device→host wire carries 4 B/route (final
fids) instead of 2 B/route and a host-side chunk gather, fid map and sort.

The default part is the H100's device memory (``bench/timing.py``'s
``HBM_BYTES_PER_S``); ``V5E_HBM_GBPS`` is the JAX package's default,
kept so that the two models can be held equal at one rate.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from rmqtt_tpu_torch.bench.timing import (HBM_BYTES_PER_S, INSTR_PER_S, L2_BYTES,
                                          SM_LOAD_BYTES_PER_S)
from rmqtt_tpu_torch.ops.encode import PLUS_TOK
from rmqtt_tpu_torch.ops.partitioned import CHUNK, WORDS_PER_CHUNK

#: the modeled part: the H100's device memory rate (GB/s)
H100_HBM_GBPS = HBM_BYTES_PER_S / 1e9
#: the JAX package's default part (v5e, GB/s); no figure of the port uses it
V5E_HBM_GBPS = 819.0


def tile_bytes_legacy(max_levels: int, tok_wide: bool = False) -> int:
    """One gathered tile in the legacy int16/int32 field-major layout."""
    return (max_levels + 3) * CHUNK * (4 if tok_wide else 2)


def tile_bytes_packed(layout) -> int:
    """One gathered tile in the bit-packed int32 byte-plane layout."""
    return layout.groups * CHUNK * 4


def model_table(table, ncs: Sequence[int], bw_gbps: float = H100_HBM_GBPS,
                measured_topics_per_sec: Optional[float] = None) -> dict:
    """Device-memory roofline of one table against a measured candidate
    count sample ``ncs`` (one entry per topic of the real publish stream).
    With ``measured_topics_per_sec`` the measured fraction of the ceiling
    is included. The same dict, key for key, as the JAX package's model for
    the same table contents, ``ncs`` and ``bw_gbps``."""
    ncs = np.asarray(ncs, dtype=np.float64)
    nc_eff = float(ncs.mean()) if ncs.size else 1.0
    layout = table.packed_layout()
    legacy = tile_bytes_legacy(table.max_levels, table._tok_wide)
    ptile = tile_bytes_packed(layout) if layout is not None else None
    out_bytes = nc_eff * WORDS_PER_CHUNK * 4
    bpt_legacy = nc_eff * legacy + out_bytes
    bpt = nc_eff * ptile + out_bytes if ptile is not None else bpt_legacy
    bw = bw_gbps * 1e9
    out = {
        "hbm_gbps": bw_gbps,
        "nc_mean": round(nc_eff, 2),
        "nc_p99": int(np.percentile(ncs, 99)) if ncs.size else 0,
        "tile_bytes_legacy": legacy,
        "tile_bytes_packed": ptile,
        "packed_tile_reduction_x": (
            round(legacy / ptile, 2) if ptile else None),
        "bytes_per_topic_legacy": int(bpt_legacy),
        "bytes_per_topic": int(bpt),
        "hbm_bytes_reduction_x": round(bpt_legacy / bpt, 2),
        "ceiling_topics_per_sec": int(bw / bpt),
        "ceiling_topics_per_sec_legacy": int(bw / bpt_legacy),
        # what the fused pipeline removes per topic: the [B, NC*WPC] words
        # written by the words kernel and read again by the compaction, and
        # the host decode (chunk gather + fid map + sort); what it costs:
        # 4 B/route on the wire instead of 2
        "fused": {
            "words_roundtrip_bytes_per_topic": int(
                2 * nc_eff * WORDS_PER_CHUNK * 4),
            "wire_bytes_per_route": 4,
            "unfused_wire_bytes_per_route": 2,
            "host_decode_on_wire": False,
        },
    }
    if measured_topics_per_sec is not None:
        out["measured_topics_per_sec"] = round(measured_topics_per_sec, 1)
        out["measured_fraction_of_ceiling"] = round(
            measured_topics_per_sec / max(1.0, out["ceiling_topics_per_sec"]),
            4)
    return out


# ------------------------------------------------- the kernels' least time
# A kernel's least time on the H100 is the larger of two: the bytes it
# must move over the memory rate and the lane-instructions it must issue
# over the issue rate (one warp instruction a clock on each of an SM's four
# schedulers).
#
# The bytes go at the device-memory rate for a call whose inputs are cold,
# as a caller that touched other data since the last call finds them. A
# call repeated on the same inputs (a CUDA-graph replay) finds up to the
# L2 cache's 50 MB of them there: only the rest must come from device
# memory, and every byte still passes the SMs' loads, at 128 bytes a clock
# an SM. That ``warm`` bound is far below the cold one for a table that
# fits the L2: the L2's own rate is not published, so it is the one that
# holds.
#
# A full-scan row test (the words kernels, the dense scans) of one query
# against one row must fold a difference for each literal level (a level
# below the filter's prefix that is not '+': ``r - t`` by an IMAD, or ``r ^
# t`` folded straight in by a LOP3) and one for the length rule, at least
# one instruction each, and turn the test into its bit, one more (a vote or
# a shift). A 3-input LOP3 folds at most two differences into the test,
# and its predicate output can be the test's result: the ALU pipe's floor
# is half an operation a difference at half the issue rate, and the FMA
# pipe's IMAD can make any difference, so no pipe's own rate binds before
# the issue rate. With the tokens as the 32-bit values the tables hold, no
# kernel of the same scan does less.


def _bound(nbytes: int, issue: float, warm: bool = False):
    """→ (the least time in ms: the larger of the bytes over the memory
    rate, cold or ``warm`` (see above), and the lane-instructions ``issue``
    over the issue rate; "bytes" or "operations"; which term set it:
    "bytes" or "issue")."""
    moved = (max(max(nbytes - L2_BYTES, 0) / HBM_BYTES_PER_S, nbytes / SM_LOAD_BYTES_PER_S)
             if warm else nbytes / HBM_BYTES_PER_S)
    terms = {"bytes": moved, "issue": issue / INSTR_PER_S}
    term = max(terms, key=terms.get)
    return terms[term] * 1e3, "bytes" if term == "bytes" else "operations", term


def row_test_work(pairs: int, literal: int) -> int:
    """The least lane-instructions of ``pairs`` row tests that compare
    ``literal`` literal levels in all (see above): a difference for each
    literal level and each test's length rule, and each test's bit."""
    return literal + 2 * pairs


def literal_levels(tok: torch.Tensor, prefix: torch.Tensor, live: torch.Tensor):
    """Literal levels of each live row of a ``[N, L]`` token table: levels
    below ``min(prefix, L)`` whose token is not '+' (a row that is not
    live counts none) → ``[N]`` int64."""
    lvl = tok.shape[1]
    below = torch.arange(lvl, device=tok.device)[None, :] < prefix.to(torch.int64)[:, None]
    return ((below & (tok != PLUS_TOK)).sum(dim=1) * live).to(torch.int64)


def chunk_literals(table) -> torch.Tensor:
    """Literal levels of each row chunk of a ``PartitionedTable`` (its live
    rows: ``flen >= 0``) → ``[nchunks]`` int64, the ``lit_chunk`` of
    :func:`words_bound_ms`."""
    rows = table.nchunks * CHUNK
    lit = literal_levels(torch.from_numpy(table.tok[:rows]),
                         torch.from_numpy(table.prefix_len[:rows]),
                         torch.from_numpy(table.flen[:rows] >= 0))
    return lit.reshape(table.nchunks, CHUNK).sum(dim=1)


def words_bound_ms(tiles, ttok, chunk_ids, lit_chunk: torch.Tensor):
    """Least time for one words call on these inputs: the bytes it must
    move (each referenced tile, each input read once, the words written
    once) and :func:`row_test_work` of its row tests (each real slot's
    ``CHUNK`` rows, with the literal levels ``lit_chunk`` of their chunk).
    Chunk 0 is the table's empty chunk: a slot naming it (padding) needs no
    tile read and no row test, only its zero words. → :func:`_bound`."""
    b, nc = chunk_ids.shape
    tile_bytes = tiles[0].numel() * tiles.element_size()
    real = chunk_ids != 0
    used = torch.unique(chunk_ids[real]).numel()
    nbytes = (used * tile_bytes + chunk_ids.numel() * 4 + ttok.numel() * 4
              + 2 * b * 4 + b * nc * WORDS_PER_CHUNK * 4)
    literal = int(lit_chunk.to(chunk_ids.device)[chunk_ids[real].long()].sum())
    return _bound(nbytes, row_test_work(int(real.sum()) * CHUNK, literal))


def dense_bound_ms(rows: int, lvl: int, b: int, literal: int, warm: bool = False):
    """Least time for one dense scan of ``b`` queries (topics, or the
    inverse's filters) against ``rows`` rows of ``lvl`` levels: every
    (query, row) pair is tested, whatever the data, comparing ``literal``
    literal levels in all (the forward: ``b`` times the rows'
    :func:`literal_levels`; the inverse: ``rows`` times the filters'); the
    bytes are the table and the batch read once, tokens and at least 5
    bytes of metadata a row or query (a topic's length and ``$`` flag; a
    filter's also has its prefix and two flags, 10 bytes), and the bitmap
    written once. ``warm``: the call repeats on the same inputs, as a graph
    replay does. → :func:`_bound`."""
    nbytes = (rows + b) * (lvl * 4 + 5) + b * rows // 8
    return _bound(nbytes, row_test_work(b * rows, literal), warm)


def dense_words_bound_ms(b: int, w: int, k: int):
    """Least time for one dense words call (``match_words``, and the topk
    mode's ``compact_words``) on a ``[b, w]`` bitmap with ``k`` slots a
    topic: the bitmap read once and ``word_idx``, ``word_bits`` (``[b, k]``
    each) and ``counts`` written once; ~2 instructions a word (a popcount
    and a test). → :func:`_bound`."""
    return _bound(b * w * 4 + b * (2 * k + 1) * 4, 2 * b * w)


def retained_work(tiles, fields, chunk_ids=None):
    """What one retained-scan call on these inputs must do, counting only
    what a row test needs. Bytes: of each tile it must test (gather: the
    distinct nonzero ids, chunk 0 being the empty chunk that pads every
    list; full: the tiles that hold a live row) the rows its filters read —
    rlen; flags if one of them starts with a wildcard (the ``$`` check);
    the token rows of their literal (non-``+``) levels within their prefix
    — then the filter fields and ids read once and the words written once.
    Operations: each test of a real filter (``flen != -2``) against a live
    32-bit word of rows costs ~6 plus 2 per literal level of the filter; a
    word holds one int32 row or two int16 rows (one operation tests both
    halves), and is live when one of its rows is (``rlen >= 1``). → (bytes,
    operations)."""
    lvl = tiles.shape[1] - 3
    row_bytes = tiles.shape[2] * tiles.element_size()
    ftok, flen, fprefix, _fhash, fwild = fields
    real_f = flen != -2
    lit = ((torch.arange(lvl, device=ftok.device)[None, :] < fprefix[:, None])
           & (ftok != PLUS_TOK) & real_f[:, None])  # [B, L]
    # per filter, the rows a test of it reads: its literal token rows,
    # rlen, flags
    need = torch.cat([lit, real_f[:, None], ((fwild != 0) & real_f)[:, None]], dim=1)
    op_f = (6 + 2 * lit.sum(dim=1)) * real_f  # operations per word test
    live = tiles[:, lvl, :] >= 1
    if tiles.element_size() == 2:
        live = live[:, 0::2] | live[:, 1::2]  # rows 2m, 2m+1 share a word
    live_n = live.sum(dim=1)  # live words per tile
    in_bytes = sum(f.numel() * 4 for f in fields)
    if chunk_ids is None:
        rows_read = int(need.any(dim=0).sum()) * int((live_n > 0).sum())
        ops = int(live_n.sum()) * int(op_f.sum())
        out_words = ftok.shape[0] * tiles.shape[0] * WORDS_PER_CHUNK
    else:
        ids = chunk_ids.long()
        real = (ids != 0) & real_f[:, None]
        # a tile is read once per row whichever of its slots need the row
        rows_read = sum(torch.unique(ids[real & need[:, r:r + 1]]).numel()
                        for r in range(need.shape[1]))
        ops = int((live_n[ids] * op_f[:, None])[real].sum())
        in_bytes += chunk_ids.numel() * 4
        out_words = chunk_ids.numel() * WORDS_PER_CHUNK
    return rows_read * row_bytes + in_bytes + out_words * 4, ops


def retained_bound_ms(tiles, fields, chunk_ids=None):
    """Least time for one retained-scan call: :func:`retained_work`'s bytes
    over the memory rate, its operations as instructions over the issue
    rate. → :func:`_bound`."""
    return _bound(*retained_work(tiles, fields, chunk_ids))


def _kept(cnts: torch.Tensor, budget: int) -> torch.Tensor:
    """Each topic's kept routes: ``clamp(budget - off, 0, cnt)``, ``off``
    the exclusive scan of the counts (int64)."""
    c = cnts.to(torch.int64)
    off = torch.cumsum(c, 0) - c
    return torch.minimum((budget - off).clamp(min=0), c)


def fused_tail_work(words, chunk_ids, cnts, budget: int):
    """What one fused-tail call (``fused_compact_decode``) on these inputs
    must do. Bytes: the words and the chunk ids read once, one fid read a
    kept route, the ``[budget + B]`` int32 wire written once. Operations:
    2 a word (its popcount, the sum), 2 a topic (the scan), and a kept
    route ~4 (its row's address and slot) plus the compares of a
    comparison sort of its topic's kept routes (log2 of their count).
    ``cnts``: the topics' route counts (the wire's tail). → (bytes,
    operations)."""
    b = words.shape[0]
    k = _kept(cnts, budget)
    n = int(k.sum())
    lg = torch.log2(k.clamp(min=1).to(torch.float64)).ceil()
    ops = 2 * words.numel() + 2 * b + 4 * n + int((k * lg).sum())
    nbytes = (words.numel() + chunk_ids.numel() + n + budget + b) * 4
    return nbytes, ops


def fused_tail_bound_ms(words, chunk_ids, cnts, budget: int):
    """Least time for one fused-tail call: :func:`fused_tail_work`'s bytes
    over the memory rate, its operations as instructions over the issue
    rate. → :func:`_bound`."""
    return _bound(*fused_tail_work(words, chunk_ids, cnts, budget))


def compact_global_work(words, cnts, budget: int):
    """What one ``compact_global`` call on these inputs must do. Bytes: the
    words read once and the ``[budget + B]`` wire written once, 2 bytes a
    slot while ``W*32 < 0x10000``, else 4. Operations: 2 a word, 2 a topic
    and 2 a kept route (its value and slot). → (bytes, operations)."""
    b, w = words.shape
    n = int(_kept(cnts, budget).sum())
    elem = 2 if w * 32 < 0x10000 else 4
    return words.numel() * 4 + (budget + b) * elem, 2 * words.numel() + 2 * b + 2 * n


def compact_global_bound_ms(words, cnts, budget: int):
    """Least time for one ``compact_global`` call, as
    :func:`fused_tail_bound_ms`. → :func:`_bound`."""
    return _bound(*compact_global_work(words, cnts, budget))
