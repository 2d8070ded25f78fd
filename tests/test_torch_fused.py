"""Fused tail parity: the port's ``fused_compact_decode`` and its
``match_fused*`` compositions against the JAX package's, on the same words
and the same tables (exact: every value is an integer)."""

import random

import jax
import numpy as np
import pytest
import torch

import rmqtt_tpu.ops.partitioned as JP
import rmqtt_tpu_torch.ops.partitioned as TP
from rmqtt_tpu.core.topic import match_filter


def _words_case(seed, b=24, nc=6, up=16, density=0.15):
    """Random sparse uint32 words, chunk ids and a fid map with some -1."""
    rng = np.random.default_rng(seed)
    bits = rng.random((b, nc * 4, 32)) < density / 8
    bits[-3:] = False  # padded topics carry no bits
    words = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
    words = words.astype(np.uint32)
    cids = rng.integers(0, up, (b, nc)).astype(np.int32)
    fid_rows = rng.permutation(up * 128).astype(np.int32).reshape(up, 128)
    return words, fid_rows, cids


def _port_tail(words, fid_rows, cids, budget):
    out = TP.fused_compact_decode(torch.from_numpy(words.view(np.int32)),
                                  torch.from_numpy(fid_rows),
                                  torch.from_numpy(cids), budget)
    return out.numpy()


@pytest.mark.parametrize("seed,budget", [(0, 4096), (1, 4096), (2, 64), (3, 1)])
def test_fused_compact_decode_equals_jax(seed, budget):
    words, fid_rows, cids = _words_case(seed)
    want = np.asarray(jax.jit(JP.fused_compact_decode_impl, static_argnums=3)(
        words, fid_rows, cids, budget))
    got = _port_tail(words, fid_rows, cids, budget)
    b = words.shape[0]
    assert got.dtype == np.int32 and got.shape == want.shape == (budget + b,)
    cn = want[budget:]
    assert np.array_equal(got[budget:], cn)
    n = int(cn.sum())
    assert n > 0
    assert (n > budget) == (budget < 4096), "overflow signal as designed"
    assert np.array_equal(got[:min(n, budget)], want[:min(n, budget)])
    assert np.array_equal(got, want)  # unfilled slots agree too


def test_popcount_and_sentinel_sort():
    """The SWAR popcount matches numpy's; a -1 fid (cleared row) sorts in
    the signed order, as JAX's two-key sort does."""
    rng = np.random.default_rng(7)
    w = rng.integers(0, 1 << 32, 1000, dtype=np.uint64).astype(np.uint32)
    w[:4] = [0, 0xFFFFFFFF, 0x80000000, 1]
    want = np.unpackbits(w.view(np.uint8)).reshape(-1, 32).sum(1)
    got = TP._popcount32(torch.from_numpy(w.view(np.int32))).numpy()
    assert np.array_equal(got, want)
    words = np.zeros((2, 4), np.uint32)
    words[0, 0] = 0b111  # rows 0..2 of chunk cids[0, 0]
    fid_rows = np.array([[5, -1, 3] + [0] * 125], np.int32)
    cids = np.zeros((2, 1), np.int32)
    want = np.asarray(jax.jit(JP.fused_compact_decode_impl, static_argnums=3)(
        words, fid_rows, cids, 8))
    got = _port_tail(words, fid_rows, cids, 8)
    assert np.array_equal(got, want) and list(got[:3]) == [-1, 3, 5]


def _table(seed, n=500):
    rng = random.Random(seed)
    jt = JP.PartitionedTable()
    jt._nenc = False
    tt = TP.PartitionedTable()
    seen = set()
    while len(seen) < n:
        depth = rng.randint(1, 5)
        levels = [rng.choice(["a", "b", "c", "d", "+"]) for _ in range(depth)]
        if rng.random() < 0.3:
            levels[-1] = "#"
        f = "/".join(levels)
        if f not in seen:
            seen.add(f)
            assert jt.add(f) == tt.add(f)
    topics = ["/".join(rng.choice("abcx") for _ in range(rng.randint(1, 6)))
              for _ in range(30)] + ["$s/a"]
    return jt, tt, topics


@pytest.mark.parametrize("packed", [True, False])
def test_match_fused_family_equals_jax(packed):
    """``match_fused`` / ``_grouped`` / ``_split`` against the JAX jitted
    compositions over the same packed or legacy table."""
    jt, tt, topics = _table(3)
    b = 32
    enc = jt.encode_topics(topics, pad_batch_to=b, with_groups=True)
    ttok, tlen, tdollar, cids, _nc, groups = enc
    lay = jt.packed_layout() if packed else None
    if packed:
        tiles = JP.pack_device_rows_packed(jt, lay)
        _, tt_tok = jt.translate_packed(ttok)
    else:
        tiles, tt_tok = JP.pack_device_rows(jt), ttok
    fid_rows = JP.pack_fid_rows(jt)
    budget = 256
    t32 = lambda a: torch.from_numpy(np.asarray(a).astype(np.int32))  # noqa: E731
    tiles_t = torch.from_numpy(tiles)
    fids_t = torch.from_numpy(fid_rows)
    ins = (t32(tt_tok), t32(tlen), t32(tdollar))

    want = np.asarray(JP._match_fused(tiles, fid_rows, tt_tok, tlen, tdollar, cids,
                                      budget=budget, layout=lay))
    got = TP.match_fused(tiles_t, fids_t, *ins, t32(cids), budget, lay)
    assert np.array_equal(got.wire.numpy(), want) and want[budget:].any()

    uq, first, inv = np.unique(groups, return_index=True, return_inverse=True)
    uniq = cids[first]
    want = np.asarray(JP._match_fused_grouped(
        tiles, fid_rows, tt_tok, tlen, tdollar, uniq, inv.astype(np.int32),
        budget=budget, layout=lay))
    got = TP.match_fused_grouped(tiles_t, fids_t, *ins, t32(uniq),
                                 torch.from_numpy(inv.astype(np.int64)), budget, lay)
    assert np.array_equal(got.wire.numpy(), want)

    halves = [(tt_tok[:16], tlen[:16], tdollar[:16], cids[:16, :8]),
              (tt_tok[16:], tlen[16:], tdollar[16:], cids[16:])]
    want = np.asarray(JP._match_fused_split(tiles, fid_rows, tuple(halves),
                                            (128, 512), layout=lay))
    wire, outs = TP.match_fused_split(
        tiles_t, fids_t, [tuple(t32(a) for a in h) for h in halves], (128, 512), lay)
    assert np.array_equal(wire.numpy(), want) and len(outs) == 2


def test_matcher_budget_regrow_reruns_only_the_tail():
    """Overflowing the slot budget regrows it (sticky) and re-decodes the
    submit-time words; the results stay exact."""
    jt, tt, topics = _table(4)
    m = TP.PartitionedMatcher(tt, device="cpu")
    want = m.match(topics)
    for k in list(m._budgets):
        m._budgets[k] = 1
    got = m.match(topics)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert all(g > 1 for g in m._budgets.values())
    levels_of = {fid: jt._filter_of_fid(fid) for fid in range(500)}
    for topic, row in zip(topics, got):
        assert row.tolist() == sorted(fid for fid, lv in levels_of.items()
                                      if match_filter(lv, topic)), topic
