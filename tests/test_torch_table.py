"""Host table parity: the port's ``PartitionedTable`` and packers against the
JAX package's, over random add/remove/compact sequences.

Every device array the port uploads comes from these packers, so they must
be byte-identical: packed tiles, legacy tiles, fid rows, dirty-chunk delta
payloads, topic encodes and the level-local translation."""

import random

import numpy as np
import pytest

import rmqtt_tpu.ops.partitioned as JP
import rmqtt_tpu_torch.ops.partitioned as TP
from rmqtt_tpu.core.topic import filter_valid


def _level(rng, depth, wide):
    r = rng.random()
    if r < 0.15:
        return "+"
    if r < 0.18:
        return ""
    # level 1 draws from 300 tokens: its packed width grows to 2 bytes
    return f"w{depth}_{rng.randrange(300 if depth == 1 and wide else 12)}"


def _random_filter(rng, wide=True):
    while True:
        depth = rng.randint(1, 6)
        levels = [_level(rng, d, wide) for d in range(depth)]
        if rng.random() < 0.3:
            levels[-1] = "#"
        if rng.random() < 0.05:
            levels[0] = "$sys"
        f = "/".join(levels)
        if filter_valid(f):
            return f


def _random_topics(rng, n):
    out = []
    for _ in range(n):
        depth = rng.randint(1, 9)  # deeper than max_levels too
        out.append("/".join(f"w{d}_{rng.randrange(300 if d == 1 else 14)}"
                            for d in range(depth)))
    return out + ["$sys/w1_3", "$sys", "", "/w1_2", "w0_1/", "unknown/level"]


def _assert_tables_equal(jt, tt, topics):
    assert (tt.nchunks, tt.max_levels, tt.version, tt.layout_epoch, tt.size) == \
        (jt.nchunks, jt.max_levels, jt.version, jt.layout_epoch, jt.size)
    assert np.array_equal(TP.pack_device_rows(tt), JP.pack_device_rows(jt))
    assert np.array_equal(TP.pack_fid_rows(tt), JP.pack_fid_rows(jt))
    lay = tt.packed_layout()
    assert lay == jt.packed_layout()
    if lay is not None:
        assert np.array_equal(TP.pack_device_rows_packed(tt, lay),
                              JP.pack_device_rows_packed(jt, lay))
    for pad in (None, len(topics) + 5):
        got = tt.encode_topics(topics, pad_batch_to=pad, with_groups=True)
        want = jt.encode_topics(topics, pad_batch_to=pad, with_groups=True)
        assert got[4] == want[4]
        for g, w in zip(got[:4] + got[5:], want[:4] + want[5:]):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        gl, gtok = tt.translate_packed(got[0])
        wl, wtok = jt.translate_packed(want[0])
        assert gl == wl
        if gl is not None:
            assert np.array_equal(gtok, wtok)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_table_parity_random_ops(seed):
    rng = random.Random(seed)
    # the Python encoders against each other (their group ids agree value
    # for value); tests/test_torch_encode_native.py holds the native ones
    jt = JP.PartitionedTable()
    jt._nenc = False
    tt = TP.PartitionedTable()
    tt._nenc = False
    live = {}
    topics = _random_topics(rng, 120)
    for step in range(1500):
        r = rng.random()
        if r < 0.62 or not live:
            f = _random_filter(rng)
            if f in live.values():
                continue
            fid = tt.add(f)
            assert jt.add(f) == fid
            live[fid] = f
        elif r < 0.995:
            fid = rng.choice(list(live))
            tt.remove(fid)
            jt.remove(fid)
            del live[fid]
        else:
            tt.compact()
            jt.compact()
        if step % 500 == 499:
            _assert_tables_equal(jt, tt, topics)
    # delta payloads and the gate over the journal since a mid-run version
    v = tt.version
    for fid in list(live)[:40]:
        tt.remove(fid)
        jt.remove(fid)
    for _ in range(40):
        f = _random_filter(rng)
        if f not in live.values():
            assert tt.add(f) == jt.add(f)
    cids = tt.delta.since(v)
    assert cids == jt.delta.since(v) and cids
    lay = tt.packed_layout()
    assert np.array_equal(TP.pack_chunk_tiles_packed(tt, cids, lay),
                          JP.pack_chunk_tiles_packed(jt, cids, lay))
    assert np.array_equal(TP.pack_chunk_tiles(tt, cids, np.int16),
                          JP.pack_chunk_tiles(jt, cids, np.int16))
    assert np.array_equal(TP.pack_fid_chunk_tiles(tt, cids),
                          JP.pack_fid_chunk_tiles(jt, cids))
    kw = dict(enabled=True, dev_version=v, has_resident=True,
              dev_epoch=tt.layout_epoch, dev_lvl=tt.max_levels,
              dev_dtype=np.int32, dt=np.int32, dev_up_chunks=1 << 20,
              dev_layout=lay, layout=lay)
    assert TP.delta_chunk_plan(tt, **kw) == JP.delta_chunk_plan(jt, **kw)
    _assert_tables_equal(jt, tt, topics)
    # the fid overlay (undo journal) agrees too
    assert tt.fid_overlay(v, tt.layout_epoch) == jt.fid_overlay(v, jt.layout_epoch)


def test_table_parity_unpackable_and_wide_tokens():
    """Deep filters (> 30 levels) make the table unpackable; a vocabulary
    past 0x7FFF widens legacy tiles and topic tokens to int32 — both the
    same in the port."""
    jt, tt = JP.PartitionedTable(), TP.PartitionedTable()
    jt._nenc = tt._nenc = False
    deep = "/".join(["d"] * 31)
    for f in ["a/b", "a/+/c/#", deep]:
        assert tt.add(f) == jt.add(f)
    assert tt.packed_layout() is None and jt.packed_layout() is None
    for i in range(0x7FFF):
        assert tt.add(f"x/{i}") == jt.add(f"x/{i}")
    topics = ["a/b", "x/12", deep, "a/q/c/d/e"]
    _assert_tables_equal(jt, tt, topics)
    assert TP.pack_device_rows(tt).dtype == np.int32
