"""Match-words parity: the port's plain twins against the JAX package's lax
scans and its Pallas kernels (interpret mode), bit for bit. The CUDA
kernels against these twins on a card: ``tests/test_torch_cuda.py``."""

import functools
import random

import jax
import numpy as np
import pytest
import torch

import rmqtt_tpu.ops.partitioned as JP
import rmqtt_tpu_torch.ops.match_words as MW
from rmqtt_tpu.ops.pallas_match import match_words_pallas, match_words_pallas_packed
from rmqtt_tpu_torch.bench.words_cases import edge_chunk_ids
from rmqtt_tpu_torch.ops.encode import PackedLayout

FORMATS = ["packed", "legacy_int16", "legacy_int32"]


def _table(seed, n=700):
    rng = random.Random(seed)
    t = JP.PartitionedTable()
    t._nenc = False
    seen = set()
    while len(seen) < n:
        depth = rng.randint(1, 6)
        levels = [f"v{d}_{rng.randrange(600 if d == 2 else 6)}" for d in range(depth)]
        r = rng.random()
        if r < 0.35:
            levels[rng.randrange(depth)] = "+"
        if 0.25 <= r < 0.55:
            levels[-1] = "#"
        if rng.random() < 0.05:
            levels[0] = "$sys"
        f = "/".join(levels)
        if f not in seen:
            seen.add(f)
            t.add(f)
    topics = ["/".join(f"v{d}_{rng.randrange(600 if d == 2 else 7)}"
                       for d in range(rng.randint(1, 8))) for _ in range(37)]
    return t, topics + ["$sys/v1_1/v2_3", "$sys"]


def _inputs(fmt, seed=0):
    """(tiles, ttok, tlen, tdollar, chunk_ids, layout) as numpy, B = 40."""
    t, topics = _table(seed)
    ttok, tlen, tdollar, cids, _nc = t.encode_topics(topics, pad_batch_to=40)
    if fmt == "packed":
        lay = t.packed_layout()
        assert lay is not None and 2 in lay.widths  # a 2-byte level
        _, tt = t.translate_packed(ttok)
        return JP.pack_device_rows_packed(t, lay), tt, tlen, tdollar, cids, lay
    tiles = JP.pack_device_rows(t)
    if fmt == "legacy_int32":
        tiles = tiles.astype(np.int32)
    assert tiles.dtype == (np.int32 if fmt == "legacy_int32" else np.int16)
    return tiles, ttok, tlen, tdollar, cids, None


def _port_plain(tiles, ttok, tlen, tdollar, cids, lay):
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (tiles, ttok)]
    args += [torch.from_numpy(tlen.astype(np.int32)),
             torch.from_numpy(tdollar.astype(np.int32)),
             torch.from_numpy(cids.astype(np.int32))]
    if lay is not None:
        out = MW.match_words_packed(*args, layout=PackedLayout(lay.widths))
    else:
        out = MW.match_words_legacy(*args)
    return out.numpy().view(np.uint32)


@pytest.mark.parametrize("fmt", FORMATS)
def test_plain_equals_jax_scan(fmt):
    tiles, ttok, tlen, tdollar, cids, lay = _inputs(fmt)
    if lay is not None:
        want = jax.jit(functools.partial(JP.scan_words_packed_impl, layout=lay))(
            tiles, ttok, tlen, tdollar, cids)
    else:
        want = jax.jit(JP.scan_words_impl)(tiles, ttok, tlen, tdollar, cids)
    want = np.asarray(want)
    got = _port_plain(tiles, ttok, tlen, tdollar, cids, lay)
    assert got.shape == want.shape and np.array_equal(got, want)
    assert want.any(), "vacuous: no row matched"


@pytest.mark.parametrize("fmt", FORMATS)
def test_plain_equals_pallas_interpret(fmt):
    tiles, ttok, tlen, tdollar, cids, lay = _inputs(fmt, seed=1)
    cids = cids[:, :8]  # short candidate lists keep interpret mode quick
    if lay is not None:
        want = match_words_pallas_packed(tiles, ttok, tlen, tdollar, cids,
                                         layout=lay, interpret=True)
    else:
        want = match_words_pallas(tiles, ttok, tlen, tdollar, cids,
                                  interpret=True)
    want = np.asarray(want)
    got = _port_plain(tiles, ttok, tlen, tdollar, cids, lay)
    assert np.array_equal(got, want)


def test_plain_random_tiles_equal_jax():
    """Arbitrary tile bytes (not only packer output): random planes incl. a
    2-byte level, random topics incl. padded (-2) and $ topics, chunk 0."""
    rng = np.random.default_rng(5)
    lay = PackedLayout((1, 2, 1, 1))
    n, b, nc = 24, 16, 5
    planes = rng.integers(0, 6, (n * 128, lay.planes)).astype(np.uint8)
    planes[:, 2] = rng.integers(0, 2, n * 128)  # level 1's high byte
    planes[:, -1] = (rng.integers(0, 7, n * 128) | (rng.integers(0, 2, n * 128) << 5)
                     | (rng.integers(0, 2, n * 128) << 6))
    from rmqtt_tpu_torch.ops.encode import group_byte_planes

    tiles = np.ascontiguousarray(group_byte_planes(planes, lay.groups)
                                 .reshape(n, 128, lay.groups).transpose(0, 2, 1)
                                 .reshape(n, lay.groups * 128))
    ttok = rng.integers(0, 6, (b, lay.nlvl)).astype(np.int32)
    tlen = rng.integers(1, 6, b).astype(np.int16)
    tlen[::5] = -2
    tdollar = rng.random(b) < 0.4
    cids = rng.integers(0, n, (b, nc)).astype(np.int32)
    want = np.asarray(jax.jit(functools.partial(
        JP.scan_words_packed_impl, layout=lay))(tiles, ttok, tlen, tdollar, cids))
    got = _port_plain(tiles, ttok, tlen, tdollar, cids, lay)
    assert np.array_equal(got, want) and want.any()


@pytest.mark.parametrize("fmt", FORMATS)
def test_plain_equals_jax_scan_edge_ids(fmt):
    """The candidate lists the CUDA kernels treat apart: NC = 64 (two warps
    per topic), chunk 0 at the front, mid-row and repeated, a nonzero id
    repeated in one row."""
    tiles, ttok, tlen, tdollar, _cids, lay = _inputs(fmt, seed=2)
    cids = edge_chunk_ids(np.random.default_rng(7), len(ttok), 64, len(tiles))
    assert (cids[:, 32] == 0).any() and (cids[:, 0] == 0).any()
    if lay is not None:
        want = jax.jit(functools.partial(JP.scan_words_packed_impl, layout=lay))(
            tiles, ttok, tlen, tdollar, cids)
    else:
        want = jax.jit(JP.scan_words_impl)(tiles, ttok, tlen, tdollar, cids)
    want = np.asarray(want)
    got = _port_plain(tiles, ttok, tlen, tdollar, cids, lay)
    assert got.shape == want.shape == (40, 256) and np.array_equal(got, want)
    assert want.any(), "vacuous: no row matched"


def test_cpu_tensors_do_not_count_launches():
    before = (MW.match_words_packed.launches, MW.match_words_legacy.launches)
    for fmt in FORMATS:
        _port_plain(*_inputs(fmt))
    assert (MW.match_words_packed.launches, MW.match_words_legacy.launches) == before

