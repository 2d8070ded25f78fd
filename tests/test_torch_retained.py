"""Retained-scan parity: the port's ``ops/retained_part.py`` against the JAX
package's, on the same inputs made with numpy and ``random`` seeds.

The host table (tiles, row→fid map, candidate chunks) byte-equal after the
same adds, removes and compactions; the plain twins bit-equal to
``retained_scan_words_impl`` / ``retained_scan_full_impl`` on int16 and
int32 tiles; the scanner's per-filter fid arrays identical to the JAX
scanner's on the cases of ``tests/test_retained_part.py``; and a scanner
installed from the JAX package's arrays giving its results. The kernels
against these twins on a card: ``tests/test_torch_cuda.py``."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rmqtt_tpu.ops.partitioned as JP
import rmqtt_tpu.ops.retained_part as JR
import rmqtt_tpu_torch.ops.partitioned as TP
import rmqtt_tpu_torch.ops.retained_part as TR
from rmqtt_tpu.core.topic import filter_valid
from rmqtt_tpu_torch.bench.retained_cases import (RETAINED_CASES, TABLE_FILTERS,
                                                  make_retained_case, table_inputs,
                                                  table_topics)
from rmqtt_tpu_torch.bench.workloads import gen_retained_topics, retained_sub_filters


# ------------------------------------------------------------------ inputs
def _rand_topics(rng, n):
    """Distinct topics of 1-6 levels over a, b, c, '', $s, $SYS ($ only
    first), as ``tests/test_retained_part.py`` draws them."""
    words = ["a", "b", "c", "", "$s", "$SYS"]
    seen = []
    while len(seen) < n:
        levels = [rng.choice(words) for _ in range(rng.randint(1, 6))]
        levels = [lev if (i == 0 or not lev.startswith("$")) else "p"
                  for i, lev in enumerate(levels)]
        t = "/".join(levels)
        if t not in seen:
            seen.append(t)
    return seen


def _rand_filters(rng, n):
    out = []
    while len(out) < n:
        levels = [rng.choice(["a", "b", "c", "", "+", "$s", "$SYS"])
                  for _ in range(rng.randint(1, 6))]
        if rng.random() < 0.4:
            levels[-1] = "#"
        f = "/".join(levels)
        if filter_valid(f):
            out.append(f)
    return out


def _scanner(mod, table):
    return (mod.PartitionedRetainedScanner(table) if mod is JR
            else TR.PartitionedRetainedScanner(table, device="cpu"))


def _same(got_t, got_j):
    assert len(got_t) == len(got_j)
    for a, b in zip(got_t, got_j):
        assert np.array_equal(np.asarray(a), np.asarray(b)), (a[:8], b[:8])


# -------------------------------------------------------------- host table
def _assert_tables_equal(jt, tt, filters):
    assert (tt.nchunks, tt.max_levels, tt.version, tt.layout_epoch, tt.size) == \
        (jt.nchunks, jt.max_levels, jt.version, jt.layout_epoch, jt.size)
    assert tt._tok_dtype() == jt._tok_dtype()
    assert np.array_equal(TP.pack_device_rows(tt), JP.pack_device_rows(jt))
    assert np.array_equal(tt._fid_of_row, jt._fid_of_row)
    assert np.array_equal(tt.fid_snapshot(), jt.fid_snapshot())
    for f in filters:
        assert np.array_equal(tt.candidates_for_filter(f), jt.candidates_for_filter(f)), f


@pytest.mark.parametrize("steps", ["adds", "adds+removes", "adds+removes+compact+adds"])
def test_table_byte_equal(steps):
    rng = random.Random(11)
    topics = _rand_topics(rng, 700)
    filters = _rand_filters(rng, 40) + ["#", "+/#", "$SYS/#", "a/+/#"]
    jt, tt = JR.RetainedTable(), TR.RetainedTable()
    fids = [(jt.add(t), tt.add(t)) for t in topics]
    assert all(a == b for a, b in fids)
    if "removes" in steps:
        for fid in rng.sample([a for a, _ in fids], 250):
            jt.remove(fid)
            tt.remove(fid)
    if "compact" in steps:
        jt.compact()
        tt.compact()
        # $-rows re-added after the compaction keep their flag
        for t in ["$SYS/late", "late/x/y", "$s/late"]:
            assert jt.add(t) == tt.add(t)
    _assert_tables_equal(jt, tt, filters)


def test_filter_masks_and_wildcard_topics():
    rng = random.Random(3)
    for f in _rand_filters(rng, 200) + ["#", "+", "a/+/c/#", "+/+"]:
        levels = f.split("/")
        assert TR.filter_masks(levels) == JR.filter_masks(levels), f
    assert ("4", "a", None, "c") in TR.filter_masks(["a", "+", "c", "#"])
    assert TR.filter_masks(["+", "+"]) == [("2E", None, None)]
    for bad in ("a/+/b", "a/#", "#"):
        with pytest.raises(ValueError):
            TR.RetainedTable().add(bad)
        with pytest.raises(ValueError):
            JR.RetainedTable().add(bad)


# --------------------------------------------------------------- the twins
def _table_case(kind):
    """(tiles, gather arrays, full arrays) of a table built from real topics
    (``retained_cases.table_inputs``), on the CPU."""
    rng = np.random.default_rng(1)
    table = TR.RetainedTable()
    for t in table_topics(kind, rng):
        table.add(t)
    return table_inputs(TR.PartitionedRetainedScanner(table, device="cpu"),
                        TABLE_FILTERS)


def _jax_words(tier, tiles, fields, ids):
    j = [jnp.asarray(a) for a in (tiles, *fields)]
    j[4] = j[4].astype(bool)  # fhash
    j[5] = j[5].astype(bool)  # fwild
    if tier == "gather":
        return np.asarray(JR.retained_scan_words_impl(*j, jnp.asarray(ids)))
    return np.asarray(JR.retained_scan_full_impl(*j, slab=min(512, tiles.shape[0])))


def _twin_words(tier, tiles, fields, ids):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (tiles, *fields)]
    if tier == "gather":
        w = TR.retained_scan_words_plain(*t, torch.from_numpy(ids))
    else:
        w = TR.retained_scan_full_plain(*t)
    return w.numpy().view(np.uint32)


#: each tier on int16 and int32 tiles, edge candidate ids, and a table of
#: real topics; the level ranges of the kernels' instances are the card
#: tests' (the twins have none), int32 tables of real topics the scanner's
#: wide_vocab case
_TWIN_CASES = [RETAINED_CASES[i] for i in (0, 2, 7, 8)] + ["table dollar"]


@pytest.mark.parametrize("case", _TWIN_CASES,
                         ids=[c if isinstance(c, str) else c.name for c in _TWIN_CASES])
def test_twins_bit_equal_to_jax(case):
    if isinstance(case, str):
        tiles, gather, full = _table_case(case.split()[1])
        runs = [("gather", tiles, gather[:5], gather[5]), ("full", tiles, full, None)]
    else:
        tiles, fields, ids, _bad, _pids = make_retained_case(case)
        runs = [(case.tier, tiles, fields, ids)]
    for tier, tl, fields, ids in runs:
        want = _jax_words(tier, tl, fields, ids)
        got = _twin_words(tier, tl, fields, ids)
        assert got.dtype == want.dtype == np.uint32 and got.shape == want.shape
        assert np.array_equal(got, want), tier
        assert want.any()


def test_wrappers_on_cpu_run_the_twins_and_never_fall_back():
    tiles, fields, ids, _bad, _pids = make_retained_case(RETAINED_CASES[2])
    t = [torch.from_numpy(a) for a in (tiles, *fields)]
    n0 = TR.retained_scan_gather.launches + TR.retained_scan_full.launches
    out = torch.empty((ids.shape[0], ids.shape[1] * 4), dtype=torch.int32)
    got = TR.retained_scan_gather(*t, torch.from_numpy(ids), out=out)
    assert got is out and torch.equal(out, TR.retained_scan_words_plain(
        *t, torch.from_numpy(ids)))
    assert torch.equal(TR.retained_scan_full(*t), TR.retained_scan_full_plain(*t))
    meta = torch.empty(tiles.shape, dtype=torch.int16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TR.retained_scan_full(meta, *t[1:])
    assert TR.retained_scan_gather.launches + TR.retained_scan_full.launches == n0


@pytest.mark.parametrize("tier", ["gather", "full"])
def test_cuda_checks_refuse_unaligned_tiles(tier):
    """The kernels read tile rows in 16-byte loads: the CUDA path's checks
    refuse tiles that start off a 16-byte boundary and take those on it."""
    tiles, fields, ids, _bad, _pids = make_retained_case(RETAINED_CASES[2])
    t = [torch.from_numpy(a) for a in fields]
    ids_t = torch.from_numpy(ids) if tier == "gather" else None
    flat = torch.zeros(tiles.size + 8, dtype=torch.int32)
    for off in (0, 1, 2, 3, 4):  # int32 elements: 0 and 16 bytes are aligned
        view = flat[off:off + tiles.size].view(tiles.shape)
        if view.data_ptr() % 16:
            with pytest.raises(ValueError, match="16-byte"):
                TR._check_cuda(f"retained_scan_{tier}", view, t, ids_t)
        else:
            TR._check_cuda(f"retained_scan_{tier}", view, t, ids_t)


@pytest.mark.parametrize("dtype", [np.int16, np.int32])
def test_retained_work_counts_a_word_test_per_32_bits(dtype):
    """The bound's operation count: a test per live 32-bit word of rows,
    two int16 rows a word (one operation tests both halves), one int32 row;
    the gather counts only the slots of real tiles, not chunk 0."""
    from rmqtt_tpu_torch.bench.roofline_model import retained_work
    lvl = 2
    tiles = np.zeros((2, lvl + 3, 128), dtype=dtype)
    tiles[1, lvl, [0, 1, 2, 9]] = 3  # live rows: words (0, 1), (2, 3), (8, 9)
    tiles[1, lvl, 4] = -1  # padding
    ftok = np.array([[5, TR.PLUS_TOK]], dtype=np.int32)  # one literal level
    fields = [torch.from_numpy(a) for a in
              (ftok, np.array([2]), np.array([2]), np.array([0]), np.array([0]))]
    fields = [f.to(torch.int32) for f in fields]
    per_test = 6 + 2 * 1
    words = 3 if dtype == np.int16 else 4
    _, ops_full = retained_work(torch.from_numpy(tiles), fields)
    assert ops_full == words * per_test
    ids = torch.tensor([[1, 0, 0]], dtype=torch.int32)
    _, ops_gather = retained_work(torch.from_numpy(tiles), fields, ids)
    assert ops_gather == words * per_test


# ------------------------------------------------------------- the scanner
def _differential(mod, rng):
    table = mod.RetainedTable()
    for t in _rand_topics(rng, 1500):
        table.add(t)
    return [_scanner(mod, table).scan(_rand_filters(rng, 150))]


def _tier_split(mod, rng):
    table = mod.RetainedTable()
    for i in range(8000):
        table.add(f"d{i % 40}/m{i % 211}/s{i}")
    scanner = _scanner(mod, table)
    got = scanner.scan(["#", "d1/m1/+", "d2/+/#", "+/#", "d3/m3/s3", "$SYS/#"])
    broad_floor = max(16, int(table.nchunks * scanner.BROAD_FRAC))
    assert len(table.candidates_for_filter("#")) > broad_floor
    assert len(table.candidates_for_filter("d1/m1/+")) <= broad_floor
    return [got]


def _pipelined(mod, rng):
    table = mod.RetainedTable()
    for t in _rand_topics(rng, 800):
        table.add(t)
    scanner = _scanner(mod, table)
    batches = [_rand_filters(rng, 24) for _ in range(4)]
    handles = [scanner.scan_submit(b) for b in batches]
    return [scanner.scan_complete(h) for h in handles]


def _survives_mutation(mod, rng):
    table = mod.RetainedTable()
    fids = [table.add(t) for t in _rand_topics(rng, 400)]
    scanner = _scanner(mod, table)
    h = scanner.scan_submit(_rand_filters(rng, 16) + ["#"])
    for fid in rng.sample(fids, len(fids) // 2):
        table.remove(fid)
    table.compact()
    out = [scanner.scan_complete(h)]
    s1 = table.fid_snapshot()
    assert table.fid_snapshot() is s1
    table.add("fresh/topic/a")
    assert table.fid_snapshot() is not s1
    return out + [scanner.scan(["#", "fresh/#"])]


def _churn_compact(mod, rng):
    table = mod.RetainedTable()
    fids = [table.add(t) for t in _rand_topics(rng, 600)]
    scanner = _scanner(mod, table)
    out = [scanner.scan(["a/+"])]
    for fid in rng.sample(fids, len(fids) // 3):
        table.remove(fid)
    for i in range(200):
        table.add(f"x{i % 7}/y{i % 13}/z{i}")
    table.compact()
    return out + [scanner.scan(_rand_filters(rng, 60) + ["x1/+/#", "x1/y1/+", "#"])]


def _dollar(mod, rng):
    table = mod.RetainedTable()
    for t in ["$SYS/x", "$SYS/x/y", "a/x", "x"]:
        table.add(t)
    return [_scanner(mod, table).scan(["#", "+/x", "$SYS/#", "+/#"])]


def _deep(mod, rng):
    table = mod.RetainedTable()
    for t in ["a/b/c/d/e/f/g/h", "a/b", "a/b/c/d/e/f/g/h/i/j"]:
        table.add(t)
    return [_scanner(mod, table).scan(["a/b/c/d/e/f/g/h/i/j/k/l", "a/b/c/d/e/f/g/h/#",
                                       "a/+/c/d/e/f/g/+/i/j", "a/#"])]


def _wide_vocab(mod, rng):
    table = mod.RetainedTable()
    scanner = _scanner(mod, table)
    n = 0x7FFF - 4 + 40
    for i in range(n):
        table.add(f"w{i}/x")
    got = scanner.scan(["w10/x", f"w{n - 1}/x", f"w{n - 1}/+"])
    assert table._tok_wide and [len(g) for g in got] == [1, 1, 1]
    return [got]


def _empty(mod, rng):
    table = mod.RetainedTable()
    table.add("a/b")
    scanner = _scanner(mod, table)
    assert scanner.scan([]) == []
    return [scanner.scan(["zzz/none"]), scanner.scan(["a/b", "zzz/none"])]


def _cfg5_mix(mod, rng):
    """cfg5's retained draw and ``run_retained``'s subscriber mix, cut to
    8K draws: both tiers and the in-batch dedup at once."""
    table = mod.RetainedTable()
    for t in gen_retained_topics(random.Random(7), 8_000):
        table.add(t)
    filters = retained_sub_filters(random.Random(5), 64)
    return [_scanner(mod, table).scan(filters + filters[:8])]


_SCENARIOS = {f.__name__.lstrip("_"): f for f in (
    _differential, _tier_split, _pipelined, _survives_mutation, _churn_compact,
    _dollar, _deep, _wide_vocab, _empty, _cfg5_mix)}


@pytest.mark.parametrize("name", sorted(_SCENARIOS))
def test_scanner_equals_jax(name):
    """Per-filter fid arrays identical to the JAX scanner's, scenario by
    scenario (both driven by the same seeds)."""
    scenario = _SCENARIOS[name]
    want = scenario(JR, random.Random(29))
    got = scenario(TR, random.Random(29))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g, w)
    assert any(len(a) for batch in want for a in batch)


def test_scanner_installed_from_jax_arrays():
    """``retained_state_from_numpy`` installs the JAX package's
    ``pack_device_rows`` array and row→fid map: no upload of its own, the
    JAX scanner's results."""
    rng = random.Random(41)
    topics = _rand_topics(rng, 900)
    jt, tt = JR.RetainedTable(), TR.RetainedTable()
    for t in topics:
        jt.add(t)
        tt.add(t)
    jt.compact()
    tt.compact()
    jt._tok_dtype()
    filters = _rand_filters(rng, 48) + ["#", "+/#"]
    want = JR.PartitionedRetainedScanner(jt).scan(filters)
    scanner = TR.PartitionedRetainedScanner(tt, device="cpu")
    scanner.install(TR.retained_state_from_numpy(
        JP.pack_device_rows(jt), jt.fid_snapshot(), tt.version, device="cpu"))
    _same(scanner.scan(filters), want)
    assert scanner.uploads == 0


def test_scanner_needs_cuda_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.PartitionedRetainedScanner(TR.RetainedTable())
    assert TR.PartitionedRetainedScanner(TR.RetainedTable(),
                                         device="cpu").device.type == "cpu"
