"""The compaction tails on the CPU: the port's ``fused_compact_decode`` and
``compact_global`` wrappers, given CPU tensors, run their plain twins
(their launch counters do not move) and equal the JAX package's
``fused_compact_decode_impl`` / ``compact_global_impl`` under ``jax.jit``
bit for bit over the whole ``[budget + B]`` wire, on
``bench/tail_cases.py``'s ``TAIL_CASES``: a topic matching every row at
NC=64, a budget cut inside a topic, ``-1`` fids, B=1 with a budget of 256,
the 32-bit ``compact_global`` wire at ``W*32 >= 65536``, an overflow, an
NC that is no power of two, no routes, no topics, 64 topics at the
broker's budget (the kernels' one-block path at its widest) and one topic
of exactly 33 routes (past the register sort). The kernels themselves run
in ``tests/test_torch_cuda.py`` on the same cases."""

import jax
import numpy as np
import pytest
import torch

import rmqtt_tpu.ops.partitioned as JP
import rmqtt_tpu_torch.ops.compact_tail as CT
import rmqtt_tpu_torch.ops.partitioned as TP
from rmqtt_tpu_torch.bench.tail_cases import (TAIL_CASES, counts_of, kept_routes,
                                              make_tail_case)

_FUSED = jax.jit(JP.fused_compact_decode_impl, static_argnums=3)
_GLOBAL = jax.jit(JP.compact_global_impl, static_argnums=1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("case", TAIL_CASES, ids=[c.name for c in TAIL_CASES])
def test_tails_equal_jax(case):
    words, fid_rows, cids, budget = make_tail_case(case)
    n0 = (CT.fused_compact_decode.launches, CT.compact_global.launches)

    want = np.asarray(_FUSED(words, fid_rows, cids, budget))
    got = TP.fused_compact_decode(_t(words), _t(fid_rows), _t(cids), budget).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape == (budget + case.b,)
    assert np.array_equal(got, want)

    want_g = np.asarray(_GLOBAL(words, budget))
    got_g = TP._unsigned(TP.compact_global(_t(words), budget).numpy())
    assert got_g.dtype == want_g.dtype == (np.uint32 if words.shape[1] * 32 >= 0x10000
                                           else np.uint16)
    assert np.array_equal(got_g, want_g)
    assert (CT.fused_compact_decode.launches, CT.compact_global.launches) == n0

    # what each case is for
    cnts = counts_of(words)
    assert np.array_equal(got[budget:], cnts)
    k = kept_routes(cnts, budget)
    n = int(cnts.sum())
    assert np.all(got[min(n, budget):budget] == 0)
    for t in case.full:
        assert cnts[t] == case.nc * 128
    for t, n_t in case.exact:
        assert cnts[t] == n_t and k[t] == n_t
    if case.budget is None:
        t = case.full[0]
        assert 0 < k[t] < cnts[t], "the budget cuts inside the full topic"
    if case.cleared:
        assert (got[:min(n, budget)] == -1).any()
