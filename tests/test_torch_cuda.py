"""The CUDA kernels on a card: each against its plain twin, the router on
the card against the same router on the CPU, and the port's broker with
every batch on the card against the ``DefaultRouter`` oracle.

This file imports nothing of JAX, so it also runs where JAX is not
installed: ``python -m pytest --noconftest tests/test_torch_cuda.py -q``
on a machine with an NVIDIA GPU (``tests/conftest.py`` imports JAX).
Every test here skips where torch sees no CUDA device."""

import asyncio
import random

import numpy as np
import pytest
import torch

import rmqtt_tpu_torch.ops.match_words as MW
import rmqtt_tpu_torch.ops.partitioned as TP
from rmqtt_tpu_torch.bench.mqtt_load import (LoadClient, connect_and_subscribe,
                                             expected_deliveries, oracle_router,
                                             publish_wave)
from rmqtt_tpu_torch.bench.words_cases import EDGE_CASES, make_case
from rmqtt_tpu_torch.broker.context import BrokerConfig, ServerContext
from rmqtt_tpu_torch.broker.server import MqttBroker
from rmqtt_tpu_torch.bench.workloads import gen_mixed, gen_topics_uniform
from rmqtt_tpu_torch.router import Id, SubscriptionOptions, TorchRouter

FORMATS = ["packed", "legacy_int16", "legacy_int32"]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(fmt, dev):
    """A ~700-filter table with a 2-byte level, 40 topics (padded and $
    topics among them) → the kernel arguments on ``dev`` and the layout."""
    rng = random.Random(0)
    t = TP.PartitionedTable()
    seen = set()
    while len(seen) < 700:
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
    topics += ["$sys/v1_1/v2_3", "$sys"]
    ttok, tlen, tdollar, cids, _nc = t.encode_topics(topics, pad_batch_to=40)
    lay = t.packed_layout() if fmt == "packed" else None
    if lay is not None:
        assert 2 in lay.widths
        _, ttok = t.translate_packed(ttok)
        tiles = TP.pack_device_rows_packed(t, lay)
    else:
        tiles = TP.pack_device_rows(t)
        if fmt == "legacy_int32":
            tiles = tiles.astype(np.int32)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    args = (put(tiles), put(ttok.astype(np.int32)), put(tlen.astype(np.int32)),
            put(tdollar.astype(np.int32)), put(cids.astype(np.int32)))
    return args, lay


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
def test_kernel_equals_plain_on_cuda(cuda, fmt):
    args, lay = _inputs(fmt, cuda)
    n0 = MW.match_words_packed.launches + MW.match_words_legacy.launches
    if lay is not None:
        got = MW.match_words_packed(*args, layout=lay)
        want = MW.match_words_packed_plain(*args, layout=lay)
    else:
        got = MW.match_words_legacy(*args)
        want = MW.match_words_legacy_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and bool((want != 0).any())
    assert MW.match_words_packed.launches + MW.match_words_legacy.launches == n0 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", EDGE_CASES, ids=[c.name for c in EDGE_CASES])
def test_kernel_edge_cases_on_cuda(cuda, case):
    """NC above 32, B of 1 and 3, chunk 0 at the front / in the middle /
    repeated, a repeated nonzero id, every packed group count and legacy L
    range: equal to the twin. Out-of-range ids give zero words."""
    tiles, ttok, tlen, tdollar, ids, lay, bad, plain_ids = make_case(case)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    args = [put(a) for a in (tiles, ttok, tlen, tdollar)]
    if lay is not None:
        got = MW.match_words_packed(*args, put(ids), layout=lay)
        want = MW.match_words_packed_plain(*args, put(plain_ids), layout=lay)
    else:
        got = MW.match_words_legacy(*args, put(ids))
        want = MW.match_words_legacy_plain(*args, put(plain_ids))
    if bad is not None:
        badw = put(np.repeat(bad, MW.WORDS_PER_CHUNK, axis=1))
        assert not bool(got[badw].any())
        want = torch.where(badw, torch.zeros_like(want), want)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and bool((want != 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False])
def test_router_on_cuda_equals_cpu(cuda, packed, monkeypatch):
    """The same ~2K filters and topics through ``TorchRouter`` on the card
    (kernels) and on the CPU (plain twins), a batch big enough for the NC
    split, before and after churn (a delta upload on the card)."""
    monkeypatch.setenv("RMQTT_PACKED", "1" if packed else "0")
    routers = [TorchRouter(device=cuda), TorchRouter(device="cpu")]
    rng = random.Random(1)
    filters = gen_mixed(rng, 2000)
    opts = SubscriptionOptions()
    for r in routers:
        for i, f in enumerate(filters):
            r.add(f, Id(1, f"c{i}"), opts)
        r.table.compact()  # the churn below stays under the compaction trigger
    topics = gen_topics_uniform(rng, 1100)
    counter = MW.match_words_packed if packed else MW.match_words_legacy
    n0 = counter.launches
    got, want = (r.matcher.match(topics) for r in routers)
    assert counter.launches > n0
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert sum(len(w) for w in want) > 1000
    for r in routers:
        for i, f in enumerate(filters[:300]):
            r.remove(f, Id(1, f"c{i}"))
        for j, f in enumerate(gen_mixed(random.Random(2), 300)):
            r.add(f, Id(1, f"n{j}"), opts)
    got, want = (r.matcher.match(topics) for r in routers)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    m = routers[0].matcher
    assert (m.full_uploads, m.delta_uploads) == (1, 1)


@pytest.mark.cuda
def test_broker_on_cuda_equals_default_router(cuda, monkeypatch):
    """An in-process broker on ``TorchRouter`` on the card with the hybrid
    off (every batch on the device): 2K filters over 8 subscribers, 1K QoS 0
    publishes from 4 publishers, deliveries equal to the oracle's."""
    monkeypatch.setenv("RMQTT_HYBRID_MAX", "0")
    rng = random.Random(3)
    filters = gen_mixed(rng, 2000)
    subs = {f"s{k}": filters[k::8] for k in range(8)}
    topics = gen_topics_uniform(rng, 1000)
    payloads = [b"p%d" % i for i in range(len(topics))]
    want = expected_deliveries(oracle_router(subs), topics, payloads)
    assert sum(want.values()) > 1000

    async def run():
        router = TorchRouter(device=cuda)
        broker = MqttBroker(ServerContext(BrokerConfig(port=0), router=router))
        await broker.start()
        try:
            subscribers = await connect_and_subscribe(broker.port, subs)
            pubs = [await LoadClient.connect(broker.port, f"p{k}") for k in range(4)]
            n0, f0 = MW.match_words_packed.launches, router.matcher.fused_batches
            got, _secs = await publish_wave(pubs, subscribers, topics, payloads,
                                            want, timeout=60.0)
            launched = MW.match_words_packed.launches - n0
            fused = router.matcher.fused_batches - f0
            st = broker.ctx.routing.stats()
            for c in [*subscribers, *pubs]:
                await c.close()
            return got, launched, fused, st
        finally:
            await broker.stop()

    got, launched, fused, st = asyncio.run(asyncio.wait_for(run(), timeout=120.0))
    assert got == want
    assert launched > 0 and fused > 0
    assert st["routing_failover_state"] == 0 and st["routing_failovers"] == 0


@pytest.mark.cuda
def test_kernel_build_failure_refuses_the_start(cuda, tmp_path, monkeypatch):
    """A words kernel source that does not build refuses the router and the
    broker's ``--router xla`` context at construction, before any publish."""
    import rmqtt_tpu_torch.ops._build as B

    bad = tmp_path / "match_words.cu"
    bad.write_text("this is not CUDA\n")
    monkeypatch.setattr(B, "SOURCE", bad)
    monkeypatch.setattr(B, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(B, "_LOADED", None)
    with pytest.raises(B.KernelError, match="nvcc failed"):
        TorchRouter(device=cuda)
    with pytest.raises(B.KernelError, match="nvcc failed"):
        ServerContext(BrokerConfig(router="xla"))
