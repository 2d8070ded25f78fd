"""The host-trie hybrid and the failover seams of ``TorchRouter(device="cpu")``
against the JAX package's ``XlaRouter`` (``mesh=None``): the same ~500
filters with ``$share`` groups and No-Local, batches of 1, 8 and 2,048
topics, with the default ``RMQTT_HYBRID_MAX`` (64) and with 0. Large
batches are pinned to the device (``RMQTT_HYBRID_ADAPT=0``) on both sides,
so which backend served a batch is deterministic. Also the failover
breaker's round trip through the port's broker and ``FAILPOINTS``."""

import asyncio
import random
import time

import numpy as np
import pytest

from rmqtt_tpu.core.topic import parse_shared
from rmqtt_tpu.router.base import Id as JId
from rmqtt_tpu.router.base import SubscriptionOptions as JOpts
from rmqtt_tpu.router.xla import XlaRouter
from rmqtt_tpu_torch.bench.workloads import gen_mixed, gen_topics_uniform
from rmqtt_tpu_torch.router import Id, SubscriptionOptions, TorchRouter
from rmqtt_tpu_torch.utils.failpoints import FAILPOINTS


def _subs(seed, n):
    """(stripped filter, client, no_local, shared_group) rows."""
    rng = random.Random(seed)
    out = []
    for i, f in enumerate(gen_mixed(rng, n, shared_frac=0.1)):
        group, stripped = parse_shared(f)
        out.append((stripped, f"c{i}", rng.random() < 0.1, group))
    return out


def _norm(raw):
    """Relation expansion → plain tuples (the two packages' dataclasses are
    different classes with the same fields)."""
    out, shared = raw
    o = {nid: [(r.topic_filter, r.id.client_id, r.opts.no_local,
                r.opts.shared_group) for r in rels] for nid, rels in out.items()}
    s = {k: [(sid.client_id, opts.no_local, on) for sid, opts, on in cands]
         for k, cands in shared.items()}
    return o, s


def _sorted(norm):
    o, s = norm
    return ({k: sorted(v) for k, v in o.items()},
            {k: sorted(v) for k, v in s.items()})


@pytest.fixture(params=["64", "0"], ids=["hybrid_default", "hybrid_off"])
def routers(request, monkeypatch):
    if request.param == "0":
        monkeypatch.setenv("RMQTT_HYBRID_MAX", "0")
    else:
        monkeypatch.delenv("RMQTT_HYBRID_MAX", raising=False)
    monkeypatch.setenv("RMQTT_HYBRID_ADAPT", "0")
    jr = XlaRouter(mesh=None)
    tr = TorchRouter(device="cpu")
    for stripped, cid, no_local, group in _subs(0, 500):
        jr.add(stripped, JId(1, cid), JOpts(no_local=no_local, shared_group=group))
        tr.add(stripped, Id(1, cid), SubscriptionOptions(no_local=no_local,
                                                         shared_group=group))
    return int(request.param), jr, tr


def test_hybrid_parity_with_xla_router(routers):
    hmax, jr, tr = routers
    assert tr._side_native == jr._side_native
    for n in (0, 1, 8, 64, 65, 2048):
        assert tr.inline_ok(n) == jr.inline_ok(n), n
    assert tr.host_available() and tr.host_inline_ok() == jr.host_inline_ok()
    topics = gen_topics_uniform(random.Random(1), 2048) + ["$SYS/x", "v0_1"]
    publisher = "c3"
    for b in (1, 8, 2048):
        tj = [(JId(1, publisher), t) for t in topics[:b]]
        tt = [(Id(1, publisher), t) for t in topics[:b]]
        want = [_norm(r) for r in jr.matches_batch_raw(tj)]
        assert [_norm(r) for r in tr.matches_batch_raw(tt)] == want, b
        assert tr.last_match_was_device() == jr.last_match_was_device(), b
        assert tr.last_match_was_device() == (b > hmax), b
        # the pipelined halves: trie-served batches resolve inside submit
        sync_j, hj = jr.submit_batch_raw(tj)
        sync_t, ht = tr.submit_batch_raw(tt)
        assert sync_t == sync_j == (b <= hmax), b
        got = ht if sync_t else tr.complete_batch_raw(ht)
        ref = hj if sync_j else jr.complete_batch_raw(hj)
        assert [_norm(r) for r in got] == [_norm(r) for r in ref] == want, b
        # the host plane alone: the trie's order, the same routes
        host = [_norm(r) for r in tr.host_matches_batch_raw(tt)]
        assert host == [_norm(r) for r in jr.host_matches_batch_raw(tj)], b
        assert [_sorted(r) for r in host] == [_sorted(r) for r in want], b
    assert sum(len(r[0]) for r in want) > 500
    canary = tr.canary_topics(3)
    assert canary == jr.canary_topics(3) and len(canary) == 3
    assert tr.device_canary(canary) and jr.device_canary(canary)
    assert tr.is_match(canary[0]) and jr.is_match(canary[0])
    # a mirror that disagrees with the device fails the canary
    stripped, fid = next(iter(tr._filter_to_fid.items()))
    tr._side.remove(stripped, fid)
    assert not tr.device_canary([tr.canary_topics(1)[0]])


def test_set_hybrid_max_moves_both_gates(routers):
    hmax, _jr, tr = routers
    assert tr.set_hybrid_max(8) == hmax
    assert tr.inline_ok(8) == tr._side_native and not tr.inline_ok(9)
    assert tr._hybrid.small_max == 8
    tr.matches_batch_raw([(None, "a/b")] * 9)
    assert tr.last_match_was_device()


def test_upload_failpoint_and_rewarm():
    """``device.upload`` fires on the port matcher's refresh, full and
    delta alike, and ``device_rewarm`` forces the next one to be full."""
    tr = TorchRouter(device="cpu")
    tr.add("a/+", Id(1, "c1"), SubscriptionOptions())
    tr.matcher.match(["a/b"])
    fp = FAILPOINTS.point("device.upload")
    hits = fp.triggers
    tr.add("a/#", Id(1, "c2"), SubscriptionOptions())
    FAILPOINTS.set("device.upload", "error")
    try:
        with pytest.raises(RuntimeError, match="failpoint"):
            tr.matcher.match(["a/b"])
    finally:
        FAILPOINTS.set("device.upload", "off")
    assert fp.triggers == hits + 1
    d0, f0 = tr.matcher.delta_uploads, tr.matcher.full_uploads
    assert [r.tolist() for r in tr.matcher.match(["a/b"])] == [[0, 1]]
    assert tr.matcher.delta_uploads == d0 + 1 and tr.matcher.full_uploads == f0
    tr.add("b", Id(1, "c3"), SubscriptionOptions())
    tr.device_rewarm()
    tr.matcher.match(["b"])
    assert tr.matcher.full_uploads == f0 + 1
    assert tr.device_hbm()["total_bytes"] > 0


def test_failover_breaker_e2e_with_forced_reupload(monkeypatch):
    """device errors → breaker opens → host routing (none lost) → fault
    cleared → the probe rewarms (a full re-upload) and canaries → breaker
    closes → the device serves again."""
    from rmqtt_tpu_torch.broker.context import BrokerConfig, ServerContext

    monkeypatch.setenv("RMQTT_HYBRID_MAX", "0")

    async def run():
        ctx = ServerContext(
            BrokerConfig(failover_cooldown=0.2, failover_threshold=2,
                         failover_k_successes=2, route_cache=False),
            router=TorchRouter(device="cpu"))
        fo = ctx.routing.failover
        assert fo is not None and fo.usable
        ctx.start()
        try:
            ctx.router.add("s/+/t", Id(1, "c1"), SubscriptionOptions(qos=1))
            ctx.router.add("s/#", Id(1, "c2"), SubscriptionOptions(qos=0))
            oracle = {"c1", "c2"}

            def ids(relmap):
                return {rel.id.client_id for rels in relmap.values() for rel in rels}

            assert ids(await ctx.routing.matches(None, "s/a/t")) == oracle
            br = fo.breaker
            FAILPOINTS.set("device.dispatch", "error")
            for i in range(6):
                assert ids(await ctx.routing.matches(None, f"s/b{i}/t")) == oracle
            assert fo.active and br.state != br.CLOSED
            assert fo.failures["dispatch_error"] >= 2
            assert fo.host_items >= 4
            st = ctx.routing.stats()
            assert st["routing_failover_state"] in (1, 2)
            assert st["routing_failovers"] == 1
            assert ctx.overload.breakers["routing.device"] is br
            full_before = ctx.router.matcher.full_uploads
            FAILPOINTS.set("device.dispatch", "off")
            t0 = time.time()
            while fo.active and time.time() - t0 < 15:
                await asyncio.sleep(0.05)
            assert not fo.active, "no switchback after recovery"
            assert br.state == br.CLOSED
            assert fo.switchbacks == 1 and fo.probes >= 1
            assert ctx.router.matcher.full_uploads > full_before
            fused = ctx.router.matcher.fused_batches
            assert ids(await ctx.routing.matches(None, "s/z/t")) == oracle
            assert ctx.router.matcher.fused_batches > fused
            assert ctx.routing.stats()["routing_failover_state"] == 0
        finally:
            await ctx.stop()
            FAILPOINTS.clear_all()

    asyncio.run(asyncio.wait_for(run(), timeout=20.0))


def test_kernel_fault_classification():
    from rmqtt_tpu_torch.ops._build import KernelError, kernel_fault
    from rmqtt_tpu_torch.utils.failpoints import FailpointError

    assert kernel_fault(KernelError("match_words_packed: launch failed"))
    assert kernel_fault(RuntimeError("CUDA error: an illegal memory access"))
    assert not kernel_fault(FailpointError("device.dispatch"))
    assert not kernel_fault(TimeoutError("device dispatch exceeded"))


def test_kernel_fault_rejects_and_never_fails_over(monkeypatch):
    """A words kernel that fails on the card rejects the batch and leaves
    the breaker closed: no batch is served off the card in its place. A
    kernel fault in the half-open probe (the breaker opened by an injected
    fault) routes on the card again. Once the kernel works, the card
    serves."""
    import rmqtt_tpu_torch.ops.partitioned as TP
    from rmqtt_tpu_torch.broker.context import BrokerConfig, ServerContext
    from rmqtt_tpu_torch.ops._build import KernelError

    monkeypatch.setenv("RMQTT_HYBRID_MAX", "0")
    real = TP.words_any

    def broken(*a, **k):
        raise KernelError("match_words_packed: CUDA launch failed with error 719")

    async def run():
        ctx = ServerContext(
            BrokerConfig(failover_cooldown=0.2, failover_threshold=2,
                         failover_k_successes=1, route_cache=False),
            router=TorchRouter(device="cpu"))
        fo = ctx.routing.failover
        br = fo.breaker
        ctx.start()
        try:
            ctx.router.add("s/+/t", Id(1, "c1"), SubscriptionOptions(qos=1))
            monkeypatch.setattr(TP, "words_any", broken)
            for i in range(4):
                with pytest.raises(KernelError):
                    await ctx.routing.matches(None, f"s/k{i}/t")
            assert not fo.active and br.state == br.CLOSED
            assert fo.failure_total == 0 and fo.host_items == 0

            monkeypatch.setattr(TP, "words_any", real)
            FAILPOINTS.set("device.dispatch", "error")
            for i in range(3):
                await ctx.routing.matches(None, f"s/f{i}/t")
            assert fo.active and fo.host_items >= 1
            monkeypatch.setattr(TP, "words_any", broken)
            FAILPOINTS.set("device.dispatch", "off")
            t0 = time.time()
            while fo.active and time.time() - t0 < 10:
                await asyncio.sleep(0.05)
            assert not fo.active and br.state == br.CLOSED
            with pytest.raises(KernelError):
                await ctx.routing.matches(None, "s/k/t")

            monkeypatch.setattr(TP, "words_any", real)
            rel = await ctx.routing.matches(None, "s/ok/t")
            assert {r.id.client_id for rels in rel.values() for r in rels} == {"c1"}
        finally:
            await ctx.stop()
            FAILPOINTS.clear_all()

    asyncio.run(asyncio.wait_for(run(), timeout=20.0))


def test_prewarm_latches_floor_without_cuda():
    tr = TorchRouter(device="cpu")
    tr.prewarm()
    assert tr.matcher._pad_floor == 8
    fused = tr.matcher.fused_batches
    tr.prewarm((1, 8, 16))
    assert tr.matcher._pad_floor == 16
    assert tr.matcher.fused_batches == fused  # no launch off the card
    assert np.asarray(tr.matcher.match(["x"])[0]).size == 0
