"""Kernel timing on the card with CUDA events: per call, and by CUDA-graph
replay, which leaves out the host's launch path; and the card's published
rates that a kernel's least time is reckoned from."""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
SMS, SM_HZ = 132, 1.98e9  # H100 SXM: streaming multiprocessors, boost clock
#: lane-instructions issued a second: one warp instruction a clock on each of
#: an SM's four schedulers
INSTR_PER_S = 4 * 32 * SMS * SM_HZ
L2_BYTES = 50 << 20  # H100 SXM L2 cache (50 MB; taken as MiB, the larger)
#: the most bytes the SMs' loads take in a second, from the L2 cache or
#: device memory alike: each SM's L1 returns 128 bytes a clock (32 banks of
#: 4 bytes)
SM_LOAD_BYTES_PER_S = 128 * SMS * SM_HZ


def time_cuda(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call over ``reps`` calls, by CUDA events after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_graph(fn, reps: int, per_graph: int = 20) -> float:
    """Device ms per call: ``per_graph`` calls captured in one CUDA graph,
    replayed ``reps`` times between CUDA events. Unlike :func:`time_cuda`
    this leaves out the host's launch path, which is longer than a small
    kernel."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(per_graph):
            fn()
    return time_cuda(g.replay, reps) / per_graph


def time_cold(fn, reps: int, flush_bytes: int = 128 << 20) -> float:
    """Mean device ms of a call of ``fn`` with the L2 cache cold: before each
    call a read of ``flush_bytes`` (more than the H100's 50 MB of L2)
    leaves the cache holding other, clean lines (a write would leave dirty
    ones, whose write-back the call would pay for); CUDA events around the
    call alone. A spin of ~0.1 ms on the device before the read keeps it
    busy while the host enqueues the read and the call, so the events do
    not also time the host's launch path (a wrapper's checks)."""
    buf = torch.zeros(flush_bytes // 4, dtype=torch.int32, device="cuda")
    fn()
    events = []
    for _ in range(reps):
        torch.cuda._sleep(200_000)  # clock cycles
        buf.max()
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        fn()
        ev[1].record()
        events.append(ev)
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / reps
