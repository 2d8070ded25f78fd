"""Kernel timing on the card with CUDA events: per call, and by CUDA-graph
replay, which leaves out the host's launch path; and the card's published
rates that a kernel's least time is reckoned from."""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12  # H100 SXM non-tensor FP32 rate (an FMA counts as two)
INT_OPS_PER_S = 64 * 132 * 1.98e9  # integer pipe: 64 ops/clk/SM, 132 SMs, 1.98 GHz


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
