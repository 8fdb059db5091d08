"""Timers of calls on the card, shared by chip_smoke.py and the tools.

  cuda_ms(fn, iters)      mean time of back-to-back calls by CUDA events:
                          for a kernel shorter than its call, the host's
                          enqueue time per call
  graph_ms(fn, launches)  device time per call: the calls captured into
                          one CUDA graph, the graph replayed under events
"""
from __future__ import annotations

import torch


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean time of fn() over `iters` back-to-back calls, by CUDA events.
    For a kernel shorter than its call this is the host's enqueue time per
    call, not the kernel's (see graph_ms)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, launches: int, replays: int = 5) -> float:
    """Device time per call of fn(): `launches` calls captured into one
    CUDA graph, the graph replayed under CUDA events, so the host's enqueue
    time is out of the measurement (each call's kernels and the gap
    between graph nodes remain)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * launches)
