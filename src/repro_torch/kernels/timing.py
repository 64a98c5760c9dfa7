"""Interleaved paired timing on the card: the JAX package's ``paired``
harness (``benchmarks/common.py``) on CUDA events.

Interleaving cancels slow drift (clocks, temperature, other work on the
host) that would bias two back-to-back timing loops. The tile autotuner's
tournaments (``kernels/autotune``) time through here.
"""
from __future__ import annotations

import statistics

import torch

#: Calls of :func:`paired` since the count was last set to 0 (a build that
#: must time nothing reads it).
calls = 0


def _event_us(fn) -> float:
    """One call of ``fn`` between two CUDA events on the current stream,
    in microseconds (synchronizes)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3


def paired(fn_a, fn_b, reps: int):
    """Interleaved timing: per-rep (a_us, b_us) pairs after a joint
    warm-up. Returns (median_a_us, median_b_us, median of per-rep a/b
    ratios). Raises ``RuntimeError`` without a card: a time is only ever
    taken on it."""
    global calls
    if not torch.cuda.is_available():
        raise RuntimeError("paired times kernels on a CUDA device and none "
                           "is available")
    calls += 1
    fn_a()
    fn_b()
    torch.cuda.synchronize()
    ta, tb, ratios = [], [], []
    for _ in range(reps):
        a = _event_us(fn_a)
        b = _event_us(fn_b)
        ta.append(a)
        tb.append(b)
        ratios.append(a / b)
    return (statistics.median(ta), statistics.median(tb),
            statistics.median(ratios))
