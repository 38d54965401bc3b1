"""Label-based timing registry, the counterpart of
``cmblensing_tpu/utils/timing.py`` (reference TimerOutputs, src/util.jl).

Where CUDA is in use, a block's time is read from CUDA events recorded
on the current stream at its start and end, and its exit waits for the
end event: the time the device took for what the block enqueued,
including the gaps the host left. Elsewhere it is host wall time.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

_timers = defaultdict(lambda: [0.0, 0])


@contextlib.contextmanager
def timed(label: str):
    """Accumulate the block's seconds under label."""
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    if cuda:
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if cuda:
            e1.record()
            e1.synchronize()
            dt = e0.elapsed_time(e1) / 1e3
        else:
            dt = time.perf_counter() - t0
        _timers[label][0] += dt
        _timers[label][1] += 1


def timer_report():
    """Accumulated timings as a table, largest total first."""
    lines = ["label                              total(s)   calls    avg(ms)"]
    for k, (tot, n) in sorted(_timers.items(), key=lambda kv: -kv[1][0]):
        lines.append(f"{k:<34s} {tot:8.3f} {n:7d} {1e3 * tot / max(n, 1):9.2f}")
    return "\n".join(lines)


def reset_timers():
    _timers.clear()
