"""Label-based timing registry, the counterpart of
``cmblensing_tpu/utils/timing.py`` (reference TimerOutputs, src/util.jl).

Where CUDA is in use, a block's time is read from CUDA events recorded
on the current stream at its start and end, and its exit waits for the
end event: the time the device took for what the block enqueued,
including the gaps the host left. Elsewhere it is host wall time.
"""
from __future__ import annotations

import contextlib
import functools
import os
import tempfile
import time
from collections import defaultdict

import torch

_timers = defaultdict(lambda: [0.0, 0])
_enabled = True


def set_timing_enabled(flag: bool):
    """Switch the registry on or off; off, `timed` neither records nor
    waits for the device."""
    global _enabled
    _enabled = bool(flag)


@contextlib.contextmanager
def timed(label: str):
    """Accumulate the block's seconds under label."""
    if not _enabled:
        yield
        return
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


def timed_fn(label: str):
    """Decorator: every call of the function is timed under label."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with timed(label):
                return fn(*a, **kw)
        return wrapper
    return deco


def timers_snapshot():
    """A copy of the registry, for `timer_report(since=...)`."""
    return {k: tuple(v) for k, v in _timers.items()}


def timer_report(since=None):
    """Accumulated timings as a table, largest total first; with `since`
    (an earlier `timers_snapshot()`) only what accrued after it."""
    lines = ["label                              total(s)   calls    avg(ms)"]
    for k, (tot, n) in sorted(_timers.items(), key=lambda kv: -kv[1][0]):
        if since is not None:
            t0, n0 = since.get(k, (0.0, 0))
            tot, n = tot - t0, n - n0
            if n == 0 and tot <= 0:
                continue
        lines.append(f"{k:<34s} {tot:8.3f} {n:7d} {1e3 * tot / max(n, 1):9.2f}")
    return "\n".join(lines)


def reset_timers():
    _timers.clear()


@contextlib.contextmanager
def profiler_trace(logdir=None):
    """torch.profiler over the block (the host, and CUDA where it is in
    use), its Chrome trace written to `logdir`/trace.json (logdir: a
    "torch-trace" folder in the temporary directory unless given). Yields
    the profiler; its key_averages() give the per-operator totals."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "torch-trace")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
