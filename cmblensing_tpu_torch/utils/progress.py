"""Progress reporting, the counterpart of
``cmblensing_tpu/utils/progress.py`` (reference ProgressMeter bars,
src/maximization.jl): a tqdm bar where tqdm is installed, a printed line
per step otherwise, and nothing at all when disabled.

    with progress_bar(total=nsteps, desc="MAP_joint", enabled=progress) as pb:
        ...
        pb.update(logpdf=lp, alpha=alpha)
"""
from __future__ import annotations

import contextlib


class _Bar:
    def __init__(self, total, desc, enabled):
        self.enabled = bool(enabled)
        self._tqdm = None
        self._n = 0
        self._total = total
        self._desc = desc
        if self.enabled:
            try:
                from tqdm import tqdm
                self._tqdm = tqdm(total=total, desc=desc, leave=True, dynamic_ncols=True)
            except ImportError:
                self._tqdm = None

    def update(self, **showvalues):
        """Advance one step, showing showvalues beside the bar."""
        if not self.enabled:
            return
        self._n += 1
        fmt = lambda v: f"{v:.4g}" if isinstance(v, float) else str(v)
        if self._tqdm is not None:
            self._tqdm.set_postfix({k: fmt(v) for k, v in showvalues.items()}, refresh=False)
            self._tqdm.update(1)
        else:
            vals = " ".join(f"{k}={fmt(v)}" for k, v in showvalues.items())
            print(f"{self._desc} {self._n}/{self._total}: {vals}", flush=True)

    def close(self):
        if self._tqdm is not None:
            self._tqdm.close()


@contextlib.contextmanager
def progress_bar(total, desc, enabled=True):
    bar = _Bar(total, desc, enabled)
    try:
        yield bar
    finally:
        bar.close()
