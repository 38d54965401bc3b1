"""Reductions over (comp, Ny, Nx) keeping leading batch axes, in one of
three accuracy modes.

Counterpart of ``cmblensing_tpu/utils/summation.py`` (reference
src/util.jl:288-316): at 4096^2 a float32 accumulation of the pixel sums
inside logpdf and dot loses 3-4 significant digits, so a mode can be
chosen globally (`set_sum_mode`) or per call (`asum(mode=...)`):

  'fast'    — torch.sum (a tree reduction; the default)
  'float64' — accumulated in float64, the result cast back to the
              input's precision
  'kahan'   — compensated (Kahan) summation: a loop over the rows of the
              (comp * Ny) axis carrying a sum and a compensation per
              column, then a compensated loop over those 2 Nx partials.
              The JAX package runs the same recurrence as a lax.scan.
"""
from __future__ import annotations

import torch

MODES = ("fast", "float64", "kahan")
_MODE = "fast"


def set_sum_mode(mode: str):
    if mode not in MODES:
        raise ValueError(f"sum mode {mode!r}: one of {MODES}")
    global _MODE
    _MODE = mode


def get_sum_mode():
    return _MODE


def _kahan_rows(rows, s, c):
    """Kahan-add each of `rows` (a sequence of tensors) into (s, c)."""
    for row in rows:
        y = row - c
        t = s + y
        c = (t - s) - y
        s = t
    return s, c


def _kahan_last3(z):
    """Compensated sum over the last 3 axes, batch axes leading."""
    b = tuple(z.shape[:-3])
    zf = z.reshape(b + (z.shape[-3] * z.shape[-2], z.shape[-1]))
    zero = torch.zeros(b + (z.shape[-1],), dtype=z.dtype, device=z.device)
    s, c = _kahan_rows(zf.unbind(-2), zero, zero)
    # the across-column reduction compensated too: a plain float32 sum of
    # the column partials would undo the row-wise compensation where they
    # cancel
    partials = torch.cat([s, -c], dim=-1)
    zero = torch.zeros(b, dtype=z.dtype, device=z.device)
    st, ct = _kahan_rows(partials.unbind(-1), zero, zero)
    return st - ct


def asum(z, mode=None):
    """Sum over the last 3 axes (comp, Ny, Nx), keeping batch axes, in
    `mode` (the global mode when None)."""
    mode = mode or _MODE
    if mode == "float64":
        return torch.sum(z.double(), dim=(-1, -2, -3)).to(z.dtype)
    if mode == "kahan":
        return _kahan_last3(z)
    return torch.sum(z, dim=(-1, -2, -3))
