"""Reductions over (comp, Ny, Nx) keeping leading batch axes.

Counterpart of ``cmblensing_tpu/utils/summation.py`` in its default
"fast" mode (a plain tree reduction).
"""
from __future__ import annotations

import torch


def asum(z):
    """Sum over the last 3 axes (comp, Ny, Nx), keeping batch axes."""
    return torch.sum(z, dim=(-1, -2, -3))
