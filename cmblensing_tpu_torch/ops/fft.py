"""Real 2-D FFTs over the last two axes of (..., Ny, Nx) tensors.

Unnormalized forward transform, inverse carrying 1/(Ny*Nx), as in the
JAX package (``cmblensing_tpu/ops/fft.py``), on ``torch.fft``.
"""
from __future__ import annotations

import torch


def rfft2(x):
    """Unnormalized forward real FFT over the last two axes."""
    return torch.fft.rfft2(x)


def irfft2(X, Nx: int):
    """Normalized (1/(Ny*Nx)) inverse real FFT over the last two axes."""
    return torch.fft.irfft2(X, s=(X.shape[-2], Nx))
