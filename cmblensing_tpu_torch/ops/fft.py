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
    """Normalized (1/(Ny*Nx)) inverse real FFT over the last two axes, of
    the Hermitian part of X's self-conjugate columns (kx = 0 and, for
    even Nx, the Nyquist column): the part of them a real inverse
    transform represents.

    A spectrum that is Hermitian only up to rounding (a Fourier-diagonal
    operator such as the quadratic estimator's Nphi applied to a field)
    also has an anti-Hermitian part there. pocketfft drops it, but cuFFT's
    batched inverse real plans do not handle it as its single plans do:
    at 1024^2 a (17, ...) batch came out 1e-4 relative apart from the same
    planes one at a time, as broadband noise that a Cphi^-1 of ~5e18 at
    high l turned into Delta logpdfs of -1e6. So the inverse runs as a
    complex inverse along y, then a real inverse along x: after the first,
    a column's Hermitian part is the real part of its transform, and
    zeroing the imaginary part there, in place on the transform's own
    output, takes two small launches and no copy of the spectrum."""
    Y = torch.fft.ifft(X, dim=-2)
    Y[..., 0].imag.zero_()
    if Nx % 2 == 0:
        Y[..., Nx // 2].imag.zero_()
    return torch.fft.irfft(Y, n=Nx, dim=-1)
