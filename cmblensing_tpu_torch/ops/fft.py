"""2-D FFTs over the last two axes of (..., Ny, Nx) tensors, and the
rfft half plane's symmetries.

Unnormalized forward transforms, inverses carrying 1/(Ny*Nx), as in the
JAX package (``cmblensing_tpu/ops/fft.py``), on ``torch.fft``. The JAX
package's matmul DFT (``set_fft_mode``) is a TPU choice and has no
counterpart here.
"""
from __future__ import annotations

import functools

import numpy as np
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


def fft2(x):
    """Unnormalized forward complex FFT over the last two axes."""
    return torch.fft.fft2(x)


def ifft2(X):
    """Normalized (1/(Ny*Nx)) inverse complex FFT over the last two axes."""
    return torch.fft.ifft2(X)


def unfold(X, Nx=None):
    """The full (..., Ny, Nx) plane of a half-plane rfft2 array (..., Ny,
    Nx//2+1) by conjugate symmetry: the entry at (ky, kx > Nx/2) is the
    conjugate of the one at (-ky, Nx - kx). Nx is taken even unless given
    (an odd grid has the same half-plane width as the even one below it)."""
    Nxh = X.shape[-1]
    if Nx is None:
        Nx = 2 * (Nxh - 1)
    if Nx // 2 + 1 != Nxh:
        raise ValueError(f"a half plane of {Nxh} columns does not unfold to {Nx}")
    rest = X[..., :, 1:-1] if Nx % 2 == 0 else X[..., :, 1:]
    rest = torch.conj(torch.flip(rest, dims=(-1,)))
    rest = torch.cat([rest[..., :1, :], torch.flip(rest[..., 1:, :], dims=(-2,))], dim=-2)
    return torch.cat([X, rest], dim=-1)


@functools.lru_cache(maxsize=None)
def fftsyms(Ny: int, Nx: int):
    """The symmetries of an rfft2 half plane (Ny, Nx//2+1), as numpy arrays:

    * ``ireal``, ``iimag``: masks of the entries whose real / imaginary
      part is a degree of freedom of its own;
    * ``(src_y, src_x)``: index maps such that every entry equals
      ``conj(X[src_y, src_x])`` where ``conj_mask`` is True, and
      ``X[src_y, src_x]`` (itself) elsewhere;
    * ``conj_mask``: the redundant entries, conjugate partners of others.

    ``ireal.sum() + iimag.sum() == Ny * Nx``, the map's degrees of freedom."""
    Nxh = Nx // 2 + 1
    ireal = np.ones((Ny, Nxh), bool)
    iimag = np.ones((Ny, Nxh), bool)
    src_y = np.tile(np.arange(Ny)[:, None], (1, Nxh))
    src_x = np.tile(np.arange(Nxh)[None, :], (Ny, 1))
    conj_mask = np.zeros((Ny, Nxh), bool)
    for c in [0] + ([Nx // 2] if Nx % 2 == 0 else []):
        for ky in range(Ny):
            ky_neg = (-ky) % Ny
            if ky == ky_neg:          # self-conjugate: real
                iimag[ky, c] = False
            elif ky > Ny // 2:        # the conjugate of (Ny - ky, c)
                ireal[ky, c] = False
                iimag[ky, c] = False
                src_y[ky, c] = ky_neg
                conj_mask[ky, c] = True
    return ireal, iimag, (src_y, src_x), conj_mask


def global_cache_clear():
    """Clear the FFT and derivative caches the package keeps: the rfft half
    plane's symmetries (`fftsyms`), the NUFFT's per-axis constants, the
    factored derivative matrices, and torch's cuFFT plan cache on every
    card. Nothing else is cached here; the JAX package's matmul-DFT
    matrices have no counterpart."""
    from .factored_deriv import factored_op
    from .nufft import _axis_consts
    for cached in (fftsyms, factored_op, _axis_consts):
        cached.cache_clear()
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.backends.cuda.cufft_plan_cache[i].clear()


def rfft2vec(X, Nx=None):
    """The degrees of freedom of an rfft2 half plane (..., Ny, Nx//2+1) as
    a real vector (..., Ny*Nx): the real parts `fftsyms` marks, then the
    imaginary parts. Nx is taken even unless given. Inverse: `vec2rfft`."""
    Ny, Nxh = X.shape[-2:]
    if Nx is None:
        Nx = 2 * (Nxh - 1)
    if Nx // 2 + 1 != Nxh:
        raise ValueError(f"a half plane of {Nxh} columns does not hold Nx = {Nx}")
    ireal, iimag, _, _ = fftsyms(Ny, Nx)
    ireal, iimag = torch.as_tensor(ireal, device=X.device), torch.as_tensor(iimag, device=X.device)
    return torch.cat([X.real[..., ireal], X.imag[..., iimag]], dim=-1)


def vec2rfft(v, Ny=None, Nx=None):
    """The rfft2 half plane (..., Ny, Nx//2+1) of a vector from `rfft2vec`,
    its redundant entries restored. Without a shape the grid is taken
    square (Ny = Nx = sqrt of the length)."""
    if Ny is None or Nx is None:
        n = int(round(np.sqrt(v.shape[-1])))
        if n * n != v.shape[-1]:
            raise ValueError("the vector's length is not a square: pass Ny and Nx")
        Ny = Nx = n
    if v.shape[-1] != Ny * Nx:
        raise ValueError(f"a vector of {v.shape[-1]} does not hold {Ny} x {Nx}")
    Nxh = Nx // 2 + 1
    ireal, iimag, (src_y, src_x), conj_mask = fftsyms(Ny, Nx)
    nreal = int(ireal.sum())
    dev = v.device
    shape = tuple(v.shape[:-1]) + (Ny, Nxh)
    re = v.new_zeros(shape)
    im = v.new_zeros(shape)
    re[..., torch.as_tensor(ireal, device=dev)] = v[..., :nreal]
    im[..., torch.as_tensor(iimag, device=dev)] = v[..., nreal:]
    Xg = torch.complex(re, im)[..., torch.as_tensor(src_y, device=dev),
                               torch.as_tensor(src_x, device=dev)]
    return torch.where(torch.as_tensor(conj_mask, device=dev), torch.conj(Xg), Xg)
