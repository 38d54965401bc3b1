"""Non-uniform FFT: the Fourier series of a regular map at scattered points.

Counterpart of ``cmblensing_tpu/ops/nufft.py`` (the reference reaches
NFFT.jl): `nufft_eval` evaluates the periodic Fourier interpolant of a
regular (Ny, Nx) map at fractional pixel coordinates (type 2), and
`nufft_adjoint` is its adjoint (type 1), by Greengard & Lee's (2004)
Gaussian gridding: an oversampled FFT, a deconvolution, and a separable
Gaussian window of 2 Msp taps an axis, as torch gathers and scatter-adds
(`index_add_`, whose order on the card is not fixed: the adjoint carries
rounding of that order). About 1e-6 relative with sigma = 2, Msp = 6.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

_SIGMA = 2       # oversampling factor
_MSP = 6         # half-width of the spreading window (taps = 2*Msp)


@functools.lru_cache(maxsize=None)
def _axis_consts(n: int):
    """(tau, deconv): the Gaussian's width and the spectral deconvolution
    factors (numpy FFT order) for one axis of length n."""
    tau = np.pi * _MSP / (n * n * _SIGMA * (_SIGMA - 0.5))
    k = np.fft.fftfreq(n) * n
    return tau, np.exp(tau * k * k)


def _spread_weights(frac, tau, n_over):
    """The window's grid indices and weights about fractional positions
    frac (npts,) of an oversampled axis of n_over: (idx, w), each (npts,
    2 Msp)."""
    i0 = torch.floor(frac).to(torch.int64)
    offs = torch.arange(-_MSP + 1, _MSP + 1, device=frac.device)
    j = i0[:, None] + offs[None, :]
    d = frac[:, None] - j
    w = torch.exp(-((d * (2 * np.pi / n_over)) ** 2) / (4 * tau))
    return j % n_over, w


def _window(ys, xs, Ny, Nx):
    """(flat oversampled-grid indices (npts, T*T), the weights times the
    normalization (npts, T*T), (oy, ox))."""
    tau_y, _ = _axis_consts(Ny)
    tau_x, _ = _axis_consts(Nx)
    oy, ox = _SIGMA * Ny, _SIGMA * Nx
    iy, wy = _spread_weights(ys * _SIGMA, tau_y, oy)
    ix, wx = _spread_weights(xs * _SIGMA, tau_x, ox)
    npts = ys.shape[0]
    gidx = (iy[:, :, None] * ox + ix[:, None, :]).reshape(npts, -1)
    norm = (np.pi / np.sqrt(tau_y * tau_x)) / (oy * ox)
    w = (wy[:, :, None] * wx[:, None, :]).reshape(npts, -1) * norm
    return gidx, w, (oy, ox)


def _deconv(Ny, Nx, device):
    _, dec_y = _axis_consts(Ny)
    _, dec_x = _axis_consts(Nx)
    return (torch.as_tensor(dec_y, device=device)[:, None],
            torch.as_tensor(dec_x, device=device)[None, :])


def _pads(Ny, Nx):
    """The zero mode at index N//2 of a centered axis lands at o//2 of its
    oversampled one: (top, left) pads."""
    oy, ox = _SIGMA * Ny, _SIGMA * Nx
    return oy // 2 - Ny // 2, ox // 2 - Nx // 2


def nufft_eval(m, ys, xs):
    """The periodic Fourier interpolant of the map m (..., Ny, Nx) at
    fractional 0-based pixel coordinates (ys, xs), each (npts,); returns
    (..., npts), real for a real m."""
    Ny, Nx = m.shape[-2], m.shape[-1]
    gidx, w, (oy, ox) = _window(ys, xs, Ny, Nx)
    dy, dx = _deconv(Ny, Nx, m.device)
    F = torch.fft.fft2(m) / (Ny * Nx)
    F = F * dy.to(F.real.dtype) * dx.to(F.real.dtype)
    Fs = torch.fft.fftshift(F, dim=(-2, -1))
    py, px = _pads(Ny, Nx)
    Fp = torch.nn.functional.pad(Fs, (px, ox - Nx - px, py, oy - Ny - py))
    u = torch.fft.ifft2(torch.fft.ifftshift(Fp, dim=(-2, -1))) * (oy * ox)
    flat = u.reshape(m.shape[:-2] + (-1,))
    npts = ys.shape[0]
    vals = flat[..., gidx.reshape(-1)].reshape(m.shape[:-2] + (npts, -1))
    out = torch.sum(vals * w.to(vals.real.dtype), dim=-1)
    return out if m.is_complex() else out.real


def _adjoint(vals, ys, xs, Ny, Nx):
    """A^H vals of nufft_eval's complex-linear map A."""
    gidx, w, (oy, ox) = _window(ys, xs, Ny, Nx)
    cdt = vals.dtype if vals.is_complex() else (torch.complex64 if vals.dtype == torch.float32
                                                else torch.complex128)
    contrib = (vals[..., :, None] * w.to(vals.real.dtype)).to(cdt)
    ubar = torch.zeros(vals.shape[:-1] + (oy * ox,), dtype=cdt, device=vals.device)
    ubar.index_add_(-1, gidx.reshape(-1), contrib.reshape(vals.shape[:-1] + (-1,)))
    ubar = ubar.reshape(vals.shape[:-1] + (oy, ox))
    # the adjoints, in reverse, of: * (oy ox) ifft2, ifftshift, pad, fftshift,
    # deconvolution, fft2 / (Ny Nx)
    Fp = torch.fft.fftshift(torch.fft.fft2(ubar), dim=(-2, -1))
    py, px = _pads(Ny, Nx)
    F = torch.fft.ifftshift(Fp[..., py:py + Ny, px:px + Nx], dim=(-2, -1))
    dy, dx = _deconv(Ny, Nx, vals.device)
    return torch.fft.ifft2(F * dy.to(F.real.dtype) * dx.to(F.real.dtype))


def nufft_adjoint(vals, ys, xs, Ny, Nx):
    """The transpose of nufft_eval: scattered values (..., npts) back onto
    a regular (..., Ny, Nx) grid (type 1). For real values, the map is real
    and this is its adjoint; for complex ones it is the plain transpose,
    conj(A^H conj(vals)), as the JAX package's linear transpose gives."""
    if vals.is_complex():
        return torch.conj(_adjoint(torch.conj(vals), ys, xs, Ny, Nx)).resolve_conj()
    return _adjoint(vals, ys, xs, Ny, Nx).real
