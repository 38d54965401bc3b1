"""Binned power spectra of fields: host-side numpy post-processing.

Counterpart of ``cmblensing_tpu/utils/spectra.py`` (reference get_Cℓ,
src/proj_lambert.jl:470-513), without JAX: the field's Fourier
coefficients are unfolded to the full plane on its device, fetched once
and binned with numpy.
"""
from __future__ import annotations

import numpy as np

from ..core.basis import FOURIER
from ..core.field import Field
from ..ops.fft import unfold
from .cls import Cls


def _full_plane_lmag(proj):
    """|l| over the full (Ny, Nx) Fourier plane, numpy FFT order."""
    ly = np.fft.ifftshift(np.arange(-(proj.Ny // 2), (proj.Ny - 1) // 2 + 1)) * float(proj.delta_ly)
    lx = np.fft.ifftshift(np.arange(-(proj.Nx // 2), (proj.Nx - 1) // 2 + 1)) * float(proj.delta_lx)
    return np.sqrt(lx[None, :] ** 2 + ly[:, None] ** 2)


def _spin0_fourier_full(f: Field):
    """The full-plane Fourier coefficients of a spin-0 field, on the host."""
    g = f.to(FOURIER) if f.basis.pol == "I" else f
    if g.arr.shape[-3] != 1:
        raise ValueError("get_Cl takes one component: index it first, e.g. f['E']")
    return unfold(g.arr.detach()[..., 0, :, :], f.proj.Nx).cpu().numpy()


def get_Cl(f1: Field, f2: Field = None, dl=50, ledges=None, Clfid=None, err_estimate=False):
    """Binned (cross-)power spectrum of spin-0 fields (index the
    components of a spin-2 field first, e.g. f['E']): the mode-weighted
    mean of Re(conj(F1) F2) / (Nx Ny / deltax^2) over the |l| of each bin
    of `ledges` (np.arange(0, 16001, dl) unless given), with weights
    (2 l + 1) / (2 Clfid(l)^2) (Clfid = 1 unless given). Returns Cls(ell
    of each bin, Cl of each bin), and with `err_estimate` also the
    standard error of each bin's mean."""
    if f2 is None:
        f2 = f1
    if f1.basis.ncomp > 1:
        raise ValueError("index components first, e.g. get_Cl(f['E'])")
    proj = f1.proj
    if ledges is None:
        ledges = np.arange(0, 16001, dl)
    ledges = np.asarray(ledges, dtype=np.float64)

    lmag = _full_plane_lmag(proj)
    alpha = proj.Nx * proj.Ny / float(proj.deltax) ** 2
    F1, F2 = _spin0_fourier_full(f1), _spin0_fourier_full(f2)
    if F1.ndim > 2:   # a batched field: its first entry
        F1 = F1.reshape((-1,) + F1.shape[-2:])[0]
        F2 = F2.reshape((-1,) + F2.shape[-2:])[0]

    mask = (lmag > ledges.min()) & (lmag < ledges.max())
    L = lmag[mask]
    CLobs = np.real(np.conj(F1[mask]) * F2[mask]) / alpha
    fid = 1.0 if Clfid is None else Clfid(L)
    w = np.nan_to_num((2 * fid ** 2 / (2 * L + 1)) ** -1)

    def bin_sum(x):
        return np.histogram(L, bins=ledges, weights=x)[0]

    A, Clb, lb = bin_sum(w), bin_sum(w * CLobs), bin_sum(w * L)
    with np.errstate(invalid="ignore", divide="ignore"):
        if err_estimate:
            N = bin_sum(np.ones_like(w)) / 2
            sigma = np.sqrt((bin_sum(w * CLobs ** 2) / A - (Clb / A) ** 2) / N)
            return Cls(lb / A, Clb / A), sigma
        return Cls(lb / A, Clb / A)


def bandpower_corr(f1: Field, f2: Field, ledges):
    """(ell, rho_b): the bandpower cross-correlation rho_b = C_b^{12} /
    sqrt(C_b^{11} C_b^{22}) in the bins of `ledges`."""
    cx, c1, c2 = get_Cl(f1, f2, ledges=ledges), get_Cl(f1, ledges=ledges), get_Cl(f2, ledges=ledges)
    with np.errstate(invalid="ignore", divide="ignore"):
        return cx.ell, cx.Cl / np.sqrt(c1.Cl * c2.Cl)


def get_Dl(*args, **kwargs):
    """`get_Cl` in the Dl = ell (ell + 1) Cl / 2 pi convention (that of
    toDl in utils/cls.py)."""
    cl = get_Cl(*args, **kwargs)
    return Cls(cl.ell, cl.ell * (cl.ell + 1) * cl.Cl / (2 * np.pi))
