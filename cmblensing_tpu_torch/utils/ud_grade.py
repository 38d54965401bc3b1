"""Up- and downgrading a field's resolution in integer steps.

Counterpart of ``cmblensing_tpu/utils/ud_grade.py`` (reference ud_grade,
src/proj_lambert.jl:533-592), on the field's device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.field import Field
from ..core.proj import ProjLambert, pixwin


def _pixwin_2d(theta, proj):
    wy = pixwin(theta, np.asarray(proj.ly, dtype=np.float64))
    wx = pixwin(theta, np.asarray(proj.lx, dtype=np.float64))
    return wy[:, None] * wx[None, :]


def _below(proj_grid, proj_nyq):
    """The Fourier modes of proj_grid below proj_nyq's Nyquist on both
    axes (a host bool array)."""
    nyq = float(proj_nyq.nyquist)
    return ((np.abs(np.asarray(proj_grid.ly))[:, None] < nyq)
            & (np.abs(np.asarray(proj_grid.lx))[None, :] < nyq))


def ud_grade(f: Field, theta_new, mode="map", deconv_pixwin=None, anti_aliasing=None):
    """f at pixel size theta_new (arcmin), an integer factor from its own.

    mode='map': average (down) or repeat (up) pixels in map space;
    mode='fourier': truncate (down) or zero-pad (up) the Fourier plane.
    deconv_pixwin (default: mode == 'map') divides out the change of pixel
    window; anti_aliasing (default: mode == 'map') zeroes the modes past
    the coarse grid's Nyquist."""
    if deconv_pixwin is None:
        deconv_pixwin = mode == "map"
    if anti_aliasing is None:
        anti_aliasing = mode == "map"
    proj = f.proj
    theta = proj.thetapix
    if theta_new == theta:
        return f
    if mode not in ("map", "fourier"):
        raise ValueError("mode must be 'map' or 'fourier'")
    fac = theta_new / theta if theta_new > theta else theta / theta_new
    if abs(round(fac) - fac) > 1e-9:
        raise ValueError("can only ud_grade in integer steps")
    fac = int(round(fac))
    Ny_new = int(round(proj.Ny * theta / theta_new))
    Nx_new = int(round(proj.Nx * theta / theta_new))
    proj_new = ProjLambert(Ny_new, Nx_new, theta_new, T=proj.T, rotator=proj.rotator,
                           device=proj.device)
    B = f.basis
    dev = proj.device
    t = lambda a: torch.as_tensor(a.astype(proj.T), device=dev)

    if theta_new > theta:  # downgrade
        if anti_aliasing:
            ff = f.to(B.with_space("fourier"))
            f = Field(ff.arr * t(_below(proj, proj_new)), ff.basis, proj)
        if mode == "map":
            a = f.to(B.with_space("map")).arr
            a = a.reshape(a.shape[:-2] + (Ny_new, fac, Nx_new, fac)).mean(dim=(-1, -3))
            out = Field(a, B.with_space("map"), proj_new)
        else:
            a = f.to(B.with_space("fourier")).arr
            ysel = np.concatenate([np.arange(0, (Ny_new + 1) // 2),
                                   np.arange(proj.Ny - Ny_new // 2, proj.Ny)])
            a = a[..., torch.as_tensor(ysel, device=dev), : Nx_new // 2 + 1] / (fac * fac)
            out = Field(a, B.with_space("fourier"), proj_new)
        if deconv_pixwin:
            pw = _pixwin_2d(theta_new, proj_new) / _pixwin_2d(theta, proj_new)
            of = out.to(B.with_space("fourier"))
            out = Field(of.arr / t(pw), of.basis, proj_new)
        return out.to(B)

    # upgrade: proj is the coarse grid, proj_new the fine one
    if mode == "map":
        a = f.to(B.with_space("map")).arr
        a = torch.repeat_interleave(torch.repeat_interleave(a, fac, dim=-2), fac, dim=-1)
        out = Field(a, B.with_space("map"), proj_new)
    else:
        # Fourier zero-padding; the coarse Nyquist row / column is one
        # self-paired bin, split with half weight into its + and - places
        # on the fine grid so that the map stays real
        ff = f.to(B.with_space("fourier"))
        a = ff.arr * (fac * fac)
        ncol = proj.Nx // 2 + 1
        if proj.Nx % 2 == 0:
            a[..., :, proj.Nx // 2] *= 0.5
        pos = (proj.Ny + 1) // 2   # rows 0 .. pos-1: frequencies 0 ..
        neg = proj.Ny - pos        # rows pos ..: frequencies -neg .. -1
        z = torch.zeros(ff.arr.shape[:-2] + (Ny_new, Nx_new // 2 + 1), dtype=ff.arr.dtype,
                        device=dev)
        if proj.Ny % 2 == 0:
            a[..., pos, :] *= 0.5
            z[..., proj.Ny // 2, :ncol] = a[..., pos, :]
        z[..., :pos, :ncol] = a[..., :pos, :]
        z[..., Ny_new - neg:, :ncol] = a[..., pos:, :]
        out = Field(z, B.with_space("fourier"), proj_new)
    if anti_aliasing and mode == "map":
        of = out.to(B.with_space("fourier"))
        out = Field(of.arr * t(_below(proj_new, proj)), of.basis, proj_new)
    if deconv_pixwin:
        # the resampling's transfer pw(coarse)/pw(fine) taken out below the
        # coarse Nyquist (identity above it)
        ratio = _pixwin_2d(theta_new, proj_new) / _pixwin_2d(theta, proj_new)
        of = out.to(B.with_space("fourier"))
        out = Field(of.arr * t(np.where(_below(proj_new, proj), ratio, 1.0)), of.basis, proj_new)
    return out.to(B)
