"""Taylens (Naess & Louis 2013): a nearest-pixel remap plus a PowerLens
Taylor expansion in the sub-pixel residual of the deflection (reference
src/taylens.jl).

Counterpart of ``cmblensing_tpu/models/taylens.py``: the remap is a
gather (torch.gather, one per batch entry of a batched phi), the
derivatives Fourier ones; no kernel of its own.
"""
from __future__ import annotations

from math import factorial

import torch

from ..core.basis import lense_basis
from ..core.field import Field
from ..ops import deriv as _deriv
from ..ops import fft as _fft
from .powerlens import _deriv_ab


def _comp_axis(w):
    """Batched (B, Ny, Nx) planes with a component axis, so that they
    broadcast against (B, C, Ny, Nx) fields and not along C."""
    return w if w.ndim == 2 else w[..., None, :, :]


def gather_pixels(arr, idx):
    """arr (..., C, Ny, Nx) read at the flat pixel indices idx, (Ny, Nx) or
    batched (B, Ny, Nx), each batch entry its own gather."""
    Ny, Nx = arr.shape[-2], arr.shape[-1]
    flat = arr.reshape(arr.shape[:-2] + (Ny * Nx,))
    if idx.ndim == 2:
        return flat[..., idx.reshape(-1)].reshape(arr.shape)
    b = torch.broadcast_shapes(idx.shape[:-2], arr.shape[:-3])
    flat_b = flat.expand(b + flat.shape[-2:])
    idx_b = idx.reshape(idx.shape[:-2] + (1, Ny * Nx)).expand(b + flat.shape[-2:])
    return torch.gather(flat_b, -1, idx_b).reshape(b + arr.shape[-3:])


class Taylens:
    """Nearest-pixel remap and residual series lensing operator (L @ f;
    L(phi') re-binds phi)."""

    __slots__ = ("phi", "order")

    def __init__(self, phi: Field, order: int = 4):
        self.phi = phi
        self.order = order

    def __call__(self, phi_or_theta):
        if isinstance(phi_or_theta, Field):
            return Taylens(phi_or_theta, self.order)
        return self

    def _setup(self):
        """(the flat index of each pixel's nearest deflected pixel, the
        residual deflections (rx, ry)), the deflection d phi in physical
        units."""
        pm = self.phi.to(self.phi.basis.with_space("map"))
        proj = pm.proj
        gx, gy = _deriv.grad_xy(pm.arr, proj)
        dx, dy = gx[..., 0, :, :], gy[..., 0, :, :]
        deltax = float(proj.deltax)
        dj = torch.round(dx / deltax)
        di = torch.round(dy / deltax)
        ii = (di.long() + torch.arange(proj.Ny, device=dx.device)[:, None]) % proj.Ny
        jj = (dj.long() + torch.arange(proj.Nx, device=dx.device)[None, :]) % proj.Nx
        return ii * proj.Nx + jj, (dx - dj * deltax, dy - di * deltax)

    def __matmul__(self, f: Field) -> Field:
        B, proj = f.basis, f.proj
        idx, (rx, ry) = self._setup()
        fl = f.to(lense_basis(B))
        Ff = _fft.rfft2(fl.arr)
        rx, ry = _comp_axis(rx), _comp_axis(ry)
        p1 = {p: (1.0 if p == 0 else rx ** p) for p in range(self.order + 1)}
        p2 = {p: (1.0 if p == 0 else ry ** p) for p in range(self.order + 1)}
        out = gather_pixels(fl.arr, idx)
        for n in range(1, self.order + 1):
            for a in range(n + 1):
                b = n - a
                dab = _fft.irfft2(_deriv_ab(Ff, a, b, proj), proj.Nx)
                out = out + p1[a] * p2[b] * gather_pixels(dab, idx) / (factorial(a) * factorial(b))
        return Field(out, fl.basis, proj).to(B)

    def __repr__(self):
        return f"Taylens(order={self.order})"
