"""PowerLens: lensing by a Taylor series in the deflection, to any order
(reference src/powerlens.jl),

    f(x + grad phi) ~= sum_{a+b <= order} d1^a d2^b f (d1 phi)^a (d2 phi)^b / (a! b!).

Counterpart of ``cmblensing_tpu/models/powerlens.py``: Fourier
derivatives (torch.fft) and pointwise products, no kernel of its own.
"""
from __future__ import annotations

from math import factorial

import torch

from ..core.basis import deriv_basis, lense_basis
from ..core.field import Field
from ..ops import deriv as _deriv
from ..ops import fft as _fft


def _grad_powers(phi: Field, order: int, sign=1):
    """{p: (sign d1 phi)^p} and {p: (sign d2 phi)^p} for p = 0 .. order, each
    (..., 1, Ny, Nx) (1.0 at p = 0)."""
    pm = phi.to(phi.basis.with_space("map"))
    gx, gy = _deriv.grad_xy(pm.arr, pm.proj)
    if sign < 0:
        gx, gy = -gx, -gy
    p1 = {p: (1.0 if p == 0 else gx ** p) for p in range(order + 1)}
    p2 = {p: (1.0 if p == 0 else gy ** p) for p in range(order + 1)}
    return p1, p2


def _deriv_ab(f_fourier, a, b, proj):
    """d1^a d2^b of a Fourier-space array (the whole lx, ly grids)."""
    ilx = torch.as_tensor(1j * proj.lx.astype(proj.complex_T), device=f_fourier.device)[None, :]
    ily = torch.as_tensor(1j * proj.ly.astype(proj.complex_T), device=f_fourier.device)[:, None]
    return f_fourier * (ilx ** a) * (ily ** b)


class PowerLens:
    """Series-expansion lensing operator: L @ f, L.H @ f; L(phi') re-binds
    phi."""

    __slots__ = ("phi", "order", "_adjoint", "_sign")

    def __init__(self, phi: Field, order: int = 4, _adjoint=False, _sign=1):
        self.phi = phi
        self.order = order
        self._adjoint = _adjoint
        self._sign = _sign   # -1 lenses by -phi (antilensing)

    def __call__(self, phi_or_theta):
        if isinstance(phi_or_theta, Field):
            return PowerLens(phi_or_theta, self.order, self._adjoint, self._sign)
        return self

    @property
    def H(self):
        return PowerLens(self.phi, self.order, not self._adjoint, self._sign)

    def _terms(self):
        """(a, b, a! b!) of every term of order 1 .. order."""
        return [(a, n - a, factorial(a) * factorial(n - a))
                for n in range(1, self.order + 1) for a in range(n + 1)]

    def __matmul__(self, f: Field) -> Field:
        B, proj = f.basis, f.proj
        p1, p2 = _grad_powers(self.phi, self.order, self._sign)
        fl = f.to(lense_basis(B))
        if not self._adjoint:
            Ff = _fft.rfft2(fl.arr)
            out = fl.arr
            for a, b, k in self._terms():
                dab = _fft.irfft2(_deriv_ab(Ff, a, b, proj), proj.Nx)
                out = out + p1[a] * p2[b] * dab / k
            return Field(out, fl.basis, proj).to(B)
        # the adjoint (src/powerlens.jl:50-58):
        # f + sum (-1)^(a+b) d1^a d2^b (p1^a p2^b f) / (a! b!), in Fourier space
        out = _fft.rfft2(fl.arr)
        for a, b, k in self._terms():
            term = _fft.rfft2(p1[a] * p2[b] * fl.arr)
            out = out + ((-1.0) ** (a + b)) * _deriv_ab(term, a, b, proj) / k
        return Field(out, deriv_basis(B), proj).to(B)

    def __repr__(self):
        return f"PowerLens(order={self.order}{', adjoint' if self._adjoint else ''})"


def antilensing(L: PowerLens) -> PowerLens:
    """The PowerLens that lenses by -phi (src/powerlens.jl:36-38)."""
    return PowerLens(L.phi, L.order, L._adjoint, -L._sign)
