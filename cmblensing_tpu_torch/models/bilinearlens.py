"""BilinearLens: lensing by bilinear interpolation at the deflected pixels
(reference src/bilinearlens.jl).

Counterpart of ``cmblensing_tpu/models/bilinearlens.py``. The apply is a
4-tap gather with periodic wrap, weighted by the interpolation weights;
the adjoint its exact transpose, a scatter-add of the same 4 taps
(`Tensor.index_add` / `scatter_add`: atomics on the card, so the
adjoint's float32 sums land in any order there); the inverse GMRES
(ops/solvers.py) left-preconditioned with antilensing, the same taps at
-grad phi. Gradients with respect to phi flow through the weights by
autograd (exact for the piecewise-linear interpolant). No kernel of its
own.
"""
from __future__ import annotations

import torch

from ..core.basis import lense_basis
from ..core.field import Field
from ..ops import deriv as _deriv
from .taylens import _comp_axis, gather_pixels


def _displacements(phi: Field):
    """grad phi in pixels, (dx, dy), each (..., Ny, Nx)."""
    pm = phi.to(phi.basis.with_space("map"))
    gx, gy = _deriv.grad_xy(pm.arr, pm.proj)
    deltax = float(pm.proj.deltax)
    return gx[..., 0, :, :] / deltax, gy[..., 0, :, :] / deltax


def _taps(dx, dy, Ny, Nx):
    """The 4 (flat pixel index, weight) taps of bilinear interpolation at
    (i + dy, j + dx), periodic: (i0, j0), (i0, j1), (i1, j0), (i1, j1)."""
    ii = torch.arange(Ny, dtype=dy.dtype, device=dy.device)[:, None] + dy
    jj = torch.arange(Nx, dtype=dx.dtype, device=dx.device)[None, :] + dx
    i0, j0 = torch.floor(ii), torch.floor(jj)
    wi, wj = _comp_axis(ii - i0), _comp_axis(jj - j0)
    i0, j0 = i0.long(), j0.long()
    i1, j1 = (i0 + 1) % Ny, (j0 + 1) % Nx
    i0, j0 = i0 % Ny, j0 % Nx
    return [(i0 * Nx + j0, (1 - wi) * (1 - wj)), (i0 * Nx + j1, (1 - wi) * wj),
            (i1 * Nx + j0, wi * (1 - wj)), (i1 * Nx + j1, wi * wj)]


def _bilinear_apply(f_map, dx, dy):
    """Each component of f_map (..., C, Ny, Nx) resampled at (i + dy,
    j + dx)."""
    out = None
    for idx, w in _taps(dx, dy, f_map.shape[-2], f_map.shape[-1]):
        t = w * gather_pixels(f_map, idx)
        out = t if out is None else out + t
    return out


def _bilinear_adjoint(g_map, dx, dy):
    """The transpose of `_bilinear_apply` at (dx, dy) applied to g_map:
    each tap's weighted value added back onto the pixel it was read
    from."""
    Ny, Nx = g_map.shape[-2], g_map.shape[-1]
    taps = _taps(dx, dy, Ny, Nx)
    b = torch.broadcast_shapes(g_map.shape[:-3], taps[0][0].shape[:-2])
    shape = b + (g_map.shape[-3], Ny * Nx)
    out = g_map.new_zeros(shape)
    for idx, w in taps:
        src = (w * g_map).expand(b + g_map.shape[-3:]).reshape(shape)
        if idx.ndim == 2:
            out = out.index_add(-1, idx.reshape(-1), src)
        else:
            idx_b = idx.reshape(idx.shape[:-2] + (1, Ny * Nx)).expand(shape)
            out = out.scatter_add(-1, idx_b, src)
    return out.reshape(b + g_map.shape[-3:])


class BilinearLens:
    """Bilinear-interpolation lensing operator: L @ f, L.H @ f,
    L.solve(f) (GMRES of gmres_iters iterations); L(phi') re-binds phi."""

    __slots__ = ("phi", "gmres_iters", "_adjoint")

    def __init__(self, phi: Field, gmres_iters: int = 5, _adjoint=False):
        self.phi = phi
        self.gmres_iters = gmres_iters
        self._adjoint = _adjoint

    def __call__(self, phi_or_theta):
        if isinstance(phi_or_theta, Field):
            return BilinearLens(phi_or_theta, self.gmres_iters, self._adjoint)
        return self

    @property
    def H(self):
        return BilinearLens(self.phi, self.gmres_iters, not self._adjoint)

    def _op(self, dx, dy):
        return ((lambda a: _bilinear_adjoint(a, dx, dy)) if self._adjoint
                else (lambda a: _bilinear_apply(a, dx, dy)))

    def __matmul__(self, f: Field) -> Field:
        B = f.basis
        fl = f.to(lense_basis(B))
        out = self._op(*_displacements(self.phi))(fl.arr)
        return Field(out, fl.basis, f.proj).to(B)

    def solve(self, f: Field) -> Field:
        """Inverse lensing by GMRES, left-preconditioned with antilensing
        (src/bilinearlens.jl:127-151), whose displacements are exactly -grad
        phi."""
        from ..ops.solvers import gmres
        B = f.basis
        fl = f.to(lense_basis(B))
        dx, dy = _displacements(self.phi)
        out = gmres(self._op(dx, dy), fl.arr, maxiter=self.gmres_iters, Pl=self._op(-dx, -dy))
        return Field(out, fl.basis, f.proj).to(B)

    def __repr__(self):
        return f"BilinearLens({'adjoint' if self._adjoint else 'fwd'})"
