"""Flat-sky fields over torch tensors.

Counterpart of ``cmblensing_tpu/core/field.py``. A Field wraps one
tensor of shape

    (*batch, ncomp, Ny, Nx)        in any map basis
    (*batch, ncomp, Ny, Nx//2+1)   (complex) in any fourier basis

plus its basis and projection. The tensor's device is the projection's
device. Basis conversions rotate QU <-> EB in Fourier space; arithmetic
between fields promotes bases as the JAX package does.
"""
from __future__ import annotations

import operator

import numpy as np
import torch

from .basis import Basis, promote_basis, harmonic_basis
from .proj import ProjLambert
from ..ops import fft as _fft
from ..utils.summation import asum


class Field:
    """A (possibly batched) flat-sky field in a given basis."""

    __slots__ = ("arr", "basis", "proj")

    def __init__(self, arr, basis: Basis, proj: ProjLambert):
        self.arr = arr
        self.basis = basis
        self.proj = proj

    @property
    def ncomp(self):
        return self.basis.ncomp

    @property
    def batch_shape(self):
        return tuple(self.arr.shape[:-3])

    @property
    def dtype(self):
        return self.arr.dtype

    @property
    def device(self):
        return self.arr.device

    def __repr__(self):
        return (f"Field<{self.basis!r}, {tuple(self.arr.shape)}, {self.arr.dtype}, "
                f"{self.proj.Ny}x{self.proj.Nx}@{self.proj.thetapix}', {self.arr.device}>")

    # --- basis conversion ------------------------------------------------
    def to(self, basis) -> "Field":
        """Convert to the given basis (or basis-function)."""
        if callable(basis) and not isinstance(basis, Basis):
            basis = basis(self.basis)
        if basis == self.basis:
            return self
        return _convert(self, basis)

    def to_harmonic(self):
        return self.to(harmonic_basis(self.basis))

    # --- component access ------------------------------------------------
    def __getitem__(self, k):
        """f['I'], f['E'] or f['B']: a spin-0 sub-field, converting to a
        Fourier EB basis where needed."""
        pol, space = self.basis.pol, self.basis.space
        if k == "I" and pol in ("I", "IQU", "IEB"):
            return Field(self.arr[..., 0:1, :, :], Basis("I", space), self.proj)
        if k in ("E", "B") and pol != "I":
            if pol in ("EB", "IEB"):
                target = self
            else:
                target = self.to(Basis("EB" if pol == "QU" else "IEB", "fourier"))
            i = (0 if target.basis.pol == "EB" else 1) + "EB".index(k)
            return Field(target.arr[..., i:i + 1, :, :], Basis("I", target.basis.space), self.proj)
        raise KeyError(k)

    # --- arithmetic ------------------------------------------------------
    def _binop(self, other, op, reverse=False):
        if isinstance(other, Field):
            if other.proj is not self.proj:
                raise ValueError(
                    f"Can't combine fields with differing projections: "
                    f"{self.proj!r} vs {other.proj!r}")
            b = promote_basis(self.basis, other.basis)
            a1, a2 = self.to(b).arr, other.to(b).arr
            if reverse:
                a1, a2 = a2, a1
            return Field(op(a1, a2), b, self.proj)
        if isinstance(other, (int, float, np.floating, torch.Tensor)):
            o = batch_broadcast(other, self)
            a1, a2 = (o, self.arr) if reverse else (self.arr, o)
            return Field(op(a1, a2), self.basis, self.proj)
        return NotImplemented

    def __add__(self, o):
        return self._binop(o, operator.add)

    def __sub__(self, o):
        return self._binop(o, operator.sub)

    def __mul__(self, o):
        return self._binop(o, operator.mul)

    def __rmul__(self, o):
        return self._binop(o, operator.mul, reverse=True)

    def __neg__(self):
        return Field(-self.arr, self.basis, self.proj)

    def conj(self):
        return Field(torch.conj(self.arr), self.basis, self.proj)


def batch_broadcast(x, f: Field):
    """A scalar, or a batched scalar of shape f.batch_shape reshaped to
    (*batch, 1, 1, 1), so that it broadcasts against f.arr."""
    if isinstance(x, torch.Tensor) and x.ndim > 0 and tuple(x.shape) == f.batch_shape:
        return x.reshape(x.shape + (1, 1, 1))
    return x


# --- basis conversion implementations ------------------------------------

def _qu_to_eb_fourier(arr, proj, has_i):
    """QU fourier -> EB fourier:  E = -Q c2 - U s2 ;  B = Q s2 - U c2."""
    c2 = proj.tensor("cos2phi")
    s2 = proj.tensor("sin2phi")
    off = 1 if has_i else 0
    Ql = arr[..., off, :, :]
    Ul = arr[..., off + 1, :, :]
    parts = ([arr[..., 0, :, :]] if has_i else []) + [-Ql * c2 - Ul * s2, Ql * s2 - Ul * c2]
    return torch.stack(parts, dim=-3)


def _eb_to_qu_fourier(arr, proj, has_i):
    """EB fourier -> QU fourier:  Q = -E c2 + B s2 ;  U = -E s2 - B c2."""
    c2 = proj.tensor("cos2phi")
    s2 = proj.tensor("sin2phi")
    off = 1 if has_i else 0
    El = arr[..., off, :, :]
    Bl = arr[..., off + 1, :, :]
    parts = ([arr[..., 0, :, :]] if has_i else []) + [-El * c2 + Bl * s2, -El * s2 - Bl * c2]
    return torch.stack(parts, dim=-3)


def _convert(f: Field, b: Basis) -> Field:
    cur = f.basis
    arr = f.arr
    proj = f.proj
    # pol rotations happen in fourier space
    if cur.pol != b.pol and cur.is_map:
        arr = _fft.rfft2(arr)
        cur = cur.with_space("fourier")
    if cur.pol != b.pol:
        has_i = cur.pol.startswith("I")
        if cur.pol in ("QU", "IQU") and b.pol in ("EB", "IEB"):
            arr = _qu_to_eb_fourier(arr, proj, has_i)
        elif cur.pol in ("EB", "IEB") and b.pol in ("QU", "IQU"):
            arr = _eb_to_qu_fourier(arr, proj, has_i)
        else:
            raise ValueError(f"no conversion {cur} -> {b}")
        cur = cur.with_pol(b.pol)
    if cur.space != b.space:
        arr = _fft.rfft2(arr) if b.is_fourier else _fft.irfft2(arr, proj.Nx)
        cur = cur.with_space(b.space)
    return Field(arr, b, proj)


# --- constructors ---------------------------------------------------------

def white_noise_like(generator, f: Field) -> Field:
    """Standard-normal white noise matching f's pol and batch shape, in
    the map basis, drawn from `generator`."""
    b = f.basis.with_space("map")
    shape = f.batch_shape + (b.ncomp, f.proj.Ny, f.proj.Nx)
    arr = torch.randn(shape, generator=generator, dtype=f.proj.torch_T,
                      device=f.proj.device)
    return Field(arr, b, f.proj)


def zeros_like_field(f: Field) -> Field:
    return Field(torch.zeros_like(f.arr), f.basis, f.proj)


# --- reductions -----------------------------------------------------------

def dot(a: Field, b: Field):
    """Inner product (equal to the pixel-space dot product), computed in
    the harmonic basis with rfft degeneracy weights. Per-batch scalars."""
    if a.basis.is_map and b.basis.is_map and a.basis == b.basis:
        return asum(a.arr * b.arr)
    ah = a.to_harmonic()
    bh = b.to(ah.basis)
    lam = ah.proj.tensor("lam_rfft")
    z = torch.real(torch.conj(ah.arr) * bh.arr) * lam
    return asum(z) / (ah.proj.Ny * ah.proj.Nx)


def norm(f: Field):
    return torch.sqrt(dot(f, f))


# --- gradients w.r.t. fields ----------------------------------------------
#
# Field gradients are taken with respect to the map-space pixel values,
# as in the JAX package: the primal is converted to its map basis and
# autograd differentiates the real map tensor, never a complex Fourier
# tensor (whose conjugate-gradient convention differs from JAX's).

def _map_basis_of(f):
    return f.basis.with_space("map")


def fvalue_and_grad(fn):
    """(fn(f), gradient) with the gradient a map-basis Field."""

    def vg(f: Field, *args, **kwargs):
        fm = f.to(_map_basis_of(f))
        arr = fm.arr.detach().requires_grad_(True)
        with torch.enable_grad():
            v = fn(Field(arr, fm.basis, fm.proj), *args, **kwargs)
            (g,) = torch.autograd.grad(v, arr)
        return v.detach(), Field(g, fm.basis, fm.proj)

    return vg


def fgrad(fn):
    """Gradient of scalar fn(field) as a map-basis Field."""
    vg = fvalue_and_grad(fn)

    def gradfn(f: Field, *args, **kwargs):
        return vg(f, *args, **kwargs)[1]

    return gradfn
