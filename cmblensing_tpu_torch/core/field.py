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

from .basis import Basis, MAP, promote_basis, harmonic_basis, lense_basis, deriv_basis
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
    def Nbatch(self):
        bs = self.batch_shape
        return int(np.prod(bs)) if bs else 1

    @property
    def dtype(self):
        return self.arr.dtype

    @property
    def device(self):
        return self.arr.device

    @property
    def real_dtype(self):
        return torch.float32 if self.arr.dtype in (torch.float32, torch.complex64) else torch.float64

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

    def to_lense(self):
        return self.to(lense_basis(self.basis))

    def to_deriv(self):
        return self.to(deriv_basis(self.basis))

    def to_harmonic(self):
        return self.to(harmonic_basis(self.basis))

    # --- component access ------------------------------------------------
    def __getitem__(self, k):
        """f['I'], f['Q'], f['U'], f['E'] or f['B']: a spin-0 sub-field,
        converting to a QU or a Fourier EB basis where needed; f['P'] the
        spin-2 part of a spin-(0,2) field, f['IP'] the field itself."""
        if not isinstance(k, str):
            raise TypeError("index fields with component names like f['E']")
        pol, space = self.basis.pol, self.basis.space
        if k == "P" and pol in ("IQU", "IEB"):
            return Field(self.arr[..., 1:, :, :], Basis(pol[1:], space), self.proj)
        if k == "IP":
            return self
        if k == "I" and pol in ("I", "IQU", "IEB"):
            return Field(self.arr[..., 0:1, :, :], Basis("I", space), self.proj)
        if k in ("Q", "U") and pol != "I":
            target = self if pol in ("QU", "IQU") else self.to(
                self.basis.with_pol("QU" if pol == "EB" else "IQU"))
            i = (0 if target.basis.pol == "QU" else 1) + "QU".index(k)
            return Field(target.arr[..., i:i + 1, :, :], Basis("I", target.basis.space), self.proj)
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
        if isinstance(other, np.ndarray):
            other = torch.as_tensor(other, device=self.arr.device)
        if isinstance(other, (int, float, np.floating, torch.Tensor)):
            o = batch_broadcast(other, self)
            a1, a2 = (o, self.arr) if reverse else (self.arr, o)
            return Field(op(a1, a2), self.basis, self.proj)
        return NotImplemented

    def __add__(self, o):
        return self._binop(o, operator.add)

    def __radd__(self, o):
        return self._binop(o, operator.add, reverse=True)

    def __sub__(self, o):
        return self._binop(o, operator.sub)

    def __rsub__(self, o):
        return self._binop(o, operator.sub, reverse=True)

    def __mul__(self, o):
        return self._binop(o, operator.mul)

    def __rmul__(self, o):
        return self._binop(o, operator.mul, reverse=True)

    def __truediv__(self, o):
        return self._binop(o, operator.truediv)

    def __rtruediv__(self, o):
        return self._binop(o, operator.truediv, reverse=True)

    def __pow__(self, p):
        return Field(self.arr ** p, self.basis, self.proj)

    def __neg__(self):
        return Field(-self.arr, self.basis, self.proj)

    def __pos__(self):
        return self

    def conj(self):
        return Field(torch.conj(self.arr), self.basis, self.proj)

    def flatten(self):
        """The array with its non-batch axes flattened: (*batch, -1)."""
        return self.arr.reshape(self.batch_shape + (-1,))


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

def from_maps(arr, proj: ProjLambert, pol=None) -> Field:
    """A map-basis Field from an array of shape (Ny, Nx), (ncomp, Ny, Nx)
    or (*batch, ncomp, Ny, Nx), on proj's device; pol 'I', 'QU' or 'IQU'
    (from ncomp when None)."""
    arr = torch.as_tensor(arr, dtype=proj.torch_T, device=proj.device)
    if arr.ndim == 2:
        arr = arr[None]
    if pol is None:
        pol = {1: "I", 2: "QU", 3: "IQU"}[arr.shape[-3]]
    return Field(arr, Basis(pol, "map"), proj)


def zeros(proj: ProjLambert, basis: Basis = MAP, batch_shape=()) -> Field:
    shape = tuple(batch_shape) + (basis.ncomp,) + (proj.shape_fourier if basis.is_fourier
                                                   else proj.shape_map)
    dtype = torch.complex64 if proj.torch_T == torch.float32 else torch.complex128
    arr = torch.zeros(shape, dtype=dtype if basis.is_fourier else proj.torch_T,
                      device=proj.device)
    return Field(arr, basis, proj)


def randn(generator, proj: ProjLambert, pol="I", batch_shape=()) -> Field:
    """Standard-normal white noise in the map basis, drawn from
    `generator`."""
    b = Basis(pol, "map")
    shape = tuple(batch_shape) + (b.ncomp, proj.Ny, proj.Nx)
    return Field(torch.randn(shape, generator=generator, dtype=proj.torch_T, device=proj.device),
                 b, proj)


def white_noise_like(generator, f: Field, batch_shape=None) -> Field:
    """Standard-normal white noise matching f's pol, with f's batch shape
    (or `batch_shape`), in the map basis, drawn from `generator`."""
    bs = f.batch_shape if batch_shape is None else tuple(batch_shape)
    return randn(generator, f.proj, f.basis.pol, bs)


def zeros_like_field(f):
    """Zeros in f's basis and shape. Duck-typed over (arr, basis, proj), so
    that the inference stack takes an EquiRectField as it takes a Field."""
    return type(f)(torch.zeros_like(f.arr), f.basis, f.proj)


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


def sum_field(f: Field):
    """Sum of the map-basis values, per batch entry."""
    return asum(f.to(f.basis.with_space("map")).arr)


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


# --- batching: a leading batch axis on the arrays -----------------------

def batch(fs):
    """Fields stacked along a new leading batch axis, in the first one's
    basis (a Field comes back as it is)."""
    if isinstance(fs, Field):
        return fs
    fs = list(fs)
    b = fs[0].basis
    return Field(torch.stack([f.to(b).arr for f in fs]), b, fs[0].proj)


def unbatch(f: Field):
    """The list of f's batch entries (f itself, unbatched)."""
    if not f.batch_shape:
        return [f]
    arr = f.arr.reshape((-1,) + f.arr.shape[len(f.batch_shape):])
    return [Field(a, f.basis, f.proj) for a in arr]


def batch_index(f: Field, i):
    if not f.batch_shape:
        raise ValueError("field is not batched")
    return Field(f.arr[i], f.basis, f.proj)


def batch_length(f) -> int:
    if isinstance(f, Field):
        return f.Nbatch
    if hasattr(f, "shape"):
        return int(np.prod(f.shape)) if len(f.shape) else 1
    return 1


def repeat_batch(f: Field, n: int) -> Field:
    """An unbatched field repeated n times along a new batch axis."""
    return Field(f.arr.unsqueeze(0).expand((n,) + tuple(f.arr.shape)).contiguous(), f.basis,
                 f.proj)


def batch_map(fn, fs):
    """fn over the batch entries of a Field (batched back together), or
    over a list."""
    if isinstance(fs, Field):
        return batch([fn(f) for f in unbatch(fs)])
    return [fn(f) for f in fs]
