"""Pencil FFTs over the spatial mesh dimension.

Counterpart of ``cmblensing_tpu/parallel/sharded_fft.py``: 2-D real FFTs,
and with them every Fourier-diagonal operator (covariances, beams,
transfer functions, bandpasses), on maps whose Ny axis is split over the
ranks of the mesh dimension "sp". Each rank holds its block; the scheme
is the classic 2-D pencil decomposition, one all_to_all a transpose:

  y-sharded map (..., Ny/P, Nx)
    --local rfft along x-->                   (..., Ny/P, Kx)  Kx = Nx/2+1
    --pad Kx to Kp (P | Kp), transpose-->      (..., Ny, Kp/P)  kx-sharded
    --local fft along y-->                    (..., Ny, Kp/P)  the pencil

and back. The padded kx columns are exact zeros through fft, multiply and
ifft, and are sliced off before the last irfft. A transpose packs its
(real view of the) block into one contiguous (P, ...) buffer and moves it
with one all_to_all_single (parallel/mesh.py); `_YToX` / `_XToY` are
torch.autograd.Functions whose backward is the inverse transpose, so
autograd runs through the pencil FFTs.

This rank's block: `rfft2_sharded` returns the kx columns
rank * Kp/P .. (rank + 1) * Kp/P of the padded half-spectrum, every ky;
`pad_multiplier` cuts a full (..., Ny, Kx) multiplier the same way.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.field import Field
from .mesh import all_reduce, all_to_all_single, axis_rank, axis_size


def _kp(Nx, p):
    kx = Nx // 2 + 1
    return ((kx + p - 1) // p) * p


# =========================================================================
# the transposes
# =========================================================================

def _as_real(x):
    """x as a real tensor whose last axis holds each element (a complex
    element as two floats), and the function that undoes it."""
    if x.is_complex():
        r = torch.view_as_real(x)
        return r.reshape(r.shape[:-2] + (2 * r.shape[-2],)), \
            lambda y: torch.view_as_complex(y.reshape(y.shape[:-1] + (y.shape[-1] // 2, 2)))
    return x, (lambda y: y)


def y_to_x(x, mesh, axis_name="sp"):
    """(..., R, C) rows of this rank, every column -> (..., P R, C / P)
    every row, this rank's columns (no autograd)."""
    P = axis_size(mesh, axis_name)
    if P == 1:
        return x
    a, back = _as_real(x)
    *lead, R, C = a.shape
    buf = a.reshape(*lead, R, P, C // P).movedim(-2, 0).contiguous()
    out = all_to_all_single(buf, mesh, axis_name)
    return back(out.movedim(0, -3).reshape(*lead, P * R, C // P))


def x_to_y(x, mesh, axis_name="sp"):
    """The inverse of `y_to_x`: (..., N, c) every row, this rank's
    columns -> (..., N / P, P c) this rank's rows, every column."""
    P = axis_size(mesh, axis_name)
    if P == 1:
        return x
    a, back = _as_real(x)
    *lead, N, c = a.shape
    buf = a.reshape(*lead, P, N // P, c).movedim(-3, 0).contiguous()
    out = all_to_all_single(buf, mesh, axis_name)
    return back(out.movedim(0, -2).reshape(*lead, N // P, P * c))


class _YToX(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis_name):
        ctx.mesh, ctx.axis_name = mesh, axis_name
        return y_to_x(x, mesh, axis_name)

    @staticmethod
    def backward(ctx, g):
        return x_to_y(g.contiguous(), ctx.mesh, ctx.axis_name), None, None


class _XToY(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis_name):
        ctx.mesh, ctx.axis_name = mesh, axis_name
        return x_to_y(x, mesh, axis_name)

    @staticmethod
    def backward(ctx, g):
        return y_to_x(g.contiguous(), ctx.mesh, ctx.axis_name), None, None


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks of a dimension of each rank's part, a value
    every rank holds; its gradient reaches each rank's part once
    (identity backward), as the gradient of a total that is counted
    once."""

    @staticmethod
    def forward(ctx, x, mesh, axis_name):
        return all_reduce(x, mesh, axis_name, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def psum(x, mesh, axis_name="sp"):
    """Each rank's part summed over the dimension (differentiable)."""
    if axis_size(mesh, axis_name) == 1:
        return x
    return _AllReduceSum.apply(x, mesh, axis_name)


# =========================================================================
# public API
# =========================================================================

def rfft2_sharded(arr, mesh, axis_name="sp", batch_axis=None):
    """Unnormalized rfft2 of a y-sharded real block (..., Ny/P, Nx); returns
    this rank's kx columns of the pencil (..., Ny, Kp/P), Kp = Nx/2+1
    padded to a multiple of P (exact zeros). batch_axis is accepted for
    the JAX package's signature: a batch split over a 2-D mesh is this
    rank's entries already."""
    p = axis_size(mesh, axis_name)
    Nx = arr.shape[-1]
    X = torch.fft.rfft(arr, dim=-1)
    pad = _kp(Nx, p) - X.shape[-1]
    if pad:
        X = torch.cat([X, X.new_zeros(X.shape[:-1] + (pad,))], dim=-1)
    if p > 1:
        X = _YToX.apply(X.contiguous(), mesh, axis_name)
    return torch.fft.fft(X, dim=-2)


def irfft2_sharded(X, Nx, mesh, axis_name="sp", batch_axis=None):
    """The inverse of `rfft2_sharded`, normalized (1/(Ny Nx), ifft's 1/Ny
    and irfft's 1/Nx): this rank's rows of the real map (..., Ny/P, Nx)."""
    x = torch.fft.ifft(X, dim=-2)
    if axis_size(mesh, axis_name) > 1:
        x = _XToY.apply(x.contiguous(), mesh, axis_name)
    return torch.fft.irfft(x[..., :Nx // 2 + 1], n=Nx, dim=-1)


def pad_multiplier(mult, mesh, axis_name="sp", device=None):
    """A full (..., Ny, Kx) Fourier multiplier padded along kx to Kp and
    cut to this rank's pencil columns (..., Ny, Kp/P), ready to multiply
    `rfft2_sharded` outputs; on `device` (mult's, or the mesh's)."""
    p, r = axis_size(mesh, axis_name), axis_rank(mesh, axis_name)
    m = torch.as_tensor(mult) if not isinstance(mult, np.ndarray) else torch.from_numpy(
        np.ascontiguousarray(mult))
    if device is None:
        device = m.device if isinstance(mult, torch.Tensor) else mesh.device_type
    kx = m.shape[-1]
    kp = ((kx + p - 1) // p) * p
    if kp > kx:
        m = torch.cat([m, m.new_zeros(m.shape[:-1] + (kp - kx,))], dim=-1)
    w = kp // p
    return m[..., r * w:(r + 1) * w].contiguous().to(device)


def fourier_diag_apply_sharded(mult_padded, f: Field, mesh, axis_name="sp",
                               batch_axis=None) -> Field:
    """A Fourier-diagonal operator (beam, covariance, bandpass...) applied
    to a y-sharded map-basis Field: pencil rfft2, the local multiply,
    pencil irfft2. The multiplier comes from `pad_multiplier`."""
    arr = f.arr
    X = rfft2_sharded(arr, mesh, axis_name, batch_axis)
    out = irfft2_sharded(X * mult_padded, arr.shape[-1], mesh, axis_name, batch_axis)
    return Field(out, f.basis, f.proj)


def get_Cl_sharded(f1: Field, mesh, f2: Field = None, dl=50, ledges=None, Clfid=None,
                   axis_name="sp", batch_axis=None):
    """The binned (cross-)power spectrum of a y-sharded spin-0 map-basis
    Field (utils/spectra.py::get_Cl's weights and normalization): each
    rank bins its pencil columns' power, and the bin sums are one
    all_reduce; only the bins leave the ranks. A batched field gives the
    first entry's spectrum, as get_Cl does. Returns Cls on every rank."""
    from ..utils.cls import Cls

    if f2 is None:
        f2 = f1
    if f1.basis.ncomp > 1:
        raise ValueError("index components first, e.g. get_Cl_sharded(f['E'], mesh)")
    proj = f1.proj
    if ledges is None:
        ledges = np.arange(0, 16001, dl)
    ledges = np.asarray(ledges, dtype=np.float64)

    # host: the l grid, full-plane inverse-variance weights (lam the rfft
    # degeneracy), bin ids, the data-independent bin sums
    L = np.asarray(proj.lmag, np.float64)
    lam = np.broadcast_to(np.asarray(proj.lam_rfft, np.float64)[None, :], L.shape)
    mask = (L > ledges.min()) & (L < ledges.max())
    with np.errstate(divide="ignore", invalid="ignore"):
        if Clfid is None:
            w = (2 * 1.0 ** 2 / (2 * L + 1)) ** -1
        else:
            w = (2 * np.asarray(Clfid(L), np.float64) ** 2 / (2 * L + 1)) ** -1
    w = np.nan_to_num(w) * lam * mask
    nbins = len(ledges) - 1
    ids = np.clip(np.digitize(L, ledges) - 1, 0, nbins - 1)
    ids = np.where(mask, ids, nbins)                     # the dump bin
    A = np.bincount(ids.ravel(), weights=w.ravel(), minlength=nbins + 1)[:nbins]
    lb = np.bincount(ids.ravel(), weights=(w * L).ravel(), minlength=nbins + 1)[:nbins]
    alpha = proj.Nx * proj.Ny / float(proj.deltax) ** 2
    # the device sums run in float32: weights scaled by their largest
    wscale = float(np.max(w)) or 1.0
    dev = f1.arr.device
    wl = pad_multiplier((w / (alpha * wscale)).astype(np.float32), mesh, axis_name, dev)
    il = pad_multiplier(ids.astype(np.int64) - nbins, mesh, axis_name, dev) + nbins

    X1 = rfft2_sharded(f1.arr, mesh, axis_name, batch_axis)[..., 0, :, :]
    X2 = X1 if f2 is f1 else rfft2_sharded(f2.arr, mesh, axis_name, batch_axis)[..., 0, :, :]
    if X1.ndim > 2:
        X1 = X1.reshape((-1,) + X1.shape[-2:])[0]
        X2 = X2.reshape((-1,) + X2.shape[-2:])[0]
    pw = wl * torch.real(torch.conj(X1) * X2)
    seg = torch.zeros(nbins + 1, dtype=pw.dtype, device=dev).index_add_(0, il.reshape(-1),
                                                                        pw.reshape(-1))
    Clb = all_reduce(seg, mesh, axis_name).cpu().numpy().astype(np.float64)[:nbins] * wscale
    with np.errstate(invalid="ignore", divide="ignore"):
        return Cls(lb / A, Clb / A)
