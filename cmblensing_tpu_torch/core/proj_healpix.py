"""HEALPix fields and their projection to and from flat grids.

Counterpart of ``cmblensing_tpu/core/proj_healpix.py`` (reference
src/proj_healpix.jl): a HealpixField holds RING-scheme maps on a device;
`project` maps between the sphere and a ProjLambert patch or a
ProjEquiRect band, bilinearly or band-limited ('fft', the NUFFT), I and
QU, rotating the polarization angle between the two bases.

A Projector's precomputation (the pixels' coordinates in the other grid,
interpolation weights, polarization angles) is host numpy in float64,
done once for a pair of grids and kept, and its index and weight arrays go
to the flat grid's device once. It visits only the sphere's pixels that
can lie in the patch: the rings within the patch's angular reach of its
center and, on each, the arc within that reach (a band's rings whole), so
its cost follows the patch, not the sphere. What lies outside the patch
is zero and is not stored: `hpx_idxs_in_patch` lists the pixels in it, and
`is_`, `js_`, `psipol_ij` and the bilinear stencil are given for those
pixels only (the JAX package keeps `is_`, `js_` and `psipol_ij_full` for
every pixel of the sphere).

The sphere-to-grid steps are gathers. The grid-to-sphere step writes each
in-patch pixel once; the NUFFT's adjoint (the 'fft' sphere-to-grid solve)
scatter-adds, in an order the card does not fix.
"""
from __future__ import annotations

import numpy as np
import torch

from . import healpix_pix as hp
from .basis import Basis
from .field import Field
from .proj import ProjLambert, resolve_device
from .proj_equirect import EquiRectField, ProjEquiRect


class ProjHealpix:
    """HEALPix metadata: Nside (one instance per Nside)."""

    _cache = {}

    def __new__(cls, nside):
        nside = int(nside)
        if nside in cls._cache:
            return cls._cache[nside]
        self = super().__new__(cls)
        self.Nside = nside
        self.npix = 12 * nside * nside
        cls._cache[nside] = self
        return self

    def __repr__(self):
        return f"ProjHealpix(Nside={self.Nside})"

    def __hash__(self):
        return hash((ProjHealpix, self.Nside))

    def __eq__(self, other):
        return self is other


class HealpixField:
    """(ncomp, ..., npix) RING-scheme maps; pol 'I', 'QU' or 'IQU'."""

    __slots__ = ("arr", "pol", "proj")

    def __init__(self, arr, pol, proj):
        self.arr = arr
        self.pol = pol
        self.proj = proj

    @classmethod
    def from_map(cls, m, pol=None, device=None):
        """A field of the map(s) m ((npix,) or (ncomp, npix)) on `device`
        (the CUDA card unless named)."""
        m = torch.as_tensor(m, device=resolve_device(device))
        if m.ndim == 1:
            m = m[None]
        pol = pol or {1: "I", 2: "QU", 3: "IQU"}[m.shape[0]]
        return cls(m, pol, ProjHealpix(hp.npix2nside(m.shape[-1])))

    @property
    def device(self):
        return self.arr.device

    def __getitem__(self, k):
        comp = {"I": 0, "Q": {"QU": 0, "IQU": 1}, "U": {"QU": 1, "IQU": 2}}[k]
        if isinstance(comp, dict):
            comp = comp[self.pol]
        return HealpixField(self.arr[comp:comp + 1], "I", self.proj)

    def __repr__(self):
        return f"HealpixField({self.pol}, Nside={self.proj.Nside}, {self.arr.device})"


# --- coordinate maps --------------------------------------------------------

def _rot_zyx(rotator):
    """R = Rz(a) Ry(b) Rx(c), rotator in degrees."""
    a, b, c = np.deg2rad(rotator)

    def Rz(t):
        return np.array([[np.cos(t), -np.sin(t), 0], [np.sin(t), np.cos(t), 0], [0, 0, 1]])

    def Ry(t):
        return np.array([[np.cos(t), 0, np.sin(t)], [0, 1, 0], [-np.sin(t), 0, np.cos(t)]])

    def Rx(t):
        return np.array([[1, 0, 0], [0, np.cos(t), -np.sin(t)], [0, np.sin(t), np.cos(t)]])

    return Rz(a) @ Ry(b) @ Rx(c)


def _sph_to_cart(theta, phi):
    st = np.sin(theta)
    return np.stack([st * np.cos(phi), st * np.sin(phi), np.cos(theta)], axis=0)


def _cart_to_sph(v):
    x, y, z = v
    r = np.sqrt(x * x + y * y + z * z)
    return np.arccos(np.clip(z / r, -1, 1)), np.arctan2(y, x)


def ij_to_thetaphi(proj: ProjLambert, i, j):
    """(theta, phi) on the sphere of fractional, 1-based pixel indices of a
    Lambert patch."""
    dx = float(proj.deltax)
    x = dx * (np.asarray(j) - proj.Nx // 2 - 0.5)
    y = dx * (np.asarray(i) - proj.Ny // 2 - 0.5)
    r = np.sqrt(x ** 2 + y ** 2)
    theta = 2 * np.arccos(np.clip(r / 2, 0, 1))
    phi = np.arctan2(-x, -y)
    v = _sph_to_cart(theta, phi)
    vr = np.linalg.solve(_rot_zyx(proj.rotator), v.reshape(3, -1)).reshape(v.shape)
    return _cart_to_sph(vr)


def thetaphi_to_ij(proj: ProjLambert, theta, phi):
    """The inverse of ij_to_thetaphi."""
    v = _sph_to_cart(np.asarray(theta), np.asarray(phi))
    vr = (_rot_zyx(proj.rotator) @ v.reshape(3, -1)).reshape(v.shape)
    th, ph = _cart_to_sph(vr)
    r = 2 * np.cos(th / 2)
    x = -r * np.sin(ph)
    y = -r * np.cos(ph)
    dx = float(proj.deltax)
    return y / dx + proj.Ny // 2 + 0.5, x / dx + proj.Nx // 2 + 0.5


def ij_to_thetaphi_equirect(proj, i, j):
    """(theta, phi) of fractional, 1-based EquiRect pixel indices: affine,
    integer (i, j) exactly at (proj.theta[i-1], proj.phi[j-1]) (as the JAX
    package; the reference's map lies half a pixel off)."""
    dth = abs(proj.theta_span[1] - proj.theta_span[0])
    dph = abs(proj.phi_span[1] - proj.phi_span[0])
    theta = dth / proj.Ny * (np.asarray(i, np.float64) - 0.5) + proj.theta_span[0]
    phi = dph / proj.Nx * (np.asarray(j, np.float64) - 0.5) + proj.phi_span[0]
    return theta, phi


def thetaphi_to_ij_equirect(proj, theta, phi):
    """The inverse of ij_to_thetaphi_equirect; phi wraps mod 2 pi."""
    dth = abs(proj.theta_span[1] - proj.theta_span[0])
    dph = abs(proj.phi_span[1] - proj.phi_span[0])
    i = (np.asarray(theta, np.float64) - proj.theta_span[0]) / dth * proj.Ny + 0.5
    j = (np.mod(np.asarray(phi, np.float64) - proj.phi_span[0], 2 * np.pi) / dph * proj.Nx
         + 0.5)
    return i, j


def _ij2tp(proj, i, j):
    if isinstance(proj, ProjEquiRect):
        return ij_to_thetaphi_equirect(proj, i, j)
    return ij_to_thetaphi(proj, i, j)


def _tp2ij(proj, theta, phi):
    if isinstance(proj, ProjEquiRect):
        return thetaphi_to_ij_equirect(proj, theta, phi)
    return thetaphi_to_ij(proj, theta, phi)


def _psipol(proj, theta, phi):
    if isinstance(proj, ProjEquiRect):
        # the band's grid is the sphere's coordinate basis: no rotation
        return np.zeros(np.broadcast(np.asarray(theta), np.asarray(phi)).shape)
    return get_psipol(proj, theta, phi)


def get_psipol(proj: ProjLambert, theta, phi, eps=1e-6):
    """The rotation angle between the sphere's and the patch's coordinate
    bases, from the map's Jacobian by central differences."""
    theta = np.asarray(theta, dtype=np.float64)
    phi = np.asarray(phi, dtype=np.float64)
    i_t1, j_t1 = thetaphi_to_ij(proj, theta + eps, phi)
    i_t0, j_t0 = thetaphi_to_ij(proj, theta - eps, phi)
    i_p1, j_p1 = thetaphi_to_ij(proj, theta, phi + eps)
    i_p0, j_p0 = thetaphi_to_ij(proj, theta, phi - eps)
    J11 = (i_t1 - i_t0) / (2 * eps)   # di/dtheta
    J21 = (j_t1 - j_t0) / (2 * eps)   # dj/dtheta
    J12 = (i_p1 - i_p0) / (2 * eps)   # di/dphi
    J22 = (j_p1 - j_p0) / (2 * eps)   # dj/dphi
    return (np.arctan2(J11, J21) + np.arctan2(-J22, J12) - np.pi) / 2


# --- the sphere's pixels a patch can hold -----------------------------------

_REACH_MARGIN = 1e-6   # radians past the patch's reach that still count


def _ring_pixels(nside, rings, lo=None, count=None):
    """The pixels of `rings` (1-based ring indices): whole rings, or on each
    ring `count` pixels from index lo on (mod its length)."""
    _, npr, _, start = hp._ring_info(nside, rings)
    if lo is None:
        lo, count = np.zeros_like(npr), npr
    count = np.minimum(count, npr)
    ring_of = np.repeat(np.arange(len(rings)), count)
    k = np.arange(int(count.sum())) - np.repeat(np.cumsum(count) - count, count)
    return start[ring_of] + (lo[ring_of] + k) % npr[ring_of]


def _unit(theta, phi):
    return _sph_to_cart(np.asarray(theta, np.float64), np.asarray(phi, np.float64))


def _candidate_pixels(nside, proj):
    """Sorted pixel indices holding every pixel of the sphere that can lie
    in the patch (a superset): the rings within reach of the patch's
    center, and the arc of each within reach (a band: its rings whole)."""
    rings = np.arange(1, 4 * nside)
    z, npr, s, _ = hp._ring_info(nside, rings)
    th_r = np.arccos(z)
    if isinstance(proj, ProjEquiRect):
        lo_t, hi_t = min(proj.theta_span), max(proj.theta_span)
        keep = (th_r >= lo_t - _REACH_MARGIN) & (th_r <= hi_t + _REACH_MARGIN)
        return _ring_pixels(nside, rings[keep])
    # the Lambert map's angular distance from the center grows with the
    # radius in the plane, so the rectangle's corners bound the patch
    Ny, Nx = proj.Ny, proj.Nx
    th_c, ph_c = ij_to_thetaphi(proj, np.array([Ny // 2 + 0.5]), np.array([Nx // 2 + 0.5]))
    ci, cj = np.array([1.0, 1.0, Ny, Ny]), np.array([1.0, Nx, 1.0, Nx])
    vc = _unit(th_c, ph_c)[:, 0]
    reach = float(np.max(np.arccos(np.clip(vc @ _unit(*ij_to_thetaphi(proj, ci, cj)), -1, 1))))
    reach += _REACH_MARGIN
    th_c, ph_c = float(th_c[0]), float(ph_c[0])
    keep = np.abs(th_r - th_c) <= reach
    rings, z, npr, s, th_r = rings[keep], z[keep], npr[keep], s[keep], th_r[keep]
    # on ring theta_r: cos(dist) = cos t_r cos t_c + sin t_r sin t_c cos(dphi) >= cos(reach)
    den = np.sin(th_r) * np.sin(th_c)
    with np.errstate(divide="ignore", invalid="ignore"):
        q = np.where(den > 0, (np.cos(reach) - z * np.cos(th_c)) / den, -2.0)
    whole = q <= -1
    dphi = np.arccos(np.clip(q, -1, 1))
    # pixel j of a ring sits at phi = 2 pi (j + s) / npr; one pixel's slack each side
    lo = np.floor((ph_c - dphi) * npr / (2 * np.pi) - s).astype(np.int64) - 1
    hi = np.ceil((ph_c + dphi) * npr / (2 * np.pi) - s).astype(np.int64) + 1
    count = np.where(whole, npr, np.minimum(hi - lo + 1, npr))
    return np.unique(_ring_pixels(nside, rings, np.where(whole, 0, lo % npr), count))


# --- the Projector ----------------------------------------------------------

def _host_key(proj):
    if isinstance(proj, ProjEquiRect):
        return ("equirect", proj.Ny, proj.Nx, proj.theta_span, proj.phi_span, proj.T.str)
    return ("lambert", proj.Ny, proj.Nx, proj.thetapix, proj.rotator, proj.T.str)


_HOST = {}


def _host_arrays(nside, proj):
    """The Projector's host numpy arrays for (nside, the flat grid), made
    once."""
    key = (nside, _host_key(proj))
    if key in _HOST:
        return _HOST[key]
    Ny, Nx = proj.Ny, proj.Nx
    T = proj.T
    ii, jj = np.meshgrid(np.arange(1, Ny + 1), np.arange(1, Nx + 1), indexing="ij")
    ths, phs = _ij2tp(proj, ii, jj)
    idxs, wgts = hp.get_interp_weights(nside, ths.ravel(), phs.ravel())
    cand = _candidate_pixels(nside, proj)
    th_h, ph_h = hp.pix2ang_ring(nside, cand)
    is_, js_ = _tp2ij(proj, th_h, ph_h)
    inpatch = (is_ >= 1) & (is_ <= Ny) & (js_ >= 1) & (js_ <= Nx)
    sel, is_, js_ = cand[inpatch], is_[inpatch], js_[inpatch]
    # the bilinear stencil clamped inside the patch (0-based)
    i0 = np.clip(np.floor(is_ - 1), 0, Ny - 2).astype(np.int64)
    j0 = np.clip(np.floor(js_ - 1), 0, Nx - 2).astype(np.int64)
    out = dict(thetas=ths, phis=phs, psipol_thetaphi=_psipol(proj, ths, phs).astype(T),
               sph2cart_idx=idxs.astype(np.int64), sph2cart_w=wgts.astype(T),
               hpx_idxs_in_patch=sel.astype(np.int64), is_=is_, js_=js_,
               psipol_ij=_psipol(proj, th_h[inpatch], ph_h[inpatch]).astype(T),
               i0=i0, j0=j0, wi=np.clip((is_ - 1) - i0, 0, 1).astype(T),
               wj=np.clip((js_ - 1) - j0, 0, 1).astype(T))
    _HOST[key] = out
    return out


class Projector:
    """The precomputation of `project` between a ProjHealpix and a flat grid
    (ProjLambert or ProjEquiRect): host numpy arrays, and their tensors on
    the flat grid's device. One instance per pair."""

    _cache = {}

    def __new__(cls, hpx_proj: ProjHealpix, cart_proj):
        key = (hpx_proj.Nside, cart_proj)
        if key in cls._cache:
            return cls._cache[key]
        self = super().__new__(cls)
        self._init(hpx_proj, cart_proj)
        cls._cache[key] = self
        return self

    def _init(self, hpx_proj, cart_proj):
        self.hpx_proj = hpx_proj
        self.cart_proj = cart_proj
        host = _host_arrays(hpx_proj.Nside, cart_proj)
        for k, v in host.items():
            setattr(self, k, v)
        dev = cart_proj.device
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
        Nx = cart_proj.Nx
        self.sel = t(host["hpx_idxs_in_patch"])
        self.sph2cart = (t(host["sph2cart_idx"]), t(host["sph2cart_w"]))
        i0, j0 = host["i0"], host["j0"]
        self.cart2sph = (t(i0 * Nx + j0), t(host["wi"]), t(host["wj"]))
        self.psi_cart = t(host["psipol_thetaphi"])
        self.psi_sph = t(host["psipol_ij"])
        self.ys = t(host["is_"].astype(cart_proj.T))
        self.xs = t(host["js_"].astype(cart_proj.T))


# --- projection -------------------------------------------------------------

def _check_device(projector, arr):
    dev = torch.device(projector.cart_proj.device)
    if arr.device.type != dev.type or dev.index not in (None, arr.device.index):
        raise ValueError(f"a field on {arr.device} does not project to or from a grid on "
                         f"{projector.cart_proj.device}")


def _project_sph_to_cart_comp(projector, m):
    """One spin-0 healpix map (npix,) -> (Ny, Nx), bilinearly."""
    idx, w = projector.sph2cart
    return torch.sum(m[idx] * w, dim=0).reshape(projector.cart_proj.Ny, projector.cart_proj.Nx)


def _scatter_in_patch(projector, vals, like):
    out = torch.zeros(like.shape[:-2] + (projector.hpx_proj.npix,), dtype=vals.dtype,
                      device=vals.device)
    out[..., projector.sel] = vals
    return out


def _project_cart_to_sph_comp(projector, arr):
    """One spin-0 (..., Ny, Nx) map -> (..., npix), bilinearly at the
    in-patch pixels, zero elsewhere."""
    k00, wi, wj = projector.cart2sph
    Nx = projector.cart_proj.Nx
    flat = arr.reshape(arr.shape[:-2] + (-1,))
    g = lambda d: flat[..., k00 + d]
    vals = ((1 - wi) * (1 - wj) * g(0) + (1 - wi) * wj * g(1)
            + wi * (1 - wj) * g(Nx) + wi * wj * g(Nx + 1))
    return _scatter_in_patch(projector, vals, arr)


def _project_cart_to_sph_comp_fft(projector, arr):
    """The flat map's Fourier series (the NUFFT) at the in-patch pixels,
    zero elsewhere."""
    from ..ops.nufft import nufft_eval
    ys, xs = projector.ys.to(arr.dtype) - 1.0, projector.xs.to(arr.dtype) - 1.0
    return _scatter_in_patch(projector, nufft_eval(arr, ys, xs), arr)


def _project_sph_to_cart_comp_fft(projector, m, cg_iters=15):
    """The band-limited flat map whose Fourier series meets the in-patch
    healpix values: cg_iters fixed CG iterations on (A^T A + lam) x = A^T v,
    A the NUFFT at the in-patch pixels, lam = 1e-3 npts / (Ny Nx)."""
    from ..ops.nufft import nufft_adjoint, nufft_eval
    from ..ops.solvers import conjugate_gradient
    Ny, Nx = projector.cart_proj.Ny, projector.cart_proj.Nx
    ys, xs = projector.ys.to(m.dtype) - 1.0, projector.xs.to(m.dtype) - 1.0
    lam = 1e-3 * ys.shape[0] / (Ny * Nx)

    def AtA(x):
        return nufft_adjoint(nufft_eval(x, ys, xs), ys, xs, Ny, Nx) + lam * x

    b = nufft_adjoint(m[projector.sel], ys, xs, Ny, Nx)
    x, _ = conjugate_gradient(lambda r: r, AtA, b, nsteps=cg_iters, tol=0.0, fixed_iters=True)
    return x


def project(field, to, method="bilinear"):
    """A HealpixField projected to a flat grid (ProjLambert or ProjEquiRect),
    or a flat field (Field or EquiRectField) up to a ProjHealpix sphere,
    with the polarization angle rotated between the bases. method
    'bilinear' or 'fft' (band-limited, by the NUFFT). The fields stay on
    the flat grid's device, and the healpix maps must lie there too."""
    if method not in ("bilinear", "fft"):
        raise ValueError(f"method={method!r}: 'bilinear' or 'fft'")
    sph2cart = _project_sph_to_cart_comp if method == "bilinear" else _project_sph_to_cart_comp_fft
    cart2sph = _project_cart_to_sph_comp if method == "bilinear" else _project_cart_to_sph_comp_fft

    if isinstance(field, HealpixField) and isinstance(to, ProjEquiRect):
        projector = Projector(field.proj, to)
        _check_device(projector, field.arr)
        comps = [sph2cart(projector, field.arr[c]) for c in range(field.arr.shape[0])]
        if field.pol == "I":
            return EquiRectField(comps[0], "map", to)
        if field.pol == "QU":
            return EquiRectField(torch.stack(comps, dim=0), "qu_map", to)
        raise NotImplementedError("EquiRect fields hold I ('map') or QU ('qu_map'): "
                                  "project I and P apart for IQU")

    if isinstance(field, EquiRectField) and isinstance(to, ProjHealpix):
        projector = Projector(to, field.proj)
        if field.basis in ("map", "az"):
            fm = field.to("map")
            _check_device(projector, fm.arr)
            return HealpixField(cart2sph(projector, fm.arr)[None], "I", to)
        fm = field.to("qu_map")
        _check_device(projector, fm.arr)
        comps = [cart2sph(projector, fm.arr[..., c, :, :]) for c in range(2)]
        return HealpixField(torch.stack(comps, dim=0), "QU", to)

    if isinstance(field, HealpixField) and isinstance(to, ProjLambert):
        projector = Projector(field.proj, to)
        _check_device(projector, field.arr)
        comps = [sph2cart(projector, field.arr[c]) for c in range(field.arr.shape[0])]
        if field.pol == "I":
            return Field(torch.stack(comps, dim=0), Basis("I", "map"), to)
        off = 1 if field.pol == "IQU" else 0
        Q, U = comps[off], comps[off + 1]
        psi = projector.psi_cart
        c2, s2 = torch.cos(2 * psi), torch.sin(2 * psi)
        parts = ([comps[0]] if off else []) + [Q * c2 - U * s2, U * c2 + Q * s2]
        return Field(torch.stack(parts, dim=0), Basis(field.pol, "map"), to)

    if isinstance(field, Field) and isinstance(to, ProjHealpix):
        projector = Projector(to, field.proj)
        fm = field.to(field.basis.with_space("map"))
        pol = fm.basis.pol
        if pol in ("EB", "IEB"):
            fm = fm.to(fm.basis.with_pol("QU" if pol == "EB" else "IQU"))
            pol = fm.basis.pol
        _check_device(projector, fm.arr)
        comps = [cart2sph(projector, fm.arr[..., c, :, :]) for c in range(fm.arr.shape[-3])]
        if pol == "I":
            return HealpixField(torch.stack(comps, dim=0), "I", to)
        off = 1 if pol == "IQU" else 0
        Q, U = comps[off], comps[off + 1]
        psi = projector.psi_sph
        c2, s2 = torch.cos(2 * psi), torch.sin(2 * psi)
        sel = projector.sel
        Qf, Uf = torch.zeros_like(Q), torch.zeros_like(U)
        Qf[..., sel] = Q[..., sel] * c2 + U[..., sel] * s2
        Uf[..., sel] = U[..., sel] * c2 - Q[..., sel] * s2
        parts = ([comps[0]] if off else []) + [Qf, Uf]
        return HealpixField(torch.stack(parts, dim=0), pol, to)

    raise TypeError(f"can't project {type(field).__name__} -> {type(to).__name__}")
