"""The Wiener filter, joint MAP and Gibbs/HMC sampler on sharded maps.

Counterpart of ``cmblensing_tpu/parallel/sharded_wf.py``. Composes the
pencil FFTs (parallel/sharded_fft.py) and the sharded LenseFlow
(parallel/spatial.py) into the posterior's solves and steps on maps whose
Ny axis is split over the ranks of the mesh dimension "sp":

    (Cf^-1 + L^H (MB)^H Cn^-1 (MB) L) f  =  L^H (MB)^H Cn^-1 d

with the covariance, beam and transfer applies EB-Fourier-diagonal
multiplies in the pencil layout (the QU <-> EB rotation is elementwise
there), a pixel mask a local multiply, the lensing the sharded flow, and
every inner product a local sum and one all_reduce. No rank holds a
whole map on the way.

Arguments: a dataset `ds` holds its data whole (the same on every rank,
as a host array is in the JAX package); fields passed in (phi, f,
fstart) may be whole or this rank's y-sharded block (`_local` tells them
apart by their rows), and fields come back as this rank's blocks
(parallel/spatial.py::gather_spatial assembles them). Randomness comes
from one torch.Generator in the same state on every rank: the draws are
made whole, as the unsharded port makes them, and sharded.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..core.basis import Basis
from ..core.field import Field
from ..core.ops import Diag, LazyOp, _Identity, evaluate_at, logdet, logdet_rel, simulate_op
from ..ops.solvers import conjugate_gradient
from .mesh import BatchSharding, axis_rank, axis_size, batch_shard
from .sharded_fft import (fourier_diag_apply_sharded, irfft2_sharded, pad_multiplier, psum,
                          rfft2_sharded)
from .spatial import ShardedLenseFlow, gather_spatial

QU_MAP = Basis("QU", "map")
I_MAP = Basis("I", "map")


def _safe_inv(x):
    return torch.where(x > 0, 1.0 / torch.where(x > 0, x, torch.ones_like(x)),
                       torch.zeros_like(x))


def _local(f: Field, mesh, axis_name, batch_axis=None, nb=None):
    """This rank's block of f: as it is when its rows are this rank's
    already, else its rows (and batch entries over batch_axis, when f
    carries the whole batch of nb)."""
    P = axis_size(mesh, axis_name)
    arr = f.arr
    if P > 1 and arr.shape[-2] == f.proj.Ny:
        k, r = f.proj.Ny // P, axis_rank(mesh, axis_name)
        arr = arr[..., r * k:(r + 1) * k, :]
    if (batch_axis is not None and nb and arr.ndim >= 4 and arr.shape[0] == nb
            and axis_size(mesh, batch_axis) > 1):
        arr = arr[BatchSharding(mesh, batch_axis).slice(nb)]
    return Field(arr.contiguous(), f.basis, f.proj)


def _nb(ds):
    d = ds.d
    return d.batch_shape[0] if isinstance(d, Field) and d.batch_shape else None


class Pencil:
    """The pencil Fourier side of y-sharded maps on proj's grid: the E/B
    (or spin-0) spectra of map blocks (this rank's kx columns, every ky),
    the way back, and inner products summed over the modes with the rfft
    weights, Parseval's: sum_x a b = sum_k lam_k Re(conj(A_k) B_k) / (Ny Nx)
    (the unsharded Field dot's). The posterior's quadratic forms are taken
    there, as the unsharded port takes them on Fourier-basis fields: a
    covariance whose inverse spans decades (Cf^-1, and D^-1 before it) is
    applied to the spectrum and summed without a trip through the map,
    whose float32 rounding at the largest scale would reach every mode."""

    def __init__(self, proj, mesh, axis_name="sp", batch_axis=None):
        self.proj, self.mesh, self.axis_name, self.batch_axis = proj, mesh, axis_name, batch_axis
        pad = lambda g: pad_multiplier(g, mesh, axis_name, proj.device)
        self.c2, self.s2 = pad(proj.tensor("cos2phi")), pad(proj.tensor("sin2phi"))
        self.lam = pad(proj.tensor("lam_rfft").expand(proj.Ny, -1) / (proj.Ny * proj.Nx))

    def pad(self, grid):
        return pad_multiplier(grid, self.mesh, self.axis_name, grid.device)

    def spectrum(self, arr):
        return rfft2_sharded(arr, self.mesh, self.axis_name, self.batch_axis)

    def eb(self, arr_qu):
        """(..., 2, Ny, Kp/P): E and B of a QU map block."""
        X = self.spectrum(arr_qu)
        Ql, Ul = X[..., 0, :, :], X[..., 1, :, :]
        return torch.stack([-Ql * self.c2 - Ul * self.s2, Ql * self.s2 - Ul * self.c2], dim=-3)

    def qu(self, EB):
        """The QU map block of E and B spectra."""
        El, Bl = EB[..., 0, :, :], EB[..., 1, :, :]
        out = torch.stack([-El * self.c2 + Bl * self.s2, -El * self.s2 - Bl * self.c2], dim=-3)
        return irfft2_sharded(out, self.proj.Nx, self.mesh, self.axis_name, self.batch_axis)

    def dot(self, A, B, w=None):
        """sum_k lam_k w_k Re(conj(A_k) B_k) / (Ny Nx) over the modes and
        the components, one value a batch entry, summed over the ranks
        (differentiable)."""
        v = (A.real * B.real + A.imag * B.imag) * self.lam
        if w is not None:
            v = v * w
        return psum(torch.sum(v, dim=(-3, -2, -1)), self.mesh, self.axis_name)


class ShardedEBDiag:
    """An EB-Fourier-diagonal operator on y-sharded QU maps: pencil rfft2,
    the QU -> EB rotation (elementwise in the pencil layout), the per-mode
    multiply, EB -> QU, pencil irfft2. The rotation is orthogonal and the
    padded kx columns stay zero."""

    def __init__(self, mult_eb, proj, mesh, axis_name="sp", batch_axis=None):
        self.pencil = Pencil(proj, mesh, axis_name, batch_axis)
        self.m = self.pencil.pad(mult_eb)

    def __call__(self, arr_qu):
        return self.pencil.qu(self.m * self.pencil.eb(arr_qu))


def _eb_diag_grids(op, name):
    """The real (2, Ny, Kx) EB-Fourier diagonal of a Diag operator."""
    if not isinstance(op, Diag):
        raise NotImplementedError(f"the sharded solve needs {name} to be a (EB-)Fourier Diag "
                                  f"operator; got {type(op).__name__}")
    d = op.diag
    if not d.basis.is_fourier:
        raise NotImplementedError(f"{name} must be Fourier-diagonal")
    arr = torch.real(d.arr) if d.arr.is_complex() else d.arr
    if arr.shape[-3] == 1:
        arr = torch.cat([arr, arr], dim=-3)
    return arr


def _fid(op):
    from ..inference.maximization import _fid as fid
    return fid(op)


def _split_M(op):
    """ds.M as (EB-Fourier grids, pixel-mask map or None): load_sim builds
    a masked dataset's M as LazyOp('*', Mfourier, Mpix); the pixel leg is a
    local multiply on y-sharded maps."""
    if isinstance(op, LazyOp) and op.kind == "*":
        fourX = isinstance(op.X, Diag) and op.X.diag.basis.is_fourier
        pixY = isinstance(op.Y, Diag) and op.Y.diag.basis.is_map
        if fourX and pixY:
            return _eb_diag_grids(op.X, "M"), op.Y.diag
        pixX = isinstance(op.X, Diag) and op.X.diag.basis.is_map
        fourY = isinstance(op.Y, Diag) and op.Y.diag.basis.is_fourier
        if pixX and fourY:
            raise NotImplementedError(
                "sharded solve supports M = Mfourier * Mpix (mask applied innermost, as load_sim "
                "builds); got the mask as the OUTER leg, which is a different operator")
    return _eb_diag_grids(op, "M"), None


def _mask_local(mask, mesh, axis_name):
    """A whole pixel-mask Field's block of rows, as a (…, 1, Ny/P, Nx)
    tensor broadcasting against QU blocks."""
    return None if mask is None else _local(mask, mesh, axis_name).arr


# =========================================================================
# the Wiener filter
# =========================================================================

def sharded_wiener_filter(ds, phi: Field, mesh, axis_name="sp", batch_axis=None, theta=None,
                          d=None, nsteps=100, tol=1e-8, nsteps_flow=7, fstart=None,
                          fixed_iters=False):
    """argmaxf_logpdf on sharded maps (`_wiener_filter_eb`): returns (this
    rank's block of f in the QU map basis, info)."""
    x, info = _wiener_filter_eb(ds, phi, mesh, axis_name, batch_axis, theta, d, nsteps, tol,
                                nsteps_flow, fstart, fixed_iters)
    return Field(x.pencil.qu(x.eb), QU_MAP, phi.proj), info


class _Spectra:
    """f's E/B spectra on this rank's pencil columns, as the sharded solves
    hand them on (a map block's roundtrip through float32 FFTs would put
    noise at the largest scale's amplitude into the modes where D^-1 Cf
    is tiny, and D amplifies them by up to 1e5)."""

    __slots__ = ("eb", "pencil")

    def __init__(self, eb, pencil):
        self.eb, self.pencil = eb, pencil


def _wiener_filter_eb(ds, phi: Field, mesh, axis_name="sp", batch_axis=None, theta=None,
                      d=None, nsteps=100, tol=1e-8, nsteps_flow=7, fstart=None,
                      fixed_iters=False):
    """The lensed Wiener filter of ds at fixed phi on sharded maps, every
    iterate this rank's pencil columns of f's spectra. ds's Cf, Cn and B
    must be Fourier-diagonal; M may carry a pixel-mask leg (load_sim's
    LazyOp('*', Mfourier, Mpix)), applied as a local multiply. d (ds.d
    unless given) and phi may be whole or this rank's blocks. The CG is
    preconditioned as the unsharded solve is, by the Fourier-diagonal
    (Cf^-1 + B_hat' M_hat' Cn_hat^-1 M_hat B_hat)^-1 per EB mode, and runs
    where the unsharded solve runs, on f's E/B spectra (this rank's pencil
    columns): the prior term Cf^-1 f, whose grid spans decades, is a
    multiply there, where a map's float32 rounding at the largest scale
    would reach every mode. Its dot products are the pencil's (all_reduces),
    its stop test read on the host once an iteration as the unsharded
    solve reads it (never with fixed_iters). fstart: f's spectra
    (`_Spectra`) or a map. Returns (f's spectra, `_Spectra`, and info)."""
    from ..inference.maximization import hessian_f_preconditioner

    proj = phi.proj
    if theta:
        ds = ds.at(theta)
    nb = _nb(ds)
    Cf = _eb_diag_grids(_fid(ds.Cf), "Cf")
    Cn = _eb_diag_grids(ds.Cn, "Cn")
    Bm = _eb_diag_grids(_fid(ds.B), "B")
    Mm, mask = _split_M(_fid(ds.M))
    MB = Mm * Bm
    iCn = _safe_inv(Cn)
    pencil = Pencil(proj, mesh, axis_name, batch_axis)
    # the unsharded solve's preconditioner, mode by mode (modes where both
    # terms vanish get 0: they are absent from b too)
    prec = pencil.pad(_safe_inv(_eb_diag_grids(hessian_f_preconditioner(ds), "prec")))
    iCf = pencil.pad(_safe_inv(Cf))
    if d is None:
        d = ds.d
    d_sh = _local(d.to(QU_MAP), mesh, axis_name, batch_axis, nb).arr
    phi_sh = _local(phi.to(phi.basis.with_space("map")), mesh, axis_name, batch_axis, nb)
    L = ShardedLenseFlow(phi_sh, nsteps=nsteps_flow, mesh=mesh, axis_name=axis_name,
                         batch_axis=batch_axis)
    mask = _mask_local(mask, mesh, axis_name)
    if mask is None:
        # one EB-diag multiply a likelihood term
        nl, bd = pencil.pad(MB * iCn * MB), pencil.pad(MB * iCn)
        NL = lambda y: pencil.qu(nl * pencil.eb(y))
        bterm = lambda dd: pencil.qu(bd * pencil.eb(dd))
    else:
        # B^T mask (Mf^2 Cn^-1) mask B, and B^T mask (Mf Cn^-1) d
        b_, mf2 = pencil.pad(Bm), pencil.pad(Mm * Mm * iCn)
        mfi = pencil.pad(Mm * iCn)
        NL = lambda y: pencil.qu(b_ * pencil.eb(mask * pencil.qu(
            mf2 * pencil.eb(mask * pencil.qu(b_ * pencil.eb(y))))))
        bterm = lambda dd: pencil.qu(b_ * pencil.eb(mask * pencil.qu(mfi * pencil.eb(dd))))

    def A(X):
        La = (L @ Field(pencil.qu(X), QU_MAP, proj)).arr
        return iCf * X + pencil.eb((L.H @ Field(NL(La), QU_MAP, proj)).arr)

    if fstart is None or isinstance(fstart, _Spectra):
        x0 = None if fstart is None else fstart.eb
    else:
        x0 = pencil.eb(_local(fstart.to(QU_MAP), mesh, axis_name, batch_axis, nb).arr)
    shard = batch_shard(mesh, nb, batch_axis) if batch_axis is not None and nb else None
    with torch.no_grad():
        b = pencil.eb((L.H @ Field(bterm(d_sh), QU_MAP, proj)).arr)
        x, info = conjugate_gradient(lambda r: prec * r, A, b, x0=x0, nsteps=int(nsteps),
                                     tol=float(tol), fixed_iters=fixed_iters, dot=pencil.dot,
                                     shard=shard)
    return _Spectra(x, pencil), info


# =========================================================================
# the posterior on sharded maps
# =========================================================================

def _lensing_quadforms(ds, mesh, axis_name, batch_axis):
    """What the sharded logpdf and MAP evaluate ds with: its pencil, the
    padded inverse-covariance grids of f (EB), phi and the noise (EB), the
    response x -> M B x as E/B spectra (`fwd_eb`) and as a map (`MB`; a
    pixel mask a local multiply), the data's E/B spectra."""
    if getattr(ds, "logprior", None) is not None:
        raise NotImplementedError(
            "sharded logpdf/MAP/HMC do not evaluate ds.logprior (it may depend on f/phi); drop "
            "it or use the single-device path")
    Cf = _eb_diag_grids(_fid(ds.Cf), "Cf")
    Cn = _eb_diag_grids(ds.Cn, "Cn")
    Bm = _eb_diag_grids(_fid(ds.B), "B")
    Mm, mask = _split_M(_fid(ds.M))
    proj = _fid(ds.Cf).diag.proj
    pencil = Pencil(proj, mesh, axis_name, batch_axis)
    mk = lambda g: ShardedEBDiag(g, proj, mesh, axis_name, batch_axis)
    if mask is None:
        mb = pencil.pad(Mm * Bm)
        fwd_eb = lambda x: mb * pencil.eb(x)
        fwd = mk(Mm * Bm)
    else:
        op_B, op_Mf, mf = mk(Bm), mk(Mm), pencil.pad(Mm)
        mask_sh = _mask_local(mask, mesh, axis_name)
        fwd_eb = lambda x: mf * pencil.eb(mask_sh * op_B(x))
        fwd = lambda x: op_Mf(mask_sh * op_B(x))
    d_sh = _local(ds.d.to(QU_MAP), mesh, axis_name, batch_axis, _nb(ds)).arr
    return dict(pencil=pencil, iCf=pencil.pad(_safe_inv(Cf)), iCn=pencil.pad(_safe_inv(Cn)),
                iCphi=pencil.pad(_safe_inv(_pdiag(_fid(ds.Cphi)))), fwd_eb=fwd_eb, MB=fwd,
                d_sh=d_sh, d_eb=pencil.eb(d_sh), proj=proj)


def _pdiag(op):
    """The real (…, Ny, Kx) Fourier diagonal of a phi-space operator (G,
    Cphi); None for the identity."""
    if op is None or isinstance(op, _Identity):
        return None
    a = op.diag.arr
    return torch.real(a) if a.is_complex() else a


def sharded_lensing_logpdf(ds, f: Field, phi: Field, mesh, axis_name="sp", batch_axis=None,
                           nsteps_flow=7, _ops=None):
    """The (f, phi) posterior density on y-sharded maps: ds.logpdf(f=f,
    phi=phi) up to its (f, phi)-independent logdet constants, one value a
    batch entry, its quadratic forms summed over the pencil's modes and
    the ranks (Pencil; differentiable)."""
    ops = _ops or _lensing_quadforms(ds, mesh, axis_name, batch_axis)
    pencil = ops["pencil"]
    nb = _nb(ds)
    f = _local(f.to(QU_MAP), mesh, axis_name, batch_axis, nb)
    phi = _local(phi, mesh, axis_name, batch_axis, nb)
    L = ShardedLenseFlow(phi, nsteps=nsteps_flow, mesh=mesh, axis_name=axis_name,
                         batch_axis=batch_axis)
    R = ops["d_eb"] - ops["fwd_eb"]((L @ f).arr)
    F, P = pencil.eb(f.arr), pencil.spectrum(phi.arr)
    return -0.5 * (pencil.dot(R, R, ops["iCn"]) + pencil.dot(F, F, ops["iCf"])
                   + pencil.dot(P, P, ops["iCphi"]))


class ShardedMixedCtx:
    """The appliers of the mixed parametrization (f°, phi°) = (L(phi) D f,
    G phi) with G = Id (MAP_joint pins G = Id: the MAP does not depend on
    it) on y-sharded maps: mix, unmix and Mixed.logpdf with its logdet
    constants, the quadratic forms on the pencil's spectra (Pencil). ds
    must be evaluated at theta already (ds.at(theta))."""

    def __init__(self, ds, mesh, axis_name="sp", batch_axis=None, nsteps_flow=7):
        if not isinstance(ds.G, _Identity):
            raise NotImplementedError("sharded mixed parametrization supports G = Id only "
                                      "(MAP_joint itself pins G=Id; replace(G=Id) first)")
        self.mesh, self.axis_name = mesh, axis_name
        self.batch_axis, self.nsteps_flow = batch_axis, nsteps_flow
        self.ops = _lensing_quadforms(ds, mesh, axis_name, batch_axis)
        self.proj, self.pencil, self.d_sh = self.ops["proj"], self.ops["pencil"], self.ops["d_sh"]
        Dop = _fid(ds.D)
        if isinstance(Dop, _Identity):
            self.D = self.Dinv = None
        else:
            Dg = _eb_diag_grids(Dop, "D")
            self.D, self.Dinv = self.pencil.pad(Dg), self.pencil.pad(_safe_inv(Dg))
        # the MvNormal normalizations of ds.logpdf (D and G at the fiducial)
        self.logdet_const = -0.5 * (logdet(_fid(ds.Cf)) + logdet(_fid(ds.Cphi)) + logdet(ds.Cn))

    def flow(self, phi):
        return ShardedLenseFlow(phi, nsteps=self.nsteps_flow, mesh=self.mesh,
                                axis_name=self.axis_name, batch_axis=self.batch_axis)

    def mix(self, f, phi):
        """(f°, phi°) of f (a QU map block, or its `_Spectra`) and phi."""
        F = f.eb if isinstance(f, _Spectra) else self.pencil.eb(f.arr)
        FD = self.D * F if self.D is not None else F
        return self.flow(phi) @ Field(self.pencil.qu(FD), QU_MAP, self.proj), phi

    def _unmix_eb(self, f_mix, phi_mix):
        """f's E/B spectra at (f°, phi°)."""
        Y = self.pencil.eb(self.flow(phi_mix).solve(f_mix).arr)
        return self.Dinv * Y if self.Dinv is not None else Y

    def unmix(self, f_mix, phi_mix):
        return Field(self.pencil.qu(self._unmix_eb(f_mix, phi_mix)), QU_MAP, self.proj), phi_mix

    def gaussian_residuals(self, f_mix, phi_mix):
        """The (Z_i, Sigma_i^-1 grid) pairs of the mixed posterior's
        Gaussian terms: the spectra of f, phi and the data residual."""
        F = self._unmix_eb(f_mix, phi_mix)
        ft = self.flow(phi_mix) @ Field(self.pencil.qu(F), QU_MAP, self.proj)
        R = self.ops["d_eb"] - self.ops["fwd_eb"](ft.arr)
        return [(F, self.ops["iCf"]), (self.pencil.spectrum(phi_mix.arr), self.ops["iCphi"]),
                (R, self.ops["iCn"])]

    def mixed_logpdf(self, f_mix, phi_mix):
        """Mixed(ds).logpdf on sharded maps, its logdet normalizations
        included, one value a batch entry."""
        quads = [self.pencil.dot(z, z, w) for z, w in self.gaussian_residuals(f_mix, phi_mix)]
        return -0.5 * sum(quads) + self.logdet_const


def _sharded_grid_linesearch(ctx: ShardedMixedCtx, f_mix, phi_mix, dphi, amax, ngrid):
    """MAP_joint's grid line search on sharded maps: the steps^1.5 grid,
    the cancellation-free objective lp(a) - lp(0) = -1/2 sum_i <z_i(a) -
    z_i(0), Sigma_i^-1 (z_i(a) + z_i(0))>, one trial after another, the
    argmax per batch entry with alpha = 0 as the self-guard. Returns
    (alpha, its dlp)."""
    rdt, dev = phi_mix.arr.dtype, phi_mix.arr.device
    steps = (torch.arange(1, ngrid + 1, dtype=rdt, device=dev) / ngrid) ** 1.5
    amax = torch.as_tensor(amax, dtype=rdt, device=dev)
    alphas = amax * steps if amax.ndim == 0 else steps[:, None] * amax[None, :]
    bc = lambda a: a if a.ndim == 0 else a.reshape(a.shape + (1,) * (phi_mix.arr.ndim - a.ndim))
    res0 = ctx.gaussian_residuals(f_mix, phi_mix)
    dlps = []
    for alpha in alphas:
        pm = Field(phi_mix.arr + bc(alpha) * dphi.arr, phi_mix.basis, phi_mix.proj)
        total = 0.0
        for (za, w), (z0, _) in zip(ctx.gaussian_residuals(f_mix, pm), res0):
            total = total - 0.5 * ctx.pencil.dot(za - z0, za + z0, w)
        dlps.append(torch.as_tensor(total, dtype=rdt, device=dev))
    dlps = torch.stack(dlps)
    alphas = torch.cat([torch.zeros_like(alphas[:1]), alphas])
    dlps = torch.cat([torch.zeros_like(dlps[:1]), dlps])
    dlps = torch.where(torch.isfinite(dlps), dlps, torch.full_like(dlps, -float("inf")))
    i = torch.argmax(dlps, dim=0)
    sel = alphas[i] if alphas.ndim == 1 else torch.gather(alphas, 0, i[None])[0]
    return sel, torch.max(dlps, dim=0).values


def sharded_MAP_joint(ds, mesh, axis_name="sp", batch_axis=None, theta=None, nsteps=10,
                      cg_nsteps=500, cg_tol=1e-1, nsteps_flow=7, ngrid=16, alpha_max=None,
                      phistart=None, fstart=None, progress=False, cg_fixed_iters=False):
    """The joint MAP of (f, phi) on sharded maps: MAP_joint's coordinate
    ascent (the Wiener-filter f-step, warm-started, alternating with an
    Hpre-preconditioned gradient step in the mixed parametrization with G =
    Id, the grid line search and the adaptive alpha_max). Batched data
    (on a 2-D mesh, batch_axis): each entry its own phi, alpha and amax.
    Returns dict(f=, phi= (this rank's blocks), history=[{logpdf, alpha,
    cg_iters}]), logpdf the whole mixed logpdf per batch entry."""
    from ..core.field import repeat_batch
    from ..core.ops import Id
    from ..inference.maximization import hessian_phimix_preconditioner

    dstheta = ds.at(theta or {}).replace(G=Id)
    ctx = ShardedMixedCtx(dstheta, mesh, axis_name, batch_axis, nsteps_flow)
    proj = ctx.proj
    if getattr(dstheta, "Nphi", None) is not None:
        hinv = _safe_inv(_pdiag(hessian_phimix_preconditioner(dstheta)))
    else:
        hinv = _pdiag(_fid(dstheta.Cphi))
    hpre = pad_multiplier(hinv, mesh, axis_name)

    nb_total = _nb(dstheta)
    if phistart is not None:
        phi = _local(phistart.to(I_MAP), mesh, axis_name, batch_axis, nb_total)
    else:
        nloc = ctx.d_sh.shape[:-3]
        phi = Field(torch.zeros(nloc + (1,) + ctx.d_sh.shape[-2:], dtype=ctx.d_sh.dtype,
                                device=ctx.d_sh.device), I_MAP, proj)
    nb = ctx.d_sh.shape[:-3]
    if nb and not phi.batch_shape:
        phi = repeat_batch(phi, nb[0])

    def grad_and_mix(f, phi):
        with torch.no_grad():
            f_mix, phi_mix = ctx.mix(f, phi)
        pm = phi_mix.arr.detach().requires_grad_(True)
        with torch.enable_grad():
            lp = torch.sum(ctx.mixed_logpdf(f_mix, Field(pm, I_MAP, proj)))
            (g,) = torch.autograd.grad(lp, pm)
        dphi = fourier_diag_apply_sharded(hpre, Field(g, I_MAP, proj), mesh, axis_name,
                                          batch_axis)
        return f_mix, Field(pm.detach(), I_MAP, proj), dphi

    history = []
    f = fstart
    dev = ctx.d_sh.device
    alpha = torch.ones(nb, dtype=torch.float32, device=dev)
    amax = 2.0 * torch.ones(nb, dtype=torch.float32, device=dev)
    for step in range(1, nsteps + 1):
        f, cg_info = _wiener_filter_eb(dstheta, phi, mesh, axis_name, batch_axis,
                                       nsteps=cg_nsteps, tol=cg_tol, nsteps_flow=nsteps_flow,
                                       fstart=f, fixed_iters=cg_fixed_iters)
        f_mix, phi_mix, dphi = grad_and_mix(f, phi)
        if alpha_max is not None:
            amax = torch.as_tensor(alpha_max, dtype=torch.float32, device=dev)
        else:
            # grow or shrink with the accepted step; a null step keeps the scale
            amax = torch.where(alpha > 0, 2.0 * alpha.to(torch.float32), amax)
        with torch.no_grad():
            alpha, _ = _sharded_grid_linesearch(ctx, f_mix, phi_mix, dphi, amax, int(ngrid))
            ab = alpha if alpha.ndim == 0 else alpha.reshape(alpha.shape
                                                             + (1,) * (phi_mix.arr.ndim - 1))
            phi = Field(phi_mix.arr + ab * dphi.arr, I_MAP, proj)    # G = Id
            lp = ctx.mixed_logpdf(f_mix, phi)
        entry = dict(logpdf=lp.cpu().numpy(), alpha=alpha.cpu().numpy(),
                     cg_iters=int(cg_info["iterations"]))
        history.append(entry)
        if progress:
            print(f"sharded_MAP_joint step {step}: logpdf={float(np.sum(entry['logpdf'])):.6g} "
                  f"alpha={float(np.max(entry['alpha'])):.3g}", flush=True)
    if isinstance(f, _Spectra):
        f = Field(f.pencil.qu(f.eb), QU_MAP, proj)
    return dict(f=f, phi=phi, history=history)


# =========================================================================
# theta-dependent mixing on sharded maps (the Gibbs sampler's theta pass)
# =========================================================================

def _sharded_mix_theta(ds, f, phi, theta, mesh, axis_name="sp", batch_axis=None, nsteps_flow=7):
    """(f, phi) -> (f°, phi°) = (L(phi) D(theta) f, G(theta) phi) on
    y-sharded maps (models/dataset.py::mix)."""
    proj = f.proj
    nb = _nb(ds)
    f = _local(f.to(QU_MAP), mesh, axis_name, batch_axis, nb)
    phi = _local(phi, mesh, axis_name, batch_axis, nb)
    D, G = evaluate_at(ds.D, theta), evaluate_at(ds.G, theta)
    fD = f if isinstance(D, _Identity) else Field(
        ShardedEBDiag(_eb_diag_grids(D, "D"), proj, mesh, axis_name, batch_axis)(f.arr),
        QU_MAP, proj)
    L = ShardedLenseFlow(phi, nsteps=nsteps_flow, mesh=mesh, axis_name=axis_name,
                         batch_axis=batch_axis)
    gg = _pdiag(G)
    phi_mix = phi if gg is None else fourier_diag_apply_sharded(
        pad_multiplier(gg, mesh, axis_name), phi, mesh, axis_name, batch_axis)
    return L @ fD, phi_mix


def _sharded_unmix_theta(ds, f_mix, phi_mix, theta, mesh, axis_name="sp", batch_axis=None,
                         nsteps_flow=7):
    """(f°, phi°) -> (f, phi) at theta on y-sharded maps
    (models/dataset.py::unmix)."""
    proj = f_mix.proj
    nb = _nb(ds)
    f_mix = _local(f_mix.to(QU_MAP), mesh, axis_name, batch_axis, nb)
    phi_mix = _local(phi_mix, mesh, axis_name, batch_axis, nb)
    D, G = evaluate_at(ds.D, theta), evaluate_at(ds.G, theta)
    gg = _pdiag(G)
    phi = phi_mix if gg is None else fourier_diag_apply_sharded(
        pad_multiplier(_safe_inv(gg), mesh, axis_name), phi_mix, mesh, axis_name, batch_axis)
    fi = ShardedLenseFlow(phi, nsteps=nsteps_flow, mesh=mesh, axis_name=axis_name,
                          batch_axis=batch_axis).solve(f_mix)
    f = fi if isinstance(D, _Identity) else Field(
        ShardedEBDiag(_safe_inv(_eb_diag_grids(D, "D")), proj, mesh, axis_name,
                      batch_axis)(fi.arr), QU_MAP, proj)
    return f, phi


def sharded_mixed_logpdf_theta(ds, f_mix, phi_mix, theta, mesh, axis_name="sp",
                               batch_axis=None, nsteps_flow=7):
    """Mixed(ds).logpdf(f_mix, phi_mix, theta) on y-sharded maps: the
    whole value, the theta-dependent logdet normalizations and the D and
    G mixing Jacobians included, one value a batch entry, its quadratic
    forms on the pencil's spectra (Pencil)."""
    proj = f_mix.proj
    f, phi = _sharded_unmix_theta(ds, f_mix, phi_mix, theta, mesh, axis_name, batch_axis,
                                  nsteps_flow)
    Cf, Cphi, Cn = (evaluate_at(op, theta) for op in (ds.Cf, ds.Cphi, ds.Cn))
    ops = _lensing_quadforms(ds.replace(Cf=Cf, Cphi=Cphi, Cn=Cn, M=evaluate_at(ds.M, theta),
                                        B=evaluate_at(ds.B, theta)),
                             mesh, axis_name, batch_axis)
    pencil = ops["pencil"]
    L = ShardedLenseFlow(phi, nsteps=nsteps_flow, mesh=mesh, axis_name=axis_name,
                         batch_axis=batch_axis)
    R = ops["d_eb"] - ops["fwd_eb"]((L @ f).arr)
    F, P = pencil.eb(f.arr), pencil.spectrum(phi.arr)
    lp = -0.5 * (pencil.dot(R, R, ops["iCn"]) + pencil.dot(F, F, ops["iCf"])
                 + pencil.dot(P, P, ops["iCphi"]) + logdet(Cf) + logdet(Cphi) + logdet(Cn))
    return lp - logdet_rel(ds.D, theta) - logdet_rel(ds.G, theta)


def sharded_sample_slice_theta(generator, ds, f: Field, phi: Field, theta, name, xs, mesh,
                               axis_name="sp", batch_axis=None, nsteps_flow=7):
    """One gridded slice-sampling pass for the scalar theta[name] on
    y-sharded chains (inference/sampling.py::gibbs_sample_slice_theta):
    mix at the current theta, the sharded mixed logpdf on the grid xs (a
    value every rank holds), an inverse-transform draw from `generator`
    (the same on every rank), and unmix at the new theta. Returns
    (theta', f', phi'), the fields this rank's blocks."""
    from ..inference.sampling import grid_and_sample

    theta = dict(theta or {})
    with torch.no_grad():
        f_mix, phi_mix = _sharded_mix_theta(ds, f, phi, theta, mesh, axis_name, batch_axis,
                                            nsteps_flow)

        def lp_at(v):
            return sharded_mixed_logpdf_theta(ds, f_mix, phi_mix, dict(theta, **{name: float(v)}),
                                              mesh, axis_name, batch_axis, nsteps_flow)

        val, _, _ = grid_and_sample(generator, lp_at, xs)
        theta[name] = float(np.asarray(val).ravel()[0]) if np.size(val) == 1 else val
        f, phi = _sharded_unmix_theta(ds, f_mix, phi_mix, theta, mesh, axis_name, batch_axis,
                                      nsteps_flow)
    return theta, f, phi


# =========================================================================
# sampling on sharded maps
# =========================================================================

def sharded_sample_f(generator, ds, phi: Field, mesh, axis_name="sp", batch_axis=None,
                     theta=None, **wf_kwargs):
    """A posterior sample of f on sharded maps by constrained simulation
    (inference/maximization.py::sample_f): f_sim and the noise drawn from
    `generator` whole, in ds.simulate's order, as the unsharded port draws
    them, then sharded; d_sim = M B L(phi) f_sim + n through the sharded
    flow; the sharded Wiener filter of d - d_sim; f_sim added back.
    Returns (this rank's block of f, info)."""
    from ..models.distributions import MvNormal

    if phi is None:
        raise ValueError("sharded_sample_f needs an explicit phi (the solve is conditioned on "
                         "it); pass a zero map for the unlensed conditional")
    theta = theta or {}
    dst = ds.at(theta) if theta else ds
    nb = _nb(dst)
    bs = (nb,) if nb else ()
    with torch.no_grad():
        f_sim = MvNormal(0, evaluate_at(ds.Cf, theta)).sample(generator, bs).to(QU_MAP)
        n = MvNormal(0, evaluate_at(ds.Cn, theta)).sample(generator, bs).to(QU_MAP)
        ops = _lensing_quadforms(dst, mesh, axis_name, batch_axis)
        phi_sh = _local(phi.to(phi.basis.with_space("map")), mesh, axis_name, batch_axis, nb)
        f_sh = _local(f_sim, mesh, axis_name, batch_axis, nb)
        L = ShardedLenseFlow(phi_sh, nsteps=wf_kwargs.get("nsteps_flow", 7), mesh=mesh,
                             axis_name=axis_name, batch_axis=batch_axis)
        d_sim = ops["MB"]((L @ f_sh).arr) + _local(n, mesh, axis_name, batch_axis, nb).arr
        d_sh = _local(dst.d.to(QU_MAP), mesh, axis_name, batch_axis, nb).arr
        dres = Field(d_sh - d_sim, QU_MAP, f_sim.proj)
    df, info = sharded_wiener_filter(dst, phi_sh, mesh, axis_name, batch_axis, d=dres,
                                     **wf_kwargs)
    return Field(f_sh.arr + df.arr, QU_MAP, df.proj), info


def sharded_hmc_phi_step(generator, ds, f: Field, phi: Field, mesh, axis_name="sp",
                         batch_axis=None, Lambda=None, N=25, eps=0.01, nsteps_flow=7,
                         always_accept=False):
    """One HMC step on phi at fixed f on sharded maps
    (inference/sampling.py::hmc_step): the momentum drawn whole from
    `generator` and sharded, the mass-matrix solves pencil Fourier-diagonal
    applies, the potential's gradient through the sharded flow's adjoint,
    N leapfrog steps, and each batch entry accepted where log(u) < dH (u
    drawn as hmc_step draws it). Returns (this rank's block of phi, dH,
    accept)."""
    from ..core.field import batch_broadcast
    from ..inference.sampling import _uniform, mass_matrix_phi

    ops = _lensing_quadforms(ds, mesh, axis_name, batch_axis)
    proj = ops["proj"]
    nb = _nb(ds)
    if Lambda is None:
        Lambda = mass_matrix_phi({}, ds)
    pencil = ops["pencil"]
    inv_lam = pencil.pad(_safe_inv(_pdiag(Lambda)))
    f = _local(f.to(QU_MAP), mesh, axis_name, batch_axis, nb)
    phi = _local(phi.to(phi.basis.with_space("map")), mesh, axis_name, batch_axis, nb)

    def U(parr):
        return sharded_lensing_logpdf(ds, f, Field(parr, phi.basis, proj), mesh, axis_name,
                                      batch_axis, nsteps_flow, _ops=ops)

    def U_grad(parr):
        x = parr.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(torch.sum(U(x)), x)
        return g

    def solve(parr):
        return fourier_diag_apply_sharded(inv_lam, Field(parr, phi.basis, proj), mesh, axis_name,
                                          batch_axis).arr

    def energy(xa, pa):
        P = pencil.spectrum(pa)
        return U(xa) - pencil.dot(P, P, inv_lam) / 2

    with torch.no_grad():
        bs = phi.batch_shape if not nb else (nb,)
        p0 = _local(simulate_op(generator, Lambda, batch_shape=bs).to(phi.basis), mesh,
                    axis_name, batch_axis, nb).arr
        x, p, gU = phi.arr, p0, U_grad(phi.arr)
        for _ in range(int(N)):
            x1 = x - eps * solve(p - (eps / 2) * gU)
            gU1 = U_grad(x1)
            p = p - (eps / 2) * (gU1 + gU)
            x, gU = x1, gU1
        dH = energy(x, p) - energy(phi.arr, p0)
        if nb and batch_axis is not None and dH.shape[:1] != (nb,):
            u = _uniform(generator, (nb,))[BatchSharding(mesh, batch_axis).slice(nb)]
        else:
            u = _uniform(generator, dH.shape)
        logu = torch.log(u)
        accept = torch.logical_or(torch.as_tensor(bool(always_accept), device=dH.device),
                                  logu < dH)
        acc = batch_broadcast(accept, phi)
        x_new = Field(torch.where(acc, x, phi.arr), phi.basis, proj)
    return x_new, dH, accept


def sharded_gibbs_pass(generator, ds, phi: Field, mesh, axis_name="sp", batch_axis=None,
                       cg_nsteps=50, cg_tol=1e-8, hmc_N=25, hmc_eps=0.01, nsteps_flow=7,
                       Lambda=None, cg_fixed_iters=False):
    """One pass of sample_joint's alternation on sharded maps: f ~ P(f |
    phi, d) by the sharded constrained realization, then phi ~ P(phi | f,
    d) by one sharded HMC step, both drawing from `generator`. Returns (f,
    phi, info), the fields this rank's blocks."""
    f, wf_info = sharded_sample_f(generator, ds, phi, mesh, axis_name, batch_axis,
                                  nsteps=cg_nsteps, tol=cg_tol, nsteps_flow=nsteps_flow,
                                  fixed_iters=cg_fixed_iters)
    phi_new, dH, accept = sharded_hmc_phi_step(
        generator, ds, f, phi.to(phi.basis.with_space("map")), mesh, axis_name, batch_axis,
        Lambda=Lambda, N=hmc_N, eps=hmc_eps, nsteps_flow=nsteps_flow)
    return f, phi_new, dict(cg_iters=wf_info["iterations"], dH=dH, accept=accept)


def sharded_sample_joint(generator, ds, mesh, nsamps=100, axis_name="sp", batch_axis=None,
                         cg_nsteps=50, cg_tol=1e-8, hmc_N=25, hmc_eps=0.01, nsteps_flow=7,
                         Lambda=None, phistart=None, filename=None, resume=False, nfilewrite=10,
                         nsavemaps=10, theta_range=None, theta_start=None, theta_grid_n=32,
                         progress=False, cg_fixed_iters=False):
    """A Gibbs chain on sharded maps: repeated `sharded_gibbs_pass` (and,
    with theta_range {name: (lo, hi)}, a gridded slice pass per scalar
    theta each step, theta_grid_n values), every draw from `generator`
    (a torch.Generator in the same state on every rank). Each step
    records logpdf, dH, accept, cg_iters and theta; the whole phi map
    every nsavemaps steps. With `filename`, rank 0 appends a native
    CRC-checked record to <filename>.ckpt every nfilewrite steps (and at
    the last), holding the generator's state; resume=True continues every
    rank from the last record. Returns inference.chains.Chains, the same
    on every rank."""
    import torch.distributed as dist
    from ..inference.chains import Chains
    from ..native import CheckpointWriter, read_records

    ops = _lensing_quadforms(ds, mesh, axis_name, batch_axis)
    proj = ops["proj"]
    nb = _nb(ds)
    start_step = 0
    theta = dict(theta_start or {})
    if phistart is not None:
        phi = _local(phistart.to(I_MAP), mesh, axis_name, batch_axis, nb)
    else:
        rows = proj.Ny // axis_size(mesh, axis_name)
        phi = Field(torch.zeros((1, rows, proj.Nx), dtype=proj.torch_T, device=proj.device),
                    I_MAP, proj)
    ckpt = f"{filename}.ckpt" if filename else None
    if ckpt and resume and os.path.exists(ckpt):
        recs = read_records(ckpt)
        if recs:
            st = pickle.loads(recs[-1])["state"]
            phi = _local(Field(torch.as_tensor(st["phi"], device=phi.arr.device), I_MAP, proj),
                         mesh, axis_name, batch_axis, nb)
            generator.set_state(st["generator_state"])
            start_step = int(st["step"])
            theta = dict(st.get("theta", theta))
    writer = None
    if ckpt and dist.get_rank() == 0:
        writer = CheckpointWriter(ckpt, append=bool(resume))
    host = lambda x: x.detach().cpu().numpy()
    whole = lambda x: host(gather_spatial(x, mesh, axis_name, batch_axis))
    chain, chunk = [], []
    try:
        for step in range(start_step + 1, nsamps + 1):
            dsth = ds.at(theta) if theta else ds
            f, phi, info = sharded_gibbs_pass(
                generator, dsth, phi, mesh, axis_name, batch_axis, cg_nsteps=cg_nsteps,
                cg_tol=cg_tol, hmc_N=hmc_N, hmc_eps=hmc_eps, nsteps_flow=nsteps_flow,
                Lambda=Lambda, cg_fixed_iters=cg_fixed_iters)
            if theta_range:
                for nm, (lo, hi) in theta_range.items():
                    xs = np.linspace(float(lo), float(hi), int(theta_grid_n))
                    theta, f, phi = sharded_sample_slice_theta(generator, ds, f, phi, theta, nm,
                                                               xs, mesh, axis_name, batch_axis,
                                                               nsteps_flow)
                dsth = ds.at(theta)
            with torch.no_grad():
                lp = sharded_lensing_logpdf(dsth, f, phi, mesh, axis_name, batch_axis,
                                            nsteps_flow, _ops=None if theta_range else ops)
            entry = dict(step=step, logpdf=host(lp), dH=host(info["dH"]),
                         accept=host(info["accept"]), cg_iters=int(info["cg_iters"]),
                         **{k: float(v) for k, v in theta.items()})
            if step % nsavemaps == 0:
                entry["phi"] = whole(phi.arr)
            chain.append(entry)
            chunk.append(entry)
            if progress:
                print(f"sharded_sample_joint step {step}: "
                      f"logpdf={float(np.sum(entry['logpdf'])):.6g} "
                      f"accept={bool(np.all(entry['accept']))}", flush=True)
            if ckpt and (step % nfilewrite == 0 or step == nsamps):
                state = dict(step=step, phi=whole(phi.arr), theta=dict(theta),
                             generator_state=generator.get_state())
                if writer:
                    writer.write(pickle.dumps(dict(chunk=chunk, state=state)))
                chunk = []
    finally:
        if writer:
            writer.flush()
            writer.close()
    from .mesh import barrier
    barrier(mesh)
    return Chains([chain])
