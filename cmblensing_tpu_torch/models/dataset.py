"""Problem-definition containers and the simulated-dataset factory.

Counterpart of ``cmblensing_tpu/models/dataset.py`` for pol I, P and IP.
The data model is

    d = M(theta) B(theta) L(phi) f + n
    f ~ N(0, Cf(theta)),  phi ~ N(0, Cphi(theta)),  n ~ N(0, Cn(theta))

and the mixed parametrization (f°, phi°) = (L(phi) D f, G phi) is the
one the phi-gradient is taken in.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..core.basis import Basis
from ..core.cov import Cl_to_Cov
from ..core.field import Field, repeat_batch
from ..core.ops import (BlockDiagIEB, Diag, Id, LazyOp, LowPass, BandPass, OpAlgebra,
                        ParamDependentOp, Scaled, evaluate_at, logdet_rel, safe_divide,
                        safe_reciprocal)
from ..core.proj import ProjLambert, resolve_device
from ..utils.cls import camb as camb_cls, noise_cls, beam_cls
from .distributions import MvNormal
from .lenseflow import LenseFlow


# --- parameter-dependent operators (functions of their deps) --------------

def _cf_recompute(deps, r=None):
    """Cf(r) = Cfs + (r/r0) Cft."""
    Cfs, Cft, r0 = deps
    r = r0 if r is None else r
    return _op_lincomb(Cfs, r / r0, Cft)


def _cphi_recompute(deps, Aphi=None):
    """Cphi(Aphi) = Aphi * Cphi0."""
    Cphi0, Aphi0 = deps
    return _op_scale(Aphi0 if Aphi is None else Aphi, Cphi0)


def _G_of(Cphi_at, Nphi):
    """sqrt(I + 2 Nphi pinv(Cphi))."""
    cp = Cphi_at.diag
    arr = 1.0 + 2.0 * Nphi.diag.arr * safe_reciprocal(cp.arr)
    return Diag(Field(torch.sqrt(arr), cp.basis, cp.proj))


def _g_recompute(deps, Aphi=None):
    """G(Aphi) = pinv(G0) sqrt(I + 2 Nphi pinv(Cphi(Aphi)))."""
    G0, Cphi, Nphi, Aphi0 = deps
    Ga = _G_of(Cphi(dict(Aphi=Aphi0 if Aphi is None else Aphi)), Nphi)
    return Diag(Field(Ga.diag.arr / G0.diag.arr, Ga.diag.basis, Ga.diag.proj))


def _d_recompute(deps, r=None):
    """D(r) = sqrt((Cf(r) + sigma2len I + 2 Cn_hat) pinv(Cf(r)))."""
    Cf, Cn_hat, r0, sigma2len = deps
    Cfr = Cf(dict(r=r0 if r is None else r))
    num = _add_scalar_identity(_op_lincomb(Cfr, 2.0, Cn_hat), sigma2len)
    return _op_mul_sqrt_pinv(num, Cfr)


IEB_BLOCKS = ("TT", "TE", "EE", "BB", "ET")   # BlockDiagIEB's blocks, in its arguments' order


def _ieb_map(op, fn):
    """The BlockDiagIEB of fn applied to each of op's blocks."""
    return BlockDiagIEB(*(fn(getattr(op, k)) for k in IEB_BLOCKS))


def _bscal(s, field):
    """A parameter value broadcastable against field's array: a scalar as
    it is, a per-entry vector (numpy or torch, one value a batch entry)
    as a tensor of shape (*batch, 1, 1, 1) on field's device, in the
    field's precision but for a float64 tensor, which stays float64 (the
    theta-score differentiates in float64, inference/muse.py)."""
    if isinstance(s, (np.ndarray, torch.Tensor)) and s.ndim >= 1:
        dtype = s.dtype if isinstance(s, torch.Tensor) and s.dtype == torch.float64 \
            else field.proj.torch_T
        t = torch.as_tensor(s, dtype=dtype, device=field.proj.device)
        return t.reshape(tuple(t.shape) + (1, 1, 1))
    return s


def _op_scale(s, op):
    if isinstance(op, (Diag, BlockDiagIEB)):
        s = _bscal(s, op.diag if isinstance(op, Diag) else op.TT)
    if isinstance(op, Diag):
        return Diag(Field(s * op.diag.arr, op.diag.basis, op.diag.proj))
    if isinstance(op, BlockDiagIEB):
        return _ieb_map(op, lambda x: Field(s * x.arr, x.basis, x.proj))
    return Scaled(s, op)


def _op_lincomb(a, s, b):
    """a + s*b for two Diags or two BlockDiagIEBs."""
    if isinstance(a, (Diag, BlockDiagIEB)):
        s = _bscal(s, a.diag if isinstance(a, Diag) else a.TT)
    if isinstance(a, Diag) and isinstance(b, Diag):
        gb = b.diag.to(a.diag.basis)
        return Diag(Field(a.diag.arr + s * gb.arr, a.diag.basis, a.diag.proj))
    if isinstance(a, BlockDiagIEB) and isinstance(b, BlockDiagIEB):
        return BlockDiagIEB(*(Field(getattr(a, k).arr + s * getattr(b, k).arr, getattr(a, k).basis,
                                    a.proj) for k in IEB_BLOCKS))
    raise TypeError((type(a), type(b)))


def _add_scalar_identity(op, s):
    """op + s I for a Diag or a BlockDiagIEB."""
    if isinstance(op, Diag):
        return Diag(Field(op.diag.arr + s, op.diag.basis, op.diag.proj))
    if isinstance(op, BlockDiagIEB):
        F = lambda x: Field(x.arr + s, x.basis, x.proj)
        return BlockDiagIEB(F(op.TT), op.TE, F(op.EE), F(op.BB), op.ET)
    raise TypeError(type(op))


def _op_mul_sqrt_pinv(num, den):
    """sqrt(num pinv(den)) for two Diags or two BlockDiagIEBs."""
    if isinstance(num, Diag) and isinstance(den, Diag):
        arr = safe_divide(num.diag.arr, den.diag.arr)
        return Diag(Field(torch.sqrt(arr), num.diag.basis, num.diag.proj))
    if isinstance(num, BlockDiagIEB) and isinstance(den, BlockDiagIEB):
        return (num * den.pinv()).sqrt()
    raise TypeError((type(num), type(den)))


# =========================================================================
# DataSet
# =========================================================================

@dataclass
class DataSet:
    """All operators of the data model."""
    d: Any = None              # data
    Cf: Any = None             # unlensed field covariance
    Cn: Any = None             # noise covariance
    Cn_hat: Any = None         # approx. noise covariance (fourier diag)
    M: Any = Id                # mask
    M_hat: Any = Id            # approx. (fourier-diagonal) mask
    B: Any = Id                # beam / transfer function
    B_hat: Any = Id            # approx. beam
    Cphi: Any = None           # phi covariance
    Cf_tilde: Any = None       # lensed field covariance
    D: Any = Id                # mixing matrix for the mixed parametrization
    G: Any = Id                # phi reparametrization
    Nphi: Any = None           # phi noise estimate
    L: Any = LenseFlow         # lensing operator factory (LenseFlow, nsteps=7)
    logprior: Any = None       # callable logprior(theta=, f=, phi=) added to the prior term

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def at(self, theta):
        """Every parameter-dependent operator evaluated at theta
        (theta={} is the fiducial)."""
        theta = theta or {}
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            ev = evaluate_at(v, theta) if isinstance(v, OpAlgebra) else v
            if ev is not v:
                kw[f.name] = ev
        return self.replace(**kw) if kw else self

    def model(self, theta=None, sample=None):
        """The data model as a models/fwdmodel.py model: sites f, phi and
        d (fwdmodel.simulate(ds.model), fwdmodel.logpdf(ds.model))."""
        theta = theta or {}
        f = sample("f", MvNormal(0, evaluate_at(self.Cf, theta)))
        phi = sample("phi", MvNormal(0, evaluate_at(self.Cphi, theta)))
        ft = self.L(phi) @ f
        mu = evaluate_at(self.M, theta) @ (evaluate_at(self.B, theta) @ ft)
        d = sample("d", MvNormal(mu, evaluate_at(self.Cn, theta)))
        return dict(f=f, phi=phi, ft=ft, d=d)

    def logpdf(self, f=None, phi=None, theta=None, d=None):
        return (self.logpdf_term(f=f, phi=phi, theta=theta, d=d, which="prior")
                + self.logpdf_term(f=f, phi=phi, theta=theta, d=d, which="data"))

    def logpdf_term(self, f=None, phi=None, theta=None, d=None, which="prior"):
        """"prior" (the Cf and Cphi Gaussians) or "data" (the M B L(phi) f
        likelihood); logpdf is their sum."""
        theta = theta or {}
        if which == "prior":
            lp = (MvNormal(0, evaluate_at(self.Cf, theta)).logpdf(f)
                  + MvNormal(0, evaluate_at(self.Cphi, theta)).logpdf(phi))
            if self.logprior is not None:
                lp = lp + self.logprior(theta=theta, f=f, phi=phi)
            return lp
        if d is None:
            d = self.d
        ft = self.L(phi) @ f
        mu = evaluate_at(self.M, theta) @ (evaluate_at(self.B, theta) @ ft)
        return MvNormal(mu, evaluate_at(self.Cn, theta)).logpdf(d)

    def simulate(self, generator, theta=None, phi=None, f=None, batch_shape=None):
        """Draw f, phi and the noise from `generator` (in that order), each
        of batch shape `batch_shape` (d's unless given), and the data they
        give."""
        theta = theta or {}
        if batch_shape is None:
            batch_shape = self.d.batch_shape if isinstance(self.d, Field) else ()
        if f is None:
            f = MvNormal(0, evaluate_at(self.Cf, theta)).sample(generator, batch_shape)
        if phi is None:
            phi = MvNormal(0, evaluate_at(self.Cphi, theta)).sample(generator, batch_shape)
        ft = self.L(phi) @ f
        mu = evaluate_at(self.M, theta) @ (evaluate_at(self.B, theta) @ ft)
        n = MvNormal(0, evaluate_at(self.Cn, theta)).sample(generator, batch_shape)
        return dict(f=f, phi=phi, ft=ft, n=n, d=mu + n)

    def gradientf_logpdf(self, f, phi=None, theta=None, d=None):
        """Analytic gradient of logpdf with respect to f: the Gaussian terms
        only, an f-dependent logprior left out (argmaxf_logpdf warns)."""
        theta = theta or {}
        if d is None:
            d = self.d
        Lphi = self.L(phi)
        M = evaluate_at(self.M, theta)
        B = evaluate_at(self.B, theta)
        r = d - M @ (B @ (Lphi @ f))
        return (Lphi.H @ (B.H @ (M.H @ evaluate_at(self.Cn, theta).solve(r)))
                - evaluate_at(self.Cf, theta).solve(f))


BaseDataSet = DataSet


@dataclass
class NoLensingDataSet:
    """A dataset without lensing, d = M B f + n (reference
    src/dataset.jl:37-47)."""
    d: Any = None
    Cf: Any = None
    Cn: Any = None
    Cn_hat: Any = None
    M: Any = Id
    M_hat: Any = Id
    B: Any = Id
    B_hat: Any = Id
    logprior: Any = None       # callable logprior(theta=, f=) added to logpdf

    replace = DataSet.replace
    at = DataSet.at

    def logpdf(self, f=None, theta=None, d=None):
        theta = theta or {}
        if d is None:
            d = self.d
        mu = evaluate_at(self.M, theta) @ (evaluate_at(self.B, theta) @ f)
        lp = (MvNormal(0, evaluate_at(self.Cf, theta)).logpdf(f)
              + MvNormal(mu, evaluate_at(self.Cn, theta)).logpdf(d))
        if self.logprior is not None:
            lp = lp + self.logprior(theta=theta, f=f)
        return lp

    def simulate(self, generator, theta=None, f=None, batch_shape=()):
        """Draw f and the noise from `generator` (in that order), and the
        data they give."""
        theta = theta or {}
        if f is None:
            f = MvNormal(0, evaluate_at(self.Cf, theta)).sample(generator, batch_shape)
        mu = evaluate_at(self.M, theta) @ (evaluate_at(self.B, theta) @ f)
        n = MvNormal(0, evaluate_at(self.Cn, theta)).sample(generator, batch_shape)
        return dict(f=f, n=n, d=mu + n)

    def gradientf_logpdf(self, f, theta=None, d=None, **_):
        theta = theta or {}
        if d is None:
            d = self.d
        M = evaluate_at(self.M, theta)
        B = evaluate_at(self.B, theta)
        r = d - M @ (B @ f)
        return (B.H @ (M.H @ evaluate_at(self.Cn, theta).solve(r))
                - evaluate_at(self.Cf, theta).solve(f))


# =========================================================================
# mixed parametrization
# =========================================================================

@dataclass
class Mixed:
    """Marks the mixed parametrization (f°, phi°) of a DataSet."""
    ds: DataSet

    def logpdf(self, f_mix=None, phi_mix=None, theta=None, d=None):
        ds = self.ds
        theta = theta or {}
        u = unmix(ds, f_mix=f_mix, phi_mix=phi_mix, theta=theta)
        lp = ds.logpdf(f=u["f"], phi=u["phi"], theta=theta, d=d)
        return lp - logdet_rel(ds.D, theta) - logdet_rel(ds.G, theta)

    def logpdf_term(self, f_mix=None, phi_mix=None, theta=None, d=None, which="prior"):
        """One additive piece of the mixed logpdf (DataSet.logpdf_term):
        the D and G logdets ride the "prior" term, so that the terms sum
        to logpdf."""
        ds = self.ds
        theta = theta or {}
        u = unmix(ds, f_mix=f_mix, phi_mix=phi_mix, theta=theta)
        lp = ds.logpdf_term(f=u["f"], phi=u["phi"], theta=theta, d=d, which=which)
        if which == "prior":
            lp = lp - logdet_rel(ds.D, theta) - logdet_rel(ds.G, theta)
        return lp


def mix(ds: DataSet, f=None, phi=None, theta=None):
    """(f, phi) -> (f°, phi°): f° = L(phi) D(theta) f, phi° = G(theta) phi,
    L's flows at the matmul precision in force (ops/deriv.py)."""
    theta = theta or {}
    D = evaluate_at(ds.D, theta)
    G = evaluate_at(ds.G, theta)
    return dict(f_mix=ds.L(phi) @ (D @ f), phi_mix=G @ phi, theta=theta)


def unmix(ds: DataSet, f_mix=None, phi_mix=None, theta=None):
    """(f°, phi°) -> (f, phi), L^-1's flows at the matmul precision in
    force (MAP_joint's unmix runs at its `precision`)."""
    theta = theta or {}
    D = evaluate_at(ds.D, theta)
    G = evaluate_at(ds.G, theta)
    phi = G.solve(phi_mix)
    f = D.solve(ds.L(phi).solve(f_mix))
    return dict(f=f, phi=phi, theta=theta)


# =========================================================================
# module-level functional API
# =========================================================================

def simulate(generator, ds, **kw):
    return ds.simulate(generator, **kw)


def logpdf(ds, **kw):
    return ds.logpdf(**kw)


def gradientf_logpdf(ds, **kw):
    return ds.gradientf_logpdf(**kw)


def Hessian_logpdf_preconditioner(which, ds):
    """The fast approximate Hessian of logpdf with respect to `which`
    (reference src/dataset.jl:127-137): for "f", pinv(Cf) + B_hat' M_hat'
    pinv(Cn_hat) M_hat B_hat as a lazy operator; for "phi_mix",
    pinv(Cphi) + pinv(Nphi), a Diag (at the fiducial parameters)."""
    if which == "f":
        Bh, Mh = ds.B_hat, ds.M_hat
        term = LazyOp("*", Bh.H, LazyOp("*", Mh.H, LazyOp("*", FuncSolve(ds.Cn_hat),
                                                          LazyOp("*", Mh, Bh))))
        return LazyOp("+", _fiducial(ds.Cf).pinv(), term)
    if which in ("phi_mix", ("phi_mix",)):
        cp = _fiducial(ds.Cphi).pinv()
        return Diag(Field(cp.diag.arr + ds.Nphi.pinv().diag.to(cp.diag.basis).arr,
                          cp.diag.basis, cp.diag.proj))
    raise ValueError(which)


def _fiducial(op):
    return op.fiducial if isinstance(op, ParamDependentOp) else op


class FuncSolve:
    """An operator whose `@` applies another's solve."""

    def __init__(self, op):
        self.op = op

    def __matmul__(self, f):
        return self.op.solve(f)

    @property
    def H(self):
        return FuncSolve(self.op.H)


# =========================================================================
# load_sim
# =========================================================================

def _mask_cov(pol, proj, bandpass):
    """Fourier-diagonal operator of a BandPass for pol I, P or IP (its TE
    block zero)."""
    W = bandpass.on(proj, pol="I").diag.arr   # (1, Ny, Nxh)
    if pol == "I":
        return Diag(Field(W, Basis("I", "fourier"), proj))
    if pol == "P":
        return Diag(Field(torch.cat([W, W], dim=-3), Basis("EB", "fourier"), proj))
    if pol == "IP":
        F = lambda a: Field(a, Basis("I", "fourier"), proj)
        return BlockDiagIEB(F(W), F(torch.zeros_like(W)), F(W), F(W))
    raise ValueError(pol)


def as_generator(key, device, seed=0):
    """A torch.Generator on `device` for the JAX package's `key` argument:
    `key` itself when it is a generator, else one seeded with `key` (an
    int) or, when key is None, with `seed`."""
    if key is not None and not isinstance(key, (int, np.integer)):
        return key
    g = torch.Generator(device=device)
    g.manual_seed(seed if key is None else int(key))
    return g


def load_sim(thetapix, Nside, pol, T=np.float32, Nbatch=None,
             muKarcminT=3, lknee=100, alphaknee=3, Cln=None, Cn=None,
             beamFWHM=0, B=None, B_hat=None,
             pixel_mask_kwargs=None, bandpass_mask=None, M=None, M_hat=None,
             Cl=None, fiducial_theta=None, seed=0, key=None, D=None, G=None, Nphi_fac=2,
             L=None, rotator=(0.0, 90.0, 0.0), device=None):
    """Simulated-dataset factory for pol 'I', 'P' or 'IP', with the JAX
    package's keywords (reference src/dataset.jl:186-338):

    - noise: white at muKarcminT with a 1/f knee (lknee, alphaknee), or the
      spectra `Cln` (a dict with TT, EE, BB, TE Cls); Cn (the noise
      covariance of the data) is Cn_hat unless given;
    - beam: a Gaussian of beamFWHM arcmin, or the operators B, B_hat (B_hat
      is B unless given);
    - mask: `bandpass_mask` (LowPass(3000) unless given) as a
      Fourier-diagonal operator, times, with `pixel_mask_kwargs`, the pixel
      mask that utils/masking.py::make_mask draws from
      np.random.default_rng(seed) with those arguments (M_hat stays the
      Fourier part); or the operators M and M_hat (M_hat is M unless
      given);
    - theory: the fiducial spectra, or `Cl` (camb()'s layout), which must
      reach the grid's lmax; fiducial_theta's "Aphi" scales Cphi (any other
      entry needs pycamb, and raises);
    - D, G: the mixing operators, built from the dataset unless given;
      Nphi is the quadratic estimate's noise over Nphi_fac;
    - L: the lensing operator factory, phi -> operator (LenseFlow with
      nsteps 7 unless given; PowerLens, Taylens, BilinearLens, ...);
    - rotator: the projection's rotation (metadata).

    One simulation is drawn, f, phi and the noise in that order, from `key`
    (a torch.Generator on `device`, or an int seed) or, without one, from
    a generator seeded with `seed`; with `Nbatch`, the dataset's d is that
    simulation's data repeated Nbatch times along a leading batch axis (Nphi
    comes from the unbatched data, as in the JAX package). The dataset
    lives on `device`: the CUDA card unless given, e.g. "cpu". Returns a
    dict with f, ft, phi, d, ds, ds0 (fiducial-evaluated), Cl, proj."""
    from .quadratic_estimate import quadratic_estimate

    pol = str(pol)
    if pol not in ("I", "P", "IP"):
        raise ValueError(f"pol should be one of 'I', 'P', or 'IP' (got {pol!r})")
    device = resolve_device(device)
    generator = as_generator(key, device, seed)
    Ny, Nx = (Nside, Nside) if np.isscalar(Nside) else Nside
    proj = ProjLambert(Ny, Nx, thetapix=thetapix, T=T, device=device, rotator=rotator)
    lmax = int(np.ceil(np.sqrt(2) * float(proj.nyquist)) + 1)

    fiducial_theta = dict(fiducial_theta or {})
    Aphi0 = float(fiducial_theta.pop("Aphi", 1.0))
    if Cl is None:
        Cl = camb_cls(lmax=lmax, **fiducial_theta)
    else:
        if fiducial_theta:
            raise ValueError("pass either Cl or fiducial_theta, not both "
                             "(the provided Cl fixes the fiducial cosmology)")
        try:
            cl_lmax = float(np.max(np.asarray(Cl["unlensed_scalar"]["TT"].ell)))
        except (KeyError, TypeError, AttributeError, ValueError):
            cl_lmax = np.inf
        if cl_lmax < lmax:
            raise ValueError(f"provided Cl extends only to ell={cl_lmax:.0f} but this grid needs "
                             f"lmax={lmax} (ceil(sqrt(2)*nyquist)+1): the covariance would be "
                             "zero at higher ell")
    r0 = float(Cl["params"].get("r", 0.2))
    if Cln is None:
        Cln = noise_cls(muKarcminT=muKarcminT, beamFWHM=0, lknee=lknee, alphaknee=alphaknee,
                        lmax=lmax)
    ks = {"I": ("TT",), "P": ("EE", "BB"), "IP": ("TT", "EE", "BB", "TE")}[pol]

    Cphi0 = Cl_to_Cov("I", proj, Cl["total"]["pp"])
    Cfs = Cl_to_Cov(pol, proj, *[Cl["unlensed_scalar"][k] for k in ks])
    Cft = Cl_to_Cov(pol, proj, *[Cl["tensor"][k] for k in ks])
    Cf_tilde = Cl_to_Cov(pol, proj, *[Cl["total"][k] for k in ks])
    Cn_hat = Cl_to_Cov(pol, proj, *[Cln[k] for k in ks])
    if Cn is None:
        Cn = Cn_hat

    Cf = ParamDependentOp(("r",), _cf_recompute, (Cfs, Cft, r0))
    Cphi = ParamDependentOp(("Aphi",), _cphi_recompute, (Cphi0, Aphi0))
    if M is None:
        Mfourier = _mask_cov(pol, proj, LowPass(3000) if bandpass_mask is None else bandpass_mask)
        M = Mfourier
        if pixel_mask_kwargs is not None:
            from ..utils.masking import make_mask
            mask = make_mask((Ny, Nx), thetapix, rng=np.random.default_rng(seed),
                             **pixel_mask_kwargs)
            b = Basis({"I": "I", "P": "QU", "IP": "IQU"}[pol], "map")
            pix = np.broadcast_to(mask[None], (b.ncomp, Ny, Nx)).copy()
            M = LazyOp("*", Mfourier, Diag(Field(torch.as_tensor(pix, device=device), b, proj)))
        if M_hat is None:
            M_hat = Mfourier
    elif M_hat is None:
        M_hat = M
    if B is None:
        Bl = beam_cls(beamFWHM=beamFWHM, lmax=lmax).sqrt()
        B = _mask_cov(pol, proj, BandPass(Bl.ell, Bl.Cl))
    if B_hat is None:
        B_hat = B

    ds = DataSet(Cn=Cn, Cn_hat=Cn_hat, Cf=Cf, Cf_tilde=Cf_tilde, Cphi=Cphi,
                 M=M, M_hat=M_hat, B=B, B_hat=B_hat, D=Id if D is None else D,
                 G=Id if G is None else G, L=LenseFlow if L is None else L)
    sim = ds.simulate(generator)
    ds = ds.replace(d=sim["d"])

    Nphi = _op_scale(1.0 / Nphi_fac, quadratic_estimate(ds)["Nphi"])
    ds = ds.replace(Nphi=Nphi)
    if G is None:
        G0 = _G_of(Cphi(dict(Aphi=Aphi0)), Nphi)
        ds = ds.replace(G=ParamDependentOp(("Aphi",), _g_recompute, (G0, Cphi, Nphi, Aphi0)))
    if D is None:
        sigma2len = float(np.deg2rad(5 / 60) ** 2)
        ds = ds.replace(D=ParamDependentOp(("r",), _d_recompute, (Cf, Cn_hat, r0, sigma2len)))
    if Nbatch is not None:
        ds = ds.replace(d=repeat_batch(sim["d"], Nbatch))
    return dict(f=sim["f"], ft=sim["ft"], phi=sim["phi"], d=ds.d,
                ds=ds, ds0=ds.at({}), Cl=Cl, proj=proj)


def load_nolensing_sim(lensed_covariance=False, **kwargs):
    """load_sim(**kwargs) with its dataset as a NoLensingDataSet (reference
    src/dataset.jl:341-352): the same data and operators, the field
    covariance the unlensed Cf, or with lensed_covariance the lensed
    Cf_tilde."""
    out = dict(load_sim(**kwargs))
    ds = out["ds"]
    ds_nl = NoLensingDataSet(d=ds.d, Cf=ds.Cf_tilde if lensed_covariance else ds.Cf, Cn=ds.Cn,
                             Cn_hat=ds.Cn_hat, M=ds.M, M_hat=ds.M_hat, B=ds.B, B_hat=ds.B_hat)
    out["ds"] = ds_nl
    out["ds0"] = ds_nl.at({})
    return out


# =========================================================================
# state carried across from numpy arrays
# =========================================================================

DIAG_OPS = ("Cf", "Cf_tilde", "Cn", "Cn_hat", "Cphi", "M", "M_hat", "B", "B_hat",
            "D", "G", "Nphi")


def _op_from_numpy(spec, proj):
    """The operator an entry of `dataset_from_numpy`'s arrays describes."""
    if isinstance(spec, list):
        ops = [_op_from_numpy(x, proj) for x in spec]
        out = ops[-1]
        for op in reversed(ops[:-1]):
            out = LazyOp("*", op, out)
        return out
    if isinstance(spec, dict):
        F = lambda a: Field(torch.as_tensor(np.array(a), device=proj.device),
                            Basis("I", "fourier"), proj)
        return BlockDiagIEB(*(F(spec[k]) for k in IEB_BLOCKS[:4]),
                            F(spec["ET"]) if "ET" in spec else None)
    arr, pol, space = spec
    return Diag(Field(torch.as_tensor(np.array(arr), device=proj.device), Basis(pol, space), proj))


def dataset_from_numpy(arrays, proj_kwargs, device=None):
    """A DataSet from plain numpy arrays, e.g. those of another
    implementation's dataset evaluated at theta = {}.

    arrays maps "d" to (array, pol, space), the data field, and each name
    in DIAG_OPS to its operator: (array, pol, space) for a Fourier- or
    map-diagonal operator (its diagonal and basis); a dict of the
    spin-0 Fourier blocks TT, TE, EE, BB (and ET where it differs from
    TE), each (1, Ny, Nx//2+1), for a BlockDiagIEB; or a list of such
    entries for their product in that order (a mask given as a Fourier
    diagonal times a pixel diagonal). A missing M, M_hat, B, B_hat, D or G
    is the identity. proj_kwargs are ProjLambert's (Ny, Nx, thetapix, T).
    The dataset lives on `device`: the CUDA card unless given, e.g.
    "cpu"."""
    device = resolve_device(device)
    proj = ProjLambert(**proj_kwargs, device=device)
    d = _field_from_numpy(arrays["d"], proj)
    kw = {name: _op_from_numpy(arrays[name], proj) for name in DIAG_OPS if name in arrays}
    return DataSet(d=d, **kw)


def _field_from_numpy(spec, proj):
    arr, pol, space = spec
    return Field(torch.as_tensor(np.array(arr), device=proj.device), Basis(pol, space), proj)


STATE_FIELDS = ("phi", "f", "f_mix", "phi_mix")


def state_from_numpy(arrays, proj, generator=None):
    """A sampler state (inference/sampling.py) from plain numpy arrays,
    e.g. another implementation's: each of STATE_FIELDS present in
    `arrays` as (array, pol, space), "theta" a dict of floats or
    per-chain arrays, "step" an int. The fields live on proj's device;
    `generator`, when given, is the state's source of draws."""
    state = {k: _field_from_numpy(arrays[k], proj) for k in STATE_FIELDS if k in arrays}
    state["theta"] = {k: (np.array(v) if np.ndim(v) else float(v))
                      for k, v in dict(arrays.get("theta", {})).items()}
    state["step"] = int(arrays.get("step", 0))
    if generator is not None:
        state["generator"] = generator
    return state
