"""Wiener filtering and joint MAP estimation.

Counterpart of ``cmblensing_tpu/inference/maximization.py`` (reference
src/maximization.jl): the f-step is a preconditioned CG Wiener filter;
the phi-step is preconditioned gradient ascent on the mixed posterior
with a grid line search whose trials run as one batched evaluation.

Ported: the two preconditioners, ``argmaxf_logpdf`` and ``MAP_joint``
with ``linesearch="grid"``, with the JAX package's precision defaults
and their guards:

- ``argmaxf_logpdf``: ``hessian_precision="auto"`` (= 'high') runs the
  Hessian applies inside CG at 'high' (the LenseFlow kernels' bf16
  head/residual tier, ops/deriv.py::precision_ctx) while b, a0 and the
  CG algebra stay strict; the final residual is re-evaluated with a
  strict Hessian and, when it misses max(tol, 1e-10 res0), the solve
  re-runs strict (``info["precision_fallback"]``).
- ``MAP_joint``: ``precision="auto"`` (= 'high') for the phi-gradient
  and ``unmix``; the grid line search always strict; when its strict
  trials reject the 'high' direction (alpha = 0), the gradient is
  recomputed strict and searched again, and an accepted retry keeps the
  run strict. ``precision=None`` is strict everywhere, the f-step
  included.

One deliberate difference from the JAX package (ROADMAP Queue 3, its
fault 1): after a strict retry that also finds alpha = 0, no further
retry fires until a step finds alpha > 0; the JAX package retries on
every later step, a gradient and a line search each time.

Not ported yet, and refused with NotImplementedError (ROADMAP Queue 1
item 3): the 'bf16' tier, ``linesearch="brent"`` (and so an
``alpha_tol`` and a ``logprior`` in MAP_joint), ``quasi_sample`` (and
so a ``key``), ``nburnin_update_hessian``, batched datasets, and
``MAP_marg``. ``argmaxf_logpdf`` solves the Gaussian conditional only and
warns when the dataset has a logprior, as the JAX package does.
"""
from __future__ import annotations

import contextlib
import os
import warnings

import numpy as np
import torch

from ..core.field import Field, dot as field_dot, fvalue_and_grad, norm as field_norm, \
    zeros_like_field
from ..core.ops import Diag, Id, ParamDependentOp, _Identity, _diag_field_of, evaluate_at
from ..models.dataset import DataSet, Mixed, mix, unmix
from ..ops.deriv import precision_ctx
from ..ops.solvers import conjugate_gradient, tree_dot
from ..utils.progress import progress_bar
from ..utils.timing import timed

_NOT_PORTED = "not ported yet (ROADMAP Queue 1 item 3)"
# what MAP_joint can record per step
HISTORY_KEYS = ("logpdf", "phi", "f", "alpha", "cg_iters", "cg_res", "cg_res_history",
                "gradnorm", "precision_fallback", "retry")


def _check_precision(precision, name, allowed):
    if precision == "bf16":
        raise NotImplementedError(f"{name}='bf16': the 'bf16' tier of the LenseFlow kernels is "
                                  "not ported (ROADMAP Queue 2)")
    if precision not in allowed:
        raise ValueError(f"{name}={precision!r}: one of {allowed}")


def _pctx(precision):
    """The derivative-product precision for a block: `precision`, or the
    one in force when None."""
    return precision_ctx(precision) if precision else contextlib.nullcontext()


# =========================================================================
# preconditioners
# =========================================================================

def _fid(op):
    return op.fiducial if isinstance(op, ParamDependentOp) else op


def _eager_chain_mul(*ops):
    """The product of Fourier-diagonal operators, identities skipped."""
    out = None
    for op in ops:
        if isinstance(op, _Identity):
            continue
        out = op if out is None else out * op
    return out if out is not None else Id


def hessian_f_preconditioner(ds: DataSet):
    """pinv(Cf) + B' M' pinv(Cn_hat) M B from the Fourier-diagonal
    approximations (reference Hessian_logpdf_preconditioner): Diags, or
    BlockDiagIEBs at pol IP, composed mode by mode."""
    Cf = _fid(ds.Cf)
    Bh, Mh, Cnh = _fid(ds.B_hat), _fid(ds.M_hat), _fid(ds.Cn_hat)
    return Cf.pinv() + _eager_chain_mul(Bh.H, Mh.H, Cnh.pinv(), Mh, Bh)


def hessian_phimix_preconditioner(ds: DataSet):
    """pinv(Cphi) + pinv(Nphi)."""
    cp = _fid(ds.Cphi).pinv()
    return cp + Diag(_fid(ds.Nphi).pinv().diag.to(cp.diag.basis))


# =========================================================================
# Wiener filter
# =========================================================================

def _zero_map_like(Cphi):
    d = Cphi.diag
    return Field(torch.zeros(d.batch_shape + (d.ncomp, d.proj.Ny, d.proj.Nx),
                             dtype=d.proj.torch_T, device=d.proj.device),
                 d.basis.with_space("map"), d.proj)


def argmaxf_logpdf(ds: DataSet, phi=None, theta=None, d=None, fstart=None,
                   conjgrad_kwargs=None, offset=False):
    """Maximize logpdf over f at fixed (phi, theta): the Gaussian system
    H f = b solved by preconditioned CG, with H applied through the
    analytic f-gradient. conjgrad_kwargs go to `conjugate_gradient` (tol,
    nsteps, fixed_iters, record_history), but for hessian_precision:
    "auto" (the default, = 'high') or 'high' runs the Hessian applies at
    that precision while b, a0 and the CG algebra stay strict, then
    re-checks the final residual with a strict Hessian (info["res_strict"],
    info["precision_ok"]) and re-runs the whole solve strict when it
    misses max(tol, 1e-10 res0) (info["precision_fallback"] = True); None
    runs everything at the precision in force. Returns (f, info)."""
    theta = theta or {}
    if getattr(ds, "logprior", None) is not None:
        warnings.warn(
            "argmaxf_logpdf solves the GAUSSIAN conditional in f; an "
            "f-dependent ds.logprior is not part of this solve "
            "(matches the reference's analytic gradientf)", stacklevel=2)
    cg = dict(tol=1e-1, nsteps=500, hessian_precision="auto")
    cg.update(conjgrad_kwargs or {})
    hp = cg.pop("hessian_precision")
    hp = "high" if hp == "auto" else hp
    _check_precision(hp, "hessian_precision", (None, "f32", "high"))
    if d is None:
        d = ds.d
    if d.batch_shape:
        raise NotImplementedError(f"argmaxf_logpdf on a batched dataset is {_NOT_PORTED}")
    with torch.no_grad():
        x, info = _argmaxf_core(ds, theta, phi, d, fstart, offset, hp, **cg)
        if hp and not bool(info["precision_ok"]):
            x, info = _argmaxf_core(ds, theta, phi, d, fstart, offset, None, **cg)
            info["precision_fallback"] = True
    return x, info


def _argmaxf_core(ds, theta, phi, d, fstart, offset, hessian_precision=None, **cg):
    precond = hessian_f_preconditioner(ds)
    dfield = _diag_field_of(ds.Cf)
    zero_f = zeros_like_field(dfield).to(dfield.basis.with_space("map"))
    zero_d = zeros_like_field(d)
    # gradientf(f, d) = b - H f with H SPD: b = gradientf(0, d) and
    # H f = -(gradientf(f, 0) - a0); with a Hessian precision, b, a0 and
    # the strict residual check are strict
    with _pctx("f32" if hessian_precision else None):
        b = ds.gradientf_logpdf(zero_f, phi=phi, theta=theta, d=d)
        a0 = ds.gradientf_logpdf(zero_f, phi=phi, theta=theta, d=zero_d)
    if offset:
        b = b - a0
    Bb = b.basis

    def hess(f):
        return -(ds.gradientf_logpdf(f, phi=phi, theta=theta, d=zero_d) - a0).to(Bb)

    def hess_at(f):
        with _pctx(hessian_precision):
            return hess(f)

    x0 = fstart.to(Bb) if fstart is not None else None
    x, info = conjugate_gradient(precond, hess_at, b, x0=x0, **cg)
    if hessian_precision:
        # the final residual under a strict Hessian, in the metric of tol
        with _pctx("f32"):
            r = b - hess(x)
        info["res_strict"] = tree_dot(r, precond.solve(r))
        info["precision_ok"] = torch.all(
            info["res_strict"] <= torch.clamp(1e-10 * info["res0"], min=float(cg.get("tol", 1e-1))))
    return x, info


# =========================================================================
# MAP_joint
# =========================================================================

def _phi_grad_and_fmix(dstheta, theta, f, phi):
    """(f°, phi° in its map basis, grad_phi° of the mixed logpdf)."""
    m = mix(dstheta, f=f, phi=phi, theta=theta)
    f_mix = m["f_mix"]
    phi_mix = m["phi_mix"].to(m["phi_mix"].basis.with_space("map"))
    _, g = fvalue_and_grad(
        lambda pm: torch.sum(Mixed(dstheta).logpdf(f_mix=f_mix, phi_mix=pm, theta=theta)))(phi_mix)
    return f_mix, phi_mix, g


def _mixed_gaussian_covs(dstheta, theta):
    """The alpha-independent Sigma_i of the mixed posterior's Gaussian
    terms (order matches _mixed_gaussian_z)."""
    return [evaluate_at(dstheta.Cf, theta), evaluate_at(dstheta.Cphi, theta),
            evaluate_at(dstheta.Cn, theta)]


def _mixed_gaussian_z(dstheta, theta, f_mix, phi_mix):
    """The residual fields z_i of the mixed posterior's Gaussian terms
    (its logdet pieces do not depend on alpha in a line search)."""
    u = unmix(dstheta, f_mix=f_mix, phi_mix=phi_mix, theta=theta)
    f, phi = u["f"], u["phi"]
    ft = dstheta.L(phi) @ f
    mu = evaluate_at(dstheta.M, theta) @ (evaluate_at(dstheta.B, theta) @ ft)
    return [f, phi, dstheta.d - mu]


# What one grid line-search trial holds on the card at its peak, in map
# planes of phi's size (a pol-P trial: unmix's L^-1 flow and the L flow
# with their RK4 buffers and p(t) planes, grad/Hess phi, the residual
# fields z_i and their covariance solves): 18.1 measured on an NVIDIA H100
# 80GB HBM3 at 2048^2 P (chip_smoke.py phase 13 prints it: the peak
# memory of a line search of 17 trials over that of chunks of 5, per
# trial), rounded up. The JAX package's v5e estimate was 100.
LINESEARCH_PLANES_PER_TRIAL = 20


def linesearch_budget(device):
    """The bytes the grid line search's trials may hold at once on
    `device`: half the card's memory (the rest for the dataset, the
    f-step's CG and the allocator's slack); None (no limit) off the
    card."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).total_memory // 2


def _linesearch_chunk(phi_mix, ngrid, budget=None):
    """How many trials the grid line search evaluates in one batch
    (counterpart of the JAX package's `_linesearch_chunk`): ngrid (all
    ngrid + 1 trials, alpha = 0 included, in one batch) while ngrid of
    them fit in `budget` bytes at LINESEARCH_PLANES_PER_TRIAL planes each
    (the JAX rule: one trial over rather than a second batch); else the
    fewest batches of at most as many as fit (at least 1), evened out so
    that padding the last one wastes least. The budget is
    `linesearch_budget` of phi's device unless given;
    CMBL_LINESEARCH_CHUNK overrides the rule."""
    env_chunk = os.environ.get("CMBL_LINESEARCH_CHUNK")
    if env_chunk:
        return max(1, int(env_chunk))
    if budget is None:
        budget = linesearch_budget(phi_mix.arr.device)
    if budget is None:
        return ngrid
    per_trial = LINESEARCH_PLANES_PER_TRIAL * phi_mix.proj.Ny * phi_mix.proj.Nx \
        * phi_mix.arr.element_size()
    fit = max(1, int(budget // per_trial))
    if fit >= ngrid:
        return ngrid
    nchunk = -(-(ngrid + 1) // fit)
    return -(-(ngrid + 1) // nchunk)


def _grid_linesearch_dlps(dstheta, theta, f_mix, phi_mix, dphi, amax, ngrid, chunk=None):
    """The grid line search's trials: (alphas, dlps), alpha = 0 as trial
    0, each trial's Delta logpdf computed cancellation-free,

        lp(a) - lp(0) = -1/2 sum_i <z_i(a) - z_i(0), Sigma_i^-1 (z_i(a) + z_i(0))>,

    so that float32 resolves the difference and not the ~1e7 totals.
    While the trials fit the memory guard (`_linesearch_chunk`, or
    `chunk` when given), all ngrid + 1 of them, alpha = 0 included, run
    as ONE batched evaluation (batch x component on the flow kernels'
    grid); otherwise as batches of `chunk` trials, the last one padded
    with alpha = 0 trials, so that every batch is the same computation.
    z_i(0) is row 0 of the first batch, computed as the others are, so
    its dlp is exactly 0 and no difference between two evaluation paths
    reaches the Sigma^-1 metric, which would amplify it (the JAX
    package's path-consistency fix)."""
    rdt, dev = phi_mix.arr.dtype, phi_mix.arr.device
    steps = (torch.arange(1, ngrid + 1, dtype=rdt, device=dev) / ngrid) ** 1.5
    alphas = torch.cat([torch.zeros(1, dtype=rdt, device=dev),
                        torch.as_tensor(amax, dtype=rdt, device=dev) * steps])
    if chunk is None:
        chunk = _linesearch_chunk(phi_mix, ngrid)
    if chunk >= ngrid:
        chunk = ngrid + 1
    nchunk = -(-(ngrid + 1) // chunk)
    padded = torch.cat([alphas, alphas.new_zeros(nchunk * chunk - (ngrid + 1))])
    covs = _mixed_gaussian_covs(dstheta, theta)
    z0s, dlps = None, []
    for a in padded.split(chunk):
        step = Field(a.reshape(-1, 1, 1, 1) * dphi.arr, dphi.basis, dphi.proj)
        zs = _mixed_gaussian_z(dstheta, theta, f_mix, phi_mix + step)
        if z0s is None:
            z0s = [Field(z.arr[:1], z.basis, z.proj) for z in zs]
        d = 0.0
        for z, z0, S in zip(zs, z0s, covs):
            d = d - 0.5 * field_dot(z - z0, S.solve(z + z0))
        dlps.append(d)
        del zs, step
    dlps = torch.cat(dlps)[:ngrid + 1]
    dlps = torch.where(torch.isfinite(dlps), dlps, torch.full_like(dlps, -float("inf")))
    return alphas, dlps


def _step_unmix_and_norm(dstheta, theta, f_mix, phi_mix, dphi, alpha):
    """phi° + alpha dphi, unmixed, its mixed logpdf and |dphi|."""
    pm = phi_mix + alpha * dphi
    u = unmix(dstheta, f_mix=f_mix, phi_mix=pm, theta=theta)
    phi = u["phi"].to(u["phi"].basis.with_space("map"))
    lp = torch.sum(Mixed(dstheta).logpdf(f_mix=f_mix, phi_mix=pm, theta=theta))
    return pm, phi, lp, field_norm(dphi)


def MAP_joint(ds: DataSet, theta=None, nsteps=20, minsteps=0, fstart=None, phistart=None,
              alpha_tol=1e-4, gradtol=0.0, alpha_max=None, conjgrad_kwargs=None,
              quasi_sample=False, key=None, progress=False, history_keys=("logpdf",),
              nburnin_update_hessian=None, linesearch="grid", ngrid=16, precision="auto"):
    """Joint MAP estimate of (f, phi) by coordinate ascent (reference
    src/maximization.jl): an exact f-step (CG Wiener filter) alternates
    with a preconditioned-gradient phi-step along grad_phi° of the mixed
    posterior, its length from a grid line search of ngrid trials on
    (0, amax] (amax = twice the last accepted step, or alpha_max).

    precision: "auto" (the default, = 'high') or 'high' runs the
    phi-gradient and unmix at 'high' and the line search strict, with the
    direction retry (module docstring); 'f32' all three strict, the
    f-step's CG at its own default ("auto") unless conjgrad_kwargs names
    a hessian_precision; None strict everywhere, the f-step included.
    history_keys picks what each step records: "logpdf", "phi" (after
    the step, map basis), "f" (the f-step's), "alpha", "cg_iters",
    "cg_res", "cg_res_history" (when conjgrad_kwargs ask CG to record
    it), "gradnorm", and "precision_fallback" (the f-step re-ran strict)
    and "retry" (the direction retry fired); another key raises.
    alpha_tol (brent's) and key (quasi_sample's) are taken at their
    defaults only, while those two are not ported. Iteration stops early
    once a step after minsteps moves phi° by less than gradtol (alpha
    |dphi|). Returns dict(f, phi, history)."""
    _check_precision(precision, "precision", (None, "auto", "f32", "high"))
    unknown = [k for k in history_keys if k not in HISTORY_KEYS]
    if unknown:
        raise ValueError(f"history_keys {unknown}: MAP_joint records {HISTORY_KEYS}")
    if linesearch != "grid":
        raise NotImplementedError(f"linesearch={linesearch!r} is {_NOT_PORTED}")
    if alpha_tol != 1e-4:
        raise NotImplementedError(f"alpha_tol={alpha_tol!r}: brent's tolerance; brent is "
                                  f"{_NOT_PORTED}")
    if quasi_sample:
        raise NotImplementedError(f"quasi_sample is {_NOT_PORTED}")
    if key is not None:
        raise NotImplementedError(f"a key (quasi_sample's) is {_NOT_PORTED}")
    if nburnin_update_hessian is not None:
        raise NotImplementedError(f"nburnin_update_hessian is {_NOT_PORTED}")
    if getattr(ds, "logprior", None) is not None:
        raise NotImplementedError(f"a logprior (which needs the brent search) is {_NOT_PORTED}")
    if not isinstance(ds, DataSet):
        raise NotImplementedError(f"MAP_joint on a {type(ds).__name__} is {_NOT_PORTED}")
    if ds.d.batch_shape:
        raise NotImplementedError(f"MAP_joint on a batched dataset is {_NOT_PORTED}")
    theta = theta or {}
    cg = dict(tol=1e-1, nsteps=500)
    cg.update(conjgrad_kwargs or {})
    if precision is None:
        cg.setdefault("hessian_precision", None)
    dstheta = ds.at(theta).replace(G=Id)   # the MAP does not depend on G
    Cphi = _fid(dstheta.Cphi)
    phi = phistart if phistart is not None else _zero_map_like(Cphi)
    f = fstart
    Hpre = hessian_phimix_preconditioner(dstheta) if dstheta.Nphi is not None else Cphi.pinv()
    Hpre_inv = Hpre.pinv()
    prec = "high" if precision == "auto" else precision
    ls_prec = "f32" if prec == "high" else prec   # the line search is always strict

    def direction(prec_):
        with _pctx(prec_):
            f_mix, phi_mix, g = _phi_grad_and_fmix(dstheta, theta, f, phi)
        return f_mix, phi_mix, g, Hpre_inv @ g

    def search(f_mix, phi_mix, dphi):
        with _pctx(ls_prec):
            alphas, dlps = _grid_linesearch_dlps(dstheta, theta, f_mix, phi_mix, dphi, amax,
                                                 int(ngrid))
        return float(alphas[torch.argmax(dlps)])

    history = []
    alpha, amax = 1.0, 2.0
    # set after a strict retry that also found alpha = 0: no further retry
    # until a step finds alpha > 0 (the JAX package retries every step)
    retry_spent = False
    with torch.no_grad(), progress_bar(nsteps, "MAP_joint", enabled=progress) as pbar:
        for step in range(1, nsteps + 1):
            with timed("MAP_joint/f_step"):
                f, cg_info = argmaxf_logpdf(dstheta, phi=phi, theta=theta, fstart=f,
                                            conjgrad_kwargs=cg)
            with timed("MAP_joint/phi_step"):
                f_mix, phi_mix, g, dphi = direction(prec)
                if alpha_max is not None:
                    amax = alpha_max
                elif alpha > 0:
                    # grow or shrink with the accepted step; a null step
                    # (alpha = 0) keeps the previous scale
                    amax = 2.0 * alpha
                alpha = search(f_mix, phi_mix, dphi)
                nfev, retried = ngrid, False
                if alpha == 0.0 and prec != ls_prec and not retry_spent:
                    # the strict trials rejected the reduced-precision
                    # direction: recompute it strict and search again; an
                    # accepted strict direction keeps the run strict
                    retried = True
                    f_mix, phi_mix, g, dphi = direction(ls_prec)
                    alpha = search(f_mix, phi_mix, dphi)
                    nfev += ngrid
                    if alpha > 0:
                        prec = ls_prec
                    else:
                        retry_spent = True
                elif alpha > 0:
                    retry_spent = False
            with _pctx(prec):
                phi_mix, phi, lp_dev, dnorm_dev = _step_unmix_and_norm(
                    dstheta, theta, f_mix, phi_mix, dphi, alpha)
            lp, dnorm = float(lp_dev), float(dnorm_dev)
            if progress:
                pbar.update(logpdf=lp, alpha=alpha, CG=int(cg_info["iterations"]), ls=nfev)
            entry = {}
            if "logpdf" in history_keys:
                entry["logpdf"] = lp
            if "phi" in history_keys:
                entry["phi"] = phi
            if "f" in history_keys:
                entry["f"] = f
            if "alpha" in history_keys:
                entry["alpha"] = alpha
            if "cg_iters" in history_keys:
                entry["cg_iters"] = int(cg_info["iterations"])
            if "cg_res" in history_keys:
                entry["cg_res"] = cg_info["res"].cpu().numpy()
            if "cg_res_history" in history_keys and "res_history" in cg_info:
                entry["cg_res_history"] = cg_info["res_history"].cpu().numpy()
            if "gradnorm" in history_keys:
                entry["gradnorm"] = np.asarray(float(field_norm(g)))
            if "precision_fallback" in history_keys:
                entry["precision_fallback"] = bool(cg_info.get("precision_fallback", False))
            if "retry" in history_keys:
                entry["retry"] = retried
            history.append(entry)
            if step > minsteps and dnorm * alpha < gradtol:
                break
    return dict(f=f, phi=phi, history=history)
