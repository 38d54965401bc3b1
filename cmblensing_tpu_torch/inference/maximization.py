"""Wiener filtering and joint MAP estimation.

Counterpart of ``cmblensing_tpu/inference/maximization.py`` (reference
src/maximization.jl): the f-step is a preconditioned CG Wiener filter;
the phi-step is preconditioned gradient ascent on the mixed posterior
with a grid line search whose trials run as one batched evaluation.

Ported: the two preconditioners, ``argmaxf_logpdf``, ``sample_f``,
``MAP_joint`` (grid or brent line search, every option of the JAX
package's) and ``MAP_marg``, with the JAX package's precision defaults
and their guards:

- ``argmaxf_logpdf``: ``hessian_precision="auto"`` (= 'high') runs the
  Hessian applies inside CG at 'high' (the LenseFlow kernels' bf16
  head/residual tier, ops/deriv.py::precision_ctx) while b, a0 and the
  CG algebra stay strict; the final residual is re-evaluated with a
  strict Hessian and, when it misses max(tol, 1e-10 res0), the solve
  re-runs strict (``info["precision_fallback"]``); at 'high' with
  ``fixed_iters``, a strict residual within ``AUTO_RECHECK_KAPPA`` of the
  'high' solve's own true residual passes too.
- ``hessian_precision="bf16"`` runs those applies at 'bf16' (one bf16
  product per circulant product), with the same strict check and
  fallback.
- ``MAP_joint``: ``precision="auto"`` (= 'high') or 'bf16' for the
  phi-gradient and ``unmix``; the line search always strict; when its
  strict trials reject the reduced-precision direction (alpha = 0), the
  gradient is recomputed strict and searched again, and an accepted
  retry keeps the run strict. The f-step keeps its own default
  ("auto"). ``precision=None`` is strict everywhere, the f-step
  included. A dataset with a logprior is line-searched by brent on the
  whole mixed logpdf (the grid's cancellation-free objective has the
  Gaussian terms only); a NoLensingDataSet's MAP is its Wiener filter.

``MAP_joint`` on a batched dataset runs every entry at once, each with its
own phi-step and grid line-search alpha; ``MAP_marg`` is the marginal MAP, its
mean field from a batch of simulations. Randomness (``quasi_sample``'s,
``MAP_marg``'s) comes from torch.Generators where the JAX package takes
keys.

Deliberate differences from the JAX package (ROADMAP Queue 3):
- after a strict retry that also finds alpha = 0, no further retry fires
  until a step finds alpha > 0 (every entry's, on a batched dataset); the
  JAX package retries on every later step, a gradient and a line search
  each time;
- on a batched dataset the retry fires when ANY entry's alpha is 0 (the
  JAX package: when every entry's is), for the whole batch, and a retry
  that moves any entry keeps the run strict; where no entry stalls, or
  every entry does, the two agree;
- brent minimizes lp(alpha) - lp(0), its Gaussian terms cancellation-free
  as the grid's trials are, and the logprior's change; the JAX package
  minimizes the float32 total lp(alpha), whose rounding (an ulp of 2 at
  1024^2 P) leaves alpha undetermined to ~1e-2; where both resolve the
  optimum they agree;
- brent returns alpha = 0 when no trial beats it (the grid's self-guard:
  the difference is exactly 0 there), so the strict retry can fire on the
  brent path; the JAX package's bounded brent never returns exactly 0, so
  its retry never fires there;
- the retry's line-search evaluations are added to the step's count (the
  JAX package drops brent's);
- under fixed CG iterations, "auto" keeps its 'high' solve when the
  strict residual is at most AUTO_RECHECK_KAPPA times the 'high'
  operator's own residual at x: a fixed count never reaches
  max(tol, 1e-10 res0), so the JAX package re-runs every such solve
  strict. Where tol > 0 its check still passes a solve that meets it.

``MAP_marg(mesh=...)`` splits the mean field's sims over the ranks of
the mesh's "batch" dimension (parallel/mesh.py::batch_shard): each rank
simulates the whole ensemble and keeps its entries, runs their Wiener
filters and gradients, and the mean is one all_reduce; MAP_joint,
argmaxf_logpdf and sample_f take that core/shard.py::BatchShard as
`shard=`.
``argmaxf_logpdf`` and
``sample_f`` take a batched d: CG keeps a residual and a step per entry,
and the strict re-check's verdict covers every entry. ``argmaxf_logpdf``
solves the Gaussian conditional only and warns when the dataset has a
logprior, as the JAX package does.
"""
from __future__ import annotations

import contextlib
import os
import warnings

import numpy as np
import torch

from ..core.field import Field, dot as field_dot, fvalue_and_grad, norm as field_norm, \
    repeat_batch, zeros_like_field
from ..core import shard as _shard
from ..core.cov import Cl_to_Cov, cov_to_Cl
from ..core.ops import (Diag, Id, ParamDependentOp, _Identity, _diag_field_of, evaluate_at,
                        nan2zero, safe_reciprocal)
from ..models.dataset import DataSet, Mixed, NoLensingDataSet, as_generator, mix, unmix
from ..ops.deriv import precision_ctx
from ..ops.solvers import conjugate_gradient, tree_dot
from ..utils.cls import Cls, smooth
from ..utils.progress import progress_bar
from ..utils.timing import timed

# what MAP_joint can record per step
HISTORY_KEYS = ("logpdf", "phi", "f", "alpha", "cg_iters", "cg_res", "cg_res_history",
                "gradnorm", "precision_fallback", "retry", "nfev")


def _check_precision(precision, name, allowed):
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
    BlockDiagIEBs at pol IP, composed mode by mode; for curved-sky
    BlockDiagEquiRect covariances, pinv(Cf) + pinv(Cn_hat) block by
    block."""
    Cf = _fid(ds.Cf)
    Bh, Mh, Cnh = _fid(ds.B_hat), _fid(ds.M_hat), _fid(ds.Cn_hat)
    term = _eager_chain_mul(Bh.H, Mh.H, Cnh.pinv(), Mh, Bh)
    if isinstance(term, _Identity):
        term = Cnh.pinv()
    return Cf.pinv() + term


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


# Under fixed CG iterations, "auto" keeps its 'high' solve where the strict
# residual at x is at most this many times the 'high' operator's own true
# residual there (argmaxf_logpdf). The ratio of the two is 1.000-1.008
# where the iteration count sets the residual (the CPU, 32^2 IP, 3-60
# fixed iterations), and exactly 1 where the operators agree (a step-1
# solve at phi = 0); where the 'high' operator's error sets it, 34 at 60
# iterations with a 1e-2 relative Hessian error (the CPU), and 1.9e4-1.6e5
# on an NVIDIA H100 80GB HBM3 (700 W) on the 1024^2 P north star, bandpower
# MUSE's 256^2 P f-steps and the 512^2 P x 32 sampler's f-step
# (scripts/torch_auto_recheck.py ratios). 4 lies between the two.
AUTO_RECHECK_KAPPA = 4.0


def argmaxf_logpdf(ds: DataSet, phi=None, theta=None, d=None, fstart=None,
                   conjgrad_kwargs=None, offset=False, shard=None):
    """Maximize logpdf over f at fixed (phi, theta): the Gaussian system
    H f = b solved by preconditioned CG, with H applied through the
    analytic f-gradient. conjgrad_kwargs go to `conjugate_gradient` (tol,
    nsteps, fixed_iters, record_history), but for hessian_precision:
    "auto" (the default, = 'high'), 'high' or 'bf16' runs the Hessian
    applies at that precision while b, a0 and the CG algebra stay strict, then
    re-checks the final residual with a strict Hessian (info["res_strict"],
    info["precision_ok"]) and re-runs the whole solve strict when it
    misses max(tol, 1e-10 res0) (info["precision_fallback"] = True); None
    runs everything at the precision in force. At 'high' ("auto") with
    fixed_iters, whose count of iterations sets the residual at any
    precision, the check also passes where res_strict is at most
    AUTO_RECHECK_KAPPA times the 'high' operator's own residual at the
    solve's x (info["res_high"], one more 'high' Hessian apply): the
    strict re-run fires where that operator's error dominates the
    residual. shard (a
    core/shard.py::BatchShard: d holds this rank's entries of a sharded
    ensemble) makes CG's stop test and the re-check's verdict read every
    rank's entries. Returns (f, info)."""
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
    _check_precision(hp, "hessian_precision", (None, "f32", "high", "bf16"))
    if d is None:
        d = ds.d
    with torch.no_grad():
        x, info = _argmaxf_core(ds, theta, phi, d, fstart, offset, hp, shard, **cg)
        if hp and not bool(info["precision_ok"]):
            x, info = _argmaxf_core(ds, theta, phi, d, fstart, offset, None, shard, **cg)
            info["precision_fallback"] = True
    return x, info


def _argmaxf_core(ds, theta, phi, d, fstart, offset, hessian_precision=None, shard=None, **cg):
    precond = hessian_f_preconditioner(ds)
    Cf = _fid(ds.Cf)
    if hasattr(Cf, "zero_field"):
        # an operator that knows its map-space domain (BlockDiagEquiRect):
        # curved-sky fields run through this same solve
        zero_f = Cf.zero_field(d.batch_shape)
    else:
        dfield = _diag_field_of(Cf)
        zero_f = zeros_like_field(dfield).to(dfield.basis.with_space("map"))
        if d.batch_shape:
            zero_f = repeat_batch(zero_f, d.batch_shape[0])
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
    x, info = conjugate_gradient(precond, hess_at, b, x0=x0, shard=shard, **cg)
    if hessian_precision:
        # the final residual under a strict Hessian, in the metric of tol
        with _pctx("f32"):
            r = b - hess(x)
        info["res_strict"] = tree_dot(r, precond.solve(r))
        ok = info["res_strict"] <= torch.clamp(1e-10 * info["res0"], min=float(cg.get("tol", 1e-1)))
        if hessian_precision == "high" and cg.get("fixed_iters") and not bool(ok.all()):
            # a fixed count of iterations can stop short of max(tol,
            # 1e-10 res0) whatever the precision, and that check alone
            # would re-run every "auto" solve strict (ROADMAP Queue 3). The
            # strict residual also passes within AUTO_RECHECK_KAPPA of the
            # 'high' solve's own true residual at x, b - H_high x (CG's
            # recurrence residual drifts from it): the strict re-run then
            # fires where the 'high' operator's error, not the count, sets
            # the residual. 'bf16' and 'f32' keep JAX's check alone
            rh = b - hess_at(x)
            info["res_high"] = tree_dot(rh, precond.solve(rh))
            ok = ok | (info["res_strict"] <= AUTO_RECHECK_KAPPA * info["res_high"])
        # one verdict for every entry, every rank's with a shard
        info["precision_ok"] = torch.tensor(_shard.all_(shard, ok), device=ok.device)
    return x, info


def simulate_entries(ds, generator, shard, theta=None, phi=None):
    """ds.simulate(generator, theta=theta, phi=phi) (phi None: drawn too),
    or with a shard (phi and ds.d this rank's entries) the whole ensemble's
    simulation at every rank's phi, as the unsharded run draws it, sliced
    to this rank's entries."""
    kw = {} if phi is None else dict(phi=phi)
    if shard is None:
        return ds.simulate(generator, theta=theta, **kw)
    if phi is not None and phi.batch_shape:
        kw["phi"] = Field(shard.gather(phi.arr), phi.basis, phi.proj)
    sim = ds.simulate(generator, theta=theta, batch_shape=(shard.total,), **kw)
    return {k: shard.slice(v) for k, v in sim.items()}


def sample_f(generator, ds: DataSet, phi=None, theta=None, d=None, shard=None, **kwargs):
    """A posterior sample of f at fixed (phi, theta) by constrained
    simulation: a simulation (f_s, d_s) drawn from `generator` at phi, and
    f_s + argmax_f of the posterior given d - d_s (argmaxf_logpdf with
    offset=True; kwargs go to it). With a shard (d and phi this rank's
    entries) the simulation is the whole ensemble's at every rank's phi,
    sliced to this rank's entries. Returns (f, info)."""
    theta = theta or {}
    if d is None:
        d = ds.d
    with torch.no_grad():
        sim = simulate_entries(ds, generator, shard, theta=theta, phi=phi)
    df, info = argmaxf_logpdf(ds, phi=phi, theta=theta, d=d - sim["d"], offset=True,
                              shard=shard, **kwargs)
    return sim["f"] + df.to(sim["f"].basis), info


# =========================================================================
# MAP_joint
# =========================================================================

# The phi-gradients take the logpdf's two terms ("prior", "data") in two
# backward passes where the map is TERM_SPLIT_MIN_N or more on a side (the
# JAX package's _term_split_fgrad, whose threshold, 8192, the v5e's 16 GB
# set): each term's graph and saved tensors are freed before the next one
# is built, so that the peak holds one term's, at the cost of a second
# unmix. TERM_SPLIT_MIN_N comes from the peak memory of the mixed
# phi-gradient measured on an NVIDIA H100 80GB HBM3 (700 W) at 2048^2 and
# 4096^2 P, strict (scripts/torch_term_split_mem.py; PERF.md §6):
# 78.1 maps of the field's size whole, 71.3 split, at +40-45 % of the
# time. Extrapolated from those two sizes (16384^2 was not run), the
# whole gradient takes 78 GiB at 16384^2, the card's memory, and the
# split 71 GiB: below 16384 the whole gradient fits with room and the
# split only costs time.
TERM_SPLIT_MIN_N = 16384
TERMS = ("prior", "data")


def _needs_term_split(field):
    return max(field.proj.Ny, field.proj.Nx) >= TERM_SPLIT_MIN_N


def _term_split_fgrad(term_fn, terms, x):
    """The gradient of sum_w term_fn(x, w), one backward pass a term, in
    x's map basis."""
    g = None
    for w in terms:
        _, gw = fvalue_and_grad(lambda xx, _w=w: term_fn(xx, _w))(x)
        g = gw if g is None else g + gw
    return g


def _phi_grad_and_fmix(dstheta, theta, f, phi):
    """(f°, phi° in its map basis, grad_phi° of the mixed logpdf)."""
    m = mix(dstheta, f=f, phi=phi, theta=theta)
    f_mix = m["f_mix"]
    phi_mix = m["phi_mix"].to(m["phi_mix"].basis.with_space("map"))
    mixed = Mixed(dstheta)
    if _needs_term_split(phi_mix):
        g = _term_split_fgrad(lambda pm, w: torch.sum(mixed.logpdf_term(
            f_mix=f_mix, phi_mix=pm, theta=theta, which=w)), TERMS, phi_mix)
        return f_mix, phi_mix, g
    _, g = fvalue_and_grad(
        lambda pm: torch.sum(mixed.logpdf(f_mix=f_mix, phi_mix=pm, theta=theta)))(phi_mix)
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
# fields z_i and their covariance solves), measured on an NVIDIA H100
# 80GB HBM3 at 2048^2 P as the peak memory of a line search of 17 trials
# over that of chunks of 5, per trial: 18.1 on the "kernel" backend
# (chip_smoke.py phase 13 prints it) and 26.1 on "uni", whose velocities
# go through a (trials, 1, 4, N, N) K5 output and a copy (phase 16); the
# larger, rounded up, for every backend. The JAX package's v5e estimate
# was 100.
LINESEARCH_PLANES_PER_TRIAL = 28


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
    per batch entry of phi (a batched dataset's trials carry every entry);
    the JAX rule: one trial over rather than a second batch; else the
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
        * phi_mix.arr.element_size() * phi_mix.Nbatch
    fit = max(1, int(budget // per_trial))
    if fit >= ngrid:
        return ngrid
    nchunk = -(-(ngrid + 1) // fit)
    return -(-(ngrid + 1) // nchunk)


def _repeat_trials(f, m):
    """A batched field's entries, all of them m times over, trial-major:
    (m * nbatch, ...)."""
    arr = f.arr.unsqueeze(0).expand((m,) + tuple(f.arr.shape))
    return Field(arr.reshape((-1,) + tuple(f.arr.shape[1:])), f.basis, f.proj)


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
    package's path-consistency fix).

    On a batched dataset (phi° of batch shape (nbatch,)) each entry has
    its own grid: amax is a scalar or one value an entry, alphas and dlps
    are (ngrid + 1, nbatch), and a batch of m trials evaluates m x nbatch
    entries, trial-major, d and f° repeated for each trial."""
    rdt, dev = phi_mix.arr.dtype, phi_mix.arr.device
    steps = (torch.arange(1, ngrid + 1, dtype=rdt, device=dev) / ngrid) ** 1.5
    amax = torch.as_tensor(amax, dtype=rdt, device=dev)
    nb = phi_mix.batch_shape
    if nb:
        amax = amax.expand(nb)
        steps = steps[:, None]
    alphas = amax * steps
    alphas = torch.cat([torch.zeros_like(alphas[:1]), alphas])
    if chunk is None:
        chunk = _linesearch_chunk(phi_mix, ngrid)
    if chunk >= ngrid:
        chunk = ngrid + 1
    nchunk = -(-(ngrid + 1) // chunk)
    padded = torch.cat([alphas, alphas.new_zeros((nchunk * chunk - (ngrid + 1),) + nb)])
    covs = _mixed_gaussian_covs(dstheta, theta)
    z0s, dlps = None, []
    for a in padded.split(chunk):
        if nb:
            m = a.shape[0]
            pm = phi_mix + Field(a.reshape(a.shape + (1, 1, 1)) * dphi.arr, dphi.basis,
                                 dphi.proj)
            pm = Field(pm.arr.reshape((-1,) + tuple(pm.arr.shape[2:])), pm.basis, pm.proj)
            zs = _mixed_gaussian_z(dstheta.replace(d=_repeat_trials(dstheta.d, m)), theta,
                                   _repeat_trials(f_mix, m), pm)
            zs = [Field(z.arr.reshape((m,) + nb + tuple(z.arr.shape[1:])), z.basis, z.proj)
                  for z in zs]
            del pm
        else:
            step = Field(a.reshape(-1, 1, 1, 1) * dphi.arr, dphi.basis, dphi.proj)
            zs = _mixed_gaussian_z(dstheta, theta, f_mix, phi_mix + step)
            del step
        if z0s is None:
            z0s = [Field(z.arr[:1], z.basis, z.proj) for z in zs]
        d = 0.0
        for z, z0, S in zip(zs, z0s, covs):
            d = d - 0.5 * field_dot(z - z0, S.solve(z + z0))
        dlps.append(d)
        del zs
    dlps = torch.cat(dlps)[:ngrid + 1]
    dlps = torch.where(torch.isfinite(dlps), dlps, torch.full_like(dlps, -float("inf")))
    return alphas, dlps


def _grid_argmax(alphas, dlps):
    """The trial of largest dlp: a float, or on a batched dataset a tensor
    of one alpha an entry (trial 0 is alpha = 0, the self-guard)."""
    i = torch.argmax(dlps, dim=0)
    if alphas.ndim == 1:
        return float(alphas[i])
    return torch.gather(alphas, 0, i[None])[0]


def _brent_dlp(dstheta, theta, f_mix, phi_mix, dphi, shard=None):
    """alpha -> lp(alpha) - lp(0) of the mixed posterior along dphi, a
    float (summed over batch entries): brent's objective. The Gaussian
    terms cancellation-free, as the grid's trials (_grid_linesearch_dlps),
    z_i(0) from the same single-trial path, plus the logprior's change; the
    logdet terms do not depend on alpha. A float32 total of ~2.6e7 (1024^2
    P) has an ulp of 2, flat to within it over ~1e-2 of alpha about the
    optimum; the difference resolves alpha to brent's tolerance."""
    covs = _mixed_gaussian_covs(dstheta, theta)
    z0 = _mixed_gaussian_z(dstheta, theta, f_mix, phi_mix)
    lp0 = (dstheta.logprior(theta=theta, f=z0[0], phi=z0[1])
           if dstheta.logprior is not None else None)

    def dlp(alpha):
        zs = _mixed_gaussian_z(dstheta, theta, f_mix, phi_mix + alpha * dphi)
        d = 0.0
        for z, z_0, S in zip(zs, z0, covs):
            d = d - 0.5 * field_dot(z - z_0, S.solve(z + z_0))
        if lp0 is not None:
            d = d + (dstheta.logprior(theta=theta, f=zs[0], phi=zs[1]) - lp0)
        return float(_shard.sum_(shard, d))

    return dlp


def _brent_min(f, b, abs_tol=1e-4, maxiter=50):
    """(x, evaluations) minimizing the float function f on [0, b], f(0) = 0
    (brent's objective is the change from alpha = 0): scipy's bounded Brent
    to abs_tol, and 0 where no trial goes below f(0) (the self-guard the
    grid has in its trial 0; the JAX package's brent has none, so its x is
    never exactly 0)."""
    from scipy.optimize import minimize_scalar
    res = minimize_scalar(f, bounds=(0.0, b), method="bounded",
                          options=dict(xatol=abs_tol, maxiter=maxiter))
    return (float(res.x) if float(res.fun) < 0.0 else 0.0), int(res.nfev)


def _secant_hessian_inv(phi_mix, prev_phi_mix, g, prev_g, current):
    """The phi-step's inverse-Hessian preconditioner from the secant ratios
    |d phi° / d g| between two steps (reference src/maximization.jl:180-186):
    binned to a spectrum (cov_to_Cl), LOWESS-smoothed in log-log as l^4
    C_l, back to a Fourier-diagonal operator; `current` where fewer than 4
    bins are finite and positive."""
    dpm = (phi_mix - prev_phi_mix).to_harmonic()
    dgm = (g - prev_g).to(dpm.basis)
    ratio = torch.abs(nan2zero(dpm.arr / dgm.arr)).to(dpm.arr.dtype)
    cl = cov_to_Cl(Diag(Field(ratio, dpm.basis, dpm.proj)))
    pos = np.isfinite(cl.Cl) & (cl.Cl > 0) & np.isfinite(cl.ell) & (cl.ell > 0)
    if pos.sum() < 4:
        return current
    cl_s = smooth(Cls(cl.ell[pos], (cl.ell[pos] ** 4) * cl.Cl[pos]), xscale="log", yscale="log",
                  smoothing=0.3)
    cl_s = Cls(cl_s.ell, cl_s.Cl / np.maximum(cl_s.ell, 1) ** 4)
    return Cl_to_Cov("I", phi_mix.proj, cl_s, units=1)


def _stalled_moved(alpha, shard=None):
    """(whether some entry's alpha is 0, whether some entry's is > 0) of a
    line search's alpha, a float or one value a batch entry (every rank's
    entries with a shard)."""
    if isinstance(alpha, torch.Tensor):
        return _shard.any_(shard, alpha == 0), _shard.any_(shard, alpha > 0)
    return alpha == 0.0, alpha > 0


def _step_unmix_and_norm(dstheta, theta, f_mix, phi_mix, dphi, alpha):
    """phi° + alpha dphi (alpha a scalar or one value a batch entry),
    unmixed, its mixed logpdf summed over the entries, and |dphi| (one
    value an entry)."""
    pm = phi_mix + alpha * dphi
    u = unmix(dstheta, f_mix=f_mix, phi_mix=pm, theta=theta)
    phi = u["phi"].to(u["phi"].basis.with_space("map"))
    lp = torch.sum(Mixed(dstheta).logpdf(f_mix=f_mix, phi_mix=pm, theta=theta))
    return pm, phi, lp, field_norm(dphi)


def MAP_joint(ds: DataSet, theta=None, nsteps=20, minsteps=0, fstart=None, phistart=None,
              alpha_tol=1e-4, gradtol=0.0, alpha_max=None, conjgrad_kwargs=None,
              quasi_sample=False, key=None, progress=False, history_keys=("logpdf",),
              nburnin_update_hessian=None, linesearch="grid", ngrid=16, precision="auto",
              shard=None):
    """Joint MAP estimate of (f, phi) by coordinate ascent (reference
    src/maximization.jl): an exact f-step (CG Wiener filter) alternates
    with a preconditioned-gradient phi-step along grad_phi° of the mixed
    posterior, its length alpha from a line search on (0, amax] (amax =
    twice the last accepted step, or alpha_max): linesearch="grid", ngrid
    trials evaluated as one batch (cancellation-free, the Gaussian terms),
    or "brent", scipy's bounded Brent to alpha_tol on the whole mixed
    logpdf's change from alpha = 0, computed cancellation-free, alpha = 0
    included (module docstring). A dataset with a
    logprior is always searched by brent. On a NoLensingDataSet the MAP
    is the Wiener filter: dict(f, phi=None, history=[CG info]).

    quasi_sample=True takes each f-step as a posterior sample
    (`sample_f`) instead of the maximum, drawn from `key` (a
    torch.Generator on the dataset's device, or an int seed; seed 0 when
    None). nburnin_update_hessian=n: from step n + 1 on, the phi-step's
    preconditioner is rebuilt each step from the secant ratios of the last
    two steps, smoothed (`_secant_hessian_inv`).

    precision: "auto" (the default, = 'high'), 'high' or 'bf16' runs the
    phi-gradient and unmix at that precision and the line search strict,
    with the direction retry (module docstring); 'f32' all three strict.
    At each of these the f-step's CG runs at its own default ("auto")
    unless conjgrad_kwargs names a hessian_precision; None is strict
    everywhere, the f-step included.
    history_keys picks what each step records: "logpdf", "phi" (after
    the step, map basis), "f" (the f-step's), "alpha", "cg_iters",
    "cg_res", "cg_res_history" (when conjgrad_kwargs ask CG to record
    it), "gradnorm", and "precision_fallback" (the f-step re-ran strict),
    "retry" (the direction retry fired) and "nfev" (the line search's
    evaluations, the retry's included); another key raises. Iteration
    stops early once a step after minsteps moves phi° by less than
    gradtol (alpha |dphi|, their largest over the entries).

    On a batched dataset (d of batch shape (nbatch,)) phi is repeated
    over the entries when phistart is not batched; the grid gives each
    entry its own grid (amax from its own last step) and alpha (brent one
    alpha for all), history's "alpha" and "gradnorm" are arrays of one
    value an entry and "logpdf" is the sum over the entries. The
    direction retry fires when any entry's alpha is 0, for the whole batch
    (module docstring). shard (a core/shard.py::BatchShard: d holds this
    rank's entries of a sharded ensemble) makes those cross-entry
    decisions, CG's stop test, the logpdf sum and the stop rule read
    every rank's entries. Returns dict(f, phi, history)."""
    _check_precision(precision, "precision", (None, "auto", "f32", "high", "bf16"))
    unknown = [k for k in history_keys if k not in HISTORY_KEYS]
    if unknown:
        raise ValueError(f"history_keys {unknown}: MAP_joint records {HISTORY_KEYS}")
    if linesearch not in ("grid", "brent"):
        raise ValueError(f"linesearch={linesearch!r}: 'grid' or 'brent'")
    theta = theta or {}
    cg = dict(tol=1e-1, nsteps=500)
    cg.update(conjgrad_kwargs or {})
    if precision is None:
        cg.setdefault("hessian_precision", None)
    if getattr(ds, "logprior", None) is not None:
        # the grid's cancellation-free objective has the Gaussian terms only
        linesearch = "brent"
    if isinstance(ds, NoLensingDataSet):
        # no phi to optimize: the MAP is the Wiener filter
        f, info = argmaxf_logpdf(ds.at(theta), theta=theta, conjgrad_kwargs=cg, shard=shard)
        return dict(f=f, phi=None, history=[info])
    dstheta = ds.at(theta).replace(G=Id)   # the MAP does not depend on G
    Cphi = _fid(dstheta.Cphi)
    phi = phistart if phistart is not None else _zero_map_like(Cphi)
    batched = bool(dstheta.d.batch_shape)
    if batched and not phi.batch_shape:
        # each entry gets its own phi-step and line-search alpha
        phi = repeat_batch(phi, dstheta.d.batch_shape[0])
    f = fstart
    Hpre = hessian_phimix_preconditioner(dstheta) if dstheta.Nphi is not None else Cphi.pinv()
    Hpre_inv = Hpre.pinv()
    prec = "high" if precision == "auto" else precision
    ls_prec = "f32" if prec in ("high", "bf16") else prec   # the line search is always strict
    generator = as_generator(key, phi.device) if quasi_sample else None

    def direction(prec_):
        with _pctx(prec_):
            return _phi_grad_and_fmix(dstheta, theta, f, phi)

    def search(f_mix, phi_mix, dphi):
        """(alpha, evaluations) of the line search along dphi."""
        with _pctx(ls_prec):
            if linesearch == "grid":
                alphas, dlps = _grid_linesearch_dlps(dstheta, theta, f_mix, phi_mix, dphi, amax,
                                                     int(ngrid))
                return _grid_argmax(alphas, dlps), int(ngrid)
            dlp = _brent_dlp(dstheta, theta, f_mix, phi_mix, dphi, shard)
            return _brent_min(lambda a: -dlp(a), float(torch.max(torch.as_tensor(amax))),
                              abs_tol=alpha_tol)

    history = []
    alpha, amax = 1.0, 2.0
    prev_phi_mix = prev_g = None
    # set after a strict retry that also found alpha = 0: no further retry
    # until a step finds alpha > 0 (the JAX package retries every step)
    retry_spent = False
    with torch.no_grad(), progress_bar(nsteps, "MAP_joint", enabled=progress) as pbar:
        for step in range(1, nsteps + 1):
            with timed("MAP_joint/f_step"):
                if quasi_sample:
                    f, cg_info = sample_f(generator, dstheta, phi=phi, theta=theta, fstart=f,
                                          conjgrad_kwargs=cg, shard=shard)
                else:
                    f, cg_info = argmaxf_logpdf(dstheta, phi=phi, theta=theta, fstart=f,
                                                conjgrad_kwargs=cg, shard=shard)
            with timed("MAP_joint/phi_step"):
                f_mix, phi_mix, g = direction(prec)
                if (nburnin_update_hessian is not None and step > nburnin_update_hessian
                        and prev_g is not None):
                    Hpre_inv = _secant_hessian_inv(phi_mix, prev_phi_mix, g, prev_g, Hpre_inv)
                dphi = Hpre_inv @ g
                if alpha_max is not None:
                    amax = alpha_max
                elif batched:
                    # per entry: grow or shrink with its accepted step; a null
                    # step (alpha = 0) keeps the entry's previous scale
                    a = torch.as_tensor(alpha, dtype=phi.dtype, device=phi.device)
                    amax = torch.where(a > 0, 2.0 * a,
                                       torch.as_tensor(amax, dtype=phi.dtype, device=phi.device))
                elif alpha > 0:
                    amax = 2.0 * alpha
                alpha, nfev = search(f_mix, phi_mix, dphi)
                retried = False
                stalled = _stalled_moved(alpha, shard)[0]
                if stalled and prec != ls_prec and not retry_spent:
                    # the strict trials rejected the reduced-precision
                    # direction (of one entry at least): recompute it strict
                    # for the whole batch and search again; an accepted
                    # strict direction (of any entry) keeps the run strict
                    retried = True
                    f_mix, phi_mix, g = direction(ls_prec)
                    dphi = Hpre_inv @ g
                    alpha, n = search(f_mix, phi_mix, dphi)
                    nfev += n
                    if _stalled_moved(alpha, shard)[1]:
                        prec = ls_prec
                    else:
                        retry_spent = True
                elif not stalled:
                    retry_spent = False
            with _pctx(prec):
                _, phi, lp_dev, dnorm_dev = _step_unmix_and_norm(
                    dstheta, theta, f_mix, phi_mix, dphi, alpha)
            alpha_s = _shard.max_(shard, alpha)
            lp, dnorm = float(_shard.sum_(shard, lp_dev)), _shard.max_(shard, dnorm_dev)
            if progress:
                pbar.update(logpdf=lp, alpha=alpha_s, CG=int(cg_info["iterations"]), ls=nfev)
            entry = {}
            if "logpdf" in history_keys:
                entry["logpdf"] = lp
            if "phi" in history_keys:
                entry["phi"] = phi
            if "f" in history_keys:
                entry["f"] = f
            if "alpha" in history_keys:
                entry["alpha"] = alpha.cpu().numpy() if isinstance(alpha, torch.Tensor) else alpha
            if "cg_iters" in history_keys:
                entry["cg_iters"] = int(cg_info["iterations"])
            if "cg_res" in history_keys:
                entry["cg_res"] = cg_info["res"].cpu().numpy()
            if "cg_res_history" in history_keys and "res_history" in cg_info:
                entry["cg_res_history"] = cg_info["res_history"].cpu().numpy()
            if "gradnorm" in history_keys:
                gn = field_norm(g)
                entry["gradnorm"] = gn.cpu().numpy() if batched else np.asarray(float(gn))
            if "precision_fallback" in history_keys:
                entry["precision_fallback"] = bool(cg_info.get("precision_fallback", False))
            if "retry" in history_keys:
                entry["retry"] = retried
            if "nfev" in history_keys:
                entry["nfev"] = nfev
            history.append(entry)
            # the secant pair: the point where g was evaluated, before the step
            prev_phi_mix, prev_g = phi_mix, g
            if step > minsteps and dnorm * alpha_s < gradtol:
                break
    return dict(f=f, phi=phi, history=history)


# =========================================================================
# MAP_marg
# =========================================================================

def _phi_gradient(dstheta, theta, phi, f, d):
    """grad_phi of logpdf(f, phi, theta) with data d at fixed f, summed
    over the batch entries (one gradient an entry), in phi's map basis."""
    if _needs_term_split(phi):
        return _term_split_fgrad(lambda p, w: torch.sum(dstheta.logpdf_term(
            f=f, phi=p, theta=theta, d=d, which=w)), TERMS, phi)
    _, g = fvalue_and_grad(
        lambda p: torch.sum(dstheta.logpdf(f=f, phi=p, theta=theta, d=d)))(phi)
    return g


def _marg_simulate_d(ds, theta, phi_b, generator, draw):
    """The data of MAP_marg's mean-field simulations at the batched phi_b,
    one an entry of phi_b, f and the noise drawn from `generator`; `draw`
    counts the calls of a run from 0 (a test replays another
    implementation's draws by it)."""
    return ds.simulate(generator, theta=theta, phi=phi_b, batch_shape=phi_b.batch_shape)["d"]


def _marg_update(ds, theta, phi, g_data, gbar, alpha):
    """phi + alpha Hinv (g_data - gbar - Cphi^-1 phi), Hinv = (Cphi^-1 +
    Nphi^-1)^-1, and the norm of the gradient it steps along."""
    Cphi = evaluate_at(ds.Cphi, theta)
    Nphi = evaluate_at(ds.Nphi, theta)
    hinv = nan2zero(safe_reciprocal(safe_reciprocal(Cphi.diag.arr)
                                    + safe_reciprocal(Nphi.diag.to(Cphi.diag.basis).arr)))
    Hinv = Diag(Field(hinv, Cphi.diag.basis, Cphi.diag.proj))
    g = g_data - gbar.to(g_data.basis) - Cphi.solve(phi).to(g_data.basis)
    return phi + alpha * (Hinv @ g).to(phi.basis), field_norm(g)


def MAP_marg(ds: DataSet, theta=None, generator=None, phistart=None, nsteps=10,
             nsteps_with_meanfield_update=4, conjgrad_kwargs=None, alpha=0.2, Nsims=50,
             progress=False, mesh=None, precision="auto"):
    """MAP of the marginal posterior P(phi | d) by mean-field-subtracted
    gradient steps (reference src/maximization.jl): each step Wiener-filters
    the data at phi (CG, conjgrad_kwargs), takes the phi-gradient of the
    logpdf at that f, and steps phi <- phi + alpha Hinv (g_data - gbar -
    Cphi^-1 phi). The mean field gbar is the mean phi-gradient over Nsims
    simulations at the current phi, their Wiener filters and gradients run
    as one batch; it is updated in the first nsteps_with_meanfield_update
    steps and kept after. Draws come from `generator` (a torch.Generator
    on ds's device, seeded 0 when not given; the JAX package takes a key)
    through `_marg_simulate_d`. precision: "auto" (= 'high'), 'high' or
    'bf16' runs the phi-gradients at that precision, 'f32' strict; None is
    strict everywhere, the f-steps included. mesh (a parallel/mesh.py
    mesh with a "batch" dimension): the sims split over its ranks, each
    simulating the whole ensemble and keeping its entries, the mean
    field one all_reduce, every rank returning the same phi (a batch that
    does not divide over the ranks runs whole on each). Returns (phi,
    history), history one dict(step, phi, gradnorm) a step."""
    _check_precision(precision, "precision", (None, "auto", "f32", "high", "bf16"))
    shard = None
    if mesh is not None:
        from ..parallel.mesh import batch_shard
        shard = batch_shard(mesh, Nsims)
    nlocal = shard.n if shard is not None else Nsims
    theta = theta or {}
    cg = dict(tol=1e-1, nsteps=500)
    cg.update(conjgrad_kwargs or {})
    if precision is None:
        cg.setdefault("hessian_precision", None)
    dstheta = ds.at(theta).replace(G=Id)
    Cphi = _fid(dstheta.Cphi)
    phi = phistart if phistart is not None else _zero_map_like(Cphi)
    if generator is None:
        generator = torch.Generator(device=phi.device)
        generator.manual_seed(0)
    prec = "high" if precision == "auto" else precision

    def phi_gradient(phi_, f_, d_):
        with _pctx(prec):
            return _phi_gradient(dstheta, theta, phi_, f_, d_)

    history = []
    f_wf = f_wf_sims = gbar = None
    for step in range(1, nsteps + 1):
        with timed("MAP_marg/data"):
            f_wf, _ = argmaxf_logpdf(dstheta, phi=phi, theta=theta, fstart=f_wf,
                                     conjgrad_kwargs=cg)
            g_data = phi_gradient(phi, f_wf, dstheta.d)
        if step <= nsteps_with_meanfield_update:
            with timed("MAP_marg/mean_field"):
                with torch.no_grad():
                    # every rank simulates the whole ensemble, as the
                    # unsharded run does, and keeps its entries
                    d_sims = _marg_simulate_d(dstheta, theta, repeat_batch(phi, Nsims),
                                              generator, step - 1)
                if shard is not None:
                    d_sims = shard.slice(d_sims)
                phi_b = repeat_batch(phi, nlocal)
                f_wf_sims, _ = argmaxf_logpdf(dstheta.replace(d=d_sims), phi=phi_b, theta=theta,
                                              fstart=f_wf_sims, conjgrad_kwargs=cg, shard=shard)
                g_sims = phi_gradient(phi_b, f_wf_sims, d_sims)
                gmean = (torch.mean(g_sims.arr, dim=0) if shard is None
                         else shard.reduce(torch.sum(g_sims.arr, dim=0), "sum") / Nsims)
                gbar = Field(gmean, g_sims.basis, g_sims.proj)
        if gbar is None:
            # no mean-field estimate yet (nsteps_with_meanfield_update < 1)
            gbar = zeros_like_field(g_data)
        with torch.no_grad():
            phi, gnorm = _marg_update(dstheta, theta, phi, g_data, gbar, alpha)
        history.append(dict(step=step, phi=phi, gradnorm=float(gnorm)))
        if progress:
            print(f"MAP_marg step {step}: |g|={float(gnorm):.3g}")
    return phi, history
