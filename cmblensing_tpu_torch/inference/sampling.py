"""Gibbs/HMC sampling of the joint lensing posterior.

Counterpart of ``cmblensing_tpu/inference/sampling.py`` (reference
src/sampling.jl): the leapfrog integrator is a Python loop of N
gradients taken by autograd through ``Mixed.logpdf``; HMC accepts or
rejects each batch entry (chain) on its own; chains are the leading
batch axis of every field, so a Gibbs pass over 32 chains runs each
LenseFlow flow once, with chains x components on the kernels' grids;
checkpoints are CRC-protected records appended by the native writer
(``native/``), from which a run resumes.

Randomness comes from one ``torch.Generator`` held in the state under
"generator" (where the JAX package splits keys): every normal draw goes
through ``core/ops.py::simulate_op`` (white noise by
``core/field.py::white_noise_like``), every uniform through `_uniform`.

``sample_joint(mesh=...)`` splits the chains over the ranks of the
mesh's "batch" dimension (parallel/mesh.py::batch_shard), whose
core/shard.py::BatchShard the state holds under "shard": every rank
holds the whole generator state and draws the whole batch's numbers,
keeping its chains' (`_draw`, maximization.py::simulate_entries), so
that each chain gets the numbers it gets unsharded; the theta pass grids
every chain's logpdf on every rank; the records are gathered, so the
chains come back whole on every rank, and rank 0 alone writes the
checkpoints, from which every rank resumes.
"""
from __future__ import annotations

import os
import pickle
import warnings
from functools import partial

import numpy as np
import torch

from ..core.field import Field, dot as field_dot, fgrad, batch_broadcast, repeat_batch, \
    zeros_like_field
from ..core.ops import Diag, safe_reciprocal, simulate_op
from ..core.proj import ProjLambert
from ..models.dataset import DataSet, Mixed, mix, unmix
from ..utils.progress import progress_bar
from ..utils.timing import timed, timer_report, timers_snapshot
from .maximization import _argmaxf_core, _fid, simulate_entries

# what a sampler state holds besides its chains: the source of its draws
# and, under mesh=, which chains are this rank's; never saved or gathered
_RUNTIME = ("generator", "shard")


def _uniform(generator, shape):
    """Uniform [0, 1) draws of `shape` from `generator`, on its device."""
    return torch.rand(shape, generator=generator, device=generator.device)


def _draw(shard, batch_shape, make):
    """make(batch_shape), or with a shard (batch_shape's leading axis this
    rank's chains) make(the whole batch's shape) sliced to them."""
    if shard is None:
        return make(tuple(batch_shape))
    return shard.slice(make((shard.total,) + tuple(batch_shape)[1:]))


# =========================================================================
# symplectic integration (reference src/sampling.jl:14-46)
# =========================================================================

def symplectic_integrate(x0, p0, Lambda, U_grad, N=50, eps=0.1, U=None):
    """Leapfrog integration of the potential U with mass matrix Lambda,
    N steps of size eps. U_grad(x) is the gradient of U at x (a Field).
    Returns (dH, x, p), dH the change of H(x, p) = U(x) - p' Lambda^-1 p / 2
    (None without U), in the reference's sign conventions (U = logpdf)."""

    def energy(x, p):
        quad = field_dot(p, Lambda.solve(p))
        return -quad / 2 if U is None else U(x) - quad / 2

    x, p, gU = x0, p0, U_grad(x0)
    for _ in range(N):
        x1 = x - eps * Lambda.solve(p - (eps / 2) * gU)
        gU1 = U_grad(x1)
        p = p - (eps / 2) * (gU1 + gU)
        x, gU = x1, gU1
    dH = energy(x, p) - energy(x0, p0) if U is not None else None
    return dH, x, p


def mass_matrix_phi(theta, ds: DataSet):
    """pinv(G)^2 (pinv(Cphi) + pinv(Nphi)) at theta (src/sampling.jl:422-425)."""
    dst = ds.at(theta or {})
    G, Cphi, Nphi = _fid(dst.G), _fid(dst.Cphi), _fid(dst.Nphi)
    icp = safe_reciprocal(Cphi.diag.arr)
    inp = safe_reciprocal(Nphi.diag.to(Cphi.diag.basis).arr)
    ig2 = safe_reciprocal(G.diag.to(Cphi.diag.basis).arr) ** 2 if isinstance(G, Diag) else 1.0
    return Diag(Field(ig2 * (icp + inp), Cphi.diag.basis, Cphi.diag.proj))


def hmc_step(generator, U, x, Lambda, U_grad=None, N=25, eps=0.01, always_accept=False,
             shard=None):
    """One HMC step (src/sampling.jl:405-419): a momentum p ~ N(0, Lambda)
    of x's batch shape, a leapfrog trajectory, and each batch entry
    accepted where log(u) < dH (u uniform) or always_accept. U is the
    log-posterior, per batch entry. With a shard (x this rank's chains)
    the draws are the whole batch's, sliced. Returns (x, dH, accept)."""
    if U_grad is None:
        U_grad = fgrad(lambda y: torch.sum(U(y)))
    p = _draw(shard, x.batch_shape, lambda bs: simulate_op(generator, Lambda, batch_shape=bs))
    dH, xt, _ = symplectic_integrate(x, p.to(x.basis), Lambda, U_grad, N=N, eps=eps, U=U)
    logu = torch.log(_draw(shard, dH.shape, lambda bs: _uniform(generator, bs)))
    accept = torch.logical_or(torch.as_tensor(bool(always_accept), device=dH.device), logu < dH)
    x_new = Field(torch.where(batch_broadcast(accept, x), xt.to(x.basis).arr, x.arr), x.basis,
                  x.proj)
    return x_new, dH, accept


# =========================================================================
# 1-D gridded slice sampling (reference grid_and_sample,
# src/sampling.jl:80-135)
# =========================================================================

def grid_and_sample(generator, logpdf_fn, xs, nsamples=1, smooth_frac=0.1, batched=False):
    """Evaluate a 1-D logpdf on the grid xs, smooth it, and draw nsamples
    by inverse-transform sampling, one uniform draw of `generator` per
    sample. logpdf_fn may return one value per batch entry, and then each
    entry is sampled on its own; with batched=True it takes the whole grid
    and returns (nx,) or (nx, nbatch).

    Returns (samples, interpolated logpdf callable(s), grid logpdfs)."""
    xs = np.asarray(xs, dtype=np.float64)
    as_np = lambda v: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v,
                                 dtype=np.float64)
    if batched:
        lps = as_np(logpdf_fn(xs)).reshape(len(xs), -1)            # (nx, nbatch)
    else:
        lps = np.stack([np.atleast_1d(as_np(logpdf_fn(float(x)))) for x in xs])
    nb = lps.shape[1]
    out = np.zeros((nsamples, nb))
    interp_fns = []
    for b in range(nb):
        lp = lps[:, b].copy()
        finite = np.isfinite(lp)
        if not finite.any():
            # a poisoned chain: sample uniformly from the grid rather
            # than end the run with a zero-size reduction
            warnings.warn("grid_and_sample: no finite logpdf on the grid "
                          f"for batch entry {b}; sampling uniformly", stacklevel=2)
            finite = np.ones_like(finite)
            lp = np.zeros_like(lp)
        xs_b, lp_b = xs[finite], lp[finite]
        lp_b = lp_b - lp_b.max()
        # mild smoothing of the log pdf (the reference uses loess)
        if smooth_frac and len(lp_b) > 4:
            w = max(3, int(len(lp_b) * smooth_frac) | 1)
            kern = np.hanning(w)
            kern /= kern.sum()
            lp_s = np.convolve(np.pad(lp_b, w // 2, mode="edge"), kern, mode="valid")
        else:
            lp_s = lp_b
        pdf = np.exp(lp_s - lp_s.max())
        cdf = np.concatenate([[0], np.cumsum((pdf[1:] + pdf[:-1]) / 2 * np.diff(xs_b))])
        if cdf[-1] > 0:
            cdf /= cdf[-1]
        else:   # a pdf that underflowed everywhere: uniform
            cdf = np.linspace(0.0, 1.0, len(xs_b))
        r = _uniform(generator, (nsamples,)).cpu().numpy()
        out[:, b] = np.interp(r, cdf, xs_b)
        interp_fns.append(partial(np.interp, xp=xs_b, fp=lp_s))
    samples = out[0] if nsamples == 1 else out
    if nb == 1:
        samples = samples[..., 0] if np.ndim(samples) else samples
        return (float(samples) if np.ndim(samples) == 0 else samples,
                interp_fns[0], lps[:, 0])
    return samples, interp_fns, lps


# =========================================================================
# Gibbs passes (reference sample_joint, src/sampling.jl:180-335)
# =========================================================================
# Each pass takes and returns the state dict; the state's "generator" is
# the source of every draw, its "shard" (None unless under mesh=) says
# which chains of the whole batch's draws are this rank's. Passes run under torch.no_grad(), the HMC
# gradient enabling autograd for itself (core/field.py::fvalue_and_grad).

@torch.no_grad()
def gibbs_sample_f(state, ds, conjgrad_kwargs):
    """f from its conditional posterior by constrained simulation
    (src/maximization.jl:56-62): a simulation at phi, and the strict CG
    solve given d - d_sim, from state["f"] (reference src/sampling.jl:388)."""
    cg = dict(tol=1e-1, nsteps=500)
    cg.update(conjgrad_kwargs or {})
    theta, phi, shard = state["theta"], state["phi"], state.get("shard")
    sim = simulate_entries(ds, state["generator"], shard, theta=theta, phi=phi)
    df, _ = _argmaxf_core(ds, theta, phi, ds.d - sim["d"], state.get("f"), True, None, shard,
                          nsteps=int(cg["nsteps"]), tol=float(cg["tol"]),
                          fixed_iters=bool(cg.get("fixed_iters", False)))
    return dict(state, f=sim["f"] + df.to(sim["f"].basis))


@torch.no_grad()
def gibbs_mix(state, ds):
    m = mix(ds, f=state["f"], phi=state["phi"], theta=state["theta"])
    # phi° in its map basis: the HMC momenta and gradients live on the
    # pixels (core/field.py::fgrad)
    pm = m["phi_mix"]
    return dict(state, f_mix=m["f_mix"], phi_mix=pm.to(pm.basis.with_space("map")))


@torch.no_grad()
def gibbs_unmix(state, ds):
    u = unmix(ds, f_mix=state["f_mix"], phi_mix=state["phi_mix"], theta=state["theta"])
    return dict(state, f=u["f"], phi=u["phi"])


def _hmc_phi(ds, generator, f_mix, phi_mix, theta, N, eps, always_accept, shard=None):
    """One HMC trajectory on phi° of the mixed posterior at fixed f°."""
    mixed = Mixed(ds)

    def U(pm):
        return mixed.logpdf(f_mix=f_mix, phi_mix=pm, theta=theta)

    return hmc_step(generator, U, phi_mix, mass_matrix_phi(theta, ds), N=N, eps=eps,
                    always_accept=always_accept, shard=shard)


@torch.no_grad()
def gibbs_sample_phi(state, ds, symp_kwargs, always_accept=False):
    """An HMC step on phi° for each entry of symp_kwargs (N, eps)."""
    phi_mix, dH, accept = state["phi_mix"], None, None
    for kw in symp_kwargs:
        phi_mix, dH, accept = _hmc_phi(ds, state["generator"], state["f_mix"], phi_mix,
                                       state["theta"], int(kw.get("N", 25)),
                                       float(kw.get("eps", 0.01)), bool(always_accept),
                                       state.get("shard"))
    return dict(state, phi_mix=phi_mix, dH=dH, accept=accept)


def gibbs_sample_slice_theta(name, xs):
    """A pass that slice-samples the scalar theta[name] on the grid xs
    (reference gibbs_sample_slice_θ!, src/sampling.jl:427-437): the mixed
    logpdf at each grid value in turn, each evaluation over every chain
    at once; one value a chain. With the state's shard every rank grids
    every chain's logpdf and draws for each, keeping its chains'."""

    @torch.no_grad()
    def pass_fn(state, ds, **_):
        theta = dict(state["theta"])
        mixed = Mixed(ds)
        shard = state.get("shard")

        def lp_grid(vs):
            lps = torch.stack([mixed.logpdf(f_mix=state["f_mix"], phi_mix=state["phi_mix"],
                                            theta=dict(theta, **{name: float(v)}))
                               for v in vs])
            return lps if shard is None or lps.ndim < 2 else shard.gather(lps.T).T

        val, _, _ = grid_and_sample(state["generator"], lp_grid, xs, batched=True)
        if shard is not None and np.size(val) == shard.total > 1:
            val = shard.slice(np.asarray(val))
        else:
            val = float(np.asarray(val).ravel()[0]) if np.size(val) == 1 else val
        theta[name] = val
        return dict(state, theta=theta)

    return pass_fn


@torch.no_grad()
def gibbs_postprocess(state, ds):
    phi, f = state["phi"], state["f"]
    lp = ds.logpdf(f=f, phi=phi, theta=state["theta"])
    return dict(state, logpdf=lp, ft=ds.L(phi) @ f)


def sample_joint(ds: DataSet, nsamps_per_chain, nchains=1, generator=None, theta_range=None,
                 theta_start=None, phi_start="prior", nhmc=1, symp_kwargs=None,
                 nburnin_always_accept=10, conjgrad_kwargs=None, filename=None, resume=None,
                 nfilewrite=5, nsavemaps=1, progress=False, verbose_timing=False,
                 gibbs_passes=None, mesh=None):
    """Gibbs-sample P(f, phi, theta | d) over nchains chains, the leading
    batch axis of every field (d repeated per chain unless batched).

    The default pass (src/sampling.jl:186-193): f by the CG f-step ->
    mix -> HMC on phi° (symp_kwargs, each step accepted while the step
    number is at most nburnin_always_accept) -> a slice pass for each
    theta in theta_range (a grid of values) -> unmix -> logpdf and the
    lensed f. gibbs_passes replaces it with a list of pass(state, ds).
    phi starts from the prior ("prior"), zero (0 or None) or the given
    field; theta from theta_start, else a uniform draw over its range.
    `generator` (a torch.Generator on ds's device, seeded 0 when not
    given) is the source of every draw.

    Checkpoints: with `filename`, records of the last nfilewrite steps
    (fields every nsavemaps steps, on the host) are appended to
    <filename>.ckpt by the native writer; resume=True continues from the
    last record, its draws where they left off. verbose_timing prints
    each step's split by pass. mesh (a parallel/mesh.py mesh with a
    "batch" dimension) splits the chains over its ranks (module
    docstring), the passes reading this rank's core/shard.py::BatchShard
    from the state's "shard"; nchains that do not divide over them run
    whole on each.
    Returns Chains with one batched chain."""
    shard = None
    if mesh is not None:
        from ..parallel.mesh import batch_shard
        shard = batch_shard(mesh, nchains)
    nlocal = shard.n if shard is not None else nchains
    whole = (lambda st: _gather_state(st, shard)) if shard is not None else (lambda st: st)
    writes = mesh is None or torch.distributed.get_rank() == 0
    proj = ds.d.proj
    if generator is None:
        generator = torch.Generator(device=proj.device)
        generator.manual_seed(0)
    symp_kwargs = symp_kwargs or [dict(N=25, eps=0.01)] * nhmc
    cg = dict(tol=1e-1, nsteps=500)
    cg.update(conjgrad_kwargs or {})
    theta_range = theta_range or {}
    Cphi = _fid(ds.Cphi)

    start_step = 0
    chain = []
    if filename and resume and os.path.exists(_ckpt_name(filename)):
        states, start_step = _load_last_chunk(filename, proj, generator)
        if shard is not None:
            states = _slice_state(states, shard)
        if progress:
            print(f"Resuming chains at step {start_step}")
    else:
        theta = dict(theta_start or {})
        for name, rng_ in theta_range.items():
            if name not in theta:
                lo, hi = float(np.min(rng_)), float(np.max(rng_))
                theta[name] = lo + (hi - lo) * float(_uniform(generator, ()))
        with torch.no_grad():
            if isinstance(phi_start, str) and phi_start == "prior":
                phi = _draw(shard, (nlocal,),
                            lambda bs: simulate_op(generator, Cphi, batch_shape=bs))
                phi = phi.to(phi.basis.with_space("map"))
            elif phi_start is None or (not isinstance(phi_start, Field) and phi_start == 0):
                phi = repeat_batch(zeros_like_field(Cphi.diag).to(
                    Cphi.diag.basis.with_space("map")), nlocal)
            elif phi_start.batch_shape:
                phi = phi_start if shard is None else shard.slice(phi_start)
            else:
                phi = repeat_batch(phi_start, nlocal)
        states = dict(generator=generator, phi=phi, theta=theta, step=0)
    states["shard"] = shard
    if ds.d.batch_shape:
        ds_b = ds if shard is None else ds.replace(d=shard.slice(ds.d))
    else:
        ds_b = ds.replace(d=repeat_batch(ds.d, nlocal))

    if gibbs_passes is None:
        def passes(state):
            with timed("gibbs/sample_f"):
                state = gibbs_sample_f(state, ds_b, cg)
            with timed("gibbs/mix"):
                state = gibbs_mix(state, ds_b)
            with timed("gibbs/sample_phi"):
                state = gibbs_sample_phi(state, ds_b, symp_kwargs,
                                         always_accept=state["step"] <= nburnin_always_accept)
            with timed("gibbs/sample_theta"):
                for name, rng_ in theta_range.items():
                    state = gibbs_sample_slice_theta(name, rng_)(state, ds_b)
            with timed("gibbs/unmix"):
                state = gibbs_unmix(state, ds_b)
            with timed("gibbs/postprocess"):
                state = gibbs_postprocess(state, ds_b)
            return state
    else:
        def passes(state):
            for p in gibbs_passes:
                with timed(f"gibbs/{getattr(p, '__name__', 'pass')}"):
                    state = p(state, ds_b)
            return state

    # the native writer appends on its own thread: sampling never waits
    # on the disk; records are CRC-protected for a crash's resume
    writer = None
    if filename and writes:
        from ..native import CheckpointWriter
        writer = CheckpointWriter(_ckpt_name(filename), append=bool(resume))
    chunk = []
    try:
        with progress_bar(nsamps_per_chain - start_step, "sample_joint",
                          enabled=progress) as pbar:
            for step in range(start_step + 1, nsamps_per_chain + 1):
                states["step"] = step
                snap = timers_snapshot() if verbose_timing else None
                states = passes(states)
                if verbose_timing:
                    print(f"--- gibbs step {step} timing ---\n" + timer_report(since=snap),
                          flush=True)
                entry = _filter_for_saving(whole(_saved(states, step, nsavemaps)), step,
                                           nsavemaps)
                chain.append(entry)
                chunk.append(entry)
                if progress:
                    sv = {k: float(torch.mean(torch.as_tensor(entry[k], dtype=torch.float64)))
                          for k in ("logpdf", "accept") if entry.get(k) is not None}
                    pbar.update(**sv)
                if filename and step % nfilewrite == 0:
                    full = whole(states)
                    if writer:
                        _write_chunk(writer, chunk, full)
                    chunk = []
            if filename and chunk:
                full = whole(states)
                if writer:
                    _write_chunk(writer, chunk, full)
    finally:
        if writer:
            writer.flush()
            writer.close()
    if mesh is not None:
        # every rank returns after rank 0 has closed the checkpoint
        from ..parallel.mesh import barrier
        barrier(mesh)

    from .chains import Chains
    return Chains([chain])


def once_every(n, gibbs_pass):
    """Run a Gibbs pass only every n steps (src/sampling.jl:469-477)."""

    def wrapped(state, ds, **kw):
        return gibbs_pass(state, ds, **kw) if state["step"] % n == 0 else state

    return wrapped


def start_after_burnin(n, gibbs_pass):
    """Run a Gibbs pass only after n burn-in steps (src/sampling.jl:479-487)."""

    def wrapped(state, ds, **kw):
        return gibbs_pass(state, ds, **kw) if state["step"] > n else state

    return wrapped


# =========================================================================
# checkpoints: host copies, pickled into the native writer's records
# =========================================================================

def _host(v):
    """v's copy on the host: a Field on its projection's CPU twin, a
    tensor on the CPU, anything else as it is."""
    if isinstance(v, Field):
        p = v.proj
        return Field(v.arr.detach().cpu(), v.basis,
                     ProjLambert(p.Ny, p.Nx, p.thetapix, p.T, device="cpu"))
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    return v


def _filter_for_saving(state, step, nsavemaps):
    """What a chain keeps of a step: everything but the generator and the
    shard, on the host, fields only every nsavemaps steps."""
    return dict({k: _host(v) for k, v in state.items()
                 if k not in _RUNTIME and (not isinstance(v, Field) or step % nsavemaps == 0)},
                step=step)


def _saved(state, step, nsavemaps):
    """The entries of the state a step's record keeps (`_filter_for_saving`)."""
    return {k: v for k, v in state.items()
            if k not in _RUNTIME and (not isinstance(v, Field) or step % nsavemaps == 0)}


def _per_chain(v, n):
    return ((isinstance(v, Field) and v.batch_shape[:1] == (n,))
            or (isinstance(v, (torch.Tensor, np.ndarray)) and v.ndim >= 1 and v.shape[0] == n))


def _gather_state(state, shard):
    """A state whose per-chain values (fields, tensors and theta arrays
    with this rank's chains leading) hold every chain, on every rank."""
    def one(v):
        if isinstance(v, dict):
            return {k: one(w) for k, w in v.items()}
        if not _per_chain(v, shard.n):
            return v
        if isinstance(v, Field):
            return Field(shard.gather(v.arr), v.basis, v.proj)
        if isinstance(v, np.ndarray):
            return shard.gather(torch.as_tensor(v)).numpy()
        if v.dtype == torch.bool:
            return shard.gather(v.to(torch.uint8)).bool()
        return shard.gather(v)
    return {k: (v if k in _RUNTIME else one(v)) for k, v in state.items()}


def _slice_state(state, shard):
    """This rank's chains of a whole state (a resumed checkpoint's)."""
    def one(v):
        if isinstance(v, dict):
            return {k: one(w) for k, w in v.items()}
        return shard.slice(v) if _per_chain(v, shard.total) else v
    return {k: (v if k in _RUNTIME else one(v)) for k, v in state.items()}


def _ckpt_name(filename):
    return f"{filename}.ckpt"


def _write_chunk(writer, chunk, states):
    state = {k: _host(v) for k, v in states.items() if k not in _RUNTIME}
    state["generator_state"] = states["generator"].get_state()
    writer.write(pickle.dumps(dict(chunk=chunk, state=state)))


def _load_last_chunk(filename, proj, generator):
    """The state of the last valid record, its fields and tensors on
    proj's device, its draws continuing in `generator`; and its step."""
    from ..native import read_records
    recs = read_records(_ckpt_name(filename))
    if not recs:
        raise FileNotFoundError(f"no valid checkpoint records in {_ckpt_name(filename)}")
    saved = pickle.loads(recs[-1])["state"]
    generator.set_state(saved.pop("generator_state"))
    dev = proj.device
    states = {k: (Field(v.arr.to(dev), v.basis, proj) if isinstance(v, Field)
                  else v.to(dev) if isinstance(v, torch.Tensor) else v)
              for k, v in saved.items()}
    states["generator"] = generator
    return states, int(states["step"])
