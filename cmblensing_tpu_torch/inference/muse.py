"""MUSE: Marginal Unbiased Score Expansion (Millea & Seljak 2021).

Counterpart of ``cmblensing_tpu/inference/muse.py``. MUSE estimates theta
from the score of the joint posterior at each dataset's latent MAP,

    s_i(theta, d) = d/dtheta_i logP(d, zhat(theta, d) | theta),

solving s(theta, data) = E_{d ~ P(d|theta)}[s(theta, d)] by quasi-Newton
iteration; the Jacobian H and the score covariance J of the simulations
give the posterior covariance Sigma = H^-1 J H^-T. The simulation ensemble
is the batch axis of one batched MAP_joint.

Theta entries are scalars (Aphi=1.0) or 1-D vectors of bandpower
amplitudes (Aphi_b=np.ones(4), driving a banded Cl_to_Cov). Inside, theta
is one flat vector: a "spec", a tuple of (name, size) with size None for a
scalar, says how to unpack it.

The per-sim theta-score is taken at fixed (f_hat, phi_hat), so no flow is
on theta's graph: theta is made per chain, one row of the flat vector a
simulation, so that entry i's logpdf depends on row i alone, and ONE
backward pass of the summed logpdf gives every simulation's score (the
JAX package differentiates forward, one pass a theta entry). Theta is
float64 there, so that the covariances it scales, their logdets and the
gradient's sums over the modes are float64: a bandpower score is ~n/2A
for the n modes of its bin (~8e3 at 256^2), while H's finite differences
move it by ~1e-3 or less, below float32's resolution of the score and its
atomically summed gradient (the JAX package: float32).

The finite differences of H reuse each draw's random numbers on purpose:
every simulation of one draw, at whatever theta, starts from the
generator state the draw began with (`_simulate_sims`), so the noise,
f and phi realisations cancel in the differences (the JAX package reuses
the draw's key).

``mesh=`` splits each ensemble over the ranks of the mesh's "batch"
dimension (parallel/mesh.py::batch_shard): each rank simulates the whole
ensemble and keeps its sims, runs their batched MAP_joint (its stop tests
and line-search verdicts read every rank's entries: `shard=`,
core/shard.py) and their scores, and the scores are gathered, so that
every rank holds the same sbar, J, H and theta.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.dataset import DataSet
from ..utils.timing import timed
from .maximization import MAP_joint


# --- theta as one flat vector ----------------------------------------------

def _theta_spec(theta0):
    """(name, size) of each theta entry in dict order, size None for a
    scalar and the length for a 1-D vector."""
    spec = []
    for k, v in theta0.items():
        a = np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
        if a.ndim > 1:
            raise ValueError(f"theta entry {k!r} must be scalar or 1-D")
        spec.append((k, None if a.ndim == 0 else int(a.shape[0])))
    return tuple(spec)


def _spec_size(spec):
    return sum(1 if s is None else s for _, s in spec)


def _spec_unpack(tvec, spec):
    """A flat vector (numpy or torch) -> theta dict; torch slices keep
    their graph. A (nchains, nflat) tensor gives per-chain values: a
    scalar entry (nchains,), a vector one (nchains, size)."""
    th, i = {}, 0
    for n, s in spec:
        if s is None:
            th[n] = tvec[..., i]
            i += 1
        else:
            th[n] = tvec[..., i:i + s]
            i += s
    return th


def _spec_pack(theta, spec):
    """theta dict -> flat float64 numpy vector."""
    parts = []
    for n, s in spec:
        v = theta[n]
        v = np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v, dtype=np.float64)
        parts.append(v.reshape(1 if s is None else s))
    return np.concatenate(parts)


def _spec_labels(spec):
    out = []
    for n, s in spec:
        out.extend([n] if s is None else [f"{n}[{j}]" for j in range(s)])
    return out


def _theta_vec(theta, spec, device):
    """The flat theta, float64 (see the module docstring)."""
    return torch.as_tensor(_spec_pack(theta, spec), dtype=torch.float64, device=device)


# --- the theta-score at fixed latents ----------------------------------------

def _theta_score_batch(ds, f_hat, phi_hat, tvec, spec):
    """Per-sim scores d/dtheta logpdf_i at the batched (f_hat, phi_hat) of
    ds's batched data, (nsims, nflat): theta made per chain, one row of
    tvec a simulation, and one backward pass of the summed logpdf."""
    nsims = f_hat.batch_shape[0]
    t = tvec.reshape(1, -1).expand(nsims, -1).clone().requires_grad_(True)
    with torch.enable_grad():
        lp = ds.logpdf(f=f_hat, phi=phi_hat, theta=_spec_unpack(t, spec))
        (g,) = torch.autograd.grad(torch.sum(lp), t)
    return g


def _theta_score(ds, f_hat, phi_hat, tvec, spec, theta=None):
    """d/dtheta of the logpdf summed over ds's batch entries at fixed
    (f_hat, phi_hat), (nflat,); theta's entries outside spec are held at
    their values in `theta`."""
    rest = {k: v for k, v in (theta or {}).items() if k not in dict(spec)}
    if f_hat.batch_shape and not rest:
        return _theta_score_batch(ds, f_hat, phi_hat, tvec, spec).sum(0)
    t = tvec.clone().requires_grad_(True)
    with torch.enable_grad():
        lp = ds.logpdf(f=f_hat, phi=phi_hat, theta={**rest, **_spec_unpack(t, spec)})
        (g,) = torch.autograd.grad(torch.sum(lp), t)
    return g


def score(ds: DataSet, theta, names=None, d=None, phi=None, MAP_kwargs=None):
    """s_i = d/dtheta_i logpdf(d, f_hat, phi_hat | theta) at the joint MAP
    (f_hat, phi_hat) given theta (MAP_kwargs go to MAP_joint; nsteps 10
    unless given), for the entries of theta named in `names` (all unless
    given), the others held at theta's values. Returns (the flat score, a
    tensor: scalars one entry, vectors one an element, in dict order;
    phi_hat)."""
    MAP_kwargs = dict(MAP_kwargs or {})
    MAP_kwargs.setdefault("nsteps", 10)
    dsd = ds if d is None else ds.replace(d=d)
    res = MAP_joint(dsd, theta=theta, phistart=phi, **MAP_kwargs)
    sub = theta if names is None else {n: theta[n] for n in names}
    spec = _theta_spec(sub)
    g = _theta_score(dsd, res["f"], res["phi"], _theta_vec(sub, spec, res["phi"].device), spec,
                     theta)
    return g, res["phi"]


# --- the simulation ensemble ---------------------------------------------------

def _simulate_sims(ds, theta, draw, nsims, generator, state):
    """The data of MUSE's draw number `draw`: nsims simulations of ds at
    theta, batched, drawn from `generator` set to `state` first, the state
    it had when the draw began, so that every theta of one draw sees the
    same random numbers (seed-matched differences)."""
    generator.set_state(state)
    return ds.simulate(generator, theta=theta, batch_shape=(nsims,))["d"]


def muse(ds: DataSet, theta0, nsims=20, nsteps=5, alpha=0.7, generator=None, MAP_kwargs=None,
         step_eps=None, progress=False, mesh=None, final_H=True):
    """The MUSE iteration for the parameters of theta0 (a dict of scalars
    and 1-D bandpower vectors), over nsims simulations a draw.

    Each of nsteps steps: the score of the data at its MAP (`score`); the
    scores of nsims simulations at theta, ONE batched MAP_joint over the
    ensemble (warm-started from the last ensemble's phi); at the first
    step H by one-sided forward differences, one column a flat theta
    entry (theta_sim moved by step_eps, the evaluation point fixed, the
    draw's random numbers reused); theta <- theta + alpha H^-1 (s_data -
    sbar), each entry's step capped at half of max(|theta|, 0.1). With
    final_H, H and J are recomputed at the last theta from a new draw by
    seed-matched two-sided differences, 2 nflat + 1 batched MAPs. step_eps
    (a dict like theta0) defaults to 0.1 max(|theta|, 0.1) at theta0 for
    the iteration's H and at the last theta for the final one (the JAX
    package: at theta0 for both). Draws come
    from `generator` (a torch.Generator on ds's device, seeded 0 when not
    given; the JAX package takes a key) through `_simulate_sims`.

    mesh (a parallel/mesh.py mesh with a "batch" dimension) splits each
    ensemble over its ranks (module docstring); a nsims that does not
    divide over them runs whole on each.

    Returns dict(theta, history, H, J, Sigma = H^-1 J H^-T, labels), the
    matrices (nflat, nflat) over the flat entries named by labels; each
    history entry holds the step's theta (after it), s_data, sbar and the
    H it stepped with."""
    shard = None
    if mesh is not None:
        from ..parallel.mesh import batch_shard
        shard = batch_shard(mesh, nsims)
    spec = _theta_spec(theta0)
    nflat = _spec_size(spec)
    tflat = _spec_pack(theta0, spec)
    device = ds.d.device
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    def eps_at(tvec):
        """The finite-difference step of each flat entry: step_eps, or
        0.1 max(|theta|, 0.1) at tvec."""
        if step_eps is None:
            return 0.1 * np.maximum(np.abs(tvec), 0.1)
        return _spec_pack({n: np.broadcast_to(np.asarray(step_eps[n], np.float64),
                                              () if s is None else (s,))
                           for n, s in spec}, spec)

    eps_flat = eps_at(tflat)

    def as_dict(vec):
        th = _spec_unpack(np.asarray(vec, np.float64), spec)
        return {n: (float(th[n]) if s is None else np.asarray(th[n])) for n, s in spec}

    theta = as_dict(tflat)
    MAP_kw = dict(MAP_kwargs or {})
    MAP_kw.setdefault("nsteps", 10)
    states = []

    def mean_sim_score(theta_sim, theta_eval, draw, phis, label):
        """Scores s(theta_eval, d_i), (nsims, nflat), of the draw's sims
        d_i ~ P(d | theta_sim): one batched MAP_joint over the ensemble,
        its phi kept in phis[0] for the next warm start."""
        with timed("muse/simulate"), torch.no_grad():
            d_b = _simulate_sims(ds, theta_sim, draw, nsims, generator, states[draw])
        dsd = ds.replace(d=d_b if shard is None else shard.slice(d_b))
        with timed(label):
            res = MAP_joint(dsd, theta=theta_eval, phistart=phis[0], shard=shard, **MAP_kw)
        phis[0] = res["phi"]
        with timed("muse/theta_score"):
            s = _theta_score_batch(dsd, res["f"], res["phi"], _theta_vec(theta_eval, spec, device),
                                   spec)
            if shard is not None:
                s = shard.gather(s)
        return s.cpu().numpy().reshape(nsims, nflat)

    def new_draw():
        states.append(generator.get_state())
        return len(states) - 1

    history, phi_data, sims_phi, H = [], None, [None], None
    for step in range(1, nsteps + 1):
        draw = new_draw()
        with timed("muse/data"):
            s_data, phi_data = score(ds, theta, phi=phi_data, MAP_kwargs=MAP_kwargs)
        s_data = s_data.cpu().numpy()
        s_sims = mean_sim_score(theta, theta, draw, sims_phi, "muse/ensemble_MAP")
        sbar = s_sims.mean(axis=0)
        J = np.atleast_2d(np.cov(s_sims.T)) if nsims > 1 else np.eye(nflat)
        if H is None:
            # H_ij = d/dtheta_sim_j E[s_i] at a fixed evaluation point, one
            # column a flat entry, the draw's random numbers reused
            H = np.zeros((nflat, nflat))
            tcur = _spec_pack(theta, spec)
            for j in range(nflat):
                tp = tcur.copy()
                tp[j] += eps_flat[j]
                s_p = mean_sim_score(as_dict(tp), theta, draw, [None], "muse/H_MAP").mean(axis=0)
                H[:, j] = (s_p - sbar) / eps_flat[j]
        # F(theta) = s_data - sbar(theta), dF/dtheta = -H: theta <- theta + H^-1 F
        dtheta = np.linalg.solve(H, s_data - sbar)
        tcur = _spec_pack(theta, spec)
        cap = 0.5 * np.maximum(np.abs(tcur), 0.1)
        theta = as_dict(tcur + np.clip(alpha * dtheta, -cap, cap))
        history.append(dict(step=step, theta=dict(theta), s_data=s_data, sbar=sbar, H=H.copy()))
        if progress:
            print(f"muse step {step}: theta={theta}")

    if final_H:
        # H and J again at the last theta, from a new draw: two-sided
        # differences with that draw's random numbers on both sides
        draw = new_draw()
        s_sims_f = mean_sim_score(theta, theta, draw, [sims_phi[0]], "muse/final_H_MAP")
        J = np.atleast_2d(np.cov(s_sims_f.T)) if nsims > 1 else np.eye(nflat)
        H = np.zeros((nflat, nflat))
        tcur = _spec_pack(theta, spec)
        # the default step follows theta (the JAX package keeps theta0's):
        # theta - eps keeps theta's sign where |theta| >= 0.01, so that an
        # amplitude the iteration took below theta0's step is not simulated
        # at a negative value (a NaN covariance root; ROADMAP Queue 3)
        eps_flat = eps_at(tcur)
        for j in range(nflat):
            tp, tm = tcur.copy(), tcur.copy()
            tp[j] += eps_flat[j]
            tm[j] -= eps_flat[j]
            s_p = mean_sim_score(as_dict(tp), theta, draw, [None], "muse/final_H_MAP").mean(axis=0)
            s_m = mean_sim_score(as_dict(tm), theta, draw, [None], "muse/final_H_MAP").mean(axis=0)
            H[:, j] = (s_p - s_m) / (2 * eps_flat[j])

    Sigma = np.linalg.solve(H, J) @ np.linalg.inv(H).T
    return dict(theta=theta, history=history, H=H, J=J, Sigma=Sigma, labels=_spec_labels(spec))


class MuseProblem:
    """A DataSet as a generic MUSE problem, with the interface of the
    reference's CMBLensingMuseProblem: logLike, grad_theta_logLike,
    sample_x_z and zhat_at_theta, and `solve`, which runs `muse`."""

    def __init__(self, ds: DataSet, params=("Aphi",), MAP_joint_kwargs=None):
        self.ds = ds
        self.params = list(params)
        self.MAP_joint_kwargs = dict(MAP_joint_kwargs or {})
        self.MAP_joint_kwargs.setdefault("nsteps", 10)

    def _theta(self, theta):
        if isinstance(theta, dict):
            return theta
        t = torch.atleast_1d(torch.as_tensor(theta, dtype=torch.float32))
        return {n: t[i] for i, n in enumerate(self.params)}

    def logLike(self, d, z, theta):
        """The logpdf, summed over d's batch entries, at z = dict(f=...,
        phi=...)."""
        with torch.no_grad():
            return torch.sum(self.ds.replace(d=d).logpdf(theta=self._theta(theta), **z))

    def grad_theta_logLike(self, d, z, theta):
        """d/dtheta of logLike over the params, at fixed z."""
        th = self._theta(theta)
        sub = {n: th[n] for n in self.params}
        spec = _theta_spec(sub)
        return _theta_score(self.ds.replace(d=d), z["f"], z["phi"],
                            _theta_vec(sub, spec, z["phi"].device), spec, th)

    def sample_x_z(self, generator, theta):
        """A simulation at theta: dict(x=d, z=dict(f=..., phi=...))."""
        with torch.no_grad():
            sim = self.ds.simulate(generator, theta=self._theta(theta))
        return dict(x=sim["d"], z=dict(f=sim["f"], phi=sim["phi"]))

    def zhat_at_theta(self, d, theta, zguess=None):
        """The joint MAP of the latents at theta (zguess's f and phi as the
        starting point): (dict(f=..., phi=...), MAP_joint's history)."""
        kw = dict(self.MAP_joint_kwargs)
        if zguess is not None:
            kw.setdefault("fstart", zguess.get("f"))
            kw.setdefault("phistart", zguess.get("phi"))
        res = MAP_joint(self.ds.replace(d=d), theta=self._theta(theta), **kw)
        return dict(f=res["f"], phi=res["phi"]), res["history"]

    def solve(self, theta0=None, **kwargs):
        """`muse` on this problem from theta0 (1.0 for each param unless
        given); a MAP_kwargs keyword overrides the problem's
        MAP_joint_kwargs."""
        theta0 = theta0 or {n: 1.0 for n in self.params}
        map_kw = kwargs.pop("MAP_kwargs", self.MAP_joint_kwargs)
        return muse(self.ds, theta0, MAP_kwargs=map_kw, **kwargs)
