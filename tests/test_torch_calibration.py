"""The reference's calibration tests held on the port's own draws (torch
Philox, not JAX's threefry: the chains, simulations and MUSE ensembles are
the port's, so these check the port's statistics, not its arithmetic
against JAX's), at the JAX tests' sizes, seeds, settings and bounds, all in
the slow lane:

- `test_gibbs_theta_posterior_calibrated` (tests/test_inference.py:206):
  sample_joint on a 32^2 I simulation at Aphi = 1 (seed 7), 2 chains x 16
  steps from Aphi 2.5 on a 32-point grid over [0.2, 3]: chain 0's Aphi past
  its 6 burn-in steps moves (std > 0.02), stays off the grid's edges, and
  averages in (0.3, 2.2).
- `test_muse_sigma_consistency` (tests/test_muse.py:21): MUSE on 16^2 I data
  simulated at Aphi = 1.5, seeds 1-3 (8 sims, 3 steps, MAP 3 steps, CG tol
  1e-2 at most 30 iterations): sigma finite and positive, every pull under 4.
- `test_muse_bandpower_pull_calibrated` (tests/test_muse.py:148): 3 bandpower
  bins at 64^2 I, data at the tilted truth linspace(1.5, 0.8, 3), 6 sims, 3
  steps, MAP 4 steps, CG 20 fixed iterations: Sigma positive definite, every
  bin's pull under 3.5.
- `test_sharded_sample_joint_theta_calibrated`
  (tests/test_sharded_theta.py:165): sharded_sample_joint over 4 gloo CPU
  ranks (tests/_torch_ranks.py "calibration") on a 32^2 P map (seed 7), 12
  steps, CG tol 1e-2 at most 40 iterations, HMC N 10 eps 0.02, phi from a
  prior draw, Aphi from 2.5 on a 24-point grid over [0.2, 3]: past 3
  burn-in steps the chain moves (std > 0.02), stays inside the grid, and
  averages in (0.3, 2.3). The JAX test runs its derivatives as matmuls
  (`deriv.mode_ctx("matmul")`); the port's LenseFlow derivatives are its
  own, one form on the CPU.

Generators are seeded as the JAX tests seed their keys.

One case is Tier-1, not slow: `test_draws_match_their_covariances` holds
the port's Gaussian draws on the sharded test's dataset to their
covariances (scripts/calibration_spread.py `draws` prints the same
statistic for both packages, and the other modes each package's chains
over many seeds).
"""
import numpy as np
import pytest
import torch

import cmblensing_tpu_torch as ct
from _torch_ranks import spawn_ranks


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _sim(**kw):
    return ct.load_sim(T=np.float32, device="cpu", **kw)


@pytest.mark.parametrize("what", ["momentum", "phi", "n", "f"])
def test_draws_match_their_covariances(what):
    """Over 64 draws on load_sim(thetapix=3, Nside=32, pol="P", seed=7),
    the mean of x' C^-1 x over x's real size in map space is within 0.03
    of its expectation 1 (its standard error about 0.005): the HMC
    momentum (simulate_op of sampling.py::mass_matrix_phi) and the
    simulation's phi, noise and f against Cphi, Cn and Cf."""
    from cmblensing_tpu_torch.inference.sampling import mass_matrix_phi
    ds = _sim(thetapix=3, Nside=32, pol="P", seed=7)["ds"]
    fid = lambda C: getattr(C, "fiducial", C)
    if what == "momentum":
        C = mass_matrix_phi(None, ds)
        xs = [ct.simulate_op(_gen(i), C) for i in range(64)]
    else:
        C = fid({"phi": ds.Cphi, "n": ds.Cn, "f": ds.Cf}[what])
        xs = [ds.simulate(_gen(10_000 + i))[what] for i in range(64)]
    q = [float(ct.dot(x, C.solve(x))) / x.to(x.basis.with_space("map")).arr.numel() for x in xs]
    assert abs(np.mean(q) - 1) < 0.03, (what, np.mean(q))


@pytest.mark.slow
def test_gibbs_theta_posterior_calibrated():
    ds = _sim(thetapix=3, Nside=32, pol="I", seed=7)["ds"]
    grid = np.linspace(0.2, 3.0, 32)
    chains = ct.sample_joint(ds, nsamps_per_chain=16, nchains=2, generator=_gen(11),
                             theta_range={"Aphi": grid}, theta_start={"Aphi": 2.5},
                             nburnin_always_accept=6, symp_kwargs=[dict(N=10, eps=0.02)],
                             conjgrad_kwargs=dict(tol=1e-2, nsteps=60))
    A = np.array([np.ravel(e["theta"]["Aphi"])[0] for e in chains[0]][6:])
    assert A.std() > 0.02, "theta chain never moved"
    assert grid.min() < A.min() and A.max() < grid.max(), "chain pinned at grid edge"
    assert 0.3 < A.mean() < 2.2, f"Aphi mean {A.mean():.2f} inconsistent with truth 1.0"


@pytest.mark.slow
def test_muse_sigma_consistency():
    pulls = []
    truth = 1.5
    for seed in [1, 2, 3]:
        ds = _sim(thetapix=5, Nside=16, pol="I", seed=seed)["ds"]
        sim = ds.at(dict(Aphi=truth)).simulate(_gen(100 + seed), theta=dict(Aphi=truth))
        res = ct.muse(ds.replace(d=sim["d"]), dict(Aphi=1.0), nsims=8, nsteps=3,
                      generator=_gen(seed),
                      MAP_kwargs=dict(nsteps=3, conjgrad_kwargs=dict(tol=1e-2, nsteps=30)))
        sigma = float(np.sqrt(np.asarray(res["Sigma"])[0, 0]))
        assert np.isfinite(sigma) and sigma > 0
        pulls.append((float(np.asarray(res["theta"]["Aphi"])) - truth) / sigma)
    assert np.all(np.abs(pulls) < 4.0), f"pulls={pulls}"


@pytest.mark.slow
def test_muse_bandpower_pull_calibrated():
    nbins = 3
    out = _sim(thetapix=3, Nside=64, pol="I", seed=0)
    ds, proj = out["ds"], out["proj"]
    lm = np.asarray(proj.lmag).ravel()
    lm = lm[lm > 0]
    inner = np.percentile(lm, np.linspace(0, 100, nbins + 1)[1:-1])
    edges = np.concatenate([[0.0], inner, [1e9]])
    ds = ds.replace(Cphi=ct.Cl_to_Cov("I", proj, (ct.camb()["total"]["pp"], edges, "Aphi_b")))
    truth = np.linspace(1.5, 0.8, nbins)
    sim = ds.simulate(_gen(7), theta=dict(Aphi_b=truth))
    res = ct.muse(ds.replace(d=sim["d"]), dict(Aphi_b=np.ones(nbins)), nsims=6, nsteps=3,
                  generator=_gen(3),
                  MAP_kwargs=dict(nsteps=4, conjgrad_kwargs=dict(tol=0.0, nsteps=20,
                                                                 fixed_iters=True)))
    A = np.asarray(res["theta"]["Aphi_b"])
    Sigma = np.asarray(res["Sigma"])
    assert np.all(np.linalg.eigvalsh(Sigma) > 0), Sigma
    pulls = (A - truth) / np.sqrt(np.diag(Sigma))
    assert np.all(np.abs(pulls) < 3.5), (A, np.sqrt(np.diag(Sigma)), pulls)


@pytest.mark.slow
def test_sharded_sample_joint_theta_calibrated(tmp_path):
    A = np.asarray(spawn_ranks("calibration", 4, str(tmp_path), timeout=1200)()["Aphi"])[3:]
    assert A.std() > 0.02, "theta chain never moved"
    assert 0.2 < A.min() and A.max() < 3.0, "chain pinned at grid edge"
    assert 0.3 < A.mean() < 2.3, f"Aphi mean {A.mean():.2f} inconsistent with truth 1.0"
