"""The spread of the Aphi chain that
tests/test_torch_calibration.py::test_sharded_sample_joint_theta_calibrated
(the port) and tests/test_sharded_theta.py::test_sharded_sample_joint_theta_calibrated
(the JAX package) hold to 0.3 < mean(Aphi past 3 burn-in steps) < 2.3,
over runs that draw everything anew, on the CPU:

    python scripts/calibration_spread.py port-sharded [--runs 5] [--first 0]
    python scripts/calibration_spread.py port [--runs 5] [--first 0]
    python scripts/calibration_spread.py jax [--runs 5] [--first 0]
    python scripts/calibration_spread.py jax-unsharded [--runs 5] [--first 0]
    python scripts/calibration_spread.py draws [--runs 200]

Every run has the tests' settings: load_sim(thetapix=3, Nside=32, pol="P")
at Aphi = 1, phi started from a prior draw, Aphi from 2.5 on a 24-point
grid over [0.2, 3], 12 steps, HMC N 10 eps 0.02, CG tol 1e-2 at most 40
iterations. Run k draws the data with seed 7 + k, the phi start with seed
123 + k and the chain with seed 11 + k: run 0 is the tests' own, and the
two packages draw from different generators (torch Philox, JAX threefry),
so their runs share seeds, not draws.

- port-sharded: the port's sharded_sample_joint over 4 gloo ranks, through
  the test's own runner (tests/_torch_ranks.py "calibration");
- port: the port's sample_joint in one process at the same settings (no
  always-accepted burn-in steps, as the sharded sampler has none);
- jax: the JAX package's sharded_sample_joint on 4 CPU devices under
  deriv.mode_ctx("matmul"), as its test runs it;
- jax-unsharded: the JAX package's sample_joint in one process, as
  `port` runs the port's.

Prints each run's chain and its mean past 3 steps, then the mean and
standard deviation of those means over the runs and the runs whose mean
misses the bound 0.3.

`draws` holds each package's Gaussian draws on the tests' dataset to their
covariances: over `--runs` draws, the mean of x' C^-1 x over the field's
real size (1 in expectation) for the HMC momentum (mass_matrix_phi, drawn
by simulate_op) and for the simulation's phi, noise and f.
"""
import argparse
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BURN, LO = 3, 0.3


def port_sharded(k):
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _torch_ranks import spawn_ranks
    with tempfile.TemporaryDirectory() as d:
        return spawn_ranks("calibration", 4, d, inputs=dict(run=np.array(k)),
                           timeout=1200)()["Aphi"]


def port(k):
    import torch
    import cmblensing_tpu_torch as ct
    torch.set_num_threads(2)
    ds = ct.load_sim(thetapix=3, Nside=32, pol="P", T=np.float32, seed=7 + k, device="cpu")["ds"]
    g = torch.Generator()
    g.manual_seed(123 + k)
    phi0 = ds.simulate(g)["phi"].to(ct.MAP)
    g.manual_seed(11 + k)
    ch = ct.sample_joint(ds, 12, nchains=1, generator=g,
                         theta_range={"Aphi": np.linspace(0.2, 3.0, 24)},
                         theta_start={"Aphi": 2.5}, phi_start=phi0, nburnin_always_accept=0,
                         symp_kwargs=[dict(N=10, eps=0.02)],
                         conjgrad_kwargs=dict(tol=1e-2, nsteps=40))
    return [float(np.ravel(e["theta"]["Aphi"])[0]) for e in ch[0]]


def jax_sharded(k):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, ROOT)
    import jax
    from cmblensing_tpu.models.dataset import load_sim
    from cmblensing_tpu.ops import deriv
    from cmblensing_tpu.parallel.sharded_wf import sharded_sample_joint
    from cmblensing_tpu.parallel.spatial import spatial_mesh
    ds = load_sim(thetapix=3, Nside=32, pol="P", T=np.float32, seed=7 + k)["ds"]
    phi0 = ds.simulate(jax.random.PRNGKey(123 + k))["phi"]
    phi0 = phi0.to(phi0.basis.with_space("map"))
    with deriv.mode_ctx("matmul"):
        ch = sharded_sample_joint(jax.random.PRNGKey(11 + k), ds,
                                  spatial_mesh(4, devices=jax.devices("cpu")), nsamps=12,
                                  cg_nsteps=40, cg_tol=1e-2, hmc_N=10, hmc_eps=0.02,
                                  phistart=phi0, theta_range={"Aphi": (0.2, 3.0)},
                                  theta_grid_n=24, theta_start={"Aphi": 2.5})
    return [float(e["Aphi"]) for e in ch[0]]


def jax_unsharded(k):
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    from cmblensing_tpu.inference.sampling import sample_joint
    from cmblensing_tpu.models.dataset import load_sim
    ds = load_sim(thetapix=3, Nside=32, pol="P", T=np.float32, seed=7 + k)["ds"]
    phi0 = ds.simulate(jax.random.PRNGKey(123 + k))["phi"]
    res = sample_joint(ds, 12, nchains=1, key=jax.random.PRNGKey(11 + k),
                       theta_range={"Aphi": np.linspace(0.2, 3.0, 24)},
                       theta_start={"Aphi": 2.5}, phi_start=phi0.to(phi0.basis.with_space("map")),
                       nburnin_always_accept=0, symp_kwargs=[dict(N=10, eps=0.02)],
                       conjgrad_kwargs=dict(tol=1e-2, nsteps=40))
    return [float(np.ravel(th["Aphi"])[0]) for th in res["theta"][0]]


def draws(K):
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import torch
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu.core import field as jf, ops as jo
    from cmblensing_tpu.inference import sampling as js
    from cmblensing_tpu.models.dataset import load_sim as j_load_sim
    from cmblensing_tpu_torch.core import field as tf, ops as to
    from cmblensing_tpu_torch.inference import sampling as ts

    def chi2(F, x, C):
        """x' C^-1 x over x's real size in map space."""
        C = getattr(C, "fiducial", C)
        size = np.asarray(x.to(x.basis.with_space("map")).arr).size
        return float(F.dot(x, C.solve(x))) / size

    for name, ds, F, ops, smp, key in (
            ("port", ct.load_sim(thetapix=3, Nside=32, pol="P", T=np.float32, seed=7,
                                 device="cpu")["ds"], tf, to, ts,
             lambda i: torch.Generator().manual_seed(i)),
            ("jax", j_load_sim(thetapix=3, Nside=32, pol="P", T=np.float32, seed=7)["ds"],
             jf, jo, js, jax.random.PRNGKey)):
        lam = smp.mass_matrix_phi(None, ds)
        q = {"momentum": [chi2(F, ops.simulate_op(key(i), lam), lam) for i in range(K)]}
        sims = [ds.simulate(key(10_000 + i)) for i in range(K)]
        for k, C in (("phi", ds.Cphi), ("n", ds.Cn), ("f", ds.Cf)):
            q[k] = [chi2(F, sm[k], C) for sm in sims]
        print(f"draws {name}: mean x' C^-1 x / size over {K} draws: "
              + ", ".join(f"{k} {np.mean(v):.4f} (± {np.std(v) / np.sqrt(K):.4f})"
                          for k, v in q.items()), flush=True)
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("port-sharded", "port", "jax", "jax-unsharded", "draws"))
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--first", type=int, default=0, help="the first run's k")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    if args.what == "draws":
        return draws(args.runs)
    run = {"port-sharded": port_sharded, "port": port, "jax": jax_sharded,
           "jax-unsharded": jax_unsharded}[args.what]
    ks, means = range(args.first, args.first + args.runs), []
    for k in ks:
        t0 = time.perf_counter()
        A = np.asarray(run(k), dtype=float)
        means.append(A[BURN:].mean())
        print(f"{args.what} run {k} (seeds {7 + k}, {123 + k}, {11 + k}): Aphi "
              f"{np.round(A, 3).tolist()}; mean past {BURN} {means[-1]:.4f} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    means = np.array(means)
    print(f"{args.what}: {len(means)} runs, mean of the chain means {means.mean():.4f}, "
          f"std {means.std(ddof=1):.4f}; runs below {LO}: "
          f"{[k for k, m in zip(ks, means) if m <= LO]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
