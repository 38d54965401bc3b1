"""Bandpower MUSE at 256^2 P on one CUDA card: BASELINE.json configs[4] on the
PyTorch port.

    python scripts/torch_muse_256.py [--N 256] [--nbins 4] [--nsims 8] [--nsteps 4]
                                     [--runs 1] [--profile]

The configuration of scripts/muse_bandpower.py at N = 256, pol "P":
load_sim(thetapix=3, Nside=N, pol="P", T=float32, seed=0); Cphi banded into
nbins bins of |l| (percentile edges of the grid's nonzero |l|, the last bin
open) as Cl_to_Cov("I", proj, (camb()["total"]["pp"], edges, "Aphi_b"));
the data simulated at the tilted truth linspace(1.5, 0.8, nbins) from a
generator seeded 7, in the QU map basis; then

    muse(ds, dict(Aphi_b=np.ones(nbins)), nsims, nsteps, MAP_kwargs=dict(nsteps=5,
         conjgrad_kwargs=dict(tol=0.0, nsteps=20, fixed_iters=True)))

at the default precision ("auto") with final_H, its draws from a generator
seeded 3, on the default ("kernel") LenseFlow backend (the dense flow
kernel at 256^2). Prints, with the card's name and power limit:
- s/run (wall) and its split by `timed` block (utils/timing.py: the data
  MAPs, the simulations, the ensemble MAPs, H's, the final H's and the
  theta-scores, with MAP_joint's own f- and phi-steps inside them);
- each step's theta, data score and mean sim score, H and J;
- each bin's estimate +/- sigma, its pull against the truth, the joint
  chi2 of theta_hat - truth under Sigma;
- the peak device memory and each kernel's launches a run
  (ops/lenseflow_kernels.py::LAUNCHES).
--runs times more runs (the first includes the kernels' build). With
--profile, one more run under torch.profiler: device time / wall (the busy
share) and the kernels that take the most device time. Needs a CUDA card;
exits non-zero without one.
"""
import argparse
import os
import subprocess
import sys
import time

import numpy as np

from torch_profile_map import report

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAP_KW = dict(nsteps=5, conjgrad_kwargs=dict(tol=0.0, nsteps=20, fixed_iters=True))
PULL_MAX = 4.0   # the bound scripts/muse_bandpower.py asserts


def muse_dataset(ct, torch, N, nbins, device="cuda"):
    """(ds, edges, truth, the data's phi) of the configuration above."""
    sim = ct.load_sim(thetapix=3, Nside=N, pol="P", T=np.float32, seed=0, device=device)
    ds, proj = sim["ds"], sim["proj"]
    lm = np.asarray(proj.lmag).ravel()
    lm = lm[lm > 0]
    inner = np.percentile(lm, np.linspace(0, 100, nbins + 1)[1:-1])
    edges = np.concatenate([[0.0], inner, [1e9]])
    ds = ds.replace(Cphi=ct.Cl_to_Cov("I", proj, (ct.camb()["total"]["pp"], edges, "Aphi_b")))
    truth = np.linspace(1.5, 0.8, nbins)
    g = torch.Generator(device=device)
    g.manual_seed(7)
    with torch.no_grad():
        s = ds.simulate(g, theta=dict(Aphi_b=truth))
    return ds.replace(d=s["d"].to(ct.QU_MAP)), edges, truth, s["phi"]


def run_muse(ct, torch, ds, nbins, nsims, nsteps, seed=3):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return ct.muse(ds, dict(Aphi_b=np.ones(nbins)), nsims=nsims, nsteps=nsteps, generator=g,
                   MAP_kwargs=MAP_KW)


def summary(res, truth):
    """(estimates, sigmas, pulls, chi2) of a muse result against the truth."""
    A = np.asarray(res["theta"]["Aphi_b"])
    Sigma = np.asarray(res["Sigma"])
    sig = np.sqrt(np.diag(Sigma))
    return A, sig, (A - truth) / sig, float((A - truth) @ np.linalg.solve(Sigma, A - truth))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--N", type=int, default=256)
    ap.add_argument("--nbins", type=int, default=4)
    ap.add_argument("--nsims", type=int, default=8)
    ap.add_argument("--nsteps", type=int, default=4)
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--top", type=int, default=14)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_muse_256: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    from cmblensing_tpu_torch.utils import timing
    from torch.profiler import ProfilerActivity, profile

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    ds, edges, truth, _ = muse_dataset(ct, torch, args.N, args.nbins)
    print(f"bins: edges {edges.tolist()}, truth {truth.tolist()}")
    walls = []
    for r in range(args.runs):
        timing.reset_timers()
        lfk.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_muse(ct, torch, ds, args.nbins, args.nsims, args.nsteps)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for h in res["history"]:
            print(f"  step {h['step']}: theta {np.asarray(h['theta']['Aphi_b']).tolist()}, s_data "
                  f"{np.asarray(h['s_data']).tolist()}, sbar {np.asarray(h['sbar']).tolist()}")
        print(f"  H {np.asarray(res['H']).tolist()}\n  J {np.asarray(res['J']).tolist()}")
        A, sig, pulls, chi2 = summary(res, truth)
        print(f"MUSE {args.N}^2 P, {args.nbins} bins, {args.nsims} sims, {args.nsteps} steps "
              f"(run {r + 1}): {walls[-1]:.3f} s/run; peak memory {peak:.2f} GiB [{card}]")
        for i, lab in enumerate(res["labels"]):
            print(f"  {lab}: {A[i]:.4f} +/- {sig[i]:.4f} (truth {truth[i]:.3f}, pull "
                  f"{pulls[i]:+.3f} sigma)")
        print(f"  joint chi2(theta_hat - truth | Sigma) = {chi2:.3f} / {args.nbins} dof; "
              f"|pull| < {PULL_MAX:g} in every bin: {bool(np.all(np.abs(pulls) < PULL_MAX))}; "
              f"Sigma eigenvalues {np.linalg.eigvalsh(res['Sigma']).tolist()}")
        print("  split (device time of each timed block):")
        for line in timing.timer_report().splitlines():
            print("    " + line)
        print("  launches a run: " + ", ".join(f"{k} {v}" for k, v in sorted(lfk.LAUNCHES.items())
                                               if v))
    print(f"s/run: {', '.join(f'{w:.3f}' for w in walls)} [{card}]")
    if args.profile:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_muse(ct, torch, ds, args.nbins, args.nsims, args.nsteps)
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run_muse(ct, torch, ds, args.nbins, args.nsims, args.nsteps)
            torch.cuda.synchronize()
        report(prof, 1, wall1, f"one MUSE run [{args.N}^2 P x {args.nsims}; {card}]", "run",
               args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
