"""Gibbs/HMC sampling of the joint lensing posterior, on the PyTorch port
(examples/05_sampling.py's steps).

Runs short chains with theta (Aphi) slice-sampling, checkpoints them, and
reloads them with burn-in removal. Runs on the CUDA card
(CMBL_EXAMPLE_DEVICE=cpu for the CPU; CMBL_EXAMPLE_FAST=1 for 16^2 and 3
samples a chain).

    python examples/torch/05_sampling.py
"""
import glob
import os

import numpy as np

from _example import FAST, check, device, generator, tmp_path

import cmblensing_tpu_torch as ct

dev = device()
out = ct.load_sim(thetapix=3, Nside=16 if FAST else 64, pol="I", T=np.float32, seed=1,
                  device=dev)
ds = out["ds"]

fn = tmp_path("torch_example_chains")
for old in glob.glob(fn + "*"):
    os.remove(old)

nsamps = 3 if FAST else 10
chains = ct.sample_joint(
    ds,
    nsamps_per_chain=nsamps,
    nchains=2,
    generator=generator(dev, 0),
    theta_range=dict(Aphi=np.linspace(0.5, 1.5, 15)),
    symp_kwargs=[dict(N=3 if FAST else 10, eps=0.02)],
    conjgrad_kwargs=dict(tol=1e-1, nsteps=20 if FAST else 100),
    filename=fn,
    progress=True,
)

burnin = 1 if FAST else 2
loaded = ct.load_chains(fn, burnin=burnin)
print(f"{len(loaded)} chains x {len(loaded[0])} samples")
aphis = np.concatenate([np.ravel(s["theta"]["Aphi"]) for c in loaded for s in c if "theta" in s])
print("Aphi samples:", np.round(aphis, 3))
lps = np.array([np.atleast_1d(np.asarray(s["logpdf"]))[0] for c in loaded for s in c],
               dtype=np.float64)
print("logpdf mean/std:", lps.mean(), lps.std())

check(len(loaded) == 2 and all(len(c) == nsamps - burnin for c in loaded),
      f"the checkpoint read back: 2 chains x {nsamps - burnin} samples past the burn-in")
check(bool(np.all(np.isfinite(lps))) and bool(np.all(np.isfinite(aphis))),
      "every logpdf and Aphi sample finite")
