"""MUSE on the PyTorch port (examples/07_muse.py's steps): estimate theta,
here the phi-spectrum amplitude Aphi, with the Marginal Unbiased Score
Expansion (Millea & Seljak 2021), the simulation ensemble a batch axis.

Runs on the CUDA card (CMBL_EXAMPLE_DEVICE=cpu for the CPU;
CMBL_EXAMPLE_FAST=1 for 4 sims and 2 steps).

    python examples/torch/07_muse.py
"""
import numpy as np

from _example import FAST, check, device, generator

import cmblensing_tpu_torch as ct

dev = device()
# simulate data at the fiducial Aphi = 1
out = ct.load_sim(thetapix=3, Nside=32, pol="I", T=np.float32, seed=5, device=dev)
ds = out["ds"]

# start deliberately wrong, let MUSE find its way back
res = ct.muse(
    ds, dict(Aphi=2.0),
    nsims=4 if FAST else 12, nsteps=2 if FAST else 4,
    generator=generator(dev, 0),
    MAP_kwargs=dict(nsteps=2 if FAST else 4,
                    conjgrad_kwargs=dict(tol=1e-2, nsteps=15 if FAST else 40)),
    progress=True,
)

Aphi = float(np.asarray(res["theta"]["Aphi"]))
H = np.atleast_2d(np.asarray(res["H"], dtype=np.float64))
Sigma = np.atleast_2d(np.asarray(res["Sigma"], dtype=np.float64))
sigma = float(np.sqrt(Sigma.ravel()[0]))
print(f"\nMUSE: Aphi = {Aphi:.3f} +/- {sigma:.3f}  (truth: 1.0)")
print("history:", [round(float(np.asarray(h["theta"]["Aphi"])), 3) for h in res["history"]])
check(bool(np.all(np.isfinite(H))) and abs(np.linalg.det(H)) > 0, f"H invertible (H = {H.ravel()})")
check(np.isfinite(Aphi) and sigma > 0, f"sigma > 0 (sigma = {sigma:.4g})")
