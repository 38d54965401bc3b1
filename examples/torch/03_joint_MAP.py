"""Joint MAP estimation, on the PyTorch port (examples/03_joint_MAP.py's
steps).

Simulate a masked, beamed, noisy polarization dataset and jointly maximize
the lensing posterior over (f, phi). Runs on the CUDA card
(CMBL_EXAMPLE_DEVICE=cpu for the CPU; CMBL_EXAMPLE_FAST=1 for 32^2 and 3
steps).

    python examples/torch/03_joint_MAP.py
"""
import numpy as np

from _example import FAST, check, device

import cmblensing_tpu_torch as ct

dev = device()
# the mask must scale with the footprint: a 1 deg edge pad on the fast
# lane's 1.6 deg map would mask every pixel (flat posterior, nan corr)
out = ct.load_sim(
    thetapix=3, Nside=32 if FAST else 128, pol="P", T=np.float32,
    muKarcminT=1, beamFWHM=2,
    pixel_mask_kwargs=(dict(edge_padding_deg=0.2, apodization_deg=0.1) if FAST else
                       dict(edge_padding_deg=1, apodization_deg=0.5)),
    seed=0, device=dev,
)
ds, f, phi = out["ds"], out["f"], out["phi"]

res = ct.MAP_joint(ds, nsteps=3 if FAST else 10, progress=True,
                   conjgrad_kwargs=dict(tol=1e-1, nsteps=200))

lps = np.array([float(h["logpdf"]) for h in res["history"]])
corr = float(ct.dot(res["phi"].to(phi.basis), phi) / (ct.norm(phi) * ct.norm(res["phi"])))
print("logpdf:", np.round(lps, 2).tolist())
print(f"corr(phi_MAP, phi_true) = {corr:.3f}")
check(bool(np.all(np.isfinite(lps))) and bool(np.all(np.diff(lps) >= 0)),
      "logpdf finite and non-decreasing")
check(np.isfinite(corr) and corr > 0.2, f"MAP moved phi (corr {corr:.3f} > 0.2)")
