"""The lensing posterior, on the PyTorch port (examples/02_posterior.py's
steps).

Walks the three parametrizations of P(f, phi | d): unlensed (f, phi),
lensed (f_tilde, phi), mixed (f_mix, phi_mix), evaluates and
differentiates each. Runs on the CUDA card (CMBL_EXAMPLE_DEVICE=cpu for
the CPU; CMBL_EXAMPLE_FAST=1 for 32^2).

    python examples/torch/02_posterior.py
"""
import numpy as np
import torch

from _example import FAST, check, device

import cmblensing_tpu_torch as ct

dev = device()
out = ct.load_sim(thetapix=2, Nside=32 if FAST else 128, pol="I", T=np.float32, seed=0,
                  device=dev)
ds, f, phi = out["ds"], out["f"], out["phi"]

# unlensed parametrization
lp = float(ds.logpdf(f=f, phi=phi))
print(f"logpdf(f, phi)             = {lp:.2f}")

# lensed parametrization: f_tilde = L(phi) f
ft = ds.L(phi) @ f
f_back = ds.L(phi).solve(ft)
resid = float(ct.norm(f_back - f) / ct.norm(f))
print(f"inverse-lense residual     = {resid:.2e}")

# mixed parametrization
m = ct.mix(ds, f=f, phi=phi)
lp_mix = float(ct.Mixed(ds).logpdf(f_mix=m["f_mix"], phi_mix=m["phi_mix"]))
print(f"mixed logpdf               = {lp_mix:.2f}  (rel diff {abs(lp - lp_mix) / abs(lp):.1e})")

# gradients wrt both fields
gf = ds.gradientf_logpdf(f, phi=phi)
gphi = ct.fgrad(lambda p: torch.sum(ds.logpdf(f=f, phi=p)))(phi)
print(f"|grad_f logpdf|            = {float(ct.norm(gf)):.3g}")
print(f"|grad_phi logpdf|          = {float(ct.norm(gphi)):.3g}")

# theta-dependence (r and Aphi scale the covariances)
lps = []
for th in [dict(), dict(r=0.1), dict(Aphi=1.5)]:
    lps.append(float(ds.logpdf(f=f, phi=phi, theta=th)))
    print(f"logpdf at theta={th}: {lps[-1]:.2f}")

check(all(np.isfinite([lp, lp_mix, resid, float(ct.norm(gf)), float(ct.norm(gphi))] + lps)),
      "every logpdf, residual and gradient norm finite")
