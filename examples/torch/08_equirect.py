"""Curved-sky (EquiRect) fields and block-diagonal covariances, on the
PyTorch port (examples/08_equirect.py's steps).

Build an equirectangular band, construct exact isotropic covariances
(block-diagonal in azimuthal m, via Wigner-d recurrences), simulate, and
verify the two-point function round-trips. Runs on the CUDA card
(CMBL_EXAMPLE_DEVICE=cpu for the CPU; CMBL_EXAMPLE_FAST=1 for an 8 x 16
band to lmax 40).

    python examples/torch/08_equirect.py
"""
import numpy as np
import torch

from _example import FAST, check, device, generator

import cmblensing_tpu_torch as ct

dev = device()
# a band between colatitudes 1.2 and 1.8 rad, full circle in phi
proj = ct.ProjEquiRect(Ny=8 if FAST else 32, Nx=16 if FAST else 64, theta_span=(1.2, 1.8),
                       phi_span=(0, 2 * np.pi), device=dev)

# toy isotropic spectra
lmax = 40 if FAST else 100
ell = np.arange(lmax + 1)
CTT = ct.Cls(ell, np.where(ell >= 2, 1.0 / (ell + 1.0) ** 2, 0.0))
CEE = ct.Cls(ell, np.where(ell >= 2, 0.5 / (ell + 1.0) ** 2, 0.0))
CBB = ct.Cls(ell, np.where(ell >= 2, 0.05 / (ell + 1.0) ** 2, 0.0))

# spin-0 and spin-2 covariances (dense n_theta blocks per m)
CT = ct.Cl_to_Cov_EquiRect("I", proj, CTT, lmax=lmax)
CP = ct.Cl_to_Cov_EquiRect("P", proj, CEE, CBB, lmax=lmax)

# simulate a batch of 8 temperature maps and check the quadratic form
g = generator(dev, 0)
fb = CT.simulate(g, batch_shape=(8,))
print("batched sims:", tuple(fb.arr.shape), fb.basis)

# <f' Cpinv f> ~ effective rank per sim. Use the rtol-regularized pinv:
# steep spectra make the high-m blocks ill-conditioned in float32, and an
# exact solve would amplify simulation rounding in the near-null
# directions (the reference's per-block SVD pinv guards the same way)
Ct_pinv = CT.pinv(rtol=1e-4)
one = lambda i: ct.EquiRectField(fb.arr[i], fb.basis, proj)
quad = np.mean([float(ct.er_dot(one(i), Ct_pinv @ one(i))) for i in range(8)])
print(f"mean f' C^+ f = {quad:.1f} (~effective rank; npix = {proj.Ny * proj.Nx})")

# MvNormal logpdf over the band
lp = float(ct.MvNormal(0, CT).logpdf(one(0)))
print("logpdf:", lp)

# spin-2: simulate and verify the EB decomposition is sane
fq = CP.simulate(g)
print("spin-2 sim:", tuple(fq.arr.shape), fq.basis)
qu = fq.to("qu_map")
q_rms, u_rms = float(torch.std(qu.arr[0])), float(torch.std(qu.arr[1]))
print("Q rms:", q_rms, " U rms:", u_rms)

check(np.isfinite(quad) and quad > 0 and np.isfinite(lp) and q_rms > 0 and u_rms > 0,
      "f' C^+ f > 0, logpdf finite, Q and U rms > 0")
