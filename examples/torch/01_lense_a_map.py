"""Lense a map, on the PyTorch port (examples/01_lense_a_map.py's steps).

Simulate an unlensed CMB field and a lensing potential from their theory
spectra, lense with LenseFlow, and compare power spectra. Runs on the CUDA
card (CMBL_EXAMPLE_DEVICE=cpu for the CPU; CMBL_EXAMPLE_FAST=1 for 64^2).

    python examples/torch/01_lense_a_map.py
"""
import numpy as np

from _example import FAST, check, device, generator, tmp_path

import cmblensing_tpu_torch as ct
from cmblensing_tpu_torch.core.ops import simulate_op

dev = device()
N = 64 if FAST else 256
proj = ct.ProjLambert(N, N, thetapix=3, T=np.float32, device=dev)
Cl = ct.camb()

Cf = ct.Cl_to_Cov("P", proj, Cl["unlensed_scalar"]["EE"], Cl["unlensed_scalar"]["BB"])
Cphi = ct.Cl_to_Cov("I", proj, Cl["total"]["pp"])

g = generator(dev, 0)
f = simulate_op(g, Cf)
phi = simulate_op(g, Cphi).to(ct.MAP)

L = ct.LenseFlow(phi, nsteps=7)
f_lensed = L @ f

ledges = np.arange(100, 3000, 100)
clBB_unlensed = ct.get_Cl(f["B"], ledges=ledges)
clBB_lensed = ct.get_Cl(f_lensed["B"], ledges=ledges)
unlensed, lensed = np.mean(clBB_unlensed.Cl), np.mean(clBB_lensed.Cl)
print("lensing-induced BB power (should be > unlensed):")
print("  unlensed BB mean:", unlensed)
print("  lensed BB mean:  ", lensed)
print("  theory lensed BB:", np.mean(Cl["lensed_scalar"]["BB"](clBB_lensed.ell)))

try:
    from cmblensing_tpu_torch.utils.plotting import plot_maps
    fig = plot_maps([f["Q"], f_lensed["Q"], phi], titles=["Q unlensed", "Q lensed", "phi"])
    fig.savefig(tmp_path("lense_a_map.png"), dpi=80)
    print("wrote", tmp_path("lense_a_map.png"))
except Exception as e:
    print("plotting skipped:", e)

check(np.isfinite(lensed) and lensed > unlensed, "lensed BB mean > unlensed")
