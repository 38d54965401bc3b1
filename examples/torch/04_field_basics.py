"""Field basics, on the PyTorch port (examples/04_field_basics.py's steps):
bases, conversions, algebra, operators, batching. Runs on the CUDA card
(CMBL_EXAMPLE_DEVICE=cpu for the CPU).

    python examples/torch/04_field_basics.py
"""
import numpy as np

from _example import check, device, generator

import cmblensing_tpu_torch as ct

dev = device()
proj = ct.ProjLambert(128, 128, thetapix=3, device=dev)
g = generator(dev, 0)

# construct, convert, index
f = ct.randn(g, proj, pol="QU")
print("f:", f)
print("as EB fourier:", f.to(ct.EB_FOURIER))
print("E component:", f["E"])

# algebra with automatic basis promotion
gsum = 2.0 * f + f.to(ct.EB_FOURIER)
print("mixed-basis sum lands in:", gsum.basis)

# operators
Cl = ct.camb()
Cf = ct.Cl_to_Cov("P", proj, Cl["unlensed_scalar"]["EE"], Cl["unlensed_scalar"]["BB"])
xi = Cf.sqrt() @ f            # colored field
hp = ct.HighPass(500).on(proj, pol="EB")
filtered = hp @ xi
energy = float(ct.dot(xi, Cf.solve(xi)))
print("dot(xi, Cf^-1 xi) =", energy)

# batching: one leading axis
fb = ct.batch([ct.randn(g, proj, pol="I") for _ in range(4)])
norms = ct.norm(fb).cpu().numpy()
print("batched:", fb.batch_shape, "norms:", np.round(norms, 1))

# the same energy as a function of the field (the JAX example jits it)
energy_of = lambda x: ct.dot(x, Cf.solve(x))
print("energy:", float(energy_of(xi)))

# the unlensed B spectrum is zero, so Cf's pseudo-inverse leaves E's Ny Nx
# degrees of freedom, each of unit variance in xi
ndof = proj.Ny * proj.Nx
check(gsum.basis == ct.QU_MAP or gsum.basis == ct.EB_FOURIER, "the mixed-basis sum has a basis")
check(fb.batch_shape == (4,) and bool(np.all(np.isfinite(norms))), "a batch of 4 finite fields")
check(abs(energy / ndof - 1) < 0.05 and bool(np.isfinite(float(ct.norm(filtered)))),
      f"xi' Cf^-1 xi / (Ny Nx) = {energy / ndof:.4f} within 0.05 of 1")
