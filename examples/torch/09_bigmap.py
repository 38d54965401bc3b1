"""Maps bigger than one card, on the PyTorch port (examples/09_bigmap.py's
steps): the posterior pipeline with every map split over the ranks by
rows.

Lensing (the derivatives' y pass through pencil transposes), the
Fourier-diagonal operators (pencil FFTs), the Wiener filter, a joint MAP,
a posterior sample, one HMC step and binned spectra, with no rank holding
a whole map. The example starts CMBL_EXAMPLE_RANKS ranks (2 by default)
on localhost: NCCL on the CUDA card, gloo on the CPU, or the backend
CMBL_EXAMPLE_BACKEND names (gloo to share one card).

    python examples/torch/09_bigmap.py
"""
import numpy as np
import torch

from _example import FAST, backend, check, device, generator, join, spawn

import cmblensing_tpu_torch as ct
from cmblensing_tpu_torch.parallel.mesh import all_reduce


def main(rank, world, port, dev):
    join(rank, world, port, dev)
    say = print if rank == 0 else (lambda *a, **k: None)
    mesh = ct.spatial_mesh(device=dev, backend=backend(dev))
    N = 32 if FAST else 64
    say(f"mesh: {world} ranks; map {N}^2 (each rank holds Ny/{world} rows)")

    out = ct.load_sim(thetapix=3, Nside=N, pol="P", T=np.float32, seed=0, device=dev)
    ds, phi_true = out["ds"], out["phi"]
    phi_m = phi_true.to(ct.MAP)

    # 1. the lensed Wiener filter: one CG whose iterates stay sharded
    f_wf, info = ct.sharded_wiener_filter(ds, phi_m, mesh, nsteps=10 if FAST else 40, tol=1e-7)
    say("Wiener filter: this rank's block", tuple(f_wf.arr.shape), "CG iters:",
        int(info["iterations"]))

    # 2. a posterior sample of f (constrained realization)
    f_samp, _ = ct.sharded_sample_f(generator(dev, 1), ds, phi_m, mesh,
                                    nsteps=10 if FAST else 40, tol=1e-7)
    say("posterior f sample drawn: this rank's block", tuple(f_samp.arr.shape))

    # 3. joint MAP: sharded Wiener-filter f-steps + preconditioned phi ascent
    res = ct.sharded_MAP_joint(ds, mesh, nsteps=2 if FAST else 4, cg_nsteps=10 if FAST else 30,
                               ngrid=5, progress=rank == 0)
    pm = ct.gather_spatial(res["phi"], mesh).arr.double().ravel()
    pt = phi_m.arr.double().ravel()
    corr = float(pm @ pt / (pm.norm() * pt.norm() + 1e-30))
    say(f"sharded MAP: corr(phi, phi_true) = {corr:.3f}")

    # 4. one HMC step on phi, conditioned on the MAP's own f
    phi_hmc, dH, acc = ct.sharded_hmc_phi_step(generator(dev, 2), ds, res["f"], res["phi"],
                                               mesh, N=3, eps=1e-8)
    say(f"HMC step: dH={float(dH):.3g} accept={bool(acc)}")

    # the lensing operator itself works on sharded maps directly
    relensed = ct.ShardedLenseFlow(phi_hmc, mesh=mesh) @ res["f"]
    say("re-lensed at the HMC phi: this rank's block", tuple(relensed.arr.shape))

    # 5. spectra binned on the ranks (only the bins leave them)
    cl = ct.get_Cl_sharded(res["phi"], mesh, dl=500)
    say("phi_MAP bandpowers:", np.asarray(cl.Cl[:4]))

    # the blocks that hold a value that is not finite, over every rank
    bad = torch.tensor([float(not torch.isfinite(x).all()) for x in
                        (f_wf.arr, f_samp.arr, relensed.arr, phi_hmc.arr)], device=dev)
    bad = all_reduce(bad, mesh, "sp", "max")
    if rank == 0:
        check(not bool(bad.any()) and np.isfinite(float(dH)), "every sharded result finite")
        check(np.isfinite(corr) and corr > 0.2, f"sharded MAP moved phi (corr {corr:.3f} > 0.2)")
        check(bool(np.all(np.isfinite(np.asarray(cl.Cl)))), "bandpowers finite")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    spawn(main, device())
