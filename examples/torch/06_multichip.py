"""Mass simulations and maps split over ranks, on the PyTorch port
(examples/06_multichip.py's steps, on torch.distributed).

The example starts CMBL_EXAMPLE_RANKS ranks (2 by default), one process
each, which join a world on localhost: NCCL on the CUDA card, gloo on the
CPU, or the backend CMBL_EXAMPLE_BACKEND names (NCCL refuses two ranks on
one card: CMBL_EXAMPLE_BACKEND=gloo shares one). Then

1. a MAP_marg-style mean-field step with the simulations split over the
   ranks: every rank draws the whole batch and keeps its entries, Wiener
   filters them (the CG's verdicts read every rank's entries), and the
   phi-gradients' mean is one all_reduce;
2. one map split over the ranks by rows: the sharded LenseFlow, its
   gradient through the flow's continuous adjoint, and the sharded Wiener
   filter.

    python examples/torch/06_multichip.py
"""
import numpy as np
import torch

from _example import FAST, backend, check, device, generator, join, spawn

import cmblensing_tpu_torch as ct
from cmblensing_tpu_torch.parallel.mesh import all_reduce, batch_shard


def meanfield_step(ds, phi, mesh, nbatch, dev):
    """One MAP_marg-style step: simulate nbatch datasets at phi (each rank
    keeps its entries), Wiener-filter each, take the mean phi-gradient."""
    shard = batch_shard(mesh, nbatch)
    phi_b = ct.repeat_batch(phi, nbatch)
    sims = ds.simulate(generator(dev, 0), phi=phi_b, batch_shape=(nbatch,))
    ds_b = ds.replace(d=ct.shard_batch(sims["d"], mesh))
    phi_b = ct.shard_batch(phi_b, mesh)
    f_wf, _ = ct.argmaxf_logpdf(ds_b, phi=phi_b, shard=shard, conjgrad_kwargs=dict(
        tol=0.0, nsteps=5 if FAST else 20, fixed_iters=True))
    g = ct.fgrad(lambda p: torch.sum(ds_b.logpdf(f=f_wf, phi=p)))(phi_b)
    gsum = all_reduce(torch.sum(g.arr, dim=0), mesh, "batch")
    return ct.Field(gsum / nbatch, g.basis, g.proj)


def main(rank, world, port, dev):
    join(rank, world, port, dev)
    say = print if rank == 0 else (lambda *a, **k: None)
    mesh = ct.make_mesh(device=dev, backend=backend(dev))
    say(f"mesh: {world} ranks, {backend(dev)} on {dev}")

    out = ct.load_sim(thetapix=3, Nside=32, pol="P", T=np.float32, seed=0, device=dev)
    ds, phi0 = out["ds"], out["phi"].to(ct.MAP)
    nbatch = world if FAST else 2 * world
    gbar = meanfield_step(ds, phi0, mesh, nbatch, dev)
    gnorm = float(ct.norm(gbar))
    say("mean-field gradient norm:", gnorm)
    say("sharded sim batch ran", nbatch, "sims over", world, "ranks")

    # spatial sharding: ONE map's rows over the ranks; the whole LenseFlow
    # ODE and its continuous-adjoint gradient run block by block
    smesh = ct.spatial_mesh(device=dev, backend=backend(dev))
    big = ct.load_sim(thetapix=3, Nside=32 if FAST else 64, pol="P", T=np.float32, seed=1,
                      device=dev)
    # the lense basis (QU map) BEFORE sharding: a basis conversion of a
    # sharded field would need the whole map
    fm = big["f"].to_lense()
    pm = big["phi"].to(ct.MAP)
    f_sh, phi_sh = ct.shard_spatial(fm, smesh), ct.shard_spatial(pm, smesh)
    lensed = ct.ShardedLenseFlow(phi_sh, mesh=smesh) @ f_sh
    say("spatially-sharded lense: this rank's block", tuple(lensed.arr.shape), "of",
        (2, pm.proj.Ny, pm.proj.Nx))

    # gradients flow through the sharded ODE block by block
    ps = phi_sh.arr.clone().requires_grad_(True)
    lp = torch.sum((ct.ShardedLenseFlow(ct.Field(ps, ct.MAP, pm.proj), mesh=smesh) @ f_sh).arr ** 2)
    (g,) = torch.autograd.grad(lp, ps)
    sq = all_reduce(torch.sum(g.double() ** 2).reshape(1), smesh, "sp")
    gflow = float(torch.sqrt(sq[0]))
    say("sharded flow gradient norm:", gflow)

    # the lensed Wiener filter on the same mesh: its CG iterates never hold
    # a whole map on any rank
    f_wf, info = ct.sharded_wiener_filter(big["ds"], pm, smesh, nsteps=10 if FAST else 40,
                                          tol=1e-7)
    say("sharded Wiener filter: this rank's block", tuple(f_wf.arr.shape), "CG iters:",
        int(info["iterations"]))
    if rank == 0:
        check(np.isfinite(gnorm) and gnorm > 0, "mean-field gradient finite and nonzero")
        check(np.isfinite(gflow) and gflow > 0, "sharded flow gradient finite and nonzero")
        check(bool(torch.isfinite(f_wf.arr).all()) and int(info["iterations"]) > 0,
              "sharded Wiener filter finite")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    spawn(main, device())
