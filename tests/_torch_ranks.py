"""Rank bodies of the port's parallel CPU tests (tests/test_torch_spatial.py,
tests/test_torch_parallel.py, tests/test_torch_calibration.py), run as

    python tests/_torch_ranks.py GROUP RANK WORLD PORT DIR

Each rank joins a gloo world of WORLD ranks at localhost:PORT, runs every
case of GROUP on one torch thread (inputs from DIR/inputs.npz where the
group reads any), and rank 0 pickles the results, numpy arrays and
plain values, to DIR/results.pkl; "marg" prints a checksum line on every
rank instead. The whole fields of sharded results are gathered
(gather_spatial, gather_batch), as the JAX package's sharded arrays come
back whole. Imports torch and the port, never JAX.
"""
import os
import pickle
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import cmblensing_tpu_torch as ct  # noqa: E402
from cmblensing_tpu_torch.parallel import mesh as pm  # noqa: E402
from cmblensing_tpu_torch.parallel import sharded_fft as sf  # noqa: E402
from cmblensing_tpu_torch.parallel import sharded_wf as sw  # noqa: E402
from cmblensing_tpu_torch.parallel import spatial as sp  # noqa: E402

THETA = dict(r=0.1, Aphi=1.4)
# the Wiener filters' CG iterations (tol 0: as many on both sides)
WF_ITERS = 20
GIBBS_ITERS = 10
SLICE_GRID = np.linspace(0.3, 2.4, 8)
THETA_FID = dict(r=0.2, Aphi=1.0)
MASK = dict(edge_padding_deg=0.2, apodization_deg=0.1)


def _np(x):
    x = x.arr if hasattr(x, "arr") else x
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _sim(N, seed=0, **kw):
    return ct.load_sim(thetapix=3, Nside=N, pol="P", T=np.float32, seed=seed, device="cpu", **kw)


def _field(a, basis, proj):
    return ct.Field(torch.as_tensor(np.array(a)), basis, proj)


def _raises(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return None


# =========================================================================
# tests/test_torch_spatial.py: against the JAX package's sharded functions
# =========================================================================

def spatial(inp):
    mesh = sp.spatial_mesh(device="cpu")
    whole = lambda x: _np(sp.gather_spatial(x, mesh))
    r = {}
    proj = ct.ProjLambert(32, 32, thetapix=3, device="cpu")
    # the pencil FFTs and their gradient
    fs = sp.shard_spatial(_field(inp["fft_arr"], ct.QU_MAP, proj), mesh)
    X = sf.rfft2_sharded(fs.arr, mesh)
    r["rfft2"] = _np(pm.all_gather(X, mesh, "sp", dim=-1))
    r["irfft2"] = whole(sf.irfft2_sharded(X, 32, mesh))
    mult = sf.pad_multiplier(inp["fft_mult"], mesh)
    a = fs.arr.clone().requires_grad_(True)
    out = sf.fourier_diag_apply_sharded(mult, ct.Field(a, ct.QU_MAP, proj), mesh)
    w = sp.shard_spatial(_field(inp["fft_w"], ct.QU_MAP, proj), mesh).arr
    (g,) = torch.autograd.grad(torch.sum(out.arr * w), a)
    r["fd_apply"], r["fd_grad"] = whole(out), whole(g)
    # the binned spectra
    f1 = sp.shard_spatial(_field(inp["cl_a"], ct.MAP, proj), mesh)
    f2 = sp.shard_spatial(_field(inp["cl_b"], ct.MAP, proj), mesh)
    c = sf.get_Cl_sharded(f1, mesh, dl=500)
    cx = sf.get_Cl_sharded(f1, mesh, f2=f2, dl=500)
    r["cl"] = (np.asarray(c.ell), np.asarray(c.Cl), np.asarray(cx.Cl))
    # the flows and the phi-gradient at 32^2 and 64^2
    for N in (32, 64):
        pN = ct.ProjLambert(N, N, thetapix=3, device="cpu")
        phi = sp.shard_spatial(_field(inp[f"phi{N}"], ct.MAP, pN), mesh)
        f = sp.shard_spatial(_field(inp[f"f{N}"], ct.QU_MAP, pN), mesh)
        v = sp.shard_spatial(_field(np.roll(inp[f"f{N}"], 3, -1), ct.QU_MAP, pN), mesh)
        L = ct.ShardedLenseFlow(phi, 7, mesh)
        r[f"L{N}"], r[f"LH{N}"] = whole(L @ f), whole(L.H @ f)
        ps = phi.arr.clone().requires_grad_(True)
        lp = torch.sum(v.arr * (L(ct.Field(ps, ct.MAP, pN)) @ f).arr)
        (g,) = torch.autograd.grad(lp, ps)
        r[f"dphi{N}"] = whole(g)
    # the Wiener filter, unmasked and masked, and the logpdf
    for tag, kw in (("", {}), ("_masked", dict(pixel_mask_kwargs=MASK))):
        ds = _sim(32, **kw)["ds"]
        ds = ds.replace(d=_field(inp["d" + tag], ct.QU_MAP, ds.d.proj))
        phi = _field(inp["phi32"], ct.MAP, proj)
        fw, info = ct.sharded_wiener_filter(ds, phi, mesh, nsteps=WF_ITERS, tol=0.0)
        r["wf" + tag] = whole(fw)
        f = _field(inp["f32"], ct.QU_MAP, proj)
        lp = lambda s, t: float(ct.sharded_lensing_logpdf(
            ds, ct.Field(s * f.arr, f.basis, proj), ct.Field(t * phi.arr, phi.basis, proj), mesh))
        r["logpdf" + tag] = [lp(s, t) for s, t in ((1, 1), (0.8, 0.5))]
    # the theta forms
    ds = _sim(32)["ds"]
    ds = ds.replace(d=_field(inp["d"], ct.QU_MAP, ds.d.proj))
    f, phi = _field(inp["f32"], ct.QU_MAP, proj), _field(inp["phi32"], ct.MAP, proj)
    fm, pmx = sw._sharded_mix_theta(ds, f, phi, THETA, mesh)
    r["mix"] = (whole(fm), whole(pmx))
    fu, pu = sw._sharded_unmix_theta(ds, _field(inp["fm_moved"], ct.QU_MAP, proj),
                                     _field(inp["pm_moved"], ct.MAP, proj), THETA, mesh)
    r["unmix"] = (whole(fu), whole(pu))
    r["mixed_logpdf"] = {
        tag: float(sw.sharded_mixed_logpdf_theta(ds, _field(inp["fm_" + tag], ct.QU_MAP, proj),
                                                 _field(inp["pm_" + tag], ct.MAP, proj), th, mesh))
        for tag, th in (("fid", THETA_FID), ("moved", THETA))}
    # the slice as a whole: two sharded_MAP_joint steps
    res = ct.sharded_MAP_joint(ds, mesh, nsteps=2, cg_nsteps=60, cg_tol=1e-7, ngrid=8)
    r["map"] = (whole(res["phi"]), whole(res["f"]),
                [(float(np.sum(h["logpdf"])), float(np.max(h["alpha"]))) for h in res["history"]])
    # batched data on a (batch, sp) = (2, 2) mesh
    mesh2 = ct.spatial_mesh(device="cpu", nbatch=2)
    dsb = ds.replace(d=_field(inp["d_batch"], ct.QU_MAP, proj))
    fb, _ = ct.sharded_wiener_filter(dsb, phi, mesh2, batch_axis="batch", nsteps=WF_ITERS,
                                     tol=0.0)
    r["wf_batch"] = _np(sp.gather_spatial(fb, mesh2, batch_axis="batch"))
    # the guards
    p30 = ct.ProjLambert(30, 30, thetapix=3, device="cpu")
    r["guard_divisible"] = _raises(
        lambda: ct.ShardedLenseFlow(ct.Field(torch.zeros(1, 30, 30), ct.MAP, p30), mesh=mesh))
    eb = ct.Field(torch.zeros(2, 32, 17, dtype=torch.complex64), ct.EB_FOURIER, proj)
    r["guard_basis"] = _raises(lambda: ct.ShardedLenseFlow(sp.shard_spatial(phi, mesh), 7,
                                                           mesh) @ eb)
    return r


# =========================================================================
# tests/test_torch_parallel.py: against the port's unsharded functions
# =========================================================================

ENS_CG = dict(tol=1e-1, nsteps=15)
SJ = dict(nchains=8, symp_kwargs=[dict(N=3, eps=0.01)], conjgrad_kwargs=ENS_CG, nsavemaps=1)
MUSE_MAP = dict(nsteps=2, conjgrad_kwargs=dict(tol=0.0, nsteps=5, fixed_iters=True))


def parallel(inp):
    world, rank = torch.distributed.get_world_size(), torch.distributed.get_rank()
    r = {}
    mesh = ct.make_mesh(device="cpu")
    proj = ct.ProjLambert(16, 16, thetapix=3, device="cpu")
    fb = ct.Field(torch.arange(8.0)[:, None, None, None].expand(8, 1, 16, 16).contiguous(),
                  ct.MAP, proj)
    r["shard_batch"] = _np(ct.shard_batch(fb, mesh))
    r["gather_batch"] = _np(ct.gather_batch(ct.shard_batch(fb, mesh), mesh))
    r["shard_unbatched"] = tuple(ct.shard_batch(ct.batch_index(fb, 0), mesh).arr.shape)
    r["shard_indivisible"] = tuple(ct.shard_batch(ct.Field(fb.arr[:6], ct.MAP, proj),
                                                  mesh).arr.shape)
    tree = dict(f=fb, raw=torch.zeros(8, 3), plane=torch.zeros(world, 16, 16))
    r["shard_tree"] = {k: tuple(v.arr.shape if hasattr(v, "arr") else v.shape)
                       for k, v in ct.shard_batch(tree, mesh).items()}
    r["shard_tree_bs"] = {k: tuple(v.arr.shape if hasattr(v, "arr") else v.shape)
                          for k, v in ct.shard_batch(tree, mesh, batch_size=8).items()}
    r["replicate"] = _np(ct.replicate(torch.full((2,), float(rank)), mesh))
    r["proc_info"] = ct.proc_info()
    # the ensembles, the mean field and the chains split over the ranks
    ds = _sim(32, seed=1)["ds"]
    phi, hist = ct.MAP_marg(ds, generator=_gen(0), nsteps=2, Nsims=8, mesh=mesh,
                            conjgrad_kwargs=ENS_CG)
    r["marg"] = (_np(phi), [h["gradnorm"] for h in hist])
    # rank 0 writes the checkpoint, every rank resumes from it (a fresh
    # generator: the record's state continues the draws)
    fn = os.path.join(inp["tmp"], "chain")
    c = ct.sample_joint(ds, 2, generator=_gen(0), mesh=mesh, filename=fn, nfilewrite=1, **SJ)
    cr = ct.sample_joint(ds, 3, generator=_gen(99), mesh=mesh, filename=fn, resume=True, **SJ)
    r["sample_joint"] = [dict(step=e["step"], logpdf=_np(e["logpdf"]), accept=_np(e["accept"]),
                              phi=_np(e["phi"]), f=_np(e["f"])) for e in list(c[0]) + list(cr[0])]
    m = ct.muse(ds, dict(Aphi=1.0), nsims=8, nsteps=1, generator=_gen(0), MAP_kwargs=MUSE_MAP,
                mesh=mesh)
    r["muse"] = dict(theta=m["theta"]["Aphi"], H=m["H"], J=m["J"], Sigma=m["Sigma"])
    # the sampler's parts on maps split by rows
    smesh = ct.spatial_mesh(device="cpu")
    sim = _sim(32)
    ds, phi, f = sim["ds"], sim["phi"].to(ct.MAP), sim["f"].to(ct.QU_MAP)
    whole = lambda x: _np(sp.gather_spatial(x, smesh))
    fs, _ = ct.sharded_sample_f(_gen(7), ds, phi, smesh, nsteps=WF_ITERS, tol=0.0)
    r["sample_f"] = whole(fs)
    Lam = ct.mass_matrix_phi({}, ds)
    x, dH, acc = ct.sharded_hmc_phi_step(_gen(3), ds, f, phi, smesh, Lambda=Lam, N=5, eps=3e-8)
    r["hmc"] = (whole(x), float(dH), bool(acc))
    fg, pg, info = ct.sharded_gibbs_pass(_gen(11), ds, phi, smesh, cg_nsteps=GIBBS_ITERS,
                                         cg_tol=0.0, hmc_N=3, hmc_eps=1e-8, cg_fixed_iters=True)
    r["gibbs"] = (whole(fg), whole(pg), float(info["dH"]), bool(info["accept"]))
    th, ft, pt = sw.sharded_sample_slice_theta(_gen(5), ds, f, phi, dict(THETA_FID), "Aphi",
                                               SLICE_GRID, smesh)
    r["slice"] = (th["Aphi"], whole(ft), whole(pt))
    fn = os.path.join(inp["tmp"], "schain")
    kw = dict(cg_nsteps=5, cg_tol=0.0, cg_fixed_iters=True, hmc_N=3, hmc_eps=1e-8, filename=fn,
              nfilewrite=1, nsavemaps=2)
    c1 = ct.sharded_sample_joint(_gen(0), ds, smesh, nsamps=2, **kw)
    c2 = ct.sharded_sample_joint(_gen(0), ds, smesh, nsamps=3, resume=True, **kw)
    r["sharded_chain"] = ([e["step"] for e in c1[0]], [e["step"] for e in c2[0]],
                          [float(np.sum(e["logpdf"])) for e in list(c1[0]) + list(c2[0])],
                          ["phi" in e for e in c1[0]])
    p30 = ct.ProjLambert(30, 30, thetapix=3, device="cpu")
    r["guard_divisible"] = _raises(
        lambda: ct.ShardedLenseFlow(ct.Field(torch.zeros(1, 30, 30), ct.MAP, p30), mesh=smesh))
    return r


def marg():
    """One MAP_marg step over the world's ranks; every rank prints the
    checksum of its phi."""
    mesh = ct.make_mesh(device="cpu")
    ds = _sim(16, seed=1)["ds"]
    phi, _ = ct.MAP_marg(ds, generator=_gen(0), nsteps=1, Nsims=4 * mesh.size(),
                         mesh=mesh, conjgrad_kwargs=dict(tol=1e-1, nsteps=3))
    print(f"MAPMARG_OK rank={torch.distributed.get_rank()} "
          f"checksum={float(torch.sum(phi.arr.double() ** 2)):.9e}", flush=True)


def calibration(inp):
    """tests/test_torch_calibration.py: sharded_sample_joint on the rows of
    a 32^2 P map (seed 7) with an Aphi slice pass, from a prior draw of
    phi and Aphi 2.5; the chain's Aphi values. inputs["run"] = k
    (scripts/calibration_spread.py; 0, the test's, without it) adds k to
    the seeds of the data, the phi start and the chain."""
    k = int(inp.get("run", 0))
    mesh = sp.spatial_mesh(device="cpu")
    ds = _sim(32, seed=7 + k)["ds"]
    phi0 = ds.simulate(_gen(123 + k))["phi"].to(ct.MAP)
    ch = ct.sharded_sample_joint(_gen(11 + k), ds, mesh, nsamps=12, cg_nsteps=40, cg_tol=1e-2,
                                 hmc_N=10, hmc_eps=0.02, phistart=phi0,
                                 theta_range={"Aphi": (0.2, 3.0)}, theta_grid_n=24,
                                 theta_start={"Aphi": 2.5})
    return dict(Aphi=[e["Aphi"] for e in ch[0]])


# =========================================================================
# spawning the ranks (for the test modules)
# =========================================================================

def spawn_ranks(group, world, outdir, inputs=None, timeout=240):
    """Start `world` ranks of this script's GROUP; returns wait(), which
    joins them (killing every rank at `timeout` seconds or when one
    fails) and returns rank 0's results, or the ranks' outputs for
    "marg"."""
    import socket
    import subprocess
    if inputs:
        np.savez(os.path.join(outdir, "inputs.npz"), **inputs)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), group, str(r),
                               str(world), str(port), outdir], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for r in range(world)]

    def wait():
        outs = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=timeout)
                assert p.returncode == 0, err[-4000:]
                outs.append(out)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        path = os.path.join(outdir, "results.pkl")
        if group != "marg":
            with open(path, "rb") as fh:
                return pickle.load(fh)
        return outs

    return wait


def main():
    group, rank, world, port, outdir = sys.argv[1:6]
    torch.set_num_threads(1)
    ct.distributed_initialize(f"localhost:{port}", int(world), int(rank), backend="gloo")
    if group == "marg":
        marg()
    else:
        path = os.path.join(outdir, "inputs.npz")
        inp = dict(np.load(path)) if os.path.exists(path) else {}
        inp["tmp"] = outdir
        out = {"spatial": spatial, "parallel": parallel, "calibration": calibration}[group](inp)
        if int(rank) == 0:
            with open(os.path.join(outdir, "results.pkl"), "wb") as fh:
                pickle.dump(out, fh)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
