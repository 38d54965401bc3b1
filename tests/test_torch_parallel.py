"""The port's ensembles and sampler split over torch.distributed ranks,
against the port's unsharded functions (themselves held against the JAX
package by the other tests/test_torch_*.py files), with the same
generator seeds.

The ranks are 4 CPU processes over gloo, spawned once for the module
(tests/_torch_ranks.py "parallel", one torch thread each): the batch
helpers of parallel/mesh.py; MAP_marg, sample_joint (with a checkpoint
written by rank 0 and resumed by every rank) and muse with mesh=, the
sims or chains split over the ranks; and the sampler's parts on maps
split by rows, where the JAX package's threefry draws cannot be
replayed: sharded_sample_f, sharded_hmc_phi_step, sharded_gibbs_pass,
sharded_sample_slice_theta, sharded_sample_joint. This process computes
the unsharded references while the ranks run.

Tolerances, relative to the reference's largest value unless said, each
with its reason:
- MAP_marg's phi MARG_TOL 1e-4: the mean field is a sum over the ranks'
  sums instead of one mean, float32 (measured 5e-6 at 2 ranks).
- sample_joint: each chain's logpdf, f and phi 1e-5 relative and the
  same accepts (every entry runs the unsharded arithmetic; only CG's
  stop test reads across the ranks); muse's theta, H, J and Sigma 1e-5
  relative (the same MAPs, scores gathered in order).
- sharded_sample_f SAMPLE_F_TOL 1e-4 and the HMC step's phi 2e-4 with dH
  within DH_ATOL 2e-2 absolute, the same accept (tests/
  test_sharded_fft.py's bounds for the JAX package's sharded sampler);
  the Gibbs pass the same; CG WF_ITERS and GIBBS_ITERS fixed iterations
  on both sides.
- the slice pass's theta THETA_ATOL 5e-3 absolute: an inverse-CDF draw
  on a grid (SLICE_GRID, step 0.3) of mixed logpdfs of ~2e4 that agree to float32
  summation noise, ~0.03 (measured), which moves the draw by ~1 % of a
  grid step (measured 1.4e-3); its fields SLICE_TOL 3e-3, the unmix at
  that theta (phi = G(Aphi)^-1 phi°, d ln G / d ln Aphi <= 1/2).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import cmblensing_tpu_torch as ct
from _torch_ranks import (ENS_CG, GIBBS_ITERS, MUSE_MAP, SJ, SLICE_GRID, THETA_FID, WF_ITERS,
                          spawn_ranks)

WORLD = 4
MARG_TOL, CHAIN_TOL = 1e-4, 1e-5
SAMPLE_F_TOL, HMC_TOL, DH_ATOL = 1e-4, 2e-4, 2e-2
THETA_ATOL, SLICE_TOL = 5e-3, 3e-3


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _np(x):
    return (x.arr if hasattr(x, "arr") else x).detach().numpy()


def _sim(N, seed):
    return ct.load_sim(thetapix=3, Nside=N, pol="P", T=np.float32, seed=seed, device="cpu")


def _unsharded():
    """The unsharded port's runs of what the ranks run sharded."""
    ref = {}
    ds = _sim(32, 1)["ds"]
    phi, hist = ct.MAP_marg(ds, generator=_gen(0), nsteps=2, Nsims=8, conjgrad_kwargs=ENS_CG)
    ref["marg"] = (_np(phi), [h["gradnorm"] for h in hist])
    c = ct.sample_joint(ds, 3, generator=_gen(0), **SJ)
    ref["sample_joint"] = [dict(step=e["step"], logpdf=_np(e["logpdf"]), accept=_np(e["accept"]),
                                phi=_np(e["phi"]), f=_np(e["f"])) for e in c[0]]
    m = ct.muse(ds, dict(Aphi=1.0), nsims=8, nsteps=1, generator=_gen(0), MAP_kwargs=MUSE_MAP)
    ref["muse"] = dict(theta=m["theta"]["Aphi"], H=m["H"], J=m["J"], Sigma=m["Sigma"])
    sim = _sim(32, 0)
    ds, phi, f = sim["ds"], sim["phi"].to(ct.MAP), sim["f"].to(ct.QU_MAP)
    strict = dict(hessian_precision=None)
    fs, _ = ct.sample_f(_gen(7), ds, phi=phi, conjgrad_kwargs=dict(tol=0.0, nsteps=WF_ITERS,
                                                                   fixed_iters=True, **strict))
    ref["sample_f"] = _np(fs.to(ct.QU_MAP))
    Lam = ct.mass_matrix_phi({}, ds)
    x, dH, acc = ct.hmc_step(_gen(3), lambda p: ds.logpdf(f=f, phi=p), phi, Lam, N=5, eps=3e-8)
    ref["hmc"] = (_np(x.to(ct.MAP)), float(dH), bool(acc))
    g = _gen(11)
    fg, _ = ct.sample_f(g, ds, phi=phi, conjgrad_kwargs=dict(tol=0.0, nsteps=GIBBS_ITERS,
                                                             fixed_iters=True, **strict))
    fg = fg.to(ct.QU_MAP)
    pg, dH, acc = ct.hmc_step(g, lambda p: ds.logpdf(f=fg, phi=p), phi, Lam, N=3, eps=1e-8)
    ref["gibbs"] = (_np(fg), _np(pg.to(ct.MAP)), float(dH), bool(acc))
    m = ct.mix(ds, f=f, phi=phi, theta=THETA_FID)
    mixed = ct.Mixed(ds)
    lp = lambda v: mixed.logpdf(f_mix=m["f_mix"], phi_mix=m["phi_mix"],
                                theta=dict(THETA_FID, Aphi=float(v)))
    val, _, _ = ct.grid_and_sample(_gen(5), lp, SLICE_GRID)
    u = ct.unmix(ds, f_mix=m["f_mix"], phi_mix=m["phi_mix"], theta=dict(THETA_FID, Aphi=val))
    ref["slice"] = (val, _np(u["f"].to(ct.QU_MAP)), _np(u["phi"].to(ct.MAP)))
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' results, the unsharded references), the references
    computed while the ranks run."""
    outdir = str(tmp_path_factory.mktemp("parallel_ranks"))
    wait = spawn_ranks("parallel", WORLD, outdir)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = _unsharded()
    finally:
        torch.set_num_threads(threads)
        port = wait()
    return port, ref


def test_shard_batch_gives_each_rank_its_slice(runs):
    port, _ = runs
    assert port["shard_batch"].shape == (2, 1, 16, 16)
    assert np.all(port["shard_batch"][:, 0, 0, 0] == [0.0, 1.0])   # rank 0's entries
    assert np.all(port["gather_batch"][:, 0, 0, 0] == np.arange(8))
    assert port["shard_unbatched"] == (1, 16, 16)       # replicated
    assert port["shard_indivisible"] == (6, 1, 16, 16)  # 6 over 4 ranks: replicated


def test_shard_batch_cuts_raw_arrays_only_with_batch_size(runs):
    port, _ = runs
    assert port["shard_tree"] == dict(f=(2, 1, 16, 16), raw=(8, 3), plane=(4, 16, 16))
    assert port["shard_tree_bs"] == dict(f=(2, 1, 16, 16), raw=(2, 3), plane=(4, 16, 16))


def test_replicate_and_proc_info(runs):
    port, _ = runs
    assert np.all(port["replicate"] == 0.0)   # rank 0's value on every rank
    info = port["proc_info"]
    assert info["process_index"] == 0 and info["process_count"] == WORLD == info["device_count"]


def test_MAP_marg_with_mesh_matches_unsharded(runs):
    (phi, gn), (rphi, rgn) = runs[0]["marg"], runs[1]["marg"]
    assert rel(phi, rphi) < MARG_TOL
    np.testing.assert_allclose(gn, rgn, rtol=MARG_TOL)


@pytest.mark.parametrize("what", ["logpdf", "phi", "f"])
def test_sample_joint_with_mesh_matches_unsharded(runs, what):
    """Steps 1-2 of the sharded run and step 3 resumed from rank 0's
    checkpoint, against one unsharded 3-step run from the same seed."""
    port, ref = runs[0]["sample_joint"], runs[1]["sample_joint"]
    assert [e["step"] for e in port] == [e["step"] for e in ref] == [1, 2, 3]
    for e, r in zip(port, ref):
        assert e[what].shape == r[what].shape and e[what].shape[0] == SJ["nchains"]
        assert rel(e[what], r[what]) < CHAIN_TOL
        assert np.array_equal(e["accept"], r["accept"])


@pytest.mark.parametrize("what", ["theta", "H", "J", "Sigma"])
def test_muse_with_mesh_matches_unsharded(runs, what):
    port, ref = runs[0]["muse"], runs[1]["muse"]
    assert rel(port[what], ref[what]) < CHAIN_TOL


def test_sharded_sample_f_matches_sample_f(runs):
    assert rel(runs[0]["sample_f"], runs[1]["sample_f"]) < SAMPLE_F_TOL


def test_sharded_hmc_phi_step_matches_hmc_step(runs):
    (x, dH, acc), (rx, rdH, racc) = runs[0]["hmc"], runs[1]["hmc"]
    assert acc == racc
    assert abs(dH - rdH) < DH_ATOL
    assert rel(x, rx) < HMC_TOL


def test_sharded_gibbs_pass_matches_unsharded_passes(runs):
    (f, phi, dH, acc), (rf, rphi, rdH, racc) = runs[0]["gibbs"], runs[1]["gibbs"]
    assert acc == racc
    assert abs(dH - rdH) < DH_ATOL
    assert rel(f, rf) < SAMPLE_F_TOL
    assert rel(phi, rphi) < HMC_TOL


def test_sharded_sample_slice_theta_matches_unsharded(runs):
    (th, f, phi), (rth, rf, rphi) = runs[0]["slice"], runs[1]["slice"]
    assert abs(th - rth) < THETA_ATOL
    assert rel(f, rf) < SLICE_TOL and rel(phi, rphi) < SLICE_TOL, (rel(f, rf), rel(phi, rphi))


def test_sharded_sample_joint_resumes(runs):
    steps, resumed, lps, saved = runs[0]["sharded_chain"]
    assert steps == [1, 2] and resumed == [3]
    assert np.all(np.isfinite(lps))
    assert saved == [False, True]


def test_spatial_divisibility_guard(runs):
    guard = runs[0]["guard_divisible"]
    assert guard.startswith("ValueError") and "divisible" in guard


def test_two_process_MAP_marg_agrees(tmp_path):
    """Two ranks, one MAP_marg step with the sims split over them: both
    print the same phi checksum (the JAX package's
    tests/_distributed_worker.py)."""
    outs = spawn_ranks("marg", 2, str(tmp_path))()
    sums = [float(next(line for line in out.splitlines() if line.startswith("MAPMARG_OK"))
                  .split("checksum=")[1]) for out in outs]
    assert np.isfinite(sums[0]) and sums[0] > 0
    assert sums[0] == sums[1]


def test_distributed_initialize_raises_on_a_broken_setup():
    """A requested world whose store cannot be reached raises (or ends the
    process) instead of carrying on as one process."""
    code = ("import cmblensing_tpu_torch as ct\n"
            "try:\n"
            "    ct.distributed_initialize('localhost:1', 2, 1, initialization_timeout=1)\n"
            "except Exception as e:\n"
            "    print('RAISED', type(e).__name__)\n"
            "else:\n"
            "    print('SILENT')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=root, CUDA_VISIBLE_DEVICES=""))
    assert ("RAISED" in r.stdout or r.returncode != 0) and "SILENT" not in r.stdout, (
        r.returncode, r.stdout, r.stderr[-2000:])


def test_distributed_initialize_is_a_no_op_when_nothing_is_asked(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    before = torch.distributed.is_initialized()
    ct.distributed_initialize()
    assert torch.distributed.is_initialized() == before


def test_make_mesh_refuses_nccl_off_the_card():
    with pytest.raises(ValueError, match="CUDA"):
        ct.make_mesh(device="cpu", backend="nccl")
