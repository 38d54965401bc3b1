"""The port's spatially sharded layer (cmblensing_tpu_torch/parallel/:
pencil FFTs, ShardedLenseFlow, the Wiener filter, the theta forms and
sharded_MAP_joint) against the JAX package's sharded functions.

The port runs on 4 CPU ranks over gloo, spawned once for the module
(tests/_torch_ranks.py "spatial", one torch thread each), after this
process has run the JAX functions on JAX's 4-device CPU mesh
(tests/conftest.py gives 8 virtual devices) on the same inputs: JAX's
32^2 and 64^2 P simulations, carried across as numpy arrays. The ranks
hand their results back gathered whole; the tests compare.

Tolerances, relative to the reference's largest value unless said, each
with its reason:
- FFT_TOL 1e-5: float32 FFTs of O(1) maps by two libraries (a few ulps
  of the largest coefficient); the padded pencil columns exactly 0.
- the Fourier-diagonal apply and its gradient 2e-5: two FFT pairs.
- get_Cl_sharded 2e-4 relative per bin, the JAX test's bound (bins of a
  few modes, float32 power sums).
- the flows FLOW_TOL 1e-5 (the kernels' bound against plain, PERF.md §2:
  both sides are the same circulant products in float32) and delta phi
  DPHI_TOL 1e-4 (the kernel-path gradient's bound).
- the Wiener filter WF_TOL 1e-4 of max |f|: the same preconditioned CG,
  WF_ITERS (20) iterations on both sides (tol 0), float32 iterates (the
  JAX tests hold each package's to its unsharded solve at 2e-3 and 5e-3).
- the logpdf LP_TOL 1e-5 relative (float32 sums of ~3e3 by two
  libraries, ulp 2.4e-4; measured 2.7e-6).
- the theta forms: unmix 5e-4 and the mixed logpdf 3e-4 relative, the
  JAX test's bounds (tests/test_sharded_theta.py); mix 5e-4, not the JAX
  test's 2e-4: D(r = 0.1) reaches 1.2e4 where Cf is small, so the two
  libraries' float32 FFT rounding (~1e-7 of the largest coefficient)
  shows at 2e-4 of f° (measured 2.1e-4, the same between the packages'
  unsharded mix, while each package's sharded mix is within 2e-7 of its
  unsharded one).
- sharded_MAP_joint after 2 steps: phi MAP_TOL 1e-4 relative L2 and the
  logpdfs 1e-4 relative (tests/test_sharded_fft.py:216-245's bounds);
  the line search's alphas equal to 1e-6 (the same grid argmax).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from cmblensing_tpu.core.basis import Basis as JBasis
from cmblensing_tpu.core.field import Field as JField, repeat_batch as jrepeat
from cmblensing_tpu.core.proj import ProjLambert as JProj
from cmblensing_tpu.models.dataset import load_sim as j_load_sim, mix as jmix
from cmblensing_tpu.ops import deriv as jderiv
from cmblensing_tpu.parallel import sharded_fft as jsf
from cmblensing_tpu.parallel import sharded_wf as jsw
from cmblensing_tpu.parallel import spatial as jsp

from _torch_ranks import WF_ITERS, spawn_ranks

WORLD = 4
FFT_TOL, FD_TOL, CL_TOL = 1e-5, 2e-5, 2e-4
FLOW_TOL, DPHI_TOL = 1e-5, 1e-4
WF_TOL, LP_TOL = 1e-4, 1e-5
MIX_TOL, UNMIX_TOL, MIXED_LP_TOL = 5e-4, 5e-4, 3e-4
MAP_TOL, ALPHA_TOL = 1e-4, 1e-6
THETA = dict(r=0.1, Aphi=1.4)
THETA_FID = dict(r=0.2, Aphi=1.0)
MASK = dict(edge_padding_deg=0.2, apodization_deg=0.1)
QU, I = JBasis("QU", "map"), JBasis("I", "map")


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _np(f, basis):
    return np.asarray(f.to(basis).arr)


@pytest.fixture(scope="module")
def mesh4():
    return jsp.spatial_mesh(4, devices=jax.devices("cpu"))


def _inputs():
    """JAX's simulations and the FFT cases' arrays, as numpy."""
    inp = {}
    rs = np.random.RandomState(0)
    inp["fft_arr"] = rs.randn(2, 32, 32).astype(np.float32)
    ky, kx = np.fft.fftfreq(32)[:, None], np.fft.rfftfreq(32)[None, :]
    inp["fft_mult"] = np.exp(-50 * (ky ** 2 + kx ** 2)).astype(np.float32)
    inp["fft_w"] = np.fft.irfft2(np.fft.rfft2(inp["fft_arr"]) * inp["fft_mult"],
                                 s=(32, 32)).astype(np.float32)
    rs = np.random.RandomState(4)
    inp["cl_a"] = rs.randn(1, 32, 32).astype(np.float32)
    inp["cl_b"] = inp["cl_a"] + rs.randn(1, 32, 32).astype(np.float32)
    sims = {}
    for N in (32, 64):
        out = j_load_sim(thetapix=3, Nside=N, pol="P", T=np.float32, seed=0)
        sims[N] = out
        inp[f"phi{N}"] = _np(out["phi"], I)
        inp[f"f{N}"] = _np(out["f"], QU)
    ds = sims[32]["ds"]
    inp["d"] = _np(ds.d, QU)
    masked = j_load_sim(thetapix=3, Nside=32, pol="P", T=np.float32, seed=0,
                        pixel_mask_kwargs=MASK)
    inp["d_masked"] = _np(masked["ds"].d, QU)
    phi, f = sims[32]["phi"].to(I), sims[32]["f"].to(QU)
    with jderiv.mode_ctx("matmul"):
        mixed = jax.jit(lambda th: jmix(ds, f=f, phi=phi, theta=th))
        for tag, th in (("fid", THETA_FID), ("moved", THETA)):
            m = mixed({k: jnp.float32(v) for k, v in th.items()})
            inp["fm_" + tag], inp["pm_" + tag] = _np(m["f_mix"], QU), _np(m["phi_mix"], I)
    sims_b = ds.simulate(jax.random.PRNGKey(5), phi=jrepeat(phi, 2), batch_shape=(2,))
    inp["d_batch"] = _np(sims_b["d"], QU)
    return inp, ds, masked["ds"]


def _jax_side(inp, ds, ds_masked, mesh4):
    """The JAX package's sharded functions on the same inputs."""
    out = {}
    proj = JProj(32, 32, thetapix=3, T=np.float32)
    arr = jnp.asarray(inp["fft_arr"])
    xs = jsp.shard_spatial(JField(arr, QU, proj), mesh4).arr
    X = jsf.rfft2_sharded(xs, mesh4)
    out["rfft2"] = np.asarray(X)
    out["irfft2"] = np.asarray(jsf.irfft2_sharded(X, 32, mesh4))
    mp = jsf.pad_multiplier(inp["fft_mult"], mesh4)
    w = jnp.asarray(inp["fft_w"])
    apply = lambda a: jsf.fourier_diag_apply_sharded(mp, JField(a, QU, proj), mesh4).arr
    out["fd_apply"] = np.asarray(apply(xs))
    out["fd_grad"] = np.asarray(jax.jit(jax.grad(lambda a: jnp.sum(apply(a) * w)))(xs))
    fa = jsp.shard_spatial(JField(jnp.asarray(inp["cl_a"]), I, proj), mesh4)
    fb = jsp.shard_spatial(JField(jnp.asarray(inp["cl_b"]), I, proj), mesh4)
    c = jsf.get_Cl_sharded(fa, mesh4, dl=500)
    cx = jsf.get_Cl_sharded(fa, mesh4, f2=fb, dl=500)
    out["cl"] = (np.asarray(c.ell), np.asarray(c.Cl), np.asarray(cx.Cl))
    for N in (32, 64):
        pN = JProj(N, N, thetapix=3, T=np.float32)
        phi = jsp.shard_spatial(JField(jnp.asarray(inp[f"phi{N}"]), I, pN), mesh4)
        f = jsp.shard_spatial(JField(jnp.asarray(inp[f"f{N}"]), QU, pN), mesh4)
        v = jnp.asarray(np.roll(inp[f"f{N}"], 3, -1))
        L = jsp.ShardedLenseFlow(phi, 7, mesh4)
        # jitted: one program a flow (and the flow with its custom-VJP
        # backward), compiled once, where eager shard_maps compile piecewise
        out[f"L{N}"] = np.asarray(jax.jit(lambda a: (L @ JField(a, QU, pN)).arr)(f.arr))
        if N == 32:
            out[f"LH{N}"] = np.asarray(jax.jit(lambda a: (L.H @ JField(a, QU, pN)).arr)(f.arr))
        grad = jax.jit(jax.grad(lambda p: jnp.sum(v * (L(JField(p, I, pN)) @ f).arr)))
        out[f"dphi{N}"] = np.asarray(grad(phi.arr))
    phi, f = JField(jnp.asarray(inp["phi32"]), I, proj), JField(jnp.asarray(inp["f32"]), QU, proj)
    for tag, dset in (("", ds), ("_masked", ds_masked)):
        fw, _ = jsw.sharded_wiener_filter(dset, phi, mesh4, nsteps=WF_ITERS, tol=0.0)
        out["wf" + tag] = np.asarray(fw.arr)
        lp = jax.jit(lambda fa, pa: jsw.sharded_lensing_logpdf(dset, JField(fa, QU, proj),
                                                               JField(pa, I, proj), mesh4))
        out["logpdf" + tag] = [float(lp(s * f.arr, t * phi.arr)) for s, t in ((1, 1), (0.8, 0.5))]
    th = {k: jnp.float32(v) for k, v in THETA.items()}
    kw = dict(mesh=mesh4, axis_name="sp", batch_axis=None, nsteps_flow=7)
    fm, pm = jsw._jit_sh_mix(ds, f, phi, th, **kw)
    out["mix"] = (np.asarray(fm.arr), np.asarray(pm.to(I).arr))
    fu, pu = jsw._jit_sh_unmix(ds, JField(jnp.asarray(inp["fm_moved"]), QU, proj),
                               JField(jnp.asarray(inp["pm_moved"]), I, proj), th, **kw)
    out["unmix"] = (np.asarray(fu.arr), np.asarray(pu.to(I).arr))
    # one compile for both theta values (theta traced), as the JAX slice
    # pass evaluates its grid
    out["mixed_logpdf"] = {
        tag: float(jsw._jit_sh_mixed_lp(
            ds, JField(jnp.asarray(inp["fm_" + tag]), QU, proj),
            JField(jnp.asarray(inp["pm_" + tag]), I, proj),
            {k: jnp.float32(v) for k, v in th.items()}, mesh=mesh4, axis_name="sp",
            batch_axis=None, nsteps_flow=7))
        for tag, th in (("fid", THETA_FID), ("moved", THETA))}
    res = jsw.sharded_MAP_joint(ds, mesh4, nsteps=2, cg_nsteps=60, cg_tol=1e-7, ngrid=8)
    out["map"] = (np.asarray(res["phi"].to(I).arr), np.asarray(res["f"].to(QU).arr),
                  [(float(np.sum(h["logpdf"])), float(np.max(h["alpha"])))
                   for h in res["history"]])
    mesh2 = jsp.spatial_mesh(4, devices=jax.devices("cpu"), nbatch=2)
    dsb = ds.replace(d=JField(jnp.asarray(inp["d_batch"]), QU, proj))
    fb, _ = jsw.sharded_wiener_filter(dsb, phi, mesh2, batch_axis="batch", nsteps=WF_ITERS,
                                      tol=0.0)
    out["wf_batch"] = np.asarray(fb.arr)
    return out


@pytest.fixture(scope="module")
def runs(mesh4, tmp_path_factory):
    """(the port's results on 4 ranks, the JAX package's). The ranks start
    after the JAX side: beside JAX's compiler threads their collectives
    wait on descheduled peers."""
    outdir = str(tmp_path_factory.mktemp("spatial_ranks"))
    inp, ds, ds_masked = _inputs()
    ref = _jax_side(inp, ds, ds_masked, mesh4)
    return spawn_ranks("spatial", WORLD, outdir, inp)(), ref


def test_rfft2_sharded_matches_jax(runs):
    port, ref = runs
    assert port["rfft2"].shape == ref["rfft2"].shape == (2, 32, 20)
    assert rel(port["rfft2"], ref["rfft2"]) < FFT_TOL
    assert np.max(np.abs(port["rfft2"][..., 17:])) == 0.0


def test_irfft2_sharded_round_trip_matches_jax(runs):
    port, ref = runs
    assert rel(port["irfft2"], ref["irfft2"]) < FFT_TOL


@pytest.mark.parametrize("what", ["fd_apply", "fd_grad"])
def test_fourier_diag_apply_and_its_gradient_match_jax(runs, what):
    port, ref = runs
    assert rel(port[what], ref[what]) < FD_TOL


def test_get_Cl_sharded_matches_jax(runs):
    (ell, cl, clx), (rell, rcl, rclx) = runs[0]["cl"], runs[1]["cl"]
    m = np.isfinite(rcl)
    np.testing.assert_allclose(ell[m], rell[m], rtol=1e-6)
    np.testing.assert_allclose(cl[m], rcl[m], rtol=CL_TOL)
    np.testing.assert_allclose(clx[m], rclx[m], rtol=CL_TOL)


@pytest.mark.parametrize("what", ["L32", "LH32", "L64"])
def test_sharded_lenseflow_matches_jax(runs, what):
    port, ref = runs
    assert rel(port[what], ref[what]) < FLOW_TOL


@pytest.mark.parametrize("N", [32, 64])
def test_sharded_lenseflow_dphi_matches_jax(runs, N):
    port, ref = runs
    assert rel(port[f"dphi{N}"], ref[f"dphi{N}"]) < DPHI_TOL


@pytest.mark.parametrize("tag", ["", "_masked"])
def test_sharded_wiener_filter_matches_jax(runs, tag):
    port, ref = runs
    assert rel(port["wf" + tag], ref["wf" + tag]) < WF_TOL


def test_sharded_wiener_filter_on_a_2d_mesh_matches_jax(runs):
    port, ref = runs
    assert port["wf_batch"].shape == ref["wf_batch"].shape == (2, 2, 32, 32)
    for i in range(2):
        assert rel(port["wf_batch"][i], ref["wf_batch"][i]) < WF_TOL


@pytest.mark.parametrize("tag", ["", "_masked"])
def test_sharded_lensing_logpdf_matches_jax(runs, tag):
    for a, ra in zip(runs[0]["logpdf" + tag], runs[1]["logpdf" + tag]):
        assert abs(a - ra) < LP_TOL * abs(ra)


def test_sharded_mix_theta_matches_jax(runs):
    port, ref = runs
    assert rel(port["mix"][0], ref["mix"][0]) < MIX_TOL
    assert rel(port["mix"][1], ref["mix"][1]) < MIX_TOL


def test_sharded_unmix_theta_matches_jax(runs):
    port, ref = runs
    assert rel(port["unmix"][0], ref["unmix"][0]) < UNMIX_TOL
    assert rel(port["unmix"][1], ref["unmix"][1]) < UNMIX_TOL


@pytest.mark.parametrize("tag", ["fid", "moved"])
def test_sharded_mixed_logpdf_theta_matches_jax(runs, tag):
    a, b = runs[0]["mixed_logpdf"][tag], runs[1]["mixed_logpdf"][tag]
    assert abs(a - b) < MIXED_LP_TOL * abs(b)


def test_sharded_MAP_joint_matches_jax(runs):
    """The slice as a whole: two sharded_MAP_joint steps at 32^2 P."""
    (phi, _, hist), (rphi, _, rhist) = runs[0]["map"], runs[1]["map"]
    assert np.linalg.norm(phi - rphi) < MAP_TOL * np.linalg.norm(rphi)
    for (lp, a), (rlp, ra) in zip(hist, rhist):
        assert abs(lp - rlp) < MAP_TOL * abs(rlp)
        assert abs(a - ra) < ALPHA_TOL * max(1.0, abs(ra))
    assert hist[1][0] >= hist[0][0]


def test_sharded_guards(runs):
    port, _ = runs
    assert port["guard_divisible"].startswith("ValueError") and "divisible" in \
        port["guard_divisible"]
    assert port["guard_basis"].startswith("ValueError") and "lense basis" in port["guard_basis"]
