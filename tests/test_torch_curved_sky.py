"""The port's curved sky against the JAX package on the same inputs:
EquiRect fields and their transforms, the block covariances
(Cl_to_Cov_EquiRect, Cl_to_Beam_EquiRect), the block operator's algebra,
sqrt, pinv, solve, logdet and simulate, er_dot and mapblocks, the EquiRect
Wiener filter through NoLensingDataSet and argmaxf_logpdf, the HEALPix
pixelization, the NUFFT and `project` both ways; and the deliberate
difference in the Wigner-d start value (ROADMAP Queue 3): the JAX package's
overflows past |m| = 1024, the port's stays finite.

Sizes are the JAX tests' (tests/test_projections.py, test_nufft.py): Ny
8-16, Nx 16-64, nside 16-32, lmax <= 100; each JAX computation runs once,
in a module fixture, and is shared. The two packages get the same numpy
arrays; where a draw is needed the port is handed JAX's white noise
through proj_equirect.white_noise.

Tolerances, relative max-abs: transforms, blocks, matvec, er_dot, logdet
1e-6 (float32; the blocks are summed in float64 in another order and cast
once); sqrt, pinv and solve through their products 1e-5 (each block's SVD
or LU in float32); simulate 1e-5; the Wiener filter 1e-4 (CG to tol 1e-6);
`project` and the NUFFT 1e-5 (the 'fft' sphere-to-grid direction on a
patch the sphere's pixels sample densely: a well-posed solve).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cmblensing_tpu.core import healpix_pix as jhp, proj_equirect as JE, proj_healpix as JH
from cmblensing_tpu.core.proj import ProjLambert as JProjLambert
from cmblensing_tpu.inference.maximization import argmaxf_logpdf as j_argmaxf
from cmblensing_tpu.models.dataset import NoLensingDataSet as JNoLensing
from cmblensing_tpu.models.distributions import MvNormal as JMvNormal
from cmblensing_tpu.ops import nufft as JN
from cmblensing_tpu.utils.cls import Cls as JCls

import cmblensing_tpu_torch as ct
from cmblensing_tpu_torch.core import healpix_pix as thp, proj_equirect as TE, proj_healpix as TH
from cmblensing_tpu_torch.ops import nufft as TN

TOL, PROD_TOL, WF_TOL, PROJ_TOL = 1e-6, 1e-5, 1e-4, 1e-5
LMAX = 50
SPAN = dict(theta_span=(1.2, 1.8), phi_span=(0, 2 * np.pi))
BASIS = {"I": "map", "P": "qu_map"}


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def npy(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.array(x)


def spectra(lmax=LMAX):
    ell = np.arange(lmax + 1)
    CE = np.where(ell >= 2, 1.0 / (ell + 1.0) ** 2, 0.0)
    CB = np.where(ell >= 2, 0.3 / (ell + 1.0) ** 2, 0.0)
    return ell, CE, CB


def cov_pair(pol, jp, tp, lmax=LMAX):
    ell, CE, CB = spectra(lmax)
    jc = (JCls(ell, CE),) if pol == "I" else (JCls(ell, CE), JCls(ell, CB))
    tc = (ct.Cls(ell, CE),) if pol == "I" else (ct.Cls(ell, CE), ct.Cls(ell, CB))
    return (JE.Cl_to_Cov_EquiRect(pol, jp, *jc, lmax=lmax),
            TE.Cl_to_Cov_EquiRect(pol, tp, *tc, lmax=lmax))


def projs(Ny=8, Nx=16):
    return (JE.ProjEquiRect(Ny=Ny, Nx=Nx, **SPAN),
            TE.ProjEquiRect(Ny=Ny, Nx=Nx, **SPAN, device="cpu"))


def fields(pol, jp, tp, seed=0, batch=()):
    shape = tuple(batch) + ((jp.Ny, jp.Nx) if pol == "I" else (2, jp.Ny, jp.Nx))
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (JE.EquiRectField(jnp.asarray(x), BASIS[pol], jp),
            TE.EquiRectField(torch.as_tensor(x), BASIS[pol], tp))


@pytest.fixture(scope="module")
def covs():
    """JAX's and the port's covariances and their products on one field,
    I and P, at 8 x 16, lmax 50."""
    jp, tp = projs()
    out = {}
    for pol in ("I", "P"):
        Cj, Ct = cov_pair(pol, jp, tp)
        fj, ft = fields(pol, jp, tp)
        S, Pi = Cj.sqrt(), Cj.pinv()
        j = dict(C=Cj, f=fj, Cf=Cj @ fj, solve=Cj.solve(fj), ld=Cj.logdet(), SS=S * S,
                 PiC=Pi * Cj, Sf=S @ fj, Pf=Pi @ fj, dot=JE.er_dot(fj, Cj @ fj), H=Cj.H @ fj,
                 lp=JMvNormal(0, Cj).logpdf(fj))
        out[pol] = (j, Ct, ft)
    return out


def test_equirect_projection_metadata_matches_jax():
    jp, tp = projs(12, 24)
    for k in ("phi_edges", "phi", "theta_edges", "theta", "Omega"):
        np.testing.assert_array_equal(getattr(tp, k), getattr(jp, k), err_msg=k)
    assert tp.phi_full_circle == jp.phi_full_circle
    assert TE.ProjEquiRect(Ny=12, Nx=24, **SPAN, device="cpu") is tp
    if not torch.cuda.is_available():   # the card unless a device is named
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TE.ProjEquiRect(Ny=12, Nx=24, **SPAN)


@pytest.mark.parametrize("pol,to", [("I", "az"), ("P", "qu_az")])
def test_equirect_transforms_match_jax(pol, to):
    jp, tp = projs()
    fj, ft = fields(pol, jp, tp, batch=(2,))
    aj, at = fj.to(to), ft.to(to)
    assert rel(npy(at.arr), aj.arr) < TOL
    assert rel(npy(at.to(BASIS[pol]).arr), aj.to(BASIS[pol]).arr) < TOL
    assert at.batch_shape == tuple(aj.batch_shape) == (2,)
    # the lower half's m = 0 entries conjugate the upper half's at P
    if pol == "P":
        top, bot = npy(at.arr)[..., :8, 0], npy(at.arr)[..., 8:, 0]
        assert np.abs(top - np.conj(bot)).max() < 1e-5


@pytest.mark.parametrize("pol", ["I", "P"])
def test_equirect_blocks_and_beam_match_jax(covs, pol):
    j, Ct, _ = covs[pol]
    assert Ct.blocks.dtype == (torch.float32 if pol == "I" else torch.complex64)
    assert rel(npy(Ct.blocks), j["C"].blocks) < TOL
    jp, tp = projs()
    ell, CE, _ = spectra()
    Bj = JE.Cl_to_Beam_EquiRect(pol, jp, JCls(ell, CE), lmax=LMAX)
    Bt = TE.Cl_to_Beam_EquiRect(pol, tp, ct.Cls(ell, CE), lmax=LMAX)
    assert rel(npy(Bt.blocks), Bj.blocks) < TOL


@pytest.mark.parametrize("pol", ["I", "P"])
def test_equirect_matvec_dot_logdet_match_jax(covs, pol):
    j, Ct, ft = covs[pol]
    assert rel(npy((Ct @ ft).arr), j["Cf"].arr) < TOL
    assert rel(npy((Ct.H @ ft).arr), j["H"].arr) < TOL
    assert abs(float(TE.er_dot(ft, Ct @ ft)) / float(j["dot"]) - 1) < TOL
    assert abs(float(Ct.logdet()) / float(j["ld"]) - 1) < TOL
    assert abs(float(ct.MvNormal(0, Ct).logpdf(ft)) / float(j["lp"]) - 1) < PROD_TOL
    # the algebra: sums, differences, scalings and products of blocks
    Cj = j["C"]
    for jop, top in (((Cj + Cj) * 0.5, (Ct + Ct) * 0.5), (Cj - Cj * 0.5, Ct - Ct * 0.5),
                     (Cj * Cj, Ct * Ct)):
        assert rel(npy(top.blocks), jop.blocks) < TOL


@pytest.mark.parametrize("pol", ["I", "P"])
def test_equirect_sqrt_pinv_solve_through_products(covs, pol):
    """sqrt and pinv come from one SVD kept on the operator, solve from one
    LU: held to JAX's through S S, pinv(C) C and their actions, which U and
    V (fixed only up to phases) do not enter."""
    j, Ct, ft = covs[pol]
    S = Ct.sqrt()
    assert rel(npy((S * S).blocks), j["SS"].blocks) < PROD_TOL
    assert rel(npy((S * S).blocks), j["C"].blocks) < PROD_TOL
    assert rel(npy((Ct.pinv() * Ct).blocks), j["PiC"].blocks) < PROD_TOL
    assert rel(npy((S @ ft).arr), j["Sf"].arr) < PROD_TOL
    assert rel(npy((Ct.pinv() @ ft).arr), j["Pf"].arr) < PROD_TOL
    assert rel(npy(Ct.solve(ft).arr), j["solve"].arr) < PROD_TOL
    assert Ct._svd is not None and Ct._lu is not None   # kept, shared by sqrt and pinv


def test_diagonal_blocks_take_the_svd_and_lu_functions_entry_by_entry():
    """A white-noise operator (every off-diagonal entry zero) takes sqrt,
    pinv, solve and logdet entry by entry; they are the SVD's and LU's
    functions of the same blocks (JAX's)."""
    jp, tp = projs()
    d = np.random.default_rng(3).uniform(0.5, 2.0, (9, 16)).astype(np.float32)
    d[2, 3] = 0.0                                  # a singular entry: pinv drops it
    blocks = np.stack([np.diag(r) for r in d]).astype(np.complex64)
    Cj, Ct = (JE.BlockDiagEquiRect(jnp.asarray(blocks), "qu_az", jp),
              TE.BlockDiagEquiRect(torch.as_tensor(blocks), "qu_az", tp))
    assert Ct._diagonal() is not None
    fj, ft = fields("P", jp, tp, seed=4)
    assert rel(npy((Ct.sqrt() @ ft).arr), (Cj.sqrt() @ fj).arr) < PROD_TOL
    assert rel(npy((Ct.pinv() @ ft).arr), (Cj.pinv() @ fj).arr) < PROD_TOL
    dd = d.copy()
    dd[2, 3] = 1.0
    Cj2, Ct2 = (JE.BlockDiagEquiRect(jnp.asarray(np.stack([np.diag(r) for r in dd])), "qu_az", jp),
                TE.BlockDiagEquiRect(torch.as_tensor(np.stack([np.diag(r) for r in dd])), "qu_az", tp))
    assert rel(npy(Ct2.solve(ft).arr), Cj2.solve(fj).arr) < PROD_TOL
    assert abs(float(Ct2.logdet()) - float(Cj2.logdet())) < 1e-4
    assert Ct._svd is None     # no SVD taken


@pytest.mark.parametrize("pol", ["I", "P"])
def test_equirect_simulate_with_jax_white_noise(covs, pol, monkeypatch):
    j, Ct, _ = covs[pol]
    key = jax.random.PRNGKey(7)
    shape = (3,) + ((8, 16) if pol == "I" else (2, 8, 16))
    xi = np.asarray(jax.random.normal(key, shape, dtype=jnp.float32))
    monkeypatch.setattr(TE, "white_noise", lambda g, proj, basis, bs=(): TE.EquiRectField(
        torch.as_tensor(xi), BASIS[pol], proj))
    st = Ct.simulate(torch.Generator().manual_seed(0), batch_shape=(3,))
    sj = j["C"].simulate(key, batch_shape=(3,))
    assert rel(npy(st.arr), sj.arr) < PROD_TOL
    # a seed stands for a generator, as models/dataset.py::as_generator takes it
    monkeypatch.undo()
    a, b = Ct.simulate(5), Ct.simulate(torch.Generator().manual_seed(5))
    assert torch.equal(a.arr, b.arr)


def test_mapblocks_and_batched_logpdf_match_jax(covs):
    j, Ct, ft = covs["I"]
    g = TE.mapblocks(lambda B, x: B @ x, Ct, ft)
    assert rel(npy(g.arr), j["Cf"].arr) < TOL
    jp, tp = projs()
    fj, ft3 = fields("I", jp, tp, seed=2, batch=(3,))
    lp = ct.MvNormal(0, Ct).logpdf(ft3)
    assert lp.shape == (3,)
    assert rel(npy(lp), JMvNormal(0, j["C"]).logpdf(fj)) < PROD_TOL


@pytest.fixture(scope="module")
def wiener():
    """JAX's EquiRect Wiener filters (I and P) at 12 x 24, lmax 50, noise at
    1e-4 of the largest block entry, as tests/test_projections.py sets it."""
    jp, tp = projs(12, 24)
    out = {}
    for pol in ("I", "P"):
        Cj, Ct = cov_pair(pol, jp, tp)
        nm, n, _ = Cj.blocks.shape
        s2 = 1e-4 * float(np.max(np.abs(np.asarray(Cj.blocks))))
        eye = np.broadcast_to(np.eye(n, dtype=np.asarray(Cj.blocks).dtype) * s2, (nm, n, n)).copy()
        Cnj = JE.BlockDiagEquiRect(jnp.asarray(eye), Cj.basis, jp)
        Cnt = TE.BlockDiagEquiRect(torch.as_tensor(eye), Ct.basis, tp)
        dj = Cj.simulate(jax.random.PRNGKey(0)) + Cnj.simulate(jax.random.PRNGKey(1))
        dsj = JNoLensing(d=dj, Cf=Cj, Cn=Cnj, Cn_hat=Cnj)
        fwj, _ = j_argmaxf(dsj, conjgrad_kwargs=dict(tol=1e-6, nsteps=200))
        d = dj.to(BASIS[pol])
        dst = ct.NoLensingDataSet(d=TE.EquiRectField(torch.as_tensor(np.array(d.arr)), d.basis, tp),
                                  Cf=Ct, Cn=Cnt, Cn_hat=Cnt)
        out[pol] = (fwj.to(BASIS[pol]), float(dsj.logpdf(f=fwj)), dst)
    return out


@pytest.mark.parametrize("pol", ["I", "P"])
def test_equirect_wiener_filter_matches_jax(wiener, pol):
    fwj, lpj, ds = wiener[pol]
    fwt, info = ct.argmaxf_logpdf(ds, conjgrad_kwargs=dict(tol=1e-6, nsteps=200))
    assert isinstance(fwt, ct.EquiRectField)
    assert rel(npy(fwt.to(BASIS[pol]).arr), fwj.arr) < WF_TOL
    assert abs(float(ds.logpdf(f=fwt)) / lpj - 1) < WF_TOL
    # a posterior sample and a batched filter run through the same solve
    fs, _ = ct.sample_f(torch.Generator().manual_seed(3), ds,
                        conjgrad_kwargs=dict(tol=1e-4, nsteps=100))
    assert isinstance(fs, ct.EquiRectField) and np.isfinite(float(ds.logpdf(f=fs)))
    d2 = TE.EquiRectField(torch.stack([ds.d.arr, 2 * ds.d.arr]), ds.d.basis, ds.d.proj)
    fb, _ = ct.argmaxf_logpdf(ds.replace(d=d2), conjgrad_kwargs=dict(tol=1e-6, nsteps=200))
    assert fb.batch_shape == (2,)
    assert rel(npy(fb.to(BASIS[pol]).arr[1]), 2 * npy(fwt.to(BASIS[pol]).arr)) < WF_TOL


def _legendre_sum(Cl, x):
    p0, p1 = 1.0, x
    tot = Cl[0] / (4 * np.pi) + 3 / (4 * np.pi) * Cl[1] * x
    for l in range(1, len(Cl) - 1):
        p0, p1 = p1, ((2 * l + 1) * x * p1 - l * p0) / (l + 1)
        tot += (2 * l + 3) / (4 * np.pi) * Cl[l + 1] * p1
    return tot


def test_cl_to_cov_is_finite_past_lmax_1024_where_jax_overflows():
    """The deliberate difference (ROADMAP Queue 3): the JAX package's
    Wigner-d start value exp(lnc) c^(l+s) (-sn)^(l-s) overflows once |m| >
    1024 (lnc ~ 0.69 l), so at lmax 1100 its harmonic columns are inf and
    every block of Cl_to_Cov_EquiRect is not finite; the port's, formed in
    log space, are finite and meet the float64 two-point sums after the
    cast: at I sum (2l+1)/4pi C_l P_l(cos b), at P <P P*> = sum (2l+1)/4pi
    (C_EE + C_BB) d^l_22(b). At orders below the overflow the port's block
    m equals JAX's (lmax 1000, each m its own single alias)."""
    from scipy.special import eval_jacobi
    jp = JE.ProjEquiRect(Ny=8, Nx=64, **SPAN)
    for s in (0, 2):
        assert not np.isfinite(JE._lambda(1100, 1030, s, jp.theta)).all()
        assert np.isfinite(JE._lambda(1100, 1000, s, jp.theta)).all()
    lmax = 1100
    ell, CE, CB = spectra(lmax)
    tp = TE.ProjEquiRect(Ny=8, Nx=64, **SPAN, device="cpu")
    w = np.full(33, 2.0)
    w[0] = w[-1] = 1.0
    for pol in ("I", "P"):
        tc = (ct.Cls(ell, CE),) if pol == "I" else (ct.Cls(ell, CE), ct.Cls(ell, CB))
        B = npy(TE.Cl_to_Cov_EquiRect(pol, tp, *tc, lmax=lmax).blocks).astype(np.complex128)
        assert np.isfinite(B).all()
        for t2 in (1, 2, 6):
            a, b = tp.theta[1], tp.theta[t2]
            x = np.cos(a) * np.cos(b) + np.sin(a) * np.sin(b)
            if pol == "I":
                cov, gam = np.sum(w * B[:, 1, t2].real) / 64, _legendre_sum(CE, x)
            else:
                cov = 2 * (np.sum(B[:, 1, t2]) + np.sum(B[1:-1, 9, 8 + t2])).real / 64
                l2 = ell[2:]
                gam = np.sum((2 * l2 + 1) / (4 * np.pi) * (CE + CB)[2:]
                             * ((1 + x) / 2) ** 2 * eval_jacobi(l2 - 2, 0, 4, x))
            assert abs(cov - gam) < 1e-4 * abs(gam), (pol, t2, cov, gam)
    # below the overflow: blocks m = 0, 1, 500, 999, 1000 at Nx 2048, lmax 1000,
    # JAX's from its own harmonic columns as its Cl_to_Cov_EquiRect sums them
    lmax, nP = 1000, 2048
    ell, CE, CB = spectra(lmax)
    jp = JE.ProjEquiRect(Ny=8, Nx=nP, **SPAN)
    tp = TE.ProjEquiRect(Ny=8, Nx=nP, **SPAN, device="cpu")
    BI = npy(TE.Cl_to_Cov_EquiRect("I", tp, ct.Cls(ell, CE), lmax=lmax).blocks)
    BP = npy(TE.Cl_to_Cov_EquiRect("P", tp, ct.Cls(ell, CE), ct.Cls(ell, CB), lmax=lmax).blocks)
    for m in (0, 1, 500, 999, 1000):
        lam = JE._lambda(lmax, m, 0, jp.theta)
        jI = ((lam * CE[:, None]).T @ lam * nP).astype(np.float32)
        lp, ln = JE._lambda(lmax, m, 2, jp.theta), JE._lambda(lmax, m, -2, jp.theta)
        gam = (lp * (CE + CB)[:, None]).T @ lp * nP / 2
        xi = (lp * (CE - CB)[:, None]).T @ ln * nP / 2
        gamc = (ln * (CE + CB)[:, None]).T @ ln * nP / 2
        jP = np.block([[gam, xi], [xi.T, gamc]]).astype(np.complex64)
        assert rel(BI[m], jI) < TOL and rel(BP[m], jP) < TOL, m


def test_healpix_pix_is_the_jax_packages():
    nside = 16
    pix = np.arange(12 * nside ** 2)
    for a, b in zip(thp.pix2ang_ring(nside, pix), jhp.pix2ang_ring(nside, pix)):
        np.testing.assert_array_equal(a, b)
    th, ph = np.random.default_rng(1).uniform(0.1, 3.0, 300), np.random.default_rng(2).uniform(
        0, 2 * np.pi, 300)
    for a, b in zip(thp.get_interp_weights(nside, th, ph), jhp.get_interp_weights(nside, th, ph)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(thp.ang2pix_ring(nside, th, ph), jhp.ang2pix_ring(nside, th, ph))
    assert thp.npix2nside(3072) == 16
    with pytest.raises(ValueError):
        thp.npix2nside(3000)


@pytest.mark.parametrize("shape", [(15, 9)])
def test_nufft_matches_jax(shape):
    Ny, Nx = shape
    g = np.random.default_rng(Ny * Nx)
    m = g.standard_normal((2, Ny, Nx)).astype(np.float32)
    ys, xs = (g.uniform(0, Ny, 40).astype(np.float32), g.uniform(0, Nx, 40).astype(np.float32))
    v = g.standard_normal(40).astype(np.float32)
    vc = (v + 1j * g.standard_normal(40)).astype(np.complex64)
    mc = (m[0] + 1j * m[1]).astype(np.complex64)
    J = lambda a: jnp.asarray(a)
    T = lambda a: torch.as_tensor(a)
    assert rel(npy(TN.nufft_eval(T(m), T(ys), T(xs))), JN.nufft_eval(J(m), J(ys), J(xs))) < PROJ_TOL
    assert rel(npy(TN.nufft_eval(T(mc), T(ys), T(xs))),
               JN.nufft_eval(J(mc), J(ys), J(xs))) < PROJ_TOL
    for vals in (v, vc):
        assert rel(npy(TN.nufft_adjoint(T(vals), T(ys), T(xs), Ny, Nx)),
                   JN.nufft_adjoint(J(vals), J(ys), J(xs), Ny, Nx)) < PROJ_TOL
    # the adjoint identity <A m, v> = <m, A^T v> for real maps
    Am = npy(TN.nufft_eval(T(m[0]), T(ys), T(xs)))
    Atv = npy(TN.nufft_adjoint(T(v), T(ys), T(xs), Ny, Nx))
    assert abs(np.dot(Am, v) - np.sum(m[0] * Atv)) < 1e-5 * abs(np.dot(Am, v))


def _hpx_maps(nside):
    th, ph = jhp.pix2ang_ring(nside, np.arange(12 * nside ** 2))
    return np.stack([np.sin(th) ** 2 * np.cos(2 * ph) + np.cos(3 * th), np.cos(th),
                     0.5 * np.sin(th) * np.sin(ph)]).astype(np.float32)


@pytest.fixture(scope="module")
def projected():
    """JAX's projections, both ways, bilinear and 'fft': nside 32 to an 8 x 8
    Lambert patch at 4 degrees (rotated and not; the sphere's pixels sample
    it ~4x; IQU, whose I and QU parts run the I and QU paths), and nside 16
    to the 8 x 16 band (I and QU)."""
    out = {}
    m32, m16 = _hpx_maps(32), _hpx_maps(16)
    cases = {"lambert": (m32, JProjLambert(8, 8, thetapix=240, T=np.float32), ("IQU",)),
             "lambert_rot": (m32, JProjLambert(8, 8, thetapix=240, T=np.float32,
                                               rotator=(30.0, 60.0, 0.0)), ("QU",)),
             "equirect": (m16, projs()[0], ("I", "QU"))}
    for name, (m, jp, pols) in cases.items():
        for pol in pols:
            mm = {"I": m[:1], "QU": m[1:], "IQU": m}[pol]
            hj = JH.HealpixField.from_map(mm, pol=pol)
            for method in ("bilinear", "fft"):
                if (name, pol, method) in PROJECT_CASES:
                    flat = JH.project(hj, jp, method=method)
                    out[name, pol, method] = (mm, flat, JH.project(flat, hj.proj, method=method))
    return out


# 'fft' once on a rotated patch (QU) and once on the band (I): each JAX
# 'fft' sphere-to-grid solve compiles its CG anew
PROJECT_CASES = [(n, p, "bilinear") for n, p in (("lambert", "IQU"), ("lambert_rot", "QU"),
                                                  ("equirect", "I"), ("equirect", "QU"))] + [
    ("lambert_rot", "QU", "fft"), ("equirect", "I", "fft")]


def _tproj(name):
    if name == "equirect":
        return projs()[1]
    rot = (30.0, 60.0, 0.0) if name == "lambert_rot" else (0.0, 90.0, 0.0)
    return ct.ProjLambert(8, 8, thetapix=240, T=np.float32, rotator=rot, device="cpu")


@pytest.mark.parametrize("case", PROJECT_CASES)
def test_project_both_ways_matches_jax(projected, case):
    name, pol, method = case
    mm, flat_j, back_j = projected[name, pol, method]
    ht = TH.HealpixField.from_map(mm, pol=pol, device="cpu")
    flat_t = TH.project(ht, _tproj(name), method=method)
    back_t = TH.project(flat_t, ht.proj, method=method)
    assert rel(npy(flat_t.arr), flat_j.arr) < PROJ_TOL
    assert rel(npy(back_t.arr), back_j.arr) < PROJ_TOL
    assert back_t.pol == back_j.pol


@pytest.mark.parametrize("name", ["lambert", "lambert_rot", "equirect"])
def test_projector_keeps_the_patch_pixels_jax_finds(name):
    """The Projector visits only the rings and arcs within the patch's reach
    and keeps the in-patch pixels: the same pixels, coordinates, stencil
    and polarization angles as the JAX package's over the whole sphere."""
    nside = 16 if name == "equirect" else 32
    tp = _tproj(name)
    jp = projs()[0] if name == "equirect" else JProjLambert(
        8, 8, thetapix=240, T=np.float32,
        rotator=(30.0, 60.0, 0.0) if name == "lambert_rot" else (0.0, 90.0, 0.0))
    pj, pt = JH.Projector(JH.ProjHealpix(nside), jp), TH.Projector(TH.ProjHealpix(nside), tp)
    sel = np.asarray(pj.hpx_idxs_in_patch)
    np.testing.assert_array_equal(pt.hpx_idxs_in_patch, sel)
    np.testing.assert_array_equal(pt.is_, pj.is_[sel])
    np.testing.assert_array_equal(pt.js_, pj.js_[sel])
    np.testing.assert_array_equal(pt.psipol_ij, pj.psipol_ij_full[sel])
    np.testing.assert_array_equal(npy(pt.sph2cart[0]), np.asarray(pj.sph2cart_idx))
    i0, j0, wi, wj = (np.asarray(a)[sel] for a in pj.cart2sph)
    np.testing.assert_array_equal(pt.i0, i0)
    np.testing.assert_array_equal(pt.wj, wj)
    assert TH.Projector(TH.ProjHealpix(nside), tp) is pt


def test_project_batched_flat_field_and_device_guard():
    """A batched flat field projects entry by entry (the 'fft' path too), and
    a healpix map on another device than the grid's is refused."""
    tp = ct.ProjLambert(32, 32, thetapix=10, T=np.float32, device="cpu")
    arr = torch.as_tensor(np.random.default_rng(0).standard_normal((2, 1, 32, 32)).astype(np.float32))
    hpx = TH.ProjHealpix(16)
    fb = ct.Field(arr, ct.Basis("I", "map"), tp)
    out = TH.project(fb, hpx, method="fft")
    assert tuple(out.arr.shape) == (1, 2, hpx.npix)
    for i in range(2):
        oi = TH.project(ct.Field(arr[i], ct.Basis("I", "map"), tp), hpx, method="fft")
        assert float((out.arr[0, i] - oi.arr[0]).abs().max()) < 1e-5
    m = TH.HealpixField(torch.zeros(1, hpx.npix), "I", hpx)
    m.arr = m.arr.to("meta")
    with pytest.raises(ValueError, match="does not project"):
        TH.project(m, tp)
