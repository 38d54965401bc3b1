"""The rest of load_sim's and MAP_joint's options in the port against the
JAX package on the same inputs: load_sim's keywords (noise, beam, mask,
spectra, fiducial_theta, Nphi_fac, D and G, L, rotator, key),
NoLensingDataSet and load_nolensing_sim, Hessian_logpdf_preconditioner,
the data model's forward-model sites, and MAP_joint with brent (alone and
switched on by a logprior), nburnin_update_hessian, quasi_sample (JAX's
draws replayed through core/ops.py's white noise) and a NoLensingDataSet;
and the deliberate brent differences (ROADMAP Queue 3).

Inputs: a JAX `load_sim` at 16^2 P carried across as numpy arrays
(`dataset_from_numpy`), and JAX `load_sim`s with keywords beside the
port's with the same keywords (the operators are deterministic; the
simulations are not compared, the two packages draw different numbers).
MAP_joint runs strict on both sides (precision=None).

Tolerances, relative max-abs unless said, each the measured gap times a
margin:
- load_sim's operators 1e-5 (the same float32 spectra; Nphi the
  quadratic estimate's normalization, 1.4e-6 in tests/test_torch_ensemble.py).
- logpdfs 1e-5 (float32 sums); the Wiener filter and a MAP's f and phi
  1e-4.
- brent's alpha: the JAX package minimizes the float32 total logpdf,
  which is flat to within its ulp (0.0039 at ~3e4) over ~1e-2 of alpha
  about the optimum; the port minimizes the cancellation-free difference
  (ROADMAP Queue 3). So the port's alpha is held to the optimum of a
  quadratic fitted to the difference (5e-3; measured 1e-4 to 5e-4, brent's
  tolerance against the difference's float32 rounding) and to JAX's to
  ALPHA_TOL 3e-2 (measured 1.2e-3 to 1.3e-2), and the logpdf after the
  step to JAX's at 1e-5.
- nburnin_update_hessian over 4 steps: phi 1e-4 (measured 2.9e-6 at
  32^2), quasi-samples (JAX's draws) f and phi 1e-4.
"""
import warnings

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cmblensing_tpu.core import field as JF
from cmblensing_tpu.core.basis import Basis as JBasis
from cmblensing_tpu.core.ops import Diag as JDiag, LowPass as JLowPass
from cmblensing_tpu.inference import maximization as jm
from cmblensing_tpu.models import dataset as jdataset, fwdmodel as jfwd
from cmblensing_tpu.models.dataset import load_sim as j_load_sim
from cmblensing_tpu.models.powerlens import PowerLens as JPower
from cmblensing_tpu.utils.cls import camb as j_camb, noise_cls as j_noise_cls

import cmblensing_tpu_torch as ct
from cmblensing_tpu_torch.core import ops as tops
from cmblensing_tpu_torch.core.ops import LowPass
from cmblensing_tpu_torch.inference import maximization as tm
from cmblensing_tpu_torch.models.dataset import DIAG_OPS

N, THETAPIX = 16, 5
CG = dict(tol=0.0, nsteps=5, fixed_iters=True, hessian_precision=None)
OP_TOL, LP_TOL, FIELD_TOL, ALPHA_TOL, OPT_TOL = 1e-5, 1e-5, 1e-4, 3e-2, 5e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _np(f, basis=None):
    if isinstance(f, ct.Field):
        return (f if basis is None else f.to(ct.Basis(basis.pol, basis.space))).arr.detach().numpy()
    return np.asarray((f if basis is None else f.to(basis)).arr)


def _carry(jfield, proj):
    return ct.Field(torch.as_tensor(np.array(jfield.arr)),
                    ct.Basis(jfield.basis.pol, jfield.basis.space), proj)


def _port_dataset(jds):
    """The port's DataSet of the JAX dataset's fiducial operators and d."""
    ds0 = jds.at({})
    arrays = {"d": (np.array(jds.d.arr), jds.d.basis.pol, jds.d.basis.space)}
    for name in DIAG_OPS:
        op = getattr(ds0, name)
        arrays[name] = (np.array(op.diag.arr), op.diag.basis.pol, op.diag.basis.space)
    return ct.dataset_from_numpy(arrays, dict(Ny=N, Nx=N, thetapix=THETAPIX, T=np.float32),
                                 device="cpu")


@pytest.fixture(scope="module")
def P16():
    out = j_load_sim(thetapix=THETAPIX, Nside=N, pol="P", T=np.float32, seed=2)
    tds = _port_dataset(out["ds"])
    proj = tds.d.proj
    return dict(jds=out["ds"], tds=tds, proj=proj, jproj=out["proj"],
                jf=out["f"], jphi=out["phi"], tf=_carry(out["f"], proj),
                tphi=_carry(out["phi"].to(out["phi"].basis.with_space("map")), proj))


def _weak_logprior(Cphi, dot, w=1e-2):
    """-w/2 phi' Cphi^-1 phi, in either package."""
    return lambda theta=None, f=None, phi=None: -0.5 * w * dot(phi, Cphi.solve(phi))


# =========================================================================
# load_sim's keywords
# =========================================================================

def _same_ops(jout, tout, names=DIAG_OPS):
    ja, ta = jout["ds0"], tout["ds0"]
    for name in names:
        jop, top = getattr(ja, name), getattr(ta, name)
        if isinstance(jop, jdataset._Identity):
            assert top is ct.Id, name
            continue
        jd, td = jop.diag, top.diag
        assert td.basis == ct.Basis(jd.basis.pol, jd.basis.space), name
        assert rel(td.arr.numpy(), np.asarray(jd.arr)) < OP_TOL, name


KEYWORD_CASES = {
    "noise and beam": dict(muKarcminT=5, lknee=50, alphaknee=2, beamFWHM=3, Nphi_fac=3),
    "fiducial Aphi": dict(fiducial_theta={"Aphi": 1.3}),
    "bandpass": dict(bandpass_mask="LowPass(2000)"),
    "spectra": dict(Cl="camb", Cln="noise_cls(2, lknee=30, alphaknee=1)"),
    "operators": dict(Cn="Cn", B="B", B_hat="B_hat", M="M", M_hat=None, D="D", G="G"),
}


def _keyword_values(kw, jax_side, lmax, proj):
    """The values of a KEYWORD_CASES entry in one package: the named
    spectra and operators built the same way, numpy arrays for the
    operators."""
    rng = np.random.default_rng(7)
    out = {}
    for k, v in kw.items():
        if not isinstance(v, str):
            out[k] = v
        elif v == "LowPass(2000)":
            out[k] = JLowPass(2000) if jax_side else LowPass(2000)
        elif v == "camb":
            out[k] = j_camb(lmax=lmax) if jax_side else ct.camb(lmax=lmax)
        elif v.startswith("noise_cls"):
            out[k] = (j_noise_cls if jax_side else ct.noise_cls)(2, lknee=30, alphaknee=1,
                                                                  lmax=lmax)
        else:   # a Fourier-diagonal EB operator of positive random values
            arr = rng.uniform(0.5, 2.0, (2, N, N // 2 + 1)).astype(np.float32)
            if k in ("Cn",):
                arr = arr * 1e-6
            out[k] = (JDiag(JF.Field(jnp.asarray(arr), JBasis("EB", "fourier"), proj)) if jax_side
                      else ct.Diag(ct.Field(torch.as_tensor(arr), ct.EB_FOURIER, proj)))
    return out


@pytest.mark.parametrize("case", list(KEYWORD_CASES))
def test_load_sim_keywords_match_jax(case):
    base = dict(thetapix=THETAPIX, Nside=N, pol="P", seed=2, T=np.float32)
    jproj = jdataset.ProjLambert(N, N, thetapix=THETAPIX, T=np.float32)
    tproj = ct.ProjLambert(N, N, thetapix=THETAPIX, T=np.float32, device="cpu")
    lmax = int(np.ceil(np.sqrt(2) * float(tproj.nyquist)) + 1)
    jout = j_load_sim(**base, **_keyword_values(KEYWORD_CASES[case], True, lmax, jproj))
    tout = ct.load_sim(**base, **_keyword_values(KEYWORD_CASES[case], False, lmax, tproj),
                       device="cpu")
    _same_ops(jout, tout)


def test_load_sim_L_keyword_makes_the_dataset_lense_with_it(P16):
    kw = dict(thetapix=THETAPIX, Nside=N, pol="P", seed=2)
    jout = j_load_sim(**kw, L=lambda p: JPower(p, 3))
    tout = ct.load_sim(**kw, L=lambda p: ct.PowerLens(p, 3), device="cpu")
    assert isinstance(tout["ds"].L(P16["tphi"]), ct.PowerLens)
    jo = jout["ds"].L(P16["jphi"]) @ P16["jf"]
    to = tout["ds"].L(P16["tphi"]) @ P16["tf"]
    assert rel(_np(to, jo.basis), _np(jo, jo.basis)) < OP_TOL
    _same_ops(jout, tout)


def test_load_sim_checks_Cl_and_fiducial_theta():
    kw = dict(thetapix=THETAPIX, Nside=N, pol="P", device="cpu")
    Cl = ct.camb()
    TT = Cl["unlensed_scalar"]["TT"]
    short = dict(Cl, unlensed_scalar=dict(Cl["unlensed_scalar"],
                                          TT=ct.Cls(TT.ell[:500], TT.Cl[:500])))
    with pytest.raises(ValueError, match="extends only"):
        ct.load_sim(**kw, Cl=short)
    with pytest.raises(ValueError, match="not both"):
        ct.load_sim(**kw, Cl=ct.camb(), fiducial_theta={"r": 0.1})
    with pytest.raises(RuntimeError, match="pycamb"):
        ct.load_sim(**kw, fiducial_theta={"r": 0.1})
    out = ct.load_sim(**kw, rotator=(10, 80, 0))
    assert out["proj"].rotator == (10.0, 80.0, 0.0)


def test_load_sim_key_is_a_generator_or_a_seed():
    kw = dict(thetapix=THETAPIX, Nside=N, pol="P", device="cpu")
    want = ct.load_sim(**kw, seed=5)["d"].arr
    assert torch.equal(ct.load_sim(**kw, key=torch.Generator().manual_seed(5))["d"].arr, want)
    assert torch.equal(ct.load_sim(**kw, key=5)["d"].arr, want)
    assert not torch.equal(ct.load_sim(**kw, seed=6)["d"].arr, want)


def test_load_sim_with_every_keyword_at_its_default_is_the_default_dataset():
    """chip_smoke.py phase 21 (f) at 16^2: bit for bit."""
    kw = dict(thetapix=THETAPIX, Nside=N, pol="P", seed=2, device="cpu")
    a = ct.load_sim(**kw)
    ds = a["ds"]
    lmax = int(np.ceil(np.sqrt(2) * float(a["proj"].nyquist)) + 1)
    b = ct.load_sim(**kw, T=np.float32, Nbatch=None, muKarcminT=3, lknee=100, alphaknee=3,
                    Cln=ct.noise_cls(3, beamFWHM=0, lknee=100, alphaknee=3, lmax=lmax), Cn=ds.Cn,
                    beamFWHM=0, B=ds.B, B_hat=ds.B_hat, pixel_mask_kwargs=None,
                    bandpass_mask=LowPass(3000), M=ds.M, M_hat=ds.M_hat, Cl=a["Cl"],
                    fiducial_theta={}, key=None, D=ds.D, G=ds.G, Nphi_fac=2, L=ct.LenseFlow,
                    rotator=(0.0, 90.0, 0.0))
    assert torch.equal(a["d"].arr, b["d"].arr)
    for name in DIAG_OPS:
        assert torch.equal(getattr(a["ds0"], name).diag.arr, getattr(b["ds0"], name).diag.arr)


# =========================================================================
# NoLensingDataSet, preconditioner, forward model
# =========================================================================

@pytest.fixture(scope="module")
def nolens():
    kw = dict(thetapix=THETAPIX, Nside=N, pol="P", seed=3)
    jout = jdataset.load_nolensing_sim(**kw, T=np.float32)
    tds = _port_dataset(j_load_sim(**kw, T=np.float32)["ds"].replace(d=jout["ds"].d))
    tnl = ct.NoLensingDataSet(d=tds.d, Cf=tds.Cf, Cn=tds.Cn, Cn_hat=tds.Cn_hat, M=tds.M,
                              M_hat=tds.M_hat, B=tds.B, B_hat=tds.B_hat)
    return dict(jout=jout, tds=tnl, proj=tds.d.proj, kw=kw)


@pytest.mark.parametrize("lensed", [False, True])
def test_load_nolensing_sim_matches_jax(nolens, lensed):
    kw = nolens["kw"]
    jout = jdataset.load_nolensing_sim(lensed_covariance=lensed, **kw)
    tout = ct.load_nolensing_sim(lensed_covariance=lensed, **kw, device="cpu")
    assert isinstance(tout["ds"], ct.NoLensingDataSet)
    _same_ops(jout, tout, ("Cf", "Cn", "Cn_hat", "M", "M_hat", "B", "B_hat"))


@pytest.mark.parametrize("what", ["logpdf", "gradientf", "argmaxf", "MAP_joint"])
def test_nolensing_dataset_matches_jax(nolens, what):
    jds, tds, proj = nolens["jout"]["ds"], nolens["tds"], nolens["proj"]
    jf = nolens["jout"]["f"]
    tf = _carry(jf, proj)
    if what == "logpdf":
        lp = _weak_logprior(tds.Cf, ct.dot)
        jlp = _weak_logprior(jds.Cf, JF.dot)
        for jd, td in ((jds, tds), (jds.replace(logprior=lambda theta=None, f=None: jlp(phi=f)),
                                    tds.replace(logprior=lambda theta=None, f=None: lp(phi=f)))):
            want = float(jd.logpdf(f=jf))
            assert abs(float(td.logpdf(f=tf)) - want) < LP_TOL * abs(want)
        return
    if what == "gradientf":
        jo, to = jds.gradientf_logpdf(jf), tds.gradientf_logpdf(tf)
        assert rel(_np(to, jo.basis), _np(jo, jo.basis)) < FIELD_TOL
        return
    cg = dict(tol=1e-3, nsteps=50, hessian_precision=None)
    jo, _ = jm.argmaxf_logpdf(jds, conjgrad_kwargs=cg)
    if what == "argmaxf":
        to, info = ct.argmaxf_logpdf(tds, conjgrad_kwargs=cg)
    else:
        jr = jm.MAP_joint(jds, conjgrad_kwargs=cg)
        r = ct.MAP_joint(tds, conjgrad_kwargs=cg)
        assert r["phi"] is None and jr["phi"] is None and len(r["history"]) == 1
        to, info = r["f"], r["history"][0]
        jo = jr["f"]
    assert int(info["iterations"]) >= 1
    assert rel(_np(to, jo.basis), _np(jo, jo.basis)) < FIELD_TOL


def test_nolensing_simulate_draws_f_then_noise(nolens):
    tds = nolens["tds"]
    g = torch.Generator().manual_seed(1)
    sim = tds.simulate(g)
    g = torch.Generator().manual_seed(1)
    f = ct.MvNormal(0, tds.Cf).sample(g)
    assert torch.equal(sim["f"].arr, f.arr)
    assert rel(_np(sim["d"], ct.EB_FOURIER), _np(tds.M @ (tds.B @ f) + sim["n"], ct.EB_FOURIER)) \
        < 1e-6


@pytest.mark.parametrize("which", ["f", "phi_mix"])
def test_Hessian_logpdf_preconditioner_matches_jax(P16, which):
    jH = jdataset.Hessian_logpdf_preconditioner(which, P16["jds"])
    tH = ct.Hessian_logpdf_preconditioner(which, P16["tds"])
    jx = P16["jf"] if which == "f" else P16["jphi"]
    tx = P16["tf"] if which == "f" else P16["tphi"]
    jo, to = jH @ jx, tH @ tx
    assert rel(_np(to, jo.basis), _np(jo, jo.basis)) < OP_TOL


def test_dataset_model_sites_match_jax_and_the_logpdf(P16):
    """fwdmodel.logpdf of the data model (sites f, phi, d) on the same
    values in both packages, and the port's equal to DataSet.logpdf."""
    jds, tds = P16["jds"], P16["tds"]
    jd = jds.d
    want = float(jfwd.logpdf(jds.model)(f=P16["jf"], phi=P16["jphi"], d=jd))
    got = float(ct.fwdmodel.logpdf(tds.model)(f=P16["tf"], phi=P16["tphi"], d=tds.d))
    assert abs(got - want) < LP_TOL * abs(want)
    assert abs(got - float(tds.logpdf(f=P16["tf"], phi=P16["tphi"]))) < 1e-6 * abs(got)
    sim = ct.fwdmodel.simulate(tds.model)(torch.Generator().manual_seed(0), phi=P16["tphi"])
    assert sim["phi"] is P16["tphi"] and sim["d"].arr.shape == tds.d.arr.shape


# =========================================================================
# MAP_joint: brent, the Hessian update, quasi-samples
# =========================================================================

def _quadratic_optimum(dstheta, f, phi, alpha):
    """The optimum of a quadratic fitted to the port's cancellation-free
    objective about alpha, along the direction MAP_joint's first step takes
    from (f, phi)."""
    f_mix, phi_mix, g = tm._phi_grad_and_fmix(dstheta, {}, f, phi)
    dphi = tm.hessian_phimix_preconditioner(dstheta).pinv() @ g
    dlp = tm._brent_dlp(dstheta, {}, f_mix, phi_mix, dphi)
    al = alpha + np.linspace(-0.05, 0.05, 7)
    c = np.polyfit(al, [dlp(a) for a in al], 2)
    return -c[1] / (2 * c[0])


@pytest.fixture(scope="module")
def brent_runs(P16):
    """MAP_joint with linesearch="brent", and with a logprior (which
    switches to brent), 2 strict steps in each package."""
    out = {}
    kw = dict(nsteps=2, precision=None, conjgrad_kwargs=CG,
              history_keys=("logpdf", "alpha", "f", "phi"))
    jds, tds = P16["jds"], P16["tds"]
    jlp = _weak_logprior(jds.Cphi.fiducial, JF.dot)
    tlp = _weak_logprior(tds.Cphi, ct.dot)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # argmaxf warns of the logprior
        out["brent"] = (jm.MAP_joint(jds, linesearch="brent", **kw),
                        ct.MAP_joint(tds, linesearch="brent", **kw), tds)
        out["logprior"] = (jm.MAP_joint(jds.replace(logprior=jlp), **kw),
                           ct.MAP_joint(tds.replace(logprior=tlp), **kw), tds.replace(logprior=tlp))
    return out


@pytest.mark.parametrize("case", ["brent", "logprior"])
def test_brent_MAP_joint_matches_jax(brent_runs, case):
    jr, tr, tds = brent_runs[case]
    for jh, th in zip(jr["history"], tr["history"]):
        assert abs(th["logpdf"] - jh["logpdf"]) < LP_TOL * abs(jh["logpdf"])
        assert th["alpha"] > 0 and abs(th["alpha"] - float(jh["alpha"])) < ALPHA_TOL
    jl = [h["logpdf"] for h in jr["history"]]
    assert all(np.diff([h["logpdf"] for h in tr["history"]]) >= 0) and np.all(np.diff(jl) >= 0)
    # the first step's alpha is the optimum of the logpdf's change along
    # the step, to brent's resolution of it
    dstheta = tds.at({}).replace(G=ct.Id)
    phi0 = tm._zero_map_like(tm._fid(dstheta.Cphi))
    with torch.no_grad():
        opt = _quadratic_optimum(dstheta, tr["history"][0]["f"], phi0, tr["history"][0]["alpha"])
    assert abs(tr["history"][0]["alpha"] - opt) < OPT_TOL
    assert rel(_np(tr["phi"], jr["phi"].basis), _np(jr["phi"], jr["phi"].basis)) < 1e-2


def test_MAP_joint_hessian_update_matches_jax(P16):
    """nburnin_update_hessian=2 over 4 steps (tests/test_inference.py:39),
    the grid search: from step 3 on the preconditioner is the smoothed
    secant ratio."""
    kw = dict(nsteps=4, nburnin_update_hessian=2, precision=None, conjgrad_kwargs=CG)
    jr = jm.MAP_joint(P16["jds"], **kw)
    tr = ct.MAP_joint(P16["tds"], **kw)
    plain = ct.MAP_joint(P16["tds"], nsteps=4, precision=None, conjgrad_kwargs=CG)
    assert rel(_np(tr["phi"], jr["phi"].basis), _np(jr["phi"], jr["phi"].basis)) < FIELD_TOL
    tl = [h["logpdf"] for h in tr["history"]]
    assert np.all(np.isfinite(tl)) and rel(tl, [h["logpdf"] for h in jr["history"]]) < LP_TOL
    assert not torch.equal(tr["phi"].arr, plain["phi"].arr)


def test_secant_update_keeps_the_preconditioner_on_too_few_bins(P16):
    """Fewer than 4 finite positive bins of the secant ratio: the current
    preconditioner stays (the JAX package's rule)."""
    phi = P16["tphi"]
    current = object()
    assert tm._secant_hessian_inv(phi, phi, phi, phi, current) is current


def test_MAP_joint_quasi_sample_with_jax_draws_matches_jax(P16, monkeypatch):
    """quasi_sample=True, 2 steps: each f-step a constrained realization;
    JAX's white noise (its key split a step, then k1 for f and k3 for the
    noise) handed to the port's draws in order."""
    key = jax.random.PRNGKey(1)
    normals = []
    for _ in range(2):
        key, sk = jax.random.split(key)
        k1, _, k3 = jax.random.split(sk, 3)
        normals += [np.asarray(jax.random.normal(k, (2, N, N), dtype=jnp.float32))
                    for k in (k1, k3)]

    def white(generator, f, batch_shape=None):
        return ct.Field(torch.as_tensor(np.array(normals.pop(0))), f.basis.with_space("map"), f.proj)

    monkeypatch.setattr(tops, "white_noise_like", white)
    kw = dict(nsteps=2, quasi_sample=True, precision=None, conjgrad_kwargs=CG,
              history_keys=("logpdf", "f"))
    jr = jm.MAP_joint(P16["jds"], key=jax.random.PRNGKey(1), **kw)
    tr = ct.MAP_joint(P16["tds"], key=torch.Generator().manual_seed(1), **kw)
    assert not normals
    for jh, th in zip(jr["history"], tr["history"]):
        assert abs(th["logpdf"] - jh["logpdf"]) < LP_TOL * abs(jh["logpdf"])
        assert rel(_np(th["f"], jh["f"].basis), _np(jh["f"], jh["f"].basis)) < FIELD_TOL
    assert rel(_np(tr["phi"], jr["phi"].basis), _np(jr["phi"], jr["phi"].basis)) < FIELD_TOL


def test_quasi_sample_takes_a_generator_or_a_seed(P16):
    kw = dict(nsteps=1, quasi_sample=True, precision=None, conjgrad_kwargs=CG,
              history_keys=("f",))
    a = ct.MAP_joint(P16["tds"], key=torch.Generator().manual_seed(4), **kw)
    b = ct.MAP_joint(P16["tds"], key=4, **kw)
    c = ct.MAP_joint(P16["tds"], **kw)   # seed 0
    assert torch.equal(a["f"].arr, b["f"].arr) and not torch.equal(a["f"].arr, c["f"].arr)


# =========================================================================
# the deliberate brent differences
# =========================================================================

def test_brent_self_guard_returns_zero_where_no_trial_beats_it():
    """Along a direction that only loses, the port's brent returns alpha = 0
    (the retry's trigger), the JAX package's a small alpha > 0 (its retry
    check alpha == 0 never holds); where a trial beats alpha = 0 the two
    agree, with the same evaluations."""
    up = lambda a: a + 0.1 * a * a
    (ta, tn), (ja, jn) = tm._brent_min(up, 2.0), jm._brent_min(up, 0.0, 2.0)
    assert ta == 0.0 and ja > 0.0 and tn == jn
    bowl = lambda a: (a - 0.7) ** 2 - 0.49
    assert tm._brent_min(bowl, 2.0) == jm._brent_min(bowl, 0.0, 2.0)


def test_brent_retry_fires_on_a_stalled_direction_and_counts_its_evaluations(P16, monkeypatch):
    """A 'high' direction that only loses (the gradient negated under the
    'high' tier): brent finds alpha = 0, the strict retry fires, finds
    alpha > 0 and keeps the run strict; the step's "nfev" counts both
    searches' evaluations (the JAX package drops the retry's)."""
    from cmblensing_tpu_torch.ops import deriv as tderiv
    real_dir, real_brent = tm._phi_grad_and_fmix, tm._brent_min
    calls = []

    def spy_dir(dstheta, theta, f, phi):
        f_mix, phi_mix, g = real_dir(dstheta, theta, f, phi)
        return (f_mix, phi_mix, -1.0 * g) if tderiv.matmul_precision() == "high" else (
            f_mix, phi_mix, g)

    def spy_brent(*a, **k):
        out = real_brent(*a, **k)
        calls.append(out)
        return out

    monkeypatch.setattr(tm, "_phi_grad_and_fmix", spy_dir)
    monkeypatch.setattr(tm, "_brent_min", spy_brent)
    r = ct.MAP_joint(P16["tds"], nsteps=2, linesearch="brent", precision="high",
                     conjgrad_kwargs=CG, history_keys=("alpha", "retry", "nfev", "logpdf"))
    h = r["history"]
    assert [c[0] == 0.0 for c in calls[:2]] == [True, False]
    assert h[0]["retry"] and h[0]["alpha"] > 0 and h[0]["nfev"] == calls[0][1] + calls[1][1]
    # the accepted strict retry keeps the run strict: no negated direction
    assert not h[1]["retry"] and h[1]["alpha"] > 0 and h[1]["nfev"] == calls[2][1]
    assert len(calls) == 3 and h[1]["logpdf"] >= h[0]["logpdf"]
