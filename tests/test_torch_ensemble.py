"""The port's ensemble pipelines against the JAX package on the same inputs:
banded (bandpower) covariances and cov_to_Cl, the theta-spec helpers and
the per-sim theta-score, MAP_joint on a batched dataset (a per-entry
alpha, the batched retry gate), the batched and two-dataset quadratic
estimate, and whole `muse` and `MAP_marg` runs with JAX's own draws
replayed through the port's draw functions (inference/muse.py's
`_simulate_sims`, inference/maximization.py's `_marg_simulate_d`), which
the cases replace.

Inputs are made once, with numpy or by the JAX package (a 16^2 pol-P
`load_sim`, its Cphi banded into 2 bins, its data simulated at a tilted
truth), and handed to both packages; each JAX run is a module fixture its
cases share. MAP_joint runs strict on both sides (precision=None): JAX's
'high' is exact float32 on the CPU, the port's is the bf16 split.

Tolerances, relative max-abs unless said, each the measured gap times a
margin:
- banded covariances: the same float32 products, exact (0); at amplitudes
  1 the unbanded operator exactly; cov_to_Cl the same numpy binning of
  the same float32 values, 1e-6 (measured 0).
- the theta-score at fixed (f, phi): float32 sums over the modes in other
  orders, SCORE_TOL 1e-5 (measured 5.3e-7).
- batched MAP_joint, 2 steps: f and phi FIELD_TOL 1e-5 (measured 2.0e-6
  and 8.1e-7; the strict MAP steps of tests/test_torch_map.py), the
  summed logpdf 1e-5, each entry's alpha 1e-6 absolute (the same float32
  grid), the gradient norms GRADNORM_TOL 1e-4 (measured 9.4e-6 at step 2:
  phi's 1e-6 through the gradient's high-l terms); each entry against its
  own unbatched run ENTRY_TOL 1e-6 (measured 0 here; at 32^2 the batched
  FFTs sum in other orders, tests/test_torch_map.py).
- the quadratic estimate QE_TOL 1e-5 (measured 1.4e-6), each batch entry
  against its unbatched estimate ENTRY_TOL (measured 0).
- MUSE (2 sims, 2 bins, 2 steps): theta's history 5e-4 (measured 6.7e-5:
  the MAPs' 1e-6 through the score's cancellation); s-bar, H and J 2e-3
  of their largest entry (measured 3.0e-5, 1.9e-4, 9.5e-6: a finite
  difference of float32 scores over eps = 0.1 resolves ~1e-5 of them);
  Sigma = H^-1 J H^-T 0.1 of its largest (measured 2.1e-2: H's smallest
  singular value lies 40x below its largest, and Sigma carries H's error
  twice).
- MAP_marg (2 sims, 2 steps): phi and the gradient norms 1e-5 (measured
  2.4e-6, 4.3e-7).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cmblensing_tpu.core import cov as jcov
from cmblensing_tpu.core.basis import Basis as JBasis
from cmblensing_tpu.core.field import Field as JField
from cmblensing_tpu.core.ops import Diag as JDiag, Id as JId
from cmblensing_tpu.core.proj import ProjLambert as JProj
from cmblensing_tpu.inference import maximization as jm
from cmblensing_tpu.inference import muse as jmuse
from cmblensing_tpu.models.dataset import load_sim as j_load_sim
from cmblensing_tpu.models.quadratic_estimate import quadratic_estimate as j_qe
from cmblensing_tpu.utils.cls import camb as j_camb

import cmblensing_tpu_torch as ct
from cmblensing_tpu_torch.core import cov as tcov
from cmblensing_tpu_torch.inference import maximization as tm
from cmblensing_tpu_torch.inference import muse as tmuse
from cmblensing_tpu_torch.models.dataset import DIAG_OPS
from cmblensing_tpu_torch.ops import deriv as tderiv

N, THETAPIX, NBINS, NSIMS = 16, 5, 2, 2
TRUTH = np.array([1.5, 0.8])
CG = dict(tol=0.0, nsteps=5, fixed_iters=True, hessian_precision=None)
MAP_KW = dict(nsteps=2, precision=None, conjgrad_kwargs=CG)
FIELD_TOL, ALPHA_TOL, GRADNORM_TOL, SCORE_TOL, QE_TOL = 1e-5, 1e-6, 1e-4, 1e-5, 1e-5
ENTRY_TOL = 1e-6
MUSE_THETA_TOL, MUSE_HJ_TOL, MUSE_SIGMA_TOL = 5e-4, 2e-3, 0.1
MARG_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread for the module (its 16^2 tensors are too small to
    share among threads, which only contend with a parallel run's other
    workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _np(f, basis=None):
    """A Field of either package as a numpy array (in `basis`, a (pol,
    space) pair, when given)."""
    if isinstance(f, ct.Field):
        return (f if basis is None else f.to(ct.Basis(*basis))).arr.detach().numpy()
    return np.asarray((f if basis is None else f.to(JBasis(*basis))).arr)


def _carry(jfield, proj):
    return ct.Field(torch.as_tensor(np.array(jfield.arr)),
                    ct.Basis(jfield.basis.pol, jfield.basis.space), proj)


def _edges(lmag, nbins):
    """scripts/muse_bandpower.py's bins: percentile edges of the nonzero
    |l|, the last bin open."""
    lm = np.asarray(lmag).ravel()
    lm = lm[lm > 0]
    inner = np.percentile(lm, np.linspace(0, 100, nbins + 1)[1:-1])
    return np.concatenate([[0.0], inner, [1e9]])


@pytest.fixture(scope="module")
def P16():
    """A JAX 16^2 P load_sim, its Cphi banded into NBINS bins, its data
    simulated at TRUTH; the same dataset in the port (the fiducial
    operators carried across, the banded Cphi built by each package from
    the same spectrum and edges)."""
    out = j_load_sim(thetapix=THETAPIX, Nside=N, pol="P", T=np.float32, seed=4)
    jproj = out["proj"]
    edges = _edges(jproj.lmag, NBINS)
    jCphi_b = jcov.Cl_to_Cov("I", jproj, (j_camb()["total"]["pp"], edges, "Aphi_b"))
    ds0 = out["ds"].at({})
    jsim = out["ds"].replace(Cphi=jCphi_b).simulate(jax.random.PRNGKey(7),
                                                    theta=dict(Aphi_b=TRUTH))
    jds = ds0.replace(d=jsim["d"])
    arrays = {"d": (np.array(jds.d.arr), jds.d.basis.pol, jds.d.basis.space)}
    for name in DIAG_OPS:
        op = getattr(ds0, name)
        arrays[name] = (np.array(op.diag.arr), op.diag.basis.pol, op.diag.basis.space)
    tds = ct.dataset_from_numpy(arrays, dict(Ny=N, Nx=N, thetapix=THETAPIX, T=np.float32),
                                device="cpu")
    proj = tds.d.proj
    tCphi_b = ct.Cl_to_Cov("I", proj, (ct.camb()["total"]["pp"], edges, "Aphi_b"))
    return dict(jds=jds, tds=tds, jds_b=jds.replace(Cphi=jCphi_b), tds_b=tds.replace(Cphi=tCphi_b),
                jsim=jsim, proj=proj, jproj=jproj, edges=edges)


# =========================================================================
# banded covariances
# =========================================================================

SPECTRA = {"I": ("TT",), "P": ("EE", "BB"), "IP": ("TT", "EE", "BB", "TE")}
BANDED_CASES = [("I", ("TT",)), ("P", ("EE",)), ("P", ("BB",)), ("IP", ("TT", "TE")),
                ("IP", ("EE", "BB"))]


@pytest.fixture(scope="module")
def projs():
    return (JProj(N, N, thetapix=3, T=np.float32),
            ct.ProjLambert(N, N, thetapix=3, T=np.float32, device="cpu"))


def _blocks(op):
    """A Diag's diagonal or a BlockDiagIEB's TT, TE, EE, BB blocks, numpy."""
    if hasattr(op, "TT"):
        return [_np(getattr(op, k)) for k in ("TT", "TE", "EE", "BB")]
    return [_np(op.diag)]


@pytest.mark.parametrize("amps", ["ones", "random"])
@pytest.mark.parametrize("pol,banded", BANDED_CASES)
def test_banded_Cl_to_Cov_matches_jax(projs, pol, banded, amps):
    """Any subset of the spectra banded, each by its own theta name (the
    tensor spectrum makes BB nonzero): the operator at theta the JAX
    package's, exactly; at amplitudes 1 (and at theta = {}) the unbanded
    operator."""
    jp, tp = projs
    jCl, tCl = j_camb(), ct.camb()
    edges = np.array([0.0, 1500.0, 4000.0, 1e9])
    spec = lambda Cl, k: Cl["tensor"][k] if k == "BB" else Cl["unlensed_scalar"][k]
    jargs = [(spec(jCl, k), edges, f"A{k}") if k in banded else spec(jCl, k)
             for k in SPECTRA[pol]]
    targs = [(spec(tCl, k), edges, f"A{k}") if k in banded else spec(tCl, k)
             for k in SPECTRA[pol]]
    J, T = jcov.Cl_to_Cov(pol, jp, *jargs), ct.Cl_to_Cov(pol, tp, *targs)
    assert isinstance(T, ct.ParamDependentOp) and T.params == tuple(f"A{k}" for k in banded)
    rng = np.random.default_rng(len(banded))
    theta = {f"A{k}": (np.ones(3) if amps == "ones" else rng.uniform(0.5, 2.0, 3))
             for k in banded}
    for jb, tb in zip(_blocks(J(theta)), _blocks(T(theta))):
        np.testing.assert_array_equal(tb, jb)
    if amps == "ones":
        plain = ct.Cl_to_Cov(pol, tp, *[spec(tCl, k) for k in SPECTRA[pol]])
        for a, b, c in zip(_blocks(T(theta)), _blocks(plain), _blocks(T({}))):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(c, b)


def test_find_bins_and_cov_to_Cl_match_jax(projs):
    """Bin indices, the out-of-range |l| (below the first edge, at or past
    the last) in bin nbins; cov_to_Cl of the fiducial Cphi."""
    jp, tp = projs
    edges = np.array([10.0, 1000.0, 3000.0])
    lmag = np.array([[0.0, 10.0, 999.0], [1000.0, 2999.0, 3000.0]])
    tb = tcov._find_bins(edges, lmag)
    np.testing.assert_array_equal(tb, jcov._find_bins(edges, lmag))
    np.testing.assert_array_equal(tb, [[2, 0, 0], [1, 1, 2]])
    jc = jcov.cov_to_Cl(jcov.Cl_to_Cov("I", jp, j_camb()["total"]["pp"]))
    tc = tcov.cov_to_Cl(ct.Cl_to_Cov("I", tp, ct.camb()["total"]["pp"]))
    assert rel(tc.ell, jc.ell) < 1e-6 and rel(tc.Cl, jc.Cl) < 1e-6


def test_banded_theta_per_chain_on_a_batched_dataset(P16):
    """A vector theta on a batched dataset whose batch equals the bins:
    a (nbins,) value rescales every entry alike (bin amplitudes, never one
    value an entry), a (nchains, nbins) value one entry a row; another
    shape is refused."""
    tds = P16["tds_b"]
    Cphi = tds.Cphi
    a = np.array([1.3, 0.6])
    shared, rows = Cphi(dict(Aphi_b=a)), Cphi(dict(Aphi_b=np.stack([a, a[::-1]])))
    assert shared.diag.batch_shape == () and rows.diag.batch_shape == (NBINS,)
    np.testing.assert_array_equal(_np(rows.diag)[0], _np(shared.diag))
    np.testing.assert_array_equal(_np(rows.diag)[1], _np(Cphi(dict(Aphi_b=a[::-1])).diag))
    d = tds.d
    batched = tds.replace(d=ct.Field(torch.stack([d.arr] * NBINS), d.basis, d.proj))
    phi = ct.repeat_batch(P16["tds"].Cphi.sqrt() @ ct.randn(
        torch.Generator().manual_seed(0), d.proj), NBINS)
    lpb = ct.MvNormal(0, ct.evaluate_at(batched.Cphi, dict(Aphi_b=a))).logpdf(phi)
    lp1 = ct.MvNormal(0, ct.evaluate_at(tds.Cphi, dict(Aphi_b=a))).logpdf(ct.batch_index(phi, 0))
    assert lpb.shape == (NBINS,) and torch.equal(lpb, lp1.expand(NBINS))
    with pytest.raises(ValueError, match="bin amplitudes"):
        Cphi(dict(Aphi_b=np.ones(NBINS + 1)))


# =========================================================================
# the theta-spec helpers and the theta-score
# =========================================================================

def test_theta_spec_helpers():
    """Flat-vector packing of mixed scalar / vector theta dicts, as
    tests/test_muse.py holds the JAX helpers."""
    theta0 = dict(Aphi=1.0, Aphi_b=np.array([1.0, 2.0, 3.0]), r=0.1)
    spec = tmuse._theta_spec(theta0)
    assert spec == jmuse._theta_spec(theta0) == (("Aphi", None), ("Aphi_b", 3), ("r", None))
    assert tmuse._spec_size(spec) == 5
    v = tmuse._spec_pack(theta0, spec)
    np.testing.assert_array_equal(v, jmuse._spec_pack(theta0, spec))
    th = tmuse._spec_unpack(v, spec)
    assert float(th["Aphi"]) == 1.0 and np.allclose(th["Aphi_b"], [1.0, 2.0, 3.0])
    per_chain = tmuse._spec_unpack(torch.as_tensor(np.stack([v, 2 * v])), spec)
    assert per_chain["Aphi"].shape == (2,) and per_chain["Aphi_b"].shape == (2, 3)
    assert tmuse._spec_labels(spec) == jmuse._spec_labels(spec) == [
        "Aphi", "Aphi_b[0]", "Aphi_b[1]", "Aphi_b[2]", "r"]
    with pytest.raises(ValueError):
        tmuse._theta_spec(dict(A=np.ones((2, 2))))


@pytest.fixture(scope="module")
def sims2(P16):
    """NSIMS simulations of the banded dataset at TRUTH drawn by JAX: their
    data, f and phi (the latents the theta-score is taken at)."""
    keys = jax.random.split(jax.random.PRNGKey(11), NSIMS)
    sims = [P16["jds_b"].simulate(k, theta=dict(Aphi_b=TRUTH)) for k in keys]
    stack = lambda name: JField(jnp.stack([s[name].arr for s in sims]), sims[0][name].basis,
                                P16["jproj"])
    return {name: stack(name) for name in ("d", "f", "phi")}


def test_theta_score_per_sim_matches_jax(P16, sims2):
    """The per-sim scores (one backward pass of per-chain theta in the
    port, jacfwd in JAX) and their sum at fixed (f, phi), 2 bins, 2
    sims."""
    spec = (("Aphi_b", NBINS),)
    t = np.array([1.2, 0.9], np.float32)
    jdsd = P16["jds_b"].replace(d=sims2["d"])
    js = np.asarray(jmuse._jit_theta_score_batch(jdsd, sims2["f"], sims2["phi"], jnp.asarray(t),
                                                 spec))
    proj = P16["proj"]
    tdsd = P16["tds_b"].replace(d=_carry(sims2["d"], proj))
    tf, tphi = _carry(sims2["f"], proj), _carry(sims2["phi"], proj)
    ts = tmuse._theta_score_batch(tdsd, tf, tphi, torch.as_tensor(t), spec).numpy()
    assert ts.shape == js.shape == (NSIMS, NBINS)
    assert rel(ts, js) < SCORE_TOL
    summed = tmuse._theta_score(tdsd, tf, tphi, torch.as_tensor(t), spec).numpy()
    assert rel(summed, js.sum(0)) < SCORE_TOL


def test_score_holds_the_other_entries_at_theta(P16, sims2):
    """score(names=...) differentiates the named entries and holds the
    others at theta's values (the JAX package evaluates them at their
    fiducial values; ROADMAP Queue 3): the named part of the whole score
    (Aphi a float on one side, a float32 tensor on the other: 1e-6)."""
    proj = P16["proj"]
    tdsd = P16["tds_b"].replace(Cphi=ct.ParamDependentOp(
        ("Aphi_b", "Aphi"), lambda deps, Aphi_b=None, Aphi=1.0: ct.Scaled(
            Aphi, deps[0](dict(Aphi_b=Aphi_b) if Aphi_b is not None else {})),
        (P16["tds_b"].Cphi,)), d=_carry(sims2["d"], proj))
    tf, tphi = _carry(sims2["f"], proj), _carry(sims2["phi"], proj)
    theta = dict(Aphi_b=np.array([1.2, 0.9]), Aphi=1.4)
    spec = tmuse._theta_spec(theta)
    whole = tmuse._theta_score(tdsd, tf, tphi, tmuse._theta_vec(theta, spec, "cpu"), spec, theta)
    sub = dict(Aphi_b=theta["Aphi_b"])
    part = tmuse._theta_score(tdsd, tf, tphi, tmuse._theta_vec(sub, (("Aphi_b", NBINS),), "cpu"),
                              (("Aphi_b", NBINS),), theta)
    assert rel(part.numpy(), whole[:NBINS].numpy()) < 1e-6


# =========================================================================
# MAP_joint on a batched dataset
# =========================================================================

# two entries, theta the banded Cphi's amplitudes: muse's ensemble MAP, so
# that the JAX run reuses the programs the muse fixture compiles (about 10
# s of compilation on the CPU, which a third entry would spend again)
NB = 2
THETA_B = dict(Aphi_b=np.array([1.3, 0.7]))


@pytest.fixture(scope="module")
def batched(P16):
    """NB datasets: P16's data scaled by 1 + 0.3 N(0, 1) each, in one
    batched dataset of each package (the banded Cphi), and a MAP_joint run
    of each at THETA_B."""
    rng = np.random.default_rng(3)
    jd = P16["jds"].d
    scale = (1 + 0.3 * rng.standard_normal((NB, 1, 1, 1))).astype(np.float32)
    arr = (np.array(jd.arr)[None] * scale).astype(np.array(jd.arr).dtype)
    jdb = P16["jds_b"].replace(d=JField(jnp.asarray(arr), jd.basis, jd.proj))
    tdb = P16["tds_b"].replace(d=_carry(jdb.d, P16["proj"]))
    keys = ("logpdf", "alpha", "gradnorm")
    jr = jm.MAP_joint(jdb, theta=THETA_B, history_keys=keys, **MAP_KW)
    tr = ct.MAP_joint(tdb, theta=THETA_B, history_keys=keys, **MAP_KW)
    return dict(jdb=jdb, tdb=tdb, jr=jr, tr=tr)


def test_batched_MAP_joint_matches_jax(batched):
    """NB entries at THETA_B, 2 steps: f, phi, each entry's alpha (arrays of one value
    an entry, as JAX records them), the logpdf summed over the entries."""
    jr, tr = batched["jr"], batched["tr"]
    for jh, th in zip(jr["history"], tr["history"]):
        assert th["alpha"].shape == (NB,) and th["gradnorm"].shape == (NB,)
        assert np.max(np.abs(th["alpha"] - np.asarray(jh["alpha"]))) < ALPHA_TOL
        assert abs(th["logpdf"] - jh["logpdf"]) < FIELD_TOL * abs(jh["logpdf"])
        assert rel(th["gradnorm"], jh["gradnorm"]) < GRADNORM_TOL
    assert tr["phi"].batch_shape == (NB,)
    assert rel(_np(tr["phi"]), _np(jr["phi"])) < FIELD_TOL
    b = (jr["f"].basis.pol, jr["f"].basis.space)
    assert rel(_np(tr["f"], b), _np(jr["f"])) < FIELD_TOL


def test_batched_MAP_joint_entries_are_their_unbatched_runs(batched):
    """Each entry of the batched run is its own unbatched run: the same
    alphas, phi and f (ENTRY_TOL)."""
    tdb, tr = batched["tdb"], batched["tr"]
    for i in range(NB):
        one = ct.MAP_joint(tdb.replace(d=ct.batch_index(tdb.d, i)), theta=THETA_B,
                           history_keys=("alpha",), **MAP_KW)
        assert np.max(np.abs(np.array([h["alpha"] for h in one["history"]])
                             - np.array([h["alpha"][i] for h in tr["history"]]))) < ALPHA_TOL
        assert rel(_np(tr["phi"])[i], _np(one["phi"])) < ENTRY_TOL
        assert rel(_np(tr["f"])[i], _np(one["f"])) < ENTRY_TOL


def test_batched_retry_fires_when_one_entry_stalls(batched, monkeypatch):
    """The batched retry gate (ROADMAP Queue 3, settled here): when the
    strict trials reject one entry's 'high' direction (forced: entry 0's
    'high' gradient reversed) and accept the other's, the direction is
    recomputed strict for the whole batch and searched again, and the
    accepted retry keeps the run strict: one 'high' gradient, then strict
    ones, every entry moving. The JAX package retries only when every
    entry stalls."""
    real, calls = tm._phi_grad_and_fmix, []

    def spy(*a, **k):
        calls.append(tderiv.matmul_precision())
        f_mix, phi_mix, g = real(*a, **k)
        if calls[-1] == "high":
            g = ct.Field(torch.cat([-g.arr[:1], g.arr[1:]]), g.basis, g.proj)
        return f_mix, phi_mix, g

    monkeypatch.setattr(tm, "_phi_grad_and_fmix", spy)
    r = ct.MAP_joint(batched["tdb"], theta=THETA_B, nsteps=3, conjgrad_kwargs=CG,
                     history_keys=("logpdf", "alpha", "retry"))
    assert calls == ["high", "f32", "f32", "f32"]
    assert [h["retry"] for h in r["history"]] == [True, False, False]
    assert all((h["alpha"] > 0).all() for h in r["history"])
    lps = [h["logpdf"] for h in r["history"]]
    assert lps == sorted(lps)


def test_linesearch_memory_guard_counts_the_batch_entries(P16):
    """`_linesearch_chunk` budgets LINESEARCH_PLANES_PER_TRIAL planes a
    trial and batch entry: a batch of 4 fits a quarter of the trials."""
    phi = ct.randn(torch.Generator().manual_seed(0), P16["proj"])
    per_entry = tm.LINESEARCH_PLANES_PER_TRIAL * N * N * 4
    budget = 8 * per_entry
    assert tm._linesearch_chunk(phi, 16, budget) == 6
    assert tm._linesearch_chunk(ct.repeat_batch(phi, 4), 16, budget) == 2
    assert tm._linesearch_chunk(ct.repeat_batch(phi, 4), 16, 64 * per_entry) == 16


# =========================================================================
# the quadratic estimate
# =========================================================================

def _scaled(jds, tds, scales):
    """jds and tds with their data repeated along a batch axis, entry i
    scaled by scales[i]."""
    jd = np.array(jds.d.arr)
    arr = (jd[None] * np.reshape(scales, (-1, 1, 1, 1))).astype(jd.dtype)
    jb = jds.replace(d=JField(jnp.asarray(arr), jds.d.basis, jds.d.proj))
    return jb, tds.replace(d=_carry(jb.d, tds.d.proj))


@pytest.fixture(scope="module")
def qe_sets(P16):
    """P16's plain dataset and a 16^2 pol-I one (JAX's load_sim), each with
    its data in 3 scaled entries, in both packages."""
    out = j_load_sim(thetapix=THETAPIX, Nside=N, pol="I", T=np.float32, seed=2)
    ds0 = out["ds"].at({})
    fields = {name: getattr(ds0, name).diag for name in DIAG_OPS}
    fields["d"] = ds0.d
    arrays = {name: (np.array(f.arr), f.basis.pol, f.basis.space) for name, f in fields.items()}
    tI = ct.dataset_from_numpy(arrays, dict(Ny=N, Nx=N, thetapix=THETAPIX, T=np.float32),
                               device="cpu")
    scales = np.array([1.0, 0.8, 1.3], np.float32)
    return {"P": _scaled(P16["jds"], P16["tds"], scales), "I": _scaled(ds0, tI, scales)}


QE_CASES = {"TT": ("I", dict(which="TT")), "EE": ("P", dict(which="EE")),
            "EB": ("P", dict()), "unfiltered": ("P", dict(wiener_filtered=False)),
            "lensed": ("P", dict(weights="lensed")), "given_AL": ("P", dict(AL="given")),
            "ds2": ("P", dict(ds2="rolled"))}


@pytest.mark.parametrize("case", list(QE_CASES))
def test_quadratic_estimate_batched_matches_jax(qe_sets, case):
    """The batched estimate (A_L once, from entry 0) against JAX's, and each
    entry against the port's unbatched estimate of it: TT, EE, EB, without
    the Wiener filter, with lensed weights, with a given A_L (used as it
    is), and with a second dataset (the data's entries rolled) as the
    second leg."""
    pol, kw = QE_CASES[case]
    jds, tds = qe_sets[pol]
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("AL") == "given":
        jAL = j_qe(jds.replace(d=JField(jds.d.arr[0], jds.d.basis, jds.d.proj)))["AL"]
        jkw["AL"] = JDiag(JField(0.5 * jAL.diag.arr, jAL.diag.basis, jAL.diag.proj))
        tkw["AL"] = ct.Diag(ct.Field(torch.as_tensor(0.5 * np.array(jAL.diag.arr)),
                                     ct.FOURIER, tds.d.proj))
    if kw.get("ds2") == "rolled":
        jkw["ds2"] = jds.replace(d=JField(jnp.roll(jds.d.arr, 1, axis=0), jds.d.basis,
                                          jds.d.proj))
        tkw["ds2"] = tds.replace(d=ct.Field(torch.roll(tds.d.arr, 1, 0), tds.d.basis,
                                            tds.d.proj))
    j, t = j_qe(jds, **jkw), ct.quadratic_estimate(tds, **tkw)
    assert t["phiqe"].batch_shape == (3,)
    assert rel(_np(t["phiqe"]), _np(j["phiqe"])) < QE_TOL
    assert rel(_np(t["AL"].diag), _np(j["AL"].diag)) < QE_TOL
    for i in range(tds.d.batch_shape[0]):
        one = dict(tkw)
        if "ds2" in one:
            one["ds2"] = one["ds2"].replace(d=ct.batch_index(one["ds2"].d, i))
        single = ct.quadratic_estimate(tds.replace(d=ct.batch_index(tds.d, i)), **one)
        assert rel(_np(t["phiqe"])[i], _np(single["phiqe"])) < ENTRY_TOL


@pytest.mark.parametrize("name", ["Cf", "Cf_tilde", "Cn_hat", "Cphi", "B_hat", "batch"])
def test_quadratic_estimate_refuses_mismatched_datasets(qe_sets, name):
    """ds2 with another operator, or another batch shape, is refused with
    the JAX package's message."""
    jds, tds = qe_sets["P"]

    def other(ds, F):
        if name == "batch":
            return ds.replace(d=F(ds.d.arr[:2], ds.d.basis, ds.d.proj))
        op = getattr(ds, name)
        return ds.replace(**{name: type(op)(F(2 * op.diag.arr, op.diag.basis, op.diag.proj))})

    msgs = []
    for qe, ds, F in ((j_qe, jds, JField), (ct.quadratic_estimate, tds, ct.Field)):
        with pytest.raises(ValueError) as e:
            qe(ds, ds2=other(ds, F))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# =========================================================================
# MUSE and MAP_marg with JAX's draws replayed
# =========================================================================

MUSE_KEY = 3


def _jax_keys(key, nsteps, final):
    """The key of each of JAX's draws: one split a step, one more for the
    final H."""
    keys = []
    for _ in range(nsteps + (1 if final else 0)):
        key, sub = jax.random.split(key)
        keys.append(sub)
    return keys


@pytest.fixture(scope="module")
def muse_runs(P16):
    """One whole muse run of each package (2 sims, 2 bins, 2 steps, MAP 2
    steps, CG 5 fixed, strict, the final H, step_eps 0.1), the port's
    draws JAX's."""
    jds = P16["jds_b"]
    keys = _jax_keys(jax.random.PRNGKey(MUSE_KEY), 2, True)
    proj = P16["proj"]

    def jax_draw(ds, theta, draw, nsims, generator, state):
        th = {n: jnp.asarray(np.asarray(v, np.float32)) for n, v in theta.items()}
        return _carry(jmuse._jit_simulate_batch(jds, jax.random.split(keys[draw], nsims), th),
                      proj)

    # step_eps given: the default step of the final H follows theta in the
    # port (test_final_H_step_follows_theta), theta0's in JAX
    theta0, eps = dict(Aphi_b=np.ones(NBINS)), dict(Aphi_b=0.1)
    jr = jmuse.muse(jds, theta0, nsims=NSIMS, nsteps=2, key=jax.random.PRNGKey(MUSE_KEY),
                    MAP_kwargs=MAP_KW, step_eps=eps)
    real = tmuse._simulate_sims
    tmuse._simulate_sims = jax_draw
    try:
        tr = tmuse.muse(P16["tds_b"], theta0, nsims=NSIMS, nsteps=2, MAP_kwargs=MAP_KW,
                        step_eps=eps)
    finally:
        tmuse._simulate_sims = real
    return jr, tr


@pytest.mark.parametrize("what", ["theta", "H", "J", "Sigma"])
def test_muse_with_jax_draws_matches_jax(muse_runs, what):
    jr, tr = muse_runs
    assert tr["labels"] == jr["labels"] == ["Aphi_b[0]", "Aphi_b[1]"]
    if what == "theta":
        for jh, th in zip(jr["history"], tr["history"]):
            assert rel(th["theta"]["Aphi_b"], jh["theta"]["Aphi_b"]) < MUSE_THETA_TOL
            assert rel(th["sbar"], jh["sbar"]) < MUSE_HJ_TOL
        return
    assert tr[what].shape == (NBINS, NBINS)
    tol = MUSE_SIGMA_TOL if what == "Sigma" else MUSE_HJ_TOL
    assert rel(tr[what], jr[what]) < tol
    if what == "Sigma":
        H = tr["H"]
        np.testing.assert_allclose(tr["Sigma"], np.linalg.solve(H, tr["J"]) @ np.linalg.inv(H).T)


def test_muse_draws_are_seed_matched(P16, monkeypatch):
    """Every simulation of one draw starts from the generator state the
    draw began with: the sims of the H columns see the s-bar sims' random
    numbers, and a new draw new ones."""
    seen = []
    real = tmuse._simulate_sims

    def spy(ds, theta, draw, nsims, generator, state):
        d = real(ds, theta, draw, nsims, generator, state)
        seen.append((draw, float(np.asarray(theta["Aphi_b"])[0]), d.arr.clone()))
        return d

    monkeypatch.setattr(tmuse, "_simulate_sims", spy)
    tmuse.muse(P16["tds_b"], dict(Aphi_b=np.ones(NBINS)), nsims=NSIMS, nsteps=1,
               final_H=False, MAP_kwargs=dict(MAP_KW, nsteps=1))
    assert [s[0] for s in seen] == [0] * (1 + NBINS)
    a, b = seen[0][2], seen[1][2]
    assert seen[1][1] > seen[0][1] and not torch.equal(a, b)
    # at the same theta the same draw gives the same bits
    g = torch.Generator().manual_seed(5)
    state = g.get_state()
    x = real(P16["tds_b"], dict(Aphi_b=np.ones(NBINS)), 0, NSIMS, g, state)
    y = real(P16["tds_b"], dict(Aphi_b=np.ones(NBINS)), 0, NSIMS, g, state)
    assert torch.equal(x.arr, y.arr)


def test_final_H_step_follows_theta(P16, monkeypatch):
    """The default step of the final H is 0.1 max(|theta|, 0.1) at the last
    theta (the JAX package keeps theta0's, and simulates at a negative
    amplitude once theta falls below it; ROADMAP Queue 3): the final draw's
    sims lie at theta and theta +- that step, every amplitude positive."""
    seen = []
    real = tmuse._simulate_sims

    def spy(ds, theta, draw, nsims, generator, state):
        seen.append((draw, np.array(theta["Aphi_b"], dtype=float)))
        return real(ds, theta, draw, nsims, generator, state)

    monkeypatch.setattr(tmuse, "_simulate_sims", spy)
    r = tmuse.muse(P16["tds_b"], dict(Aphi_b=np.array([1.0, 0.12])), nsims=NSIMS, nsteps=1,
                   MAP_kwargs=dict(MAP_KW, nsteps=1))
    last = np.array(r["theta"]["Aphi_b"])
    final = [t for d, t in seen if d == 1]
    eps = 0.1 * np.maximum(np.abs(last), 0.1)
    want = [last] + [last + sgn * eps[j] * np.eye(NBINS)[j] for j in range(NBINS)
                     for sgn in (1, -1)]
    assert len(final) == len(want) and all(np.allclose(a, b) for a, b in zip(final, want))
    assert all((t > 0).all() for t in final) and np.isfinite(r["Sigma"]).all()


@pytest.fixture(scope="module")
def marg_runs(P16):
    """One whole MAP_marg run of each package (2 sims, 2 steps, CG 5 fixed,
    strict), the port's draws JAX's, on the banded dataset at amplitudes 1
    (the unbanded Cphi), where JAX's f-steps are muse's compiled ones."""
    keys = _jax_keys(jax.random.PRNGKey(1), 2, False)
    jds = P16["jds_b"]
    theta = dict(Aphi_b=np.ones(NBINS))

    def jax_draw(ds, theta_, phi_b, generator, draw):
        jphi = JField(jnp.asarray(_np(phi_b)), JBasis(phi_b.basis.pol, phi_b.basis.space),
                      P16["jproj"])
        return _carry(jm._jit_marg_simulate_d(jds.at(theta).replace(G=JId), keys[draw], theta,
                                              jphi, phi_b.batch_shape[0]), P16["proj"])

    kw = dict(nsteps=2, Nsims=NSIMS, conjgrad_kwargs=CG, precision=None, theta=theta)
    jr = jm.MAP_marg(jds, key=jax.random.PRNGKey(1), **kw)
    real = tm._marg_simulate_d
    tm._marg_simulate_d = jax_draw
    try:
        tr = tm.MAP_marg(P16["tds_b"], **kw)
    finally:
        tm._marg_simulate_d = real
    return jr, tr


@pytest.mark.parametrize("what", ["phi", "gradnorm"])
def test_MAP_marg_with_jax_draws_matches_jax(marg_runs, what):
    (jphi, jh), (tphi, th) = marg_runs
    assert [h["step"] for h in th] == [h["step"] for h in jh] == [1, 2]
    if what == "phi":
        assert rel(_np(tphi), _np(jphi)) < MARG_TOL
    else:
        assert rel([h["gradnorm"] for h in th], [h["gradnorm"] for h in jh]) < MARG_TOL


@pytest.mark.parametrize("run", ["muse", "MAP_marg"])
def test_mesh_is_refused_naming_the_queue_item(P16, run):
    """mesh= is taken (ROADMAP Queue 1 item 9 is done): at one rank, a
    world of one process over gloo, the run is the unsharded one, bit for
    bit (several ranks: tests/test_torch_parallel.py)."""
    mesh = ct.make_mesh(device="cpu")
    if run == "muse":
        kw = dict(nsims=2, nsteps=1, final_H=False,
                  MAP_kwargs=dict(nsteps=1, conjgrad_kwargs=dict(tol=0.0, nsteps=3,
                                                                 fixed_iters=True)))
        a, b = (tmuse.muse(P16["tds_b"], dict(Aphi_b=np.ones(NBINS)), mesh=m, **kw)
                for m in (mesh, None))
        assert np.array_equal(a["theta"]["Aphi_b"], b["theta"]["Aphi_b"])
    else:
        kw = dict(nsteps=1, Nsims=2, conjgrad_kwargs=dict(tol=0.0, nsteps=3, fixed_iters=True))
        a, b = (tm.MAP_marg(P16["tds"], mesh=m, **kw)[0] for m in (mesh, None))
        assert torch.equal(a.arr, b.arr)


# =========================================================================
# MuseProblem
# =========================================================================

@pytest.fixture(scope="module")
def problems(P16, sims2):
    kw = dict(MAP_joint_kwargs=MAP_KW)
    jp = jmuse.MuseProblem(P16["jds_b"], params=("Aphi_b",), **kw)
    tp = tmuse.MuseProblem(P16["tds_b"], params=("Aphi_b",), **kw)
    proj = P16["proj"]
    jz = dict(f=sims2["f"], phi=sims2["phi"])
    tz = dict(f=_carry(sims2["f"], proj), phi=_carry(sims2["phi"], proj))
    return jp, tp, sims2["d"], _carry(sims2["d"], proj), jz, tz


def test_MuseProblem_logLike_matches_jax(problems):
    jp, tp, jd, td, jz, tz = problems
    theta = dict(Aphi_b=np.array([1.2, 0.9]))
    j, t = float(jax.jit(jp.logLike)(jd, jz, theta)), float(tp.logLike(td, tz, theta))
    assert abs(t - j) < FIELD_TOL * abs(j)


def test_MuseProblem_grad_theta_logLike_matches_jax(problems):
    jp, tp, jd, td, jz, tz = problems
    theta = dict(Aphi_b=np.array([1.2, 0.9]))
    j = np.asarray(jp.grad_theta_logLike(jd, jz, theta))
    t = tp.grad_theta_logLike(td, tz, theta).numpy()
    assert t.shape == (NBINS,) and rel(t, j) < SCORE_TOL


def test_MuseProblem_sample_x_z(problems):
    """A simulation at theta from a generator: the data and latents of one
    dataset, the same from the same seed."""
    _, tp, _, td, _, _ = problems
    draw = lambda: tp.sample_x_z(torch.Generator().manual_seed(4), dict(Aphi_b=np.ones(NBINS)))
    a, b = draw(), draw()
    assert a["x"].batch_shape == () and set(a["z"]) == {"f", "phi"}
    assert torch.equal(a["x"].arr, b["x"].arr) and torch.isfinite(a["x"].arr).all()
    assert np.isfinite(float(tp.logLike(a["x"], a["z"], dict(Aphi_b=np.ones(NBINS)))))


def test_MuseProblem_zhat_at_theta_is_MAP_joint(problems):
    """zhat at theta is MAP_joint's (f, phi) with the problem's kwargs, on
    one sim's data, and its history."""
    _, tp, _, td, _, tz = problems
    d0 = ct.batch_index(td, 0)
    theta = dict(Aphi_b=np.array([1.2, 0.9]))
    z, hist = tp.zhat_at_theta(d0, theta)
    res = ct.MAP_joint(tp.ds.replace(d=d0), theta=theta, **MAP_KW)
    assert len(hist) == MAP_KW["nsteps"]
    assert torch.equal(z["phi"].arr, res["phi"].arr) and torch.equal(z["f"].arr, res["f"].arr)
