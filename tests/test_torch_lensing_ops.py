"""The port's other lensing operators (PowerLens, antilensing, Taylens,
BilinearLens), `lense`, `get_max_lensing_step`, the forward-model sites,
the `Cls` helpers, the sum modes and the solvers (`rk4_integrate`, `gmres`,
CG's x/r histories, `conjugate_gradient_with_history`) against the JAX
package on the same inputs.

Inputs are made once by the JAX package on the CPU (tests/test_lensing_ops.py's
64^2 pol-P setup: phi from Cphi, f and g from Cf) or with numpy, and handed
to both packages as numpy arrays.

Tolerances, relative max-abs unless said, each the measured gap times a
margin:
- the operators' applies and adjoints 1e-5 (measured 7.5e-7 to 4.5e-6:
  the same FFT derivatives, gathers and scatter-adds summed in other
  orders); `lense` 1e-5 (7.0e-7).
- BilinearLens's GMRES solve and the phi-gradients through its weights
  1e-4 (3.8e-6 to 6.7e-6; 1.1e-6 to 6.2e-6).
- get_max_lensing_step 1e-5 (7.0e-6: the port forms the Hessians in
  float64; in float32 each package's FFT rounding at high l moves the
  root by 0.7e-5 to 3e-5, JAX's 7.0e-6 from the float64 root).
- the forward-model logpdf 1e-5 (sums of ~1e4 in float32); the Cls
  helpers 1e-9 (the same float64 numpy); the sum modes against numpy's
  float64 sum (kahan and float64 to 2 float32 ulps of the sum, where the
  plain float32 sum of the ill-conditioned input errs by many more).
- the solvers 1e-5 (rk4, CG histories) and 1e-4 (GMRES: a float32
  Gram-Schmidt and pseudo-inverse in each package).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cmblensing_tpu.core import field as JF
from cmblensing_tpu.core.basis import MAP as JMAP
from cmblensing_tpu.core.cov import Cl_to_Cov as j_Cl_to_Cov
from cmblensing_tpu.core.ops import Diag as JDiag, simulate_op as j_simulate_op
from cmblensing_tpu.core.proj import ProjLambert as JProj
from cmblensing_tpu.models import fwdmodel as jfwd
from cmblensing_tpu.models.bilinearlens import BilinearLens as JBilinear
from cmblensing_tpu.models.lenseflow import (LenseFlow as JLenseFlow,
                                             get_max_lensing_step as j_max_step)
from cmblensing_tpu.models.powerlens import PowerLens as JPower, antilensing as j_antilensing
from cmblensing_tpu.models.taylens import Taylens as JTaylens
from cmblensing_tpu.ops import solvers as jsolvers
from cmblensing_tpu.utils import cls as jcls
from cmblensing_tpu.utils import summation as jsum
from cmblensing_tpu.utils.cls import camb as j_camb

import cmblensing_tpu_torch as ct
from cmblensing_tpu_torch.models import fwdmodel as tfwd
from cmblensing_tpu_torch.ops import solvers as tsolvers
from cmblensing_tpu_torch.utils import summation as tsum

N = 64
APPLY_TOL, SOLVE_TOL, GRAD_TOL, STEP_TOL = 1e-5, 1e-4, 1e-4, 1e-5
LP_TOL, CLS_TOL, RK4_TOL, CG_TOL, GMRES_TOL = 1e-5, 1e-9, 1e-5, 1e-5, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread for the module (its 64^2 tensors are too small to
    share among threads, which only contend with a parallel run's other
    workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _np(f, basis):
    """A Field of either package in `basis` (the JAX package's Basis) as a
    numpy array."""
    if isinstance(f, ct.Field):
        return f.to(ct.Basis(basis.pol, basis.space)).arr.detach().numpy()
    return np.asarray(f.to(basis).arr)


@pytest.fixture(scope="module")
def lens():
    """tests/test_lensing_ops.py's setup in the JAX package, carried across."""
    jproj = JProj(N, N, thetapix=3, T=np.float32)
    Cl = j_camb()
    Cphi = j_Cl_to_Cov("I", jproj, Cl["total"]["pp"])
    Cf = j_Cl_to_Cov("P", jproj, Cl["unlensed_scalar"]["EE"], Cl["unlensed_scalar"]["BB"])
    ks = jax.random.split(jax.random.PRNGKey(0), 4)
    j = dict(phi=j_simulate_op(ks[0], Cphi).to(JMAP), f=j_simulate_op(ks[1], Cf).to_lense(),
             g=j_simulate_op(ks[2], Cf).to_lense(), eta=j_simulate_op(ks[3], Cphi).to(JMAP))
    proj = ct.ProjLambert(N, N, thetapix=3, T=np.float32, device="cpu")
    t = {k: ct.Field(torch.as_tensor(np.array(v.arr)), ct.Basis(v.basis.pol, v.basis.space), proj)
         for k, v in j.items()}
    return dict(j=j, t=t, jproj=jproj, proj=proj)


OPS = {"PowerLens": (lambda p: JPower(p, 4), lambda p: ct.PowerLens(p, 4)),
       "antilensing": (lambda p: j_antilensing(JPower(p, 3)),
                       lambda p: ct.antilensing(ct.PowerLens(p, 3))),
       "Taylens": (lambda p: JTaylens(p, 4), lambda p: ct.Taylens(p, 4)),
       "BilinearLens": (JBilinear, ct.BilinearLens)}


@pytest.mark.parametrize("name", list(OPS))
def test_apply_matches_jax(lens, name):
    jop, top = OPS[name]
    jo = jop(lens["j"]["phi"]) @ lens["j"]["f"]
    to = top(lens["t"]["phi"]) @ lens["t"]["f"]
    assert rel(_np(to, jo.basis), _np(jo, jo.basis)) < APPLY_TOL


@pytest.mark.parametrize("name", ["PowerLens", "antilensing", "BilinearLens"])
def test_adjoint_matches_jax(lens, name):
    jop, top = OPS[name]
    jo = jop(lens["j"]["phi"]).H @ lens["j"]["g"]
    to = top(lens["t"]["phi"]).H @ lens["t"]["g"]
    assert rel(_np(to, jo.basis), _np(jo, jo.basis)) < APPLY_TOL


@pytest.mark.parametrize("adjoint", [False, True])
def test_bilinear_solve_matches_jax(lens, adjoint):
    jL, tL = JBilinear(lens["j"]["phi"]), ct.BilinearLens(lens["t"]["phi"])
    if adjoint:
        jL, tL = jL.H, tL.H
    jo, to = jL.solve(lens["j"]["f"]), tL.solve(lens["t"]["f"])
    assert rel(_np(to, jo.basis), _np(jo, jo.basis)) < SOLVE_TOL


@pytest.mark.parametrize("how", ["apply", "adjoint", "solve"])
def test_bilinear_phi_gradient_matches_jax(lens, how):
    """d/dphi <g, L(phi) f> through the interpolation weights (and the
    GMRES iterations for the solve), autograd in both packages."""
    use = {"apply": lambda L, f: L @ f, "adjoint": lambda L, f: L.H @ f,
           "solve": lambda L, f: L.solve(f)}[how]
    j, t = lens["j"], lens["t"]
    jg = JF.fgrad(lambda p: jnp.sum(JF.dot(use(JBilinear(p), j["f"]), j["g"])))(j["phi"])
    tg = ct.fgrad(lambda p: torch.sum(ct.dot(use(ct.BilinearLens(p), t["f"]), t["g"])))(t["phi"])
    assert rel(tg.arr.numpy(), np.asarray(jg.arr)) < GRAD_TOL


@pytest.mark.parametrize("name", ["BilinearLens", "Taylens", "PowerLens"])
def test_batched_phi_matches_jax_and_each_entry(lens, name):
    jop, top = OPS[name]
    j, t = lens["j"], lens["t"]
    jphi = JF.Field(jnp.stack([j["phi"].arr, 0.5 * j["phi"].arr]), j["phi"].basis, lens["jproj"])
    tphi = ct.Field(torch.stack([t["phi"].arr, 0.5 * t["phi"].arr]), t["phi"].basis, lens["proj"])
    jo, to = jop(jphi) @ j["f"], top(tphi) @ t["f"]
    assert to.arr.shape[0] == 2
    assert rel(_np(to, jo.basis), _np(jo, jo.basis)) < APPLY_TOL
    for i, s in enumerate((1.0, 0.5)):
        one = top(ct.Field(s * t["phi"].arr, t["phi"].basis, lens["proj"])) @ t["f"]
        assert rel(to.arr[i].numpy(), one.arr.numpy()) < APPLY_TOL


@pytest.mark.parametrize("name,bound", [("PowerLens", 0.05), ("Taylens", 0.05),
                                        ("BilinearLens", 0.3)])
def test_operators_agree_with_lenseflow(lens, name, bound):
    """The bounds tests/test_lensing_ops.py holds the JAX operators to, on
    the port's own operators (measured 0.021, 0.005, 0.050 at 512^2)."""
    t = lens["t"]
    Llf = ct.LenseFlow(t["phi"], 7) @ t["f"]
    out = OPS[name][1](t["phi"]) @ t["f"]
    assert float(ct.norm(out - Llf) / ct.norm(Llf)) < bound


def test_bilinear_identities(lens):
    """The adjoint is the exact transpose (the scatter-add of the gather's
    taps), and GMRES inverts the operator to the JAX test's 0.15."""
    t = lens["t"]
    L = ct.BilinearLens(t["phi"])
    lhs, rhs = float(ct.dot(t["g"], L @ t["f"])), float(ct.dot(L.H @ t["g"], t["f"]))
    assert abs(lhs - rhs) < 1e-4 * abs(lhs)
    assert float(ct.norm(L.solve(L @ t["f"]) - t["f"]) / ct.norm(t["f"])) < 0.15
    P = ct.PowerLens(t["phi"], 3)
    lhs, rhs = float(ct.dot(t["g"], P @ t["f"])), float(ct.dot(P.H @ t["g"], t["f"]))
    assert abs(lhs - rhs) < 1e-4 * abs(lhs)
    r = ct.norm(ct.antilensing(P) @ (P @ t["f"]) - t["f"]) / ct.norm(t["f"])
    assert float(r) < 0.1


def test_lense_matches_jax(lens):
    j, t = lens["j"], lens["t"]
    jo = JLenseFlow(j["phi"], 7) @ j["f"]
    to = ct.lense(t["phi"], t["f"])
    assert rel(_np(to, jo.basis), _np(jo, jo.basis)) < APPLY_TOL


@pytest.mark.parametrize("eta", ["phi", "eta"])
def test_get_max_lensing_step_matches_jax(lens, eta):
    j, t = lens["j"], lens["t"]
    want = float(j_max_step(j["phi"], j[eta]))
    got = ct.get_max_lensing_step(t["phi"], t[eta])
    assert got.dtype == torch.float32 and abs(float(got) - want) < STEP_TOL * abs(want)


def test_rotator_is_projection_metadata():
    a = ct.ProjLambert(8, 8, thetapix=3, device="cpu")
    b = ct.ProjLambert(8, 8, thetapix=3, device="cpu", rotator=(0, 45, 0))
    assert a.rotator == (0.0, 90.0, 0.0) and b.rotator == (0.0, 45.0, 0.0) and a is not b
    assert ct.ProjLambert(8, 8, thetapix=3, device="cpu", rotator=(0, 45, 0)) is b
    assert a.lx.tolist() == b.lx.tolist()


# =========================================================================
# forward models
# =========================================================================

def _two_site_models(jproj, proj):
    jC = JDiag(JF.Field(jnp.full((1, 8, 8), 4.0), JMAP, jproj))
    tC = ct.Diag(ct.Field(torch.full((1, 8, 8), 4.0), ct.MAP, proj))

    def jmodel(sample=None):
        x = sample("x", jfwd_MvNormal(0, jC))
        return dict(x=x, y=sample("y", jfwd_MvNormal(x, jC)))

    def tmodel(sample=None):
        x = sample("x", ct.MvNormal(0, tC))
        return dict(x=x, y=sample("y", ct.MvNormal(x, tC)))

    return jmodel, tmodel


from cmblensing_tpu.models.distributions import MvNormal as jfwd_MvNormal  # noqa: E402


def test_fwdmodel_logpdf_matches_jax():
    jproj = JProj(8, 8, thetapix=3, T=np.float32)
    proj = ct.ProjLambert(8, 8, thetapix=3, T=np.float32, device="cpu")
    jmodel, tmodel = _two_site_models(jproj, proj)
    sim = jfwd.simulate(jmodel)(jax.random.PRNGKey(0))
    tv = {k: ct.Field(torch.as_tensor(np.array(v.arr)), ct.MAP, proj) for k, v in sim.items()}
    want = float(jfwd.logpdf(jmodel)(x=sim["x"], y=sim["y"]))
    assert abs(float(tfwd.logpdf(tmodel)(**tv)) - want) < LP_TOL * abs(want)
    want = float(jfwd.loglikelihood(jmodel, latents=("x",))(x=sim["x"], y=sim["y"]))
    got = float(tfwd.loglikelihood(tmodel, latents=("x",))(**tv))
    assert abs(got - want) < LP_TOL * abs(want)
    with pytest.raises(ValueError, match="needs a value"):
        tfwd.logpdf(tmodel)(x=tv["x"])


def test_fwdmodel_conditioning_keeps_the_other_sites_draws():
    """Each site draws from its own generator, seeded from one draw of the
    caller's and the site's name: conditioning one site leaves the other's
    draw as it was, two sites never share a stream, and an unknown site
    raises (as tests/test_lensing_ops.py holds the JAX package)."""
    proj = ct.ProjLambert(8, 8, thetapix=3, T=np.float32, device="cpu")
    _, tmodel = _two_site_models(JProj(8, 8, thetapix=3, T=np.float32), proj)
    sim = tfwd.simulate(tmodel)
    gen = lambda: torch.Generator().manual_seed(3)
    full, cond = sim(gen()), sim(gen(), x=ct.zeros(proj))
    noise = (full["y"] - full["x"]).arr
    assert torch.allclose(noise, cond["y"].arr, rtol=0, atol=1e-6)
    assert not torch.allclose(full["x"].arr, noise, rtol=0, atol=1e-3)
    with pytest.raises(ValueError, match="unknown site"):
        sim(gen(), typo=1.0)


# =========================================================================
# Cls helpers, sum modes
# =========================================================================

def _cls_pair(ell, cl):
    return jcls.Cls(ell, cl), ct.Cls(ell, cl)


def test_Cls_arithmetic_and_FuncCls_match_jax():
    rng = np.random.default_rng(0)
    ja, ta = _cls_pair(np.arange(2, 200), rng.uniform(1, 2, 198))
    jb, tb = _cls_pair(np.arange(2, 300, 2.5), rng.uniform(1, 2, 120))
    pairs = [(ja + jb, ta + tb), (ja - 2.0, ta - 2.0), (3.0 * ja, 3.0 * ta), (ja / jb, ta / tb),
             (ja ** 2, ta ** 2), (jcls.ell2 * ja, ct.ell2 * ta), (jcls.ell4 * ja, ct.ell4 * ta),
             (jcls.toDl * ja, ct.toDl * ta), (jcls.toCl * ja, ct.toCl * ta),
             (jcls.ell2 / ja, ct.ell2 / ta), (ja * (lambda l: l), ta * (lambda l: l)),
             (jcls.shift_l(3, ja), ct.shift_l(3, ta)),
             (jcls.shift_l(1.5, ja, factor=True), ct.shift_l(1.5, ta, factor=True))]
    for j, t in pairs:
        assert j.concrete == t.concrete
        np.testing.assert_array_equal(t.ell, j.ell)
        assert rel(t.Cl, j.Cl) < CLS_TOL
    np.testing.assert_allclose(ta[2:50], ja[2:50], rtol=CLS_TOL)
    assert (jcls.FuncCls(np.sqrt) * jcls.ell2)(4.0) == (ct.FuncCls(np.sqrt) * ct.ell2)(4.0)


@pytest.mark.parametrize("kw", [dict(), dict(xscale="log", yscale="log", smoothing=0.3),
                                dict(newells=np.arange(5, 150, 3))])
def test_smooth_matches_jax(kw):
    rng = np.random.default_rng(1)
    ell = np.arange(2, 150)
    cl = ell ** -2.0 * np.exp(rng.normal(0, 0.3, ell.size))
    ja, ta = _cls_pair(ell, cl)
    j, t = jcls.smooth(ja, **kw), ct.smooth(ta, **kw)
    np.testing.assert_array_equal(t.ell, j.ell)
    assert rel(t.Cl, j.Cl) < CLS_TOL


def test_get_l4Cl_and_get_rho_l_match_jax(lens):
    j, t = lens["j"], lens["t"]
    ja, jb = j["f"]["E"], j["g"]["E"]
    ta, tb = t["f"]["E"], t["g"]["E"]
    for jc, tc in ((jcls.get_l4Cl(ja), ct.get_l4Cl(ta)),
                   (jcls.get_l4Cl(ja, jb, dl=100), ct.get_l4Cl(ta, tb, dl=100)),
                   (jcls.get_rho_l(ja, jb), ct.get_rho_l(ta, tb))):
        np.testing.assert_array_equal(tc.ell, jc.ell)
        ok = np.isfinite(jc.Cl)
        np.testing.assert_array_equal(np.isfinite(tc.Cl), ok)
        assert rel(tc.Cl[ok], jc.Cl[ok]) < 1e-5


def test_load_camb_cls_matches_jax(tmp_path):
    """CAMB's four output tables (one header line, D_l columns), written
    with numpy, read by both packages, with and without lmax."""
    rng = np.random.default_rng(2)
    ell = np.arange(2, 400)
    cols = {"scalCls.dat": 4, "tensCls.dat": 5, "lensedCls.dat": 5, "lenspotentialCls.dat": 8}
    for name, n in cols.items():
        table = np.column_stack([ell] + [rng.uniform(1, 10, ell.size) * (ell / 100.0) ** -0.5
                                         for _ in range(n - 1)])
        np.savetxt(tmp_path / f"test_{name}", table, header="L cols", comments="# ")
    for lmax in (None, 600):
        j = jcls.load_camb_cls(str(tmp_path / "test_"), lmax=lmax)
        t = ct.load_camb_cls(str(tmp_path / "test_"), lmax=lmax)
        for comp in ("unlensed_scalar", "lensed_scalar", "tensor", "unlensed_total", "total"):
            for spec in ("TT", "EE", "BB", "TE", "pp", "phiphi"):
                jc, tc = j[comp][spec], t[comp][spec]
                np.testing.assert_array_equal(tc.ell, jc.ell)
                np.testing.assert_allclose(tc.Cl, jc.Cl, rtol=CLS_TOL, atol=0)
                assert tc.concrete == jc.concrete


@pytest.mark.parametrize("mode", ["fast", "float64", "kahan"])
def test_sum_modes_against_the_float64_sum(mode):
    """A batch of ill-conditioned (2, 64, 64) arrays (values of 1e-3 to 1e3
    that cancel) summed in each mode, against numpy's float64 sum: float64
    rounds it once (half an ulp of the result); kahan errs by at most a
    fifth of eps sum|x| (measured 0.6-8.3 ulps of the result, 1-3 % of
    eps sum|x|) and is the JAX package's kahan bit for bit (the same
    recurrence in the same order); fast within eps sum|x| (a tree sum's
    bound; measured 0.4-10.3 ulps)."""
    rng = np.random.default_rng(3)
    z = rng.normal(0, 1, (3, 2, 64, 64)) * 10.0 ** rng.integers(-3, 4, (3, 2, 64, 64))
    z = z.astype(np.float32)
    exact = z.astype(np.float64).sum(axis=(-1, -2, -3))
    scale = np.finfo(np.float32).eps * np.abs(z).astype(np.float64).sum(axis=(-1, -2, -3))
    prev = tsum.get_sum_mode()
    try:
        tsum.set_sum_mode(mode)
        got = tsum.asum(torch.as_tensor(z)).numpy()
        assert ct.get_sum_mode() == mode
    finally:
        tsum.set_sum_mode(prev)
    assert got.dtype == np.float32
    err = np.abs(got.astype(np.float64) - exact)
    if mode == "float64":
        assert np.all(err <= 0.5 * np.spacing(np.abs(exact).astype(np.float32)))
    elif mode == "kahan":
        assert np.all(err <= 0.2 * scale)
        np.testing.assert_array_equal(got, np.asarray(jsum.asum(jnp.asarray(z), mode="kahan")))
    else:
        assert np.all(err <= scale)
    with pytest.raises(ValueError):
        tsum.set_sum_mode("pairwise")


# =========================================================================
# solvers
# =========================================================================

def test_rk4_integrate_matches_jax():
    """A linear 2-component system with a time-dependent term, over a
    tuple state (a tensor and a pair), 7 steps."""
    A = np.array([[0.0, 1.0], [-2.0, -0.3]], np.float32)
    y0 = np.array([1.0, 0.5], np.float32)

    def jF(t, y):
        return (jnp.asarray(A) @ y[0] + jnp.sin(t), (y[1][0] * t, -y[1][1]))

    def tF(t, y):
        return (torch.as_tensor(A) @ y[0] + float(np.sin(t)), (y[1][0] * t, -y[1][1]))

    j = jsolvers.rk4_integrate(jF, (jnp.asarray(y0), (jnp.ones(3), jnp.ones(2))), 0.0, 1.5, 7)
    t = tsolvers.rk4_integrate(tF, (torch.as_tensor(y0), (torch.ones(3), torch.ones(2))), 0.0,
                               1.5, 7)
    for jl, tl in ((j[0], t[0]), (j[1][0], t[1][0]), (j[1][1], t[1][1])):
        assert rel(tl.numpy(), np.asarray(jl)) < RK4_TOL


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.normal(size=(n, n)))[0]
    return (Q * np.linspace(1, 30, n)) @ Q.T, rng.normal(size=n)


@pytest.mark.parametrize("method,maxiter", [("arnoldi", 5), ("arnoldi", 12), ("power", 5)])
def test_gmres_matches_jax(method, maxiter):
    """A nonsymmetric 40 x 40 system, left-preconditioned by a rough
    inverse, in both packages; and the operator a tuple of tensors."""
    rng = np.random.default_rng(4)
    A = (np.eye(40) + 0.3 * rng.normal(size=(40, 40)) / np.sqrt(40)).astype(np.float32)
    P = np.linalg.inv(A + 0.1 * rng.normal(size=(40, 40)) / np.sqrt(40)).astype(np.float32)
    b = rng.normal(size=40).astype(np.float32)
    jx = jsolvers.gmres(lambda x: (jnp.asarray(A[:25]) @ jnp.concatenate(x),
                                   jnp.asarray(A[25:]) @ jnp.concatenate(x)),
                        (jnp.asarray(b[:25]), jnp.asarray(b[25:])), maxiter,
                        Pl=lambda x: (jnp.asarray(P[:25]) @ jnp.concatenate(x),
                                      jnp.asarray(P[25:]) @ jnp.concatenate(x)), method=method)
    A_, P_ = torch.as_tensor(A), torch.as_tensor(P)
    tx = tsolvers.gmres(lambda x: (A_[:25] @ torch.cat(x), A_[25:] @ torch.cat(x)),
                        (torch.as_tensor(b[:25]), torch.as_tensor(b[25:])), maxiter,
                        Pl=lambda x: (P_[:25] @ torch.cat(x), P_[25:] @ torch.cat(x)),
                        method=method)
    got, want = torch.cat(tx).numpy(), np.concatenate([np.asarray(x) for x in jx])
    assert rel(got, want) < GMRES_TOL
    if maxiter == 12:
        assert np.linalg.norm(A @ got - b) < 1e-4 * np.linalg.norm(b)


@pytest.mark.parametrize("keys", [True, ("res", "x"), ("x", "r")])
def test_conjugate_gradient_histories_match_jax(keys):
    """The x and r histories (stacked iterates, NaN past the last) on a
    Fourier-diagonal 16^2 system with two right-hand sides (in Fourier
    space, the basis the JAX package's in-graph buffers keep), tol 0 and 8
    iterations, against the JAX package's."""
    jproj = JProj(16, 16, thetapix=3, T=np.float32)
    proj = ct.ProjLambert(16, 16, thetapix=3, T=np.float32, device="cpu")
    rng = np.random.default_rng(5)
    diag = (1.0 + rng.uniform(0, 20, (1, 16, 9))).astype(np.float32)
    pre = (diag * rng.uniform(0.5, 1.5, diag.shape)).astype(np.float32)
    b = np.fft.rfft2(rng.normal(size=(2, 1, 16, 16))).astype(np.complex64)
    jF = lambda a: JF.Field(jnp.asarray(a), JF.Basis("I", "fourier") if a.shape[-1] == 9
                            else JMAP, jproj)
    tF = lambda a: ct.Field(torch.as_tensor(a), ct.Basis("I", "fourier") if a.shape[-1] == 9
                            else ct.MAP, proj)
    jx, ji = jsolvers.conjugate_gradient(JDiag(jF(pre)), JDiag(jF(diag)), jF(b), nsteps=8,
                                         tol=0.0, record_history=keys)
    tx, ti = ct.conjugate_gradient(ct.Diag(tF(pre)), ct.Diag(tF(diag)), tF(b), nsteps=8,
                                   tol=0.0, record_history=keys)
    names = ["res"] if keys is True else list(keys)
    assert sorted(k for k in ti if k.endswith("_history")) == sorted(f"{k}_history" for k in names)
    for k in names:
        jh, th = ji[f"{k}_history"], ti[f"{k}_history"]
        if k == "res":
            assert rel(th.numpy(), np.asarray(jh)) < CG_TOL
            continue
        assert th.arr.shape == (9,) + tuple(tx.arr.shape)
        assert rel(_np(th, jh.basis), _np(jh, jh.basis)) < CG_TOL
    assert rel(_np(tx, jx.basis), _np(jx, jx.basis)) < CG_TOL
    with pytest.raises(ValueError, match="record_history"):
        ct.conjugate_gradient(ct.Diag(tF(pre)), ct.Diag(tF(diag)), tF(b), nsteps=2,
                              record_history=("p",))


def test_conjugate_gradient_with_history_matches_jax():
    A, b = _spd(30, 6)
    A, b = A.astype(np.float32), b.astype(np.float32)
    keys = ("i", "res", "x", "r", "t")
    jx, jh = jsolvers.conjugate_gradient_with_history(
        lambda v: v, lambda v: jnp.asarray(A) @ v, jnp.asarray(b), nsteps=40, tol=1e-8,
        history_keys=keys)
    tx, th = ct.conjugate_gradient_with_history(
        lambda v: v, lambda v: torch.as_tensor(A) @ v, torch.as_tensor(b), nsteps=40, tol=1e-8,
        history_keys=keys)
    assert [h["i"] for h in th] == [h["i"] for h in jh]
    assert all(set(h) == set(keys) for h in th)
    n = min(len(th), 12)   # the early iterations, before float32 round-off takes over
    for k in ("res", "x", "r"):
        for a, c in zip(th[:n], jh[:n]):
            want = np.asarray(c[k])
            assert np.max(np.abs(a[k].numpy() - want)) <= 1e-4 * np.max(np.abs(want))
    assert np.linalg.norm(A @ tx.numpy() - b) < 1e-3 * np.linalg.norm(b)
