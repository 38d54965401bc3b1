"""The port's main path against the JAX package: the mixed-posterior
lnP and its phi°-gradient on a JAX `load_sim` dataset carried across as
numpy arrays (`dataset_from_numpy`), with the same f°, phi° and d.

Tolerances, relative max-abs:
- lnP 1e-6: a sum of ~1e5-sized float32 terms (measured 9e-8).
- gradient 3e-4: on these inputs both float32 implementations lie ~9e-5
  from a float64 evaluation of the same posterior (measured: JAX 8.4e-5,
  the port 9.0e-5), while the port's two backends agree to 6e-7.
- f-gradient 3e-4: it holds the residual d - M B L f, which cancels;
  measured against float64, JAX 3.5e-5 and the port 8.3e-5.
- everything else 1e-5: f32 round-off of a handful of FFTs.
"""
import numpy as np
import pytest
import torch

from cmblensing_tpu.core.field import fvalue_and_grad as j_fvalue_and_grad
from cmblensing_tpu.core.ops import Diag as JDiag
from cmblensing_tpu.models.dataset import load_sim as j_load_sim, mix as j_mix, Mixed as JMixed
from cmblensing_tpu.models.quadratic_estimate import quadratic_estimate as j_qe

import cmblensing_tpu_torch as ct
from cmblensing_tpu_torch.models.dataset import DIAG_OPS


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _carry(jfield, proj):
    return ct.Field(torch.as_tensor(np.array(jfield.arr)),
                    ct.Basis(jfield.basis.pol, jfield.basis.space), proj)


def _problem(pol, N):
    """JAX load_sim + mix + lnP and grad, and the port's DataSet built
    from the JAX arrays."""
    out = j_load_sim(thetapix=3, Nside=N, pol=pol, T=np.float32, seed=0)
    ds = out["ds"]
    f = out["f"].to(out["f"].basis.with_space("map"))
    phi = out["phi"].to(out["phi"].basis.with_space("map"))
    m = j_mix(ds, f=f, phi=phi)
    fm, pm = m["f_mix"].to(f.basis), m["phi_mix"].to(phi.basis)
    v, g = j_fvalue_and_grad(lambda p: JMixed(ds).logpdf(f_mix=fm, phi_mix=p))(pm)
    ds0 = ds.at({})
    arrays = {"d": (np.array(ds.d.arr), ds.d.basis.pol, ds.d.basis.space)}
    for name in DIAG_OPS:
        op = getattr(ds0, name)
        assert isinstance(op, JDiag), name
        arrays[name] = (np.array(op.diag.arr), op.diag.basis.pol, op.diag.basis.space)
    tds = ct.dataset_from_numpy(arrays, dict(Ny=N, Nx=N, thetapix=3, T=np.float32), device="cpu")
    proj = tds.d.proj
    return dict(jds=ds, tds=tds, f=f, phi=phi, fm=fm, pm=pm, lnP=float(v), grad=np.array(g.arr),
                tf=_carry(f, proj), tphi=_carry(phi, proj), tfm=_carry(fm, proj),
                tpm=_carry(pm, proj))


@pytest.fixture(scope="module")
def P64():
    return _problem("P", 64)


@pytest.fixture(scope="module")
def I32():
    return _problem("I", 32)


@pytest.mark.parametrize("backend", ["kernel", "plain"])
@pytest.mark.parametrize("which", ["P64", "I32"])
def test_mixed_lnP_and_phi_gradient_match_jax(which, backend, request):
    pb = request.getfixturevalue(which)
    with ct.lenseflow_backend_ctx(backend):
        v, g = ct.fvalue_and_grad(
            lambda p: ct.Mixed(pb["tds"]).logpdf(f_mix=pb["tfm"], phi_mix=p))(pb["tpm"])
    assert g.basis.space == "map" and tuple(g.arr.shape) == pb["grad"].shape
    assert abs(float(v) - pb["lnP"]) < 1e-6 * abs(pb["lnP"])
    assert rel(g.arr.numpy(), pb["grad"]) < 3e-4


def test_mix_matches_jax(P64):
    m = ct.mix(P64["tds"], f=P64["tf"], phi=P64["tphi"])
    assert rel(m["f_mix"].to(P64["tfm"].basis).arr.numpy(), np.array(P64["fm"].arr)) < 1e-5
    assert rel(m["phi_mix"].to(P64["tpm"].basis).arr.numpy(), np.array(P64["pm"].arr)) < 1e-5


@pytest.mark.parametrize("backend", ["kernel", "plain"])
def test_gradientf_matches_jax(P64, backend):
    """The f-gradient runs the adjoint flow (L.H)."""
    ref = P64["jds"].gradientf_logpdf(P64["f"], phi=P64["phi"])
    with ct.lenseflow_backend_ctx(backend):
        g = P64["tds"].gradientf_logpdf(P64["tf"], phi=P64["tphi"])
    assert rel(g.to(ct.Basis(ref.basis.pol, ref.basis.space)).arr.numpy(), np.array(ref.arr)) < 3e-4


@pytest.mark.parametrize("which,estimator", [("P64", "EB"), ("P64", "EE"), ("I32", "TT")])
def test_quadratic_estimate_matches_jax(which, estimator, request):
    pb = request.getfixturevalue(which)
    ref = j_qe(pb["jds"], which=estimator)
    out = ct.quadratic_estimate(pb["tds"], which=estimator)
    assert rel(out["Nphi"].diag.arr.numpy(), np.array(ref["Nphi"].diag.arr)) < 1e-5
    assert rel(out["phiqe"].arr.numpy(), np.array(ref["phiqe"].arr)) < 1e-5


@pytest.mark.parametrize("pol", ["I", "P"])
def test_port_load_sim_runs_and_lnP_rises_along_its_gradient(pol):
    sim = ct.load_sim(thetapix=3, Nside=32, pol=pol, seed=0, device="cpu")
    ds = sim["ds"]
    assert ds.d.arr.shape[-3] == {"I": 1, "P": 2}[pol]
    f = sim["f"].to(sim["f"].basis.with_space("map"))
    phi = sim["phi"].to(sim["phi"].basis.with_space("map"))
    m = ct.mix(ds, f=f, phi=phi)
    fm, pm = m["f_mix"].to(f.basis), m["phi_mix"].to(phi.basis)
    lnP = lambda p: ct.Mixed(ds).logpdf(f_mix=fm, phi_mix=p)
    v, g = ct.fvalue_and_grad(lnP)(pm)
    assert torch.isfinite(v) and torch.isfinite(g.arr).all()
    alpha = 30.0 / float(ct.dot(g, g))   # first-order gain 30, as chip_smoke.py
    assert float(lnP(pm + alpha * g)) > float(v)
