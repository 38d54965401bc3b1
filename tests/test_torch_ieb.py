"""The port's pol-IP pieces against the JAX package: the simulated mask,
the T/E/B block-diagonal operator and its covariances, and a masked,
beamed 32^2 IP dataset carried across as numpy arrays
(`dataset_from_numpy`).

Tolerances, relative max-abs:
- make_mask: bit for bit (the same numpy and scipy calls on the same
  np.random.default_rng(seed) stream).
- Cl_to_Cov("IP") and every BlockDiagIEB method: 1e-6, float32 of the
  same per-mode arithmetic (a 2 x 2 inverse or square root per mode).
- logpdf of the masked IP dataset: 1e-5, both sides strict float32
  through LenseFlow (nsteps 7) summing in other orders (measured 5e-7).
- its f-gradient: 5e-5. The data residual d - M B L f cancels most of
  d at 1 muK-arcmin noise, so float32 resolves the gradient's largest
  element only to ~2e-5: on these inputs the JAX package and the port
  each lie 1.9e-5 from a float64 evaluation of the same arrays, and
  1.9e-5 from each other.
- the EB quadratic estimate's Nphi: 1e-5, float32 FFT sums of the same
  legs in another order.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cmblensing_tpu.core.basis import Basis as JBasis
from cmblensing_tpu.core.cov import Cl_to_Cov as j_Cl_to_Cov
from cmblensing_tpu.core.field import Field as JField
from cmblensing_tpu.core.ops import BlockDiagIEB as JIEB, Diag as JDiag, LazyOp as JLazyOp
from cmblensing_tpu.core.ops import logdet as j_logdet
from cmblensing_tpu.core.proj import ProjLambert as JProj
from cmblensing_tpu.models.dataset import load_sim as j_load_sim
from cmblensing_tpu.models.quadratic_estimate import quadratic_estimate as j_qe
from cmblensing_tpu.utils.masking import make_mask as j_make_mask

import cmblensing_tpu_torch as ct
from cmblensing_tpu_torch.core.ops import BlockDiagIEB, Id, LazyOp
from cmblensing_tpu_torch.models.dataset import DIAG_OPS
from cmblensing_tpu_torch.utils.masking import make_mask

N = 32
MASK = dict(edge_padding_deg=0.2, apodization_deg=0.1)


def rel(a, b):
    """Relative max-abs distance; absolute where b is zero (a zero block)."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) or 1.0))


def carry_field(jfield, proj):
    return ct.Field(torch.as_tensor(np.array(jfield.arr)),
                    ct.Basis(jfield.basis.pol, jfield.basis.space), proj)


def op_to_numpy(op):
    """What dataset_from_numpy takes for a JAX operator evaluated at theta = {}."""
    if isinstance(op, JLazyOp):
        assert op.kind == "*"
        return [op_to_numpy(op.X), op_to_numpy(op.Y)]
    if isinstance(op, JIEB):
        blocks = {k: np.array(getattr(op, k).arr) for k in ("TT", "TE", "EE", "BB")}
        if op.ET is not op.TE:
            blocks["ET"] = np.array(op.ET.arr)
        return blocks
    return (np.array(op.diag.arr), op.diag.basis.pol, op.diag.basis.space)


def dataset_to_port(jds, proj_kwargs):
    ds0 = jds.at({})
    arrays = {"d": (np.array(jds.d.arr), jds.d.basis.pol, jds.d.basis.space)}
    arrays.update({name: op_to_numpy(getattr(ds0, name)) for name in DIAG_OPS})
    return ct.dataset_from_numpy(arrays, proj_kwargs, device="cpu")


@pytest.fixture(scope="module")
def IP32():
    """The masked, beamed IP dataset of the slice's configuration at 32^2
    (examples/03_joint_MAP.py's mask and beam, pol IP), built by the JAX
    package and carried across."""
    out = j_load_sim(thetapix=3, Nside=N, pol="IP", T=np.float32, muKarcminT=1, beamFWHM=2,
                     pixel_mask_kwargs=MASK, seed=0)
    jds = out["ds"]
    tds = dataset_to_port(jds, dict(Ny=N, Nx=N, thetapix=3, T=np.float32))
    proj = tds.d.proj
    jphi = out["phi"].to(out["phi"].basis.with_space("map"))
    jf = out["f"].to(out["f"].basis.with_space("map"))
    return dict(jds=jds, tds=tds, jphi=jphi, jf=jf, tphi=carry_field(jphi, proj),
                tf=carry_field(jf, proj), proj=proj)


@pytest.mark.parametrize("shape,thetapix,kw", [
    ((32, 32), 3, MASK),
    ((64, 48), 2, dict(edge_padding_deg=0.5, apodization_deg=0.25, num_ptsrcs=5)),
    ((40, 40), 3, dict(apodization_deg=0, edge_padding_deg=0.3)),
    ((32, 32), 3, dict(num_ptsrcs=0, edge_padding_deg=0.2, apodization_deg=0.1)),
])
def test_make_mask_is_the_jax_mask_bit_for_bit(shape, thetapix, kw):
    a = make_mask(shape, thetapix, rng=np.random.default_rng(7), **kw)
    b = j_make_mask(shape, thetapix, rng=np.random.default_rng(7), **kw)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def IEB():
    """Two IP covariances (one with T and E correlated), a non-symmetric
    product of the two, and an IEB fourier field, on both sides."""
    jp = JProj(N, N, thetapix=3)
    tp = ct.ProjLambert(N, N, thetapix=3, device="cpu")
    Cl = ct.camb()
    ks = ("TT", "EE", "BB", "TE")
    specs = [[Cl["unlensed_scalar"][k] for k in ks], [Cl["total"][k] for k in ks]]
    jC = [j_Cl_to_Cov("IP", jp, *s) for s in specs]
    tC = [ct.Cl_to_Cov("IP", tp, *s) for s in specs]
    rng = np.random.default_rng(3)
    m = rng.standard_normal((3, N, N)).astype(np.float32)
    jf = JField(jnp.asarray(m), JBasis("IQU", "map"), jp).to(JBasis("IEB", "fourier"))
    tf = ct.Field(torch.as_tensor(m), ct.Basis("IQU", "map"), tp).to(ct.Basis("IEB", "fourier"))
    dg = (1 + rng.random((3, N, N // 2 + 1))).astype(np.float32)
    jD = JDiag(JField(jnp.asarray(dg), JBasis("IEB", "fourier"), jp))
    tD = ct.Diag(ct.Field(torch.as_tensor(dg), ct.Basis("IEB", "fourier"), tp))
    return dict(jC=jC, tC=tC, jf=jf, tf=tf, jD=jD, tD=tD, tp=tp)


def _blocks(op):
    return [np.array(getattr(op, k).arr) for k in ("TT", "TE", "EE", "BB", "ET")]


def test_Cl_to_Cov_IP_is_the_jax_block_operator(IEB):
    for j, t in zip(IEB["jC"], IEB["tC"]):
        assert isinstance(t, BlockDiagIEB)
        for a, b in zip(_blocks(t), _blocks(j)):
            assert rel(a, b) < 1e-6
    with pytest.raises(ValueError, match="takes 4 spectra"):
        ct.Cl_to_Cov("IP", IEB["tp"], ct.camb()["total"]["TT"])


@pytest.mark.parametrize("method", ["matmul", "solve", "pinv", "H", "sqrt", "diag", "getitem",
                                    "mul", "mul_diag", "rmul_diag", "add", "add_diag",
                                    "radd_diag", "logdet", "product_H"])
def test_BlockDiagIEB_methods_match_jax(IEB, method):
    (jA, jB), (tA, tB) = IEB["jC"], IEB["tC"]
    jf, tf, jD, tD = IEB["jf"], IEB["tf"], IEB["jD"], IEB["tD"]
    fields = lambda j, t: [(np.array(j.arr), t.arr.numpy())]
    if method == "matmul":
        pairs = fields(jA @ jf, tA @ tf)
    elif method == "solve":
        pairs = fields(jA.solve(jf), tA.solve(tf))
    elif method == "diag":
        pairs = fields(jA.diag(), tA.diag())
    elif method == "getitem":
        pairs = [(np.array(jA[k].diag.arr), tA[k].diag.arr.numpy()) for k in ("I", "E", "B", "P")]
        assert tA["IP"] is tA
    elif method == "logdet":
        pairs = [(np.array(j_logdet(jA)), ct.logdet(tA).numpy())]
    else:
        jop, top = {"pinv": (jA.pinv(), tA.pinv()), "H": ((jA * jB).H, (tA * tB).H),
                    "sqrt": (jA.sqrt(), tA.sqrt()), "mul": (jA * jB, tA * tB),
                    "mul_diag": (jA * jD, tA * tD), "rmul_diag": (jD * jA, tD * tA),
                    "add": (jA + jB, tA + tB), "add_diag": (jA + jD, tA + tD),
                    "radd_diag": (jD + jA, tD + tA),
                    "product_H": ((jA * jB).H @ jf, (tA * tB).H @ tf)}[method]
        if method == "product_H":
            pairs = fields(jop, top)
        elif isinstance(jop, JIEB):
            assert isinstance(top, BlockDiagIEB)
            pairs = list(zip(_blocks(jop), _blocks(top)))
        else:   # JAX keeps Diag * BlockDiagIEB lazy: compare the applied operators
            pairs = fields(jop @ jf, top @ tf)
    for j, t in pairs:
        assert rel(t, j) < 1e-6, method


def test_BlockDiagIEB_with_other_operators(IEB):
    """With the identity a product is the operator itself and a sum is
    lazy; with a Diag on another basis both are lazy; either applies as
    the JAX package's LazyOp does."""
    tA, tf = IEB["tC"][0], IEB["tf"]
    assert tA * Id is tA and Id * tA is tA
    s = tA + Id
    assert isinstance(s, LazyOp) and s.kind == "+"
    out = s @ tf
    ref = (tA @ tf) + tf
    assert rel(out.to(ref.basis).arr.numpy(), ref.arr.numpy()) < 1e-6
    eb = ct.Diag(ct.Field(torch.ones((1, N, N)), ct.Basis("I", "map"), IEB["tp"]))
    assert isinstance(tA * eb, LazyOp) and isinstance(eb * tA, LazyOp)
    assert isinstance(tA + eb, LazyOp) and isinstance(eb + tA, LazyOp)


def test_IP_load_sim_runs_the_port_on_its_own():
    """The port's own load_sim at pol IP with a pixel mask: M is the
    Fourier mask times the pixel mask that make_mask draws, M_hat the
    Fourier part; d is an IEB fourier field; the logpdf is finite."""
    sim = ct.load_sim(thetapix=3, Nside=N, pol="IP", T=np.float32, muKarcminT=1, beamFWHM=2,
                      pixel_mask_kwargs=MASK, seed=0, device="cpu")
    ds = sim["ds"]
    assert isinstance(ds.M, LazyOp) and ds.M.kind == "*" and ds.M.X is ds.M_hat
    assert isinstance(ds.M_hat, BlockDiagIEB) and isinstance(ds.Cf.fiducial, BlockDiagIEB)
    mask = make_mask((N, N), 3, rng=np.random.default_rng(0), **MASK)
    np.testing.assert_array_equal(ds.M.Y.diag.arr.numpy(), np.broadcast_to(mask, (3, N, N)))
    assert ds.d.basis == ct.Basis("IEB", "fourier")
    assert torch.isfinite(ds.logpdf(f=sim["f"], phi=sim["phi"]))


def test_IP_dataset_logpdf_and_fgradient_match_jax(IP32):
    jds, tds = IP32["jds"], IP32["tds"]
    jl = float(jds.logpdf(f=IP32["jf"], phi=IP32["jphi"]))
    tl = float(tds.logpdf(f=IP32["tf"], phi=IP32["tphi"]))
    assert abs(tl - jl) < 1e-5 * abs(jl)
    jg = jds.gradientf_logpdf(IP32["jf"], phi=IP32["jphi"])
    tg = tds.gradientf_logpdf(IP32["tf"], phi=IP32["tphi"])
    assert tg.basis == ct.Basis(jg.basis.pol, jg.basis.space)
    assert rel(tg.arr.numpy(), np.array(jg.arr)) < 5e-5


def test_IP_EB_quadratic_estimate_matches_jax(IP32):
    """The EB estimator on IEB data (which = "EB" for any pol but I), its
    transfer function per component from M_hat and B_hat: Nphi and the
    estimate itself."""
    jq, tq = j_qe(IP32["jds"]), ct.quadratic_estimate(IP32["tds"])
    assert rel(tq["Nphi"].diag.arr.numpy(), np.array(jq["Nphi"].diag.arr)) < 1e-5
    assert rel(tq["phiqe"].arr.numpy(), np.array(jq["phiqe"].arr)) < 1e-5


def test_IQU_and_IEB_component_access_matches_jax(IEB):
    """f["I"], f["E"], f["B"] of an IQU map field and of its IEB fourier
    form, and the IQU <-> IEB round trip, as the JAX package gives them."""
    jp, tp = IEB["jf"].proj, IEB["tp"]
    m = np.random.default_rng(5).standard_normal((3, N, N)).astype(np.float32)
    jm = JField(jnp.asarray(m), JBasis("IQU", "map"), jp)
    tmap = ct.Field(torch.as_tensor(m), ct.Basis("IQU", "map"), tp)
    for jf, tf in ((jm, tmap), (jm.to(JBasis("IEB", "fourier")), tmap.to(ct.IEB_FOURIER))):
        for k in ("I", "E", "B"):
            j, t = jf[k], tf[k]
            assert t.basis == ct.Basis(j.basis.pol, j.basis.space), k
            assert rel(t.arr.numpy(), np.array(j.arr)) < 1e-6, k
    back = tmap.to(ct.IEB_FOURIER).to(ct.IQU_MAP)
    assert rel(back.arr.numpy(), m) < 1e-6


def test_IP_load_sim_takes_a_bandpass_mask():
    """bandpass_mask replaces LowPass(3000) as the Fourier mask (M_hat)."""
    lp = ct.LowPass(1000)
    sim = ct.load_sim(thetapix=3, Nside=N, pol="IP", bandpass_mask=lp, seed=0, device="cpu")
    W = lp.on(sim["proj"], pol="I").diag.arr
    Mh = sim["ds"].M_hat
    assert isinstance(Mh, BlockDiagIEB) and sim["ds"].M is Mh
    for k in ("TT", "EE", "BB"):
        assert torch.equal(getattr(Mh, k).arr, W)
    assert not getattr(Mh, "TE").arr.any()
