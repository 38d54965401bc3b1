"""The rest of the port's field API against the JAX package on the same
inputs: Field's basis shorthands and components, zeros_like_field on any
field type, the fft helpers (fft2, ifft2, unfold, fftsyms, rfft2vec,
vec2rfft), the operator algebra (_as_op, FuncOp, SymmetricFuncOp), the
pass filters, the gradient operators, tr and diag_field, FieldTuple and
DiagFieldTuple, FieldVector and FieldMatrix, ud_grade, get_Dl; and that
profiler_trace, the plots and the top-level names run.

Fields are 16^2 (and 12 x 10, 9 x 7 where odd shapes matter), float32, the
same numpy arrays on both sides. Tolerance 1e-6 relative max-abs: the two
packages run the same float32 operations (FFTs by different libraries).
"""
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import cmblensing_tpu as J
from cmblensing_tpu.core import field_tuple as jft, field_vectors as jfv, ops as jops
from cmblensing_tpu.core.basis import Basis as JB
from cmblensing_tpu.core.field import Field as JF
from cmblensing_tpu.ops import fft as jfft
from cmblensing_tpu.utils.spectra import get_Dl as j_get_Dl

import cmblensing_tpu_torch as ct
from cmblensing_tpu_torch.core import field_tuple as tft, field_vectors as tfv, ops as tops
from cmblensing_tpu_torch.ops import fft as tfft

TOL = 1e-6
N = 16


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def npy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().resolve_conj().numpy()
    return np.asarray(getattr(x, "arr", x))


def arr_of(f):
    return npy(f.arr) if isinstance(f.arr, torch.Tensor) else np.asarray(f.arr)


def same(tf, jf, tol=TOL):
    """A port field (or tensor) against a JAX one, in the JAX one's basis."""
    if hasattr(jf, "basis") and hasattr(tf, "basis"):
        tf = tf.to(ct.Basis(jf.basis.pol, jf.basis.space))
        assert (tf.basis.pol, tf.basis.space) == (jf.basis.pol, jf.basis.space)
        return rel(arr_of(tf), np.asarray(jf.arr)) < tol
    return rel(npy(tf), np.asarray(jf)) < tol


@pytest.fixture(scope="module")
def pair():
    """A 16^2 IQU map field and a 16^2 I map field on each side."""
    jp = J.ProjLambert(N, N, thetapix=3.0, T=np.float32)
    tp = ct.ProjLambert(N, N, thetapix=3.0, T=np.float32, device="cpu")
    g = np.random.default_rng(0)
    x3 = g.standard_normal((3, N, N)).astype(np.float32)
    x1 = g.standard_normal((1, N, N)).astype(np.float32)
    mk = lambda x, pol: (JF(jnp.asarray(x), JB(pol, "map"), jp),
                         ct.Field(torch.as_tensor(x.copy()), ct.Basis(pol, "map"), tp))
    return dict(jp=jp, tp=tp, IQU=mk(x3, "IQU"), I=mk(x1, "I"), QU=mk(x3[1:], "QU"))


@pytest.mark.parametrize("k", ["I", "Q", "U", "E", "B", "P", "IP"])
def test_field_components_and_basis_shorthands_match_jax(pair, k):
    jf, tf = pair["IQU"]
    assert same(tf[k], jf[k])
    jq, tq = pair["QU"]
    if k in ("Q", "U", "E", "B"):
        assert same(tq.to(ct.EB_FOURIER)[k], jq.to(J.EB_FOURIER)[k])
    assert same(tf.to_lense(), jf.to_lense()) and same(tf.to_deriv(), jf.to_deriv())
    assert tf.real_dtype == torch.float32 and tf.to(ct.IEB_FOURIER).real_dtype == torch.float32
    assert tuple(tf.flatten().shape) == tuple(jf.flatten().shape)


def test_zeros_like_field_takes_any_field_type():
    from cmblensing_tpu_torch.core import proj_equirect as TE
    tp = TE.ProjEquiRect(Ny=4, Nx=8, theta_span=(1.2, 1.8), phi_span=(0, 2 * np.pi), device="cpu")
    f = TE.EquiRectField(torch.ones(2, 4, 8), "map", tp)
    z = ct.zeros_like_field(f)
    assert type(z) is TE.EquiRectField and z.basis == "map" and z.batch_shape == (2,)
    assert float(z.arr.abs().sum()) == 0.0


@pytest.mark.parametrize("shape", [(N, N), (12, 10), (9, 7)])
def test_fft_helpers_match_jax(shape):
    Ny, Nx = shape
    x = np.random.default_rng(Ny * Nx).standard_normal((2, Ny, Nx)).astype(np.float32)
    X = np.fft.rfft2(x).astype(np.complex64)
    assert same(tfft.fft2(torch.as_tensor(x)), jfft.fft2(jnp.asarray(x)))
    Xf = np.fft.fft2(x).astype(np.complex64)
    assert same(tfft.ifft2(torch.as_tensor(Xf)), jfft.ifft2(jnp.asarray(Xf)))
    u = tfft.unfold(torch.as_tensor(X), Nx)
    assert same(u, jfft.unfold(jnp.asarray(X), Nx=Nx))
    assert rel(npy(u), Xf) < 1e-5                          # the full plane of a real map
    for a, b in zip(tfft.fftsyms(Ny, Nx)[:2], jfft.fftsyms(Ny, Nx)[:2]):
        np.testing.assert_array_equal(a, b)
    v = tfft.rfft2vec(torch.as_tensor(X), Nx=Nx)
    assert v.shape[-1] == Ny * Nx
    assert same(v, jfft.rfft2vec(jnp.asarray(X), Nx=Nx))
    back = tfft.vec2rfft(v, Ny=Ny, Nx=Nx)
    assert same(back, jfft.vec2rfft(jnp.asarray(npy(v)), Ny=Ny, Nx=Nx))
    assert rel(npy(back), X) < 1e-6                       # the half plane restored
    if Ny == Nx and Nx % 2 == 0:
        assert torch.equal(tfft.vec2rfft(v), back)          # a square grid by default
        assert same(tfft.unfold(torch.as_tensor(X)), jfft.unfold(jnp.asarray(X)))


def test_spectra_use_the_one_unfold_and_get_Dl_matches_jax(pair):
    from cmblensing_tpu_torch.utils import spectra
    assert spectra.unfold is tfft.unfold
    jf, tf = pair["I"]
    ledges = np.arange(100, 3000, 400)
    dj, dt = j_get_Dl(jf, ledges=ledges), ct.get_Dl(tf, ledges=ledges)
    assert rel(dt.ell, dj.ell) < TOL and rel(dt.Cl, dj.Cl) < 1e-5


def test_operator_algebra_and_funcop_match_jax(pair):
    jf, tf = pair["QU"]
    jd = jops.Diag(jf.to(J.EB_FOURIER) * 0.05 + 2.0)
    td = tops.Diag(tf.to(ct.EB_FOURIER) * 0.05 + 2.0)
    cases = [(lambda D, I, s: (I + D) @ s, "Id + D"), (lambda D, I, s: (D * 2) @ s, "D * 2"),
             (lambda D, I, s: (2 * D) @ s, "2 * D"), (lambda D, I, s: (D / 4) @ s, "D / 4"),
             (lambda D, I, s: (-D) @ s, "-D"), (lambda D, I, s: (D ** 2) @ s, "D ** 2"),
             (lambda D, I, s: (D - D * 0.5) @ s, "D - D/2"), (lambda D, I, s: (D + I) @ s, "D + Id"),
             (lambda D, I, s: (D ** -1) @ s, "D ** -1"), (lambda D, I, s: (D * D.H).solve(s), "solve"),
             (lambda D, I, s: (D + 1).H @ s, "(D + 1).H")]
    for fn, label in cases:
        assert same(fn(td, tops.Id, tf), fn(jd, jops.Id, jf), 1e-5), label
    # FuncOp / SymmetricFuncOp: apply, adjoint, inverse
    jF = jops.FuncOp(op=lambda f: jd @ f, opH=lambda f: jd.H @ f, opinv=lambda f: jd.solve(f))
    tF = tops.FuncOp(op=lambda f: td @ f, opH=lambda f: td.H @ f, opinv=lambda f: td.solve(f))
    assert same(tF @ tf, jF @ jf) and same(tF.H @ tf, jF.H @ jf)
    assert same(tF.solve(tf), jF.solve(jf)) and same(tF.inv() @ tf, jF.inv() @ jf)
    tS = tops.SymmetricFuncOp(op=lambda f: 3 * f, opinv=lambda f: f / 3)
    assert same(tS.H @ tf, jops.SymmetricFuncOp(op=lambda f: 3 * f).H @ jf)
    assert isinstance(tops._as_op(2), tops.Scaled) and tops._as_op(td) is td
    with pytest.raises(ValueError, match="not implemented"):
        tops.FuncOp(op=lambda f: f).solve(tf)
    with pytest.raises(TypeError, match="'@'"):
        td * tf


@pytest.mark.parametrize("name,args", [("HighPass", (300,)), ("LowPass", (2000, 100)),
                                       ("MidPass", (200, 1500, 60))])
def test_pass_filters_match_jax(pair, name, args):
    jB, tB = getattr(jops, name)(*args), getattr(tops, name)(*args)
    np.testing.assert_array_equal(tB.ell, jB.ell)
    np.testing.assert_array_equal(tB.Wl, jB.Wl)
    ell = np.arange(0, 3000, 7.5)
    np.testing.assert_array_equal(tB(ell), jB(ell))
    assert same(tB.on(pair["tp"], "QU").diag, jB.on(pair["jp"], "QU").diag)
    for a, b in zip(tops.MidPasses([100, 500, 1200]), jops.MidPasses([100, 500, 1200])):
        np.testing.assert_array_equal(a.Wl, b.Wl)


@pytest.mark.parametrize("pol", ["I", "QU"])
def test_gradient_operators_match_jax(pair, pol):
    jf, tf = pair[pol]
    assert same(tops.grad_x(tf), jops.grad_x(jf)) and same(tops.grad_y(tf), jops.grad_y(jf))
    (tdx, tdy), (jdx, jdy) = tops.gradient_ops(), jops.gradient_ops()
    assert same(tdx @ tf, jdx @ jf) and same(tdy.H @ tf, jdy.H @ jf)
    for a, b in zip(tops.gradient(tf), jops.gradient(jf)):
        assert same(a, b)
    (tg, tH), (jg, jH) = tops.gradhess(tf), jops.gradhess(jf)
    for a, b in zip(tg + tH[0] + tH[1], jg + jH[0] + jH[1]):
        assert same(a, b)
    assert same(tops.laplacian(tf), jops.laplacian(jf))


def test_tr_and_diag_field_match_jax(pair):
    jf, tf = pair["QU"]
    for tb, jb in ((ct.EB_FOURIER, J.EB_FOURIER), (ct.QU_MAP, J.QU_MAP)):
        jd, td = jops.Diag(jf.to(jb) * 0.3 + 1.0), tops.Diag(tf.to(tb) * 0.3 + 1.0)
        assert rel(npy(tops.tr(td)), np.asarray(jops.tr(jd))) < TOL
        assert same(tops.diag_field(tops.Scaled(2.0, td)), jops.diag_field(jops.Scaled(2.0, jd)))
        pd_t = tops.ParamDependentOp((), lambda deps: deps[0], (td,))
        pd_j = jops.ParamDependentOp((), lambda deps: deps[0], (jd,))
        assert same(tops.diag_field(pd_t), jops.diag_field(pd_j))
    with pytest.raises(TypeError):
        tops.tr(tops.Id)


def test_field_tuple_matches_jax(pair):
    (jq, tq), (ji, ti) = pair["QU"], pair["I"]
    J_ = jft.FieldTuple(f=jq, phi=ji)
    T_ = tft.FieldTuple(f=tq, phi=ti)
    for jr, tr_ in ((J_ + J_ * 2.0, T_ + T_ * 2.0), (J_ - 0.5 * J_, T_ - 0.5 * T_), (-J_, -T_)):
        assert same(tr_.f, jr.f) and same(tr_["phi"], jr["phi"])
    assert list(T_.keys()) == ["f", "phi"]
    assert same(T_.to(ct.harmonic_basis).f, J_.to(J.harmonic_basis).f)
    assert rel(npy(tft.ft_dot(T_, T_)), np.asarray(jft.ft_dot(J_, J_))) < TOL
    jD = jft.DiagFieldTuple(f=jops.Diag(jq.to(J.EB_FOURIER) * 0 + 3.0))
    tD = tft.DiagFieldTuple(f=tops.Diag(tq.to(ct.EB_FOURIER) * 0 + 3.0))
    for jr, tr_ in ((jD @ J_, tD @ T_), (jD.solve(J_), tD.solve(T_)), (jD.H @ J_, tD.H @ T_),
                    (jD.pinv() @ J_, tD.pinv() @ T_)):
        assert same(tr_.f, jr.f) and same(tr_.phi, jr.phi)
    with pytest.raises(AttributeError):
        T_.nothing


def test_field_vectors_and_matrices_match_jax(pair):
    jf, tf = pair["I"]
    jv, tv = jfv.gradient_vector(jf), tfv.gradient_vector(tf)
    for a, b in zip(tv, jv):
        assert same(a, b)
    assert rel(npy(tv.dot(tv)), np.asarray(jv.dot(jv))) < TOL
    assert same(tv.norm2(), jv.norm2()) and same((tv + tv * 2.0)[1], (jv + jv * 2.0)[1])
    jH, tH = jfv.hessian_matrix(jf), tfv.hessian_matrix(tf)
    t = 0.3 / max(float(np.abs(np.asarray(jH[i, k].arr)).max()) for i in (0, 1) for k in (0, 1))
    jM, tM = jfv.magnification_matrix(jf, t=t), tfv.magnification_matrix(tf, t=t)
    for i in range(2):
        for k in range(2):
            assert same(tH[i, k], jH[i, k]) and same(tM[i, k], jM[i, k])
    assert same(tM.det(), jM.det())
    # an SPD matrix of fields: its closed-form sqrt and inverse
    jS, tS = jM @ jM.T, tM @ tM.T
    for jr, tr_ in ((jS.sqrt(), tS.sqrt()), (jS.pinv(), tS.pinv()), (jS + jS, tS + tS),
                    (jv.outer(jv), tv.outer(tv))):
        for i in range(2):
            for k in range(2):
                assert same(tr_[i, k], jr[i, k], 1e-5)
    for a, b in zip(tM @ tv, jM @ jv):
        assert same(a, b)
    q = tS.sqrt()
    assert same((q @ q)[0, 1], jS[0, 1], 1e-4)              # sqrt(M) sqrt(M) = M
    # matrices of Diag operators
    jD = jfv.FieldMatrix(((jops.Diag(jf.to(J.FOURIER) * 0 + 2.0), jops.Diag(jf.to(J.FOURIER) * 0)),
                          (jops.Diag(jf.to(J.FOURIER) * 0), jops.Diag(jf.to(J.FOURIER) * 0 + 4.0))))
    tD = tfv.FieldMatrix(((tops.Diag(tf.to(ct.FOURIER) * 0 + 2.0), tops.Diag(tf.to(ct.FOURIER) * 0)),
                          (tops.Diag(tf.to(ct.FOURIER) * 0), tops.Diag(tf.to(ct.FOURIER) * 0 + 4.0))))
    for a, b in zip(tD.pinv() @ tv, jD.pinv() @ jv):
        assert same(a, b)


@pytest.mark.parametrize("mode", ["map", "fourier"])
@pytest.mark.parametrize("theta_new", [1.5, 6.0])
@pytest.mark.parametrize("opts", [dict(), dict(deconv_pixwin=True, anti_aliasing=False)])
def test_ud_grade_matches_jax(pair, mode, theta_new, opts):
    for pol in ("I", "QU"):
        jf, tf = pair[pol]
        jg, tg = J.ud_grade(jf, theta_new, mode=mode, **opts), ct.ud_grade(tf, theta_new, mode=mode,
                                                                              **opts)
        assert (tg.proj.Ny, tg.proj.thetapix) == (jg.proj.Ny, jg.proj.thetapix)
        assert tg.proj.device == tf.proj.device
        assert same(tg, jg)
    with pytest.raises(ValueError, match="integer"):
        ct.ud_grade(tf, 4.0)


def test_profiler_trace_writes_a_chrome_trace(tmp_path, pair):
    _, tf = pair["I"]
    with ct.profiler_trace(str(tmp_path)) as prof:
        with ct.timed("curved test"):
            tf.to(ct.FOURIER)
    assert os.path.getsize(tmp_path / "trace.json") > 0
    assert len(prof.key_averages()) > 0
    assert "curved test" in ct.timer_report()
    ct.reset_timers()
    assert "curved test" not in ct.timer_report()


def test_plots_run_on_the_host(tmp_path, pair):
    pytest.importorskip("matplotlib")
    from cmblensing_tpu_torch.utils import plotting
    _, tf = pair["IQU"]
    plotting.plot_map(tf, "E")
    plotting.plot_maps([tf["I"], tf["Q"]], titles=["I", "Q"])
    plotting.plot_cls([ct.get_Cl(tf["I"], ledges=np.arange(100, 3000, 400))], labels=["I"])
    plotting.plot_kde(np.random.default_rng(0).standard_normal(200))
    import matplotlib.pyplot as plt
    plt.close("all")


def test_top_level_names():
    x = torch.tensor([1.0, 3.0, 2.0])
    np.testing.assert_allclose(npy(ct.expnorm(x)), np.asarray(J.expnorm(jnp.asarray(npy(x)))),
                               rtol=1e-6)
    assert ct.firsthalf([1, 2, 3, 4]) == [1, 2] and ct.lasthalf([1, 2, 3, 4]) == [3, 4]
    tp = ct.ProjLambert(8, 8, device="cpu")
    f = ct.from_maps(np.ones((8, 8), np.float32), tp)
    D = ct.Diag(f)
    assert ct.diag(D) is f and "Field" in ct.fieldinfo(f)
    for name in ("gibbs_sample_f", "gibbs_sample_phi", "gibbs_sample_slice_theta", "gibbs_mix",
                 "gibbs_unmix", "gibbs_postprocess", "timed", "timer_report", "reset_timers",
                 "FieldTuple", "FieldVector", "ProjEquiRect", "ProjHealpix", "project", "ud_grade",
                 "unfold", "fftsyms", "rfft2vec", "vec2rfft", "get_Dl", "HighPass", "MidPasses",
                 "gradhess", "laplacian", "tr", "animate"):
        assert hasattr(ct, name), name
