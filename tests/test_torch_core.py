"""The PyTorch port's core modules against the JAX package on the same
numpy inputs: basis conversions, dot, Cl_to_Cov, logpdf pieces and the
FFT spectral derivatives; plus the port's import hygiene and precision
pins.

Tolerances: both sides run float32 FFTs of <= 32^2 planes in different
libraries, whose round-off is ~1e-7 relative; 1e-5 relative max-abs
leaves room for the log(N) growth of FFT error and a few chained
transforms."""
import os
import subprocess
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cmblensing_tpu.core import field as JF
from cmblensing_tpu.core.basis import Basis
from cmblensing_tpu.core.cov import Cl_to_Cov as j_Cl_to_Cov
from cmblensing_tpu.core.proj import ProjLambert as JProj
from cmblensing_tpu.ops import deriv as jderiv
from cmblensing_tpu.utils.cls import camb as j_camb

import cmblensing_tpu_torch as ct
from cmblensing_tpu_torch.ops import deriv as tderiv
from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _projs(Ny, Nx):
    return (JProj(Ny, Nx, thetapix=3, T=np.float32),
            ct.ProjLambert(Ny, Nx, thetapix=3, T=np.float32, device="cpu"))


def _pair(arr, basis, jp, tp):
    """The same array as a JAX Field and a port Field; basis is (pol, space)."""
    return (JF.Field(jnp.asarray(arr), Basis(*basis), jp),
            ct.Field(torch.as_tensor(arr), ct.Basis(*basis), tp))


@pytest.fixture(autouse=True)
def _restore_mode():
    yield
    jderiv.set_deriv_mode("auto")


@pytest.mark.parametrize("src,dst", [
    (("QU", "map"), ("EB", "fourier")),
    (("QU", "map"), ("EB", "map")),
    (("QU", "map"), ("QU", "fourier")),
    (("EB", "map"), ("QU", "map")),
    (("EB", "map"), ("QU", "fourier")),
])
def test_basis_conversion_matches_jax(src, dst):
    jp, tp = _projs(32, 32)
    x = np.random.default_rng(0).standard_normal((2, 32, 32)).astype(np.float32)
    fj, ft = _pair(x, src, jp, tp)
    bj = fj.to(Basis(*dst)).arr
    bt = ft.to(ct.Basis(*dst)).arr
    assert rel(bt.numpy(), bj) < TOL
    # and back
    assert rel(ft.to(ct.Basis(*dst)).to(ct.Basis(*src)).arr.numpy(), x) < TOL


@pytest.mark.parametrize("ba,bb", [(("QU", "map"), ("QU", "map")),
                                   (("QU", "map"), ("EB", "map")),
                                   (("I", "map"), ("I", "map"))])
def test_dot_matches_jax(ba, bb):
    jp, tp = _projs(32, 32)
    rng = np.random.default_rng(1)
    n = Basis(*ba).ncomp
    xa = rng.standard_normal((n, 32, 32)).astype(np.float32)
    xb = rng.standard_normal((n, 32, 32)).astype(np.float32)
    aj, at = _pair(xa, ba, jp, tp)
    bj, bt = _pair(xb, bb, jp, tp)
    # in a Fourier basis, so the lam_rfft-weighted path runs on both sides
    aj, at = aj.to(Basis(ba[0], "fourier")), at.to(ct.Basis(ba[0], "fourier"))
    vj, vt = float(JF.dot(aj, bj)), float(ct.dot(at, bt))
    assert abs(vt - vj) <= 1e-5 * float(JF.norm(aj) * JF.norm(bj))
    assert abs(float(ct.norm(at)) - float(JF.norm(aj))) < TOL * float(JF.norm(aj))


@pytest.mark.parametrize("pol", ["I", "P"])
def test_Cl_to_Cov_and_logpdf_match_jax(pol):
    from cmblensing_tpu.models.distributions import MvNormal as JMv
    jp, tp = _projs(32, 32)
    ks = {"I": ("TT",), "P": ("EE", "BB")}[pol]
    jC = j_Cl_to_Cov(pol, jp, *[j_camb()["unlensed_scalar"][k] for k in ks])
    tC = ct.Cl_to_Cov(pol, tp, *[ct.camb()["unlensed_scalar"][k] for k in ks])
    assert (tC.basis.pol, tC.basis.space) == (jC.basis.pol, jC.basis.space)
    np.testing.assert_allclose(tC.diag.arr.numpy(), np.asarray(jC.diag.arr), rtol=1e-6)
    n = len(ks)
    x = np.random.default_rng(2).standard_normal((n, 32, 32)).astype(np.float32) * 1e-5
    fj, ft = _pair(x, (pol if pol == "I" else "QU", "map"), jp, tp)
    lj = float(JMv(0, jC).logpdf(fj))
    lt = float(ct.MvNormal(0, tC).logpdf(ft))
    assert abs(lt - lj) < 1e-5 * abs(lj)


@pytest.mark.parametrize("Ny,Nx", [(16, 16), (8, 16), (16, 8), (32, 32)])
def test_fft_derivatives_match_jax(Ny, Nx):
    jderiv.set_deriv_mode("fft")
    jp, tp = _projs(Ny, Nx)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, Ny, Nx)).astype(np.float32)
    s = rng.standard_normal((5, Ny, Nx)).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.as_tensor(x)
    sj, st = jnp.asarray(s), torch.as_tensor(s)
    for a, b in zip(jderiv.grad_xy(xj, jp), tderiv.grad_xy(xt, tp)):
        assert rel(b.numpy(), a) < TOL
    assert rel(tderiv.div_xy(xt[:1], xt[1:], tp).numpy(),
               jderiv.div_xy(xj[:1], xj[1:], jp)) < TOL
    (gj, hj), (gt, ht) = jderiv.gradhess(xj[:1], jp), tderiv.gradhess(xt[:1], tp)
    for a, b in zip((*gj, *hj), (*gt, *ht)):
        assert rel(b.numpy(), a) < TOL
    assert rel(tderiv.div_plus_dij5(*st, tp).numpy(),
               jderiv.div_plus_dij5(*sj, jp)) < TOL
    for a, b in zip(jderiv.bwd_stage_derivs(xj, sj[:2], sj[2:4], jp),
                    tderiv.bwd_stage_derivs(xt, st[:2], st[2:4], tp)):
        assert rel(b.numpy(), a) < TOL


@pytest.mark.parametrize("Ny,Nx", [(16, 16), (16, 32)])
def test_dense_circulants_equal_fft_derivatives(Ny, Nx):
    """The flow kernel's dense circulants (Nyquist zeroed) and the FFT
    derivatives are one operator: gradhess agrees to f32 round-off."""
    _, tp = _projs(Ny, Nx)
    x = torch.as_tensor(np.random.default_rng(4).standard_normal((1, Ny, Nx)).astype(np.float32))
    (g, h) = tderiv.gradhess(x, tp)
    planes = lfk.gradhess(x, tderiv.deriv_mats(tp))
    for a, b in zip(planes, (*g, *h)):
        assert rel(a.numpy(), b.numpy()) < TOL
    np.testing.assert_array_equal(tderiv._deriv_matrix(Nx, float(tp.deltax), "<f4"),
                                  jderiv._deriv_matrices(Nx, float(tp.deltax), "<f4")[0])


@pytest.mark.parametrize("Ny,Nx", [(16, 16), (16, 15)])
def test_irfft2_takes_the_hermitian_part_of_self_conjugate_columns(Ny, Nx):
    """A spectrum whose kx = 0 (and Nyquist) column is Hermitian only up
    to a perturbation inverts like its Hermitian part, as numpy's
    irfft2, and a batch of planes inverts like its planes one by one."""
    from cmblensing_tpu_torch.ops import fft as tfft
    rng = np.random.default_rng(5)
    X = (rng.standard_normal((3, Ny, Nx // 2 + 1))
         + 1j * rng.standard_normal((3, Ny, Nx // 2 + 1))).astype(np.complex64)
    out = tfft.irfft2(torch.as_tensor(X), Nx).numpy()
    np.testing.assert_allclose(out, np.fft.irfft2(X, s=(Ny, Nx)), atol=1e-6)
    for i in range(3):
        np.testing.assert_array_equal(out[i], tfft.irfft2(torch.as_tensor(X[i]), Nx).numpy())


def test_port_imports_no_jax():
    """Every module of the port, those its __init__ does not load (e.g.
    utils/plotting.py) too, imports neither jax nor the JAX package."""
    code = ("import importlib, pkgutil, sys, cmblensing_tpu_torch\n"
            "mods = [m.name for m in pkgutil.walk_packages(cmblensing_tpu_torch.__path__,"
            " 'cmblensing_tpu_torch.')]\n"
            "for m in mods:\n"
            "    importlib.import_module(m)\n"
            "assert 'cmblensing_tpu_torch.utils.plotting' in mods, mods\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m.startswith('cmblensing_tpu.') or m == 'cmblensing_tpu']\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_port_reads_its_own_copy_of_the_fiducial_spectra():
    """utils/cls.py reads the spectra from a file inside the port, equal
    array for array to the JAX package's, so that the port does not break
    when the reference package moves."""
    from cmblensing_tpu_torch.utils import cls as tcls
    port = os.path.realpath(tcls._CLS_NPZ)
    assert port.startswith(os.path.join(os.path.realpath(REPO), "cmblensing_tpu_torch") + os.sep)
    ref = os.path.join(REPO, "cmblensing_tpu", "dat", "default_camb_cls.npz")
    with np.load(port) as a, np.load(ref) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_tf32_off_after_import():
    import cmblensing_tpu_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
