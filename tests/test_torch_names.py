"""Three small names of the JAX package held on the port: the theory
spectra's container `CMBSpectra` (utils/cls.py), `tree_axpy`
(ops/solvers.py) and `global_cache_clear` (ops/fft.py).

- camb() and load_camb_cls() return a CMBSpectra, as the JAX package's do,
  with its components, spectra and params; every ell and C_ell within 1e-6
  relative of JAX's (both read the same float64 numbers: measured 0).
- tree_axpy over Fields, tensors and tuples of them: the port's y + a x
  within 1e-6 relative of JAX's (float32, one multiply-add).
- global_cache_clear empties the caches its docstring names.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cmblensing_tpu.core.basis import Basis as JBasis
from cmblensing_tpu.core.field import Field as JField
from cmblensing_tpu.core.proj import ProjLambert as JProj
from cmblensing_tpu.ops.solvers import tree_axpy as j_tree_axpy
from cmblensing_tpu.utils import cls as jcls

import cmblensing_tpu_torch as ct
from cmblensing_tpu_torch.ops import fft as tfft
from cmblensing_tpu_torch.ops.solvers import tree_axpy
from cmblensing_tpu_torch.utils import cls as tcls

COMPONENTS = ("unlensed_scalar", "lensed_scalar", "tensor", "unlensed_total", "total")
SPECTRA = ("TT", "EE", "BB", "TE", "pp", "phiphi")


def rel(a, b):
    a, b = np.asarray(a).astype(np.complex128), np.asarray(b).astype(np.complex128)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) or 1.0))


def _same_spectra(t, j):
    assert isinstance(t, tcls.CMBSpectra) and isinstance(j, jcls.CMBSpectra)
    assert set(t) == set(j)
    for comp in COMPONENTS:
        assert getattr(t, comp) is t[comp]
        assert set(t[comp]) == set(j[comp]) >= set(SPECTRA)
        for spec in SPECTRA:
            assert rel(t[comp][spec].ell, j[comp][spec].ell) < 1e-6, (comp, spec)
            assert rel(t[comp][spec].Cl, j[comp][spec].Cl) < 1e-6, (comp, spec)
    assert dict(t["params"]) == dict(j["params"])


def test_camb_returns_CMBSpectra_with_jax_values():
    _same_spectra(ct.camb(), jcls.camb())


def test_load_camb_cls_returns_CMBSpectra_with_jax_values(tmp_path):
    """CAMB's four output files (one header line, D_ell columns), written
    from a seeded draw, read by both packages, with and without lmax."""
    rng = np.random.default_rng(3)
    ell = np.arange(2, 400, dtype=np.float64)
    cols = {"scalCls.dat": 4, "tensCls.dat": 5, "lensedCls.dat": 5, "lenspotentialCls.dat": 6}
    for name, ncol in cols.items():
        t = np.column_stack([ell] + [1 + rng.random(ell.size) for _ in range(ncol - 1)])
        np.savetxt(tmp_path / f"camb_{name}", t, header="L cols")
    prefix = str(tmp_path / "camb_")
    for lmax in (None, 600):
        _same_spectra(ct.load_camb_cls(prefix, lmax=lmax), jcls.load_camb_cls(prefix, lmax=lmax))


@pytest.mark.parametrize("a", [0.37, -2.5])
def test_tree_axpy_matches_jax(a):
    rng = np.random.default_rng(4)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            [(2, 16, 16), (2, 16, 16), (1, 16, 9), (1, 16, 9), (5,), (5,)]]
    arrs[2] = (arrs[2] + 1j * rng.standard_normal((1, 16, 9))).astype(np.complex64)
    arrs[3] = (arrs[3] + 1j * rng.standard_normal((1, 16, 9))).astype(np.complex64)
    tp = ct.ProjLambert(16, 16, thetapix=3, device="cpu")
    jp = JProj(16, 16, thetapix=3, T=np.float32)
    tf = lambda x, pol, sp: ct.Field(torch.as_tensor(x), ct.Basis(pol, sp), tp)
    jf = lambda x, pol, sp: JField(jnp.asarray(x), JBasis(pol, sp), jp)
    tx = (tf(arrs[0], "QU", "map"), (tf(arrs[2], "I", "fourier"), torch.as_tensor(arrs[4])))
    ty = (tf(arrs[1], "QU", "map"), (tf(arrs[3], "I", "fourier"), torch.as_tensor(arrs[5])))
    jx = (jf(arrs[0], "QU", "map"), (jf(arrs[2], "I", "fourier"), jnp.asarray(arrs[4])))
    jy = (jf(arrs[1], "QU", "map"), (jf(arrs[3], "I", "fourier"), jnp.asarray(arrs[5])))
    (t0, (t1, t2)), (j0, (j1, j2)) = tree_axpy(a, tx, ty), j_tree_axpy(a, jx, jy)
    assert t0.basis == ct.QU_MAP and t1.basis == ct.Basis("I", "fourier")
    for t, j in ((t0.arr, j0.arr), (t1.arr, j1.arr), (t2, j2)):
        assert rel(t.numpy(), np.asarray(j)) < 1e-6
    # a Field alone, and a per-batch-entry a
    f = tree_axpy(a, tx[0], ty[0])
    assert torch.equal(f.arr, t0.arr)
    ab = torch.tensor([a, 2 * a])
    fb = tree_axpy(ab, ct.batch([tx[0], tx[0]]), ct.batch([ty[0], ty[0]]))
    assert torch.allclose(fb.arr[1], (ty[0].arr + 2 * a * tx[0].arr), rtol=1e-6, atol=1e-6)


def test_global_cache_clear_empties_the_caches():
    from cmblensing_tpu_torch.ops.factored_deriv import factored_op
    from cmblensing_tpu_torch.ops.nufft import _axis_consts
    tfft.fftsyms(8, 8)
    _axis_consts(16)
    factored_op(512, 0.1, "float32", 4)
    assert all(c.cache_info().currsize for c in (tfft.fftsyms, _axis_consts, factored_op))
    tfft.global_cache_clear()
    assert not any(c.cache_info().currsize for c in (tfft.fftsyms, _axis_consts, factored_op))
    # the caches refill as before
    ireal, iimag, _, _ = tfft.fftsyms(8, 8)
    assert int(ireal.sum() + iimag.sum()) == 64
