"""What the port needs to run MAP_joint above 1024^2: the radix rule, the
grid line search's memory guard and `get_Cl`, against the JAX package
where it has a counterpart.

- `radix` returns only radices the factored kernels are built for; any
  other plane side takes the dense circulant, which takes any size. A
  640^2 `load_sim` (radix 5 before, which the factored form refused) runs
  `L @ f` on the default backend: against JAX's LenseFlow on the same
  arrays, and against the port's plain (FFT) backend, within 5e-5
  relative max-abs. Both float32 forms lie 1.7e-5 to 1.9e-5 from a
  float64 evaluation there (measured), so the 1e-5 flow bound of the
  smaller tests cannot hold at this size in float32 for any form; in
  float64 the dense kernel form and the FFT form are one operator (1e-10;
  measured 3.5e-14).
- The chunked grid line search gives the dlps of the single batch bit for
  bit on the CPU (every chunk is the same batched computation, alpha = 0
  row 0 of the first), at 32^2 P with a forced chunk of 5.
- The chunk rule at 2048^2 and 4096^2 for given budgets, and the
  CMBL_LINESEARCH_CHUNK override.
- `get_Cl` of a 64^2 field, of a cross-spectrum and of an E component
  against JAX's at 1e-5 relative.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cmblensing_tpu.core.basis import Basis as JBasis
from cmblensing_tpu.core.field import Field as JField
from cmblensing_tpu.core.proj import ProjLambert as JProj
from cmblensing_tpu.models.lenseflow import LenseFlow as JLenseFlow
from cmblensing_tpu.utils.spectra import get_Cl as j_get_Cl

import cmblensing_tpu_torch as ct
from cmblensing_tpu_torch.inference import maximization as tm
from cmblensing_tpu_torch.ops import deriv as tderiv
from cmblensing_tpu_torch.ops import factored_deriv as tfd
from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
from cmblensing_tpu_torch.utils.spectra import bandpower_corr, get_Cl
from test_torch_map import P32  # noqa: F401  (a fixture)

FLOW640_TOL = 5e-5


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    ct.set_lenseflow_backend("kernel")


# =========================================================================
# the radix rule
# =========================================================================

def test_radix_returns_only_built_radices():
    """Every plane side from 128 to 8192: radix 1 (dense) or a built
    radix, n = B * 128; the wrapper's check refuses an unbuilt one."""
    for n in range(64, 8193, 64):
        B = tderiv.radix(n)
        assert B == 1 or (B in tderiv.BUILT_RADICES and n == B * tderiv.FACTOR_A), (n, B)
    assert [n for n in range(64, 8193, 64) if tderiv.radix(n) > 1] == [512, 1024, 2048, 4096]
    ops = tfd.factored_ops(ct.ProjLambert(256, 256, thetapix=2, T=np.float32, device="cpu"), 2, 2)
    with pytest.raises(ValueError, match="built for"):
        lfk._check_factored("lf_fderiv", ops, 256, 256)
    assert lfk._check_factored("lf_fderiv", ops._replace(
        FX=torch.empty((32, 128, 128)), FY=torch.empty((16, 128, 128))), 2048, 4096) == (32, 16)


def test_L_at_640_runs_the_default_backend_and_matches_jax_and_plain():
    """A 640^2 P load_sim: L @ f on the default ("kernel") backend takes
    the dense circulant (radix 5 is not built) and matches JAX's LenseFlow
    on the same arrays and the port's plain backend (FLOW640_TOL; see the
    module docstring); in float64 the kernel and plain backends agree to
    1e-10."""
    sim = ct.load_sim(thetapix=2, Nside=640, pol="P", T=np.float32, seed=0, device="cpu")
    phi, f = sim["phi"].to(ct.MAP), sim["f"].to(ct.QU_MAP)
    assert tderiv.radix(640) == 1 and isinstance(tderiv.deriv_ops(phi.proj), tuple)
    lfk.reset_launches()
    k = (sim["ds"].L(phi) @ f).to(ct.QU_MAP).arr
    with ct.lenseflow_backend_ctx("plain"):
        p = (sim["ds"].L(phi) @ f).to(ct.QU_MAP).arr
    jp = JProj(640, 640, thetapix=2, T=np.float32)
    jphi = JField(jnp.asarray(phi.arr.numpy()), JBasis("I", "map"), jp)
    jf = JField(jnp.asarray(f.arr.numpy()), JBasis("QU", "map"), jp)
    j = np.asarray((JLenseFlow(jphi, 7) @ jf).to(JBasis("QU", "map")).arr)
    assert k.shape == (2, 640, 640) and torch.isfinite(k).all()
    assert rel(k.numpy(), j) < FLOW640_TOL
    assert rel(k.numpy(), p.numpy()) < FLOW640_TOL
    p64 = ct.ProjLambert(640, 640, thetapix=2, T=np.float64, device="cpu")
    phi64, f64 = ct.Field(phi.arr.double(), ct.MAP, p64), ct.Field(f.arr.double(), ct.QU_MAP, p64)
    out = {}
    for be in ("kernel", "plain"):
        with ct.lenseflow_backend_ctx(be):
            out[be] = (ct.LenseFlow(phi64, 7) @ f64).to(ct.QU_MAP).arr.numpy()
    assert rel(out["kernel"], out["plain"]) < 1e-10


# =========================================================================
# the grid line search's memory guard
# =========================================================================

def test_chunked_linesearch_matches_one_batch_bit_for_bit(P32, monkeypatch):
    """Chunks of 5 trials (4 of them, the last padded with alpha = 0)
    give the dlps of the single batch of 17, bit for bit on the CPU, and
    the same alphas; CMBL_LINESEARCH_CHUNK forces the same chunks."""
    ds = P32["tds"].replace(G=ct.Id)
    f, _ = ct.argmaxf_logpdf(ds, phi=P32["tphi"],
                             conjgrad_kwargs=dict(tol=0.0, nsteps=5, fixed_iters=True,
                                                  hessian_precision=None))
    with torch.no_grad():
        f_mix, phi_mix, g = tm._phi_grad_and_fmix(ds, {}, f, P32["tphi"])
        dphi = tm.hessian_phimix_preconditioner(ds).pinv() @ g
        a1, d1 = tm._grid_linesearch_dlps(ds, {}, f_mix, phi_mix, dphi, 2.0, 16)
        a5, d5 = tm._grid_linesearch_dlps(ds, {}, f_mix, phi_mix, dphi, 2.0, 16, chunk=5)
        monkeypatch.setenv("CMBL_LINESEARCH_CHUNK", "5")
        assert tm._linesearch_chunk(phi_mix, 16) == 5
        ae, de = tm._grid_linesearch_dlps(ds, {}, f_mix, phi_mix, dphi, 2.0, 16)
    assert d1.shape == (17,) and d1[0] == 0 and torch.isfinite(d1).all()
    assert torch.equal(a1, a5) and torch.equal(d1, d5) and torch.equal(d1, de)
    assert float(d1.max()) > 0


@pytest.mark.parametrize("N,budget,chunk", [
    (1024, 40 * 2 ** 30, 16),   # 17 trials of 40 planes of 4 MiB: one batch
    (2048, 40 * 2 ** 30, 16),   # 17 x 640 MiB = 10.6 GiB: one batch
    (4096, 40 * 2 ** 30, 16),   # 2.5 GiB a trial, 16 fit: one batch of 17, as JAX's rule
    (4096, 32 * 2 ** 30, 9),    # 12 fit in 32 GiB: two batches of 9 (one padded trial)
    (4096, 8 * 2 ** 30, 3),     # the JAX package's v5e budget: 3 fit, six batches of 3
    (4096, 2 ** 30, 1),         # less than a trial
    (2048, 8 * 2 ** 30, 9),     # 640 MiB a trial, 12 fit: two batches of 9
])
def test_linesearch_chunk_rule(N, budget, chunk, monkeypatch):
    """ngrid (one batch of all ngrid + 1 trials) while ngrid trials of
    LINESEARCH_PLANES_PER_TRIAL float32 planes fit the budget (JAX's
    rule: the one extra trial rather than a second batch), else the
    fewest batches of at most as many as fit, evened out; at least 1; no
    limit off the card; CMBL_LINESEARCH_CHUNK overrides it."""
    monkeypatch.delenv("CMBL_LINESEARCH_CHUNK", raising=False)
    monkeypatch.setattr(tm, "LINESEARCH_PLANES_PER_TRIAL", 40)
    proj = ct.ProjLambert(N, N, thetapix=2, T=np.float32, device="meta")
    phi_mix = ct.Field(torch.empty((1, N, N), device="meta"), ct.MAP, proj)
    assert tm._linesearch_chunk(phi_mix, 16, budget) == chunk
    assert tm.linesearch_budget("cpu") is None
    cpu = ct.Field(torch.empty((1, 32, 32)), ct.MAP,
                   ct.ProjLambert(32, 32, thetapix=2, T=np.float32, device="cpu"))
    assert tm._linesearch_chunk(cpu, 16) == 16
    monkeypatch.setenv("CMBL_LINESEARCH_CHUNK", "7")
    assert tm._linesearch_chunk(phi_mix, 16, budget) == 7


# =========================================================================
# get_Cl
# =========================================================================

def _fields(seed=5):
    """A 64^2 spin-0 map, a second one correlated with it, and a QU map,
    as port and JAX fields on the same numpy arrays."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((1, 64, 64)).astype(np.float32)
    b = (0.6 * a + rng.standard_normal((1, 64, 64))).astype(np.float32)
    qu = rng.standard_normal((2, 64, 64)).astype(np.float32)
    tp = ct.ProjLambert(64, 64, thetapix=3, T=np.float32, device="cpu")
    jp = JProj(64, 64, thetapix=3, T=np.float32)
    t = lambda x, pol: ct.Field(torch.as_tensor(x), ct.Basis(pol, "map"), tp)
    j = lambda x, pol: JField(jnp.asarray(x), JBasis(pol, "map"), jp)
    return (t(a, "I"), t(b, "I"), t(qu, "QU")), (j(a, "I"), j(b, "I"), j(qu, "QU"))


@pytest.mark.parametrize("case", ["auto", "cross", "E", "ledges", "err"])
def test_get_Cl_matches_jax(case):
    (ta, tb, tqu), (ja, jb, jqu) = _fields()
    ledges = np.array([2, 100, 200, 350, 500, 750, 1000, 1500, 2000, 3000, 4500, 6000])
    args = {"auto": ((ta,), (ja,), {}), "cross": ((ta, tb), (ja, jb), {}),
            "E": ((tqu["E"],), (jqu["E"],), {}), "ledges": ((ta, tb), (ja, jb), {"ledges": ledges}),
            "err": ((ta,), (ja,), {"err_estimate": True, "dl": 100})}[case]
    t, j = get_Cl(*args[0], **args[2]), j_get_Cl(*args[1], **args[2])
    if case == "err":
        (t, ts), (j, js) = t, j
        ok = np.isfinite(js)   # empty bins have no spectrum and no error estimate
        np.testing.assert_array_equal(np.isfinite(ts), ok)
        assert ok.sum() > 3 and rel(ts[ok], js[ok]) < 1e-5
    assert t.ell.shape == j.ell.shape and t.ell.size > 3
    assert rel(t.ell, j.ell) < 1e-5 and rel(t.Cl, j.Cl) < 1e-5


def test_bandpower_corr_of_a_field_with_itself_is_one():
    (ta, tb, _), _ = _fields()
    ledges = np.array([2, 500, 1500, 3000, 6000])
    ell, rho = bandpower_corr(ta, ta, ledges)
    assert ell.shape == rho.shape == (4,) and np.allclose(rho, 1.0)
    _, rho_ab = bandpower_corr(ta, tb, ledges)
    assert np.all((rho_ab > 0.2) & (rho_ab < 0.9))
