"""The port's LenseFlow flows against the JAX package on the same numpy
inputs.

- The flow kernel's plain version (dense circulant RK4, what the wrapper
  runs for a CPU tensor) against the JAX Pallas whole-flow kernel in
  interpret mode with matmul derivatives, as tests/test_deriv.py runs
  it, and against the JAX scan: forward, adjoint and backward. 1e-5
  relative max-abs, the bound the JAX package holds its own Pallas
  kernel to against its scan.
- The port's plain backend (FFT scan) against the JAX FFT scan, same
  bound.
- gradcheck of both autograd Functions in float64 at 16^2.

The hand-written CUDA kernel itself is held against its plain version
on the card, in tests/test_torch_cuda.py and chip_smoke.py.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cmblensing_tpu.core.proj import ProjLambert as JProj
from cmblensing_tpu.models import lenseflow as jlf
from cmblensing_tpu.ops import deriv as jderiv
from cmblensing_tpu.ops import pallas_lenseflow as plf

import cmblensing_tpu_torch as ct
from cmblensing_tpu_torch.models import lenseflow as tlf
from cmblensing_tpu_torch.ops import deriv as tderiv
from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk

TOL = 1e-5
NSTEPS = 3


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.fixture(autouse=True)
def _restore_mode():
    yield
    jderiv.set_deriv_mode("auto")


def _weak_lensing(N=32, ncomp=2, dtype=np.float32, seed=1):
    """A weak-lensing phi (one Fourier mode), shape (1, N, N), and random
    f, dy of shape (ncomp, N, N), from numpy. The mode's amplitude scales
    as N^4 so that Hess(phi) stays ~0.1 (and I + t Hess(phi) far from
    singular) at every N; at N = 32 it is the JAX package's own test
    input (tests/test_deriv.py::_weak_lensing_setup)."""
    phi_f = np.zeros((1, N, N // 2 + 1), np.complex128)
    phi_f[0, 1, 1] = 1e-3 * (N / 32) ** 4
    phi = np.fft.irfft2(phi_f, s=(N, N)).astype(dtype)
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((ncomp, N, N)).astype(dtype)
    dy = rng.standard_normal((ncomp, N, N)).astype(dtype)
    return phi, f, dy


def _jax_planes(phi, proj):
    g, h = jlf._gradhess_phi(jnp.asarray(phi), proj)
    return g, h, np.stack([np.asarray(x) for x in (*g, *h)])


def test_gradhess_planes_match_jax_matmul():
    """The kernel path's grad/Hess(phi) planes (first-derivative
    circulants, the Hessian as two products) against JAX's matmul
    derivatives and against a float64 evaluation. JAX's own f32 hyy
    plane, from its dense second-derivative circulant, lies 2.9e-5
    (relative max-abs) from float64 on this one-mode phi; hence 5e-5
    against JAX and 2e-5 against float64."""
    jderiv.set_deriv_mode("matmul")
    phi, _, _ = _weak_lensing()
    _, _, planes_j = _jax_planes(phi, JProj(32, 32, thetapix=3, T=np.float32))
    tp = ct.ProjLambert(32, 32, thetapix=3, T=np.float32, device="cpu")
    tp64 = ct.ProjLambert(32, 32, thetapix=3, T=np.float64, device="cpu")
    planes_t = lfk.gradhess(torch.as_tensor(phi), tderiv.deriv_mats(tp))
    planes_64 = lfk.gradhess(torch.as_tensor(phi.astype(np.float64)),
                             tderiv.deriv_mats(tp64))
    for a, b, c in zip(planes_t.numpy(), planes_j, planes_64.numpy()):
        assert rel(a, b) < 5e-5
        assert rel(a, c) < 2e-5


@pytest.mark.parametrize("kind,t0,t1", [("forward", 0.0, 1.0), ("forward", 1.0, 0.0),
                                        ("adjoint", 1.0, 0.0), ("adjoint", 0.0, 1.0)])
def test_plain_flow_matches_jax_pallas_interpret(kind, t0, t1):
    jderiv.set_deriv_mode("matmul")
    jp = JProj(32, 32, thetapix=3, T=np.float32)
    tp = ct.ProjLambert(32, 32, thetapix=3, T=np.float32, device="cpu")
    phi, f, _ = _weak_lensing()
    g, h, planes = _jax_planes(phi, jp)
    ref = plf.pallas_flow_apply(jnp.asarray(f), g, h, t0, t1, NSTEPS, jp, kind,
                                interpret=True)
    vel = jlf._velocity if kind == "forward" else jlf._velocity_adj
    scan = jlf._rk4(lambda t, y: vel(t, y, g, h, jp), jnp.asarray(f), t0, t1, NSTEPS)
    out = lfk.flow_apply(torch.as_tensor(f), torch.as_tensor(planes), tderiv.deriv_mats(tp),
                         t0, t1, NSTEPS, kind)
    assert rel(out.numpy(), ref) < TOL
    assert rel(out.numpy(), scan) < TOL


def test_plain_backward_flow_matches_jax_pallas_interpret():
    jderiv.set_deriv_mode("matmul")
    jp = JProj(32, 32, thetapix=3, T=np.float32)
    tp = ct.ProjLambert(32, 32, thetapix=3, T=np.float32, device="cpu")
    phi, f, dy = _weak_lensing()
    g, h, planes = _jax_planes(phi, jp)
    dphi_ref, df0_ref = plf.pallas_flow_bwd(jnp.asarray(dy), jnp.asarray(f), g, h, 0., 1.,
                                            NSTEPS, jp, interpret=True)
    dphi_scan, df0_scan = jlf._lenseflow_bwd(0., 1., NSTEPS, jp, "scan", None,
                                             (jnp.asarray(phi), jnp.asarray(f)),
                                             jnp.asarray(dy))
    dphi, df0 = lfk.flow_bwd(torch.as_tensor(dy), torch.as_tensor(f), torch.as_tensor(planes),
                             tderiv.deriv_mats(tp), 0., 1., NSTEPS)
    assert dphi.shape == (1, 32, 32) and df0.shape == f.shape
    assert rel(df0.numpy(), df0_ref) < TOL
    assert rel(dphi.numpy(), dphi_ref) < TOL
    assert rel(df0.numpy(), df0_scan) < TOL
    assert rel(dphi.numpy(), dphi_scan) < TOL


@pytest.mark.parametrize("which", ["forward", "adjoint", "backward"])
def test_plain_backend_matches_jax_fft_scan(which):
    """The port's 'plain' backend (RK4 over FFT derivatives, hoisted
    backward flow) against the JAX scan in fft mode."""
    jderiv.set_deriv_mode("fft")
    jp = JProj(32, 32, thetapix=3, T=np.float32)
    tp = ct.ProjLambert(32, 32, thetapix=3, T=np.float32, device="cpu")
    phi, f, dy = _weak_lensing()
    pj, fj = jnp.asarray(phi), jnp.asarray(f)
    pt, ft = torch.as_tensor(phi), torch.as_tensor(f)
    if which == "backward":
        ref = jlf._lenseflow_bwd(0., 1., NSTEPS, jp, "scan", None, (pj, fj), jnp.asarray(dy))
        out = tlf._bwd(pt, ft, torch.as_tensor(dy), 0., 1., NSTEPS, tp, "plain")
        for a, b in zip(out, ref):
            assert rel(a.numpy(), b) < TOL
        return
    fn = jlf._lenseflow_apply if which == "forward" else jlf._lenseflow_apply_adjoint
    ref = fn(pj, fj, 0., 1., NSTEPS, jp, "scan")
    out = tlf._apply(pt, ft, 0., 1., NSTEPS, tp, "plain", kind=which)
    assert rel(out.numpy(), ref) < TOL


@pytest.mark.parametrize("backend", ["kernel", "plain"])
@pytest.mark.parametrize("fn", ["apply", "adjoint"])
def test_autograd_functions_gradcheck_f64(backend, fn):
    """The continuous-adjoint VJPs against finite differences, in
    float64 at 16^2. phi is checked in units of PHI_SCALE: a per-pixel
    step of gradcheck's eps in phi itself would move Hess(phi) by
    eps * l^2 ~ 10, far outside the linear regime. The transpose-delta
    flow is the adjoint of the ODE, not of its RK4 discretization; at
    this weak lensing and nsteps=7 the two differ well below rtol."""
    PHI_SCALE = 1e-6
    tp = ct.ProjLambert(16, 16, thetapix=3, T=np.float64, device="cpu")
    phi, f, _ = _weak_lensing(N=16, dtype=np.float64, seed=5)
    x = torch.as_tensor(phi / PHI_SCALE).requires_grad_(True)
    f = torch.as_tensor(f).requires_grad_(True)
    F = tlf._LenseflowApply if fn == "apply" else tlf._LenseflowApplyAdjoint
    assert torch.autograd.gradcheck(
        lambda x, f: F.apply(x * PHI_SCALE, f, 0., 1., 7, tp, backend, "f32"),
        (x, f), eps=1e-6, atol=1e-6, rtol=1e-4, fast_mode=True)


def test_wrapper_rejects_devices_without_a_kernel():
    x = torch.empty((2, 16, 16), device="meta")
    with pytest.raises(ValueError, match="no LenseFlow kernel"):
        lfk.flow_apply(x, torch.empty((5, 16, 16), device="meta"), (x[0], x[0]), 0., 1., 1)


@pytest.fixture(scope="module")
def lensing_64():
    """A Cphi-drawn phi and Cf-drawn f, g (pol P) at 64^2 from numpy."""
    tp = ct.ProjLambert(64, 64, thetapix=3, T=np.float32, device="cpu")
    rng = np.random.default_rng(7)
    Cl = ct.camb()
    Cphi = ct.Cl_to_Cov("I", tp, Cl["total"]["pp"])
    Cf = ct.Cl_to_Cov("P", tp, Cl["unlensed_scalar"]["EE"], Cl["unlensed_scalar"]["BB"])
    white = lambda n, pol: ct.Field(
        torch.as_tensor(rng.standard_normal((n, 64, 64)).astype(np.float32)),
        ct.Basis(pol, "map"), tp)
    phi = (Cphi.sqrt() @ white(1, "I")).to(ct.MAP)
    f = (Cf.sqrt() @ white(2, "QU")).to(ct.QU_MAP)
    g = (Cf.sqrt() @ white(2, "QU")).to(ct.QU_MAP)
    return phi, f, g


@pytest.mark.parametrize("backend", ["kernel", "plain"])
def test_lenseflow_adjoint_and_inverse_identities(lensing_64, backend):
    """<g, L f> = <L^H g, f> and L^-1 L f = f, the reference's own
    LenseFlow checks (tests/test_lensing.py), to 1e-4 as there."""
    phi, f, g = lensing_64
    L = ct.LenseFlow(phi, 7)
    with ct.lenseflow_backend_ctx(backend):
        lhs = float(ct.dot(g, L @ f))
        rhs = float(ct.dot(L.H @ g, f))
        assert abs(lhs - rhs) < 1e-4 * abs(lhs)
        assert float(ct.norm(L.solve(L @ f) - f) / ct.norm(f)) < 1e-4
        assert float(ct.norm(L.H.solve(L.H @ f) - f) / ct.norm(f)) < 1e-4


def test_batched_field_flows_each_entry(lensing_64):
    """A batch of fields under one phi flows entry by entry, and the
    phi-gradient sums over the batch."""
    phi, f, g = lensing_64
    fb = ct.Field(torch.stack([f.arr, g.arr]), f.basis, f.proj)
    out = ct.LenseFlow(phi, 3) @ fb
    for i, x in enumerate((f, g)):
        assert rel(out.arr[i].numpy(), (ct.LenseFlow(phi, 3) @ x).arr.numpy()) < 1e-6
    gb = ct.fgrad(lambda p: ct.dot(ct.LenseFlow(p, 3) @ fb, fb).sum())(phi)
    gs = sum(ct.fgrad(lambda p: ct.dot(ct.LenseFlow(p, 3) @ x, x))(phi).arr for x in (f, g))
    assert rel(gb.arr.numpy(), gs.numpy()) < 1e-5
