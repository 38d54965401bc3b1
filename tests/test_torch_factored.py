"""The port's factored (radix-B) derivative and its factored flows
against the JAX package on the same numpy inputs.

- Blocks and butterflies equal JAX's `_factored_ops` in float64 to 1e-12
  (both are built by the same arithmetic from the same circulant).
- The plain factored apply (what the K1 wrapper runs for a CPU tensor)
  matches JAX's in-kernel `_fact_apply` in a Pallas interpreter kernel
  and the dense circulant: 5e-6 relative max-abs, the bound
  tests/test_deriv.py::test_pallas_factored_inkernel_matches_dense holds
  JAX's factored form to.
- The factored flows (forward, reverse L^-1, adjoint; backward) match
  JAX's `_fa_call` / `_bv_flow` in interpret mode with dense in-kernel
  derivatives, which are the same operator: 1e-5, the bound
  tests/test_deriv.py holds those kernels to against the scan.

The factored kernels take blocks of A = 128 on the card; the plain
version takes any A, so these tests run at 32^2-64^2 with A = 8..32.
The CUDA kernels themselves are held against this plain version on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl

from cmblensing_tpu.core.proj import ProjLambert as JProj
from cmblensing_tpu.ops import deriv as jderiv
from cmblensing_tpu.ops import pallas_lenseflow as plf
from cmblensing_tpu.ops.factored_deriv import _factored_ops as j_factored_ops

import cmblensing_tpu_torch as ct
from cmblensing_tpu_torch.models import lenseflow as tlf
from cmblensing_tpu_torch.ops import deriv as tderiv
from cmblensing_tpu_torch.ops import factored_deriv as tfd
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


def _weak_lensing(N=32, ncomp=2, seed=1):
    """One-mode phi with Hess(phi) ~ 0.1 at every N, and random f, dy
    (as tests/test_torch_flow_kernel.py)."""
    phi_f = np.zeros((1, N, N // 2 + 1), np.complex128)
    phi_f[0, 1, 1] = 1e-3 * (N / 32) ** 4
    phi = np.fft.irfft2(phi_f, s=(N, N)).astype(np.float32)
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((ncomp, N, N)).astype(np.float32)
    dy = rng.standard_normal((ncomp, N, N)).astype(np.float32)
    return phi, f, dy


@pytest.mark.parametrize("B", [2, 4, 8])
def test_factored_blocks_match_jax_f64(B):
    delta = float(JProj(64, 64, thetapix=3, T=np.float64).deltax)
    jop = j_factored_ops(64, delta, "float64", B)[0]
    top = tfd.factored_op(64, delta, "float64", B)
    assert (top.B, top.A) == (jop.B, jop.A)
    pairs = [(top.Rf, jop.Rf), (top.Ri, jop.Ri), (top.Gre, jop.Gre)]
    if B > 2:
        pairs += [(top.Gar, jop.Gar), (top.Gai, jop.Gai)]
    for a, b in pairs:
        assert np.max(np.abs(a - b)) <= 1e-12 * np.max(np.abs(b))
    for transpose in (True, False):
        np.testing.assert_array_equal(top.packed(transpose), plf._pack_factored(jop, transpose))


@pytest.mark.parametrize("B", [2, 4, 8])
def test_factored_apply_matches_jax_in_kernel_and_dense(B):
    N = 64
    tp = ct.ProjLambert(N, N, thetapix=3, T=np.float32, device="cpu")
    delta = float(tp.deltax)
    jop = j_factored_ops(N, delta, "float32", B)[0]
    FXt, FY = jnp.asarray(plf._pack_factored(jop, True)), jnp.asarray(plf._pack_factored(jop, False))
    fmeta = ((B, jop.A, jop.Rf, jop.Ri), (B, jop.A, jop.Rf, jop.Ri))
    x = np.random.default_rng(B).standard_normal((N, N)).astype(np.float32)

    def kern(x_ref, fx_ref, fy_ref, o_ref):
        ddx, ddy = plf._make_dd_any(fx_ref[:], fy_ref[:], "f32", fmeta)
        o_ref[0] = ddx(x_ref[:])
        o_ref[1] = ddy(x_ref[:])

    ref = np.asarray(pl.pallas_call(kern, out_shape=jax.ShapeDtypeStruct((2, N, N), jnp.float32),
                                    interpret=True)(jnp.asarray(x), FXt, FY))
    ops = tfd.factored_ops(tp, B, B)
    xt = torch.as_tensor(x)
    out = [tfd.apply_x(xt, ops.FX, ops.bfx).numpy(), tfd.apply_y(xt, ops.FY, ops.bfy).numpy()]
    DxT, Dy = tderiv.deriv_mats(tp)
    dense = [(xt @ DxT).numpy(), (Dy @ xt).numpy()]
    for o, r, d in zip(out, ref, dense):
        assert rel(o, r) < 5e-6
        assert rel(o, d) < 5e-6


def test_factored_gradhess_matches_dense_and_f64():
    """grad/Hess(phi) through the factored derivative against the dense
    one and a float64 evaluation. The gradient planes agree to f32
    round-off (1e-5); the Hessian planes differentiate the gradient's
    float32 rounding again, which costs ~5e-5 relative here in either
    form: 1e-4 (the gradhess bound chip_smoke.py and the JAX package's
    test_lensing.py use)."""
    phi, _, _ = _weak_lensing(N=64)
    tp = ct.ProjLambert(64, 64, thetapix=3, T=np.float32, device="cpu")
    tp64 = ct.ProjLambert(64, 64, thetapix=3, T=np.float64, device="cpu")
    pt = torch.as_tensor(phi)
    a = lfk.gradhess(pt, tfd.factored_ops(tp, 4, 4)).numpy()
    b = lfk.gradhess(pt, tderiv.deriv_mats(tp)).numpy()
    c = lfk.gradhess(pt.double(), tfd.factored_ops(tp64, 4, 4)).numpy()
    assert a.shape == (5, 64, 64)
    for i in range(5):
        bound = TOL if i < 2 else 1e-4
        assert rel(a[i], b[i]) < bound
        assert rel(a[i], c[i]) < bound


def _flow_inputs(B):
    jp = JProj(32, 32, thetapix=3, T=np.float32)
    tp = ct.ProjLambert(32, 32, thetapix=3, T=np.float32, device="cpu")
    phi, f, dy = _weak_lensing()
    ops = tfd.factored_ops(tp, B, B)
    planes = lfk.gradhess(torch.as_tensor(phi), ops)
    return jp, ops, planes, f, dy


@pytest.mark.parametrize("B", [2, 4])
@pytest.mark.parametrize("kind,t0,t1", [("forward", 0.0, 1.0), ("forward", 1.0, 0.0),
                                        ("adjoint", 1.0, 0.0)])
def test_factored_flow_matches_jax_fa_call_interpret(B, kind, t0, t1):
    """L, L^-1 (forward kind run 1 -> 0) and L^H against the
    component-gridded `_fa_call` on the same phi planes."""
    jp, ops, planes, f, _ = _flow_inputs(B)
    jplanes = tuple(jnp.asarray(p) for p in planes.numpy())
    ref = plf._fa_call(jnp.asarray(f), jplanes, plf._mats_for(jp, np.float32), kind, NSTEPS,
                       t0, t1, "f32", True)
    out = lfk.flow_apply(torch.as_tensor(f), planes, ops, t0, t1, NSTEPS, kind)
    assert rel(out.numpy(), ref) < TOL


@pytest.mark.parametrize("B", [2, 4])
def test_factored_backward_flow_matches_jax_bv_flow_interpret(B):
    jderiv.set_deriv_mode("matmul")
    jp, ops, planes, f, dy = _flow_inputs(B)
    state = jnp.concatenate([jnp.asarray(f), jnp.asarray(dy), jnp.zeros((1, 32, 32), jnp.float32)])
    ref = plf._bv_flow(state, tuple(jnp.asarray(p) for p in planes.numpy()), jp, NSTEPS, 1.0, 0.0,
                       "f32", interpret=True)
    dphi, df0 = lfk.flow_bwd(torch.as_tensor(dy), torch.as_tensor(f), planes, ops, 0., 1., NSTEPS)
    assert dphi.shape == (1, 32, 32) and df0.shape == f.shape
    assert rel(df0.numpy(), ref[2:4]) < TOL
    assert rel(dphi.numpy(), ref[4:]) < TOL


def test_factored_flows_take_the_batch_in_one_call():
    """A batch of (f, phi) pairs through the factored flows equals its
    entries one by one: batch x component rides on the kernels' grid."""
    _, ops, planes, f, dy = _flow_inputs(4)
    planes2 = torch.stack([planes, 0.5 * planes])
    fb = torch.stack([torch.as_tensor(f), torch.as_tensor(dy)])
    out = lfk.flow_apply(fb, planes2, ops, 0., 1., NSTEPS, "adjoint")
    dphi, df0 = lfk.flow_bwd(fb.flip(0), fb, planes2, ops, 0., 1., NSTEPS)
    for i in range(2):
        assert rel(out[i].numpy(), lfk.flow_apply(fb[i], planes2[i], ops, 0., 1., NSTEPS,
                                                  "adjoint").numpy()) < 1e-6
        one = lfk.flow_bwd(fb.flip(0)[i], fb[i], planes2[i], ops, 0., 1., NSTEPS)
        assert rel(dphi[i].numpy(), one[0].numpy()) < 1e-6
        assert rel(df0[i].numpy(), one[1].numpy()) < 1e-6


def test_deriv_ops_radix_rule():
    """A = 128 where N >= 512 and 128 | N, else dense: B = 8 packed
    operands at 1024, B = 4 at 512, dense (DxT, Dy) at 256."""
    assert [tderiv.radix(n) for n in (256, 384, 512, 640, 1024, 2048)] == [1, 1, 4, 5, 8, 16]
    ops = tderiv.deriv_ops(ct.ProjLambert(1024, 1024, thetapix=2, T=np.float32, device="cpu"))
    assert isinstance(ops, tfd.FactoredOps)
    assert ops.FX.shape == ops.FY.shape == (8, 128, 128) and ops.bfx.shape == (2, 8, 8)
    assert ops.FX.dtype == torch.float32
    dense = tderiv.deriv_ops(ct.ProjLambert(256, 256, thetapix=2, T=np.float32, device="cpu"))
    assert isinstance(dense, tuple) and dense[0].shape == (256, 256)


@pytest.mark.parametrize("dtype,bound", [(np.float64, 1e-10), (np.float32, 1e-4)])
def test_kernel_backend_at_512_runs_factored_and_matches_plain(dtype, bound):
    """At 512^2 the 'kernel' backend routes through the factored flows
    (B = 4); on a Cphi-drawn phi and Cf-drawn f its apply and
    phi-gradient agree with the FFT 'plain' backend. In float64 the two
    are one operator (measured 2e-12). In float32 the apply is held to
    1e-4: the backends form grad/Hess phi in two ways whose float32
    values differ by ~1e-4 relative, and the apply inherits 4.6e-5 of
    it against float64 (plain 7.3e-5). The float32 gradient of this
    objective is ill-conditioned in any form (2e-3 from float64 here,
    kernel and plain alike), so it is compared in float64 only."""
    N = 512
    tp = ct.ProjLambert(N, N, thetapix=2, T=dtype, device="cpu")
    rng = np.random.default_rng(3)
    Cl = ct.camb()
    white = lambda n, pol: ct.Field(
        torch.as_tensor(rng.standard_normal((n, N, N)).astype(dtype)), ct.Basis(pol, "map"), tp)
    phi_f = (ct.Cl_to_Cov("I", tp, Cl["total"]["pp"]).sqrt() @ white(1, "I")).to(ct.MAP)
    Cf = ct.Cl_to_Cov("P", tp, Cl["unlensed_scalar"]["EE"], Cl["unlensed_scalar"]["BB"])
    f_f = (Cf.sqrt() @ white(2, "QU")).to(ct.QU_MAP)
    assert isinstance(tderiv.deriv_ops(tp), tfd.FactoredOps)
    out = {}
    for be in ("kernel", "plain"):
        with ct.lenseflow_backend_ctx(be):
            out[be] = [(ct.LenseFlow(phi_f, 2) @ f_f).arr]
            if dtype == np.float64:
                out[be].append(ct.fgrad(lambda p: ct.dot(ct.LenseFlow(p, 2) @ f_f, f_f))(phi_f).arr)
    for a, b in zip(out["kernel"], out["plain"]):
        assert rel(a.numpy(), b.numpy()) < bound


def test_factored_wrapper_rejects_devices_without_a_kernel():
    x = torch.empty((1, 2, 16, 16), device="meta")
    ops = tfd.FactoredOps(*(torch.empty((2, 8, 8), device="meta"),) * 2,
                          *(torch.empty((2, 2, 2), device="meta"),) * 2)
    with pytest.raises(ValueError, match="no LenseFlow kernel"):
        lfk.flow_apply(x, torch.empty((1, 5, 16, 16), device="meta"), ops, 0., 1., 1)
