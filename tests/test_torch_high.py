"""The 'high' precision tier and the JAX package's "auto" defaults, held
to the JAX package on the same numpy inputs.

'high' is the JAX package's bf16 head/residual split (`_mk_dot('high')`,
`_make_ddx_ddy` 'high' in cmblensing_tpu/ops/pallas_lenseflow.py): each
operand rounded to a bf16 head and a bf16 residual, three products (the
residual x residual one dropped), each exact in float32 and summed in
float32. Run in a Pallas interpreter kernel it really rounds to bf16, so
the port's plain 'high' versions (what the kernel wrappers run for a CPU
tensor) are held to those kernels. JAX's own MAP_joint and
argmaxf_logpdf on the CPU take the scan integrator, where 'high' changes
nothing: there the port's 'high' is held to JAX's strict result within
the operator error the split adds.

Tolerances, relative max-abs unless said, each with its reason at the
test: the split operands are the same bf16 values on both sides, so the
derivatives and flows differ only by float32 summation order, except
where a value that differs in its last bit between the two orders rounds
its bf16 head the other way (a change of ~2^-17 of that value). At radix
16 and 32 the interpreted kernels unroll B^2 butterfly terms a derivative
and take minutes, so those cases hold the port to the JAX package's plain
XLA forms: the derivative body run as XLA (`_jax_dd_xla`, the same
function and values), and the flows against its strict LenseFlow scan at
that radix (`_jax_xla_flow`), 'high' within the split's operator error.

The CUDA kernels themselves are held to these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 9).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl

from cmblensing_tpu.core.proj import ProjLambert as JProj
from cmblensing_tpu.inference import maximization as jm
from cmblensing_tpu.ops import deriv as jderiv
from cmblensing_tpu.ops import pallas_lenseflow as plf
from cmblensing_tpu.ops.factored_deriv import _factored_ops as j_factored_ops

import cmblensing_tpu_torch as ct
from cmblensing_tpu_torch.inference import maximization as tm
from cmblensing_tpu_torch.models import lenseflow as tlf
from cmblensing_tpu_torch.ops import deriv as tderiv
from cmblensing_tpu_torch.ops import factored_deriv as tfd
from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
from test_torch_map import P32, _carry  # noqa: F401  (P32 is a fixture)

NSTEPS = 3
# the plain 'high' derivative against JAX's 'high' Pallas body on the
# same operands: the same bf16 products, summed in another order; where
# the butterfly's weights are not 0 and +-1 (B = 8) XLA may fuse its
# multiply-adds, a butterflied value then differs in its last bit and may
# round its bf16 head the other way (measured 1.1e-6 at B = 8)
DERIV_TOL = 2e-6
# a 'high' flow against JAX's: nsteps RK4 stages of such derivatives
# (measured 2.6e-7 to 8.9e-7), the bound of the strict flows
FLOW_TOL = 1e-5
# 'high' against strict: the split's operator error, ~2^-17 relative per
# product term, summed over the contraction (measured 1.5e-6 to 1.1e-5)
HIGH_VS_STRICT = 1e-4


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.fixture(autouse=True)
def _restore_modes():
    """One torch thread per test (tensors of 32^2-64^2 are too small to
    share among threads, which only contend with a parallel run's other
    workers); the modes these tests set, restored."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jderiv.set_deriv_mode("auto")
    tderiv.set_matmul_precision("f32")
    ct.set_lenseflow_backend("kernel")


def _weak_lensing(N=32, ncomp=2, seed=1):
    """One-mode phi with Hess(phi) ~ 0.1 at every N, random f and dy (as
    tests/test_torch_flow_kernel.py)."""
    phi_f = np.zeros((1, N, N // 2 + 1), np.complex128)
    phi_f[0, 1, 1] = 1e-3 * (N / 32) ** 4
    phi = np.fft.irfft2(phi_f, s=(N, N)).astype(np.float32)
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((ncomp, N, N)).astype(np.float32)
    dy = rng.standard_normal((ncomp, N, N)).astype(np.float32)
    return phi, f, dy


def _jax_xla_flow(kind, f, planes, N, B, t0, t1, nsteps, monkeypatch, dy=None):
    """The JAX package's plain XLA form of a flow at radix B: its LenseFlow
    scan (models/lenseflow.py: `_rk4` over `_velocity` or `_velocity_adj`
    from t0 to t1, or `_backward_flow_scan` from t1 back to t0) under the
    "factored" derivative mode at radix B (CMBL_RADIX_B; at B >= 16
    ops/factored_deriv.py::_apply_factored_batched), strict float32 XLA,
    on the port's phi planes. The radix-16 and 32 cases are held to it:
    the interpreted Pallas kernels unroll B^2 butterfly terms a
    derivative and take minutes there (radix 2 to 8 stay interpreted).
    Returns the flow's output, or (dphi, df0) for "backward"."""
    from cmblensing_tpu.models import lenseflow as jlf
    monkeypatch.setenv("CMBL_RADIX_B", str(B))
    jp = JProj(N, N, thetapix=3, T=np.float32)
    p = [jnp.asarray(x) for x in np.asarray(planes)]
    g, h = tuple(p[:2]), tuple(p[2:])
    with jderiv.mode_ctx("factored"), jderiv.precision_ctx("f32"):
        if kind == "backward":
            df0, dphi = jax.jit(lambda a, b: jlf._backward_flow_scan(a, b, g, h, jp, t1, t0,
                                                                     nsteps))(
                jnp.asarray(f), jnp.asarray(dy))
            return np.asarray(dphi), np.asarray(df0)
        vel = jlf._velocity if kind == "forward" else jlf._velocity_adj
        return np.asarray(jax.jit(lambda y: jlf._rk4(lambda t, s: vel(t, s, g, h, jp), y, t0, t1,
                                                     nsteps, jp))(jnp.asarray(f)))


def _jax_dd_xla(x, jm_, fmeta, precision):
    """JAX's in-kernel derivative body (`_make_dd_any`) run as plain XLA
    under jax.jit, not in a Pallas interpreter: the same jnp function,
    the same values, in seconds where the interpreter takes a minute at
    radix 32. (d/dx x, d/dy x)."""
    fn = jax.jit(lambda a, fx, fy: tuple(d(a) for d in plf._make_dd_any(fx, fy, precision, fmeta)))
    return np.asarray(jnp.stack(fn(jnp.asarray(x), *jm_)))


def _jax_factored(N, B):
    """JAX's packed factored operands (FXt, FY) and butterfly metadata at
    radix B along both axes of an N^2 projection of thetapix 3."""
    delta = float(JProj(N, N, thetapix=3, T=np.float32).deltax)
    jop = j_factored_ops(N, delta, "float32", B)[0]
    fmeta = ((B, jop.A, jop.Rf, jop.Ri), (B, jop.A, jop.Rf, jop.Ri))
    return (jnp.asarray(plf._pack_factored(jop, True)),
            jnp.asarray(plf._pack_factored(jop, False))), fmeta


# =========================================================================
# the derivative products (K1 'high' and the dense 'high')
# =========================================================================

@pytest.mark.parametrize("form", ["dense", 2, 4, 8, 16, 32])
def test_high_derivatives_match_jax_high_in_kernel(form):
    """d/dx, d/dy at 'high' (`dot_high` and the factored apply at radix
    B, or the dense split product) against JAX's 'high' body in a Pallas
    interpreter kernel, at 64^2 on white noise: DERIV_TOL; at radix 16 and
    32 the same body run as XLA (`_jax_dd_xla`). Against strict,
    HIGH_VS_STRICT."""
    N = 64
    tp = ct.ProjLambert(N, N, thetapix=3, T=np.float32, device="cpu")
    if form == "dense":
        mats = tderiv.deriv_mats(tp)
        jm_, fmeta = tuple(jnp.asarray(m.numpy()) for m in mats), None
    else:
        mats = tfd.factored_ops(tp, form, form)
        jm_, fmeta = _jax_factored(N, form)
    x = np.random.default_rng(7).standard_normal((N, N)).astype(np.float32)

    def kern(x_ref, fx_ref, fy_ref, o_ref):
        ddx, ddy = plf._make_dd_any(fx_ref[:], fy_ref[:], "high", fmeta)
        o_ref[0] = ddx(x_ref[:])
        o_ref[1] = ddy(x_ref[:])

    if form in (16, 32):
        ref = _jax_dd_xla(x, jm_, fmeta, "high")
    else:
        ref = np.asarray(pl.pallas_call(
            kern, out_shape=jax.ShapeDtypeStruct((2, N, N), jnp.float32),
            interpret=True)(jnp.asarray(x), *jm_))
    xt = torch.as_tensor(x)
    high, strict = tderiv.ddx_ddy(mats, "high"), tderiv.ddx_ddy(mats)
    for d, hi, st in zip(ref, high, strict):
        assert rel(hi(xt).numpy(), d) < DERIV_TOL
        assert rel(hi(xt).numpy(), st(xt).numpy()) < HIGH_VS_STRICT


def test_dot_high_is_the_three_product_split():
    """dot_high forms ah bh + ah bl + al bh from round-to-nearest-even bf16
    heads and residuals: exactly the float64 sum of those three products
    up to float32 rounding of the sums, and within 2^-16 of the float64
    product of the float32 operands (the dropped al bl term and the
    residuals' rounding)."""
    rng = np.random.default_rng(3)
    M = torch.as_tensor(rng.standard_normal((16, 16)).astype(np.float32))
    v = torch.as_tensor(rng.standard_normal((16, 8)).astype(np.float32))
    h, l = tfd.split_bf16(v)
    assert h.dtype == l.dtype == torch.bfloat16
    assert torch.equal(h, v.to(torch.bfloat16))
    assert torch.equal(l, (v - h.float()).to(torch.bfloat16))
    (Mh, Ml), (vh, vl) = (tuple(t.double() for t in tfd.split_bf16(a)) for a in (M, v))
    three = Mh @ vh + Ml @ vh + Mh @ vl
    out = tfd.dot_high(M, v, False).double()
    assert float((out - three).abs().max()) < 1e-6 * float(three.abs().max())
    exact = M.double() @ v.double()
    assert float((out - exact).abs().max()) < 2.0 ** -16 * float((M.abs() @ v.abs()).max())
    right = tfd.dot_high(M.T, v.T, True).T.double()   # v^T M^T, the same three products
    assert float((right - out).abs().max()) < 1e-6 * float(three.abs().max())


def test_factored_ops_carry_the_split_blocks():
    """FactoredOps splits FX and FYT once per operator, as the kernels read
    them: (2, B, A, A) bfloat16 [head, residual]."""
    tp = ct.ProjLambert(64, 64, thetapix=3, T=np.float32, device="cpu")
    ops = tfd.factored_ops(tp, 4, 4)
    assert ops.FXS.shape == (2, 4, 16, 16) and ops.FXS.dtype == torch.bfloat16
    for split, blocks in ((ops.FXS, ops.FX), (ops.FYTS, ops.FYT)):
        assert torch.equal(split[0], blocks.to(torch.bfloat16))
        assert torch.equal(split[1], (blocks - split[0].float()).to(torch.bfloat16))
    assert tfd.factored_ops(tp, 4, 4) is ops


# the Frobenius ratio chip_smoke.py and tests/test_torch_cuda.py hold each
# 'high' kernel's output planes to: distance to the plain 'high' version
# over distance to strict FP32
HIGH_SPLIT_RATIO = 0.5


def _trunc_bf16(v):
    return (v.view(torch.int32) & ~0xFFFF).view(torch.float32).to(torch.bfloat16)


def _split_trunc(v):
    h = _trunc_bf16(v)
    return h, _trunc_bf16(v - h.float())


def _split_no_residual(v):
    h = v.to(torch.bfloat16)
    return h, torch.zeros_like(h)


@pytest.mark.parametrize("variant", ["butterfly_in_float64", "truncating_split",
                                     "operand_residual_dropped"])
@pytest.mark.parametrize("N", [512, 1024])
def test_split_ratio_tells_the_rne_split_apart(N, variant):
    """What the on-card ratio bound separates, on the CPU: a factored d_x
    at 'high' whose butterfly sums in another order (float64, rounded
    once), as the kernel's does, lies far nearer the plain 'high' version
    than the strict product (its bf16 splits differ only where a channel
    value moved by an ulp rounds its residual the other way); a split
    truncated instead of rounded to nearest even, or one without the
    operand's residual, lies as far from plain 'high' as from strict
    (ratio about 1), and strict FP32 is at distance 0 from strict."""
    tp = ct.ProjLambert(N, N, thetapix=2, T=np.float32, device="cpu")
    ops = tderiv.deriv_ops(tp)
    B, A = ops.FX.shape[0], ops.FX.shape[-1]
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((1, N, N)).astype(np.float32))
    split = {"truncating_split": _split_trunc,
             "operand_residual_dropped": _split_no_residual}.get(variant, tfd.split_bf16)
    wide = torch.float64 if variant == "butterfly_in_float64" else torch.float32
    xr = x.reshape(1, N, B, A)
    u = [c.float() for c in tfd._butterfly([xr[..., r, :].to(wide) for r in range(B)],
                                           ops.bfx[0].to(wide))]

    def dot(Mp, v):
        (Mh, Ml), (vh, vl) = (tuple(t.float() for t in s) for s in (Mp[1], split(v)))
        return (vh @ Mh + vh @ Ml) + vl @ Mh

    y = tfd._blocks(u, [(ops.FX[c], (ops.FXS[0, c], ops.FXS[1, c])) for c in range(B)], dot)
    v = torch.stack(tfd._butterfly(y, ops.bfx[1]), dim=-2).reshape(x.shape)
    fro = lambda a, b: float((a.double() - b.double()).norm() / b.double().norm())
    plain = tfd.apply_x(x, ops.FX, ops.bfx, ops.FXS)
    strict = tfd.apply_x(x, ops.FX, ops.bfx)
    assert fro(plain, strict) > 0
    ratio = fro(v, plain) / fro(v, strict)
    if variant == "butterfly_in_float64":
        assert 0 < ratio < HIGH_SPLIT_RATIO / 2, ratio     # 0.09 (512^2), 0.14 (1024^2)
    else:
        assert ratio > 1.8 * HIGH_SPLIT_RATIO, ratio       # 1.00 to 1.07


# =========================================================================
# the flows (K3, K4, K2 dense) at 'high'
# =========================================================================

def _planes(phi, mats):
    return lfk.gradhess(torch.as_tensor(phi), mats)


_FA_KINDS = [("forward", 0.0, 1.0), ("forward", 1.0, 0.0), ("adjoint", 1.0, 0.0),
             ("adjoint", 0.0, 1.0)]


def _radix_case(B):
    """(N, ncomp, nsteps) of a flow test at radix B: radix 16 and 32 at
    64^2 (A = 4, 2) on one component and one RK4 step, since the
    interpreted kernels unroll B^2 butterfly terms a derivative."""
    return (64, 1, 1) if B > 8 else (32, 2, NSTEPS)


# every kind at radix 2 and 4; L and L^H at radix 16, L at radix 32 (whose
# interpreted kernel takes a minute on a loaded CPU; its adjoint role is
# held strict in tests/test_torch_factored.py)
@pytest.mark.parametrize("kind,t0,t1,B", [(*k, B) for B in (2, 4) for k in _FA_KINDS]
                         + [(*k, 16) for k in (_FA_KINDS[0], _FA_KINDS[2])]
                         + [(*_FA_KINDS[0], 32)])
def test_high_fa_flows_match_jax_fa_call_interpret(B, kind, t0, t1, monkeypatch):
    """K3's plain 'high' flows (L, L^-1; L^H and its inverse) against
    `_fa_call(..., "high", interpret=True)` with the factored in-kernel
    derivatives, on the same phi planes: FLOW_TOL. At radix 16 and 32
    against the JAX package's plain XLA flow at that radix
    (`_jax_xla_flow`), which is strict on the CPU: the plain 'high' flow
    within HIGH_VS_STRICT of it, the plain strict flow within FLOW_TOL
    (the 'high' rounding itself held at radix 2 and 4 here, and at 16
    and 32 in the derivative test above)."""
    N, ncomp, nsteps = _radix_case(B)
    tp = ct.ProjLambert(N, N, thetapix=3, T=np.float32, device="cpu")
    ops = tfd.factored_ops(tp, B, B)
    phi, f, _ = _weak_lensing(N, ncomp)
    planes = _planes(phi, ops)
    out = lfk.flow_apply(torch.as_tensor(f), planes, ops, t0, t1, nsteps, kind, "high")
    strict = lfk.flow_apply(torch.as_tensor(f), planes, ops, t0, t1, nsteps, kind)
    if B > 8:
        ref = _jax_xla_flow(kind, f, planes, N, B, t0, t1, nsteps, monkeypatch)
        assert rel(out.numpy(), ref) < HIGH_VS_STRICT
        assert rel(strict.numpy(), ref) < FLOW_TOL
    else:
        fmats, fmeta = _jax_factored(N, B)
        monkeypatch.setattr(plf, "_fmeta_from_key", lambda fkey: fmeta)
        ref = plf._fa_call(jnp.asarray(f), tuple(jnp.asarray(p) for p in planes.numpy()), fmats,
                           kind, nsteps, t0, t1, "high", True, ("high", B))
        assert rel(out.numpy(), ref) < FLOW_TOL
    assert rel(out.numpy(), strict.numpy()) < HIGH_VS_STRICT


def test_high_backward_flow_matches_jax_bv_flow_interpret(monkeypatch):
    """K4's plain 'high' backward flow against `_bv_flow(..., "high",
    interpret=True)` with the factored in-kernel derivatives: delta f to
    FLOW_TOL. delta phi to DPHI_TOL: JAX applies its three delta-phi
    derivatives after the loop as XLA products, which run strict on the
    CPU ('high' changes nothing there), the port at 'high' as the TPU
    runs them; the three strict-vs-'high' products of the accumulated
    integrands differ by the split's operator error (measured 2.3e-6).
    Radix 4 (a complex channel pair), one RK4 step: JAX interprets one
    kernel per stage."""
    DPHI_TOL = 2e-5
    B, nsteps = 4, 1
    jderiv.set_deriv_mode("matmul")
    fmats, fmeta = _jax_factored(32, B)
    monkeypatch.setattr(plf, "_fmats_for", lambda proj, dtype: (fmats, fmeta))
    monkeypatch.setattr(plf, "_fmeta_from_key", lambda fkey: fmeta)
    jp = JProj(32, 32, thetapix=3, T=np.float32)
    tp = ct.ProjLambert(32, 32, thetapix=3, T=np.float32, device="cpu")
    ops = tfd.factored_ops(tp, B, B)
    phi, f, dy = _weak_lensing()
    planes = _planes(phi, ops)
    state = jnp.concatenate([jnp.asarray(f), jnp.asarray(dy), jnp.zeros((1, 32, 32), jnp.float32)])
    ref = plf._bv_flow(state, tuple(jnp.asarray(p) for p in planes.numpy()), jp, nsteps, 1.0, 0.0,
                       "high", interpret=True)
    dphi, df0 = lfk.flow_bwd(torch.as_tensor(dy), torch.as_tensor(f), planes, ops, 0., 1., nsteps,
                             "high")
    assert rel(df0.numpy(), ref[2:4]) < FLOW_TOL
    assert rel(dphi.numpy(), ref[4:]) < DPHI_TOL


@pytest.mark.parametrize("B", [16, 32])
def test_high_backward_flow_matches_jax_bv_flow_interpret_at_radix_16_and_32(B, monkeypatch):
    """The plain 'high' backward flow at radix 16 and 32 (64^2, A = 4 and
    2), on one component, against the JAX package's plain XLA backward
    flow at that radix (`_jax_xla_flow`, strict on the CPU): delta f and
    delta phi within HIGH_VS_STRICT; the plain strict backward flow
    within FLOW_TOL of it (the interpreted `_bv_flow` at 'high' is held
    at radix 4 above)."""
    N, ncomp, nsteps = _radix_case(B)
    ops = tfd.factored_ops(ct.ProjLambert(N, N, thetapix=3, T=np.float32, device="cpu"), B, B)
    phi, f, dy = _weak_lensing(N, ncomp)
    planes = _planes(phi, ops)
    rdphi, rdf0 = _jax_xla_flow("backward", f, planes, N, B, 0.0, 1.0, nsteps, monkeypatch, dy)
    for precision, tol in (("high", HIGH_VS_STRICT), ("f32", FLOW_TOL)):
        dphi, df0 = lfk.flow_bwd(torch.as_tensor(dy), torch.as_tensor(f), planes, ops, 0., 1.,
                                 nsteps, precision)
        assert rel(df0.numpy(), rdf0) < tol
        assert rel(dphi.numpy(), rdphi) < tol


@pytest.mark.parametrize("kind,t0,t1", [("forward", 0.0, 1.0), ("adjoint", 1.0, 0.0),
                                        ("backward", 0.0, 1.0)])
def test_dense_high_flows_match_jax_flow_call_interpret(kind, t0, t1):
    """The dense plain 'high' flows (what the Tier-1 slice tests run at
    32^2-64^2) against the whole-flow kernel `_flow_call` at 'high' in
    interpret mode with dense in-kernel derivatives: FLOW_TOL; the backward
    flow's delta phi (JAX integrates it un-hoisted, in the state, six 'high'
    products a stage; the port hoists it and applies three 'high' products
    once) to DPHI_TOL, the difference of the two orders of 'high' rounding
    (measured 4.8e-6)."""
    DPHI_TOL = 2e-5
    jderiv.set_deriv_mode("matmul")
    jp = JProj(32, 32, thetapix=3, T=np.float32)
    tp = ct.ProjLambert(32, 32, thetapix=3, T=np.float32, device="cpu")
    mats = tderiv.deriv_mats(tp)
    phi, f, dy = _weak_lensing()
    planes = _planes(phi, mats)
    g, h = tuple(jnp.asarray(p) for p in planes.numpy()[:2]), tuple(
        jnp.asarray(p) for p in planes.numpy()[2:])
    if kind == "backward":
        dphi_j, df0_j = plf.pallas_flow_bwd(jnp.asarray(dy), jnp.asarray(f), g, h, t0, t1, NSTEPS,
                                            jp, precision="high", interpret=True)
        dphi, df0 = lfk.flow_bwd(torch.as_tensor(dy), torch.as_tensor(f), planes, mats, t0, t1,
                                 NSTEPS, "high")
        assert rel(df0.numpy(), df0_j) < FLOW_TOL
        assert rel(dphi.numpy(), dphi_j) < DPHI_TOL
        return
    ref = plf.pallas_flow_apply(jnp.asarray(f), g, h, t0, t1, NSTEPS, jp, kind, precision="high",
                                interpret=True)
    out = lfk.flow_apply(torch.as_tensor(f), planes, mats, t0, t1, NSTEPS, kind, "high")
    assert rel(out.numpy(), ref) < FLOW_TOL


def test_flows_read_the_precision_in_force():
    """The public flows and gradhess run at the precision ops/deriv.py
    holds; precision_ctx restores it; the uni granularity reads it too (K5
    at 'high' and 'bf16', where it used to refuse both): the uni leaves of
    the tier in force, a result that differs from strict."""
    tp = ct.ProjLambert(32, 32, thetapix=3, T=np.float32, device="cpu")
    ops = tfd.factored_ops(tp, 2, 2)
    phi, f, dy = _weak_lensing()
    ft = torch.as_tensor(f)
    planes = _planes(phi, ops)
    with tderiv.precision_ctx("high"):
        assert tderiv.matmul_precision() == "high"
        a = lfk.flow_apply(ft, planes, ops, 0., 1., 1)
        assert lfk._uni_leaves_for(ft) is lfk.UPLAIN_HIGH
        u = lfk.uni_flow_apply(ft, planes, ops, 0., 1., 1)
    assert tderiv.matmul_precision() == "f32"
    assert torch.equal(a, lfk.flow_apply(ft, planes, ops, 0., 1., 1, precision="high"))
    assert not torch.equal(a, lfk.flow_apply(ft, planes, ops, 0., 1., 1))
    assert torch.equal(u, lfk.uni_flow_apply(ft, planes, ops, 0., 1., 1, precision="high"))
    assert not torch.equal(u, lfk.uni_flow_apply(ft, planes, ops, 0., 1., 1))
    tderiv.set_matmul_precision("bf16")
    assert lfk._uni_leaves_for(ft) is lfk.UPLAIN_BF16
    dphi, df0 = lfk.uni_flow_bwd(torch.as_tensor(dy)[None], ft[None], planes[None], ops, 0., 1., 1)
    dphi_s, df0_s = lfk.uni_flow_bwd(torch.as_tensor(dy)[None], ft[None], planes[None], ops, 0.,
                                     1., 1, "f32")
    assert not torch.equal(dphi, dphi_s) and not torch.equal(df0, df0_s)
    with pytest.raises(ValueError):
        tderiv.set_matmul_precision("tf32")
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_autograd_backward_runs_at_the_forward_precision(monkeypatch):
    """The LenseFlow Functions record the precision at forward time: a
    backward called outside the precision_ctx still runs the 'high'
    leaves (the transpose-delta flow and its delta-phi derivatives), and
    a strict forward's backward stays strict under a later 'high'
    context."""
    tp = ct.ProjLambert(32, 32, thetapix=3, T=np.float32, device="cpu")
    phi, f, dy = _weak_lensing()
    seen = []
    real = lfk._leaves_for

    def spy(x, mats, precision=None):
        leaves = real(x, mats, precision)
        seen.append("high" if leaves in (lfk.PLAIN_HIGH, lfk.FPLAIN_HIGH) else "f32")
        return leaves

    monkeypatch.setattr(lfk, "_leaves_for", spy)
    for adjoint in (False, True):
        x = torch.as_tensor(phi).requires_grad_(True)
        with tderiv.precision_ctx("high"):
            L = ct.LenseFlow(ct.Field(x, ct.MAP, tp), NSTEPS)
            out = (L.H if adjoint else L) @ ct.Field(torch.as_tensor(f), ct.QU_MAP, tp)
        seen.clear()
        (out.arr * torch.as_tensor(dy)).sum().backward()
        assert seen and set(seen) == {"high"}
        assert torch.isfinite(x.grad).all()
        x = torch.as_tensor(phi).requires_grad_(True)
        out = ct.LenseFlow(ct.Field(x, ct.MAP, tp), NSTEPS) @ ct.Field(torch.as_tensor(f),
                                                                      ct.QU_MAP, tp)
        seen.clear()
        with tderiv.precision_ctx("high"):
            (out.arr * torch.as_tensor(dy)).sum().backward()
        assert seen and set(seen) == {"f32"}


# =========================================================================
# argmaxf_logpdf and MAP_joint at "auto"
# =========================================================================

@pytest.mark.parametrize("cg,fallback", [(dict(tol=1e-4, nsteps=200), False),
                                         (dict(tol=0.0, nsteps=3, fixed_iters=True), True)])
def test_argmaxf_auto_matches_jax_verdict(P32, cg, fallback):
    """hessian_precision="auto" (the default on both sides): at tol=1e-4
    the 'high' solve passes its strict-residual check in both packages; at
    tol=0 with fixed iterations it misses 1e-10 res0 in both and re-runs
    strict (info["precision_fallback"]), as every f-step of
    scripts/map_1024.py does. f within the inexact-Krylov bound of
    tests/test_inference.py:267 (1e-3 in norm; measured 8e-6), and equal to
    JAX's strict solve to 1e-5 after a fallback."""
    jf, jinfo = jm.argmaxf_logpdf(P32["jds"], phi=P32["jphi"], conjgrad_kwargs=dict(cg))
    tf, tinfo = ct.argmaxf_logpdf(P32["tds"], phi=P32["tphi"], conjgrad_kwargs=dict(cg))
    assert bool(jinfo.get("precision_fallback", False)) is fallback
    assert bool(tinfo.get("precision_fallback", False)) is fallback
    out = tf.to(ct.Basis(jf.basis.pol, jf.basis.space)).arr.numpy()
    ref = np.array(jf.arr)
    if fallback:
        assert "res_strict" not in tinfo and rel(out, ref) < 1e-5
    else:
        assert bool(tinfo["precision_ok"])
        bound = max(cg["tol"], 1e-10 * float(tinfo["res0"]))
        assert float(tinfo["res_strict"]) <= bound
        assert np.linalg.norm(out - ref) / np.linalg.norm(ref) < 1e-3


MAP_CG = dict(tol=0.0, nsteps=2, fixed_iters=True)


def test_MAP_joint_auto_matches_jax(P32):
    """MAP_joint at its default precision="auto" for 3 steps at 32^2 P
    against JAX's (whose 'high' is strict on the CPU): the 'high'
    phi-gradient and unmix move the logpdfs by the split's operator error,
    bound 1e-5; the alphas come from the same strict grid, 1e-4. The first
    f-step, at phi = 0, passes its check (the preconditioner is then the
    Hessian itself, and CG converges at once); the later ones, 2 fixed
    iterations at tol 0, miss 1e-10 res0 and re-run strict. No direction
    retry fires."""
    keys = ("logpdf", "alpha", "precision_fallback", "retry")
    jr = jm.MAP_joint(P32["jds"], nsteps=3, conjgrad_kwargs=MAP_CG,
                      history_keys=("logpdf", "alpha"))
    tr = ct.MAP_joint(P32["tds"], nsteps=3, conjgrad_kwargs=MAP_CG, history_keys=keys)
    jl = np.array([h["logpdf"] for h in jr["history"]])
    tl = np.array([h["logpdf"] for h in tr["history"]])
    assert rel(tl, jl) < 1e-5
    assert np.all(np.diff(tl) >= 0)
    ja = np.array([h["alpha"] for h in jr["history"]], np.float64)
    ta = np.array([h["alpha"] for h in tr["history"]])
    assert ta[0] > 0 and rel(ta, ja) < 1e-4
    assert [h["precision_fallback"] for h in tr["history"]] == [False, True, True]
    assert [h["retry"] for h in tr["history"]] == [False] * 3


def _spy_gradients(monkeypatch, module, name, bad_high):
    """Wrap module.name (the phi-gradient) to record the precision of each
    call; with `bad_high` a 'high' gradient comes back reversed, which the
    strict line search can only reject (alpha = 0)."""
    calls, real = [], getattr(module, name)
    read = tderiv.matmul_precision if module is tm else (lambda: jderiv._PRECISION)

    def spy(*a, **k):
        calls.append(read() if module is tm else a[-1])
        f_mix, phi_mix, g = real(*a, **k)
        if bad_high and calls[-1] == "high":
            g = -1.0 * g
        return f_mix, phi_mix, g

    monkeypatch.setattr(module, name, spy)
    return calls


def test_direction_retry_fires_and_stays_strict(P32, monkeypatch):
    """The retry of MAP_joint(precision="auto"): when the strict trials
    reject the 'high' direction (forced here by reversing every 'high'
    gradient), the gradient is recomputed strict and searched again; the
    accepted strict retry keeps the run strict: one 'high' gradient, then
    strict ones only, and the steps still ascend."""
    calls = _spy_gradients(monkeypatch, tm, "_phi_grad_and_fmix", bad_high=True)
    r = ct.MAP_joint(P32["tds"], nsteps=3, conjgrad_kwargs=MAP_CG,
                     history_keys=("logpdf", "alpha", "retry"))
    assert calls == ["high", "f32", "f32", "f32"]
    assert [h["retry"] for h in r["history"]] == [True, False, False]
    assert all(h["alpha"] > 0 for h in r["history"])
    lps = [h["logpdf"] for h in r["history"]]
    assert lps == sorted(lps)


def test_failed_retry_waits_for_a_step_that_moves(P32, monkeypatch):
    """ROADMAP Queue 3 fault 1, settled in the port: after a strict retry
    that also finds alpha = 0 (forced: every line search returns alpha =
    0), no retry fires again until a step finds alpha > 0. Over 4 steps
    the port evaluates 5 gradients (high, strict retry, then high only);
    the JAX package, which retries on every such step, 8 (high and strict
    at each step), counted the same way in both."""
    def no_step(module, name):
        real = getattr(module, name)

        def stalled(*a, **k):
            out = real(*a, **k)
            if module is tm:
                alphas, dlps = out
                return alphas, torch.where(torch.arange(len(dlps)) == 0, 0.0, -1.0)
            return jnp.zeros_like(out[0]), out[1]
        monkeypatch.setattr(module, name, stalled)

    no_step(tm, "_grid_linesearch_dlps")
    no_step(jm, "_jit_grid_linesearch")
    tcalls = _spy_gradients(monkeypatch, tm, "_phi_grad_and_fmix", bad_high=False)
    jcalls = _spy_gradients(monkeypatch, jm, "_jit_phi_grad_and_fmix", bad_high=False)
    tr = ct.MAP_joint(P32["tds"], nsteps=4, conjgrad_kwargs=MAP_CG,
                      history_keys=("alpha", "retry"))
    jm.MAP_joint(P32["jds"], nsteps=4, conjgrad_kwargs=MAP_CG)
    assert tcalls == ["high", "f32", "high", "high", "high"]
    assert jcalls == ["high", "f32"] * 4
    assert [h["retry"] for h in tr["history"]] == [True, False, False, False]
    assert all(h["alpha"] == 0 for h in tr["history"])


def test_MAP_joint_precision_none_is_strict_everywhere(P32, monkeypatch):
    """precision=None: strict gradients and f-steps with no 'high' solve
    and no retry; precision='f32' keeps the f-step's own "auto" default,
    as the JAX package does."""
    calls = _spy_gradients(monkeypatch, tm, "_phi_grad_and_fmix", bad_high=False)
    seen = []
    real = tm._argmaxf_core

    def core(*a, **k):
        seen.append(a[6])
        return real(*a, **k)

    monkeypatch.setattr(tm, "_argmaxf_core", core)
    ct.MAP_joint(P32["tds"], nsteps=2, precision=None, conjgrad_kwargs=MAP_CG)
    assert calls == ["f32", "f32"] and seen == [None, None]
    calls.clear(), seen.clear()
    ct.MAP_joint(P32["tds"], nsteps=2, precision="f32", conjgrad_kwargs=MAP_CG)
    assert calls == ["f32", "f32"] and seen == ["high", "high", None]
