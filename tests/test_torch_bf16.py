"""The 'bf16' precision tier, held to the JAX package on the same numpy
inputs.

'bf16' is the JAX package's single bf16 product (`_mk_dot('bf16')`,
`_make_ddx_ddy` 'bf16' in cmblensing_tpu/ops/pallas_lenseflow.py): both
operands rounded to bf16 (nearest even), each product exact in float32,
summed in float32, no residual. Run in a Pallas interpreter kernel it
really rounds, so the port's plain 'bf16' versions (what the kernel
wrappers run for a CPU tensor) are held to those kernels. JAX's own
MAP_joint and argmaxf_logpdf on the CPU take the FFT derivatives, where
'bf16' changes nothing; under `set_deriv_mode("matmul")` its dense
products `_mm_x` / `_mm_y` cast to bf16 (cmblensing_tpu/ops/deriv.py:91-
105), so the end-to-end tests hold the port to that JAX run, with one
deliberate difference pinned on the JAX side: the port forms phi's
grad/Hess planes strict at 'bf16' (lenseflow_kernels.PLANES_PRECISION;
test_bf16_hessian_of_phi_is_rounding_noise says why).

Tolerances, relative max-abs unless said, each with its reason at the
test. Both sides round the same float32 values wherever they form them in
the same order: dense operands, and the factored butterflies at radix 2
and 4, whose weights are 0 and +-1 (the port's plain butterfly repeats the
CUDA tile's fused multiply-adds, JAX's `_kcomb` adds the same terms in the
same order). At radix 8 the weights +-0.7071 are multiplied and added in
JAX but fused in the port, so a channel value may differ in its last bit
and round to the neighbouring bf16 value (a flip, one bf16 ulp, ~2^-8 of
that value). Max-abs bounds cannot tell 'bf16' from strict where flips
are allowed; the per-plane relative Frobenius distance can: held to under
half (kernels) or under all (flows) of the distance to strict float32.

The CUDA kernels themselves are held to these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 14).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl

from cmblensing_tpu.core.proj import ProjLambert as JProj
from cmblensing_tpu.inference import maximization as jm
from cmblensing_tpu.models import lenseflow as jlf
from cmblensing_tpu.ops import deriv as jderiv
from cmblensing_tpu.ops import pallas_lenseflow as plf
from cmblensing_tpu.ops.factored_deriv import _factored_ops as j_factored_ops

import cmblensing_tpu_torch as ct
from cmblensing_tpu_torch.inference import maximization as tm
from cmblensing_tpu_torch.ops import deriv as tderiv
from cmblensing_tpu_torch.ops import factored_deriv as tfd
from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
from test_torch_map import P32  # noqa: F401  (a fixture)

NSTEPS = 3
# the same bf16 operands on both sides, summed in another float32 order
SAME_ROUNDING_TOL = 1e-5
# a butterfly summed in another order (radix 8) or a whole flow, whose RK4
# states differ in their last bits from stage to stage: flips (measured
# 3.1e-4 at radix 8, flows 1.6e-7 to 1.7e-4)
FLIP_TOL = 2e-3
# distance to the JAX result over distance to strict, per plane, in
# relative Frobenius norm (measured 0 to 0.03 for derivatives, 4e-5 to 0.04
# for flows; strict float32 gives infinity)
KERNEL_RATIO, FLOW_RATIO = 0.5, 1.0
# delta phi of the backward flow: JAX integrates it in the flow's state
# (dense, six 'bf16' products a stage) or applies its three derivatives
# after the loop as XLA's dense bf16 matmuls (factored), the port applies
# three 'bf16' products of its own form once after the loop: the same
# operator rounded at other places, not the same rounding (measured 1.7e-3
# and 1.8e-3, against 3.7e-3 and 2.3e-3 from strict; ROADMAP Queue 3,
# accuracy bounds)
DPHI_TOL = 5e-3


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def fro(a, b):
    """|a - b| / |b| in Frobenius norm, in double precision (complex where
    the fields are Fourier coefficients)."""
    a, b = (np.asarray(x).astype(np.result_type(x, np.float64)) for x in (a, b))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def ratio(out, ref, strict):
    """Per plane (leading axes flattened): the largest relative Frobenius
    distance of `out` to `ref` over its distance to `strict`."""
    planes = lambda x: np.asarray(x).reshape(-1, *np.shape(x)[-2:])
    return max(fro(o, r) / fro(o, s) for o, r, s in zip(planes(out), planes(ref), planes(strict)))


@pytest.fixture(autouse=True)
def _restore_modes():
    """One torch thread per test; the modes these tests set, restored, and
    JAX's compiled functions dropped after a test that ran them under
    set_deriv_mode("matmul") (the mode is read when a function is traced,
    and is not part of jit's cache key)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    if jderiv.get_deriv_mode() != "auto":
        jderiv.set_deriv_mode("auto")
        jax.clear_caches()
    tderiv.set_matmul_precision("f32")
    ct.set_lenseflow_backend("kernel")


def _jax_matmul_mode(monkeypatch):
    """JAX's products as dense bf16 matmuls at 'bf16', compiled afresh, its
    phi planes formed strict as the port forms them at 'bf16'."""
    real = jlf._gradhess_phi

    def strict_planes(phi_map, proj):
        with jderiv.precision_ctx("f32"):
            return real(phi_map, proj)

    monkeypatch.setattr(jlf, "_gradhess_phi", strict_planes)
    jax.clear_caches()
    jderiv.set_deriv_mode("matmul")


def _weak_lensing(N=32, ncomp=2, seed=1):
    """One-mode phi with Hess(phi) ~ 0.1 at every N, random f and dy."""
    phi_f = np.zeros((1, N, N // 2 + 1), np.complex128)
    phi_f[0, 1, 1] = 1e-3 * (N / 32) ** 4
    phi = np.fft.irfft2(phi_f, s=(N, N)).astype(np.float32)
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((ncomp, N, N)).astype(np.float32)
    dy = rng.standard_normal((ncomp, N, N)).astype(np.float32)
    return phi, f, dy


def _jax_factored(N, B, thetapix=3):
    """JAX's packed factored operands (FXt, FY) and butterfly metadata at
    radix B along both axes of an N^2 projection."""
    delta = float(JProj(N, N, thetapix=thetapix, T=np.float32).deltax)
    jop = j_factored_ops(N, delta, "float32", B)[0]
    fmeta = ((B, jop.A, jop.Rf, jop.Ri), (B, jop.A, jop.Rf, jop.Ri))
    return (jnp.asarray(plf._pack_factored(jop, True)),
            jnp.asarray(plf._pack_factored(jop, False))), fmeta


# =========================================================================
# the products and derivatives (K1 'bf16' and the dense 'bf16')
# =========================================================================

def test_dot_bf16_is_one_product_of_rne_operands():
    """dot_bf16 forms one product of the round-to-nearest-even bf16
    operands: the float64 product of those bf16 values up to float32
    rounding of the sums; no residual term (it lies ~2^-9 from the exact
    product, where dot_high lies ~2^-17); a right product is the same
    product transposed; a block already rounded is not rounded again."""
    rng = np.random.default_rng(3)
    M = torch.as_tensor(rng.standard_normal((16, 16)).astype(np.float32))
    v = torch.as_tensor(rng.standard_normal((16, 8)).astype(np.float32))
    Mh, vh = (x.to(torch.bfloat16).double() for x in (M, v))
    one = Mh @ vh
    out = tfd.dot_bf16(M, v, False).double()
    assert float((out - one).abs().max()) < 1e-6 * float(one.abs().max())
    exact = M.double() @ v.double()
    scale = float((M.abs() @ v.abs()).max())
    err = float((out - exact).abs().max())
    assert 2.0 ** -16 * scale < err < 2.0 ** -7 * scale
    assert float((tfd.dot_high(M, v, False).double() - exact).abs().max()) < 2.0 ** -16 * scale
    right = tfd.dot_bf16(M.T, v.T, True).T.double()
    assert torch.equal(right, out)
    assert torch.equal(tfd.dot_bf16(M.to(torch.bfloat16), v, False), tfd.dot_bf16(M, v, False))


def test_butterfly_fma_sums_in_the_tile_order():
    """The 'bf16' forward butterfly rounds each step of its multiply-add
    chain once, as fmaf does: exactly the float64 chain rounded to float32
    step by step, and at weights 0 and +-1 (radix 4) the plain float32 sum."""
    rng = np.random.default_rng(5)
    planes = [torch.as_tensor(rng.standard_normal((8, 8)).astype(np.float32)) for _ in range(8)]
    for B in (4, 8):
        R = torch.as_tensor(tfd._real_butterfly_mats(B)[0].astype(np.float32))
        out = tfd._butterfly_fma(planes[:B], R)
        for c in range(B):
            u = np.zeros((8, 8), np.float32)
            for r in range(B):
                u = (u.astype(np.float64) + float(R[c, r]) * planes[r].double().numpy()).astype(
                    np.float32)
            assert np.array_equal(out[c].numpy(), u)
        if B == 4:
            assert all(torch.equal(a, b) for a, b in zip(out, tfd._butterfly(planes[:B], R)))


def test_factored_ops_carry_the_bf16_heads():
    """The 'bf16' operands of the factored kernels are the 'high' split's
    heads, FX and FYT rounded to nearest even; the plain 'bf16' apply
    needs the split and refuses an unknown precision."""
    tp = ct.ProjLambert(64, 64, thetapix=3, T=np.float32, device="cpu")
    ops = tfd.factored_ops(tp, 4, 4)
    FX, FYT, bfx, bfy = lfk._fops(ops, "bf16")
    assert FX.dtype == FYT.dtype == torch.bfloat16 and FX.is_contiguous()
    assert torch.equal(FX, ops.FX.to(torch.bfloat16))
    assert torch.equal(FYT, ops.FYT.to(torch.bfloat16))
    x = torch.ones(1, 64, 64)
    with pytest.raises(ValueError, match="split"):
        tfd.apply_x(x, ops.FX, ops.bfx, None, "bf16")
    with pytest.raises(ValueError):
        tfd.apply_x(x, ops.FX, ops.bfx, ops.FXS, "tf32")


def _bf16_kernel(N, mats, fmeta, x):
    """d/dx, d/dy of x at 'bf16' by JAX's in-kernel derivative in a Pallas
    interpreter kernel."""
    jm_ = (tuple(jnp.asarray(m.numpy()) for m in mats) if fmeta is None
           else mats)

    def kern(x_ref, fx_ref, fy_ref, o_ref):
        ddx, ddy = plf._make_dd_any(fx_ref[:], fy_ref[:], "bf16", fmeta)
        o_ref[0] = ddx(x_ref[:])
        o_ref[1] = ddy(x_ref[:])

    return np.asarray(pl.pallas_call(kern, out_shape=jax.ShapeDtypeStruct((2, N, N), jnp.float32),
                                     interpret=True)(jnp.asarray(x), *jm_))


@pytest.mark.parametrize("form,N", [("dense", 64), (2, 64), (4, 64), (8, 64), (4, 512)])
def test_bf16_derivatives_match_jax_bf16_in_kernel(form, N):
    """d/dx, d/dy at 'bf16' (dense `dot_bf16`, or the factored apply at
    radix B with its butterfly in the tile's order) against JAX's 'bf16'
    body in a Pallas interpreter kernel, on white noise: the same rounded
    operands, SAME_ROUNDING_TOL, where both sum the butterfly in one order
    (dense, radix 2, 4; radix 4 also at 512^2, the kernels' block size A
    = 128); FLIP_TOL at radix 8 (measured 3.1e-4 where a channel value
    flipped, 1.4e-7 elsewhere). Each plane nearer JAX's than strict
    (KERNEL_RATIO; measured <= 0.03)."""
    thetapix = 2 if N == 512 else 3
    tp = ct.ProjLambert(N, N, thetapix=thetapix, T=np.float32, device="cpu")
    if form == "dense":
        mats, (jmats, fmeta) = tderiv.deriv_mats(tp), (None, None)
    else:
        mats = tfd.factored_ops(tp, form, form)
        jmats, fmeta = _jax_factored(N, form, thetapix)
    tol = FLIP_TOL if form == 8 else SAME_ROUNDING_TOL
    for seed in (1, 7):
        x = np.random.default_rng(seed).standard_normal((N, N)).astype(np.float32)
        ref = _bf16_kernel(N, mats if fmeta is None else jmats, fmeta, x)
        xt = torch.as_tensor(x)
        for d, b, st in zip(ref, tderiv.ddx_ddy(mats, "bf16"), tderiv.ddx_ddy(mats)):
            out, strict = b(xt).numpy(), st(xt).numpy()
            assert rel(out, d) < tol
            assert 1e-3 < rel(out, strict) < 1e-2   # ~2^-9 per rounded operand, summed
            assert ratio(out, d, strict) < KERNEL_RATIO


# =========================================================================
# the flows (K2 dense, K3, K4) at 'bf16'
# =========================================================================

def _planes(phi, mats):
    return lfk.gradhess(torch.as_tensor(phi), mats)


@pytest.mark.parametrize("kind,t0,t1", [("forward", 0.0, 1.0), ("adjoint", 1.0, 0.0),
                                        ("backward", 0.0, 1.0)])
def test_dense_bf16_flows_match_jax_flow_call_interpret(kind, t0, t1):
    """The dense plain 'bf16' flows against the whole-flow kernel
    `_flow_call` at 'bf16' in interpret mode with dense in-kernel
    derivatives, on the same phi planes: FLIP_TOL (measured 1.6e-7 to
    2.0e-5) and FLOW_RATIO; the backward flow's delta phi, which JAX
    integrates un-hoisted, to DPHI_TOL."""
    jderiv.set_deriv_mode("matmul")
    jp = JProj(32, 32, thetapix=3, T=np.float32)
    tp = ct.ProjLambert(32, 32, thetapix=3, T=np.float32, device="cpu")
    mats = tderiv.deriv_mats(tp)
    phi, f, dy = _weak_lensing()
    planes = _planes(phi, mats)
    g = tuple(jnp.asarray(p) for p in planes.numpy()[:2])
    h = tuple(jnp.asarray(p) for p in planes.numpy()[2:])
    if kind == "backward":
        dphi_j, df0_j = plf.pallas_flow_bwd(jnp.asarray(dy), jnp.asarray(f), g, h, t0, t1, NSTEPS,
                                            jp, precision="bf16", interpret=True)
        args = (torch.as_tensor(dy), torch.as_tensor(f), planes, mats, t0, t1, NSTEPS)
        (dphi, df0), (dphi_s, df0_s) = lfk.flow_bwd(*args, "bf16"), lfk.flow_bwd(*args)
        assert rel(df0.numpy(), df0_j) < FLIP_TOL and ratio(df0, df0_j, df0_s) < FLOW_RATIO
        assert rel(dphi.numpy(), dphi_j) < DPHI_TOL and ratio(dphi, dphi_j, dphi_s) < FLOW_RATIO
        return
    ref = plf.pallas_flow_apply(jnp.asarray(f), g, h, t0, t1, NSTEPS, jp, kind, precision="bf16",
                                interpret=True)
    out = lfk.flow_apply(torch.as_tensor(f), planes, mats, t0, t1, NSTEPS, kind, "bf16")
    strict = lfk.flow_apply(torch.as_tensor(f), planes, mats, t0, t1, NSTEPS, kind)
    assert rel(out.numpy(), ref) < FLIP_TOL
    assert ratio(out, ref, strict) < FLOW_RATIO


@pytest.mark.parametrize("kind,t0,t1", [("forward", 0.0, 1.0), ("forward", 1.0, 0.0),
                                        ("adjoint", 1.0, 0.0), ("adjoint", 0.0, 1.0)])
def test_bf16_fa_flows_match_jax_fa_call_interpret(kind, t0, t1, monkeypatch):
    """K3's plain 'bf16' flows (L, L^-1; L^H and its inverse) at radix 4
    against `_fa_call(..., "bf16", interpret=True)` with the factored
    in-kernel derivatives, on the same phi planes: FLIP_TOL (measured 0 to
    1.7e-4: the RK4 states of the two differ in their last bits after the
    first stage, and a channel value formed from them may flip) and
    FLOW_RATIO (measured <= 0.04)."""
    B, N = 4, 32
    fmats, fmeta = _jax_factored(N, B)
    monkeypatch.setattr(plf, "_fmeta_from_key", lambda fkey: fmeta)
    ops = tfd.factored_ops(ct.ProjLambert(N, N, thetapix=3, T=np.float32, device="cpu"), B, B)
    phi, f, _ = _weak_lensing(N)
    planes = _planes(phi, ops)
    ref = plf._fa_call(jnp.asarray(f), tuple(jnp.asarray(p) for p in planes.numpy()), fmats,
                       kind, NSTEPS, t0, t1, "bf16", True, ("bf16", B))
    out = lfk.flow_apply(torch.as_tensor(f), planes, ops, t0, t1, NSTEPS, kind, "bf16")
    strict = lfk.flow_apply(torch.as_tensor(f), planes, ops, t0, t1, NSTEPS, kind)
    assert rel(out.numpy(), ref) < FLIP_TOL
    assert ratio(out, ref, strict) < FLOW_RATIO


def test_bf16_backward_flow_matches_jax_bv_flow_interpret(monkeypatch):
    """K4's plain 'bf16' backward flow at radix 4 against `_bv_flow(...,
    "bf16", interpret=True)` with the factored in-kernel derivatives, one
    RK4 step: delta f to FLIP_TOL (measured 1.3e-7) and FLOW_RATIO; delta
    phi, whose three derivatives after the loop JAX runs as XLA's dense
    bf16 matmuls and the port as its factored 'bf16' products, to
    DPHI_TOL and FLOW_RATIO."""
    B, N = 4, 32
    jderiv.set_deriv_mode("matmul")
    fmats, fmeta = _jax_factored(N, B)
    monkeypatch.setattr(plf, "_fmats_for", lambda proj, dtype: (fmats, fmeta))
    monkeypatch.setattr(plf, "_fmeta_from_key", lambda fkey: fmeta)
    jp = JProj(N, N, thetapix=3, T=np.float32)
    ops = tfd.factored_ops(ct.ProjLambert(N, N, thetapix=3, T=np.float32, device="cpu"), B, B)
    phi, f, dy = _weak_lensing(N)
    planes = _planes(phi, ops)
    state = jnp.concatenate([jnp.asarray(f), jnp.asarray(dy), jnp.zeros((1, N, N), jnp.float32)])
    ref = np.asarray(plf._bv_flow(state, tuple(jnp.asarray(p) for p in planes.numpy()), jp, 1,
                                  1.0, 0.0, "bf16", interpret=True))
    args = (torch.as_tensor(dy), torch.as_tensor(f), planes, ops, 0., 1., 1)
    (dphi, df0), (dphi_s, df0_s) = lfk.flow_bwd(*args, "bf16"), lfk.flow_bwd(*args)
    assert rel(df0.numpy(), ref[2:4]) < FLIP_TOL and ratio(df0, ref[2:4], df0_s) < FLOW_RATIO
    assert rel(dphi.numpy(), ref[4:]) < DPHI_TOL and ratio(dphi, ref[4:], dphi_s) < FLOW_RATIO


def test_bf16_flows_take_the_bf16_leaves_and_uni_refuses_them():
    """precision_ctx("bf16") puts the public flows on the plain 'bf16'
    leaves, dense or factored, and their results differ from strict, while
    gradhess forms phi's planes strict; the uni granularity, which refused
    'bf16' before K5 had the tier, takes its 'bf16' leaves too, dense or
    factored, and its backward flow differs from strict."""
    phi, f, dy = _weak_lensing()
    ft = torch.as_tensor(f)
    tp = ct.ProjLambert(32, 32, thetapix=3, T=np.float32, device="cpu")
    for mats, leaves in ((tderiv.deriv_mats(tp), lfk.PLAIN_BF16),
                         (tfd.factored_ops(tp, 4, 4), lfk.FPLAIN_BF16)):
        planes = _planes(phi, mats)
        with tderiv.precision_ctx("bf16"):
            assert lfk._leaves_for(ft, mats) is leaves
            a = lfk.flow_apply(ft, planes, mats, 0., 1., 1)
            g = lfk.gradhess(torch.as_tensor(phi)[None], mats)
            assert lfk._uni_leaves_for(ft) is lfk.UPLAIN_BF16
            ub = lfk.uni_flow_bwd(torch.as_tensor(dy)[None], ft[None], planes[None], mats, 0., 1.,
                                  1)
        us = lfk.uni_flow_bwd(torch.as_tensor(dy)[None], ft[None], planes[None], mats, 0., 1., 1)
        assert all(torch.isfinite(x).all() and not torch.equal(x, y) for x, y in zip(ub, us))
        assert torch.equal(a, lfk.flow_apply(ft, planes, mats, 0., 1., 1, precision="bf16"))
        assert not torch.equal(a, lfk.flow_apply(ft, planes, mats, 0., 1., 1))
        # phi's planes are formed strict at 'bf16' (PLANES_PRECISION)
        assert torch.equal(g, lfk.gradhess(torch.as_tensor(phi)[None], mats, "f32"))
        assert torch.equal(g, lfk.gradhess_plain(torch.as_tensor(phi)[None], mats, "bf16"))
    with pytest.raises(ValueError):
        lfk.flow_apply(ft, planes, mats, 0., 1., 1, precision="tf32")


def test_bf16_hessian_of_phi_is_rounding_noise():
    """Why the port forms phi's planes strict at 'bf16': on a 256^2 phi
    drawn from the fiducial Cphi (thetapix 3), the Hessian of phi rounded
    to bf16 errs by more than the Hessian's largest value, both as the
    port would form it (two 'bf16' first derivatives) and as the JAX
    package forms it (its dense second-derivative circulant on bf16(phi),
    set_deriv_mode("matmul")); det(I + Hess phi), which p(t) divides by,
    then turns negative (measured -0.46), where the strict planes keep it
    above 0.4. The 'high' split errs by ~1 % of the Hessian."""
    N = 256
    tp = ct.ProjLambert(N, N, thetapix=3, T=np.float32, device="cpu")
    Cl = ct.camb()
    white = np.random.default_rng(0).standard_normal((1, N, N)).astype(np.float32)
    phi = (ct.Cl_to_Cov("I", tp, Cl["total"]["pp"]).sqrt()
           @ ct.Field(torch.as_tensor(white), ct.Basis("I", "map"), tp)).to(ct.MAP).arr
    mats = tderiv.deriv_mats(tp)
    strict, high = lfk.gradhess(phi, mats, "f32"), lfk.gradhess(phi, mats, "high")
    rounded = lfk._gradhess(lfk.PLAIN_BF16, phi, mats)
    jderiv.set_deriv_mode("matmul")
    with jderiv.precision_ctx("bf16"):
        (_, _), (jhxx, jhxy, jhyy) = jderiv.gradhess(jnp.asarray(phi.numpy()),
                                                     JProj(N, N, thetapix=3, T=np.float32))
    jax_h = torch.as_tensor(np.stack([np.asarray(h) for h in (jhxx, jhxy, jhyy)]))
    det = lambda h: float(((1 + h[0]) * (1 + h[2]) - h[1] ** 2).min())
    hmax = float(strict[2:].abs().max())
    for h in (rounded[2:], jax_h):
        assert float((h - strict[2:]).abs().max()) > hmax and det(h) < 0
    assert det(strict[2:]) > 0.4
    assert float((high[2:] - strict[2:]).abs().max()) < 0.02 * hmax


# =========================================================================
# MAP_joint(precision="bf16") and argmaxf_logpdf(hessian_precision="bf16")
# =========================================================================

MAP_CG = dict(tol=0.0, nsteps=2, fixed_iters=True)


def test_MAP_joint_bf16_matches_jax_matmul_bf16(P32, monkeypatch):
    """MAP_joint(precision="bf16") for 3 steps at 32^2 P against JAX's under
    set_deriv_mode("matmul"), whose 'bf16' phi-gradient and unmix really
    round (the dense bf16 matmuls of `_mm_x` / `_mm_y`), its phi planes
    strict as the port's: the same grid alphas (1e-6, the same float32
    grid points), among them one that the port's strict run does not
    take; logpdfs within 1e-6 (measured 8.7e-8, against 5.1e-6 from the
    strict run); phi within 5e-3 rel max-abs (measured 1.1e-3: the flows'
    states differ in their last bits between the two packages, and a value
    may round to the neighbouring bf16 value) and nearer JAX's 'bf16' phi
    than the port's strict one, in Frobenius norm (9.8e-4 against 7.8e-3)."""
    keys = ("logpdf", "alpha")
    tr = ct.MAP_joint(P32["tds"], nsteps=3, conjgrad_kwargs=MAP_CG, history_keys=keys,
                      precision="bf16")
    ts = ct.MAP_joint(P32["tds"], nsteps=3, conjgrad_kwargs=MAP_CG, history_keys=keys,
                      precision="f32")
    _jax_matmul_mode(monkeypatch)
    jr = jm.MAP_joint(P32["jds"], nsteps=3, conjgrad_kwargs=MAP_CG, history_keys=keys,
                      precision="bf16")
    get = lambda r, k: np.array([h[k] for h in r["history"]], np.float64)
    assert rel(get(tr, "alpha"), get(jr, "alpha")) < 1e-6
    assert not np.array_equal(get(tr, "alpha"), get(ts, "alpha"))
    tl = get(tr, "logpdf")
    assert rel(tl, get(jr, "logpdf")) < 1e-6 and np.all(np.diff(tl) >= 0)
    phi_t, phi_j, phi_s = (np.asarray(r["phi"].arr) for r in (tr, jr, ts))
    assert rel(phi_t, phi_j) < 5e-3
    assert fro(phi_t, phi_j) < fro(phi_t, phi_s)


def _spy(monkeypatch, name, record, transform=None):
    """Wrap tm.name to record what `record(*args)` says at each call, and
    pass its result through `transform(result, recorded)` when given."""
    calls, real = [], getattr(tm, name)

    def spy(*a, **k):
        calls.append(record(*a))
        out = real(*a, **k)
        return transform(out, calls[-1]) if transform else out

    monkeypatch.setattr(tm, name, spy)
    return calls


def test_MAP_joint_bf16_runs_each_part_at_its_precision(P32, monkeypatch):
    """MAP_joint(precision="bf16"), as the JAX package runs it
    (maximization.py:584-700): the phi-gradient and the step's unmix at
    'bf16'; the grid line search strict; each f-step's CG at its own
    default "auto" ('high'), kept at 2 fixed iterations, where the JAX
    package re-runs each after the first strict (the fixed-iteration
    re-check, ROADMAP Queue 3); no retry."""
    prec = lambda *a: tderiv.matmul_precision()
    grads = _spy(monkeypatch, "_phi_grad_and_fmix", prec)
    searches = _spy(monkeypatch, "_grid_linesearch_dlps", prec)
    unmixes = _spy(monkeypatch, "_step_unmix_and_norm", prec)
    fsteps = _spy(monkeypatch, "_argmaxf_core", lambda *a: a[6])
    r = ct.MAP_joint(P32["tds"], nsteps=3, conjgrad_kwargs=MAP_CG, precision="bf16",
                     history_keys=("logpdf", "alpha", "precision_fallback", "retry"))
    assert grads == unmixes == ["bf16"] * 3 and searches == ["f32"] * 3
    assert fsteps == ["high", "high", "high"]
    assert [h["precision_fallback"] for h in r["history"]] == [False, False, False]
    assert [h["retry"] for h in r["history"]] == [False] * 3
    assert all(h["alpha"] > 0 for h in r["history"])


def test_bf16_direction_retry_forces_strict(P32, monkeypatch):
    """The direction retry at 'bf16': when the strict trials reject the
    'bf16' direction (forced here by reversing every 'bf16' gradient), the
    gradient is recomputed strict and searched again, and the accepted
    strict retry keeps the run strict, the unmix included; the steps still
    ascend."""
    prec = lambda *a: tderiv.matmul_precision()
    flip = lambda out, p: (*out[:2], -1.0 * out[2]) if p == "bf16" else out
    grads = _spy(monkeypatch, "_phi_grad_and_fmix", prec, flip)
    unmixes = _spy(monkeypatch, "_step_unmix_and_norm", prec)
    r = ct.MAP_joint(P32["tds"], nsteps=3, conjgrad_kwargs=MAP_CG, precision="bf16",
                     history_keys=("logpdf", "alpha", "retry"))
    assert grads == ["bf16", "f32", "f32", "f32"] and unmixes == ["f32"] * 3
    assert [h["retry"] for h in r["history"]] == [True, False, False]
    assert all(h["alpha"] > 0 for h in r["history"])
    lps = [h["logpdf"] for h in r["history"]]
    assert lps == sorted(lps)


@pytest.mark.parametrize("cg,fallback", [(dict(tol=100.0, nsteps=200), False),
                                         (dict(tol=0.0, nsteps=3, fixed_iters=True), True)])
def test_argmaxf_bf16_matches_jax_matmul_verdict(P32, cg, fallback, monkeypatch):
    """argmaxf_logpdf(hessian_precision="bf16") against JAX's under
    set_deriv_mode("matmul"), whose 'bf16' Hessian applies round (its phi
    planes strict, as the port's): at tol 100 the 'bf16' solve passes its
    strict-residual check in both packages, f within 1e-4 in norm of JAX's
    'bf16' solve (measured 1.5e-6: the same rounded operands; the
    inexact-Krylov bound against strict, tests/test_inference.py:267, is
    1e-3); at 3 fixed iterations at tol 0 it misses max(tol, 1e-10 res0)
    in both (as it does at tol 1e-4) and re-runs strict, f then within
    1e-5 of JAX's strict solve."""
    _jax_matmul_mode(monkeypatch)
    kw = dict(cg, hessian_precision="bf16")
    jf, jinfo = jm.argmaxf_logpdf(P32["jds"], phi=P32["jphi"], conjgrad_kwargs=dict(kw))
    tf, tinfo = ct.argmaxf_logpdf(P32["tds"], phi=P32["tphi"], conjgrad_kwargs=dict(kw))
    assert bool(jinfo.get("precision_fallback", False)) is fallback
    assert bool(tinfo.get("precision_fallback", False)) is fallback
    out = tf.to(ct.Basis(jf.basis.pol, jf.basis.space)).arr.numpy()
    ref = np.array(jf.arr)
    if fallback:
        assert "res_strict" not in tinfo and fro(out, ref) < 1e-5
    else:
        assert bool(tinfo["precision_ok"]) and float(tinfo["res_strict"]) <= cg["tol"]
        assert fro(out, ref) < 1e-4
