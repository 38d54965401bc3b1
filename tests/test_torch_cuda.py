"""The hand-written CUDA LenseFlow kernels against their plain PyTorch
versions, on the card. These tests need a CUDA device (the kernels have
no CPU mode) and skip without one. The module imports no JAX, so that it
runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Bound: 1e-5 relative max-abs, both sides strict FP32 summing in another
order; 5e-4 for grad/Hess(phi), whose float32 value carries ~1e-4
relative error in any form (dense circulants or FFT, measured against
float64 at 256^2), so two FP32 summation orders differ by as much.
The factored kernels (csrc/factored.cu and the cluster tile's sources)
are checked at every radix they are built for: 512^2 (B = 4), 1024^2
(B = 8), 2048^2 (B = 16) and 4096^2 (B = 32), each on the tile
lenseflow_kernels.FORMS names.

Their 'high' tier (bf16 head/residual split on the tensor cores) is held
to its plain 'high' version at 2e-5: the two split the same FP32 values,
but a butterflied channel value that differs by one ulp between the two
summation orders may round its bf16 head the other way, which moves its
residual's rounding error, ~2^-17 of the operand; and to the strict
kernel at 1e-3, the operator error of the split (~2^-17 relative per
product term, summed over the contraction). Those bounds alone would pass
a 'high' entry that ran strict FP32, or split otherwise than round to
nearest even; what tells them apart is that such rounding flips touch
about one value in 128 while the split's error touches every value. So
each plane is also held in relative Frobenius norm: its distance to the
plain 'high' version under HIGH_SPLIT_RATIO of its distance to strict
(on the CPU a reordered butterfly gives 0.09-0.14, a truncating split
1.05, a split without the operand's residual 1.00:
tests/test_torch_high.py::test_split_ratio_tells_the_rne_split_apart).
A whole flow adds its RK4 sums' FP32 reassociation to both distances,
so it is held only to lie nearer its plain 'high' version than the
strict flow (FLOW_SPLIT_RATIO; strict kernels would give infinity).

K5 (csrc/uni_sm90.cu or csrc/uni.cu, factored at radix 4 to 32;
csrc/uni_dense.cu, dense at any plane shape) is held at every tier to the same bounds as the other
kernels at that tier, but for role 1, whose outer products round the
inner stage's sums (formed in another order by its plain version): at
'bf16' BF16_TOL in either form, and at both reduced tiers the Frobenius
ratio of a flow (FLOW_SPLIT_RATIO).

Their 'bf16' tier (one bf16 product of the rounded operands) is held to
its plain 'bf16' version: the dense kernels at 1e-5 (both round the same
operands; only FP32 sums differ), the factored ones and every flow at
2e-3 (a bf16 ulp is 3.9e-3: the plain butterfly repeats the tile's
fused multiply-adds, but where a value is formed in another order it may
round to the neighbouring bf16 value), and per plane in relative
Frobenius norm under BF16_RATIO (kernels) or FLOW_SPLIT_RATIO (flows) of
the distance to strict.
"""
import numpy as np
import pytest
import torch

import cmblensing_tpu_torch as ct
from cmblensing_tpu_torch.ops import deriv as tderiv
from cmblensing_tpu_torch.ops import factored_deriv as tfd
from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk

TOL = 1e-5
HESS_TOL = 5e-4
NSTEPS = 3
HIGH_TOL, HIGH_VS_STRICT, HIGH_SPLIT_RATIO, FLOW_SPLIT_RATIO = 2e-5, 1e-3, 0.5, 1.0
BF16_DENSE_TOL, BF16_TOL, BF16_RATIO = 1e-5, 2e-3, 0.5


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def split_ratio(high, plain, strict):
    """The largest, over the planes (leading axes flattened), of a 'high'
    result's relative Frobenius distance to its plain 'high' version over
    that to the strict result."""
    fro = lambda a, b: float((a.double() - b.double()).norm() / b.double().norm())
    return max(fro(h, q) / fro(h, st) for h, q, st in
               zip(*(x.reshape(-1, *x.shape[-2:]) for x in (high, plain, strict))))


def _weak_lensing(N, ncomp=2, seed=1):
    """One-mode phi with Hess(phi) ~ 0.1, random f and dy, from numpy."""
    phi_f = np.zeros((1, N, N // 2 + 1), np.complex128)
    phi_f[0, 1, 1] = 1e-3 * (N / 32) ** 4
    phi = np.fft.irfft2(phi_f, s=(N, N)).astype(np.float32)
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((ncomp, N, N)).astype(np.float32)
    dy = rng.standard_normal((ncomp, N, N)).astype(np.float32)
    return phi, f, dy


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_on_card():
    """The CUDA flow kernel against its plain version on the card, at
    64^2 and nsteps=3 (chip_smoke.py does the same at 256^2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flow kernel has no CPU mode")
    tp = ct.ProjLambert(64, 64, thetapix=3, T=np.float32, device="cuda")
    phi, f, dy = _weak_lensing(N=64)
    mats = tderiv.deriv_mats(tp)
    pt = torch.as_tensor(phi, device="cuda")
    ft, dyt = torch.as_tensor(f, device="cuda"), torch.as_tensor(dy, device="cuda")
    planes = lfk.gradhess(pt, mats)
    assert rel(planes, lfk.gradhess_plain(pt, mats)) < HESS_TOL
    for kind in ("forward", "adjoint"):
        a = lfk.flow_apply(ft, planes, mats, 0., 1., NSTEPS, kind)
        b = lfk.flow_apply_plain(ft, planes, mats, 0., 1., NSTEPS, kind)
        assert rel(a, b) < TOL
    for a, b in zip(lfk.flow_bwd(dyt, ft, planes, mats, 0., 1., NSTEPS),
                    lfk.flow_bwd_plain(dyt, ft, planes, mats, 0., 1., NSTEPS)):
        assert rel(a, b) < TOL


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    """Any plane shape is taken (the edge tiles are guarded), but not a
    tensor whose 16-byte rows lie off a 16-byte boundary, a state that
    does not fit its kind, or another type than float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flow kernel has no CPU mode")
    tp = ct.ProjLambert(24, 24, thetapix=3, T=np.float32, device="cuda")
    mats = tderiv.deriv_mats(tp)
    x = torch.zeros(2 * 24 * 24 + 1, device="cuda")[1:].view(2, 24, 24)
    with pytest.raises(ValueError, match="aligned"):
        lfk.deriv_cuda(x, None, None, torch.empty_like(x), mats)
    phi = torch.zeros((5, 24, 24), device="cuda")
    y3 = torch.zeros((3, 24, 24), device="cuda")
    with pytest.raises(ValueError, match="do not fit"):
        lfk.flow_cuda("backward", y3, phi, mats, 2, lfk.flow_schedule(1, 1., 0.))
    y = torch.zeros((2, 32, 32), device="cuda", dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        lfk.deriv_cuda(y, None, None, torch.empty_like(y), (y[0], y[0]))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flow kernels have no CPU mode")


def _p_planes(t, planes):
    """p(t) planes through the kernel, held against the plain version."""
    pt = torch.full((2,) + tuple(planes.shape[:-3]) + tuple(planes.shape[-2:]), float("nan"),
                    device="cuda")
    ref = torch.empty_like(pt)
    lfk.p_planes_cuda(t, planes, pt)
    lfk.p_planes_plain(t, planes, ref)
    assert rel(pt, ref) < 1e-6
    return pt


def _flow_pair(kind, y, planes, mats, ncomp, nsteps, precision, plain_too=True):
    """One whole dense flow of `kind` from state y through the flow kernel,
    and through its plain version (the plain leaves walking the same stage
    table): forward from 0 to 1, adjoint and backward from 1 to 0."""
    t0, t1 = (0., 1.) if kind == "forward" else (1., 0.)
    sched = lfk.flow_schedule(nsteps, t0, t1)
    k, p = y.clone(), y.clone()
    lfk.flow_cuda(kind, k, planes, mats, ncomp, sched, precision)
    if plain_too:
        lfk.flow_plain(kind, p, planes, mats, ncomp, sched, precision)
    return k, p


# (N, batch) of the factored kernel tests: every built radix at batch 1
# and, up to 2048^2, on the line search's batch of 17 (at 4096^2 a batch of
# 17 backward states is 10 GB a buffer; chip_smoke.py phase 13 runs K3 there)
FACTORED_CASES = [(512, 1), (512, 17), (1024, 1), (1024, 17), (2048, 1), (2048, 17), (4096, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("N,nb", FACTORED_CASES)
def test_factored_kernels_match_plain_on_card(N, nb):
    """K1 (lf_fderiv, x and y), K3 (lf_fa_velocity, both roles) and K4
    (lf_bv_velocity), strict, on the tile FORMS names at radix 4 (512^2), 8
    (1024^2), 16 (2048^2) and 32 (4096^2; the last two on the cluster tile)
    against their plain versions, one call each, at batch 1 and on the line
    search's batch of 17, every batch entry with its own phi and held to
    the bound on its own."""
    _card()
    tp = ct.ProjLambert(N, N, thetapix=2, T=np.float32, device="cuda")
    ops = tderiv.deriv_ops(tp)
    assert isinstance(ops, tfd.FactoredOps) and ops.FX.shape[0] == N // 128
    assert torch.equal(ops.FYT, ops.FY.transpose(-1, -2))
    phi, _, _ = _weak_lensing(N=N)
    planes = lfk.gradhess_plain(torch.as_tensor(phi, device="cuda"), ops)
    planes = torch.stack([planes * (1 - 0.05 * i) for i in range(nb)])
    g = torch.Generator(device="cuda").manual_seed(0)
    T = lambda *s: torch.randn(s, generator=g, device="cuda")
    each = lambda x, y: max(rel(x[i], y[i]) for i in range(nb))
    a, b, c = T(nb, 1, N, N), T(nb, 1, N, N), T(nb, 1, N, N)
    for args in ((a, None, None), (None, b, None), (a, b, c)):
        o1, o2 = torch.full_like(a, float("nan")), torch.empty_like(a)
        lfk.fderiv_cuda(*args, o1, ops)
        lfk.fderiv_plain(*args, o2, ops)
        assert each(o1, o2) < TOL
    y = T(nb, 2, N, N)
    pt = _p_planes(0.3, planes)
    for kind in ("forward", "adjoint"):
        k1, k2 = torch.full_like(y, float("nan")), torch.empty_like(y)
        lfk.fvelocity_cuda(kind, y, k1, planes, pt, ops, 2, 0.3)
        lfk.fvelocity_plain(kind, y, k2, planes, pt, ops, 2, 0.3)
        assert each(k1, k2) < TOL
    yb = torch.cat([T(nb, 4, N, N), 1e-3 * T(nb, lfk.NACC, N, N)], dim=1)
    pt = _p_planes(0.7, planes)
    k1, k2 = torch.full_like(yb, float("nan")), torch.empty_like(yb)
    lfk.fvelocity_cuda("backward", yb, k1, planes, pt, ops, 2, 0.7)
    lfk.fvelocity_plain("backward", yb, k2, planes, pt, ops, 2, 0.7)
    for i in range(yb.shape[1]):
        assert each(k1[:, i], k2[:, i]) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("N", [64, 256])
def test_dense_kernels_match_plain_on_card(N):
    """The register-tiled dense product of csrc/lenseflow.cu: lf_deriv with
    every combination of operands, and the whole-flow kernel (csrc/
    dense_flow.cu) of the three kinds (two and three components, nsteps
    2), against their plain versions, each plane held to the bound on its
    own."""
    _card()
    tp = ct.ProjLambert(N, N, thetapix=3, T=np.float32, device="cuda")
    mats = tderiv.deriv_mats(tp)
    phi, _, _ = _weak_lensing(N=N)
    planes = lfk.gradhess_plain(torch.as_tensor(phi, device="cuda"), mats)
    g = torch.Generator(device="cuda").manual_seed(0)
    T = lambda *s: torch.randn(s, generator=g, device="cuda")
    a, b, c = T(3, N, N), T(3, N, N), T(3, N, N)
    for args in ((a, None, None), (None, b, None), (a, b, None), (a, b, c)):
        o1, o2 = torch.full_like(a, float("nan")), torch.empty_like(a)
        lfk.deriv_cuda(*args, o1, mats)
        lfk.deriv_plain(*args, o2, mats)
        assert rel(o1, o2) < TOL
    for kind, ncomp in (("forward", 2), ("adjoint", 2), ("forward", 3), ("backward", 2)):
        ns = 2 * ncomp + lfk.NACC if kind == "backward" else ncomp
        y = T(ns, N, N)
        k1, k2 = _flow_pair(kind, y, planes, mats, ncomp, 2, "f32")
        for i in range(ns):
            assert rel(k1[i], k2[i]) < TOL, (kind, i)


@pytest.mark.cuda
def test_factored_flows_match_plain_on_card():
    """Whole K3 flows (L, L^-1, L^H) and a K4 backward flow at 1024^2
    against their plain versions, on a Cphi-drawn phi and Cf-drawn f
    (a one-mode phi that smooth is not representable to 1e-4 in float32
    at this size). grad/Hess(phi) to 2e-3, the 1024^2 bound chip_smoke.py
    states (l_max is 6x the 256^2 headline's)."""
    _card()
    N = 1024
    tp = ct.ProjLambert(N, N, thetapix=2, T=np.float32, device="cuda")
    ops = tderiv.deriv_ops(tp)
    rng = np.random.default_rng(2)
    Cl = ct.camb()
    white = lambda n, pol: ct.Field(torch.as_tensor(
        rng.standard_normal((n, N, N)).astype(np.float32), device="cuda"), ct.Basis(pol, "map"), tp)
    pt = (ct.Cl_to_Cov("I", tp, Cl["total"]["pp"]).sqrt() @ white(1, "I")).to(ct.MAP).arr
    Cf = ct.Cl_to_Cov("P", tp, Cl["unlensed_scalar"]["EE"], Cl["unlensed_scalar"]["BB"])
    ft = (Cf.sqrt() @ white(2, "QU")).to(ct.QU_MAP).arr.contiguous()
    dyt = white(2, "QU").arr
    planes = lfk.gradhess(pt, ops)
    assert rel(planes, lfk.gradhess_plain(pt, ops)) < 2e-3
    for kind, t0, t1 in (("forward", 0., 1.), ("forward", 1., 0.), ("adjoint", 1., 0.)):
        assert rel(lfk.flow_apply(ft, planes, ops, t0, t1, 2, kind),
                   lfk.flow_apply_plain(ft, planes, ops, t0, t1, 2, kind)) < TOL
    for x, y in zip(lfk.flow_bwd(dyt, ft, planes, ops, 0., 1., 2),
                    lfk.flow_bwd_plain(dyt, ft, planes, ops, 0., 1., 2)):
        assert rel(x, y) < TOL


@pytest.mark.cuda
def test_factored_wrapper_rejects_what_the_kernel_does_not_take():
    """A radix the kernels are not built for is refused by the wrapper
    and, should it reach the C entry, by the entry too."""
    from cmblensing_tpu_torch.ops import _build
    _card()
    tp = ct.ProjLambert(256, 256, thetapix=2, T=np.float32, device="cuda")
    ops = tfd.factored_ops(tp, 2, 2)
    x = torch.zeros((1, 256, 256), device="cuda")
    with pytest.raises(ValueError, match="radix"):
        lfk.fderiv_cuda(x, None, None, torch.empty_like(x), ops)
    out = torch.empty_like(x)
    fops = [lfk._ptr(t) for t in lfk._fops(ops)]
    assert _build.load().lf_fderiv(0, lfk._ptr(x), None, None, lfk._ptr(out), *fops, 2, 2, 1,
                                   256, 256, lfk._stream()) == lfk.CUDA_ERROR_INVALID_VALUE
    ops8 = tderiv.deriv_ops(ct.ProjLambert(1024, 1024, thetapix=2, T=np.float32, device="cuda"))
    y = torch.zeros((1, 1024, 1024), device="cuda")
    with pytest.raises(ValueError, match="alias"):
        lfk.fderiv_cuda(y, None, None, y, ops8)


@pytest.mark.cuda
def test_batched_irfft2_matches_single_planes_on_card():
    """cuFFT's batched inverse real plans treated the anti-Hermitian part
    of the self-conjugate columns unlike its single plans (1e-4 relative
    apart at 1024^2); ops/fft.py::irfft2 hands them only the Hermitian
    part, so a batch inverts like its planes one by one."""
    _card()
    from cmblensing_tpu_torch.ops import fft as tfft
    g = torch.Generator(device="cuda").manual_seed(1)
    X = torch.randn((17, 1, 1024, 513), generator=g, device="cuda", dtype=torch.complex64)
    X[..., 1:, 0] *= torch.linspace(1, 2, 1023, device="cuda")   # break the column's symmetry
    out = tfft.irfft2(X, 1024)
    for i in (0, 5, 16):
        one = tfft.irfft2(X[i], 1024)
        assert rel(out[i], one) < 1e-6


def _uni_role_inputs(N, mats, seed=0, nb=2):
    """px, py of a batch of nb phi's (phi, phi / 2, ...) at t = 0.6 and each
    role's (a, b) as the uni flows pass them: strided views of a (nb, 5, N,
    N) state (a component pair; f and delta f of both components; (u_x,
    u_y))."""
    phi, _, _ = _weak_lensing(N=N)
    planes = lfk.gradhess_plain(torch.as_tensor(phi, device="cuda"), mats)
    planes = torch.stack([planes / (1 + i) for i in range(nb)])
    g = torch.Generator(device="cuda").manual_seed(seed)
    y = torch.randn((nb, 5) + tuple(phi.shape[-2:]), generator=g, device="cuda")
    px, py = (p.unsqueeze(1).contiguous() for p in lfk._p_of_t(0.6, planes))
    return px, py, ((0, y[:, :2], y[:, 2:4]), (1, y[:, 4:], 1e-2 * y[:, :1]),
                    (2, y[:, :1], y[:, 1:2]), (3, y[:, :1], y[:, 1:2]))


UNI_NONZERO = {0: 4, 1: 1, 2: 2, 3: 2}   # the planes each K5 role writes; the rest are 0


@pytest.mark.cuda
@pytest.mark.parametrize("N", [512, 1024])
def test_uni_kernel_roles_match_plain_on_card(N):
    """K5 (lf_uni_velocity), every role, against its plain version on a
    batch of two, its operands strided views of a flow state as the uni
    flows pass them; each output plane held to the bound on its own."""
    _card()
    tp = ct.ProjLambert(N, N, thetapix=2, T=np.float32, device="cuda")
    ops = tderiv.deriv_ops(tp)
    assert isinstance(ops, tfd.FactoredOps) and ops.FX.shape[0] == N // 128
    px, py, roles = _uni_role_inputs(N, ops)
    t = 0.6
    for role, a, b in roles:
        o1 = torch.empty((2, a.shape[1], 4, N, N), device="cuda")
        o2 = torch.full_like(o1, float("nan"))
        o1.fill_(float("nan"))
        lfk.uni_velocity_cuda(role, a, b, px, py, o1, ops, t)
        lfk.uni_velocity_plain(role, a, b, px, py, o2, ops, t)
        nonzero = UNI_NONZERO[role]
        for i in range(nonzero):
            assert rel(o1[:, :, i], o2[:, :, i]) < TOL, (role, i)
        assert (o1[:, :, nonzero:] == 0).all()


# K5 at each tier against its plain version at that tier, per output plane
UNI_TOL = {"f32": TOL, "high": HIGH_TOL, "bf16": BF16_TOL}
UNI_DENSE_TOL = {"f32": TOL, "high": HIGH_TOL, "bf16": BF16_DENSE_TOL}


def _check_uni_roles(mats, px, py, roles, precision, tol, label, sentinel=False):
    """Each role of K5 at `precision` against its plain version at the
    tier (every output plane of every entry within `tol`; at a reduced
    tier also its Frobenius distance to plain under HIGH_SPLIT_RATIO of
    that to the strict kernel, FLOW_SPLIT_RATIO for role 1, and within
    HIGH_VS_STRICT of strict at 'high'), the planes a role leaves at zero exactly zero, two launches
    the same bits; with `sentinel` nothing written past the last plane (a
    NaN plane behind out)."""
    t = 0.6
    Ny, Nx = px.shape[-2:]
    each = lambda x, z: max(rel(u, v) for u, v in zip(x.reshape(-1, Ny, Nx),
                                                       z.reshape(-1, Ny, Nx)))
    for role, a, b in roles:
        nb, nper = a.shape[:2]
        outs = []
        for p in (precision, precision, "f32"):
            full = torch.full((nb * nper * 4 + 1, Ny, Nx), float("nan"), device="cuda")
            out = full[:-1].view(nb, nper, 4, Ny, Nx)
            lfk.uni_velocity_cuda(role, a, b, px, py, out, mats, t, p)
            if sentinel:
                assert torch.isnan(full[-1]).all(), f"{label} role {role} wrote past the last plane"
            outs.append(out)
        ref = torch.full_like(outs[0], float("nan"))
        lfk.uni_velocity_plain(role, a, b, px, py, ref, mats, t, precision)
        n = UNI_NONZERO[role]
        k, st, pl = (x[:, :, :n] for x in (outs[0], outs[2], ref))
        err = each(k, pl)
        msg = f"K5 {label} role {role} at {precision!r}: vs plain {err:.3e}"
        # role 1's outer products round the inner stage's sums, which the
        # kernel and plain form in other orders: at 'bf16' a sum one ulp
        # apart may round to the neighbouring bf16 value (dense: 2.0e-4)
        ok = err < (BF16_TOL if precision == "bf16" and role == 1 else tol)
        if precision != "f32":
            # those reassociated sums move both of role 1's distances: its
            # ratio is held as a flow's (0.31-0.47 at 'high' on the card)
            e_st, r = each(k, st), split_ratio(k, pl, st)
            msg += f", vs strict {e_st:.3e}, Frobenius ratio {r:.4f}"
            ok = (ok and r < (FLOW_SPLIT_RATIO if role == 1 else HIGH_SPLIT_RATIO)
                  and (precision != "high" or e_st < HIGH_VS_STRICT))
        print(msg)
        assert ok, msg
        assert (outs[0][:, :, n:] == 0).all(), (label, role)
        assert torch.equal(outs[0], outs[1]), (label, role)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["high", "bf16"])
@pytest.mark.parametrize("N", [512, 1024])
def test_uni_tier_kernel_roles_match_plain_on_card(N, precision):
    """K5 'high' and 'bf16' on factored operands (radix 4 and 8): every
    role on strided batch-2 operands against its plain version at the
    tier (HIGH_TOL, BF16_TOL) and the strict kernel (the Frobenius ratio),
    two launches per call counted on the tier's counter (four for role 1)."""
    _card()
    ops = tderiv.deriv_ops(ct.ProjLambert(N, N, thetapix=2, T=np.float32, device="cuda"))
    assert isinstance(ops, tfd.FactoredOps) and ops.FX.shape[0] == N // 128
    px, py, roles = _uni_role_inputs(N, ops)
    lfk.reset_launches()
    _check_uni_roles(ops, px, py, roles, precision, UNI_TOL[precision], f"{N}^2")
    sfx = "_" + precision
    assert [lfk.LAUNCHES[f"uni_role{r}{sfx}"] for r in range(4)] == [4, 8, 4, 4], lfk.LAUNCHES


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "high", "bf16"])
@pytest.mark.parametrize("shape", [(256, 256), (200, 200), (160, 200)])
def test_uni_dense_kernel_roles_match_plain_on_card(shape, precision):
    """The dense K5 (csrc/uni_dense.cu) at every tier, at whole tiles
    (256^2) and at ragged edge tiles (200^2, 160 x 200): every role on
    strided batch-2 operands against its plain version at the tier (TOL,
    HIGH_TOL, BF16_DENSE_TOL: the same rounded operands; role 1 at 'bf16'
    BF16_TOL, _check_uni_roles says why) and the strict kernel, nothing
    written past the last plane, two launches the same bits; one launch a
    call on the tier's dense counter (two for role 1)."""
    _card()
    Ny, Nx = shape
    mats = tderiv.deriv_mats(ct.ProjLambert(Ny, Nx, thetapix=3, T=np.float32, device="cuda"))
    phi_f = np.zeros((1, Ny, Nx // 2 + 1), np.complex128)
    phi_f[0, 1, 1] = 1e-3 * (Ny * Nx / 1024) ** 2
    phi = torch.as_tensor(np.fft.irfft2(phi_f, s=(Ny, Nx)).astype(np.float32), device="cuda")
    planes = lfk.gradhess_plain(phi, mats)
    planes = torch.stack([planes, 0.5 * planes])
    px, py = (p.unsqueeze(1).contiguous() for p in lfk._p_of_t(0.6, planes))
    y = torch.randn((2, 5, Ny, Nx), generator=torch.Generator(device="cuda").manual_seed(0),
                    device="cuda")
    roles = ((0, y[:, :2], y[:, 2:4]), (1, y[:, 4:], 1e-2 * y[:, :1]), (2, y[:, :1], y[:, 1:2]),
             (3, y[:, :1], y[:, 1:2]))
    lfk.reset_launches()
    _check_uni_roles(mats, px, py, roles, precision, UNI_DENSE_TOL[precision], f"{Ny}x{Nx}",
                     sentinel=True)
    sfx = "" if precision == "f32" else "_" + precision
    n = 3 if precision == "f32" else 2   # _check_uni_roles's strict launches count there too
    assert [lfk.LAUNCHES[f"uni_dense_role{r}{sfx}"] for r in range(4)] == [n, 2 * n, n, n]


@pytest.mark.cuda
def test_entry_points_default_to_the_card():
    """ProjLambert and load_sim put the port on the card unless asked for
    another device."""
    _card()
    assert ct.ProjLambert(32, 32, thetapix=3).device.type == "cuda"
    sim = ct.load_sim(thetapix=3, Nside=32, pol="P", seed=0)
    assert sim["proj"].device.type == "cuda" and sim["ds"].d.arr.is_cuda


@pytest.mark.cuda
@pytest.mark.parametrize("N,nb", FACTORED_CASES)
def test_factored_high_kernels_match_plain_high_on_card(N, nb):
    """The 'high' tier of K1, K3 (both roles) and K4 on the tensor cores
    against their plain 'high' versions (HIGH_TOL) and the strict kernels
    (HIGH_VS_STRICT), one launch each, every batch entry and output plane
    on its own; the 'high' counters count their launches."""
    _card()
    tp = ct.ProjLambert(N, N, thetapix=2, T=np.float32, device="cuda")
    ops = tderiv.deriv_ops(tp)
    assert ops.FXS.dtype == torch.bfloat16 and ops.FXS.shape == (2,) + tuple(ops.FX.shape)
    phi, _, _ = _weak_lensing(N=N)
    planes = lfk.gradhess_plain(torch.as_tensor(phi, device="cuda"), ops)
    planes = torch.stack([planes * (1 - 0.05 * i) for i in range(nb)])
    g = torch.Generator(device="cuda").manual_seed(0)
    T = lambda *s: torch.randn(s, generator=g, device="cuda")
    each = lambda x, y: max(rel(x[i, j], y[i, j]) for i in range(x.shape[0])
                            for j in range(x.shape[1]))

    def check(shape, kernel, plain):
        """kernel(out, precision) against plain(out) and the strict kernel."""
        o1, o2, o3 = (torch.full(shape, float("nan"), device="cuda") for _ in range(3))
        kernel(o1, "high")
        plain(o2)
        kernel(o3, "f32")
        e = (each(o1, o2), each(o1, o3), split_ratio(o1, o2, o3))
        print(f"'high' kernel N={N} nb={nb} shape {tuple(shape)}: vs plain 'high' {e[0]:.3e}, "
              f"vs strict {e[1]:.3e}, Frobenius ratio {e[2]:.3f}")
        assert e[0] < HIGH_TOL and e[1] < HIGH_VS_STRICT and e[2] < HIGH_SPLIT_RATIO, e

    lfk.reset_launches()
    a, b, c = T(nb, 1, N, N), T(nb, 1, N, N), T(nb, 1, N, N)
    for args in ((a, None, None), (None, b, None), (a, b, c)):
        check(a.shape, lambda o, p: lfk.fderiv_cuda(*args, o, ops, p),
              lambda o: lfk.fderiv_plain(*args, o, ops, "high"))
    assert lfk.LAUNCHES["fderiv_high"] == 4   # K1 'high': one launch a pass at every radix
    y = T(nb, 2, N, N)
    pt = _p_planes(0.3, planes)
    for kind in ("forward", "adjoint"):
        check(y.shape, lambda o, p: lfk.fvelocity_cuda(kind, y, o, planes, pt, ops, 2, 0.3, p),
              lambda o: lfk.fvelocity_plain(kind, y, o, planes, pt, ops, 2, 0.3, "high"))
        assert lfk.LAUNCHES[f"fa_velocity_{kind}_high"] == 2   # K3 'high': a launch a pass
    yb = torch.cat([T(nb, 4, N, N), 1e-3 * T(nb, lfk.NACC, N, N)], dim=1)
    pt = _p_planes(0.7, planes)
    check(yb.shape, lambda o, p: lfk.fvelocity_cuda("backward", yb, o, planes, pt, ops, 2, 0.7, p),
          lambda o: lfk.fvelocity_plain("backward", yb, o, planes, pt, ops, 2, 0.7, "high"))
    assert lfk.LAUNCHES["bv_velocity_high"] == 2   # K4 'high': a launch a pass on either tile


@pytest.mark.cuda
@pytest.mark.parametrize("N", [2048, 4096])
def test_factored_outputs_ignore_what_the_buffer_held_on_card(N):
    """At radix 16 and 32 every kernel runs the cluster tile, whose store
    folds the channel groups' partial sums in a fixed order and whose y
    pass adds onto the x pass's output; the output must not depend on what
    its buffer held: K1 (d_x alone, and d_x a + d_y b + c), K3 (both roles)
    and K4 into buffers of NaN, of 1e30 and of zeros give finite results
    within TOL of the plain version, at both tiers, and the same bits for
    every buffer."""
    _card()
    ops = tderiv.deriv_ops(ct.ProjLambert(N, N, thetapix=2, T=np.float32, device="cuda"))
    phi, _, _ = _weak_lensing(N=N)
    planes = lfk.gradhess_plain(torch.as_tensor(phi, device="cuda"), ops)[None]
    g = torch.Generator(device="cuda").manual_seed(0)
    T = lambda *s: torch.randn(s, generator=g, device="cuda")
    a, b, c = T(1, 1, N, N), T(1, 1, N, N), T(1, 1, N, N)
    y, yb = T(1, 2, N, N), torch.cat([T(1, 4, N, N), 1e-3 * T(1, lfk.NACC, N, N)], dim=1)
    pt = _p_planes(0.4, planes)
    cases = [(a.shape, lambda o, p, x=x: lfk.fderiv_cuda(*x, o, ops, p),
              lambda o, p, x=x: lfk.fderiv_plain(*x, o, ops, p))
             for x in ((a, None, None), (a, b, c), (None, b, c))]
    cases += [(y.shape, lambda o, p, k=k: lfk.fvelocity_cuda(k, y, o, planes, pt, ops, 2, 0.4, p),
               lambda o, p, k=k: lfk.fvelocity_plain(k, y, o, planes, pt, ops, 2, 0.4, p))
              for k in ("forward", "adjoint")]
    cases.append((yb.shape,
                  lambda o, p: lfk.fvelocity_cuda("backward", yb, o, planes, pt, ops, 2, 0.4, p),
                  lambda o, p: lfk.fvelocity_plain("backward", yb, o, planes, pt, ops, 2, 0.4, p)))
    for shape, kernel, plain in cases:
        for p in ("f32", "high"):
            ref = torch.empty(shape, device="cuda")
            plain(ref, p)
            first = None
            for fill in (float("nan"), 1e30, 0.0):
                o = torch.full(shape, fill, device="cuda")
                kernel(o, p)
                assert torch.isfinite(o).all(), (shape, p, fill)
                errs = [rel(o[0, i], ref[0, i]) for i in range(shape[1])]
                assert max(errs) < (TOL if p == "f32" else HIGH_TOL), (shape, p, fill, errs)
                first = o if first is None else first
                assert torch.equal(o, first), (shape, p, fill)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "high", "bf16"])
@pytest.mark.parametrize("N", [2048, 4096])
def test_uni_kernel_roles_at_radix_16_and_32_match_plain_on_card(N, precision):
    """K5 at radix 16 and 32, where the channel groups run as launches of
    their own, in order (the first stores, later ones add): every role on
    strided batch-2 operands against its plain version at the tier
    (_check_uni_roles: the tier's bound, and at a reduced tier the strict
    kernel and the Frobenius ratio; the zero planes exact; two launches
    the same bits; nothing written past the last plane), into buffers of
    NaN, 1e30 and zeros the same finite bits; a launch a channel group and
    pass on the tier's counter, two stages for role 1."""
    _card()
    ops = tderiv.deriv_ops(ct.ProjLambert(N, N, thetapix=2, T=np.float32, device="cuda"))
    assert isinstance(ops, tfd.FactoredOps) and ops.FX.shape[0] == N // 128
    px, py, roles = _uni_role_inputs(N, ops)
    lfk.reset_launches()
    _check_uni_roles(ops, px, py, roles, precision, UNI_TOL[precision], f"{N}^2", sentinel=True)
    sfx = "" if precision == "f32" else "_" + precision
    # calls x passes x launches a pass (channel groups strict, one on the cluster tile)
    n = (3 if precision == "f32" else 2) * 2 * lfk.pass_launches(N // 128, precision, "uni")
    assert [lfk.LAUNCHES[f"uni_role{r}{sfx}"] for r in range(4)] == [n, 2 * n, n, n], lfk.LAUNCHES
    for role, a, b in roles:
        first = None
        for fill in (float("nan"), 1e30, 0.0):
            o = torch.full((2, a.shape[1], 4, N, N), fill, device="cuda")
            lfk.uni_velocity_cuda(role, a, b, px, py, o, ops, 0.6, precision)
            assert torch.isfinite(o).all(), (role, fill)
            first = o if first is None else first
            assert torch.equal(o, first), (role, fill)
        del first, o


@pytest.mark.cuda
def test_factored_high_flows_match_plain_high_on_card():
    """Whole K3 flows (L, L^-1, L^H) and a K4 backward flow at 'high' at
    1024^2 against their plain 'high' versions, on a Cphi-drawn phi and
    Cf-drawn f, under precision_ctx: the flows read the precision in
    force, at the main path's nsteps (7; at 2 steps this 1024^2 flow is
    under-resolved and amplifies the operator error many times over). Each output plane within HIGH_TOL of the
    plain 'high' flow (chip_smoke.py phase 9 measured 1.0e-6 to 3.2e-6)
    and HIGH_VS_STRICT of the strict flow, and its Frobenius distance to
    the plain 'high' flow under FLOW_SPLIT_RATIO of that to the strict
    flow. grad/Hess phi at 'high' is held by that ratio alone, per plane: the
    derivatives of this red phi are small against the operand whose split
    rounding they inherit, and the Hessian differentiates that rounding
    once more, so their max-abs distances to either reference say little
    about which tier ran."""
    _card()
    N = 1024
    tp = ct.ProjLambert(N, N, thetapix=2, T=np.float32, device="cuda")
    ops = tderiv.deriv_ops(tp)
    rng = np.random.default_rng(2)
    Cl = ct.camb()
    white = lambda n, pol: ct.Field(torch.as_tensor(
        rng.standard_normal((n, N, N)).astype(np.float32), device="cuda"), ct.Basis(pol, "map"), tp)
    pt = (ct.Cl_to_Cov("I", tp, Cl["total"]["pp"]).sqrt() @ white(1, "I")).to(ct.MAP).arr
    Cf = ct.Cl_to_Cov("P", tp, Cl["unlensed_scalar"]["EE"], Cl["unlensed_scalar"]["BB"])
    ft = (Cf.sqrt() @ white(2, "QU")).to(ct.QU_MAP).arr.contiguous()
    dyt = white(2, "QU").arr
    planes = lfk.gradhess(pt, ops)
    lfk.reset_launches()
    each = lambda x, y: max(rel(a, b) for a, b in zip(x.reshape(-1, N, N), y.reshape(-1, N, N)))
    nsteps, found = 7, {}
    with tderiv.precision_ctx("high"):
        high, plain = lfk.gradhess(pt, ops), lfk.gradhess_plain(pt, ops)
        found["gradhess"] = (None, None, split_ratio(high, plain, planes))
        for kind, t0, t1 in (("forward", 0., 1.), ("forward", 1., 0.), ("adjoint", 1., 0.)):
            k = lfk.flow_apply(ft, planes, ops, t0, t1, nsteps, kind)
            p = lfk.flow_apply_plain(ft, planes, ops, t0, t1, nsteps, kind)
            st = lfk.flow_apply(ft, planes, ops, t0, t1, nsteps, kind, "f32")
            found[(kind, t0)] = (each(k, p), each(k, st), split_ratio(k, p, st))
        k = lfk.flow_bwd(dyt, ft, planes, ops, 0., 1., nsteps)
        for name, x, y, z in zip(("backward dphi", "backward df0"), k,
                                 lfk.flow_bwd_plain(dyt, ft, planes, ops, 0., 1., nsteps),
                                 lfk.flow_bwd(dyt, ft, planes, ops, 0., 1., nsteps, "f32")):
            found[name] = (each(x, y), each(x, z), split_ratio(x, y, z))
    print("'high' flows (vs plain 'high', vs strict, Frobenius ratio):", found)
    assert found.pop("gradhess")[2] < HIGH_SPLIT_RATIO
    assert all(r < FLOW_SPLIT_RATIO for _, _, r in found.values()), found
    assert all(e < HIGH_TOL and s < HIGH_VS_STRICT for e, s, _ in found.values()), found
    assert all(lfk.LAUNCHES[k + "_high"] > 0
               for k in ("fderiv", "fa_velocity_forward", "fa_velocity_adjoint", "bv_velocity"))


@pytest.mark.cuda
def test_dense_high_runs_only_high_kernels_on_card():
    """Since K2's 'high' tier was ported, a dense 'high' flow and grad/Hess
    phi launch only the 'high' dense kernels, the flow one launch with its
    RK4 update and p(t) inside, never the strict ones in their place."""
    _card()
    tp = ct.ProjLambert(64, 64, thetapix=3, T=np.float32, device="cuda")
    phi, f, dy = _weak_lensing(N=64)
    pt, ft = torch.as_tensor(phi, device="cuda"), torch.as_tensor(f, device="cuda")
    mats = tderiv.deriv_mats(tp)
    planes = lfk.gradhess(pt, mats)
    lfk.reset_launches()
    with tderiv.precision_ctx("high"):
        assert torch.isfinite(lfk.flow_apply(ft, planes, mats, 0., 1., 1)).all()
        assert torch.isfinite(lfk.gradhess(pt, mats)).all()
    ran = {k: v for k, v in lfk.LAUNCHES.items() if v}
    assert ran == {"flow_forward_high": 1, "deriv_high": 5}, ran


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "high", "bf16"])
@pytest.mark.parametrize("N", [256, 512])
def test_uni_tier_flows_match_plain_on_card(N, precision):
    """The uni flows (L, L^-1, L^H, backward delta phi and delta f) on K5,
    dense at 256^2 (csrc/uni_dense.cu, where K5 used to refuse dense
    operands) and factored at 512^2, at every tier, where 'high' and
    'bf16' used to raise: each output plane within the tier's bound of the
    plain uni flow at the tier (TOL; HIGH_TOL; BF16_TOL), and at a reduced
    tier nearer it than the strict flow (FLOW_SPLIT_RATIO); L, L^-1, L^H
    and delta f within that bound of the kernel backend's flow (K2, K3/K4)
    at the same tier; only K5 and the integrator launch in the applies."""
    _card()
    tp = ct.ProjLambert(N, N, thetapix=3, T=np.float32, device="cuda")
    mats = tderiv.deriv_ops(tp)
    rng = np.random.default_rng(3)
    Cl = ct.camb()
    white = lambda n, pol: ct.Field(torch.as_tensor(
        rng.standard_normal((n, N, N)).astype(np.float32), device="cuda"), ct.Basis(pol, "map"), tp)
    pm = (ct.Cl_to_Cov("I", tp, Cl["total"]["pp"]).sqrt() @ white(1, "I")).to(ct.MAP).arr
    Cf = ct.Cl_to_Cov("P", tp, Cl["unlensed_scalar"]["EE"], Cl["unlensed_scalar"]["BB"])
    ft = (Cf.sqrt() @ white(2, "QU")).to(ct.QU_MAP).arr.contiguous()
    dyt = white(2, "QU").arr
    planes = lfk.gradhess(pm, mats, precision)
    each = lambda x, y: max(rel(a, b) for a, b in zip(x.reshape(-1, N, N), y.reshape(-1, N, N)))
    tol = {"f32": TOL, "high": HIGH_TOL, "bf16": BF16_TOL}[precision]
    kinds = (("forward", 0., 1.), ("forward", 1., 0.), ("adjoint", 1., 0.))
    found = {}
    lfk.reset_launches()
    for kind, t0, t1 in kinds:
        found[(kind, t0)] = [lfk.uni_flow_apply(ft, planes, mats, t0, t1, 7, kind, precision)]
    launched = {k_: v for k_, v in lfk.LAUNCHES.items() if v}
    for kind, t0, t1 in kinds:
        found[(kind, t0)] += [fn(ft, planes, mats, t0, t1, 7, kind, p) for fn, p in (
            (lfk.uni_flow_apply_plain, precision), (lfk.uni_flow_apply, "f32"),
            (lfk.flow_apply, precision))]
    bwd = [fn(dyt, ft, planes, mats, 0., 1., 7, p) for fn, p in (
        (lfk.uni_flow_bwd, precision), (lfk.uni_flow_bwd_plain, precision),
        (lfk.uni_flow_bwd, "f32"), (lfk.flow_bwd, precision))]
    for i, name in enumerate(("backward dphi", "backward df0")):
        found[name] = [r[i] for r in bwd]
    for name, (k, p, st, kern) in found.items():
        e = (each(k, p), each(k, kern))
        r = split_ratio(k, p, st) if precision != "f32" else 0.0
        print(f"uni flow {name} {N}^2 at {precision!r}: vs plain uni {e[0]:.3e}, vs kernel "
              f"backend {e[1]:.3e}, ratio {r:.4f}")
        assert e[0] < tol and r < FLOW_SPLIT_RATIO, (name, e, r)
        if name != "backward dphi":   # delta phi is hoisted on the kernel backend
            assert e[1] < tol, (name, e)
    form = "" if isinstance(mats, tfd.FactoredOps) else "_dense"
    sfx = "" if precision == "f32" else "_" + precision
    k5 = {k_ for k_ in launched if k_.startswith("uni")}
    assert k5 == {f"uni{form}_role2{sfx}", f"uni{form}_role3{sfx}"}, launched
    assert set(launched) - k5 == {"rk4_update", "p_planes"}, launched


def _check_high(shape, kernel, plain, label):
    """kernel(out, precision) at 'high' against plain(out) (its plain 'high'
    version) and the strict kernel: every plane within HIGH_TOL and
    HIGH_VS_STRICT, and its Frobenius distance to plain 'high' under
    HIGH_SPLIT_RATIO of that to strict."""
    o1, o2, o3 = (torch.full(shape, float("nan"), device="cuda") for _ in range(3))
    kernel(o1, "high")
    plain(o2)
    kernel(o3, "f32")
    each = lambda x, y: max(rel(a, b) for a, b in zip(x.reshape(-1, *shape[-2:]),
                                                       y.reshape(-1, *shape[-2:])))
    e = (each(o1, o2), each(o1, o3), split_ratio(o1, o2, o3))
    print(f"'high' {label} {tuple(shape)}: vs plain 'high' {e[0]:.3e}, vs strict {e[1]:.3e}, "
          f"Frobenius ratio {e[2]:.3f}")
    assert e[0] < HIGH_TOL and e[1] < HIGH_VS_STRICT and e[2] < HIGH_SPLIT_RATIO, e


@pytest.mark.cuda
@pytest.mark.parametrize("N", [64, 256])
def test_dense_high_kernels_match_plain_high_on_card(N):
    """K2 'high' (csrc/lenseflow.cu, HIGH: mma.sync bf16 on the split
    circulants and operand): lf_deriv with each operand set, one launch
    each, against the plain 'high' version and the strict kernel
    (_check_high); the 'high' counters count their launches. The whole
    flow at 'high': test_whole_flow_matches_plain_on_card."""
    _card()
    tp = ct.ProjLambert(N, N, thetapix=3, T=np.float32, device="cuda")
    mats = tderiv.deriv_mats(tp)
    phi, _, _ = _weak_lensing(N=N)
    planes = lfk.gradhess_plain(torch.as_tensor(phi, device="cuda"), mats)
    g = torch.Generator(device="cuda").manual_seed(0)
    T = lambda *s: torch.randn(s, generator=g, device="cuda")
    lfk.reset_launches()
    a, b, c = T(3, N, N), T(3, N, N), T(3, N, N)
    for args in ((a, None, None), (None, b, None), (a, b, c)):
        _check_high(a.shape, lambda o, p: lfk.deriv_cuda(*args, o, mats, p),
                    lambda o: lfk.deriv_plain(*args, o, mats, "high"), "deriv")
    assert lfk.LAUNCHES["deriv_high"] == 3 and lfk.LAUNCHES["deriv"] == 3


@pytest.mark.cuda
def test_dense_high_flows_match_plain_high_on_card():
    """Whole dense flows at 'high' at the main path's 256^2 and nsteps 7,
    on a Cphi-drawn phi and a Cf-drawn f: each output plane within
    HIGH_TOL of the plain 'high' flow and HIGH_VS_STRICT of the strict
    flow, and nearer the plain 'high' flow than the strict one
    (FLOW_SPLIT_RATIO)."""
    _card()
    N = 256
    tp = ct.ProjLambert(N, N, thetapix=3, T=np.float32, device="cuda")
    mats = tderiv.deriv_mats(tp)
    rng = np.random.default_rng(3)
    Cl = ct.camb()
    white = lambda n, pol: ct.Field(torch.as_tensor(
        rng.standard_normal((n, N, N)).astype(np.float32), device="cuda"), ct.Basis(pol, "map"), tp)
    pm = (ct.Cl_to_Cov("I", tp, Cl["total"]["pp"]).sqrt() @ white(1, "I")).to(ct.MAP).arr
    Cf = ct.Cl_to_Cov("P", tp, Cl["unlensed_scalar"]["EE"], Cl["unlensed_scalar"]["BB"])
    ft = (Cf.sqrt() @ white(2, "QU")).to(ct.QU_MAP).arr.contiguous()
    dyt = white(2, "QU").arr
    planes = lfk.gradhess(pm, mats)
    each = lambda x, y: max(rel(a, b) for a, b in zip(x.reshape(-1, N, N), y.reshape(-1, N, N)))
    found = {}
    for kind, t0, t1 in (("forward", 0., 1.), ("forward", 1., 0.), ("adjoint", 1., 0.)):
        k = lfk.flow_apply(ft, planes, mats, t0, t1, 7, kind, "high")
        p = lfk.flow_apply_plain(ft, planes, mats, t0, t1, 7, kind, "high")
        st = lfk.flow_apply(ft, planes, mats, t0, t1, 7, kind, "f32")
        found[(kind, t0)] = (each(k, p), each(k, st), split_ratio(k, p, st))
    for name, x, y, z in zip(("backward dphi", "backward df0"),
                             lfk.flow_bwd(dyt, ft, planes, mats, 0., 1., 7, "high"),
                             lfk.flow_bwd_plain(dyt, ft, planes, mats, 0., 1., 7, "high"),
                             lfk.flow_bwd(dyt, ft, planes, mats, 0., 1., 7, "f32")):
        found[name] = (each(x, y), each(x, z), split_ratio(x, y, z))
    print("dense 'high' flows (vs plain 'high', vs strict, Frobenius ratio):", found)
    assert all(e < HIGH_TOL and s < HIGH_VS_STRICT and r < FLOW_SPLIT_RATIO
               for e, s, r in found.values()), found


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "high"])
@pytest.mark.parametrize("shape", [(200, 200), (160, 200), (33, 45)])
def test_dense_edge_tiles_match_plain_on_card(shape, precision):
    """K2 at plane shapes its 32 x 32 tile and 16-deep slab do not divide
    (200^2 is load_sim(Nside=200); 33 x 45 also loads its rows a float at
    a time): lf_deriv, p(t), the RK4 update and whole flows (the flow
    kernel) against their plain versions at the same precision,
    every plane on its own (TOL strict, HIGH_TOL at 'high'), and nothing
    written past the last plane (a NaN sentinel plane behind it)."""
    _card()
    Ny, Nx = shape
    tol = TOL if precision == "f32" else HIGH_TOL
    tp = ct.ProjLambert(Ny, Nx, thetapix=3, T=np.float32, device="cuda")
    mats = tderiv.deriv_mats(tp)
    rng = np.random.default_rng(4)
    phi_f = np.zeros((1, Ny, Nx // 2 + 1), np.complex128)
    phi_f[0, 1, 1] = 1e-3 * (Ny * Nx / 1024) ** 2
    phi = torch.as_tensor(np.fft.irfft2(phi_f, s=(Ny, Nx)).astype(np.float32), device="cuda")
    T = lambda *s: torch.as_tensor(rng.standard_normal(s).astype(np.float32), device="cuda")
    each = lambda x, y: max(rel(a, b) for a, b in zip(x.reshape(-1, Ny, Nx), y.reshape(-1, Ny, Nx)))

    def check(n, kernel, plain, label):
        full = torch.full((n + 1, Ny, Nx), float("nan"), device="cuda")
        ref = torch.empty((n, Ny, Nx), device="cuda")
        kernel(full[:n])
        plain(ref)
        assert torch.isnan(full[n]).all(), f"{label} wrote past the last plane"
        assert each(full[:n], ref) < tol, (label, each(full[:n], ref))

    planes = lfk.gradhess_plain(phi, mats)
    a, b, c = T(3, Ny, Nx), T(3, Ny, Nx), T(3, Ny, Nx)
    for args in ((a, None, None), (None, b, None), (a, b, c)):
        check(3, lambda o: lfk.deriv_cuda(*args, o, mats, precision),
              lambda o: lfk.deriv_plain(*args, o, mats, precision), "deriv")
    check(2, lambda o: lfk.p_planes_cuda(0.4, planes, o),
          lambda o: lfk.p_planes_plain(0.4, planes, o), "p_planes")
    y, k = T(9, Ny, Nx), T(9, Ny, Nx)
    rk = [torch.zeros((2, 9, Ny, Nx), device="cuda") for _ in range(2)]
    for fn, (acc, s) in zip((lfk.rk4_update_cuda, lfk.rk4_update_plain), rk):
        fn(y, k, acc, s, 1, 1 / 21, 1 / 14)
    assert each(*rk) < TOL
    # grad/Hess phi. This phi is one long mode, so its derivatives cancel
    # hard (the sum of |D_ij phi_j| is ~1e3 x |D phi|, ~1e5 x for the
    # Hessian) and any FP32 summation order lies ~1e-5 (gradient) to ~1e-3
    # (Hessian) from the exact value: two orders differ by as much, which
    # no fixed kernel-vs-plain bound can hold (the first version of this
    # test read 7.5e-4 against HESS_TOL at 200^2). Held instead, per plane,
    # to be no less accurate against a float64 evaluation than the plain
    # FP32 version, within a factor 2 for the two orders' luck (or within
    # TOL where the plain version lies nearer than TOL). At 'high', to the
    # Frobenius split ratio.
    if precision == "f32":
        m64 = tderiv.deriv_mats(ct.ProjLambert(Ny, Nx, thetapix=3, T=np.float64, device="cuda"))
        exact = lfk.gradhess_plain(phi.double(), m64)
        per_plane = lambda x: [rel(a.double(), b) for a, b in zip(x, exact)]
        k_err, p_err = per_plane(lfk.gradhess(phi, mats)), per_plane(planes)
        print(f"gradhess {shape} vs float64, per plane: kernel {k_err}, plain {p_err}")
        assert all(ke <= 2 * max(pe, TOL) for ke, pe in zip(k_err, p_err)), (k_err, p_err)
    else:
        assert split_ratio(lfk.gradhess(phi, mats, "high"), lfk.gradhess_plain(phi, mats, "high"),
                           lfk.gradhess(phi, mats, "f32")) < HIGH_SPLIT_RATIO
    # whole flows on a Cphi-drawn phi and a Cf-drawn f at the main path's
    # nsteps 7 (white fields at few steps under-resolve the backward flow,
    # whose delta phi then amplifies the 'high' split's rounding flips)
    Cl = ct.camb()
    white = lambda n, pol: ct.Field(T(n, Ny, Nx), ct.Basis(pol, "map"), tp)
    pm = (ct.Cl_to_Cov("I", tp, Cl["total"]["pp"]).sqrt() @ white(1, "I")).to(ct.MAP).arr
    Cf = ct.Cl_to_Cov("P", tp, Cl["unlensed_scalar"]["EE"], Cl["unlensed_scalar"]["BB"])
    f2 = (Cf.sqrt() @ white(2, "QU")).to(ct.QU_MAP).arr.contiguous()
    dy = white(2, "QU").arr
    planes = lfk.gradhess_plain(pm, mats)
    for kind in ("forward", "adjoint"):
        assert each(lfk.flow_apply(f2, planes, mats, 0., 1., 7, kind, precision),
                    lfk.flow_apply_plain(f2, planes, mats, 0., 1., 7, kind, precision)) < tol
    for x, z in zip(lfk.flow_bwd(dy, f2, planes, mats, 0., 1., 7, precision),
                    lfk.flow_bwd_plain(dy, f2, planes, mats, 0., 1., 7, precision)):
        assert each(x, z) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(200, 200), (160, 200)])
def test_dense_high_backward_flow_on_white_fields_stage_by_stage_on_card(shape):
    """The inputs on which the 'high' backward flow first lay above
    HIGH_TOL from its plain 'high' version (2.4e-5 at 160 x 200): white f
    and delta f, the one-mode phi, 3 steps. The flow kernel runs the flow
    step by step, a launch on each step's slice of the stage table (its
    four stages, the p of its first time formed first), and the chained
    steps give the whole flow's bits; each step is held against the plain
    'high' leaves walking that slice from the very state the kernel
    reached (HIGH_TOL, every state plane), as are the three closing
    derivatives on the accumulators the flow reached, and delta f is
    flow_bwd's bit for bit. So the kernel is right at every step; what
    the whole flow adds (printed, with its distance to the strict flow)
    is the plain and kernel trajectories drifting apart by reassociation
    and split-rounding flips, which 3 coarse steps over a white field's
    large velocities amplify. The whole flows of
    test_whole_flow_matches_plain_on_card run the main path's
    Cphi/Cf-drawn fields at its nsteps 7."""
    _card()
    Ny, Nx = shape
    nsteps, ncomp = 3, 2
    tp = ct.ProjLambert(Ny, Nx, thetapix=3, T=np.float32, device="cuda")
    mats = tderiv.deriv_mats(tp)
    phi_f = np.zeros((1, Ny, Nx // 2 + 1), np.complex128)
    phi_f[0, 1, 1] = 1e-3 * (Ny * Nx / 1024) ** 2
    phi = torch.as_tensor(np.fft.irfft2(phi_f, s=(Ny, Nx)).astype(np.float32), device="cuda")
    planes = lfk.gradhess_plain(phi, mats)
    rng = np.random.default_rng(4)
    f2, dy = (torch.as_tensor(rng.standard_normal((ncomp, Ny, Nx)).astype(np.float32),
                              device="cuda") for _ in range(2))
    each = lambda x, y: max(rel(a, b) for a, b in zip(x.reshape(-1, Ny, Nx), y.reshape(-1, Ny, Nx)))
    y0 = torch.cat([f2, dy, torch.zeros((lfk.NACC, Ny, Nx), device="cuda")])
    y, _ = _flow_pair("backward", y0, planes, mats, ncomp, nsteps, "high", plain_too=False)
    sched, state, step_errs = lfk.flow_schedule(nsteps, 1., 0.), y0.clone(), []
    for i in range(nsteps):
        step, plain = sched[4 * i:4 * i + 4], state.clone()
        lfk.flow_plain("backward", plain, planes, mats, ncomp, step, "high")
        lfk.flow_cuda("backward", state, planes, mats, ncomp, step, "high")
        step_errs.append(each(state, plain))
    assert torch.equal(state, y)
    dphi, df0 = lfk.flow_bwd(dy, f2, planes, mats, 0., 1., nsteps, "high")
    assert torch.equal(df0, y[ncomp:2 * ncomp])
    ux, uy, sxx, sxy, syy = (y[2 * ncomp + i:2 * ncomp + i + 1].contiguous()
                             for i in range(lfk.NACC))
    X, Y, D = (torch.empty_like(ux) for _ in range(3))
    deriv_errs = []
    for args, out in (((sxx, sxy, ux), X), ((None, syy, uy), Y), ((X, Y, None), D)):
        lfk.deriv_cuda(*args, out, mats, "high")
        plain = torch.empty_like(out)
        lfk.deriv_plain(*args, plain, mats, "high")
        deriv_errs.append(each(out, plain))
    assert torch.equal(D, dphi)
    flows = zip(("dphi", "df0"), (dphi, df0),
                lfk.flow_bwd_plain(dy, f2, planes, mats, 0., 1., nsteps, "high"),
                lfk.flow_bwd(dy, f2, planes, mats, 0., 1., nsteps, "f32"))
    print(f"white backward flow {shape}, nsteps {nsteps}: steps vs plain 'high' from the same "
          f"state {step_errs}; closing derivatives {deriv_errs}; whole flow "
          + ", ".join(f"{name} vs plain 'high' {each(x, p):.3e}, vs strict {each(x, st):.3e}, "
                      f"Frobenius ratio {split_ratio(x, p, st):.3f}" for name, x, p, st in flows))
    assert max(step_errs) < HIGH_TOL and max(deriv_errs) < HIGH_TOL, (step_errs, deriv_errs)


@pytest.mark.cuda
def test_IP_wiener_filter_kernel_matches_plain_on_card():
    """The slice at a test's size: the masked, beamed 64^2 IP Wiener
    filter on the kernel backend against the plain (cuFFT) one, strict,
    20 fixed CG iterations: f within 1e-4 in norm (each flow within 1e-5
    of its plain version, amplified by at most the iteration count); the
    same 20 iterations at 'high' throughout against the "matmul" backend
    (the same flows on their plain 'high' leaves, no launch): within 1e-4,
    and nearer it than the strict kernel solve; at "auto" the 'high' solve
    runs K2 'high' and ends finite."""
    _card()
    sim = ct.load_sim(thetapix=3, Nside=64, pol="IP", T=np.float32, muKarcminT=1, beamFWHM=2,
                      pixel_mask_kwargs=dict(edge_padding_deg=0.4, apodization_deg=0.2), seed=0,
                      device="cuda")
    ds, phi = sim["ds"], sim["phi"]
    fixed = dict(tol=0.0, nsteps=20, fixed_iters=True, hessian_precision=None)
    out = {}
    for backend in ("kernel", "plain"):
        with ct.lenseflow_backend_ctx(backend):
            out[backend] = ct.argmaxf_logpdf(ds, phi=phi, conjgrad_kwargs=fixed)[0]
    fk, fp = out["kernel"], out["plain"].to(out["kernel"].basis)
    err = float((fk.arr - fp.arr).norm() / fp.arr.norm())
    print(f"64^2 IP Wiener filter, kernel vs plain backend: {err:.3e}")
    assert err < 1e-4
    for backend in ("kernel", "matmul"):
        lfk.reset_launches()
        with ct.lenseflow_backend_ctx(backend), tderiv.precision_ctx("high"):
            out[backend, "high"] = ct.argmaxf_logpdf(ds, phi=phi, conjgrad_kwargs=fixed)[0].arr
        assert (lfk.LAUNCHES["flow_forward_high"] > 0) == (backend == "kernel"), lfk.LAUNCHES
    fhk, fhm = out["kernel", "high"], out["matmul", "high"]
    dist = lambda a, b: float((a - b).norm() / b.norm())
    print(f"at 'high', kernel vs matmul backend {dist(fhk, fhm):.3e}, vs the strict kernel "
          f"solve {dist(fhk, fk.arr):.3e}")
    assert dist(fhk, fhm) < 1e-4 and dist(fhk, fhm) < dist(fhk, fk.arr)
    lfk.reset_launches()
    with ct.lenseflow_backend_ctx("kernel"):
        fa, _ = ct.argmaxf_logpdf(ds, phi=phi, conjgrad_kwargs=dict(nsteps=30))
    assert torch.isfinite(fa.arr).all()
    assert all(lfk.LAUNCHES[k] > 0 for k in ("flow_forward_high", "flow_adjoint_high",
                                             "deriv_high")), lfk.LAUNCHES


def _check_bf16(shape, kernel, plain, label, tol=BF16_TOL):
    """kernel(out, precision) at 'bf16' against plain(out) (its plain
    'bf16' version) and the strict kernel: every plane within `tol` of
    plain 'bf16', and its Frobenius distance to plain 'bf16' under
    BF16_RATIO of that to strict."""
    o1, o2, o3 = (torch.full(shape, float("nan"), device="cuda") for _ in range(3))
    kernel(o1, "bf16")
    plain(o2)
    kernel(o3, "f32")
    each = lambda x, y: max(rel(a, b) for a, b in zip(x.reshape(-1, *shape[-2:]),
                                                       y.reshape(-1, *shape[-2:])))
    e = (each(o1, o2), each(o1, o3), split_ratio(o1, o2, o3))
    print(f"'bf16' {label} {tuple(shape)}: vs plain 'bf16' {e[0]:.3e}, vs strict {e[1]:.3e}, "
          f"Frobenius ratio {e[2]:.4f}")
    assert e[0] < tol and e[2] < BF16_RATIO, e
    return o1


@pytest.mark.cuda
@pytest.mark.parametrize("N,nb", FACTORED_CASES)
def test_factored_bf16_kernels_match_plain_bf16_on_card(N, nb):
    """The 'bf16' tier of K1, K3 (both roles) and K4 (one mma.sync a block
    product on the blocks' bf16 heads) against their plain 'bf16' versions
    (BF16_TOL) and the strict kernels (BF16_RATIO), every batch entry and
    output plane on its own; the 'bf16' counters count their launches; at
    radix 16 and 32 (channel groups) a second launch into a buffer of
    other contents gives the same bits."""
    _card()
    tp = ct.ProjLambert(N, N, thetapix=2, T=np.float32, device="cuda")
    ops = tderiv.deriv_ops(tp)
    phi, _, _ = _weak_lensing(N=N)
    planes = lfk.gradhess_plain(torch.as_tensor(phi, device="cuda"), ops)
    planes = torch.stack([planes * (1 - 0.05 * i) for i in range(nb)])
    g = torch.Generator(device="cuda").manual_seed(0)
    T = lambda *s: torch.randn(s, generator=g, device="cuda")
    ngroup = tderiv.radix_groups(N // 128)   # the radices whose outputs are checked twice

    def check(shape, kernel, plain, label):
        out = _check_bf16(shape, kernel, plain, f"{label} N={N} nb={nb}")
        if ngroup > 1:
            again = torch.zeros(shape, device="cuda")
            kernel(again, "bf16")
            assert torch.equal(again, out), f"{label}: two launches differ"

    lfk.reset_launches()
    a, b, c = T(nb, 1, N, N), T(nb, 1, N, N), T(nb, 1, N, N)
    for args in ((a, None, None), (None, b, None), (a, b, c)):
        check(a.shape, lambda o, p: lfk.fderiv_cuda(*args, o, ops, p),
              lambda o: lfk.fderiv_plain(*args, o, ops, "bf16"), "fderiv")
    assert lfk.LAUNCHES["fderiv_bf16"] == 4 * (2 if ngroup > 1 else 1)   # one launch a pass
    y = T(nb, 2, N, N)
    pt = _p_planes(0.3, planes)
    for kind in ("forward", "adjoint"):
        check(y.shape, lambda o, p: lfk.fvelocity_cuda(kind, y, o, planes, pt, ops, 2, 0.3, p),
              lambda o: lfk.fvelocity_plain(kind, y, o, planes, pt, ops, 2, 0.3, "bf16"), kind)
    yb = torch.cat([T(nb, 4, N, N), 1e-3 * T(nb, lfk.NACC, N, N)], dim=1)
    pt = _p_planes(0.7, planes)
    check(yb.shape, lambda o, p: lfk.fvelocity_cuda("backward", yb, o, planes, pt, ops, 2, 0.7, p),
          lambda o: lfk.fvelocity_plain("backward", yb, o, planes, pt, ops, 2, 0.7, "bf16"),
          "backward")
    twice = 2 if ngroup > 1 else 1
    # K3 and K4 one launch a pass on either tile
    assert all(lfk.LAUNCHES[f"{k}_bf16"] == 2 * lfk.pass_launches(N // 128, "bf16", kern) * twice
               for k, kern in (("fa_velocity_forward", "fa"), ("fa_velocity_adjoint", "fa"),
                               ("bv_velocity", "bv")))


# K1 at 'high' and 'bf16' (csrc/fderiv_sm90.cu): each tier's bound against
# its plain version and its Frobenius ratio
K1_TIER = {"high": (HIGH_TOL, HIGH_SPLIT_RATIO), "bf16": (BF16_TOL, BF16_RATIO)}


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["high", "bf16"])
def test_fderiv_sm90_block_products_match_plain_on_card(precision):
    """The redesigned K1's block products alone: with both butterflies the
    identity, channel c is the operand's row block c and output block r is
    channel r, so the kernel's output is its block products (each channel
    passing through the cluster's exchange as it is), against the plain
    version on the same operator at the tier, at 1024^2 (two CTAs a
    cluster) and 4096^2 (four), along both axes."""
    _card()
    for N in (1024, 4096):
        ops = tderiv.deriv_ops(ct.ProjLambert(N, N, thetapix=2, T=np.float32, device="cuda"))
        B = N // 128
        eye = torch.eye(B, device="cuda").expand(2, B, B).contiguous()
        ops = ops._replace(bfx=eye, bfy=eye)
        a = torch.randn((1, 1, N, N), generator=torch.Generator(device="cuda").manual_seed(3),
                        device="cuda")
        for args in ((a, None, None), (None, a, None)):
            o1, o2 = torch.full_like(a, float("nan")), torch.empty_like(a)
            lfk.fderiv_cuda(*args, o1, ops, precision)
            lfk.fderiv_plain(*args, o2, ops, precision)
            e = rel(o1, o2)
            print(f"K1 {precision} block products N={N} axis {'x' if args[0] is a else 'y'}: "
                  f"vs plain {e:.3e}")
            assert e < K1_TIER[precision][0], e


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["high", "bf16"])
@pytest.mark.parametrize("N,nb", [(N, nb) for N in (512, 1024, 2048, 4096) for nb in (1, 5)])
def test_fderiv_sm90_matches_plain_on_card(N, nb, precision):
    """K1 at 'high' and 'bf16' (csrc/fderiv_sm90.cu) at every built radix,
    at batch 1 and on 5 planes: d_x a, d_y b and d_x a + d_y b + c against
    the plain version at the tier (each plane within HIGH_TOL or BF16_TOL)
    and the strict kernel (the Frobenius ratio; at 'high' HIGH_VS_STRICT
    too); into buffers of NaN, 1e30 and zeros the same bits, nothing
    written past the last plane; one launch a pass at every radix."""
    _card()
    ops = tderiv.deriv_ops(ct.ProjLambert(N, N, thetapix=2, T=np.float32, device="cuda"))
    g = torch.Generator(device="cuda").manual_seed(0)
    a, b, c = (torch.randn((nb, 1, N, N), generator=g, device="cuda") for _ in range(3))
    tol, ratio = K1_TIER[precision]
    lfk.reset_launches()
    for args in ((a, None, None), (None, b, None), (a, b, c)):
        ref, strict = torch.empty_like(a), torch.empty_like(a)
        lfk.fderiv_plain(*args, ref, ops, precision)
        lfk.fderiv_cuda(*args, strict, ops, "f32")
        first = None
        for fill in (float("nan"), 1e30, 0.0):
            buf = torch.full((nb + 1, 1, N, N), fill, device="cuda")
            lfk.fderiv_cuda(*args, buf[:nb], ops, precision)
            past = buf[nb]
            assert (torch.isnan(past) if fill != fill else past == fill).all(), "wrote past"
            first = buf[:nb].clone() if first is None else first
            assert torch.equal(buf[:nb], first), (fill, "not the same bits")
            del buf
        each = lambda x, y: max(rel(p, q) for p, q in zip(x.reshape(-1, N, N), y.reshape(-1, N, N)))
        e = (each(first, ref), each(first, strict), split_ratio(first, ref, strict))
        print(f"K1 {precision} N={N} nb={nb} {[x is not None for x in args]}: vs plain {e[0]:.3e}, "
              f"vs strict {e[1]:.3e}, Frobenius ratio {e[2]:.4f}")
        assert e[0] < tol and e[2] < ratio, e
        assert precision != "high" or e[1] < HIGH_VS_STRICT, e
    assert lfk.LAUNCHES["fderiv_" + precision] == 3 * 4   # 3 buffers x 4 passes


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 256, 256), (1, 160, 200), (4, 300, 300), (2, 600, 600)])
def test_deriv_bf16_matches_plain_on_card(shape):
    """K2's 'bf16' derivative (deriv_bf16_kernel: a 32 x TN tile's whole
    contraction in one block, 128 values at a time through a ring of two)
    on the IP slice's three 256^2 planes (TN 64), a ragged rectangle (TN
    32), four 300^2 planes (TN 64, ragged tiles, circulant rows not 16-byte
    aligned) and two 600^2 planes (TN 64, five chunks an axis): d_x a,
    d_y b and d_x a + d_y b + c within BF16_DENSE_TOL of plain 'bf16' on
    every plane, the same bits twice, nothing written past
    the last plane; one launch each."""
    _card()
    n, Ny, Nx = shape
    mats = tderiv.deriv_mats(ct.ProjLambert(Ny, Nx, thetapix=3, T=np.float32, device="cuda"))
    g = torch.Generator(device="cuda").manual_seed(4)
    a, b, c = (torch.randn(shape, generator=g, device="cuda") for _ in range(3))
    lfk.reset_launches()
    for args in ((a, None, None), (None, b, None), (a, b, c)):
        ref = torch.empty_like(a)
        lfk.deriv_plain(*args, ref, mats, "bf16")
        outs = []
        for fill in (float("nan"), 0.0):
            buf = torch.full((n + 1, Ny, Nx), fill, device="cuda")
            lfk.deriv_cuda(*args, buf[:n], mats, "bf16")
            assert (torch.isnan(buf[n]) if fill != fill else buf[n] == 0).all(), "wrote past"
            outs.append(buf[:n])
        assert torch.equal(*outs)
        e = max(rel(p, q) for p, q in zip(outs[0], ref))
        print(f"K2 bf16 deriv {shape} {[x is not None for x in args]}: vs plain {e:.3e}")
        assert e < BF16_DENSE_TOL, e
    assert lfk.LAUNCHES["deriv_bf16"] == 6


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 64), (256, 256), (200, 200), (33, 45)])
def test_dense_bf16_kernels_match_plain_bf16_on_card(shape):
    """K2 'bf16' (csrc/lenseflow.cu, TIER_BF16: one mma.sync on the
    circulant's bf16 head and the rounded operand) at whole tiles and at
    ragged edge tiles: lf_deriv with each operand set, one launch each,
    against the plain 'bf16' version (BF16_DENSE_TOL: the same rounded
    operands) and the strict kernel (BF16_RATIO), nothing written past
    the last plane; the 'bf16' counters count their launches. The whole
    flow at 'bf16': test_whole_flow_matches_plain_on_card."""
    _card()
    Ny, Nx = shape
    tp = ct.ProjLambert(Ny, Nx, thetapix=3, T=np.float32, device="cuda")
    mats = tderiv.deriv_mats(tp)
    phi_f = np.zeros((1, Ny, Nx // 2 + 1), np.complex128)
    phi_f[0, 1, 1] = 1e-3 * (Ny * Nx / 1024) ** 2
    phi = torch.as_tensor(np.fft.irfft2(phi_f, s=(Ny, Nx)).astype(np.float32), device="cuda")
    planes = lfk.gradhess_plain(phi, mats)
    g = torch.Generator(device="cuda").manual_seed(0)
    T = lambda *s: torch.randn(s, generator=g, device="cuda")

    def check(shape_, kernel, plain, label):
        n = shape_[0]
        full = torch.full((n + 1,) + tuple(shape_[1:]), float("nan"), device="cuda")
        _check_bf16(shape_, kernel, plain, label, BF16_DENSE_TOL)
        kernel(full[:n], "bf16")
        assert torch.isnan(full[n]).all(), f"{label} wrote past the last plane"

    lfk.reset_launches()
    a, b, c = T(3, Ny, Nx), T(3, Ny, Nx), T(3, Ny, Nx)
    for args in ((a, None, None), (None, b, None), (a, b, c)):
        check(a.shape, lambda o, p: lfk.deriv_cuda(*args, o, mats, p),
              lambda o: lfk.deriv_plain(*args, o, mats, "bf16"), "deriv")
    assert lfk.LAUNCHES["deriv_bf16"] == 6


@pytest.mark.cuda
@pytest.mark.parametrize("N", [256, 1024])
def test_bf16_flows_match_plain_bf16_on_card(N):
    """Whole flows at 'bf16' at nsteps 7, dense (256^2) and factored
    (1024^2), on a Cphi-drawn phi and a Cf-drawn f: each output plane
    within BF16_TOL of the plain 'bf16' flow and nearer it than the strict
    flow (FLOW_SPLIT_RATIO); only 'bf16' kernels launch for the products."""
    _card()
    tp = ct.ProjLambert(N, N, thetapix=3 if N == 256 else 2, T=np.float32, device="cuda")
    mats = tderiv.deriv_ops(tp)
    rng = np.random.default_rng(3)
    Cl = ct.camb()
    white = lambda n, pol: ct.Field(torch.as_tensor(
        rng.standard_normal((n, N, N)).astype(np.float32), device="cuda"), ct.Basis(pol, "map"), tp)
    pm = (ct.Cl_to_Cov("I", tp, Cl["total"]["pp"]).sqrt() @ white(1, "I")).to(ct.MAP).arr
    Cf = ct.Cl_to_Cov("P", tp, Cl["unlensed_scalar"]["EE"], Cl["unlensed_scalar"]["BB"])
    ft = (Cf.sqrt() @ white(2, "QU")).to(ct.QU_MAP).arr.contiguous()
    dyt = white(2, "QU").arr
    planes = lfk.gradhess(pm, mats)
    each = lambda x, y: max(rel(a, b) for a, b in zip(x.reshape(-1, N, N), y.reshape(-1, N, N)))
    found = {}
    lfk.reset_launches()
    for kind, t0, t1 in (("forward", 0., 1.), ("forward", 1., 0.), ("adjoint", 1., 0.)):
        k = lfk.flow_apply(ft, planes, mats, t0, t1, 7, kind, "bf16")
        found[(kind, t0)] = (k, lfk.flow_apply_plain(ft, planes, mats, t0, t1, 7, kind, "bf16"),
                             lfk.flow_apply(ft, planes, mats, t0, t1, 7, kind, "f32"))
    for name, x, y, z in zip(("backward dphi", "backward df0"),
                             lfk.flow_bwd(dyt, ft, planes, mats, 0., 1., 7, "bf16"),
                             lfk.flow_bwd_plain(dyt, ft, planes, mats, 0., 1., 7, "bf16"),
                             lfk.flow_bwd(dyt, ft, planes, mats, 0., 1., 7, "f32")):
        found[name] = (x, y, z)
    for name, (k, p, st) in found.items():
        e = (each(k, p), each(k, st), split_ratio(k, p, st))
        print(f"'bf16' flow {name} {N}^2: vs plain 'bf16' {e[0]:.3e}, vs strict {e[1]:.3e}, "
              f"ratio {e[2]:.4f}")
        assert e[0] < BF16_TOL and e[2] < FLOW_SPLIT_RATIO, (name, e)
    bf16 = sum(v for k_, v in lfk.LAUNCHES.items() if k_.endswith("_bf16"))
    high = sum(v for k_, v in lfk.LAUNCHES.items() if k_.endswith("_high"))
    assert bf16 > 0 and high == 0


# K3 and K5 at 'high' and 'bf16' on the tile lenseflow_kernels.FORMS puts
# them on (the cluster tile, csrc/fa_sm90.cu, csrc/uni_sm90.cu, at radix
# 16 and 32; fact_tile at 4 and 8): every built radix, at batch 1 and on 17
# trials (to 2048^2; 4096^2 at batch 1)
SM90_CASES = [(N, nb) for N in (512, 1024, 2048, 4096) for nb in (1, 17) if nb == 1 or N < 4096]


def _same_bits(shape, kernel):
    """kernel(out) into buffers of NaN, 1e30 and zeros with one more
    (sentinel) plane behind out: finite, the same bits for every buffer,
    the sentinel untouched. Returns the output."""
    first = None
    for fill in (float("nan"), 1e30, 0.0):
        full = torch.full((shape[0] + 1,) + tuple(shape[1:]), fill, device="cuda")
        kernel(full[:shape[0]])
        past = full[shape[0]]
        assert (torch.isnan(past) if fill != fill else past == fill).all(), (fill, "wrote past")
        assert torch.isfinite(full[:shape[0]]).all(), fill
        first = full[:shape[0]].clone() if first is None else first
        assert torch.equal(full[:shape[0]], first), (fill, "not the same bits")
        del full
    return first


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["high", "bf16"])
@pytest.mark.parametrize("N,nb", SM90_CASES)
def test_fa_sm90_matches_plain_on_card(N, nb, precision):
    """K3 at 'high' and 'bf16' (csrc/fa_sm90.cu at radix 16 and 32, as
    FORMS puts it), both roles, at every built radix, on nb batch entries
    each with its own phi: against the
    plain version at the tier (each plane within HIGH_TOL or BF16_TOL) and
    the strict kernel (the Frobenius ratio; at 'high' HIGH_VS_STRICT too);
    into buffers of NaN, 1e30 and zeros finite and the same bits, nothing
    written past the last entry; one launch a pass at every radix."""
    _card()
    ops = tderiv.deriv_ops(ct.ProjLambert(N, N, thetapix=2, T=np.float32, device="cuda"))
    phi, _, _ = _weak_lensing(N=N)
    planes = lfk.gradhess_plain(torch.as_tensor(phi, device="cuda"), ops)
    planes = torch.stack([planes * (1 - 0.05 * i) for i in range(nb)])
    y = torch.randn((nb, 2, N, N), generator=torch.Generator(device="cuda").manual_seed(2),
                    device="cuda")
    pt = _p_planes(0.3, planes)
    tol, ratio = K1_TIER[precision]
    each = lambda x, z: max(rel(u, v) for u, v in zip(x.reshape(-1, N, N), z.reshape(-1, N, N)))
    for kind in ("forward", "adjoint"):
        ref, strict = torch.empty_like(y), torch.empty_like(y)
        lfk.fvelocity_plain(kind, y, ref, planes, pt, ops, 2, 0.3, precision)
        lfk.fvelocity_cuda(kind, y, strict, planes, pt, ops, 2, 0.3, "f32")
        lfk.reset_launches()
        got = _same_bits(y.shape, lambda o: lfk.fvelocity_cuda(kind, y, o, planes, pt, ops, 2,
                                                                 0.3, precision))
        assert lfk.LAUNCHES[f"fa_velocity_{kind}_{precision}"] == 3 * 2   # 3 buffers x 2 passes
        e = (each(got, ref), each(got, strict), split_ratio(got, ref, strict))
        print(f"K3 {precision} {kind} N={N} nb={nb}: vs plain {e[0]:.3e}, vs strict {e[1]:.3e}, "
              f"Frobenius ratio {e[2]:.4f}")
        assert e[0] < tol and e[2] < ratio, e
        assert precision != "high" or e[1] < HIGH_VS_STRICT, e


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["high", "bf16"])
@pytest.mark.parametrize("N,nb", SM90_CASES)
def test_uni_sm90_roles_match_plain_on_card(N, nb, precision):
    """K5 at 'high' and 'bf16' (csrc/uni_sm90.cu at radix 16 and 32, as
    FORMS puts it), every role and stage, at every built radix, on strided
    views of an (nb, 5, N, N) flow state: against the plain version at the
    tier and the strict kernel (_check_uni_roles: the zero planes exact,
    nothing written past the last plane); into buffers of NaN, 1e30 and
    zeros finite and the same bits; one launch a pass and stage at every
    radix; on the cluster tile a view it cannot read as pixel pairs (an
    odd stride) refused, on fact_tile taken."""
    _card()
    ops = tderiv.deriv_ops(ct.ProjLambert(N, N, thetapix=2, T=np.float32, device="cuda"))
    px, py, roles = _uni_role_inputs(N, ops, nb=nb)
    lfk.reset_launches()
    _check_uni_roles(ops, px, py, roles, precision, UNI_TOL[precision], f"{N}^2 nb {nb}",
                     sentinel=True)
    # 2 launches at the tier a call (role 1: 4), _check_uni_roles's two calls
    assert [lfk.LAUNCHES[f"uni_role{r}_{precision}"] for r in range(4)] == [4, 8, 4, 4]
    for role, a, b in roles:
        _same_bits((nb, a.shape[1], 4, N, N), lambda o: lfk.uni_velocity_cuda(
            role, a, b, px, py, o.view(nb, a.shape[1], 4, N, N), ops, 0.6, precision))
    odd = torch.empty((nb, 1, N * N + 1), device="cuda")[..., 1:].view(nb, 1, N, N)
    run = lambda: lfk.uni_velocity_cuda(2, odd, odd, px, py,
                                        torch.empty((nb, 1, 4, N, N), device="cuda"), ops, 0.6,
                                        precision)
    if lfk.FORMS["uni", precision, N // 128] == "cluster":
        with pytest.raises(ValueError, match="8-byte aligned"):
            run()
    else:
        run()
        torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("N,nb", [(N, nb) for N in (2048, 4096) for nb in (1, 17)])
def test_strict_k3_k5_on_the_cluster_tile_at_radix_16_and_32_on_card(N, nb):
    """Strict K3 (both roles) and K5 (every role and stage) at radix 16
    and 32, which run the cluster tile's FP32 tier (csrc/fa_sm90.cu,
    csrc/uni_sm90.cu), on nb batch entries each with its own phi: every
    output plane within TOL of the plain version; into buffers of NaN,
    1e30 and zeros finite and the same bits, nothing written past the last
    entry; the planes a K5 role leaves at zero exactly zero; one launch a
    pass (and stage) on the counters."""
    _card()
    assert all(lfk.FORMS[k, "f32", N // 128] == "cluster" for k in ("fa", "uni"))
    ops = tderiv.deriv_ops(ct.ProjLambert(N, N, thetapix=2, T=np.float32, device="cuda"))
    phi, _, _ = _weak_lensing(N=N)
    planes = lfk.gradhess_plain(torch.as_tensor(phi, device="cuda"), ops)
    planes = torch.stack([planes * (1 - 0.05 * i) for i in range(nb)])
    g = torch.Generator(device="cuda").manual_seed(5)
    y = torch.randn((nb, 2, N, N), generator=g, device="cuda")
    pt = _p_planes(0.3, planes)
    each = lambda x, z: max(rel(u, v) for u, v in zip(x.reshape(-1, N, N), z.reshape(-1, N, N)))
    for kind in ("forward", "adjoint"):
        ref = torch.empty_like(y)
        lfk.fvelocity_plain(kind, y, ref, planes, pt, ops, 2, 0.3)
        lfk.reset_launches()
        got = _same_bits(y.shape, lambda o: lfk.fvelocity_cuda(kind, y, o, planes, pt, ops, 2,
                                                                 0.3))
        assert lfk.LAUNCHES[f"fa_velocity_{kind}"] == 3 * 2   # 3 buffers x 2 passes
        e = each(got, ref)
        print(f"strict K3 {kind} N={N} nb={nb}: vs plain {e:.3e}")
        assert e < TOL, e
        del ref, got
    del y, pt
    px, py = (p.unsqueeze(1).contiguous() for p in lfk._p_of_t(0.6, planes))
    del planes
    state = torch.randn((nb, 5, N, N), generator=g, device="cuda")
    roles = ((0, state[:, :2], state[:, 2:4]), (1, state[:, 4:], 1e-2 * state[:, :1]),
             (2, state[:, :1], state[:, 1:2]), (3, state[:, :1], state[:, 1:2]))
    for role, a, b in roles:
        shape = (nb, a.shape[1], 4, N, N)
        ref = torch.empty(shape, device="cuda")
        lfk.uni_velocity_plain(role, a, b, px, py, ref, ops, 0.6)
        lfk.reset_launches()
        got = _same_bits(shape, lambda o: lfk.uni_velocity_cuda(role, a, b, px, py, o, ops, 0.6))
        assert lfk.LAUNCHES[f"uni_role{role}"] == 3 * (4 if role == 1 else 2)
        n = UNI_NONZERO[role]
        e = each(got[:, :, :n], ref[:, :, :n])
        print(f"strict K5 role {role} N={N} nb={nb}: vs plain {e:.3e}")
        assert e < TOL, (role, e)
        assert (got[:, :, n:] == 0).all(), role
        del ref, got


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "high", "bf16"])
@pytest.mark.parametrize("N", [512, 1024])
def test_k3_k5_entries_run_only_the_tile_forms_names_on_card(N, precision):
    """At radix 4 and 8 csrc/ builds K3, K4 and K5 on the one tile FORMS
    names for each tier (the build passes FORMS to nvcc,
    _build.form_flags), and no other form: lf_fa_velocity, lf_bv_velocity
    and lf_uni_velocity run the pass forms FORMS gives (rc 0, a finite
    output) and refuse every other choice (either pass on the other tile)
    with cudaErrorInvalidValue; lf_fderiv, K1 on its one form, the cluster
    tile, runs (rc 0, a finite output)."""
    _card()
    from cmblensing_tpu_torch.ops import _build
    B, stream = N // 128, lfk._stream()
    lib, tier = _build.load(), lfk.PRECISIONS.index(precision)
    ops = tderiv.deriv_ops(ct.ProjLambert(N, N, thetapix=2, T=np.float32, device="cuda"))
    phi, _, _ = _weak_lensing(N=N)
    planes = lfk.gradhess_plain(torch.as_tensor(phi, device="cuda"), ops)[None]
    y = torch.randn((1, 2, N, N), generator=torch.Generator(device="cuda").manual_seed(6),
                    device="cuda")
    pt = _p_planes(0.3, planes)
    px, py, roles = _uni_role_inputs(N, ops)
    _, a, b = roles[2]
    strides = [*lfk._plane_strides("lf_uni_velocity", a, N, N),
               *lfk._plane_strides("lf_uni_velocity", b, N, N)]
    for forms in range(4):
        o = torch.full_like(y, float("nan"))
        _, ptrs = lfk._operands("lf_fa_velocity", ops, y, precision, forms)
        rc = lib.lf_fa_velocity(tier, forms, 0, lfk._ptr(y), lfk._ptr(o), lfk._ptr(pt), *ptrs, B,
                                B, 1, 2, N, N, stream)
        torch.cuda.synchronize()
        if forms == lfk._forms("fa", precision, B, B):
            assert rc == 0 and torch.isfinite(o).all(), forms
        else:
            assert rc == 1, (forms, rc)
        o = torch.full((2, 1, 4, N, N), float("nan"), device="cuda")
        _, ptrs = lfk._operands("lf_uni_velocity", ops, o, precision, forms)
        rc = lib.lf_uni_velocity(tier, forms, 2, lfk._ptr(a), lfk._ptr(b), *strides,
                                 lfk._ptr(px), lfk._ptr(py), lfk._ptr(o), None, *ptrs, B, B, 2, 1,
                                 N, N, 0.6, stream)
        torch.cuda.synchronize()
        if forms == lfk._forms("uni", precision, B, B):
            assert rc == 0 and torch.isfinite(o).all(), forms
        else:
            assert rc == 1, (forms, rc)
        yb = torch.cat([y, y, 1e-3 * y[:, :1].expand(1, lfk.NACC, N, N)], dim=1).contiguous()
        o = torch.full_like(yb, float("nan"))
        _, ptrs = lfk._operands("lf_bv_velocity", ops, yb, precision, forms)
        rc = lib.lf_bv_velocity(tier, forms, lfk._ptr(yb), lfk._ptr(o), lfk._ptr(planes),
                                lfk._ptr(pt), *ptrs, B, B, 1, 2, N, N, 0.3, stream)
        torch.cuda.synchronize()
        if forms == lfk._forms("bv", precision, B, B):
            assert rc == 0 and torch.isfinite(o).all(), forms
        else:
            assert rc == 1, (forms, rc)
    o = torch.full_like(y, float("nan"))
    assert lfk._forms("fderiv", precision, B, B) == 3
    _, ptrs = lfk._operands("lf_fderiv", ops, y, precision, 3)
    rc = lib.lf_fderiv(tier, lfk._ptr(y[:, 0]), lfk._ptr(y[:, 1]), None, lfk._ptr(o[:, 0]), *ptrs,
                       B, B, 1, N, N, stream)
    torch.cuda.synchronize()
    assert rc == 0 and torch.isfinite(o[:, 0]).all()


# K4 at every tier and strict K1 on the tile FORMS names (the cluster tile,
# csrc/bv_sm90.cu and csrc/fderiv_sm90.cu, at radix 16 and 32), at 512^2 to
# 2048^2: (N, batch, components)
K4_CASES = [(512, 1, 1), (512, 3, 3), (1024, 1, 2), (1024, 3, 2), (2048, 1, 2), (2048, 2, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "high", "bf16"])
@pytest.mark.parametrize("N,nb,ncomp", K4_CASES)
def test_k4_on_the_tile_forms_names_matches_plain_on_card(N, nb, ncomp, precision):
    """K4 (lf_bv_velocity) on the tile FORMS names, on nb backward states of
    ncomp components each with its own phi: every output plane (k_f, k_df,
    the five delta-phi integrands) against the plain version at the tier
    (TOL; 'high' and 'bf16' K1_TIER's bound and Frobenius ratio to the
    strict kernel, at 'high' HIGH_VS_STRICT too); into buffers of NaN, 1e30
    and zeros finite and the same bits, nothing written past the last
    entry; one launch a pass; k_f and k_df bit for bit those of K5 role 0
    (lf_uni_velocity) on the same state and p(t) planes, as the uni flows'
    delta f is the kernel backend's."""
    _card()
    ops = tderiv.deriv_ops(ct.ProjLambert(N, N, thetapix=2, T=np.float32, device="cuda"))
    phi, _, _ = _weak_lensing(N=N)
    planes = lfk.gradhess_plain(torch.as_tensor(phi, device="cuda"), ops)
    planes = torch.stack([planes * (1 - 0.05 * i) for i in range(nb)])
    g = torch.Generator(device="cuda").manual_seed(7)
    yb = torch.cat([torch.randn((nb, 2 * ncomp, N, N), generator=g, device="cuda"),
                    1e-3 * torch.randn((nb, lfk.NACC, N, N), generator=g, device="cuda")], dim=1)
    pt = _p_planes(0.7, planes)
    run = lambda o, p: lfk.fvelocity_cuda("backward", yb, o, planes, pt, ops, ncomp, 0.7, p)
    ref, strict = torch.empty_like(yb), torch.empty_like(yb)
    lfk.fvelocity_plain("backward", yb, ref, planes, pt, ops, ncomp, 0.7, precision)
    run(strict, "f32")
    sfx = "" if precision == "f32" else "_" + precision
    lfk.reset_launches()
    got = _same_bits(yb.shape, lambda o: run(o, precision))
    assert lfk.LAUNCHES["bv_velocity" + sfx] == 3 * 2   # 3 buffers x 2 passes
    each = lambda x, z: max(rel(x[j, i], z[j, i]) for j in range(nb) for i in range(x.shape[1]))
    e = each(got, ref)
    if precision == "f32":
        print(f"K4 strict N={N} nb={nb} ncomp={ncomp}: vs plain {e:.3e}")
        assert e < TOL, e
    else:
        tol, ratio = K1_TIER[precision]
        r = split_ratio(got, ref, strict)
        print(f"K4 {precision} N={N} nb={nb} ncomp={ncomp}: vs plain {e:.3e}, vs strict "
              f"{each(got, strict):.3e}, Frobenius ratio {r:.4f}")
        assert e < tol and r < ratio, (e, r)
        assert precision != "high" or each(got, strict) < HIGH_VS_STRICT
    out = torch.empty((nb, ncomp, 4, N, N), device="cuda")
    lfk.uni_velocity_cuda(0, yb[:, :ncomp], yb[:, ncomp:2 * ncomp], pt[0].unsqueeze(1),
                          pt[1].unsqueeze(1), out, ops, 0.7, precision)
    torch.cuda.synchronize()
    assert torch.equal(got[:, :ncomp], out[:, :, 0]), "k_f against K5 role 0"
    assert torch.equal(got[:, ncomp:2 * ncomp], out[:, :, 1]), "k_df against K5 role 0"


@pytest.mark.cuda
@pytest.mark.parametrize("N,nb", [(N, nb) for N in (512, 1024, 2048) for nb in (1, 5)])
def test_strict_k1_on_the_tile_forms_names_matches_plain_on_card(N, nb):
    """Strict K1 (lf_fderiv) on the tile FORMS names (the cluster tile's
    FP32 tier at radix 16 and 32, csrc/fderiv_sm90.cu): d_x a, d_y b and
    d_x a + d_y b + c on nb planes within TOL of the plain version, every
    plane on its own; into buffers of NaN, 1e30 and zeros finite and the
    same bits, nothing written past the last plane; one launch a pass."""
    _card()
    ops = tderiv.deriv_ops(ct.ProjLambert(N, N, thetapix=2, T=np.float32, device="cuda"))
    g = torch.Generator(device="cuda").manual_seed(8)
    a, b, c = (torch.randn((nb, 1, N, N), generator=g, device="cuda") for _ in range(3))
    for args, npass in (((a, None, None), 1), ((None, b, None), 1), ((a, b, c), 2)):
        ref = torch.empty_like(a)
        lfk.fderiv_plain(*args, ref, ops)
        lfk.reset_launches()
        got = _same_bits(a.shape, lambda o: lfk.fderiv_cuda(*args, o, ops))
        assert lfk.LAUNCHES["fderiv"] == 3 * npass
        e = max(rel(got[i], ref[i]) for i in range(nb))
        print(f"strict K1 N={N} nb={nb} passes {npass}: vs plain {e:.3e}")
        assert e < TOL, e


# the whole-flow kernel's cases: the main path's 256^2 P, the IP slice's
# 3 x 256^2 (its third component a rolled copy of the first), and edge
# shapes (ragged tiles); each tier's bound for a flow (PERF.md §2)
WHOLE_FLOW_CASES = [(256, 256, 2), (256, 256, 3), (200, 200, 2), (160, 200, 2)]
FLOW_TIER_TOL = {"f32": TOL, "high": HIGH_TOL, "bf16": BF16_TOL}


def _drawn_inputs(Ny, Nx, ncomp, seed=3):
    """mats, phi planes and f, dy drawn from the fiducial Cphi and Cf (pol
    P; a third component, where asked, a rolled copy of the first)."""
    tp = ct.ProjLambert(Ny, Nx, thetapix=3, T=np.float32, device="cuda")
    mats = tderiv.deriv_mats(tp)
    rng = np.random.default_rng(seed)
    Cl = ct.camb()
    white = lambda n, pol: ct.Field(torch.as_tensor(
        rng.standard_normal((n, Ny, Nx)).astype(np.float32), device="cuda"),
        ct.Basis(pol, "map"), tp)
    pm = (ct.Cl_to_Cov("I", tp, Cl["total"]["pp"]).sqrt() @ white(1, "I")).to(ct.MAP).arr
    Cf = ct.Cl_to_Cov("P", tp, Cl["unlensed_scalar"]["EE"], Cl["unlensed_scalar"]["BB"])
    f = (Cf.sqrt() @ white(2, "QU")).to(ct.QU_MAP).arr
    dy = white(2, "QU").arr
    if ncomp == 3:
        f, dy = (torch.cat([x, torch.roll(x[:1], 17, dims=-1)]) for x in (f, dy))
    return mats, lfk.gradhess_plain(pm, mats), f.contiguous(), dy.contiguous()


def _flow_state(kind, f, dy):
    if kind != "backward":
        return f
    acc = torch.zeros(f.shape[:-3] + (lfk.NACC,) + f.shape[-2:], device=f.device)
    return torch.cat([f, dy, acc], dim=-3).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "high", "bf16"])
@pytest.mark.parametrize("Ny,Nx,ncomp", WHOLE_FLOW_CASES)
def test_whole_flow_matches_plain_on_card(Ny, Nx, ncomp, precision):
    """K2, one launch a whole dense flow (csrc/dense_flow.cu), every kind,
    at nsteps 7: every state plane within the tier's bound of the plain
    leaves walking the same stage table, and at 'high' and 'bf16' nearer it
    than the strict kernel flow (FLOW_SPLIT_RATIO); the same bits on two
    calls; one launch a flow on the launch counter."""
    _card()
    mats, planes, f, dy = _drawn_inputs(Ny, Nx, ncomp)
    sfx = "" if precision == "f32" else "_" + precision
    each = lambda x, y: max(rel(a, b) for a, b in zip(x.reshape(-1, Ny, Nx), y.reshape(-1, Ny, Nx)))
    for kind in ("forward", "adjoint", "backward"):
        y = _flow_state(kind, f, dy)
        lfk.reset_launches()
        k, p = _flow_pair(kind, y, planes, mats, ncomp, 7, precision)
        assert {n: v for n, v in lfk.LAUNCHES.items() if v} == {f"flow_{kind}{sfx}": 1}
        again, _ = _flow_pair(kind, y, planes, mats, ncomp, 7, precision, plain_too=False)
        e = each(k, p)
        line = f"whole flow {kind} {ncomp} x {Ny}x{Nx} {precision}: vs plain {e:.3e}"
        if precision != "f32":
            st, _ = _flow_pair(kind, y, planes, mats, ncomp, 7, "f32", plain_too=False)
            r = split_ratio(k, p, st)
            line += f", Frobenius ratio {r:.4f}"
            assert r < FLOW_SPLIT_RATIO, (kind, r)
        print(line)
        assert e < FLOW_TIER_TOL[precision], (kind, e)
        assert torch.equal(k, again), kind


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 64), (200, 200)])
def test_whole_flow_batch_is_the_single_flows_bits_on_card(shape):
    """Three batch entries, each its own phi and state, in one launch of
    the flow kernel give each entry's single flow bit for bit, at every
    kind and tier."""
    _card()
    Ny, Nx = shape
    mats, planes, f, dy = _drawn_inputs(Ny, Nx, 2)
    phis = torch.stack([s * planes for s in (0.5, 1.0, 1.5)])
    for kind in ("forward", "adjoint", "backward"):
        ys = torch.stack([torch.roll(_flow_state(kind, f, dy), 7 * i, dims=-1) for i in range(3)])
        for precision in ("f32", "high", "bf16"):
            sfx = "" if precision == "f32" else "_" + precision
            lfk.reset_launches()
            out, _ = _flow_pair(kind, ys, phis, mats, 2, 7, precision, plain_too=False)
            assert {n: v for n, v in lfk.LAUNCHES.items() if v} == {f"flow_{kind}{sfx}": 1}
            for i in range(3):
                one, _ = _flow_pair(kind, ys[i], phis[i], mats, 2, 7, precision, plain_too=False)
                assert torch.equal(out[i], one), (kind, precision, i)


# =========================================================================
# batched sims and the Gibbs/HMC sampler at 512^2 P (BASELINE.json
# configs[3], scripts/torch_sample_512.py)
# =========================================================================

SAMPLE_CG = dict(tol=0.0, nsteps=25, fixed_iters=True)
# a Gibbs pass on the kernel backend against the plain one (torch.fft
# flows): 25 fixed CG iterations amplify the flows' float32 differences
# (1e-5 a flow) as in chip_smoke.py's 20-iteration Wiener filter (1e-4)
GIBBS_PLAIN_TOL = 1e-4
# dH of the two backends, absolute: each Hamiltonian is a float32 sum of
# ~6e6 a sim at 512^2 P (its ulp 0.5, so dH comes in steps of 0.5 on
# either side), and the two backends' logpdfs differ by their flows'
# float32 rounding: 8 ulps (measured 1.5)
GIBBS_DH_ATOL = 4.0


@pytest.mark.cuda
def test_gibbs_pass_kernel_matches_plain_on_card(monkeypatch):
    """One default Gibbs pass of sample_joint at 512^2 P x 2 sims (N = 3
    leapfrog steps, eps 0.003, 25 fixed CG iterations) on the kernel
    backend against the plain one, from one generator seed (so one prior
    phi and the same draws). The pass is a chain's first, always accepted
    (as BASELINE.json configs[3]'s first three are), so phi carries each
    backend's HMC trajectory: f, phi and the logpdf within GIBBS_PLAIN_TOL,
    dH within GIBBS_DH_ATOL, and the accept each dH gives against the same
    uniform, log u < dH, the same wherever log u lies farther than
    GIBBS_DH_ATOL from dH."""
    _card()
    from cmblensing_tpu_torch.inference import sampling as ts
    ds = ct.load_sim(thetapix=2, Nside=512, pol="P", seed=0, Nbatch=2)["ds"]
    draw, runs = ts._uniform, {}
    for backend in ("kernel", "plain"):
        us = []
        monkeypatch.setattr(ts, "_uniform", lambda g, shape: us.append(draw(g, shape)) or us[-1])
        g = torch.Generator(device="cuda")
        g.manual_seed(5)
        with ct.lenseflow_backend_ctx(backend):
            res = ct.sample_joint(ds, 1, nchains=2, generator=g, symp_kwargs=[dict(N=3, eps=0.003)],
                                  nburnin_always_accept=1, conjgrad_kwargs=SAMPLE_CG)
        runs[backend] = (res[0][0], us)
    (k, uk), (p, up) = runs["kernel"], runs["plain"]
    assert all(torch.equal(a, b) for a, b in zip(uk, up))
    for name in ("f", "phi"):
        e = rel(k[name].to(ct.Basis(k[name].basis.pol, "map")).arr,
                p[name].to(ct.Basis(k[name].basis.pol, "map")).arr)
        print(f"Gibbs pass kernel vs plain: {name} {e:.3e}")
        assert e < GIBBS_PLAIN_TOL, name
    assert rel(k["logpdf"], p["logpdf"]) < GIBBS_PLAIN_TOL
    assert torch.isfinite(k["logpdf"]).all() and bool(k["accept"].all())
    logu = torch.log(uk[0]).cpu()
    print(f"dH kernel {k['dH'].tolist()} plain {p['dH'].tolist()}, log u {logu.tolist()}")
    assert float((k["dH"] - p["dH"]).abs().max()) < GIBBS_DH_ATOL
    clear = (logu - k["dH"]).abs() > GIBBS_DH_ATOL
    assert torch.equal((logu < k["dH"])[clear], (logu < p["dH"])[clear])


@pytest.mark.cuda
def test_hmc_gradient_batch_matches_single_gradients_on_card():
    """The HMC gradient (grad phi° of the mixed logpdf) at 512^2 P for a
    batch of 3 (three f° and phi°) against the three single gradients, bit
    for bit: the flows' kernels give each entry its single bits, and so do
    cuFFT's batched plans (both checked on their own)."""
    _card()
    sim = ct.load_sim(thetapix=2, Nside=512, pol="P", seed=0)
    ds, f, phi = sim["ds"], sim["f"], sim["phi"]
    ds3 = ds.replace(d=ct.repeat_batch(ds.d, 3))
    m = ct.mix(ds3, f=ct.batch([f, 0.5 * f, -1.0 * f]), phi=ct.batch([phi, 0.8 * phi, 1.2 * phi]))
    f_mix, phi_mix = m["f_mix"], m["phi_mix"].to(ct.MAP)
    grad = lambda dsx, fm, pm: ct.fgrad(
        lambda x: torch.sum(ct.Mixed(dsx).logpdf(f_mix=fm, phi_mix=x)))(pm)
    g3 = grad(ds3, f_mix, phi_mix)
    x = torch.randn((3, 2, 512, 512), device="cuda")
    fft3, flow3 = torch.fft.rfft2(x), (ds3.L(phi_mix) @ ct.Field(x, ct.QU_MAP, phi_mix.proj)).arr
    for i in range(3):
        gi = grad(ds, ct.batch_index(f_mix, i), ct.batch_index(phi_mix, i))
        flow_i = (ds.L(ct.batch_index(phi_mix, i)) @ ct.Field(x[i], ct.QU_MAP, phi_mix.proj)).arr
        same = {"rfft2": torch.equal(fft3[i], torch.fft.rfft2(x[i])),
                "flow": torch.equal(flow3[i], flow_i), "gradient": torch.equal(g3.arr[i], gi.arr)}
        e = rel(g3.arr[i], gi.arr)
        print(f"entry {i}: bit for bit {same}; gradient {e:.3e}")
        assert all(same.values()), (i, same, e)


@pytest.mark.cuda
def test_batched_argmaxf_at_32_sims_runs_on_card():
    """One strict argmaxf_logpdf at 32 sims x 512^2 P (3 fixed CG
    iterations): the launchers take 32 entries x 2 components on the
    kernels' grids (K3 for L and L^H); finite, each entry its own solve."""
    _card()
    sim = ct.load_sim(thetapix=2, Nside=512, pol="P", seed=0, Nbatch=32)
    ds = sim["ds"]
    phi = ct.repeat_batch(sim["phi"].to(ct.MAP), 32)
    lfk.reset_launches()
    f, info = ct.argmaxf_logpdf(ds, phi=phi, conjgrad_kwargs=dict(tol=0.0, nsteps=3,
                                                                   fixed_iters=True,
                                                                   hessian_precision=None))
    assert f.batch_shape == (32,) and info["res"].shape == (32,)
    assert torch.isfinite(f.arr).all()
    assert lfk.LAUNCHES["fa_velocity_forward"] > 0 and lfk.LAUNCHES["fa_velocity_adjoint"] > 0
    one, _ = ct.argmaxf_logpdf(ds.replace(d=ct.batch_index(ds.d, 0)), phi=sim["phi"].to(ct.MAP),
                               conjgrad_kwargs=dict(tol=0.0, nsteps=3, fixed_iters=True,
                                                    hessian_precision=None))
    assert rel(ct.batch_index(f, 31).arr, one.arr) < 1e-5


# =========================================================================
# the ensemble pipelines: batched MAP_joint and the MUSE theta-score
# =========================================================================

# a batched MAP_joint step (20 fixed CG iterations, strict) on the kernel
# backend against the plain one: CG amplifies the flows' 1e-5 as
# chip_smoke.py's 20-iteration Wiener filter does (1e-4)
ENSEMBLE_PLAIN_TOL = 1e-4


@pytest.mark.cuda
def test_batched_MAP_joint_step_and_muse_score_kernel_match_plain_on_card():
    """At 64^2 P, Cphi banded into 2 bins, 2 sims drawn at amplitudes (1.3,
    0.7): one batched MAP_joint step (an alpha an entry) and the per-sim
    MUSE theta-scores at its MAP, on "kernel" against "plain": f, phi and
    the scores within ENSEMBLE_PLAIN_TOL, the same alphas."""
    _card()
    from cmblensing_tpu_torch.inference import muse as tmuse
    sim = ct.load_sim(thetapix=3, Nside=64, pol="P", seed=0)
    ds, proj = sim["ds"], sim["proj"]
    edges = np.array([0.0, 2000.0, 1e9])
    ds = ds.replace(Cphi=ct.Cl_to_Cov("I", proj, (ct.camb()["total"]["pp"], edges, "Aphi_b")))
    theta = dict(Aphi_b=np.array([1.3, 0.7]))
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    with torch.no_grad():
        ds = ds.replace(d=ds.simulate(g, theta=theta, batch_shape=(2,))["d"])
    spec = tmuse._theta_spec(theta)
    out = {}
    for backend in ("kernel", "plain"):
        with ct.lenseflow_backend_ctx(backend):
            r = ct.MAP_joint(ds, theta=theta, nsteps=1, precision=None, history_keys=("alpha",),
                             conjgrad_kwargs=dict(tol=0.0, nsteps=20, fixed_iters=True))
            s = tmuse._theta_score_batch(ds, r["f"], r["phi"],
                                         tmuse._theta_vec(theta, spec, "cuda"), spec)
        out[backend] = (r, s)
    (k, sk), (p, sp) = out["kernel"], out["plain"]
    m = lambda x: x.to(x.basis.with_space("map")).arr
    errs = {"f": rel(m(k["f"]), m(p["f"])), "phi": rel(m(k["phi"]), m(p["phi"])),
            "scores": rel(sk, sp)}
    print(f"batched MAP_joint step and MUSE scores, kernel vs plain: {errs}")
    assert k["phi"].batch_shape == (2,) and sk.shape == (2, 2)
    assert np.array_equal(k["history"][0]["alpha"], p["history"][0]["alpha"])
    assert max(errs.values()) < ENSEMBLE_PLAIN_TOL, errs


@pytest.mark.cuda
def test_curved_sky_on_card_matches_cpu():
    """The curved sky (no kernel of its own) on the card against the CPU on
    the same inputs: EquiRect blocks past |m| = 1024 (16 x 64, lmax 1100),
    their Wiener filter, and HEALPix projection both ways (nside 32 <-> an
    8 x 8 patch at 4 degrees; 'fft' through the NUFFT's scatter-add, whose
    order the card does not fix)."""
    _card()
    from cmblensing_tpu_torch.core import proj_healpix as TH
    ell = np.arange(1101)
    CE = ct.Cls(ell, np.where(ell >= 2, 1.0 / (ell + 1.0) ** 2, 0.0))
    CB = ct.Cls(ell, np.where(ell >= 2, 0.3 / (ell + 1.0) ** 2, 0.0))
    span = dict(theta_span=(1.2, 1.8), phi_span=(0, 2 * np.pi))
    for pol, cls in (("I", (CE,)), ("P", (CE, CB))):
        C = {dev: ct.Cl_to_Cov_EquiRect(pol, ct.ProjEquiRect(Ny=16, Nx=64, **span, device=dev),
                                        *cls, lmax=1100) for dev in ("cuda", "cpu")}
        assert bool(torch.isfinite(C["cuda"].blocks).all())
        assert rel(C["cuda"].blocks.cpu(), C["cpu"].blocks) < 1e-6
        d = C["cpu"].simulate(3)
        fw = {}
        for dev, Cd in C.items():
            n = 1e-4 * float(Cd.blocks.abs().max())
            Cn = ct.BlockDiagEquiRect(n * torch.eye(Cd.blocks.shape[-1], dtype=Cd.blocks.dtype,
                                                    device=dev).expand_as(Cd.blocks).contiguous(),
                                      Cd.basis, Cd.proj)
            ds = ct.NoLensingDataSet(d=ct.EquiRectField(d.arr.to(dev), d.basis, Cd.proj),
                                     Cf=Cd, Cn=Cn, Cn_hat=Cn)
            fw[dev] = ct.argmaxf_logpdf(ds, conjgrad_kwargs=dict(tol=1e-6, nsteps=200))[0]
        assert rel(fw["cuda"].arr.cpu(), fw["cpu"].to(fw["cuda"].basis).arr) < 1e-4
    hpx = TH.ProjHealpix(32)
    th, ph = TH.hp.pix2ang_ring(32, np.arange(hpx.npix))
    m = np.stack([np.cos(th), 0.5 * np.sin(th) * np.sin(ph)]).astype(np.float32)
    for method, tol in (("bilinear", 1e-5), ("fft", 1e-4)):
        out = {}
        for dev in ("cuda", "cpu"):
            proj = ct.ProjLambert(8, 8, thetapix=240, T=np.float32, device=dev)
            flat = ct.project(ct.HealpixField.from_map(m, pol="QU", device=dev), proj, method=method)
            out[dev] = (flat.arr.cpu(), ct.project(flat, hpx, method=method).arr.cpu())
        assert rel(out["cuda"][0], out["cpu"][0]) < tol and rel(out["cuda"][1], out["cpu"][1]) < tol


_NCCL_TWO_RANKS = """
import sys
import cmblensing_tpu_torch as ct
rank, port = int(sys.argv[1]), sys.argv[2]
ct.distributed_initialize(f"localhost:{port}", 2, rank, backend="nccl")
try:
    ct.make_mesh(device="cuda")
except ValueError as e:
    print("REFUSED", "Duplicate GPU" in str(e))
else:
    print("ACCEPTED")
"""


@pytest.mark.cuda
def test_nccl_mesh_refuses_two_ranks_on_one_card(tmp_path):
    """Two ranks over NCCL on a one-card machine: make_mesh raises, naming
    NCCL's refusal of two ranks on one device, and never falls back to
    another backend."""
    import os
    import socket
    import subprocess
    import sys
    if not torch.cuda.is_available() or torch.cuda.device_count() != 1:
        pytest.skip("needs a machine with exactly one CUDA card")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen([sys.executable, "-c", _NCCL_TWO_RANKS, str(r), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert "REFUSED True" in out, (out, err[-2000:])
