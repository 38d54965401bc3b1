"""The hand-written CUDA LenseFlow kernels against their plain PyTorch
versions, on the card. These tests need a CUDA device (the kernels have
no CPU mode) and skip without one. The module imports no JAX, so that it
runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Bound: 1e-5 relative max-abs, both sides strict FP32 summing in another
order; 5e-4 for grad/Hess(phi), whose float32 value carries ~1e-4
relative error in any form (dense circulants or FFT, measured against
float64 at 256^2), so two FP32 summation orders differ by as much.
The factored kernels (csrc/factored.cu) are checked at 1024^2, the size
whose radix (B = 8) the main path runs, and at 512^2 (B = 4).

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
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flow kernel has no CPU mode")
    tp = ct.ProjLambert(24, 24, thetapix=3, T=np.float32, device="cuda")
    mats = tderiv.deriv_mats(tp)
    x = torch.zeros((2, 24, 24), device="cuda")
    with pytest.raises(ValueError, match="multiples"):
        lfk.flow_apply(x, torch.zeros((5, 24, 24), device="cuda"), mats, 0., 1., 1)
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


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 17])
@pytest.mark.parametrize("N", [512, 1024])
def test_factored_kernels_match_plain_on_card(N, nb):
    """K1 (lf_fderiv, x and y), K3 (lf_fa_velocity, both roles) and K4
    (lf_bv_velocity) on the 64 x 32 tile at radix 4 (512^2) and 8 (1024^2)
    against their plain versions, one launch each, at batch 1 and on the
    line search's batch of 17, every batch entry with its own phi and
    held to the bound on its own."""
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
    every combination of operands and lf_velocity of the three kinds (two
    and three components) against their plain versions, each plane held to
    the bound on its own."""
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
    pt = _p_planes(0.4, planes)
    for kind, ncomp in (("forward", 2), ("adjoint", 2), ("forward", 3), ("backward", 2)):
        ns = 2 * ncomp + lfk.NACC if kind == "backward" else ncomp
        y = T(ns, N, N)
        k1, k2 = torch.full_like(y, float("nan")), torch.empty_like(y)
        lfk.velocity_cuda(kind, y, k1, planes, pt, mats, ncomp, 0.4)
        lfk.velocity_plain(kind, y, k2, planes, pt, mats, ncomp, 0.4)
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
    _card()
    tp = ct.ProjLambert(256, 256, thetapix=2, T=np.float32, device="cuda")
    ops = tfd.factored_ops(tp, 2, 2)
    x = torch.zeros((1, 256, 256), device="cuda")
    with pytest.raises(RuntimeError, match="radix"):
        lfk.fderiv_cuda(x, None, None, torch.empty_like(x), ops)
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
    phi, _, _ = _weak_lensing(N=N)
    planes = lfk.gradhess_plain(torch.as_tensor(phi, device="cuda"), ops)
    planes = torch.stack([planes, 0.5 * planes])
    g = torch.Generator(device="cuda").manual_seed(0)
    y = torch.randn((2, 5, N, N), generator=g, device="cuda")
    t = 0.6
    px, py = (p.unsqueeze(1).contiguous() for p in lfk._p_of_t(t, planes))
    # (role, a, b): a component pair; f and delta f of both components; (u_x, u_y)
    for role, a, b in ((0, y[:, :2], y[:, 2:4]), (1, y[:, 4:], 1e-2 * y[:, :1]),
                       (2, y[:, :1], y[:, 1:2]), (3, y[:, :1], y[:, 1:2])):
        o1 = torch.empty((2, a.shape[1], 4, N, N), device="cuda")
        o2 = torch.full_like(o1, float("nan"))
        o1.fill_(float("nan"))
        lfk.uni_velocity_cuda(role, a, b, px, py, o1, ops, t)
        lfk.uni_velocity_plain(role, a, b, px, py, o2, ops, t)
        nonzero = {0: 4, 1: 1, 2: 2, 3: 2}[role]
        for i in range(nonzero):
            assert rel(o1[:, :, i], o2[:, :, i]) < TOL, (role, i)
        assert (o1[:, :, nonzero:] == 0).all()


@pytest.mark.cuda
def test_uni_wrapper_rejects_dense_operands():
    _card()
    tp = ct.ProjLambert(256, 256, thetapix=2, T=np.float32, device="cuda")
    x = torch.zeros((1, 1, 256, 256), device="cuda")
    with pytest.raises(RuntimeError, match="ROADMAP"):
        lfk.uni_velocity_cuda(2, x, x, x, x, torch.empty((1, 1, 4, 256, 256), device="cuda"),
                              tderiv.deriv_mats(tp), 0.5)


@pytest.mark.cuda
def test_entry_points_default_to_the_card():
    """ProjLambert and load_sim put the port on the card unless asked for
    another device."""
    _card()
    assert ct.ProjLambert(32, 32, thetapix=3).device.type == "cuda"
    sim = ct.load_sim(thetapix=3, Nside=32, pol="P", seed=0)
    assert sim["proj"].device.type == "cuda" and sim["ds"].d.arr.is_cuda


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 17])
@pytest.mark.parametrize("N", [512, 1024])
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
    assert lfk.LAUNCHES["fderiv_high"] == 4
    y = T(nb, 2, N, N)
    pt = _p_planes(0.3, planes)
    for kind in ("forward", "adjoint"):
        check(y.shape, lambda o, p: lfk.fvelocity_cuda(kind, y, o, planes, pt, ops, 2, 0.3, p),
              lambda o: lfk.fvelocity_plain(kind, y, o, planes, pt, ops, 2, 0.3, "high"))
        assert lfk.LAUNCHES[f"fa_velocity_{kind}_high"] == 2
    yb = torch.cat([T(nb, 4, N, N), 1e-3 * T(nb, lfk.NACC, N, N)], dim=1)
    pt = _p_planes(0.7, planes)
    check(yb.shape, lambda o, p: lfk.fvelocity_cuda("backward", yb, o, planes, pt, ops, 2, 0.7, p),
          lambda o: lfk.fvelocity_plain("backward", yb, o, planes, pt, ops, 2, 0.7, "high"))
    assert lfk.LAUNCHES["bv_velocity_high"] == 2


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
def test_dense_and_uni_high_raise_on_card():
    """No 'high' kernel yet for the dense K2 (below 512^2) or K5: on the
    card they raise, never running strict in its place."""
    _card()
    tp = ct.ProjLambert(64, 64, thetapix=3, T=np.float32, device="cuda")
    phi, f, dy = _weak_lensing(N=64)
    pt, ft = torch.as_tensor(phi, device="cuda"), torch.as_tensor(f, device="cuda")
    mats = tderiv.deriv_mats(tp)
    planes = lfk.gradhess(pt, mats)
    lfk.reset_launches()
    with tderiv.precision_ctx("high"):
        with pytest.raises(NotImplementedError, match="Queue 2"):
            lfk.flow_apply(ft, planes, mats, 0., 1., 1)
        with pytest.raises(NotImplementedError, match="Queue 2"):
            lfk.gradhess(pt, mats)
        ops = tderiv.deriv_ops(ct.ProjLambert(512, 512, thetapix=2, T=np.float32, device="cuda"))
        f512 = torch.zeros((2, 512, 512), device="cuda")
        with pytest.raises(NotImplementedError, match="K5 'high'"):
            lfk.uni_flow_apply(f512, torch.zeros((5, 512, 512), device="cuda"), ops, 0., 1., 1)
    assert all(v == 0 for v in lfk.LAUNCHES.values())
