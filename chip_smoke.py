"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written LenseFlow kernels from csrc/ into build/, holds
each against its plain PyTorch version on the card, and drives the
port's two paths through the kernel backend:

  phases 2-4  the mixed-posterior phi-gradient of a 256^2 pol-P
              simulation (LenseFlow nsteps=7) on the dense kernels
              (csrc/lenseflow.cu), checked against the plain backend and
              timed;
  phases 5-7  at 1024^2 P (thetapix 2): the factored kernels
              (csrc/factored.cu) and whole flows against their plain
              versions, the phi-gradient against the plain backend, and
              MAP_joint as scripts/map_1024.py runs it (grid line search,
              15 fixed CG iterations, 2 warm-up steps then 6 timed),
              with one step on the plain backend beside it;
  phase 8     the same 1024^2 P path on the "uni" backend: the universal
              role-switched kernel K5 (csrc/uni.cu), each role at batch 1
              and 17 against its plain version, the uni flows against
              their plain versions and the K3/K4 flows, the phi-gradient
              against the kernel backend, and MAP_joint as in phase 7.
  phase 9     the 'high' tier at 1024^2 P (bf16 head/residual split on the
              tensor cores): K1, K3 (batch 1 and 17) and K4 against their
              plain 'high' versions and the strict kernels, the 'high'
              flows, the phi-gradient under precision_ctx("high") against
              the strict one, argmaxf_logpdf at the JAX default CG and
              "auto" against strict, and MAP_joint as scripts/map_1024.py
              runs it at its default precision "auto".
  phase 10    the dense kernels' ragged edge tiles: every K2 kernel, p(t)
              and the RK4 update at 200^2, 160 x 200 and 600^2, both
              tiers, against their plain versions, and one L @ f on a
              200^2 load_sim against the plain backend.
  phase 11    K2 'high' at 256^2 P (nsteps 7): each velocity kind and the
              derivative against its plain 'high' version and the strict
              kernel, the 'high' flows, the phi-gradient at 'high' against
              strict, and two steps of MAP_joint at its default "auto".
  phase 12    the slice: K2 'high' on its three-component (I, Q, U)
              inputs against plain 'high' and strict; the Wiener filter
              (argmaxf_logpdf at the JAX defaults, "auto") on a masked,
              beamed 256^2 T+EB (pol IP) simulation, against the strict
              solve; at 20 fixed iterations the kernel backend against the
              plain one (strict) and against the "matmul" one ('high').
  phase 13    the large maps, K1, K3 and K4 at radix 16 (2048^2) and 32
              (4096^2) in channel groups: (a) each kernel at both tiers
              against its plain versions (K3 also at batch 17), the whole
              4096^2 flows at both tiers; (b) the strict phi-gradient
              at 2048^2 and 4096^2, kernel and plain backends, each
              against the same evaluation with its flows in float64;
              (c) a strict
              MAP_joint step at 2048^2 P on the kernel and the plain
              backends, the line search's memory per trial, one step at
              "auto"; (d) MAP_joint at 4096^2 P at "auto" as
              scripts/map_4096.py runs it (1 warm-up and 2 timed steps:
              s/step, peak memory, rho_b), and L @ f at 640^2 (dense)
              against the plain backend.

    python3 chip_smoke.py --phase 13    (phase 1, the build, and phase 13 alone)

Phases 7 and 8 measure the strict north star (precision=None); phases
2-6 and 10 run at the global precision 'f32', and both tiers in 10.

Each path's launch counters are set to 0 just before it and read just
after; phase 13's radix-16/32 records name, under "path", the run their
launches come from. A kernel's time is device time: its launches captured into a CUDA
graph and the replay timed by CUDA events (the host's launch cost, about
0.04 ms a call, would hide a shorter kernel), and so is the library
call's. Phase 9's kernels (both tiers, and the library call) and phase
5's p(t) and RK4 update are timed cold: the replay goes round copies of
their buffers that together hold twice the L2, so that what a launch
reads comes from HBM (cold_ms); the other kernels are replayed on one
set of buffers, which the L2 holds where they fit in it. Plain versions
and whole flows, gradients and steps are timed as they run. Exits non-zero, printing no result line, when there is no CUDA
card or any phase fails.

The last two lines of stdout are the per-kernel JSON record and
{"ok": true, "device": {...}}; the card's name and power limit come on a
line before them. Each kernel's record holds its time, its plain
version's, the time of one PyTorch call computing the same function
where there is one (strict FP32 `a @ DxT` for a derivative pass), and
its bound: the larger of its derivative FLOPs over the card's FP32 peak
and the bytes it must move over its memory rate; for a 'high' kernel the
larger of its three bf16 products' FLOPs over the bf16 tensor-core peak
plus its FP32 work (butterflies, split) over the FP32 peak, and its
bytes over the memory rate.
"""
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

# relative max-abs bounds, kernel against its plain version on the card
# (both strict FP32; the sums run in another order)
FLOW_TOL = 1e-5
# grad/Hess(phi) of a realistic 256^2 phi carries ~1e-4 relative error in
# float32 in any form (dense circulants or FFT, against float64), so two
# FP32 summation orders differ by as much
HESS_TOL = 5e-4
GRAD_TOL = 1e-4        # the bound tests/test_lensing.py:131 holds the TPU kernel to
# the 1024^2 gradient: the same bound until a measurement says otherwise
GRAD_TOL_1024 = 1e-4
# grad/Hess(phi) at 1024^2, thetapix 2: l_max is 6x the 256^2 headline's,
# and the Hessian planes differentiate the gradient planes' float32
# rounding once more, so their float32 error grows with it: on an H100
# the kernel's planes lay 4.6e-4 and the plain version's 3.4e-4 from
# float64, and 5.2e-4 from each other
HESS_TOL_1024 = 2e-3
N, NSTEPS, SEED = 256, 7, 0
DEVICE = "cuda"
N_MAP, THETAPIX_MAP = 1024, 2          # scripts/map_1024.py
MAP_CG = dict(tol=0.0, nsteps=15, fixed_iters=True)
MAP_WARM, MAP_STEPS = 2, 6
NTRIAL = 17            # the grid line search's batch: alpha = 0 and 16 trials
CORR_MIN = 0.9
# kernels of each path: every one must launch in its run
DENSE_KERNELS = ("velocity_forward", "velocity_adjoint", "velocity_backward", "rk4_update",
                 "p_planes", "deriv")
FACTORED_KERNELS = ("fderiv", "fa_velocity_forward", "fa_velocity_adjoint", "bv_velocity",
                    "rk4_update", "p_planes")
UNI_KERNELS = ("uni_role0", "uni_role1", "uni_role2", "uni_role3", "fderiv", "rk4_update",
               "p_planes")
# the un-hoisted delta phi (integrated in the uni flow's state) against
# the hoisted one and a float64 evaluation: one more summation order over
# 4 nsteps stages of 6 derivatives
DPHI_UNHOISTED_TOL = 1e-4
# H100 SXM data sheet: FP32 outside the tensor cores, dense bf16 on them, HBM3;
# its L2 cache
FP32_PEAK, BF16_PEAK, HBM_RATE = 67e12, 989e12, 3.35e12
L2_BYTES = 50 * 2 ** 20
# a 'high' kernel against its plain 'high' version: the same split of the
# same FP32 values, but a butterflied channel value one ulp apart between
# the two summation orders may round its bf16 head the other way, moving
# its residual's rounding by ~2^-17 of the value; against the strict
# kernel, the split's operator error (~2^-17 per product term, summed)
HIGH_TOL, HIGH_VS_STRICT = 2e-5, 1e-3
# ... and what tells a 'high' kernel from a strict one, or from a split
# rounded otherwise than to nearest even: per plane in relative Frobenius
# norm, its distance to the plain 'high' version over its distance to the
# strict kernel. The two 'high' forms differ only where a channel value's
# residual rounds the other way (about one value in 128 of those whose
# butterfly sums differ by an ulp), while the split's own error touches
# every value: on the CPU a butterfly summed in another order gives 0.09
# (512^2) and 0.14 (1024^2), a truncating split 1.05, a split without the
# operand's residual 1.00, strict FP32 infinity
# (tests/test_torch_high.py::test_split_ratio_tells_the_rne_split_apart)
HIGH_SPLIT_RATIO = 0.5
# a whole flow adds the RK4 sums' FP32 reassociation to both distances, so
# its ratio lies nearer 1; held only to be nearer its plain 'high' version
# than the strict flow (a flow on strict kernels gives infinity)
FLOW_SPLIT_RATIO = 1.0
# f of the 'high' Wiener filter against the strict one, in norm: the
# inexact-Krylov bound of tests/test_inference.py:267
WF_HIGH_TOL = 1e-3
HIGH_KERNELS = ("fderiv_high", "fa_velocity_forward_high", "fa_velocity_adjoint_high",
                "bv_velocity_high")
DENSE_HIGH_KERNELS = ("velocity_forward_high", "velocity_adjoint_high", "velocity_backward_high",
                      "deriv_high")
# plane shapes the dense kernels' 32 x 32 tile and 16-deep slab do not
# divide: load_sim(Nside=200), a rectangle, and 600^2 (dense, since the
# factored radix needs 128 | N)
EDGE_SHAPES = ((200, 200), (160, 200), (600, 600))
# the slice: examples/03_joint_MAP.py's masked, beamed configuration at
# pol IP and 256^2
WF_SIM = dict(thetapix=3, Nside=256, pol="IP", T=np.float32, muKarcminT=1, beamFWHM=2,
              pixel_mask_kwargs=dict(edge_padding_deg=1, apodization_deg=0.5), seed=SEED)
# f of the kernel backend's strict solve against the plain backend's at 20
# fixed iterations, in norm: CG amplifies the operators' float32 differences
# (1e-5 per flow) by its iteration count at most
WF_PLAIN_TOL = 1e-4
FA = 128               # the factored derivative's block size (ops/deriv.py::FACTOR_A)
# where K1, K3 and K4 are written, both tiers (factored.cu and
# factored_high.cu instantiate them)
FACTORED_SRC = "cmblensing_tpu_torch/csrc/factored_kernels.cuh"
# phase 13, the large maps: MAP_joint as scripts/map_4096.py runs it
# (load_sim(thetapix=2, Nside=N, pol="P", T=float32, seed=0), grid line
# search, 15 fixed CG iterations) at 2048^2 (radix 16) and 4096^2 (radix
# 32); at 4096^2 1 warm-up step and 2 timed at the JAX default "auto"
N_LARGE = (2048, 4096)
LARGE_WARM, LARGE_STEPS = 1, 2
# the bandpower bins of scripts/map_4096.py:184
RHO_LEDGES = np.array([2, 100, 200, 350, 500, 750, 1000, 1500, 2000, 3000, 4500, 6000])
# a strict MAP_joint step on the kernel backend against the plain one:
# alpha and logpdf, relative
STEP_TOL = 1e-6
# L @ f at 640^2 (the dense circulant, radix 5 not being built) against
# the plain backend: both float32 forms lie 1.7e-5 to 1.9e-5 from float64
# there (tests/test_torch_large_maps.py)
FLOW640_TOL = 5e-5


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def fro(a, b):
    """|a - b| / |b| in Frobenius norm, in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def cuda_ms(fn, reps, torch, graph=False):
    """Milliseconds per fn() over reps back-to-back runs after one warm-up
    run, by CUDA events around the whole run. With `graph` the reps runs are
    captured into one CUDA graph and its replay is timed: device time
    without the host's launch cost, which is what a kernel under ~0.05 ms
    would otherwise show."""
    fn()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if graph:
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        run = g.replay
    else:
        def run():
            for _ in range(reps):
                fn()
    e0.record()
    run()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def kernel_ms(fn, reps, torch):
    """Device milliseconds of a kernel wrapper's launches (or of the one
    library call held beside it)."""
    return cuda_ms(fn, reps, torch, graph=True)


def cold_ms(fn, args, reps, torch):
    """Device milliseconds of fn(*args) with its tensors read from HBM, not
    the L2: the replayed launches go round copies of args' tensors that
    together hold at least twice the L2, so that no launch finds what it
    reads left in the L2 by the launches before it, as a replay on one set
    of buffers does for a working set below the L2's 50 MB."""
    import math
    nbytes = sum(x.numel() * x.element_size() for x in args if torch.is_tensor(x))
    sets = [args] + [tuple(x.clone() if torch.is_tensor(x) else x for x in args)
                     for _ in range(math.ceil(2 * L2_BYTES / nbytes) - 1)]
    nxt = iter(range(1 << 30))
    return kernel_ms(lambda: fn(*sets[next(nxt) % len(sets)]), reps, torch)


def bound(flops, planes, N, extra_floats=0):
    """bound_ms and bound_by of a function doing `flops` FP32 operations
    and moving `planes` N x N float32 planes plus `extra_floats` floats
    (each input read once, each output written once)."""
    t_op = flops / FP32_PEAK
    t_mem = 4 * (planes * N * N + extra_floats) / HBM_RATE
    return dict(bound_ms=1e3 * max(t_op, t_mem), bound_by="operations" if t_op >= t_mem else "bytes")


def dense_deriv_flops(N):
    """One dense circulant derivative of an N x N plane: N^3 FMA."""
    return 2 * N ** 3


def fact_deriv_flops(N, B=None):
    """One radix-B factored derivative of an N x N plane (csrc/fact_tile.cuh):
    2B - 2 block products of A x A x N FMA, and B FMA per pixel in each
    butterfly."""
    B = B or N // FA
    return 2 * (2 * B - 2) * FA * FA * N + 2 * 2 * B * N * N


def bound_high(N, nder, planes, nb=1, axes=2):
    """bound_ms and bound_by of nb entries of nder 'high' factored
    derivatives each (csrc/fact_tile.cuh, HIGH): three bf16 products per
    block product on the tensor cores, and in FP32 the two butterflies
    (B FMA a pixel each) and the split (three operations a channel value);
    bytes: `planes` N x N float32 planes per entry, and the split blocks
    ([head, residual] bf16) and butterflies of the `axes` axes it
    differentiates along."""
    B = N // FA
    prod = nb * nder * 2 * (2 * B - 2) * FA * FA * N
    fp32 = nb * nder * (2 * 2 * B + 3) * N * N
    t_op = 3 * prod / BF16_PEAK + fp32 / FP32_PEAK
    t_mem = (4 * nb * planes * N * N + axes * (2 * 2 * B * FA * FA + 4 * 2 * B * B)) / HBM_RATE
    return dict(bound_ms=1e3 * max(t_op, t_mem), bound_by="operations" if t_op >= t_mem else "bytes")


def bound_dense_high(N, nder, planes):
    """bound_ms and bound_by of nder 'high' dense derivatives of N x N planes
    (csrc/lenseflow.cu, HIGH): three bf16 products of 2 N^3 operations each
    on the tensor cores and the operand's split (three FP32 operations a
    value); bytes: `planes` N x N planes of 4 bytes, the circulants' bf16
    head and residual counting as one such plane each."""
    t_op = 3 * nder * 2 * N ** 3 / BF16_PEAK + 3 * nder * N * N / FP32_PEAK
    t_mem = 4 * planes * N * N / HBM_RATE
    return dict(bound_ms=1e3 * max(t_op, t_mem), bound_by="operations" if t_op >= t_mem else "bytes")


def split_matmuls_ms(a, M, right, torch, reps=20):
    """The library yardstick of a 'high' derivative pass: the three bf16
    torch.matmul of the split (head.head, head.residual, residual.head) on
    operands split beforehand, timed cold; the port never calls it."""
    from cmblensing_tpu_torch.ops.factored_deriv import split_bf16
    (ah, al), (mh, ml) = split_bf16(a), split_bf16(M)
    if right:
        return cold_ms(lambda x, y, z, w: (x @ z, x @ w, y @ z), (ah, al, mh, ml), reps, torch)
    return cold_ms(lambda x, y, z, w: (z @ x, w @ x, z @ y), (ah, al, mh, ml), reps, torch)


def fact_op_floats(N):
    """The factored operands' floats: (B, A, A) blocks and (2, B, B)
    butterflies per axis."""
    B = N // FA
    return 2 * (B * FA * FA + 2 * B * B)


def matmul_ms(a, b, torch, reps=20, cold=False):
    """The library call for a derivative pass: strict FP32 `a @ b` (no
    TF32; a @ DxT along x, Dy @ b along y), one cuBLAS call; `cold` as
    cold_ms."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        if cold:
            return cold_ms(lambda x, y: x @ y, (a, b), reps, torch)
        return kernel_ms(lambda: a @ b, reps, torch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def weak_lensing_inputs(proj, torch):
    """phi, f (pol P) and a cotangent dy drawn with numpy from SEED: phi and
    f from the fiducial Cphi and Cf, so the lensing is realistically weak."""
    import cmblensing_tpu_torch as ct
    rng = np.random.default_rng(SEED)
    n = proj.Nx
    Cl = ct.camb()
    Cphi = ct.Cl_to_Cov("I", proj, Cl["total"]["pp"])
    Cf = ct.Cl_to_Cov("P", proj, Cl["unlensed_scalar"]["EE"], Cl["unlensed_scalar"]["BB"])
    white = lambda c: ct.Field(torch.as_tensor(rng.standard_normal((c, n, n)).astype(np.float32),
                                               device=proj.device), ct.Basis("I" if c == 1 else "QU", "map"), proj)
    phi = (Cphi.sqrt() @ white(1)).to(ct.MAP).arr.contiguous()
    f = (Cf.sqrt() @ white(2)).to(ct.QU_MAP).arr.contiguous()
    dy = torch.as_tensor(rng.standard_normal((2, n, n)).astype(np.float32), device=proj.device)
    return phi, f, dy


def phase_kernels(torch, proj):
    """Each kernel and each whole flow against its plain version."""
    from cmblensing_tpu_torch.ops import deriv, lenseflow_kernels as lfk
    phi_map, f, dy = weak_lensing_inputs(proj, torch)
    mats = deriv.deriv_mats(proj)
    phi = lfk.gradhess(phi_map, mats)
    hess_err = rel(phi, lfk.gradhess_plain(phi_map, mats))
    errs = {}

    out = {}
    t = 0.5
    nb = 2 * 2 + lfk.NACC
    # the p(t) planes every velocity reads: 5 planes in, 2 out, ~25 flops a pixel
    pt, pt2 = torch.empty((2, N, N), device=f.device), torch.empty((2, N, N), device=f.device)
    lfk.p_planes_cuda(t, phi, pt)
    lfk.p_planes_plain(t, phi, pt2)
    out["p_planes"] = dict(
        max_abs_err=float((pt - pt2).abs().max()), rel=rel(pt, pt2),
        ms=kernel_ms(lambda: lfk.p_planes_cuda(t, phi, pt), 20, torch),
        plain_ms=cuda_ms(lambda: lfk.p_planes_plain(t, phi, pt2), 20, torch),
        library_ms=None, **bound(25 * N * N, 7, N))
    ybwd = torch.cat([f, dy, torch.randn((lfk.NACC, N, N), device=f.device) * 1e-3])
    for kind, y in (("forward", f), ("adjoint", f), ("backward", ybwd)):
        k1, k2 = torch.empty_like(y), torch.empty_like(y)
        lfk.velocity_cuda(kind, y, k1, phi, pt, mats, 2, t)
        lfk.velocity_plain(kind, y, k2, phi, pt2, mats, 2, t)
        # y, p (and phi, backward), k, DxT, Dy
        nder, planes = (8, 27) if kind == "backward" else (4, 8)
        out["velocity_" + kind] = dict(
            max_abs_err=float((k1 - k2).abs().max()), rel=rel(k1, k2),
            ms=kernel_ms(lambda: lfk.velocity_cuda(kind, y, k1, phi, pt, mats, 2, t), 20, torch),
            plain_ms=cuda_ms(lambda: lfk.velocity_plain(kind, y, k2, phi, pt2, mats, 2, t), 20,
                             torch),
            library_ms=None, **bound(nder * dense_deriv_flops(N), planes, N))
    y = torch.randn((nb, N, N), device=f.device)
    k = torch.randn_like(y)
    bufs = [torch.randn_like(y) for _ in range(2)]
    res = []
    for fn in (lfk.rk4_update_cuda, lfk.rk4_update_plain):
        yy, acc, s = y.clone(), bufs[0].clone(), bufs[1].clone()
        for stage, (wa, ws) in enumerate(((1 / 42, 1 / 14), (1 / 21, 1 / 14), (1 / 21, 1 / 7),
                                          (1 / 42, 0.0))):
            fn(yy, k, acc, s, stage, wa, ws)
        res.append(torch.cat([yy, acc, s]))
    yy, acc, s = y.clone(), bufs[0].clone(), bufs[1].clone()
    out["rk4_update"] = dict(
        max_abs_err=float((res[0] - res[1]).abs().max()), rel=rel(res[0], res[1]),
        ms=kernel_ms(lambda: lfk.rk4_update_cuda(yy, k, acc, s, 1, 1 / 21, 1 / 14), 20, torch),
        plain_ms=cuda_ms(lambda: lfk.rk4_update_plain(yy, k, acc, s, 1, 1 / 21, 1 / 14), 20, torch),
        # stage 1: acc += w k, s = y + w' k (4 flops; y, k, acc in, acc, s out)
        library_ms=None, **bound(4 * nb * N * N, 5 * nb, N))
    # the derivative kernel: d_x a + d_y b + c checked, the d_x a pass timed
    # beside its one-call library counterpart
    a, b, c = f[0:1].contiguous(), f[1:2].contiguous(), dy[0:1].contiguous()
    o1, o2 = torch.empty_like(a), torch.empty_like(a)
    lfk.deriv_cuda(a, b, c, o1, mats)
    lfk.deriv_plain(a, b, c, o2, mats)
    err3 = (float((o1 - o2).abs().max()), rel(o1, o2))
    lfk.deriv_cuda(a, None, None, o1, mats)
    lfk.deriv_plain(a, None, None, o2, mats)
    out["deriv"] = dict(max_abs_err=max(err3[0], float((o1 - o2).abs().max())),
                        rel=max(err3[1], rel(o1, o2)),
                        ms=kernel_ms(lambda: lfk.deriv_cuda(a, None, None, o1, mats), 20, torch),
                        plain_ms=cuda_ms(lambda: lfk.deriv_plain(a, None, None, o2, mats), 20, torch),
                        library_ms=matmul_ms(a[0], mats[0], torch),
                        **bound(dense_deriv_flops(N), 3, N))      # a, out, DxT

    # whole flows at the main path's size and nsteps
    errs["flow_forward"] = rel(lfk.flow_apply(f, phi, mats, 0., 1., NSTEPS, "forward"),
                               lfk.flow_apply_plain(f, phi, mats, 0., 1., NSTEPS, "forward"))
    errs["flow_adjoint"] = rel(lfk.flow_apply(f, phi, mats, 1., 0., NSTEPS, "adjoint"),
                               lfk.flow_apply_plain(f, phi, mats, 1., 0., NSTEPS, "adjoint"))
    (dphi_k, df0_k) = lfk.flow_bwd(dy, f, phi, mats, 0., 1., NSTEPS)
    (dphi_p, df0_p) = lfk.flow_bwd_plain(dy, f, phi, mats, 0., 1., NSTEPS)
    errs["flow_backward_df0"] = rel(df0_k, df0_p)
    errs["flow_backward_dphi"] = rel(dphi_k, dphi_p)
    torch.cuda.synchronize()
    for name, e in errs.items():
        print(f"phase 2: {name:22s} rel max-abs err kernel vs plain = {e:.3e} (bound {FLOW_TOL:g})")
    for name, d in out.items():
        print(f"phase 2: kernel {name:18s} rel err {d['rel']:.3e}  {d['ms']:.4f} ms  plain "
              f"{d['plain_ms']:.4f} ms  library {d['library_ms']}  bound {d['bound_ms']:.4f} ms "
              f"({d['bound_by']})")
    print(f"phase 2: {'gradhess':22s} rel max-abs err kernel vs plain = {hess_err:.3e} (bound {HESS_TOL:g})")
    bad = {k: v for k, v in errs.items() if not v < FLOW_TOL}
    if not hess_err < HESS_TOL:
        bad["gradhess"] = hess_err
    bad.update({k: d["rel"] for k, d in out.items() if not d["rel"] < FLOW_TOL})
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")
    return out, (phi_map, f)


def phase_slice(torch):
    """load_sim -> mix -> lnP and grad_phi° lnP, five times, through the
    kernel backend; plus the f-gradient, which runs the adjoint flow."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    t0 = time.perf_counter()
    sim = ct.load_sim(thetapix=3, Nside=N, pol="P", T=np.float32, seed=SEED, device=DEVICE)
    ds = sim["ds"]
    f = sim["f"].to(sim["f"].basis.with_space("map"))
    phi = sim["phi"].to(sim["phi"].basis.with_space("map"))
    m = ct.mix(ds, f=f, phi=phi)
    f_mix = m["f_mix"].to(f.basis)
    phi_mix = m["phi_mix"].to(phi.basis)
    torch.cuda.synchronize()
    print(f"phase 3: load_sim + mix at {N}^2 P: {time.perf_counter() - t0:.2f} s")
    lnP = lambda p: ct.Mixed(ds).logpdf(f_mix=f_mix, phi_mix=p)
    vg = ct.fvalue_and_grad(lnP)

    lfk.reset_launches()
    with ct.lenseflow_backend_ctx("kernel"):
        results = [vg(phi_mix) for _ in range(5)]
        gf = ds.gradientf_logpdf(f, phi=phi)
        torch.cuda.synchronize()
    launches = dict(lfk.LAUNCHES)
    print(f"phase 3: launches in the main path run: {launches}")
    for v, g in results:
        if not (torch.isfinite(v).all() and torch.isfinite(g.arr).all()):
            raise AssertionError("non-finite lnP or gradient")
    if not torch.isfinite(gf.arr).all():
        raise AssertionError("non-finite f-gradient")
    if min(launches[k] for k in DENSE_KERNELS) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    v, g = results[0]
    spread = max(rel(gi.arr, g.arr) for _, gi in results)
    with ct.lenseflow_backend_ctx("plain"):
        vp, gp = vg(phi_mix)
    gerr = rel(g.arr, gp.arr)
    print(f"phase 3: lnP kernel {float(v)!r} plain {float(vp)!r}; grad rel max-abs err "
          f"{gerr:.3e} (bound {GRAD_TOL:g}); spread over 5 runs {spread:.3e}")
    if not gerr < GRAD_TOL:
        raise AssertionError(f"kernel gradient disagrees with the plain backend: {gerr}")
    # a step whose first-order gain, 30, is far above lnP's float32
    # resolution (~0.1 at 1e6) and far below where the curvature, large
    # along the gradient's high-l part, turns it over
    alpha = 30.0 / float(ct.dot(g, g))
    with ct.lenseflow_backend_ctx("kernel"):
        v1 = lnP(phi_mix + alpha * g)
    print(f"phase 3: lnP(phi° + a g) - lnP(phi°) = {float(v1 - v)!r} at a = {alpha:.3e} "
          f"(first order {alpha * float(ct.dot(g, g))!r})")
    if not float(v1) > float(v):
        raise AssertionError("lnP does not rise along its gradient")
    return ds, f_mix, phi_mix, launches


def phase_timing(torch, ds, f_mix, phi_mix, card):
    import cmblensing_tpu_torch as ct
    phi = ds.G.solve(phi_mix)
    L = ct.LenseFlow(phi, NSTEPS)
    fq = f_mix.to(ct.QU_MAP)
    vg = ct.fvalue_and_grad(lambda p: ct.Mixed(ds).logpdf(f_mix=f_mix, phi_mix=p))
    ops = {"gradlnP": lambda: vg(phi_mix), "apply": lambda: L @ fq, "adjoint": lambda: L.H @ fq}
    times = {}
    for name, fn in ops.items():
        for be in ("plain", "kernel", "kernel", "plain"):
            with ct.lenseflow_backend_ctx(be):
                fn()
                times.setdefault((name, be), []).append(cuda_ms(fn, 5, torch))
    out = {}
    for name in ops:
        k = float(np.median(times[(name, "kernel")]))
        p = float(np.median(times[(name, "plain")]))
        out[name] = (k, p)
        print(f"phase 4: {name:8s} kernel {k:.3f} ms  plain {p:.3f} ms  [{N}^2 P, nsteps={NSTEPS}; {card}]")
    return out


def phase_factored(torch, card):
    """The factored kernels (K1 both passes, K3 both roles, K4) at the
    1024^2 main path's shapes, one launch each, K1 and K3 also at the
    line search's batch of NTRIAL, and the whole flows, against their
    plain versions on the same inputs, with times."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import deriv, factored_deriv, lenseflow_kernels as lfk
    proj = ct.ProjLambert(N_MAP, N_MAP, thetapix=THETAPIX_MAP, T=np.float32, device=DEVICE)
    ops = deriv.deriv_ops(proj)
    if not isinstance(ops, factored_deriv.FactoredOps) or ops.FX.shape[0] != N_MAP // FA:
        raise AssertionError(f"deriv_ops gives no radix-{N_MAP // FA} factored operands")
    phi_map, f, dy = weak_lensing_inputs(proj, torch)
    phi = lfk.gradhess(phi_map, ops)
    phi_plain = lfk.gradhess_plain(phi_map, ops)
    hess_err = rel(phi, phi_plain)
    proj64 = ct.ProjLambert(N_MAP, N_MAP, thetapix=THETAPIX_MAP, T=np.float64, device=DEVICE)
    phi64 = lfk.gradhess_plain(phi_map.double(), deriv.deriv_ops(proj64))
    hess_f64 = (rel(phi.double(), phi64), rel(phi_plain.double(), phi64))
    phi1, y = phi[None], f[None].contiguous()
    out = {}

    def check(name, run_k, run_p, result, reps=10, cold=None):
        """cold: (fn, args) of run_k, to time it as cold_ms does."""
        run_k()
        run_p()
        k, p = result()
        out[name] = dict(max_abs_err=float((k - p).abs().max()), rel=rel(k, p),
                         ms=kernel_ms(run_k, reps, torch) if cold is None
                         else cold_ms(*cold, reps, torch),
                         plain_ms=cuda_ms(run_p, reps, torch))

    a, b, c = f[0:1].contiguous(), f[1:2].contiguous(), dy[0:1].contiguous()
    o1, o2 = torch.empty_like(a), torch.empty_like(a)
    for name, args in (("fderiv_x", (a, None, None)), ("fderiv_y", (None, b, None)),
                       ("fderiv", (a, b, c))):
        check(name, lambda: lfk.fderiv_cuda(*args, o1, ops),
              lambda: lfk.fderiv_plain(*args, o2, ops), lambda: (o1, o2))
    # bounds: derivative FLOPs; planes in and out plus the factored operands
    # (one axis' for a single pass); the dense circulants for the library call
    DxT, Dy = deriv.deriv_mats(proj)
    half_ops = fact_op_floats(N_MAP) // 2
    out["fderiv_x"].update(library_ms=matmul_ms(a[0], DxT, torch),
                           **bound(fact_deriv_flops(N_MAP), 2, N_MAP, half_ops))
    out["fderiv_y"].update(library_ms=matmul_ms(Dy, b[0], torch),
                           **bound(fact_deriv_flops(N_MAP), 2, N_MAP, half_ops))
    out["fderiv"].update(library_ms=None, **bound(2 * fact_deriv_flops(N_MAP), 4, N_MAP,
                                                  fact_op_floats(N_MAP)))
    t = 0.5
    pt1, pt1p = (torch.empty((2, 1, N_MAP, N_MAP), device=DEVICE) for _ in range(2))
    # p(t) and the RK4 update are bound by bytes and their working sets fit
    # the L2: timed cold, as the flows' stages meet them
    check("p_planes", lambda: lfk.p_planes_cuda(t, phi1, pt1),
          lambda: lfk.p_planes_plain(t, phi1, pt1p), lambda: (pt1, pt1p),
          cold=(lambda ph, o: lfk.p_planes_cuda(t, ph, o), (phi1, pt1)))
    out["p_planes"].update(library_ms=None, **bound(25 * N_MAP * N_MAP, 7, N_MAP))
    # the RK4 update on a K3 flow's state (stage 1: y, k, acc in; acc, s out)
    yy, kk, acc, st = (torch.randn_like(y) for _ in range(4))
    res = []
    for fn in (lfk.rk4_update_cuda, lfk.rk4_update_plain):
        a2, s2, y2 = acc.clone(), st.clone(), yy.clone()
        for stage, (wa, ws) in enumerate(((1 / 42, 1 / 14), (1 / 21, 1 / 14), (1 / 21, 1 / 7),
                                          (1 / 42, 0.0))):
            fn(y2, kk, a2, s2, stage, wa, ws)
        res.append(torch.cat([y2, a2, s2]))
    out["rk4_update"] = dict(max_abs_err=float((res[0] - res[1]).abs().max()),
                             rel=rel(res[0], res[1]),
                             ms=cold_ms(lambda *a: lfk.rk4_update_cuda(*a, 1, 1 / 21, 1 / 14),
                                        (yy, kk, acc, st), 10, torch),
                             plain_ms=cuda_ms(lambda: lfk.rk4_update_plain(yy, kk, acc, st, 1,
                                                                           1 / 21, 1 / 14), 10,
                                              torch),
                             library_ms=None, **bound(4 * 2 * N_MAP * N_MAP, 5 * 2, N_MAP))
    del yy, kk, acc, st, res
    k1, k2 = torch.empty_like(y), torch.empty_like(y)
    for kind in ("forward", "adjoint"):
        check("fa_velocity_" + kind,
              lambda: lfk.fvelocity_cuda(kind, y, k1, phi1, pt1, ops, 2, t),
              lambda: lfk.fvelocity_plain(kind, y, k2, phi1, pt1p, ops, 2, t), lambda: (k1, k2))
    acc = 1e-3 * torch.as_tensor(np.random.default_rng(SEED + 1).standard_normal(
        (1, lfk.NACC, N_MAP, N_MAP)).astype(np.float32), device=DEVICE)
    yb = torch.cat([f[None], dy[None], acc], dim=1)
    kb1, kb2 = torch.empty_like(yb), torch.empty_like(yb)
    check("bv_velocity", lambda: lfk.fvelocity_cuda("backward", yb, kb1, phi1, pt1, ops, 2, t),
          lambda: lfk.fvelocity_plain("backward", yb, kb2, phi1, pt1p, ops, 2, t),
          lambda: (kb1, kb2))
    # the bundle's planes differ in scale by orders: hold each to the bound
    bv_planes = max(rel(kb1[0, i], kb2[0, i]) for i in range(yb.shape[1]))
    out["bv_velocity"]["rel"] = max(out["bv_velocity"]["rel"], bv_planes)
    # y, p, k: 2 + 2 + 2 planes, 4 derivatives (K3); y, phi, p, k: 9 + 5 + 2 + 9, 8 (K4)
    for name, nder, planes in (("fa_velocity_forward", 4, 6), ("fa_velocity_adjoint", 4, 6),
                               ("bv_velocity", 8, 25)):
        out[name].update(library_ms=None, **bound(nder * fact_deriv_flops(N_MAP), planes, N_MAP,
                                                  fact_op_floats(N_MAP)))

    # the line search's batch: NTRIAL trials, each with its own phi planes
    # (phi scaled along an alpha grid) and its own state, on the kernels'
    # grid z axis; each trial held to the bound on its own
    scales = torch.linspace(0.1, 2.0, NTRIAL, device=DEVICE).reshape(-1, 1, 1, 1)
    phis = (scales * phi).contiguous()
    ys = torch.stack([torch.roll(f, 7 * i, dims=-1) for i in range(NTRIAL)])
    batched = {}

    def check_batched(name, run_k, run_p, result):
        run_k()
        run_p()
        k, p = result()
        batched[name] = dict(nb=NTRIAL, max_abs_err=float((k - p).abs().max()),
                             rel=max(rel(k[i], p[i]) for i in range(NTRIAL)),
                             ms=kernel_ms(run_k, 5, torch), plain_ms=cuda_ms(run_p, 3, torch))

    pts, ptsp = (torch.empty((2, NTRIAL, N_MAP, N_MAP), device=DEVICE) for _ in range(2))
    check_batched("p_planes", lambda: lfk.p_planes_cuda(t, phis, pts),
                  lambda: lfk.p_planes_plain(t, phis, ptsp),
                  lambda: (pts.transpose(0, 1), ptsp.transpose(0, 1)))
    a17 = ys[:, :1].contiguous()
    d1, d2 = torch.empty_like(a17), torch.empty_like(a17)
    check_batched("fderiv", lambda: lfk.fderiv_cuda(a17, a17, None, d1, ops),
                  lambda: lfk.fderiv_plain(a17, a17, None, d2, ops), lambda: (d1, d2))
    s1, s2 = torch.empty_like(ys), torch.empty_like(ys)
    for kind in ("forward", "adjoint"):
        check_batched("fa_velocity_" + kind,
                      lambda: lfk.fvelocity_cuda(kind, ys, s1, phis, pts, ops, 2, t),
                      lambda: lfk.fvelocity_plain(kind, ys, s2, phis, ptsp, ops, 2, t),
                      lambda: (s1, s2))
    for name, d in batched.items():
        out[name]["batched"] = d

    # whole flows at the main path's nsteps
    flows, results = {}, {}
    for name, run in (
            ("L", lambda fn: fn(f, phi, ops, 0., 1., NSTEPS, "forward")),
            ("L^-1", lambda fn: fn(f, phi, ops, 1., 0., NSTEPS, "forward")),
            ("L^H", lambda fn: fn(f, phi, ops, 1., 0., NSTEPS, "adjoint"))):
        results[name], pv = run(lfk.flow_apply), run(lfk.flow_apply_plain)
        flows[name] = (rel(results[name], pv), cuda_ms(lambda: run(lfk.flow_apply), 3, torch),
                       cuda_ms(lambda: run(lfk.flow_apply_plain), 1, torch))
    (dphi_k, df0_k), (dphi_p, df0_p) = (fn(dy, f, phi, ops, 0., 1., NSTEPS)
                                        for fn in (lfk.flow_bwd, lfk.flow_bwd_plain))
    bwd_ms = cuda_ms(lambda: lfk.flow_bwd(dy, f, phi, ops, 0., 1., NSTEPS), 3, torch)
    bwd_plain_ms = cuda_ms(lambda: lfk.flow_bwd_plain(dy, f, phi, ops, 0., 1., NSTEPS), 1, torch)
    flows["backward df0"] = (rel(df0_k, df0_p), bwd_ms, bwd_plain_ms)
    flows["backward dphi"] = (rel(dphi_k, dphi_p), bwd_ms, bwd_plain_ms)
    torch.cuda.synchronize()
    for name, d in out.items():
        print(f"phase 5: kernel {name:20s} rel err {d['rel']:.3e} (bound {FLOW_TOL:g})  "
              f"{d['ms']:.4f} ms  plain {d['plain_ms']:.4f} ms  library {d['library_ms']}  "
              f"bound {d['bound_ms']:.4f} ms ({d['bound_by']})  [{N_MAP}^2; {card}]")
    for name, d in batched.items():
        print(f"phase 5: kernel {name:20s} batch {NTRIAL} rel err {d['rel']:.3e} (bound "
              f"{FLOW_TOL:g}, each trial)  {d['ms']:.4f} ms  plain {d['plain_ms']:.4f} ms  "
              f"[{N_MAP}^2; {card}]")
    for name, (e, km, pm) in flows.items():
        print(f"phase 5: flow {name:14s} rel err {e:.3e} (bound {FLOW_TOL:g})  kernel {km:.3f} ms  "
              f"plain {pm:.3f} ms  [{N_MAP}^2 P, nsteps={NSTEPS}; {card}]")
    print(f"phase 5: gradhess rel err {hess_err:.3e} (bound {HESS_TOL_1024:g}); against float64: "
          f"kernel {hess_f64[0]:.3e}, plain {hess_f64[1]:.3e}")
    bad = {k: d["rel"] for k, d in out.items() if not d["rel"] < FLOW_TOL}
    bad.update({f"{k}[{NTRIAL}]": d["rel"] for k, d in batched.items() if not d["rel"] < FLOW_TOL})
    bad.update({k: v[0] for k, v in flows.items() if not v[0] < FLOW_TOL})
    if not hess_err < HESS_TOL_1024:
        bad["gradhess"] = hess_err
    if bad:
        raise AssertionError(f"factored kernel disagrees with its plain version: {bad}")
    results.update(dphi=dphi_k, df0=df0_k)
    return out, dict(ops=ops, phi=phi, phi_map=phi_map, f=f, dy=dy, flows=results)


def phase_map_gradient(torch, card):
    """load_sim at 1024^2 P and the mixed phi-gradient, kernel backend
    against the plain (cuFFT) backend."""
    import cmblensing_tpu_torch as ct
    t0 = time.perf_counter()
    sim = ct.load_sim(thetapix=THETAPIX_MAP, Nside=N_MAP, pol="P", T=np.float32, seed=SEED,
                      device=DEVICE)
    torch.cuda.synchronize()
    print(f"phase 6: load_sim at {N_MAP}^2 P: {time.perf_counter() - t0:.2f} s [{card}]")
    ds = sim["ds"]
    f = sim["f"].to(sim["f"].basis.with_space("map"))
    phi = sim["phi"].to(sim["phi"].basis.with_space("map"))
    m = ct.mix(ds, f=f, phi=phi)
    f_mix, phi_mix = m["f_mix"].to(f.basis), m["phi_mix"].to(phi.basis)
    vg = ct.fvalue_and_grad(lambda p: ct.Mixed(ds).logpdf(f_mix=f_mix, phi_mix=p))
    res = {}
    for be in ("kernel", "plain"):
        with ct.lenseflow_backend_ctx(be):
            v, g = vg(phi_mix)
            ms = cuda_ms(lambda: vg(phi_mix), 3, torch)
        res[be] = (v, g, ms)
    gerr = rel(res["kernel"][1].arr, res["plain"][1].arr)
    print(f"phase 6: lnP kernel {float(res['kernel'][0])!r} plain {float(res['plain'][0])!r}; "
          f"grad rel max-abs err {gerr:.3e} (bound {GRAD_TOL_1024:g}); gradlnP kernel "
          f"{res['kernel'][2]:.3f} ms plain {res['plain'][2]:.3f} ms [{N_MAP}^2 P; {card}]")
    if not (torch.isfinite(res["kernel"][1].arr).all() and gerr < GRAD_TOL_1024):
        raise AssertionError(f"1024^2 kernel gradient disagrees with the plain backend: {gerr}")
    return (dict(sim=sim, vg=vg, phi_mix=phi_mix, grad=res["kernel"][1], grad_ms=res["kernel"][2]),
            res["kernel"][2], res["plain"][2])


def run_map(torch, sim, phase, label, card, precision=None):
    """MAP_joint at 1024^2 P as scripts/map_1024.py runs it, on the current
    LenseFlow backend at `precision` (None: strict everywhere): MAP_WARM
    warm-up steps, then MAP_STEPS timed with the launch counters and timers
    set to 0 just before and read just after. Checks a finite,
    never-decreasing logpdf, a first step taken and corr(phi_MAP,
    phi_true); returns (launches, s/step, history)."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    from cmblensing_tpu_torch.utils import timing
    keys = ("logpdf", "alpha", "cg_iters", "cg_res", "gradnorm", "precision_fallback", "retry")
    run = lambda n: ct.MAP_joint(sim["ds"], nsteps=n, linesearch="grid", conjgrad_kwargs=MAP_CG,
                                 history_keys=keys, precision=precision)
    t0 = time.perf_counter()
    run(MAP_WARM)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    timing.reset_timers()
    lfk.reset_launches()
    t0 = time.perf_counter()
    res = run(MAP_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(lfk.LAUNCHES)
    report = timing.timer_report()
    hist = res["history"]
    lps = [h["logpdf"] for h in hist]
    alphas = [h["alpha"] for h in hist]
    pt = sim["phi"].to(ct.MAP).arr.reshape(-1).double()
    pm = res["phi"].to(ct.MAP).arr.reshape(-1).double()
    corr = float(pm @ pt / (pm.norm() * pt.norm()))
    print(f"phase {phase}: MAP_joint {N_MAP}^2 P: {MAP_WARM} warm-up steps {warm:.2f} s; "
          f"{MAP_STEPS} steps {dt:.2f} s = {dt / MAP_STEPS:.3f} s/step {label} [{card}]")
    for line in report.splitlines():
        print(f"phase {phase}: timers", line)
    print(f"phase {phase}: logpdfs {lps!r}")
    print(f"phase {phase}: alphas {alphas!r}; CG iters {[h['cg_iters'] for h in hist]}; "
          f"CG res {[float(h['cg_res']) for h in hist]!r}")
    print(f"phase {phase}: gradnorm {[float(h['gradnorm']) for h in hist]!r}")
    print(f"phase {phase}: precision {precision!r}: f-steps re-run strict (precision_fallback) "
          f"{[h['precision_fallback'] for h in hist]}; direction retries "
          f"{[h['retry'] for h in hist]}")
    print(f"phase {phase}: corr(phi_MAP, phi_true) = {corr:.4f} (bound >= {CORR_MIN:g})")
    print(f"phase {phase}: launches in the MAP_joint run: {launches}; per step "
          f"{ {k: v / MAP_STEPS for k, v in launches.items() if v} }")
    if not all(np.isfinite(lps)) or any(b < a for a, b in zip(lps, lps[1:])):
        raise AssertionError(f"MAP_joint logpdf not finite and non-decreasing: {lps}")
    if not alphas[0] > 0:
        raise AssertionError(f"first line search accepted no step: {alphas}")
    if not corr >= CORR_MIN:
        raise AssertionError(f"corr(phi_MAP, phi_true) = {corr} < {CORR_MIN}")
    dense = {k: launches[k] for k in DENSE_KERNELS
             if k not in ("rk4_update", "p_planes") and launches[k]}
    if dense:
        raise AssertionError(f"dense K2 kernels launched at {N_MAP}^2: {dense}")
    return launches, dt / MAP_STEPS, hist


def phase_map(torch, sim, card):
    """MAP_joint at 1024^2 P on the factored kernels; one plain-backend
    step beside it."""
    import cmblensing_tpu_torch as ct
    launches, s_step, hist = run_map(torch, sim, 7, "kernel", card)
    with ct.lenseflow_backend_ctx("plain"):
        t1 = time.perf_counter()
        ct.MAP_joint(sim["ds"], nsteps=1, linesearch="grid", conjgrad_kwargs=MAP_CG, precision=None)
        torch.cuda.synchronize()
        plain_step = time.perf_counter() - t1
    print(f"phase 7: plain backend {plain_step:.3f} s/step (1 step) [{card}]")
    if min(launches[k] for k in FACTORED_KERNELS) <= 0:
        raise AssertionError(f"a factored kernel never launched in MAP_joint: {launches}")
    if any(launches[k] for k in HIGH_KERNELS):
        raise AssertionError(f"a 'high' kernel launched in the strict MAP_joint: {launches}")
    return launches, s_step, plain_step, hist


def phase_uni(torch, card, fctx, gctx):
    """The 1024^2 P path on the "uni" backend: K5, every role at the
    operands the uni flows give it, at batch 1 and on a NTRIAL-trial state
    with NTRIAL phi scalings, against its plain version; the uni flows
    against their plain versions and phase 5's K3/K4 flows; the
    phi-gradient against the kernel backend; MAP_joint as in phase 7."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import deriv, lenseflow_kernels as lfk
    ops, phi, f, dy = (fctx[k] for k in ("ops", "phi", "f", "dy"))
    t = 0.5
    nonzero, nder = {0: 4, 1: 1, 2: 2, 3: 2}, {0: 4, 1: 6, 2: 4, 3: 4}

    def operands(phis, state):
        """px, py and each role's (a, b) as the uni flows pass them: views
        of a (nb, 4, N, N) state (f, delta f); role 1 takes u = M^-1 w of
        role 0's w."""
        px, py = (p.unsqueeze(1).contiguous() for p in lfk._p_of_t(t, phis))
        w = torch.empty((state.shape[0], 2, 4, N_MAP, N_MAP), device=DEVICE)
        lfk.uni_velocity_plain(0, state[:, :2], state[:, 2:], px, py, w, ops, t)
        m11, m12, m22 = lfk._minv_of_t(t, phis)
        wx, wy = w[:, :, 2].sum(1), w[:, :, 3].sum(1)
        u = torch.stack([m11 * wx + m12 * wy, m12 * wx + m22 * wy], dim=1)
        pair = (state[:, :1], state[:, 1:2])
        return px, py, {0: (state[:, :2], state[:, 2:]), 1: (u[:, :1], u[:, 1:]), 2: pair, 3: pair}

    def check_roles(phis, state, reps):
        """Each role, kernel against plain; every output plane of every
        entry of every trial held to the bound on its own, the planes the
        role leaves at zero exactly zero."""
        px, py, ab = operands(phis, state)
        nb, res = state.shape[0], {}
        for role, (a, b) in ab.items():
            nper = a.shape[1]
            o1 = torch.full((nb, nper, 4, N_MAP, N_MAP), float("nan"), device=DEVICE)
            o2 = torch.empty_like(o1)
            run_k = lambda: lfk.uni_velocity_cuda(role, a, b, px, py, o1, ops, t)
            run_p = lambda: lfk.uni_velocity_plain(role, a, b, px, py, o2, ops, t)
            run_k()
            run_p()
            n = nonzero[role]
            res[role] = dict(
                nb=nb, max_abs_err=float((o1[:, :, :n] - o2[:, :, :n]).abs().max()),
                rel=max(rel(o1[i, c, j], o2[i, c, j])
                        for i in range(nb) for c in range(nper) for j in range(n)),
                zero=bool((o1[:, :, n:] == 0).all()),
                ms=kernel_ms(run_k, reps, torch), plain_ms=cuda_ms(run_p, 1, torch),
                library_ms=None,
                # a, b, out per entry; px, py per trial; the factored operands
                **bound(nder[role] * nb * nper * fact_deriv_flops(N_MAP),
                        nb * (2 * nper + 2 + 4 * nper), N_MAP, fact_op_floats(N_MAP)))
        return res

    one = check_roles(phi[None], torch.cat([f, dy])[None], 10)
    scales = torch.linspace(0.1, 2.0, NTRIAL, device=DEVICE).reshape(-1, 1, 1, 1)
    states = torch.stack([torch.roll(torch.cat([f, dy]), 7 * i, dims=-1) for i in range(NTRIAL)])
    many = check_roles((scales * phi).contiguous(), states, 3)
    del states

    # whole uni flows at the main path's nsteps
    flows = {}
    for name, (t0, t1, kind) in (("L", (0., 1., "forward")), ("L^-1", (1., 0., "forward")),
                                 ("L^H", (1., 0., "adjoint"))):
        run = lambda fn: fn(f, phi, ops, t0, t1, NSTEPS, kind)
        kv, pv = run(lfk.uni_flow_apply), run(lfk.uni_flow_apply_plain)
        flows[name] = dict(rel=rel(kv, pv), k3=rel(kv, fctx["flows"][name]),
                           ms=cuda_ms(lambda: run(lfk.uni_flow_apply), 3, torch),
                           plain_ms=cuda_ms(lambda: run(lfk.uni_flow_apply_plain), 1, torch))
    bwd = lambda fn: fn(dy, f, phi, ops, 0., 1., NSTEPS)
    (dphi_u, df0_u), (dphi_p, df0_p) = bwd(lfk.uni_flow_bwd), bwd(lfk.uni_flow_bwd_plain)
    bwd_ms = cuda_ms(lambda: bwd(lfk.uni_flow_bwd), 3, torch)
    bwd_plain_ms = cuda_ms(lambda: bwd(lfk.uni_flow_bwd_plain), 1, torch)
    proj64 = ct.ProjLambert(N_MAP, N_MAP, thetapix=THETAPIX_MAP, T=np.float64, device=DEVICE)
    dphi64, _ = lfk.uni_flow_bwd_plain(dy.double(), f.double(), phi.double(),
                                       deriv.deriv_ops(proj64), 0., 1., NSTEPS)
    flows["backward df0"] = dict(rel=rel(df0_u, df0_p), k3=rel(df0_u, fctx["flows"]["df0"]),
                                 ms=bwd_ms, plain_ms=bwd_plain_ms)
    flows["backward dphi"] = dict(rel=rel(dphi_u, dphi_p), ms=bwd_ms, plain_ms=bwd_plain_ms)
    dphi_err = dict(hoisted=rel(dphi_u, fctx["flows"]["dphi"]),
                    float64=rel(dphi_u.double(), dphi64))
    del dphi64

    # the phi-gradient on "uni" against the kernel backend
    with ct.lenseflow_backend_ctx("uni"):
        v, g = gctx["vg"](gctx["phi_mix"])
        grad_ms = cuda_ms(lambda: gctx["vg"](gctx["phi_mix"]), 3, torch)
    gerr = rel(g.arr, gctx["grad"].arr)

    torch.cuda.synchronize()
    for label, res in (("", one), (f" batch {NTRIAL}", many)):
        for role, d in res.items():
            print(f"phase 8: K5 role {role}{label} rel err {d['rel']:.3e} (bound {FLOW_TOL:g}, each "
                  f"plane and trial)  zero planes exact {d['zero']}  {d['ms']:.4f} ms  plain "
                  f"{d['plain_ms']:.4f} ms  bound {d['bound_ms']:.4f} ms ({d['bound_by']})  "
                  f"[{N_MAP}^2; {card}]")
    for name, d in flows.items():
        k3 = f"; vs K3/K4 flow {d['k3']:.3e}" if "k3" in d else ""
        print(f"phase 8: uni flow {name:14s} rel err vs plain {d['rel']:.3e}{k3} (bound "
              f"{FLOW_TOL:g})  uni {d['ms']:.3f} ms  plain {d['plain_ms']:.3f} ms  "
              f"[{N_MAP}^2 P, nsteps={NSTEPS}; {card}]")
    print(f"phase 8: un-hoisted dphi vs hoisted {dphi_err['hoisted']:.3e}, vs float64 "
          f"{dphi_err['float64']:.3e} (bound {DPHI_UNHOISTED_TOL:g})")
    print(f"phase 8: lnP uni {float(v)!r}; grad rel max-abs err vs kernel backend {gerr:.3e} "
          f"(bound {GRAD_TOL_1024:g}); gradlnP uni {grad_ms:.3f} ms [{N_MAP}^2 P; {card}]")
    bad = {f"role {r}{lab}": d["rel"] for lab, res in (("", one), (f"[{NTRIAL}]", many))
           for r, d in res.items() if not (d["rel"] < FLOW_TOL and d["zero"])}
    bad.update({k: d["rel"] for k, d in flows.items() if not d["rel"] < FLOW_TOL})
    bad.update({k + " vs K3/K4": d["k3"] for k, d in flows.items()
                if "k3" in d and not d["k3"] < FLOW_TOL})
    bad.update({"dphi vs " + k: e for k, e in dphi_err.items() if not e < DPHI_UNHOISTED_TOL})
    if not (torch.isfinite(g.arr).all() and gerr < GRAD_TOL_1024):
        bad["gradient"] = gerr
    if bad:
        raise AssertionError(f"uni path disagrees: {bad}")

    with ct.lenseflow_backend_ctx("uni"):
        launches, s_step, hist = run_map(torch, gctx["sim"], 8, "uni", card)
    khist = gctx["map_hist"]
    print(f"phase 8: beside phase 7 (kernel): logpdfs {[h['logpdf'] for h in khist]!r}; alphas "
          f"{[h['alpha'] for h in khist]!r}")
    if min(launches[k] for k in UNI_KERNELS) <= 0:
        raise AssertionError(f"a kernel of the uni path never launched in MAP_joint: {launches}")
    k34 = {k: launches[k] for k in ("fa_velocity_forward", "fa_velocity_adjoint", "bv_velocity")
           if launches[k]}
    if k34:
        raise AssertionError(f"K3/K4 launched on the uni backend: {k34}")
    for role, d in one.items():
        d["batched"] = many[role]
    return {f"uni_role{r}": d for r, d in one.items()}, launches, grad_ms, s_step


def split_ratio(high, plain, strict):
    """Relative Frobenius distances of a 'high' result, plane by plane
    (leading axes flattened): to its plain 'high' version (largest), to
    the strict result (least), and the largest ratio of the two."""
    trip = list(zip(*(x.reshape(-1, *x.shape[-2:]) for x in (high, plain, strict))))
    return dict(fro=max(fro(h, q) for h, q, _ in trip),
                fro_strict=min(fro(h, st) for h, _, st in trip),
                split_ratio=max(fro(h, q) / fro(h, st) for h, q, st in trip))


def high_against(torch, kernel, plain, shape):
    """kernel(out, precision) at 'high' and at 'f32', and plain(out), its
    plain 'high' version, each into a NaN-filled buffer of `shape`; every
    output plane on its own: rel max-abs to plain 'high' and to strict
    (largest of the planes) and the Frobenius distances and ratio."""
    oh, op, ost = (torch.full(shape, float("nan"), device=DEVICE) for _ in range(3))
    kernel(oh, "high")
    plain(op)
    kernel(ost, "f32")
    torch.cuda.synchronize()
    trip = list(zip(*(x.reshape(-1, *shape[-2:]) for x in (oh, op, ost))))
    return dict(max_abs_err=float((oh - op).abs().max()), rel=max(rel(h, q) for h, q, _ in trip),
                rel_strict=max(rel(h, st) for h, _, st in trip), **split_ratio(oh, op, ost))


def high_failures(found):
    """The entries of `found` (name -> high_against's dict) outside
    HIGH_TOL, HIGH_VS_STRICT or HIGH_SPLIT_RATIO."""
    bad = {k: d["rel"] for k, d in found.items() if not d["rel"] < HIGH_TOL}
    bad.update({k + " vs strict": d["rel_strict"] for k, d in found.items()
                if not d["rel_strict"] < HIGH_VS_STRICT})
    bad.update({k + " ratio": d["split_ratio"] for k, d in found.items()
                if not d["split_ratio"] < HIGH_SPLIT_RATIO})
    return bad


def phase_high(torch, card, fctx, gctx):
    """The 'high' tier at 1024^2 P: (a) K1, K3 (batch 1 and NTRIAL) and K4
    against their plain 'high' versions (HIGH_TOL, every output plane of
    every entry on its own) and the strict kernels (HIGH_VS_STRICT), with
    device ms beside the strict kernel's and the 'high' bound; (b) the
    'high' flows against their plain 'high' versions and the strict flows;
    (c) the phi-gradient under precision_ctx("high") against the strict
    one; (d) argmaxf_logpdf with the JAX default CG at "auto" against
    strict; (e) MAP_joint as scripts/map_1024.py runs it, at its default
    precision "auto"."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import deriv, lenseflow_kernels as lfk
    ops, phi, f, dy = (fctx[k] for k in ("ops", "phi", "f", "dy"))
    t, nan = 0.5, float("nan")
    planes_of = lambda x: x.reshape(-1, N_MAP, N_MAP)
    out = {}

    def check(name, args, shape, kernel, plain, nder, planes, nb=1, axes=2, reps=10):
        """kernel(o, precision, *args) at 'high' against plain(o, *args)
        and at 'f32', every output plane on its own: rel max-abs, and
        relative Frobenius distance to plain 'high' over that to strict.
        Both tiers are timed cold (cold_ms)."""
        oh, op, ost = (torch.full(shape, nan, device=DEVICE) for _ in range(3))
        kernel(oh, "high", *args)
        plain(op, *args)
        kernel(ost, "f32", *args)
        torch.cuda.synchronize()
        trip = list(zip(planes_of(oh), planes_of(op), planes_of(ost)))
        out[name] = dict(
            nb=nb, max_abs_err=float((oh - op).abs().max()),
            rel=max(rel(h, q) for h, q, _ in trip),
            rel_strict=max(rel(h, st) for h, _, st in trip), **split_ratio(oh, op, ost),
            ms=cold_ms(lambda *a: kernel(a[0], "high", *a[1:]), (oh, *args), reps, torch),
            strict_ms=cold_ms(lambda *a: kernel(a[0], "f32", *a[1:]), (ost, *args), reps, torch),
            plain_ms=cuda_ms(lambda: plain(op, *args), 3, torch), library_ms=None,
            **bound_high(N_MAP, nder, planes, nb, axes))

    # single derivatives: a plane in, a plane out, one axis' operands;
    # d_x a + d_y b + c: three in, one out, both axes
    a, b, c = f[0:1].contiguous(), f[1:2].contiguous(), dy[0:1].contiguous()
    for name, args, nder, planes, axes in (("fderiv_x", (a, None, None), 1, 2, 1),
                                           ("fderiv_y", (None, b, None), 1, 2, 1),
                                           ("fderiv", (a, b, c), 2, 4, 2)):
        check(name, args, a.shape, lambda o, p, *x: lfk.fderiv_cuda(*x, o, ops, p),
              lambda o, *x: lfk.fderiv_plain(*x, o, ops, "high"), nder, planes, axes=axes)
    DxT, _ = deriv.deriv_mats(ct.ProjLambert(N_MAP, N_MAP, thetapix=THETAPIX_MAP, T=np.float32,
                                             device=DEVICE))
    out["fderiv_x"]["library_ms"] = matmul_ms(a[0], DxT, torch, cold=True)
    phi1, y = phi[None], f[None].contiguous()
    pt1 = torch.empty((2, 1, N_MAP, N_MAP), device=DEVICE)
    lfk.p_planes_cuda(t, phi1, pt1)
    for kind in ("forward", "adjoint"):
        check("fa_velocity_" + kind, (y, phi1, pt1), y.shape,
              lambda o, p, y_, ph, pt: lfk.fvelocity_cuda(kind, y_, o, ph, pt, ops, 2, t, p),
              lambda o, y_, ph, pt: lfk.fvelocity_plain(kind, y_, o, ph, pt, ops, 2, t, "high"),
              4, 6)
    acc = 1e-3 * torch.as_tensor(np.random.default_rng(SEED + 1).standard_normal(
        (1, lfk.NACC, N_MAP, N_MAP)).astype(np.float32), device=DEVICE)
    yb = torch.cat([f[None], dy[None], acc], dim=1)
    check("bv_velocity", (yb, phi1, pt1), yb.shape,
          lambda o, p, y_, ph, pt: lfk.fvelocity_cuda("backward", y_, o, ph, pt, ops, 2, t, p),
          lambda o, y_, ph, pt: lfk.fvelocity_plain("backward", y_, o, ph, pt, ops, 2, t, "high"),
          8, 25)
    # the line search's batch shape (the 17 trials run strict in MAP_joint,
    # but the kernels take any batch)
    scales = torch.linspace(0.1, 2.0, NTRIAL, device=DEVICE).reshape(-1, 1, 1, 1)
    phis = (scales * phi).contiguous()
    ys = torch.stack([torch.roll(f, 7 * i, dims=-1) for i in range(NTRIAL)])
    pts = torch.empty((2, NTRIAL, N_MAP, N_MAP), device=DEVICE)
    lfk.p_planes_cuda(t, phis, pts)
    for kind in ("forward", "adjoint"):
        check(f"fa_velocity_{kind}[{NTRIAL}]", (ys, phis, pts), ys.shape,
              lambda o, p, y_, ph, pt: lfk.fvelocity_cuda(kind, y_, o, ph, pt, ops, 2, t, p),
              lambda o, y_, ph, pt: lfk.fvelocity_plain(kind, y_, o, ph, pt, ops, 2, t, "high"),
              4, 6, nb=NTRIAL, reps=5)
    del ys, pts, phis
    for name, d in out.items():
        print(f"phase 9: 'high' kernel {name:24s} vs plain 'high' {d['rel']:.3e} (bound "
              f"{HIGH_TOL:g}, each plane)  vs strict {d['rel_strict']:.3e} (bound "
              f"{HIGH_VS_STRICT:g}); Frobenius vs plain 'high' {d['fro']:.3e}, vs strict "
              f"{d['fro_strict']:.3e} (least), ratio {d['split_ratio']:.3f} (bound "
              f"{HIGH_SPLIT_RATIO:g}, each plane)  {d['ms']:.4f} ms  strict {d['strict_ms']:.4f} "
              f"ms (both cold)  plain {d['plain_ms']:.4f} ms  'high' bound {d['bound_ms']:.4f} ms "
              f"({d['bound_by']}, {100 * d['bound_ms'] / d['ms']:.1f} %)  [{N_MAP}^2; {card}]")

    # (b) whole flows at 'high' on phase 5's inputs
    flows = {}
    for name, (t0, t1, kind) in (("L", (0., 1., "forward")), ("L^-1", (1., 0., "forward")),
                                 ("L^H", (1., 0., "adjoint"))):
        run = lambda fn, p="high": fn(f, phi, ops, t0, t1, NSTEPS, kind, p)
        kv, pv = run(lfk.flow_apply), run(lfk.flow_apply_plain)
        flows[name] = dict(rel=rel(kv, pv), strict=rel(kv, fctx["flows"][name]),
                           **split_ratio(kv, pv, fctx["flows"][name]),
                           ms=cuda_ms(lambda: run(lfk.flow_apply), 3, torch),
                           strict_ms=cuda_ms(lambda: run(lfk.flow_apply, "f32"), 3, torch))
    bwd = lambda fn, p="high": fn(dy, f, phi, ops, 0., 1., NSTEPS, p)
    (dphi_k, df0_k), (dphi_p, df0_p) = bwd(lfk.flow_bwd), bwd(lfk.flow_bwd_plain)
    bwd_ms = cuda_ms(lambda: bwd(lfk.flow_bwd), 3, torch)
    bwd_strict_ms = cuda_ms(lambda: bwd(lfk.flow_bwd, "f32"), 3, torch)
    flows["backward df0"] = dict(rel=rel(df0_k, df0_p), strict=rel(df0_k, fctx["flows"]["df0"]),
                                 **split_ratio(df0_k, df0_p, fctx["flows"]["df0"]),
                                 ms=bwd_ms, strict_ms=bwd_strict_ms)
    flows["backward dphi"] = dict(rel=rel(dphi_k, dphi_p),
                                  strict=rel(dphi_k, fctx["flows"]["dphi"]),
                                  **split_ratio(dphi_k, dphi_p, fctx["flows"]["dphi"]), ms=bwd_ms,
                                  strict_ms=bwd_strict_ms)
    # grad/Hess phi at 'high': the derivatives of a Cphi-drawn phi are small
    # against the operand whose split rounding they inherit, and the Hessian
    # planes differentiate it once more, so only the Frobenius ratio is held
    gh, ghp = (fn(fctx["phi_map"], ops, "high") for fn in (lfk.gradhess, lfk.gradhess_plain))
    gh_ratio = split_ratio(gh, ghp, phi)
    print(f"phase 9: 'high' gradhess vs plain 'high', per plane (gx, gy, hxx, hxy, hyy): "
          f"{[f'{rel(gh[i], ghp[i]):.3e}' for i in range(5)]}; vs strict "
          f"{[f'{rel(gh[i], phi[i]):.3e}' for i in range(5)]}; Frobenius ratio "
          f"{gh_ratio['split_ratio']:.3f} (bound {HIGH_SPLIT_RATIO:g}, each plane)")
    for name, d in flows.items():
        print(f"phase 9: 'high' flow {name:14s} vs plain 'high' {d['rel']:.3e} (bound "
              f"{HIGH_TOL:g})  vs strict {d['strict']:.3e}; Frobenius vs plain 'high' "
              f"{d['fro']:.3e}, vs strict {d['fro_strict']:.3e}, ratio {d['split_ratio']:.3f} "
              f"(bound {FLOW_SPLIT_RATIO:g})  {d['ms']:.3f} ms  strict {d['strict_ms']:.3f} ms  "
              f"[{N_MAP}^2 P, nsteps={NSTEPS}; {card}]")

    # (c) the phi-gradient at 'high' against the strict one (phase 6)
    with ct.lenseflow_backend_ctx("kernel"), deriv.precision_ctx("high"):
        _, g = gctx["vg"](gctx["phi_mix"])
        grad_ms = cuda_ms(lambda: gctx["vg"](gctx["phi_mix"]), 3, torch)
    gs = gctx["grad"].arr
    gerr = rel(g.arr, gs)
    cos = float((g.arr.double() * gs.double()).sum() / (g.arr.double().norm() * gs.double().norm()))
    print(f"phase 9: gradlnP 'high' vs strict: rel max-abs {gerr:.3e}, cosine {cos:.9f}; "
          f"{grad_ms:.3f} ms ('f32' {gctx['grad_ms']:.3f} ms) [{N_MAP}^2 P; {card}]")

    # (d) the Wiener filter at the JAX default CG (tol 0.1, up to 500 iterations)
    sim = gctx["sim"]
    wf = {}
    for hp in ("auto", None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fw, info = ct.argmaxf_logpdf(sim["ds"], phi=sim["phi"],
                                     conjgrad_kwargs=dict(hessian_precision=hp))
        torch.cuda.synchronize()
        wf[hp] = (fw, info, 1e3 * (time.perf_counter() - t0))
    fa_, fs_ = wf["auto"][0].arr, wf[None][0].to(wf["auto"][0].basis).arr
    wf_err = float((fa_ - fs_).norm() / fs_.norm())
    ia = wf["auto"][1]
    # the 'high' solve's own check, which a fallback's info no longer holds
    from cmblensing_tpu_torch.inference.maximization import _argmaxf_core
    with torch.no_grad():
        _, ih = _argmaxf_core(sim["ds"], {}, sim["phi"], sim["ds"].d, None, False, "high",
                              tol=1e-1, nsteps=500)
    print(f"phase 9: the 'high' solve's check: {ih['iterations']} iterations, res "
          f"{float(ih['res']):.4e} (its own operator), res_strict {float(ih['res_strict']):.4e} "
          f"against max(tol 0.1, 1e-10 res0), res0 {float(ih['res0']):.4e}")
    print(f"phase 9: argmaxf_logpdf (tol 0.1, nsteps 500) \"auto\": {ia['iterations']} iterations, "
          f"precision_ok {bool(ia.get('precision_ok', False))}, precision_fallback "
          f"{bool(ia.get('precision_fallback', False))}, {wf['auto'][2]:.1f} ms; strict: "
          f"{wf[None][1]['iterations']} iterations, {wf[None][2]:.1f} ms; |f_auto - f_strict| / "
          f"|f_strict| = {wf_err:.3e} (bound {WF_HIGH_TOL:g}) [{N_MAP}^2 P; {card}]")

    bad = {k: d["rel"] for k, d in out.items() if not d["rel"] < HIGH_TOL}
    bad.update({k + " vs strict": d["rel_strict"] for k, d in out.items()
                if not d["rel_strict"] < HIGH_VS_STRICT})
    bad.update({"flow " + k: d["rel"] for k, d in flows.items() if not d["rel"] < HIGH_TOL})
    bad.update({k + " Frobenius ratio": d["split_ratio"]
                for k, d in [*out.items(), ("gradhess", gh_ratio)]
                if not d["split_ratio"] < HIGH_SPLIT_RATIO})
    bad.update({"flow " + k + " Frobenius ratio": d["split_ratio"] for k, d in flows.items()
                if not d["split_ratio"] < FLOW_SPLIT_RATIO})
    if not torch.isfinite(g.arr).all():
        bad["gradient"] = "not finite"
    if not wf_err < WF_HIGH_TOL:
        bad["argmaxf"] = wf_err
    if bad:
        raise AssertionError(f"'high' tier disagrees: {bad}")

    # (e) the north star at the JAX default precision "auto"
    with ct.lenseflow_backend_ctx("kernel"):
        launches, s_step, hist = run_map(torch, sim, 9, "kernel, precision \"auto\"", card,
                                         precision="auto")
    khist = gctx["map_hist"]
    print(f"phase 9: beside phase 7 (strict): logpdfs {[h['logpdf'] for h in khist]!r}; alphas "
          f"{[h['alpha'] for h in khist]!r}")
    print(f"phase 9: f-steps re-run strict {sum(h['precision_fallback'] for h in hist)} of "
          f"{len(hist)}; direction retries fired {sum(h['retry'] for h in hist)}")
    if min(launches[k] for k in HIGH_KERNELS) <= 0:
        raise AssertionError(f"a 'high' kernel never launched in the \"auto\" MAP_joint: {launches}")
    return out, launches, dict(gradlnP_1024_high=grad_ms, argmaxf_1024_auto_ms=wf["auto"][2],
                               argmaxf_1024_strict_ms=wf[None][2],
                               MAP_joint_1024_auto_s_per_step=s_step)


def phase_edges(torch, card):
    """Phase 10: K2 (each velocity kind, the derivative), p(t) and the RK4
    update at plane shapes the 32 x 32 tile does not divide, both tiers,
    every plane against the plain version at the same precision (FLOW_TOL
    strict, HIGH_TOL at 'high'), nothing written past the last plane; the
    forward velocity's device ms per shape and tier; one L @ f on a 200^2
    load_sim on the kernel backend against the plain (cuFFT) backend."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import deriv, lenseflow_kernels as lfk
    nan, t, found, times = float("nan"), 0.4, {}, {}
    for Ny, Nx in EDGE_SHAPES:
        proj = ct.ProjLambert(Ny, Nx, thetapix=3, T=np.float32, device=DEVICE)
        mats = deriv.deriv_mats(proj)
        rng = np.random.default_rng(SEED + 2)
        T = lambda *sh: torch.as_tensor(rng.standard_normal(sh).astype(np.float32), device=DEVICE)
        phi_f = np.zeros((1, Ny, Nx // 2 + 1), np.complex128)
        phi_f[0, 1, 1] = 1e-3 * (Ny * Nx / 1024) ** 2   # Hess phi ~ 0.1
        phi = lfk.gradhess_plain(torch.as_tensor(np.fft.irfft2(phi_f, s=(Ny, Nx)).astype(
            np.float32), device=DEVICE), mats)
        pt = torch.empty((2, Ny, Nx), device=DEVICE)
        lfk.p_planes_plain(t, phi, pt)
        a, b, c = T(1, Ny, Nx), T(1, Ny, Nx), T(1, Ny, Nx)
        ys = {"forward": T(2, Ny, Nx), "adjoint": T(2, Ny, Nx),
              "backward": torch.cat([T(4, Ny, Nx), 1e-3 * T(lfk.NACC, Ny, Nx)])}

        def check(name, p, n, kernel, plain):
            full = torch.full((n + 1, Ny, Nx), nan, device=DEVICE)
            ref = torch.empty((n, Ny, Nx), device=DEVICE)
            kernel(full[:n])
            plain(ref)
            found[(name, Ny, Nx, p)] = (max(rel(x, y) for x, y in zip(full[:n], ref)),
                                        bool(torch.isnan(full[n]).all()))

        for p in lfk.PRECISIONS:
            for name, args in (("deriv_x", (a, None, None)), ("deriv", (a, b, c))):
                check(name, p, 1, lambda o: lfk.deriv_cuda(*args, o, mats, p),
                      lambda o: lfk.deriv_plain(*args, o, mats, p))
            for kind, y in ys.items():
                check("velocity_" + kind, p, y.shape[0],
                      lambda o: lfk.velocity_cuda(kind, y, o, phi, pt, mats, 2, t, p),
                      lambda o: lfk.velocity_plain(kind, y, o, phi, pt, mats, 2, t, p))
            k = torch.empty_like(ys["forward"])
            times[(Ny, Nx, p)] = kernel_ms(
                lambda: lfk.velocity_cuda("forward", ys["forward"], k, phi, pt, mats, 2, t, p), 20,
                torch)
        check("p_planes", "f32", 2, lambda o: lfk.p_planes_cuda(t, phi, o),
              lambda o: lfk.p_planes_plain(t, phi, o))
        y, k = T(9, Ny, Nx), T(9, Ny, Nx)
        rk = [torch.zeros((2, 9, Ny, Nx), device=DEVICE) for _ in range(2)]
        for fn, (acc, s_) in zip((lfk.rk4_update_cuda, lfk.rk4_update_plain), rk):
            fn(y, k, acc, s_, 1, 1 / 21, 1 / 14)
        found[("rk4_update", Ny, Nx, "f32")] = (rel(rk[0], rk[1]), True)
    torch.cuda.synchronize()
    for (name, Ny, Nx, p), (e, clean) in found.items():
        print(f"phase 10: {name:18s} {Ny}x{Nx} {p:4s} rel err vs plain {e:.3e} (bound "
              f"{FLOW_TOL if p == 'f32' else HIGH_TOL:g}, each plane); past the last plane "
              f"{'untouched' if clean else 'WRITTEN'}")
    for (Ny, Nx, p), ms in times.items():
        print(f"phase 10: velocity_forward {Ny}x{Nx} {p}: {ms:.4f} ms [{card}]")
    sim = ct.load_sim(thetapix=3, Nside=200, pol="P", T=np.float32, seed=SEED, device=DEVICE)
    L = ct.LenseFlow(sim["phi"], NSTEPS)
    fq = sim["f"].to(ct.QU_MAP)
    with ct.lenseflow_backend_ctx("kernel"):
        lk = (L @ fq).arr
    with ct.lenseflow_backend_ctx("plain"):
        lp = (L @ fq).arr
    lerr = rel(lk, lp)
    print(f"phase 10: L @ f on load_sim(Nside=200, pol P): kernel vs plain backend {lerr:.3e} "
          f"(bound {GRAD_TOL:g})")
    bad = {k: v for k, v in found.items()
           if not (v[1] and v[0] < (FLOW_TOL if k[3] == "f32" else HIGH_TOL))}
    if not (torch.isfinite(lk).all() and lerr < GRAD_TOL):
        bad["L @ f"] = lerr
    if bad:
        raise AssertionError(f"edge tiles disagree: {bad}")
    return times


def phase_dense_high(torch, card, ds, f_mix, phi_mix, strict):
    """Phase 11: K2 'high' at 256^2 P. (a) Each velocity kind and the
    derivative, one launch each, against its plain 'high' version
    (HIGH_TOL) and the strict kernel (HIGH_VS_STRICT), every output plane
    on its own, with the Frobenius ratio (HIGH_SPLIT_RATIO), device ms
    cold beside the strict kernel's (cold too), the 'high' bound and the
    three bf16 matmuls of the split; (b) the 'high' flows against the plain
    'high' flows and the strict ones (HIGH_TOL, FLOW_SPLIT_RATIO); (c) the
    phi-gradient at 'high' against the strict one and the plain 'high'
    one (the "matmul" backend; FLOW_SPLIT_RATIO per plane), with its ms; (d) two steps of
    MAP_joint at its defaults ("auto"), the launch counters set to 0 just
    before and read just after: finite, non-decreasing logpdfs, every K2
    'high' kernel launched (the kernels line reports these counts)."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import deriv, lenseflow_kernels as lfk
    proj = ct.ProjLambert(N, N, thetapix=3, T=np.float32, device=DEVICE)
    mats = deriv.deriv_mats(proj)
    phi_map, f, dy = weak_lensing_inputs(proj, torch)
    phi = lfk.gradhess(phi_map, mats)
    t, out = 0.5, {}
    pt = torch.empty((2, N, N), device=DEVICE)
    lfk.p_planes_cuda(t, phi, pt)

    def check(name, args, shape, kernel, plain, nder, planes):
        o = torch.empty(shape, device=DEVICE)
        out[name] = dict(
            **high_against(torch, lambda o_, p: kernel(o_, p, *args), lambda o_: plain(o_, *args),
                           shape),
            ms=cold_ms(lambda *a: kernel(a[0], "high", *a[1:]), (o, *args), 20, torch),
            strict_ms=cold_ms(lambda *a: kernel(a[0], "f32", *a[1:]), (o, *args), 20, torch),
            plain_ms=cuda_ms(lambda: plain(o, *args), 5, torch), library_ms=None,
            **bound_dense_high(N, nder, planes))

    a, b, c = f[0:1].contiguous(), f[1:2].contiguous(), dy[0:1].contiguous()
    for name, args, nder, planes in (("deriv", (a, None, None), 1, 3),
                                     ("deriv_xy", (a, b, c), 2, 6)):
        check(name, args, a.shape, lambda o, p, *x: lfk.deriv_cuda(*x, o, mats, p),
              lambda o, *x: lfk.deriv_plain(*x, o, mats, "high"), nder, planes)
    out["deriv"]["library_ms"] = split_matmuls_ms(a[0], mats[0], True, torch)
    ybwd = torch.cat([f, dy, 1e-3 * torch.as_tensor(np.random.default_rng(SEED + 1).standard_normal(
        (lfk.NACC, N, N)).astype(np.float32), device=DEVICE)])
    for kind, y, nder, planes in (("forward", f, 4, 8), ("adjoint", f, 4, 8),
                                  ("backward", ybwd, 8, 27)):
        check("velocity_" + kind, (y,), y.shape,
              lambda o, p, y_: lfk.velocity_cuda(kind, y_, o, phi, pt, mats, 2, t, p),
              lambda o, y_: lfk.velocity_plain(kind, y_, o, phi, pt, mats, 2, t, "high"),
              nder, planes)
    for name, d in out.items():
        print(f"phase 11: 'high' kernel {name:18s} vs plain 'high' {d['rel']:.3e} (bound "
              f"{HIGH_TOL:g}, each plane)  vs strict {d['rel_strict']:.3e} (bound "
              f"{HIGH_VS_STRICT:g}); Frobenius ratio {d['split_ratio']:.3f} (bound "
              f"{HIGH_SPLIT_RATIO:g})  {d['ms']:.4f} ms  strict {d['strict_ms']:.4f} ms (both "
              f"cold; phase 2's strict, L2-resident: "
              f"{strict.get(name, {}).get('ms', float('nan')):.4f})  plain {d['plain_ms']:.4f} ms  "
              f"library {d['library_ms']}  'high' bound {d['bound_ms']:.4f} ms ({d['bound_by']}, "
              f"{100 * d['bound_ms'] / d['ms']:.1f} %)  [{N}^2; {card}]")

    # (b) whole flows at 'high'
    flows = {}
    for name, (t0, t1, kind) in (("L", (0., 1., "forward")), ("L^-1", (1., 0., "forward")),
                                 ("L^H", (1., 0., "adjoint"))):
        run = lambda fn, p="high": fn(f, phi, mats, t0, t1, NSTEPS, kind, p)
        kv, pv, sv = run(lfk.flow_apply), run(lfk.flow_apply_plain), run(lfk.flow_apply, "f32")
        flows[name] = dict(rel=rel(kv, pv), strict=rel(kv, sv), **split_ratio(kv, pv, sv),
                           ms=cuda_ms(lambda: run(lfk.flow_apply), 5, torch),
                           strict_ms=cuda_ms(lambda: run(lfk.flow_apply, "f32"), 5, torch))
    bwd = lambda fn, p="high": fn(dy, f, phi, mats, 0., 1., NSTEPS, p)
    for name, kv, pv, sv in zip(("backward dphi", "backward df0"), bwd(lfk.flow_bwd),
                                bwd(lfk.flow_bwd_plain), bwd(lfk.flow_bwd, "f32")):
        flows[name] = dict(rel=rel(kv, pv), strict=rel(kv, sv), **split_ratio(kv, pv, sv),
                           ms=cuda_ms(lambda: bwd(lfk.flow_bwd), 5, torch),
                           strict_ms=cuda_ms(lambda: bwd(lfk.flow_bwd, "f32"), 5, torch))
    for name, d in flows.items():
        print(f"phase 11: 'high' flow {name:14s} vs plain 'high' {d['rel']:.3e} (bound "
              f"{HIGH_TOL:g})  vs strict {d['strict']:.3e}; Frobenius ratio "
              f"{d['split_ratio']:.3f} (bound {FLOW_SPLIT_RATIO:g})  {d['ms']:.3f} ms  strict "
              f"{d['strict_ms']:.3f} ms  [{N}^2 P, nsteps={NSTEPS}; {card}]")

    # (c) the phi-gradient at 'high' against strict and the plain 'high' one
    vg = ct.fvalue_and_grad(lambda p: ct.Mixed(ds).logpdf(f_mix=f_mix, phi_mix=p))
    with ct.lenseflow_backend_ctx("kernel"):
        _, gs = vg(phi_mix)
        strict_ms = cuda_ms(lambda: vg(phi_mix), 5, torch)
        with deriv.precision_ctx("high"):
            _, gh = vg(phi_mix)
            high_ms = cuda_ms(lambda: vg(phi_mix), 5, torch)
    # the reference: the same flows on their plain 'high' leaves, which
    # launch no kernel
    with ct.lenseflow_backend_ctx("matmul"), deriv.precision_ctx("high"):
        lfk.reset_launches()
        _, gp = vg(phi_mix)
        ref_launches = sum(lfk.LAUNCHES.values())
    grad = dict(rel=rel(gh.arr, gp.arr), strict=rel(gh.arr, gs.arr),
                **split_ratio(gh.arr, gp.arr, gs.arr), ms=high_ms, strict_ms=strict_ms)
    print(f"phase 11: gradlnP 'high' vs plain 'high' {grad['rel']:.3e}, vs strict "
          f"{grad['strict']:.3e}; Frobenius ratio {grad['split_ratio']:.3f} (bound "
          f"{FLOW_SPLIT_RATIO:g}); {high_ms:.3f} ms ('f32' {strict_ms:.3f} ms) [{N}^2 P; {card}]")

    # (d) MAP_joint at its defaults, two steps
    with ct.lenseflow_backend_ctx("kernel"):
        lfk.reset_launches()
        t0 = time.perf_counter()
        res = ct.MAP_joint(ds, nsteps=2, history_keys=("logpdf", "alpha", "cg_iters",
                                                       "precision_fallback"))
        torch.cuda.synchronize()
        map_s = time.perf_counter() - t0
        map_launches = dict(lfk.LAUNCHES)
    hist = res["history"]
    lps = [h["logpdf"] for h in hist]
    print(f"phase 11: MAP_joint {N}^2 P at \"auto\", 2 steps {map_s:.2f} s: logpdfs {lps!r}; "
          f"alphas {[h['alpha'] for h in hist]!r}; CG iters {[h['cg_iters'] for h in hist]}; "
          f"fallbacks {[h['precision_fallback'] for h in hist]}; launches "
          f"{ {k: v for k, v in map_launches.items() if v} } [{card}]")

    bad = high_failures(out)
    if ref_launches:
        bad["plain 'high' gradient launches"] = ref_launches
    bad.update({"flow " + k: d["rel"] for k, d in flows.items() if not d["rel"] < HIGH_TOL})
    bad.update({"flow " + k + " ratio": d["split_ratio"] for k, d in
                [*flows.items(), ("gradient", grad)] if not d["split_ratio"] < FLOW_SPLIT_RATIO})
    if not torch.isfinite(gh.arr).all():
        bad["gradient"] = "not finite"
    if not all(np.isfinite(lps)) or any(y < x for x, y in zip(lps, lps[1:])):
        bad["MAP_joint logpdf"] = lps
    if min(map_launches[k] for k in DENSE_HIGH_KERNELS) <= 0:
        bad["MAP_joint 'high' launches"] = map_launches
    if bad:
        raise AssertionError(f"K2 'high' disagrees: {bad}")
    return out, map_launches, dict(gradlnP_256_high=high_ms, gradlnP_256_strict=strict_ms,
                                   MAP_joint_256_auto_2_steps_s=map_s)


def phase_wiener(torch, card):
    """Phase 12, the slice: load_sim at WF_SIM; (a) K2 'high' on the
    slice's own inputs, I, Q and U on the grid's z axis: each velocity kind
    and the derivative against its plain 'high' version and the strict
    kernel (HIGH_TOL, HIGH_VS_STRICT, HIGH_SPLIT_RATIO, every plane); (b)
    argmaxf_logpdf at the JAX defaults (tol 0.1, nsteps 500, "auto") with
    the launch counters set to 0 just before and read just after, the
    'high' solve's own strict check (res_strict) reported; the strict solve
    (hessian_precision=None) beside it (f within WF_HIGH_TOL in norm); (c)
    20 fixed iterations, strict, of the kernel backend against the plain
    one (WF_PLAIN_TOL), and at 'high' against the "matmul" backend (the
    same flows on their plain 'high' leaves: WF_PLAIN_TOL, and nearer it
    than the strict solve, FLOW_SPLIT_RATIO), whatever the fallback does."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.inference import maximization as tm
    from cmblensing_tpu_torch.ops import deriv, lenseflow_kernels as lfk
    t0 = time.perf_counter()
    sim = ct.load_sim(**WF_SIM, device=DEVICE)
    ds, phi = sim["ds"], sim["phi"]
    torch.cuda.synchronize()
    print(f"phase 12: load_sim {WF_SIM}: {time.perf_counter() - t0:.2f} s [{card}]")

    # (a) the 'high' kernels at the shapes the IP flows give them
    mats = deriv.deriv_mats(phi.proj)
    planes = lfk.gradhess(phi.to(ct.MAP).arr.contiguous(), mats)
    f = sim["f"].to(ct.IQU_MAP).arr.contiguous()
    d = ds.d.to(ct.IQU_MAP).arr.contiguous()
    ncomp, t = f.shape[-3], 0.5
    pt = torch.empty((2, N, N), device=DEVICE)
    lfk.p_planes_cuda(t, planes, pt)
    ybwd = torch.cat([f, d, torch.zeros((lfk.NACC, N, N), device=DEVICE)])
    kernels = {name: high_against(torch, lambda o, p: lfk.deriv_cuda(*args, o, mats, p),
                                  lambda o: lfk.deriv_plain(*args, o, mats, "high"), f.shape)
               for name, args in (("deriv", (f, None, None)), ("deriv_xy", (f, d, f)))}
    for kind, y in (("forward", f), ("adjoint", f), ("backward", ybwd)):
        kernels["velocity_" + kind] = high_against(
            torch, lambda o, p: lfk.velocity_cuda(kind, y, o, planes, pt, mats, ncomp, t, p),
            lambda o: lfk.velocity_plain(kind, y, o, planes, pt, mats, ncomp, t, "high"), y.shape)
    for name, r in kernels.items():
        print(f"phase 12: 'high' kernel {name:18s} on {ncomp} x {N}^2 vs plain 'high' "
              f"{r['rel']:.3e} (bound {HIGH_TOL:g}, each plane)  vs strict {r['rel_strict']:.3e} "
              f"(bound {HIGH_VS_STRICT:g}); Frobenius ratio {r['split_ratio']:.3f} (bound "
              f"{HIGH_SPLIT_RATIO:g})")

    # (b) the JAX defaults, and strict
    solves, core = [], tm._argmaxf_core

    def spy(*a, **k):
        x, info = core(*a, **k)
        solves.append(dict(info))
        return x, info

    def solve(**cg):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fw, info = ct.argmaxf_logpdf(ds, phi=phi, conjgrad_kwargs=cg or None)
        torch.cuda.synchronize()
        return fw, info, 1e3 * (time.perf_counter() - t)

    with ct.lenseflow_backend_ctx("kernel"):
        tm._argmaxf_core = spy
        try:
            lfk.reset_launches()
            fa, ia, ms_auto = solve()
            launches = dict(lfk.LAUNCHES)
        finally:
            tm._argmaxf_core = core
        fs, is_, ms_strict = solve(hessian_precision=None)
    hi = solves[0]
    fallback = bool(ia.get("precision_fallback", False))
    norm_err = lambda x, y: float((x.arr - y.to(x.basis).arr).norm() / x.arr.norm())
    wf_err = norm_err(fs, fa)
    print(f"phase 12: argmaxf_logpdf \"auto\" (tol 0.1, nsteps 500): the 'high' solve "
          f"{hi['iterations']} iterations, res {float(hi['res']):.4e} (its own operator), "
          f"res_strict {float(hi['res_strict']):.4e} against max(tol 0.1, 1e-10 res0 = "
          f"{1e-10 * float(hi['res0']):.4e}); precision_fallback {fallback}; "
          f"{ia['iterations']} iterations returned, {ms_auto:.1f} ms [{card}]")
    print(f"phase 12: launches in the \"auto\" solve: "
          f"{ {k: v for k, v in launches.items() if v} }")
    print(f"phase 12: strict solve {is_['iterations']} iterations {ms_strict:.1f} ms; "
          f"|f_auto - f_strict| / |f_strict| = {wf_err:.3e} (bound {WF_HIGH_TOL:g})"
          + ("; after the fallback f_auto is a strict solve too" if fallback else ""))

    # (c) 20 fixed iterations: strict, kernel vs plain (cuFFT) backend;
    # 'high' throughout (b, a0 and every Hessian apply), kernel vs matmul
    fixed = dict(tol=0.0, nsteps=20, fixed_iters=True, hessian_precision=None)
    fixed_runs, fixed_launches = {}, {}
    for backend, p in (("kernel", "f32"), ("plain", "f32"), ("kernel", "high"), ("matmul", "high")):
        with ct.lenseflow_backend_ctx(backend), deriv.precision_ctx(p):
            lfk.reset_launches()
            fixed_runs[backend, p], _, ms = solve(**fixed)
            fixed_launches[backend, p] = dict(lfk.LAUNCHES)
        print(f"phase 12: 20 fixed iterations, {backend} backend at {p!r}: {ms:.1f} ms [{card}]")
    fk, fp = fixed_runs["kernel", "f32"], fixed_runs["plain", "f32"]
    fhk, fhm = fixed_runs["kernel", "high"], fixed_runs["matmul", "high"]
    plain_err, high_err = norm_err(fp, fk), norm_err(fhm, fhk)
    high_ratio = high_err / norm_err(fk, fhk)
    print(f"phase 12: 20 fixed strict iterations, kernel vs plain backend |f_k - f_p| / |f_p| "
          f"= {plain_err:.3e} (bound {WF_PLAIN_TOL:g}); at 'high', kernel vs matmul backend "
          f"{high_err:.3e} (bound {WF_PLAIN_TOL:g}), over the distance to the strict kernel "
          f"solve {high_ratio:.3f} (bound {FLOW_SPLIT_RATIO:g})")
    bad = high_failures(kernels)
    if not all(torch.isfinite(x.arr).all() for x in (fa, fs, fk, fp, fhk, fhm)):
        bad["f"] = "not finite"
    if not wf_err < WF_HIGH_TOL:
        bad["auto vs strict"] = wf_err
    if not plain_err < WF_PLAIN_TOL:
        bad["kernel vs plain"] = plain_err
    if not (high_err < WF_PLAIN_TOL and high_ratio < FLOW_SPLIT_RATIO):
        bad["'high' kernel vs matmul"] = (high_err, high_ratio)
    wf_high = DENSE_HIGH_KERNELS[:2] + ("deriv_high",)
    if min(launches[k] for k in wf_high) <= 0:
        bad["'high' launches"] = launches
    if (min(fixed_launches["kernel", "high"][k] for k in wf_high) <= 0
            or any(fixed_launches["matmul", "high"].values())):
        bad["fixed 'high' launches"] = fixed_launches
    if bad:
        raise AssertionError(f"the masked IP Wiener filter disagrees: {bad}")
    return launches, dict(argmaxf_256_IP_auto_ms=ms_auto, argmaxf_256_IP_strict_ms=ms_strict,
                          argmaxf_256_IP_auto_iterations=int(ia["iterations"]),
                          argmaxf_256_IP_strict_iterations=int(is_["iterations"]),
                          argmaxf_256_IP_auto_fallback=fallback)


def large_kernels(torch, card, N):
    """Phase 13 (a) at N^2: K1 (d_x, d_y), K3 (forward, adjoint; batch 1
    and NTRIAL) and K4 at radix N / FA, each at both tiers on the same
    inputs: strict against its plain version (FLOW_TOL, every output plane
    on its own), 'high' against plain 'high' and the strict kernel
    (HIGH_TOL, HIGH_VS_STRICT, HIGH_SPLIT_RATIO, every plane); both tiers
    timed cold, with their bounds, and the library call of K1's d_x
    (`a @ DxT`); each launched twice at each tier, bit for bit the same.
    Returns ({tier: {name: record}}, the inputs)."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import deriv, factored_deriv, lenseflow_kernels as lfk
    B = N // FA
    proj = ct.ProjLambert(N, N, thetapix=THETAPIX_MAP, T=np.float32, device=DEVICE)
    t0 = time.perf_counter()
    ops = deriv.deriv_ops(proj)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    if not isinstance(ops, factored_deriv.FactoredOps) or ops.FX.shape[0] != B:
        raise AssertionError(f"deriv_ops gives no radix-{B} factored operands at {N}^2")
    print(f"phase 13: factored operands at {N}^2 (radix {B}, host float64, and their split): "
          f"{host_s:.2f} s")
    phi_map, f, dy = weak_lensing_inputs(proj, torch)
    phi = lfk.gradhess(phi_map, ops)
    planes_of = lambda x: x.reshape(-1, N, N)
    nan, t = float("nan"), 0.5
    out = {"f32": {}, "high": {}}

    def check(name, args, shape, kernel, plain, nder, planes, nb=1, axes=2, reps=5):
        """kernel(o, precision, *args) and plain(o, precision, *args) at both
        tiers, every output plane on its own."""
        ost, opl, oh, oph = (torch.full(shape, nan, device=DEVICE) for _ in range(4))
        kernel(ost, "f32", *args)
        plain(opl, "f32", *args)
        kernel(oh, "high", *args)
        plain(oph, "high", *args)
        # the channel groups' sums run in a fixed order: a second launch
        # into a buffer of other contents gives the same bits
        for o, p in ((ost, "f32"), (oh, "high")):
            again = torch.zeros(shape, device=DEVICE)
            kernel(again, p, *args)
            if not torch.equal(again, o):
                raise AssertionError(f"radix-{B} {name} {p}: two launches differ")
            del again
        torch.cuda.synchronize()
        strict = list(zip(planes_of(ost), planes_of(opl)))
        trip = list(zip(planes_of(oh), planes_of(oph), planes_of(ost)))
        floats = (1 if axes == 1 else 2) * (B * FA * FA + 2 * B * B)
        out["f32"][name] = dict(
            nb=nb, max_abs_err=float((ost - opl).abs().max()),
            rel=max(rel(k, p) for k, p in strict),
            ms=cold_ms(lambda *a: kernel(a[0], "f32", *a[1:]), (ost, *args), reps, torch),
            plain_ms=cuda_ms(lambda: plain(opl, "f32", *args), 1, torch), library_ms=None,
            **bound(nb * nder * fact_deriv_flops(N), nb * planes, N, floats))
        out["high"][name] = dict(
            nb=nb, max_abs_err=float((oh - oph).abs().max()),
            rel=max(rel(h, q) for h, q, _ in trip),
            rel_strict=max(rel(h, st) for h, _, st in trip), **split_ratio(oh, oph, ost),
            ms=cold_ms(lambda *a: kernel(a[0], "high", *a[1:]), (oh, *args), reps, torch),
            plain_ms=cuda_ms(lambda: plain(oph, "high", *args), 1, torch), library_ms=None,
            **bound_high(N, nder, planes, nb, axes))
        del ost, opl, oh, oph

    a, b = f[0:1].contiguous(), f[1:2].contiguous()
    for name, args, axes in (("fderiv_x", (a, None, None), 1), ("fderiv_y", (None, b, None), 1)):
        check(name, args, a.shape, lambda o, p, *x: lfk.fderiv_cuda(*x, o, ops, p),
              lambda o, p, *x: lfk.fderiv_plain(*x, o, ops, p), 1, 2, axes=axes)
    DxT, _ = deriv.deriv_mats(proj)
    out["f32"]["fderiv_x"]["library_ms"] = matmul_ms(a[0], DxT, torch, cold=True)
    out["high"]["fderiv_x"]["library_ms"] = split_matmuls_ms(a[0], DxT, True, torch, reps=5)
    del DxT
    proj._tensors.pop("_deriv_mats", None)
    phi1, y = phi[None], f[None].contiguous()
    pt1 = torch.empty((2, 1, N, N), device=DEVICE)
    lfk.p_planes_cuda(t, phi1, pt1)
    for kind in ("forward", "adjoint"):
        check("fa_velocity_" + kind, (y, phi1, pt1), y.shape,
              lambda o, p, y_, ph, pt: lfk.fvelocity_cuda(kind, y_, o, ph, pt, ops, 2, t, p),
              lambda o, p, y_, ph, pt: lfk.fvelocity_plain(kind, y_, o, ph, pt, ops, 2, t, p),
              4, 6)
    acc = 1e-3 * torch.as_tensor(np.random.default_rng(SEED + 1).standard_normal(
        (1, lfk.NACC, N, N)).astype(np.float32), device=DEVICE)
    yb = torch.cat([f[None], dy[None], acc], dim=1)
    check("bv_velocity", (yb, phi1, pt1), yb.shape,
          lambda o, p, y_, ph, pt: lfk.fvelocity_cuda("backward", y_, o, ph, pt, ops, 2, t, p),
          lambda o, p, y_, ph, pt: lfk.fvelocity_plain("backward", y_, o, ph, pt, ops, 2, t, p),
          8, 25)
    del yb, acc
    # the line search's batch: NTRIAL trials, each with its own phi
    scales = torch.linspace(0.1, 2.0, NTRIAL, device=DEVICE).reshape(-1, 1, 1, 1)
    phis = (scales * phi).contiguous()
    ys = torch.stack([torch.roll(f, 7 * i, dims=-1) for i in range(NTRIAL)])
    pts = torch.empty((2, NTRIAL, N, N), device=DEVICE)
    lfk.p_planes_cuda(t, phis, pts)
    for kind in ("forward", "adjoint"):
        check(f"fa_velocity_{kind}[{NTRIAL}]", (ys, phis, pts), ys.shape,
              lambda o, p, y_, ph, pt: lfk.fvelocity_cuda(kind, y_, o, ph, pt, ops, 2, t, p),
              lambda o, p, y_, ph, pt: lfk.fvelocity_plain(kind, y_, o, ph, pt, ops, 2, t, p),
              4, 6, nb=NTRIAL, reps=3)
    del ys, pts, phis
    torch.cuda.empty_cache()
    for tier, found in out.items():
        for name, d in found.items():
            extra = (f"  vs strict {d['rel_strict']:.3e} (bound {HIGH_VS_STRICT:g}); Frobenius "
                     f"ratio {d['split_ratio']:.3f} (bound {HIGH_SPLIT_RATIO:g})"
                     if tier == "high" else "")
            print(f"phase 13: {tier:4s} kernel {name:26s} radix {B:2d} rel err vs plain "
                  f"{d['rel']:.3e} (bound {FLOW_TOL if tier == 'f32' else HIGH_TOL:g}, each "
                  f"plane){extra}  {d['ms']:.4f} ms cold  plain {d['plain_ms']:.4f} ms  library "
                  f"{d['library_ms']}  bound {d['bound_ms']:.4f} ms ({d['bound_by']}, "
                  f"{100 * d['bound_ms'] / d['ms']:.1f} %)  [{N}^2; {card}]")
    bad = {k: d["rel"] for k, d in out["f32"].items() if not d["rel"] < FLOW_TOL}
    bad.update(high_failures(out["high"]))
    if bad:
        raise AssertionError(f"radix-{B} kernels disagree with their plain versions: {bad}")
    return out, dict(ops=ops, phi=phi, f=f, dy=dy)


def large_flows(torch, card, ctx):
    """Phase 13 (a): the whole L, L^-1, L^H and backward flows at 4096^2
    against their plain versions, strict (FLOW_TOL) and at 'high' (HIGH_TOL,
    and nearer plain 'high' than strict, FLOW_SPLIT_RATIO)."""
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    ops, phi, f, dy = (ctx[k] for k in ("ops", "phi", "f", "dy"))
    N = f.shape[-1]
    found = {}
    for name, (t0, t1, kind) in (("L", (0., 1., "forward")), ("L^-1", (1., 0., "forward")),
                                 ("L^H", (1., 0., "adjoint"))):
        run = lambda fn, p: fn(f, phi, ops, t0, t1, NSTEPS, kind, p)
        ks, ps = run(lfk.flow_apply, "f32"), run(lfk.flow_apply_plain, "f32")
        kh, ph = run(lfk.flow_apply, "high"), run(lfk.flow_apply_plain, "high")
        found[name] = dict(rel=rel(ks, ps), high=rel(kh, ph), **split_ratio(kh, ph, ks),
                           ms=cuda_ms(lambda: run(lfk.flow_apply, "f32"), 2, torch),
                           high_ms=cuda_ms(lambda: run(lfk.flow_apply, "high"), 2, torch))
    bwd = lambda fn, p: fn(dy, f, phi, ops, 0., 1., NSTEPS, p)
    (ks, ps, kh, ph) = (bwd(lfk.flow_bwd, "f32"), bwd(lfk.flow_bwd_plain, "f32"),
                        bwd(lfk.flow_bwd, "high"), bwd(lfk.flow_bwd_plain, "high"))
    ms, high_ms = (cuda_ms(lambda: bwd(lfk.flow_bwd, p), 2, torch) for p in ("f32", "high"))
    for i, name in enumerate(("backward dphi", "backward df0")):
        found[name] = dict(rel=rel(ks[i], ps[i]), high=rel(kh[i], ph[i]),
                           **split_ratio(kh[i], ph[i], ks[i]), ms=ms, high_ms=high_ms)
    for name, d in found.items():
        print(f"phase 13: flow {name:14s} strict vs plain {d['rel']:.3e} (bound {FLOW_TOL:g}); "
              f"'high' vs plain 'high' {d['high']:.3e} (bound {HIGH_TOL:g}), Frobenius ratio "
              f"{d['split_ratio']:.3f} (bound {FLOW_SPLIT_RATIO:g})  {d['ms']:.2f} ms strict  "
              f"{d['high_ms']:.2f} ms 'high'  [{N}^2 P, nsteps={NSTEPS}; {card}]")
    bad = {k: d["rel"] for k, d in found.items() if not d["rel"] < FLOW_TOL}
    bad.update({k + " 'high'": d["high"] for k, d in found.items() if not d["high"] < HIGH_TOL})
    bad.update({k + " ratio": d["split_ratio"] for k, d in found.items()
                if not d["split_ratio"] < FLOW_SPLIT_RATIO})
    if bad:
        raise AssertionError(f"{N}^2 flows disagree with their plain versions: {bad}")


def large_sim(torch, card, N):
    import cmblensing_tpu_torch as ct
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = ct.load_sim(thetapix=THETAPIX_MAP, Nside=N, pol="P", T=np.float32, seed=SEED,
                      device=DEVICE)
    torch.cuda.synchronize()
    print(f"phase 13: load_sim at {N}^2 P: {time.perf_counter() - t0:.2f} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card}]")
    return sim


@contextlib.contextmanager
def flows_in_float64(proj):
    """Within it, LenseFlow's flows (forward, adjoint and the
    transpose-delta flow of the VJP) run on the plain backend in float64,
    on a float64 projection of proj's geometry, their results cast back
    to the caller's dtype: an evaluation that shares everything but the
    flows with the caller's float32 one."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.models import lenseflow as lf
    p64 = ct.ProjLambert(proj.Ny, proj.Nx, thetapix=proj.thetapix, T=np.float64, device=DEVICE)
    apply, bwd = lf._apply, lf._bwd

    def apply64(phi_map, f_map, t0, t1, nsteps, proj, backend, precision=None, kind="forward"):
        return apply(phi_map.double(), f_map.double(), t0, t1, nsteps, p64, "plain", None,
                     kind).to(f_map.dtype)

    def bwd64(phi_map, f1, dy, t0, t1, nsteps, proj, backend, precision=None):
        dphi, df0 = bwd(phi_map.double(), f1.double(), dy.double(), t0, t1, nsteps, p64, "plain")
        return dphi.to(dy.dtype), df0.to(dy.dtype)

    lf._apply, lf._bwd = apply64, bwd64
    try:
        yield
    finally:
        lf._apply, lf._bwd = apply, bwd


def large_gradient(torch, card, sim):
    """Phase 13 (b): the strict mixed phi-gradient on the kernel and the
    plain (cuFFT) backends, each against the same float32 evaluation with
    its flows in float64 (flows_in_float64): what each backend's float32
    flows put into the gradient; the kernel backend held to GRAD_TOL of
    it. Returns
    ({backend: launches}, {"gap": kernel vs plain, backend: its distance
    to the float64-flow evaluation})."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    ds = sim["ds"]
    f = sim["f"].to(sim["f"].basis.with_space("map"))
    phi = sim["phi"].to(sim["phi"].basis.with_space("map"))
    m = ct.mix(ds, f=f, phi=phi)
    f_mix, phi_mix = m["f_mix"].to(f.basis), m["phi_mix"].to(phi.basis)
    vg = ct.fvalue_and_grad(lambda p: ct.Mixed(ds).logpdf(f_mix=f_mix, phi_mix=p))
    res = {}
    for be in ("kernel", "plain", "float64 flows"):
        ref = be == "float64 flows"
        with ct.lenseflow_backend_ctx("plain" if ref else be), \
                (flows_in_float64(phi.proj) if ref else contextlib.nullcontext()):
            lfk.reset_launches()
            t0 = time.perf_counter()
            v, g = vg(phi_mix)
            torch.cuda.synchronize()
            res[be] = (v, g.arr, 1e3 * (time.perf_counter() - t0), dict(lfk.LAUNCHES))
    N = phi.proj.Nx
    gaps = {"gap": rel(res["kernel"][1], res["plain"][1])}
    gaps.update({be: rel(res[be][1], res["float64 flows"][1]) for be in ("kernel", "plain")})
    print(f"phase 13: gradlnP at {N}^2 P, strict: lnP kernel {float(res['kernel'][0])!r} plain "
          f"{float(res['plain'][0])!r}; grad rel max-abs err kernel vs plain {gaps['gap']:.3e}; "
          f"against the same evaluation with float64 flows: kernel {gaps['kernel']:.3e} (bound "
          f"{GRAD_TOL:g}), plain {gaps['plain']:.3e}; kernel {res['kernel'][2]:.1f} ms plain "
          f"{res['plain'][2]:.1f} ms (first call) [{card}]")
    # held against the float64-flow evaluation: at 4096^2 the plain
    # backend's own float32 flows put 1.0e-4 into the gradient on an H100,
    # so kernel and plain lie 1.17e-4 apart while the kernel lies 6.7e-5
    # from it (ROADMAP Queue 3, accuracy bounds)
    if not (torch.isfinite(res["kernel"][1]).all() and gaps["kernel"] < GRAD_TOL):
        raise AssertionError(f"{N}^2 kernel gradient disagrees with the evaluation with float64 "
                             f"flows: {gaps}")
    return {be: res[be][3] for be in ("kernel", "plain")}, gaps


def map_steps(torch, ds, n, precision, keys=("logpdf", "alpha", "cg_iters", "precision_fallback",
                                              "retry")):
    import cmblensing_tpu_torch as ct
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ct.MAP_joint(ds, nsteps=n, linesearch="grid", conjgrad_kwargs=MAP_CG,
                       history_keys=keys, precision=precision)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def large_step_2048(torch, card, sim):
    """Phase 13 (c) at 2048^2 P: one strict MAP_joint step on the kernel and
    on the plain backend (the same alpha and logpdf, STEP_TOL); the line
    search's memory per trial (peak of 17 trials over that of chunks of 5);
    one step at "auto". Returns (launches of the strict and the "auto"
    kernel steps, their s/step, the plain s/step, planes per trial)."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.inference import maximization as tm
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    ds = sim["ds"]
    runs, launches = {}, {}
    # the "auto" step first: it meets the size's one-time costs (operands,
    # FFT plans), which the two timed strict steps then do not
    for be, p in (("kernel", "auto"), ("kernel", None), ("plain", None)):
        with ct.lenseflow_backend_ctx(be):
            lfk.reset_launches()
            runs[be, p] = map_steps(torch, ds, 1, p, keys=("logpdf", "alpha", "cg_iters",
                                                          "precision_fallback", "retry", "f"))
            launches[be, p] = dict(lfk.LAUNCHES)
    (hk, tk), (hp, tp_), (ha, ta) = (runs[k] for k in (("kernel", None), ("plain", None),
                                                        ("kernel", "auto")))
    hk, hp, ha = hk["history"][0], hp["history"][0], ha["history"][0]
    d_lp = abs(hk["logpdf"] - hp["logpdf"]) / abs(hp["logpdf"])
    d_a = abs(hk["alpha"] - hp["alpha"]) / max(abs(hp["alpha"]), 1e-30)
    N = ds.d.proj.Nx
    print(f"phase 13: MAP_joint {N}^2 P strict, 1 step: kernel {tk:.3f} s, plain {tp_:.3f} s; "
          f"logpdf {hk['logpdf']!r} vs {hp['logpdf']!r} (rel {d_lp:.2e}, bound {STEP_TOL:g}); "
          f"alpha {hk['alpha']!r} vs {hp['alpha']!r} (rel {d_a:.2e}) [{card}]")
    print(f"phase 13: MAP_joint {N}^2 P \"auto\", 1 step (the first at {N}^2, set-up "
          f"included): {ta:.3f} s; logpdf {ha['logpdf']!r}, alpha {ha['alpha']!r}, fallback "
          f"{ha['precision_fallback']}, retry {ha['retry']}")
    # the line search's footprint: peak memory of 17 trials and of chunks of
    # 5, on the second step's search from the strict step's result
    res = runs[("kernel", None)][0]
    dsg = ds.replace(G=ct.Id)
    with torch.no_grad():
        f_mix, phi_mix, g = tm._phi_grad_and_fmix(dsg, {}, res["history"][0]["f"], res["phi"])
        dphi = tm.hessian_phimix_preconditioner(dsg).pinv() @ g
        del g
        peak, dl = {}, {}
        for chunk in (5, None):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            _, dl[chunk] = tm._grid_linesearch_dlps(dsg, {}, f_mix, phi_mix, dphi,
                                                    2 * hk["alpha"], 16, chunk=chunk or 16)
            torch.cuda.synchronize()
            peak[chunk] = torch.cuda.max_memory_allocated() - base
    plane = N * N * 4
    per_trial = (peak[None] - peak[5]) / (NTRIAL - 5) / plane
    fin = torch.isfinite(dl[None]) & torch.isfinite(dl[5])
    ddl = float((dl[5] - dl[None])[fin].abs().max() / dl[None][fin].abs().max())
    print(f"phase 13: grid line search at {N}^2 P: peak {peak[None] / 2 ** 30:.2f} GiB for "
          f"{NTRIAL} trials, {peak[5] / 2 ** 30:.2f} GiB in chunks of 5: {per_trial:.1f} planes "
          f"a trial (the constant: {tm.LINESEARCH_PLANES_PER_TRIAL}); chunks of 5 vs one batch: "
          f"max |d dlp| / max |dlp| = {ddl:.2e}, argmax {int(dl[5].argmax())} vs "
          f"{int(dl[None].argmax())} [{card}]")
    bad = {}
    if not (d_lp < STEP_TOL and d_a < STEP_TOL):
        bad["strict step kernel vs plain"] = (d_lp, d_a)
    if not (np.isfinite(ha["logpdf"]) and ha["alpha"] > 0 and hk["alpha"] > 0):
        bad["steps"] = (hk, ha)
    if bad:
        raise AssertionError(f"{N}^2 MAP_joint step disagrees: {bad}")
    return launches[("kernel", None)], launches[("kernel", "auto")], tk, tp_, per_trial


def large_map_4096(torch, card, sim):
    """Phase 13 (d): MAP_joint at 4096^2 P at the JAX default "auto", as
    scripts/map_4096.py runs it: LARGE_WARM warm-up steps, then LARGE_STEPS
    timed with the launch counters set to 0 just before and read just
    after; every logpdf finite and never decreasing, alpha > 0 on the
    first step. Prints s/step, peak memory, corr and rho_b."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.inference import maximization as tm
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    from cmblensing_tpu_torch.utils import timing
    ds = sim["ds"]
    N = ds.d.proj.Nx
    torch.cuda.reset_peak_memory_stats()
    _, warm = map_steps(torch, ds, LARGE_WARM, "auto")
    timing.reset_timers()
    lfk.reset_launches()
    keys = ("logpdf", "alpha", "cg_iters", "gradnorm", "precision_fallback", "retry")
    res, dt = map_steps(torch, ds, LARGE_STEPS, "auto", keys)
    launches = dict(lfk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    hist = res["history"]
    lps, alphas = [h["logpdf"] for h in hist], [h["alpha"] for h in hist]
    phi_true = sim["phi"].to(ct.MAP)
    phi_map = res["phi"].to(ct.MAP)
    pt, pm = phi_true.arr.reshape(-1).double(), phi_map.arr.reshape(-1).double()
    corr = float(pm @ pt / (pm.norm() * pt.norm()))
    ell, rho = ct.bandpower_corr(phi_map, phi_true, RHO_LEDGES)
    chunk = tm._linesearch_chunk(phi_map, 16)
    print(f"phase 13: MAP_joint {N}^2 P \"auto\": {LARGE_WARM} warm-up step {warm:.2f} s; "
          f"{LARGE_STEPS} steps {dt:.2f} s = {dt / LARGE_STEPS:.3f} s/step; peak memory "
          f"{peak:.2f} GiB; line-search chunk {chunk} (16: all 17 trials in one batch) [{card}]")
    for line in timing.timer_report().splitlines():
        print("phase 13: timers", line)
    print(f"phase 13: logpdfs {lps!r}; alphas {alphas!r}; CG iters "
          f"{[h['cg_iters'] for h in hist]}; gradnorm {[float(h['gradnorm']) for h in hist]!r}")
    print(f"phase 13: f-steps re-run strict (precision_fallback) "
          f"{[h['precision_fallback'] for h in hist]}; direction retries "
          f"{[h['retry'] for h in hist]}")
    print(f"phase 13: corr(phi_MAP, phi_true) = {corr:.4f} (no bound: {LARGE_STEPS} steps of 15 "
          f"fixed CG iterations); rho_b " + ", ".join(f"l~{l:.0f}: {r:.3f}"
                                                      for l, r in zip(ell, rho)))
    print(f"phase 13: launches in the {N}^2 \"auto\" run: "
          f"{ {k: v for k, v in launches.items() if v} }; per step "
          f"{ {k: v / LARGE_STEPS for k, v in launches.items() if v} }")
    if not all(np.isfinite(lps)) or any(b < a for a, b in zip(lps, lps[1:])):
        raise AssertionError(f"{N}^2 MAP_joint logpdf not finite and non-decreasing: {lps}")
    if not alphas[0] > 0:
        raise AssertionError(f"{N}^2 MAP_joint: the first line search accepted no step: {alphas}")
    return launches, dt / LARGE_STEPS, peak


def dense_640(torch, card):
    """L @ f on a 640^2 P load_sim through the default backend (the dense
    circulant: radix 5 is not built) against the plain backend."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import deriv, lenseflow_kernels as lfk
    sim = ct.load_sim(thetapix=THETAPIX_MAP, Nside=640, pol="P", T=np.float32, seed=SEED,
                      device=DEVICE)
    phi, f = sim["phi"].to(ct.MAP), sim["f"].to(ct.QU_MAP)
    lfk.reset_launches()
    k = (sim["ds"].L(phi) @ f).to(ct.QU_MAP).arr
    dense = lfk.LAUNCHES["velocity_forward"]
    with ct.lenseflow_backend_ctx("plain"):
        p = (sim["ds"].L(phi) @ f).to(ct.QU_MAP).arr
    e = rel(k, p)
    print(f"phase 13: L @ f on a 640^2 load_sim, default backend (radix {deriv.radix(640)}: "
          f"dense, {dense} K2 launches) vs plain: {e:.3e} (bound {FLOW640_TOL:g})")
    if not (dense > 0 and e < FLOW640_TOL):
        raise AssertionError(f"640^2 L @ f: {e}, {dense} dense launches")


def phase_large(torch, card):
    """Phase 13: the large maps (see the module docstring). Returns (the
    kernel records {(N, tier): {name: record}}, launches {(N, tier, name):
    (path, count)}: each radix-16/32 kernel's count from the run of the
    path named, timings)."""
    t_start = time.perf_counter()
    records, timing_out = {}, {}
    for N in N_LARGE:
        found, ctx = large_kernels(torch, card, N)
        for tier, d in found.items():
            records[N, tier] = d
        if N == 4096:
            large_flows(torch, card, ctx)
        del ctx
        torch.cuda.empty_cache()
    # path -> (its run's launch counts, set to 0 just before it and read
    # just after; the kernels the path runs, each of which must launch)
    paths = {}
    sim = large_sim(torch, card, 2048)
    large_gradient(torch, card, sim)
    strict, auto, tk, tp_, per_trial = large_step_2048(torch, card, sim)
    paths["MAP_joint 2048^2 P strict, 1 step"] = (strict, FACTORED_KERNELS[:4])
    paths["MAP_joint 2048^2 P auto, 1 step"] = (auto, HIGH_KERNELS)
    timing_out["MAP_joint_2048_s_per_step"] = (tk, tp_)
    timing_out["linesearch_planes_per_trial_2048"] = per_trial
    del sim
    torch.cuda.empty_cache()
    sim = large_sim(torch, card, 4096)
    grad_launches, _ = large_gradient(torch, card, sim)
    paths["gradlnP 4096^2 P strict"] = (grad_launches["kernel"],
                                       ("fderiv", "fa_velocity_forward", "bv_velocity"))
    torch.cuda.empty_cache()
    run_launches, s_step, peak = large_map_4096(torch, card, sim)
    # the main path: "auto" runs the strict K1 and K3 in its line search and
    # strict residual checks, strict K4 only on a direction retry
    main_path = "MAP_joint 4096^2 P auto"
    paths[main_path] = (run_launches,
                        HIGH_KERNELS + ("fderiv", "fa_velocity_forward", "fa_velocity_adjoint"))
    timing_out.update(MAP_joint_4096_s_per_step=s_step, MAP_joint_4096_peak_GiB=peak)
    del sim
    torch.cuda.empty_cache()
    dense_640(torch, card)
    for path, (counts, names) in paths.items():
        if min(counts[k] for k in names) <= 0:
            raise AssertionError(f"{path}: a kernel of the path never launched: "
                                 f"{ {k: counts[k] for k in names} }")
    record_path = {(2048, "f32"): "MAP_joint 2048^2 P strict, 1 step",
                   (2048, "high"): "MAP_joint 2048^2 P auto, 1 step",
                   (4096, "f32"): main_path, (4096, "high"): main_path}
    launches = {}
    for (N, tier), path in record_path.items():
        for name in FACTORED_KERNELS[:4]:
            key = name + ("_high" if tier == "high" else "")
            # strict K4 at 4096^2 runs on the strict gradient's path
            p = "gradlnP 4096^2 P strict" if (N, key) == (4096, "bv_velocity") else path
            launches[N, tier, name] = (p, paths[p][0][key])
    print(f"phase 13: wall time {time.perf_counter() - t_start:.1f} s [{card}]")
    return records, launches, timing_out


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import _build

    card = card_line()
    print(f"phase 1: card {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.load()
    print(f"phase 1: kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    if _build.BUILD_LOG:
        for line in _build.BUILD_LOG.splitlines():
            if "registers" in line or "error" in line.lower():
                print("phase 1: ptxas:", line.strip())

    if sys.argv[1:] == ["--phase", "13"]:
        phase_large(torch, card)
        return 0
    proj = ct.ProjLambert(N, N, thetapix=3, T=np.float32, device=DEVICE)
    kernels, _ = phase_kernels(torch, proj)
    ds, f_mix, phi_mix, launches = phase_slice(torch)
    timing = phase_timing(torch, ds, f_mix, phi_mix, card)
    fkernels, fctx = phase_factored(torch, card)
    gctx, grad_ms, grad_plain_ms = phase_map_gradient(torch, card)
    map_launches, s_step, plain_s_step, gctx["map_hist"] = phase_map(torch, gctx["sim"], card)
    ukernels, uni_launches, uni_grad_ms, uni_s_step = phase_uni(torch, card, fctx, gctx)
    hkernels, high_launches, high_timing = phase_high(torch, card, fctx, gctx)
    edge_ms = phase_edges(torch, card)
    dkernels, dense_high_launches, dense_high_timing = phase_dense_high(torch, card, ds, f_mix,
                                                                        phi_mix, kernels)
    _, wf_timing = phase_wiener(torch, card)
    large, large_launches, large_timing = phase_large(torch, card)

    replaces = {"deriv": "cmblensing_tpu/ops/pallas_lenseflow.py:86",
                "p_planes": "cmblensing_tpu/ops/pallas_lenseflow.py:303",
                "fderiv": "cmblensing_tpu/ops/pallas_lenseflow.py:249",
                "fa_velocity_forward": "cmblensing_tpu/ops/pallas_lenseflow.py:506",
                "fa_velocity_adjoint": "cmblensing_tpu/ops/pallas_lenseflow.py:506",
                "bv_velocity": "cmblensing_tpu/ops/pallas_lenseflow.py:581"}
    replaces.update({f"uni_role{r}": "cmblensing_tpu/ops/pallas_lenseflow.py:734" for r in range(4)})
    replaces.update({k: "cmblensing_tpu/ops/pallas_lenseflow.py:225" for k in HIGH_KERNELS})
    replaces.update({k: "cmblensing_tpu/ops/pallas_lenseflow.py:103" for k in DENSE_HIGH_KERNELS})
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    entry = lambda name, d, src, n: {
        "name": name, "route": "cuda", "source": src,
        "replaces": replaces.get(name, "cmblensing_tpu/ops/pallas_lenseflow.py:472"),
        "launches": n, **{k: d[k] for k in keys},
        **({"batched": d["batched"]} if "batched" in d else {})}
    # K1's record is its d_x pass, the function one library call (a @ DxT) computes
    fkernels["fderiv_x"]["batched"] = fkernels["fderiv"]["batched"]
    record = {"kernels": [entry(name, d, "cmblensing_tpu_torch/csrc/lenseflow.cu", launches[name])
                          for name, d in kernels.items()]
              + [entry(name, fkernels[key], FACTORED_SRC,
                       map_launches[name])
                 for name, key in (("fderiv", "fderiv_x"),
                                   ("fa_velocity_forward", "fa_velocity_forward"),
                                   ("fa_velocity_adjoint", "fa_velocity_adjoint"),
                                   ("bv_velocity", "bv_velocity"))]
              + [entry(name, d, "cmblensing_tpu_torch/csrc/uni.cu", uni_launches[name])
                 for name, d in ukernels.items()]
              + [entry(name, hkernels[key], FACTORED_SRC,
                       high_launches[name])
                 for name, key in (("fderiv_high", "fderiv_x"),
                                   ("fa_velocity_forward_high", "fa_velocity_forward"),
                                   ("fa_velocity_adjoint_high", "fa_velocity_adjoint"),
                                   ("bv_velocity_high", "bv_velocity"))]
              + [entry(name + "_high", dkernels[name], "cmblensing_tpu_torch/csrc/lenseflow.cu",
                       dense_high_launches[name + "_high"])
                 for name in ("velocity_forward", "velocity_adjoint", "velocity_backward",
                              "deriv")]}
    # radix 16 and 32 (phase 13): K1's record is its d_x pass, K3's carry
    # their batch-17 runs under "batched"; "path" names the run whose
    # launches each gives
    for (Nl, tier), found in large.items():
        sfx = "_high" if tier == "high" else ""
        for name, key in (("fderiv", "fderiv_x"), ("fa_velocity_forward", "fa_velocity_forward"),
                          ("fa_velocity_adjoint", "fa_velocity_adjoint"),
                          ("bv_velocity", "bv_velocity")):
            d = dict(found[key])
            if f"{key}[{NTRIAL}]" in found:
                d["batched"] = {k: found[f"{key}[{NTRIAL}]"][k]
                                for k in ("nb", "max_abs_err", "rel", "ms", "plain_ms")}
            path, n = large_launches[Nl, tier, name]
            rec = entry(name + sfx, d, FACTORED_SRC, n)
            rec.update(name=f"{name}{sfx}_b{Nl // FA}", path=path)
            record["kernels"].append(rec)
    timing.update({"gradlnP_1024": (grad_ms, grad_plain_ms),
                   "MAP_joint_1024_s_per_step": (s_step, plain_s_step),
                   "gradlnP_1024_uni": uni_grad_ms, "MAP_joint_1024_uni_s_per_step": uni_s_step,
                   **high_timing, **dense_high_timing, **wf_timing, **large_timing,
                   **{f"velocity_forward_{Ny}x{Nx}_{p}": ms for (Ny, Nx, p), ms in edge_ms.items()}})
    print("main path ms (kernel, plain):", json.dumps(timing))
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
