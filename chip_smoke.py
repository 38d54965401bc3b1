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
              with one step on the plain backend beside it.

Each path's launch counters are set to 0 just before it and read just
after. Exits non-zero, printing no result line, when there is no CUDA
card or any phase fails.

The last two lines of stdout are the per-kernel JSON record and
{"ok": true, "device": {...}}; the card's name and power limit come on a
line before them.
"""
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
                 "deriv")
FACTORED_KERNELS = ("fderiv", "fa_velocity_forward", "fa_velocity_adjoint", "bv_velocity",
                    "rk4_update")


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def cuda_ms(fn, reps, torch):
    """Median milliseconds of fn() over reps runs, by CUDA events."""
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


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
    ybwd = torch.cat([f, dy, torch.randn((lfk.NACC, N, N), device=f.device) * 1e-3])
    for kind, y in (("forward", f), ("adjoint", f), ("backward", ybwd)):
        k1, k2 = torch.empty_like(y), torch.empty_like(y)
        lfk.velocity_cuda(kind, y, k1, phi, mats, 2, t)
        lfk.velocity_plain(kind, y, k2, phi, mats, 2, t)
        out["velocity_" + kind] = dict(
            max_abs_err=float((k1 - k2).abs().max()), rel=rel(k1, k2),
            ms=cuda_ms(lambda: lfk.velocity_cuda(kind, y, k1, phi, mats, 2, t), 20, torch),
            plain_ms=cuda_ms(lambda: lfk.velocity_plain(kind, y, k2, phi, mats, 2, t), 20, torch))
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
        ms=cuda_ms(lambda: lfk.rk4_update_cuda(yy, k, acc, s, 1, 1 / 21, 1 / 14), 20, torch),
        plain_ms=cuda_ms(lambda: lfk.rk4_update_plain(yy, k, acc, s, 1, 1 / 21, 1 / 14), 20, torch))
    a, b, c = f[0:1].contiguous(), f[1:2].contiguous(), dy[0:1].contiguous()
    o1, o2 = torch.empty_like(a), torch.empty_like(a)
    lfk.deriv_cuda(a, b, c, o1, mats)
    lfk.deriv_plain(a, b, c, o2, mats)
    out["deriv"] = dict(max_abs_err=float((o1 - o2).abs().max()), rel=rel(o1, o2),
                        ms=cuda_ms(lambda: lfk.deriv_cuda(a, b, c, o1, mats), 20, torch),
                        plain_ms=cuda_ms(lambda: lfk.deriv_plain(a, b, c, o2, mats), 20, torch))

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
        print(f"phase 2: kernel {name:18s} rel err {d['rel']:.3e}  {d['ms']:.4f} ms  plain {d['plain_ms']:.4f} ms")
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
    if not isinstance(ops, factored_deriv.FactoredOps) or ops.FX.shape[0] != N_MAP // 128:
        raise AssertionError(f"deriv_ops gives no radix-{N_MAP // 128} factored operands")
    phi_map, f, dy = weak_lensing_inputs(proj, torch)
    phi = lfk.gradhess(phi_map, ops)
    phi_plain = lfk.gradhess_plain(phi_map, ops)
    hess_err = rel(phi, phi_plain)
    proj64 = ct.ProjLambert(N_MAP, N_MAP, thetapix=THETAPIX_MAP, T=np.float64, device=DEVICE)
    phi64 = lfk.gradhess_plain(phi_map.double(), deriv.deriv_ops(proj64))
    hess_f64 = (rel(phi.double(), phi64), rel(phi_plain.double(), phi64))
    phi1, y = phi[None], f[None].contiguous()
    out = {}

    def check(name, run_k, run_p, result, reps=10):
        run_k()
        run_p()
        k, p = result()
        out[name] = dict(max_abs_err=float((k - p).abs().max()), rel=rel(k, p),
                         ms=cuda_ms(run_k, reps, torch), plain_ms=cuda_ms(run_p, reps, torch))

    a, b, c = f[0:1].contiguous(), f[1:2].contiguous(), dy[0:1].contiguous()
    o1, o2 = torch.empty_like(a), torch.empty_like(a)
    for name, args in (("fderiv_x", (a, None, None)), ("fderiv_y", (None, b, None)),
                       ("fderiv", (a, b, c))):
        check(name, lambda: lfk.fderiv_cuda(*args, o1, ops),
              lambda: lfk.fderiv_plain(*args, o2, ops), lambda: (o1, o2))
    t = 0.5
    k1, k2 = torch.empty_like(y), torch.empty_like(y)
    for kind in ("forward", "adjoint"):
        check("fa_velocity_" + kind, lambda: lfk.fvelocity_cuda(kind, y, k1, phi1, ops, 2, t),
              lambda: lfk.fvelocity_plain(kind, y, k2, phi1, ops, 2, t), lambda: (k1, k2))
    acc = 1e-3 * torch.as_tensor(np.random.default_rng(SEED + 1).standard_normal(
        (1, lfk.NACC, N_MAP, N_MAP)).astype(np.float32), device=DEVICE)
    yb = torch.cat([f[None], dy[None], acc], dim=1)
    kb1, kb2 = torch.empty_like(yb), torch.empty_like(yb)
    check("bv_velocity", lambda: lfk.fvelocity_cuda("backward", yb, kb1, phi1, ops, 2, t),
          lambda: lfk.fvelocity_plain("backward", yb, kb2, phi1, ops, 2, t),
          lambda: (kb1, kb2))
    # the bundle's planes differ in scale by orders: hold each to the bound
    bv_planes = max(rel(kb1[0, i], kb2[0, i]) for i in range(yb.shape[1]))
    out["bv_velocity"]["rel"] = max(out["bv_velocity"]["rel"], bv_planes)

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
                             ms=cuda_ms(run_k, 5, torch), plain_ms=cuda_ms(run_p, 3, torch))

    a17 = ys[:, :1].contiguous()
    d1, d2 = torch.empty_like(a17), torch.empty_like(a17)
    check_batched("fderiv", lambda: lfk.fderiv_cuda(a17, a17, None, d1, ops),
                  lambda: lfk.fderiv_plain(a17, a17, None, d2, ops), lambda: (d1, d2))
    s1, s2 = torch.empty_like(ys), torch.empty_like(ys)
    for kind in ("forward", "adjoint"):
        check_batched("fa_velocity_" + kind,
                      lambda: lfk.fvelocity_cuda(kind, ys, s1, phis, ops, 2, t),
                      lambda: lfk.fvelocity_plain(kind, ys, s2, phis, ops, 2, t),
                      lambda: (s1, s2))
    for name, d in batched.items():
        out[name]["batched"] = d

    # whole flows at the main path's nsteps
    flows = {}
    for name, run in (
            ("L", lambda fn: fn(f, phi, ops, 0., 1., NSTEPS, "forward")),
            ("L^-1", lambda fn: fn(f, phi, ops, 1., 0., NSTEPS, "forward")),
            ("L^H", lambda fn: fn(f, phi, ops, 1., 0., NSTEPS, "adjoint"))):
        kv, pv = run(lfk.flow_apply), run(lfk.flow_apply_plain)
        flows[name] = (rel(kv, pv), cuda_ms(lambda: run(lfk.flow_apply), 3, torch),
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
              f"{d['ms']:.4f} ms  plain {d['plain_ms']:.4f} ms  [{N_MAP}^2; {card}]")
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
    return out


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
    return sim, res["kernel"][2], res["plain"][2]


def phase_map(torch, sim, card):
    """MAP_joint at 1024^2 P as scripts/map_1024.py runs it, on the
    factored kernels; one plain-backend step beside it."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    from cmblensing_tpu_torch.utils import timing
    ds = sim["ds"]
    keys = ("logpdf", "alpha", "cg_iters", "cg_res", "gradnorm")
    run = lambda n: ct.MAP_joint(ds, nsteps=n, linesearch="grid", conjgrad_kwargs=MAP_CG,
                                 history_keys=keys)
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
    with ct.lenseflow_backend_ctx("plain"):
        t1 = time.perf_counter()
        run(1)
        torch.cuda.synchronize()
        plain_step = time.perf_counter() - t1
    hist = res["history"]
    lps = [h["logpdf"] for h in hist]
    alphas = [h["alpha"] for h in hist]
    pt = sim["phi"].to(ct.MAP).arr.reshape(-1).double()
    pm = res["phi"].to(ct.MAP).arr.reshape(-1).double()
    corr = float(pm @ pt / (pm.norm() * pt.norm()))
    print(f"phase 7: MAP_joint {N_MAP}^2 P: {MAP_WARM} warm-up steps {warm:.2f} s; "
          f"{MAP_STEPS} steps {dt:.2f} s = {dt / MAP_STEPS:.3f} s/step kernel; "
          f"plain backend {plain_step:.3f} s/step (1 step) [{card}]")
    for line in report.splitlines():
        print("phase 7: timers", line)
    print(f"phase 7: logpdfs {lps!r}")
    print(f"phase 7: alphas {alphas!r}; CG iters {[h['cg_iters'] for h in hist]}; "
          f"CG res {[float(h['cg_res']) for h in hist]!r}")
    print(f"phase 7: gradnorm {[float(h['gradnorm']) for h in hist]!r}")
    print(f"phase 7: corr(phi_MAP, phi_true) = {corr:.4f} (bound >= {CORR_MIN:g})")
    print(f"phase 7: launches in the MAP_joint run: {launches}")
    if not all(np.isfinite(lps)) or any(b < a for a, b in zip(lps, lps[1:])):
        raise AssertionError(f"MAP_joint logpdf not finite and non-decreasing: {lps}")
    if not alphas[0] > 0:
        raise AssertionError(f"first line search accepted no step: {alphas}")
    if min(launches[k] for k in FACTORED_KERNELS) <= 0:
        raise AssertionError(f"a factored kernel never launched in MAP_joint: {launches}")
    dense = {k: launches[k] for k in DENSE_KERNELS if k != "rk4_update" and launches[k]}
    if dense:
        raise AssertionError(f"dense K2 kernels launched at {N_MAP}^2: {dense}")
    if not corr >= CORR_MIN:
        raise AssertionError(f"corr(phi_MAP, phi_true) = {corr} < {CORR_MIN}")
    return launches, dt / MAP_STEPS, plain_step


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

    proj = ct.ProjLambert(N, N, thetapix=3, T=np.float32, device=DEVICE)
    kernels, _ = phase_kernels(torch, proj)
    ds, f_mix, phi_mix, launches = phase_slice(torch)
    timing = phase_timing(torch, ds, f_mix, phi_mix, card)
    fkernels = phase_factored(torch, card)
    sim, grad_ms, grad_plain_ms = phase_map_gradient(torch, card)
    map_launches, s_step, plain_s_step = phase_map(torch, sim, card)

    replaces = {"deriv": "cmblensing_tpu/ops/pallas_lenseflow.py:86",
                "fderiv": "cmblensing_tpu/ops/pallas_lenseflow.py:249",
                "fa_velocity_forward": "cmblensing_tpu/ops/pallas_lenseflow.py:506",
                "fa_velocity_adjoint": "cmblensing_tpu/ops/pallas_lenseflow.py:506",
                "bv_velocity": "cmblensing_tpu/ops/pallas_lenseflow.py:581"}
    entry = lambda name, d, src, n: {
        "name": name, "route": "cuda", "source": src,
        "replaces": replaces.get(name, "cmblensing_tpu/ops/pallas_lenseflow.py:472"),
        "launches": n, "max_abs_err": d["max_abs_err"], "ms": d["ms"], "plain_ms": d["plain_ms"],
        **({"batched": d["batched"]} if "batched" in d else {})}
    record = {"kernels": [entry(name, d, "cmblensing_tpu_torch/csrc/lenseflow.cu", launches[name])
                          for name, d in kernels.items()]
              + [entry(name, fkernels[name], "cmblensing_tpu_torch/csrc/factored.cu",
                       map_launches[name])
                 for name in ("fderiv", "fa_velocity_forward", "fa_velocity_adjoint",
                              "bv_velocity")]}
    timing.update({"gradlnP_1024": (grad_ms, grad_plain_ms),
                   "MAP_joint_1024_s_per_step": (s_step, plain_s_step)})
    print("main path ms (kernel, plain):", json.dumps(timing))
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
