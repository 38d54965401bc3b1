"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written LenseFlow kernels from csrc/ into build/, holds
each against its plain PyTorch version on the card, drives the main
path (the mixed-posterior phi-gradient of a 256^2 pol-P simulation,
LenseFlow nsteps=7) through the kernel backend, checks it against the
plain backend, and times both. Exits non-zero, printing no result line,
when there is no CUDA card or any phase fails.

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
N, NSTEPS, SEED = 256, 7, 0
DEVICE = "cuda"


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
    Cl = ct.camb()
    Cphi = ct.Cl_to_Cov("I", proj, Cl["total"]["pp"])
    Cf = ct.Cl_to_Cov("P", proj, Cl["unlensed_scalar"]["EE"], Cl["unlensed_scalar"]["BB"])
    white = lambda n: ct.Field(torch.as_tensor(rng.standard_normal((n, N, N)).astype(np.float32),
                                               device=proj.device), ct.Basis("I" if n == 1 else "QU", "map"), proj)
    phi = (Cphi.sqrt() @ white(1)).to(ct.MAP).arr.contiguous()
    f = (Cf.sqrt() @ white(2)).to(ct.QU_MAP).arr.contiguous()
    dy = torch.as_tensor(rng.standard_normal((2, N, N)).astype(np.float32), device=proj.device)
    return phi, f, dy


def phase_kernels(torch, proj):
    """Each kernel and each whole flow against its plain version."""
    from cmblensing_tpu_torch.ops import deriv, lenseflow_kernels as lfk
    phi_map, f, dy = weak_lensing_inputs(proj, torch)
    mats = deriv.deriv_mats(proj)
    DxT, Dy = mats
    phi = lfk.gradhess(phi_map, mats)
    hess_err = rel(phi, lfk.gradhess_plain(phi_map, mats))
    errs = {}

    out = {}
    t = 0.5
    nb = 2 * 2 + lfk.NACC
    ybwd = torch.cat([f, dy, torch.randn((lfk.NACC, N, N), device=f.device) * 1e-3])
    for kind, y in (("forward", f), ("adjoint", f), ("backward", ybwd)):
        k1, k2 = torch.empty_like(y), torch.empty_like(y)
        lfk.velocity_cuda(kind, y, k1, phi, DxT, Dy, 2, t)
        lfk.velocity_plain(kind, y, k2, phi, DxT, Dy, 2, t)
        out["velocity_" + kind] = dict(
            max_abs_err=float((k1 - k2).abs().max()), rel=rel(k1, k2),
            ms=cuda_ms(lambda: lfk.velocity_cuda(kind, y, k1, phi, DxT, Dy, 2, t), 20, torch),
            plain_ms=cuda_ms(lambda: lfk.velocity_plain(kind, y, k2, phi, DxT, Dy, 2, t), 20, torch))
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
    lfk.deriv_cuda(a, b, c, o1, DxT, Dy)
    lfk.deriv_plain(a, b, c, o2, DxT, Dy)
    out["deriv"] = dict(max_abs_err=float((o1 - o2).abs().max()), rel=rel(o1, o2),
                        ms=cuda_ms(lambda: lfk.deriv_cuda(a, b, c, o1, DxT, Dy), 20, torch),
                        plain_ms=cuda_ms(lambda: lfk.deriv_plain(a, b, c, o2, DxT, Dy), 20, torch))

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
    if min(launches.values()) <= 0:
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

    src = "cmblensing_tpu_torch/csrc/lenseflow.cu"
    replaces = {"deriv": "cmblensing_tpu/ops/pallas_lenseflow.py:86"}
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src,
         "replaces": replaces.get(name, "cmblensing_tpu/ops/pallas_lenseflow.py:472"),
         "launches": launches[name], "max_abs_err": d["max_abs_err"],
         "ms": d["ms"], "plain_ms": d["plain_ms"]}
        for name, d in kernels.items()]}
    print("main path ms (kernel, plain):", json.dumps(timing))
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
