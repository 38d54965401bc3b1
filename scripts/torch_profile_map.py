"""Where the time of a 1024^2 P MAP_joint step goes on the PyTorch port,
per LenseFlow backend, on one CUDA card.

    python scripts/torch_profile_map.py [--backends kernel uni] [--steps 2] [--grad256]
                                        [--host-ab] [--precision auto|f32|bf16] [--wiener256]
                                        [--N 1024] [--warm 2]

Runs MAP_joint as chip_smoke.py phase 7 does (load_sim at 1024^2 P, or at
--N^2 (2048 and 4096 as chip_smoke.py phase 13),
thetapix 2, seed 0; grid line search; 15 fixed CG iterations), strict
everywhere (--precision f32, the default: precision=None), at the JAX
package's default precision "auto" (--precision auto, as chip_smoke.py
phase 9) or at 'bf16' (--precision bf16, as chip_smoke.py phase 14), on
either backend (the uni one on K5's tier, as chip_smoke.py phase 15). For each
backend: --warm warm-up steps, an unprofiled run of --steps steps for the
wall time, then the same run under torch.profiler (CUDA activity only).
Prints per step: wall s, device ms and the device's busy share, and the
device ms and launches of the kernels that take the most time. With
--grad256 it then profiles the mixed-posterior phi-gradient at 256^2 P
(chip_smoke.py phases 3-4: thetapix 3, nsteps 7, kernel backend) the same
way, per gradient over 5 gradients. With --wiener256 it profiles the
Wiener filter of chip_smoke.py phase 12 (argmaxf_logpdf at the JAX
defaults on a masked, beamed 256^2 IP simulation, kernel backend), one
solve at "auto" and one strict, per solve, and with --precision bf16 one
at hessian_precision="bf16". `--backends` with no name
skips the 1024^2 step. With --host-ab it times the kernel
backend's step with the flows' launchers made once per flow (as the port
runs) against the checked wrappers called at every launch, in turns in
one process: what the per-launch checks cost the host. Needs a CUDA card;
exits non-zero without one.
"""
import argparse
import os
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def report(prof, n, wall, what, label, top):
    """Device ms, busy share and the top kernels of a profile over n units
    of work that took `wall` seconds each unprofiled."""
    by_name = defaultdict(lambda: [0.0, 0])
    for e in prof.key_averages():
        by_name[e.key][0] += e.self_device_time_total / 1e3 / n
        by_name[e.key][1] += e.count / n
    device = sum(ms for ms, _ in by_name.values())
    print(f"{what}: {wall:.4f} s/{label} wall, {device:.2f} ms/{label} device, busy "
          f"{100 * device / (1e3 * wall):.1f} %")
    for name, (ms, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {ms:9.3f} ms/{label}  {cnt:8.1f} launches/{label}  {name[:90]}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--backends", nargs="*", default=["kernel", "uni"])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--grad256", action="store_true")
    ap.add_argument("--host-ab", action="store_true")
    ap.add_argument("--precision", choices=("auto", "f32", "bf16"), default="f32")
    ap.add_argument("--wiener256", action="store_true")
    ap.add_argument("--N", type=int, default=1024)
    ap.add_argument("--warm", type=int, default=2)
    args = ap.parse_args()
    precision = None if args.precision == "f32" else args.precision
    import torch
    if not torch.cuda.is_available():
        print("torch_profile_map: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import cmblensing_tpu_torch as ct
    from torch.profiler import ProfilerActivity, profile

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    ds = ct.load_sim(thetapix=2, Nside=args.N, pol="P", T=np.float32, seed=0)["ds"]
    run = lambda n: ct.MAP_joint(ds, nsteps=n, linesearch="grid", precision=precision,
                                 conjgrad_kwargs=dict(tol=0.0, nsteps=15, fixed_iters=True))
    for backend in args.backends:
        with ct.lenseflow_backend_ctx(backend):
            run(args.warm)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(args.steps)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / args.steps
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run(args.steps)
                torch.cuda.synchronize()
        report(prof, args.steps, wall,
               f"{backend}, precision {args.precision} [{args.N}^2 P, {args.steps} steps; {card}]",
               "step", args.top)
    if args.host_ab:
        from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
        per_flow = lfk.FKERNEL
        per_launch = lfk._Leaves(lfk.fvelocity_cuda, lfk.rk4_update_cuda, lfk.fderiv_cuda,
                                 lfk.p_planes_cuda, True)
        turns = (("per flow", per_flow), ("per launch", per_launch))
        key = ("cuda", True, "f32")   # the strict factored kernel leaves _leaves_for picks
        try:
            for label, leaves in (turns + turns[::-1]) * 2:
                lfk._LEAVES[key] = leaves
                run(1)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(args.steps)
                torch.cuda.synchronize()
                print(f"kernel backend, checks {label}: "
                      f"{(time.perf_counter() - t0) / args.steps:.4f} s/step wall "
                      f"[1024^2 P, {args.steps} steps; {card}]")
        finally:
            lfk._LEAVES[key] = per_flow
    if args.grad256:
        sim = ct.load_sim(thetapix=3, Nside=256, pol="P", T=np.float32, seed=0)
        ds = sim["ds"]
        f = sim["f"].to(sim["f"].basis.with_space("map"))
        phi = sim["phi"].to(sim["phi"].basis.with_space("map"))
        m = ct.mix(ds, f=f, phi=phi)
        f_mix, phi_mix = m["f_mix"].to(f.basis), m["phi_mix"].to(phi.basis)
        vg = ct.fvalue_and_grad(lambda p: ct.Mixed(ds).logpdf(f_mix=f_mix, phi_mix=p))
        ngrad = 5
        with ct.lenseflow_backend_ctx("kernel"):
            vg(phi_mix)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(ngrad):
                vg(phi_mix)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / ngrad
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(ngrad):
                    vg(phi_mix)
                torch.cuda.synchronize()
        report(prof, ngrad, wall, f"kernel [256^2 P phi-gradient, nsteps 7; {card}]", "gradient",
               args.top)
    if args.wiener256:
        sim = ct.load_sim(thetapix=3, Nside=256, pol="IP", T=np.float32, muKarcminT=1,
                          beamFWHM=2, seed=0,
                          pixel_mask_kwargs=dict(edge_padding_deg=1, apodization_deg=0.5))
        for hp in ("auto", None) + (("bf16",) if args.precision == "bf16" else ()):
            solve = lambda: ct.argmaxf_logpdf(sim["ds"], phi=sim["phi"],
                                              conjgrad_kwargs=dict(hessian_precision=hp))
            with ct.lenseflow_backend_ctx("kernel"):
                solve()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, info = solve()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    solve()
                    torch.cuda.synchronize()
            report(prof, 1, wall, f"kernel, hessian_precision {hp!r} [masked 256^2 IP Wiener "
                   f"filter, {info['iterations']} iterations, fallback "
                   f"{bool(info.get('precision_fallback', False))}; {card}]", "solve", args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
