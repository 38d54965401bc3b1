"""sample_joint over a batch of sims on 512^2 P maps on one CUDA card:
BASELINE.json configs[3] on the PyTorch port.

    python scripts/torch_sample_512.py [--N 512] [--nsims 32] [--passes 6] [--profile]
                                       [--theta-ab]

The configuration of scripts/sample_512_batched.py: load_sim(thetapix=2,
Nside=N, pol="P", Nbatch=nsims, seed=0), then sample_joint(nchains=nsims,
symp_kwargs=[dict(N=25, eps=0.003)], nburnin_always_accept=3,
conjgrad_kwargs=dict(tol=0.0, nsteps=25, fixed_iters=True)), its draws
from a generator seeded 1, on the default ("kernel") LenseFlow backend
(the factored kernels at 512^2, radix 4). One warm-up run of one Gibbs
pass, then a timed run of --passes passes (a new sample_joint call, from
the prior). Prints, with the card's name and power limit:
- s/pass (wall, the run over its passes) and its split by pass label
  (device time of each `timed` block, utils/timing.py);
- the mean accept, over all passes and over those after the burn-in
  (steps > 3, where the accept/reject is real), and whether every logpdf
  is finite;
- the peak device memory of the timed run;
- each kernel's launches a pass (ops/lenseflow_kernels.py::LAUNCHES).
With --profile, one more pass under torch.profiler: device time / wall
(the busy share) and the kernels that take the most device time. With
--theta-ab, the slice pass's grid (9 values of Aphi) evaluated as the
port's pass does, one mixed logpdf a grid value over every chain, against
one call over (grid x chains), in turns, with their largest difference.
Needs a CUDA card; exits non-zero without one.
"""
import argparse
import os
import subprocess
import sys
import time

import numpy as np

from torch_profile_map import report

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYMP = [dict(N=25, eps=0.003)]
CG = dict(tol=0.0, nsteps=25, fixed_iters=True)
NBURNIN = 3


def run(ct, torch, ds, nsims, passes, seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return ct.sample_joint(ds, passes, nchains=nsims, generator=g, symp_kwargs=SYMP,
                           nburnin_always_accept=NBURNIN, conjgrad_kwargs=CG)


def theta_ab(ct, torch, ds, nsims, card, reps=2):
    """The slice pass's grid of mixed logpdfs, one call a grid value
    against one call over (grid x chains), in turns, after one Gibbs
    f-step and mix from the prior."""
    from cmblensing_tpu_torch.inference import sampling as ts
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    Cphi = ts._fid(ds.Cphi)
    phi = ct.simulate_op(g, Cphi, batch_shape=(nsims,))
    st = dict(generator=g, phi=phi.to(phi.basis.with_space("map")), theta={}, step=1)
    st = ts.gibbs_mix(ts.gibbs_sample_f(st, ds, CG), ds)
    xs = np.linspace(0.5, 1.5, 9)
    mixed = ct.Mixed(ds)

    def loop():
        with torch.no_grad():
            return torch.stack([mixed.logpdf(f_mix=st["f_mix"], phi_mix=st["phi_mix"],
                                             theta={"Aphi": float(v)}) for v in xs])

    def one_call():
        rep = lambda f: ct.Field(f.arr.repeat(len(xs), *([1] * (f.arr.ndim - 1))), f.basis,
                                 f.proj)
        A = torch.as_tensor(np.repeat(xs, nsims), device="cuda")
        with torch.no_grad():
            lp = ct.Mixed(ds.replace(d=rep(ds.d))).logpdf(
                f_mix=rep(st["f_mix"]), phi_mix=rep(st["phi_mix"]), theta={"Aphi": A})
        return lp.reshape(len(xs), nsims)

    out = {}
    for label, fn in (("loop", loop), ("one call", one_call)) * reps:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        lp = fn()
        torch.cuda.synchronize()
        out.setdefault(label, []).append((time.perf_counter() - t0,
                                          torch.cuda.max_memory_allocated() / 2 ** 30, lp))
    for label, rs in out.items():
        print(f"theta grid, {label}: " + ", ".join(f"{t:.4f} s ({m:.2f} GiB peak)"
                                                   for t, m, _ in rs)
              + f" [{len(xs)} values x {nsims} chains; {card}]")
    a, b = out["loop"][0][2], out["one call"][0][2]
    print(f"theta grid: largest |loop - one call| {float((a - b).abs().max()):.3e} "
          f"of logpdfs ~{float(a.abs().max()):.4e}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--N", type=int, default=512)
    ap.add_argument("--nsims", type=int, default=32)
    ap.add_argument("--passes", type=int, default=6)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--theta-ab", action="store_true")
    ap.add_argument("--top", type=int, default=14)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_sample_512: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    from cmblensing_tpu_torch.utils import timing
    from torch.profiler import ProfilerActivity, profile

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    t0 = time.perf_counter()
    sim = ct.load_sim(thetapix=2, Nside=args.N, pol="P", T=np.float32, Nbatch=args.nsims, seed=0)
    ds = sim["ds"]
    torch.cuda.synchronize()
    print(f"load_sim({args.N}^2 P, Nbatch={args.nsims}): {time.perf_counter() - t0:.2f} s "
          "(kernels built at first use)")
    t0 = time.perf_counter()
    run(ct, torch, ds, args.nsims, 1, seed=1)
    torch.cuda.synchronize()
    print(f"warm-up: 1 pass {time.perf_counter() - t0:.2f} s")

    timing.reset_timers()
    lfk.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run(ct, torch, ds, args.nsims, args.passes, seed=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {k: v / args.passes for k, v in lfk.LAUNCHES.items() if v}
    lps = np.stack([e["logpdf"].numpy() for e in res[0]])
    acc = np.stack([e["accept"].numpy() for e in res[0]]).astype(float)
    dH = np.stack([e["dH"].numpy() for e in res[0]])
    late = acc[NBURNIN:]
    print(f"sample_joint {args.N}^2 P x {args.nsims} sims: {args.passes} passes in {wall:.3f} s, "
          f"{wall / args.passes:.4f} s/pass; peak memory {peak:.2f} GiB [{card}]")
    print(f"mean accept {acc.mean():.4f} (all passes), "
          + (f"{late.mean():.4f} over steps > {NBURNIN}" if late.size else
             f"no pass past the {NBURNIN} always-accepted burn-in steps")
          + f"; dH per pass (mean, min, max): "
          + ", ".join(f"({d.mean():.3f}, {d.min():.3f}, {d.max():.3f})" for d in dH))
    print(f"every logpdf finite: {bool(np.isfinite(lps).all())}; mean logpdf per pass "
          + ", ".join(f"{v:.6e}" for v in lps.mean(axis=1)))
    print("split a pass (device time of each timed block):")
    for line in timing.timer_report().splitlines():
        print("  " + line)
    print("launches a pass: " + ", ".join(f"{k} {v:g}" for k, v in sorted(launches.items())))

    if args.profile:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(ct, torch, ds, args.nsims, 1, seed=3)
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(ct, torch, ds, args.nsims, 1, seed=3)
            torch.cuda.synchronize()
        report(prof, 1, wall1, f"one pass [{args.N}^2 P x {args.nsims}; {card}]", "pass", args.top)
    if args.theta_ab:
        theta_ab(ct, torch, ds, args.nsims, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
