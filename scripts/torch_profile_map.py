"""Where the time of a 1024^2 P MAP_joint step goes on the PyTorch port,
per LenseFlow backend, on one CUDA card.

    python scripts/torch_profile_map.py [--backends kernel uni] [--steps 2]

Runs MAP_joint as chip_smoke.py phase 7 does (load_sim at 1024^2 P,
thetapix 2, seed 0; grid line search; 15 fixed CG iterations). For each
backend: 2 warm-up steps, an unprofiled run of --steps steps for the
wall time, then the same run under torch.profiler (CUDA activity only).
Prints per step: wall s, device ms and the device's busy share, and the
device ms and launches of the kernels that take the most time. Needs a
CUDA card; exits non-zero without one.
"""
import argparse
import os
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--backends", nargs="+", default=["kernel", "uni"])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_profile_map: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import cmblensing_tpu_torch as ct
    from torch.profiler import ProfilerActivity, profile

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    ds = ct.load_sim(thetapix=2, Nside=1024, pol="P", T=np.float32, seed=0)["ds"]
    run = lambda n: ct.MAP_joint(ds, nsteps=n, linesearch="grid",
                                 conjgrad_kwargs=dict(tol=0.0, nsteps=15, fixed_iters=True))
    for backend in args.backends:
        with ct.lenseflow_backend_ctx(backend):
            run(2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(args.steps)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / args.steps
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run(args.steps)
                torch.cuda.synchronize()
        by_name = defaultdict(lambda: [0.0, 0])
        for e in prof.key_averages():
            by_name[e.key][0] += e.self_device_time_total / 1e3 / args.steps
            by_name[e.key][1] += e.count / args.steps
        device = sum(ms for ms, _ in by_name.values())
        print(f"{backend}: {wall:.4f} s/step wall, {device:.2f} ms/step device, busy "
              f"{100 * device / (1e3 * wall):.1f} % [1024^2 P, {args.steps} steps; {card}]")
        for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:args.top]:
            print(f"  {ms:9.3f} ms/step  {n:8.1f} launches/step  {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
