"""Peak device memory of the port's mixed phi-gradient, whole against
split into its two logpdf terms (inference/maximization.py::
_term_split_fgrad), on one CUDA card.

    python scripts/torch_term_split_mem.py [--N 2048 4096] [--out FILE]

For each N: load_sim(thetapix=2, Nside=N, pol="P", seed=0) on the card,
its f and phi, and `_phi_grad_and_fmix` (strict, the kernel backend) run
whole and split, each after one warm run: the peak memory above what the
card held before the call, the wall seconds, and the two gradients'
relative distance. TERM_SPLIT_MIN_N in inference/maximization.py is set
from these numbers. Prints one JSON line per N, and the card's name and
power limit.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--N", type=int, nargs="+", default=[2048, 4096])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.inference import maximization as tm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    rows = []
    for N in args.N:
        sim = ct.load_sim(thetapix=2, Nside=N, pol="P", T=np.float32, seed=0, device="cuda")
        ds = sim["ds"].at({}).replace(G=ct.Id)
        f, phi = sim["f"], sim["phi"].to(ct.MAP)
        del sim
        row = dict(N=N, card=card)
        grads = {}
        for how, threshold in (("whole", 1 << 30), ("split", 1)):
            tm.TERM_SPLIT_MIN_N = threshold
            with torch.no_grad():
                tm._phi_grad_and_fmix(ds, {}, f, phi)       # warm-up
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                _, _, g = tm._phi_grad_and_fmix(ds, {}, f, phi)
                torch.cuda.synchronize()
            row[f"{how}_s"] = time.perf_counter() - t0
            row[f"{how}_peak_GiB"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            grads[how] = g.arr.double()
            del g
        row["rel"] = float((grads["split"] - grads["whole"]).norm() / grads["whole"].norm())
        row["planes_whole"] = row["whole_peak_GiB"] * 2 ** 30 / (4 * N * N)
        row["planes_split"] = row["split_peak_GiB"] * 2 ** 30 / (4 * N * N)
        print(json.dumps(row), flush=True)
        rows.append(row)
        del grads, ds, f, phi
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rows, fh)
    print(card)


if __name__ == "__main__":
    main()
