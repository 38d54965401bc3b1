"""The "auto" Wiener filter's strict re-check under fixed CG iterations, on
one CUDA card.

    python scripts/torch_auto_recheck.py ratios
    python scripts/torch_auto_recheck.py ab --tree DIR

`ratios` runs three workloads at "auto" and records, for every f-step solve
(`inference/maximization.py::_argmaxf_core` at 'high'), the strict residual
at the solve's x (info["res_strict"]), the 'high' operator's own residual
there (info["res_high"]) and their ratio, entry by entry, with the
argmaxf_logpdf verdicts (AUTO_RECHECK_KAPPA sets the bound these ratios
choose):
- the 1024^2 P north star, through chip_smoke.py's run_map (MAP_joint as
  scripts/map_1024.py runs it: grid line search, CG 15 fixed iterations at
  tol 0; 2 warm-up steps, then 6 timed);
- bandpower MUSE at 256^2 P x 8 sims (scripts/torch_muse_256.py's
  configuration: 4 bins, 4 steps, MAP 5 steps, CG 20 fixed);
- the sampler's f-step at 512^2 P x 32 sims (load_sim(thetapix=2,
  Nside=512, pol="P", Nbatch=32, seed=0); after one strict sample_joint pass
  at chip_smoke.py's settings, sample_f at its phi, CG 25 fixed, "auto").

`ab` runs the north star from the package in DIR (a checkout; its kernels
build under DIR/build) through DIR's own chip_smoke.py::run_map: MAP_joint
strict (precision=None) and at "auto", each printing s/step, corr(phi_MAP,
phi_true), the logpdfs and whether each f-step re-ran strict. Run it on two
trees in one call, in the order parent, change, change, parent, to compare
them on one card.

Each run prints the card's name and power limit. Needs a CUDA card; exits
non-zero without one.
"""
import argparse
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE_CG = dict(tol=0.0, nsteps=25, fixed_iters=True)  # chip_smoke.py phase 19


def card_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def north_star(ct, cs):
    """chip_smoke.py's 1024^2 P simulation, the one run_map takes."""
    return ct.load_sim(thetapix=cs.THETAPIX_MAP, Nside=cs.N_MAP, pol="P", T=np.float32,
                       seed=cs.SEED, device="cuda")


class Recorder:
    """Wraps _argmaxf_core: keeps the residuals of every reduced-precision
    solve."""

    def __init__(self, tm):
        self.tm, self.core, self.rows = tm, tm._argmaxf_core, []

    def __enter__(self):
        def spy(*a, **k):
            x, info = self.core(*a, **k)
            if "res_high" in info:
                s, h, r0 = (info[k].double().cpu().reshape(-1)
                            for k in ("res_strict", "res_high", "res0"))
                self.rows.append((s, h, r0, bool(info["precision_ok"])))
            return x, info
        self.tm._argmaxf_core = spy
        return self

    def __exit__(self, *exc):
        self.tm._argmaxf_core = self.core

    def report(self, label, card):
        if not self.rows:
            raise SystemExit(f"{label}: no solve recorded res_high")
        ratios = np.concatenate([(s / h).numpy() for s, h, _, _ in self.rows])
        rel = np.concatenate([(s / r0).numpy() for s, _, r0, _ in self.rows])
        fails = sum(not ok for *_, ok in self.rows)
        print(f"{label}: {len(self.rows)} solves, {ratios.size} entries: res_strict / res_high "
              f"min {ratios.min():.6g}, median {np.median(ratios):.6g}, max {ratios.max():.6g}; "
              f"res_strict / res0 median {np.median(rel):.6g}, max {rel.max():.6g}; "
              f"solves that re-ran strict {fails} [{card}]")
        for i, (s, h, r0, ok) in enumerate(self.rows[:4]):
            print(f"  solve {i}: res0 {r0.tolist()[:4]}, res_strict {s.tolist()[:4]}, res_high "
                  f"{h.tolist()[:4]}, ok {ok}")
        return ratios


def ratios(args, card):
    import torch
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.inference import maximization as tm
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from torch_muse_256 import muse_dataset, run_muse
    import chip_smoke as cs
    print(f"AUTO_RECHECK_KAPPA {tm.AUTO_RECHECK_KAPPA}")
    out = {}
    sim = north_star(ct, cs)
    with Recorder(tm) as rec:
        cs.run_map(torch, sim, "ratios", "kernel, precision \"auto\"", card, "auto")
    out["map"] = rec.report(f"north star {cs.N_MAP}^2 P", card)
    del sim
    ds, _, _, _ = muse_dataset(ct, torch, 256, 4)
    with Recorder(tm) as rec:
        t0 = time.perf_counter()
        run_muse(ct, torch, ds, 4, 8, 4)
        torch.cuda.synchronize()
    print(f"MUSE 256^2 P x 8: {time.perf_counter() - t0:.3f} s/run")
    out["muse"] = rec.report("MUSE 256^2 P x 8", card)
    del ds
    sim = ct.load_sim(thetapix=2, Nside=512, pol="P", T=np.float32, Nbatch=32, seed=0,
                      device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    chain = ct.sample_joint(sim["ds"], 1, nchains=32, generator=g,
                            symp_kwargs=[dict(N=25, eps=0.003)], nburnin_always_accept=3,
                            conjgrad_kwargs=SAMPLE_CG)[0]
    phi = chain[-1]["phi"]   # the chain's record, on the host
    phi = ct.Field(phi.arr.to("cuda"), phi.basis, sim["ds"].d.proj)
    with Recorder(tm) as rec:
        ct.sample_f(g, sim["ds"], phi=phi, conjgrad_kwargs=SAMPLE_CG)
    out["sample"] = rec.report("sampler f-step 512^2 P x 32", card)
    allr = np.concatenate(list(out.values()))
    print(f"all: {allr.size} entries, res_strict / res_high max {allr.max():.6g}")


def ab(args, card):
    import torch
    import cmblensing_tpu_torch as ct
    import chip_smoke as cs
    print(f"tree {args.tree}: cmblensing_tpu_torch from {os.path.dirname(ct.__file__)}, "
          f"run_map from {cs.__file__}")
    sim = north_star(ct, cs)
    for label, precision in (("strict", None), ("auto", "auto")):
        cs.run_map(torch, sim, "ab", f"{args.tree} {label}", card, precision)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("ratios", "ab"))
    ap.add_argument("--tree", default=ROOT)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_auto_recheck: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.tree))
    card = card_line()
    print(card)
    (ratios if args.what == "ratios" else ab)(args, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
