"""The lensed-spectra anchor of tests/test_golden.py on the port's own
draws: scripts/make_golden.py's recipe (load_sim(thetapix=3, Nside=256,
seed) for seeds 0-3, T from pol I and E, B from pol P, each lensed by
LenseFlow(phi, 7), get_Cl in bins of 100 over [300, 2000]), the seeds'
mean band powers over CAMB's lensed_scalar theory, held to the bounds
tests/test_golden.py holds the committed ratios to: each bin within 0.25
of 1, each spectrum's mean within 0.06.

    python scripts/torch_lensed_anchor.py [--device cuda|cpu]

prints the ratios and exits 1 when a spectrum misses. chip_smoke.py phase
24 (b) runs it on the card, tests/test_torch_golden.py on the CPU.
Imports torch and the port, never JAX.
"""
import argparse
import os
import sys

import numpy as np

SEEDS, LEDGES = 4, np.arange(300, 2001, 100)
BIN_TOL, MEAN_TOL = 0.25, 0.06
N, NSTEPS = 256, 7


def ratios(device="cuda"):
    """{"TT", "EE", "BB"}: the mean over SEEDS seeds of the lensed band
    powers over CAMB's lensed theory in the bins of LEDGES."""
    import torch
    import cmblensing_tpu_torch as ct
    Cl = ct.camb()
    out = {}
    for pol, comps in (("I", (("I", "TT"),)), ("P", (("E", "EE"), ("B", "BB")))):
        found = {spec: [] for _, spec in comps}
        for seed in range(SEEDS):
            o = ct.load_sim(thetapix=3, Nside=N, pol=pol, T=np.float32, seed=seed, device=device)
            with torch.no_grad():
                f_len = ct.LenseFlow(o["phi"].to(ct.MAP), NSTEPS) @ o["f"].to(
                    o["f"].basis.with_space("map"))
            for c, spec in comps:
                bp = ct.get_Cl(f_len[c], ledges=LEDGES)
                found[spec].append(np.asarray(bp.Cl) / Cl["lensed_scalar"][spec](bp.ell))
        out.update({spec: np.mean(r, axis=0) for spec, r in found.items()})
    return out


def misses(found):
    """The spectra of `found` (ratios()) that miss the bounds: a bin
    BIN_TOL from 1, or the mean MEAN_TOL."""
    return {spec: r.tolist() for spec, r in found.items()
            if not (np.all(np.abs(r - 1) < BIN_TOL) and abs(np.mean(r) - 1) < MEAN_TOL)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    found = ratios(args.device)
    for spec, r in found.items():
        print(f"lensed {spec} / CAMB: {np.round(r, 4).tolist()}, mean {np.mean(r):.4f}")
    missed = misses(found)
    if missed:
        print(f"missed: {sorted(missed)}")
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
