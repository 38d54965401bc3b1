"""What the precision of phi's grad/Hess planes does to the 'bf16' tier of
the PyTorch port, on one CUDA card.

    python scripts/torch_bf16_planes.py [--N 1024 2048] [--map-N 2048]

For each --N: phi, f and dy as chip_smoke.py draws them (weak_lensing_inputs:
phi from the fiducial Cphi, f from Cf, seed 0, thetapix 2); the error of
phi's planes (gx, gy, hxx, hxy, hyy) formed at 'bf16' and at 'high' against
strict, and the least det(I + Hess phi), which p(t) divides by at t = 1;
then L @ f, L^H @ f and the phi-VJP of L @ f through the LenseFlow entry
points under precision_ctx("bf16"), with the planes formed strict (the
port's rule, ops/lenseflow_kernels.py::PLANES_PRECISION) and at 'bf16' (as
the JAX package forms them): the largest |value| and the non-finite count
of each, beside the strict results. With --map-N, one MAP_joint(precision=
"bf16") step each way (load_sim at that size, thetapix 2, pol P, seed 0;
grid line search, 15 fixed CG iterations): logpdf, alpha, direction retry.
Needs a CUDA card; exits non-zero without one.
"""
import argparse
import contextlib
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def planes_at(lfk, precision):
    """phi's planes at `precision` for the 'bf16' tier, within."""
    prev = lfk.PLANES_PRECISION["bf16"]
    lfk.PLANES_PRECISION["bf16"] = precision
    try:
        yield
    finally:
        lfk.PLANES_PRECISION["bf16"] = prev


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--N", type=int, nargs="*", default=[1024, 2048])
    ap.add_argument("--map-N", type=int, default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_bf16_planes: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import deriv, lenseflow_kernels as lfk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    for N in args.N:
        proj = ct.ProjLambert(N, N, thetapix=2, T=np.float32, device="cuda")
        phi_map, f, dy = chip_smoke.weak_lensing_inputs(proj, torch)
        ops = deriv.deriv_ops(proj)
        strict = lfk.gradhess(phi_map, ops, "f32")
        det = lambda h: float(((1 + h[2]) * (1 + h[4]) - h[3] ** 2).min())
        for p in ("bf16", "high"):
            with planes_at(lfk, p):
                planes = lfk._gradhess(lfk._leaves_for(phi_map, ops, p), phi_map, ops)
            err = [float((planes[i] - strict[i]).abs().max()) for i in range(5)]
            print(f"{N}^2: planes at {p!r}: max |error| (gx, gy, hxx, hxy, hyy) "
                  f"{[f'{e:.3g}' for e in err]} against max |strict| "
                  f"{[f'{float(x.abs().max()):.3g}' for x in strict]}; least det(I + H) "
                  f"{det(planes):.3f} (strict {det(strict):.3f}) [{card}]")
        fq = ct.Field(f, ct.QU_MAP, proj)
        for label, prec, planes_prec in (("strict", "f32", "f32"), ("bf16, strict planes", "bf16",
                                                                    "f32"),
                                         ("bf16, bf16 planes", "bf16", "bf16")):
            x = phi_map.clone().requires_grad_(True)
            with planes_at(lfk, planes_prec), deriv.precision_ctx(prec):
                L = ct.LenseFlow(ct.Field(x, ct.MAP, proj), 7)
                lf, lh = (L @ fq).arr, (L.H @ fq).arr
                (g,) = torch.autograd.grad((lf * dy).sum(), x)
            torch.cuda.synchronize()
            desc = lambda t: (f"max {float(t[torch.isfinite(t)].abs().max()):.4g}, non-finite "
                              f"{int((~torch.isfinite(t)).sum())}" if torch.isfinite(t).any()
                              else "all non-finite")
            print(f"{N}^2: {label}: L @ f {desc(lf.detach())}; L^H @ f {desc(lh.detach())}; "
                  f"phi-VJP {desc(g)} [{card}]")
    if args.map_N:
        sim = ct.load_sim(thetapix=2, Nside=args.map_N, pol="P", T=np.float32, seed=0)
        for planes_prec in ("f32", "bf16"):
            with planes_at(lfk, planes_prec):
                res = ct.MAP_joint(sim["ds"], nsteps=1, linesearch="grid", precision="bf16",
                                   conjgrad_kwargs=dict(tol=0.0, nsteps=15, fixed_iters=True),
                                   history_keys=("logpdf", "alpha", "retry"))
            h = res["history"][0]
            print(f"MAP_joint {args.map_N}^2 P precision 'bf16', phi planes at {planes_prec!r}, "
                  f"1 step: logpdf {h['logpdf']!r}, alpha {h['alpha']!r}, retry {h['retry']} "
                  f"[{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
