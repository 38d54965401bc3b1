"""The flows of one checkout of the port against their plain versions at
nsteps 1 and 7, for a comparison between checkouts; the cold times of the
factored kernels at one radix; and the MAP_joint step at "auto". One CUDA
card.

    python scripts/torch_flow_witness.py flows --tree DIR --out FILE [--N 512 1024]
        [--tiers high bf16] [--backward] [--nsteps 1 7] [--no-plain]
    python scripts/torch_flow_witness.py compare FILE_A FILE_B
    python scripts/torch_flow_witness.py kernels --tree DIR [--N 1024] [--reps 10]
        [--tiers high bf16] [--kernels K1 K3 K4 K5]
    python scripts/torch_flow_witness.py map --tree DIR [--N 1024] [--steps 4]
    python scripts/torch_flow_witness.py ulp [--N 2048 4096] [--tiers f32 high bf16]
        [--nsteps 7]

DIR is a checkout of the repository (the parent commit unpacked by
`git archive`, say); its cmblensing_tpu_torch is imported, and its
kernels built into DIR/build, in place of this one's. The inputs are
chip_smoke.py's (weak_lensing_inputs, seed 0), so every checkout sees the
same ones.

  flows    at each --N and tier of --tiers ('high', 'bf16', 'f32'), at each
           of --nsteps (1 and 7): the kernel backend's L and L^H (K3) and
           backward flow (delta f, delta phi; K4, K1), K4's velocity at one
           backward state (k_f, k_df, the five delta-phi integrands), and
           the uni backend's L, L^H and backward flow (delta f, delta phi;
           K5), each against its plain version at the tier (relative
           max-abs, every plane) and, at a reduced tier, in relative
           Frobenius norm, the distance to plain over the distance to the
           strict kernel flow (chip_smoke.py's split_ratio), unless
           --no-plain; with --backward the backward flows and K4's velocity
           alone; the kernel outputs saved to FILE
  compare  two such files: for each output, the same bits or how far apart
           (the largest relative max-abs of its planes)
  kernels  of --kernels at each tier of --tiers on --N^2 (radix N / 128),
           cold device ms (chip_smoke.py's cold_ms) and relative max-abs
           against the plain version: K1 strict d_x and d_y (batch 1;
           strict alone, whatever --tiers), K3 forward and adjoint (batch 1
           and 17 trials), K4 (batch 1), K5 roles 0-3 (batch 1); run it on
           two checkouts in turns to compare them (the A/B of the tile a
           kernel runs at a tier and radix, ops/lenseflow_kernels.py::
           FORMS, against a checkout that runs the other)
  map      MAP_joint at --N^2 P (1024 or 4096), "auto", as chip_smoke.py
           phases 9 and 15 (1024^2: 2 warm-up steps) or 13 (d) and 16 (d)
           (4096^2: 1), on the kernel and the uni backend, then --steps
           timed
  ulp      at each --N and tier of --tiers, the kernel backend's backward
           flow (nsteps: the last of --nsteps) twice: as it runs, and with
           its five delta-phi accumulators each moved by one float32 ulp
           (up or down, a seeded coin per value) before the K1 passes that
           form delta phi from them; prints how far delta phi moves
           (relative max-abs) and, for scale, how far the accumulators did
           (the largest relative max-abs of the five planes): what a
           last-bit change of K4's integrands alone does to delta phi

Prints the card's name and power limit. Exits non-zero without a card.
"""
import argparse
import importlib.util
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIERS = ("high", "bf16")
PRECISIONS = ("f32", "high", "bf16")


def smoke():
    """This checkout's chip_smoke.py as a module (its helpers import the
    port lazily, so they use whichever package sys.path finds first)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def inputs(cs, torch, N):
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import deriv, lenseflow_kernels as lfk
    proj = ct.ProjLambert(N, N, thetapix=cs.THETAPIX_MAP, T=np.float32, device="cuda")
    ops = deriv.deriv_ops(proj)
    phi_map, f, dy = cs.weak_lensing_inputs(proj, torch)
    return ops, lfk.gradhess(phi_map, ops), f, dy


def flows(cs, torch, args):
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    saved = {}
    for N in args.N:
        ops, phi, f, dy = inputs(cs, torch, N)
        yb = torch.cat([f[None], dy[None], 1e-3 * torch.as_tensor(
            np.random.default_rng(cs.SEED + 1).standard_normal((1, 5, N, N)).astype(np.float32),
            device="cuda")], dim=1)
        pt = torch.empty((2, 1, N, N), device="cuda")
        lfk.p_planes_cuda(0.5, phi[None], pt)

        def run(tier, form):
            ap = {"kernel": lfk.flow_apply, "plain": lfk.flow_apply_plain}[form]
            bw = {"kernel": lfk.flow_bwd, "plain": lfk.flow_bwd_plain}[form]
            uap = {"kernel": lfk.uni_flow_apply, "plain": lfk.uni_flow_apply_plain}[form]
            ubw = {"kernel": lfk.uni_flow_bwd, "plain": lfk.uni_flow_bwd_plain}[form]
            vel = {"kernel": lfk.fvelocity_cuda, "plain": lfk.fvelocity_plain}[form]
            out = {}
            k = torch.empty_like(yb)
            vel("backward", yb, k, phi[None], pt, ops, 2, 0.5, tier)
            out[0, "K4 k_f"], out[0, "K4 k_df"], out[0, "K4 integrands"] = k[:, :2], k[:, 2:4], k[:, 4:]
            for n in args.nsteps:
                if not args.backward:
                    out[n, "K3 L"] = ap(f, phi, ops, 0., 1., n, "forward", tier)
                    out[n, "K3 L^H"] = ap(f, phi, ops, 0., 1., n, "adjoint", tier)
                    out[n, "K5 L"] = uap(f, phi, ops, 0., 1., n, "forward", tier)
                    out[n, "K5 L^H"] = uap(f, phi, ops, 0., 1., n, "adjoint", tier)
                out[n, "K4 delta phi"], out[n, "K4 delta f"] = bw(dy, f, phi, ops, 0., 1., n, tier)
                dphi, df = ubw(dy, f, phi, ops, 0., 1., n, tier)
                out[n, "K5 delta f"], out[n, "K5 delta phi"] = df, dphi
            torch.cuda.synchronize()
            return out

        strict = run("f32", "kernel") if not args.no_plain else None
        for tier in args.tiers:
            k = strict if tier == "f32" and strict is not None else run(tier, "kernel")
            p = run(tier, "plain") if not args.no_plain else None
            for key in k:
                line = f"{N}^2 {tier:4s} nsteps {key[0]} {key[1]:13s}"
                if p is not None:
                    e = max(cs.rel(a, b) for a, b in zip(k[key].reshape(-1, N, N),
                                                          p[key].reshape(-1, N, N)))
                    bound = cs.K1_SM90_TOL.get(tier, cs.FLOW_TOL)
                    line += f": vs plain {e:.3e} (bound {bound:g}{'' if e < bound else ', OVER'})"
                    if tier != "f32":
                        r = cs.split_ratio(k[key], p[key], strict[key])
                        line += (f"; Frobenius vs plain {r['fro']:.3e}, vs strict "
                                 f"{r['fro_strict']:.3e}, ratio {r['split_ratio']:.4f} (bound "
                                 f"{cs.FLOW_SPLIT_RATIO:g})")
                print(line, flush=True)
                saved[f"{N} {tier} {key[0]} {key[1]}"] = k[key].cpu()
            del k, p
        del ops, phi, f, dy, yb, pt, strict
        torch.cuda.empty_cache()
    torch.save(saved, args.out)


def compare(args):
    import torch
    a, b = torch.load(args.files[0]), torch.load(args.files[1])
    for key in a:
        x, y = a[key], b[key]
        if torch.equal(x, y):
            print(f"{key:36s}: the same bits")
            continue
        n = x.shape[-1]
        d = max(float((p - q).abs().max() / q.abs().max())
                for p, q in zip(x.reshape(-1, n, n), y.reshape(-1, n, n)))
        print(f"{key:36s}: differ, relative max-abs {d:.3e} (the largest of its planes)")


def kernels(cs, torch, args, card):
    for N in args.N:
        kernels_at(cs, torch, args, card, N)
        torch.cuda.empty_cache()


def kernels_at(cs, torch, args, card, N):
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    ops, phi, f, dy = inputs(cs, torch, N)
    t = 0.5
    if "K1" in args.kernels:
        for label, x in (("d_x", (f[:1], None, None)), ("d_y", (None, f[:1], None))):
            o, ref = torch.empty_like(f[:1]), torch.empty_like(f[:1])
            run = lambda o_, x=x: lfk.fderiv_cuda(*x, o_, ops)
            run(o)
            lfk.fderiv_plain(*x, ref, ops)
            ms = cs.cold_ms(run, (o,), args.reps, torch)
            print(f"K1 f32  {label:8s} {N}^2 [ 1]: {ms:.4f} ms cold; vs plain "
                  f"{cs.rel(o, ref):.3e} [{card}]", flush=True)
    for nb in ((1, cs.NTRIAL) if "K3" in args.kernels else ()):
        phis = phi[None] if nb == 1 else torch.stack([(0.1 + 0.1 * i) * phi
                                                      for i in range(nb)])
        y = f[None] if nb == 1 else torch.stack([torch.roll(f, 7 * i, dims=-1)
                                                 for i in range(nb)])
        pt = torch.empty((2, nb, N, N), device="cuda")
        lfk.p_planes_cuda(t, phis, pt)
        for tier in args.tiers:
            for kind in ("forward", "adjoint"):
                o, ref = torch.empty_like(y), torch.empty_like(y)
                run = lambda o_, y_, kind=kind, tier=tier: lfk.fvelocity_cuda(
                    kind, y_, o_, phis, pt, ops, 2, t, tier)
                run(o, y)
                lfk.fvelocity_plain(kind, y, ref, phis, pt, ops, 2, t, tier)
                ms = cs.cold_ms(run, (o, y), args.reps, torch)
                print(f"K3 {tier:4s} {kind:8s} {N}^2 [{nb:2d}]: {ms:.4f} ms cold; vs plain "
                      f"{cs.rel(o, ref):.3e} [{card}]", flush=True)
    if "K4" in args.kernels:
        yb = torch.cat([f[None], dy[None], 1e-3 * torch.ones((1, 5, N, N), device="cuda")], dim=1)
        pt = torch.empty((2, 1, N, N), device="cuda")
        lfk.p_planes_cuda(t, phi[None], pt)
        for tier in args.tiers:
            o, ref = torch.empty_like(yb), torch.empty_like(yb)
            run = lambda o_, y_, tier=tier: lfk.fvelocity_cuda("backward", y_, o_, phi[None], pt,
                                                               ops, 2, t, tier)
            run(o, yb)
            lfk.fvelocity_plain("backward", yb, ref, phi[None], pt, ops, 2, t, tier)
            ms = cs.cold_ms(run, (o, yb), args.reps, torch)
            e = max(cs.rel(a, b) for a, b in zip(o[0], ref[0]))
            print(f"K4 {tier:4s} backward {N}^2 [ 1]: {ms:.4f} ms cold; vs plain {e:.3e} "
                  f"[{card}]", flush=True)
        del yb
    if "K5" not in args.kernels:
        return
    px, py, calls = cs.uni_operands(torch, ops, phi[None], torch.cat([f, dy])[None], t)
    for tier in args.tiers:
        for key, role, a, b in calls:
            if not isinstance(key, int):
                continue
            out = torch.empty((1, a.shape[1], 4, N, N), device="cuda")
            ref = torch.empty_like(out)
            run = lambda o_, role=role, a=a, b=b, tier=tier: lfk.uni_velocity_cuda(
                role, a, b, px, py, o_, ops, t, tier)
            run(out)
            lfk.uni_velocity_plain(role, a, b, px, py, ref, ops, t, tier)
            ms = cs.cold_ms(run, (out,), args.reps, torch)
            print(f"K5 {tier:4s} role {role} {N}^2 [ 1]: {ms:.4f} ms cold; vs plain "
                  f"{cs.rel(out, ref):.3e} [{card}]", flush=True)


def ulp(cs, torch, args, card):
    import copy
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    n = args.nsteps[-1]
    for N in args.N:
        ops, phi, f, dy = inputs(cs, torch, N)
        for tier in args.tiers:
            leaves = lfk._leaves_for(f, ops, tier)
            nudged, moved = copy.copy(leaves), []
            g = torch.Generator(device=f.device).manual_seed(cs.SEED)

            def deriv(a, b, c, out, mats):
                # _flow_bwd's first two K1 calls read the accumulators
                # (s_xx, s_xy, u_x; s_yy, u_y), the third what they made
                if len(moved) < 2:
                    ups = [None if x is None else torch.nextafter(x, torch.where(
                        torch.rand(x.shape, generator=g, device=x.device) < 0.5,
                        -torch.inf, torch.inf)) for x in (a, b, c)]
                    moved.append(max(cs.rel(u, x) for u, x in zip(ups, (a, b, c))
                                     if x is not None))
                    a, b, c = ups
                leaves.deriv(a, b, c, out, mats)

            nudged.deriv = deriv
            dphi, _ = lfk._flow_bwd(leaves, dy, f, phi, ops, 0., 1., n)
            dphi_u, _ = lfk._flow_bwd(nudged, dy, f, phi, ops, 0., 1., n)
            again, _ = lfk._flow_bwd(leaves, dy, f, phi, ops, 0., 1., n)
            print(f"{N}^2 {tier:4s} nsteps {n}: delta phi moves {cs.rel(dphi_u, dphi):.3e} "
                  f"(relative max-abs) when the accumulators move {max(moved):.3e}; the same "
                  f"flow again: {'the same bits' if torch.equal(again, dphi) else 'DIFFERS'} "
                  f"[{card}]", flush=True)
            del dphi, dphi_u, again
        del ops, phi, f, dy
        torch.cuda.empty_cache()


def map_step(cs, torch, args, card):
    import cmblensing_tpu_torch as ct
    N = args.N[0]
    warm = cs.MAP_WARM if N == cs.N_MAP else cs.LARGE_WARM
    sim = ct.load_sim(thetapix=cs.THETAPIX_MAP, Nside=N, pol="P", T=np.float32, seed=cs.SEED,
                      device="cuda")
    for backend in ("kernel", "uni"):
        with ct.lenseflow_backend_ctx(backend):
            run = lambda n: ct.MAP_joint(sim["ds"], nsteps=n, linesearch="grid",
                                         conjgrad_kwargs=cs.MAP_CG, precision="auto",
                                         history_keys=("logpdf",))
            run(warm)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = run(args.steps)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / args.steps
        lps = [h["logpdf"] for h in res["history"]]
        print(f"MAP_joint {N}^2 P \"auto\" on {backend}: {dt:.4f} s/step over {args.steps} steps "
              f"after {warm} warm-up; peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
              f"logpdfs {lps} [{card}]", flush=True)
        del res
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("flows", "compare", "kernels", "map", "ulp"))
    ap.add_argument("files", nargs="*")
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--out", default=None)
    ap.add_argument("--N", type=int, nargs="+", default=None)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--tiers", nargs="+", choices=PRECISIONS, default=None)
    ap.add_argument("--kernels", nargs="+", choices=("K1", "K3", "K4", "K5"),
                    default=["K1", "K3", "K4", "K5"])
    ap.add_argument("--nsteps", type=int, nargs="+", default=[1, 7])
    ap.add_argument("--backward", action="store_true")
    ap.add_argument("--no-plain", action="store_true")
    args = ap.parse_args()
    if args.mode == "compare":
        return compare(args)
    import torch
    if not torch.cuda.is_available():
        print("torch_flow_witness: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.tree))
    cs = smoke()
    card = cs.card_line()
    import cmblensing_tpu_torch
    print(f"{args.mode} on {os.path.dirname(cmblensing_tpu_torch.__file__)} [{card}]", flush=True)
    if args.mode == "flows":
        args.N, args.tiers = args.N or [512, 1024], args.tiers or TIERS
        flows(cs, torch, args)
    elif args.mode == "kernels":
        args.N, args.tiers = args.N or [1024], args.tiers or TIERS
        kernels(cs, torch, args, card)
    elif args.mode == "ulp":
        args.N, args.tiers = args.N or [2048, 4096], args.tiers or PRECISIONS
        ulp(cs, torch, args, card)
    else:
        args.N = args.N or [cs.N_MAP]
        map_step(cs, torch, args, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
