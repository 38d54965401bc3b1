"""Where the time of the kernels on the cluster tile (K1, K3) and of K2's
'bf16' derivative goes, by clock64 phase, and K2's 'bf16' derivative
against the library call, on one CUDA card.

    python scripts/torch_kernel_phases.py [--N 1024 4096] [--rounds 6]
        [--parent DIR]

Builds probe libraries from the port's sources into build/ (nvcc,
sm_90a, in parallel): csrc/fderiv_sm90.cu, csrc/fa_sm90.cu and
csrc/lenseflow.cu with LF_CLOCK_PHASES defined (thread 0 of every block
adds the clock64 cycles between the kernels' phase marks,
lenseflow_common.cuh); with --parent, also DIR's
cmblensing_tpu_torch/csrc/lenseflow.cu as it is and its fderiv_sm90.cu with
LF_CLOCK_PHASES (another checkout, for example the parent commit unpacked
by `git archive`). Then:

  K1   at each --N, 'high' and 'bf16', d_x and d_y of one plane: the mean
       cycles a CTA spends in each phase of csrc/fact_sm90.cuh (set-up,
       the first slab, and per slab the next slab's loads issued, the
       consumer barrier, the block-slab wait, the products and the next
       slab's channels; the two cluster barriers around the push of y_c
       through DSMEM, and the inverse butterfly with the kernel's store),
       each as a share of the CTA's total;
       with --parent, then --rounds rounds of cold device times of d_x, in
       turns, the port's K1 and DIR's (both probe builds, each round in the
       order port, parent and the next in reverse), and the two outputs'
       relative max-abs difference;
  K3   the same phases for both roles of a two-component velocity (one
       call: the x pass and the y pass), strict, 'high' and 'bf16' where
       ops/lenseflow_kernels.py::FORMS runs K3 on the cluster tile;
  K2   the 'bf16' derivative d_x of the masked IP slice's shape (3 x 256^2)
       and of 200^2, 160 x 200 and 600^2 (random planes): the phases of
       csrc/lenseflow.cu::deriv_bf16_kernel (loads issued, load wait,
       rounding to bf16 and the barrier, products, stores), then --rounds
       rounds of cold device times (chip_smoke.py's cold_ms) in turns, the
       port's lf_deriv (the library it loads), the library call
       (chip_smoke.py's library_bf16_ms) and, with --parent, DIR's
       lf_deriv, each round in the order port, library, parent and the
       next in reverse; every reading is printed.

The phases' cycles come from instrumented builds and are shares, not
times; the times come from uninstrumented ones. Prints the card's name
and power limit. Needs a CUDA card and nvcc; exits non-zero without them.
"""
import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

K1_PHASES = {0: "set-up", 1: "first slab", 4: "next loads issued", 3: "consumer barrier",
             2: "block-slab wait", 5: "products", 6: "next channels", 7: "after the last slab",
             8: "cluster barrier 1", 9: "push y_c (DSMEM stores)", 10: "cluster barrier 2",
             11: "inverse butterfly and store"}
K2_PHASES = {0: "loads issued", 1: "load wait", 4: "rounding and barrier", 2: "products",
             3: "stores"}


def build(tag, src, defines=()):
    """Start nvcc on `src` with -D`defines` into build/phases_<tag>.so."""
    from cmblensing_tpu_torch.ops import _build
    out = os.path.join(ROOT, "build", f"phases_{tag}.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *_build.form_flags(), *(f"-D{d}" for d in defines),
           "-shared", "-o", out, str(src)]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def load(path, entries):
    lib = ctypes.CDLL(path)
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, args in entries.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, I
    return lib


def ticks(lib, run, nblocks, torch):
    """Mean cycles a block spends in each phase over one run (after a warm-up)."""
    run()
    torch.cuda.synchronize()
    assert lib.lf_phase_ticks_clear() == 0
    run()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 16)()
    assert lib.lf_phase_ticks_read(buf) == 0
    return np.array(buf[:], dtype=np.float64) / nblocks


def show(label, t, names):
    total = sum(t[i] for i in names)
    parts = ", ".join(f"{n} {t[i]:.0f} ({100 * t[i] / total:.1f} %)" for i, n in names.items()
                      if t[i] > 0)
    print(f"{label}: {total:.0f} cycles a block: {parts}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--N", type=int, nargs="+", default=[1024, 4096])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--parent", default=None,
                    help="another checkout whose lenseflow.cu K2 is timed beside the port's")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_phases: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import _build, deriv, lenseflow_kernels as lfk
    card = cs.card_line()
    print(f"card: {card}")
    jobs = [build("k1", _build.CSRC / "fderiv_sm90.cu", ["LF_CLOCK_PHASES"]),
            build("k2", _build.CSRC / "lenseflow.cu", ["LF_CLOCK_PHASES"]),
            build("k3", _build.CSRC / "fa_sm90.cu", ["LF_CLOCK_PHASES"])]
    if args.parent:
        pcsrc = os.path.join(args.parent, "cmblensing_tpu_torch", "csrc")
        jobs.append(build("parent", os.path.join(pcsrc, "lenseflow.cu")))
        jobs.append(build("k1_parent", os.path.join(pcsrc, "fderiv_sm90.cu"), ["LF_CLOCK_PHASES"]))
    for out, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(log)
            raise RuntimeError(f"nvcc failed building {out}")
    P, I = ctypes.c_void_p, ctypes.c_int
    fd = [I, P, P, P, P, P, P, P, P, I, I, I, I, I, P]
    dd = [I, P, P, P, P, P, P, I, I, I, P]
    probe = {"lf_phase_ticks_read": [P], "lf_phase_ticks_clear": []}
    fa = [I, I, P, P, P, P, P, P, P, I, I, I, I, I, I, P]
    k1 = load(jobs[0][0], {"lf_fderiv_sm90_probe": fd, "lf_fderiv_sm90_init": [], **probe})
    k2 = load(jobs[1][0], {"lf_deriv": dd, "lf_dense_init": [], **probe})
    k3 = load(jobs[2][0], {"lf_fa_sm90_probe": fa, "lf_fa_sm90_init": [], **probe})
    parent = load(jobs[3][0], {"lf_deriv": dd, "lf_dense_init": []}) if args.parent else None
    k1p = (load(jobs[4][0], {"lf_fderiv_sm90_probe": fd, "lf_fderiv_sm90_init": [], **probe})
           if args.parent else None)
    assert k1p is None or k1p.lf_fderiv_sm90_init() == 0
    assert k1.lf_fderiv_sm90_init() == 0 and k2.lf_dense_init() == 0
    assert k3.lf_fa_sm90_init() == 0
    assert parent is None or parent.lf_dense_init() == 0
    ptr, stream = lfk._ptr, lfk._stream

    for N in args.N:
        B = N // 128
        ops = deriv.deriv_ops(ct.ProjLambert(N, N, thetapix=2, T=np.float32, device="cuda"))
        a = torch.randn((1, 1, N, N), device="cuda")
        out = torch.empty_like(a)
        nc = 4 if B == 32 else 2   # csrc/fact_sm90.cuh: cluster_ctas (K1), velocity_ctas (K3)
        nc3 = 1 if B == 8 else nc
        for tier, name in ((1, "'high'"), (2, "'bf16'")):
            for axis in ("x", "y"):
                x, y = (a, None) if axis == "x" else (None, a)
                run = lambda: k1.lf_fderiv_sm90_probe(
                    tier, ptr(x), ptr(y), None, ptr(out), ptr(ops.FXW), ptr(ops.FYTW),
                    ptr(ops.bfx), ptr(ops.bfy), B, B, 1, N, N, stream())
                show(f"K1 {name} d_{axis} {N}^2 (radix {B}, {nc} CTAs a cluster)",
                     ticks(k1, run, N // 16 * nc, torch), K1_PHASES)
            if k1p is None:
                continue
            forms = {f: (lambda o, x_, lib=lib: lib.lf_fderiv_sm90_probe(
                tier, ptr(x_), None, None, ptr(o), ptr(ops.FXW), ptr(ops.FYTW), ptr(ops.bfx),
                ptr(ops.bfy), B, B, 1, N, N, stream())) for f, lib in (("port", k1), ("parent", k1p))}
            outs = {f: torch.empty_like(a) for f in forms}
            for f in forms:
                forms[f](outs[f], a)
            torch.cuda.synchronize()
            e = float((outs["port"] - outs["parent"]).abs().max() / outs["parent"].abs().max())
            times = {f: [] for f in forms}
            for r in range(args.rounds):
                for f in (("port", "parent") if r % 2 == 0 else ("parent", "port")):
                    times[f].append(cs.cold_ms(forms[f], (outs[f], a), 20, torch))
            print(f"K1 {name} d_x {N}^2: port vs parent relative max-abs {e:.3e}; cold ms in "
                  f"{args.rounds} rounds of turns: " + "; ".join(
                      f"{f} {', '.join(f'{v:.4f}' for v in t)} (median {float(np.median(t)):.4f})"
                      for f, t in times.items()) + f" [{card}]")
        y = torch.randn((1, 2, N, N), device="cuda")
        p = 0.1 * torch.randn((2, 1, N, N), device="cuda")
        k = torch.empty_like(y)
        for tier, name in ((0, "strict"), (1, "'high'"), (2, "'bf16'")):
            if lfk.FORMS["fa", lfk.PRECISIONS[tier], B] != "cluster":
                continue   # K3 runs fact_tile there: no cluster form is built
            WX, WYT = (ops.FX, ops.FYT) if tier == 0 else (ops.FXW, ops.FYTW)
            for role, kind in ((0, "forward"), (1, "adjoint")):
                run = lambda: k3.lf_fa_sm90_probe(
                    tier, role, ptr(y), ptr(k), ptr(p), ptr(WX), ptr(WYT), ptr(ops.bfx),
                    ptr(ops.bfy), B, B, 1, 2, N, N, stream())
                show(f"K3 {name} {kind} {N}^2 (2 components, x and y pass; radix {B}, {nc3} CTAs "
                     "a cluster)", ticks(k3, run, 2 * 2 * N // 16 * nc3, torch), K1_PHASES)
        del ops, a, out, y, p, k
        torch.cuda.empty_cache()

    shapes = ((3, 256, 256), (1, 200, 200), (1, 160, 200), (1, 600, 600))
    for n, Ny, Nx in shapes:
        mats = deriv.deriv_mats(ct.ProjLambert(Ny, Nx, thetapix=3, T=np.float32, device="cuda"))
        DxT, Dy = (M.to(torch.bfloat16) for M in mats)
        x = torch.randn((n, Ny, Nx), device="cuda")
        out = torch.empty_like(x)
        rows, sms = -(-Ny // 32) * n, torch.cuda.get_device_properties(0).multi_processor_count
        # the tile width lenseflow.cu::deriv_bf16 picks
        tn = 64 if 2 * rows * -(-Nx // 64) >= sms else 32
        nblocks = rows * -(-Nx // tn)
        show(f"K2 'bf16' d_x {n} x {Ny}x{Nx} (32 x {tn} tiles)",
             ticks(k2, lambda: k2.lf_deriv(2, ptr(x), None, None, ptr(out), ptr(DxT), ptr(Dy),
                                           n, Ny, Nx, stream()), nblocks, torch), K2_PHASES)
        forms = {"port": lambda o, x_: lfk.deriv_cuda(x_, None, None, o, mats, "bf16"),
                 "library": None}
        if parent is not None:
            forms["parent"] = lambda o, x_: parent.lf_deriv(2, ptr(x_), None, None, ptr(o),
                                                            ptr(DxT), ptr(Dy), n, Ny, Nx,
                                                            stream())
            ref = torch.empty_like(out)
            forms["parent"](ref, x)
            forms["port"](out, x)
            torch.cuda.synchronize()
            print(f"K2 'bf16' d_x {n} x {Ny}x{Nx}: port vs parent, relative max-abs "
                  f"{float((out - ref).abs().max() / ref.abs().max()):.3e}")
        times = {k: [] for k in forms}
        order = list(forms)
        for r in range(args.rounds):
            for k in (order if r % 2 == 0 else order[::-1]):
                times[k].append(cs.library_bf16_ms(x.reshape(-1, Nx), mats[0], torch)[0]
                                if k == "library" else cs.cold_ms(forms[k], (out, x), 20, torch))
        print(f"K2 'bf16' d_x {n} x {Ny}x{Nx}, cold ms in {args.rounds} rounds of turns: "
              + "; ".join(f"{k} {', '.join(f'{v:.4f}' for v in t)} (median "
                          f"{float(np.median(t)):.4f})" for k, t in times.items())
              + f"; port < library in {sum(p < q for p, q in zip(times['port'], times['library']))}"
              f" of {args.rounds} rounds [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
