"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written LenseFlow kernels from csrc/ into build/, holds
each against its plain PyTorch version on the card, and drives the
port's two paths through the kernel backend:

  phases 2-4  the mixed-posterior phi-gradient of a 256^2 pol-P
              simulation (LenseFlow nsteps=7) on the dense kernels (one
              launch a flow, csrc/dense_flow.cu; the derivative,
              csrc/lenseflow.cu), checked against the plain backend and
              timed;
  phases 5-7  at 1024^2 P (thetapix 2): the factored kernels
              (csrc/factored.cu) and whole flows against their plain
              versions, the phi-gradient against the plain backend, and
              MAP_joint as scripts/map_1024.py runs it (grid line search,
              15 fixed CG iterations, 2 warm-up steps then 6 timed),
              with one step on the plain backend beside it;
  phase 8     the same 1024^2 P path on the "uni" backend: the universal
              role-switched kernel K5 (csrc/uni.cu), each role at batch 1
              and 17 against its plain version, the uni flows against
              their plain versions and the K3/K4 flows, the phi-gradient
              against the kernel backend, and MAP_joint as in phase 7.
  phase 9     the 'high' tier at 1024^2 P (bf16 head/residual split on the
              tensor cores): K1, K3 (batch 1 and 17) and K4 against their
              plain 'high' versions and the strict kernels, the 'high'
              flows, the phi-gradient under precision_ctx("high") against
              the strict one, argmaxf_logpdf at the JAX default CG and
              "auto" against strict, and MAP_joint as scripts/map_1024.py
              runs it at its default precision "auto".
  phase 10    the dense kernels' ragged edge tiles: K2's derivative, p(t)
              and the RK4 update at 200^2, 160 x 200 and 600^2, every
              tier, against their plain versions, and one L @ f on a
              200^2 load_sim against the plain backend.
  phase 11    K2 'high' at 256^2 P (nsteps 7): the derivative against its
              plain 'high' version and the strict kernel, the 'high'
              flows, the phi-gradient at 'high' against strict, and two
              steps of MAP_joint at its default "auto".
  phase 12    the slice: K2's 'high' derivative on its three-component (I,
              Q, U) inputs against plain 'high' and strict; the Wiener filter
              (argmaxf_logpdf at the JAX defaults, "auto") on a masked,
              beamed 256^2 T+EB (pol IP) simulation, against the strict
              solve; at 20 fixed iterations the kernel backend against the
              plain one (strict) and against the "matmul" one ('high').
  phase 13    the large maps, K1, K3 and K4 at radix 16 (2048^2) and 32
              (4096^2) on the cluster tile: (a) each kernel at both tiers
              against its plain versions (K3 also at batch 17), the whole
              4096^2 flows at both tiers; (b) the strict phi-gradient
              at 2048^2 and 4096^2, kernel and plain backends, each
              against the same evaluation with its flows in float64;
              (c) a strict
              MAP_joint step at 2048^2 P on the kernel and the plain
              backends, the line search's memory per trial, one step at
              "auto"; (d) MAP_joint at 4096^2 P at "auto" as
              scripts/map_4096.py runs it (1 warm-up and 2 timed steps:
              s/step, peak memory, rho_b), and L @ f at 640^2 (dense)
              against the plain backend.
  phase 14    the 'bf16' tier (one bf16 product of the rounded operands):
              (a) K1, K3 (batch 1 and 17) and K4 at 1024^2 against plain
              'bf16' and the strict kernels, with the library call of K1's
              d_x; (b) K2's derivative at 256^2 on the masked IP slice's (I,
              Q, U) inputs and at 200^2 (edge tiles); (c) K1, K3, K4 at 2048^2
              and 4096^2, each launched twice, bit for bit, and there one
              MAP_joint(precision="bf16") step and a two-iteration Wiener
              filter at 'bf16'; (d) the 1024^2 flows; (e) the
              1024^2 phi-gradient against strict and the plain 'bf16'
              backend; (f) MAP_joint(precision="bf16") as in phase 7,
              beside phases 7 and 9, and argmaxf_logpdf at 1024^2; (g) the
              masked 256^2 IP Wiener filter at hessian_precision="bf16"
              against the strict solve (phase 12's in a whole run).
  phase 15    K5 at 'high' and 'bf16' and with dense operands
              (csrc/uni.cu, csrc/uni_dense.cu), and the "uni" backend at the
              JAX defaults: (a) K5 'high' and 'bf16' at 1024^2 (radix 8),
              every role at batch 1 and 17 against plain at the tier and
              the strict kernel, timed cold; (b) the dense K5 at every tier
              on the 256^2 P inputs, the masked IP slice's I, Q, U, the edge
              tiles and 768^2 P, nothing written past a plane; (c) the uni
              flows at 'high' and 'bf16' against the plain uni flows and
              K3/K4 (1024^2) or K2 (256^2); (d) the phi-gradient on "uni"
              against the kernel backend at every tier, 256^2 and 1024^2 P;
              (e) MAP_joint 1024^2 P on "uni" at "auto" and 'bf16' as in
              phase 7, beside phases 8, 9 and 14 (f), with no K3/K4 launch;
              (f) the masked 256^2 IP Wiener filter on "uni" at the JAX
              defaults against the kernel backend, and 20 fixed strict
              iterations (the kernel backend's solves phase 12's in a whole
              run); (g) L @ f on a 768^2 P load_sim on "uni", strict
              and 'high', against the kernel backend.
  phase 16    K5 at radix 16 (2048^2) and 32 (4096^2) on the cluster tile
              (csrc/uni_sm90.cu) and the "uni" backend there: (a) every role at
              every tier at batch 1 (and 17 at 2048^2) against plain at the
              tier and the strict kernel, twice the same bits, nothing past
              a plane, timed cold; (b) the uni flows at every tier against
              K3/K4's (bit for bit) and, at 2048^2, the plain uni flows;
              (c) the strict phi-gradient on "uni" against "kernel" at both
              sizes ('bf16' too at 4096^2); (d) MAP_joint 2048^2 P on "uni"
              strict beside "kernel", at "auto" and 'bf16', the line
              search's memory per trial, and at 4096^2 P "auto" as phase
              13 (d) but one timed step; no K3/K4 launch on "uni".
  phase 17    the kernels on the cluster tile (csrc/fact_sm90.cuh: one
              launch a pass, the channel groups the CTAs of one cluster) at
              512^2, 1024^2, 2048^2 and 4096^2: (a) K1 at 'high' and 'bf16'
              (csrc/fderiv_sm90.cu), d_x, d_y and d_x + d_y + c at batch 1
              and on 5 planes, timed cold beside the strict kernel and the
              library call, one launch a pass counted on the backward
              flow's delta phi; (c) K3 at 'high' and 'bf16' on the tile
              lenseflow_kernels.FORMS puts them on at each radix (the
              cluster tile, csrc/fa_sm90.cu, or fact_tile) and strict on
              the cluster tile at radix 16 and 32, both roles at batch 1
              and (to 1024^2) 17 trials, timed cold beside the strict
              kernel, one launch a pass counted on the forward and adjoint
              flows; (d) K5 the same way (csrc/uni_sm90.cu or csrc/uni.cu),
              every role and stage on strided views of a flow state at
              batch 1 and (to 1024^2) 17 trials, timed cold (at 2048^2
              and 4096^2 in a whole run phase 16 (a)'s check of the same
              inputs, not re-run), two launches a stage counted on the uni
              flows; the reduced tiers' flows at
              nsteps 1 and 7, to 1024^2 against their plain versions
              (flow_checks); each kernel against plain at the tier (and a
              reduced tier against the strict kernel),
              the same bits into buffers of NaN, 1e30 and 0, nothing past a
              plane, K5's zero planes exact; (b) K2's 'bf16' derivative on
              the masked IP slice's I, Q, U planes and at 200^2, 160 x 200,
              600^2, held at 1e-5 of plain 'bf16', timed cold beside the
              library call, its launches counted on the slice's backward
              flow; (e) K4 at every tier (csrc/bv_sm90.cu: the velocity's
              derivatives in turn inside one launch a pass, u = M^-1 w in
              the y pass's store) and strict K1 (csrc/fderiv_sm90.cu's FP32
              tier, with (a); its one form) on the tile FORMS puts them on,
              the cluster tile at radix 16 and 32: each against its plain
              version at the tier (and a reduced tier against strict), the
              same bits into buffers of NaN, 1e30 and 0, nothing past the
              last entry, K4's k_f and k_df bit for bit K5 role 0's, timed cold
              beside the parent's time (PARENT_MS), one launch a pass
              counted on the backward flow at the tier (nsteps 7; at
              512^2 held to its plain version, delta phi at 'bf16' to
              DPHI_BF16_TOL). Its numbers are the
              kernels' one record a size: at the sizes an earlier phase
              records (K1, K3 and K4 in phases 5, 9 and 13, K1, K2, K3 and
              K4 'bf16' in phase 14, K5 in phases 15 and 16) the record
              keeps that phase's name and path launches and takes this
              phase's numbers, source and form.
  phase 18    K2, one launch a whole dense LenseFlow flow
              (csrc/dense_flow.cu: the RK4 stages, p(t) and the update
              inside, grid-wide barriers between stages), every kind and
              tier at 256^2 P, the IP slice's 3 x 256^2, 200^2, 160 x 200
              and 600^2, nsteps 7: against the plain leaves walking the
              same stage table (FLOW_TIER_TOL, and at 'high' and 'bf16'
              FLOW_SPLIT_RATIO), the same bits twice, one launch a flow;
              3 entries in one launch bit for bit the single flows; timed
              warm and cold (and 17 entries at 256^2 P) beside the bound.
  phase 19    BASELINE.json configs[3], the port's batched sims and Gibbs/HMC
              sampler: (a) load_sim(thetapix=2, Nside=512, pol="P",
              Nbatch=32), one warm-up and two timed sample_joint passes at
              scripts/sample_512_batched.py's settings (N = 25 leapfrog
              steps of eps 0.003, 3 burn-in steps always accepted, CG 25
              fixed iterations, strict) on the factored kernels at radix 4
              (K1, K3, K4, rk4 and p each launched in the timed run): s/pass
              and its split by pass, accept, dH, every logpdf finite, peak
              memory, launches a pass; (b) the kernels at the path's shapes
              (32 sims x 2 components): phi's planes and the L, L^-1, L^H
              and backward flows (nsteps 1) of the last state against their
              plain versions; (c) one pass at 2 sims with N = 3 on
              the kernel backend against the plain one from one generator
              seed (always accepted: phi carries the HMC trajectory; the
              accept each dH gives compared).
  phase 20    BASELINE.json configs[4], the ensemble pipelines at 256^2 P on
              the dense flow kernel: (a) bandpower MUSE as
              scripts/muse_bandpower.py runs it at N = 256, pol P (4 bins, 8
              sims a draw, 4 steps, MAP 5 steps, CG 20 fixed, "auto", the
              final H: 4 data MAPs and 17 batched MAPs over 8 sims): s/run,
              its split, per-bin estimates, sigmas and pulls (each under 4),
              the joint chi2, H invertible, Sigma positive definite, every
              score finite, peak memory, launches; (b) the batched EB
              quadratic estimate of the data and 8 sims at the last theta,
              each entry its unbatched estimate, ms, corr with each sim's
              phi; (c) MAP_marg as scripts/map_marg_256.py runs it (16 sims,
              10 steps, CG 25 fixed, alpha 0.2): s/step, the gradient norm
              of each step, corr with phi; (d) K2's whole flow at every kind
              and tier at 8 and 17 x 8 entries on the path's fields, and its
              derivative on the path's phi, against their plain versions,
              timed at 8; (e) one batched MAP_joint step and the MUSE
              theta-scores at 2 sims, kernel against plain.
  phase 21    the rest of load_sim's and MAP_joint's options at 1024^2 P
              (scripts/map_1024.py's simulation, phase 7's in a whole run),
              on the factored kernels, no kernel of its own: (a) MAP_joint
              with a weak logprior (so brent), 4 steps at "auto", CG 15
              fixed: s/step, brent's evaluations a step, alpha > 0 first, a
              finite non-decreasing logpdf, every kernel of the path
              launched; one strict brent step from one f-step on the kernel
              and the plain backends (alpha within 10 alpha_tol along one
              direction, logpdf 1e-6); (b) nburnin_update_hessian=2 over 6
              steps beside the grid run without it, corr(phi, phi_true) >=
              0.9 each; (c) quasi_sample, 3 steps, finite logpdfs; (d)
              load_nolensing_sim and its MAP_joint, f equal to
              argmaxf_logpdf's, CG iterations and ms; (e) PowerLens(phi, 4),
              Taylens(phi, 4) and BilinearLens(phi) against LenseFlow,
              BilinearLens's adjoint identity and solve residual,
              get_max_lensing_step, each on the card against the CPU on the
              same inputs and against the CPU in float64, and the
              phi-gradient of logpdf on load_sim(L=BilinearLens) the same
              way; (f) load_sim with every keyword passed at its default
              value: the default dataset's d and operators bit for bit.
  phase 22    the curved sky and the rest of the field API, no kernel of
              its own: (a) an EquiRect band of 256 rings x 1024 pixels, 34
              degrees across, lmax 2000: Cl_to_Cov_EquiRect at I and P
              (the blocks' build time, every block finite, the Legendre
              two-point identity at three pixel pairs to 1e-4 in float64);
              (b) sqrt (S S against C), pinv, solve(C @ f), logdet, timed;
              (c) the Wiener filter of a NoLensingDataSet on those blocks
              and white noise of 3 muK-arcmin (argmaxf_logpdf, CG tol 1e-4,
              at most 500 iterations) and sample_f, peak memory; (d) the
              band at 32 x 128, lmax 1100 (orders past the JAX package's
              overflow at |m| = 1024), card against CPU: blocks and Wiener
              filter within 1e-4; (e) HEALPix nside 2048 to the 1024^2
              patch and to (a)'s band and back, bilinear and 'fft', I and
              QU (Projector build, ms, round-trip error), card against CPU
              (bilinear at nside 2048, 'fft' at nside 512); (f) ud_grade of
              a 1024^2 P field to 512^2 and 2048^2 in both modes (card
              against CPU), the magnification matrix of the 1024^2 path's
              phi against the K1 planes, get_Dl.

    python3 chip_smoke.py --phase 13    (phase 1, the build, and phase 13 alone)
    python3 chip_smoke.py --phase 14    (phase 1, the build, and phase 14 alone)
    python3 chip_smoke.py --phase 15    (phase 1, the build, and phase 15 alone)
    python3 chip_smoke.py --phase 16    (phase 1, the build, and phase 16 alone)
    python3 chip_smoke.py --phase 17    (phase 1, the build, and phase 17 alone)
    python3 chip_smoke.py --phase 18    (phase 1, the build, and phase 18 alone)
    python3 chip_smoke.py --phase 19    (phase 1, the build, and phase 19 alone)
    python3 chip_smoke.py --phase 20    (phase 1, the build, and phase 20 alone)
    python3 chip_smoke.py --phase 21    (phase 1, the build, and phase 21 alone)
    python3 chip_smoke.py --phase 22    (phase 1, the build, and phase 22 alone)

Phases 13, 14 (c) and 16 take one 4096^2 P simulation (load_sim is
seeded), loaded once in a whole run. Phases 7 and 8 measure the strict
north star (precision=None); phases
2-6 and 10 run at the global precision 'f32', and every tier in 10.

Each path's launch counters are set to 0 just before it and read just
after; the records of phases 13-16 name, under "path", the run their
launches come from. A kernel's time is device time: its launches captured into a CUDA
graph and the replay timed by CUDA events (the host's launch cost, about
0.04 ms a call, would hide a shorter kernel), and so is the library
call's. Phase 9's kernels (both tiers, and the library call) and phase
5's p(t) and RK4 update are timed cold: the replay goes round copies of
their buffers that together hold twice the L2, so that what a launch
reads comes from HBM (cold_ms); the other kernels are replayed on one
set of buffers, which the L2 holds where they fit in it. Plain versions
and whole flows, gradients and steps are timed as they run. Exits non-zero, printing no result line, when there is no CUDA
card or any phase fails.

The last two lines of stdout are the per-kernel JSON record and
{"ok": true, "device": {...}}; the card's name and power limit come on a
line before them. Each kernel's record holds its time, its plain
version's, the time of one PyTorch call computing the same function
where there is one (strict FP32 `a @ DxT` for a derivative pass), and
its bound: the larger of its derivative FLOPs over the card's FP32 peak
and the bytes it must move over its memory rate; for a 'high' kernel the
larger of its three bf16 products' FLOPs over the bf16 tensor-core peak
plus its FP32 work (butterflies, split) over the FP32 peak, and its
bytes over the memory rate; for a 'bf16' kernel the same with its one
bf16 product, and the library call is one bf16 matmul with float32
output.
"""
import contextlib
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
# the 1024^2 gradient: the same bound until a measurement says otherwise
GRAD_TOL_1024 = 1e-4
# grad/Hess(phi) at 1024^2, thetapix 2: l_max is 6x the 256^2 headline's,
# and the Hessian planes differentiate the gradient planes' float32
# rounding once more, so their float32 error grows with it: on an H100
# the kernel's planes lay 4.6e-4 and the plain version's 3.4e-4 from
# float64, and 5.2e-4 from each other
HESS_TOL_1024 = 2e-3
N, NSTEPS, SEED = 256, 7, 0
DEVICE = "cuda"
N_MAP, THETAPIX_MAP = 1024, 2          # scripts/map_1024.py
MAP_CG = dict(tol=0.0, nsteps=15, fixed_iters=True)
MAP_WARM, MAP_STEPS = 2, 6
NTRIAL = 17            # the grid line search's batch: alpha = 0 and 16 trials
CORR_MIN = 0.9
# kernels of each path: every one must launch in its run
DENSE_KERNELS = ("flow_forward", "flow_adjoint", "flow_backward", "deriv")
FACTORED_KERNELS = ("fderiv", "fa_velocity_forward", "fa_velocity_adjoint", "bv_velocity",
                    "rk4_update", "p_planes")
UNI_KERNELS = ("uni_role0", "uni_role1", "uni_role2", "uni_role3", "fderiv", "rk4_update",
               "p_planes")
# the un-hoisted delta phi (integrated in the uni flow's state) against
# the hoisted one and a float64 evaluation: one more summation order over
# 4 nsteps stages of 6 derivatives
DPHI_UNHOISTED_TOL = 1e-4
# H100 SXM data sheet: FP32 outside the tensor cores, dense bf16 on them, HBM3;
# its L2 cache
FP32_PEAK, BF16_PEAK, HBM_RATE = 67e12, 989e12, 3.35e12
L2_BYTES = 50 * 2 ** 20
# a 'high' kernel against its plain 'high' version: the same split of the
# same FP32 values, but a butterflied channel value one ulp apart between
# the two summation orders may round its bf16 head the other way, moving
# its residual's rounding by ~2^-17 of the value; against the strict
# kernel, the split's operator error (~2^-17 per product term, summed)
HIGH_TOL, HIGH_VS_STRICT = 2e-5, 1e-3
# ... and what tells a 'high' kernel from a strict one, or from a split
# rounded otherwise than to nearest even: per plane in relative Frobenius
# norm, its distance to the plain 'high' version over its distance to the
# strict kernel. The two 'high' forms differ only where a channel value's
# residual rounds the other way (about one value in 128 of those whose
# butterfly sums differ by an ulp), while the split's own error touches
# every value: on the CPU a butterfly summed in another order gives 0.09
# (512^2) and 0.14 (1024^2), a truncating split 1.05, a split without the
# operand's residual 1.00, strict FP32 infinity
# (tests/test_torch_high.py::test_split_ratio_tells_the_rne_split_apart)
HIGH_SPLIT_RATIO = 0.5
# a whole flow adds the RK4 sums' FP32 reassociation to both distances, so
# its ratio lies nearer 1; held only to be nearer its plain 'high' version
# than the strict flow (a flow on strict kernels gives infinity)
FLOW_SPLIT_RATIO = 1.0
# f of the 'high' Wiener filter against the strict one, in norm: the
# inexact-Krylov bound of tests/test_inference.py:267 (the 'bf16' one's too)
WF_HIGH_TOL = 1e-3
# a 'bf16' kernel against its plain 'bf16' version: a dense one rounds the
# same operands (only the FP32 sums differ); a factored one's plain
# butterfly repeats the tile's fused multiply-adds, but a channel value
# formed in another order may round to the neighbouring bf16 value (a bf16
# ulp is 3.9e-3 of it), and so may a flow's state; every plane also held,
# in relative Frobenius norm, under HIGH_SPLIT_RATIO (kernels) or
# FLOW_SPLIT_RATIO (flows, gradients) of its distance to strict
BF16_DENSE_TOL, BF16_TOL = 1e-5, 2e-3
BF16_KERNELS = ("fderiv_bf16", "fa_velocity_forward_bf16", "fa_velocity_adjoint_bf16",
                "bv_velocity_bf16")
# each tier's bound against its plain version for the dense kernels
DENSE_TIER_TOL = {"f32": FLOW_TOL, "high": HIGH_TOL, "bf16": BF16_DENSE_TOL}
HIGH_KERNELS = ("fderiv_high", "fa_velocity_forward_high", "fa_velocity_adjoint_high",
                "bv_velocity_high")
DENSE_HIGH_KERNELS = ("flow_forward_high", "flow_adjoint_high", "flow_backward_high",
                      "deriv_high")
# phase 15, K5 at every tier and form: the planes each role writes (the
# rest are 0) and its derivatives per entry
UNI_NONZERO, UNI_NDER = {0: 4, 1: 1, 2: 2, 3: 2}, {0: 4, 1: 6, 2: 4, 3: 4}
# K5 against its plain version at each tier, factored and dense, as the
# other kernels at that tier; role 1 at 'bf16' takes BF16_TOL in either
# form: its outer products round the inner stage's sums, which kernel and
# plain form in other orders, and a sum one ulp apart may round to the
# neighbouring bf16 value (dense 2.0e-4 on the card, tests/test_torch_cuda.py)
UNI_TOL = {"f32": FLOW_TOL, "high": HIGH_TOL, "bf16": BF16_TOL}
UNI_DENSE_TOL = {"f32": FLOW_TOL, "high": HIGH_TOL, "bf16": BF16_DENSE_TOL}
# ... and role 1's Frobenius ratio at 'high' and 'bf16' to FLOW_SPLIT_RATIO,
# as a flow's: those reassociated inner sums move both of its distances (at
# 'high', 0.44-0.47 at 512^2 and 1024^2, 0.62 at 600^2, 0.74 at 768^2 on the
# card; the other roles 0.04-0.24)
UNI_RATIO = {0: HIGH_SPLIT_RATIO, 1: FLOW_SPLIT_RATIO, 2: HIGH_SPLIT_RATIO, 3: HIGH_SPLIT_RATIO}
# delta phi of the uni backward flow (integrated in the state) against the
# kernel backend's (hoisted) at a tier: at 'high' the two forms' strict
# bound; at 'bf16' tests/test_torch_bf16.py's DPHI_TOL (the same operator
# rounded at other places)
DPHI_BF16_TOL = 5e-3   # tests/test_torch_bf16.py:72, DPHI_TOL
UNI_DPHI_TOL = {"high": DPHI_UNHOISTED_TOL, "bf16": DPHI_BF16_TOL}
# the JAX package's dense-K5 territory: no built radix divides 768 (radix
# 6), and `_flow_fits` fails there, so `_uni_call` runs on dense mats
N_DENSE_UNI = 768
# plane shapes the dense kernels' 32 x 32 tile and 16-deep slab do not
# divide: load_sim(Nside=200), a rectangle, and 600^2 (dense, since the
# factored radix needs 128 | N)
EDGE_SHAPES = ((200, 200), (160, 200), (600, 600))
# the slice: examples/03_joint_MAP.py's masked, beamed configuration at
# pol IP and 256^2
WF_SIM = dict(thetapix=3, Nside=256, pol="IP", T=np.float32, muKarcminT=1, beamFWHM=2,
              pixel_mask_kwargs=dict(edge_padding_deg=1, apodization_deg=0.5), seed=SEED)
# f of the kernel backend's strict solve against the plain backend's at 20
# fixed iterations, in norm: CG amplifies the operators' float32 differences
# (1e-5 per flow) by its iteration count at most
WF_PLAIN_TOL = 1e-4
FA = 128               # the factored derivative's block size (ops/deriv.py::FACTOR_A)
# where K1 (strict), K3 and K4 on fact_tile are written, every tier
# (factored.cu, factored_high.cu and factored_bf16.cu instantiate them),
# the form FORMS names at radix 4 and 8 where it won its A/B; on the
# cluster tile they are FDERIV_SM90_SRC, FA_SM90_SRC and BV_SM90_SRC
FACTORED_SRC = "cmblensing_tpu_torch/csrc/factored_kernels.cuh"
# phase 13, the large maps: MAP_joint as scripts/map_4096.py runs it
# (load_sim(thetapix=2, Nside=N, pol="P", T=float32, seed=0), grid line
# search, 15 fixed CG iterations) at 2048^2 (radix 16) and 4096^2 (radix
# 32); at 4096^2 1 warm-up step and 2 timed at the JAX default "auto"
N_LARGE = (2048, 4096)
LARGE_WARM, LARGE_STEPS = 1, 2
# ... on "uni" (phase 16 (d)) one timed step: the smoke's time budget
UNI_LARGE_STEPS = 1
# the bandpower bins of scripts/map_4096.py:184
RHO_LEDGES = np.array([2, 100, 200, 350, 500, 750, 1000, 1500, 2000, 3000, 4500, 6000])
# a strict MAP_joint step on the kernel backend against the plain one:
# alpha and logpdf, relative
STEP_TOL = 1e-6
# L @ f at 640^2 (the dense circulant, radix 5 not being built) against
# the plain backend: both float32 forms lie 1.7e-5 to 1.9e-5 from float64
# there (tests/test_torch_large_maps.py)
FLOW640_TOL = 5e-5
# phase 17: K1 at 'high' and 'bf16' redesigned (one launch a pass, its
# channel groups the CTAs of a cluster) at every built radix, at batch 1 and
# on NPLANES_SM90 planes, held to each tier's bounds above; and K2's 'bf16'
# derivative redesigned, on the masked IP slice's planes and at the edge
# shapes, held to BF16_DENSE_TOL
FDERIV_SM90_SRC = "cmblensing_tpu_torch/csrc/fderiv_sm90.cu"
N_SM90 = (512, 1024, 2048, 4096)
NPLANES_SM90 = 5
K1_SM90_TOL = {"high": HIGH_TOL, "bf16": BF16_TOL}
# ... and K3 and K5 at 'high' and 'bf16' on the tile lenseflow_kernels.FORMS
# puts them on (the cluster tile, csrc/fact_sm90.cuh, at radix 16 and 32),
# strict where that is the cluster tile, at every built radix, at batch 1
# and (to 1024^2; phases 13, 14 and 16 run them at 2048^2) NTRIAL trials,
# held to the same bounds (strict: FLOW_TOL; K5: uni_roles), the same bits
# in buffers of NaN, 1e30 and 0
FA_SM90_SRC = "cmblensing_tpu_torch/csrc/fa_sm90.cu"
UNI_SM90_SRC = "cmblensing_tpu_torch/csrc/uni_sm90.cu"
N_SM90_BATCHED = 1024   # the largest size phase 17 runs NTRIAL trials and flows vs plain at
# ... and (e) K4 at every tier and strict K1 on the tile FORMS names (the
# cluster tile at radix 16 and 32: csrc/bv_sm90.cu, csrc/fderiv_sm90.cu),
# timed beside their parent's cold ms, fact_tile in ordered channel-group
# launches at 16 and 32 (PERF.md §6; NVIDIA H100 80GB HBM3, 700 W): K4
# ("bv", tier, N), strict K1 d_x and d_y ("fderiv", axis, N)
BV_SM90_SRC = "cmblensing_tpu_torch/csrc/bv_sm90.cu"
PARENT_MS = {("bv", "f32", 1024): 0.3459, ("bv", "high", 1024): 0.2572,
             ("bv", "bf16", 1024): 0.2382, ("bv", "f32", 2048): 1.306,
             ("bv", "high", 2048): 1.114, ("bv", "bf16", 2048): 1.016,
             ("bv", "f32", 4096): 8.788, ("bv", "high", 4096): 7.968,
             ("bv", "bf16", 4096): 7.631, ("fderiv", "x", 1024): 0.0305,
             ("fderiv", "y", 1024): 0.0291, ("fderiv", "x", 2048): 0.0870,
             ("fderiv", "y", 2048): 0.0804, ("fderiv", "x", 4096): 0.6168,
             ("fderiv", "y", 4096): 0.5277}

# phase 18: K2, one launch a whole dense flow (csrc/dense_flow.cu), every
# kind and tier, against its plain version (the plain dense leaves walking
# the same stage table) at PERF.md §2's bounds for a flow at the tier, and
# at a reduced tier nearer its plain version than the strict flow
# (FLOW_SPLIT_RATIO), on the shapes the dense path gives it: 256^2 P, the IP
# slice's 3 x 256^2, the edge shapes; FLOW_BATCH entries in one launch bit
# for bit the single flows'; timed warm (a CUDA graph's replay on one set of
# buffers, which the L2 holds) and cold (cold_ms), and at NTRIAL entries
DENSE_FLOW_SRC = "cmblensing_tpu_torch/csrc/dense_flow.cu"
FLOW_TIER_TOL = {"f32": FLOW_TOL, "high": HIGH_TOL, "bf16": BF16_TOL}
FLOW_BATCH = 3
# name -> (Ny, Nx, components); the cases timed (and, with 256P's batch of
# NTRIAL, printed for PERF.md)
FLOW_CASES = {"256P": (N, N, 2), "256IP": (N, N, 3), "200": (200, 200, 2),
              "160x200": (160, 200, 2), "600": (600, 600, 2)}
FLOW_TIMED = ("256P", "256IP", "200", "600")
# phase 19: BASELINE.json configs[3], sample_joint over 32 sims at 512^2 P as
# scripts/sample_512_batched.py runs it (load_sim(thetapix=2, Nside=512,
# pol="P", Nbatch=32, seed=0); N = 25 leapfrog steps of eps 0.003; 3
# always-accepted burn-in steps; CG 25 fixed iterations, strict): one
# warm-up pass, then SAMPLE_PASSES timed
N_SAMPLE, SAMPLE_SIMS, SAMPLE_PASSES, SAMPLE_NBURNIN = 512, 32, 2, 3
SAMPLE_SYMP = [dict(N=25, eps=0.003)]
SAMPLE_CG = dict(tol=0.0, nsteps=25, fixed_iters=True)
# the kernels a strict pass at radix 4 runs: K1 (phi's planes, delta phi),
# K3 (L, L^H, L^-1), K4 (the HMC gradients' backward flows), rk4 and p
SAMPLE_KERNELS = ("fderiv", "fa_velocity_forward", "fa_velocity_adjoint", "bv_velocity",
                  "rk4_update", "p_planes")
# ... and one pass at 2 sims with N = 3 on "kernel" against "plain" from one
# generator seed, always accepted so that phi carries each HMC trajectory
# (tests/test_torch_cuda.py::test_gibbs_pass_kernel_matches_plain_on_card):
# f, phi and the logpdf within GIBBS_PLAIN_TOL (25 fixed CG iterations
# amplify the flows' 1e-5, as WF_PLAIN_TOL's 20 do), dH within GIBBS_DH_ATOL
# (float32 Hamiltonians of ~6e6 a sim, whose ulp is 0.5: 8 ulps; measured
# 1.5 on an H100), and the accept each dH gives, log u < dH, the same
# wherever log u lies farther than that from dH
GIBBS_PLAIN_TOL, GIBBS_DH_ATOL = 1e-4, 4.0
# phase 20: BASELINE.json configs[4], the ensemble pipelines at 256^2 P on the
# dense flow kernel. (a) bandpower MUSE as scripts/muse_bandpower.py runs it at
# N = 256, pol P (scripts/torch_muse_256.py): load_sim(thetapix=3, Nside=256,
# pol="P", seed=0), Cphi banded into MUSE_BINS percentile bins of |l| (the
# last open), the data simulated at MUSE_TRUTH (generator seed 7); muse over
# MUSE_SIMS sims a draw, MUSE_STEPS steps, MAP 5 steps, CG 20 fixed, "auto",
# the final H; every bin's |pull| under MUSE_PULL_MAX, the bound the script
# asserts (a miss is reported as a miss, the seed kept)
N_MUSE, MUSE_BINS, MUSE_SIMS, MUSE_STEPS = 256, 4, 8, 4
MUSE_TRUTH = np.linspace(1.5, 0.8, MUSE_BINS)
MUSE_MAP = dict(nsteps=5, conjgrad_kwargs=dict(tol=0.0, nsteps=20, fixed_iters=True))
MUSE_PULL_MAX = 4.0
# (b) the batched EB quadratic estimate of the data and MUSE_SIMS sims at the
# last theta: each entry its unbatched estimate within QE_ENTRY_TOL. On the
# CPU the two are the same bits (tests/test_torch_ensemble.py); on the card
# the batched cuFFT plans round otherwise than the single-plane ones, and
# the estimate's legs cancel: 6.24e-6 on an H100 80GB HBM3 at 700 W
QE_ENTRY_TOL = 5e-5
# (c) MAP_marg as scripts/map_marg_256.py runs it: 16 sims, 10 steps (4 with
# the mean-field update), CG 25 fixed, alpha 0.2, "auto"
MARG_SIMS, MARG_STEPS, MARG_MF_STEPS, MARG_ALPHA = 16, 10, 4, 0.2
MARG_CG = dict(tol=0.0, nsteps=25, fixed_iters=True)
# (d) K2's whole flow at every kind and tier at the path's shapes (MUSE_SIMS
# entries, and NTRIAL x MUSE_SIMS as the batched line search runs them) and
# its derivative on the path's phi, against the plain versions at PERF.md
# §2's bounds (FLOW_TIER_TOL, FLOW_SPLIT_RATIO, HESS_TOL); the kernels each
# run of (a) and (c) must launch ("auto": 'high' gradients and CG, strict
# line search, strict CG fallback, strict theta-scores)
ENSEMBLE_KERNELS = ("flow_forward", "flow_adjoint", "flow_forward_high", "flow_adjoint_high",
                    "flow_backward_high", "deriv", "deriv_high")
# (e) one batched MAP_joint step and the MUSE theta-scores at 2 sims on the
# kernel backend against the plain one (strict; CG 20 fixed: the flows'
# 1e-5 amplified as WF_PLAIN_TOL's 20 iterations do)
ENSEMBLE_PLAIN_TOL = 1e-4
# phase 21: the rest of load_sim's and MAP_joint's options at 1024^2 P
OPT_STEPS = 4              # (a) MAP_joint steps with a logprior (brent)
OPT_ALPHA_TOL = 1e-4       # brent's tolerance (MAP_joint's default)
OPT_LOGPRIOR_W = 1e-2      # the weak logprior: -w/2 phi' Cphi^-1 phi
OPT_LP_TOL = 1e-6          # (a) one brent step's logpdf, kernel against plain
OPT_HESS_STEPS, OPT_HESS_BURNIN = 6, 2   # (b)
OPT_QUASI_STEPS = 3        # (c)
OPT_NOLENS_TOL = 1e-6      # (d) MAP_joint's f against argmaxf_logpdf's
# (e) the other lensing operators against LenseFlow (bounds of JAX
# tests/test_lensing_ops.py:35-75), and the card against the CPU
# tests/test_lensing_ops.py:35-75; PowerLens's 0.05 holds at 64^2 thetapix 3
# (3.2 deg; the port 0.006) and 512^2 thetapix 2 (0.021), but a 34 deg
# 1024^2 field holds phi's modes down to l ~ 10, whose deflections the
# series expands about the undeflected pixel: 0.101 there (on an H100
# 80GB HBM3 at 700 W), so it is held to 0.15 (Taylens remaps to the nearest
# pixel first)
OPT_LENS_BOUND = {"PowerLens": 0.15, "Taylens": 0.05, "BilinearLens": 0.3}
OPT_ADJ_TOL, OPT_SOLVE_TOL = 1e-4, 0.15
# the card against the CPU on the same float32 inputs, in Frobenius norm:
# grad phi by FFT lies 8.4e-6 from float64 at 512^2 (phi's steep spectrum:
# the rounding at high l is weighted by l), and the operators inherit it,
# 3.7e-6-5.7e-6 at 512^2 on the CPU, 2.2e-5-2.5e-5 between the card and the
# CPU at 1024^2, BilinearLens's adjoint and solve 9.0e-5 and 7.6e-5 (an H100
# 80GB HBM3 at 700 W): held at OPT_F32_TOL, and each no further from float64 than
# twice the CPU. get_max_lensing_step forms its
# Hessians in float64: OPT_CPU_TOL. The phi-gradient of logpdf with
# BilinearLens: 6.2e-3 and 6.7e-3 from float64 on the card and the CPU at
# 1024^2, 8.0e-3 apart (the weights' kinks at cell edges; Cphi^-1
# amplifying high-l FFT rounding): OPT_GRAD_TOL
OPT_F32_TOL, OPT_CPU_TOL, OPT_GRAD_TOL = 2e-4, 1e-5, 2e-2
# the "auto" path's kernels: the strict line search and f-step CG, the
# 'high' phi-gradient
# phase 22: the curved sky. The band: 256 rings x 1024 pixels, 34 degrees
# across (the 1024^2 P patch's width), the full circle in phi, lmax 2000
CURVED_NY, CURVED_NX, CURVED_HALF, CURVED_LMAX = 256, 1024, 0.3, 2000
CURVED_SMALL = (32, 128, 1100)   # (d): card against CPU, orders past |m| = 1024
CURVED_NOISE = 3.0               # muK-arcmin, white
# the Wiener filter as a user runs it; no precision-dependent operator lies
# on this path, so the solve runs strict (the "auto" re-check would re-run it)
CURVED_CG = dict(tol=1e-4, nsteps=500, hessian_precision=None)
# the blocks against the float64 harmonic sums after the float32 cast, S S
# against C, and the card against the CPU (blocks and Wiener filter)
CURVED_2PT_TOL, CURVED_SQRT_TOL, CURVED_CPU_TOL = 1e-4, 1e-4, 1e-4
HPX_NSIDE = 2048
# the card against the CPU: bilinear is gathers only; 'fft' solves 15 CG
# iterations through the NUFFT adjoint's scatter-add, whose order the card
# does not fix, at nside 512 <-> 256^2 at 8' (the CPU's time at nside 2048)
HPX_BILINEAR_TOL, HPX_FFT_TOL = 1e-5, 1e-3
HPX_FFT_SMALL = (512, 256, 8)
# the smooth maps' largest l: on the 1024^2 patch (2' pixels), on the band
# (8' x 21' pixels at the equator)
HPX_WAVE_LMAX = {False: 600, True: 100}
# the round trip sphere -> grid -> sphere of a smooth map (l <= 600), rel rms
HPX_RT_RMS = {"bilinear": 0.05, "fft": 0.05}
UD_TOL = 1e-5
# phase 23: the parallel layer (cmblensing_tpu_torch/parallel/). (a) NCCL at
# one rank in this process: the 1024^2 P sharded flows (L, L^H, delta phi)
# and the sharded Wiener filter (CG PAR_CG) against the unsharded port,
# each plane within FLOW_TOL (delta phi GRAD_TOL, the Wiener filter
# PAR_ONE_WF_TOL: the same CG over flows that agree to FLOW_TOL). (b)
# PAR_RANKS ranks sharing the card over gloo (host-staged: a check of the
# decomposition, not a multi-card time): the 4096^2 P flows and delta phi
# (K1 on every block) and the 256^2 P ones (K2's derivative: the blocks
# fit no radix) against the unsharded kernel path, FLOW_TOL and GRAD_TOL
# (PERF.md §2's bounds for the kernels against plain and the kernel-path
# gradient); the 1024^2 P Wiener filter within PAR_WF_TOL (CG PAR_CG
# amplifies the flows' 1e-5, as WF_PLAIN_TOL's 20 iterations do) and
# PAR_MAP_STEPS sharded_MAP_joint steps against MAP_joint (strict): the
# same alphas, logpdfs within STEP_TOL (phase 13's kernel-vs-plain MAP
# step), finite and non-decreasing, phi within PAR_MAP_UN_TOL relative L2
# of MAP_joint's: between the sound reading, 2.27e-3, and 9.7e-3, that of
# a map-space CG that lost float32 accuracy (PERF.md §6). The JAX
# package's bound, PAR_MAP_TOL (tests/test_sharded_fft.py, 32^2), and
# each run's distance to MAP_joint in float64 on the plain backend are
# printed: at 1024^2 both float32 runs lie 1.4e-2 from the float64 one.
# (c) BASELINE.json configs[4]'s ensembles with mesh= over PAR_RANKS
# ranks, each against two unsharded runs from the same seeds: the whole
# ensemble in one batch (the unsharded entry point), and the ensemble in
# PAR_RANKS batches of a rank's size in this process (par_halves_*: the
# witness of what batch size alone does to float32 rounding). The
# sharded run must match the batches within PAR_HALVES_TOL, relative to
# the largest entry; its distance to the one-batch run is printed beside
# the batches' own. MUSE at phase 20's settings: the data score and step
# 1's mean simulation score within PAR_ENS_TOL of the one-batch run, step
# 1's per-sim scores and H (muse's finite differences, the Newton step's
# matrix) within PAR_HALVES_TOL of the batches'; theta and the pulls
# after the capped Newton steps printed (H's finite differences of
# batched MAPs, cond(H) 6.2e4, turn batch-size rounding into steps of
# other signs, PERF.md §6), each run's pulls under MUSE_PULL_MAX. One
# sample_joint pass at phase 19's settings, always accepted: f, phi,
# logpdf and dH within PAR_HALVES_TOL of the batches', the same accepts
# as both runs; PAR_ENS_TOL against the one-batch pass printed (phase 19
# (c)'s measure: max-abs over every sim). PAR_MARG_STEPS MAP_marg steps
# at phase 20's settings: step 1's phi within PAR_HALVES_TOL of the
# batches', the last phi within PAR_MARG_TOL of the one-batch run's (its
# steps move phi along g_data - gbar, two gradients of norm ~1.3e9 that
# cancel: 1.9e-4 measured). Each part's launches are counted per rank
# (rank 0's recorded); PAR_PATH_KERNELS lists what each path must launch.
PAR_RANKS, PAR_FLOW_N, PAR_MAP_STEPS, PAR_MARG_STEPS = 2, 4096, 2, 2
PAR_FLOW_SIMS = ((PAR_FLOW_N, THETAPIX_MAP), (N, 3))   # (Nside, thetapix) of (b)'s flows
PAR_CG = dict(tol=0.0, nsteps=15, fixed_iters=True)
PAR_ONE_WF_TOL, PAR_WF_TOL, PAR_MAP_TOL, PAR_ENS_TOL = 1e-5, 1e-4, 1e-4, 1e-4
PAR_MAP_UN_TOL, PAR_MARG_TOL, PAR_HALVES_TOL = 5e-3, 1e-3, 1e-6
PAR_TIMEOUT, PAR_BUDGET_S = 900, 150
PAR_PATH_KERNELS = {
    "one_rank_flows_1024": ("fderiv", "rk4_update", "p_planes"),
    "sharded_flows_4096_rank0": ("fderiv", "rk4_update", "p_planes"),
    "sharded_flows_256_rank0": ("deriv", "rk4_update", "p_planes"),
    "sharded_MAP_joint_1024_rank0": ("fderiv", "rk4_update", "p_planes"),
    "muse_mesh_256x8_rank0": ENSEMBLE_KERNELS,
    "sample_joint_mesh_512x32_rank0": SAMPLE_KERNELS,
    "MAP_marg_mesh_256x16_rank0": ENSEMBLE_KERNELS}
OPT_KERNELS = ("fderiv", "fa_velocity_forward", "fa_velocity_adjoint", "rk4_update", "p_planes",
               "fderiv_high", "fa_velocity_forward_high", "fa_velocity_adjoint_high",
               "bv_velocity_high")


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def fro(a, b):
    """|a - b| / |b| in Frobenius norm, in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def cuda_ms(fn, reps, torch, graph=False):
    """Milliseconds per fn() over reps back-to-back runs after one warm-up
    run, by CUDA events around the whole run. With `graph` the reps runs are
    captured into one CUDA graph and its replay is timed: device time
    without the host's launch cost, which is what a kernel under ~0.05 ms
    would otherwise show."""
    fn()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if graph:
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        run = g.replay
    else:
        def run():
            for _ in range(reps):
                fn()
    e0.record()
    run()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def kernel_ms(fn, reps, torch):
    """Device milliseconds of a kernel wrapper's launches (or of the one
    library call held beside it)."""
    return cuda_ms(fn, reps, torch, graph=True)


def cold_ms(fn, args, reps, torch):
    """Device milliseconds of fn(*args) with its tensors read from HBM, not
    the L2: the replayed launches go round copies of args' tensors that
    together hold at least twice the L2, so that no launch finds what it
    reads left in the L2 by the launches before it, as a replay on one set
    of buffers does for a working set below the L2's 50 MB."""
    import math
    nbytes = sum(x.numel() * x.element_size() for x in args if torch.is_tensor(x))
    sets = [args] + [tuple(x.clone() if torch.is_tensor(x) else x for x in args)
                     for _ in range(math.ceil(2 * L2_BYTES / nbytes) - 1)]
    nxt = iter(range(1 << 30))
    return kernel_ms(lambda: fn(*sets[next(nxt) % len(sets)]), reps, torch)


def bound(flops, planes, N, extra_floats=0):
    """bound_ms and bound_by of a function doing `flops` FP32 operations
    and moving `planes` N x N float32 planes plus `extra_floats` floats
    (each input read once, each output written once)."""
    t_op = flops / FP32_PEAK
    t_mem = 4 * (planes * N * N + extra_floats) / HBM_RATE
    return dict(bound_ms=1e3 * max(t_op, t_mem), bound_by="operations" if t_op >= t_mem else "bytes")


def dense_deriv_flops(N):
    """One dense circulant derivative of an N x N plane: N^3 FMA."""
    return 2 * N ** 3


def fact_deriv_flops(N, B=None):
    """One radix-B factored derivative of an N x N plane (csrc/fact_tile.cuh):
    2B - 2 block products of A x A x N FMA, and B FMA per pixel in each
    butterfly."""
    B = B or N // FA
    return 2 * (2 * B - 2) * FA * FA * N + 2 * 2 * B * N * N


def bound_high(N, nder, planes, nb=1, axes=2, tier="high"):
    """bound_ms and bound_by of nb entries of nder 'high' factored
    derivatives each (csrc/fact_tile.cuh, TIER_HIGH): three bf16 products
    per block product on the tensor cores, and in FP32 the two butterflies
    (B FMA a pixel each) and the split (three operations a channel value);
    bytes: `planes` N x N float32 planes per entry, and the split blocks
    ([head, residual] bf16) and butterflies of the `axes` axes it
    differentiates along. At tier 'bf16': one product, one rounding a
    channel value, the blocks' heads."""
    B = N // FA
    passes, split_ops = (3, 3) if tier == "high" else (1, 1)
    prod = nb * nder * 2 * (2 * B - 2) * FA * FA * N
    fp32 = nb * nder * (2 * 2 * B + split_ops) * N * N
    t_op = passes * prod / BF16_PEAK + fp32 / FP32_PEAK
    blocks = (2 if tier == "high" else 1) * 2 * B * FA * FA
    t_mem = (4 * nb * planes * N * N + axes * (blocks + 4 * 2 * B * B)) / HBM_RATE
    return dict(bound_ms=1e3 * max(t_op, t_mem), bound_by="operations" if t_op >= t_mem else "bytes")


def bound_dense_high(N, nder, planes, tier="high"):
    """bound_ms and bound_by of nder 'high' dense derivatives of N x N planes
    (csrc/lenseflow.cu, TIER_HIGH): three bf16 products of 2 N^3 operations
    each on the tensor cores and the operand's split (three FP32 operations
    a value); bytes: `planes` N x N planes of 4 bytes, the circulants' bf16
    head and residual counting as one such plane each. At tier 'bf16': one
    product and one rounding a value (the circulant's head is half a
    plane)."""
    passes = 3 if tier == "high" else 1
    t_op = passes * nder * 2 * N ** 3 / BF16_PEAK + passes * nder * N * N / FP32_PEAK
    t_mem = 4 * planes * N * N / HBM_RATE
    return dict(bound_ms=1e3 * max(t_op, t_mem), bound_by="operations" if t_op >= t_mem else "bytes")


def split_matmuls_ms(a, M, right, torch, reps=20):
    """The library yardstick of a 'high' derivative pass: the three bf16
    torch.matmul of the split (head.head, head.residual, residual.head) on
    operands split beforehand, timed cold; the port never calls it."""
    from cmblensing_tpu_torch.ops.factored_deriv import split_bf16
    (ah, al), (mh, ml) = split_bf16(a), split_bf16(M)
    if right:
        return cold_ms(lambda x, y, z, w: (x @ z, x @ w, y @ z), (ah, al, mh, ml), reps, torch)
    return cold_ms(lambda x, y, z, w: (z @ x, w @ x, z @ y), (ah, al, mh, ml), reps, torch)


def library_bf16_ms(a, M, torch, reps=20):
    """The library yardstick of a 'bf16' derivative pass, a @ M with both
    operands rounded to bf16 and float32 output, as one PyTorch call
    (torch.mm with out_dtype, where this torch has it; else torch.matmul on
    bf16, cast to float32), M rounded beforehand, timed cold; the port never
    calls it. Returns (ms, the call)."""
    Mb = M.bfloat16()
    try:
        torch.mm(a.bfloat16(), Mb, out_dtype=torch.float32)
        fn, how = (lambda x, m: torch.mm(x.bfloat16(), m, out_dtype=torch.float32),
                   "torch.mm(a.bfloat16(), M.bfloat16(), out_dtype=torch.float32)")
    except (TypeError, RuntimeError):
        fn, how = (lambda x, m: torch.matmul(x.bfloat16(), m).float(),
                   "torch.matmul(a.bfloat16(), M.bfloat16()).float() (this torch.mm has no "
                   "out_dtype)")
    return cold_ms(fn, (a, Mb), reps, torch), how


def fact_op_floats(N):
    """The factored operands' floats: (B, A, A) blocks and (2, B, B)
    butterflies per axis."""
    B = N // FA
    return 2 * (B * FA * FA + 2 * B * B)


def matmul_ms(a, b, torch, reps=20, cold=False):
    """The library call for a derivative pass: strict FP32 `a @ b` (no
    TF32; a @ DxT along x, Dy @ b along y), one cuBLAS call; `cold` as
    cold_ms."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        if cold:
            return cold_ms(lambda x, y: x @ y, (a, b), reps, torch)
        return kernel_ms(lambda: a @ b, reps, torch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def weak_lensing_inputs(proj, torch):
    """phi, f (pol P) and a cotangent dy drawn with numpy from SEED: phi and
    f from the fiducial Cphi and Cf, so the lensing is realistically weak."""
    import cmblensing_tpu_torch as ct
    rng = np.random.default_rng(SEED)
    n = proj.Nx
    Cl = ct.camb()
    Cphi = ct.Cl_to_Cov("I", proj, Cl["total"]["pp"])
    Cf = ct.Cl_to_Cov("P", proj, Cl["unlensed_scalar"]["EE"], Cl["unlensed_scalar"]["BB"])
    white = lambda c: ct.Field(torch.as_tensor(rng.standard_normal((c, n, n)).astype(np.float32),
                                               device=proj.device), ct.Basis("I" if c == 1 else "QU", "map"), proj)
    phi = (Cphi.sqrt() @ white(1)).to(ct.MAP).arr.contiguous()
    f = (Cf.sqrt() @ white(2)).to(ct.QU_MAP).arr.contiguous()
    dy = torch.as_tensor(rng.standard_normal((2, n, n)).astype(np.float32), device=proj.device)
    return phi, f, dy


def phase_kernels(torch, proj):
    """K2's derivative and each whole flow against its plain version (the
    flow kernel's own record, every kind and tier: phase 18)."""
    from cmblensing_tpu_torch.ops import deriv, lenseflow_kernels as lfk
    phi_map, f, dy = weak_lensing_inputs(proj, torch)
    mats = deriv.deriv_mats(proj)
    phi = lfk.gradhess(phi_map, mats)
    hess_err = rel(phi, lfk.gradhess_plain(phi_map, mats))
    errs = {}

    out = {}
    # the derivative kernel: d_x a + d_y b + c checked, the d_x a pass timed
    # beside its one-call library counterpart
    a, b, c = f[0:1].contiguous(), f[1:2].contiguous(), dy[0:1].contiguous()
    o1, o2 = torch.empty_like(a), torch.empty_like(a)
    lfk.deriv_cuda(a, b, c, o1, mats)
    lfk.deriv_plain(a, b, c, o2, mats)
    err3 = (float((o1 - o2).abs().max()), rel(o1, o2))
    lfk.deriv_cuda(a, None, None, o1, mats)
    lfk.deriv_plain(a, None, None, o2, mats)
    out["deriv"] = dict(max_abs_err=max(err3[0], float((o1 - o2).abs().max())),
                        rel=max(err3[1], rel(o1, o2)),
                        ms=kernel_ms(lambda: lfk.deriv_cuda(a, None, None, o1, mats), 20, torch),
                        plain_ms=cuda_ms(lambda: lfk.deriv_plain(a, None, None, o2, mats), 20, torch),
                        library_ms=matmul_ms(a[0], mats[0], torch),
                        **bound(dense_deriv_flops(N), 3, N))      # a, out, DxT

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
        print(f"phase 2: kernel {name:18s} rel err {d['rel']:.3e}  {d['ms']:.4f} ms  plain "
              f"{d['plain_ms']:.4f} ms  library {d['library_ms']}  bound {d['bound_ms']:.4f} ms "
              f"({d['bound_by']})")
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
    if min(launches[k] for k in DENSE_KERNELS) <= 0:
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


def phase_factored(torch, card):
    """The factored kernels (K1 both passes, K3 both roles, K4) at the
    1024^2 main path's shapes, one launch each, K1 and K3 also at the
    line search's batch of NTRIAL, and the whole flows, against their
    plain versions on the same inputs, with times."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import deriv, factored_deriv, lenseflow_kernels as lfk
    proj = ct.ProjLambert(N_MAP, N_MAP, thetapix=THETAPIX_MAP, T=np.float32, device=DEVICE)
    ops = deriv.deriv_ops(proj)
    if not isinstance(ops, factored_deriv.FactoredOps) or ops.FX.shape[0] != N_MAP // FA:
        raise AssertionError(f"deriv_ops gives no radix-{N_MAP // FA} factored operands")
    phi_map, f, dy = weak_lensing_inputs(proj, torch)
    phi = lfk.gradhess(phi_map, ops)
    phi_plain = lfk.gradhess_plain(phi_map, ops)
    hess_err = rel(phi, phi_plain)
    proj64 = ct.ProjLambert(N_MAP, N_MAP, thetapix=THETAPIX_MAP, T=np.float64, device=DEVICE)
    phi64 = lfk.gradhess_plain(phi_map.double(), deriv.deriv_ops(proj64))
    hess_f64 = (rel(phi.double(), phi64), rel(phi_plain.double(), phi64))
    phi1, y = phi[None], f[None].contiguous()
    out = {}

    def check(name, run_k, run_p, result, reps=10, cold=None):
        """cold: (fn, args) of run_k, to time it as cold_ms does."""
        run_k()
        run_p()
        k, p = result()
        out[name] = dict(max_abs_err=float((k - p).abs().max()), rel=rel(k, p),
                         ms=kernel_ms(run_k, reps, torch) if cold is None
                         else cold_ms(*cold, reps, torch),
                         plain_ms=cuda_ms(run_p, reps, torch))

    a, b, c = f[0:1].contiguous(), f[1:2].contiguous(), dy[0:1].contiguous()
    o1, o2 = torch.empty_like(a), torch.empty_like(a)
    for name, args in (("fderiv_x", (a, None, None)), ("fderiv_y", (None, b, None)),
                       ("fderiv", (a, b, c))):
        check(name, lambda: lfk.fderiv_cuda(*args, o1, ops),
              lambda: lfk.fderiv_plain(*args, o2, ops), lambda: (o1, o2))
    # bounds: derivative FLOPs; planes in and out plus the factored operands
    # (one axis' for a single pass); the dense circulants for the library call
    DxT, Dy = deriv.deriv_mats(proj)
    half_ops = fact_op_floats(N_MAP) // 2
    out["fderiv_x"].update(library_ms=matmul_ms(a[0], DxT, torch),
                           **bound(fact_deriv_flops(N_MAP), 2, N_MAP, half_ops))
    out["fderiv_y"].update(library_ms=matmul_ms(Dy, b[0], torch),
                           **bound(fact_deriv_flops(N_MAP), 2, N_MAP, half_ops))
    out["fderiv"].update(library_ms=None, **bound(2 * fact_deriv_flops(N_MAP), 4, N_MAP,
                                                  fact_op_floats(N_MAP)))
    t = 0.5
    pt1, pt1p = (torch.empty((2, 1, N_MAP, N_MAP), device=DEVICE) for _ in range(2))
    # p(t) and the RK4 update are bound by bytes and their working sets fit
    # the L2: timed cold, as the flows' stages meet them
    check("p_planes", lambda: lfk.p_planes_cuda(t, phi1, pt1),
          lambda: lfk.p_planes_plain(t, phi1, pt1p), lambda: (pt1, pt1p),
          cold=(lambda ph, o: lfk.p_planes_cuda(t, ph, o), (phi1, pt1)))
    out["p_planes"].update(library_ms=None, **bound(25 * N_MAP * N_MAP, 7, N_MAP))
    # the RK4 update on a K3 flow's state (stage 1: y, k, acc in; acc, s out)
    yy, kk, acc, st = (torch.randn_like(y) for _ in range(4))
    res = []
    for fn in (lfk.rk4_update_cuda, lfk.rk4_update_plain):
        a2, s2, y2 = acc.clone(), st.clone(), yy.clone()
        for stage, (wa, ws) in enumerate(((1 / 42, 1 / 14), (1 / 21, 1 / 14), (1 / 21, 1 / 7),
                                          (1 / 42, 0.0))):
            fn(y2, kk, a2, s2, stage, wa, ws)
        res.append(torch.cat([y2, a2, s2]))
    out["rk4_update"] = dict(max_abs_err=float((res[0] - res[1]).abs().max()),
                             rel=rel(res[0], res[1]),
                             ms=cold_ms(lambda *a: lfk.rk4_update_cuda(*a, 1, 1 / 21, 1 / 14),
                                        (yy, kk, acc, st), 10, torch),
                             plain_ms=cuda_ms(lambda: lfk.rk4_update_plain(yy, kk, acc, st, 1,
                                                                           1 / 21, 1 / 14), 10,
                                              torch),
                             library_ms=None, **bound(4 * 2 * N_MAP * N_MAP, 5 * 2, N_MAP))
    del yy, kk, acc, st, res
    k1, k2 = torch.empty_like(y), torch.empty_like(y)
    for kind in ("forward", "adjoint"):
        check("fa_velocity_" + kind,
              lambda: lfk.fvelocity_cuda(kind, y, k1, phi1, pt1, ops, 2, t),
              lambda: lfk.fvelocity_plain(kind, y, k2, phi1, pt1p, ops, 2, t), lambda: (k1, k2))
    acc = 1e-3 * torch.as_tensor(np.random.default_rng(SEED + 1).standard_normal(
        (1, lfk.NACC, N_MAP, N_MAP)).astype(np.float32), device=DEVICE)
    yb = torch.cat([f[None], dy[None], acc], dim=1)
    kb1, kb2 = torch.empty_like(yb), torch.empty_like(yb)
    check("bv_velocity", lambda: lfk.fvelocity_cuda("backward", yb, kb1, phi1, pt1, ops, 2, t),
          lambda: lfk.fvelocity_plain("backward", yb, kb2, phi1, pt1p, ops, 2, t),
          lambda: (kb1, kb2))
    # the bundle's planes differ in scale by orders: hold each to the bound
    bv_planes = max(rel(kb1[0, i], kb2[0, i]) for i in range(yb.shape[1]))
    out["bv_velocity"]["rel"] = max(out["bv_velocity"]["rel"], bv_planes)
    # y, p, k: 2 + 2 + 2 planes, 4 derivatives (K3); y, phi, p, k: 9 + 5 + 2 + 9, 8 (K4)
    for name, nder, planes in (("fa_velocity_forward", 4, 6), ("fa_velocity_adjoint", 4, 6),
                               ("bv_velocity", 8, 25)):
        out[name].update(library_ms=None, **bound(nder * fact_deriv_flops(N_MAP), planes, N_MAP,
                                                  fact_op_floats(N_MAP)))

    # the line search's batch: NTRIAL trials, each with its own phi planes
    # (phi scaled along an alpha grid) and its own state, on the kernels'
    # grid z axis; each trial held to the bound on its own
    scales = torch.linspace(0.1, 2.0, NTRIAL, device=DEVICE).reshape(-1, 1, 1, 1)
    phis = (scales * phi).contiguous()
    ys = torch.stack([torch.roll(f, 7 * i, dims=-1) for i in range(NTRIAL)])
    batched = {}

    def check_batched(name, run_k, run_p, result):
        run_k()
        run_p()
        k, p = result()
        batched[name] = dict(nb=NTRIAL, max_abs_err=float((k - p).abs().max()),
                             rel=max(rel(k[i], p[i]) for i in range(NTRIAL)),
                             ms=kernel_ms(run_k, 5, torch), plain_ms=cuda_ms(run_p, 3, torch))

    pts, ptsp = (torch.empty((2, NTRIAL, N_MAP, N_MAP), device=DEVICE) for _ in range(2))
    check_batched("p_planes", lambda: lfk.p_planes_cuda(t, phis, pts),
                  lambda: lfk.p_planes_plain(t, phis, ptsp),
                  lambda: (pts.transpose(0, 1), ptsp.transpose(0, 1)))
    a17 = ys[:, :1].contiguous()
    d1, d2 = torch.empty_like(a17), torch.empty_like(a17)
    check_batched("fderiv", lambda: lfk.fderiv_cuda(a17, a17, None, d1, ops),
                  lambda: lfk.fderiv_plain(a17, a17, None, d2, ops), lambda: (d1, d2))
    s1, s2 = torch.empty_like(ys), torch.empty_like(ys)
    for kind in ("forward", "adjoint"):
        check_batched("fa_velocity_" + kind,
                      lambda: lfk.fvelocity_cuda(kind, ys, s1, phis, pts, ops, 2, t),
                      lambda: lfk.fvelocity_plain(kind, ys, s2, phis, ptsp, ops, 2, t),
                      lambda: (s1, s2))
    for name, d in batched.items():
        out[name]["batched"] = d

    # whole flows at the main path's nsteps
    flows, results = {}, {}
    for name, run in (
            ("L", lambda fn: fn(f, phi, ops, 0., 1., NSTEPS, "forward")),
            ("L^-1", lambda fn: fn(f, phi, ops, 1., 0., NSTEPS, "forward")),
            ("L^H", lambda fn: fn(f, phi, ops, 1., 0., NSTEPS, "adjoint"))):
        results[name], pv = run(lfk.flow_apply), run(lfk.flow_apply_plain)
        flows[name] = (rel(results[name], pv), cuda_ms(lambda: run(lfk.flow_apply), 3, torch),
                       cuda_ms(lambda: run(lfk.flow_apply_plain), 1, torch))
    (dphi_k, df0_k), (dphi_p, df0_p) = (fn(dy, f, phi, ops, 0., 1., NSTEPS)
                                        for fn in (lfk.flow_bwd, lfk.flow_bwd_plain))
    bwd_ms = cuda_ms(lambda: lfk.flow_bwd(dy, f, phi, ops, 0., 1., NSTEPS), 3, torch)
    bwd_plain_ms = cuda_ms(lambda: lfk.flow_bwd_plain(dy, f, phi, ops, 0., 1., NSTEPS), 1, torch)
    flows["backward df0"] = (rel(df0_k, df0_p), bwd_ms, bwd_plain_ms)
    flows["backward dphi"] = (rel(dphi_k, dphi_p), bwd_ms, bwd_plain_ms)
    torch.cuda.synchronize()
    for name, d in out.items():
        print(f"phase 5: kernel {name:20s} rel err {d['rel']:.3e} (bound {FLOW_TOL:g})  "
              f"{d['ms']:.4f} ms  plain {d['plain_ms']:.4f} ms  library {d['library_ms']}  "
              f"bound {d['bound_ms']:.4f} ms ({d['bound_by']})  [{N_MAP}^2; {card}]")
    for name, d in batched.items():
        print(f"phase 5: kernel {name:20s} batch {NTRIAL} rel err {d['rel']:.3e} (bound "
              f"{FLOW_TOL:g}, each trial)  {d['ms']:.4f} ms  plain {d['plain_ms']:.4f} ms  "
              f"[{N_MAP}^2; {card}]")
    for name, (e, km, pm) in flows.items():
        print(f"phase 5: flow {name:14s} rel err {e:.3e} (bound {FLOW_TOL:g})  kernel {km:.3f} ms  "
              f"plain {pm:.3f} ms  [{N_MAP}^2 P, nsteps={NSTEPS}; {card}]")
    print(f"phase 5: gradhess rel err {hess_err:.3e} (bound {HESS_TOL_1024:g}); against float64: "
          f"kernel {hess_f64[0]:.3e}, plain {hess_f64[1]:.3e}")
    bad = {k: d["rel"] for k, d in out.items() if not d["rel"] < FLOW_TOL}
    bad.update({f"{k}[{NTRIAL}]": d["rel"] for k, d in batched.items() if not d["rel"] < FLOW_TOL})
    bad.update({k: v[0] for k, v in flows.items() if not v[0] < FLOW_TOL})
    if not hess_err < HESS_TOL_1024:
        bad["gradhess"] = hess_err
    if bad:
        raise AssertionError(f"factored kernel disagrees with its plain version: {bad}")
    results.update(dphi=dphi_k, df0=df0_k)
    return out, dict(ops=ops, phi=phi, phi_map=phi_map, f=f, dy=dy, flows=results)


def phase_map_gradient(torch, card):
    """load_sim at 1024^2 P and the mixed phi-gradient, kernel backend
    against the plain (cuFFT) backend."""
    import cmblensing_tpu_torch as ct
    t0 = time.perf_counter()
    sim = ct.load_sim(thetapix=THETAPIX_MAP, Nside=N_MAP, pol="P", T=np.float32, seed=SEED,
                      device=DEVICE)
    torch.cuda.synchronize()
    print(f"phase 6: load_sim at {N_MAP}^2 P: {time.perf_counter() - t0:.2f} s [{card}]")
    ds = sim["ds"]
    f = sim["f"].to(sim["f"].basis.with_space("map"))
    phi = sim["phi"].to(sim["phi"].basis.with_space("map"))
    m = ct.mix(ds, f=f, phi=phi)
    f_mix, phi_mix = m["f_mix"].to(f.basis), m["phi_mix"].to(phi.basis)
    vg = ct.fvalue_and_grad(lambda p: ct.Mixed(ds).logpdf(f_mix=f_mix, phi_mix=p))
    res = {}
    for be in ("kernel", "plain"):
        with ct.lenseflow_backend_ctx(be):
            v, g = vg(phi_mix)
            ms = cuda_ms(lambda: vg(phi_mix), 3, torch)
        res[be] = (v, g, ms)
    gerr = rel(res["kernel"][1].arr, res["plain"][1].arr)
    print(f"phase 6: lnP kernel {float(res['kernel'][0])!r} plain {float(res['plain'][0])!r}; "
          f"grad rel max-abs err {gerr:.3e} (bound {GRAD_TOL_1024:g}); gradlnP kernel "
          f"{res['kernel'][2]:.3f} ms plain {res['plain'][2]:.3f} ms [{N_MAP}^2 P; {card}]")
    if not (torch.isfinite(res["kernel"][1].arr).all() and gerr < GRAD_TOL_1024):
        raise AssertionError(f"1024^2 kernel gradient disagrees with the plain backend: {gerr}")
    return (dict(sim=sim, vg=vg, phi_mix=phi_mix, grad=res["kernel"][1], grad_ms=res["kernel"][2]),
            res["kernel"][2], res["plain"][2])


def run_map(torch, sim, phase, label, card, precision=None):
    """MAP_joint at 1024^2 P as scripts/map_1024.py runs it, on the current
    LenseFlow backend at `precision` (None: strict everywhere): MAP_WARM
    warm-up steps, then MAP_STEPS timed with the launch counters and timers
    set to 0 just before and read just after. Checks a finite,
    never-decreasing logpdf, a first step taken and corr(phi_MAP,
    phi_true); returns (launches, s/step, history)."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    from cmblensing_tpu_torch.utils import timing
    keys = ("logpdf", "alpha", "cg_iters", "cg_res", "gradnorm", "precision_fallback", "retry")
    run = lambda n: ct.MAP_joint(sim["ds"], nsteps=n, linesearch="grid", conjgrad_kwargs=MAP_CG,
                                 history_keys=keys, precision=precision)
    t0 = time.perf_counter()
    run(MAP_WARM)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    timing.reset_timers()
    lfk.reset_launches()
    t0 = time.perf_counter()
    res = run(MAP_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(lfk.LAUNCHES)
    report = timing.timer_report()
    hist = res["history"]
    lps = [h["logpdf"] for h in hist]
    alphas = [h["alpha"] for h in hist]
    pt = sim["phi"].to(ct.MAP).arr.reshape(-1).double()
    pm = res["phi"].to(ct.MAP).arr.reshape(-1).double()
    corr = float(pm @ pt / (pm.norm() * pt.norm()))
    print(f"phase {phase}: MAP_joint {N_MAP}^2 P: {MAP_WARM} warm-up steps {warm:.2f} s; "
          f"{MAP_STEPS} steps {dt:.2f} s = {dt / MAP_STEPS:.3f} s/step {label} [{card}]")
    for line in report.splitlines():
        print(f"phase {phase}: timers", line)
    print(f"phase {phase}: logpdfs {lps!r}")
    print(f"phase {phase}: alphas {alphas!r}; CG iters {[h['cg_iters'] for h in hist]}; "
          f"CG res {[float(h['cg_res']) for h in hist]!r}")
    print(f"phase {phase}: gradnorm {[float(h['gradnorm']) for h in hist]!r}")
    print(f"phase {phase}: precision {precision!r}: f-steps re-run strict (precision_fallback) "
          f"{[h['precision_fallback'] for h in hist]}; direction retries "
          f"{[h['retry'] for h in hist]}")
    print(f"phase {phase}: corr(phi_MAP, phi_true) = {corr:.4f} (bound >= {CORR_MIN:g})")
    print(f"phase {phase}: launches in the MAP_joint run: {launches}; per step "
          f"{ {k: v / MAP_STEPS for k, v in launches.items() if v} }")
    if not all(np.isfinite(lps)) or any(b < a for a, b in zip(lps, lps[1:])):
        raise AssertionError(f"MAP_joint logpdf not finite and non-decreasing: {lps}")
    if not alphas[0] > 0:
        raise AssertionError(f"first line search accepted no step: {alphas}")
    if not corr >= CORR_MIN:
        raise AssertionError(f"corr(phi_MAP, phi_true) = {corr} < {CORR_MIN}")
    dense = {k: launches[k] for k in DENSE_KERNELS if launches[k]}
    if dense:
        raise AssertionError(f"dense K2 kernels launched at {N_MAP}^2: {dense}")
    return launches, dt / MAP_STEPS, hist


def phase_map(torch, sim, card):
    """MAP_joint at 1024^2 P on the factored kernels; one plain-backend
    step beside it."""
    import cmblensing_tpu_torch as ct
    launches, s_step, hist = run_map(torch, sim, 7, "kernel", card)
    with ct.lenseflow_backend_ctx("plain"):
        t1 = time.perf_counter()
        ct.MAP_joint(sim["ds"], nsteps=1, linesearch="grid", conjgrad_kwargs=MAP_CG, precision=None)
        torch.cuda.synchronize()
        plain_step = time.perf_counter() - t1
    print(f"phase 7: plain backend {plain_step:.3f} s/step (1 step) [{card}]")
    if min(launches[k] for k in FACTORED_KERNELS) <= 0:
        raise AssertionError(f"a factored kernel never launched in MAP_joint: {launches}")
    if any(launches[k] for k in HIGH_KERNELS):
        raise AssertionError(f"a 'high' kernel launched in the strict MAP_joint: {launches}")
    return launches, s_step, plain_step, hist


def phase_uni(torch, card, fctx, gctx):
    """The 1024^2 P path on the "uni" backend: K5, every role at the
    operands the uni flows give it, at batch 1 and on a NTRIAL-trial state
    with NTRIAL phi scalings, against its plain version; the uni flows
    against their plain versions and phase 5's K3/K4 flows; the
    phi-gradient against the kernel backend; MAP_joint as in phase 7."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import deriv, lenseflow_kernels as lfk
    ops, phi, f, dy = (fctx[k] for k in ("ops", "phi", "f", "dy"))
    t = 0.5
    nonzero, nder = {0: 4, 1: 1, 2: 2, 3: 2}, {0: 4, 1: 6, 2: 4, 3: 4}

    def check_roles(phis, state, reps):
        """Each role, kernel against plain; every output plane of every
        entry of every trial held to the bound on its own, the planes the
        role leaves at zero exactly zero."""
        px, py, calls = uni_operands(torch, ops, phis, state, t)
        nb, res = state.shape[0], {}
        for role, _, a, b in calls:
            nper = a.shape[1]
            o1 = torch.full((nb, nper, 4, N_MAP, N_MAP), float("nan"), device=DEVICE)
            o2 = torch.empty_like(o1)
            run_k = lambda: lfk.uni_velocity_cuda(role, a, b, px, py, o1, ops, t)
            run_p = lambda: lfk.uni_velocity_plain(role, a, b, px, py, o2, ops, t)
            run_k()
            run_p()
            n = nonzero[role]
            res[role] = dict(
                nb=nb, max_abs_err=float((o1[:, :, :n] - o2[:, :, :n]).abs().max()),
                rel=max(rel(o1[i, c, j], o2[i, c, j])
                        for i in range(nb) for c in range(nper) for j in range(n)),
                zero=bool((o1[:, :, n:] == 0).all()),
                ms=kernel_ms(run_k, reps, torch), plain_ms=cuda_ms(run_p, 1, torch),
                library_ms=None,
                # a, b, out per entry; px, py per trial; the factored operands
                **bound(nder[role] * nb * nper * fact_deriv_flops(N_MAP),
                        nb * (2 * nper + 2 + 4 * nper), N_MAP, fact_op_floats(N_MAP)))
        return res

    one = check_roles(phi[None], torch.cat([f, dy])[None], 10)
    scales = torch.linspace(0.1, 2.0, NTRIAL, device=DEVICE).reshape(-1, 1, 1, 1)
    states = torch.stack([torch.roll(torch.cat([f, dy]), 7 * i, dims=-1) for i in range(NTRIAL)])
    many = check_roles((scales * phi).contiguous(), states, 3)
    del states

    # whole uni flows at the main path's nsteps
    flows = {}
    for name, (t0, t1, kind) in (("L", (0., 1., "forward")), ("L^-1", (1., 0., "forward")),
                                 ("L^H", (1., 0., "adjoint"))):
        run = lambda fn: fn(f, phi, ops, t0, t1, NSTEPS, kind)
        kv, pv = run(lfk.uni_flow_apply), run(lfk.uni_flow_apply_plain)
        flows[name] = dict(rel=rel(kv, pv), k3=rel(kv, fctx["flows"][name]),
                           ms=cuda_ms(lambda: run(lfk.uni_flow_apply), 3, torch),
                           plain_ms=cuda_ms(lambda: run(lfk.uni_flow_apply_plain), 1, torch))
    bwd = lambda fn: fn(dy, f, phi, ops, 0., 1., NSTEPS)
    (dphi_u, df0_u), (dphi_p, df0_p) = bwd(lfk.uni_flow_bwd), bwd(lfk.uni_flow_bwd_plain)
    bwd_ms = cuda_ms(lambda: bwd(lfk.uni_flow_bwd), 3, torch)
    bwd_plain_ms = cuda_ms(lambda: bwd(lfk.uni_flow_bwd_plain), 1, torch)
    proj64 = ct.ProjLambert(N_MAP, N_MAP, thetapix=THETAPIX_MAP, T=np.float64, device=DEVICE)
    dphi64, _ = lfk.uni_flow_bwd_plain(dy.double(), f.double(), phi.double(),
                                       deriv.deriv_ops(proj64), 0., 1., NSTEPS)
    flows["backward df0"] = dict(rel=rel(df0_u, df0_p), k3=rel(df0_u, fctx["flows"]["df0"]),
                                 ms=bwd_ms, plain_ms=bwd_plain_ms)
    flows["backward dphi"] = dict(rel=rel(dphi_u, dphi_p), ms=bwd_ms, plain_ms=bwd_plain_ms)
    dphi_err = dict(hoisted=rel(dphi_u, fctx["flows"]["dphi"]),
                    float64=rel(dphi_u.double(), dphi64))
    del dphi64

    # the phi-gradient on "uni" against the kernel backend
    with ct.lenseflow_backend_ctx("uni"):
        v, g = gctx["vg"](gctx["phi_mix"])
        grad_ms = cuda_ms(lambda: gctx["vg"](gctx["phi_mix"]), 3, torch)
    gerr = rel(g.arr, gctx["grad"].arr)

    torch.cuda.synchronize()
    for label, res in (("", one), (f" batch {NTRIAL}", many)):
        for role, d in res.items():
            print(f"phase 8: K5 role {role}{label} rel err {d['rel']:.3e} (bound {FLOW_TOL:g}, each "
                  f"plane and trial)  zero planes exact {d['zero']}  {d['ms']:.4f} ms  plain "
                  f"{d['plain_ms']:.4f} ms  bound {d['bound_ms']:.4f} ms ({d['bound_by']})  "
                  f"[{N_MAP}^2; {card}]")
    for name, d in flows.items():
        k3 = f"; vs K3/K4 flow {d['k3']:.3e}" if "k3" in d else ""
        print(f"phase 8: uni flow {name:14s} rel err vs plain {d['rel']:.3e}{k3} (bound "
              f"{FLOW_TOL:g})  uni {d['ms']:.3f} ms  plain {d['plain_ms']:.3f} ms  "
              f"[{N_MAP}^2 P, nsteps={NSTEPS}; {card}]")
    print(f"phase 8: un-hoisted dphi vs hoisted {dphi_err['hoisted']:.3e}, vs float64 "
          f"{dphi_err['float64']:.3e} (bound {DPHI_UNHOISTED_TOL:g})")
    print(f"phase 8: lnP uni {float(v)!r}; grad rel max-abs err vs kernel backend {gerr:.3e} "
          f"(bound {GRAD_TOL_1024:g}); gradlnP uni {grad_ms:.3f} ms [{N_MAP}^2 P; {card}]")
    bad = {f"role {r}{lab}": d["rel"] for lab, res in (("", one), (f"[{NTRIAL}]", many))
           for r, d in res.items() if not (d["rel"] < FLOW_TOL and d["zero"])}
    bad.update({k: d["rel"] for k, d in flows.items() if not d["rel"] < FLOW_TOL})
    bad.update({k + " vs K3/K4": d["k3"] for k, d in flows.items()
                if "k3" in d and not d["k3"] < FLOW_TOL})
    bad.update({"dphi vs " + k: e for k, e in dphi_err.items() if not e < DPHI_UNHOISTED_TOL})
    if not (torch.isfinite(g.arr).all() and gerr < GRAD_TOL_1024):
        bad["gradient"] = gerr
    if bad:
        raise AssertionError(f"uni path disagrees: {bad}")

    with ct.lenseflow_backend_ctx("uni"):
        launches, s_step, hist = run_map(torch, gctx["sim"], 8, "uni", card)
    gctx["map_hist_uni"], gctx["map_s_uni"] = hist, s_step
    khist = gctx["map_hist"]
    print(f"phase 8: beside phase 7 (kernel): logpdfs {[h['logpdf'] for h in khist]!r}; alphas "
          f"{[h['alpha'] for h in khist]!r}")
    if min(launches[k] for k in UNI_KERNELS) <= 0:
        raise AssertionError(f"a kernel of the uni path never launched in MAP_joint: {launches}")
    k34 = {k: launches[k] for k in ("fa_velocity_forward", "fa_velocity_adjoint", "bv_velocity")
           if launches[k]}
    if k34:
        raise AssertionError(f"K3/K4 launched on the uni backend: {k34}")
    for role, d in one.items():
        d["batched"] = many[role]
    return {f"uni_role{r}": d for r, d in one.items()}, launches, grad_ms, s_step


def split_ratio(high, plain, strict):
    """Relative Frobenius distances of a 'high' result, plane by plane
    (leading axes flattened): to its plain 'high' version (largest), to
    the strict result (least), and the largest ratio of the two."""
    trip = list(zip(*(x.reshape(-1, *x.shape[-2:]) for x in (high, plain, strict))))
    return dict(fro=max(fro(h, q) for h, q, _ in trip),
                fro_strict=min(fro(h, st) for h, _, st in trip),
                split_ratio=max(fro(h, q) / fro(h, st) for h, q, st in trip))


def high_against(torch, kernel, plain, shape, tier="high"):
    """kernel(out, precision) at `tier` ('high' or 'bf16') and at 'f32',
    and plain(out), its plain version at `tier`, each into a NaN-filled
    buffer of `shape`; every output plane on its own: rel max-abs to the
    plain version and to strict (largest of the planes) and the Frobenius
    distances and ratio."""
    oh, op, ost = (torch.full(shape, float("nan"), device=DEVICE) for _ in range(3))
    kernel(oh, tier)
    plain(op)
    kernel(ost, "f32")
    torch.cuda.synchronize()
    trip = list(zip(*(x.reshape(-1, *shape[-2:]) for x in (oh, op, ost))))
    return dict(max_abs_err=float((oh - op).abs().max()), rel=max(rel(h, q) for h, q, _ in trip),
                rel_strict=max(rel(h, st) for h, _, st in trip), **split_ratio(oh, op, ost))


def high_failures(found):
    """The entries of `found` (name -> high_against's dict) outside
    HIGH_TOL, HIGH_VS_STRICT or HIGH_SPLIT_RATIO."""
    bad = {k: d["rel"] for k, d in found.items() if not d["rel"] < HIGH_TOL}
    bad.update({k + " vs strict": d["rel_strict"] for k, d in found.items()
                if not d["rel_strict"] < HIGH_VS_STRICT})
    bad.update({k + " ratio": d["split_ratio"] for k, d in found.items()
                if not d["split_ratio"] < HIGH_SPLIT_RATIO})
    return bad


def phase_high(torch, card, fctx, gctx):
    """The 'high' tier at 1024^2 P: (a) K1, K3 (batch 1 and NTRIAL) and K4
    against their plain 'high' versions (HIGH_TOL, every output plane of
    every entry on its own) and the strict kernels (HIGH_VS_STRICT), with
    device ms beside the strict kernel's and the 'high' bound; (b) the
    'high' flows against their plain 'high' versions and the strict flows;
    (c) the phi-gradient under precision_ctx("high") against the strict
    one; (d) argmaxf_logpdf with the JAX default CG at "auto" against
    strict; (e) MAP_joint as scripts/map_1024.py runs it, at its default
    precision "auto"."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import deriv, lenseflow_kernels as lfk
    ops, phi, f, dy = (fctx[k] for k in ("ops", "phi", "f", "dy"))
    t, nan = 0.5, float("nan")
    planes_of = lambda x: x.reshape(-1, N_MAP, N_MAP)
    out = {}

    def check(name, args, shape, kernel, plain, nder, planes, nb=1, axes=2, reps=10):
        """kernel(o, precision, *args) at 'high' against plain(o, *args)
        and at 'f32', every output plane on its own: rel max-abs, and
        relative Frobenius distance to plain 'high' over that to strict.
        Both tiers are timed cold (cold_ms)."""
        oh, op, ost = (torch.full(shape, nan, device=DEVICE) for _ in range(3))
        kernel(oh, "high", *args)
        plain(op, *args)
        kernel(ost, "f32", *args)
        torch.cuda.synchronize()
        trip = list(zip(planes_of(oh), planes_of(op), planes_of(ost)))
        out[name] = dict(
            nb=nb, max_abs_err=float((oh - op).abs().max()),
            rel=max(rel(h, q) for h, q, _ in trip),
            rel_strict=max(rel(h, st) for h, _, st in trip), **split_ratio(oh, op, ost),
            ms=cold_ms(lambda *a: kernel(a[0], "high", *a[1:]), (oh, *args), reps, torch),
            strict_ms=cold_ms(lambda *a: kernel(a[0], "f32", *a[1:]), (ost, *args), reps, torch),
            plain_ms=cuda_ms(lambda: plain(op, *args), 3, torch), library_ms=None,
            **bound_high(N_MAP, nder, planes, nb, axes))

    # single derivatives: a plane in, a plane out, one axis' operands;
    # d_x a + d_y b + c: three in, one out, both axes
    a, b, c = f[0:1].contiguous(), f[1:2].contiguous(), dy[0:1].contiguous()
    for name, args, nder, planes, axes in (("fderiv_x", (a, None, None), 1, 2, 1),
                                           ("fderiv_y", (None, b, None), 1, 2, 1),
                                           ("fderiv", (a, b, c), 2, 4, 2)):
        check(name, args, a.shape, lambda o, p, *x: lfk.fderiv_cuda(*x, o, ops, p),
              lambda o, *x: lfk.fderiv_plain(*x, o, ops, "high"), nder, planes, axes=axes)
    DxT, _ = deriv.deriv_mats(ct.ProjLambert(N_MAP, N_MAP, thetapix=THETAPIX_MAP, T=np.float32,
                                             device=DEVICE))
    # the library yardstick of a 'high' d_x: the split's three bf16 matmuls
    out["fderiv_x"]["library_ms"] = split_matmuls_ms(a[0], DxT, True, torch)
    phi1, y = phi[None], f[None].contiguous()
    pt1 = torch.empty((2, 1, N_MAP, N_MAP), device=DEVICE)
    lfk.p_planes_cuda(t, phi1, pt1)
    for kind in ("forward", "adjoint"):
        check("fa_velocity_" + kind, (y, phi1, pt1), y.shape,
              lambda o, p, y_, ph, pt: lfk.fvelocity_cuda(kind, y_, o, ph, pt, ops, 2, t, p),
              lambda o, y_, ph, pt: lfk.fvelocity_plain(kind, y_, o, ph, pt, ops, 2, t, "high"),
              4, 6)
    acc = 1e-3 * torch.as_tensor(np.random.default_rng(SEED + 1).standard_normal(
        (1, lfk.NACC, N_MAP, N_MAP)).astype(np.float32), device=DEVICE)
    yb = torch.cat([f[None], dy[None], acc], dim=1)
    check("bv_velocity", (yb, phi1, pt1), yb.shape,
          lambda o, p, y_, ph, pt: lfk.fvelocity_cuda("backward", y_, o, ph, pt, ops, 2, t, p),
          lambda o, y_, ph, pt: lfk.fvelocity_plain("backward", y_, o, ph, pt, ops, 2, t, "high"),
          8, 25)
    # the line search's batch shape (the 17 trials run strict in MAP_joint,
    # but the kernels take any batch)
    scales = torch.linspace(0.1, 2.0, NTRIAL, device=DEVICE).reshape(-1, 1, 1, 1)
    phis = (scales * phi).contiguous()
    ys = torch.stack([torch.roll(f, 7 * i, dims=-1) for i in range(NTRIAL)])
    pts = torch.empty((2, NTRIAL, N_MAP, N_MAP), device=DEVICE)
    lfk.p_planes_cuda(t, phis, pts)
    for kind in ("forward", "adjoint"):
        check(f"fa_velocity_{kind}[{NTRIAL}]", (ys, phis, pts), ys.shape,
              lambda o, p, y_, ph, pt: lfk.fvelocity_cuda(kind, y_, o, ph, pt, ops, 2, t, p),
              lambda o, y_, ph, pt: lfk.fvelocity_plain(kind, y_, o, ph, pt, ops, 2, t, "high"),
              4, 6, nb=NTRIAL, reps=5)
    del ys, pts, phis
    for name, d in out.items():
        print(f"phase 9: 'high' kernel {name:24s} vs plain 'high' {d['rel']:.3e} (bound "
              f"{HIGH_TOL:g}, each plane)  vs strict {d['rel_strict']:.3e} (bound "
              f"{HIGH_VS_STRICT:g}); Frobenius vs plain 'high' {d['fro']:.3e}, vs strict "
              f"{d['fro_strict']:.3e} (least), ratio {d['split_ratio']:.3f} (bound "
              f"{HIGH_SPLIT_RATIO:g}, each plane)  {d['ms']:.4f} ms  strict {d['strict_ms']:.4f} "
              f"ms (both cold)  plain {d['plain_ms']:.4f} ms  library {d['library_ms']}  'high' "
              f"bound {d['bound_ms']:.4f} ms ({d['bound_by']}, {100 * d['bound_ms'] / d['ms']:.1f} "
              f"%)  [{N_MAP}^2; {card}]")

    # (b) whole flows at 'high' on phase 5's inputs
    flows = {}
    for name, (t0, t1, kind) in (("L", (0., 1., "forward")), ("L^-1", (1., 0., "forward")),
                                 ("L^H", (1., 0., "adjoint"))):
        run = lambda fn, p="high": fn(f, phi, ops, t0, t1, NSTEPS, kind, p)
        kv, pv = run(lfk.flow_apply), run(lfk.flow_apply_plain)
        flows[name] = dict(rel=rel(kv, pv), strict=rel(kv, fctx["flows"][name]),
                           **split_ratio(kv, pv, fctx["flows"][name]),
                           ms=cuda_ms(lambda: run(lfk.flow_apply), 3, torch),
                           strict_ms=cuda_ms(lambda: run(lfk.flow_apply, "f32"), 3, torch))
    bwd = lambda fn, p="high": fn(dy, f, phi, ops, 0., 1., NSTEPS, p)
    (dphi_k, df0_k), (dphi_p, df0_p) = bwd(lfk.flow_bwd), bwd(lfk.flow_bwd_plain)
    bwd_ms = cuda_ms(lambda: bwd(lfk.flow_bwd), 3, torch)
    bwd_strict_ms = cuda_ms(lambda: bwd(lfk.flow_bwd, "f32"), 3, torch)
    flows["backward df0"] = dict(rel=rel(df0_k, df0_p), strict=rel(df0_k, fctx["flows"]["df0"]),
                                 **split_ratio(df0_k, df0_p, fctx["flows"]["df0"]),
                                 ms=bwd_ms, strict_ms=bwd_strict_ms)
    flows["backward dphi"] = dict(rel=rel(dphi_k, dphi_p),
                                  strict=rel(dphi_k, fctx["flows"]["dphi"]),
                                  **split_ratio(dphi_k, dphi_p, fctx["flows"]["dphi"]), ms=bwd_ms,
                                  strict_ms=bwd_strict_ms)
    # grad/Hess phi at 'high': the derivatives of a Cphi-drawn phi are small
    # against the operand whose split rounding they inherit, and the Hessian
    # planes differentiate it once more, so only the Frobenius ratio is held
    gh, ghp = (fn(fctx["phi_map"], ops, "high") for fn in (lfk.gradhess, lfk.gradhess_plain))
    gh_ratio = split_ratio(gh, ghp, phi)
    print(f"phase 9: 'high' gradhess vs plain 'high', per plane (gx, gy, hxx, hxy, hyy): "
          f"{[f'{rel(gh[i], ghp[i]):.3e}' for i in range(5)]}; vs strict "
          f"{[f'{rel(gh[i], phi[i]):.3e}' for i in range(5)]}; Frobenius ratio "
          f"{gh_ratio['split_ratio']:.3f} (bound {HIGH_SPLIT_RATIO:g}, each plane)")
    for name, d in flows.items():
        print(f"phase 9: 'high' flow {name:14s} vs plain 'high' {d['rel']:.3e} (bound "
              f"{HIGH_TOL:g})  vs strict {d['strict']:.3e}; Frobenius vs plain 'high' "
              f"{d['fro']:.3e}, vs strict {d['fro_strict']:.3e}, ratio {d['split_ratio']:.3f} "
              f"(bound {FLOW_SPLIT_RATIO:g})  {d['ms']:.3f} ms  strict {d['strict_ms']:.3f} ms  "
              f"[{N_MAP}^2 P, nsteps={NSTEPS}; {card}]")

    # (c) the phi-gradient at 'high' against the strict one (phase 6)
    with ct.lenseflow_backend_ctx("kernel"), deriv.precision_ctx("high"):
        _, g = gctx["vg"](gctx["phi_mix"])
        grad_ms = cuda_ms(lambda: gctx["vg"](gctx["phi_mix"]), 3, torch)
    gs = gctx["grad"].arr
    gerr = rel(g.arr, gs)
    cos = float((g.arr.double() * gs.double()).sum() / (g.arr.double().norm() * gs.double().norm()))
    print(f"phase 9: gradlnP 'high' vs strict: rel max-abs {gerr:.3e}, cosine {cos:.9f}; "
          f"{grad_ms:.3f} ms ('f32' {gctx['grad_ms']:.3f} ms) [{N_MAP}^2 P; {card}]")

    # (d) the Wiener filter at the JAX default CG (tol 0.1, up to 500 iterations)
    sim = gctx["sim"]
    wf = {}
    for hp in ("auto", None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fw, info = ct.argmaxf_logpdf(sim["ds"], phi=sim["phi"],
                                     conjgrad_kwargs=dict(hessian_precision=hp))
        torch.cuda.synchronize()
        wf[hp] = (fw, info, 1e3 * (time.perf_counter() - t0))
    fa_, fs_ = wf["auto"][0].arr, wf[None][0].to(wf["auto"][0].basis).arr
    wf_err = float((fa_ - fs_).norm() / fs_.norm())
    ia = wf["auto"][1]
    # the 'high' solve's own check, which a fallback's info no longer holds
    from cmblensing_tpu_torch.inference.maximization import _argmaxf_core
    with torch.no_grad():
        _, ih = _argmaxf_core(sim["ds"], {}, sim["phi"], sim["ds"].d, None, False, "high",
                              tol=1e-1, nsteps=500)
    print(f"phase 9: the 'high' solve's check: {ih['iterations']} iterations, res "
          f"{float(ih['res']):.4e} (its own operator), res_strict {float(ih['res_strict']):.4e} "
          f"against max(tol 0.1, 1e-10 res0), res0 {float(ih['res0']):.4e}")
    print(f"phase 9: argmaxf_logpdf (tol 0.1, nsteps 500) \"auto\": {ia['iterations']} iterations, "
          f"precision_ok {bool(ia.get('precision_ok', False))}, precision_fallback "
          f"{bool(ia.get('precision_fallback', False))}, {wf['auto'][2]:.1f} ms; strict: "
          f"{wf[None][1]['iterations']} iterations, {wf[None][2]:.1f} ms; |f_auto - f_strict| / "
          f"|f_strict| = {wf_err:.3e} (bound {WF_HIGH_TOL:g}) [{N_MAP}^2 P; {card}]")

    bad = {k: d["rel"] for k, d in out.items() if not d["rel"] < HIGH_TOL}
    bad.update({k + " vs strict": d["rel_strict"] for k, d in out.items()
                if not d["rel_strict"] < HIGH_VS_STRICT})
    bad.update({"flow " + k: d["rel"] for k, d in flows.items() if not d["rel"] < HIGH_TOL})
    bad.update({k + " Frobenius ratio": d["split_ratio"]
                for k, d in [*out.items(), ("gradhess", gh_ratio)]
                if not d["split_ratio"] < HIGH_SPLIT_RATIO})
    bad.update({"flow " + k + " Frobenius ratio": d["split_ratio"] for k, d in flows.items()
                if not d["split_ratio"] < FLOW_SPLIT_RATIO})
    if not torch.isfinite(g.arr).all():
        bad["gradient"] = "not finite"
    if not wf_err < WF_HIGH_TOL:
        bad["argmaxf"] = wf_err
    if bad:
        raise AssertionError(f"'high' tier disagrees: {bad}")

    # (e) the north star at the JAX default precision "auto"
    with ct.lenseflow_backend_ctx("kernel"):
        launches, s_step, hist = run_map(torch, sim, 9, "kernel, precision \"auto\"", card,
                                         precision="auto")
    gctx["map_hist_auto"], gctx["map_s_auto"] = hist, s_step
    khist = gctx["map_hist"]
    print(f"phase 9: beside phase 7 (strict): logpdfs {[h['logpdf'] for h in khist]!r}; alphas "
          f"{[h['alpha'] for h in khist]!r}")
    print(f"phase 9: f-steps re-run strict {sum(h['precision_fallback'] for h in hist)} of "
          f"{len(hist)}; direction retries fired {sum(h['retry'] for h in hist)}")
    if min(launches[k] for k in HIGH_KERNELS) <= 0:
        raise AssertionError(f"a 'high' kernel never launched in the \"auto\" MAP_joint: {launches}")
    return out, launches, dict(gradlnP_1024_high=grad_ms, argmaxf_1024_auto_ms=wf["auto"][2],
                               argmaxf_1024_strict_ms=wf[None][2],
                               MAP_joint_1024_auto_s_per_step=s_step)


def phase_edges(torch, card):
    """Phase 10: K2's derivative, p(t) and the RK4 update at plane shapes
    the 32 x 32 tile does not divide, every tier, every plane against the
    plain version at the same precision (DENSE_TIER_TOL), nothing written
    past the last plane (the flow kernel there: phase 18); one L @ f on a
    200^2 load_sim on the kernel backend against the plain (cuFFT)
    backend."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import deriv, lenseflow_kernels as lfk
    nan, t, found = float("nan"), 0.4, {}
    for Ny, Nx in EDGE_SHAPES:
        proj = ct.ProjLambert(Ny, Nx, thetapix=3, T=np.float32, device=DEVICE)
        mats = deriv.deriv_mats(proj)
        rng = np.random.default_rng(SEED + 2)
        T = lambda *sh: torch.as_tensor(rng.standard_normal(sh).astype(np.float32), device=DEVICE)
        phi_f = np.zeros((1, Ny, Nx // 2 + 1), np.complex128)
        phi_f[0, 1, 1] = 1e-3 * (Ny * Nx / 1024) ** 2   # Hess phi ~ 0.1
        phi = lfk.gradhess_plain(torch.as_tensor(np.fft.irfft2(phi_f, s=(Ny, Nx)).astype(
            np.float32), device=DEVICE), mats)
        a, b, c = T(1, Ny, Nx), T(1, Ny, Nx), T(1, Ny, Nx)

        def check(name, p, n, kernel, plain):
            full = torch.full((n + 1, Ny, Nx), nan, device=DEVICE)
            ref = torch.empty((n, Ny, Nx), device=DEVICE)
            kernel(full[:n])
            plain(ref)
            found[(name, Ny, Nx, p)] = (max(rel(x, y) for x, y in zip(full[:n], ref)),
                                        bool(torch.isnan(full[n]).all()))

        for p in lfk.PRECISIONS:
            for name, args in (("deriv_x", (a, None, None)), ("deriv", (a, b, c))):
                check(name, p, 1, lambda o: lfk.deriv_cuda(*args, o, mats, p),
                      lambda o: lfk.deriv_plain(*args, o, mats, p))
        check("p_planes", "f32", 2, lambda o: lfk.p_planes_cuda(t, phi, o),
              lambda o: lfk.p_planes_plain(t, phi, o))
        y, k = T(9, Ny, Nx), T(9, Ny, Nx)
        rk = [torch.zeros((2, 9, Ny, Nx), device=DEVICE) for _ in range(2)]
        for fn, (acc, s_) in zip((lfk.rk4_update_cuda, lfk.rk4_update_plain), rk):
            fn(y, k, acc, s_, 1, 1 / 21, 1 / 14)
        found[("rk4_update", Ny, Nx, "f32")] = (rel(rk[0], rk[1]), True)
    torch.cuda.synchronize()
    for (name, Ny, Nx, p), (e, clean) in found.items():
        print(f"phase 10: {name:18s} {Ny}x{Nx} {p:4s} rel err vs plain {e:.3e} (bound "
              f"{DENSE_TIER_TOL[p]:g}, each plane); past the last plane "
              f"{'untouched' if clean else 'WRITTEN'}")
    sim = ct.load_sim(thetapix=3, Nside=200, pol="P", T=np.float32, seed=SEED, device=DEVICE)
    L = ct.LenseFlow(sim["phi"], NSTEPS)
    fq = sim["f"].to(ct.QU_MAP)
    with ct.lenseflow_backend_ctx("kernel"):
        lk = (L @ fq).arr
    with ct.lenseflow_backend_ctx("plain"):
        lp = (L @ fq).arr
    lerr = rel(lk, lp)
    print(f"phase 10: L @ f on load_sim(Nside=200, pol P): kernel vs plain backend {lerr:.3e} "
          f"(bound {GRAD_TOL:g})")
    bad = {k: v for k, v in found.items() if not (v[1] and v[0] < DENSE_TIER_TOL[k[3]])}
    if not (torch.isfinite(lk).all() and lerr < GRAD_TOL):
        bad["L @ f"] = lerr
    if bad:
        raise AssertionError(f"edge tiles disagree: {bad}")


def phase_dense_high(torch, card, ds, f_mix, phi_mix, strict):
    """Phase 11: K2 'high' at 256^2 P. (a) The derivative, one launch
    each (the flow kernel's own checks: phase 18), against its plain 'high' version
    (HIGH_TOL) and the strict kernel (HIGH_VS_STRICT), every output plane
    on its own, with the Frobenius ratio (HIGH_SPLIT_RATIO), device ms
    cold beside the strict kernel's (cold too), the 'high' bound and the
    three bf16 matmuls of the split; (b) the 'high' flows against the plain
    'high' flows and the strict ones (HIGH_TOL, FLOW_SPLIT_RATIO); (c) the
    phi-gradient at 'high' against the strict one and the plain 'high'
    one (the "matmul" backend; FLOW_SPLIT_RATIO per plane), with its ms; (d) two steps of
    MAP_joint at its defaults ("auto"), the launch counters set to 0 just
    before and read just after: finite, non-decreasing logpdfs, every K2
    'high' kernel launched (the kernels line reports these counts)."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import deriv, lenseflow_kernels as lfk
    proj = ct.ProjLambert(N, N, thetapix=3, T=np.float32, device=DEVICE)
    mats = deriv.deriv_mats(proj)
    phi_map, f, dy = weak_lensing_inputs(proj, torch)
    phi = lfk.gradhess(phi_map, mats)
    out = {}

    def check(name, args, shape, kernel, plain, nder, planes):
        o = torch.empty(shape, device=DEVICE)
        out[name] = dict(
            **high_against(torch, lambda o_, p: kernel(o_, p, *args), lambda o_: plain(o_, *args),
                           shape),
            ms=cold_ms(lambda *a: kernel(a[0], "high", *a[1:]), (o, *args), 20, torch),
            strict_ms=cold_ms(lambda *a: kernel(a[0], "f32", *a[1:]), (o, *args), 20, torch),
            plain_ms=cuda_ms(lambda: plain(o, *args), 5, torch), library_ms=None,
            **bound_dense_high(N, nder, planes))

    a, b, c = f[0:1].contiguous(), f[1:2].contiguous(), dy[0:1].contiguous()
    for name, args, nder, planes in (("deriv", (a, None, None), 1, 3),
                                     ("deriv_xy", (a, b, c), 2, 6)):
        check(name, args, a.shape, lambda o, p, *x: lfk.deriv_cuda(*x, o, mats, p),
              lambda o, *x: lfk.deriv_plain(*x, o, mats, "high"), nder, planes)
    out["deriv"]["library_ms"] = split_matmuls_ms(a[0], mats[0], True, torch)
    for name, d in out.items():
        print(f"phase 11: 'high' kernel {name:18s} vs plain 'high' {d['rel']:.3e} (bound "
              f"{HIGH_TOL:g}, each plane)  vs strict {d['rel_strict']:.3e} (bound "
              f"{HIGH_VS_STRICT:g}); Frobenius ratio {d['split_ratio']:.3f} (bound "
              f"{HIGH_SPLIT_RATIO:g})  {d['ms']:.4f} ms  strict {d['strict_ms']:.4f} ms (both "
              f"cold; phase 2's strict, L2-resident: "
              f"{strict.get(name, {}).get('ms', float('nan')):.4f})  plain {d['plain_ms']:.4f} ms  "
              f"library {d['library_ms']}  'high' bound {d['bound_ms']:.4f} ms ({d['bound_by']}, "
              f"{100 * d['bound_ms'] / d['ms']:.1f} %)  [{N}^2; {card}]")

    # (b) whole flows at 'high'
    flows = {}
    for name, (t0, t1, kind) in (("L", (0., 1., "forward")), ("L^-1", (1., 0., "forward")),
                                 ("L^H", (1., 0., "adjoint"))):
        run = lambda fn, p="high": fn(f, phi, mats, t0, t1, NSTEPS, kind, p)
        kv, pv, sv = run(lfk.flow_apply), run(lfk.flow_apply_plain), run(lfk.flow_apply, "f32")
        flows[name] = dict(rel=rel(kv, pv), strict=rel(kv, sv), **split_ratio(kv, pv, sv),
                           ms=cuda_ms(lambda: run(lfk.flow_apply), 5, torch),
                           strict_ms=cuda_ms(lambda: run(lfk.flow_apply, "f32"), 5, torch))
    bwd = lambda fn, p="high": fn(dy, f, phi, mats, 0., 1., NSTEPS, p)
    for name, kv, pv, sv in zip(("backward dphi", "backward df0"), bwd(lfk.flow_bwd),
                                bwd(lfk.flow_bwd_plain), bwd(lfk.flow_bwd, "f32")):
        flows[name] = dict(rel=rel(kv, pv), strict=rel(kv, sv), **split_ratio(kv, pv, sv),
                           ms=cuda_ms(lambda: bwd(lfk.flow_bwd), 5, torch),
                           strict_ms=cuda_ms(lambda: bwd(lfk.flow_bwd, "f32"), 5, torch))
    for name, d in flows.items():
        print(f"phase 11: 'high' flow {name:14s} vs plain 'high' {d['rel']:.3e} (bound "
              f"{HIGH_TOL:g})  vs strict {d['strict']:.3e}; Frobenius ratio "
              f"{d['split_ratio']:.3f} (bound {FLOW_SPLIT_RATIO:g})  {d['ms']:.3f} ms  strict "
              f"{d['strict_ms']:.3f} ms  [{N}^2 P, nsteps={NSTEPS}; {card}]")

    # (c) the phi-gradient at 'high' against strict and the plain 'high' one
    vg = ct.fvalue_and_grad(lambda p: ct.Mixed(ds).logpdf(f_mix=f_mix, phi_mix=p))
    with ct.lenseflow_backend_ctx("kernel"):
        _, gs = vg(phi_mix)
        strict_ms = cuda_ms(lambda: vg(phi_mix), 5, torch)
        with deriv.precision_ctx("high"):
            _, gh = vg(phi_mix)
            high_ms = cuda_ms(lambda: vg(phi_mix), 5, torch)
    # the reference: the same flows on their plain 'high' leaves, which
    # launch no kernel
    with ct.lenseflow_backend_ctx("matmul"), deriv.precision_ctx("high"):
        lfk.reset_launches()
        _, gp = vg(phi_mix)
        ref_launches = sum(lfk.LAUNCHES.values())
    grad = dict(rel=rel(gh.arr, gp.arr), strict=rel(gh.arr, gs.arr),
                **split_ratio(gh.arr, gp.arr, gs.arr), ms=high_ms, strict_ms=strict_ms)
    print(f"phase 11: gradlnP 'high' vs plain 'high' {grad['rel']:.3e}, vs strict "
          f"{grad['strict']:.3e}; Frobenius ratio {grad['split_ratio']:.3f} (bound "
          f"{FLOW_SPLIT_RATIO:g}); {high_ms:.3f} ms ('f32' {strict_ms:.3f} ms) [{N}^2 P; {card}]")

    # (d) MAP_joint at its defaults, two steps
    with ct.lenseflow_backend_ctx("kernel"):
        lfk.reset_launches()
        t0 = time.perf_counter()
        res = ct.MAP_joint(ds, nsteps=2, history_keys=("logpdf", "alpha", "cg_iters",
                                                       "precision_fallback"))
        torch.cuda.synchronize()
        map_s = time.perf_counter() - t0
        map_launches = dict(lfk.LAUNCHES)
    hist = res["history"]
    lps = [h["logpdf"] for h in hist]
    print(f"phase 11: MAP_joint {N}^2 P at \"auto\", 2 steps {map_s:.2f} s: logpdfs {lps!r}; "
          f"alphas {[h['alpha'] for h in hist]!r}; CG iters {[h['cg_iters'] for h in hist]}; "
          f"fallbacks {[h['precision_fallback'] for h in hist]}; launches "
          f"{ {k: v for k, v in map_launches.items() if v} } [{card}]")

    bad = high_failures(out)
    if ref_launches:
        bad["plain 'high' gradient launches"] = ref_launches
    bad.update({"flow " + k: d["rel"] for k, d in flows.items() if not d["rel"] < HIGH_TOL})
    bad.update({"flow " + k + " ratio": d["split_ratio"] for k, d in
                [*flows.items(), ("gradient", grad)] if not d["split_ratio"] < FLOW_SPLIT_RATIO})
    if not torch.isfinite(gh.arr).all():
        bad["gradient"] = "not finite"
    if not all(np.isfinite(lps)) or any(y < x for x, y in zip(lps, lps[1:])):
        bad["MAP_joint logpdf"] = lps
    if min(map_launches[k] for k in DENSE_HIGH_KERNELS) <= 0:
        bad["MAP_joint 'high' launches"] = map_launches
    if bad:
        raise AssertionError(f"K2 'high' disagrees: {bad}")
    return out, map_launches, dict(gradlnP_256_high=high_ms, gradlnP_256_strict=strict_ms,
                                   MAP_joint_256_auto_2_steps_s=map_s)


def phase_wiener(torch, card):
    """Phase 12, the slice: load_sim at WF_SIM; (a) K2's 'high' derivative
    on the slice's own inputs, I, Q and U on the grid's z axis, against
    its plain 'high' version and the strict kernel (HIGH_TOL,
    HIGH_VS_STRICT, HIGH_SPLIT_RATIO, every plane); (b)
    argmaxf_logpdf at the JAX defaults (tol 0.1, nsteps 500, "auto") with
    the launch counters set to 0 just before and read just after, the
    'high' solve's own strict check (res_strict) reported; the strict solve
    (hessian_precision=None) beside it (f within WF_HIGH_TOL in norm); (c)
    20 fixed iterations, strict, of the kernel backend against the plain
    one (WF_PLAIN_TOL), and at 'high' against the "matmul" backend (the
    same flows on their plain 'high' leaves: WF_PLAIN_TOL, and nearer it
    than the strict solve, FLOW_SPLIT_RATIO), whatever the fallback does.
    Returns (the "auto" solve's launches, timings, wctx): wctx holds the
    simulation and the kernel backend's solves of it, for phases 14 (g)
    and 15 (f) to compare with, not to re-run."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.inference import maximization as tm
    from cmblensing_tpu_torch.ops import deriv, lenseflow_kernels as lfk
    t0 = time.perf_counter()
    sim = ct.load_sim(**WF_SIM, device=DEVICE)
    ds, phi = sim["ds"], sim["phi"]
    torch.cuda.synchronize()
    print(f"phase 12: load_sim {WF_SIM}: {time.perf_counter() - t0:.2f} s [{card}]")

    # (a) the 'high' derivative at the shapes the IP flows give it (the flow
    # kernel on them: phase 18)
    mats = deriv.deriv_mats(phi.proj)
    f = sim["f"].to(ct.IQU_MAP).arr.contiguous()
    d = ds.d.to(ct.IQU_MAP).arr.contiguous()
    ncomp = f.shape[-3]
    kernels = {name: high_against(torch, lambda o, p: lfk.deriv_cuda(*args, o, mats, p),
                                  lambda o: lfk.deriv_plain(*args, o, mats, "high"), f.shape)
               for name, args in (("deriv", (f, None, None)), ("deriv_xy", (f, d, f)))}
    for name, r in kernels.items():
        print(f"phase 12: 'high' kernel {name:18s} on {ncomp} x {N}^2 vs plain 'high' "
              f"{r['rel']:.3e} (bound {HIGH_TOL:g}, each plane)  vs strict {r['rel_strict']:.3e} "
              f"(bound {HIGH_VS_STRICT:g}); Frobenius ratio {r['split_ratio']:.3f} (bound "
              f"{HIGH_SPLIT_RATIO:g})")

    # (b) the JAX defaults, and strict
    solves, core = [], tm._argmaxf_core

    def spy(*a, **k):
        x, info = core(*a, **k)
        solves.append(dict(info))
        return x, info

    def solve(**cg):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fw, info = ct.argmaxf_logpdf(ds, phi=phi, conjgrad_kwargs=cg or None)
        torch.cuda.synchronize()
        return fw, info, 1e3 * (time.perf_counter() - t)

    with ct.lenseflow_backend_ctx("kernel"):
        tm._argmaxf_core = spy
        try:
            lfk.reset_launches()
            fa, ia, ms_auto = solve()
            launches = dict(lfk.LAUNCHES)
        finally:
            tm._argmaxf_core = core
        fs, is_, ms_strict = solve(hessian_precision=None)
    hi = solves[0]
    fallback = bool(ia.get("precision_fallback", False))
    norm_err = lambda x, y: float((x.arr - y.to(x.basis).arr).norm() / x.arr.norm())
    wf_err = norm_err(fs, fa)
    print(f"phase 12: argmaxf_logpdf \"auto\" (tol 0.1, nsteps 500): the 'high' solve "
          f"{hi['iterations']} iterations, res {float(hi['res']):.4e} (its own operator), "
          f"res_strict {float(hi['res_strict']):.4e} against max(tol 0.1, 1e-10 res0 = "
          f"{1e-10 * float(hi['res0']):.4e}); precision_fallback {fallback}; "
          f"{ia['iterations']} iterations returned, {ms_auto:.1f} ms [{card}]")
    print(f"phase 12: launches in the \"auto\" solve: "
          f"{ {k: v for k, v in launches.items() if v} }")
    print(f"phase 12: strict solve {is_['iterations']} iterations {ms_strict:.1f} ms; "
          f"|f_auto - f_strict| / |f_strict| = {wf_err:.3e} (bound {WF_HIGH_TOL:g})"
          + ("; after the fallback f_auto is a strict solve too" if fallback else ""))

    # (c) 20 fixed iterations: strict, kernel vs plain (cuFFT) backend;
    # 'high' throughout (b, a0 and every Hessian apply), kernel vs matmul
    fixed = dict(tol=0.0, nsteps=20, fixed_iters=True, hessian_precision=None)
    fixed_runs, fixed_launches, fixed_ms = {}, {}, {}
    for backend, p in (("kernel", "f32"), ("plain", "f32"), ("kernel", "high"), ("matmul", "high")):
        with ct.lenseflow_backend_ctx(backend), deriv.precision_ctx(p):
            lfk.reset_launches()
            fixed_runs[backend, p], _, ms = solve(**fixed)
            fixed_launches[backend, p] = dict(lfk.LAUNCHES)
        fixed_ms[backend, p] = ms
        print(f"phase 12: 20 fixed iterations, {backend} backend at {p!r}: {ms:.1f} ms [{card}]")
    fk, fp = fixed_runs["kernel", "f32"], fixed_runs["plain", "f32"]
    fhk, fhm = fixed_runs["kernel", "high"], fixed_runs["matmul", "high"]
    plain_err, high_err = norm_err(fp, fk), norm_err(fhm, fhk)
    high_ratio = high_err / norm_err(fk, fhk)
    print(f"phase 12: 20 fixed strict iterations, kernel vs plain backend |f_k - f_p| / |f_p| "
          f"= {plain_err:.3e} (bound {WF_PLAIN_TOL:g}); at 'high', kernel vs matmul backend "
          f"{high_err:.3e} (bound {WF_PLAIN_TOL:g}), over the distance to the strict kernel "
          f"solve {high_ratio:.3f} (bound {FLOW_SPLIT_RATIO:g})")
    bad = high_failures(kernels)
    if not all(torch.isfinite(x.arr).all() for x in (fa, fs, fk, fp, fhk, fhm)):
        bad["f"] = "not finite"
    if not wf_err < WF_HIGH_TOL:
        bad["auto vs strict"] = wf_err
    if not plain_err < WF_PLAIN_TOL:
        bad["kernel vs plain"] = plain_err
    if not (high_err < WF_PLAIN_TOL and high_ratio < FLOW_SPLIT_RATIO):
        bad["'high' kernel vs matmul"] = (high_err, high_ratio)
    wf_high = DENSE_HIGH_KERNELS[:2] + ("deriv_high",)
    if min(launches[k] for k in wf_high) <= 0:
        bad["'high' launches"] = launches
    if (min(fixed_launches["kernel", "high"][k] for k in wf_high) <= 0
            or any(fixed_launches["matmul", "high"].values())):
        bad["fixed 'high' launches"] = fixed_launches
    if bad:
        raise AssertionError(f"the masked IP Wiener filter disagrees: {bad}")
    wctx = dict(sim=sim, strict=(fs, is_, ms_strict),
                kernel={"kernel": (fa, ia, ms_auto, launches),
                        ("kernel", "fixed"): (fk, None, fixed_ms["kernel", "f32"],
                                              fixed_launches["kernel", "f32"])})
    return launches, dict(argmaxf_256_IP_auto_ms=ms_auto, argmaxf_256_IP_strict_ms=ms_strict,
                          argmaxf_256_IP_auto_iterations=int(ia["iterations"]),
                          argmaxf_256_IP_strict_iterations=int(is_["iterations"]),
                          argmaxf_256_IP_auto_fallback=fallback), wctx


def large_kernels(torch, card, N):
    """Phase 13 (a) at N^2: K1 (d_x, d_y), K3 (forward, adjoint; batch 1
    and NTRIAL) and K4 at radix N / FA, each at both tiers on the same
    inputs: strict against its plain version (FLOW_TOL, every output plane
    on its own), 'high' against plain 'high' and the strict kernel
    (HIGH_TOL, HIGH_VS_STRICT, HIGH_SPLIT_RATIO, every plane); both tiers
    timed cold, with their bounds, and the library call of K1's d_x
    (`a @ DxT`); each launched twice at each tier, bit for bit the same.
    Returns ({tier: {name: record}}, the inputs)."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import deriv, factored_deriv, lenseflow_kernels as lfk
    B = N // FA
    proj = ct.ProjLambert(N, N, thetapix=THETAPIX_MAP, T=np.float32, device=DEVICE)
    t0 = time.perf_counter()
    ops = deriv.deriv_ops(proj)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    if not isinstance(ops, factored_deriv.FactoredOps) or ops.FX.shape[0] != B:
        raise AssertionError(f"deriv_ops gives no radix-{B} factored operands at {N}^2")
    print(f"phase 13: factored operands at {N}^2 (radix {B}, host float64, and their split): "
          f"{host_s:.2f} s")
    phi_map, f, dy = weak_lensing_inputs(proj, torch)
    phi = lfk.gradhess(phi_map, ops)
    planes_of = lambda x: x.reshape(-1, N, N)
    nan, t = float("nan"), 0.5
    out = {"f32": {}, "high": {}}

    def check(name, args, shape, kernel, plain, nder, planes, nb=1, axes=2, reps=5):
        """kernel(o, precision, *args) and plain(o, precision, *args) at both
        tiers, every output plane on its own."""
        ost, opl, oh, oph = (torch.full(shape, nan, device=DEVICE) for _ in range(4))
        kernel(ost, "f32", *args)
        plain(opl, "f32", *args)
        kernel(oh, "high", *args)
        plain(oph, "high", *args)
        # each pixel pair is one thread's, its sums in a fixed order: a
        # second launch into a buffer of other contents gives the same bits
        for o, p in ((ost, "f32"), (oh, "high")):
            again = torch.zeros(shape, device=DEVICE)
            kernel(again, p, *args)
            if not torch.equal(again, o):
                raise AssertionError(f"radix-{B} {name} {p}: two launches differ")
            del again
        torch.cuda.synchronize()
        strict = list(zip(planes_of(ost), planes_of(opl)))
        trip = list(zip(planes_of(oh), planes_of(oph), planes_of(ost)))
        floats = (1 if axes == 1 else 2) * (B * FA * FA + 2 * B * B)
        out["f32"][name] = dict(
            nb=nb, max_abs_err=float((ost - opl).abs().max()),
            rel=max(rel(k, p) for k, p in strict),
            ms=cold_ms(lambda *a: kernel(a[0], "f32", *a[1:]), (ost, *args), reps, torch),
            plain_ms=cuda_ms(lambda: plain(opl, "f32", *args), 1, torch), library_ms=None,
            **bound(nb * nder * fact_deriv_flops(N), nb * planes, N, floats))
        out["high"][name] = dict(
            nb=nb, max_abs_err=float((oh - oph).abs().max()),
            rel=max(rel(h, q) for h, q, _ in trip),
            rel_strict=max(rel(h, st) for h, _, st in trip), **split_ratio(oh, oph, ost),
            ms=cold_ms(lambda *a: kernel(a[0], "high", *a[1:]), (oh, *args), reps, torch),
            plain_ms=cuda_ms(lambda: plain(oph, "high", *args), 1, torch), library_ms=None,
            **bound_high(N, nder, planes, nb, axes))
        del ost, opl, oh, oph

    a, b = f[0:1].contiguous(), f[1:2].contiguous()
    for name, args, axes in (("fderiv_x", (a, None, None), 1), ("fderiv_y", (None, b, None), 1)):
        check(name, args, a.shape, lambda o, p, *x: lfk.fderiv_cuda(*x, o, ops, p),
              lambda o, p, *x: lfk.fderiv_plain(*x, o, ops, p), 1, 2, axes=axes)
    DxT, _ = deriv.deriv_mats(proj)
    out["f32"]["fderiv_x"]["library_ms"] = matmul_ms(a[0], DxT, torch, cold=True)
    out["high"]["fderiv_x"]["library_ms"] = split_matmuls_ms(a[0], DxT, True, torch, reps=5)
    del DxT
    proj._tensors.pop("_deriv_mats", None)
    phi1, y = phi[None], f[None].contiguous()
    pt1 = torch.empty((2, 1, N, N), device=DEVICE)
    lfk.p_planes_cuda(t, phi1, pt1)
    for kind in ("forward", "adjoint"):
        check("fa_velocity_" + kind, (y, phi1, pt1), y.shape,
              lambda o, p, y_, ph, pt: lfk.fvelocity_cuda(kind, y_, o, ph, pt, ops, 2, t, p),
              lambda o, p, y_, ph, pt: lfk.fvelocity_plain(kind, y_, o, ph, pt, ops, 2, t, p),
              4, 6)
    acc = 1e-3 * torch.as_tensor(np.random.default_rng(SEED + 1).standard_normal(
        (1, lfk.NACC, N, N)).astype(np.float32), device=DEVICE)
    yb = torch.cat([f[None], dy[None], acc], dim=1)
    check("bv_velocity", (yb, phi1, pt1), yb.shape,
          lambda o, p, y_, ph, pt: lfk.fvelocity_cuda("backward", y_, o, ph, pt, ops, 2, t, p),
          lambda o, p, y_, ph, pt: lfk.fvelocity_plain("backward", y_, o, ph, pt, ops, 2, t, p),
          8, 25)
    del yb, acc
    # the line search's batch: NTRIAL trials, each with its own phi
    scales = torch.linspace(0.1, 2.0, NTRIAL, device=DEVICE).reshape(-1, 1, 1, 1)
    phis = (scales * phi).contiguous()
    ys = torch.stack([torch.roll(f, 7 * i, dims=-1) for i in range(NTRIAL)])
    pts = torch.empty((2, NTRIAL, N, N), device=DEVICE)
    lfk.p_planes_cuda(t, phis, pts)
    for kind in ("forward", "adjoint"):
        check(f"fa_velocity_{kind}[{NTRIAL}]", (ys, phis, pts), ys.shape,
              lambda o, p, y_, ph, pt: lfk.fvelocity_cuda(kind, y_, o, ph, pt, ops, 2, t, p),
              lambda o, p, y_, ph, pt: lfk.fvelocity_plain(kind, y_, o, ph, pt, ops, 2, t, p),
              4, 6, nb=NTRIAL, reps=3)
    del ys, pts, phis
    torch.cuda.empty_cache()
    for tier, found in out.items():
        for name, d in found.items():
            extra = (f"  vs strict {d['rel_strict']:.3e} (bound {HIGH_VS_STRICT:g}); Frobenius "
                     f"ratio {d['split_ratio']:.3f} (bound {HIGH_SPLIT_RATIO:g})"
                     if tier == "high" else "")
            print(f"phase 13: {tier:4s} kernel {name:26s} radix {B:2d} rel err vs plain "
                  f"{d['rel']:.3e} (bound {FLOW_TOL if tier == 'f32' else HIGH_TOL:g}, each "
                  f"plane){extra}  {d['ms']:.4f} ms cold  plain {d['plain_ms']:.4f} ms  library "
                  f"{d['library_ms']}  bound {d['bound_ms']:.4f} ms ({d['bound_by']}, "
                  f"{100 * d['bound_ms'] / d['ms']:.1f} %)  [{N}^2; {card}]")
    bad = {k: d["rel"] for k, d in out["f32"].items() if not d["rel"] < FLOW_TOL}
    bad.update(high_failures(out["high"]))
    if bad:
        raise AssertionError(f"radix-{B} kernels disagree with their plain versions: {bad}")
    return out, dict(ops=ops, phi=phi, f=f, dy=dy)


def large_flows(torch, card, ctx):
    """Phase 13 (a): the whole L, L^-1, L^H and backward flows at 4096^2
    against their plain versions, strict (FLOW_TOL) and at 'high' (HIGH_TOL,
    and nearer plain 'high' than strict, FLOW_SPLIT_RATIO)."""
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    ops, phi, f, dy = (ctx[k] for k in ("ops", "phi", "f", "dy"))
    N = f.shape[-1]
    found = {}
    for name, (t0, t1, kind) in (("L", (0., 1., "forward")), ("L^-1", (1., 0., "forward")),
                                 ("L^H", (1., 0., "adjoint"))):
        run = lambda fn, p: fn(f, phi, ops, t0, t1, NSTEPS, kind, p)
        ks, ps = run(lfk.flow_apply, "f32"), run(lfk.flow_apply_plain, "f32")
        kh, ph = run(lfk.flow_apply, "high"), run(lfk.flow_apply_plain, "high")
        found[name] = dict(rel=rel(ks, ps), high=rel(kh, ph), **split_ratio(kh, ph, ks),
                           ms=cuda_ms(lambda: run(lfk.flow_apply, "f32"), 2, torch),
                           high_ms=cuda_ms(lambda: run(lfk.flow_apply, "high"), 2, torch))
    bwd = lambda fn, p: fn(dy, f, phi, ops, 0., 1., NSTEPS, p)
    (ks, ps, kh, ph) = (bwd(lfk.flow_bwd, "f32"), bwd(lfk.flow_bwd_plain, "f32"),
                        bwd(lfk.flow_bwd, "high"), bwd(lfk.flow_bwd_plain, "high"))
    ms, high_ms = (cuda_ms(lambda: bwd(lfk.flow_bwd, p), 2, torch) for p in ("f32", "high"))
    for i, name in enumerate(("backward dphi", "backward df0")):
        found[name] = dict(rel=rel(ks[i], ps[i]), high=rel(kh[i], ph[i]),
                           **split_ratio(kh[i], ph[i], ks[i]), ms=ms, high_ms=high_ms)
    for name, d in found.items():
        print(f"phase 13: flow {name:14s} strict vs plain {d['rel']:.3e} (bound {FLOW_TOL:g}); "
              f"'high' vs plain 'high' {d['high']:.3e} (bound {HIGH_TOL:g}), Frobenius ratio "
              f"{d['split_ratio']:.3f} (bound {FLOW_SPLIT_RATIO:g})  {d['ms']:.2f} ms strict  "
              f"{d['high_ms']:.2f} ms 'high'  [{N}^2 P, nsteps={NSTEPS}; {card}]")
    bad = {k: d["rel"] for k, d in found.items() if not d["rel"] < FLOW_TOL}
    bad.update({k + " 'high'": d["high"] for k, d in found.items() if not d["high"] < HIGH_TOL})
    bad.update({k + " ratio": d["split_ratio"] for k, d in found.items()
                if not d["split_ratio"] < FLOW_SPLIT_RATIO})
    if bad:
        raise AssertionError(f"{N}^2 flows disagree with their plain versions: {bad}")


# the 4096^2 P simulation of phases 13, 14 (c) and 16 (load_sim is seeded:
# one simulation), loaded once in a whole run by phase 13 and dropped by
# phase 16, its last user
SIM_CACHE = {}
MUSE_CACHE = {}   # phase 20's MUSE run (par_muse_numbers), phase 23 (c)'s reference


def large_sim(torch, card, N, phase=13, keep=False):
    """load_sim at N^2 P as scripts/map_4096.py runs it, or the one an
    earlier phase of this call kept (keep=True keeps it)."""
    import cmblensing_tpu_torch as ct
    if N in SIM_CACHE:
        print(f"phase {phase}: load_sim at {N}^2 P: the simulation phase 13 loaded in this call")
        return SIM_CACHE[N]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = ct.load_sim(thetapix=THETAPIX_MAP, Nside=N, pol="P", T=np.float32, seed=SEED,
                      device=DEVICE)
    torch.cuda.synchronize()
    print(f"phase {phase}: load_sim at {N}^2 P: {time.perf_counter() - t0:.2f} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card}]")
    if keep:
        SIM_CACHE[N] = sim
    return sim


@contextlib.contextmanager
def flows_in_float64(proj):
    """Within it, LenseFlow's flows (forward, adjoint and the
    transpose-delta flow of the VJP) run on the plain backend in float64,
    on a float64 projection of proj's geometry, their results cast back
    to the caller's dtype: an evaluation that shares everything but the
    flows with the caller's float32 one."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.models import lenseflow as lf
    p64 = ct.ProjLambert(proj.Ny, proj.Nx, thetapix=proj.thetapix, T=np.float64, device=DEVICE)
    apply, bwd = lf._apply, lf._bwd

    def apply64(phi_map, f_map, t0, t1, nsteps, proj, backend, precision=None, kind="forward"):
        return apply(phi_map.double(), f_map.double(), t0, t1, nsteps, p64, "plain", None,
                     kind).to(f_map.dtype)

    def bwd64(phi_map, f1, dy, t0, t1, nsteps, proj, backend, precision=None):
        dphi, df0 = bwd(phi_map.double(), f1.double(), dy.double(), t0, t1, nsteps, p64, "plain")
        return dphi.to(dy.dtype), df0.to(dy.dtype)

    lf._apply, lf._bwd = apply64, bwd64
    try:
        yield
    finally:
        lf._apply, lf._bwd = apply, bwd


def mixed_vg(sim):
    """(vg, phi_mix): the value and phi-gradient of the mixed posterior at
    the simulation's truth, mixed (vg(phi_mix) -> (lnP, grad))."""
    import cmblensing_tpu_torch as ct
    ds = sim["ds"]
    f = sim["f"].to(sim["f"].basis.with_space("map"))
    phi = sim["phi"].to(sim["phi"].basis.with_space("map"))
    m = ct.mix(ds, f=f, phi=phi)
    f_mix, phi_mix = m["f_mix"].to(f.basis), m["phi_mix"].to(phi.basis)
    return ct.fvalue_and_grad(lambda p: ct.Mixed(ds).logpdf(f_mix=f_mix, phi_mix=p)), phi_mix


def large_gradient(torch, card, sim):
    """Phase 13 (b): the strict mixed phi-gradient on the kernel and the
    plain (cuFFT) backends, each against the same float32 evaluation with
    its flows in float64 (flows_in_float64): what each backend's float32
    flows put into the gradient; the kernel backend held to GRAD_TOL of
    it. Returns
    ({backend: launches}, {"gap": kernel vs plain, backend: its distance
    to the float64-flow evaluation})."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    vg, phi_mix = mixed_vg(sim)
    res = {}
    for be in ("kernel", "plain", "float64 flows"):
        ref = be == "float64 flows"
        with ct.lenseflow_backend_ctx("plain" if ref else be), \
                (flows_in_float64(phi_mix.proj) if ref else contextlib.nullcontext()):
            lfk.reset_launches()
            t0 = time.perf_counter()
            v, g = vg(phi_mix)
            torch.cuda.synchronize()
            res[be] = (v, g.arr, 1e3 * (time.perf_counter() - t0), dict(lfk.LAUNCHES))
    N = phi_mix.proj.Nx
    gaps = {"gap": rel(res["kernel"][1], res["plain"][1])}
    gaps.update({be: rel(res[be][1], res["float64 flows"][1]) for be in ("kernel", "plain")})
    print(f"phase 13: gradlnP at {N}^2 P, strict: lnP kernel {float(res['kernel'][0])!r} plain "
          f"{float(res['plain'][0])!r}; grad rel max-abs err kernel vs plain {gaps['gap']:.3e}; "
          f"against the same evaluation with float64 flows: kernel {gaps['kernel']:.3e} (bound "
          f"{GRAD_TOL:g}), plain {gaps['plain']:.3e}; kernel {res['kernel'][2]:.1f} ms plain "
          f"{res['plain'][2]:.1f} ms (first call) [{card}]")
    # held against the float64-flow evaluation: at 4096^2 the plain
    # backend's own float32 flows put 1.0e-4 into the gradient on an H100,
    # so kernel and plain lie 1.17e-4 apart while the kernel lies 6.7e-5
    # from it (ROADMAP Queue 3, accuracy bounds)
    if not (torch.isfinite(res["kernel"][1]).all() and gaps["kernel"] < GRAD_TOL):
        raise AssertionError(f"{N}^2 kernel gradient disagrees with the evaluation with float64 "
                             f"flows: {gaps}")
    return {be: res[be][3] for be in ("kernel", "plain")}, gaps


def map_steps(torch, ds, n, precision, keys=("logpdf", "alpha", "cg_iters", "precision_fallback",
                                              "retry")):
    import cmblensing_tpu_torch as ct
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ct.MAP_joint(ds, nsteps=n, linesearch="grid", conjgrad_kwargs=MAP_CG,
                       history_keys=keys, precision=precision)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def linesearch_footprint(torch, card, ds, res, phase):
    """The grid line search's footprint on the current LenseFlow backend:
    its peak memory for NTRIAL trials in one batch and in chunks of 5, on
    the second step's search from a one-step MAP_joint result `res`
    (history key "f"); returns the planes a trial holds, the difference of
    the two peaks over NTRIAL - 5 trials."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.inference import maximization as tm
    h = res["history"][0]
    dsg = ds.replace(G=ct.Id)
    with torch.no_grad():
        f_mix, phi_mix, g = tm._phi_grad_and_fmix(dsg, {}, h["f"], res["phi"])
        dphi = tm.hessian_phimix_preconditioner(dsg).pinv() @ g
        del g
        peak, dl = {}, {}
        for chunk in (5, None):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            _, dl[chunk] = tm._grid_linesearch_dlps(dsg, {}, f_mix, phi_mix, dphi,
                                                    2 * h["alpha"], 16, chunk=chunk or 16)
            torch.cuda.synchronize()
            peak[chunk] = torch.cuda.max_memory_allocated() - base
    N = ds.d.proj.Nx
    per_trial = (peak[None] - peak[5]) / (NTRIAL - 5) / (N * N * 4)
    fin = torch.isfinite(dl[None]) & torch.isfinite(dl[5])
    ddl = float((dl[5] - dl[None])[fin].abs().max() / dl[None][fin].abs().max())
    print(f"phase {phase}: grid line search at {N}^2 P: peak {peak[None] / 2 ** 30:.2f} GiB for "
          f"{NTRIAL} trials, {peak[5] / 2 ** 30:.2f} GiB in chunks of 5: {per_trial:.1f} planes "
          f"a trial (the constant: {tm.LINESEARCH_PLANES_PER_TRIAL}); chunks of 5 vs one batch: "
          f"max |d dlp| / max |dlp| = {ddl:.2e}, argmax {int(dl[5].argmax())} vs "
          f"{int(dl[None].argmax())} [{card}]")
    return per_trial


def large_step_2048(torch, card, sim):
    """Phase 13 (c) at 2048^2 P: one strict MAP_joint step on the kernel and
    on the plain backend (the same alpha and logpdf, STEP_TOL); the line
    search's memory per trial (peak of 17 trials over that of chunks of 5);
    one step at "auto". Returns (launches of the strict and the "auto"
    kernel steps, their s/step, the plain s/step, planes per trial)."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    ds = sim["ds"]
    runs, launches = {}, {}
    # the "auto" step first: it meets the size's one-time costs (operands,
    # FFT plans), which the two timed strict steps then do not
    for be, p in (("kernel", "auto"), ("kernel", None), ("plain", None)):
        with ct.lenseflow_backend_ctx(be):
            lfk.reset_launches()
            runs[be, p] = map_steps(torch, ds, 1, p, keys=("logpdf", "alpha", "cg_iters",
                                                          "precision_fallback", "retry", "f"))
            launches[be, p] = dict(lfk.LAUNCHES)
    (hk, tk), (hp, tp_), (ha, ta) = (runs[k] for k in (("kernel", None), ("plain", None),
                                                        ("kernel", "auto")))
    hk, hp, ha = hk["history"][0], hp["history"][0], ha["history"][0]
    d_lp = abs(hk["logpdf"] - hp["logpdf"]) / abs(hp["logpdf"])
    d_a = abs(hk["alpha"] - hp["alpha"]) / max(abs(hp["alpha"]), 1e-30)
    N = ds.d.proj.Nx
    print(f"phase 13: MAP_joint {N}^2 P strict, 1 step: kernel {tk:.3f} s, plain {tp_:.3f} s; "
          f"logpdf {hk['logpdf']!r} vs {hp['logpdf']!r} (rel {d_lp:.2e}, bound {STEP_TOL:g}); "
          f"alpha {hk['alpha']!r} vs {hp['alpha']!r} (rel {d_a:.2e}) [{card}]")
    print(f"phase 13: MAP_joint {N}^2 P \"auto\", 1 step (the first at {N}^2, set-up "
          f"included): {ta:.3f} s; logpdf {ha['logpdf']!r}, alpha {ha['alpha']!r}, fallback "
          f"{ha['precision_fallback']}, retry {ha['retry']}")
    per_trial = linesearch_footprint(torch, card, ds, runs[("kernel", None)][0], 13)
    bad = {}
    if not (d_lp < STEP_TOL and d_a < STEP_TOL):
        bad["strict step kernel vs plain"] = (d_lp, d_a)
    if not (np.isfinite(ha["logpdf"]) and ha["alpha"] > 0 and hk["alpha"] > 0):
        bad["steps"] = (hk, ha)
    if bad:
        raise AssertionError(f"{N}^2 MAP_joint step disagrees: {bad}")
    return launches[("kernel", None)], launches[("kernel", "auto")], tk, tp_, per_trial


def large_map_4096(torch, card, sim, phase=13, steps=LARGE_STEPS):
    """Phase 13 (d): MAP_joint at 4096^2 P at the JAX default "auto", as
    scripts/map_4096.py runs it, on the current LenseFlow backend:
    LARGE_WARM warm-up steps, then `steps` timed with the launch counters
    set to 0 just before and read just after; every logpdf finite and
    never decreasing, alpha > 0 on the first step. Prints s/step, peak
    memory, corr and rho_b."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.inference import maximization as tm
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    from cmblensing_tpu_torch.utils import timing
    ds = sim["ds"]
    N = ds.d.proj.Nx
    torch.cuda.reset_peak_memory_stats()
    _, warm = map_steps(torch, ds, LARGE_WARM, "auto")
    timing.reset_timers()
    lfk.reset_launches()
    keys = ("logpdf", "alpha", "cg_iters", "gradnorm", "precision_fallback", "retry")
    res, dt = map_steps(torch, ds, steps, "auto", keys)
    launches = dict(lfk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    hist = res["history"]
    lps, alphas = [h["logpdf"] for h in hist], [h["alpha"] for h in hist]
    phi_true = sim["phi"].to(ct.MAP)
    phi_map = res["phi"].to(ct.MAP)
    pt, pm = phi_true.arr.reshape(-1).double(), phi_map.arr.reshape(-1).double()
    corr = float(pm @ pt / (pm.norm() * pt.norm()))
    ell, rho = ct.bandpower_corr(phi_map, phi_true, RHO_LEDGES)
    chunk = tm._linesearch_chunk(phi_map, 16)
    print(f"phase {phase}: MAP_joint {N}^2 P \"auto\": {LARGE_WARM} warm-up step {warm:.2f} s; "
          f"{steps} steps {dt:.2f} s = {dt / steps:.3f} s/step; peak memory "
          f"{peak:.2f} GiB; line-search chunk {chunk} (16: all 17 trials in one batch) [{card}]")
    for line in timing.timer_report().splitlines():
        print(f"phase {phase}: timers", line)
    print(f"phase {phase}: logpdfs {lps!r}; alphas {alphas!r}; CG iters "
          f"{[h['cg_iters'] for h in hist]}; gradnorm {[float(h['gradnorm']) for h in hist]!r}")
    print(f"phase {phase}: f-steps re-run strict (precision_fallback) "
          f"{[h['precision_fallback'] for h in hist]}; direction retries "
          f"{[h['retry'] for h in hist]}")
    print(f"phase {phase}: corr(phi_MAP, phi_true) = {corr:.4f} (no bound: {steps} steps of 15 "
          f"fixed CG iterations); rho_b " + ", ".join(f"l~{l:.0f}: {r:.3f}"
                                                      for l, r in zip(ell, rho)))
    print(f"phase {phase}: launches in the {N}^2 \"auto\" run: "
          f"{ {k: v for k, v in launches.items() if v} }; per step "
          f"{ {k: v / steps for k, v in launches.items() if v} }")
    if not all(np.isfinite(lps)) or any(b < a for a, b in zip(lps, lps[1:])):
        raise AssertionError(f"{N}^2 MAP_joint logpdf not finite and non-decreasing: {lps}")
    if not alphas[0] > 0:
        raise AssertionError(f"{N}^2 MAP_joint: the first line search accepted no step: {alphas}")
    return launches, dt / steps, peak


def dense_640(torch, card):
    """L @ f on a 640^2 P load_sim through the default backend (the dense
    circulant: radix 5 is not built) against the plain backend."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import deriv, lenseflow_kernels as lfk
    sim = ct.load_sim(thetapix=THETAPIX_MAP, Nside=640, pol="P", T=np.float32, seed=SEED,
                      device=DEVICE)
    phi, f = sim["phi"].to(ct.MAP), sim["f"].to(ct.QU_MAP)
    lfk.reset_launches()
    k = (sim["ds"].L(phi) @ f).to(ct.QU_MAP).arr
    dense = lfk.LAUNCHES["flow_forward"]
    with ct.lenseflow_backend_ctx("plain"):
        p = (sim["ds"].L(phi) @ f).to(ct.QU_MAP).arr
    e = rel(k, p)
    print(f"phase 13: L @ f on a 640^2 load_sim, default backend (radix {deriv.radix(640)}: "
          f"dense, {dense} K2 flow launches) vs plain: {e:.3e} (bound {FLOW640_TOL:g})")
    if not (dense > 0 and e < FLOW640_TOL):
        raise AssertionError(f"640^2 L @ f: {e}, {dense} dense launches")


def phase_large(torch, card):
    """Phase 13: the large maps (see the module docstring). Returns (the
    kernel records {(N, tier): {name: record}}, launches {(N, tier, name):
    (path, count)}: each radix-16/32 kernel's count from the run of the
    path named, timings)."""
    t_start = time.perf_counter()
    records, timing_out = {}, {}
    for N in N_LARGE:
        found, ctx = large_kernels(torch, card, N)
        for tier, d in found.items():
            records[N, tier] = d
        if N == 4096:
            large_flows(torch, card, ctx)
        del ctx
        torch.cuda.empty_cache()
    # path -> (its run's launch counts, set to 0 just before it and read
    # just after; the kernels the path runs, each of which must launch)
    paths = {}
    sim = large_sim(torch, card, 2048)
    large_gradient(torch, card, sim)
    strict, auto, tk, tp_, per_trial = large_step_2048(torch, card, sim)
    paths["MAP_joint 2048^2 P strict, 1 step"] = (strict, FACTORED_KERNELS[:4])
    paths["MAP_joint 2048^2 P auto, 1 step"] = (auto, HIGH_KERNELS)
    timing_out["MAP_joint_2048_s_per_step"] = (tk, tp_)
    timing_out["linesearch_planes_per_trial_2048"] = per_trial
    del sim
    torch.cuda.empty_cache()
    sim = large_sim(torch, card, 4096, keep=True)
    grad_launches, _ = large_gradient(torch, card, sim)
    paths["gradlnP 4096^2 P strict"] = (grad_launches["kernel"],
                                       ("fderiv", "fa_velocity_forward", "bv_velocity"))
    torch.cuda.empty_cache()
    run_launches, s_step, peak = large_map_4096(torch, card, sim)
    # the main path: "auto" runs the strict K1 and K3 in its line search and
    # strict residual checks, strict K4 only on a direction retry
    main_path = "MAP_joint 4096^2 P auto"
    paths[main_path] = (run_launches,
                        HIGH_KERNELS + ("fderiv", "fa_velocity_forward", "fa_velocity_adjoint"))
    timing_out.update(MAP_joint_4096_s_per_step=s_step, MAP_joint_4096_peak_GiB=peak)
    del sim
    torch.cuda.empty_cache()
    dense_640(torch, card)
    for path, (counts, names) in paths.items():
        if min(counts[k] for k in names) <= 0:
            raise AssertionError(f"{path}: a kernel of the path never launched: "
                                 f"{ {k: counts[k] for k in names} }")
    record_path = {(2048, "f32"): "MAP_joint 2048^2 P strict, 1 step",
                   (2048, "high"): "MAP_joint 2048^2 P auto, 1 step",
                   (4096, "f32"): main_path, (4096, "high"): main_path}
    launches = {}
    for (N, tier), path in record_path.items():
        for name in FACTORED_KERNELS[:4]:
            key = name + ("_high" if tier == "high" else "")
            # strict K4 at 4096^2 runs on the strict gradient's path
            p = "gradlnP 4096^2 P strict" if (N, key) == (4096, "bv_velocity") else path
            launches[N, tier, name] = (p, paths[p][0][key])
    print(f"phase 13: wall time {time.perf_counter() - t_start:.1f} s [{card}]")
    return records, launches, timing_out


def bf16_failures(found, tol, ratio=HIGH_SPLIT_RATIO):
    """The entries of `found` (name -> high_against's dict at 'bf16')
    outside `tol` of their plain 'bf16' version or `ratio`."""
    bad = {k: d["rel"] for k, d in found.items() if not d["rel"] < tol}
    bad.update({k + " ratio": d["split_ratio"] for k, d in found.items()
                if not d["split_ratio"] < ratio})
    return bad


def bf16_line(phase, label, d, tol, card, where):
    print(f"phase {phase}: 'bf16' kernel {label:26s} vs plain 'bf16' {d['rel']:.3e} (bound "
          f"{tol:g}, each plane)  vs strict {d['rel_strict']:.3e}; Frobenius vs plain 'bf16' "
          f"{d['fro']:.3e}, vs strict {d['fro_strict']:.3e} (least), ratio {d['split_ratio']:.4f} "
          f"(bound {HIGH_SPLIT_RATIO:g})  {d['ms']:.4f} ms  strict {d['strict_ms']:.4f} ms (both "
          f"cold)  plain {d['plain_ms']:.4f} ms  library {d['library_ms']}  'bf16' bound "
          f"{d['bound_ms']:.4f} ms ({d['bound_by']}, {100 * d['bound_ms'] / d['ms']:.1f} %)  "
          f"[{where}; {card}]")


def bf16_factored(torch, card, N, reps=10, twice=False):
    """Phase 14 (a), (c): K1 (d_x, d_y, d_x a + d_y b + c), K3 (both roles,
    batch 1 and NTRIAL) and K4 at 'bf16' at N^2 (radix N / FA) against
    their plain 'bf16' versions (BF16_TOL) and the strict kernels
    (HIGH_SPLIT_RATIO), every output plane on its own, both tiers timed
    cold, with the 'bf16' bound and, for K1's d_x, the library call; with
    `twice` each launched a second time into a buffer of other contents,
    bit for bit the same. Returns ({name: record}, the inputs)."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import deriv, factored_deriv, lenseflow_kernels as lfk
    B = N // FA
    proj = ct.ProjLambert(N, N, thetapix=THETAPIX_MAP, T=np.float32, device=DEVICE)
    ops = deriv.deriv_ops(proj)
    if not isinstance(ops, factored_deriv.FactoredOps) or ops.FX.shape[0] != B:
        raise AssertionError(f"deriv_ops gives no radix-{B} factored operands at {N}^2")
    phi_map, f, dy = weak_lensing_inputs(proj, torch)
    phi = lfk.gradhess(phi_map, ops)
    t, out = 0.5, {}

    def check(name, args, shape, kernel, plain, nder, planes, nb=1, axes=2, reps_=reps):
        o = torch.empty(shape, device=DEVICE)
        found = high_against(torch, lambda o_, p: kernel(o_, p, *args),
                             lambda o_: plain(o_, *args), shape, "bf16")
        if twice:
            first = torch.empty(shape, device=DEVICE)
            kernel(first, "bf16", *args)
            o.fill_(1e30)
            kernel(o, "bf16", *args)
            if not torch.equal(first, o):
                raise AssertionError(f"radix-{B} 'bf16' {name}: two launches differ")
            del first
        out[name] = dict(
            nb=nb, **found,
            ms=cold_ms(lambda *a: kernel(a[0], "bf16", *a[1:]), (o, *args), reps_, torch),
            strict_ms=cold_ms(lambda *a: kernel(a[0], "f32", *a[1:]), (o, *args), reps_, torch),
            plain_ms=cuda_ms(lambda: plain(o, *args), 1, torch), library_ms=None,
            **bound_high(N, nder, planes, nb, axes, tier="bf16"))
        del o

    a, b, c = f[0:1].contiguous(), f[1:2].contiguous(), dy[0:1].contiguous()
    for name, args, nder, planes, axes in (("fderiv_x", (a, None, None), 1, 2, 1),
                                           ("fderiv_y", (None, b, None), 1, 2, 1),
                                           ("fderiv", (a, b, c), 2, 4, 2)):
        check(name, args, a.shape, lambda o, p, *x: lfk.fderiv_cuda(*x, o, ops, p),
              lambda o, *x: lfk.fderiv_plain(*x, o, ops, "bf16"), nder, planes, axes=axes)
    DxT, _ = deriv.deriv_mats(proj)
    out["fderiv_x"]["library_ms"], out["fderiv_x"]["library_call"] = library_bf16_ms(
        a[0], DxT, torch, reps=max(3, reps // 2))
    del DxT
    proj._tensors.pop("_deriv_mats", None)
    phi1, y = phi[None], f[None].contiguous()
    pt1 = torch.empty((2, 1, N, N), device=DEVICE)
    lfk.p_planes_cuda(t, phi1, pt1)
    for kind in ("forward", "adjoint"):
        check("fa_velocity_" + kind, (y, phi1, pt1), y.shape,
              lambda o, p, y_, ph, pt: lfk.fvelocity_cuda(kind, y_, o, ph, pt, ops, 2, t, p),
              lambda o, y_, ph, pt: lfk.fvelocity_plain(kind, y_, o, ph, pt, ops, 2, t, "bf16"),
              4, 6)
    acc = 1e-3 * torch.as_tensor(np.random.default_rng(SEED + 1).standard_normal(
        (1, lfk.NACC, N, N)).astype(np.float32), device=DEVICE)
    yb = torch.cat([f[None], dy[None], acc], dim=1)
    check("bv_velocity", (yb, phi1, pt1), yb.shape,
          lambda o, p, y_, ph, pt: lfk.fvelocity_cuda("backward", y_, o, ph, pt, ops, 2, t, p),
          lambda o, y_, ph, pt: lfk.fvelocity_plain("backward", y_, o, ph, pt, ops, 2, t, "bf16"),
          8, 25)
    del yb, acc
    scales = torch.linspace(0.1, 2.0, NTRIAL, device=DEVICE).reshape(-1, 1, 1, 1)
    phis = (scales * phi).contiguous()
    ys = torch.stack([torch.roll(f, 7 * i, dims=-1) for i in range(NTRIAL)])
    pts = torch.empty((2, NTRIAL, N, N), device=DEVICE)
    lfk.p_planes_cuda(t, phis, pts)
    for kind in ("forward", "adjoint"):
        check(f"fa_velocity_{kind}[{NTRIAL}]", (ys, phis, pts), ys.shape,
              lambda o, p, y_, ph, pt: lfk.fvelocity_cuda(kind, y_, o, ph, pt, ops, 2, t, p),
              lambda o, y_, ph, pt: lfk.fvelocity_plain(kind, y_, o, ph, pt, ops, 2, t, "bf16"),
              4, 6, nb=NTRIAL, reps_=max(3, reps // 2))
    del ys, pts, phis
    torch.cuda.empty_cache()
    for name, d in out.items():
        bf16_line(14, f"{name} radix {B}", d, BF16_TOL, card, f"{N}^2")
    print(f"phase 14: K1 d_x library call at {N}^2: {out['fderiv_x']['library_call']}")
    bad = bf16_failures(out, BF16_TOL)
    if bad:
        raise AssertionError(f"radix-{B} 'bf16' kernels disagree with plain 'bf16': {bad}")
    return out, dict(proj=proj, ops=ops, phi_map=phi_map, phi=phi, f=f, dy=dy)


def bf16_large_paths(torch, card, N):
    """Phase 14 (c): the user's paths at 'bf16' at N^2 P (load_sim as
    scripts/map_4096.py), each with the launch counters set to 0 just
    before and read just after: one MAP_joint(precision="bf16") step as
    scripts/map_4096.py runs it (its phi-gradient and unmix at 'bf16', the
    strict retry where the strict line search rejects that direction),
    logpdf finite and a step taken; and argmaxf_logpdf at
    hessian_precision="bf16", 2 fixed iterations, f finite (the path of
    K3's adjoint role: a phi-step runs no adjoint flow). Returns {path:
    launches}."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    sim = large_sim(torch, card, N, 14)
    paths = {}
    with ct.lenseflow_backend_ctx("kernel"):
        lfk.reset_launches()
        res, dt = map_steps(torch, sim["ds"], 1, "bf16")
        paths[f"MAP_joint {N}^2 P bf16, 1 step"] = dict(lfk.LAUNCHES)
        h = res["history"][0]
        lfk.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fw, info = ct.argmaxf_logpdf(sim["ds"], phi=sim["phi"], conjgrad_kwargs=dict(
            tol=0.0, nsteps=2, fixed_iters=True, hessian_precision="bf16"))
        torch.cuda.synchronize()
        wf_ms = 1e3 * (time.perf_counter() - t0)
        paths[f"argmaxf_logpdf {N}^2 P bf16, 2 iterations"] = dict(lfk.LAUNCHES)
    print(f"phase 14: MAP_joint {N}^2 P precision \"bf16\", 1 step (the first at {N}^2 in "
          f"this phase, set-up included): {dt:.3f} s; logpdf {h['logpdf']!r}, alpha "
          f"{h['alpha']!r}, direction retry {h['retry']}, f-step fallback "
          f"{h['precision_fallback']} [{card}]")
    print(f"phase 14: argmaxf_logpdf {N}^2 P hessian_precision='bf16', 2 fixed iterations: "
          f"{wf_ms:.1f} ms, precision_fallback {bool(info.get('precision_fallback', False))}")
    for path, launches in paths.items():
        print(f"phase 14: launches in {path}: { {k: v for k, v in launches.items() if v} }")
    if not (np.isfinite(h["logpdf"]) and h["alpha"] > 0 and torch.isfinite(fw.arr).all()):
        raise AssertionError(f"{N}^2 'bf16' paths: {h}, f finite {bool(torch.isfinite(fw.arr).all())}")
    return paths


def bf16_dense(torch, card, sim):
    """Phase 14 (b): K2's 'bf16' derivative at 256^2 on the masked IP
    slice's own inputs, I, Q and U on the grid's z axis, against plain
    'bf16' (BF16_DENSE_TOL) and strict (HIGH_SPLIT_RATIO), timed cold with
    the 'bf16' bound and the library call; and at 200^2 (edge tiles;
    nothing written past the last plane). The flow kernel at 'bf16' on
    these shapes: phase 18."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import deriv, lenseflow_kernels as lfk
    ds, phi = sim["ds"], sim["phi"]
    mats = deriv.deriv_mats(phi.proj)
    f = sim["f"].to(ct.IQU_MAP).arr.contiguous()
    d = ds.d.to(ct.IQU_MAP).arr.contiguous()
    ncomp, out = f.shape[-3], {}

    def check(name, args, shape, kernel, plain, nder, planes_):
        o = torch.empty(shape, device=DEVICE)
        out[name] = dict(
            **high_against(torch, lambda o_, p: kernel(o_, p, *args), lambda o_: plain(o_, *args),
                           shape, "bf16"),
            ms=cold_ms(lambda *a: kernel(a[0], "bf16", *a[1:]), (o, *args), 20, torch),
            strict_ms=cold_ms(lambda *a: kernel(a[0], "f32", *a[1:]), (o, *args), 20, torch),
            plain_ms=cuda_ms(lambda: plain(o, *args), 5, torch), library_ms=None,
            **bound_dense_high(N, nder, planes_, tier="bf16"))

    for name, args, nder, planes_ in (("deriv", (f, None, None), ncomp, 2 * ncomp + 0.5),
                                      ("deriv_xy", (f, d, f), 2 * ncomp, 4 * ncomp + 1)):
        check(name, args, f.shape, lambda o, p, *x: lfk.deriv_cuda(*x, o, mats, p),
              lambda o, *x: lfk.deriv_plain(*x, o, mats, "bf16"), nder, planes_)
    # the same d_x of the slice's three planes as one product
    out["deriv"]["library_ms"], out["deriv"]["library_call"] = library_bf16_ms(
        f.reshape(-1, N), mats[0], torch)
    for name, dd in out.items():
        bf16_line(14, name, dd, BF16_DENSE_TOL, card, f"{ncomp} x {N}^2 IP")
    print(f"phase 14: K2 d_x library call: {out['deriv']['library_call']}")
    bad = bf16_failures(out, BF16_DENSE_TOL)
    # edge tiles: 200^2, two components
    Ny = Nx = 200
    proj = ct.ProjLambert(Ny, Nx, thetapix=3, T=np.float32, device=DEVICE)
    emats = deriv.deriv_mats(proj)
    rng = np.random.default_rng(SEED + 2)
    T = lambda *sh: torch.as_tensor(rng.standard_normal(sh).astype(np.float32), device=DEVICE)
    a, b, c = T(1, Ny, Nx), T(1, Ny, Nx), T(1, Ny, Nx)
    edge = {}
    cases = [(name, args, (1, Ny, Nx), lambda o, p, args=args: lfk.deriv_cuda(*args, o, emats, p),
              lambda o, args=args: lfk.deriv_plain(*args, o, emats, "bf16"))
             for name, args in (("deriv_x", (a, None, None)), ("deriv", (a, b, c)))]
    for name, _, shape, kernel, plain in cases:
        full = torch.full((shape[0] + 1,) + tuple(shape[1:]), float("nan"), device=DEVICE)
        kernel(full[:shape[0]], "bf16")
        edge[name] = dict(**high_against(torch, kernel, plain, shape, "bf16"),
                          clean=bool(torch.isnan(full[shape[0]]).all()))
    for name, dd in edge.items():
        print(f"phase 14: 'bf16' kernel {name:18s} {Ny}x{Nx} vs plain 'bf16' {dd['rel']:.3e} "
              f"(bound {BF16_DENSE_TOL:g}, each plane), Frobenius ratio {dd['split_ratio']:.4f}; "
              f"past the last plane {'untouched' if dd['clean'] else 'WRITTEN'}")
    bad.update({f"{k} {Ny}x{Nx}": v for k, v in bf16_failures(edge, BF16_DENSE_TOL).items()})
    bad.update({f"{k} {Ny}x{Nx} wrote past its planes": True for k, dd in edge.items()
                if not dd["clean"]})
    if bad:
        raise AssertionError(f"K2 'bf16' disagrees with plain 'bf16': {bad}")
    return out


def bf16_gradient(torch, card, ds, f_mix, phi_mix, label):
    """The mixed phi-gradient under precision_ctx("bf16") on the kernel
    backend, the launch counters set to 0 just before and read just after,
    against the strict one (rel max-abs, cosine) and the plain 'bf16' one
    (the "matmul" backend, which launches nothing; FLOW_SPLIT_RATIO per
    plane). Returns (record, launches)."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import deriv, lenseflow_kernels as lfk
    vg = ct.fvalue_and_grad(lambda p: ct.Mixed(ds).logpdf(f_mix=f_mix, phi_mix=p))
    with ct.lenseflow_backend_ctx("kernel"):
        _, gs = vg(phi_mix)
        strict_ms = cuda_ms(lambda: vg(phi_mix), 3, torch)
        with deriv.precision_ctx("bf16"):
            lfk.reset_launches()
            _, gb = vg(phi_mix)
            torch.cuda.synchronize()
            launches = dict(lfk.LAUNCHES)
            ms = cuda_ms(lambda: vg(phi_mix), 3, torch)
    with ct.lenseflow_backend_ctx("matmul"), deriv.precision_ctx("bf16"):
        lfk.reset_launches()
        _, gp = vg(phi_mix)
        ref_launches = sum(lfk.LAUNCHES.values())
    a, s_, p_ = gb.arr, gs.arr, gp.arr
    cos = float((a.double() * s_.double()).sum() / (a.double().norm() * s_.double().norm()))
    rec = dict(rel=rel(a, p_), strict=rel(a, s_), cos=cos, **split_ratio(a, p_, s_), ms=ms,
               strict_ms=strict_ms)
    print(f"phase 14: gradlnP {label} 'bf16' vs plain 'bf16' {rec['rel']:.3e}, vs strict "
          f"{rec['strict']:.3e} (cosine {cos:.9f}); Frobenius ratio {rec['split_ratio']:.4f} "
          f"(bound {FLOW_SPLIT_RATIO:g}); {ms:.3f} ms ('f32' {strict_ms:.3f} ms) [{card}]")
    bad = {}
    if ref_launches:
        bad["plain 'bf16' gradient launches"] = ref_launches
    if not (torch.isfinite(a).all() and rec["split_ratio"] < FLOW_SPLIT_RATIO):
        bad["gradient"] = rec
    if any(v for k, v in launches.items() if k.endswith("_high")):
        bad["'high' launches"] = launches
    if bad:
        raise AssertionError(f"{label} 'bf16' gradient: {bad}")
    return rec, launches


def bf16_wiener(torch, card, sim, label, hp="bf16", strict=None):
    """argmaxf_logpdf at the JAX default CG (tol 0.1, nsteps 500) with
    hessian_precision `hp`, the launch counters set to 0 just before and
    read just after, the reduced solve's own strict check reported, and
    the strict solve beside it (`strict`, (f, info, ms) of an earlier
    phase's strict solve of `sim` on the kernel backend, else solved
    here): |f - f_strict| / |f_strict| within WF_HIGH_TOL where the check
    passed (a fallback returns a strict solve). Returns (record,
    launches)."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.inference import maximization as tm
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    solves, core = [], tm._argmaxf_core

    def spy(*a, **k):
        x, info = core(*a, **k)
        solves.append(dict(info))
        return x, info

    def solve(**cg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fw, info = ct.argmaxf_logpdf(sim["ds"], phi=sim["phi"], conjgrad_kwargs=cg)
        torch.cuda.synchronize()
        return fw, info, 1e3 * (time.perf_counter() - t0)

    with ct.lenseflow_backend_ctx("kernel"):
        tm._argmaxf_core = spy
        try:
            lfk.reset_launches()
            fb, ib, ms = solve(hessian_precision=hp)
            launches = dict(lfk.LAUNCHES)
        finally:
            tm._argmaxf_core = core
        fs, is_, ms_strict = strict or solve(hessian_precision=None)
    red = solves[0]
    fallback = bool(ib.get("precision_fallback", False))
    err = float((fb.arr - fs.to(fb.basis).arr).norm() / fs.arr.norm())
    print(f"phase 14: argmaxf_logpdf {label} hessian_precision={hp!r} (tol 0.1, nsteps 500): the "
          f"'{hp}' solve {red['iterations']} iterations, res {float(red['res']):.4e}, res_strict "
          f"{float(red['res_strict']):.4e} against max(tol 0.1, 1e-10 res0 = "
          f"{1e-10 * float(red['res0']):.4e}); precision_fallback {fallback}; "
          f"{ib['iterations']} iterations returned, {ms:.1f} ms; strict solve "
          f"{is_['iterations']} iterations {ms_strict:.1f} ms; |f - f_strict| / |f_strict| = "
          f"{err:.3e} (bound {WF_HIGH_TOL:g}"
          + (", f is the strict fallback's" if fallback else "") + f") [{card}]")
    print(f"phase 14: launches in the {label} solve: {({k: v for k, v in launches.items() if v})}")
    if not (torch.isfinite(fb.arr).all() and err < WF_HIGH_TOL):
        raise AssertionError(f"{label} 'bf16' Wiener filter: {err}")
    return dict(ms=ms, strict_ms=ms_strict, iterations=int(red["iterations"]),
                returned_iterations=int(ib["iterations"]), fallback=fallback, err=err), launches


def bf16_flows(torch, card, ctx):
    """Phase 14 (d): the 1024^2 L, L^-1, L^H and backward flows at 'bf16'
    against their plain 'bf16' versions (BF16_TOL) and nearer them than
    the strict flows (FLOW_SPLIT_RATIO), with times."""
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    ops, phi, f, dy = (ctx[k] for k in ("ops", "phi", "f", "dy"))
    flows = {}
    for name, (t0, t1, kind) in (("L", (0., 1., "forward")), ("L^-1", (1., 0., "forward")),
                                 ("L^H", (1., 0., "adjoint"))):
        run = lambda fn, p="bf16": fn(f, phi, ops, t0, t1, NSTEPS, kind, p)
        kv, pv, sv = run(lfk.flow_apply), run(lfk.flow_apply_plain), run(lfk.flow_apply, "f32")
        flows[name] = dict(rel=rel(kv, pv), strict=rel(kv, sv), **split_ratio(kv, pv, sv),
                           ms=cuda_ms(lambda: run(lfk.flow_apply), 3, torch),
                           strict_ms=cuda_ms(lambda: run(lfk.flow_apply, "f32"), 3, torch))
    bwd = lambda fn, p="bf16": fn(dy, f, phi, ops, 0., 1., NSTEPS, p)
    ms, strict_ms = (cuda_ms(lambda: bwd(lfk.flow_bwd, p), 3, torch) for p in ("bf16", "f32"))
    for name, kv, pv, sv in zip(("backward dphi", "backward df0"), bwd(lfk.flow_bwd),
                                bwd(lfk.flow_bwd_plain), bwd(lfk.flow_bwd, "f32")):
        flows[name] = dict(rel=rel(kv, pv), strict=rel(kv, sv), **split_ratio(kv, pv, sv), ms=ms,
                           strict_ms=strict_ms)
    N = f.shape[-1]
    for name, d in flows.items():
        print(f"phase 14: 'bf16' flow {name:14s} vs plain 'bf16' {d['rel']:.3e} (bound "
              f"{BF16_TOL:g})  vs strict {d['strict']:.3e}; Frobenius ratio "
              f"{d['split_ratio']:.4f} (bound {FLOW_SPLIT_RATIO:g})  {d['ms']:.3f} ms  strict "
              f"{d['strict_ms']:.3f} ms  [{N}^2 P, nsteps={NSTEPS}; {card}]")
    bad = bf16_failures(flows, BF16_TOL, FLOW_SPLIT_RATIO)
    if bad:
        raise AssertionError(f"{N}^2 'bf16' flows disagree with plain 'bf16': {bad}")
    return flows


def phase_bf16(torch, card, gctx=None, beside=None, wctx=None):
    """Phase 14, the 'bf16' tier (see the module docstring). gctx is phase
    6's 1024^2 context (made here when phase 14 runs alone); beside holds
    phases 7 and 9's MAP_joint (s/step, history) to print beside (f);
    wctx is phase 12's masked IP simulation and its strict solve (loaded
    and solved here when phase 14 runs alone).
    Returns (kernel records {(N, name): record}, launches {(N, name): (path,
    count)}, timings)."""
    import cmblensing_tpu_torch as ct
    t_start = time.perf_counter()
    records, paths, timing_out = {}, {}, {}
    # (a) the 1024^2 kernels
    found, ctx = bf16_factored(torch, card, N_MAP)
    records.update({(N_MAP, k): d for k, d in found.items()})
    # (d) the 1024^2 flows on the same inputs
    flows = bf16_flows(torch, card, ctx)
    timing_out["flows_1024_bf16_ms"] = {k: (d["ms"], d["strict_ms"]) for k, d in flows.items()}
    del ctx
    # (b) K2 on the masked 256^2 IP slice's inputs, and at 200^2
    if wctx is None:
        t0 = time.perf_counter()
        wf_sim = ct.load_sim(**WF_SIM, device=DEVICE)
        torch.cuda.synchronize()
        print(f"phase 14: load_sim {WF_SIM}: {time.perf_counter() - t0:.2f} s [{card}]")
    else:
        wf_sim = wctx["sim"]
    records.update({(N, k): d for k, d in bf16_dense(torch, card, wf_sim).items()})
    # the dense backward flow's path: the masked IP slice's phi-gradient
    ds = wf_sim["ds"]
    fm = wf_sim["f"].to(wf_sim["f"].basis.with_space("map"))
    pm = wf_sim["phi"].to(ct.MAP)
    m = ct.mix(ds, f=fm, phi=pm)
    grad_ip, paths["gradlnP masked 256^2 IP bf16"] = bf16_gradient(
        torch, card, ds, m["f_mix"].to(fm.basis), m["phi_mix"].to(ct.MAP), "masked 256^2 IP")
    timing_out["gradlnP_256_IP_bf16_ms"] = (grad_ip["ms"], grad_ip["strict_ms"])
    # (g) the masked 256^2 IP Wiener filter at hessian_precision="bf16"
    wf, paths["argmaxf_logpdf masked 256^2 IP bf16"] = bf16_wiener(
        torch, card, wf_sim, "masked 256^2 IP", strict=wctx and wctx["strict"])
    timing_out["argmaxf_256_IP_bf16"] = wf
    del wf_sim, ds, m
    # (c) radix 16 and 32: the kernels, twice each, and the LenseFlow entry points
    for Nl in N_LARGE:
        found, ctx = bf16_factored(torch, card, Nl, reps=3, twice=True)
        records.update({(Nl, k): d for k, d in found.items()})
        del ctx
        torch.cuda.empty_cache()
        paths.update(bf16_large_paths(torch, card, Nl))
        torch.cuda.empty_cache()
    # (e) the 1024^2 phi-gradient
    if gctx is None:
        gctx = phase_map_gradient(torch, card)[0]
    sim = gctx["sim"]
    fs = sim["f"].to(sim["f"].basis.with_space("map"))
    m = ct.mix(sim["ds"], f=fs, phi=sim["phi"].to(ct.MAP))
    grad, _ = bf16_gradient(torch, card, sim["ds"], m["f_mix"].to(fs.basis),
                            m["phi_mix"].to(ct.MAP), f"{N_MAP}^2 P")
    timing_out["gradlnP_1024_bf16_ms"] = (grad["ms"], grad["strict_ms"])
    # (f) MAP_joint(precision="bf16") as scripts/map_1024.py runs it, and the
    # 1024^2 Wiener filter at hessian_precision="bf16" (the path of K3's
    # adjoint role at 'bf16': the phi-step runs no adjoint flow)
    with ct.lenseflow_backend_ctx("kernel"):
        launches, s_step, hist = run_map(torch, sim, 14, "kernel, precision \"bf16\"", card,
                                         precision="bf16")
    gctx["map_hist_bf16"], gctx["map_s_bf16"] = hist, s_step
    paths["MAP_joint 1024^2 P bf16"] = launches
    timing_out["MAP_joint_1024_bf16_s_per_step"] = s_step
    print(f"phase 14: f-steps re-run strict {sum(h['precision_fallback'] for h in hist)} of "
          f"{len(hist)}; direction retries fired {sum(h['retry'] for h in hist)}")
    for phase, label in ((7, "strict"), (9, "\"auto\"")):
        s, h = (beside or {}).get(phase, (None, None))
        if h is None:
            print(f"phase 14: beside phase {phase} ({label}): not run in this call")
            continue
        print(f"phase 14: beside phase {phase} ({label}): {s:.3f} s/step; logpdfs "
              f"{[x['logpdf'] for x in h]!r}; alphas {[x['alpha'] for x in h]!r}; fallbacks "
              f"{sum(x.get('precision_fallback', False) for x in h)}; retries "
              f"{sum(x.get('retry', False) for x in h)}")
    wf1024, paths["argmaxf_logpdf 1024^2 P bf16"] = bf16_wiener(torch, card, sim, f"{N_MAP}^2 P")
    timing_out["argmaxf_1024_bf16"] = wf1024
    # every kernel of each path launched in its run; the records' launches
    path_of = {(N_MAP, "fderiv_bf16"): "MAP_joint 1024^2 P bf16",
               (N_MAP, "fa_velocity_forward_bf16"): "MAP_joint 1024^2 P bf16",
               (N_MAP, "fa_velocity_adjoint_bf16"): "argmaxf_logpdf 1024^2 P bf16",
               (N_MAP, "bv_velocity_bf16"): "MAP_joint 1024^2 P bf16",
               (N, "flow_forward_bf16"): "argmaxf_logpdf masked 256^2 IP bf16",
               (N, "flow_adjoint_bf16"): "argmaxf_logpdf masked 256^2 IP bf16",
               (N, "deriv_bf16"): "gradlnP masked 256^2 IP bf16",
               (N, "flow_backward_bf16"): "gradlnP masked 256^2 IP bf16"}
    for Nl in N_LARGE:
        path_of.update({(Nl, k): f"MAP_joint {Nl}^2 P bf16, 1 step" for k in BF16_KERNELS})
        path_of[Nl, "fa_velocity_adjoint_bf16"] = f"argmaxf_logpdf {Nl}^2 P bf16, 2 iterations"
    launches = {key: (p, paths[p][key[1]]) for key, p in path_of.items()}
    never = {key: v for key, v in launches.items() if v[1] <= 0}
    if never:
        raise AssertionError(f"a 'bf16' kernel never launched in its path's run: {never}")
    print(f"phase 14: wall time {time.perf_counter() - t_start:.1f} s [{card}]")
    return records, launches, timing_out


def uni_operands(torch, mats, phis, state, t=0.5):
    """px, py and each K5 call's (key, role, a, b) as the uni flows pass
    them: views of a (nb, 2 ncomp, Ny, Nx) state (f, delta f); role 0 on
    every component at once, roles 2 and 3 on each component pair (the
    last pair repeating its component when ncomp is odd; key (role, first
    component) after the first pair, else the role), role 1 on u = M^-1 w
    of role 0's w."""
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    nb, Ny, Nx = state.shape[0], state.shape[-2], state.shape[-1]
    nc = state.shape[1] // 2
    px, py = (p.unsqueeze(1).contiguous() for p in lfk._p_of_t(t, phis))
    w = torch.empty((nb, nc, 4, Ny, Nx), device=state.device)
    lfk.uni_velocity_plain(0, state[:, :nc], state[:, nc:], px, py, w, mats, t)
    m11, m12, m22 = lfk._minv_of_t(t, phis)
    wx, wy = w[:, :, 2].sum(1), w[:, :, 3].sum(1)
    u = torch.stack([m11 * wx + m12 * wy, m12 * wx + m22 * wy], dim=1)
    calls = [(0, 0, state[:, :nc], state[:, nc:]), (1, 1, u[:, :1], u[:, 1:])]
    for role in (2, 3):
        for c0 in range(0, nc, 2):
            c1 = min(c0 + 1, nc - 1)
            calls.append((role if c0 == 0 else (role, c0), role, state[:, c0:c0 + 1],
                          state[:, c1:c1 + 1]))
    return px, py, calls


def uni_roles(torch, mats, px, py, calls, tier, tol, bound_of=None, reps=10, t=0.5):
    """Each K5 call of `calls` (uni_operands') at `tier` against its plain
    version at the tier and the strict kernel, every output plane of every
    entry on its own: rel max-abs within `tol` (role 1 at 'bf16':
    BF16_TOL, UNI_TOL says why), at a reduced tier the Frobenius ratio
    under UNI_RATIO (and within HIGH_VS_STRICT of strict at 'high');
    the planes a role leaves at zero exactly zero; two launches the same
    bits; nothing written past the last plane (a NaN plane behind out).
    With bound_of(role, nb, nper) each call is timed cold at the tier and
    strict, its plain version as it runs, and given its bound. Returns
    ({key: record}, {key: what failed})."""
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    Ny, Nx = px.shape[-2:]
    nb, nan = px.shape[0], float("nan")
    found, bad = {}, {}
    for key, role, a, b in calls:
        nper = a.shape[1]
        shape = (nb, nper, 4, Ny, Nx)
        fulls = [torch.full((nb * nper * 4 + 1, Ny, Nx), nan, device=DEVICE) for _ in range(3)]
        ok_, again, ost = (x[:-1].view(shape) for x in fulls)
        for o, p in ((ok_, tier), (again, tier), (ost, "f32")):
            lfk.uni_velocity_cuda(role, a, b, px, py, o, mats, t, p)
        op = torch.full(shape, nan, device=DEVICE)
        lfk.uni_velocity_plain(role, a, b, px, py, op, mats, t, tier)
        torch.cuda.synchronize()
        n = UNI_NONZERO[role]
        k_, p_, s_ = (x[:, :, :n] for x in (ok_, op, ost))
        trip = list(zip(*(x.reshape(-1, Ny, Nx) for x in (k_, p_, s_))))
        d = dict(nb=nb, nper=nper, max_abs_err=float((k_ - p_).abs().max()),
                 rel=max(rel(k, q) for k, q, _ in trip),
                 tol=BF16_TOL if tier == "bf16" and role == 1 else tol,
                 zero=bool((ok_[:, :, n:] == 0).all()), same_bits=bool(torch.equal(ok_, again)),
                 inside=all(bool(torch.isnan(x[-1]).all()) for x in fulls))
        if tier != "f32":
            d.update(rel_strict=max(rel(k, s) for k, _, s in trip), ratio_bound=UNI_RATIO[role],
                     **split_ratio(k_, p_, s_))
        if bound_of is not None:
            at = lambda p: (lambda a_, b_, px_, py_, o: lfk.uni_velocity_cuda(
                role, a_, b_, px_, py_, o, mats, t, p))
            d.update(ms=cold_ms(at(tier), (a, b, px, py, ok_), reps, torch),
                     strict_ms=cold_ms(at("f32"), (a, b, px, py, ost), reps, torch),
                     plain_ms=cuda_ms(lambda: lfk.uni_velocity_plain(role, a, b, px, py, op, mats,
                                                                     t, tier), 1, torch),
                     library_ms=None, **bound_of(role, nb, nper))
        why = [w for w, ok in ((f"rel {d['rel']:.3e}", d["rel"] < d["tol"]),
                               ("zero planes", d["zero"]), ("two launches differ", d["same_bits"]),
                               ("wrote past the last plane", d["inside"])) if not ok]
        if tier != "f32" and not d["split_ratio"] < UNI_RATIO[role]:
            why.append(f"Frobenius ratio {d['split_ratio']:.3f}")
        if tier == "high" and not d["rel_strict"] < HIGH_VS_STRICT:
            why.append(f"vs strict {d['rel_strict']:.3e}")
        if why:
            bad[key] = why
        found[key] = d
    return found, bad


def uni_role_line(label, key, d):
    """One printed line of a uni_roles record."""
    ratio = (f"; vs strict {d['rel_strict']:.3e}, Frobenius ratio {d['split_ratio']:.4f} (bound "
             f"{d['ratio_bound']:g})" if "split_ratio" in d else "")
    times = (f"  {d['ms']:.4f} ms  strict {d['strict_ms']:.4f} ms (both cold)  plain "
             f"{d['plain_ms']:.4f} ms  bound {d['bound_ms']:.4f} ms ({d['bound_by']}, "
             f"{100 * d['bound_ms'] / d['ms']:.1f} %)" if "ms" in d else "")
    return (f"K5 {label} role {key} (nb {d['nb']}, nper {d['nper']}): vs plain {d['rel']:.3e} "
            f"(bound {d['tol']:g}){ratio}; zero planes exact {d['zero']}, same bits "
            f"{d['same_bits']}, inside {d['inside']}{times}")


def uni_fctx(torch, N=N_MAP):
    """phase 5's inputs (fctx) at N^2 (thetapix 2) on its factored
    operands: at 1024^2 for phase 15 run alone, at 2048^2 and 4096^2 for
    phase 16."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import deriv, factored_deriv, lenseflow_kernels as lfk
    proj = ct.ProjLambert(N, N, thetapix=THETAPIX_MAP, T=np.float32, device=DEVICE)
    ops = deriv.deriv_ops(proj)
    if not isinstance(ops, factored_deriv.FactoredOps) or ops.FX.shape[0] != N // FA:
        raise AssertionError(f"deriv_ops gives no radix-{N // FA} factored operands at {N}^2")
    phi_map, f, dy = weak_lensing_inputs(proj, torch)
    return dict(ops=ops, phi=lfk.gradhess(phi_map, ops), phi_map=phi_map, f=f, dy=dy)


def uni_tiers_factored(torch, card, ctx, N, tiers, phase, batched=True):
    """K5 on factored operands at N^2 (radix N / FA) at each of `tiers`:
    every role on the operands the uni flows give it at batch 1 and, with
    `batched`, on NTRIAL trials with NTRIAL phi scalings (uni_roles: each
    plane against plain at the tier, at a reduced tier against the strict
    kernel too; two launches the same bits; nothing written past a plane;
    the zero planes exact), timed cold with the tier's bound (bound,
    bound_high). Returns ({(tier, role key): record}, {what: why it
    failed})."""
    ops, phi, f, dy = (ctx[k] for k in ("ops", "phi", "f", "dy"))
    state = torch.cat([f, dy])
    inputs = {1: uni_operands(torch, ops, phi[None], state[None])}
    if batched:
        scales = torch.linspace(0.1, 2.0, NTRIAL, device=DEVICE).reshape(-1, 1, 1, 1)
        states = torch.stack([torch.roll(state, 7 * i, dims=-1) for i in range(NTRIAL)])
        inputs[NTRIAL] = uni_operands(torch, ops, (scales * phi).contiguous(), states)
        del states
    records, bad = {}, {}
    for tier in tiers:
        def bound_of(role, nb, nper):
            nder, planes = UNI_NDER[role] * nb * nper, nb * (6 * nper + 2)
            if tier == "f32":
                return bound(nder * fact_deriv_flops(N), planes, N, fact_op_floats(N))
            return bound_high(N, nder, planes, 1, 2, tier)

        found = {}
        for nb, operands in inputs.items():
            found[nb], why = uni_roles(torch, ops, *operands, tier, UNI_TOL[tier], bound_of,
                                       reps=10 if nb == 1 else 3)
            bad.update({f"{tier} {N}^2 [{nb}] {k}": v for k, v in why.items()})
        for key, d in found[1].items():
            for nb in found:
                print(f"phase {phase}: (a) "
                      f"{uni_role_line(f'{tier!r} {N}^2 radix {N // FA}', key, found[nb][key])} "
                      f"[{card}]")
            if NTRIAL in found:
                d["batched"] = {k: found[NTRIAL][key][k]
                                for k in ("nb", "max_abs_err", "rel", "ms", "plain_ms")}
            records[tier, key] = d
    return records, bad


def uni_edge_inputs(torch, Ny, Nx, seed):
    """A one-mode phi's planes (Hess phi ~ 0.1) and a random (f, delta f)
    state of two components, from numpy, at a plane shape of any sides."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import deriv, lenseflow_kernels as lfk
    mats = deriv.deriv_mats(ct.ProjLambert(Ny, Nx, thetapix=3, T=np.float32, device=DEVICE))
    phi_f = np.zeros((1, Ny, Nx // 2 + 1), np.complex128)
    phi_f[0, 1, 1] = 1e-3 * (Ny * Nx / 1024) ** 2
    phi = torch.as_tensor(np.fft.irfft2(phi_f, s=(Ny, Nx)).astype(np.float32), device=DEVICE)
    rng = np.random.default_rng(seed)
    state = torch.as_tensor(rng.standard_normal((4, Ny, Nx)).astype(np.float32), device=DEVICE)
    return mats, lfk.gradhess(phi, mats), state


def uni_tiers_dense(torch, card, wf_sim):
    """(b) the dense K5 (csrc/uni_dense.cu) at every tier: on the 256^2 P
    inputs (two components; timed cold with the tier's bound: the kernels
    line's records), on the masked IP slice's three components (I, Q, U:
    role 0 on all three, roles 2 and 3 on the pairs (I, Q) and (U, U)),
    at the edge tiles and at 768^2 P (uni_roles)."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import deriv, lenseflow_kernels as lfk
    proj = ct.ProjLambert(N, N, thetapix=3, T=np.float32, device=DEVICE)
    mats = deriv.deriv_mats(proj)
    phi_map, f, dy = weak_lensing_inputs(proj, torch)
    phi = lfk.gradhess(phi_map, mats)
    ip_phi = lfk.gradhess(wf_sim["phi"].to(ct.MAP).arr.contiguous(), mats)
    ip_state = torch.cat([wf_sim["f"].to(ct.IQU_MAP).arr, wf_sim["ds"].d.to(ct.IQU_MAP).arr])
    p768 = ct.ProjLambert(N_DENSE_UNI, N_DENSE_UNI, thetapix=THETAPIX_MAP, T=np.float32,
                          device=DEVICE)
    m768 = deriv.deriv_mats(p768)
    phi768, f768, dy768 = weak_lensing_inputs(p768, torch)
    others = [(f"IP {N}^2", mats, ip_phi, ip_state),
              (f"{N_DENSE_UNI}^2 P", m768, lfk.gradhess(phi768, m768), torch.cat([f768, dy768]))]
    others += [(f"{Ny}x{Nx}", *uni_edge_inputs(torch, Ny, Nx, SEED + i))
               for i, (Ny, Nx) in enumerate(EDGE_SHAPES)]
    records, bad = {}, {}
    for tier in lfk.PRECISIONS:
        sfx = "" if tier == "f32" else "_" + tier
        extra = {"f32": 2, "high": 2, "bf16": 1}[tier]   # the circulants, in planes

        def bound_of(role, nb, nper):
            nder, planes = UNI_NDER[role] * nb * nper, nb * (6 * nper + 2)
            if tier == "f32":
                return bound(nder * dense_deriv_flops(N), planes, N, extra * N * N)
            return bound_dense_high(N, nder, planes + extra, tier)

        found, why = uni_roles(torch, mats, *uni_operands(torch, mats, phi[None], torch.cat(
            [f, dy])[None]), tier, UNI_DENSE_TOL[tier], bound_of)
        for key, d in found.items():
            print(f"phase 15: (b) {uni_role_line(f'dense {tier!r} {N}^2 P', key, d)} [{card}]")
            records[f"uni_dense_role{key}{sfx}"] = d
        bad.update({f"dense {tier} {N}^2 P {k}": v for k, v in why.items()})
        for label, m, planes, state in others:
            found, why = uni_roles(torch, m, *uni_operands(torch, m, planes[None], state[None]),
                                   tier, UNI_DENSE_TOL[tier])
            worst = max(found.values(), key=lambda d: d["rel"] / d["tol"])
            ratio = "" if tier == "f32" else (
                f", largest Frobenius ratio {max(d['split_ratio'] for d in found.values()):.4f}")
            print(f"phase 15: (b) K5 dense {tier!r} {label}: {len(found)} calls, worst vs plain "
                  f"{worst['rel']:.3e} (bound {worst['tol']:g}){ratio}; zero planes, same bits, "
                  f"nothing past the last plane: "
                  f"{all(d['zero'] and d['same_bits'] and d['inside'] for d in found.values())}")
            bad.update({f"dense {tier} {label} {k}": v for k, v in why.items()})
    return records, bad


def uni_tier_flows(torch, card, fctx):
    """(c) the uni flows (L, L^-1, L^H, backward delta phi and delta f) at
    'high' and 'bf16': at 1024^2 P against the plain uni flows at the tier
    (the tier's bound, and nearer them than the strict uni flows,
    FLOW_SPLIT_RATIO) and against the K3/K4 flows at the tier; at 256^2 P
    against the K2 flows at the tier. Delta phi, hoisted on K3/K4 and K2,
    to UNI_DPHI_TOL."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import deriv, lenseflow_kernels as lfk
    p256 = ct.ProjLambert(N, N, thetapix=3, T=np.float32, device=DEVICE)
    m256 = deriv.deriv_mats(p256)
    phi256, f256, dy256 = weak_lensing_inputs(p256, torch)
    kinds = (("L", 0., 1., "forward"), ("L^-1", 1., 0., "forward"), ("L^H", 1., 0., "adjoint"))
    found, bad = {}, {}
    for tier in ("high", "bf16"):
        tol = {"high": HIGH_TOL, "bf16": BF16_TOL}[tier]
        for size, mats, phi_map, f, dy in ((N_MAP, fctx["ops"], fctx["phi_map"], fctx["f"],
                                            fctx["dy"]), (N, m256, phi256, f256, dy256)):
            planes = lfk.gradhess(phi_map, mats, tier)
            runs = {}
            for name, t0, t1, kind in kinds:
                ap = lambda fn, p: fn(f, planes, mats, t0, t1, NSTEPS, kind, p)
                torch.cuda.synchronize()
                t_ = time.perf_counter()
                u = ap(lfk.uni_flow_apply, tier)
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t_)
                runs[name] = (u, ap(lfk.flow_apply, tier), ms)
                if size == N_MAP:
                    runs[name] += (ap(lfk.uni_flow_apply_plain, tier),
                                   ap(lfk.uni_flow_apply, "f32"))
            bw = lambda fn, p: fn(dy, f, planes, mats, 0., 1., NSTEPS, p)
            torch.cuda.synchronize()
            t_ = time.perf_counter()
            ub = bw(lfk.uni_flow_bwd, tier)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t_)
            kb = bw(lfk.flow_bwd, tier)
            extra = (bw(lfk.uni_flow_bwd_plain, tier), bw(lfk.uni_flow_bwd, "f32")) \
                if size == N_MAP else ()
            for i, name in enumerate(("backward dphi", "backward df0")):
                runs[name] = (ub[i], kb[i], ms) + tuple(x[i] for x in extra)
            other = "K3/K4" if size == N_MAP else "K2"
            for name, r in runs.items():
                d = dict(vs_kernel=rel(r[0], r[1]), ms=r[2])
                ktol = UNI_DPHI_TOL[tier] if name == "backward dphi" else tol
                line = f"vs {other} flow {d['vs_kernel']:.3e} (bound {ktol:g})"
                if len(r) > 3:
                    d.update(vs_plain=rel(r[0], r[3]), **split_ratio(r[0], r[3], r[4]))
                    line = (f"vs plain uni {d['vs_plain']:.3e} (bound {tol:g}), Frobenius ratio "
                            f"{d['split_ratio']:.4f} (bound {FLOW_SPLIT_RATIO:g}); " + line)
                    if not (d["vs_plain"] < tol and d["split_ratio"] < FLOW_SPLIT_RATIO):
                        bad[f"{tier} {size} {name} vs plain"] = (d["vs_plain"], d["split_ratio"])
                if not d["vs_kernel"] < ktol:
                    bad[f"{tier} {size} {name} vs {other}"] = d["vs_kernel"]
                print(f"phase 15: (c) uni flow {name:14s} {tier!r} {size}^2 P: {line}  uni "
                      f"{d['ms']:.2f} ms [nsteps={NSTEPS}; {card}]")
                found[tier, size, name] = d
    return found, bad


def uni_gradients(torch, card, cases, tag):
    """The phi-gradient on "uni" against the kernel backend, for each
    (size, vg, phi_mix, tiers) of `cases` (tiers beginning with 'f32'):
    strict within GRAD_TOL (GRAD_TOL_1024 at 1024^2), at 'high' and
    'bf16' nearer the kernel backend's at the tier than the strict uni
    gradient (FLOW_SPLIT_RATIO); no K3/K4 launch on "uni". The launch
    counters are set to 0 just before each uni run and read just after.
    Returns (paths' launches, records, failures)."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import deriv, lenseflow_kernels as lfk
    paths, found, bad = {}, {}, {}
    for size, vg, phi_mix, tiers in cases:
        g = {}
        for tier in tiers:
            for be in ("kernel", "uni"):
                with ct.lenseflow_backend_ctx(be), deriv.precision_ctx(tier):
                    lfk.reset_launches()
                    _, g[be, tier] = vg(phi_mix)
                    torch.cuda.synchronize()
                    if be == "uni":
                        path = f"gradlnP {size}^2 P uni {tier}"
                        paths[path] = dict(lfk.LAUNCHES)
                        uni_no_k34(path, paths[path])
                        ms = cuda_ms(lambda: vg(phi_mix), 3, torch)
            gu, gk = g["uni", tier].arr, g["kernel", tier].arr
            d = dict(rel=rel(gu, gk), ms=ms)
            if tier == "f32":
                tol = GRAD_TOL_1024 if size == N_MAP else GRAD_TOL
                ok, line = d["rel"] < tol, f"bound {tol:g}"
            else:
                d["ratio"] = fro(gu, gk) / fro(gu, g["uni", "f32"].arr)
                ok = d["ratio"] < FLOW_SPLIT_RATIO
                line = (f"Frobenius distance over the distance to strict uni {d['ratio']:.4f} "
                        f"(bound {FLOW_SPLIT_RATIO:g})")
            print(f"{tag} gradlnP {size}^2 P on \"uni\" at {tier!r} vs the kernel backend "
                  f"at {tier!r}: rel max-abs {d['rel']:.3e}; {line}; uni {ms:.3f} ms [{card}]")
            if not (ok and torch.isfinite(gu).all()):
                bad[f"gradient {size} {tier}"] = d
            found[size, tier] = d
    return paths, found, bad


def uni_maps(torch, card, gctx, beside):
    """(e) MAP_joint at 1024^2 P on "uni" at its default "auto" and at
    precision="bf16" (run_map, phase 7's configuration): no K3/K4 launch,
    K5's 'high' (every role) or 'bf16' (the phi-step's roles 0-2)
    launched; beside phases 8, 9 and 14 (f). Then the path of K5's 'bf16'
    role 3: argmaxf_logpdf at 1024^2 P on "uni", hessian_precision="bf16",
    2 fixed iterations."""
    import cmblensing_tpu_torch as ct
    sim, paths, timing_out = gctx["sim"], {}, {}
    for tier, want in (("auto", [f"uni_role{r}_high" for r in range(4)]),
                       ("bf16", [f"uni_role{r}_bf16" for r in range(3)])):
        with ct.lenseflow_backend_ctx("uni"):
            launches, s_step, hist = run_map(torch, sim, 15, f"uni, precision {tier!r}", card,
                                             precision=tier)
        path = f"MAP_joint {N_MAP}^2 P uni {tier}"
        paths[path] = launches
        uni_no_k34(path, launches)
        timing_out[f"MAP_joint_1024_uni_{tier}_s_per_step"] = s_step
        print(f"phase 15: (e) f-steps re-run strict {sum(h['precision_fallback'] for h in hist)} "
              f"of {len(hist)}; direction retries fired {sum(h['retry'] for h in hist)}")
        if min(launches[k] for k in want) <= 0:
            raise AssertionError(f"MAP_joint on \"uni\" at {tier!r}: K5's {tier!r} tier did not "
                                 f"launch: {launches}")
    for phase, label in ((8, "\"uni\" strict"), (9, "\"kernel\" \"auto\""),
                         (14, "\"kernel\" 'bf16'")):
        s, h = (beside or {}).get(phase, (None, None))
        if h is None:
            print(f"phase 15: (e) beside phase {phase} ({label}): not run in this call")
            continue
        print(f"phase 15: (e) beside phase {phase} ({label}): {s:.3f} s/step; logpdfs "
              f"{[x['logpdf'] for x in h]!r}; alphas {[x['alpha'] for x in h]!r}; fallbacks "
              f"{sum(x.get('precision_fallback', False) for x in h)}; retries "
              f"{sum(x.get('retry', False) for x in h)}")
    path, paths[path] = uni_bf16_wiener(torch, sim)
    return paths, timing_out


def uni_wiener(torch, card, wf_sim, kernel_runs=None):
    """(f) the masked 256^2 IP Wiener filter on "uni": argmaxf_logpdf at
    the JAX defaults (tol 0.1, nsteps 500, "auto") against the kernel
    backend in the same call (the same fallback verdict; both iteration
    counts and times); 20 fixed strict iterations within WF_PLAIN_TOL of
    the kernel backend's; and 2 fixed iterations at
    hessian_precision="bf16" (the path of the dense K5's 'bf16' role 3).
    The counters are set to 0 just before each uni run and read after.
    kernel_runs holds phase 12's two kernel-backend solves of wf_sim (the
    "auto" one, "kernel", and the 20 fixed iterations, ("kernel",
    "fixed")), which are then not re-run."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    ds, phi = wf_sim["ds"], wf_sim["phi"]
    paths, runs = {}, dict(kernel_runs or {})

    def solve(backend, **cg):
        with ct.lenseflow_backend_ctx(backend):
            lfk.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fw, info = ct.argmaxf_logpdf(ds, phi=phi, conjgrad_kwargs=cg or None)
            torch.cuda.synchronize()
            return fw, info, 1e3 * (time.perf_counter() - t0), dict(lfk.LAUNCHES)

    for be in ("kernel", "uni"):
        if be not in runs:
            runs[be] = solve(be)
        _, info, ms, _ = runs[be]
        print(f"phase 15: (f) argmaxf_logpdf \"auto\" (tol 0.1, nsteps 500) masked {N}^2 IP on "
              f"\"{be}\": {info['iterations']} iterations returned, precision_fallback "
              f"{bool(info.get('precision_fallback', False))}, {ms:.1f} ms [{card}]")
    paths[f"argmaxf_logpdf masked {N}^2 IP uni auto"] = runs["uni"][3]
    fixed = dict(tol=0.0, nsteps=20, fixed_iters=True, hessian_precision=None)
    for be in ("kernel", "uni"):
        if (be, "fixed") not in runs:
            runs[be, "fixed"] = solve(be, **fixed)
    paths[f"argmaxf_logpdf masked {N}^2 IP uni, 20 fixed strict iterations"] = \
        runs["uni", "fixed"][3]
    fk, fu = runs["kernel", "fixed"][0], runs["uni", "fixed"][0]
    err = float((fu.arr - fk.to(fu.basis).arr).norm() / fk.arr.norm())
    print(f"phase 15: (f) 20 fixed strict iterations, uni vs kernel backend |f_u - f_k| / |f_k| = "
          f"{err:.3e} (bound {WF_PLAIN_TOL:g}); uni {runs['uni', 'fixed'][2]:.1f} ms, kernel "
          f"{runs['kernel', 'fixed'][2]:.1f} ms [{card}]")
    fb, _, _, paths[f"argmaxf_logpdf masked {N}^2 IP uni bf16, 2 iterations"] = solve(
        "uni", tol=0.0, nsteps=2, fixed_iters=True, hessian_precision="bf16")
    verdict = [bool(runs[be][1].get("precision_fallback", False)) for be in ("kernel", "uni")]
    bad = {}
    if verdict[0] != verdict[1]:
        bad["fallback verdict"] = verdict
    if not err < WF_PLAIN_TOL:
        bad["20 fixed iterations"] = err
    if not all(torch.isfinite(x.arr).all() for x in (runs["uni"][0], fu, fb)):
        bad["f"] = "not finite"
    timing_out = dict(argmaxf_256_IP_uni_auto_ms=runs["uni"][2],
                      argmaxf_256_IP_kernel_auto_ms=runs["kernel"][2],
                      argmaxf_256_IP_uni_auto_iterations=int(runs["uni"][1]["iterations"]),
                      argmaxf_256_IP_uni_auto_fallback=verdict[1])
    return paths, timing_out, bad


def uni_768(torch, card):
    """(g) L @ f on a 768^2 P load_sim on "uni" (the dense K5: radix 6 is
    not built), strict within FLOW_TOL and at 'high' within HIGH_TOL of
    the kernel backend (K2) at the same tier; K5's dense role 2 launched."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import deriv, lenseflow_kernels as lfk
    sim = ct.load_sim(thetapix=THETAPIX_MAP, Nside=N_DENSE_UNI, pol="P", T=np.float32, seed=SEED,
                      device=DEVICE)
    phi, f = sim["phi"].to(ct.MAP), sim["f"].to(ct.QU_MAP)
    bad = {}
    for tier, tol in (("f32", FLOW_TOL), ("high", HIGH_TOL)):
        out = {}
        for be in ("kernel", "uni"):
            with ct.lenseflow_backend_ctx(be), deriv.precision_ctx(tier):
                lfk.reset_launches()
                out[be] = (sim["ds"].L(phi) @ f).to(ct.QU_MAP).arr
                launches = dict(lfk.LAUNCHES)
        e = rel(out["uni"], out["kernel"])
        k5 = launches["uni_dense_role2" + ("" if tier == "f32" else "_high")]
        print(f"phase 15: (g) L @ f on a {N_DENSE_UNI}^2 P load_sim at {tier!r}: uni ({k5} dense "
              f"K5 launches) vs kernel backend {e:.3e} (bound {tol:g})")
        if not (k5 > 0 and e < tol):
            bad[f"768 L @ f {tier}"] = (e, k5)
    return bad


def phase_uni_tiers(torch, card, fctx=None, gctx=None, beside=None, wctx=None):
    """Phase 15: K5 at 'high' and 'bf16' and with dense operands, and the
    "uni" backend at the JAX defaults (see the module docstring). fctx and
    gctx are phases 5 and 6's 1024^2 contexts (made here when phase 15
    runs alone); beside holds phases 8, 9 and 14's MAP_joint (s/step,
    history); wctx is phase 12's masked IP simulation and its kernel
    backend's solves (loaded and solved here when phase 15 runs alone).
    Returns (kernel records {name: record}, launches {name: (path,
    count)}, timings)."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    t_start = time.perf_counter()
    fctx = fctx or uni_fctx(torch)
    if gctx is None:
        gctx = phase_map_gradient(torch, card)[0]
    bad, timing_out = {}, {}
    found, why = uni_tiers_factored(torch, card, fctx, N_MAP, ("high", "bf16"), 15)
    records = {f"uni_role{key}_{tier}": d for (tier, key), d in found.items()}
    bad.update(why)
    t0 = time.perf_counter()
    wf_sim = ct.load_sim(**WF_SIM, device=DEVICE) if wctx is None else wctx["sim"]
    sim256 = ct.load_sim(thetapix=3, Nside=N, pol="P", T=np.float32, seed=SEED, device=DEVICE)
    torch.cuda.synchronize()
    print(f"phase 15: load_sim {WF_SIM} and at {N}^2 P: {time.perf_counter() - t0:.2f} s [{card}]")
    dense, why = uni_tiers_dense(torch, card, wf_sim)
    records.update(dense)
    bad.update(why)
    _, why = uni_tier_flows(torch, card, fctx)
    bad.update(why)
    f256 = sim256["f"].to(sim256["f"].basis.with_space("map"))
    p256 = sim256["phi"].to(ct.MAP)
    m = ct.mix(sim256["ds"], f=f256, phi=p256)
    f_mix, phi_mix = m["f_mix"].to(f256.basis), m["phi_mix"].to(p256.basis)
    vg = ct.fvalue_and_grad(lambda p: ct.Mixed(sim256["ds"]).logpdf(f_mix=f_mix, phi_mix=p))
    paths, grads, why = uni_gradients(torch, card, (
        (N, vg, phi_mix, lfk.PRECISIONS), (N_MAP, gctx["vg"], gctx["phi_mix"], lfk.PRECISIONS)),
        "phase 15: (d)")
    bad.update(why)
    timing_out.update({f"gradlnP_{s}_uni_{t}_ms": d["ms"] for (s, t), d in grads.items()})
    wpaths, wtiming, why = uni_wiener(torch, card, wf_sim, wctx and wctx["kernel"])
    paths.update(wpaths)
    timing_out.update(wtiming)
    bad.update(why)
    bad.update(uni_768(torch, card))
    if bad:
        raise AssertionError(f"phase 15: K5 or the uni path disagrees: {bad}")
    mpaths, mtiming = uni_maps(torch, card, gctx, beside)
    paths.update(mpaths)
    timing_out.update(mtiming)
    # each record's launches: the named path's run
    path_of = {f"uni_role{r}_high": f"MAP_joint {N_MAP}^2 P uni auto" for r in range(4)}
    path_of.update({f"uni_role{r}_bf16": f"MAP_joint {N_MAP}^2 P uni bf16" for r in range(3)})
    path_of["uni_role3_bf16"] = f"argmaxf_logpdf {N_MAP}^2 P uni bf16, 2 iterations"
    for tier, sfx, role3 in (("f32", "", f"argmaxf_logpdf masked {N}^2 IP uni, 20 fixed strict "
                              "iterations"),
                             ("high", "_high", f"argmaxf_logpdf masked {N}^2 IP uni auto"),
                             ("bf16", "_bf16", f"argmaxf_logpdf masked {N}^2 IP uni bf16, 2 "
                              "iterations")):
        path_of.update({f"uni_dense_role{r}{sfx}": f"gradlnP {N}^2 P uni {tier}" for r in range(3)})
        path_of[f"uni_dense_role3{sfx}"] = role3
    launches = {name: (p, paths[p][name]) for name, p in path_of.items()}
    never = {k: v for k, v in launches.items() if v[1] <= 0}
    if never:
        raise AssertionError(f"a K5 kernel never launched in its path's run: {never}")
    for name, (p, n) in launches.items():
        print(f"phase 15: {name}: {n} launches in {p}")
    print(f"phase 15: wall time {time.perf_counter() - t_start:.1f} s [{card}]")
    return records, launches, timing_out


def uni_large_flows(torch, card, N, ctx):
    """Phase 16 (b): the uni flows (L, L^-1, L^H, backward delta phi and
    delta f; nsteps NSTEPS) at every tier against the kernel backend's
    flows (K3/K4) at the tier: L, L^-1, L^H and delta f the same bits, or
    else within FLOW_TOL; delta phi (hoisted there) within
    DPHI_UNHOISTED_TOL strict, UNI_DPHI_TOL at a reduced tier. At 2048^2
    also against the plain uni flows at the tier (UNI_TOL, and at a
    reduced tier nearer them than the strict uni flow, FLOW_SPLIT_RATIO).
    Returns {what: why it failed}."""
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    ops, phi_map, f, dy = (ctx[k] for k in ("ops", "phi_map", "f", "dy"))
    vs_plain = N == 2048
    kinds = (("L", 0., 1., "forward"), ("L^-1", 1., 0., "forward"), ("L^H", 1., 0., "adjoint"))

    def timed(fn):
        torch.cuda.synchronize()
        t_ = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t_)

    bad = {}
    for tier in lfk.PRECISIONS:
        planes = lfk.gradhess(phi_map, ops, tier)
        runs = {}
        for name, t0, t1, kind in kinds:
            ap = lambda fn, p: fn(f, planes, ops, t0, t1, NSTEPS, kind, p)
            (u, ms), (k, kms) = timed(lambda: ap(lfk.uni_flow_apply, tier)), timed(
                lambda: ap(lfk.flow_apply, tier))
            runs[name] = (u, k, ms, kms)
            if vs_plain:
                runs[name] += (ap(lfk.uni_flow_apply_plain, tier), ap(lfk.uni_flow_apply, "f32"))
        bw = lambda fn, p: fn(dy, f, planes, ops, 0., 1., NSTEPS, p)
        (ub, ms), (kb, kms) = timed(lambda: bw(lfk.uni_flow_bwd, tier)), timed(
            lambda: bw(lfk.flow_bwd, tier))
        extra = (bw(lfk.uni_flow_bwd_plain, tier), bw(lfk.uni_flow_bwd, "f32")) if vs_plain else ()
        for i, name in enumerate(("backward dphi", "backward df0")):
            runs[name] = (ub[i], kb[i], ms, kms) + tuple(x[i] for x in extra)
        for name, r in runs.items():
            dphi = name == "backward dphi"
            same, vs_k = bool(torch.equal(r[0], r[1])), rel(r[0], r[1])
            ktol = (DPHI_UNHOISTED_TOL if tier == "f32" else UNI_DPHI_TOL[tier]) if dphi \
                else FLOW_TOL
            line = f"vs K3/K4 flow {vs_k:.3e} (bound {ktol:g}), same bits {same}"
            if not (vs_k < ktol or (same and not dphi)):
                bad[f"{tier} {N} {name} vs K3/K4"] = vs_k
            if vs_plain:
                vs_p, ratio = rel(r[0], r[4]), split_ratio(r[0], r[4], r[5]) \
                    if tier != "f32" else {"split_ratio": 0.0}
                line = (f"vs plain uni {vs_p:.3e} (bound {UNI_TOL[tier]:g}), Frobenius ratio "
                        f"{ratio['split_ratio']:.4f} (bound {FLOW_SPLIT_RATIO:g}); " + line)
                if not (vs_p < UNI_TOL[tier] and ratio["split_ratio"] < FLOW_SPLIT_RATIO):
                    bad[f"{tier} {N} {name} vs plain"] = (vs_p, ratio["split_ratio"])
            print(f"phase 16: (b) uni flow {name:14s} {tier!r} {N}^2 P: {line}  uni {r[2]:.2f} ms, "
                  f"K3/K4 {r[3]:.2f} ms [nsteps={NSTEPS}; {card}]")
        del runs
    return bad


def uni_no_k34(path, launches):
    """Raise where a run on "uni" launched K3 or K4."""
    k34 = {k: v for k, v in launches.items() if k.startswith(("fa_velocity", "bv_velocity")) and v}
    if k34:
        raise AssertionError(f"{path}: K3/K4 launched on the uni backend: {k34}")


def uni_bf16_wiener(torch, sim):
    """argmaxf_logpdf on "uni" at hessian_precision="bf16", 2 fixed
    iterations, f finite: the path of K5's 'bf16' role 3 (a phi-step
    runs no adjoint flow at 'bf16'). Returns (path, launches)."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    N = sim["ds"].d.proj.Nx
    with ct.lenseflow_backend_ctx("uni"):
        lfk.reset_launches()
        fw, _ = ct.argmaxf_logpdf(sim["ds"], phi=sim["phi"], conjgrad_kwargs=dict(
            tol=0.0, nsteps=2, fixed_iters=True, hessian_precision="bf16"))
        torch.cuda.synchronize()
    path = f"argmaxf_logpdf {N}^2 P uni bf16, 2 iterations"
    launches = dict(lfk.LAUNCHES)
    uni_no_k34(path, launches)
    if not torch.isfinite(fw.arr).all():
        raise AssertionError(f"{path}: f not finite")
    return path, launches


def uni_steps_2048(torch, card, sim):
    """Phase 16 (d) at 2048^2 P: one strict MAP_joint step on "kernel" and
    on "uni" (the same alpha and logpdf, STEP_TOL), one at "auto" and one
    at 'bf16' on "uni" (logpdf finite, a step taken), each with the
    counters set to 0 just before and read just after, no K3/K4 launch on
    "uni"; the line search's footprint on "uni". Returns ({path:
    launches}, timings)."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    ds = sim["ds"]
    keys = ("logpdf", "alpha", "cg_iters", "precision_fallback", "retry", "f")
    runs, paths = {}, {}
    # the "auto" step first: it meets the size's one-time costs on "uni"
    for be, p in (("uni", "auto"), ("kernel", None), ("uni", None), ("uni", "bf16")):
        with ct.lenseflow_backend_ctx(be):
            lfk.reset_launches()
            runs[be, p] = map_steps(torch, ds, 1, p, keys)
            if be == "uni":
                path = f"MAP_joint 2048^2 P uni {p or 'strict'}, 1 step"
                paths[path] = dict(lfk.LAUNCHES)
                uni_no_k34(path, paths[path])
    hist = {k: r[0]["history"][0] for k, r in runs.items()}
    hk, hu = hist["kernel", None], hist["uni", None]
    d_lp = abs(hu["logpdf"] - hk["logpdf"]) / abs(hk["logpdf"])
    d_a = abs(hu["alpha"] - hk["alpha"]) / max(abs(hk["alpha"]), 1e-30)
    print(f"phase 16: (d) MAP_joint 2048^2 P strict, 1 step: uni {runs['uni', None][1]:.3f} s, "
          f"kernel {runs['kernel', None][1]:.3f} s; logpdf {hu['logpdf']!r} vs {hk['logpdf']!r} "
          f"(rel {d_lp:.2e}, bound {STEP_TOL:g}); alpha {hu['alpha']!r} vs {hk['alpha']!r} (rel "
          f"{d_a:.2e}) [{card}]")
    for p in ("auto", "bf16"):
        h = hist["uni", p]
        print(f"phase 16: (d) MAP_joint 2048^2 P on \"uni\" at {p!r}, 1 step"
              f"{' (the first at 2048^2 in this phase, set-up included)' if p == 'auto' else ''}: "
              f"{runs['uni', p][1]:.3f} s; logpdf {h['logpdf']!r}, alpha {h['alpha']!r}, fallback "
              f"{h['precision_fallback']}, retry {h['retry']}")
    with ct.lenseflow_backend_ctx("uni"):
        per_trial = linesearch_footprint(torch, card, ds, runs["uni", None][0], 16)
    bad = {}
    if not (d_lp < STEP_TOL and d_a < STEP_TOL):
        bad["strict step uni vs kernel"] = (d_lp, d_a)
    if not all(np.isfinite(h["logpdf"]) and h["alpha"] > 0 for h in hist.values()):
        bad["steps"] = hist
    if bad:
        raise AssertionError(f"phase 16: 2048^2 MAP_joint on \"uni\" disagrees: {bad}")
    return paths, {"MAP_joint_2048_uni_s_per_step": (runs["uni", None][1],
                                                     runs["kernel", None][1]),
                   "MAP_joint_2048_uni_auto_s": runs["uni", "auto"][1],
                   "MAP_joint_2048_uni_bf16_s": runs["uni", "bf16"][1],
                   "linesearch_planes_per_trial_2048_uni": per_trial}


def phase_uni_large(torch, card, beside=None):
    """Phase 16: K5 at radix 16 and 32 and the "uni" backend at 2048^2 and
    4096^2 P (see the module docstring). beside holds phase 13's 4096^2
    "auto" s/step, when it ran in this call. Returns (kernel records
    {name: record}, launches {name: (path, count)}, timings)."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    t_start = time.perf_counter()
    records, bad = {}, {}
    for N in N_LARGE:
        ctx = uni_fctx(torch, N)
        found, why = uni_tiers_factored(torch, card, ctx, N, lfk.PRECISIONS, 16, N == 2048)
        records.update({f"uni_role{key}{'' if tier == 'f32' else '_' + tier}_b{N // FA}": d
                        for (tier, key), d in found.items()})
        bad.update(why)
        bad.update(uni_large_flows(torch, card, N, ctx))
        del ctx
        torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"phase 16: K5 or the uni flows disagree: {bad}")
    sim = large_sim(torch, card, 2048, 16)
    paths, _, bad = uni_gradients(torch, card, ((2048, *mixed_vg(sim), ("f32",)),), "phase 16: (c)")
    step_paths, timing_out = uni_steps_2048(torch, card, sim)
    paths.update(step_paths)
    path, paths[path] = uni_bf16_wiener(torch, sim)
    del sim
    torch.cuda.empty_cache()
    sim = large_sim(torch, card, 4096, 16)
    gpaths, grads, why = uni_gradients(torch, card, ((4096, *mixed_vg(sim), ("f32", "bf16")),),
                                       "phase 16: (c)")
    paths.update(gpaths)
    bad.update(why)
    if bad:
        raise AssertionError(f"phase 16: the gradient on \"uni\" disagrees: {bad}")
    path, paths[path] = uni_bf16_wiener(torch, sim)
    torch.cuda.empty_cache()
    with ct.lenseflow_backend_ctx("uni"):
        run_launches, s_step, peak = large_map_4096(torch, card, sim, 16, UNI_LARGE_STEPS)
    main_path = "MAP_joint 4096^2 P uni auto"
    paths[main_path] = run_launches
    uni_no_k34(main_path, run_launches)
    del sim
    SIM_CACHE.clear()
    torch.cuda.empty_cache()
    kernel_s = (beside or {}).get("MAP_joint_4096_s_per_step")
    print(f"phase 16: (d) MAP_joint 4096^2 P \"auto\": uni {s_step:.3f} s/step, peak {peak:.2f} GiB; "
          + (f"phase 13 (kernel) {kernel_s:.3f} s/step, peak "
             f"{beside['MAP_joint_4096_peak_GiB']:.2f} GiB" if kernel_s else
             "phase 13 (kernel) not run in this call") + f" [{card}]")
    timing_out.update(MAP_joint_4096_uni_s_per_step=s_step, MAP_joint_4096_uni_peak_GiB=peak,
                      gradlnP_4096_uni_ms=grads[4096, "f32"]["ms"],
                      gradlnP_4096_uni_bf16_ms=grads[4096, "bf16"]["ms"])
    # each record's launches: the named path's run (strict roles 0 and 1
    # run in a 4096^2 "auto" step only on a direction retry, 'bf16' role 3
    # in no phi-step)
    path_of = {}
    for r in range(4):
        path_of[f"uni_role{r}_b16"] = "MAP_joint 2048^2 P uni strict, 1 step"
        path_of[f"uni_role{r}_high_b16"] = "MAP_joint 2048^2 P uni auto, 1 step"
        path_of[f"uni_role{r}_bf16_b16"] = ("MAP_joint 2048^2 P uni bf16, 1 step" if r < 3 else
                                           "argmaxf_logpdf 2048^2 P uni bf16, 2 iterations")
        path_of[f"uni_role{r}_b32"] = "gradlnP 4096^2 P uni f32" if r < 3 else main_path
        path_of[f"uni_role{r}_high_b32"] = main_path
        path_of[f"uni_role{r}_bf16_b32"] = ("gradlnP 4096^2 P uni bf16" if r < 3 else
                                           "argmaxf_logpdf 4096^2 P uni bf16, 2 iterations")
    launches = {name: (p, paths[p][name.rsplit("_", 1)[0]]) for name, p in path_of.items()}
    never = {k: v for k, v in launches.items() if v[1] <= 0}
    if never:
        raise AssertionError(f"a radix-16/32 K5 kernel never launched in its path's run: {never}")
    for name, (p, n) in launches.items():
        print(f"phase 16: {name}: {n} launches in {p}")
    print(f"phase 16: wall time {time.perf_counter() - t_start:.1f} s [{card}]")
    return records, launches, timing_out


def same_bits(torch, shape, run):
    """run(out) into buffers of NaN, 1e30 and zeros of `shape`, each with one
    more entry behind out: (the same bits from every buffer, nothing
    written past the last entry)."""
    first, clean, same = None, True, True
    for fill in (float("nan"), 1e30, 0.0):
        buf = torch.full((shape[0] + 1,) + tuple(shape[1:]), fill, device=DEVICE)
        run(buf[:shape[0]])
        past = buf[shape[0]]
        clean &= bool((torch.isnan(past) if fill != fill else past == fill).all())
        if first is None:
            first = buf[:shape[0]].clone()
        else:
            same &= bool(torch.equal(first, buf[:shape[0]]))
        del buf
    return same, clean


def sm90_k1(torch, card, N):
    """Phase 17 (a) at N^2, and (e)'s strict K1: K1 at 'high' and 'bf16'
    (csrc/fderiv_sm90.cu) and strict on the tile FORMS names
    (sm90_tiers("fderiv", B): the cluster tile at radix 16 and 32, its FP32
    tier) on d_x a, d_y b and d_x a + d_y b + c at batch 1 and
    NPLANES_SM90, against its plain version at the tier (strict: FLOW_TOL)
    and, at a reduced tier, the strict kernel (high_against; every plane:
    K1_SM90_TOL, at 'high' HIGH_VS_STRICT, the Frobenius ratio under
    HIGH_SPLIT_RATIO); into buffers of NaN, 1e30 and zeros the same bits,
    nothing written past the last plane; d_x and d_y timed cold beside the
    strict kernel (strict: beside its parent's time, PARENT_MS) and, for
    d_x, the library call of the tier; then the path: the backward flow
    (nsteps 1) at the tier, whose hoisted delta phi runs K1 on five passes,
    the launch counters set to 0 just before and read just after, delta
    phi within K1_SM90_TOL (strict: FLOW_TOL) of plain flow_bwd at the tier
    (phi a weak-lensing potential: the flow needs I + t Hess phi invertible
    over t in [0, 1]). Returns ({tier: record}, {tier: launches},
    failures)."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import deriv, lenseflow_kernels as lfk
    B = N // FA
    proj = ct.ProjLambert(N, N, thetapix=THETAPIX_MAP, T=np.float32, device=DEVICE)
    ops = deriv.deriv_ops(proj)
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 17)
    a, b, c = (torch.randn((NPLANES_SM90, 1, N, N), generator=g, device=DEVICE)
               for _ in range(3))
    reps = 10 if N <= 1024 else 5
    DxT, _ = deriv.deriv_mats(proj)
    records, launches, bad = {}, {}, {}
    for tier in [p for p in sm90_tiers("fderiv", B) if p == "f32"] + ["high", "bf16"]:
        tol = K1_SM90_TOL.get(tier, FLOW_TOL)
        form, src = form_source("fderiv", tier, B)
        found = {}
        for nb in (1, NPLANES_SM90):
            x, y, z = a[:nb], b[:nb], c[:nb]
            for label, args, nder, planes, axes in (("x", (x, None, None), 1, 2, 1),
                                                    ("y", (None, y, None), 1, 2, 1),
                                                    ("xyc", (x, y, z), 2, 4, 2)):
                key = f"{label}[{nb}]"
                run = lambda o, p, args=args: lfk.fderiv_cuda(*args, o, ops, p)
                if tier == "f32":
                    o, ref = torch.full_like(x, float("nan")), torch.empty_like(x)
                    run(o, tier)
                    lfk.fderiv_plain(*args, ref, ops)
                    d = found[key] = dict(max_abs_err=float((o - ref).abs().max()),
                                          rel=max(rel(p, q) for p, q in zip(o, ref)))
                    d.update(bound(nb * nder * fact_deriv_flops(N), nb * planes, N,
                                   axes * (B * FA * FA + 2 * B * B)))
                    del o, ref
                else:
                    d = found[key] = high_against(
                        torch, run, lambda o, args=args: lfk.fderiv_plain(*args, o, ops, tier),
                        x.shape, tier)
                    d.update(bound_high(N, nder, planes, nb, axes, tier=tier))
                same, clean = same_bits(torch, x.shape, lambda o, run=run: run(o, tier))
                d.update(clean=clean, same=same, nb=nb, form=form, source=src)
                if label != "xyc" and (nb == 1 or label == "x"):
                    o = torch.empty_like(x)
                    d["ms"] = cold_ms(lambda o_, *q: lfk.fderiv_cuda(*q, o_, ops, tier),
                                      (o, *args), reps, torch)
                    if tier != "f32":
                        d["strict_ms"] = cold_ms(lambda o_, *q: lfk.fderiv_cuda(*q, o_, ops, "f32"),
                                                 (o, *args), reps, torch)
                    d["plain_ms"] = cuda_ms(lambda: lfk.fderiv_plain(*args, o, ops, tier), 1, torch)
                    del o
        lib = (library_bf16_ms(a[0, 0], DxT, torch, reps=max(3, reps // 2))[0] if tier == "bf16"
               else split_matmuls_ms(a[0, 0], DxT, True, torch, reps=max(3, reps // 2))
               if tier == "high" else matmul_ms(a[0, 0], DxT, torch, reps=max(3, reps // 2),
                                                cold=True))
        for key, d in found.items():
            if tier == "f32":
                ok, vs = d["rel"] < FLOW_TOL, f"{d['rel']:.3e} (bound {FLOW_TOL:g})"
            else:
                ok = (d["rel"] < tol and d["split_ratio"] < HIGH_SPLIT_RATIO
                      and (tier == "bf16" or d["rel_strict"] < HIGH_VS_STRICT))
                vs = (f"{d['rel']:.3e} (bound {tol:g}) vs strict {d['rel_strict']:.3e}, "
                      f"Frobenius ratio {d['split_ratio']:.4f}")
            if not ok:
                bad[f"{tier} {N}^2 {key}"] = vs
            if not (d["clean"] and d["same"]):
                bad[f"{tier} {N}^2 {key} same bits / nothing past a plane"] = (d["same"], d["clean"])
            beside = (f"strict {d['strict_ms']:.4f}" if "strict_ms" in d
                      else f"parent {PARENT_MS.get(('fderiv', key[0], N), 'not recorded')}")
            timed = (f"  {d['ms']:.4f} ms cold ({beside}, plain {d['plain_ms']:.4f}), bound "
                     f"{d['bound_ms']:.4f} ms ({d['bound_by']}, "
                     f"{100 * d['bound_ms'] / d['ms']:.1f} %)" if "ms" in d else "")
            print(f"phase 17: K1 {tier:4s} radix {B:2d} {key:9s} on {form} vs plain {vs}; same "
                  f"bits in NaN / 1e30 / 0 {d['same']}, past the last plane "
                  f"{'untouched' if d['clean'] else 'WRITTEN'}{timed}"
                  + (f"  library {lib:.4f} ms" if key == "x[1]" else "") + f" [{N}^2; {card}]")
        many = [found[f"{k}[{NPLANES_SM90}]"] for k in ("x", "y", "xyc")]
        records[tier] = dict(found["x[1]"], library_ms=lib, d_y_ms=found["y[1]"]["ms"],
                             batched=dict(nb=NPLANES_SM90, ms=many[0]["ms"],
                                          rel=max(m["rel"] for m in many)))
        # the path: the backward flow's hoisted delta phi, five K1 passes
        # phi = A cos(k (x + y)) with |Hess phi| = A k^2 = 0.1 (weak lensing)
        xs = torch.arange(N, device=DEVICE, dtype=torch.float32) * (2 * np.pi / N)
        k = 2 * np.pi / (N * float(proj.deltax))
        phi_map = (0.1 / k ** 2 * torch.cos(xs[:, None] + xs[None, :]))[None]
        phi = lfk.gradhess(phi_map.contiguous(), ops, "f32")
        f1, dy = b[:2, 0].contiguous(), c[:2, 0].contiguous()
        sfx = "" if tier == "f32" else "_" + tier
        lfk.reset_launches()
        dphi, _ = lfk.flow_bwd(dy, f1, phi, ops, 0., 1., 1, tier)
        torch.cuda.synchronize()
        launches[tier] = dict(lfk.LAUNCHES)
        n = launches[tier]["fderiv" + sfx]
        e = rel(dphi, lfk.flow_bwd_plain(dy, f1, phi, ops, 0., 1., 1, tier)[0])
        print(f"phase 17: launches in the backward flow at {N}^2, {tier!r} (nsteps 1): K1 {n} "
              f"(five passes), K4 {launches[tier]['bv_velocity' + sfx]} (a launch a pass); "
              f"delta phi vs plain {tier!r} {e:.3e} (bound {tol:g})")
        if n != 5 or launches[tier]["bv_velocity" + sfx] != 8 or not e < tol:
            bad[f"{tier} {N}^2 path"] = (n, launches[tier]["bv_velocity" + sfx], e)
        del phi, f1, dy, dphi
    del DxT, a, b, c
    proj._tensors.clear()
    torch.cuda.empty_cache()
    return records, launches, bad


def flow_checks(flows, tier, nsteps, tols=None):
    """Phase 17's reduced-tier flows at nsteps against their plain versions
    at the tier and the strict kernel flows, {name: (flow, plain, strict)},
    every plane on its own: the Frobenius ratio under FLOW_SPLIT_RATIO, and
    at NSTEPS the relative max-abs within K1_SM90_TOL (the path phases 14
    and 16 hold); at nsteps 1 the max-abs is printed against that bound but
    not held: one step of dt = 1 takes it past (K3 'bf16' L 2.6e-3 at
    512^2, K5 'high' delta phi 3.2e-5) while the Frobenius ratio stays
    under 1, and the flows on fact_tile, the form these kernels replaced,
    give the same bits (scripts/torch_flow_witness.py, PERF.md). `tols`
    names outputs held to a bound of their own in place of K1_SM90_TOL:
    K4's delta phi at 'bf16', DPHI_BF16_TOL (PERF.md §2). Returns (the
    line to print, {name: failing readings})."""
    line, why = "", {}
    for name, (out, plain, strict) in flows.items():
        e = max(rel(a, b) for a, b in zip(out.reshape(-1, *out.shape[-2:]),
                                          plain.reshape(-1, *out.shape[-2:])))
        r = split_ratio(out, plain, strict)["split_ratio"]
        held = nsteps == NSTEPS
        tol = (tols or {}).get(name, K1_SM90_TOL[tier])
        note = "" if held else f", held at nsteps {NSTEPS}"
        line += (f"; {name} vs plain {e:.3e} (bound {tol:g}{note}), Frobenius "
                 f"ratio {r:.4f} (bound {FLOW_SPLIT_RATIO:g})")
        if not r < FLOW_SPLIT_RATIO or (held and not e < tol):
            why[name] = (e, r)
    return line, why


def sm90_tiers(kernel, B):
    """The tiers phase 17 runs K1 ('fderiv'), K3 ('fa'), K4 ('bv') or K5
    ('uni') at, radix B: 'high' and 'bf16' on the tile
    lenseflow_kernels.FORMS puts them on, and the strict tier where FORMS
    puts it on the cluster tile (radix 16 and 32; on fact_tile phases 5, 8,
    13 and 16 hold it); K4 at every tier on either tile."""
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    return [p for p in lfk.PRECISIONS
            if p != "f32" or kernel == "bv" or lfk.FORMS[kernel, p, B] == "cluster"]


def form_source(kernel, tier, B):
    """The tile FORMS runs K1 ('fderiv'), K3 ('fa'), K4 ('bv') or K5
    ('uni') on at (tier, B), and the source of that form."""
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    form = lfk.FORMS[kernel, tier, B]
    if form == "cluster":
        return form, {"fderiv": FDERIV_SM90_SRC, "fa": FA_SM90_SRC, "bv": BV_SM90_SRC,
                      "uni": UNI_SM90_SRC}[kernel]
    return form, FACTORED_SRC if kernel != "uni" else "cmblensing_tpu_torch/csrc/uni.cu"


def sm90_k3(torch, card, N):
    """Phase 17 (c) at N^2: K3 at 'high' and 'bf16' on the tile FORMS puts
    them on (csrc/fa_sm90.cu, the cluster tile, or fact_tile) and strict on
    the cluster tile where FORMS puts it there (sm90_tiers), both roles, at
    batch 1 and (to N_SM90_BATCHED) on NTRIAL trials each with its own
    phi: strict against its plain version (FLOW_TOL, every plane), a
    reduced tier against plain at the tier and the strict kernel
    (high_against; every plane: K1_SM90_TOL, at 'high' HIGH_VS_STRICT, the
    Frobenius ratio under HIGH_SPLIT_RATIO); into buffers of NaN, 1e30 and
    zeros the same bits, nothing written past the last entry; timed cold
    (a reduced tier beside the strict kernel), with the tier's bound; then
    the path: the forward and adjoint flows (nsteps 1 and NSTEPS) at the
    tier, the launch counters set to 0 just before each and read just
    after: one launch a pass (8 nsteps a flow), no strict K3 launch in a
    reduced tier's flow, the flow finite and, at a reduced tier to
    N_SM90_BATCHED, held to its plain version by flow_checks (phases 13 and
    16 hold the larger flows and the strict ones). Returns ({name: record},
    {name: (path, launches)}, failures)."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import deriv, lenseflow_kernels as lfk
    B, t = N // FA, 0.5
    tiers = sm90_tiers("fa", B)
    proj = ct.ProjLambert(N, N, thetapix=THETAPIX_MAP, T=np.float32, device=DEVICE)
    ops = deriv.deriv_ops(proj)
    phi_map, f, _ = weak_lensing_inputs(proj, torch)
    phi = lfk.gradhess(phi_map, ops)
    inputs = {1: (f[None].contiguous(), phi[None])}
    if N <= N_SM90_BATCHED:
        scales = torch.linspace(0.1, 2.0, NTRIAL, device=DEVICE).reshape(-1, 1, 1, 1)
        inputs[NTRIAL] = (torch.stack([torch.roll(f, 7 * i, dims=-1) for i in range(NTRIAL)]),
                          (scales * phi).contiguous())
    found, bad = {}, {}
    for nb, (y, phis) in inputs.items():
        pt = torch.empty((2, nb, N, N), device=DEVICE)
        lfk.p_planes_cuda(t, phis, pt)
        for tier in tiers:
            form, src = form_source("fa", tier, B)
            for kind in ("forward", "adjoint"):
                at = lambda p, kind=kind: (lambda o, y_, ph, pt_: lfk.fvelocity_cuda(
                    kind, y_, o, ph, pt_, ops, 2, t, p))
                plain = lambda o, kind=kind, tier=tier: lfk.fvelocity_plain(
                    kind, y, o, phis, pt, ops, 2, t, tier)
                if tier == "f32":
                    o, ref = torch.full_like(y, float("nan")), torch.empty_like(y)
                    at(tier)(o, y, phis, pt)
                    plain(ref)
                    d = dict(max_abs_err=float((o - ref).abs().max()),
                             rel=max(rel(a, b) for a, b in zip(o.reshape(-1, N, N),
                                                               ref.reshape(-1, N, N))))
                    del o, ref
                else:
                    d = high_against(torch, lambda o, p, at=at: at(p)(o, y, phis, pt), plain,
                                     y.shape, tier)
                d["same"], d["clean"] = same_bits(torch, y.shape,
                                                  lambda o, at=at, tier=tier: at(tier)(o, y, phis,
                                                                                      pt))
                o = torch.empty_like(y)
                reps = (10 if N <= 1024 else 5) if nb == 1 else 3
                d.update(nb=nb, library_ms=None, source=src, form=form,
                         ms=cold_ms(at(tier), (o, y, phis, pt), reps, torch),
                         plain_ms=cuda_ms(lambda: plain(o), 1, torch),
                         **(bound(nb * 4 * fact_deriv_flops(N), nb * 6, N, fact_op_floats(N))
                            if tier == "f32" else bound_high(N, 4, 6, nb, 2, tier)))
                if nb == 1 and tier != "f32":
                    d["strict_ms"] = cold_ms(at("f32"), (o, y, phis, pt), reps, torch)
                del o
                found[tier, kind, nb] = d
                if tier == "f32":
                    ok = d["rel"] < FLOW_TOL
                    vs = f"{d['rel']:.3e} (bound {FLOW_TOL:g})"
                else:
                    ok = (d["rel"] < K1_SM90_TOL[tier] and d["split_ratio"] < HIGH_SPLIT_RATIO
                          and (tier == "bf16" or d["rel_strict"] < HIGH_VS_STRICT))
                    vs = (f"{d['rel']:.3e} (bound {K1_SM90_TOL[tier]:g}) vs strict "
                          f"{d['rel_strict']:.3e}, Frobenius ratio {d['split_ratio']:.4f}")
                if not ok:
                    bad[f"K3 {tier} {kind} {N}^2 [{nb}]"] = vs
                if not (d["same"] and d["clean"]):
                    bad[f"K3 {tier} {kind} {N}^2 [{nb}] same bits / nothing past an entry"] = (
                        d["same"], d["clean"])
                strict = f", strict {d['strict_ms']:.4f}" if "strict_ms" in d else ""
                print(f"phase 17: K3 {tier:4s} {kind:8s} radix {B:2d} [{nb:2d}] on {form} vs "
                      f"plain {vs}; same bits in NaN / 1e30 / 0 {d['same']}, past the last entry "
                      f"{'untouched' if d['clean'] else 'WRITTEN'}  {d['ms']:.4f} ms cold"
                      f"{strict}, plain {d['plain_ms']:.4f}, bound {d['bound_ms']:.4f} ms "
                      f"({d['bound_by']}, {100 * d['bound_ms'] / d['ms']:.1f} %) [{N}^2; {card}]")
        del pt
    records, launches = {}, {}
    sfx = "" if N == N_MAP else f"_b{B}"
    for tier in tiers:
        for kind in ("forward", "adjoint"):
            d = dict(found[tier, kind, 1])
            if (tier, kind, NTRIAL) in found:
                d["batched"] = {k: found[tier, kind, NTRIAL][k]
                                for k in ("nb", "max_abs_err", "rel", "ms", "plain_ms")}
            name = f"fa_velocity_{kind}{'' if tier == 'f32' else '_' + tier}{sfx}"
            records[name] = d
            # the path: the flow at the tier, one launch a pass, at nsteps 1
            # and NSTEPS
            for nsteps in (1, NSTEPS):
                run = lambda fn, p: fn(f, phi, ops, 0., 1., nsteps, kind, p)
                lfk.reset_launches()
                out = run(lfk.flow_apply, tier)
                torch.cuda.synchronize()
                n, n_strict = (lfk.LAUNCHES[f"fa_velocity_{kind}{x}"]
                               for x in ("" if tier == "f32" else "_" + tier, ""))
                n_strict = 0 if tier == "f32" else n_strict
                path = f"flow_apply {kind} {N}^2 {tier}, nsteps {nsteps}"
                if nsteps == NSTEPS:
                    launches[name] = (path, n)
                line, why = flow_checks({"flow": (out, run(lfk.flow_apply_plain, tier),
                                                  run(lfk.flow_apply, "f32"))}, tier, nsteps) \
                    if N <= N_SM90_BATCHED and tier != "f32" else ("", {})
                print(f"phase 17: launches in {path}: K3 {n} at the tier (a launch a pass)"
                      + ("" if tier == "f32" else f", {n_strict} strict")
                      + f"; the flow finite {bool(torch.isfinite(out).all())}" + line)
                if n != 8 * nsteps or n_strict != 0 or not torch.isfinite(out).all() or why:
                    bad[f"K3 {tier} {kind} {N}^2 path, nsteps {nsteps}"] = (n, n_strict, why)
    del phi, f, phi_map, inputs
    proj._tensors.clear()
    torch.cuda.empty_cache()
    return records, launches, bad


def sm90_k5(torch, card, N, held=None):
    """Phase 17 (d) at N^2: K5 at 'high' and 'bf16' on the tile FORMS puts
    them on (csrc/uni_sm90.cu, the cluster tile, or csrc/uni.cu on
    fact_tile) and strict on the cluster tile where FORMS puts it there
    (sm90_tiers), every role and stage, on the strided views of a flow
    state the uni flows pass it, at batch 1 and (to N_SM90_BATCHED) NTRIAL
    trials (uni_tiers_factored: every plane against plain at the tier and,
    at a reduced tier, the strict kernel, the zero planes exact, two
    launches the same bits, nothing past a plane, timed cold with the
    bound); into buffers of NaN, 1e30 and zeros the same bits; then the
    path: the uni forward, adjoint and backward flows (nsteps 1 and
    NSTEPS) at the tier, the launch counters set to 0 just before and read
    just after: two launches a stage (roles 2, 3, 0: 8 nsteps a flow; role
    1: 16 nsteps), no strict K5 launch in a reduced tier's flows, each flow
    finite and, at a reduced tier to N_SM90_BATCHED, held to its plain
    version by flow_checks (as phases 15 (c) and 16 (b) hold them at
    NSTEPS). `held`: phase 16's records, when it ran in this call; its
    uni_tiers_factored at 2048^2 and 4096^2 ran this one's on the same
    inputs (uni_fctx), so its records are taken, not re-run. Returns
    ({name: record}, {name: (path, launches)}, failures)."""
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    B, t = N // FA, 0.5
    tiers = sm90_tiers("uni", B)
    ctx = uni_fctx(torch, N)
    ops, phi, f, dy = (ctx[k] for k in ("ops", "phi", "f", "dy"))
    px, py, calls = uni_operands(torch, ops, phi[None], torch.cat([f, dy])[None], t)
    name = lambda tier, key: f"uni_role{key}{'' if tier == 'f32' else '_' + tier}_b{B}"
    held = {(tier, key): (held or {}).get(name(tier, key)) for tier in tiers for key, *_ in calls}
    if N in N_LARGE and all(held.values()):
        found, bad = {k: dict(d) for k, d in held.items()}, {}
        print(f"phase 17: (a) K5 {N}^2 radix {B} at {', '.join(tiers)}: held to plain by phase 16 "
              f"(a) in this call, its records taken [{card}]")
    else:
        found, bad = uni_tiers_factored(torch, card, ctx, N, tiers, 17,
                                        batched=N <= N_SM90_BATCHED)
    records, launches = {}, {}
    sfx = "" if N == N_MAP else f"_b{B}"
    for tier in tiers:
        form, src = form_source("uni", tier, B)
        tsfx = "" if tier == "f32" else "_" + tier
        for key, role, a, b in calls:
            d = found[tier, key]
            d["same"], d["clean"] = same_bits(
                torch, (1, a.shape[1], 4, N, N),
                lambda o, role=role, a=a, b=b: lfk.uni_velocity_cuda(role, a, b, px, py, o, ops, t,
                                                                     tier))
            print(f"phase 17: K5 {tier:4s} role {key} radix {B:2d} on {form}: same bits in NaN / "
                  f"1e30 / 0 {d['same']}, past the last entry "
                  f"{'untouched' if d['clean'] else 'WRITTEN'}")
            if not (d["same"] and d["clean"]):
                bad[f"K5 {tier} role {key} {N}^2 same bits / nothing past an entry"] = (
                    d["same"], d["clean"])
            d.update(source=src, form=form)
            records[f"uni_role{key}{tsfx}{sfx}"] = d
        # the path: the uni flows at the tier, two launches a stage, at
        # nsteps 1 and NSTEPS
        for nsteps in (1, NSTEPS):
            run = lambda p, plain=False: (
                (lfk.uni_flow_apply_plain if plain else lfk.uni_flow_apply)(
                    f, phi, ops, 0., 1., nsteps, "forward", p),
                (lfk.uni_flow_apply_plain if plain else lfk.uni_flow_apply)(
                    f, phi, ops, 0., 1., nsteps, "adjoint", p),
                *(lfk.uni_flow_bwd_plain if plain else lfk.uni_flow_bwd)(
                    dy, f, phi, ops, 0., 1., nsteps, p)[::-1])
            lfk.reset_launches()
            outs = run(tier)
            torch.cuda.synchronize()
            n = [lfk.LAUNCHES[f"uni_role{r}{tsfx}"] for r in range(4)]
            n_strict = 0 if tier == "f32" else sum(lfk.LAUNCHES[f"uni_role{r}"] for r in range(4))
            finite = all(bool(torch.isfinite(x).all()) for x in outs)
            line, why = flow_checks(
                dict(zip(("L", "L^H", "delta f", "delta phi"),
                         zip(outs, run(tier, plain=True), run("f32")))), tier, nsteps) \
                if N <= N_SM90_BATCHED and tier != "f32" else ("", {})
            path = f"uni flows {N}^2 {tier} (forward, adjoint, backward), nsteps {nsteps}"
            if nsteps == NSTEPS:
                for r in range(4):
                    launches[f"uni_role{r}{tsfx}{sfx}"] = (path, n[r])
            print(f"phase 17: launches in the {path}: K5 roles 0-3 {n} at the tier (two a "
                  "stage)" + ("" if tier == "f32" else f", {n_strict} strict")
                  + f"; the flows finite {finite}" + line)
            if (n != [8 * nsteps, 16 * nsteps, 8 * nsteps, 8 * nsteps] or n_strict or not finite
                    or why):
                bad[f"K5 {tier} {N}^2 path, nsteps {nsteps}"] = (n, n_strict, finite, why)
    del ctx, phi, f, dy, px, py, calls
    torch.cuda.empty_cache()
    return records, launches, bad


def sm90_k4(torch, card, N):
    """Phase 17 (e) at N^2: K4 at every tier on the tile FORMS puts it on
    (csrc/bv_sm90.cu, the cluster tile: one launch a pass, the velocity's
    derivatives in turn inside the launch, u = M^-1 w in the y pass's
    store; or fact_tile), at batch 1 on a backward state of weak-lensing f
    and dy: strict against its plain version (FLOW_TOL, every plane), a
    reduced tier against plain at the tier and the strict kernel
    (high_against; every plane: K1_SM90_TOL, at 'high' HIGH_VS_STRICT, the
    Frobenius ratio under HIGH_SPLIT_RATIO); into buffers of NaN, 1e30 and
    zeros the same bits, nothing written past the last entry; k_f and k_df
    bit for bit K5 role 0's (lf_uni_velocity) on the same state and p(t)
    planes; timed cold beside the parent's (PARENT_MS), with the tier's
    bound; then the path: the backward flow (nsteps NSTEPS) at the tier, the
    launch counters set to 0 just before and read just after: one launch a
    pass (8 nsteps), no strict K4 launch in a reduced tier's flow, delta
    phi and delta f finite and, below N_MAP (at N_MAP phases 5, 9 and 14
    hold the same flows), held to the plain flow by flow_checks (strict:
    FLOW_TOL; at 'bf16' delta phi's max-abs printed, not held: ROADMAP
    Queue 3). Returns ({name: record}, {name: (path, launches)},
    failures)."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import deriv, lenseflow_kernels as lfk
    B, t = N // FA, 0.5
    proj = ct.ProjLambert(N, N, thetapix=THETAPIX_MAP, T=np.float32, device=DEVICE)
    ops = deriv.deriv_ops(proj)
    phi_map, f, dy = weak_lensing_inputs(proj, torch)
    phi = lfk.gradhess(phi_map, ops)
    acc = 1e-3 * torch.as_tensor(np.random.default_rng(SEED + 1).standard_normal(
        (1, lfk.NACC, N, N)).astype(np.float32), device=DEVICE)
    yb = torch.cat([f[None], dy[None], acc], dim=1)
    del acc
    phi1 = phi[None]
    pt = torch.empty((2, 1, N, N), device=DEVICE)
    lfk.p_planes_cuda(t, phi1, pt)
    at = lambda p: (lambda o, y_, ph, pt_: lfk.fvelocity_cuda("backward", y_, o, ph, pt_, ops, 2,
                                                              t, p))
    reps = 10 if N <= 1024 else 5
    records, launches, bad = {}, {}, {}
    sfx = "" if N == N_MAP else f"_b{B}"
    for tier in sm90_tiers("bv", B):
        form, src = form_source("bv", tier, B)
        tsfx = "" if tier == "f32" else "_" + tier
        plain = lambda o, tier=tier: lfk.fvelocity_plain("backward", yb, o, phi1, pt, ops, 2, t,
                                                         tier)
        if tier == "f32":
            o, ref = torch.full_like(yb, float("nan")), torch.empty_like(yb)
            at(tier)(o, yb, phi1, pt)
            plain(ref)
            d = dict(max_abs_err=float((o - ref).abs().max()),
                     rel=max(rel(p, q) for p, q in zip(o[0], ref[0])))
            ok, vs = d["rel"] < FLOW_TOL, f"{d['rel']:.3e} (bound {FLOW_TOL:g})"
            del ref
        else:
            d = high_against(torch, lambda o, p: at(p)(o, yb, phi1, pt), plain, yb.shape, tier)
            ok = (d["rel"] < K1_SM90_TOL[tier] and d["split_ratio"] < HIGH_SPLIT_RATIO
                  and (tier == "bf16" or d["rel_strict"] < HIGH_VS_STRICT))
            vs = (f"{d['rel']:.3e} (bound {K1_SM90_TOL[tier]:g}) vs strict "
                  f"{d['rel_strict']:.3e}, Frobenius ratio {d['split_ratio']:.4f}")
            o = torch.empty_like(yb)
            at(tier)(o, yb, phi1, pt)
        out = torch.empty((1, 2, 4, N, N), device=DEVICE)
        lfk.uni_velocity_cuda(0, yb[:, :2], yb[:, 2:4], pt[0].unsqueeze(1), pt[1].unsqueeze(1),
                              out, ops, t, tier)
        torch.cuda.synchronize()
        k5 = bool(torch.equal(o[:, :2], out[:, :, 0]) and torch.equal(o[:, 2:4], out[:, :, 1]))
        del o, out
        d["same"], d["clean"] = same_bits(torch, yb.shape,
                                          lambda o, tier=tier: at(tier)(o, yb, phi1, pt))
        o = torch.empty_like(yb)
        d.update(nb=1, library_ms=None, source=src, form=form, k5_bits=k5,
                 ms=cold_ms(at(tier), (o, yb, phi1, pt), reps, torch),
                 plain_ms=cuda_ms(lambda: plain(o), 1, torch),
                 **(bound(8 * fact_deriv_flops(N), 25, N, fact_op_floats(N)) if tier == "f32"
                    else bound_high(N, 8, 25, 1, 2, tier)))
        del o
        if not ok:
            bad[f"K4 {tier} {N}^2"] = vs
        if not (d["same"] and d["clean"] and k5):
            bad[f"K4 {tier} {N}^2 same bits / nothing past an entry / K5 role 0's bits"] = (
                d["same"], d["clean"], k5)
        print(f"phase 17: K4 {tier:4s} radix {B:2d} on {form} vs plain {vs}; same bits in NaN / "
              f"1e30 / 0 {d['same']}, past the last entry "
              f"{'untouched' if d['clean'] else 'WRITTEN'}; k_f, k_df bit for bit K5 role 0's "
              f"{k5}  {d['ms']:.4f} ms cold (parent "
              f"{PARENT_MS.get(('bv', tier, N), 'not recorded')}), plain {d['plain_ms']:.4f}, "
              f"bound {d['bound_ms']:.4f} ms ({d['bound_by']}, "
              f"{100 * d['bound_ms'] / d['ms']:.1f} %) [{N}^2; {card}]")
        name = f"bv_velocity{tsfx}{sfx}"
        records[name] = d
        # the path: the backward flow at the tier, one launch a pass
        run = lambda fn: fn(dy, f, phi, ops, 0., 1., NSTEPS, tier)
        lfk.reset_launches()
        outs = run(lfk.flow_bwd)
        torch.cuda.synchronize()
        n, n_strict = (lfk.LAUNCHES[f"bv_velocity{x}"] for x in (tsfx, ""))
        n_strict = 0 if tier == "f32" else n_strict
        finite = all(bool(torch.isfinite(x).all()) for x in outs)
        path = f"flow_bwd {N}^2 {tier}, nsteps {NSTEPS}"
        launches[name] = (path, n)
        line, why = "", {}
        if N < N_MAP:   # at N_MAP phases 5, 9 and 14 hold these flows to plain
            ref = run(lfk.flow_bwd_plain)
            if tier == "f32":
                e = max(rel(a, b) for x, y in zip(outs, ref)
                        for a, b in zip(x.reshape(-1, N, N), y.reshape(-1, N, N)))
                line = f"; delta phi, delta f vs plain {e:.3e} (bound {FLOW_TOL:g})"
                why = {} if e < FLOW_TOL else {"flow": e}
            else:
                strict = lfk.flow_bwd(dy, f, phi, ops, 0., 1., NSTEPS, "f32")
                line, why = flow_checks(dict(zip(("delta phi", "delta f"), zip(outs, ref, strict))),
                                        tier, NSTEPS,
                                        {"delta phi": DPHI_BF16_TOL} if tier == "bf16" else None)
            del ref
        print(f"phase 17: launches in {path}: K4 {n} at the tier (a launch a pass)"
              + ("" if tier == "f32" else f", {n_strict} strict")
              + f"; the flow finite {finite}" + line)
        if n != 8 * NSTEPS or n_strict or not finite or why:
            bad[f"K4 {tier} {N}^2 path"] = (n, n_strict, finite, why)
        del outs
    del yb, phi, phi1, pt, f, dy, phi_map
    proj._tensors.clear()
    torch.cuda.empty_cache()
    return records, launches, bad


def sm90_k2(torch, card):
    """Phase 17 (b): K2's 'bf16' derivative on the masked IP slice's I, Q, U
    planes (d_x f, d_y d, d_x f + d_y d + f) and at 200^2, 160 x 200 and
    600^2 (random planes), each within BF16_DENSE_TOL of plain 'bf16' on
    every plane, the same bits twice (into NaN and into zeros), nothing
    written past the last plane; d_x timed cold, on the slice beside the
    library call; then the path: the slice's backward flow at 'bf16'
    (nsteps 7), whose hoisted delta phi runs K2's derivative three times,
    the launch counters set to 0 just before and read just after. Returns
    (record, launches, failures)."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import deriv, lenseflow_kernels as lfk
    sim = ct.load_sim(**WF_SIM, device=DEVICE)
    mats = deriv.deriv_mats(sim["phi"].proj)
    f = sim["f"].to(ct.IQU_MAP).arr.contiguous()
    d = sim["ds"].d.to(ct.IQU_MAP).arr.contiguous()
    phi = lfk.gradhess(sim["phi"].to(ct.MAP).arr.contiguous(), mats, "f32")
    rng = np.random.default_rng(SEED + 17)
    cases = [("IP slice", mats, (f, None, None)), ("IP slice", mats, (None, d, None)),
             ("IP slice", mats, (f, d, f))]
    for Ny, Nx in EDGE_SHAPES:
        em = deriv.deriv_mats(ct.ProjLambert(Ny, Nx, thetapix=3, T=np.float32, device=DEVICE))
        x, y, z = (torch.as_tensor(rng.standard_normal((2, Ny, Nx)).astype(np.float32),
                                   device=DEVICE) for _ in range(3))
        cases += [(f"{Ny}x{Nx}", em, (x, None, None)), (f"{Ny}x{Nx}", em, (x, y, z))]
    found, bad, rec = {}, {}, None
    for where, m, args in cases:
        like = next(t for t in args if t is not None)
        n = like.shape[0]
        ref = torch.empty_like(like)
        lfk.deriv_plain(*args, ref, m, "bf16")
        outs = []
        for fill in (float("nan"), 0.0):
            buf = torch.full((n + 1,) + tuple(like.shape[1:]), fill, device=DEVICE)
            lfk.deriv_cuda(*args, buf[:n], m, "bf16")
            clean = bool((torch.isnan(buf[n]) if fill != fill else buf[n] == 0).all())
            outs.append((buf[:n], clean))
        key = f"{where} {'x' if args[1] is None else 'y' if args[0] is None else 'xyc'}"
        e = max(rel(p, q) for p, q in zip(outs[0][0], ref))
        dd = found[key] = dict(rel=e, max_abs_err=float((outs[0][0] - ref).abs().max()),
                               same=bool(torch.equal(outs[0][0], outs[1][0])),
                               clean=outs[0][1] and outs[1][1])
        if args[1] is None:   # d_x: timed cold
            o = torch.empty_like(like)
            dd["ms"] = cold_ms(lambda o_, x_: lfk.deriv_cuda(x_, None, None, o_, m, "bf16"),
                               (o, args[0]), 20, torch)
            x = args[0]
            if where == "IP slice" or x.shape[-1] == x.shape[-2]:
                # the library call and the bound beside it on square planes:
                # the slice (the record) and 600^2
                n_ = x.shape[-1]
                dd["plain_ms"] = cuda_ms(lambda: lfk.deriv_plain(x, None, None, o, m, "bf16"), 5,
                                         torch)
                dd["library_ms"], dd["library_call"] = library_bf16_ms(x.reshape(-1, n_), m[0],
                                                                       torch)
                dd.update(bound_dense_high(n_, x.shape[0], 2 * x.shape[0] + 0.5, tier="bf16"))
            if where == "IP slice":
                rec = dd
        if not (e < BF16_DENSE_TOL and dd["same"] and dd["clean"]):
            bad[key] = (e, dd["same"], dd["clean"])
        print(f"phase 17: K2 'bf16' deriv {key:16s} vs plain 'bf16' {e:.3e} (bound "
              f"{BF16_DENSE_TOL:g}, each plane); the same bits twice {dd['same']}, past the last "
              f"plane {'untouched' if dd['clean'] else 'WRITTEN'}"
              + (f"; {dd['ms']:.4f} ms cold" if "ms" in dd else "")
              + (f", plain {dd['plain_ms']:.4f} ms, library {dd['library_ms']:.4f} ms "
                 f"({dd['library_call']}), bound {dd['bound_ms']:.4f} ms ({dd['bound_by']}, "
                 f"{100 * dd['bound_ms'] / dd['ms']:.1f} %)" if "library_ms" in dd else "")
              + f" [{card}]")
    lfk.reset_launches()
    dphi, _ = lfk.flow_bwd(d, f, phi, mats, 0., 1., NSTEPS, "bf16")
    torch.cuda.synchronize()
    launches = dict(lfk.LAUNCHES)
    print(f"phase 17: launches in the masked IP slice's backward flow at 'bf16' (nsteps "
          f"{NSTEPS}): K2 deriv {launches['deriv_bf16']}, whole flow "
          f"{launches['flow_backward_bf16']}; delta phi finite {bool(torch.isfinite(dphi).all())}")
    if (launches["deriv_bf16"] != 3 or launches["flow_backward_bf16"] != 1
            or not torch.isfinite(dphi).all()):
        bad["path"] = (launches["deriv_bf16"], launches["flow_backward_bf16"],
                       bool(torch.isfinite(dphi).all()))
    return rec, launches, bad


def phase_sm90(torch, card, uni_large=None):
    """Phase 17: K1 at 'high' and 'bf16' on the cluster tile at every built
    radix, K3, K5 and strict K1 on the tile FORMS puts them on at every
    tier and radix (strict only where that is the cluster tile), K4 on it
    at every tier, and K2's redesigned 'bf16' derivative (see the module
    docstring). uni_large: phase 16's kernel records, when it ran in this
    call (sm90_k5). Returns (kernel records {name: record}, launches
    {name: (path, count)})."""
    from cmblensing_tpu_torch.ops import _build, lenseflow_kernels as lfk
    t_start = time.perf_counter()
    lib = _build.load()
    for kernel, fn, key in (("K1", lib.lf_fderiv_sm90_clusters, "fderiv"),
                            ("K3", lib.lf_fa_sm90_clusters, "fa"),
                            ("K4", lib.lf_bv_sm90_clusters, "bv"),
                            ("K5", lib.lf_uni_sm90_clusters, "uni")):
        # '-' where FORMS runs fact_tile: no cluster form is built there
        fits = {p: [fn(i, B) if lfk.FORMS[key, p, B] == "cluster" else "-"
                    for B in (4, 8, 16, 32)] for i, p in enumerate(lfk.PRECISIONS)}
        print(f"phase 17: {kernel} clusters that fit on the card at once "
              "(cudaOccupancyMaxActiveClusters; radix 4, 8, 16, 32): " + "; ".join(
                  f"{p!r} {n}" for p, n in fits.items() if set(n) != {"-"}) + f" [{card}]")
        if any(isinstance(c, int) and c < 1 for n in fits.values() for c in n):
            raise AssertionError(f"phase 17: a {kernel} cluster does not fit: {fits}")
    records, launches, bad = {}, {}, {}
    for N in N_SM90:
        found, paths, why = sm90_k1(torch, card, N)
        bad.update(why)
        for tier, d in found.items():   # the earlier phases' names: fderiv_high at 1024^2
            tsfx = "" if tier == "f32" else "_" + tier
            name = "fderiv" + tsfx + ("" if N == N_MAP else f"_b{N // FA}")
            records[name] = d
            launches[name] = (f"flow_bwd {N}^2 {tier}, nsteps 1", paths[tier]["fderiv" + tsfx])
        k5 = lambda torch, card, N: sm90_k5(torch, card, N, uni_large)
        for check in (sm90_k3, k5, sm90_k4):
            found, paths, why = check(torch, card, N)
            bad.update(why)
            records.update(found)
            launches.update(paths)
    rec, paths, why = sm90_k2(torch, card)
    bad.update(why)
    records["deriv_bf16"] = rec
    launches["deriv_bf16"] = (f"flow_bwd masked 256^2 IP bf16, nsteps {NSTEPS}",
                                   paths["deriv_bf16"])
    if bad:
        raise AssertionError(f"phase 17: the redesigned kernels fail their checks: {bad}")
    print(f"phase 17: wall time {time.perf_counter() - t_start:.1f} s [{card}]")
    return records, launches


def flow_bound(kind, tier, ncomp, nb, Ny, Nx, nsteps=NSTEPS):
    """bound_ms and bound_by of nb whole dense flows of `kind` at `tier`:
    4 nsteps stages, each ncomp (forward, adjoint) or 2 ncomp (backward)
    derivatives along x (2 Ny Nx Nx operations) and as many along y (2 Ny
    Ny Nx), on the FP32 units (strict), or three ('high') or one ('bf16')
    bf16 products on the tensor cores plus the operand's split or rounding
    (three or one FP32 operations a value); bytes: the state in and out
    and phi's five planes per entry, and the two circulants (FP32; 'high'
    their bf16 head and residual, 'bf16' the head) once."""
    nx = (2 if kind == "backward" else 1) * ncomp * 4 * nsteps * nb
    ops = nx * 2 * Ny * Nx * (Nx + Ny)
    if tier == "f32":
        t_op = ops / FP32_PEAK
    else:
        passes = 3 if tier == "high" else 1
        t_op = passes * ops / BF16_PEAK + passes * 2 * nx * Ny * Nx / FP32_PEAK
    nstate = 2 * ncomp + 5 if kind == "backward" else ncomp
    circ = (Nx * Nx + Ny * Ny) * (2 if tier == "bf16" else 4)
    t_mem = (4 * nb * (2 * nstate + 5) * Ny * Nx + circ) / HBM_RATE
    return dict(bound_ms=1e3 * max(t_op, t_mem), bound_by="operations" if t_op >= t_mem else "bytes")


def flow_inputs(torch, case):
    """(mats, phi planes, f, dy) of a FLOW_CASES case: phi drawn from the
    fiducial Cphi, f (pol P) from Cf and a white cotangent dy, with numpy
    from SEED, as weak_lensing_inputs draws them (the lensing realistically
    weak; white fields under strong one-mode lensing make 7 coarse steps
    drift, whatever the kernel); the IP slice's third component a rolled
    copy of the first."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import deriv, lenseflow_kernels as lfk
    Ny, Nx, ncomp = FLOW_CASES[case]
    proj = ct.ProjLambert(Ny, Nx, thetapix=3, T=np.float32, device=DEVICE)
    mats = deriv.deriv_mats(proj)
    rng = np.random.default_rng(SEED)
    Cl = ct.camb()
    white = lambda c: ct.Field(torch.as_tensor(rng.standard_normal((c, Ny, Nx)).astype(np.float32),
                                               device=DEVICE),
                               ct.Basis("I" if c == 1 else "QU", "map"), proj)
    Cphi = ct.Cl_to_Cov("I", proj, Cl["total"]["pp"])
    Cf = ct.Cl_to_Cov("P", proj, Cl["unlensed_scalar"]["EE"], Cl["unlensed_scalar"]["BB"])
    phi_map = (Cphi.sqrt() @ white(1)).to(ct.MAP).arr.contiguous()
    f = (Cf.sqrt() @ white(2)).to(ct.QU_MAP).arr
    dy = white(2).arr
    if ncomp == 3:
        f, dy = (torch.cat([x, torch.roll(x[:1], 17, dims=-1)]) for x in (f, dy))
    return mats, lfk.gradhess(phi_map, mats), f.contiguous(), dy.contiguous()


def flow_state(torch, kind, f, dy):
    """The state a dense flow of `kind` starts from, and its (t0, t1): f
    from 0 to 1 (forward) or 1 to 0 (adjoint, as L^H); the backward
    kind's (f, dy, zero accumulators) from 1 to 0, as _flow_bwd starts it."""
    if kind != "backward":
        return f.contiguous(), ((0., 1.) if kind == "forward" else (1., 0.))
    acc = torch.zeros(f.shape[:-3] + (5,) + f.shape[-2:], device=f.device)
    return torch.cat([f, dy, acc], dim=-3).contiguous(), (1., 0.)


def flow_case(torch, kind, tier, mats, phi, f, dy, timed):
    """One dense flow through the flow kernel against its plain version and,
    at a reduced tier, the strict kernel flow, every state plane on its own;
    the same bits twice; its launches; timed warm, cold and plain."""
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    y, (t0, t1) = flow_state(torch, kind, f, dy)
    ncomp = f.shape[-3]
    sched = lfk.flow_schedule(NSTEPS, t0, t1)

    def kernel(p, y_=y, ph=phi):
        o = y_.clone()
        lfk.flow_cuda(kind, o, ph, mats, ncomp, sched, p)
        return o

    def plain():
        o = y.clone()
        lfk.flow_plain(kind, o, phi, mats, ncomp, sched, tier)
        return o

    lfk.reset_launches()
    out = kernel(tier)
    torch.cuda.synchronize()
    launches = {k: v for k, v in lfk.LAUNCHES.items() if v}
    ref = plain()
    planes = lambda x: x.reshape(-1, *x.shape[-2:])
    d = dict(max_abs_err=float((out - ref).abs().max()),
             rel=max(rel(a, b) for a, b in zip(planes(out), planes(ref))),
             same=bool(torch.equal(out, kernel(tier))), launches=launches,
             library_ms=None, **flow_bound(kind, tier, ncomp, 1, *f.shape[-2:]))
    if tier != "f32":
        strict = kernel("f32")
        d.update(rel_strict=max(rel(a, b) for a, b in zip(planes(out), planes(strict))),
                 **split_ratio(out, ref, strict))
    if timed:
        # repeated flows in place on the inputs (or their copies)
        launch = lfk.flow_launcher(kind, y.clone(), phi, mats, ncomp, sched, tier)
        flow = lambda y_, ph: lfk.flow_cuda(kind, y_, ph, mats, ncomp, sched, tier)
        d.update(ms=kernel_ms(launch, 10, torch), cold_ms=cold_ms(flow, (y.clone(), phi), 10, torch),
                 plain_ms=cuda_ms(plain, 1, torch))
    return d


def flow_batch(torch, kind, tier, mats, phi, f, dy, nb, timed):
    """nb entries (phi scaled, the state rolled) in one launch: bit for bit
    the nb single flows (where not timed), its launches; timed warm and
    cold (where timed)."""
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    phis = torch.stack([(0.5 + i / nb) * phi for i in range(nb)])
    ys = torch.stack([torch.roll(flow_state(torch, kind, f, dy)[0], 7 * i, dims=-1)
                      for i in range(nb)])
    t0, t1 = flow_state(torch, kind, f, dy)[1]
    ncomp = f.shape[-3]
    sched = lfk.flow_schedule(NSTEPS, t0, t1)

    def run(y_, ph):
        o = y_.clone()
        lfk.flow_cuda(kind, o, ph, mats, ncomp, sched, tier)
        return o

    lfk.reset_launches()
    out = run(ys, phis)
    torch.cuda.synchronize()
    d = dict(nb=nb, launches={k: v for k, v in lfk.LAUNCHES.items() if v},
             **{k: v for k, v in flow_bound(kind, tier, ncomp, nb, *f.shape[-2:]).items()})
    if timed:
        launch = lfk.flow_launcher(kind, ys.clone(), phis, mats, ncomp, sched, tier)
        flow = lambda y_, ph: lfk.flow_cuda(kind, y_, ph, mats, ncomp, sched, tier)
        d.update(ms=kernel_ms(launch, 5, torch), cold_ms=cold_ms(flow, (ys.clone(), phis), 5, torch))
    else:
        d["same_as_singles"] = all(bool(torch.equal(out[i], run(ys[i], phis[i])))
                                   for i in range(nb))
    return d


def phase_whole_flow(torch, card):
    """Phase 18: K2's whole-flow kernel (see FLOW_CASES above). Returns
    ({(case, tier, kind): record}, {(tier, kind): batch-NTRIAL record})."""
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    t_start = time.perf_counter()
    found, batched, bad = {}, {}, {}
    for case in FLOW_CASES:
        mats, phi, f, dy = flow_inputs(torch, case)
        Ny, Nx, ncomp = FLOW_CASES[case]
        for tier in lfk.PRECISIONS:
            sfx = "" if tier == "f32" else "_" + tier
            for kind in ("forward", "adjoint", "backward"):
                d = found[case, tier, kind] = flow_case(torch, kind, tier, mats, phi, f, dy,
                                                        case in FLOW_TIMED)
                tol = FLOW_TIER_TOL[tier]
                ok = (d["rel"] < tol and d["same"] and d["launches"] == {f"flow_{kind}{sfx}": 1}
                      and (tier == "f32" or d["split_ratio"] < FLOW_SPLIT_RATIO))
                line = (f"phase 18: flow {kind:8s} {tier:4s} {case:7s} ({ncomp} x {Ny}x{Nx}) vs "
                        f"plain {d['rel']:.3e} (bound {tol:g}, each plane)")
                if tier != "f32":
                    line += (f", vs strict {d['rel_strict']:.3e}, Frobenius ratio "
                             f"{d['split_ratio']:.4f} (bound {FLOW_SPLIT_RATIO:g})")
                line += (f"; twice {'the same bits' if d['same'] else 'DIFFERENT'}; launches "
                         f"{d['launches']}")
                if "ms" in d:
                    line += (f"; {d['ms']:.4f} ms warm, {d['cold_ms']:.4f} ms cold, plain "
                             f"{d['plain_ms']:.3f} ms, bound {d['bound_ms']:.4f} ms "
                             f"({d['bound_by']}, {100 * d['bound_ms'] / d['cold_ms']:.1f} % cold)")
                print(line + f" [{card}]", flush=True)
                if not ok:
                    bad[case, tier, kind] = (d["rel"], d["same"], d["launches"],
                                             d.get("split_ratio"))
                if case == "256P":
                    for nb in (FLOW_BATCH, NTRIAL):
                        b = flow_batch(torch, kind, tier, mats, phi, f, dy, nb, nb == NTRIAL)
                        one = b["launches"] == {f"flow_{kind}{sfx}": 1}
                        if nb == NTRIAL:
                            batched[tier, kind] = b
                            msg = (f"{b['ms']:.4f} ms warm, {b['cold_ms']:.4f} ms cold, bound "
                                   f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
                        else:
                            msg = ("bit for bit the single flows" if b["same_as_singles"]
                                   else "NOT the single flows' bits")
                        print(f"phase 18: flow {kind:8s} {tier:4s} 256P batch {nb:2d} in one "
                              f"launch: launches {b['launches']}; {msg} [{card}]", flush=True)
                        if not one or not b.get("same_as_singles", True):
                            bad[case, tier, kind, nb] = b["launches"]
        del mats, phi, f, dy
        torch.cuda.empty_cache()
    blocks = {kind: lfk.flow_blocks(kind, "f32", 1, 2, N, N) for kind in ("forward", "backward")}
    print(f"phase 18: blocks a launch at 256^2 P: {blocks} (the card's SMs x the blocks an SM "
          f"holds, at most the items of a stage); wall time {time.perf_counter() - t_start:.1f} s")
    if bad:
        raise AssertionError(f"the whole-flow kernel disagrees: {bad}")
    return found, batched



def sample_run(torch, ds, nsims, passes, seed, backend="kernel", symp=SAMPLE_SYMP,
               nburnin=SAMPLE_NBURNIN):
    import cmblensing_tpu_torch as ct
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    with ct.lenseflow_backend_ctx(backend):
        return ct.sample_joint(ds, passes, nchains=nsims, generator=g, symp_kwargs=symp,
                               nburnin_always_accept=nburnin, conjgrad_kwargs=SAMPLE_CG)


def gibbs_vs_plain(torch, card, ds):
    """Phase 19 (c): one Gibbs pass of the dataset ds (its first 2 sims) at
    N = 3 on "kernel" against "plain" from one generator seed: a chain's
    first pass, always accepted, so that phi carries each backend's HMC
    trajectory, and the accept each backend's dH gives (log u < dH)
    compared."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.inference import sampling as ts
    ds = ds.replace(d=ct.Field(ds.d.arr[:2], ds.d.basis, ds.d.proj))
    draw, runs = ts._uniform, {}
    try:
        for backend in ("kernel", "plain"):
            us = []
            ts._uniform = lambda g, shape: us.append(draw(g, shape)) or us[-1]
            t0 = time.perf_counter()
            res = sample_run(torch, ds, 2, 1, 5, backend, [dict(N=3, eps=0.003)], 1)
            torch.cuda.synchronize()
            runs[backend] = (res[0][0], us, time.perf_counter() - t0)
    finally:
        ts._uniform = draw
    (k, uk, tk), (p, up, tp_) = runs["kernel"], runs["plain"]
    errs = {name: rel(k[name].to(k[name].basis.with_space("map")).arr,
                      p[name].to(k[name].basis.with_space("map")).arr) for name in ("f", "phi")}
    errs["logpdf"] = rel(k["logpdf"], p["logpdf"])
    dh = float((k["dH"] - p["dH"]).abs().max())
    logu = torch.log(uk[0]).cpu()
    clear = (logu - k["dH"]).abs() > GIBBS_DH_ATOL
    same_accept = bool(torch.equal((logu < k["dH"])[clear], (logu < p["dH"])[clear]))
    print(f"phase 19: (c) a Gibbs pass {N_SAMPLE}^2 P x 2 sims, N = 3, kernel vs plain: "
          + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
          + f" (bound {GIBBS_PLAIN_TOL:g}); dH {k['dH'].tolist()} vs {p['dH'].tolist()} "
          f"(bound {GIBBS_DH_ATOL:g}); log u {logu.tolist()}: accept {(logu < k['dH']).tolist()} "
          f"vs {(logu < p['dH']).tolist()}; kernel {tk:.2f} s, plain {tp_:.2f} s [{card}]")
    if not (all(torch.equal(a, b) for a, b in zip(uk, up)) and max(errs.values()) < GIBBS_PLAIN_TOL
            and dh < GIBBS_DH_ATOL and same_accept and torch.isfinite(k["logpdf"]).all()):
        raise AssertionError(f"phase 19: the Gibbs pass on kernel disagrees with plain: {errs}, "
                             f"dH {dh}, same accept {same_accept}")


def sample_kernels(torch, card, state):
    """Phase 19 (b): the kernels at the shapes the sampler's path gives
    them, on its state after the timed passes (32 sims): phi's planes (K1)
    against their plain version (HESS_TOL_1024, the bound at thetapix 2),
    and the forward (L, L^-1), adjoint and backward flows of f (32 x 2
    planes; K3, K4, rk4, p, and K1 after the backward loop) against the
    plain leaves, every plane within FLOW_TOL; nsteps 1, whose stages take
    a whole flow's shapes. Returns {what: error}."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import deriv, lenseflow_kernels as lfk
    dev = lambda f: f.to(f.basis.with_space("map")).arr.to(DEVICE).contiguous()
    phi, f, dy = dev(state["phi"]), dev(state["f"]), dev(state["f_mix"])
    N = phi.shape[-1]
    ops = deriv.deriv_ops(ct.ProjLambert(N, N, thetapix=THETAPIX_MAP, T=np.float32, device=DEVICE))
    planes = lfk.gradhess(phi, ops)
    each = lambda a, b: max(rel(x, y) for x, y in zip(a.reshape(-1, N, N), b.reshape(-1, N, N)))
    errs = {"planes": rel(planes, lfk.gradhess_plain(phi, ops))}
    for name, (t0, t1, kind) in (("L", (0., 1., "forward")), ("L^-1", (1., 0., "forward")),
                                 ("L^H", (1., 0., "adjoint"))):
        run = lambda fn: fn(f, planes, ops, t0, t1, 1, kind)
        errs[name] = each(run(lfk.flow_apply), run(lfk.flow_apply_plain))
    k, p = (fn(dy, f, planes, ops, 0., 1., 1) for fn in (lfk.flow_bwd, lfk.flow_bwd_plain))
    errs["backward dphi"], errs["backward df0"] = each(k[0], p[0]), each(k[1], p[1])
    print(f"phase 19: (b) the kernels at {phi.shape[0]} sims x {N}^2 P vs plain: "
          + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
          + f" (bounds {HESS_TOL_1024:g} planes, {FLOW_TOL:g} flows, each plane) [{card}]")
    return {n: e for n, e in errs.items()
            if not e < (HESS_TOL_1024 if n == "planes" else FLOW_TOL)}


def phase_sample(torch, card):
    """Phase 19: (a) BASELINE.json configs[3] at full size: load_sim 512^2 P
    with Nbatch=32, one warm-up sample_joint pass and SAMPLE_PASSES timed at
    scripts/sample_512_batched.py's settings (s/pass, its split by pass,
    accept, dH, every logpdf finite, peak memory, launches a pass; each of
    SAMPLE_KERNELS launched); (b) sample_kernels on its last state; (c)
    gibbs_vs_plain on its first 2 sims (the data of load_sim(Nbatch=2): one
    simulation repeated). Returns (launches of the timed run, timings)."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    from cmblensing_tpu_torch.utils import timing
    t_start = time.perf_counter()
    sim = ct.load_sim(thetapix=THETAPIX_MAP, Nside=N_SAMPLE, pol="P", T=np.float32,
                      Nbatch=SAMPLE_SIMS, seed=SEED, device=DEVICE)
    ds = sim["ds"]
    if ds.d.batch_shape != (SAMPLE_SIMS,):
        raise AssertionError(f"load_sim(Nbatch={SAMPLE_SIMS}) gave d of batch {ds.d.batch_shape}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sample_run(torch, ds, SAMPLE_SIMS, 1, 1)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    timing.reset_timers()
    torch.cuda.reset_peak_memory_stats()
    lfk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sample_run(torch, ds, SAMPLE_SIMS, SAMPLE_PASSES, 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(lfk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    chain = res[0]
    lps = torch.stack([e["logpdf"] for e in chain])
    acc = torch.stack([e["accept"] for e in chain]).float()
    dH = torch.stack([e["dH"] for e in chain])
    s_pass = wall / SAMPLE_PASSES
    print(f"phase 19: (a) sample_joint {N_SAMPLE}^2 P x {SAMPLE_SIMS} sims (N 25, eps 0.003, CG 25 "
          f"fixed): warm-up pass {warm:.2f} s; {SAMPLE_PASSES} passes {wall:.2f} s = "
          f"{s_pass:.3f} s/pass; peak memory {peak:.2f} GiB; accept {acc.mean().item():.3f} "
          f"(steps <= {SAMPLE_NBURNIN} always accepted); dH mean per pass "
          f"{dH.mean(dim=1).tolist()}, range [{dH.min().item():.3f}, {dH.max().item():.3f}]; "
          f"logpdf mean per pass {lps.mean(dim=1).tolist()} [{card}]")
    for line in timing.timer_report().splitlines():
        print(f"phase 19: (a) split {line}")
    per_pass = {k: v / SAMPLE_PASSES for k, v in launches.items() if v}
    print(f"phase 19: (a) launches a pass {per_pass}")
    if not (bool(torch.isfinite(lps).all()) and lps.shape == (SAMPLE_PASSES, SAMPLE_SIMS)
            and chain[-1]["phi"].batch_shape == (SAMPLE_SIMS,)):
        raise AssertionError(f"phase 19: sample_joint gave logpdfs {lps.tolist()}")
    never = {k: launches[k] for k in SAMPLE_KERNELS if launches[k] <= 0}
    if never:
        raise AssertionError(f"phase 19: a kernel of the sampler's path never launched: {never}")
    bad = sample_kernels(torch, card, chain[-1])
    if bad:
        raise AssertionError(f"phase 19: the kernels at the sampler's shapes disagree: {bad}")
    del sim, res, chain
    torch.cuda.empty_cache()
    gibbs_vs_plain(torch, card, ds)
    del ds
    torch.cuda.empty_cache()
    print(f"phase 19: wall time {time.perf_counter() - t_start:.1f} s [{card}]")
    return launches, {"sample_joint_512x32_s_per_pass": s_pass,
                      "sample_joint_512x32_peak_GiB": peak,
                      "sample_joint_512x32_launches_per_pass": per_pass}


def muse_dataset(torch, N=N_MUSE, nbins=MUSE_BINS):
    """Phase 20's MUSE configuration (scripts/torch_muse_256.py's
    muse_dataset): (ds with the banded Cphi and the data at MUSE_TRUTH in
    the QU map basis, the load_sim dict, the data's phi)."""
    import cmblensing_tpu_torch as ct
    sim = ct.load_sim(thetapix=3, Nside=N, pol="P", T=np.float32, seed=SEED, device=DEVICE)
    ds, proj = sim["ds"], sim["proj"]
    lm = np.asarray(proj.lmag).ravel()
    lm = lm[lm > 0]
    edges = np.concatenate([[0.0], np.percentile(lm, np.linspace(0, 100, nbins + 1)[1:-1]), [1e9]])
    ds = ds.replace(Cphi=ct.Cl_to_Cov("I", proj, (ct.camb()["total"]["pp"], edges, "Aphi_b")))
    g = torch.Generator(device=DEVICE)
    g.manual_seed(7)
    with torch.no_grad():
        s = ds.simulate(g, theta=dict(Aphi_b=MUSE_TRUTH))
    return ds.replace(d=s["d"].to(ct.QU_MAP)), sim, s["phi"]


def corr(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def ensemble_muse(torch, card, ds):
    """Phase 20 (a): one MUSE run; returns (its result, launches, numbers)."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    from cmblensing_tpu_torch.utils import timing
    g = torch.Generator(device=DEVICE)
    g.manual_seed(3)
    timing.reset_timers()
    lfk.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ct.muse(ds, dict(Aphi_b=np.ones(MUSE_BINS)), nsims=MUSE_SIMS, nsteps=MUSE_STEPS,
                  generator=g, MAP_kwargs=MUSE_MAP)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in lfk.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    A = np.asarray(res["theta"]["Aphi_b"])
    H, Sigma = np.asarray(res["H"]), np.asarray(res["Sigma"])
    sig = np.sqrt(np.abs(np.diag(Sigma)))
    pulls = (A - MUSE_TRUTH) / sig
    finite = all(np.isfinite(h["s_data"]).all() and np.isfinite(h["sbar"]).all()
                 for h in res["history"]) and np.isfinite(H).all() and np.isfinite(Sigma).all()
    chi2 = float((A - MUSE_TRUTH) @ np.linalg.solve(Sigma, A - MUSE_TRUTH)) if finite else np.nan
    evals = np.linalg.eigvalsh(0.5 * (Sigma + Sigma.T)) if finite else np.full(MUSE_BINS, np.nan)
    print(f"phase 20: (a) MUSE {N_MUSE}^2 P, {MUSE_BINS} bins, {MUSE_SIMS} sims, {MUSE_STEPS} "
          f"steps (MAP 5 steps, CG 20 fixed, \"auto\", final H): {wall:.3f} s/run; peak memory "
          f"{peak:.2f} GiB [{card}]")
    for i, lab in enumerate(res["labels"]):
        print(f"phase 20: (a)   {lab}: {A[i]:.4f} +/- {sig[i]:.4f} (truth {MUSE_TRUTH[i]:.3f}, "
              f"pull {pulls[i]:+.3f} sigma)")
    print(f"phase 20: (a) joint chi2 {chi2:.3f} / {MUSE_BINS} dof; H cond "
          f"{np.linalg.cond(H) if finite else np.nan:.3e}; "
          f"Sigma eigenvalues {evals.tolist()}")
    for line in timing.timer_report().splitlines():
        print(f"phase 20: (a) split {line}")
    print(f"phase 20: (a) launches a run {launches}")
    for h in res["history"]:
        print(f"phase 20: (a) step {h['step']}: theta {np.asarray(h['theta']['Aphi_b']).tolist()}, "
              f"s_data {np.asarray(h['s_data']).tolist()}, sbar {np.asarray(h['sbar']).tolist()}")
    print(f"phase 20: (a) H {H.tolist()}; J {np.asarray(res['J']).tolist()}")
    bad = {}
    if not finite:
        bad["finite"] = False
    if not (finite and np.linalg.matrix_rank(H) == MUSE_BINS and np.isfinite(np.linalg.cond(H))):
        bad["H invertible"] = np.linalg.cond(H)
    if not (evals > 0).all():
        bad["Sigma positive definite"] = evals.tolist()
    if not (np.abs(pulls) < MUSE_PULL_MAX).all():
        bad["pulls"] = pulls.tolist()
    return res, launches, bad, dict(s_run=wall, peak_GiB=peak, pulls=pulls.tolist(), chi2=chi2,
                                    theta=A.tolist(), sigma=sig.tolist())


def ensemble_qe(torch, card, ds, theta, phi_data):
    """Phase 20 (b): the data and MUSE_SIMS sims at theta (drawn as muse
    draws an ensemble) in one batched EB quadratic estimate, A_L once; each
    entry its unbatched estimate; corr with each entry's phi. Returns (the
    sims, errors, ms)."""
    import cmblensing_tpu_torch as ct
    g = torch.Generator(device=DEVICE)
    g.manual_seed(13)
    with torch.no_grad():
        sims = ds.simulate(g, theta=theta, batch_shape=(MUSE_SIMS,))
    d = ds.d
    batch = ct.Field(torch.cat([d.arr[None], sims["d"].to(d.basis).arr]), d.basis, d.proj)
    dsb = ds.replace(d=batch)
    ct.quadratic_estimate(dsb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qe = ct.quadratic_estimate(dsb)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    errs = [rel(qe["phiqe"].arr[i], ct.quadratic_estimate(ds.replace(d=ct.batch_index(batch, i)))[
        "phiqe"].arr) for i in range(MUSE_SIMS + 1)]
    phis = torch.cat([phi_data.to(ct.MAP).arr[None], sims["phi"].to(ct.MAP).arr])
    q = qe["phiqe"].to(ct.MAP).arr
    corrs = [corr(q[i], phis[i]) for i in range(MUSE_SIMS + 1)]
    print(f"phase 20: (b) batched EB quadratic estimate of the data + {MUSE_SIMS} sims at the last "
          f"theta ({MUSE_SIMS + 1} x {N_MUSE}^2 P): {ms:.3f} ms; each entry vs its unbatched "
          f"estimate {max(errs):.3e} (bound {QE_ENTRY_TOL:g}); corr(phi_QE, phi_true) data "
          f"{corrs[0]:.4f}, sims {[round(c, 4) for c in corrs[1:]]} [{card}]")
    bad = {} if max(errs) < QE_ENTRY_TOL and np.isfinite(corrs).all() else {"qe": max(errs)}
    return sims, bad, ms


def ensemble_marg(torch, card):
    """Phase 20 (c): MAP_marg at 256^2 P as scripts/map_marg_256.py runs it;
    returns (launches, bad, s/step)."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    from cmblensing_tpu_torch.utils import timing
    sim = ct.load_sim(thetapix=3, Nside=N_MUSE, pol="P", T=np.float32, seed=SEED, device=DEVICE)
    ds = sim["ds"].replace(d=sim["ds"].d.to(sim["ds"].d.basis.with_space("map")))
    g = torch.Generator(device=DEVICE)
    g.manual_seed(1)
    timing.reset_timers()
    lfk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    phi, hist = ct.MAP_marg(ds, generator=g, nsteps=MARG_STEPS, Nsims=MARG_SIMS,
                            nsteps_with_meanfield_update=MARG_MF_STEPS, conjgrad_kwargs=MARG_CG,
                            alpha=MARG_ALPHA)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in lfk.LAUNCHES.items() if v}
    gn = [h["gradnorm"] for h in hist]
    c = corr(phi.to(ct.MAP).arr, sim["phi"].to(ct.MAP).arr)
    print(f"phase 20: (c) MAP_marg {N_MUSE}^2 P, {MARG_SIMS} sims, {MARG_STEPS} steps "
          f"({MARG_MF_STEPS} with the mean field), CG 25 fixed, alpha {MARG_ALPHA}: {wall:.3f} s, "
          f"{wall / MARG_STEPS:.4f} s/step (the first step's kernel tables included); gradient "
          f"norms {gn}; corr(phi_marg, phi_true) {c:.4f} [{card}]")
    for line in timing.timer_report().splitlines():
        print(f"phase 20: (c) split {line}")
    print(f"phase 20: (c) launches {launches}")
    bad = {} if np.isfinite(gn).all() and torch.isfinite(phi.arr).all() else {"MAP_marg": gn}
    return launches, bad, wall / MARG_STEPS


def ensemble_kernels(torch, card, f, phi_map):
    """Phase 20 (d): K2's whole flow at every kind and tier on the path's
    fields (MUSE_SIMS entries and NTRIAL x MUSE_SIMS), and its derivative's
    planes of the path's phi at both path tiers, against their plain
    versions. Returns ({(tier, kind): record at MUSE_SIMS}, bad)."""
    from cmblensing_tpu_torch.ops import deriv, lenseflow_kernels as lfk
    import cmblensing_tpu_torch as ct
    proj = ct.ProjLambert(N_MUSE, N_MUSE, thetapix=3, T=np.float32, device=DEVICE)
    mats = deriv.deriv_mats(proj)
    bad, found = {}, {}
    for tier in ("f32", "high"):
        e = rel(lfk.gradhess(phi_map, mats, tier), lfk.gradhess_plain(phi_map, mats, tier))
        print(f"phase 20: (d) K2 deriv {tier}: phi's planes ({MUSE_SIMS} x {N_MUSE}^2) vs plain "
              f"{e:.3e} (bound {HESS_TOL:g}) [{card}]")
        if not e < HESS_TOL:
            bad["deriv", tier] = e
    dy = torch.roll(f, 11, dims=-1).contiguous()
    each = lambda a, b: max(rel(x, y) for x, y in zip(a.reshape(-1, *a.shape[-2:]),
                                                      b.reshape(-1, *b.shape[-2:])))
    for nb in (MUSE_SIMS, NTRIAL * MUSE_SIMS):
        reps = nb // MUSE_SIMS
        ff = f.repeat(reps, 1, 1, 1)
        ph = torch.cat([(0.5 + i / reps) * phi_map for i in range(reps)]) if reps > 1 else phi_map
        planes = {t: lfk.gradhess(ph, mats, t) for t in lfk.PRECISIONS}
        for tier in lfk.PRECISIONS:
            for kind in ("forward", "adjoint", "backward"):
                y, (t0, t1) = flow_state(torch, kind, ff, dy.repeat(reps, 1, 1, 1))
                sched = lfk.flow_schedule(NSTEPS, t0, t1)

                def run(fn, p=tier, y_=y):
                    o = y_.clone()
                    fn(kind, o, planes[tier], mats, 2, sched, p)
                    return o

                lfk.reset_launches()
                out = run(lfk.flow_cuda)
                torch.cuda.synchronize()
                launched = {k: v for k, v in lfk.LAUNCHES.items() if v}
                ref = run(lfk.flow_plain)
                d = dict(nb=nb, rel=each(out, ref), max_abs_err=float((out - ref).abs().max()),
                         launches=launched, **flow_bound(kind, tier, 2, nb, N_MUSE, N_MUSE))
                ok = d["rel"] < FLOW_TIER_TOL[tier]
                if tier != "f32":
                    d.update(split_ratio(out, ref, run(lfk.flow_cuda, "f32")))
                    ok = ok and d["split_ratio"] < FLOW_SPLIT_RATIO
                sfx = "" if tier == "f32" else "_" + tier
                ok = ok and launched == {f"flow_{kind}{sfx}": 1}
                line = (f"phase 20: (d) flow {kind:8s} {tier:4s} {nb:3d} x {N_MUSE}^2 P vs plain "
                        f"{d['rel']:.3e} (bound {FLOW_TIER_TOL[tier]:g}, each plane)")
                if tier != "f32":
                    line += f", Frobenius ratio {d['split_ratio']:.4f}"
                if nb == MUSE_SIMS:
                    launch = lfk.flow_launcher(kind, y.clone(), planes[tier], mats, 2, sched, tier)
                    d.update(ms=kernel_ms(launch, 5, torch),
                             plain_ms=cuda_ms(lambda: run(lfk.flow_plain), 1, torch),
                             library_ms=None)
                    line += (f"; {d['ms']:.4f} ms, plain {d['plain_ms']:.3f} ms, bound "
                             f"{d['bound_ms']:.4f} ms ({d['bound_by']}, "
                             f"{100 * d['bound_ms'] / d['ms']:.1f} %)")
                    found[tier, kind] = d
                print(line + f"; launches {launched} [{card}]", flush=True)
                if not ok:
                    bad[kind, tier, nb] = (d["rel"], d.get("split_ratio"), launched)
                del out, ref, y
        del planes, ff, ph
        torch.cuda.empty_cache()
    return found, bad


def ensemble_vs_plain(torch, card, ds, sims):
    """Phase 20 (e): one batched MAP_joint step at 2 sims (strict, CG 20
    fixed) and the MUSE theta-scores at its MAP, on "kernel" against
    "plain"."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.inference import muse as tmuse
    ds2 = ds.replace(d=ct.Field(sims["d"].arr[:2], sims["d"].basis, sims["d"].proj))
    theta = dict(Aphi_b=MUSE_TRUTH)
    spec = tmuse._theta_spec(theta)
    out = {}
    for backend in ("kernel", "plain"):
        t0 = time.perf_counter()
        with ct.lenseflow_backend_ctx(backend):
            r = ct.MAP_joint(ds2, theta=theta, nsteps=1, precision=None,
                             conjgrad_kwargs=dict(tol=0.0, nsteps=20, fixed_iters=True),
                             history_keys=("logpdf", "alpha"))
            s = tmuse._theta_score_batch(ds2, r["f"], r["phi"],
                                         tmuse._theta_vec(theta, spec, DEVICE), spec)
        torch.cuda.synchronize()
        out[backend] = (r, s, time.perf_counter() - t0)
    (k, sk, tk), (p, sp, tp_) = out["kernel"], out["plain"]
    m = lambda x: x.to(x.basis.with_space("map")).arr
    errs = {"f": rel(m(k["f"]), m(p["f"])), "phi": rel(m(k["phi"]), m(p["phi"])),
            "scores": rel(sk, sp)}
    print(f"phase 20: (e) a batched MAP_joint step at 2 sims and its MUSE scores, kernel vs "
          f"plain: " + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
          + f" (bound {ENSEMBLE_PLAIN_TOL:g}); alpha {k['history'][0]['alpha'].tolist()} vs "
          f"{p['history'][0]['alpha'].tolist()}; scores {sk.tolist()}; kernel {tk:.2f} s, plain "
          f"{tp_:.2f} s [{card}]")
    return {n: e for n, e in errs.items() if not e < ENSEMBLE_PLAIN_TOL}


def phase_ensemble(torch, card):
    """Phase 20: BASELINE.json configs[4] (see ENSEMBLE_KERNELS and the
    constants above it). Returns (launches of (a) and (c), the flows' and
    derivative's records at the path's shapes, timings)."""
    import cmblensing_tpu_torch as ct
    t_start = time.perf_counter()
    ds, sim, phi_data = muse_dataset(torch)
    res, muse_launches, bad, numbers = ensemble_muse(torch, card, ds)
    MUSE_CACHE["ref"] = par_muse_numbers(res)   # phase 23 (c)'s unsharded reference
    theta = dict(Aphi_b=np.asarray(res["theta"]["Aphi_b"]))
    sims, bad_qe, qe_ms = ensemble_qe(torch, card, ds, theta, phi_data)
    bad.update(bad_qe)
    marg_launches, bad_marg, marg_s = ensemble_marg(torch, card)
    bad.update(bad_marg)
    f = sims["f"].to(ct.QU_MAP).arr.contiguous()
    phi_map = sims["phi"].to(ct.MAP).arr.contiguous()
    found, bad_k = ensemble_kernels(torch, card, f, phi_map)
    bad.update(bad_k)
    bad.update(ensemble_vs_plain(torch, card, ds, sims))
    for label, launches in (("MUSE", muse_launches), ("MAP_marg", marg_launches)):
        never = [k for k in ENSEMBLE_KERNELS if not launches.get(k)]
        if never:
            bad[f"{label} never launched"] = never
    del ds, sim, sims, res, f, phi_map
    torch.cuda.empty_cache()
    print(f"phase 20: wall time {time.perf_counter() - t_start:.1f} s [{card}]")
    if bad:
        raise AssertionError(f"phase 20 failed: {bad}")
    return muse_launches, marg_launches, found, {
        "muse_256x8_s_per_run": numbers["s_run"], "muse_256x8_peak_GiB": numbers["peak_GiB"],
        "muse_256x8_pulls": numbers["pulls"], "muse_256x8_chi2": numbers["chi2"],
        "qe_eb_256x9_ms": qe_ms, "MAP_marg_256x16_s_per_step": marg_s}


def weak_logprior(ds):
    """A weak Gaussian logprior on phi, -w/2 phi' Cphi^-1 phi (w =
    OPT_LOGPRIOR_W), as a dataset's logprior(theta=, f=, phi=)."""
    import cmblensing_tpu_torch as ct
    Cphi = ds.Cphi.fiducial
    return lambda theta=None, f=None, phi=None: -0.5 * OPT_LOGPRIOR_W * ct.dot(phi, Cphi.solve(phi))


def options_brent(torch, card, sim):
    """Phase 21 (a): MAP_joint with a logprior (so brent), OPT_STEPS steps at
    "auto", CG as MAP_CG, the launch counters set to 0 just before and read
    just after; then one brent step from the same f-step on the kernel and
    the plain backends. Returns (launches, s/step, bad)."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.inference import maximization as tm
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    from cmblensing_tpu_torch.ops.deriv import precision_ctx
    ds = sim["ds"].replace(logprior=weak_logprior(sim["ds"]))
    keys = ("logpdf", "alpha", "nfev", "cg_iters", "retry")
    bad = {}
    lfk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ct.MAP_joint(ds, nsteps=OPT_STEPS, conjgrad_kwargs=MAP_CG, history_keys=keys,
                       alpha_tol=OPT_ALPHA_TOL)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: v for k, v in lfk.LAUNCHES.items() if v}
    hist = res["history"]
    lps, alphas, nfev = ([h[k] for h in hist] for k in ("logpdf", "alpha", "nfev"))
    print(f"phase 21: (a) MAP_joint {N_MAP}^2 P with a logprior (brent, alpha_tol "
          f"{OPT_ALPHA_TOL:g}), {OPT_STEPS} steps at \"auto\", CG 15 fixed: {dt:.3f} s = "
          f"{dt / OPT_STEPS:.4f} s/step (the first step's kernel tables included) [{card}]")
    print(f"phase 21: (a) logpdfs {lps!r}; alphas {alphas!r}; brent evaluations a step {nfev}; "
          f"retries {[h['retry'] for h in hist]}; CG iters {[h['cg_iters'] for h in hist]}")
    print(f"phase 21: (a) launches {launches}; per step "
          f"{ {k: v / OPT_STEPS for k, v in launches.items()} }")
    if not all(np.isfinite(lps)) or any(b < a for a, b in zip(lps, lps[1:])):
        bad["(a) logpdf"] = lps
    if not alphas[0] > 0:
        bad["(a) first alpha"] = alphas
    never = [k for k in OPT_KERNELS if not launches.get(k)]
    if never:
        bad["(a) never launched"] = never
    # one strict brent step on each backend from the same f-step: its own
    # direction (the gradients lie ~1e-4 apart), and the line search alone
    # along the kernel backend's direction
    dstheta = ds.at({}).replace(G=ct.Id)
    phi0 = tm._zero_map_like(tm._fid(dstheta.Cphi))
    f, _ = ct.argmaxf_logpdf(dstheta, phi=phi0, conjgrad_kwargs=MAP_CG)
    Hinv = tm.hessian_phimix_preconditioner(dstheta).pinv()
    step, shared = {}, None
    for be in ("kernel", "plain"):
        with ct.lenseflow_backend_ctx(be), precision_ctx("f32"), torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f_mix, phi_mix, g = tm._phi_grad_and_fmix(dstheta, {}, f, phi0)
            shared = shared or (f_mix, phi_mix, Hinv @ g)
            for label, (fm, pm, dphi) in (("own", (f_mix, phi_mix, Hinv @ g)),
                                          ("shared", shared)):
                dlp = tm._brent_dlp(dstheta, {}, fm, pm, dphi)
                a, n = tm._brent_min(lambda a: -dlp(a), 2.0, abs_tol=OPT_ALPHA_TOL)
                lp = float(tm._step_unmix_and_norm(dstheta, {}, fm, pm, dphi, a)[2])
                step[be, label] = (a, lp, n)
            torch.cuda.synchronize()
            step[be] = time.perf_counter() - t0
    for label in ("own", "shared"):
        (ak, lk, nk), (ap, lpp, npl) = step["kernel", label], step["plain", label]
        print(f"phase 21: (a) one strict brent step from the same f-step, "
              + ("each backend's own direction" if label == "own" else
                 "the line search along the kernel backend's direction")
              + f": kernel alpha {ak!r} logpdf {lk!r} ({nk} evaluations); plain alpha {ap!r} "
              f"logpdf {lpp!r} ({npl}); |d alpha| {abs(ak - ap):.3e}"
              + (f" (bound {10 * OPT_ALPHA_TOL:g})" if label == "shared" else "")
              + f", logpdf rel {abs(lk - lpp) / abs(lpp):.3e} (bound {OPT_LP_TOL:g}) [{card}]")
        if not abs(lk - lpp) < OPT_LP_TOL * abs(lpp):
            bad[f"(a) brent logpdf kernel vs plain, {label}"] = (lk, lpp)
        if label == "shared" and not abs(ak - ap) < 10 * OPT_ALPHA_TOL:
            bad["(a) brent alpha kernel vs plain"] = (ak, ap)
    print(f"phase 21: (a) those steps: kernel {step['kernel']:.3f} s, plain {step['plain']:.3f} s")
    return launches, dt / OPT_STEPS, bad


def options_hessian_quasi(torch, card, sim):
    """Phase 21 (b) nburnin_update_hessian against the grid run without it,
    and (c) quasi-samples. Returns (numbers, bad)."""
    import cmblensing_tpu_torch as ct
    ds, bad, out = sim["ds"], {}, {}
    for label, kw in (("grid", {}), ("hessian update", dict(nburnin_update_hessian=OPT_HESS_BURNIN))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ct.MAP_joint(ds, nsteps=OPT_HESS_STEPS, conjgrad_kwargs=MAP_CG, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        lps = [h["logpdf"] for h in res["history"]]
        c = corr(res["phi"].to(ct.MAP).arr, sim["phi"].to(ct.MAP).arr)
        out[label] = (dt / OPT_HESS_STEPS, c)
        print(f"phase 21: (b) MAP_joint {N_MAP}^2 P \"auto\" {OPT_HESS_STEPS} steps, {label}"
              + (f" (from step {OPT_HESS_BURNIN + 1})" if kw else "")
              + f": {dt / OPT_HESS_STEPS:.4f} s/step; corr(phi_MAP, phi_true) {c:.4f} (bound >= "
              f"{CORR_MIN:g}); logpdfs {lps!r} [{card}]")
        if not (c >= CORR_MIN and np.isfinite(lps).all()):
            bad[f"(b) {label}"] = (c, lps)
    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED + 21)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ct.MAP_joint(ds, nsteps=OPT_QUASI_STEPS, conjgrad_kwargs=MAP_CG, quasi_sample=True,
                       key=g)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    lps = [h["logpdf"] for h in res["history"]]
    out["quasi"] = dt / OPT_QUASI_STEPS
    print(f"phase 21: (c) MAP_joint quasi_sample=True, {OPT_QUASI_STEPS} steps: "
          f"{dt / OPT_QUASI_STEPS:.4f} s/step; logpdfs {lps!r} [{card}]")
    if not np.isfinite(lps).all():
        bad["(c) quasi_sample"] = lps
    return out, bad


def options_nolensing(torch, card):
    """Phase 21 (d): load_nolensing_sim at 1024^2 P, MAP_joint against
    argmaxf_logpdf. Returns (ms, bad)."""
    import cmblensing_tpu_torch as ct
    sim = ct.load_nolensing_sim(thetapix=THETAPIX_MAP, Nside=N_MAP, pol="P", seed=SEED,
                                device=DEVICE)
    ds = sim["ds"]
    times = {}
    for label, run in (("MAP_joint", lambda: ct.MAP_joint(ds)),
                       ("argmaxf_logpdf", lambda: ct.argmaxf_logpdf(ds))):
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = run()
        torch.cuda.synchronize()
        times[label] = (1e3 * (time.perf_counter() - t0), r)
    (ms_map, rm), (ms_wf, (fw, info)) = times["MAP_joint"], times["argmaxf_logpdf"]
    fm = rm["f"]
    e = rel(fm.arr, fw.to(fm.basis).arr)
    it = int(rm["history"][0]["iterations"])
    print(f"phase 21: (d) load_nolensing_sim {N_MAP}^2 P: MAP_joint {ms_map:.2f} ms, "
          f"argmaxf_logpdf {ms_wf:.2f} ms, CG iterations {it} and {int(info['iterations'])} "
          f"(tol 0.1), f rel {e:.3e} (bound {OPT_NOLENS_TOL:g}); phi {rm['phi']} [{card}]")
    bad = {} if (e < OPT_NOLENS_TOL and rm["phi"] is None) else {"(d) nolensing": e}
    return ms_map, bad


def options_lensing(torch, card, sim):
    """Phase 21 (e): PowerLens, Taylens and BilinearLens at 1024^2 P against
    LenseFlow, BilinearLens's adjoint identity and solve residual, and
    get_max_lensing_step; each on the card against the same function on
    the CPU on the same float32 inputs and on the CPU in float64
    (`f32_agrees`); the phi-gradient of logpdf on load_sim(L=BilinearLens)
    the same way. Returns (ms of each, bad)."""
    import cmblensing_tpu_torch as ct
    projs = {"card": ct.ProjLambert(N_MAP, N_MAP, thetapix=THETAPIX_MAP, T=np.float32,
                                    device=DEVICE),
             "cpu": ct.ProjLambert(N_MAP, N_MAP, thetapix=THETAPIX_MAP, T=np.float32,
                                   device="cpu"),
             "cpu64": ct.ProjLambert(N_MAP, N_MAP, thetapix=THETAPIX_MAP, T=np.float64,
                                     device="cpu")}
    rng = np.random.default_rng(SEED + 21)
    Cl = ct.camb()
    pc = projs["cpu"]
    Cphi = ct.Cl_to_Cov("I", pc, Cl["total"]["pp"])
    Cf = ct.Cl_to_Cov("P", pc, Cl["unlensed_scalar"]["EE"], Cl["unlensed_scalar"]["BB"])
    w = [ct.Field(torch.as_tensor(rng.standard_normal((c, N_MAP, N_MAP)).astype(np.float32)),
                  b, pc) for c, b in ((1, ct.MAP), (2, ct.QU_MAP), (2, ct.QU_MAP))]
    # the inputs made once, on the CPU in float32, and the same values on the
    # card and (cast) in float64
    base = dict(phi=(Cphi.sqrt() @ w[0]).to(ct.MAP), f=(Cf.sqrt() @ w[1]).to(ct.QU_MAP),
                g=(Cf.sqrt() @ w[2]).to(ct.QU_MAP))
    x = {side: {k: ct.Field(v.arr.to(proj.device, proj.torch_T), v.basis, proj)
                for k, v in base.items()} for side, proj in projs.items()}
    bad, ms = {}, {}

    def check(label, outs, tol=OPT_F32_TOL):
        """outs: side -> tensor. The card's float32 result against the CPU's
        and both against float64, in Frobenius norm: the card within tol of
        the CPU and no further from float64 than twice the CPU is."""
        cc = fro(outs["card"].cpu(), outs["cpu"])
        c64, p64 = fro(outs["card"].cpu().double(), outs["cpu64"]), fro(outs["cpu"].double(),
                                                                        outs["cpu64"])
        ok = cc < tol and c64 <= 2 * p64 + 1e-7
        if not ok:
            bad[f"(e) {label} against the CPU"] = (cc, c64, p64)
        return f"card vs CPU {cc:.3e} (bound {tol:g}), vs float64 card {c64:.3e} CPU {p64:.3e}"

    phi, f, g = (x["card"][k] for k in ("phi", "f", "g"))
    Llf = ct.LenseFlow(phi, NSTEPS) @ f
    ops = {"PowerLens": lambda p: ct.PowerLens(p, 4), "Taylens": lambda p: ct.Taylens(p, 4),
           "BilinearLens": ct.BilinearLens}
    for name, op in ops.items():
        outs = {side: (op(v["phi"]) @ v["f"]).to(ct.QU_MAP).arr for side, v in x.items()}
        ms[name] = cuda_ms(lambda: op(phi) @ f, 5, torch)
        e_lf = float((outs["card"] - Llf.to(ct.QU_MAP).arr).norm() / Llf.arr.norm())
        line = check(name, outs)
        print(f"phase 21: (e) {name} {N_MAP}^2 P: against LenseFlow {e_lf:.3e} in norm (bound "
              f"{OPT_LENS_BOUND[name]:g}); {line}; {ms[name]:.3f} ms [{card}]")
        if not e_lf < OPT_LENS_BOUND[name]:
            bad[f"(e) {name} against LenseFlow"] = e_lf
    L = ct.BilinearLens(phi)
    lhs, rhs = float(ct.dot(g, L @ f)), float(ct.dot(L.H @ g, f))
    e_adj = abs(lhs - rhs) / abs(lhs)
    outs = {side: (ct.BilinearLens(v["phi"]).H @ v["g"]).arr for side, v in x.items()}
    ms["BilinearLens.H"] = cuda_ms(lambda: L.H @ g, 5, torch)
    line_adj = check("BilinearLens.H", outs)
    e_solve = float(ct.norm(L.solve(L @ f) - f) / ct.norm(f))
    outs = {side: ct.BilinearLens(v["phi"]).solve(v["f"]).to(ct.QU_MAP).arr
            for side, v in x.items()}
    ms["BilinearLens.solve"] = cuda_ms(lambda: L.solve(f), 3, torch)
    line_solve = check("BilinearLens.solve", outs)
    mls = {side: float(ct.get_max_lensing_step(v["phi"], v["phi"])) for side, v in x.items()}
    e_mls = abs(mls["card"] - mls["cpu"]) / abs(mls["cpu"])
    print(f"phase 21: (e) BilinearLens adjoint identity {e_adj:.3e} (bound {OPT_ADJ_TOL:g}); L^H "
          f"{line_adj} ({ms['BilinearLens.H']:.3f} ms); solve residual {e_solve:.3e} (bound "
          f"{OPT_SOLVE_TOL:g}), solve {line_solve} ({ms['BilinearLens.solve']:.3f} ms) [{card}]")
    print(f"phase 21: (e) get_max_lensing_step(phi, phi): card {mls['card']!r}, CPU "
          f"{mls['cpu']!r}, CPU float64 {mls['cpu64']!r}; card vs CPU {e_mls:.3e} (bound "
          f"{OPT_CPU_TOL:g})")
    if not (e_adj < OPT_ADJ_TOL and e_solve < OPT_SOLVE_TOL and e_mls < OPT_CPU_TOL):
        bad["(e) BilinearLens / get_max_lensing_step"] = (e_adj, e_solve, e_mls)
    # the phi-gradient of logpdf with the bilinear lensing operator at the
    # card's simulation: load_sim's operators on each side, the card's d, f, phi
    kw = dict(thetapix=THETAPIX_MAP, Nside=N_MAP, pol="P", seed=SEED, L=ct.BilinearLens)
    sg = ct.load_sim(**kw, device=DEVICE)
    grads = {}
    for side, proj in projs.items():
        ds = (sg["ds"] if side == "card" else
              ct.load_sim(**kw, T=proj.T, device="cpu")["ds"])
        to = lambda v: ct.Field(v.arr.to("cpu", torch.complex128 if v.arr.is_complex() else
                                          torch.float64) if proj.T == np.float64
                                else v.arr.to(proj.device), v.basis, proj)
        ds = ds.replace(d=to(sg["ds"].d))
        fx, px = to(sg["f"]), to(sg["phi"])
        grads[side] = ct.fgrad(lambda p: torch.sum(ds.logpdf(f=fx, phi=p)))(px).arr
    ms["grad logpdf BilinearLens"] = cuda_ms(
        lambda: ct.fgrad(lambda p: torch.sum(sg["ds"].logpdf(f=sg["f"], phi=p)))(sg["phi"]), 3,
        torch)
    finite = bool(torch.isfinite(grads["card"]).all())
    line = check("grad logpdf BilinearLens", grads, OPT_GRAD_TOL)
    print(f"phase 21: (e) grad_phi logpdf on load_sim(L=BilinearLens) {N_MAP}^2 P: finite "
          f"{finite}; {line}; {ms['grad logpdf BilinearLens']:.3f} ms [{card}]")
    if not finite:
        bad["(e) BilinearLens gradient finite"] = finite
    return ms, bad


def options_defaults(torch, card, sim):
    """Phase 21 (f): load_sim with every keyword passed at its default value
    gives the default dataset's d and operators, bit for bit."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.core.ops import LowPass
    ds = sim["ds"]
    lmax = int(np.ceil(np.sqrt(2) * float(sim["proj"].nyquist)) + 1)
    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED)
    over = ct.load_sim(
        thetapix=THETAPIX_MAP, Nside=N_MAP, pol="P", T=np.float32, Nbatch=None, muKarcminT=3,
        lknee=100, alphaknee=3, Cln=ct.noise_cls(3, beamFWHM=0, lknee=100, alphaknee=3, lmax=lmax),
        Cn=ds.Cn, beamFWHM=0, B=ds.B, B_hat=ds.B_hat, pixel_mask_kwargs=None,
        bandpass_mask=LowPass(3000), M=ds.M, M_hat=ds.M_hat, Cl=sim["Cl"], fiducial_theta={},
        seed=SEED, key=g, D=ds.D, G=ds.G, Nphi_fac=2, L=ct.LenseFlow, rotator=(0.0, 90.0, 0.0),
        device=DEVICE)
    a, b = sim["ds0"], over["ds0"]
    same = {"d": torch.equal(a.d.arr, b.d.arr)}
    for name in ("Cf", "Cf_tilde", "Cn", "Cn_hat", "Cphi", "M", "M_hat", "B", "B_hat", "D", "G",
                 "Nphi"):
        same[name] = torch.equal(getattr(a, name).diag.arr, getattr(b, name).diag.arr)
    print(f"phase 21: (f) load_sim with every keyword at its default value, bit for bit: {same}")
    return {} if all(same.values()) else {"(f) defaults": same}


def phase_options(torch, card, sim=None):
    """Phase 21: the rest of load_sim's and MAP_joint's options at 1024^2 P
    (thetapix 2, scripts/map_1024.py's simulation; the one phase 7 loaded in
    a whole run). No kernel of its own: (a) runs the factored kernels.
    Returns (launches of (a), timings)."""
    t_start = time.perf_counter()
    if sim is None:
        sim = large_sim(torch, card, N_MAP, 21)
    launches, s_brent, bad = options_brent(torch, card, sim)
    hq, bad_hq = options_hessian_quasi(torch, card, sim)
    bad.update(bad_hq)
    ms_nolens, bad_nl = options_nolensing(torch, card)
    bad.update(bad_nl)
    ms_lens, bad_lens = options_lensing(torch, card, sim)
    bad.update(bad_lens)
    bad.update(options_defaults(torch, card, sim))
    torch.cuda.empty_cache()
    print(f"phase 21: wall time {time.perf_counter() - t_start:.1f} s [{card}]")
    if bad:
        raise AssertionError(f"phase 21 failed: {bad}")
    return launches, {"MAP_joint_1024_brent_s_per_step": s_brent,
                      "MAP_joint_1024_hessian_update_s_per_step": hq["hessian update"][0],
                      "MAP_joint_1024_hessian_update_corr": hq["hessian update"][1],
                      "MAP_joint_1024_grid_corr_6": hq["grid"][1],
                      "MAP_joint_1024_quasi_s_per_step": hq["quasi"],
                      "MAP_joint_nolensing_1024_ms": ms_nolens,
                      **{f"{k}_1024_ms": v for k, v in ms_lens.items()}}


# --- phase 22: the curved sky and the rest of the field API ------------------

def curved_band(ct, Ny, Nx, device=None):
    """The band of phase 22: Ny rings of Nx pixels, theta within CURVED_HALF
    of the equator, the full circle in phi."""
    return ct.ProjEquiRect(Ny=Ny, Nx=Nx, theta_span=(np.pi / 2 - CURVED_HALF,
                                                     np.pi / 2 + CURVED_HALF),
                           phi_span=(0, 2 * np.pi), device=device or DEVICE)


def curved_spectra(ct, pol):
    """The fiducial unlensed spectra (scalar and tensor, r = 0.2) of pol."""
    c = ct.camb().unlensed_total
    return (c.TT,) if pol == "I" else (c.EE, c.BB)


def curved_noise(ct, torch, proj, pol):
    """White noise of CURVED_NOISE muK-arcmin: each ring's pixel variance
    (muK-arcmin)^2 / Omega(theta) on the diagonal of every block; at P the
    blocks are half the covariance of P = Q + iU, so Q and U each get it."""
    var = CURVED_NOISE ** 2 / (proj.Omega * (60 * 180 / np.pi) ** 2)
    v = torch.as_tensor(np.concatenate([var, var]) if pol == "P" else var,
                        dtype=torch.float32, device=proj.device)
    dt = torch.complex64 if pol == "P" else torch.float32
    blocks = torch.diag_embed(v).to(dt).expand(proj.Nx // 2 + 1, -1, -1).contiguous()
    return ct.BlockDiagEquiRect(blocks, "qu_az" if pol == "P" else "az", proj)


def legendre_sum(Cl, ell, x):
    """sum_l (2l+1)/(4 pi) C_l P_l(x), by the Legendre recurrence in float64."""
    p0, p1 = 1.0, x
    tot = Cl[0] / (4 * np.pi) + (3 / (4 * np.pi)) * Cl[1] * x
    for l in range(1, int(ell[-1])):
        p0, p1 = p1, ((2 * l + 1) * x * p1 - l * p0) / (l + 1)
        tot += (2 * (l + 1) + 1) / (4 * np.pi) * Cl[l + 1] * p1
    return tot


def two_point_errors(C, pol, Cls, lmax, rings):
    """|cov - Gamma| / |Gamma| at the pixel pairs (rings[0], r) on one
    meridian: cov from the float32 blocks summed over m in float64, Gamma
    the float64 harmonic sum. At I, Gamma = sum (2l+1)/4pi C_l P_l(cos b); at
    P, <P P*> = sum (2l+1)/4pi (C_EE + C_BB) d^l_22(b), d^l_22 = ((1 +
    cos b)/2)^2 P^(0,4)_(l-2)(cos b)."""
    from scipy.special import eval_jacobi
    proj = C.proj
    nT, nP = proj.Ny, proj.Nx
    t1, cols = rings[0], list(rings)
    top = C.blocks[:, t1, cols].cpu().numpy().astype(np.complex128)          # (nm, pairs)
    bot = (C.blocks[:, nT + t1, [nT + c for c in cols]].cpu().numpy().astype(np.complex128)
           if pol == "P" else None)
    ell = np.arange(lmax + 1)
    w = np.full(nP // 2 + 1, 2.0)
    w[0] = w[-1] = 1.0
    out = []
    for k, t2 in enumerate(rings):
        a, b = proj.theta[t1], proj.theta[t2]
        x = np.cos(a) * np.cos(b) + np.sin(a) * np.sin(b)
        if pol == "I":
            cov = np.sum(w * top[:, k].real) / nP
            gam = legendre_sum(np.nan_to_num(Cls[0](ell)), ell, x)
        else:
            cov = 2 * (np.sum(top[:, k]) + np.sum(bot[1:-1, k])).real / nP
            CP = np.nan_to_num(Cls[0](ell)) + np.nan_to_num(Cls[1](ell))
            l2 = ell[2:]
            d22 = ((1 + x) / 2) ** 2 * eval_jacobi(l2 - 2, 0, 4, x)
            gam = np.sum((2 * l2 + 1) / (4 * np.pi) * CP[2:] * d22)
        out.append(float(abs(cov - gam) / abs(gam)))
    return out


def sync_ms(torch, fn):
    """(fn()'s result, its milliseconds to the end of its device work)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, 1e3 * (time.perf_counter() - t0)


def curved_ops(torch, card, ct, proj, pol, lmax, bad, tag):
    """(a) and (b) of phase 22 at one pol: Cf's build and its checks, then
    sqrt, pinv, solve and logdet. Returns (Cf, timings)."""
    Cls = curved_spectra(ct, pol)
    C, ms_build = sync_ms(torch, lambda: ct.Cl_to_Cov_EquiRect(pol, proj, *Cls, lmax=lmax))
    finite = bool(torch.isfinite(C.blocks).all())
    mid = proj.Ny // 2
    tp = two_point_errors(C, pol, Cls, lmax, (mid, mid + 1, mid + 4))
    print(f"phase 22: {tag} Cl_to_Cov_EquiRect({pol!r}) {proj.Ny} x {proj.Nx}, lmax {lmax}: "
          f"blocks {tuple(C.blocks.shape)} {C.blocks.dtype} "
          f"({C.blocks.numel() * C.blocks.element_size() / 2 ** 30:.3f} GiB), built in "
          f"{ms_build:.1f} ms, every block finite: {finite}; two-point identity at rings "
          f"({mid}, {mid}), ({mid}, {mid + 1}), ({mid}, {mid + 4}): rel err "
          f"{', '.join(f'{e:.2e}' for e in tp)} (bound {CURVED_2PT_TOL:g}) [{card}]")
    if not finite or max(tp) > CURVED_2PT_TOL:
        bad[f"{tag} {pol} blocks"] = (finite, tp)
    t = {"build_ms": ms_build}
    S, t["sqrt_ms"] = sync_ms(torch, C.sqrt)
    err_sq = rel((S * S).blocks, C.blocks)
    del S
    _, t["pinv_ms"] = sync_ms(torch, C.pinv)
    (ld, sign), t["logdet_ms"] = sync_ms(torch, C.logabsdet)
    f = C.simulate(torch.Generator(device=proj.device).manual_seed(SEED))
    Cf_ = C @ f
    back, t["solve_ms"] = sync_ms(torch, lambda: C.solve(Cf_))
    b = f.to(back.basis).arr
    err_solve = rel(back.arr, b)
    print(f"phase 22: {tag} {pol}: sqrt {t['sqrt_ms']:.1f} ms (the SVD), S S vs C rel max-abs "
          f"{err_sq:.2e} (bound {CURVED_SQRT_TOL:g}); pinv {t['pinv_ms']:.1f} ms; logdet "
          f"{float(ld):.6g} (sign {complex(sign)}) {t['logdet_ms']:.1f} ms; solve(C @ f) "
          f"{t['solve_ms']:.1f} ms (the LU), against f rel max-abs {err_solve:.2e} "
          f"[{card}]")
    if not err_sq < CURVED_SQRT_TOL or not np.isfinite(float(ld)):
        bad[f"{tag} {pol} sqrt/logdet"] = (err_sq, float(ld))
    t.update(sqrt_err=err_sq, solve_err=err_solve, logdet=float(ld))
    return C, t


def curved_wiener(torch, card, ct, C, pol, gen, tag):
    """(c) of phase 22: the NoLensingDataSet on C and white noise, its
    Wiener filter and a posterior sample. Returns timings."""
    proj = C.proj
    Cn = curved_noise(ct, torch, proj, pol)
    f = C.simulate(gen)
    d = f + Cn.simulate(gen)
    ds = ct.NoLensingDataSet(d=d, Cf=C, Cn=Cn, Cn_hat=Cn)
    (fwf, info), ms = sync_ms(torch, lambda: ct.argmaxf_logpdf(ds, conjgrad_kwargs=CURVED_CG))
    fm = fwf.to(f.basis)
    corr = float(ct.er_dot(fm, f) / torch.sqrt(ct.er_dot(f, f) * ct.er_dot(fm, fm)))
    (fs, sinfo), ms_s = sync_ms(torch, lambda: ct.sample_f(gen, ds, conjgrad_kwargs=CURVED_CG))
    lp = float(ds.logpdf(f=fs))
    it, res, res0 = int(info["iterations"]), float(info["res"]), float(info["res0"])
    print(f"phase 22: {tag} {pol} Wiener filter (CG tol {CURVED_CG['tol']:g}, at most "
          f"{CURVED_CG['nsteps']}): {ms:.1f} ms, {it} iterations, residual {res:.3e} (from "
          f"{res0:.3e}), corr(f_WF, f) {corr:.4f}; sample_f {ms_s:.1f} ms, "
          f"{int(sinfo['iterations'])} iterations, logpdf {lp:.6g} [{card}]")
    return {"ms": ms, "iterations": it, "res": res, "corr": corr, "sample_ms": ms_s,
            "logpdf": lp}


def curved_vs_cpu(torch, card, ct, bad):
    """(d) of phase 22: the band at CURVED_SMALL on the card and on the CPU:
    the blocks, and the Wiener filter of one CPU-drawn d."""
    Ny, Nx, lmax = CURVED_SMALL
    for pol in ("I", "P"):
        Cls = curved_spectra(ct, pol)
        Cs = {dev: ct.Cl_to_Cov_EquiRect(pol, curved_band(ct, Ny, Nx, dev), *Cls, lmax=lmax)
              for dev in (DEVICE, "cpu")}
        e_blocks = rel(Cs[DEVICE].blocks.cpu(), Cs["cpu"].blocks)
        tp = two_point_errors(Cs[DEVICE], pol, Cls, lmax, (Ny // 2, Ny // 2 + 1, Ny // 2 + 4))
        gen = torch.Generator().manual_seed(SEED)
        Cn_cpu = curved_noise(ct, torch, Cs["cpu"].proj, pol)
        d_cpu = Cs["cpu"].simulate(gen) + Cn_cpu.simulate(gen)
        fw = {}
        for dev in (DEVICE, "cpu"):
            proj = Cs[dev].proj
            d = ct.EquiRectField(d_cpu.arr.to(dev), d_cpu.basis, proj)
            Cn = curved_noise(ct, torch, proj, pol)
            ds = ct.NoLensingDataSet(d=d, Cf=Cs[dev], Cn=Cn, Cn_hat=Cn)
            fw[dev], info = ct.argmaxf_logpdf(ds, conjgrad_kwargs=CURVED_CG)
            fw[dev + "_it"] = int(info["iterations"])
        b = fw["cpu"].basis
        e_wf = rel(fw[DEVICE].to(b).arr.cpu(), fw["cpu"].arr)
        print(f"phase 22: (d) {pol} at {Ny} x {Nx}, lmax {lmax} (orders to |m| = {lmax} > 1024): "
              f"card vs CPU blocks rel max-abs {e_blocks:.2e}, Wiener filter f {e_wf:.2e} (CG "
              f"iterations {fw[DEVICE + '_it']}, {fw['cpu_it']}; bound {CURVED_CPU_TOL:g}); "
              f"blocks finite {bool(torch.isfinite(Cs[DEVICE].blocks).all())}; two-point rel err "
              f"{', '.join(f'{e:.2e}' for e in tp)} [{card}]")
        if not (e_blocks < CURVED_CPU_TOL and e_wf < CURVED_CPU_TOL
                and max(tp) < CURVED_2PT_TOL):
            bad[f"(d) {pol}"] = (e_blocks, e_wf, tp)


def plane_waves(torch, proj, ncomp, lmax, seed=SEED):
    """A smooth flat map on proj's device: six plane waves of l in [lmax /
    10, lmax] a component (on a band, x runs along phi at the equator)."""
    g = np.random.default_rng(seed)
    y, x = np.meshgrid(np.arange(proj.Ny), np.arange(proj.Nx), indexing="ij")
    if hasattr(proj, "deltax"):
        dy = dx = float(proj.deltax)
    else:
        dy, dx = 2 * CURVED_HALF / proj.Ny, 2 * np.pi / proj.Nx
    comps = []
    for _ in range(ncomp):
        m = np.zeros((proj.Ny, proj.Nx))
        for _ in range(6):
            lv, ang, ph = g.uniform(lmax / 10, lmax), g.uniform(0, 2 * np.pi), g.uniform(0, 2 * np.pi)
            m += g.normal() * np.cos(lv * (dx * x * np.cos(ang) + dy * y * np.sin(ang)) + ph)
        comps.append(m)
    return torch.as_tensor(np.stack(comps).astype(np.float32), device=proj.device)


def hpx_round_trips(torch, card, ct, proj, nside, bad, tag, fft_pols=("I", "QU")):
    """(e) of phase 22 on one flat grid: a flat map up to the sphere (its
    in-patch pixels), then sphere -> grid -> sphere, bilinear (and 'fft' at
    fft_pols), I and QU; times, and the round trip's rms error on the
    patch's pixels."""
    from cmblensing_tpu_torch.core import proj_healpix as ph
    hpx = ct.ProjHealpix(nside)
    t0 = time.perf_counter()
    pr = ph.Projector(hpx, proj)
    t_build = time.perf_counter() - t0
    print(f"phase 22: (e) {tag}: Projector(nside {nside}) host build {t_build:.2f} s "
          f"({pr.sel.numel()} pixels in the patch, of {hpx.npix}) [{card}]")
    out = {"projector_s": t_build}
    er = isinstance(proj, ct.ProjEquiRect)
    for pol in ("I", "QU"):
        arr = plane_waves(torch, proj, 1 if pol == "I" else 2, HPX_WAVE_LMAX[er])
        flat = (ct.EquiRectField(arr[0] if pol == "I" else arr, "map" if pol == "I" else "qu_map",
                                 proj) if er else ct.Field(arr, ct.Basis(pol, "map"), proj))
        m = ct.project(flat, hpx)
        for method in ("bilinear",) + (("fft",) if pol in fft_pols else ()):
            # the bilinear steps timed on their second run, 'fft' (seconds
            # at the band) on its first, after the bilinear ones warmed the card
            for _ in range(2 if method == "bilinear" else 1):
                down, ms_d = sync_ms(torch, lambda: ct.project(m, proj, method=method))
                up, ms_u = sync_ms(torch, lambda: ct.project(down, hpx, method=method))
            sel = pr.sel
            err = float((up.arr[..., sel] - m.arr[..., sel]).abs().max()
                        / m.arr[..., sel].abs().max())
            rms = float((up.arr[..., sel] - m.arr[..., sel]).pow(2).mean().sqrt()
                        / m.arr[..., sel].pow(2).mean().sqrt())
            print(f"phase 22: (e) {tag} {pol} {method}: sphere -> grid {ms_d:.2f} ms, grid -> "
                  f"sphere {ms_u:.2f} ms; round trip on the patch's pixels rel max-abs "
                  f"{err:.3e}, rel rms {rms:.3e} [{card}]")
            if not (np.isfinite(err) and rms < HPX_RT_RMS[method]):
                bad[f"(e) {tag} {pol} {method}"] = rms
            out[f"{pol}_{method}"] = (ms_d, ms_u, rms)
    return out


def hpx_vs_cpu(torch, card, ct, bad):
    """(e) of phase 22, the card against the CPU on the same inputs:
    bilinear at nside HPX_NSIDE to the 1024^2 patch and back, 'fft' at
    HPX_FFT_SMALL both ways, QU."""
    from cmblensing_tpu_torch.core import proj_healpix as ph
    cases = (("bilinear", HPX_NSIDE, N_MAP, THETAPIX_MAP, HPX_BILINEAR_TOL),
             ("fft", *HPX_FFT_SMALL, HPX_FFT_TOL))
    for method, nside, n, tp, tol in cases:
        hpx = ct.ProjHealpix(nside)
        projs = {dev: ct.ProjLambert(n, n, thetapix=tp, T=np.float32, device=dev)
                 for dev in (DEVICE, "cpu")}
        arr = plane_waves(torch, projs[DEVICE], 2, HPX_WAVE_LMAX[False])
        m = ct.project(ct.Field(arr, ct.Basis("QU", "map"), projs[DEVICE]), hpx)
        res = {}
        for dev, proj in projs.items():
            mm = ct.HealpixField(m.arr.to(dev), "QU", hpx)
            down = ct.project(mm, proj, method=method)
            res[dev] = (down.arr.cpu(), ct.project(down, hpx, method=method).arr.cpu())
        e_down = rel(res[DEVICE][0], res["cpu"][0])
        e_up = rel(res[DEVICE][1], res["cpu"][1])
        print(f"phase 22: (e) card vs CPU, {method}, nside {nside} <-> {n}^2 at {tp}': sphere -> "
              f"grid rel max-abs {e_down:.2e}, back {e_up:.2e} (bound {tol:g}) [{card}]")
        if not (e_down < tol and e_up < tol):
            bad[f"(e) card vs CPU {method}"] = (e_down, e_up)


def field_api(torch, card, ct, sim, bad):
    """(f) of phase 22: ud_grade of the 1024^2 P path's f to 512^2 and
    2048^2 in both modes (card against CPU), the magnification matrix of its
    phi against the K1-derived planes, and get_Dl."""
    from cmblensing_tpu_torch.ops import deriv, lenseflow_kernels as lfk
    f = sim["f"].to(ct.QU_MAP)
    proj = f.proj
    proj_cpu = ct.ProjLambert(N_MAP, N_MAP, thetapix=THETAPIX_MAP, T=np.float32, device="cpu")
    f_cpu = ct.Field(f.arr.cpu(), f.basis, proj_cpu)
    out = {}
    for mode in ("map", "fourier"):
        for th in (2 * THETAPIX_MAP, THETAPIX_MAP / 2):
            g, ms = sync_ms(torch, lambda: ct.ud_grade(f, th, mode=mode))
            g, ms = sync_ms(torch, lambda: ct.ud_grade(f, th, mode=mode))
            e = rel(g.arr.cpu(), ct.ud_grade(f_cpu, th, mode=mode).arr)
            print(f"phase 22: (f) ud_grade {mode} {N_MAP}^2 -> {g.proj.Ny}^2: {ms:.2f} ms, card "
                  f"vs CPU rel max-abs {e:.2e} (bound {UD_TOL:g}) [{card}]")
            if not e < UD_TOL:
                bad[f"(f) ud_grade {mode} {g.proj.Ny}"] = e
            out[f"ud_grade_{mode}_{g.proj.Ny}_ms"] = ms
    # the FFT's Hessian and K1's two first-derivative products treat phi's
    # Nyquist row and column apart (K1's derivative zeroes the Nyquist mode,
    # -l^2 does not): held to each other on phi with them zeroed, the raw
    # distance reported
    phi = sim["phi"].to(ct.FOURIER)
    F = phi.arr.clone()
    F[..., N_MAP // 2, :] = 0
    F[..., :, -1] = 0
    dist = {}
    for label, p in (("raw", phi), ("Nyquist-free", ct.Field(F, ct.FOURIER, proj))):
        pm = p.to(ct.MAP)
        lfk.reset_launches()
        planes = lfk.gradhess(pm.arr.contiguous(), deriv.deriv_ops(proj))
        torch.cuda.synchronize()
        k1 = {k: v for k, v in lfk.LAUNCHES.items() if v}
        M, ms = sync_ms(torch, lambda: ct.magnification_matrix(pm))
        dist[label] = [rel(M[0, 0].arr - 1, planes[..., 2:3, :, :]),
                       rel(M[0, 1].arr, planes[..., 3:4, :, :]),
                       rel(M[1, 1].arr - 1, planes[..., 4:5, :, :])]
    det = M.det()
    print(f"phase 22: (f) magnification_matrix(phi) {ms:.2f} ms against the K1 planes ({k1}): "
          f"hxx, hxy, hyy rel max-abs {', '.join(f'{e:.2e}' for e in dist['Nyquist-free'])} on "
          f"phi without its Nyquist row and column (bound {HESS_TOL_1024:g}), "
          f"{', '.join(f'{e:.2e}' for e in dist['raw'])} with them; det M in "
          f"[{float(det.arr.min()):.4f}, {float(det.arr.max()):.4f}] [{card}]")
    if not max(dist["Nyquist-free"]) < HESS_TOL_1024 or "fderiv" not in k1:
        bad["(f) magnification"] = (dist, k1)
    dl, cl = ct.get_Dl(f["E"]), ct.get_Cl(f["E"])
    ok = np.allclose(dl.Cl, dl.ell * (dl.ell + 1) * cl.Cl / (2 * np.pi), rtol=1e-12,
                     equal_nan=True) and np.isfinite(dl.Cl[1:40]).all()
    print(f"phase 22: (f) get_Dl(f['E']): {len(dl.ell)} bins, D_l at l ~ {dl.ell[10]:.0f}: "
          f"{dl.Cl[10]:.4g} muK^2; = l(l+1)C_l/2pi of get_Cl: {ok}")
    if not ok:
        bad["(f) get_Dl"] = ok
    return out


def phase_curved(torch, card, sim=None):
    """Phase 22: the curved sky and the rest of the field API, no kernel of
    its own: (a) the EquiRect band's block covariances, I and P; (b) sqrt,
    pinv, solve, logdet; (c) its Wiener filter and a posterior sample; (d)
    a small band past the JAX package's overflow, card against CPU; (e)
    HEALPix projection; (f) ud_grade, the magnification matrix, get_Dl.
    Returns timings."""
    import cmblensing_tpu_torch as ct
    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    bad = {}
    proj = curved_band(ct, CURVED_NY, CURVED_NX)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    timing = {}
    for pol in ("I", "P"):
        C, t = curved_ops(torch, card, ct, proj, pol, CURVED_LMAX, bad, "(a, b)")
        w = curved_wiener(torch, card, ct, C, pol, gen, "(c)")
        if not np.isfinite(w["logpdf"]):
            bad[f"(c) {pol}"] = w
        timing.update({f"curved_{pol}_{k}": v for k, v in {**t, **w}.items()})
        del C
        torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"phase 22: (a-c) peak memory {peak:.2f} GiB; {time.perf_counter() - t_start:.1f} s "
          f"[{card}]")
    timing["curved_peak_GiB"] = peak
    t0 = time.perf_counter()
    curved_vs_cpu(torch, card, ct, bad)
    print(f"phase 22: (d) {time.perf_counter() - t0:.1f} s")
    if sim is None:
        sim = large_sim(torch, card, N_MAP, 22)
    lam = ct.ProjLambert(N_MAP, N_MAP, thetapix=THETAPIX_MAP, T=np.float32, device=DEVICE)
    t0 = time.perf_counter()
    rt = hpx_round_trips(torch, card, ct, lam, HPX_NSIDE, bad, f"Lambert {N_MAP}^2")
    timing.update({f"hpx_lambert_{k}": v for k, v in rt.items()})
    # on the band 'fft' at I only: its sphere -> grid solve visits 14.8 M
    # pixels in 15 CG iterations (2.2 s a component)
    rt = hpx_round_trips(torch, card, ct, proj, HPX_NSIDE, bad,
                            f"EquiRect {CURVED_NY} x {CURVED_NX}", fft_pols=("I",))
    timing.update({f"hpx_equirect_{k}": v for k, v in rt.items()})
    hpx_vs_cpu(torch, card, ct, bad)
    print(f"phase 22: (e) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    timing.update(field_api(torch, card, ct, sim, bad))
    print(f"phase 22: (f) {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_start
    print(f"phase 22: wall time {wall:.1f} s [{card}]")
    timing["phase22_s"] = wall
    if bad:
        raise AssertionError(f"phase 22 failed: {bad}")
    return timing


# =========================================================================
# phase 23: the parallel layer (cmblensing_tpu_torch/parallel/)
# =========================================================================

def par_rel_planes(a, b):
    """The largest rel over the (leading axes flattened) planes."""
    a, b = a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:])
    return max(rel(x, y) for x, y in zip(a, b))


def par_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def par_launches():
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    return {k: v for k, v in lfk.LAUNCHES.items() if v}


def par_reset(torch):
    from cmblensing_tpu_torch.ops import lenseflow_kernels as lfk
    from cmblensing_tpu_torch.parallel import mesh as pm
    torch.cuda.synchronize()
    lfk.reset_launches()
    pm.reset_collective_bytes()
    torch.cuda.reset_peak_memory_stats()
    return time.perf_counter()


def par_read(torch, t0):
    """(s since t0, launches, collective bytes, peak GiB) of a path."""
    from cmblensing_tpu_torch.parallel import mesh as pm
    torch.cuda.synchronize()
    return (time.perf_counter() - t0, par_launches(), dict(pm.COLLECTIVE_BYTES),
            torch.cuda.max_memory_allocated() / 2 ** 30)


def par_sim(N, thetapix=THETAPIX_MAP, **kw):
    import cmblensing_tpu_torch as ct
    return ct.load_sim(thetapix=thetapix, Nside=N, pol="P", T=np.float32, seed=SEED,
                       device=DEVICE, **kw)


def par_flows(torch, mesh, phi, f):
    """(L f, L^H f, delta phi of <v, L f>) of a y-sharded flow (v = f rolled
    by 11 columns), and the path's numbers (par_read)."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.parallel import spatial as sp
    t0 = par_reset(torch)
    phi_s, f_s = sp.shard_spatial(phi, mesh), sp.shard_spatial(f, mesh)
    v_s = sp.shard_spatial(ct.Field(torch.roll(f.arr, 11, dims=-1), f.basis, f.proj), mesh)
    L = ct.ShardedLenseFlow(phi_s, NSTEPS, mesh)
    Lf, LHf = (L @ f_s).arr, (L.H @ f_s).arr
    ps = phi_s.arr.clone().requires_grad_(True)
    with torch.enable_grad():
        lp = torch.sum(v_s.arr * (L(ct.Field(ps, phi.basis, phi.proj)) @ f_s).arr)
        (g,) = torch.autograd.grad(lp, ps)
    numbers = par_read(torch, t0)
    return tuple(sp.gather_spatial(x, mesh) for x in (Lf, LHf, g)), numbers


def par_flows_ref(torch, phi, f):
    """par_flows' three results through the unsharded kernel path."""
    import cmblensing_tpu_torch as ct
    v = torch.roll(f.arr, 11, dims=-1)
    L = ct.LenseFlow(phi, NSTEPS)
    Lf, LHf = (L @ f).arr, (L.H @ f).arr
    g = ct.fgrad(lambda p: torch.sum(v * (ct.LenseFlow(p, NSTEPS) @ f).arr))(phi).arr
    return Lf, LHf, g


def par_line(label, numbers, card, staged):
    s, kinds, nbytes, peak = numbers
    how = ("gloo, host-staged on one card: a check of the decomposition, not a multi-card time"
           if staged else "NCCL, one rank")
    return (f"{label}: {s:.3f} s; bytes sent by this rank {nbytes}; peak memory {peak:.2f} GiB; "
            f"launches {kinds} ({how}) [{card}]")


def par_rank_spatial(torch, rank, world, card, save):
    """Phase 23 (b), one rank of `world` sharing the card over gloo: gloo's
    take on CUDA tensors; the 4096^2 P flows and delta phi, the 256^2 P
    flows (K2's derivative: blocks that fit no radix), the 1024^2 P
    Wiener filter and PAR_MAP_STEPS sharded_MAP_joint steps. Rank 0 saves
    the whole results (`save`) for the parent to hold to the unsharded
    port."""
    import torch.distributed as dist
    import cmblensing_tpu_torch as ct
    out, probe = {}, {}
    collectives = (
        ("all_to_all_single", lambda x: dist.all_to_all_single(torch.empty_like(x), x)),
        ("all_reduce", lambda x: dist.all_reduce(x)),
        ("all_gather", lambda x: dist.all_gather([torch.empty_like(x) for _ in range(world)], x)))
    for name, fn in collectives:
        try:
            fn(torch.ones(4 * world, device=DEVICE))
            torch.cuda.synchronize()
            probe[name] = "takes CUDA tensors"
        except Exception as e:   # the answer, not a failure: gloo's CUDA support
            first = str(e).splitlines()[0][:120]
            probe[name] = f"refuses CUDA tensors ({type(e).__name__}: {first})"
        dist.barrier()
    out["probe"] = probe
    mesh = ct.spatial_mesh(device=DEVICE, backend="gloo")
    for Nf, thetapix in PAR_FLOW_SIMS:
        sim = par_sim(Nf, thetapix)
        phi, f = sim["phi"].to(ct.MAP), sim["f"].to(ct.QU_MAP)
        del sim
        res, numbers = par_flows(torch, mesh, phi, f)
        save(f"flows_{Nf}", res)
        out[f"flows_{Nf}"] = dict(launches=numbers[1], line=par_line(
            f"phase 23: (b) rank {rank}/{world} sharded flows {Nf}^2 P (L, L^H, delta phi)",
            numbers, card, True))
        del phi, f, res
        torch.cuda.empty_cache()
    sim = par_sim(N_MAP)
    ds, phi = sim["ds"], sim["phi"].to(ct.MAP)
    del sim
    t0 = par_reset(torch)
    fw, _ = ct.sharded_wiener_filter(ds, phi, mesh, nsteps=PAR_CG["nsteps"], tol=0.0,
                                     fixed_iters=True)
    wf_numbers = par_read(torch, t0)
    save("wf", ct.gather_spatial(fw, mesh).arr)
    t0 = par_reset(torch)
    res = ct.sharded_MAP_joint(ds, mesh, nsteps=PAR_MAP_STEPS, cg_nsteps=PAR_CG["nsteps"],
                               cg_tol=0.0, cg_fixed_iters=True)
    map_numbers = par_read(torch, t0)
    save("map_phi", ct.gather_spatial(res["phi"], mesh).arr)
    out["map"] = dict(
        line=par_line(f"phase 23: (b) rank {rank}/{world} sharded Wiener filter {N_MAP}^2 P "
                      f"(CG {PAR_CG['nsteps']} fixed)", wf_numbers, card, True),
        line2=par_line(f"phase 23: (b) rank {rank}/{world} sharded_MAP_joint {N_MAP}^2 P, "
                       f"{PAR_MAP_STEPS} steps (CG {PAR_CG['nsteps']} fixed, strict)", map_numbers,
                       card, True),
        launches=map_numbers[1], history=[(float(h["logpdf"]), float(h["alpha"]))
                                          for h in res["history"]])
    return out


def par_rank_ensemble(torch, rank, world, card, save):
    """Phase 23 (c), one rank of `world` sharing the card over gloo:
    BASELINE.json configs[4]'s ensembles split over the ranks with mesh=:
    MUSE (phase 20's settings), one sample_joint pass at 512^2 P x 32 sims
    (phase 19's settings, the pass always accepted as phase 19 (c)'s),
    PAR_MARG_STEPS MAP_marg steps at 256^2 P x 16 sims (phase 20's)."""
    import cmblensing_tpu_torch as ct
    out = {}
    mesh = ct.make_mesh(device=DEVICE, backend="gloo")
    ds, _, _ = muse_dataset(torch)
    t0 = par_reset(torch)
    res = par_muse(torch, ds, mesh)
    numbers = par_read(torch, t0)
    out["muse"] = dict(res, launches=numbers[1], line=par_line(
        f"phase 23: (c) rank {rank}/{world} muse(mesh=) {N_MUSE}^2 P x {MUSE_SIMS} sims "
        f"({MUSE_SIMS // world} a rank)", numbers, card, True))
    del ds
    ds = par_sim(N_SAMPLE, Nbatch=SAMPLE_SIMS)["ds"]
    t0 = par_reset(torch)
    e = par_sample(torch, ds, mesh)
    numbers = par_read(torch, t0)
    save("sample", {k: e[k] for k in ("f", "phi", "logpdf", "accept", "dH")})
    out["sample"] = dict(launches=numbers[1], line=par_line(
        f"phase 23: (c) rank {rank}/{world} sample_joint(mesh=) one pass {N_SAMPLE}^2 P x "
        f"{SAMPLE_SIMS} sims (N {SAMPLE_SYMP[0]['N']}, eps {SAMPLE_SYMP[0]['eps']}, CG 25 "
        "fixed, always accepted)", numbers, card, True))
    del ds, e
    torch.cuda.empty_cache()
    ds = par_marg_ds()
    t0 = par_reset(torch)
    phi, gn, phi1 = par_marg(torch, ds, mesh)
    numbers = par_read(torch, t0)
    save("marg", (phi.arr, phi1.arr))
    out["marg"] = dict(launches=numbers[1], gradnorm=gn, line=par_line(
        f"phase 23: (c) rank {rank}/{world} MAP_marg(mesh=) {PAR_MARG_STEPS} steps {N_MUSE}^2 P x "
        f"{MARG_SIMS} sims", numbers, card, True))
    return out


def par_muse(torch, ds, mesh=None):
    """Phase 20's MUSE run (mesh=None: unsharded): theta, pulls, and each
    step's theta, s_data and sbar."""
    import cmblensing_tpu_torch as ct
    g = torch.Generator(device=DEVICE)
    g.manual_seed(3)
    res = ct.muse(ds, dict(Aphi_b=np.ones(MUSE_BINS)), nsims=MUSE_SIMS, nsteps=MUSE_STEPS,
                  generator=g, MAP_kwargs=MUSE_MAP, mesh=mesh)
    return par_muse_numbers(res)


def par_muse_numbers(res):
    A = np.asarray(res["theta"]["Aphi_b"])
    sig = np.sqrt(np.abs(np.diag(np.asarray(res["Sigma"]))))
    return dict(theta=A.tolist(), pulls=((A - MUSE_TRUTH) / sig).tolist(),
                steps=[dict(theta=np.asarray(h["theta"]["Aphi_b"]).tolist(),
                            s_data=np.asarray(h["s_data"]).tolist(),
                            sbar=np.asarray(h["sbar"]).tolist(), H=np.asarray(h["H"]).tolist())
                       for h in res["history"]])


def par_sample(torch, ds, mesh=None):
    """One sample_joint pass at phase 19's settings, always accepted, as
    phase 19 (c) holds the kernel backend to the plain one: the chain's
    entry."""
    import cmblensing_tpu_torch as ct
    g = torch.Generator(device=DEVICE)
    g.manual_seed(1)
    c = ct.sample_joint(ds, 1, nchains=SAMPLE_SIMS, generator=g, symp_kwargs=SAMPLE_SYMP,
                        nburnin_always_accept=1, conjgrad_kwargs=SAMPLE_CG, mesh=mesh)
    return par_sample_entry(c[0][0])


def par_sample_entry(e):
    m = lambda x: x.to(x.basis.with_space("map")).arr.cpu()
    return dict(f=m(e["f"]), phi=m(e["phi"]), logpdf=e["logpdf"].cpu(), accept=e["accept"].cpu(),
                dH=e["dH"].cpu())


def par_marg_ds():
    sim = par_sim(N_MUSE, 3)
    return sim["ds"].replace(d=sim["ds"].d.to(sim["ds"].d.basis.with_space("map")))


def par_marg(torch, ds, mesh=None):
    import cmblensing_tpu_torch as ct
    g = torch.Generator(device=DEVICE)
    g.manual_seed(1)
    phi, hist = ct.MAP_marg(ds, generator=g, nsteps=PAR_MARG_STEPS, Nsims=MARG_SIMS,
                            nsteps_with_meanfield_update=MARG_MF_STEPS, conjgrad_kwargs=MARG_CG,
                            alpha=MARG_ALPHA, mesh=mesh)
    return phi, [h["gradnorm"] for h in hist], hist[0]["phi"]


# The witness of phase 23 (c): each ensemble's first step (a whole pass
# for sample_joint) unsharded, in this process, with the ensemble in
# PAR_RANKS batches of a rank's size: each batch runs on its entries of
# the whole ensemble's draws, as a rank does, and the batches' results
# are joined as the ranks' are; only the collectives are missing.

def par_batches(total):
    k = total // PAR_RANKS
    return [slice(lo, lo + k) for lo in range(0, total, k)]


def par_halves_muse(torch, ds):
    """Step 1 of par_muse's run: the per-sim scores at theta0 and H by
    muse's forward differences, each batched MAP_joint and theta-score
    run on one batch of the sims."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.inference import muse as tmu
    theta = dict(Aphi_b=np.ones(MUSE_BINS))
    spec = tmu._theta_spec(theta)
    tflat = tmu._spec_pack(theta, spec)
    eps = 0.1 * np.maximum(np.abs(tflat), 0.1)     # muse's default step at theta0
    tvec = tmu._theta_vec(theta, spec, DEVICE)
    kw = dict(MUSE_MAP)
    g = torch.Generator(device=DEVICE)
    g.manual_seed(3)
    state = g.get_state()

    def scores(theta_sim):
        with torch.no_grad():
            d = tmu._simulate_sims(ds, theta_sim, 0, MUSE_SIMS, g, state)
        out = []
        for b in par_batches(MUSE_SIMS):
            dsd = ds.replace(d=ct.Field(d.arr[b], d.basis, d.proj))
            res = ct.MAP_joint(dsd, theta=theta, **kw)
            out.append(tmu._theta_score_batch(dsd, res["f"], res["phi"], tvec, spec))
        return torch.cat(out).cpu().numpy()

    s = scores(theta)
    sbar = s.mean(axis=0)
    H = np.zeros((len(tflat), len(tflat)))
    for j in range(len(tflat)):
        tp = tflat.copy()
        tp[j] += eps[j]
        H[:, j] = (scores(dict(Aphi_b=tp)).mean(axis=0) - sbar) / eps[j]
    return dict(s_sims=s, sbar=sbar, H=H)


def par_halves_sample(torch, ds):
    """par_sample's pass: each batch of chains runs sample_joint's default
    pass functions on a state holding its core/shard.py::BatchShard, the
    whole batch's draws sliced to its chains. A first pass simulates at
    the prior phi of every chain, which each batch draws whole: the
    shard's gather hands it over; a reduction across the batches would
    raise (a pass of chains with fixed CG iterations has none)."""
    from cmblensing_tpu_torch.core.shard import BatchShard
    from cmblensing_tpu_torch.inference import sampling as ts

    def no_reduce(t, op):
        raise AssertionError("a reduction across the chains in a pass of independent chains")

    cg = dict(tol=1e-1, nsteps=500)
    cg.update(SAMPLE_CG)
    parts = []
    for b in par_batches(SAMPLE_SIMS):
        g = torch.Generator(device=DEVICE)
        g.manual_seed(1)
        with torch.no_grad():
            phi = ts.simulate_op(g, ts._fid(ds.Cphi), batch_shape=(SAMPLE_SIMS,))
            phi = phi.to(phi.basis.with_space("map"))

        def gather(t, whole=phi.arr, b=b):
            assert torch.equal(t, whole[b])
            return whole

        shard = BatchShard(b.start, b.stop - b.start, SAMPLE_SIMS, no_reduce, gather)
        ds_b = ds.replace(d=shard.slice(ds.d))
        st = dict(generator=g, phi=shard.slice(phi), theta={}, step=1, shard=shard)
        st = ts.gibbs_sample_f(st, ds_b, cg)
        st = ts.gibbs_mix(st, ds_b)
        st = ts.gibbs_sample_phi(st, ds_b, SAMPLE_SYMP, always_accept=True)
        st = ts.gibbs_unmix(st, ds_b)
        parts.append(par_sample_entry(ts.gibbs_postprocess(st, ds_b)))
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def par_halves_marg(torch, ds):
    """Step 1 of par_marg's run: the data's gradient as MAP_marg takes it,
    the mean field from the whole ensemble's simulations, each batch's
    Wiener filters and gradients on its sims, the batches' sums added
    (a rank's sum and the all_reduce), and MAP_marg's update."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.core.field import repeat_batch
    from cmblensing_tpu_torch.inference import maximization as tm
    g = torch.Generator(device=DEVICE)
    g.manual_seed(1)
    dst = ds.at({}).replace(G=ct.Id)
    phi = tm._zero_map_like(tm._fid(dst.Cphi))
    cg = dict(tol=1e-1, nsteps=500)
    cg.update(MARG_CG)

    def grad(phi_, f_, d_):
        with tm._pctx("high"):                      # MAP_marg's precision "auto"
            return tm._phi_gradient(dst, {}, phi_, f_, d_)

    f_wf, _ = ct.argmaxf_logpdf(dst, phi=phi, theta={}, conjgrad_kwargs=cg)
    g_data = grad(phi, f_wf, dst.d)
    with torch.no_grad():
        d_sims = tm._marg_simulate_d(dst, {}, repeat_batch(phi, MARG_SIMS), g, 0)
    total = None
    for b in par_batches(MARG_SIMS):
        d_b = ct.Field(d_sims.arr[b], d_sims.basis, d_sims.proj)
        phi_b = repeat_batch(phi, b.stop - b.start)
        f_b, _ = ct.argmaxf_logpdf(dst.replace(d=d_b), phi=phi_b, theta={}, conjgrad_kwargs=cg)
        s = torch.sum(grad(phi_b, f_b, d_b).arr, dim=0)
        total = s if total is None else total + s
    gbar = ct.Field(total / MARG_SIMS, g_data.basis, g_data.proj)
    with torch.no_grad():
        phi1, _ = tm._marg_update(dst, {}, phi, g_data, gbar, MARG_ALPHA)
    return phi1


def par_rank_main(torch, part, rank, world, port, outdir):
    """A rank of phase 23: `python3 chip_smoke.py --rank23 PART RANK WORLD
    PORT DIR`, started by phase_parallel after the kernels are built: part
    (b) ("spatial") or (c) ("ensemble"), each its own world. Writes its
    numbers to DIR/PART_RANK.json; rank 0 its whole results to DIR/*.pt."""
    import cmblensing_tpu_torch as ct
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.set_num_threads(1)
    ct.distributed_initialize(f"localhost:{port}", world, rank, backend="gloo")
    card = card_line()

    def save(name, obj):
        if rank == 0:
            torch.save(obj, os.path.join(outdir, f"{name}.pt"))

    fn = {"spatial": par_rank_spatial, "ensemble": par_rank_ensemble}[part]
    out = fn(torch, rank, world, card, save)
    with open(os.path.join(outdir, f"{part}_{rank}.json"), "w") as fh:
        json.dump(out, fh)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def par_start(part, world, outdir):
    """Start `world` ranks of phase 23's `part` (par_rank_main), each its
    own process on the card; returns wait(), which joins them (every rank
    stopped at PAR_TIMEOUT or when one fails) and returns their numbers,
    rank by rank."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank23", part,
                               str(r), str(world), str(port), outdir],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]

    def wait():
        try:
            for r, p in enumerate(procs):
                out, _ = p.communicate(timeout=PAR_TIMEOUT)
                if p.returncode != 0:
                    raise AssertionError(f"phase 23: {part} rank {r} failed (rc "
                                         f"{p.returncode}):\n" + out[-6000:])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        results = []
        for r in range(world):
            with open(os.path.join(outdir, f"{part}_{r}.json")) as fh:
                results.append(json.load(fh))
        return results

    return wait


def par_one_rank(torch, card):
    """Phase 23 (a): NCCL at one rank in this process: the 1024^2 P sharded
    flows and delta phi and the sharded Wiener filter against the
    unsharded port on the card, each plane within FLOW_TOL (delta phi
    GRAD_TOL, the Wiener filter PAR_ONE_WF_TOL)."""
    import cmblensing_tpu_torch as ct
    mesh = ct.make_mesh(axis_name="sp", device=DEVICE)
    sim = par_sim(N_MAP)
    ds, phi, f = sim["ds"], sim["phi"].to(ct.MAP), sim["f"].to(ct.QU_MAP)
    par_flows(torch, mesh, phi, f)            # warm-up: first launches, cuFFT plans
    (Lf, LHf, g), numbers = par_flows(torch, mesh, phi, f)
    par_flows_ref(torch, phi, f)
    t0 = par_reset(torch)
    ref = par_flows_ref(torch, phi, f)
    ref_s = par_read(torch, t0)[0]
    errs = {"L": par_rel_planes(Lf, ref[0]), "L^H": par_rel_planes(LHf, ref[1]),
            "dphi": rel(g, ref[2])}
    t0 = par_reset(torch)
    fw, _ = ct.sharded_wiener_filter(ds, phi, mesh, nsteps=PAR_CG["nsteps"], tol=0.0,
                                     fixed_iters=True)
    wf_numbers = par_read(torch, t0)
    fr, _ = ct.argmaxf_logpdf(ds, phi=phi, conjgrad_kwargs=dict(PAR_CG, hessian_precision=None))
    errs["wf"] = par_rel_planes(fw.arr, fr.to(ct.QU_MAP).arr)
    print(par_line(f"phase 23: (a) sharded flows {N_MAP}^2 P (L, L^H, delta phi, warm; the "
                   f"unsharded kernel path {ref_s:.3f} s)", numbers, card, False))
    print(par_line(f"phase 23: (a) sharded Wiener filter {N_MAP}^2 P (CG {PAR_CG['nsteps']} "
                   "fixed)", wf_numbers, card, False))
    print(f"phase 23: (a) against the unsharded port: " + ", ".join(f"{k} {v:.3e}"
                                                                   for k, v in errs.items())
          + f" (bounds {FLOW_TOL:g} flows each plane, {GRAD_TOL:g} delta phi, {PAR_ONE_WF_TOL:g} "
          f"Wiener filter each plane) [{card}]")
    bad = {} if (errs["L"] < FLOW_TOL and errs["L^H"] < FLOW_TOL and errs["dphi"] < GRAD_TOL
                 and errs["wf"] < PAR_ONE_WF_TOL) else {"one rank": errs}
    return numbers[1], wf_numbers[1], bad


def par_float64_map(torch, ds):
    """PAR_MAP_STEPS strict MAP_joint steps of ds at float64, on the plain
    backend (the kernels are float32): its operators at theta = {} and its
    data carried to a float64 dataset (dataset_from_numpy)."""
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.models import dataset as tdsm
    ds0 = ds.at({})
    wide = lambda a: (a.to(torch.complex128) if a.is_complex() else a.double()).cpu().numpy()
    arrays = {"d": (wide(ds0.d.arr), ds0.d.basis.pol, ds0.d.basis.space)}
    for name in tdsm.DIAG_OPS:
        op = getattr(ds0, name)
        if isinstance(op, ct.Diag):
            arrays[name] = (wide(op.diag.arr), op.diag.basis.pol, op.diag.basis.space)
    p = ds0.d.proj
    ds64 = ct.dataset_from_numpy(arrays, dict(Ny=p.Ny, Nx=p.Nx, thetapix=p.thetapix,
                                              T=np.float64), device=DEVICE)
    with ct.lenseflow_backend_ctx("plain"):
        r = ct.MAP_joint(ds64, nsteps=PAR_MAP_STEPS, precision=None,
                         conjgrad_kwargs=dict(PAR_CG, hessian_precision=None),
                         history_keys=("logpdf", "alpha"))
    return r["phi"].to(ct.MAP).arr, [(float(h["logpdf"]), float(h["alpha"]))
                                     for h in r["history"]]


def par_refs(torch, card, muse_ref):
    """The unsharded references of parts (b) and (c), and (c)'s witness
    (par_halves_*), computed in this process while the ranks run."""
    import cmblensing_tpu_torch as ct
    refs = {}
    t0 = time.perf_counter()
    for Nf, thetapix in PAR_FLOW_SIMS:
        sim = par_sim(Nf, thetapix)
        refs[f"flows_{Nf}"] = par_flows_ref(torch, sim["phi"].to(ct.MAP), sim["f"].to(ct.QU_MAP))
        del sim
    sim = par_sim(N_MAP)
    ds, phi = sim["ds"], sim["phi"].to(ct.MAP)
    cg = dict(PAR_CG, hessian_precision=None)
    refs["wf"] = ct.argmaxf_logpdf(ds, phi=phi, conjgrad_kwargs=cg)[0].to(ct.QU_MAP).arr
    r = ct.MAP_joint(ds, nsteps=PAR_MAP_STEPS, precision=None, conjgrad_kwargs=cg,
                     history_keys=("logpdf", "alpha"))
    refs["map"] = (r["phi"].to(ct.MAP).arr,
                   [(float(h["logpdf"]), float(h["alpha"])) for h in r["history"]])
    refs["map64"] = par_float64_map(torch, ds)
    del sim, ds, phi, r
    torch.cuda.empty_cache()
    ds, _, _ = muse_dataset(torch)
    if muse_ref is None:
        muse_ref, refs["muse_whence"] = par_muse(torch, ds), "computed here"
    else:
        refs["muse_whence"] = "phase 20's run"
    refs["muse"] = muse_ref
    refs["halves_muse"] = par_halves_muse(torch, ds)
    ds = par_sim(N_SAMPLE, Nbatch=SAMPLE_SIMS)["ds"]
    refs["sample"] = par_sample(torch, ds)
    refs["halves_sample"] = par_halves_sample(torch, ds)
    del ds
    ds = par_marg_ds()
    refs["marg"] = par_marg(torch, ds)
    refs["halves_marg"] = par_halves_marg(torch, ds)
    torch.cuda.synchronize()
    refs["s"] = time.perf_counter() - t0
    return refs


def par_check(torch, card, refs, ranks, outdir):
    """Parts (b) and (c): the ranks' results against the references;
    returns {what: numbers} of the checks that fail."""
    load = lambda name: torch.load(os.path.join(outdir, f"{name}.pt"))
    bad = {}
    r0 = ranks[0]
    print(f"phase 23: (b) gloo with CUDA tensors: {r0['spatial']['probe']}")
    for r in ranks:
        sp, en = r["spatial"], r["ensemble"]
        for key in [f"flows_{n}" for n, _ in PAR_FLOW_SIMS]:
            print(sp[key]["line"])
        print(sp["map"]["line"])
        print(sp["map"]["line2"])
        for key in ("muse", "sample", "marg"):
            print(en[key]["line"])
    for Nf, _ in PAR_FLOW_SIMS:
        (Lf, LHf, g), ref = load(f"flows_{Nf}"), refs[f"flows_{Nf}"]
        errs = {"L": par_rel_planes(Lf, ref[0]), "L^H": par_rel_planes(LHf, ref[1]),
                "dphi": rel(g, ref[2])}
        print(f"phase 23: (b) {Nf}^2 P flows, {PAR_RANKS} ranks against the unsharded kernel path: "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (bounds {FLOW_TOL:g} flows each plane, {GRAD_TOL:g} delta phi) [{card}]")
        if not (errs["L"] < FLOW_TOL and errs["L^H"] < FLOW_TOL and errs["dphi"] < GRAD_TOL):
            bad[f"flows_{Nf}"] = errs
    e_wf = par_rel_planes(load("wf"), refs["wf"])
    phi_sh, hist = load("map_phi"), r0["spatial"]["map"]["history"]
    (phi_un, rhist), (phi64, hist64) = refs["map"], refs["map64"]
    e_phi, e_sh64, e_un64 = par_l2(phi_sh, phi_un), par_l2(phi_sh, phi64), par_l2(phi_un, phi64)
    lps = [h[0] for h in hist]
    d_lp = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(hist, rhist))
    same_alpha = all(a[1] == b[1] for a, b in zip(hist, rhist))
    print(f"phase 23: (b) {N_MAP}^2 P, {PAR_RANKS} ranks against the unsharded port: Wiener filter "
          f"{e_wf:.3e} (bound {PAR_WF_TOL:g}); sharded_MAP_joint (logpdf, alpha) {hist} vs "
          f"MAP_joint {rhist}: logpdf {d_lp:.3e} (bound {STEP_TOL:g}), the same alphas "
          f"{same_alpha}; phi {e_phi:.3e} relative L2 (bound {PAR_MAP_UN_TOL:g}; the JAX "
          f"package's {PAR_MAP_TOL:g}, not held); against MAP_joint in float64 on the plain "
          f"backend {hist64}: sharded {e_sh64:.3e}, unsharded {e_un64:.3e} (printed) [{card}]")
    if not (e_wf < PAR_WF_TOL and d_lp < STEP_TOL and same_alpha and np.all(np.isfinite(lps))
            and all(b >= a for a, b in zip(lps, lps[1:])) and e_phi < PAR_MAP_UN_TOL):
        bad["map"] = (e_wf, d_lp, same_alpha, hist, rhist, e_phi, e_sh64, e_un64)
    # (c): each ensemble against the one-batch run and the batches (the witness)
    rl = lambda x, y: float(np.max(np.abs(np.subtract(x, y))) / np.max(np.abs(y)))
    mu, ref, hv = r0["ensemble"]["muse"], refs["muse"], refs["halves_muse"]
    s1, rs1 = mu["steps"][0], ref["steps"][0]
    errs = {f"step 1 {k}": rl(s1[k], rs1[k]) for k in ("s_data", "sbar")}
    wit = {k: (rl(s1[k], hv[k]), rl(hv[k], rs1[k]), rl(s1[k], rs1[k])) for k in ("sbar", "H")}
    H1 = np.asarray(rs1["H"])
    dtheta = lambda s: np.linalg.solve(np.asarray(s["H"]), np.subtract(s["s_data"], s["sbar"]))
    pulls = np.asarray(mu["pulls"])
    print(f"phase 23: (c) muse(mesh=) against the one-batch run ({refs['muse_whence']}): "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f" (bound {PAR_ENS_TOL:g}); "
          "step 1 (sharded vs batches, bound " f"{PAR_HALVES_TOL:g}; batches vs one batch; "
          "sharded vs one batch): " + ", ".join(f"{k} {a:.3e}, {b:.3e}, {c:.3e}"
                                                for k, (a, b, c) in wit.items())
          + f"; cond(H) {np.linalg.cond(H1):.3e}, Newton step H^-1 (s_data - sbar) "
          f"{dtheta(s1).tolist()} vs {dtheta(rs1).tolist()} (capped at 0.5 max(|theta|, 0.1) "
          f"an entry); theta by step {[s['theta'] for s in mu['steps']]} vs "
          f"{[s['theta'] for s in ref['steps']]}; pulls {mu['pulls']} vs {ref['pulls']} (each "
          f"under {MUSE_PULL_MAX:g}) [{card}]")
    if not (max(errs.values()) < PAR_ENS_TOL and max(w[0] for w in wit.values()) < PAR_HALVES_TOL
            and np.all(np.isfinite(pulls)) and np.all(np.abs(pulls) < MUSE_PULL_MAX)):
        bad["muse"] = (errs, wit, mu["pulls"])
    e, r, hv = load("sample"), refs["sample"], refs["halves_sample"]
    # phase 19 (c)'s measure: max-abs over every sim, relative to the largest
    keys = ("f", "phi", "logpdf")
    wit = {k: (rel(e[k], hv[k]), rel(hv[k], r[k]), rel(e[k], r[k])) for k in keys}
    dh = (float((e["dH"] - hv["dH"]).abs().max()), float((hv["dH"] - r["dH"]).abs().max()),
          float((e["dH"] - r["dH"]).abs().max()))
    same = bool(torch.equal(e["accept"], hv["accept"]) and torch.equal(e["accept"], r["accept"]))
    print(f"phase 23: (c) sample_joint(mesh=) one pass, seed 1 (sharded vs batches, bound "
          f"{PAR_HALVES_TOL:g}; batches vs one batch; sharded vs one batch, the issue's "
          f"{PAR_ENS_TOL:g} printed): " + ", ".join(f"{k} {a:.3e}, {b:.3e}, {c:.3e}"
                                                   for k, (a, b, c) in wit.items())
          + f"; dH {dh[0]:.3e}, {dh[1]:.3f}, {dh[2]:.3f} (absolute); the same accepts {same} "
          f"[{card}]")
    if not (max(w[0] for w in wit.values()) < PAR_HALVES_TOL and dh[0] < PAR_HALVES_TOL and same):
        bad["sample"] = (wit, dh, same)
    (phi_m, phi1_m), gn = load("marg"), r0["ensemble"]["marg"]["gradnorm"]
    rphi_m, rgn, rphi1_m = refs["marg"]
    hphi1 = refs["halves_marg"].arr
    e_m = rel(phi_m, rphi_m.arr)
    w1 = (rel(phi1_m, hphi1), rel(hphi1, rphi1_m.arr), rel(phi1_m, rphi1_m.arr))
    print(f"phase 23: (c) MAP_marg(mesh=) against the one-batch run (seed 1): phi {e_m:.3e} "
          f"(bound {PAR_MARG_TOL:g}); step 1's phi (sharded vs batches, bound {PAR_HALVES_TOL:g}; "
          f"batches vs one batch; sharded vs one batch) {w1[0]:.3e}, {w1[1]:.3e}, {w1[2]:.3e}; "
          f"gradient norms {gn} vs {rgn} [{card}]")
    if not (e_m < PAR_MARG_TOL and w1[0] < PAR_HALVES_TOL and np.all(np.isfinite(gn))):
        bad["marg"] = (e_m, w1)
    return bad


def phase_parallel(torch, card, muse_ref=None):
    """Phase 23: the parallel layer. (a) NCCL at one rank (par_one_rank);
    then two worlds of PAR_RANKS ranks sharing the card over gloo at once,
    processes of this script started after the build (the build directory
    is shared): (b) the spatial sharding at full size (par_rank_spatial),
    (c) BASELINE.json configs[4]'s ensembles with mesh= (par_rank_ensemble);
    this process computes the unsharded references meanwhile (par_refs;
    MUSE's is phase 20's run in a whole run) and holds the ranks' results
    to them (par_check). Returns ({path: launches}, timings)."""
    import tempfile
    t_start = time.perf_counter()
    launches = {}
    launches["one_rank_flows_1024"], launches["one_rank_wf_1024"], bad = par_one_rank(torch, card)
    s_a = time.perf_counter() - t_start
    print(f"phase 23: (a) {s_a:.1f} s [{card}]", flush=True)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as outdir:
        t0 = time.perf_counter()
        # (b) and (c) each its own world of PAR_RANKS ranks, at once: (b)
        # waits on gloo's host-staged transposes, (c) on the card
        waits = [par_start(part, PAR_RANKS, outdir) for part in ("spatial", "ensemble")]
        refs = par_refs(torch, card, muse_ref)
        print(f"phase 23: the unsharded references {refs['s']:.1f} s, beside the ranks [{card}]",
              flush=True)
        spatial, ensemble = (w() for w in waits)
        ranks = [dict(spatial=s, ensemble=e) for s, e in zip(spatial, ensemble)]
        s_bc = time.perf_counter() - t0
        torch.cuda.empty_cache()
        bad.update(par_check(torch, card, refs, ranks, outdir))
    print(f"phase 23: (b) and (c) {s_bc:.1f} s, the ranks' start included [{card}]")
    sp, en = ranks[0]["spatial"], ranks[0]["ensemble"]
    launches["sharded_flows_4096_rank0"] = sp[f"flows_{PAR_FLOW_N}"]["launches"]
    launches["sharded_flows_256_rank0"] = sp[f"flows_{N}"]["launches"]
    launches["sharded_MAP_joint_1024_rank0"] = sp["map"]["launches"]
    launches["muse_mesh_256x8_rank0"] = en["muse"]["launches"]
    launches["sample_joint_mesh_512x32_rank0"] = en["sample"]["launches"]
    launches["MAP_marg_mesh_256x16_rank0"] = en["marg"]["launches"]
    for path, kernels in PAR_PATH_KERNELS.items():
        never = [k for k in kernels if not launches[path].get(k)]
        if never:
            bad[f"{path} never launched"] = never
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()   # (a)'s world of one rank
    wall = time.perf_counter() - t_start
    print(f"phase 23: wall time {wall:.1f} s (budget {PAR_BUDGET_S} s alone after the build"
          f"{', a miss' if wall > PAR_BUDGET_S else ''}) [{card}]")
    if bad:
        raise AssertionError(f"phase 23 failed: {bad}")
    return launches, {"phase23_s": wall, "phase23_a_s": s_a, "phase23_bc_s": s_bc}


def print_ptxas(log):
    """Phase 1: the build log's register lines and errors, and for the
    kernels on the cluster tile (fderiv_sm90.cu, fa_sm90.cu, bv_sm90.cu,
    uni_sm90.cu) and K5 on fact_tile (uni.cu) each instantiation's radix,
    axis and tier, for the whole-flow kernel (dense_flow.cu) its kind,
    tier and edge guards, with its registers, stack and spills."""
    import re
    kernel = None
    for line in log.splitlines():
        line = line.strip()
        if line.startswith("[") and line.endswith("]"):
            continue
        m = re.search(r"(uni_kernel|fderiv_sm90_kernel|fa_sm90_kernel|bv_sm90_kernel|uni_sm90_kernel)ILi(\d+)ELi(\d)ELi(\d)E", line)
        mf = re.search(r"flow_kernelILi(\d)ELi(\d)ELb(\d)E", line)
        if "Compiling entry function" in line:
            kernel = ("{}<B={}, AXIS={}, TIER={}>".format(*m.groups()) if m else
                      "flow_kernel<KIND={}, TIER={}, EDGE={}>".format(*mf.groups()) if mf else None)
        elif kernel and ("registers" in line or "spill" in line):
            print(f"phase 1: ptxas: {kernel}: {line.split(':', 1)[-1].strip()}")
        elif "registers" in line or "error" in line.lower():
            print("phase 1: ptxas:", line)


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
    if sys.argv[1:2] == ["--rank23"]:
        part, rank, world, port, outdir = sys.argv[2:7]
        return par_rank_main(torch, part, int(rank), int(world), int(port), outdir)
    import cmblensing_tpu_torch as ct
    from cmblensing_tpu_torch.ops import _build

    card = card_line()
    print(f"phase 1: card {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.load()
    print(f"phase 1: kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    if _build.BUILD_LOG:
        print_ptxas(_build.BUILD_LOG)

    if sys.argv[1:] == ["--phase", "13"]:
        phase_large(torch, card)
        return 0
    if sys.argv[1:] == ["--phase", "14"]:
        phase_bf16(torch, card)
        return 0
    if sys.argv[1:] == ["--phase", "15"]:
        phase_uni_tiers(torch, card)
        return 0
    if sys.argv[1:] == ["--phase", "16"]:
        phase_uni_large(torch, card)
        return 0
    if sys.argv[1:] == ["--phase", "17"]:
        phase_sm90(torch, card)
        return 0
    if sys.argv[1:] == ["--phase", "18"]:
        phase_whole_flow(torch, card)
        return 0
    if sys.argv[1:] == ["--phase", "19"]:
        phase_sample(torch, card)
        return 0
    if sys.argv[1:] == ["--phase", "20"]:
        phase_ensemble(torch, card)
        return 0
    if sys.argv[1:] == ["--phase", "21"]:
        phase_options(torch, card)
        return 0
    if sys.argv[1:] == ["--phase", "22"]:
        phase_curved(torch, card)
        return 0
    if sys.argv[1:] == ["--phase", "23"]:
        phase_parallel(torch, card)
        return 0
    proj = ct.ProjLambert(N, N, thetapix=3, T=np.float32, device=DEVICE)
    kernels, _ = phase_kernels(torch, proj)
    ds, f_mix, phi_mix, launches = phase_slice(torch)
    timing = phase_timing(torch, ds, f_mix, phi_mix, card)
    fkernels, fctx = phase_factored(torch, card)
    gctx, grad_ms, grad_plain_ms = phase_map_gradient(torch, card)
    map_launches, s_step, plain_s_step, gctx["map_hist"] = phase_map(torch, gctx["sim"], card)
    ukernels, uni_launches, uni_grad_ms, uni_s_step = phase_uni(torch, card, fctx, gctx)
    hkernels, high_launches, high_timing = phase_high(torch, card, fctx, gctx)
    phase_edges(torch, card)
    dkernels, dense_high_launches, dense_high_timing = phase_dense_high(torch, card, ds, f_mix,
                                                                        phi_mix, kernels)
    _, wf_timing, wctx = phase_wiener(torch, card)
    large, large_launches, large_timing = phase_large(torch, card)
    beside = {7: (s_step, gctx["map_hist"]), 9: (gctx["map_s_auto"], gctx["map_hist_auto"])}
    bf16, bf16_launches, bf16_timing = phase_bf16(torch, card, gctx, beside, wctx)
    beside.update({8: (gctx["map_s_uni"], gctx["map_hist_uni"]),
                   14: (gctx["map_s_bf16"], gctx["map_hist_bf16"])})
    uni_tiers, uni_tier_launches, uni_tier_timing = phase_uni_tiers(torch, card, fctx, gctx,
                                                                    beside, wctx)
    map_sim = gctx["sim"]
    del fctx, gctx, beside, wctx
    torch.cuda.empty_cache()
    uni_large, uni_large_launches, uni_large_timing = phase_uni_large(torch, card, large_timing)
    sm90, sm90_launches = phase_sm90(torch, card, uni_large)
    flows, flows_batched = phase_whole_flow(torch, card)
    sample_launches, sample_timing = phase_sample(torch, card)
    muse_launches, marg_launches, ens_flows, ens_timing = phase_ensemble(torch, card)
    opt_launches, opt_timing = phase_options(torch, card, map_sim)
    curved_timing = phase_curved(torch, card, map_sim)
    del map_sim
    torch.cuda.empty_cache()
    par_path_launches, par_timing = phase_parallel(torch, card, MUSE_CACHE.get("ref"))

    replaces = {"deriv": "cmblensing_tpu/ops/pallas_lenseflow.py:86",
                "p_planes": "cmblensing_tpu/ops/pallas_lenseflow.py:303",
                "rk4_update": "cmblensing_tpu/ops/pallas_lenseflow.py:371",
                "fderiv": "cmblensing_tpu/ops/pallas_lenseflow.py:249",
                "fa_velocity_forward": "cmblensing_tpu/ops/pallas_lenseflow.py:506",
                "fa_velocity_adjoint": "cmblensing_tpu/ops/pallas_lenseflow.py:506",
                "bv_velocity": "cmblensing_tpu/ops/pallas_lenseflow.py:581"}
    replaces.update({f"uni{form}_role{r}{sfx}": "cmblensing_tpu/ops/pallas_lenseflow.py:734"
                     for form in ("", "_dense") for r in range(4)
                     for sfx in ("", "_high", "_bf16")})
    replaces.update({k: "cmblensing_tpu/ops/pallas_lenseflow.py:225" for k in HIGH_KERNELS})
    replaces["deriv_high"] = "cmblensing_tpu/ops/pallas_lenseflow.py:103"
    replaces.update({k: "cmblensing_tpu/ops/pallas_lenseflow.py:218" for k in BF16_KERNELS})
    replaces["deriv_bf16"] = "cmblensing_tpu/ops/pallas_lenseflow.py:92"
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # K1's 'high' and 'bf16' tiers run csrc/fderiv_sm90.cu
    entry = lambda name, d, src, n: {
        "name": name, "route": "cuda",
        "source": FDERIV_SM90_SRC if name in ("fderiv_high", "fderiv_bf16") else src,
        "replaces": replaces.get(name, "cmblensing_tpu/ops/pallas_lenseflow.py:472"),
        "launches": n, **{k: d[k] for k in keys},
        **({"batched": d["batched"]} if "batched" in d else {})}
    # K1's record is its d_x pass, the function one library call (a @ DxT) computes
    fkernels["fderiv_x"]["batched"] = fkernels["fderiv"]["batched"]
    record = {"kernels": [entry(name, d, "cmblensing_tpu_torch/csrc/lenseflow.cu", launches[name])
                          for name, d in kernels.items()]
              + [entry(name, fkernels[name], "cmblensing_tpu_torch/csrc/lenseflow.cu",
                       map_launches[name]) for name in ("p_planes", "rk4_update")]
              + [entry(name, fkernels[key], FACTORED_SRC,
                       map_launches[name])
                 for name, key in (("fderiv", "fderiv_x"),
                                   ("fa_velocity_forward", "fa_velocity_forward"),
                                   ("fa_velocity_adjoint", "fa_velocity_adjoint"),
                                   ("bv_velocity", "bv_velocity"))]
              + [entry(name, d, "cmblensing_tpu_torch/csrc/uni.cu", uni_launches[name])
                 for name, d in ukernels.items()]
              + [entry(name, hkernels[key], FACTORED_SRC,
                       high_launches[name])
                 for name, key in (("fderiv_high", "fderiv_x"),
                                   ("fa_velocity_forward_high", "fa_velocity_forward"),
                                   ("fa_velocity_adjoint_high", "fa_velocity_adjoint"),
                                   ("bv_velocity_high", "bv_velocity"))]
              + [entry("deriv_high", dkernels["deriv"], "cmblensing_tpu_torch/csrc/lenseflow.cu",
                       dense_high_launches["deriv_high"])]}
    # K2's whole-flow kernel at every tier (phase 18, 256^2 P; "batched":
    # NTRIAL entries in one launch): launches of the dense paths, strict
    # phase 3's, 'high' phase 11's MAP_joint, 'bf16' phase 14's slice
    for tier in ("f32", "high", "bf16"):
        sfx = "" if tier == "f32" else "_" + tier
        for kind in ("forward", "adjoint", "backward"):
            name = f"flow_{kind}{sfx}"
            n = (launches[name] if tier == "f32" else dense_high_launches[name] if tier == "high"
                 else bf16_launches[N, name][1])
            rec = entry(name, flows["256P", tier, kind], DENSE_FLOW_SRC, n)
            rec.update(cold_ms=flows["256P", tier, kind]["cold_ms"],
                       batched={k: flows_batched[tier, kind][k]
                                for k in ("nb", "ms", "cold_ms", "bound_ms")})
            if tier == "bf16":
                rec["path"] = bf16_launches[N, name][0]
            record["kernels"].append(rec)
    # radix 16 and 32 (phase 13): K1's record is its d_x pass, K3's carry
    # their batch-17 runs under "batched"; "path" names the run whose
    # launches each gives
    for (Nl, tier), found in large.items():
        sfx = "_high" if tier == "high" else ""
        for name, key in (("fderiv", "fderiv_x"), ("fa_velocity_forward", "fa_velocity_forward"),
                          ("fa_velocity_adjoint", "fa_velocity_adjoint"),
                          ("bv_velocity", "bv_velocity")):
            d = dict(found[key])
            if f"{key}[{NTRIAL}]" in found:
                d["batched"] = {k: found[f"{key}[{NTRIAL}]"][k]
                                for k in ("nb", "max_abs_err", "rel", "ms", "plain_ms")}
            path, n = large_launches[Nl, tier, name]
            rec = entry(name + sfx, d, FACTORED_SRC, n)
            rec.update(name=f"{name}{sfx}_b{Nl // FA}", path=path)
            record["kernels"].append(rec)
    # the 'bf16' tier (phase 14): K1's record is its d_x pass, K2's its
    # derivative of the slice's three planes; K3's carry their batch-17 runs
    # under "batched"; "path" names the run whose launches each gives
    factored = (("fderiv", "fderiv_x"), ("fa_velocity_forward", "fa_velocity_forward"),
                ("fa_velocity_adjoint", "fa_velocity_adjoint"), ("bv_velocity", "bv_velocity"))
    dense = (("deriv", "deriv"),)
    dense_src = "cmblensing_tpu_torch/csrc/lenseflow.cu"
    for Nl, names, src in ([(N_MAP, factored, FACTORED_SRC), (N, dense, dense_src)]
                           + [(Nl, factored, FACTORED_SRC) for Nl in N_LARGE]):
        for name, key in names:
            d = dict(bf16[Nl, key])
            if (Nl, f"{key}[{NTRIAL}]") in bf16:
                d["batched"] = {k: bf16[Nl, f"{key}[{NTRIAL}]"][k]
                                for k in ("nb", "max_abs_err", "rel", "ms", "plain_ms")}
            path, n = bf16_launches[Nl, name + "_bf16"]
            rec = entry(name + "_bf16", d, src, n)
            rec["path"] = path
            if Nl in N_LARGE:
                rec["name"] = f"{name}_bf16_b{Nl // FA}"
            record["kernels"].append(rec)
    # K5 at 'high' and 'bf16' (factored, 1024^2; "batched": the NTRIAL
    # trials) and dense at every tier (256^2 P) (phase 15); "path" names the
    # run whose launches each gives
    for name, d in uni_tiers.items():
        path, n = uni_tier_launches[name]
        src = "cmblensing_tpu_torch/csrc/" + ("uni_dense.cu" if "dense" in name else "uni.cu")
        rec = entry(name, d, src, n)
        rec["path"] = path
        record["kernels"].append(rec)
    # K5 at radix 16 and 32, every tier (phase 16; "batched": the NTRIAL
    # trials at 2048^2); "path" names the run whose launches each gives
    for name, d in uni_large.items():
        path, n = uni_large_launches[name]
        rec = entry(name.rsplit("_", 1)[0], d, "cmblensing_tpu_torch/csrc/uni.cu", n)
        rec.update(name=name, path=path)
        record["kernels"].append(rec)
    # K1, K3 and K5 at 'high' and 'bf16' on the cluster tile at every radix
    # and K2's 'bf16' derivative (phase 17): one record a kernel and size.
    # Where an earlier phase records the kernel at that size (K1, K3 'high'
    # at 1024^2 in phase 9, 2048^2 and 4096^2 in phase 13; 'bf16' K1, K2, K3
    # in phase 14; K5 in phases 15 and 16), the record keeps the launches of
    # that phase's path and takes phase 17's numbers and source; radix 4
    # (512^2) comes from phase 17 alone, with its path's launches
    for rec in record["kernels"]:
        d = sm90.pop(rec["name"], None)
        if d is not None:
            if "batched" in d:
                rec.pop("batched", None)
            rec.update({k: d[k] for k in keys + ("batched", "source", "form") if k in d})
    for name, d in sm90.items():
        path, n = sm90_launches[name]
        rec = entry(name.rsplit("_b", 1)[0], d, d.get("source", FDERIV_SM90_SRC), n)
        rec.update(name=name, path=path, source=d.get("source", rec["source"]),
                   **({"form": d["form"]} if "form" in d else {}))
        record["kernels"].append(rec)
    # the sampler's run (phase 19): the launches of the strict kernels it runs
    for rec in record["kernels"]:
        if rec["name"] in SAMPLE_KERNELS:
            rec["launches_sample_joint_512x32"] = sample_launches[rec["name"]]
    # the ensemble pipelines (phase 20): K2's launches a MUSE run and a
    # MAP_marg run, and its whole flow timed at the path's MUSE_SIMS entries
    for rec in record["kernels"]:
        name = rec["name"]
        if name in ENSEMBLE_KERNELS or name == "flow_backward":
            rec["launches_muse_256x8"] = muse_launches.get(name, 0)
            rec["launches_MAP_marg_256x16"] = marg_launches.get(name, 0)
        if name in opt_launches:
            rec["launches_MAP_joint_1024_brent"] = opt_launches[name]
        for path, counts in par_path_launches.items():
            if counts.get(name):
                rec[f"launches_parallel_{path}"] = counts[name]
        for (tier, kind), d in ens_flows.items():
            if name == f"flow_{kind}" + ("" if tier == "f32" else "_" + tier):
                rec["ensemble"] = {k: d[k] for k in ("nb", "max_abs_err", "rel", "ms", "plain_ms",
                                                     "bound_ms", "bound_by")}
    timing.update({"gradlnP_1024": (grad_ms, grad_plain_ms),
                   "MAP_joint_1024_s_per_step": (s_step, plain_s_step),
                   "gradlnP_1024_uni": uni_grad_ms, "MAP_joint_1024_uni_s_per_step": uni_s_step,
                   **high_timing, **dense_high_timing, **wf_timing, **large_timing,
                   **bf16_timing, **uni_tier_timing, **uni_large_timing, **sample_timing,
                   **ens_timing, **opt_timing, **curved_timing, **par_timing,
                   **{f"flow_{kind}_{case}_{tier}_ms_warm_cold": (d["ms"], d["cold_ms"])
                      for (case, tier, kind), d in flows.items() if "ms" in d}})
    print("main path ms (kernel, plain):", json.dumps(timing))
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
