// Factored (radix-B) LenseFlow kernels for NVIDIA Hopper (sm_90a), in FP32
// FMA, and at 'high' and 'bf16' on the tensor cores (each entry's `tier`
// argument).
//
// Replaces, from cmblensing_tpu/ops/pallas_lenseflow.py:
//   K1  the factored in-kernel derivative `_fact_apply` / `_make_ddx_ddy_fact`
//       -> the device function fact_tile, and lf_fderiv (out = d_x a + d_y b + c)
//   K3  `_fa_kernel` (launched by `_fa_call`): a forward or adjoint velocity,
//       the role a runtime argument                -> lf_fa_velocity
//   K4  `_bv_kernel` (`_bv_call`, driven by `_bv_flow`): one backward
//       velocity's bundle dfdt = p.grad f_c, ddf = div(p delta f_c),
//       w = sum_c delta f_c grad f_c, then u = M^-1 w and the five hoisted
//       delta-phi integrands (as lf_velocity's backward kind)  -> lf_bv_velocity
//
// Two tiles run them. The cluster tile fact_sm90 (fact_sm90.cuh;
// fderiv_sm90.cu, fa_sm90.cu: one launch a pass at every radix, the
// channel groups the CTAs of a cluster, no atomics) runs K1 at 'high' and
// 'bf16' and K3 wherever it does not run fact_tile; the tiled factored
// derivative `fact_tile` (fact_tile.cuh) runs strict K1, K4 at every tier,
// and K3 strict at radix 4 and 8 and at 'high' at 8
// (lenseflow_common.cuh::k3_on_tile; the host's table,
// ops/lenseflow_kernels.py::FORMS, is the same and is read at every call:
// lf_fa_velocity's `forms`, a bit a pass). fact_tile is instantiated three
// times: FP32 (the JAX package's precision 'f32'), 'high' (its
// `_mk_dot('high')` body, pallas_lenseflow.py:225: bf16 head and residual
// split, three bf16 products a block product, on mma.sync) and 'bf16'
// (`_mk_dot('bf16')`, :218: one bf16 product of the rounded operands). Each entry takes an
// `int tier` (lenseflow_common.cuh::Tier); on fact_tile at 'high' the
// blocks come split ([head, residual] bf16, FactoredOps.FXS / FYTS), at
// 'bf16' as those heads (FXS[0], FYTS[0]), strict in FP32 (FX, FYT); the
// cluster tile takes the FP32 blocks strict and the split ones with their
// rows swizzled (FXW / FYTW) at the reduced tiers.
// The TPU kernels hold whole planes in VMEM. A 1024^2 f32 plane is 4 MiB,
// far beyond a block's 227 KB of shared memory, so here every derivative
// is tiled, and a velocity is two launches: an x pass that stores and a y
// pass that accumulates (strict K1 and K4 at radix 16 and 32, on
// fact_tile, a launch per channel group each; fact_tile.cuh). The grid's
// z axis (the cluster tile's y axis) runs over batch x component (K1, K3)
// or batch (K4), so a
// batched flow (the line search's trials, each with its own phi) is one
// launch per pass.
//
// What bounds it on this card: FP32 FMA. At N = 1024, B = 8 a derivative
// is 14 A x A x N block products (0.47 GFLOP) against 2.1 GFLOP dense, and
// fact_tile's header says what its tiling does about the shared-memory
// load rate, the butterfly recomputation (7 % of the product FMA in
// both passes; it was 29 % in the y pass and 7 % in the x pass of the first
// 16 x 64 tile, which is why that y pass ran 19 % slower) and latency.
// p(t) comes as two ready planes per batch entry (lf_p_planes,
// lenseflow.cu), computed once per distinct time of a flow, so no functor
// here rebuilds it. A 1024^2 plane is 64 tiles per pass: a batch-1 strict
// K1 launch fills half the card's 132 SMs, a two-component K3 launch all of
// them once. A persistent whole-flow kernel is later work.
//
// The fact_tile kernels and their launchers are in factored_kernels.cuh.
// This source instantiates their FP32 tier and holds the C entries;
// factored_high.cu and factored_bf16.cu instantiate K3's (k3_on_tile) and
// K4's 'high' and 'bf16' tiers, so that nvcc builds the sources at once
// (with radix 16 and 32 two tiers in one source took 75 s).
//
// Plain C interface, loaded with ctypes. Every launch goes on the caller's
// stream; each entry point returns the first nonzero cudaGetLastError().

#include "factored_kernels.cuh"

// The launcher of `tier` among a kernel's three (nullptr for another value).
template <class F>
F tier_fn(int tier, F f32, F high, F bf16) {
    return tier == TIER_F32 ? f32 : tier == TIER_HIGH ? high : tier == TIER_BF16 ? bf16 : nullptr;
}

// Once after loading, before any launch: the kernels' dynamic shared memory.
extern "C" int lf_factored_init() {
    int rc = allow_smem_all<TIER_F32>();
    if (rc == 0) rc = lf_high::init();
    return rc != 0 ? rc : lf_bf16::init();
}

namespace lf_sm90 {   // K1 and K3 on the cluster tile (fderiv_sm90.cu, fa_sm90.cu)
int fderiv(int tier, const float* a, const float* b, const float* c, float* out, const void* WX,
           const void* WYT, const float* bfx, const float* bfy, int Bx, int By, int nplanes,
           int Ny, int Nx, void* stream);
int fa_pass(int tier, int axis, int Bv, int role, const float* y, float* k, const float* p,
            const void* W, const float* bf, int nbatch, int ncomp, int Ny, int Nx, void* stream);
}

// The entries: `tier` picks FP32 (0), 'high' (1) or 'bf16' (2). FX and FYT
// are the packed blocks, both transposed (fact_tile.cuh): FP32 (B, A, A),
// at 'high' their bf16 split (2, B, A, A) [head, residual], at 'bf16' the
// heads (B, A, A). lf_fderiv runs fact_tile strict and the cluster tile
// (fderiv_sm90.cu) at 'high' and 'bf16', which takes the split blocks with
// their rows swizzled (FactoredOps.FXW / FYTW, (2, B, A, A); 'bf16' reads
// the heads).
extern "C" int lf_fderiv(int tier, const float* a, const float* b, const float* c, float* out,
                         const void* FX, const void* FYT, const float* bfx, const float* bfy,
                         int Bx, int By, int nplanes, int Ny, int Nx, void* stream) {
    if (tier == TIER_F32)
        return fderiv<TIER_F32>(a, b, c, out, FX, FYT, bfx, bfy, Bx, By, nplanes, Ny, Nx, stream);
    return lf_sm90::fderiv(tier, a, b, c, out, FX, FYT, bfx, bfy, Bx, By, nplanes, Ny, Nx,
                           stream);
}

// K3: each pass on the form that bit `axis` of `forms` names (the host's
// table, ops/lenseflow_kernels.py::FORMS): 0 fact_tile (where k3_on_tile
// puts it; GX / GYT the tier's fact_tile blocks: FX / FYT or their split),
// 1 the cluster tile (fa_sm90.cu, everywhere else; GX / GYT strict FX /
// FYT, at 'high' and 'bf16' the swizzled split FXW / FYTW). A form that is
// not built there is refused. The x pass stores, the y pass adds, in
// stream order; a launch a pass.
extern "C" int lf_fa_velocity(int tier, int forms, int role, const float* y, float* k,
                              const float* p, const void* GX, const void* GYT, const float* bfx,
                              const float* bfy, int Bx, int By, int nbatch, int ncomp, int Ny,
                              int Nx, void* stream) {
    const auto tile = tier_fn(tier, fa_tile<TIER_F32>, lf_high::fa_tile, lf_bf16::fa_tile);
    if (tile == nullptr || !shape_ok(Bx, By, Ny, Nx) || (role != 0 && role != 1) || nbatch < 1 ||
        ncomp < 1 || nbatch * ncomp > 65535 || (forms & ~3))
        return (int)cudaErrorInvalidValue;
    for (int axis = AXIS_X; axis <= AXIS_Y; ++axis) {
        const int Bv = axis == AXIS_X ? Bx : By;
        const void* G = axis == AXIS_X ? GX : GYT;
        const float* bf = axis == AXIS_X ? bfx : bfy;
        const int rc = (forms >> axis & 1)
                           ? lf_sm90::fa_pass(tier, axis, Bv, role, y, k, p, G, bf, nbatch, ncomp,
                                              Ny, Nx, stream)
                           : tile(axis, Bv, role, y, k, p, G, bf, nbatch, ncomp, Ny, Nx, stream);
        if (rc != 0) return rc;
    }
    return 0;
}

extern "C" int lf_bv_velocity(int tier, const float* y, float* k, const float* phi,
                              const float* p, const void* FX, const void* FYT, const float* bfx,
                              const float* bfy, int Bx, int By, int nbatch, int ncomp, int Ny,
                              int Nx, float t, void* stream) {
    const auto fn = tier_fn(tier, bv_velocity<TIER_F32>, lf_high::bv_velocity,
                            lf_bf16::bv_velocity);
    return fn == nullptr ? (int)cudaErrorInvalidValue
                         : fn(y, k, phi, p, FX, FYT, bfx, bfy, Bx, By, nbatch, ncomp, Ny, Nx, t,
                              stream);
}
