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
// Two tiles run them, each pass on the one ops/lenseflow_kernels.py::FORMS
// names for its kernel, tier and radix (K3's and K4's entries take a
// `forms` argument, a bit a pass; only that form is built,
// lenseflow_common.cuh::k3_on_tile, k4_on_tile). The cluster tile
// fact_sm90 (fact_sm90.cuh; fderiv_sm90.cu, fa_sm90.cu, bv_sm90.cu: one
// launch a pass, the channels split over the CTAs of a cluster, no
// atomics) at every tier at radix 16 and 32, and at 4 and 8 wherever an
// A/B in turns did not measure the tiled factored derivative `fact_tile`
// (fact_tile.cuh; factored_kernels.cuh) more than 2 % faster; K1 at every
// tier and radix (strict it won at 4 and 8, 1.2-1.6x). fact_tile is instantiated
// three times: FP32 (the JAX package's precision 'f32'), 'high' (its
// `_mk_dot('high')` body, pallas_lenseflow.py:225: bf16 head and residual
// split, three bf16 products a block product, on mma.sync) and 'bf16'
// (`_mk_dot('bf16')`, :218: one bf16 product of the rounded operands).
// Each entry takes an `int tier` (lenseflow_common.cuh::Tier); on
// fact_tile at 'high' the blocks come split ([head, residual] bf16,
// FactoredOps.FXS / FYTS), at 'bf16' as those heads (FXS[0], FYTS[0]),
// strict in FP32 (FX, FYT); the cluster tile takes the FP32 blocks strict
// and the split ones with their rows swizzled (FXW / FYTW) at the reduced
// tiers.
// The TPU kernels hold whole planes in VMEM. A 1024^2 f32 plane is 4 MiB,
// far beyond a block's 227 KB of shared memory, so here every derivative
// is tiled, and a velocity is two launches: an x pass that stores and a y
// pass that accumulates. The grid's z axis (the cluster tile's y axis) runs
// over batch x component (K1, K3) or batch (K4, whose cluster tile runs the
// components in turn inside the launch), so a
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
// factored_high.cu and factored_bf16.cu instantiate K3's and K4's 'high'
// and 'bf16' tiers where the table puts them on fact_tile, so that nvcc
// builds the sources at once.
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

namespace lf_sm90 {   // K1, K3 and K4 on the cluster tile (fderiv_sm90.cu, fa_sm90.cu, bv_sm90.cu)
int fderiv_pass(int tier, int axis, int Bv, const float* x, const float* c, float* out,
                const void* W, const float* bf, int nplanes, int Ny, int Nx, int accumulate,
                void* stream);
int fa_pass(int tier, int axis, int Bv, int role, const float* y, float* k, const float* p,
            const void* W, const float* bf, int nbatch, int ncomp, int Ny, int Nx, void* stream);
int bv_pass(int tier, int axis, int Bv, const float* y, float* k, const float* phi, const float* p,
            const void* W, const float* bf, int nbatch, int ncomp, int Ny, int Nx, float t,
            void* stream);
}

// The entries: `tier` picks FP32 (0), 'high' (1) or 'bf16' (2); K3's and
// K4's `forms` the tile of each pass, bit `axis` as the host's table (ops/
// lenseflow_kernels.py::FORMS) names it: 0 fact_tile (GX / GYT the tier's
// fact_tile blocks: FX / FYT, both transposed (fact_tile.cuh), FP32 (B, A,
// A), at 'high' their bf16 split (2, B, A, A) [head, residual], at 'bf16'
// the heads (B, A, A)), 1 the cluster tile (strict FX / FYT, at 'high' and
// 'bf16' the swizzled split FXW / FYTW, whose heads 'bf16' reads). A form
// that is not built there is refused. The x pass stores, the y pass adds,
// in stream order; a launch a pass.

// K1: out = d_x a + d_y b + c over nplanes planes on the cluster tile (GX /
// GYT as that tile takes them); a or b (not both) and c may be null; out
// must not alias a or b.
extern "C" int lf_fderiv(int tier, const float* a, const float* b, const float* c, float* out,
                         const void* GX, const void* GYT, const float* bfx, const float* bfy,
                         int Bx, int By, int nplanes, int Ny, int Nx, void* stream) {
    if (!shape_ok(Bx, By, Ny, Nx) || (a == nullptr && b == nullptr) || nplanes < 1 ||
        nplanes > 65535 || tier < TIER_F32 || tier > TIER_BF16)
        return (int)cudaErrorInvalidValue;
    auto pass = [&](int axis, const float* x, const float* cc, int accumulate) {
        const int Bv = axis == AXIS_X ? Bx : By;
        const void* G = axis == AXIS_X ? GX : GYT;
        const float* bf = axis == AXIS_X ? bfx : bfy;
        return lf_sm90::fderiv_pass(tier, axis, Bv, x, cc, out, G, bf, nplanes, Ny, Nx,
                                    accumulate, stream);
    };
    if (a != nullptr) {
        const int rc = pass(AXIS_X, a, c, 0);
        if (rc != 0 || b == nullptr) return rc;
    }
    return pass(AXIS_Y, b, a != nullptr ? nullptr : c, a != nullptr);
}

// K3: the forward (role 0) or adjoint (role 1) velocity of the (nbatch,
// ncomp, Ny, Nx) state y into k under the p(t) planes p, (2, nbatch, Ny,
// Nx).
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

// K4: k <- the backward velocity at time t of the (nbatch, 2 ncomp + 5, Ny,
// Nx) state y; phi is (nbatch, 5, Ny, Nx), p its p(t) planes (2, nbatch,
// Ny, Nx). The y pass ends by writing u = M^-1 w and the five delta-phi
// integrands.
extern "C" int lf_bv_velocity(int tier, int forms, const float* y, float* k, const float* phi,
                              const float* p, const void* GX, const void* GYT, const float* bfx,
                              const float* bfy, int Bx, int By, int nbatch, int ncomp, int Ny,
                              int Nx, float t, void* stream) {
    const auto tile = tier_fn(tier, bv_tile<TIER_F32>, lf_high::bv_tile, lf_bf16::bv_tile);
    if (tile == nullptr || !shape_ok(Bx, By, Ny, Nx) || nbatch < 1 || nbatch > 65535 ||
        ncomp < 1 || (forms & ~3))
        return (int)cudaErrorInvalidValue;
    for (int axis = AXIS_X; axis <= AXIS_Y; ++axis) {
        const int Bv = axis == AXIS_X ? Bx : By;
        const void* G = axis == AXIS_X ? GX : GYT;
        const float* bf = axis == AXIS_X ? bfx : bfy;
        const int rc = (forms >> axis & 1)
                           ? lf_sm90::bv_pass(tier, axis, Bv, y, k, phi, p, G, bf, nbatch, ncomp,
                                              Ny, Nx, t, stream)
                           : tile(axis, Bv, y, k, phi, p, G, bf, nbatch, ncomp, Ny, Nx, t, stream);
        if (rc != 0) return rc;
    }
    return 0;
}
