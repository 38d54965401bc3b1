// Factored (radix-B) LenseFlow kernels for NVIDIA Hopper (sm_90a), in FP32
// FMA, and at 'high' on the tensor cores (each entry's `high` argument).
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
// Each is built on the tiled factored derivative `fact_tile` (fact_tile.cuh),
// instantiated twice: FP32 (the JAX package's precision 'f32') and 'high'
// (its `_mk_dot('high')` body, pallas_lenseflow.py:225: bf16 head and
// residual split, three bf16 products a block product, on mma.sync). Each
// entry takes an `int high` that picks the instantiation; at 'high' the
// blocks come split ([head, residual] bf16, FactoredOps.FXS / FYTS) where
// the FP32 form takes them in FP32.
// The TPU kernels hold whole planes in VMEM. A 1024^2 f32 plane is 4 MiB,
// far beyond a block's 227 KB of shared memory, so here every derivative
// is tiled, and a velocity is two launches: an x pass that stores and a y
// pass that accumulates (at radix 16 and 32, a launch per channel group
// each; fact_tile.cuh). The grid's z axis runs over batch x component
// (K1, K3) or batch (K4), so a batched flow (the line search's trials,
// each with its own phi) is one launch per pass.
//
// What bounds it on this card: FP32 FMA. At N = 1024, B = 8 a derivative
// is 14 A x A x N block products (0.47 GFLOP) against 2.1 GFLOP dense, and
// fact_tile's header says what its tiling does about the shared-memory
// load rate, the butterfly recomputation (7 % of the product FMA in
// both passes; it was 29 % in the y pass and 7 % in the x pass of the first
// 16 x 64 tile, which is why that y pass ran 19 % slower) and latency.
// p(t) comes as two ready planes per batch entry (lf_p_planes,
// lenseflow.cu), computed once per distinct time of a flow, so no functor
// here rebuilds it. A 1024^2 plane is 64 tiles per pass: a batch-1 K1
// launch fills half the card's 132 SMs, a two-component K3 launch all of
// them once. wgmma with TMA for the 'high' products and a persistent
// whole-flow kernel are later work.
//
// The kernels and their launchers are in factored_kernels.cuh. This source
// instantiates the FP32 tier and holds the C entries; factored_high.cu
// instantiates the 'high' tier, so that nvcc builds the two at once (with
// radix 16 and 32 one source took 75 s).
//
// Plain C interface, loaded with ctypes. Every launch goes on the caller's
// stream; each entry point returns the first nonzero cudaGetLastError().

#include "factored_kernels.cuh"

// Once after loading, before any launch: the kernels' dynamic shared memory.
extern "C" int lf_factored_init() {
    int rc = allow_smem<4, false>();
    if (rc == 0) rc = allow_smem<8, false>();
    if (rc == 0) rc = allow_smem<16, false>();
    if (rc == 0) rc = allow_smem<32, false>();
    return rc != 0 ? rc : lf_high::init();
}

// The entries: high != 0 runs the 'high' tier. FX and FYT are the packed
// blocks, both transposed (fact_tile.cuh): FP32 (B, A, A), or at 'high'
// their bf16 split (2, B, A, A) [head, residual].
extern "C" int lf_fderiv(int high, const float* a, const float* b, const float* c, float* out,
                         const void* FX, const void* FYT, const float* bfx, const float* bfy,
                         int Bx, int By, int nplanes, int Ny, int Nx, void* stream) {
    return (high ? lf_high::fderiv : fderiv<false>)(a, b, c, out, FX, FYT, bfx, bfy, Bx, By,
                                                     nplanes, Ny, Nx, stream);
}

extern "C" int lf_fa_velocity(int high, int role, const float* y, float* k, const float* p,
                              const void* FX, const void* FYT, const float* bfx,
                              const float* bfy, int Bx, int By, int nbatch, int ncomp, int Ny,
                              int Nx, void* stream) {
    return (high ? lf_high::fa_velocity : fa_velocity<false>)(role, y, k, p, FX, FYT, bfx, bfy,
                                                               Bx, By, nbatch, ncomp, Ny, Nx,
                                                               stream);
}

extern "C" int lf_bv_velocity(int high, const float* y, float* k, const float* phi,
                              const float* p, const void* FX, const void* FYT, const float* bfx,
                              const float* bfy, int Bx, int By, int nbatch, int ncomp, int Ny,
                              int Nx, float t, void* stream) {
    return (high ? lf_high::bv_velocity : bv_velocity<false>)(y, k, phi, p, FX, FYT, bfx, bfy,
                                                               Bx, By, nbatch, ncomp, Ny, Nx, t,
                                                               stream);
}
