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
// pass that accumulates. The grid's z axis runs over batch x component
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
// Plain C interface, loaded with ctypes. Every launch goes on the caller's
// stream; each entry point returns the first nonzero cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

#include "fact_tile.cuh"
#include "lenseflow_common.cuh"

namespace {

constexpr int NACC = 5;   // delta-phi accumulator planes of the backward state

// Where a pass adds onto what an earlier pass (or component) stored, it
// does so with atomicAdd whose result is unused (a RED at the L2): each
// pixel gets exactly one such add per pass, so the sum and its rounding are
// those of a load, add and store, without a load's latency between the
// tile's stores.

// K1: out = D a (+ c), or out += D a, along AXIS over blockIdx.z planes.
// G: the blocks (FP32, or at HIGH their bf16 split; fact_tile.cuh).
template <int B, int AXIS, bool HIGH>
__global__ void __launch_bounds__(tile_threads(B), tile_min_blocks(B))
fderiv_kernel(const float* __restrict__ a, const float* __restrict__ c, float* __restrict__ out,
              const void* __restrict__ G, const float* __restrict__ bf, int Ny, int Nx,
              int accumulate) {
    extern __shared__ __align__(16) float smem[];   // tile_smem_bytes(B, HIGH)
    load_butterflies<B, HIGH>(bf, smem);
    const size_t base = (size_t)blockIdx.z * Ny * Nx;
    const float* ap = a + base;
    const float* cp = c != nullptr ? c + base : nullptr;
    float* op = out + base;
    int m0, o0;
    tile_origin<AXIS>(m0, o0);
    fact_tile<B, AXIS, HIGH>(
        G, smem, m0, o0, Nx, [&](int q) { return ap[q]; },
        [&](int q, float v) {
            if (cp != nullptr) v += cp[q];
            if (accumulate) atomicAdd(op + q, v);
            else op[q] = v;
        });
}

// K3: one pass of a forward (role 0: p . grad y, p multiplied after the
// derivative) or adjoint (role 1: div(p y), p multiplied before) velocity.
// The x pass stores p_x d_x y (or d_x(p_x y)), the y pass adds the y term.
// blockIdx.z = batch * ncomp + component; p holds the planes (p_x, p_y) of
// every batch entry, (2, nbatch, Ny, Nx).
template <int B, int AXIS, bool HIGH>
__global__ void __launch_bounds__(tile_threads(B), tile_min_blocks(B))
fa_kernel(const float* __restrict__ y, float* __restrict__ k, const float* __restrict__ p,
          const void* __restrict__ G, const float* __restrict__ bf, int ncomp, int nbatch,
          int Ny, int Nx, int role) {
    extern __shared__ __align__(16) float smem[];   // tile_smem_bytes(B, HIGH)
    load_butterflies<B, HIGH>(bf, smem);
    const size_t plane = (size_t)Ny * Nx;
    const float* yp = y + blockIdx.z * plane;
    float* kp = k + blockIdx.z * plane;
    // p along this axis
    const float* pa = p + ((size_t)(AXIS == AXIS_X ? 0 : nbatch) + blockIdx.z / ncomp) * plane;
    int m0, o0;
    tile_origin<AXIS>(m0, o0);
    fact_tile<B, AXIS, HIGH>(
        G, smem, m0, o0, Nx, [&](int q) { return role != 0 ? pa[q] * yp[q] : yp[q]; },
        [&](int q, float v) {
            if (role == 0) v *= pa[q];
            if (AXIS == AXIS_X) kp[q] = v;
            else atomicAdd(kp + q, v);
        });
}

// K4: one pass of the backward velocity over the state
// (f_0.., delta f_0.., 5 accumulators) of batch blockIdx.z. The x pass
// stores p_x d_x f_c, d_x(p_x delta f_c) and w_x (held in the first
// accumulator slot); the y pass adds the y terms, accumulates w_y in the
// second slot and then writes u = M^-1 w and the five integrands. p as K3's;
// M^-1(t) is rebuilt from phi's 5 planes per batch at the output pixels.
template <int B, int AXIS, bool HIGH>
__global__ void __launch_bounds__(tile_threads(B), tile_min_blocks(B))
bv_kernel(const float* __restrict__ y, float* __restrict__ k, const float* __restrict__ phi,
          const float* __restrict__ p, const void* __restrict__ G,
          const float* __restrict__ bf, int ncomp, int nbatch, int Ny, int Nx, float t) {
    extern __shared__ __align__(16) float smem[];   // tile_smem_bytes(B, HIGH)
    load_butterflies<B, HIGH>(bf, smem);
    const size_t plane = (size_t)Ny * Nx;
    const size_t nstate = 2 * ncomp + NACC;
    const float* yb = y + blockIdx.z * nstate * plane;
    float* kb = k + blockIdx.z * nstate * plane;
    const float* pa = p + ((size_t)(AXIS == AXIS_X ? 0 : nbatch) + blockIdx.z) * plane;
    float* w = kb + (2 * ncomp + AXIS) * plane;   // w_x (x pass) or w_y (y pass)
    int m0, o0;
    tile_origin<AXIS>(m0, o0);
    for (int c = 0; c < ncomp; ++c) {
        const float* f = yb + c * plane;
        const float* df = yb + (ncomp + c) * plane;
        float* kf = kb + c * plane;
        float* kdf = kb + (ncomp + c) * plane;
        fact_tile<B, AXIS, HIGH>(
            G, smem, m0, o0, Nx, [&](int q) { return f[q]; },
            [&](int q, float v) {   // v = d f_c
                const float pv = pa[q] * v, dw = df[q] * v;
                if (AXIS == AXIS_X) kf[q] = pv;
                else atomicAdd(kf + q, pv);
                if (c == 0) w[q] = dw;
                else atomicAdd(w + q, dw);
            });
        fact_tile<B, AXIS, HIGH>(
            G, smem, m0, o0, Nx, [&](int q) { return pa[q] * df[q]; },
            [&](int q, float v) {
                if (AXIS == AXIS_X) kdf[q] = v;
                else atomicAdd(kdf + q, v);
            });
    }
    if (AXIS == AXIS_Y) {
        // w is complete at this thread's pixels (its own stores and adds,
        // and the x pass's before this launch); read it where the adds
        // were made, at the L2
        __threadfence();
        const float* ph = phi + (size_t)blockIdx.z * 5 * plane;
        float* acc = kb + 2 * ncomp * plane;
        for (int q = 0; q < tile_pixels(B); ++q)
            for (int r = 0; r < B; ++r) {
                const size_t o = out_offset<B, AXIS>(q, r, m0, o0, Nx);
                dphi_integrands(ph, plane, o, t, __ldcg(acc + o), __ldcg(acc + plane + o), acc);
            }
    }
}

template <int B, bool HIGH>
int allow_smem() {
    int rc = allow_tile_smem(fderiv_kernel<B, AXIS_X, HIGH>, B, HIGH);
    if (rc == 0) rc = allow_tile_smem(fderiv_kernel<B, AXIS_Y, HIGH>, B, HIGH);
    if (rc == 0) rc = allow_tile_smem(fa_kernel<B, AXIS_X, HIGH>, B, HIGH);
    if (rc == 0) rc = allow_tile_smem(fa_kernel<B, AXIS_Y, HIGH>, B, HIGH);
    if (rc == 0) rc = allow_tile_smem(bv_kernel<B, AXIS_X, HIGH>, B, HIGH);
    if (rc == 0) rc = allow_tile_smem(bv_kernel<B, AXIS_Y, HIGH>, B, HIGH);
    return rc;
}

#define LF_TILE_LAUNCH(kernel, AXIS, nz)                                                       \
    kernel<B, AXIS, HIGH><<<pass_grid<AXIS>(Ny, Nx, nz), tile_threads(B),                      \
                            tile_smem_bytes(B, HIGH), st>>>

// out = d_x a + d_y b + c over nplanes planes; a or b (not both) and c may
// be null; out must not alias a or b. One launch per non-null derivative.
template <bool HIGH>
int fderiv(const float* a, const float* b, const float* c, float* out, const void* FX,
           const void* FYT, const float* bfx, const float* bfy, int Bx, int By, int nplanes,
           int Ny, int Nx, void* stream) {
    if (!shape_ok(Bx, By, Ny, Nx) || (a == nullptr && b == nullptr))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (a != nullptr) {
        LF_WITH_RADIX(Bx, LF_TILE_LAUNCH(fderiv_kernel, AXIS_X, nplanes)(a, c, out, FX, bfx, Ny,
                                                                         Nx, 0))
        const int rc = (int)cudaGetLastError();
        if (rc != 0) return rc;
    }
    if (b != nullptr) {
        LF_WITH_RADIX(By, LF_TILE_LAUNCH(fderiv_kernel, AXIS_Y, nplanes)(
                              b, a != nullptr ? nullptr : c, out, FYT, bfy, Ny, Nx, a != nullptr))
    }
    return (int)cudaGetLastError();
}

// k <- the forward (role 0) or adjoint (role 1) velocity of the
// (nbatch, ncomp, Ny, Nx) state y under the p(t) planes p, (2, nbatch, Ny,
// Nx). Two launches.
template <bool HIGH>
int fa_velocity(int role, const float* y, float* k, const float* p, const void* FX,
                const void* FYT, const float* bfx, const float* bfy, int Bx, int By, int nbatch,
                int ncomp, int Ny, int Nx, void* stream) {
    if (!shape_ok(Bx, By, Ny, Nx) || (role != 0 && role != 1)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int nz = nbatch * ncomp;
    LF_WITH_RADIX(Bx, LF_TILE_LAUNCH(fa_kernel, AXIS_X, nz)(y, k, p, FX, bfx, ncomp, nbatch, Ny,
                                                            Nx, role))
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    LF_WITH_RADIX(By, LF_TILE_LAUNCH(fa_kernel, AXIS_Y, nz)(y, k, p, FYT, bfy, ncomp, nbatch, Ny,
                                                            Nx, role))
    return (int)cudaGetLastError();
}

// k <- the backward velocity at time t of the (nbatch, 2 ncomp + 5, Ny, Nx)
// state y; phi is (nbatch, 5, Ny, Nx), p its p(t) planes (2, nbatch, Ny,
// Nx). Two launches.
template <bool HIGH>
int bv_velocity(const float* y, float* k, const float* phi, const float* p, const void* FX,
                const void* FYT, const float* bfx, const float* bfy, int Bx, int By, int nbatch,
                int ncomp, int Ny, int Nx, float t, void* stream) {
    if (!shape_ok(Bx, By, Ny, Nx)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    LF_WITH_RADIX(Bx, LF_TILE_LAUNCH(bv_kernel, AXIS_X, nbatch)(y, k, phi, p, FX, bfx, ncomp,
                                                                nbatch, Ny, Nx, t))
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    LF_WITH_RADIX(By, LF_TILE_LAUNCH(bv_kernel, AXIS_Y, nbatch)(y, k, phi, p, FYT, bfy, ncomp,
                                                                nbatch, Ny, Nx, t))
    return (int)cudaGetLastError();
}

}  // namespace

// Once after loading, before any launch: the kernels' dynamic shared memory.
extern "C" int lf_factored_init() {
    int rc = allow_smem<4, false>();
    if (rc == 0) rc = allow_smem<8, false>();
    if (rc == 0) rc = allow_smem<4, true>();
    return rc != 0 ? rc : allow_smem<8, true>();
}

// The entries: high != 0 runs the 'high' tier. FX and FYT are the packed
// blocks, both transposed (fact_tile.cuh): FP32 (B, A, A), or at 'high'
// their bf16 split (2, B, A, A) [head, residual].
extern "C" int lf_fderiv(int high, const float* a, const float* b, const float* c, float* out,
                         const void* FX, const void* FYT, const float* bfx, const float* bfy,
                         int Bx, int By, int nplanes, int Ny, int Nx, void* stream) {
    return (high ? fderiv<true> : fderiv<false>)(a, b, c, out, FX, FYT, bfx, bfy, Bx, By, nplanes,
                                                 Ny, Nx, stream);
}

extern "C" int lf_fa_velocity(int high, int role, const float* y, float* k, const float* p,
                              const void* FX, const void* FYT, const float* bfx,
                              const float* bfy, int Bx, int By, int nbatch, int ncomp, int Ny,
                              int Nx, void* stream) {
    return (high ? fa_velocity<true> : fa_velocity<false>)(role, y, k, p, FX, FYT, bfx, bfy, Bx,
                                                           By, nbatch, ncomp, Ny, Nx, stream);
}

extern "C" int lf_bv_velocity(int high, const float* y, float* k, const float* phi,
                              const float* p, const void* FX, const void* FYT, const float* bfx,
                              const float* bfy, int Bx, int By, int nbatch, int ncomp, int Ny,
                              int Nx, float t, void* stream) {
    return (high ? bv_velocity<true> : bv_velocity<false>)(y, k, phi, p, FX, FYT, bfx, bfy, Bx,
                                                           By, nbatch, ncomp, Ny, Nx, t, stream);
}
