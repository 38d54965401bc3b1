// Factored (radix-B) LenseFlow kernels for NVIDIA Hopper (sm_90a), FP32 FMA.
//
// Replaces, from cmblensing_tpu/ops/pallas_lenseflow.py:
//   K1  the factored in-kernel derivative `_fact_apply` / `_make_ddx_ddy_fact`
//       -> the device function fact_tile, and lf_fderiv (out = d_x a + d_y b + c)
//   K3  `_fa_kernel` (launched by `_fa_call`): a forward or adjoint velocity,
//       role and t as runtime arguments            -> lf_fa_velocity
//   K4  `_bv_kernel` (`_bv_call`, driven by `_bv_flow`): one backward
//       velocity's bundle dfdt = p.grad f_c, ddf = div(p delta f_c),
//       w = sum_c delta f_c grad f_c, then u = M^-1 w and the five hoisted
//       delta-phi integrands (as lf_velocity's backward kind)  -> lf_bv_velocity
//
// Each is built on the tiled factored derivative `fact_tile` (fact_tile.cuh).
// The TPU kernels hold whole planes in VMEM. A 1024^2 f32 plane is 4 MiB,
// far beyond a block's 227 KB of shared memory, so here every derivative
// is tiled, and a velocity is two launches: an x pass that stores and a y
// pass that accumulates. The grid's z axis runs over batch x component
// (K1, K3) or batch (K4), so a batched flow (the line search's trials,
// each with its own phi) is one launch per pass.
//
// What bounds it on this card: FP32 FMA. At N = 1024, B = 8 a derivative
// is 14 A x A x N block products (0.47 GFLOP) against 2.1 GFLOP dense;
// the butterflies are recomputed per tile but cost < 5 % of that. This
// first form reads both FMA operands from shared memory (56 FMA per 32
// shared loads per thread and step); wgmma on a 3xTF32 split and a
// persistent kernel are later work.
//
// Plain C interface, loaded with ctypes. Every launch goes on the caller's
// stream; each entry point returns the first nonzero cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

#include "fact_tile.cuh"
#include "lenseflow_common.cuh"

namespace {

constexpr int NACC = 5;   // delta-phi accumulator planes of the backward state

// K1: out = D a (+ c), or out += D a, along AXIS over blockIdx.z planes.
template <int B, int AXIS>
__global__ void __launch_bounds__(NT)
fderiv_kernel(const float* __restrict__ a, const float* __restrict__ c, float* __restrict__ out,
              const float* __restrict__ G, const float* __restrict__ bf, int Ny, int Nx,
              int accumulate) {
    __shared__ float smem[SLAB_FLOATS + 2 * B * B];
    load_butterflies<B>(bf, smem);
    const size_t base = (size_t)blockIdx.z * Ny * Nx;
    fact_tile<B, AXIS>(
        G, smem, blockIdx.y * TS, blockIdx.x * TW,
        [&](int row, int col) { return a[base + (size_t)row * Nx + col]; },
        [&](int row, int col, float v) {
            const size_t o = base + (size_t)row * Nx + col;
            if (c != nullptr) v += c[o];
            out[o] = accumulate ? out[o] + v : v;
        });
}

// K3: one pass of a forward (role 0: p . grad y, p multiplied after the
// derivative) or adjoint (role 1: div(p y), p multiplied before) velocity.
// The x pass stores p_x d_x y (or d_x(p_x y)), the y pass adds the y term.
// blockIdx.z = batch * ncomp + component; phi holds 5 planes per batch.
template <int B, int AXIS>
__global__ void __launch_bounds__(NT)
fa_kernel(const float* __restrict__ y, float* __restrict__ k, const float* __restrict__ phi,
          const float* __restrict__ G, const float* __restrict__ bf, int ncomp, int Ny, int Nx,
          int role, float t) {
    __shared__ float smem[SLAB_FLOATS + 2 * B * B];
    load_butterflies<B>(bf, smem);
    const size_t plane = (size_t)Ny * Nx;
    const float* yp = y + blockIdx.z * plane;
    float* kp = k + blockIdx.z * plane;
    const float* ph = phi + (size_t)(blockIdx.z / ncomp) * 5 * plane;
    fact_tile<B, AXIS>(
        G, smem, blockIdx.y * TS, blockIdx.x * TW,
        [&](int row, int col) {
            const size_t o = (size_t)row * Nx + col;
            float v = yp[o];
            if (role != 0) {
                float px, py;
                p_of_t(ph, plane, o, t, px, py);
                v *= AXIS == AXIS_X ? px : py;
            }
            return v;
        },
        [&](int row, int col, float v) {
            const size_t o = (size_t)row * Nx + col;
            if (role == 0) {
                float px, py;
                p_of_t(ph, plane, o, t, px, py);
                v *= AXIS == AXIS_X ? px : py;
            }
            kp[o] = AXIS == AXIS_X ? v : kp[o] + v;
        });
}

// K4: one pass of the backward velocity over the state
// (f_0.., delta f_0.., 5 accumulators) of batch blockIdx.z. The x pass
// stores p_x d_x f_c, d_x(p_x delta f_c) and w_x (held in the first
// accumulator slot); the y pass adds the y terms, accumulates w_y in the
// second slot and then writes u = M^-1 w and the five integrands.
template <int B, int AXIS>
__global__ void __launch_bounds__(NT)
bv_kernel(const float* __restrict__ y, float* __restrict__ k, const float* __restrict__ phi,
          const float* __restrict__ G, const float* __restrict__ bf, int ncomp, int Ny, int Nx,
          float t) {
    __shared__ float smem[SLAB_FLOATS + 2 * B * B];
    load_butterflies<B>(bf, smem);
    const size_t plane = (size_t)Ny * Nx;
    const size_t nstate = 2 * ncomp + NACC;
    const float* yb = y + blockIdx.z * nstate * plane;
    float* kb = k + blockIdx.z * nstate * plane;
    const float* ph = phi + (size_t)blockIdx.z * 5 * plane;
    float* w = kb + (2 * ncomp + AXIS) * plane;   // w_x (x pass) or w_y (y pass)
    const int s0 = blockIdx.y * TS, w0 = blockIdx.x * TW;
    for (int c = 0; c < ncomp; ++c) {
        const float* f = yb + c * plane;
        const float* df = yb + (ncomp + c) * plane;
        float* kf = kb + c * plane;
        float* kdf = kb + (ncomp + c) * plane;
        fact_tile<B, AXIS>(
            G, smem, s0, w0, [&](int row, int col) { return f[(size_t)row * Nx + col]; },
            [&](int row, int col, float v) {   // v = d f_c
                const size_t o = (size_t)row * Nx + col;
                float px, py;
                p_of_t(ph, plane, o, t, px, py);
                const float pv = (AXIS == AXIS_X ? px : py) * v;
                kf[o] = AXIS == AXIS_X ? pv : kf[o] + pv;
                const float dw = df[o] * v;
                w[o] = c == 0 ? dw : w[o] + dw;
            });
        fact_tile<B, AXIS>(
            G, smem, s0, w0,
            [&](int row, int col) {
                const size_t o = (size_t)row * Nx + col;
                float px, py;
                p_of_t(ph, plane, o, t, px, py);
                return (AXIS == AXIS_X ? px : py) * df[o];
            },
            [&](int row, int col, float v) {
                const size_t o = (size_t)row * Nx + col;
                kdf[o] = AXIS == AXIS_X ? v : kdf[o] + v;
            });
    }
    if (AXIS == AXIS_Y) {
        // w is complete at this thread's pixels (its own stores, and the
        // x pass's before this launch)
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
            for (int ww = 0; ww < 2; ++ww)
                for (int r = 0; r < B; ++r) {
                    int row, col;
                    out_pixel<AXIS>(r, s, ww, s0, w0, row, col);
                    const size_t o = (size_t)row * Nx + col;
                    float* acc = kb + 2 * ncomp * plane;
                    dphi_integrands(ph, plane, o, t, acc[o], acc[plane + o], acc);
                }
    }
}

}  // namespace

// out = d_x a + d_y b + c over nplanes planes; a or b (not both) and c may
// be null; out must not alias a or b. One launch per non-null derivative.
extern "C" int lf_fderiv(const float* a, const float* b, const float* c, float* out,
                         const float* FX, const float* FY, const float* bfx, const float* bfy,
                         int Bx, int By, int nplanes, int Ny, int Nx, void* stream) {
    if (!shape_ok(Bx, By, Ny, Nx) || (a == nullptr && b == nullptr))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (a != nullptr) {
        LF_WITH_RADIX(Bx, fderiv_kernel<B, AXIS_X><<<pass_grid<AXIS_X>(Ny, Nx, nplanes), BLOCK,
                                                     0, st>>>(a, c, out, FX, bfx, Ny, Nx, 0))
        const int rc = (int)cudaGetLastError();
        if (rc != 0) return rc;
    }
    if (b != nullptr) {
        LF_WITH_RADIX(By, fderiv_kernel<B, AXIS_Y><<<pass_grid<AXIS_Y>(Ny, Nx, nplanes), BLOCK,
                                                     0, st>>>(b, a != nullptr ? nullptr : c,
                                                              out, FY, bfy, Ny, Nx,
                                                              a != nullptr))
    }
    return (int)cudaGetLastError();
}

// k <- the forward (role 0) or adjoint (role 1) velocity at time t of the
// (nbatch, ncomp, Ny, Nx) state y; phi is (nbatch, 5, Ny, Nx). Two launches.
extern "C" int lf_fa_velocity(int role, const float* y, float* k, const float* phi,
                              const float* FX, const float* FY, const float* bfx,
                              const float* bfy, int Bx, int By, int nbatch, int ncomp, int Ny,
                              int Nx, float t, void* stream) {
    if (!shape_ok(Bx, By, Ny, Nx) || (role != 0 && role != 1)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int nz = nbatch * ncomp;
    LF_WITH_RADIX(Bx, fa_kernel<B, AXIS_X><<<pass_grid<AXIS_X>(Ny, Nx, nz), BLOCK, 0, st>>>(
                          y, k, phi, FX, bfx, ncomp, Ny, Nx, role, t))
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    LF_WITH_RADIX(By, fa_kernel<B, AXIS_Y><<<pass_grid<AXIS_Y>(Ny, Nx, nz), BLOCK, 0, st>>>(
                          y, k, phi, FY, bfy, ncomp, Ny, Nx, role, t))
    return (int)cudaGetLastError();
}

// k <- the backward velocity at time t of the (nbatch, 2 ncomp + 5, Ny, Nx)
// state y; phi is (nbatch, 5, Ny, Nx). Two launches.
extern "C" int lf_bv_velocity(const float* y, float* k, const float* phi, const float* FX,
                              const float* FY, const float* bfx, const float* bfy, int Bx,
                              int By, int nbatch, int ncomp, int Ny, int Nx, float t,
                              void* stream) {
    if (!shape_ok(Bx, By, Ny, Nx)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    LF_WITH_RADIX(Bx, bv_kernel<B, AXIS_X><<<pass_grid<AXIS_X>(Ny, Nx, nbatch), BLOCK, 0, st>>>(
                          y, k, phi, FX, bfx, ncomp, Ny, Nx, t))
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    LF_WITH_RADIX(By, bv_kernel<B, AXIS_Y><<<pass_grid<AXIS_Y>(Ny, Nx, nbatch), BLOCK, 0, st>>>(
                          y, k, phi, FY, bfy, ncomp, Ny, Nx, t))
    return (int)cudaGetLastError();
}
