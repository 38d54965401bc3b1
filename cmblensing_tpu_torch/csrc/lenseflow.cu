// LenseFlow flow kernels for NVIDIA Hopper (sm_90a), FP32 FMA.
//
// Replaces the whole-flow Pallas kernel `_flow_kernel` and its launcher
// `_flow_call` (cmblensing_tpu/ops/pallas_lenseflow.py), together with
// the dense in-kernel derivatives `_make_ddx_ddy` it uses at 256^2. The
// TPU kernel holds a whole RK4 flow in VMEM. A 256^2 f32 plane is
// 256 KiB, more than a block's 227 KB of shared memory, so that scheme
// does not carry over. Here one flow is a host loop of 4*nsteps stages,
// each two launches:
//
//   lf_velocity    one velocity evaluation, templated on the flow kind.
//                  Each block computes one TILE x TILE output tile. It
//                  accumulates the circulant products d_x a = a . Dx^T
//                  and d_y a = Dy . a over k in FP32 FMA, staging tiles
//                  of the operand and the matrix through shared memory,
//                  and rebuilds p(t) (and M^-1(t) for the backward kind)
//                  from the five phi planes at the pixels it touches:
//                    forward   df/dt = p . grad f      p in the epilogue
//                    adjoint   df/dt = div(p f)        p multiplied into
//                                                      the operand at load
//                    backward  the coupled transpose-delta system (below)
//   lf_rk4_update  folds a stage into the RK4 accumulator, in the order
//                  of `_rk4_steps`: acc = y + h/6 k1; s = y + h/2 k1; ...
//                  y = acc + h/6 k4.
//
// and lf_deriv, out = d_x a + d_y b + c, which computes every other
// derivative product of the flows (grad/Hess of phi and the final
// delta-phi), so that no derivative goes through cuBLAS or cuFFT.
//
// Backward kind, delta-phi form. The kernel follows the HOISTED form of
// models/lenseflow.py::_backward_flow_scan_body rather than the per-stage
// form of `_vel_backward`: the state carries, besides (f, delta f), the
// five accumulator planes (u_x, u_y, t p_x u_x, t (p_y u_x + p_x u_y),
// t p_y u_y), whose velocity is their integrand, and delta-phi is applied
// once after the flow, d_x(u_x + d_x s_xx + d_y s_xy) + d_y(u_y + d_y s_yy),
// in three lf_deriv launches. The per-stage form needs derivatives of u,
// which is built from derivatives of f: every stage would need a second
// grid-wide pass. Hoisted, each stage is one velocity launch and does 4
// derivative products per component instead of 4 per component + 6. Both
// forms agree up to f32 summation order (the JAX package's
// tests/test_deriv.py::test_backward_dphi_hoisting_exact_f64).
//
// What bounds it on this card: FP32 FMA. A dense N^2 derivative is
// 2 N^3 flops (33.5 MFLOP at 256^2, 4 per component per forward stage).
// This first form is simple, one output pixel per thread, and reads both
// operands of every FMA from shared memory. Making it fast is later work:
// a persistent kernel that keeps a flow's working set in the 50 MB L2,
// wgmma on a 3xTF32 split, and the factored (radix-B) circulant.
//
// Plain C interface, loaded with ctypes. Every launch goes on the
// caller's stream and each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

#include "lenseflow_common.cuh"

#define TILE 16

namespace {

enum Kind { FORWARD = 0, ADJOINT = 1, BACKWARD = 2 };

template <int KIND>
__global__ void __launch_bounds__(TILE * TILE)
velocity_kernel(const float* __restrict__ y, float* __restrict__ k,
                const float* __restrict__ phi, const float* __restrict__ DxT,
                const float* __restrict__ Dy, int ncomp, int Ny, int Nx, float t) {
    __shared__ float sM[TILE][TILE + 1];      // derivative-matrix tile
    __shared__ float sA[2][TILE][TILE + 1];   // operand tiles (f or p f; p delta f)
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int i = blockIdx.y * TILE + ty, j = blockIdx.x * TILE + tx;
    const size_t plane = (size_t)Ny * Nx;
    const size_t o = (size_t)i * Nx + j;
    float px, py;
    p_of_t(phi, plane, o, t, px, py);
    float wx = 0.f, wy = 0.f;
    for (int c = 0; c < ncomp; ++c) {
        const float* a = y + (size_t)c * plane;
        const float* b = y + (size_t)(ncomp + c) * plane;   // backward: delta f_c
        float ax = 0.f, ay = 0.f, bx = 0.f, by = 0.f;
        // d_x: row i of the operand against column j of Dx^T
        for (int k0 = 0; k0 < Nx; k0 += TILE) {
            const size_t src = (size_t)i * Nx + k0 + tx;
            float v = a[src];
            if (KIND != FORWARD) {
                float qx, qy;
                p_of_t(phi, plane, src, t, qx, qy);
                if (KIND == ADJOINT) v *= qx;
                else sA[1][ty][tx] = qx * b[src];
            }
            sA[0][ty][tx] = v;
            sM[ty][tx] = DxT[(size_t)(k0 + ty) * Nx + j];
            __syncthreads();
#pragma unroll
            for (int kk = 0; kk < TILE; ++kk) {
                const float m = sM[kk][tx];
                ax = fmaf(sA[0][ty][kk], m, ax);
                if (KIND == BACKWARD) bx = fmaf(sA[1][ty][kk], m, bx);
            }
            __syncthreads();
        }
        // d_y: row i of Dy against column j of the operand
        for (int k0 = 0; k0 < Ny; k0 += TILE) {
            const size_t src = (size_t)(k0 + ty) * Nx + j;
            float v = a[src];
            if (KIND != FORWARD) {
                float qx, qy;
                p_of_t(phi, plane, src, t, qx, qy);
                if (KIND == ADJOINT) v *= qy;
                else sA[1][ty][tx] = qy * b[src];
            }
            sA[0][ty][tx] = v;
            sM[ty][tx] = Dy[(size_t)i * Ny + k0 + tx];
            __syncthreads();
#pragma unroll
            for (int kk = 0; kk < TILE; ++kk) {
                const float m = sM[ty][kk];
                ay = fmaf(m, sA[0][kk][tx], ay);
                if (KIND == BACKWARD) by = fmaf(m, sA[1][kk][tx], by);
            }
            __syncthreads();
        }
        if (KIND == FORWARD) {
            k[(size_t)c * plane + o] = px * ax + py * ay;
        } else if (KIND == ADJOINT) {
            k[(size_t)c * plane + o] = ax + ay;
        } else {
            k[(size_t)c * plane + o] = px * ax + py * ay;             // df/dt
            k[(size_t)(ncomp + c) * plane + o] = bx + by;             // d(delta f)/dt
            const float dfc = b[o];
            wx = fmaf(dfc, ax, wx);                                   // w = sum_c delta f_c grad f_c
            wy = fmaf(dfc, ay, wy);
        }
    }
    if (KIND == BACKWARD) {
        // u = M^-1 w and the delta-phi integrands
        dphi_integrands(phi, plane, o, t, wx, wy, k + (size_t)(2 * ncomp) * plane);
    }
}

// out = d_x a + d_y b + c over blockIdx.z planes; a, b or c may be null.
__global__ void __launch_bounds__(TILE * TILE)
deriv_kernel(const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ c, float* __restrict__ out,
             const float* __restrict__ DxT, const float* __restrict__ Dy, int Ny, int Nx) {
    __shared__ float sM[TILE][TILE + 1];
    __shared__ float sA[TILE][TILE + 1];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int i = blockIdx.y * TILE + ty, j = blockIdx.x * TILE + tx;
    const size_t plane = (size_t)Ny * Nx;
    const size_t base = (size_t)blockIdx.z * plane;
    const size_t o = (size_t)i * Nx + j;
    float ax = 0.f, ay = 0.f;
    if (a != nullptr) {
        for (int k0 = 0; k0 < Nx; k0 += TILE) {
            sA[ty][tx] = a[base + (size_t)i * Nx + k0 + tx];
            sM[ty][tx] = DxT[(size_t)(k0 + ty) * Nx + j];
            __syncthreads();
#pragma unroll
            for (int kk = 0; kk < TILE; ++kk) ax = fmaf(sA[ty][kk], sM[kk][tx], ax);
            __syncthreads();
        }
    }
    if (b != nullptr) {
        for (int k0 = 0; k0 < Ny; k0 += TILE) {
            sA[ty][tx] = b[base + (size_t)(k0 + ty) * Nx + j];
            sM[ty][tx] = Dy[(size_t)i * Ny + k0 + tx];
            __syncthreads();
#pragma unroll
            for (int kk = 0; kk < TILE; ++kk) ay = fmaf(sM[ty][kk], sA[kk][tx], ay);
            __syncthreads();
        }
    }
    float v = ax + ay;
    if (c != nullptr) v += c[base + o];
    out[base + o] = v;
}

// stage 0: acc = y + wacc k;  s = y + ws k
// stage 1, 2: acc += wacc k;  s = y + ws k
// stage 3: y = acc + wacc k
__global__ void rk4_kernel(float* __restrict__ y, const float* __restrict__ k,
                           float* __restrict__ acc, float* __restrict__ s,
                           size_t n, int stage, float wacc, float ws) {
    for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
         idx += (size_t)gridDim.x * blockDim.x) {
        const float kv = k[idx];
        if (stage == 0) {
            const float yv = y[idx];
            acc[idx] = yv + wacc * kv;
            s[idx] = yv + ws * kv;
        } else if (stage < 3) {
            acc[idx] = acc[idx] + wacc * kv;
            s[idx] = y[idx] + ws * kv;
        } else {
            y[idx] = acc[idx] + wacc * kv;
        }
    }
}

}  // namespace

extern "C" int lf_velocity(int kind, const float* y, float* k, const float* phi,
                           const float* DxT, const float* Dy, int ncomp, int Ny, int Nx,
                           float t, void* stream) {
    const dim3 block(TILE, TILE), grid(Nx / TILE, Ny / TILE);
    cudaStream_t st = (cudaStream_t)stream;
    switch (kind) {
        case FORWARD:
            velocity_kernel<FORWARD><<<grid, block, 0, st>>>(y, k, phi, DxT, Dy, ncomp, Ny, Nx, t);
            break;
        case ADJOINT:
            velocity_kernel<ADJOINT><<<grid, block, 0, st>>>(y, k, phi, DxT, Dy, ncomp, Ny, Nx, t);
            break;
        case BACKWARD:
            velocity_kernel<BACKWARD><<<grid, block, 0, st>>>(y, k, phi, DxT, Dy, ncomp, Ny, Nx, t);
            break;
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

extern "C" int lf_deriv(const float* a, const float* b, const float* c, float* out,
                        const float* DxT, const float* Dy, int nplanes, int Ny, int Nx,
                        void* stream) {
    const dim3 block(TILE, TILE), grid(Nx / TILE, Ny / TILE, nplanes);
    deriv_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a, b, c, out, DxT, Dy, Ny, Nx);
    return (int)cudaGetLastError();
}

extern "C" int lf_rk4_update(float* y, const float* k, float* acc, float* s, size_t n,
                             int stage, float wacc, float ws, void* stream) {
    const int threads = 256;
    size_t blocks = (n + threads - 1) / threads;
    if (blocks > 65535) blocks = 65535;
    rk4_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(y, k, acc, s, n, stage,
                                                                       wacc, ws);
    return (int)cudaGetLastError();
}
