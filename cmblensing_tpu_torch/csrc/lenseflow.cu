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
//                  Each block computes one 32 x 32 output tile of one
//                  component (every component, in turn, for the backward
//                  kind): the circulant products d_x a = a . Dx^T and
//                  d_y a = Dy . a in FP32 FMA through the register-tiled
//                  `dense_xy` below, with p(t) read from two ready planes
//                  (lf_p_planes: once per distinct time of a flow, not at
//                  every operand load) and M^-1(t) for the backward kind
//                  rebuilt from the five phi planes at the output pixels:
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
// What bounds it on this card: FP32 FMA in the products (a dense N^2
// derivative is 2 N^3 flops, 33.5 MFLOP at 256^2, 4 per component per
// forward stage), but at 256^2 a plane has only 64 tiles, so the pace is
// set by how much of the card a launch occupies and by the shared-memory
// load rate inside a block. `dense_xy` is the one product both
// lf_velocity and lf_deriv run: a block's 8 warps split into 4 groups,
// (x product, y product) x (two halves of the contraction), so that both
// terms of a tile are formed at once and combined inside the block (one
// launch and no atomics: the 256^2 gradient is launch-bound, and a
// second pass would add launches); each thread keeps 4 x 4 outputs per
// operand (16 FMA per two 16-byte shared loads, 2 FMA per word; the
// backward kind's two operands share the matrix slab, 2.7), layouts are
// unpadded and conflict-free, and each group runs a ring of two slabs,
// the next one fetched into registers before the current one's FMA loop.
// A forward or adjoint launch is 64 tiles x ncomp blocks (128 at pol P on
// 132 SMs). Later work: capturing a flow in a CUDA graph, and wgmma on a
// 3xTF32 split ('high' tier).
//
// Plain C interface, loaded with ctypes. Every launch goes on the
// caller's stream and each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

#include "lenseflow_common.cuh"

namespace {

enum Kind { FORWARD = 0, ADJOINT = 1, BACKWARD = 2 };

constexpr int DT = 32;        // output tile side
constexpr int DK = 16;        // contraction slab
constexpr int DGROUP = 64;    // threads of a group: 8 x 8, each 4 x 4 outputs per operand
constexpr int DNT = 4 * DGROUP;
// a group's two slab stages of the matrix and NOP operands
__host__ __device__ constexpr int group_floats(int NOP) { return 2 * (1 + NOP) * DK * DT; }

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
    return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ void group_sync(int bar) {
    asm volatile("bar.sync %0, %1;" ::"r"(bar), "n"(DGROUP) : "memory");
}

// One group's share of a tile: acc[o] += (operand o)[i0.., kb..ke) . M
// (AX == 0: d_x, M = Dx^T) or M[i0.., kb..ke) . (operand o) (AX == 1: d_y,
// M = Dy), both row-major with rows of n. op(AX, o, row, col) returns the
// four operand values at (row, col..col+3) after the caller's prologue.
// The left factor is staged k-major (transposed at store), so both are
// read as 16-byte loads.
template <int AX, int NOP, class Op>
__device__ __forceinline__ void dense_tile(const float* __restrict__ M, int n, int i0, int j0,
                                           int kb, int ke, float* sm, int gt, int bar, Op op,
                                           float (&acc)[NOP][4][4]) {
    constexpr int NL = AX == 0 ? NOP : 1, NR = AX == 0 ? 1 : NOP;
    constexpr int STAGE = (NL + NR) * DK * DT;
    const int li = gt % DT, lq = gt / DT;     // left loads: row li, k quads lq and lq + 2
    const int rk = gt / 8, rj = (gt % 8) * 4; // right loads: rows rk and rk + 8, columns rj..
    const int ti = (gt / 8) * 4, tj = (gt % 8) * 4;
    float4 lreg[NL][2], rreg[NR][2];
    auto fetch = [&](int k0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int o = 0; o < NL; ++o)
                lreg[o][h] = AX == 0 ? op(0, o, i0 + li, k0 + (lq + 2 * h) * 4)
                                     : ld4(M + (size_t)(i0 + li) * n + k0 + (lq + 2 * h) * 4);
#pragma unroll
            for (int o = 0; o < NR; ++o)
                rreg[o][h] = AX == 0 ? ld4(M + (size_t)(k0 + rk + 8 * h) * n + j0 + rj)
                                     : op(1, o, k0 + rk + 8 * h, j0 + rj);
        }
    };
    auto stash = [&](float* st) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int o = 0; o < NL; ++o) {
                float* d = st + (o * DK + (lq + 2 * h) * 4) * DT + li;
                d[0] = lreg[o][h].x, d[DT] = lreg[o][h].y, d[2 * DT] = lreg[o][h].z,
                d[3 * DT] = lreg[o][h].w;
            }
#pragma unroll
            for (int o = 0; o < NR; ++o)
                *reinterpret_cast<float4*>(st + ((NL + o) * DK + rk + 8 * h) * DT + rj) =
                    rreg[o][h];
        }
    };
    fetch(kb);
    stash(sm);
    const int nslab = (ke - kb) / DK;
    for (int s = 0; s < nslab; ++s) {
        const float* cur = sm + (s % 2) * STAGE;
        group_sync(bar);   // stage `cur` is complete, and the group has left the other one
        const bool more = s + 1 < nslab;
        if (more) fetch(kb + (s + 1) * DK);
#pragma unroll
        for (int kk = 0; kk < DK; ++kk) {
            float l[NL][4], r[NR][4];
#pragma unroll
            for (int o = 0; o < NL; ++o) {
                const float4 v = ld4(cur + (o * DK + kk) * DT + ti);
                l[o][0] = v.x, l[o][1] = v.y, l[o][2] = v.z, l[o][3] = v.w;
            }
#pragma unroll
            for (int o = 0; o < NR; ++o) {
                const float4 v = ld4(cur + ((NL + o) * DK + kk) * DT + tj);
                r[o][0] = v.x, r[o][1] = v.y, r[o][2] = v.z, r[o][3] = v.w;
            }
#pragma unroll
            for (int o = 0; o < NOP; ++o)
#pragma unroll
                for (int a = 0; a < 4; ++a)
#pragma unroll
                    for (int b = 0; b < 4; ++b)
                        acc[o][a][b] = fmaf(l[AX == 0 ? o : 0][a], r[AX == 0 ? 0 : o][b],
                                            acc[o][a][b]);
        }
        if (more) stash(sm + ((s + 1) % 2) * STAGE);
    }
}

// The x and y circulant products of the block's 32 x 32 tile, for NOP
// operands: X[o] = d_x (operand o) and Y[o] = d_y (operand o) at this
// thread's four pixels (row threadIdx.x / 8, columns 4 (threadIdx.x % 8)..
// of the tile), either skipped (zero) when has_x / has_y is false. Four
// groups of 64 threads take (x, y) x (the two halves of the contraction),
// or the four quarters of the one product asked for, and meet in shared
// memory; sm holds 4 group_floats(NOP). Every thread of the block must
// call it.
template <int NOP, class Op>
__device__ __forceinline__ void dense_xy(const float* __restrict__ DxT,
                                         const float* __restrict__ Dy, int Ny, int Nx, float* sm,
                                         bool has_x, bool has_y, Op op, float4 (&X)[NOP],
                                         float4 (&Y)[NOP]) {
    const int tid = threadIdx.x, g = tid / DGROUP, gt = tid % DGROUP;
    const int i0 = blockIdx.y * DT, j0 = blockIdx.x * DT;
    // one product alone is split four ways where its quarters are whole slabs
    const int n1 = has_x ? Nx : Ny;
    const bool four = has_x != has_y && n1 % (4 * DK) == 0;
    const int nsplit = four ? 4 : 2, kh = four ? g : g >> 1;
    const int axis = four ? (has_x ? 0 : 1) : g & 1;
    float acc[NOP][4][4];
#pragma unroll
    for (int o = 0; o < NOP; ++o)
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) acc[o][a][b] = 0.f;
    float* stage = sm + g * group_floats(NOP);
    if (axis == 0) {
        if (has_x)
            dense_tile<0, NOP>(DxT, Nx, i0, j0, kh * (Nx / nsplit), (kh + 1) * (Nx / nsplit),
                               stage, gt, 1 + g, op, acc);
    } else if (has_y) {
        dense_tile<1, NOP>(Dy, Ny, i0, j0, kh * (Ny / nsplit), (kh + 1) * (Ny / nsplit), stage,
                           gt, 1 + g, op, acc);
    }
    __syncthreads();   // every group has left its stages: reuse them for the partial tiles
    const int ti = (gt / 8) * 4, tj = (gt % 8) * 4;
#pragma unroll
    for (int o = 0; o < NOP; ++o)
#pragma unroll
        for (int a = 0; a < 4; ++a)
            *reinterpret_cast<float4*>(sm + ((g * NOP + o) * DT + ti + a) * DT + tj) =
                make_float4(acc[o][a][0], acc[o][a][1], acc[o][a][2], acc[o][a][3]);
    __syncthreads();
    const int at = (tid / 8) * DT + (tid % 8) * 4;
#pragma unroll
    for (int o = 0; o < NOP; ++o) {
        const float4 p0 = ld4(sm + (0 * NOP + o) * DT * DT + at);
        const float4 p1 = ld4(sm + (1 * NOP + o) * DT * DT + at);
        const float4 p2 = ld4(sm + (2 * NOP + o) * DT * DT + at);
        const float4 p3 = ld4(sm + (3 * NOP + o) * DT * DT + at);
        const float4 all = add4(add4(p0, p1), add4(p2, p3));
        X[o] = four ? (has_x ? all : make_float4(0.f, 0.f, 0.f, 0.f)) : add4(p0, p2);
        Y[o] = four ? (has_x ? make_float4(0.f, 0.f, 0.f, 0.f) : all) : add4(p1, p3);
    }
    __syncthreads();   // the partial tiles are read: the stages are free again
}

__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

// One velocity of flow KIND; p holds the planes (p_x, p_y) at time t.
// blockIdx.z is the component (forward, adjoint); the backward kind walks
// its components in the block, because w sums over them.
template <int KIND>
__global__ void __launch_bounds__(DNT)
velocity_kernel(const float* __restrict__ y, float* __restrict__ k,
                const float* __restrict__ phi, const float* __restrict__ p,
                const float* __restrict__ DxT, const float* __restrict__ Dy, int ncomp, int Ny,
                int Nx, float t) {
    constexpr int NOP = KIND == BACKWARD ? 2 : 1;
    __shared__ __align__(16) float sm[4 * group_floats(NOP)];
    const size_t plane = (size_t)Ny * Nx;
    const int tid = threadIdx.x;
    // this thread's four output pixels
    const size_t o = (size_t)(blockIdx.y * DT + tid / 8) * Nx + blockIdx.x * DT + (tid % 8) * 4;
    const float4 px = ld4(p + o), py = ld4(p + plane + o);
    float4 wx = make_float4(0.f, 0.f, 0.f, 0.f), wy = wx;
    const int c0 = KIND == BACKWARD ? 0 : blockIdx.z, c1 = KIND == BACKWARD ? ncomp : c0 + 1;
    for (int c = c0; c < c1; ++c) {
        const float* a = y + (size_t)c * plane;
        const float* b = y + (size_t)(ncomp + c) * plane;   // backward: delta f_c
        float4 X[NOP], Y[NOP];
        dense_xy<NOP>(
            DxT, Dy, Ny, Nx, sm, true, true,
            [&](int axis, int op, int row, int col) {
                const size_t q = (size_t)row * Nx + col;
                // f_c as it is (forward, backward); p f_c (adjoint); p delta f_c (backward)
                if (KIND == FORWARD || (KIND == BACKWARD && op == 0)) return ld4(a + q);
                return mul4(ld4(p + axis * plane + q), ld4((op == 0 ? a : b) + q));
            },
            X, Y);
        if (KIND == ADJOINT) {
            st4(k + (size_t)c * plane + o, add4(X[0], Y[0]));
        } else {
            st4(k + (size_t)c * plane + o, add4(mul4(px, X[0]), mul4(py, Y[0])));   // df/dt
        }
        if (KIND == BACKWARD) {
            st4(k + (size_t)(ncomp + c) * plane + o, add4(X[NOP - 1], Y[NOP - 1]));   // d(delta f)/dt
            const float4 dfc = ld4(b + o);
            wx = add4(wx, mul4(dfc, X[0]));   // w = sum_c delta f_c grad f_c
            wy = add4(wy, mul4(dfc, Y[0]));
        }
    }
    if (KIND == BACKWARD) {
        // u = M^-1 w and the delta-phi integrands
        float* acc = k + (size_t)(2 * ncomp) * plane;
        dphi_integrands(phi, plane, o, t, wx.x, wy.x, acc);
        dphi_integrands(phi, plane, o + 1, t, wx.y, wy.y, acc);
        dphi_integrands(phi, plane, o + 2, t, wx.z, wy.z, acc);
        dphi_integrands(phi, plane, o + 3, t, wx.w, wy.w, acc);
    }
}

// out = d_x a + d_y b + c over blockIdx.z planes; a, b or c may be null.
__global__ void __launch_bounds__(DNT)
deriv_kernel(const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ c, float* __restrict__ out,
             const float* __restrict__ DxT, const float* __restrict__ Dy, int Ny, int Nx) {
    __shared__ __align__(16) float sm[4 * group_floats(1)];
    const size_t base = (size_t)blockIdx.z * Ny * Nx;
    const int tid = threadIdx.x;
    const size_t o = base + (size_t)(blockIdx.y * DT + tid / 8) * Nx + blockIdx.x * DT + (tid % 8) * 4;
    float4 X[1], Y[1];
    dense_xy<1>(
        DxT, Dy, Ny, Nx, sm, a != nullptr, b != nullptr,
        [&](int axis, int, int row, int col) {
            return ld4((axis == 0 ? a : b) + base + (size_t)row * Nx + col);
        },
        X, Y);
    float4 v = add4(X[0], Y[0]);
    if (c != nullptr) v = add4(v, ld4(c + o));
    st4(out + o, v);
}

// out <- (p_x, p_y)(t), (2, nb, plane), from phi's (nb, 5, plane) planes.
__global__ void p_kernel(const float* __restrict__ phi, float* __restrict__ out, size_t nb,
                         size_t plane, float t) {
    for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < nb * plane;
         idx += (size_t)gridDim.x * blockDim.x) {
        float px, py;
        p_of_t(phi + (idx / plane) * 5 * plane, plane, idx % plane, t, px, py);
        out[idx] = px;
        out[nb * plane + idx] = py;
    }
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

unsigned stride_blocks(size_t n, int threads) {
    const size_t blocks = (n + threads - 1) / threads;
    return (unsigned)(blocks > 65535 ? 65535 : blocks);
}

bool dense_shape_ok(int Ny, int Nx) { return Ny > 0 && Nx > 0 && Ny % DT == 0 && Nx % DT == 0; }

}  // namespace

// k <- the velocity of flow `kind` at time t of the (nstate, Ny, Nx) state
// y; phi is (5, Ny, Nx) and p its p(t) planes, (2, Ny, Nx). One launch.
extern "C" int lf_velocity(int kind, const float* y, float* k, const float* phi, const float* p,
                           const float* DxT, const float* Dy, int ncomp, int Ny, int Nx,
                           float t, void* stream) {
    if (!dense_shape_ok(Ny, Nx)) return (int)cudaErrorInvalidValue;
    const dim3 grid(Nx / DT, Ny / DT, ncomp);
    cudaStream_t st = (cudaStream_t)stream;
    switch (kind) {
        case FORWARD:
            velocity_kernel<FORWARD><<<grid, DNT, 0, st>>>(y, k, phi, p, DxT, Dy, ncomp, Ny, Nx, t);
            break;
        case ADJOINT:
            velocity_kernel<ADJOINT><<<grid, DNT, 0, st>>>(y, k, phi, p, DxT, Dy, ncomp, Ny, Nx, t);
            break;
        case BACKWARD:
            velocity_kernel<BACKWARD><<<dim3(Nx / DT, Ny / DT), DNT, 0, st>>>(y, k, phi, p, DxT,
                                                                              Dy, ncomp, Ny, Nx, t);
            break;
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

extern "C" int lf_deriv(const float* a, const float* b, const float* c, float* out,
                        const float* DxT, const float* Dy, int nplanes, int Ny, int Nx,
                        void* stream) {
    if (!dense_shape_ok(Ny, Nx)) return (int)cudaErrorInvalidValue;
    const dim3 grid(Nx / DT, Ny / DT, nplanes);
    deriv_kernel<<<grid, DNT, 0, (cudaStream_t)stream>>>(a, b, c, out, DxT, Dy, Ny, Nx);
    return (int)cudaGetLastError();
}

// out <- the planes (p_x, p_y) of p(t) = (I + t Hess phi)^-1 grad phi,
// (2, nb, plane), from phi (nb, 5, plane).
extern "C" int lf_p_planes(const float* phi, float* out, size_t nb, size_t plane, float t,
                           void* stream) {
    p_kernel<<<stride_blocks(nb * plane, 256), 256, 0, (cudaStream_t)stream>>>(phi, out, nb,
                                                                                plane, t);
    return (int)cudaGetLastError();
}

extern "C" int lf_rk4_update(float* y, const float* k, float* acc, float* s, size_t n,
                             int stage, float wacc, float ws, void* stream) {
    rk4_kernel<<<stride_blocks(n, 256), 256, 0, (cudaStream_t)stream>>>(y, k, acc, s, n, stage,
                                                                        wacc, ws);
    return (int)cudaGetLastError();
}
