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
// The factored derivative along an axis of length N = B * A (A = FA = 128):
// a real butterfly over the B row (or column) blocks r of the operand,
// u_c = sum_r Rf[c][r] x_r, the block products y_0 = G_0 u_0,
// y_{B-1} = G_{B/2} u_{B-1}, and for each complex pair
// (y_{2i+1}, y_{2i+2}) = (Ar u_{2i+1} - Ai u_{2i+2}, Ai u_{2i+1} + Ar u_{2i+2}),
// then out_r = sum_c Ri[r][c] y_c. Blocks are packed (B, A, A) as
// [G_0, G_{B/2}, Ar_1.., Ai_1..]; the x blocks are stored transposed.
//
// The TPU kernels hold whole planes in VMEM. A 1024^2 f32 plane is 4 MiB,
// far beyond a block's 227 KB of shared memory, so here every derivative
// is tiled: one block owns an output tile across all B blocks of the
// derivative's axis (d/dy: 16 values of m x 64 columns, i.e. the rows
// r*A + m for every r; d/dx: 16 rows x 64 values of m). It walks the
// A-long contraction in slabs: it forms the B butterfly channels of the
// operand slab at load (through the caller's prologue, e.g. a multiply by
// p(t)), stages them and the matching block slab in shared memory
// (40 KB), and each thread accumulates 2 x 2 outputs in all B channels;
// the inverse butterfly is applied at store, through the caller's
// epilogue. A derivative along y needs whole columns and one along x
// whole rows, so a velocity is two launches: an x pass that stores and a
// y pass that accumulates. The grid's z axis runs over batch x component
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

#include "lenseflow_common.cuh"

namespace {

constexpr int FA = 128;   // block size A: an axis of length N is factored at radix N / FA
constexpr int TS = 16;    // tile, short side: threadIdx.y and threadIdx.y + 8
constexpr int TW = 64;    // tile, wide side: threadIdx.x and threadIdx.x + 32
constexpr int NT = 256;   // threads per block (32 x 8)
constexpr int NACC = 5;   // delta-phi accumulator planes of the backward state
// shared memory: a (FA x TW) and a (TS x FA) slab, then the butterflies
constexpr int SLAB_FLOATS = FA * TW + TS * FA;

enum Axis { AXIS_X = 0, AXIS_Y = 1 };

// Pixel of the thread's output (s, w) in butterfly row r of the tile at
// (s0, w0): d/dy puts the blocks on rows, d/dx on columns.
template <int AXIS>
__device__ __forceinline__ void out_pixel(int r, int s, int w, int s0, int w0, int& row,
                                          int& col) {
    const int is = s0 + threadIdx.y + 8 * s, iw = w0 + threadIdx.x + 32 * w;
    if (AXIS == AXIS_Y) {
        row = r * FA + is;
        col = iw;
    } else {
        row = is;
        col = r * FA + iw;
    }
}

template <int B>
__device__ __forceinline__ void load_butterflies(const float* __restrict__ bf, float* smem) {
    const int tid = threadIdx.y * 32 + threadIdx.x;
    for (int p = tid; p < 2 * B * B; p += NT) smem[SLAB_FLOATS + p] = bf[p];
}

// One output tile of the factored derivative along AXIS (see the header).
// load(row, col) returns the operand at a pixel (with the caller's
// prologue); store(row, col, v) receives the derivative there. Every
// thread of the block must call it.
template <int B, int AXIS, class Load, class Store>
__device__ __forceinline__ void fact_tile(const float* __restrict__ G, float* smem, int s0,
                                          int w0, Load load, Store store) {
    constexpr int TK = FA / B;      // contraction slab
    constexpr int NC = B / 2 - 1;   // complex channel pairs
    float* big = smem;              // (B, TK, TW) channels of d/dy, (B, TK, TW) blocks of d/dx
    float* small = smem + FA * TW;  // (B, TS, TK) blocks of d/dy, (B, TS, TK) channels of d/dx
    const float* sRf = smem + SLAB_FLOATS;
    const float* sRi = sRf + B * B;
    float* sU = AXIS == AXIS_Y ? big : small;
    float* sG = AXIS == AXIS_Y ? small : big;
    const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * 32 + tx;

    float acc[B][2][2];
#pragma unroll
    for (int c = 0; c < B; ++c)
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
            for (int w = 0; w < 2; ++w) acc[c][s][w] = 0.f;

    for (int k0 = 0; k0 < FA; k0 += TK) {
        __syncthreads();
        if (AXIS == AXIS_Y) {
            for (int p = tid; p < TK * TW; p += NT) {
                const int kk = p / TW, w = p % TW;
                float x[B];
#pragma unroll
                for (int r = 0; r < B; ++r) x[r] = load(r * FA + k0 + kk, w0 + w);
#pragma unroll
                for (int c = 0; c < B; ++c) {
                    float u = 0.f;
#pragma unroll
                    for (int r = 0; r < B; ++r) u = fmaf(sRf[c * B + r], x[r], u);
                    sU[(c * TK + kk) * TW + w] = u;
                }
            }
            for (int p = tid; p < B * TS * TK; p += NT) {
                const int c = p / (TS * TK), s = (p / TK) % TS, kk = p % TK;
                sG[p] = G[((size_t)c * FA + s0 + s) * FA + k0 + kk];
            }
        } else {
            for (int p = tid; p < TS * TK; p += NT) {
                const int s = p / TK, kk = p % TK;
                float x[B];
#pragma unroll
                for (int r = 0; r < B; ++r) x[r] = load(s0 + s, r * FA + k0 + kk);
#pragma unroll
                for (int c = 0; c < B; ++c) {
                    float u = 0.f;
#pragma unroll
                    for (int r = 0; r < B; ++r) u = fmaf(sRf[c * B + r], x[r], u);
                    sU[(c * TS + s) * TK + kk] = u;
                }
            }
            for (int p = tid; p < B * TK * TW; p += NT) {
                const int c = p / (TK * TW), kk = (p / TW) % TK, w = p % TW;
                sG[p] = G[((size_t)c * FA + k0 + kk) * FA + w0 + w];
            }
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < TK; ++kk) {
            // g[c][.]: block c's entries, u[c][.]: channel c's entries at
            // this thread's two short-side (s) and two wide-side (w) points
            float g[B][2], u[B][2];
#pragma unroll
            for (int c = 0; c < B; ++c) {
                if (AXIS == AXIS_Y) {
                    g[c][0] = sG[(c * TS + ty) * TK + kk];
                    g[c][1] = sG[(c * TS + ty + 8) * TK + kk];
                    u[c][0] = sU[(c * TK + kk) * TW + tx];
                    u[c][1] = sU[(c * TK + kk) * TW + tx + 32];
                } else {
                    u[c][0] = sU[(c * TS + ty) * TK + kk];
                    u[c][1] = sU[(c * TS + ty + 8) * TK + kk];
                    g[c][0] = sG[(c * TK + kk) * TW + tx];
                    g[c][1] = sG[(c * TK + kk) * TW + tx + 32];
                }
            }
#pragma unroll
            for (int s = 0; s < 2; ++s)
#pragma unroll
                for (int w = 0; w < 2; ++w) {
                    const int gi = AXIS == AXIS_Y ? s : w, ui = AXIS == AXIS_Y ? w : s;
                    acc[0][s][w] = fmaf(g[0][gi], u[0][ui], acc[0][s][w]);
                    acc[B - 1][s][w] = fmaf(g[1][gi], u[B - 1][ui], acc[B - 1][s][w]);
#pragma unroll
                    for (int i = 0; i < NC; ++i) {
                        const float ar = g[2 + i][gi], ai = g[2 + NC + i][gi];
                        const float ure = u[2 * i + 1][ui], uim = u[2 * i + 2][ui];
                        acc[2 * i + 1][s][w] = fmaf(ar, ure, fmaf(-ai, uim, acc[2 * i + 1][s][w]));
                        acc[2 * i + 2][s][w] = fmaf(ai, ure, fmaf(ar, uim, acc[2 * i + 2][s][w]));
                    }
                }
        }
    }
    // inverse butterfly at store
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int w = 0; w < 2; ++w)
#pragma unroll
            for (int r = 0; r < B; ++r) {
                float v = 0.f;
#pragma unroll
                for (int c = 0; c < B; ++c) v = fmaf(sRi[r * B + c], acc[c][s][w], v);
                int row, col;
                out_pixel<AXIS>(r, s, w, s0, w0, row, col);
                store(row, col, v);
            }
}

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

template <int AXIS>
dim3 pass_grid(int Ny, int Nx, int nz) {
    return AXIS == AXIS_Y ? dim3(Nx / TW, FA / TS, nz) : dim3(FA / TW, Ny / TS, nz);
}

const dim3 BLOCK(32, 8);

bool shape_ok(int Bx, int By, int Ny, int Nx) {
    return Nx == Bx * FA && Ny == By * FA;
}

}  // namespace

// Instantiate the statement for the radix Bv (as the constant B); other
// radices are refused.
#define LF_WITH_RADIX(Bv, ...)                                                                  \
    switch (Bv) {                                                                               \
        case 4: {                                                                               \
            constexpr int B = 4;                                                                \
            __VA_ARGS__;                                                                        \
        } break;                                                                                \
        case 8: {                                                                               \
            constexpr int B = 8;                                                                \
            __VA_ARGS__;                                                                        \
        } break;                                                                                \
        default:                                                                                \
            return (int)cudaErrorInvalidValue;                                                  \
    }

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
