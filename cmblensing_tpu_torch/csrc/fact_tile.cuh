// The radix-B factored derivative as a tiled device function, shared by
// the factored LenseFlow kernels (factored.cu: K1, K3, K4; uni.cu: K5).
//
// The factored derivative along an axis of length N = B * A (A = FA = 128):
// a real butterfly over the B row (or column) blocks r of the operand,
// u_c = sum_r Rf[c][r] x_r, the block products y_0 = G_0 u_0,
// y_{B-1} = G_{B/2} u_{B-1}, and for each complex pair
// (y_{2i+1}, y_{2i+2}) = (Ar u_{2i+1} - Ai u_{2i+2}, Ai u_{2i+1} + Ar u_{2i+2}),
// then out_r = sum_c Ri[r][c] y_c. Blocks are packed (B, A, A) as
// [G_0, G_{B/2}, Ar_1.., Ai_1..]; the x blocks are stored transposed.
//
// One block owns an output tile across all B blocks of the derivative's
// axis (d/dy: 16 values of m x 64 columns, i.e. the rows r*A + m for every
// r; d/dx: 16 rows x 64 values of m). It walks the A-long contraction in
// slabs: it forms the B butterfly channels of the operand slab at load
// (through the caller's load functor, e.g. a multiply by p(t)), stages them
// and the matching block slab in shared memory (40 KB), and each thread
// accumulates 2 x 2 outputs in all B channels; the inverse butterfly is
// applied at store, through the caller's store functor. A derivative along
// y needs whole columns and one along x whole rows, so a kernel built on it
// runs as passes: an x pass that stores and a y pass that accumulates.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int FA = 128;   // block size A: an axis of length N is factored at radix N / FA
constexpr int TS = 16;    // tile, short side: threadIdx.y and threadIdx.y + 8
constexpr int TW = 64;    // tile, wide side: threadIdx.x and threadIdx.x + 32
constexpr int NT = 256;   // threads per block (32 x 8)
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
