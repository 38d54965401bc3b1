// The register-tiled dense circulant product `dense_xy` (the x and y
// derivatives of a 32 x 32 output tile in FP32 FMA, or at 'high' and 'bf16'
// on mma.sync bf16, any plane shape with the edge guards a template
// parameter), and the tile's loads, stores and launch helpers: shared by
// the dense LenseFlow kernels K2 (dense_flow.cu, the whole flow, and
// lenseflow.cu, the derivative, whose header says what bounds the product
// and how the tile is laid out) and the dense form of the universal kernel
// K5 (uni_dense.cu). lf_deriv's 'bf16' tier no longer runs it
// (lenseflow.cu::deriv_bf16_kernel: the whole contraction of a tile in one
// block, no split and no shared-memory reduction); the whole-flow kernel,
// K5 and the strict and 'high' derivatives do.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "lenseflow_common.cuh"

namespace {

constexpr int DT = 32;        // output tile side
constexpr int DK = 16;        // contraction slab
constexpr int DGROUP = 64;    // threads of a group: 8 x 8, each 4 x 4 outputs per operand
constexpr int DNT = 4 * DGROUP;
constexpr int AS = DK + 8;    // bf16 tiers: row strides of a staged left slab ([row][k])
constexpr int BS = DT + 8;    // and right slab ([k][column])

// bf16 elements of one slab of a bf16 tier's stage: NL left and NR right
// slabs; a stage holds two (head, residual) at 'high', one (head) at 'bf16'
__host__ __device__ constexpr int bf16_slab(int NL, int NR) { return NL * DT * AS + NR * DK * BS; }
__host__ __device__ constexpr int tier_halves(int tier) { return tier == TIER_HIGH ? 2 : 1; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
// floats of a group's two slab stages (of either product) for NOP operands
// (two stages of bf16 slabs take as many floats as one stage has bf16)
__host__ __device__ constexpr int group_floats(int NOP, int tier) {
    return tier == TIER_F32 ? 2 * (1 + NOP) * DK * DT
                            : tier_halves(tier) * cmax(bf16_slab(NOP, 1), bf16_slab(1, NOP));
}
// a block's dynamic shared memory: four groups' stages, reused for the partial tiles
__host__ __device__ constexpr size_t dense_smem_bytes(int NOP, int tier) {
    return sizeof(float) * 4 * group_floats(NOP, tier);
}
static_assert(group_floats(1, TIER_F32) >= DT * DT && group_floats(2, TIER_F32) >= 2 * DT * DT &&
                  group_floats(1, TIER_HIGH) >= DT * DT &&
                  group_floats(2, TIER_HIGH) >= 2 * DT * DT &&
                  group_floats(1, TIER_BF16) >= DT * DT &&
                  group_floats(2, TIER_BF16) >= 2 * DT * DT,
              "the stages hold the four groups' partial tiles");

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
    return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The four floats at (row, col..col+3) of a row-major array of `rows` rows
// of `cols`, 0 past its edge; col is a multiple of 4, and x 16-byte aligned
// where cols is.
__device__ __forceinline__ float4 ldg4(const float* __restrict__ x, int row, int col, int rows,
                                       int cols) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row >= rows || col >= cols) return v;
    const float* p = x + (size_t)row * cols + col;
    if ((cols & 3) == 0) return ld4(p);
    v.x = p[0];
    if (col + 1 < cols) v.y = p[1];
    if (col + 2 < cols) v.z = p[2];
    if (col + 3 < cols) v.w = p[3];
    return v;
}

// ... the four bf16 there, packed in two words
__device__ __forceinline__ uint2 ldg4h(const __nv_bfloat16* __restrict__ x, int row, int col,
                                       int rows, int cols) {
    if (row >= rows || col >= cols) return make_uint2(0u, 0u);
    const __nv_bfloat16* p = x + (size_t)row * cols + col;
    if ((cols & 3) == 0) return *reinterpret_cast<const uint2*>(p);
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
    unsigned e[4] = {q[0], 0u, 0u, 0u};
    for (int i = 1; i < 4; ++i)
        if (col + i < cols) e[i] = q[i];
    return make_uint2(e[0] | (e[1] << 16), e[2] | (e[3] << 16));
}

// ... and the store of four floats there, skipped past the edge
__device__ __forceinline__ void stg4(float* __restrict__ x, int row, int col, int rows, int cols,
                                     float4 v) {
    if (row >= rows || col >= cols) return;
    float* p = x + (size_t)row * cols + col;
    if ((cols & 3) == 0) {
        *reinterpret_cast<float4*>(p) = v;
        return;
    }
    p[0] = v.x;
    if (col + 1 < cols) p[1] = v.y;
    if (col + 2 < cols) p[2] = v.z;
    if (col + 3 < cols) p[3] = v.w;
}

// Loads and stores of four values at (row, col..col+3) of an array of
// `rows` rows of `cols`: unguarded vector accesses where every tile and
// slab of the launch lies inside its arrays (EDGE false: Ny and Nx
// multiples of the tile), the guarded ones above where not.
template <bool EDGE>
__device__ __forceinline__ float4 ldq(const float* __restrict__ x, int row, int col, int rows,
                                      int cols) {
    return EDGE ? ldg4(x, row, col, rows, cols) : ld4(x + (size_t)row * cols + col);
}

template <bool EDGE>
__device__ __forceinline__ uint2 ldqh(const __nv_bfloat16* __restrict__ x, int row, int col,
                                      int rows, int cols) {
    return EDGE ? ldg4h(x, row, col, rows, cols)
                : *reinterpret_cast<const uint2*>(x + (size_t)row * cols + col);
}

template <bool EDGE>
__device__ __forceinline__ void stq(float* __restrict__ x, int row, int col, int rows, int cols,
                                    float4 v) {
    if (EDGE)
        stg4(x, row, col, rows, cols, v);
    else
        *reinterpret_cast<float4*>(x + (size_t)row * cols + col) = v;
}

__device__ __forceinline__ unsigned bf16x2_bits(__nv_bfloat162 v) {
    return *reinterpret_cast<unsigned*>(&v);
}

// The bf16 heads (round to nearest even) of four floats, packed in pairs
// as they lie in memory
__device__ __forceinline__ uint2 round4(float4 v) {
    return make_uint2(bf16x2_bits(__floats2bfloat162_rn(v.x, v.y)),
                      bf16x2_bits(__floats2bfloat162_rn(v.z, v.w)));
}

// ... and with them the residuals bf16(x - head)
__device__ __forceinline__ void split4(float4 v, uint2& h, uint2& l) {
    const __nv_bfloat162 h01 = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 h23 = __floats2bfloat162_rn(v.z, v.w);
    const float2 f01 = __bfloat1622float2(h01), f23 = __bfloat1622float2(h23);
    h = make_uint2(bf16x2_bits(h01), bf16x2_bits(h23));
    l = make_uint2(bf16x2_bits(__floats2bfloat162_rn(v.x - f01.x, v.y - f01.y)),
                   bf16x2_bits(__floats2bfloat162_rn(v.z - f23.x, v.w - f23.y)));
}

__device__ __forceinline__ void group_sync(int bar) {
    asm volatile("bar.sync %0, %1;" ::"r"(bar), "n"(DGROUP) : "memory");
}

// One group's share of a tile: acc[o] += (operand o)[i0.., kb..ke) . M
// (AX == 0: d_x, M = Dx^T) or M[i0.., kb..ke) . (operand o) (AX == 1: d_y,
// M = Dy), both row-major with rows of n. op(AX, o, row, col) returns the
// four operand values at (row, col..col+3) after the caller's prologue,
// 0 past the plane's edge. The left factor is staged k-major (transposed
// at store), so both are read as 16-byte loads.
template <int AX, int NOP, bool EDGE, class Op>
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
                                     : ldq<EDGE>(M, i0 + li, k0 + (lq + 2 * h) * 4, n, n);
#pragma unroll
            for (int o = 0; o < NR; ++o)
                rreg[o][h] = AX == 0 ? ldq<EDGE>(M, k0 + rk + 8 * h, j0 + rj, n, n)
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

// dense_tile at a bf16 tier: M is the (2, n, n) bf16 split [head,
// residual] of the circulant (RESID, 'high') or its (n, n) head ('bf16').
// The same loads (M's as bf16); the operand is split, or rounded to its
// head, where it is staged. acc[o][j] is n8 column tile j of the warp's 16
// rows (16 (gt / 32)..) in the mma C layout.
template <int AX, int NOP, bool EDGE, bool RESID, class Op>
__device__ __forceinline__ void dense_tile_bf16(const __nv_bfloat16* __restrict__ M, int n,
                                                int i0, int j0, int kb, int ke, float* sm,
                                                int gt, int bar, Op op,
                                                float (&acc)[NOP][4][4]) {
    constexpr int NL = AX == 0 ? NOP : 1, NR = AX == 0 ? 1 : NOP;
    constexpr int NH = RESID ? 2 : 1;                     // slabs of each operand: head (, residual)
    constexpr int SL = NL * DT * AS, SR = NR * DK * BS;   // head -> residual
    constexpr int STAGE = NH * bf16_slab(NL, NR);
    const __nv_bfloat16* Ml = M + (size_t)n * n;
    __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(sm);
    const int li = gt % DT, lq = gt / DT;     // left loads: row li, k quads lq and lq + 2
    const int rk = gt / 8, rj = (gt % 8) * 4; // right loads: rows rk and rk + 8, columns rj..
    const int lane = gt % 32, w = gt / 32;
    // ldmatrix rows this lane names: A (rows 0-7 | 8-15) x (k 0-7 | 8-15) of the
    // warp's 16 rows; B (k 0-7 | 8-15) x (columns 0-7 | 8-15) of a 16-column half
    const int ar = 16 * w + (lane & 7) + ((lane >> 3) & 1) * 8, ak = (lane >> 4) * 8;
    const int bk = (lane & 7) + ((lane >> 3) & 1) * 8, bc = (lane >> 4) * 8;
    float4 oreg[NOP][2];
    uint2 mh[2], ml[2];
    auto fetch = [&](int k0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            if (AX == 0) {
#pragma unroll
                for (int o = 0; o < NOP; ++o) oreg[o][h] = op(0, o, i0 + li, k0 + (lq + 2 * h) * 4);
                mh[h] = ldqh<EDGE>(M, k0 + rk + 8 * h, j0 + rj, n, n);
                if constexpr (RESID) ml[h] = ldqh<EDGE>(Ml, k0 + rk + 8 * h, j0 + rj, n, n);
            } else {
                mh[h] = ldqh<EDGE>(M, i0 + li, k0 + (lq + 2 * h) * 4, n, n);
                if constexpr (RESID) ml[h] = ldqh<EDGE>(Ml, i0 + li, k0 + (lq + 2 * h) * 4, n, n);
#pragma unroll
                for (int o = 0; o < NOP; ++o) oreg[o][h] = op(1, o, k0 + rk + 8 * h, j0 + rj);
            }
        }
    };
    // left slabs [head, residual][o][row][k], right slabs [head, residual][o][k][column]
    auto stash = [&](__nv_bfloat16* st) {
        __nv_bfloat16* L = st;
        __nv_bfloat16* R = st + NH * SL;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int lat = li * AS + (lq + 2 * h) * 4, rat = (rk + 8 * h) * BS + rj;
#pragma unroll
            for (int o = 0; o < NOP; ++o) {
                uint2 vh, vl{};
                if constexpr (RESID) split4(oreg[o][h], vh, vl);
                else vh = round4(oreg[o][h]);
                const int at = AX == 0 ? o * DT * AS + lat : o * DK * BS + rat;
                __nv_bfloat16* dst = AX == 0 ? L : R;
                *reinterpret_cast<uint2*>(dst + at) = vh;
                if constexpr (RESID) *reinterpret_cast<uint2*>(dst + (AX == 0 ? SL : SR) + at) = vl;
            }
            __nv_bfloat16* dst = AX == 0 ? R : L;
            const int at = AX == 0 ? rat : lat;
            *reinterpret_cast<uint2*>(dst + at) = mh[h];
            if constexpr (RESID) *reinterpret_cast<uint2*>(dst + (AX == 0 ? SR : SL) + at) = ml[h];
        }
    };
    auto products = [&](const __nv_bfloat16* st) {
        const __nv_bfloat16* L = st;
        const __nv_bfloat16* R = st + NH * SL;
        unsigned ah[NL][4], al[NL][4] = {};
#pragma unroll
        for (int o = 0; o < NL; ++o) {
            ldsm_x4(L + (o * DT + ar) * AS + ak, ah[o]);
            if constexpr (RESID) ldsm_x4(L + SL + (o * DT + ar) * AS + ak, al[o]);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            unsigned bh[NR][4], bl[NR][4] = {};
#pragma unroll
            for (int o = 0; o < NR; ++o) {
                ldsm_x4_t(R + (o * DK + bk) * BS + 16 * half + bc, bh[o]);
                if constexpr (RESID) ldsm_x4_t(R + SR + (o * DK + bk) * BS + 16 * half + bc, bl[o]);
            }
#pragma unroll
            for (int o = 0; o < NOP; ++o)
#pragma unroll
                for (int j = 0; j < 2; ++j)
                    mma_tier<RESID>(acc[o][2 * half + j], ah[AX == 0 ? o : 0],
                                    al[AX == 0 ? o : 0], bh[AX == 0 ? 0 : o],
                                    bl[AX == 0 ? 0 : o], j);
        }
    };
    fetch(kb);
    stash(ring);
    const int nslab = (ke - kb) / DK;
    for (int s = 0; s < nslab; ++s) {
        group_sync(bar);   // stage s % 2 is complete, and the group has left the other one
        const bool more = s + 1 < nslab;
        if (more) fetch(kb + (s + 1) * DK);
        products(ring + (s % 2) * STAGE);
        if (more) stash(ring + ((s + 1) % 2) * STAGE);
    }
}

// The x and y circulant products of the 32 x 32 tile at (i0, j0), for NOP
// operands: X[o] = d_x (operand o) and Y[o] = d_y (operand o) at this
// thread's four pixels (row threadIdx.x / 8, columns 4 (threadIdx.x % 8)..
// of the tile), either skipped (zero) when has_x / has_y is false; DxT and
// Dy are FP32 (n, n), at 'high' their (2, n, n) bf16 split, at 'bf16' their
// (n, n) bf16 heads. Four groups of 64 threads take (x, y) x (two halves of
// the contraction's slabs), or four quarters of the one product asked for,
// and meet in shared memory; sm holds 4 group_floats(NOP, TIER). Every
// thread of the block must call it.
template <int NOP, int TIER, bool EDGE, class Op>
__device__ __forceinline__ void dense_xy_at(const void* __restrict__ DxT,
                                            const void* __restrict__ Dy, int Ny, int Nx, int i0,
                                            int j0, float* sm, bool has_x, bool has_y, Op op,
                                            float4 (&X)[NOP], float4 (&Y)[NOP]) {
    const int tid = threadIdx.x, g = tid / DGROUP, gt = tid % DGROUP;
    const int nsx = (Nx + DK - 1) / DK, nsy = (Ny + DK - 1) / DK;   // slabs of each product
    const bool four = has_x != has_y && (has_x ? nsx : nsy) >= 4;
    const int nsplit = four ? 4 : 2, kh = four ? g : g >> 1;
    const int axis = four ? (has_x ? 0 : 1) : g & 1;
    const int ns = axis == 0 ? nsx : nsy;
    const int kb = kh * ns / nsplit * DK, ke = (kh + 1) * ns / nsplit * DK;
    float acc[NOP][4][4];
#pragma unroll
    for (int o = 0; o < NOP; ++o)
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) acc[o][a][b] = 0.f;
    constexpr bool RESID = TIER == TIER_HIGH;
    float* stage = sm + g * group_floats(NOP, TIER);
    if (axis == 0 ? has_x : has_y) {
        if constexpr (TIER != TIER_F32) {
            if (axis == 0)
                dense_tile_bf16<0, NOP, EDGE, RESID>(static_cast<const __nv_bfloat16*>(DxT), Nx,
                                                     i0, j0, kb, ke, stage, gt, 1 + g, op, acc);
            else
                dense_tile_bf16<1, NOP, EDGE, RESID>(static_cast<const __nv_bfloat16*>(Dy), Ny,
                                                     i0, j0, kb, ke, stage, gt, 1 + g, op, acc);
        } else {
            if (axis == 0)
                dense_tile<0, NOP, EDGE>(static_cast<const float*>(DxT), Nx, i0, j0, kb, ke, stage,
                                         gt, 1 + g, op, acc);
            else
                dense_tile<1, NOP, EDGE>(static_cast<const float*>(Dy), Ny, i0, j0, kb, ke, stage,
                                         gt, 1 + g, op, acc);
        }
    }
    __syncthreads();   // every group has left its stages: reuse them for the partial tiles
    if constexpr (TIER != TIER_F32) {   // C layout: (row 16 w + lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2)
        const int lane = gt % 32, r0 = 16 * (gt / 32) + lane / 4, c0 = 2 * (lane % 4);
#pragma unroll
        for (int o = 0; o < NOP; ++o)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 4; e += 2)
                    *reinterpret_cast<float2*>(sm + ((g * NOP + o) * DT + r0 + 4 * e) * DT + 8 * j +
                                               c0) = make_float2(acc[o][j][e], acc[o][j][e + 1]);
    } else {
        const int ti = (gt / 8) * 4, tj = (gt % 8) * 4;
#pragma unroll
        for (int o = 0; o < NOP; ++o)
#pragma unroll
            for (int a = 0; a < 4; ++a)
                *reinterpret_cast<float4*>(sm + ((g * NOP + o) * DT + ti + a) * DT + tj) =
                    make_float4(acc[o][a][0], acc[o][a][1], acc[o][a][2], acc[o][a][3]);
    }
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

// ... of the block's own tile (blockIdx.y, blockIdx.x)
template <int NOP, int TIER, bool EDGE, class Op>
__device__ __forceinline__ void dense_xy(const void* __restrict__ DxT,
                                         const void* __restrict__ Dy, int Ny, int Nx, float* sm,
                                         bool has_x, bool has_y, Op op, float4 (&X)[NOP],
                                         float4 (&Y)[NOP]) {
    dense_xy_at<NOP, TIER, EDGE>(DxT, Dy, Ny, Nx, blockIdx.y * DT, blockIdx.x * DT, sm, has_x,
                                 has_y, op, X, Y);
}

int tiles(int n) { return (n + DT - 1) / DT; }

bool dense_shape_ok(int Ny, int Nx, int nz) {
    return Ny > 0 && Nx > 0 && nz > 0 && tiles(Ny) <= 65535 && nz <= 65535;
}

// whether a launch over (Ny, Nx) planes has ragged edge tiles or slabs
bool has_edge(int Ny, int Nx) { return Ny % DT != 0 || Nx % DT != 0; }

template <class K>
int allow(K kernel, size_t bytes) {
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)bytes);
}

// The launcher of `tier` among FP32, 'high' and 'bf16', with the edge
// guards or without (nullptr for another tier).
template <class F>
F dense_fn(int tier, bool edge, F f32, F f32e, F high, F highe, F bf16, F bf16e) {
    return tier == TIER_F32    ? (edge ? f32e : f32)
           : tier == TIER_HIGH ? (edge ? highe : high)
           : tier == TIER_BF16 ? (edge ? bf16e : bf16)
                               : nullptr;
}

}  // namespace
