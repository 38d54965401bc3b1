// Device helpers shared by the dense (lenseflow.cu) and factored
// (factored.cu, uni.cu through fact_tile.cuh) LenseFlow kernels: p(t) and
// the delta-phi integrands, the precision tiers, and the bf16 tensor-core
// products of the 'high' and 'bf16' tiers.
#pragma once

#include <stddef.h>

// The precision tiers of the derivative products, the value of every C
// entry's `tier` argument (ops/lenseflow_kernels.py::PRECISIONS, in order):
// FP32 FMA; 'high', the bf16 head/residual split, three bf16 products a
// product; 'bf16', one bf16 product of the operands rounded to nearest
// even. The two bf16 tiers accumulate in FP32 on mma.sync.
enum Tier { TIER_F32 = 0, TIER_HIGH = 1, TIER_BF16 = 2 };

// p(t) = (I + t Hess phi)^-1 grad phi at pixel idx; phi holds the planes
// (gx, gy, hxx, hxy, hyy) with stride `plane`.
__device__ __forceinline__ void p_of_t(const float* __restrict__ phi, size_t plane,
                                       size_t idx, float t, float& px, float& py) {
    const float gx = phi[idx], gy = phi[plane + idx];
    const float a = 1.f + t * phi[2 * plane + idx];
    const float b = t * phi[3 * plane + idx];
    const float d = 1.f + t * phi[4 * plane + idx];
    const float idet = 1.f / (a * d - b * b);
    px = (d * gx - b * gy) * idet;
    py = (-b * gx + a * gy) * idet;
}

// The five hoisted delta-phi integrands of the backward flow at pixel o,
// from w = sum_c delta f_c grad f_c: u = M^-1(t) w, then
// (u_x, u_y, t p_x u_x, t (p_y u_x + p_x u_y), t p_y u_y), written to the
// planes acc[0..4] (stride `plane`).
__device__ __forceinline__ void dphi_integrands(const float* __restrict__ phi, size_t plane,
                                                size_t o, float t, float wx, float wy,
                                                float* __restrict__ acc) {
    const float gx = phi[o], gy = phi[plane + o];
    const float a = 1.f + t * phi[2 * plane + o];
    const float b = t * phi[3 * plane + o];
    const float d = 1.f + t * phi[4 * plane + o];
    const float idet = 1.f / (a * d - b * b);
    const float px = (d * gx - b * gy) * idet, py = (-b * gx + a * gy) * idet;
    const float m11 = d * idet, m12 = -b * idet, m22 = a * idet;
    const float ux = m11 * wx + m12 * wy;
    const float uy = m12 * wx + m22 * wy;
    acc[o] = ux;
    acc[plane + o] = uy;
    acc[2 * plane + o] = t * px * ux;
    acc[3 * plane + o] = t * (py * ux + px * uy);
    acc[4 * plane + o] = t * py * uy;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

// Four 8 x 8 bf16 matrices from shared memory; this lane names row
// (lane % 8) of matrix lane / 8.
__device__ __forceinline__ void ldsm_x4(const void* row, unsigned (&r)[4]) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(row)));
}

// Four 8 x 8 bf16 matrices from shared memory, each transposed on load;
// this lane names row (lane % 8) of matrix lane / 8.
__device__ __forceinline__ void ldsm_x4_t(const void* row, unsigned (&r)[4]) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(row)));
}

// d += a b: a 16 x 16 (row) by 16 x 8 (col) bf16 product, FP32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += (ah + al)(bh + bl) without al bl, as three products of n8 tile j
// of the B fragments (rows of four registers, two per n8 tile)
__device__ __forceinline__ void mma_high(float (&d)[4], const unsigned (&ah)[4],
                                         const unsigned (&al)[4], const unsigned (&bh)[4],
                                         const unsigned (&bl)[4], int j) {
    mma_bf16(d, ah, bh[2 * j], bh[2 * j + 1]);
    mma_bf16(d, al, bh[2 * j], bh[2 * j + 1]);
    mma_bf16(d, ah, bl[2 * j], bl[2 * j + 1]);
}

// The product of a bf16 tier: mma_high with the residuals (RESID, 'high'),
// or the heads' one product ('bf16'; al and bl unread)
template <bool RESID>
__device__ __forceinline__ void mma_tier(float (&d)[4], const unsigned (&ah)[4],
                                         const unsigned (&al)[4], const unsigned (&bh)[4],
                                         const unsigned (&bl)[4], int j) {
    if constexpr (RESID)
        mma_high(d, ah, al, bh, bl, j);
    else
        mma_bf16(d, ah, bh[2 * j], bh[2 * j + 1]);
}
