// Device helpers shared by the dense (lenseflow.cu) and factored
// (factored.cu, uni.cu through fact_tile.cuh) LenseFlow kernels: p(t) and
// the delta-phi integrands, the precision tiers, and the bf16 tensor-core
// products of the 'high' and 'bf16' tiers.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

// Phase probe (scripts/torch_kernel_phases.py builds a source with
// LF_CLOCK_PHASES defined; the library the port loads never does): thread 0
// of each block adds the clock64 cycles since its previous mark t to phase
// i's sum, lf_phase_ticks[i], read and cleared through the C entries below.
#ifdef LF_CLOCK_PHASES
constexpr int LF_NPHASE = 16;
__device__ unsigned long long lf_phase_ticks[LF_NPHASE];
__device__ __forceinline__ void lf_clock_mark(int i, long long& t) {
    if (threadIdx.x == 0) {
        const long long now = clock64();
        atomicAdd(&lf_phase_ticks[i], (unsigned long long)(now - t));
        t = now;
    }
}
#define LF_CLOCK_START(t) long long t = clock64()
#define LF_CLOCK(i, t) lf_clock_mark(i, t)
extern "C" int lf_phase_ticks_read(unsigned long long* host) {
    return (int)cudaMemcpyFromSymbol(host, lf_phase_ticks, sizeof(lf_phase_ticks));
}
extern "C" int lf_phase_ticks_clear() {
    const unsigned long long zero[LF_NPHASE] = {};
    return (int)cudaMemcpyToSymbol(lf_phase_ticks, zero, sizeof(zero));
}
#else
#define LF_CLOCK_START(t)
#define LF_CLOCK(i, t)
#endif

// The precision tiers of the derivative products, the value of every C
// entry's `tier` argument (ops/lenseflow_kernels.py::PRECISIONS, in order):
// FP32 FMA; 'high', the bf16 head/residual split, three bf16 products a
// product; 'bf16', one bf16 product of the operands rounded to nearest
// even. The two bf16 tiers accumulate in FP32 on mma.sync.
enum Tier { TIER_F32 = 0, TIER_HIGH = 1, TIER_BF16 = 2 };

// Where the factored kernels run fact_tile (fact_tile.cuh;
// factored_kernels.cuh, uni.cu), by radix and tier: the host's table
// (ops/lenseflow_kernels.py::FORMS, with the A/B in turns that chose it),
// which the build passes as one bitmask for each kernel (ops/_build.py::
// form_flags: bit 2 tier + (B == 8)). Radix 16 and 32, and every tier and
// radix a mask leaves out, run the cluster tile (fact_sm90.cuh;
// fa_sm90.cu, bv_sm90.cu, uni_sm90.cu), as K1 (lf_fderiv, fderiv_sm90.cu)
// does at every tier and radix: it has no mask. Each kernel is
// built on the one tile the table names for it; a source built without
// the flags has none of these.
#if defined(LF_FA_ON_TILE) && defined(LF_BV_ON_TILE) && defined(LF_UNI_ON_TILE)
__host__ __device__ constexpr bool on_tile(int mask, int B, int tier) {
    return (B == 4 || B == 8) && (mask >> (2 * tier + (B == 8)) & 1);
}
__host__ __device__ constexpr bool k3_on_tile(int B, int tier) {
    return on_tile(LF_FA_ON_TILE, B, tier);
}
__host__ __device__ constexpr bool k4_on_tile(int B, int tier) {
    return on_tile(LF_BV_ON_TILE, B, tier);
}
__host__ __device__ constexpr bool k5_on_tile(int B, int tier) {
    return on_tile(LF_UNI_ON_TILE, B, tier);
}
#endif

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

// The five hoisted delta-phi integrands of the backward flow at a pixel,
// from phi's five values there (gx, gy, hxx, hxy, hyy) and w = sum_c
// delta f_c grad f_c: u = M^-1(t) w, then
// (u_x, u_y, t p_x u_x, t (p_y u_x + p_x u_y), t p_y u_y) into out.
__device__ __forceinline__ void dphi_values(const float (&ph)[5], float t, float wx, float wy,
                                            float (&out)[5]) {
    const float gx = ph[0], gy = ph[1];
    const float a = 1.f + t * ph[2];
    const float b = t * ph[3];
    const float d = 1.f + t * ph[4];
    const float idet = 1.f / (a * d - b * b);
    const float px = (d * gx - b * gy) * idet, py = (-b * gx + a * gy) * idet;
    const float m11 = d * idet, m12 = -b * idet, m22 = a * idet;
    const float ux = m11 * wx + m12 * wy;
    const float uy = m12 * wx + m22 * wy;
    out[0] = ux;
    out[1] = uy;
    out[2] = t * px * ux;
    out[3] = t * (py * ux + px * uy);
    out[4] = t * py * uy;
}

// The same at pixel o of phi's planes (stride `plane`), written to the
// planes acc[0..4].
__device__ __forceinline__ void dphi_integrands(const float* __restrict__ phi, size_t plane,
                                                size_t o, float t, float wx, float wy,
                                                float* __restrict__ acc) {
    const float ph[5] = {phi[o], phi[plane + o], phi[2 * plane + o], phi[3 * plane + o],
                         phi[4 * plane + o]};
    float out[5];
    dphi_values(ph, t, wx, wy, out);
    for (int i = 0; i < 5; ++i) acc[i * plane + o] = out[i];
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
