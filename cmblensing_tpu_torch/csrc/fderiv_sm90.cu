// K1 at 'high' and 'bf16' for NVIDIA Hopper (sm_90a): the radix-B factored
// derivative d_x a or d_y a, one launch a pass at every radix, its channel
// groups the CTAs of one thread-block cluster.
//
// Replaces, at the tiers 'high' and 'bf16', the factored in-kernel
// derivative `_fact_apply` / `_make_ddx_ddy_fact` of
// cmblensing_tpu/ops/pallas_lenseflow.py (:249, :273) with its products
// `_mk_dot('high')` (:225) and `_mk_dot('bf16')` (:218): lf_fderiv
// (factored.cu) runs this kernel at TIER_HIGH and TIER_BF16 and keeps
// fact_tile (fact_tile.cuh) for the strict tier. K3, K4 and K5 still run
// fact_tile at every tier.
//
// The operator (fact_tile.cuh's header has it in full): along an axis of
// length N = B * A (A = FA = 128), the forward butterfly
// u_c = sum_r Rf[c][r] x_r over the B blocks r of the operand, the block
// products y_0 = G_0 u_0, y_{B-1} = G_{B/2} u_{B-1} and, for each complex
// pair, (Ar u_re - Ai u_im, Ai u_re + Ar u_im), then the inverse
// butterfly out_r = sum_c Ri[r][c] y_c.
//
// Tile and cluster. A tile is every value of the in-block index m (all
// 128) by TO = 16 pixels across the axis, so each operand strip is read by
// one tile. Its B channels are split over the NC CTAs of a cluster: NC = 2
// at radix 4, 8 and 16, 4 at radix 32, each CTA holding BC = B / NC
// channels (2, 4, 8, 8) as channel pairs (the real pair (0, B - 1) in CTA
// 0). A 1024^2 pass is 64 tiles, 128 CTAs; a 4096^2 pass 256 tiles, 1024
// CTAs. Each CTA forms its BC channels from all B operand rows (fmaf from 0
// over r in order, the order ops/factored_deriv.py::_butterfly_fma
// mirrors), rounds them (to the bf16 head, and at 'high' the residual too),
// and runs its block products. Then, after a cluster barrier (every CTA
// has left its ring), each CTA pushes its channel outputs y_c through
// distributed shared memory to the CTA that owns their pixels (CTA p owns
// m in [p MQ, (p + 1) MQ), MQ = 128 / NC) and receives there all B channels
// of its share; after a second cluster barrier (every push has landed),
// each CTA sums all B output rows of its pixels over the B channels, in one
// fixed order, from its own shared memory, and stores each pixel once: no
// atomics and no read-modify-write, so the bits repeat from run to run by
// construction, and no CTA touches another's memory after the second
// barrier, so none waits for another before it exits. Pushing (stores)
// where the first form of this kernel pulled (loads of the other CTAs'
// y_c after the barrier) took the exchange, sums and stores with their
// barriers from 35 % of a radix-32 'bf16' CTA's cycles to 29 %, the pass
// 0.87-0.94x (scripts/torch_kernel_phases.py). The operand reaches
// the cluster from device memory once per tile: the cluster's CTAs run
// together and load the same strip, so all but the first read of a line
// hit the L2 (no multicast).
//
// Phases overlap. One producer warp streams the CTA's block k-slabs (TK =
// 16 rows of 128 m, 4 KB a block and half) by cp.async.bulk into a ring of
// three stages behind full / empty mbarriers; the blocks are repacked once
// on the host (ops/factored_deriv.py::swizzle_blocks, FactoredOps.FXW /
// FYTW), each row's 16-byte chunks permuted by the row index, so that the
// contiguous bulk copy lands in a layout ldmatrix reads without bank
// conflicts. Eight consumer warps load the operand, each thread the B
// values of its slab position, a slab ahead into registers (cached in the
// L2 alone: 0.90x the time at 2048^2, the same elsewhere); they run a
// slab's products, then form and round the next slab's channels into a
// double-buffered channel slab. Those loads and the channels they feed are
// what still holds a radix-32 CTA back (50 % of its cycles): four CTAs load
// each strip, and a CTA of 9 warps (one an SM, the registers' limit) hides
// little of their latency. Staging the operand in shared memory instead ran
// slower: as 512 64-byte bulk copies a slab from the producer, 3-5x (the
// copy engine's cost per copy set the pace); as one box of a 4-D tensor map
// a slab, 1.0-1.2x at radix 32 (NVIDIA H100 80GB HBM3, 700 W).
//
// Products on mma.sync (m16n8k16, bf16 in, FP32 accumulate), not wgmma:
// what bounds this kernel is the FP32 butterfly work (4 B operations a
// pixel, forward and inverse: 0.033 ms a 4096^2 pass at the FP32 peak)
// and its bytes, not the tensor cores (the products of a 4096^2 'bf16'
// pass are 8.3 GFLOP, 0.0084 ms at the bf16 peak, three times that at
// 'high'), and the consumer warps that form a channel slab are the ones
// that hold it, so mma.sync reads it with ldmatrix from padded rows where
// wgmma would need its canonical layout written by those warps and one
// more barrier a slab.
//
// Shared memory (radix 32, 'high'): a ring of three 64 KB block stages (8
// blocks' head and residual slabs), which receives the y_c of the CTA's
// share (64 KB) after the last slab; two channel slabs (24 KB); the
// butterflies (5 KB): 221 KB, one CTA an SM. 'bf16': 113 KB.
//
// Plain C++ entry (lf_sm90::fderiv, called by lf_fderiv) and a C entry for
// set-up (lf_fderiv_sm90_init) and the cluster-fit query; every launch goes
// on the caller's stream and returns its error code: a refused cluster
// launch raises in the wrapper.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "lenseflow_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int FA = 128;          // block size A
constexpr int TO = 16;           // tile pixels across the axis
constexpr int TK = 16;           // contraction slab: one mma k step
constexpr int NCW = 8;           // consumer warps
constexpr int NCT = 32 * NCW;    // consumer threads: one operand-slab position each
constexpr int NT = NCT + 32;     // and the producer warp
constexpr int US = TO + 8;       // row stride (bf16) of a staged channel slab [c][k][o]
static_assert(TO * TK == NCT, "a consumer thread forms one slab position");

enum Axis { AXIS_X = 0, AXIS_Y = 1 };

__host__ __device__ constexpr int cluster_ctas(int B) { return B == 32 ? 4 : 2; }
__host__ __device__ constexpr int halves(int tier) { return tier == TIER_HIGH ? 2 : 1; }
constexpr int NSTAGE = 3;        // block-slab stages of the ring
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// bytes of a ring stage: the CTA's block slabs (bf16 [half][slot][k][m])
__host__ __device__ constexpr int stage_bytes(int B, int tier) {
    return halves(tier) * (B / cluster_ctas(B)) * TK * FA * 2;
}
// the values of m whose output pixels a CTA sums and stores (a quarter or a
// half of the tile)
__host__ __device__ constexpr int mquarter(int B) { return FA / cluster_ctas(B); }
// bytes of the ring (reused to receive the channel outputs y_c of the
// CTA's share of the tile, all B channels), the channel slabs and the
// butterfly rows, then the mbarriers
__host__ __device__ constexpr int ring_bytes(int B, int tier) {
    return cmax(NSTAGE * stage_bytes(B, tier), 4 * B * mquarter(B) * TO);
}
__host__ __device__ constexpr int useg_bytes(int B, int tier) {
    return 2 * halves(tier) * (B / cluster_ctas(B)) * TK * US * 2;
}
// the CTA's rows of the forward butterfly, and the inverse one
__host__ __device__ constexpr int bfly_bytes(int B) { return 4 * ((B / cluster_ctas(B)) * B + B * B); }
__host__ __device__ constexpr size_t smem_bytes(int B, int tier) {
    return (size_t)ring_bytes(B, tier) + useg_bytes(B, tier) + bfly_bytes(B) + 2 * NSTAGE * 8;
}
static_assert(smem_bytes(32, TIER_HIGH) <= 232448 && smem_bytes(32, TIER_BF16) <= 232448,
              "a CTA's shared memory fits the 227 KB a block may have");

// The channel and the packed block ([G_0, G_{B/2}, Ar.., Ai..]) that slot s
// of CTA q holds: slots 2 i, 2 i + 1 are its pair i, the real pair (0,
// B - 1; G_0, G_{B/2}) as pair 0 of CTA 0, else complex pair p (channels
// 2p - 1, 2p; blocks Ar_p, Ai_p).
template <int B>
__host__ __device__ constexpr int slot_channel(int q, int s) {
    const int p = q * (B / cluster_ctas(B) / 2) + s / 2;
    return p == 0 ? (s % 2 == 0 ? 0 : B - 1) : 2 * p - 1 + s % 2;
}
template <int B>
__host__ __device__ constexpr int slot_block(int q, int s) {
    const int p = q * (B / cluster_ctas(B) / 2) + s / 2;
    return p == 0 ? s % 2 : (s % 2 == 0 ? 1 + p : B / 2 + p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    unsigned done;
    do {
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}\n"
            : "=r"(done)
            : "r"(smem_addr(bar)), "r"(parity)
            : "memory");
    } while (!done);
}

// bytes from global to this CTA's shared memory, completing on bar
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
            "r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

__device__ __forceinline__ void consumer_sync() {
    asm volatile("bar.sync 1, %0;" ::"n"(NCT) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

// K1 at TIER (HIGH or BF16) along AXIS over gridDim.y planes:
// out = D a (+ c), or out += D a where `accumulate`. W holds the packed
// blocks transposed (Gt[c][k][m]) as their bf16 [head, residual] split,
// rows swizzled (swizzle_blocks), (2, B, A, A); 'bf16' reads the heads.
// bf is (2, B, B) [Rf, Ri]. blockIdx.x = tile * NC + rank in the cluster.
template <int B, int AXIS, int TIER>
__global__ void __launch_bounds__(NT, 1)
fderiv_sm90_kernel(const float* __restrict__ a, const float* __restrict__ c,
                   float* __restrict__ out, const __nv_bfloat16* __restrict__ W,
                   const float* __restrict__ bf, int Ny, int Nx, int accumulate) {
    constexpr int NC = cluster_ctas(B), BC = B / NC, NH = halves(TIER), MQ = mquarter(B);
    constexpr int NST = NSTAGE, SB = stage_bytes(B, TIER);
    constexpr bool RESID = TIER == TIER_HIGH;
    constexpr int NP = BC / 2, WPP = NCW / NP, MT = FA / 16 / WPP;   // pairs; warps a pair; m16 tiles a warp
    constexpr int NS = FA / TK;                // slabs
    constexpr int SLAB = TK * FA;              // bf16 of a block slab
    constexpr int ULEN = BC * TK * US;         // bf16 of one half of a channel slab
    extern __shared__ __align__(128) unsigned char smem[];
    float* sR = reinterpret_cast<float*>(smem);   // the ring, after the last slab: [c][..]
    __nv_bfloat16* sU = reinterpret_cast<__nv_bfloat16*>(smem + ring_bytes(B, TIER));
    float* sRf = reinterpret_cast<float*>(sU + 2 * NH * ULEN);
    float* sRi = sRf + BC * B;   // [r][q' BC + s']
    uint64_t* full = reinterpret_cast<uint64_t*>(sRi + B * B);
    uint64_t* empty = full + NST;
    auto stage = [&](int s) { return smem + (s % NST) * SB; };

    cg::cluster_group cluster = cg::this_cluster();
    const int q = (int)cluster.block_rank();
    const int o0 = (blockIdx.x / NC) * TO;
    const size_t base = (size_t)blockIdx.y * Ny * Nx;
    const int tid = threadIdx.x, lane = tid % 32, wid = tid / 32;
    LF_CLOCK_START(lf_t);   // phases 0-11, marked by thread 0 (consumer warp 0)

    for (int p = tid; p < BC * B; p += NT) sRf[p] = bf[slot_channel<B>(q, p / B) * B + p % B];
    for (int p = tid; p < B * B; p += NT) {
        const int j = p % B;
        sRi[p] = bf[B * B + (p / B) * B + slot_channel<B>(j / BC, j % BC)];
    }
    if (tid == 0) {
        for (int s = 0; s < NST; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, NCW);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    LF_CLOCK(0, lf_t);   // set-up
    // a consumer warp's channel outputs, accX[t][j]: m16 tile t of the warp,
    // n8 tile j, in the mma C layout
    float accA[MT][2][4], accB[MT][2][4];

    if (wid == NCW) {
        // producer: slab s's blocks, in slot order, into stage s
        for (int s = 0; s < NS; ++s) {
            const int st = s % NST;
            if (s >= NST) mbar_wait(empty + st, (s / NST - 1) & 1);
            if (lane == 0) mbar_expect_tx(full + st, SB);
            __syncwarp();
            for (int i = lane; i < NH * BC; i += 32)
                bulk_g2s(stage(s) + i * SLAB * 2,
                         W + ((size_t)((i / BC) * B + slot_block<B>(q, i % BC)) * FA + s * TK) * FA,
                         SLAB * 2, full + st);
            __syncwarp();
        }
    } else {
        const int pair = wid / WPP, mw = (wid % WPP) * MT * 16;
        const int chA = 2 * pair, chB = chA + 1;   // slots: channels and blocks alike
        const bool real = q == 0 && pair == 0;
        // this thread's operand-slab position (kk, o): its B values come
        // into registers a slab ahead
        const int kk = AXIS == AXIS_Y ? tid / TO : tid % TK;
        const int o = AXIS == AXIS_Y ? tid % TO : tid / TK;
        const float* ap = a + base + (AXIS == AXIS_Y ? (size_t)kk * Nx + o0 + o
                                                     : (size_t)(o0 + o) * Nx + kk);
        const size_t kstep = AXIS == AXIS_Y ? (size_t)TK * Nx : TK;
        const size_t rstep = AXIS == AXIS_Y ? (size_t)FA * Nx : FA;
        float raw[B];
        auto fetch = [&](int s) {
#pragma unroll
            for (int r = 0; r < B; ++r) raw[r] = __ldcg(ap + s * kstep + r * rstep);
        };
        auto butterfly = [&](__nv_bfloat16* u) {
#pragma unroll
            for (int ch = 0; ch < BC; ++ch) {
                float v = 0.f;
#pragma unroll
                for (int r = 0; r < B; r += 4) {
                    const float4 w = ld4(sRf + ch * B + r);
                    v = fmaf(w.x, raw[r], v);
                    v = fmaf(w.y, raw[r + 1], v);
                    v = fmaf(w.z, raw[r + 2], v);
                    v = fmaf(w.w, raw[r + 3], v);
                }
                const __nv_bfloat16 h = __float2bfloat16_rn(v);
                u[(ch * TK + kk) * US + o] = h;
                if constexpr (RESID)
                    u[ULEN + (ch * TK + kk) * US + o] = __float2bfloat16_rn(v - __bfloat162float(h));
            }
        };
#pragma unroll
        for (int t = 0; t < MT; ++t)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) accA[t][j][e] = accB[t][j][e] = 0.f;
        // ldmatrix rows this lane names: A (m x k) from the [k][m] block rows,
        // B (k x o) from the [k][o] channel rows (fact_tile.cuh's slab_mma)
        const int ka = (lane & 7) + (lane >> 4) * 8, ma = ((lane >> 3) & 1) * 8;
        const int kb = (lane & 7) + ((lane >> 3) & 1) * 8, ob = (lane >> 4) * 8;
        const int swz = (lane & 7) << 3;   // the block rows' chunk permutation at row ka
        auto products = [&](const __nv_bfloat16* sG, const __nv_bfloat16* u) {
            unsigned uAh[4], uAl[4] = {}, uBh[4], uBl[4] = {};
            ldsm_x4_t(u + (chA * TK + kb) * US + ob, uAh);
            ldsm_x4_t(u + (chB * TK + kb) * US + ob, uBh);
            if constexpr (RESID) {
                ldsm_x4_t(u + ULEN + (chA * TK + kb) * US + ob, uAl);
                ldsm_x4_t(u + ULEN + (chB * TK + kb) * US + ob, uBl);
            }
#pragma unroll
            for (int t = 0; t < MT; ++t) {
                const int at = ka * FA + ((mw + 16 * t + ma) ^ swz);
                unsigned aAh[4], aAl[4] = {}, aBh[4], aBl[4] = {};
                ldsm_x4_t(sG + chA * SLAB + at, aAh);
                ldsm_x4_t(sG + chB * SLAB + at, aBh);
                if constexpr (RESID) {
                    ldsm_x4_t(sG + (BC + chA) * SLAB + at, aAl);
                    ldsm_x4_t(sG + (BC + chB) * SLAB + at, aBl);
                }
                unsigned nBh[4], nBl[4];   // -Ai: the sign bits flipped, exact
#pragma unroll
                for (int i = 0; i < 4; ++i) nBh[i] = aBh[i] ^ 0x80008000u, nBl[i] = aBl[i] ^ 0x80008000u;
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    if (real) {
                        mma_tier<RESID>(accA[t][j], aAh, aAl, uAh, uAl, j);
                        mma_tier<RESID>(accB[t][j], aBh, aBl, uBh, uBl, j);
                    } else {
                        mma_tier<RESID>(accA[t][j], aAh, aAl, uAh, uAl, j);
                        mma_tier<RESID>(accA[t][j], nBh, nBl, uBh, uBl, j);
                        mma_tier<RESID>(accB[t][j], aBh, aBl, uAh, uAl, j);
                        mma_tier<RESID>(accB[t][j], aAh, aAl, uBh, uBl, j);
                    }
                }
            }
        };

        fetch(0);
        butterfly(sU);
        LF_CLOCK(1, lf_t);   // the first slab's operand and channels
        for (int s = 0; s < NS; ++s) {
            if (s + 1 < NS) fetch(s + 1);
            LF_CLOCK(4, lf_t);   // the next operand slab's loads issued
            consumer_sync();   // channel slab s is formed, and every warp has left slab s - 1's
            LF_CLOCK(3, lf_t);   // waiting for the other consumer warps
            mbar_wait(full + s % NST, (s / NST) & 1);
            LF_CLOCK(2, lf_t);   // waiting for the block slab
            products(reinterpret_cast<const __nv_bfloat16*>(stage(s)), sU + (s % 2) * NH * ULEN);
            __syncwarp();
            if (lane == 0) mbar_arrive(empty + s % NST);   // stage s read
            LF_CLOCK(5, lf_t);   // the products
            if (s + 1 < NS) {
                butterfly(sU + ((s + 1) % 2) * NH * ULEN);
                LF_CLOCK(6, lf_t);   // the next slab's channels (its loads' latency included)
            }
        }
        LF_CLOCK(7, lf_t);   // the last slab
    }
    cluster.sync();   // every CTA of the cluster has left its ring: it may receive
    LF_CLOCK(8, lf_t);   // the first cluster barrier

    // Each consumer thread pushes its channel outputs y_c (its accumulators)
    // to the CTA that sums their pixels: CTA p takes m in [p MQ, (p + 1) MQ)
    // and receives all B channels there, in (CTA, slot) order, as
    // sR[c][m - p MQ][o] (y pass) or sR[c][o][m - p MQ] (x pass), through
    // distributed shared memory; stores, so no load's latency stalls.
    if (wid < NCW) {
        const int pair = wid / WPP, mw = (wid % WPP) * MT * 16;
        const int cA = q * BC + 2 * pair, cB = cA + 1;
        float* dst[NC];
#pragma unroll
        for (int p = 0; p < NC; ++p) dst[p] = cluster.map_shared_rank(sR, p);
#pragma unroll
        for (int t = 0; t < MT; ++t)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int e = 0; e < 4; e += 2) {   // C layout: (m, o), (m, o + 1)
                    const int m = mw + 16 * t + lane / 4 + 4 * e, ov = 8 * j + 2 * (lane % 4);
                    float* d = dst[m / MQ];
                    const int ml = m % MQ;
                    if (AXIS == AXIS_Y) {
                        *reinterpret_cast<float2*>(d + (cA * MQ + ml) * TO + ov) =
                            make_float2(accA[t][j][e], accA[t][j][e + 1]);
                        *reinterpret_cast<float2*>(d + (cB * MQ + ml) * TO + ov) =
                            make_float2(accB[t][j][e], accB[t][j][e + 1]);
                    } else {
                        d[(cA * TO + ov) * MQ + ml] = accA[t][j][e];
                        d[(cA * TO + ov + 1) * MQ + ml] = accA[t][j][e + 1];
                        d[(cB * TO + ov) * MQ + ml] = accB[t][j][e];
                        d[(cB * TO + ov + 1) * MQ + ml] = accB[t][j][e + 1];
                    }
                }
    }
    LF_CLOCK(9, lf_t);   // the pushes issued
    cluster.sync();   // every push has landed; no CTA reads or writes another's memory after
    LF_CLOCK(10, lf_t);   // the second cluster barrier

    // The inverse butterfly of this CTA's share: all B output rows r of its
    // pixels, each pair of pixels adjacent in memory (along o in the y pass,
    // m in the x pass) one thread's, summed over the B channels in (CTA,
    // slot) order and stored once.
    if (tid < NCT) {
        constexpr int NPAIR = MQ * TO / 2 / NCT;   // pairs a thread: 1 (radix 32) or 2
#pragma unroll 1
        for (int jp = 0; jp < NPAIR; ++jp) {
            const int idx = tid + jp * NCT;
            const int ml = AXIS == AXIS_Y ? idx / (TO / 2) : idx % (MQ / 2) * 2;
            const int ov = AXIS == AXIS_Y ? idx % (TO / 2) * 2 : idx / (MQ / 2);
            const int at = AXIS == AXIS_Y ? ml * TO + ov : ov * MQ + ml;
            const int m = q * MQ + ml;
            float2 y[B];
#pragma unroll
            for (int j = 0; j < B; ++j) y[j] = *reinterpret_cast<const float2*>(sR + j * MQ * TO + at);
#pragma unroll 4
            for (int r = 0; r < B; ++r) {
                float2 v = make_float2(0.f, 0.f);
#pragma unroll
                for (int j = 0; j < B; j += 4) {
                    const float4 w = ld4(sRi + r * B + j);
                    v.x = fmaf(w.x, y[j].x, v.x), v.y = fmaf(w.x, y[j].y, v.y);
                    v.x = fmaf(w.y, y[j + 1].x, v.x), v.y = fmaf(w.y, y[j + 1].y, v.y);
                    v.x = fmaf(w.z, y[j + 2].x, v.x), v.y = fmaf(w.z, y[j + 2].y, v.y);
                    v.x = fmaf(w.w, y[j + 3].x, v.x), v.y = fmaf(w.w, y[j + 3].y, v.y);
                }
                const size_t at_o = base + (AXIS == AXIS_Y ? (size_t)(r * FA + m) * Nx + o0 + ov
                                                           : (size_t)(o0 + ov) * Nx + r * FA + m);
                if (c != nullptr) {
                    const float2 cv = *reinterpret_cast<const float2*>(c + at_o);
                    v.x += cv.x, v.y += cv.y;
                }
                if (accumulate) {
                    const float2 ov2 = *reinterpret_cast<const float2*>(out + at_o);
                    v.x += ov2.x, v.y += ov2.y;
                }
                *reinterpret_cast<float2*>(out + at_o) = v;
            }
        }
    }
    LF_CLOCK(11, lf_t);   // the inverse butterfly: sums and stores
}

template <int B, int AXIS, int TIER>
cudaLaunchConfig_t launch_config(cudaLaunchAttribute* attr, unsigned ntile, unsigned nplanes,
                                 cudaStream_t st) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(ntile * cluster_ctas(B), nplanes, 1);
    cfg.blockDim = dim3(NT, 1, 1);
    cfg.dynamicSmemBytes = smem_bytes(B, TIER);
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster_ctas(B);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

template <int B, int AXIS, int TIER>
int launch(const float* x, const float* c, float* out, const void* W, const float* bf, int Ny,
           int Nx, int nplanes, int accumulate, cudaStream_t st) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg =
        launch_config<B, AXIS, TIER>(attr, (AXIS == AXIS_Y ? Nx : Ny) / TO, nplanes, st);
    const int rc = (int)cudaLaunchKernelEx(&cfg, fderiv_sm90_kernel<B, AXIS, TIER>, x, c, out,
                                           static_cast<const __nv_bfloat16*>(W), bf, Ny, Nx,
                                           accumulate);
    return rc != 0 ? rc : (int)cudaGetLastError();
}

template <int AXIS, int TIER>
int pass(int Bv, const float* x, const float* c, float* out, const void* W, const float* bf,
         int Ny, int Nx, int nplanes, int accumulate, cudaStream_t st) {
    switch (Bv) {
        case 4: return launch<4, AXIS, TIER>(x, c, out, W, bf, Ny, Nx, nplanes, accumulate, st);
        case 8: return launch<8, AXIS, TIER>(x, c, out, W, bf, Ny, Nx, nplanes, accumulate, st);
        case 16: return launch<16, AXIS, TIER>(x, c, out, W, bf, Ny, Nx, nplanes, accumulate, st);
        case 32: return launch<32, AXIS, TIER>(x, c, out, W, bf, Ny, Nx, nplanes, accumulate, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <int TIER>
int fderiv_tier(const float* a, const float* b, const float* c, float* out, const void* WX,
                const void* WYT, const float* bfx, const float* bfy, int Bx, int By, int nplanes,
                int Ny, int Nx, cudaStream_t st) {
    if (a != nullptr) {
        const int rc = pass<AXIS_X, TIER>(Bx, a, c, out, WX, bfx, Ny, Nx, nplanes, 0, st);
        if (rc != 0 || b == nullptr) return rc;
    }
    return pass<AXIS_Y, TIER>(By, b, a != nullptr ? nullptr : c, out, WYT, bfy, Ny, Nx, nplanes,
                              a != nullptr, st);
}

// Allow a kernel its dynamic shared memory, and count the clusters of it
// that fit on the card at once (cudaOccupancyMaxActiveClusters) into *n.
template <int B, int AXIS, int TIER>
int prepare(int* n) {
    const auto k = fderiv_sm90_kernel<B, AXIS, TIER>;
    int rc = (int)cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem_bytes(B, TIER));
    if (rc != 0) return rc;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = launch_config<B, AXIS, TIER>(attr, 1, 1, 0);
    return (int)cudaOccupancyMaxActiveClusters(n, (const void*)k, &cfg);
}

template <int TIER>
int prepare_tier(int B, int* n) {
    int nx = 0, ny = 0, rc;
    switch (B) {
        case 4: rc = prepare<4, AXIS_X, TIER>(&nx); if (rc == 0) rc = prepare<4, AXIS_Y, TIER>(&ny); break;
        case 8: rc = prepare<8, AXIS_X, TIER>(&nx); if (rc == 0) rc = prepare<8, AXIS_Y, TIER>(&ny); break;
        case 16: rc = prepare<16, AXIS_X, TIER>(&nx); if (rc == 0) rc = prepare<16, AXIS_Y, TIER>(&ny); break;
        case 32: rc = prepare<32, AXIS_X, TIER>(&nx); if (rc == 0) rc = prepare<32, AXIS_Y, TIER>(&ny); break;
        default: return (int)cudaErrorInvalidValue;
    }
    *n = nx < ny ? nx : ny;
    return rc;
}

int prepare_any(int tier, int B, int* n) {
    return tier == TIER_HIGH   ? prepare_tier<TIER_HIGH>(B, n)
           : tier == TIER_BF16 ? prepare_tier<TIER_BF16>(B, n)
                               : (int)cudaErrorInvalidValue;
}

}  // namespace

namespace lf_sm90 {
// out = d_x a + d_y b + c over nplanes planes at `tier` ('high' or 'bf16');
// a or b (not both) and c may be null; out must not alias a or b. WX, WYT:
// the swizzled split blocks (2, B, A, A) bf16 of each axis. One launch a
// pass: the x pass stores, the y pass adds onto it in stream order.
int fderiv(int tier, const float* a, const float* b, const float* c, float* out, const void* WX,
           const void* WYT, const float* bfx, const float* bfy, int Bx, int By, int nplanes,
           int Ny, int Nx, void* stream) {
    if (Nx != Bx * FA || Ny != By * FA || (a == nullptr && b == nullptr) || nplanes < 1 ||
        nplanes > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (tier == TIER_HIGH)
        return fderiv_tier<TIER_HIGH>(a, b, c, out, WX, WYT, bfx, bfy, Bx, By, nplanes, Ny, Nx, st);
    if (tier == TIER_BF16)
        return fderiv_tier<TIER_BF16>(a, b, c, out, WX, WYT, bfx, bfy, Bx, By, nplanes, Ny, Nx, st);
    return (int)cudaErrorInvalidValue;
}
}  // namespace lf_sm90

// Once after loading, before any launch: every instantiation's dynamic
// shared memory, and a check that at least one of its clusters fits on the
// card (a cluster of 4 CTAs of 218 KB at radix 32 'high'); an error code
// where one does not.
extern "C" int lf_fderiv_sm90_init() {
    const int tiers[] = {TIER_HIGH, TIER_BF16}, radices[] = {4, 8, 16, 32};
    for (int tier : tiers)
        for (int B : radices) {
            int n = 0;
            const int rc = prepare_any(tier, B, &n);
            if (rc != 0) return rc;
            if (n < 1) return (int)cudaErrorInvalidConfiguration;
        }
    return 0;
}

#ifdef LF_CLOCK_PHASES
// the phase probe's entry to lf_sm90::fderiv (lf_fderiv lives in factored.cu)
extern "C" int lf_fderiv_sm90_probe(int tier, const float* a, const float* b, const float* c,
                                    float* out, const void* WX, const void* WYT, const float* bfx,
                                    const float* bfy, int Bx, int By, int nplanes, int Ny, int Nx,
                                    void* stream) {
    return lf_sm90::fderiv(tier, a, b, c, out, WX, WYT, bfx, bfy, Bx, By, nplanes, Ny, Nx, stream);
}
#endif

// The clusters of radix B at `tier` that fit on the card at once (the
// lesser of the two passes'), or minus a CUDA error code.
extern "C" int lf_fderiv_sm90_clusters(int tier, int B) {
    int n = 0;
    const int rc = prepare_any(tier, B, &n);
    return rc != 0 ? -rc : n;
}
