// The radix-B factored derivative as a tiled device function, shared by
// the factored LenseFlow kernels that run it at radix 4 and 8 where the
// host's table puts them (lenseflow_common.cuh::k3_on_tile, k4_on_tile,
// k5_on_tile; ops/lenseflow_kernels.py::FORMS;
// factored_kernels.cuh, uni.cu). Every other form, radix 16 and 32 among
// them, runs the cluster tile fact_sm90 (fact_sm90.cuh; fderiv_sm90.cu,
// fa_sm90.cu, bv_sm90.cu, uni_sm90.cu: one launch a pass, the channels
// split over the CTAs of a cluster), whose strict tier repeats this tile's
// FMA order (slab_fma) and so its bits. Nothing builds this tile at radix
// 16 or 32 any more, nor K1 at any radix: what this header says of its
// channel groups there, and of K1, describes the forms they ran before.
//
// The factored derivative along an axis of length N = B * A (A = FA = 128):
// a real butterfly over the B row (or column) blocks r of the operand,
// u_c = sum_r Rf[c][r] x_r, the block products y_0 = G_0 u_0,
// y_{B-1} = G_{B/2} u_{B-1}, and for each complex pair
// (y_{2i+1}, y_{2i+2}) = (Ar u_{2i+1} - Ai u_{2i+2}, Ai u_{2i+1} + Ar u_{2i+2}),
// then out_r = sum_c Ri[r][c] y_c. Blocks are packed (B, A, A) as
// [G_0, G_{B/2}, Ar_1.., Ai_1..] and arrive TRANSPOSED for both axes,
// Gt[c][k][m] = G_c[m][k] (the x blocks are stored so; the y pass takes
// the transposed copy FactoredOps.FYT), so that a slab row is contiguous
// in the output index m.
//
// One block owns an output tile across all B blocks of the derivative's
// axis: TM = 64 values of the in-block index m (the rows r*A + m of d/dy,
// the columns r*A + m of d/dx, for every r) by TO = 32 pixels across the
// axis. It walks the A-long contraction in slabs of TK = 16.
//
// Channel groups (B = 16, 32). A block holds at most 8 channels (four
// channel pairs, 512 threads and the B = 8 ring): beyond that all B
// channels would need 64 B threads and 12.8 KB B of ring, more than a
// block may have. So the B / 2 pairs are split into B / 8 groups of four,
// one launch each, in order (g, a kernel argument). A group's block forms
// only its 8 channels of the forward butterfly (from all B operand rows),
// runs their block products, and applies its 8 columns of the inverse
// butterfly to every output row r: a partial sum of the derivative. The
// first group's launch stores it (or adds it, where the kernel adds) and
// each later launch adds onto it. The derivative is linear in the
// channels, so the groups' partial sums add up to it; a kernel's epilogue
// must then be linear in the derivative too, or run in the last group's
// launch. The launches run in stream order and, within one, each pixel
// is one thread's, so the adds onto a pixel come in a fixed order and the
// result is the same bit for bit from run to run. Each group re-reads the
// operand: B / 8 times the operand reads of a one-group tile. Up to B = 8
// there is one group, and the tile is as before.
//
// What the order costs (chip_smoke.py phase 13, NVIDIA H100 80GB HBM3 at
// 700 W): the groups of one launch on the grid, adding in whatever order
// they finish, ran 0.7-1.0x the time of these launches a kernel (K3 on 17
// trials at 4096^2: 33.9 ms against 48.1), their operand re-reads and
// adds sharing the L2, but no two runs gave the same bits; one block
// running its tile's groups one after another, in order, ran 1.0-1.3x
// their time, ptxas spilling up to 2.5 KB a thread around the loop.
//
// What bounds it on an H100, and what the design does about it (FP32 FMA
// only; the block products are 2B - 2 real A x A x N products):
//
//   shared-memory load rate. The B / 2 channel pairs are split over
//     warps, four warps per pair (64 B threads a block): a warp owns the
//     two real channels (0, B-1) or one complex pair over a quarter of the
//     tile (16 m x 32), a thread 4 (m) x 4 (across) outputs of both
//     channels, 32 accumulators. Per contraction step a thread makes four
//     16-byte shared loads (16 words: two blocks at 4 m, two channels at 4
//     pixels), conflict-free (a quarter-warp reads one contiguous 64 B
//     and one contiguous 32 B span), for 64 FMA in a complex-pair warp:
//     4.0 FMA per shared word (2.0 in the real-pair warps, whose products
//     are half as many; every scheduler holds one real-pair and three
//     complex-pair warps, so they finish together). Twice the outputs
//     along m (8 x 4, two warps a pair, 5.3 FMA per word) was measured
//     beside it and lost by a third at batch 1 and a tenth at batch 17:
//     with 8 warps a block the phases below leave the FMA pipe idle. The
//     inverse butterfly needs every channel of a pixel, so the
//     accumulators go through shared memory once, after the last slab.
//   butterfly recomputation. A block forms the B forward-butterfly
//     channels of its operand slab itself, and the FA / TM = 2 blocks that
//     share those pixels repeat it: B * B FMA per B pixels against
//     (2B - 2) * TM product FMA, 7.1 % at B = 8 and 4.2 % at B = 4, in
//     both passes (the tile's long side lies along m in both).
//   latency. A ring of two slab stages in dynamic shared memory (104 KB
//     at B = 8: one block of 16 warps an SM; two at B = 4): the next
//     slab's blocks arrive by cp.async and the next operand slab's raw
//     values are fetched into registers before the current slab's FMA
//     loop, and butterflied into the other stage after it (through the
//     caller's load functor, e.g. a multiply by p(t)); one __syncthreads
//     per slab.
//
// Where a tile's time goes (clock64 around the phases of one block of the
// 8 x 4 form, NVIDIA H100 80GB HBM3 at 700 W, 1024^2, B = 8): the FMA
// loop 65-70 %; forming the next slab's channels 13 %, starting its loads
// 6-12 %, the store 5-8 %. These phases follow one another within a
// block, which is why more warps a block pay. A 1024^2 plane is only 64
// tiles a pass: a batch-1 launch of one plane fills half the card.
//
// A derivative along y needs whole columns and one along x whole rows, so
// a kernel built on it runs as passes: an x pass that stores and a y pass
// that accumulates.
//
// The 'high' tier (TIER_HIGH; `_mk_dot('high')`,
// cmblensing_tpu/ops/pallas_lenseflow.py:225) runs the same tile with
// the block products on the tensor cores: every operand split into a
// bf16 head and a bf16 residual, three products per block product
// (head.head + residual.head + head.residual, the residual.residual term
// dropped), each bf16 x bf16 product exact and accumulated in FP32 by
// mma.sync.m16n8k16. The butterflied channel values are split (round to
// nearest even) as the slab is formed and staged as two bf16 slabs; the
// blocks arrive split from the host (FactoredOps.FXS / FYTS, [head,
// residual] x B blocks, transposed as above) by cp.async. A warp owns the
// same 16 m x 32 pixels of its channel pair as in the FP32 form: one
// m16 A fragment per block and operand half (ldmatrix.trans from the
// [k][m] rows), four n8 B fragments per channel and half (ldmatrix.trans
// from the [k][o] rows), per slab 24 mma (real pair) or 48 (complex pair;
// -Ai enters as its head and residual with the sign bits flipped, which
// is exact). The operand rows are padded (72 and 40 bf16) so that the
// eight 16-byte rows of every ldmatrix phase fall in distinct banks.
// The inverse butterfly, the stores and the functors are the FP32 form's.
// What bounds it: not the products (3 x 0.47 GFLOP at 989 TFLOP/s is
// 1.4 us a 1024^2 derivative) but the bytes (a plane in and out and one
// axis' split blocks, 2.7 us) and the FP32 work around them. The products
// no longer dominate a tile, so its other phases (forming and splitting
// the next slab, the loads, the store), which follow one another within a
// block, set its time: K1's 1024^2 d_x on this tile took 0.0246 ms read
// from HBM on an NVIDIA H100 80GB HBM3 at 700 W, 11 % of that bound and
// 74 % of the FP32 form's time (chip_smoke.py phase 9).
//
// The 'bf16' tier (TIER_BF16; `_mk_dot('bf16')`, pallas_lenseflow.py:218)
// is the 'high' tile without the residuals: each butterflied channel value
// rounded to a bf16 head once (round to nearest even) as the slab is
// formed, the blocks' heads (FactoredOps.FXS[0] / FYTS[0]) by cp.async,
// and one mma per block product where 'high' issues three; the rest is
// the 'high' form's. Its ring holds half the 'high' ring's bytes (57 KB at
// B = 8), below the accumulators staged for the inverse butterfly (74 KB),
// which then set the block's shared memory (work_floats).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "lenseflow_common.cuh"

namespace {

constexpr int FA = 128;      // block size A: an axis of length N is factored at radix N / FA
constexpr int TM = 64;       // tile side along the derivative's axis (values of m)
constexpr int TO = 32;       // tile side across it
constexpr int TK = 16;       // contraction slab
constexpr int RM = 4;        // a thread's outputs along m (by 4 across), per channel of its pair
constexpr int WPP = TM / (4 * RM);   // warps per channel pair, each 4 RM values of m
constexpr int NSTAGE = 2;    // slab stages in flight
constexpr int SUO = TO + 4;  // row stride of a staged channel slab (x-pass stores conflict-free)
constexpr int SY_Y = TO + 4; // row strides of the accumulators staged for the inverse butterfly
constexpr int SY_X = TM + 4;
constexpr int GS_H = TM + 8; // bf16 tiers: row strides of a staged block slab and channel slab
constexpr int US_H = TO + 8;

enum Axis { AXIS_X = 0, AXIS_Y = 1 };

// the channels a block holds (all of them up to B = 8), and the groups of
// them (see the header)
__host__ __device__ constexpr int tile_channels(int B) { return B < 8 ? B : 8; }
__host__ __device__ constexpr int tile_groups(int B) { return B / tile_channels(B); }
__host__ __device__ constexpr int tile_threads(int B) { return 16 * tile_channels(B) * WPP; }
// resident blocks an SM asked for: 16 warps
__host__ __device__ constexpr int tile_min_blocks(int B) { return 512 / tile_threads(B); }
// the bf16 slabs a stage holds of each operand: [head, residual] at
// 'high', the head at 'bf16'
__host__ __device__ constexpr int tier_halves(int tier) { return tier == TIER_HIGH ? 2 : 1; }
// a stage: the slab of the group's blocks and of its channels, FP32; at a
// bf16 tier each as tier_halves bf16 slabs (2 bf16 a float)
__host__ __device__ constexpr int stage_floats(int B, int tier = TIER_F32) {
    return tier == TIER_F32 ? tile_channels(B) * TK * (TM + SUO)
                            : tier_halves(tier) * tile_channels(B) * TK * (GS_H + US_H) / 2;
}
__host__ __device__ constexpr int ring_floats(int B, int tier = TIER_F32) {
    return NSTAGE * stage_floats(B, tier);
}
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
// the ring, reused for the accumulators staged for the inverse butterfly
__host__ __device__ constexpr int work_floats(int B, int tier = TIER_F32) {
    return cmax(ring_floats(B, tier), tile_channels(B) * cmax(TM * SY_Y, TO * SY_X));
}
// the ring or staged accumulators, then the group's rows of the forward
// butterfly and columns of the inverse one
__host__ __device__ constexpr size_t tile_smem_bytes(int B, int tier = TIER_F32) {
    return sizeof(float) * (work_floats(B, tier) + 2 * tile_channels(B) * B);
}
static_assert(work_floats(8, TIER_F32) == ring_floats(8, TIER_F32) &&
                  work_floats(8, TIER_HIGH) == ring_floats(8, TIER_HIGH),
              "the FP32 and 'high' rings hold the staged accumulators");
static_assert(tile_min_blocks(4) >= 1 && tile_min_blocks(8) >= 1 && tile_min_blocks(16) >= 1 &&
                  tile_min_blocks(32) >= 1 && tile_threads(32) == 512,
              "a radix's block stays within the launch bounds");
__host__ __device__ constexpr int tile_pixels(int B) { return TM * TO / tile_threads(B); }   // per thread at store

// The packed block (of B: [G_0, G_{B/2}, Ar.., Ai..]) and the butterfly
// channel that slot s of group g's stage holds. Slots 2 i and 2 i + 1 are
// the group's pair i: the real pair (channels 0, B - 1; blocks G_0,
// G_{B/2}) for pair 0 of group 0, else complex pair p = 4 g + i (channels
// 2p - 1, 2p; blocks Ar_p, Ai_p).
template <int B>
__host__ __device__ constexpr int slot_block(int g, int s) {
    const int p = g * (tile_channels(B) / 2) + s / 2;
    return p == 0 ? s % 2 : (s % 2 == 0 ? 1 + p : B / 2 + p);
}
template <int B>
__host__ __device__ constexpr int slot_channel(int g, int s) {
    const int p = g * (tile_channels(B) / 2) + s / 2;
    return p == 0 ? (s % 2 == 0 ? 0 : B - 1) : 2 * p - 1 + s % 2;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

// Offset in an (Ny, Nx) plane of the pixel at in-block index a (0..FA-1)
// of butterfly row 0 along the axis and index x across it (d/dy puts the
// blocks on rows, d/dx on columns), and the step from one butterfly row
// to the next.
template <int AXIS>
__device__ __forceinline__ int axis_offset(int a, int x, int Nx) {
    return AXIS == AXIS_Y ? a * Nx + x : x * Nx + a;
}

template <int AXIS>
__device__ __forceinline__ int row_step(int Nx) {
    return AXIS == AXIS_Y ? FA * Nx : FA;
}

// Offset in the plane of the q-th (of tile_pixels(B)) output pixel this
// thread stores, in butterfly row r, of the tile at (m0, o0); consecutive
// threads run along the plane's rows.
template <int B, int AXIS>
__device__ __forceinline__ int out_offset(int q, int r, int m0, int o0, int Nx) {
    const int idx = threadIdx.x + q * tile_threads(B);
    return r * row_step<AXIS>(Nx) + (AXIS == AXIS_Y ? axis_offset<AXIS>(m0 + idx / TO, o0 + idx % TO, Nx)
                                                    : axis_offset<AXIS>(m0 + idx % TM, o0 + idx / TM, Nx));
}

// The block's tile (m0, o0): along m and across the derivative's axis.
template <int AXIS>
__device__ __forceinline__ void tile_origin(int& m0, int& o0) {
    m0 = (AXIS == AXIS_Y ? blockIdx.y : blockIdx.x) * TM;
    o0 = (AXIS == AXIS_Y ? blockIdx.x : blockIdx.y) * TO;
}

// Group g's rows of the forward butterfly Rf and columns of the inverse Ri
// (bf is (2, B, B) [Rf, Ri]), in slot order: Rf[slot s][r], then Ri[r][slot s].
template <int B, int TIER = TIER_F32>
__device__ __forceinline__ void load_butterflies(const float* __restrict__ bf, float* smem, int g) {
    constexpr int BC = tile_channels(B);
    float* dst = smem + work_floats(B, TIER);
    for (int p = threadIdx.x; p < BC * B; p += tile_threads(B)) {
        const int s = p / B, r = p % B;
        dst[p] = bf[slot_channel<B>(g, s) * B + r];
        dst[BC * B + r * BC + s] = bf[B * B + r * B + slot_channel<B>(g, s)];
    }
}

// (o, kk) of the j-th operand-slab position this thread loads: along the
// plane's rows, 32 pixels a warp (d/dy) or 4 rows x 8 (d/dx: whole 32-byte
// sectors; 8 rows x 4 measured 7 % slower on the adjoint velocity).
template <int B, int AXIS>
__device__ __forceinline__ void slab_pos(int j, int& o, int& kk) {
    const int p = threadIdx.x + j * tile_threads(B);
    if (AXIS == AXIS_Y) {
        o = p % TO;
        kk = p / TO;
    } else {
        const int l = p % 32, q = p / 32;
        o = (q % (TO / 4)) * 4 + l / 8;
        kk = (q / (TO / 4)) * 8 + l % 8;
    }
}

// One slab of the block products of one channel pair into the thread's
// accumulators: the real pair (channels 0, B-1 against G_0, G_{B/2}) or
// a complex pair (re, im against Ar, Ai).
template <bool REAL>
__device__ __forceinline__ void slab_fma(const float* __restrict__ gA, const float* __restrict__ gB,
                                         const float* __restrict__ uA, const float* __restrict__ uB,
                                         float (&accA)[RM][4], float (&accB)[RM][4]) {
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
        float ga[RM], gb[RM];
#pragma unroll
        for (int h = 0; h < RM / 4; ++h) {
            const float4 a = ld4(gA + kk * TM + 16 * h), b = ld4(gB + kk * TM + 16 * h);
            ga[4 * h] = a.x, ga[4 * h + 1] = a.y, ga[4 * h + 2] = a.z, ga[4 * h + 3] = a.w;
            gb[4 * h] = b.x, gb[4 * h + 1] = b.y, gb[4 * h + 2] = b.z, gb[4 * h + 3] = b.w;
        }
        const float4 va = ld4(uA + kk * SUO), vb = ld4(uB + kk * SUO);
        const float ua[4] = {va.x, va.y, va.z, va.w}, ub[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                if (REAL) {
                    accA[i][j] = fmaf(ga[i], ua[j], accA[i][j]);
                    accB[i][j] = fmaf(gb[i], ub[j], accB[i][j]);
                } else {
                    accA[i][j] = fmaf(ga[i], ua[j], fmaf(-gb[i], ub[j], accA[i][j]));
                    accB[i][j] = fmaf(gb[i], ua[j], fmaf(ga[i], ub[j], accB[i][j]));
                }
            }
    }
}

// A bf16 tier: one slab (TK = 16, one mma k step) of the block products
// of one channel pair on the tensor cores, into the warp's 16 m x 32
// pixels: the real pair (channels chA, chB against blocks blA, blB; stage
// slots of a group of BC channels) or a complex pair
// (accA += Ar ur - Ai ui, accB += Ai ur + Ar ui with Ar = blA, Ai = blB,
// ur = chA, ui = chB). sG and sU are the stage's slabs [head, residual
// (RESID, 'high')][c][k][m or o]; accX[j] is n8 tile j in the mma C layout.
template <int BC, bool REAL, bool RESID>
__device__ __forceinline__ void slab_mma(const __nv_bfloat16* sG, const __nv_bfloat16* sU,
                                         int blA, int blB, int chA, int chB, int mrow,
                                         float (&accA)[4][4], float (&accB)[4][4]) {
    constexpr int GL = BC * TK * GS_H, UL = BC * TK * US_H;   // head -> residual
    const int lane = threadIdx.x % 32;
    // A (m x k) from [k][m] rows: matrices (m 0-7, k 0-7), (m 8-15, k 0-7),
    // (m 0-7, k 8-15), (m 8-15, k 8-15); B (k x o) from [k][o] rows:
    // (k 0-7, o 0-7), (k 8-15, o 0-7), (k 0-7, o 8-15), (k 8-15, o 8-15)
    const int ka = (lane & 7) + (lane >> 4) * 8, ma = ((lane >> 3) & 1) * 8;
    const int kb = (lane & 7) + ((lane >> 3) & 1) * 8, ob = (lane >> 4) * 8;
    unsigned aAh[4], aAl[4] = {}, aBh[4], aBl[4] = {};
    const __nv_bfloat16* ga = sG + (blA * TK + ka) * GS_H + mrow + ma;
    const __nv_bfloat16* gb = sG + (blB * TK + ka) * GS_H + mrow + ma;
    ldsm_x4_t(ga, aAh);
    ldsm_x4_t(gb, aBh);
    if constexpr (RESID) {
        ldsm_x4_t(ga + GL, aAl);
        ldsm_x4_t(gb + GL, aBl);
    }
    unsigned nBh[4], nBl[4];   // -Ai
#pragma unroll
    for (int i = 0; i < 4; ++i) nBh[i] = aBh[i] ^ 0x80008000u, nBl[i] = aBl[i] ^ 0x80008000u;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        unsigned uAh[4], uAl[4] = {}, uBh[4], uBl[4] = {};
        const __nv_bfloat16* ua = sU + (chA * TK + kb) * US_H + 16 * half + ob;
        const __nv_bfloat16* ub = sU + (chB * TK + kb) * US_H + 16 * half + ob;
        ldsm_x4_t(ua, uAh);
        ldsm_x4_t(ub, uBh);
        if constexpr (RESID) {
            ldsm_x4_t(ua + UL, uAl);
            ldsm_x4_t(ub + UL, uBl);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            float(&dA)[4] = accA[2 * half + j];
            float(&dB)[4] = accB[2 * half + j];
            if (REAL) {
                mma_tier<RESID>(dA, aAh, aAl, uAh, uAl, j);
                mma_tier<RESID>(dB, aBh, aBl, uBh, uBl, j);
            } else {
                mma_tier<RESID>(dA, aAh, aAl, uAh, uAl, j);
                mma_tier<RESID>(dA, nBh, nBl, uBh, uBl, j);
                mma_tier<RESID>(dB, aBh, aBl, uAh, uAl, j);
                mma_tier<RESID>(dB, aAh, aAl, uBh, uBl, j);
            }
        }
    }
}

// One output tile of the factored derivative along AXIS (see the header),
// at precision tier TIER, or channel group g's partial sum of it (B > 8).
// G holds the packed blocks transposed (FP32; at 'high' their bf16 [head,
// residual] split, at 'bf16' their bf16 heads); smem is the block's
// dynamic shared memory (tile_smem_bytes(B, TIER)), its butterflies loaded
// by load_butterflies<B, TIER>(bf, smem, g). load(q) returns the operand at
// offset q of the (Ny, Nx) plane (with the caller's prologue); store(q, v)
// receives the derivative (or the group's partial sum of it) there, at the
// pixels out_offset names. Every thread of the block must call it.
template <int B, int AXIS, int TIER = TIER_F32, class Load, class Store>
__device__ __forceinline__ void fact_tile(const void* __restrict__ G, float* smem, int m0, int o0,
                                          int g, int Nx, Load load, Store store) {
    constexpr bool MMA = TIER != TIER_F32, RESID = TIER == TIER_HIGH;
    constexpr int NH = tier_halves(TIER);   // bf16 slabs of each operand a stage
    constexpr int BC = tile_channels(B);   // the channels (stage slots) this block holds
    constexpr int NT = tile_threads(B);
    constexpr int NPOS = TO * TK / NT;      // operand-slab positions per thread
    constexpr int GROWS = NT / (TM / 4);    // block-slab rows (of BC TK) that the threads copy at once
    constexpr int PX = tile_pixels(B);
    const float* sRf = smem + work_floats(B, TIER);   // [slot][r]
    const float* sRi = sRf + BC * B;                  // [r][slot]
    const int tid = threadIdx.x, lane = tid % 32, wid = tid / 32;
    const int pair = wid / WPP, mh = wid % WPP;   // channel pair of the group; the warp's share of the tile along m
    const int lm = lane % 4, lo = lane / 4;       // FP32: 4 x 8 threads over the warp's 4 RM x 32 pixels
    const int mt = mh * 4 * RM + lm * 4;          // FP32: the thread's m: mt + 16 h + {0..3}, h < RM / 4
    // the pair's stage slots (channels and blocks alike), and whether it is
    // the real pair
    const int chA = 2 * pair, chB = 2 * pair + 1, blA = chA, blB = chB;
    const bool real = g == 0 && pair == 0;

    // FP32: accX[i][j] is (m = mt + 16 (i / 4) + i % 4, pixel lo * 4 + j);
    // bf16 tiers: accX[j] is n8 tile j of the warp's 16 m x 32 pixels
    float accA[RM][4], accB[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) accA[i][j] = accB[i][j] = 0.f;

    // this thread's share of a slab: 16 bytes of each block row it copies,
    // and NPOS operand positions in every butterfly row
    const float* Gt = static_cast<const float*>(G);
    const __nv_bfloat16* Gs = static_cast<const __nv_bfloat16*>(G);
    const float* gsrc = Gt + m0 + (tid % (TM / 4)) * 4;
    const int grow = tid / (TM / 4), gdst = (tid % (TM / 4)) * 4;
    const int kstep = AXIS == AXIS_Y ? Nx : 1, rstep = row_step<AXIS>(Nx);
    int qpos[NPOS];
#pragma unroll
    for (int j = 0; j < NPOS; ++j) {
        int o, kk;
        slab_pos<B, AXIS>(j, o, kk);
        qpos[j] = axis_offset<AXIS>(kk, o0 + o, Nx);
    }
    float raw[NPOS][B];
    auto fetch = [&](int k0, float* stage) {
        // the slab's blocks, asynchronously, and its raw operand values
        if constexpr (MMA) {
            // [head(, residual)] x BC x TK rows of TM bf16, 16 bytes a copy
            constexpr int CPR = TM / 8, NCP = NH * BC * TK * CPR / NT;
            __nv_bfloat16* sG = reinterpret_cast<__nv_bfloat16*>(stage);
#pragma unroll
            for (int h = 0; h < NCP; ++h) {
                const int q = tid + h * NT, row = q / CPR, ch = q % CPR;   // row: (hl BC + s) TK + kk
                const int hs = row / TK, blk = (hs / BC) * B + slot_block<B>(g, hs % BC);
                cp_async16(sG + row * GS_H + ch * 8,
                           Gs + ((size_t)blk * FA + k0 + row % TK) * FA + m0 + ch * 8);
            }
        } else {
#pragma unroll
            for (int h = 0; h < BC * TK / GROWS; ++h) {
                const int row = grow + h * GROWS;   // s TK + kk of the slab
                cp_async16(stage + gdst + row * TM,
                           gsrc + ((size_t)slot_block<B>(g, row / TK) * FA + k0 + row % TK) * FA);
            }
        }
#pragma unroll
        for (int j = 0; j < NPOS; ++j)
#pragma unroll
            for (int r = 0; r < B; ++r) raw[j][r] = load(qpos[j] + k0 * kstep + r * rstep);
    };
    auto butterfly = [&](float* stage) {   // the group's channels, slot c
        float* sU = stage + BC * TK * TM;
        __nv_bfloat16* sUh = reinterpret_cast<__nv_bfloat16*>(stage) + NH * BC * TK * GS_H;
#pragma unroll
        for (int c = 0; c < BC; ++c) {
            float rf[B];
#pragma unroll
            for (int r = 0; r < B; r += 4) {
                const float4 v = ld4(sRf + c * B + r);
                rf[r] = v.x, rf[r + 1] = v.y, rf[r + 2] = v.z, rf[r + 3] = v.w;
            }
#pragma unroll
            for (int j = 0; j < NPOS; ++j) {
                int o, kk;
                slab_pos<B, AXIS>(j, o, kk);
                float u = 0.f;
#pragma unroll
                for (int r = 0; r < B; ++r) u = fmaf(rf[r], raw[j][r], u);
                if constexpr (MMA) {
                    const __nv_bfloat16 h = __float2bfloat16_rn(u);
                    sUh[(c * TK + kk) * US_H + o] = h;
                    if constexpr (RESID)
                        sUh[(BC * TK + c * TK + kk) * US_H + o] = __float2bfloat16_rn(u - __bfloat162float(h));
                } else {
                    sU[(c * TK + kk) * SUO + o] = u;
                }
            }
        }
    };

    __syncthreads();   // the butterflies are loaded; a previous tile's staging is read
    fetch(0, smem);
    butterfly(smem);
    for (int s = 0; s < FA / TK; ++s) {
        float* cur = smem + (s % NSTAGE) * stage_floats(B, TIER);
        float* nxt = smem + ((s + 1) % NSTAGE) * stage_floats(B, TIER);
        cp_async_wait_all();
        __syncthreads();   // stage `cur` is complete, and every warp has left stage `nxt`
        const bool more = s + 1 < FA / TK;
        if (more) fetch((s + 1) * TK, nxt);
        if constexpr (MMA) {
            const __nv_bfloat16* sG = reinterpret_cast<const __nv_bfloat16*>(cur);
            const __nv_bfloat16* sU = sG + NH * BC * TK * GS_H;
            if (real) slab_mma<BC, true, RESID>(sG, sU, blA, blB, chA, chB, 16 * mh, accA, accB);
            else slab_mma<BC, false, RESID>(sG, sU, blA, blB, chA, chB, 16 * mh, accA, accB);
        } else {
            const float* sG = cur + mt;
            const float* sU = cur + BC * TK * TM + lo * 4;
            if (real)
                slab_fma<true>(sG + blA * TK * TM, sG + blB * TK * TM, sU + chA * TK * SUO,
                               sU + chB * TK * SUO, accA, accB);
            else
                slab_fma<false>(sG + blA * TK * TM, sG + blB * TK * TM, sU + chA * TK * SUO,
                                sU + chB * TK * SUO, accA, accB);
        }
        if (more) butterfly(nxt);
    }

    // every channel of a pixel to one thread: stage the accumulators
    __syncthreads();
    float* sY = smem;
    if constexpr (MMA) {   // C layout: (m = 16 mh + lane / 4 + 8 (e / 2), pixel 8 j + 2 (lane % 4) + e % 2)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int m = 16 * mh + lane / 4 + 8 * (e / 2), o = 8 * j + 2 * (lane % 4) + e % 2;
                if (AXIS == AXIS_Y) {   // sY[c][m][o]
                    sY[(chA * TM + m) * SY_Y + o] = accA[j][e];
                    sY[(chB * TM + m) * SY_Y + o] = accB[j][e];
                } else {                // sY[c][o][m]
                    sY[(chA * TO + o) * SY_X + m] = accA[j][e];
                    sY[(chB * TO + o) * SY_X + m] = accB[j][e];
                }
            }
    } else if (AXIS == AXIS_Y) {   // sY[c][m][o]
#pragma unroll
        for (int i = 0; i < RM; ++i) {
            const int m = mt + (i / 4) * 16 + i % 4;
            *reinterpret_cast<float4*>(sY + (chA * TM + m) * SY_Y + lo * 4) =
                make_float4(accA[i][0], accA[i][1], accA[i][2], accA[i][3]);
            *reinterpret_cast<float4*>(sY + (chB * TM + m) * SY_Y + lo * 4) =
                make_float4(accB[i][0], accB[i][1], accB[i][2], accB[i][3]);
        }
    } else {                // sY[c][o][m]
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int h = 0; h < RM / 4; ++h) {
                const int at = (lo * 4 + j) * SY_X + mt + h * 16;
                *reinterpret_cast<float4*>(sY + chA * TO * SY_X + at) = make_float4(
                    accA[4 * h][j], accA[4 * h + 1][j], accA[4 * h + 2][j], accA[4 * h + 3][j]);
                *reinterpret_cast<float4*>(sY + chB * TO * SY_X + at) = make_float4(
                    accB[4 * h][j], accB[4 * h + 1][j], accB[4 * h + 2][j], accB[4 * h + 3][j]);
            }
    }
    __syncthreads();
    // inverse butterfly at store (the group's columns of it)
    float yv[PX][BC];
#pragma unroll
    for (int q = 0; q < PX; ++q) {
        const int idx = tid + q * NT;
#pragma unroll
        for (int c = 0; c < BC; ++c)
            yv[q][c] = AXIS == AXIS_Y ? sY[(c * TM + idx / TO) * SY_Y + idx % TO]
                                      : sY[(c * TO + idx / TM) * SY_X + idx % TM];
    }
#pragma unroll
    for (int r = 0; r < B; ++r) {
        float ri[BC];
#pragma unroll
        for (int c = 0; c < BC; c += 4) {
            const float4 v = ld4(sRi + r * BC + c);
            ri[c] = v.x, ri[c + 1] = v.y, ri[c + 2] = v.z, ri[c + 3] = v.w;
        }
#pragma unroll
        for (int q = 0; q < PX; ++q) {
            float v = 0.f;
#pragma unroll
            for (int c = 0; c < BC; ++c) v = fmaf(ri[c], yv[q][c], v);
            store(out_offset<B, AXIS>(q, r, m0, o0, Nx), v);
        }
    }
}

template <int AXIS>
dim3 pass_grid(int Ny, int Nx, int nz) {
    constexpr int NM = FA / TM;   // tiles along m
    return AXIS == AXIS_Y ? dim3(Nx / TO, NM, nz) : dim3(NM, Ny / TO, nz);
}

bool shape_ok(int Bx, int By, int Ny, int Nx) {
    return Nx == Bx * FA && Ny == By * FA;
}

// Let `kernel` take the tile's dynamic shared memory (above the 48 KB a
// kernel gets unasked), and have the SM's L1 / shared split favour shared
// memory, so that as many blocks as the launch bounds ask for are resident.
template <class K>
int allow_tile_smem(K kernel, int B, int tier = TIER_F32) {
    const int rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)tile_smem_bytes(B, tier));
    if (rc != 0) return rc;
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                     (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// Instantiate the statement for the radix Bv (as the constant B) among
// those one channel group holds (4 and 8), at the tier TIER in force,
// where ON(B, TIER) says a kernel runs this tile
// (lenseflow_common.cuh::k3_on_tile, k4_on_tile, k5_on_tile);
// only those forms are built, the others refused.
#define LF_TILE_RADIX_CASE(n, ON, ...)                                                          \
    case n: {                                                                                   \
        constexpr int B = n;                                                                    \
        if constexpr (ON(n, TIER)) {                                                            \
            __VA_ARGS__;                                                                        \
        } else {                                                                                \
            return (int)cudaErrorInvalidValue;                                                  \
        }                                                                                       \
    } break;
#define LF_WITH_TILE_RADIX(Bv, ON, ...)                                                         \
    switch (Bv) {                                                                               \
        LF_TILE_RADIX_CASE(4, ON, __VA_ARGS__)                                                  \
        LF_TILE_RADIX_CASE(8, ON, __VA_ARGS__)                                                  \
        default:                                                                                \
            return (int)cudaErrorInvalidValue;                                                  \
    }

// One launch of `kernel` at the radix B (one channel group) and tier TIER
// in force on stream st; (...) are its arguments.
#define LF_TILE_LAUNCH(kernel, AXIS, nz, ...)                                                  \
    static_assert(tile_groups(B) == 1, "fact_tile runs one channel group");                    \
    kernel<B, AXIS, TIER><<<pass_grid<AXIS>(Ny, Nx, nz), tile_threads(B),                      \
                            tile_smem_bytes(B, TIER), st>>>(__VA_ARGS__)
