// The radix-B factored derivative for NVIDIA Hopper (sm_90a) as a device
// function on a thread-block cluster, fact_sm90 (one operand) and
// fact_sm90_ops (several in turn, one launch), at every tier, and the
// launch and set-up helpers of the kernels built on it, one launch a pass
// at every built radix: K1 (fderiv_sm90.cu), K3 (fa_sm90.cu), K4
// (bv_sm90.cu, on fact_sm90_ops: the backward velocity's 2 ncomp
// derivatives in one launch) and K5 (uni_sm90.cu) at every tier. Which
// tile a kernel runs at a (tier, radix) is one table
// (lenseflow_common.cuh::k3_on_tile .. k5_on_tile; the host's
// ops/lenseflow_kernels.py::FORMS): this one at radix 16 and 32, where
// fact_tile would need ordered channel-group launches, K1 everywhere, and
// K3, K4 and K5 at 4 and 8 wherever an A/B in turns did not measure
// fact_tile (fact_tile.cuh) more than 2 % faster; each kernel is built on
// this tile only where it runs it (sm90_dispatch's Built).
//
// Replaces the factored in-kernel derivative `_fact_apply` /
// `_make_ddx_ddy_fact` of cmblensing_tpu/ops/pallas_lenseflow.py (:249,
// :273) with its products `_mk_dot('f32')`, `_mk_dot('high')` (:225) and
// `_mk_dot('bf16')` (:218), inside `_fa_kernel` (:506, K3) and
// `_bwdAB_kernel` (:734, K5) as well as alone (K1).
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
// at radix 4, 8 and 16, 4 at radix 32 (K1; K3, K4 and K5 take one at radix 8,
// cluster_ctas / velocity_ctas), each CTA holding BC = B / NC channels (2,
// 4 or 8, 8, 8) as channel pairs (the real pair (0, B - 1) in CTA 0). A
// 1024^2 pass is 64 tiles, 128 CTAs (64 for K3, K4 and K5); a 4096^2 pass 256
// tiles, 1024 CTAs, times the planes on the grid's y axis. Each CTA forms its BC
// channels from all B operand rows (fmaf from 0 over r in order, the
// order ops/factored_deriv.py::_butterfly_fma mirrors), rounds them (to
// the bf16 head, and at 'high' the residual too), and runs its block
// products. Then, after a cluster barrier (every CTA has left its ring),
// each CTA pushes its channel outputs y_c through distributed shared
// memory to the CTA that owns their pixels (CTA p owns m in [p MQ, (p + 1)
// MQ), MQ = 128 / NC) and receives there all B channels of its share;
// after a second cluster barrier (every push has landed), each CTA sums
// all B output rows of its pixels over the B channels, in one fixed order,
// from its own shared memory, and hands each pair of adjacent pixels once
// to the caller's store: no atomics, so the bits repeat from run to run
// by construction, and no CTA touches another's memory after the second
// barrier, so none waits for another before it exits. Pushing (stores)
// where the first form of this tile pulled (loads of the other CTAs' y_c
// after the barrier) took the exchange, sums and stores with their
// barriers from 35 % of a radix-32 'bf16' K1 CTA's cycles to 29 %, the
// pass 0.87-0.94x (scripts/torch_kernel_phases.py). The operand reaches
// the cluster from device memory once per tile: the cluster's CTAs run
// together and load the same strip, so all but the first read of a line
// hit the L2.
//
// Phases overlap. One producer warp streams the CTA's block k-slabs (TK =
// 16 rows of 128 m, 4 KB a block and half) by cp.async.bulk into a ring of
// three stages behind full / empty mbarriers; the blocks are repacked once
// on the host (ops/factored_deriv.py::swizzle_blocks, FactoredOps.FXW /
// FYTW), each row's 16-byte chunks permuted by the row index, so that the
// contiguous bulk copy lands in a layout ldmatrix reads without bank
// conflicts. Eight consumer warps load the operand through the caller's
// load functor, each thread the B values of its slab position, a slab
// ahead into registers; they run a slab's products, then form and round
// the next slab's channels into a double-buffered channel slab. Those
// loads and the channels they feed are what still holds a radix-32 K1 CTA
// back (43-50 % of its cycles; K3's two-plane adjoint loads 41-50 %): four
// CTAs load each strip, and a CTA of 9 warps (one an SM, the registers'
// limit) hides little of their latency. Staging the operand in shared
// memory instead ran slower: as 512 64-byte bulk copies a slab from the
// producer, 3-5x (the copy engine's cost per copy set the pace); as one
// box of a 4-D tensor map a slab, 1.0-1.2x at radix 32; and as a multicast
// (each CTA loading 1 / NC of a slab's rows through the load functor and
// pushing them by st.async into two raw stages of every CTA of the
// cluster, behind cluster-wide full and empty mbarriers, the 'high' ring
// cut to two stages at radix 16 and 32 to make room), 1.12-2.05x, the
// same bits, in all 16 cases of K1 d_x, d_y and K3 forward, adjoint at
// radix 16 and 32, 'high' and 'bf16' (cold ms, multicast / these loads:
// K1 'high' 4096^2 d_x 0.5261 / 0.3404, 'bf16' 0.4425 / 0.2322; K3 'high'
// 4096^2 forward 2.5798 / 2.0190, adjoint 2.4588 / 2.0952, 2048^2 0.4623
// / 0.3849, 0.4365 / 0.3913; medians of 4 rounds of turns,
// scripts/torch_kernel_phases.py's A/B before the form was dropped): the
// operand's loads fell from 21.5 K to 11 K cycles of a radix-32 'high'
// K1 CTA, but every slab became a cluster-wide handshake, so the first
// slab (6 K to 15 K), the channels read back from shared memory (17 K to
// 34 K) and the refill's wait and push (12 K) took more than that, 141 K
// cycles a CTA against 96 K (NVIDIA H100 80GB HBM3, 700 W).
//
// The reduced tiers' products on mma.sync (m16n8k16, bf16 in, FP32
// accumulate), not wgmma:
// what bounds the tile is the FP32 butterfly work (4 B operations a pixel,
// forward and inverse: 0.033 ms a 4096^2 pass at the FP32 peak) and its
// bytes, not the tensor cores (the products of a 4096^2 'bf16' pass are
// 8.3 GFLOP, 0.0084 ms at the bf16 peak, three times that at 'high'), and
// the consumer warps that form a channel slab are the ones that hold it,
// so mma.sync reads it with ldmatrix from padded rows where wgmma would
// need its canonical layout written by those warps and one more barrier a
// slab.
//
// The strict tier (TIER_F32) keeps the tile, the ring, the producer warp,
// the cluster barriers, the push and the inverse butterfly, and changes
// what the products need. The producer bulk-copies slabs of the FP32
// blocks as fact_tile takes them (FactoredOps.FX / FYT, (B, A, A),
// transposed, contiguous in m: 8 KB a block slab, the 'high' stage's 64 KB
// at 8 blocks); the channels stay in FP32 (a slab row of TO + 4 floats);
// the block products are FP32 FMA in fact_tile's slab_fma order (slab_f32:
// each channel output an fmaf chain from 0 over k ascending, the complex
// pairs' two FMA a term in its order), so every channel output y_c, and
// after the inverse butterfly of each channel group (Parts, fold) every
// pixel, has the bits of fact_tile's ordered launches. A thread holds 2 NP
// values of m (NP the CTA's channel pairs: 4 at radix 8 to 32, so 8 values)
// by 4 pixels of each channel of its pair, 64 accumulators, and reads a k step
// as 16 block and 8 channel words for 128 FMA (a complex pair; 5.3 FMA a
// shared word): each quarter-warp reads 128 contiguous bytes of a block
// row (its 8 lanes' float4 along m) and broadcasts one channel float4, so
// the blocks need no swizzle. ptxas: K1 and K3 167-168 registers, no
// spills; K5 167-168, 60 bytes spilled in the radix-32 x pass alone (the
// 'high' radix-32 kernels spill 8-24; 9 warps hold at most 168 registers a
// thread); K4, whose operand loop (fact_sm90_ops) holds more across the
// products, 168 and 228-692 bytes spilled at radix 32 at every tier.
//
// Shared memory (radix 32, 'high'): a ring of three 64 KB block stages (8
// blocks' head and residual slabs), which receives the y_c of the CTA's
// share (64 KB) after the last slab; two channel slabs (24 KB); the
// butterflies (5 KB): 221 KB, one CTA an SM. 'bf16': 113 KB; strict: the
// same 192 KB ring, 20 KB of channel slabs, 217 KB. Radix 8 on one CTA
// holds the same 8 channels a CTA: 'high' 217 KB, 'bf16' 109 KB, strict
// 213 KB. A kernel on this tile holds nothing else in shared memory, so
// every kernel's clusters fit as K1's do (sm90_init checks it at load).
//
// The caller's functors: load(q) returns the operand at offset q of the
// (Ny, Nx) plane (a product of planes, say); fetch(q) reads what the store
// of the adjacent pixels q and q + 1 needs (p, or what the x pass stored)
// and returns it as a small value (q even); store(q, part, fetched)
// receives the derivative at those pixels (x, y of each float2) once,
// after the second cluster barrier, as the partial sums of
// fact_tile's channel groups (Parts, one up to radix 8, 2 and 4 at radix
// 16 and 32), and does with them what its kernel does: a multiply by p, a
// store, or an add onto what the x pass stored, the groups folded in the
// order fact_tile's ordered launches add them (fold). Each pixel pair is
// one thread's, in every operand of a launch (PairAt), and the passes run
// in stream order, so a read, an add and a store repeat their bits; and a
// kernel on this tile gives, bit for bit, what the same kernel on
// fact_tile at that tier would, which keeps the uni flows' delta f (K5
// role 0) the bits of the kernel backend's (K4) on either tile. At radix 4
// and 8 the one group's sum is the single fmaf chain over all B channels.
// Parts and fold exist only for those bits: no kernel runs fact_tile's
// channel groups any more (K4 and strict K1 were the last, at radix 16 and
// 32), so they can go (ROADMAP Queue 2), the store receiving one sum over
// all B channels in a fixed order, once a witness has shown what that
// order does to the bits. A thread fetches RB rows of its pixel pair (4 at
// radix 32, 8 below) before it sums and stores any of them: a store the
// compiler cannot tell apart from the next row's reads would otherwise
// hold each read back until the row before it was written. That took the
// store phase of a radix-32 strict K3 forward CTA from 34.8 K cycles to
// 20.0 K (of 130 K and 118 K), and K3 and K5 at radix 16 and 32 at every
// tier to 0.69-0.95x their time, the same bits (cold, in turns,
// scripts/torch_flow_witness.py kernels; K1, whose store reads little,
// 1.00-1.01x; NVIDIA H100 80GB HBM3, 700 W).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

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

// The CTAs of a tile's cluster, its channel groups, as a kernel on this
// tile chooses them: K1 takes cluster_ctas (2 at radix 4, 8 and 16, 4 at
// radix 32); K3, K4 and K5 take velocity_ctas, one CTA at radix 8, where a
// cluster of one ran K3 1.02-1.07x faster at 'high' and 1.18-1.33x at
// 'bf16' than two (1024^2, batch 1 and 17 trials, cold; K1 'high' 2x
// slower, and every kernel slower at radix 4; NVIDIA H100 80GB HBM3, 700 W)
__host__ __device__ constexpr int cluster_ctas(int B) { return B == 32 ? 4 : 2; }
__host__ __device__ constexpr int velocity_ctas(int B) { return B == 8 ? 1 : cluster_ctas(B); }
__host__ __device__ constexpr int halves(int tier) { return tier == TIER_HIGH ? 2 : 1; }
// bytes of a block or channel value: FP32 strict, bf16 at the reduced tiers
__host__ __device__ constexpr int value_bytes(int tier) { return tier == TIER_F32 ? 4 : 2; }
constexpr int USF = TO + 4;      // row stride (FP32) of a strict staged channel slab [c][k][o]
constexpr int NSTAGE = 3;        // block-slab stages of the ring
constexpr int NSLAB = FA / TK;   // contraction slabs of an operand
// the uses of ring stage st by one operand's NSLAB slabs (slab s fills
// stage s % NSTAGE): 3, 3, 2
__host__ __device__ constexpr int stage_uses(int st) {
    return NSLAB / NSTAGE + (st < NSLAB % NSTAGE);
}
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// bytes of a ring stage: the CTA's block slabs ([half][slot][k][m]; FP32
// strict, bf16 at the reduced tiers)
__host__ __device__ constexpr int stage_bytes(int B, int NC, int tier) {
    return halves(tier) * (B / NC) * TK * FA * value_bytes(tier);
}
// the values of m whose output pixels a CTA sums and stores (a quarter, a
// half or all of the tile)
__host__ __device__ constexpr int mquarter(int NC) { return FA / NC; }
// bytes of the ring (reused to receive the channel outputs y_c of the
// CTA's share of the tile, all B channels), the channel slabs and the
// butterfly rows, then the mbarriers
__host__ __device__ constexpr int ring_bytes(int B, int NC, int tier) {
    return cmax(NSTAGE * stage_bytes(B, NC, tier), 4 * B * mquarter(NC) * TO);
}
__host__ __device__ constexpr int useg_bytes(int B, int NC, int tier) {
    return tier == TIER_F32 ? 2 * (B / NC) * TK * USF * 4 : 2 * halves(tier) * (B / NC) * TK * US * 2;
}
// the CTA's rows of the forward butterfly, and the inverse one
__host__ __device__ constexpr int bfly_bytes(int B, int NC) { return 4 * ((B / NC) * B + B * B); }
__host__ __device__ constexpr size_t smem_bytes(int B, int NC, int tier) {
    return (size_t)ring_bytes(B, NC, tier) + useg_bytes(B, NC, tier) + bfly_bytes(B, NC) +
           2 * NSTAGE * 8;
}
static_assert(smem_bytes(32, 4, TIER_HIGH) <= 232448 && smem_bytes(8, 1, TIER_HIGH) <= 232448 &&
                  smem_bytes(32, 4, TIER_F32) <= 232448 && smem_bytes(8, 1, TIER_F32) <= 232448,
              "a CTA's shared memory fits the 227 KB a block may have");

// The channel and the packed block ([G_0, G_{B/2}, Ar.., Ai..]) that slot s
// of CTA q holds: slots 2 i, 2 i + 1 are its pair i, the real pair (0,
// B - 1; G_0, G_{B/2}) as pair 0 of CTA 0, else complex pair p (channels
// 2p - 1, 2p; blocks Ar_p, Ai_p).
template <int B, int NC>
__host__ __device__ constexpr int slot_channel(int q, int s) {
    const int p = q * (B / NC / 2) + s / 2;
    return p == 0 ? (s % 2 == 0 ? 0 : B - 1) : 2 * p - 1 + s % 2;
}
template <int B, int NC>
__host__ __device__ constexpr int slot_block(int q, int s) {
    const int p = q * (B / NC / 2) + s / 2;
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

// two adjacent floats (8-byte aligned), as the store functors read and
// write the pixel pairs, and their sum and product, each rounded on its own
// (never fused into an FMA)
__device__ __forceinline__ float2 ld2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void st2(float* p, float2 v) { *reinterpret_cast<float2*>(p) = v; }
__device__ __forceinline__ float2 add2(float2 a, float2 b) {
    return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}
__device__ __forceinline__ float2 mul2(float2 a, float2 b) {
    return make_float2(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y));
}

// fact_tile's channel groups (fact_tile.cuh::tile_groups: 8 channels, all
// B up to radix 8), which are this tile's CTAs at radix 16 and 32: the
// inverse butterfly sums each group's channels on its own and hands the
// store the groups' partial sums of a pixel pair, in order
__host__ __device__ constexpr int sm90_groups(int B) { return B <= 8 ? 1 : B / 8; }
template <int NG>
struct Parts {
    float2 g[NG];
};
// acc + s(g_i) + s(g_{i+1}) + ... in that order: what fact_tile's launches
// of groups i, i + 1, ... add onto a pixel (s: the store's per-group
// transform, a multiply by p, say)
template <int NG, class S>
__device__ __forceinline__ float2 fold(float2 acc, const Parts<NG>& part, int i, S s) {
#pragma unroll
    for (int k = 0; k < NG; ++k)
        if (k >= i) acc = add2(acc, s(part.g[k]));
    return acc;
}

// VW adjacent floats (VW = 2 or 4, 8 or 16-byte aligned) from p into v, or
// from v to p
template <int VW>
__device__ __forceinline__ void ldv(const float* p, float* v) {
    if constexpr (VW == 4) {
        const float4 x = ld4(p);
        v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
    } else {
        const float2 x = ld2(p);
        v[0] = x.x, v[1] = x.y;
    }
}
template <int VW>
__device__ __forceinline__ void stv(float* p, const float* v) {
    if constexpr (VW == 4) *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    else st2(p, make_float2(v[0], v[1]));
}

// The strict tier: one slab (TK rows of k) of a channel pair's block
// products in FP32 FMA, into the thread's RMF values of m by 4 pixels of
// each channel of the pair, acc[i / 2][i % 2][j] at (m_i, pixel j): the
// real pair (channel A against block A, B against B) or a complex pair
// (A += Ar ur - Ai ui, B += Ai ur + Ar ui; Ar = block A, ur = channel A).
// fact_tile.cuh's slab_fma, operation for operation and k ascending, so
// that every channel output has its bits. gX point at the thread's first
// m of row k = 0 of a block slab [k][m] (its m: VW adjacent values at each
// of RMF / VW offsets 8 VW apart), uX at its 4 pixels of row 0 of a
// channel slab [k][o].
template <bool REAL, int RMF, int VW, int MT>
__device__ __forceinline__ void slab_f32(const float* gA, const float* gB, const float* uA,
                                         const float* uB, float (&accA)[MT][2][4],
                                         float (&accB)[MT][2][4]) {
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
        float ga[RMF], gb[RMF], ua[4], ub[4];
#pragma unroll
        for (int h = 0; h < RMF / VW; ++h) {
            ldv<VW>(gA + kk * FA + 8 * VW * h, ga + VW * h);
            ldv<VW>(gB + kk * FA + 8 * VW * h, gb + VW * h);
        }
        ldv<4>(uA + kk * USF, ua);
        ldv<4>(uB + kk * USF, ub);
#pragma unroll
        for (int i = 0; i < RMF; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                float& a = accA[i / 2][i % 2][j];
                float& b = accB[i / 2][i % 2][j];
                if (REAL) {
                    a = fmaf(ga[i], ua[j], a);
                    b = fmaf(gb[i], ub[j], b);
                } else {
                    a = fmaf(ga[i], ua[j], fmaf(-gb[i], ub[j], a));
                    b = fmaf(gb[i], ua[j], fmaf(ga[i], ub[j], b));
                }
            }
    }
}

// The pixel pair jp (of store_pairs(NC)) that consumer thread tid sums and
// stores in the share of CTA q of a tile: two pixels adjacent in memory
// (along o in the y pass, m in the x pass), at offset `at` of its channel
// rows in the received y_c, and in output row r at pixel(r). The same
// thread owns the same pairs in every operand of a launch.
__host__ __device__ constexpr int store_pairs(int NC) { return mquarter(NC) * TO / 2 / NCT; }
template <int NC, int AXIS>
struct PairAt {
    static constexpr int MQ = mquarter(NC);
    int at, m, ov;
    __device__ __forceinline__ PairAt(int tid, int jp, int q) {
        const int idx = tid + jp * NCT;
        const int ml = AXIS == AXIS_Y ? idx / (TO / 2) : idx % (MQ / 2) * 2;
        ov = AXIS == AXIS_Y ? idx % (TO / 2) * 2 : idx / (MQ / 2);
        at = AXIS == AXIS_Y ? ml * TO + ov : ov * MQ + ml;
        m = q * MQ + ml;
    }
    // the pair's offset in output row r of the tile across the axis at o0
    __device__ __forceinline__ size_t pixel(int r, int o0, int Nx) const {
        return AXIS == AXIS_Y ? (size_t)(r * FA + m) * Nx + o0 + ov
                              : (size_t)(o0 + ov) * Nx + r * FA + m;
    }
};

// The pixel pairs this thread stored in its kernel's fact_sm90_ops call
// (consumer threads; none for the producer warp), R rows at a time in the
// store's order: f(pairs), pairs[i] the offset of the pair in row r0 + i,
// so that f can issue the reads of R pairs before it writes any.
template <int B, int NC, int AXIS, int R, class F>
__device__ __forceinline__ void sm90_own_pairs(int Nx, F f) {
    static_assert(B % R == 0, "whole batches of rows");
    const int q = (int)cg::this_cluster().block_rank(), tid = threadIdx.x;
    const int o0 = (blockIdx.x / NC) * TO;
    if (tid >= NCT) return;
#pragma unroll 1
    for (int jp = 0; jp < store_pairs(NC); ++jp) {
        const PairAt<NC, AXIS> at(tid, jp, q);
#pragma unroll 1
        for (int r0 = 0; r0 < B; r0 += R) {
            size_t pairs[R];
#pragma unroll
            for (int i = 0; i < R; ++i) pairs[i] = at.pixel(r0 + i, o0, Nx);
            f(pairs);
        }
    }
}

// One tile (blockIdx.x / NC) of the factored derivative along AXIS at TIER
// on a cluster of NC CTAs (see the header), of each of nop operands in
// turn, in one launch; every thread of the CTA calls it. W holds the packed
// blocks transposed (Gt[c][k][m]): strict, in FP32 as fact_tile takes them,
// (B, A, A); at 'high' and 'bf16' as their bf16 [head, residual] split,
// rows swizzled (swizzle_blocks), (2, B, A, A), whose heads 'bf16' reads.
// bf is (2, B, B) [Rf, Ri]. Nx is the plane's row length. The functors take
// the operand's index first: load(op, q), fetch(op, q), store(op, q, part,
// fetched), as the header says of one operand. nop is an int, or
// OneOperand (fact_sm90: the loop and its barrier gone at compile time).
// RBX, where not 0, caps the rows whose store reads a thread issues
// together (RB below), for a kernel whose fetched values are many.
//
// Operands after the first reuse the set-up (the butterflies in shared
// memory, the ring's mbarriers): the producer streams the axis' blocks once
// more for each, and the ring's phase carries on from one operand to the
// next (slab s of every operand fills stage s % NST, and the stage's
// mbarriers count its uses over the launch, stage_uses a operand), so the
// next operand's first slabs are in flight as soon as this CTA's store has
// read its share out of the ring (one __syncthreads). No CTA writes into
// another before the next operand's first cluster barrier, which every CTA
// of the cluster reaches only after its store. (Initialising the
// mbarriers anew for each operand, behind a cluster barrier, ran K4 1.00-
// 1.03x this form's time: PERF.md §6.)
template <int B, int NC, int AXIS, int TIER, int RBX = 0, class Nop, class Load, class Fetch,
          class Store>
__device__ __forceinline__ void fact_sm90_ops(const void* __restrict__ W,
                                              const float* __restrict__ bf, int Nx, Nop nop,
                                              Load load, Fetch fetch, Store store) {
    constexpr int BC = B / NC, NH = halves(TIER), MQ = mquarter(NC);
    constexpr int NST = NSTAGE, SB = stage_bytes(B, NC, TIER);
    constexpr bool F32 = TIER == TIER_F32, RESID = TIER == TIER_HIGH;
    constexpr int NP = BC / 2, WPP = NCW / NP, MT = FA / 16 / WPP;   // pairs; warps a pair; m16 tiles a warp
    // strict: a thread's values of m (by 4 pixels) per channel, VW adjacent
    // ones at each of RMF / VW offsets 8 VW apart
    constexpr int RMF = 2 * NP, VW = RMF < 4 ? RMF : 4;
    constexpr int NS = NSLAB;                  // slabs
    constexpr int SLABV = TK * FA, SLAB = SLABV * value_bytes(TIER);   // values, bytes of a block slab
    constexpr int ULEN = BC * TK * US;         // bf16 of one half of a channel slab
    constexpr int UFLEN = BC * TK * USF;       // strict: floats of a channel slab
    static_assert(!F32 || (RMF == 2 * MT && RMF % VW == 0), "the strict register tile fills acc");
    extern __shared__ __align__(128) unsigned char smem[];
    float* sR = reinterpret_cast<float*>(smem);   // the ring, after the last slab: [c][..]
    __nv_bfloat16* sU = reinterpret_cast<__nv_bfloat16*>(smem + ring_bytes(B, NC, TIER));
    float* sUf = reinterpret_cast<float*>(sU);   // strict: the channel slabs, FP32
    float* sRf = reinterpret_cast<float*>(smem + ring_bytes(B, NC, TIER) + useg_bytes(B, NC, TIER));
    float* sRi = sRf + BC * B;   // [r][q' BC + s']
    uint64_t* full = reinterpret_cast<uint64_t*>(sRi + B * B);
    uint64_t* empty = full + NST;
    auto stage = [&](int s) { return smem + (s % NST) * SB; };

    cg::cluster_group cluster = cg::this_cluster();
    const int q = (int)cluster.block_rank();
    const int o0 = (blockIdx.x / NC) * TO;
    const int tid = threadIdx.x, lane = tid % 32, wid = tid / 32;
    LF_CLOCK_START(lf_t);   // phases 0-11, marked by thread 0 (consumer warp 0)

    for (int p = tid; p < BC * B; p += NT) sRf[p] = bf[slot_channel<B, NC>(q, p / B) * B + p % B];
    for (int p = tid; p < B * B; p += NT) {
        const int j = p % B;
        sRi[p] = bf[B * B + (p / B) * B + slot_channel<B, NC>(j / BC, j % BC)];
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
    // n8 tile j, in the mma C layout; strict: accX[i / 2][i % 2][j], the
    // thread's m_i (below) by pixel 4 (lane / 8) + j
    float accA[MT][2][4], accB[MT][2][4];
    // strict: the thread's first m, m_i = mt + 8 VW (i / VW) + i % VW
    const int mt = (wid % WPP) * MT * 16 + VW * (lane % 8), lo = lane / 8;

#pragma unroll 1
    for (int op = 0; op < (int)nop; ++op) {
        if (op > 0) __syncthreads();   // this CTA's store has read its share out of the ring
        // slab s of the operand fills stage s % NST, that stage's use
        // op stage_uses(s % NST) + s / NST of the launch (its mbarriers' phase)
        auto use = [&](int s) { return op * stage_uses(s % NST) + s / NST; };
        if (wid == NCW) {
            // producer: slab s's blocks, in slot order, into stage s % NST
            const unsigned char* Wb = static_cast<const unsigned char*>(W);
            for (int s = 0; s < NS; ++s) {
                const int st = s % NST;
                if (use(s) > 0) mbar_wait(empty + st, (use(s) - 1) & 1);
                if (lane == 0) mbar_expect_tx(full + st, SB);
                __syncwarp();
                for (int i = lane; i < NH * BC; i += 32)
                    bulk_g2s(stage(s) + i * SLAB,
                             Wb + ((size_t)((i / BC) * B + slot_block<B, NC>(q, i % BC)) * FA + s * TK) *
                                      FA * value_bytes(TIER),
                             SLAB, full + st);
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
            const size_t q0 = AXIS == AXIS_Y ? (size_t)kk * Nx + o0 + o : (size_t)(o0 + o) * Nx + kk;
            const size_t kstep = AXIS == AXIS_Y ? (size_t)TK * Nx : TK;
            const size_t rstep = AXIS == AXIS_Y ? (size_t)FA * Nx : FA;
            float raw[B];
            auto fetch = [&](int s) {
#pragma unroll
                for (int r = 0; r < B; ++r) raw[r] = load(op, q0 + s * kstep + r * rstep);
            };
            // channel slab b (0, 1) of this thread's position: strict in FP32,
            // else its bf16 head (and at 'high' residual)
            auto butterfly = [&](int b) {
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
                    if constexpr (F32) {
                        sUf[b * UFLEN + (ch * TK + kk) * USF + o] = v;
                    } else {
                        __nv_bfloat16* u = sU + b * NH * ULEN;
                        const __nv_bfloat16 h = __float2bfloat16_rn(v);
                        u[(ch * TK + kk) * US + o] = h;
                        if constexpr (RESID)
                            u[ULEN + (ch * TK + kk) * US + o] = __float2bfloat16_rn(v - __bfloat162float(h));
                    }
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
                if constexpr (!F32) {
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
                        ldsm_x4_t(sG + chA * SLABV + at, aAh);
                        ldsm_x4_t(sG + chB * SLABV + at, aBh);
                        if constexpr (RESID) {
                            ldsm_x4_t(sG + (BC + chA) * SLABV + at, aAl);
                            ldsm_x4_t(sG + (BC + chB) * SLABV + at, aBl);
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
                }
            };

            // strict: the pair's block slabs at the thread's first m, and its
            // channel slabs at its first pixel
            auto products_f32 = [&](const float* sG, const float* u) {
                if constexpr (F32) {
                    const float *gA = sG + chA * SLABV + mt, *gB = sG + chB * SLABV + mt;
                    const float *uA = u + chA * TK * USF + 4 * lo, *uB = u + chB * TK * USF + 4 * lo;
                    if (real) slab_f32<true, RMF, VW>(gA, gB, uA, uB, accA, accB);
                    else slab_f32<false, RMF, VW>(gA, gB, uA, uB, accA, accB);
                }
            };

            fetch(0);
            butterfly(0);
            LF_CLOCK(1, lf_t);   // the first slab's operand and channels
            for (int s = 0; s < NS; ++s) {
                if (s + 1 < NS) fetch(s + 1);
                LF_CLOCK(4, lf_t);   // the next operand slab's loads issued
                consumer_sync();   // channel slab s is formed, and every warp has left slab s - 1's
                LF_CLOCK(3, lf_t);   // waiting for the other consumer warps
                mbar_wait(full + s % NST, use(s) & 1);
                LF_CLOCK(2, lf_t);   // waiting for the block slab
                if constexpr (F32)
                    products_f32(reinterpret_cast<const float*>(stage(s)), sUf + (s % 2) * UFLEN);
                else
                    products(reinterpret_cast<const __nv_bfloat16*>(stage(s)), sU + (s % 2) * NH * ULEN);
                __syncwarp();
                if (lane == 0) mbar_arrive(empty + s % NST);   // stage s read
                LF_CLOCK(5, lf_t);   // the products
                if (s + 1 < NS) {
                    butterfly((s + 1) % 2);
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
            if constexpr (F32) {
                // VW adjacent m at a time: rows of 4 pixels (y pass), or VW of
                // m in each pixel's row (x pass)
#pragma unroll
                for (int i0 = 0; i0 < RMF; i0 += VW) {
                    const int m = mt + 8 * i0, ov = 4 * lo;
                    float* d = dst[m / MQ];
                    const int ml = m % MQ;
#pragma unroll
                    for (int i = i0; i < i0 + VW; ++i)
                        if (AXIS == AXIS_Y) {
                            stv<4>(d + (cA * MQ + ml + i - i0) * TO + ov, accA[i / 2][i % 2]);
                            stv<4>(d + (cB * MQ + ml + i - i0) * TO + ov, accB[i / 2][i % 2]);
                        }
                    if (AXIS == AXIS_X)
#pragma unroll
                        for (int j = 0; j < 4; ++j) {
                            float va[VW], vb[VW];
#pragma unroll
                            for (int i = 0; i < VW; ++i)
                                va[i] = accA[(i0 + i) / 2][(i0 + i) % 2][j],
                                vb[i] = accB[(i0 + i) / 2][(i0 + i) % 2][j];
                            stv<VW>(d + (cA * TO + ov + j) * MQ + ml, va);
                            stv<VW>(d + (cB * TO + ov + j) * MQ + ml, vb);
                        }
                }
            } else
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
        // slot) order, each group of sm90_groups on its own (fmaf from 0, as
        // fact_tile sums a group), and handed to the caller's store once.
        if (tid < NCT) {
            constexpr int NG = sm90_groups(B), GS = B / NG;   // groups; channels a group
            constexpr int NPAIR = store_pairs(NC);   // pairs a thread: 4 / NC
            // rows whose reads go out together
            constexpr int RB0 = B < 8 ? B : B < 32 ? 8 : 4, RB = RBX && RBX < RB0 ? RBX : RB0;
#pragma unroll 1
            for (int jp = 0; jp < NPAIR; ++jp) {
                const PairAt<NC, AXIS> at(tid, jp, q);
                float2 y[B];
#pragma unroll
                for (int j = 0; j < B; ++j) y[j] = *reinterpret_cast<const float2*>(sR + j * MQ * TO + at.at);
                auto pixel = [&](int r) { return at.pixel(r, o0, Nx); };
                // RB rows at a time: their reads issued together (fetch), then
                // each row's sums handed to the store with what was read
#pragma unroll 1
                for (int r0 = 0; r0 < B; r0 += RB) {
                    decltype(fetch(op, size_t(0))) pre[RB];
#pragma unroll
                    for (int i = 0; i < RB; ++i) pre[i] = fetch(op, pixel(r0 + i));
#pragma unroll
                    for (int i = 0; i < RB; ++i) {
                        const int r = r0 + i;
                        Parts<NG> part;
#pragma unroll
                        for (int g = 0; g < NG; ++g) {
                            float2 v = make_float2(0.f, 0.f);
#pragma unroll
                            for (int j = g * GS; j < (g + 1) * GS; j += 4) {
                                const float4 w = ld4(sRi + r * B + j);
                                v.x = fmaf(w.x, y[j].x, v.x), v.y = fmaf(w.x, y[j].y, v.y);
                                v.x = fmaf(w.y, y[j + 1].x, v.x), v.y = fmaf(w.y, y[j + 1].y, v.y);
                                v.x = fmaf(w.z, y[j + 2].x, v.x), v.y = fmaf(w.z, y[j + 2].y, v.y);
                                v.x = fmaf(w.w, y[j + 3].x, v.x), v.y = fmaf(w.w, y[j + 3].y, v.y);
                            }
                            part.g[g] = v;
                        }
                        store(op, pixel(r), part, pre[i]);
                    }
                }
            }
        }
        LF_CLOCK(11, lf_t);   // the inverse butterfly: sums and stores
    }
}

// The operand count of fact_sm90: one, known at compile time.
struct OneOperand {
    __host__ __device__ constexpr operator int() const { return 1; }
};

// One operand: fact_sm90_ops with load(q), fetch(q), store(q, part, fetched).
template <int B, int NC, int AXIS, int TIER, class Load, class Fetch, class Store>
__device__ __forceinline__ void fact_sm90(const void* __restrict__ W,
                                          const float* __restrict__ bf, int Nx, Load load,
                                          Fetch fetch, Store store) {
    fact_sm90_ops<B, NC, AXIS, TIER>(
        W, bf, Nx, OneOperand(), [&](int, size_t q) { return load(q); },
        [&](int, size_t q) { return fetch(q); },
        [&](int, size_t q, const auto& part, const auto& pre) { store(q, part, pre); });
}

// The tiles of a pass along AXIS over an (Ny, Nx) plane: one a 16-pixel
// strip across the axis.
template <int AXIS>
unsigned sm90_tiles(int Ny, int Nx) {
    return (AXIS == AXIS_Y ? Nx : Ny) / TO;
}

template <int B, int NC, int TIER>
cudaLaunchConfig_t sm90_config(cudaLaunchAttribute* attr, unsigned ntile, unsigned nplanes,
                               cudaStream_t st) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(ntile * NC, nplanes, 1);
    cfg.blockDim = dim3(NT, 1, 1);
    cfg.dynamicSmemBytes = smem_bytes(B, NC, TIER);
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = NC;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

// One launch of a kernel on this tile (B, NC, TIER) over ntile tiles and
// nplanes planes (the grid's y axis) on stream st, by cudaLaunchKernelEx
// (the cluster dimension is a launch attribute); its error code, or the
// launch's cudaGetLastError().
template <int B, int NC, int TIER, class... Params, class... Args>
int sm90_launch(void (*kernel)(Params...), unsigned ntile, unsigned nplanes, cudaStream_t st,
                Args... args) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = sm90_config<B, NC, TIER>(attr, ntile, nplanes, st);
    const int rc = (int)cudaLaunchKernelEx(&cfg, kernel, args...);
    return rc != 0 ? rc : (int)cudaGetLastError();
}

// Allow a kernel on this tile its dynamic shared memory, and count the
// clusters of it that fit on the card at once
// (cudaOccupancyMaxActiveClusters) into *n.
template <int B, int NC, int TIER, class... Params>
int sm90_prepare(void (*kernel)(Params...), int* n) {
    const int rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem_bytes(B, NC, TIER));
    if (rc != 0) return rc;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = sm90_config<B, NC, TIER>(attr, 1, 1, 0);
    return (int)cudaOccupancyMaxActiveClusters(n, (const void*)kernel, &cfg);
}

template <int V>
using ic = std::integral_constant<int, V>;

// f(ic<B>(), ic<TIER>()) at the run-time radix Bv and tier `tier`, where
// Built::on(B, TIER) says that the kernel is built on this tile there (the
// radices ops/deriv.py::BUILT_RADICES names; which tier and radix each
// kernel runs here is the host's table, ops/lenseflow_kernels.py::FORMS);
// other values refused.
template <class Built, int B, int T, class F>
int sm90_at(F& f) {
    if constexpr (Built::on(B, T)) return f(ic<B>(), ic<T>());
    else return (int)cudaErrorInvalidValue;
}

template <class Built, int T, class F>
int sm90_radix(int Bv, F& f) {
    switch (Bv) {
        case 4: return sm90_at<Built, 4, T>(f);
        case 8: return sm90_at<Built, 8, T>(f);
        case 16: return sm90_at<Built, 16, T>(f);
        case 32: return sm90_at<Built, 32, T>(f);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <class Built, class F>
int sm90_dispatch(int tier, int Bv, F f) {
    switch (tier) {
        case TIER_F32: return sm90_radix<Built, TIER_F32>(Bv, f);
        case TIER_HIGH: return sm90_radix<Built, TIER_HIGH>(Bv, f);
        case TIER_BF16: return sm90_radix<Built, TIER_BF16>(Bv, f);
        default: return (int)cudaErrorInvalidValue;
    }
}

// Every instantiation of a kernel on this tile (Built::on), by
// prepare(tier, B, &n) (sm90_prepare of both passes): its dynamic shared
// memory allowed, and an error code where not one of its clusters fits on
// the card.
template <class Built, class P>
int sm90_init(P prepare) {
    const int tiers[] = {TIER_F32, TIER_HIGH, TIER_BF16}, radices[] = {4, 8, 16, 32};
    for (int tier : tiers)
        for (int B : radices) {
            if (!Built::on(B, tier)) continue;
            int n = 0;
            const int rc = prepare(tier, B, &n);
            if (rc != 0) return rc;
            if (n < 1) return (int)cudaErrorInvalidConfiguration;
        }
    return 0;
}

}  // namespace

// The set-up entries of the kernel template `kernel<B, AXIS, TIER>` on this
// tile, its clusters of ctas(B) CTAs, built where built::on(B, TIER):
// init_name() allows every instantiation its shared memory once after
// loading, before any launch, and returns an error code where one of its
// clusters does not fit (sm90_init); clusters_name(tier, B) returns the
// clusters of radix B at `tier` that fit on the card at once (the lesser
// of the two passes'), or minus a CUDA error code (cudaErrorInvalidValue
// where it is not built).
#define LF_SM90_SETUP(kernel, ctas, built, init_name, clusters_name)                           \
    namespace {                                                                               \
    int kernel##_prepare(int tier, int Bv, int* n) {                                          \
        return sm90_dispatch<built>(tier, Bv, [&](auto b, auto t) {                           \
            constexpr int B_ = decltype(b)::value, T_ = decltype(t)::value;                   \
            int nx = 0, ny = 0;                                                               \
            int rc = sm90_prepare<B_, ctas(B_), T_>(kernel<B_, AXIS_X, T_>, &nx);             \
            if (rc == 0) rc = sm90_prepare<B_, ctas(B_), T_>(kernel<B_, AXIS_Y, T_>, &ny);    \
            *n = nx < ny ? nx : ny;                                                           \
            return rc;                                                                        \
        });                                                                                   \
    }                                                                                         \
    }                                                                                         \
    extern "C" int init_name() { return sm90_init<built>(kernel##_prepare); }                 \
    extern "C" int clusters_name(int tier, int B) {                                           \
        int n = 0;                                                                            \
        const int rc = kernel##_prepare(tier, B, &n);                                         \
        return rc != 0 ? -rc : n;                                                             \
    }
