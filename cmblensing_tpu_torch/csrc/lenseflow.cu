// LenseFlow flow kernels for NVIDIA Hopper (sm_90a): FP32 FMA, and the
// 'high' and 'bf16' tiers on the tensor cores.
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
// load rate inside a block. `dense_xy` (dense_tile.cuh) is the one
// product lf_velocity, lf_deriv and the dense K5 (uni_dense.cu) run: a
// block's 8 warps split into 4 groups,
// (x product, y product) x (two halves of the contraction), so that both
// terms of a tile are formed at once and combined inside the block (one
// launch and no atomics: the 256^2 gradient is launch-bound, and a
// second pass would add launches); each thread keeps 4 x 4 outputs per
// operand (16 FMA per two 16-byte shared loads, 2 FMA per word; the
// backward kind's two operands share the matrix slab, 2.7), layouts are
// unpadded and conflict-free, and each group runs a ring of two slabs,
// the next one fetched into registers before the current one's FMA loop.
// A forward or adjoint launch is 64 tiles x ncomp blocks (128 at pol P on
// 132 SMs). Later work: capturing a flow in a CUDA graph.
//
// Any plane shape. The grid covers ceil(Ny / 32) x ceil(Nx / 32) tiles
// and each product's contraction ceil(n / 16) slabs (split between two
// groups, or four for a single product, in whole slabs); every load past
// the edge of a plane or a circulant reads 0 and every store past it is
// skipped, so the ragged last tile and slab need no padded copy (the JAX
// package runs such sizes, 200^2 or 600^2, through its scan:
// models/lenseflow.py:192-209). A row whose length is not a multiple of 4
// is loaded and stored a float at a time. The guards are a template
// parameter (EDGE), chosen at launch: where Ny and Nx are multiples of the
// tile the kernels run the unguarded loads, so that such planes pay
// nothing for the guards.
//
// The 'high' tier (TIER_HIGH; the 'high' branch of `_make_ddx_ddy`,
// pallas_lenseflow.py:103): each product as the bf16 head/residual
// split, h = bf16(x) rounded to nearest even and l = bf16(x - h), summed
// as head.head + residual.head + head.residual in FP32 by
// mma.sync.m16n8k16 (the residual.residual term dropped, as there). The
// circulants arrive split from the host ((2, n, n) bf16 [head, residual]
// of DxT and Dy, made once per operator set), the operand is split as
// its slab is staged. Each group runs the same slabs, ring and combine as
// the FP32 form; of its two warps each owns 16 rows x 32 columns of the
// tile, four n8 accumulator tiles per operand, the same 16 registers a
// thread as the FP32 form's 4 x 4. The left factor is staged [row][k]
// (read by ldmatrix), the right one [k][column] (read by ldmatrix.trans),
// rows padded to 24 and 40 bf16 so that every ldmatrix phase is
// conflict-free. Per slab a warp issues three mma per n8 column tile and
// operand, 12 per operand.
// The stages no longer fit the 48 KB of static shared memory for the
// backward kind (68 KB), so every dense kernel takes its stages as
// dynamic shared memory, allowed once by lf_dense_init. What bounds it:
// the products shrink to a few percent of the FP32 loop's time, so the
// loads, the split at stash and the combine, which follow one another
// within a group, set the pace: at 256^2 a 'high' launch takes 0.84-0.97
// of the strict one's time, 5-8 % of its bound (NVIDIA H100 80GB HBM3 at
// 700 W, chip_smoke.py phase 11, both tiers timed cold).
//
// The 'bf16' tier (TIER_BF16; the 'bf16' branch of `_make_ddx_ddy`,
// pallas_lenseflow.py:92): the 'high' form without the residuals. The
// circulant arrives as its bf16 head ((n, n), rounded to nearest even on
// the host once per operator set), the operand (y or p y) is rounded to
// its head as its slab is staged, and a warp issues one mma per n8 column
// tile and operand a slab, 4 per operand. The guards (EDGE), the ring and
// the combine are the 'high' form's; its stages hold half the bytes. That
// is the velocity kernels' 'bf16' tier; lf_deriv's is deriv_bf16_kernel
// below, redesigned without dense_xy's split of the contraction.
//
// Plain C interface, loaded with ctypes. Every launch goes on the
// caller's stream and each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

#include "dense_tile.cuh"

namespace {

enum Kind { FORWARD = 0, ADJOINT = 1, BACKWARD = 2 };

// One velocity of flow KIND; p holds the planes (p_x, p_y) at time t.
// blockIdx.z is the component (forward, adjoint); the backward kind walks
// its components in the block, because w sums over them.
template <int KIND, int TIER, bool EDGE>
__global__ void __launch_bounds__(DNT)
velocity_kernel(const float* __restrict__ y, float* __restrict__ k,
                const float* __restrict__ phi, const float* __restrict__ p,
                const void* __restrict__ DxT, const void* __restrict__ Dy, int ncomp, int Ny,
                int Nx, float t) {
    constexpr int NOP = KIND == BACKWARD ? 2 : 1;
    extern __shared__ float4 dense_smem[];
    float* sm = reinterpret_cast<float*>(dense_smem);
    const size_t plane = (size_t)Ny * Nx;
    const int tid = threadIdx.x;
    // this thread's four output pixels
    const int row = blockIdx.y * DT + tid / 8, col = blockIdx.x * DT + (tid % 8) * 4;
    const float4 px = ldq<EDGE>(p, row, col, Ny, Nx), py = ldq<EDGE>(p + plane, row, col, Ny, Nx);
    float4 wx = make_float4(0.f, 0.f, 0.f, 0.f), wy = wx;
    const int c0 = KIND == BACKWARD ? 0 : blockIdx.z, c1 = KIND == BACKWARD ? ncomp : c0 + 1;
    for (int c = c0; c < c1; ++c) {
        const float* a = y + (size_t)c * plane;
        const float* b = y + (size_t)(ncomp + c) * plane;   // backward: delta f_c
        float4 X[NOP], Y[NOP];
        dense_xy<NOP, TIER, EDGE>(
            DxT, Dy, Ny, Nx, sm, true, true,
            [&](int axis, int op, int r, int cc) {
                // f_c as it is (forward, backward); p f_c (adjoint); p delta f_c (backward)
                if (KIND == FORWARD || (KIND == BACKWARD && op == 0))
                    return ldq<EDGE>(a, r, cc, Ny, Nx);
                return mul4(ldq<EDGE>(p + axis * plane, r, cc, Ny, Nx),
                            ldq<EDGE>(op == 0 ? a : b, r, cc, Ny, Nx));
            },
            X, Y);
        if (KIND == ADJOINT) {
            stq<EDGE>(k + (size_t)c * plane, row, col, Ny, Nx, add4(X[0], Y[0]));
        } else {
            stq<EDGE>(k + (size_t)c * plane, row, col, Ny, Nx,
                      add4(mul4(px, X[0]), mul4(py, Y[0])));   // df/dt
        }
        if (KIND == BACKWARD) {
            stq<EDGE>(k + (size_t)(ncomp + c) * plane, row, col, Ny, Nx,
                      add4(X[NOP - 1], Y[NOP - 1]));   // d(delta f)/dt
            const float4 dfc = ldq<EDGE>(b, row, col, Ny, Nx);
            wx = add4(wx, mul4(dfc, X[0]));   // w = sum_c delta f_c grad f_c
            wy = add4(wy, mul4(dfc, Y[0]));
        }
    }
    if (KIND == BACKWARD && row < Ny) {
        // u = M^-1 w and the delta-phi integrands
        float* acc = k + (size_t)(2 * ncomp) * plane;
        const size_t o = (size_t)row * Nx + col;
        const float wxs[4] = {wx.x, wx.y, wx.z, wx.w}, wys[4] = {wy.x, wy.y, wy.z, wy.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
            if (!EDGE || col + e < Nx) dphi_integrands(phi, plane, o + e, t, wxs[e], wys[e], acc);
    }
}

// out = d_x a + d_y b + c over blockIdx.z planes; a, b or c may be null.
template <int TIER, bool EDGE>
__global__ void __launch_bounds__(DNT)
deriv_kernel(const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ c, float* __restrict__ out,
             const void* __restrict__ DxT, const void* __restrict__ Dy, int Ny, int Nx) {
    extern __shared__ float4 dense_smem[];
    float* sm = reinterpret_cast<float*>(dense_smem);
    const size_t base = (size_t)blockIdx.z * Ny * Nx;
    const int tid = threadIdx.x;
    const int row = blockIdx.y * DT + tid / 8, col = blockIdx.x * DT + (tid % 8) * 4;
    float4 X[1], Y[1];
    dense_xy<1, TIER, EDGE>(
        DxT, Dy, Ny, Nx, sm, a != nullptr, b != nullptr,
        [&](int axis, int, int r, int cc) {
            return ldq<EDGE>((axis == 0 ? a : b) + base, r, cc, Ny, Nx);
        },
        X, Y);
    float4 v = add4(X[0], Y[0]);
    if (c != nullptr) v = add4(v, ldq<EDGE>(c + base, row, col, Ny, Nx));
    stq<EDGE>(out + base, row, col, Ny, Nx, v);
}

// K2's 'bf16' derivative (lf_deriv at TIER_BF16), out = d_x a + d_y b + c
// over blockIdx.z planes, redesigned for Hopper. The first form ran it on
// dense_xy, which splits one product's contraction over four groups of 64
// threads, each a two-stage ring of slabs through registers with a barrier
// a slab, and meets the four partial tiles in shared memory behind three
// more barriers: at 256^2 four slabs a group, a chain of load latencies
// with little math between them. Here a block of 8 warps owns a 32 x TN
// output tile (TN 32 or 64) and the whole contraction: the FP32 operand
// strip (32 rows of a, or TN columns of b) and the matching circulant
// strip (the bf16 head of DxT or Dy) come by 16-byte cp.async from every
// thread, in chunks of 128 values of the contraction through a ring of
// two, both chunks of a 256-long contraction issued at once. Each thread rounds the FP32 values
// it copied to bf16 (nearest even) once, in place: the eight bf16 of an
// eight-float run land in its first 16 bytes, which ldmatrix then reads as
// a row. One barrier a chunk. Each warp forms its 16 x TN/4 share with
// mma.sync m16n8k16 over the whole contraction (at TN 64 two independent
// accumulators, its two n8 tiles, fed by one ldmatrix of each operand a
// k-step) and stores its sums with the c term: no split of the
// contraction and no shared-memory reduction. The 64-wide tile halves the
// operand strips' reads from the L2 (a row strip of a is read by Nx / TN
// blocks) and lets a warp reuse an A fragment for two products, but makes
// half as many blocks: deriv_bf16 takes it where it still gives every
// other SM a block. On the IP slice's 3 x 256^2 planes that is 96 blocks
// of 64 columns (87 KB of shared memory, 2 an SM), all resident at once
// on the 132 SMs; at 200^2 it is 49 of 32 (53 KB, 4 an SM).
// The rounding points are the first form's: the operand and the circulant
// rounded to bf16, the products exact, the sums FP32. Any plane shape:
// past the plane's or the circulant's edge a load stages 0 and a store is
// skipped (EDGE: a ragged 32 x TN tile), and a row that is not 16-byte
// aligned is staged a value at a time.
constexpr int DB_TM = 32;               // output tile rows (its columns: TN, 32 or 64)
constexpr int DB_K = 128;               // contraction values a chunk (a stage of the ring of two)
constexpr int DB_NT = 256;              // threads: 2 x 4 warps, each 16 rows x TN / 4 columns
constexpr int DB_SA = DB_K + 8;         // row strides: d_y circulant rows [i][k] (bf16)
constexpr int DB_FA = DB_K + 4;         // d_x operand rows [i][k] (FP32, rounded in place)
// d_x circulant rows [k][j] (bf16); d_y operand rows [k][j] (FP32, rounded in place)
__host__ __device__ constexpr int db_sb(int tn) { return tn + 8; }
__host__ __device__ constexpr int db_fb(int tn) { return tn + 4; }
constexpr int DB_XA = DB_TM * DB_FA * 4, DB_YA = DB_TM * DB_SA * 2;   // bytes of the first strips
__host__ __device__ constexpr int db_stage(int tn) {
    return cmax(DB_XA + DB_K * db_sb(tn) * 2, DB_YA + DB_K * db_fb(tn) * 4);
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// Stage the four floats at (row, col..) of a (rows, cols) array into dst,
// 0 past its edge
template <bool EDGE>
__device__ __forceinline__ void stage4(float* dst, const float* __restrict__ x, int row, int col,
                                       int rows, int cols) {
    if (row < rows && col < cols && (!EDGE || (cols & 3) == 0))
        cp16(dst, x + (size_t)row * cols + col);
    else
        *reinterpret_cast<float4*>(dst) = EDGE ? ldg4(x, row, col, rows, cols)
                                               : make_float4(0.f, 0.f, 0.f, 0.f);
}

// ... the eight bf16 there
template <bool EDGE>
__device__ __forceinline__ void stage8h(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ x,
                                        int row, int col, int rows, int cols) {
    if (row < rows && col + 8 <= cols && (!EDGE || (cols & 7) == 0)) {
        cp16(dst, x + (size_t)row * cols + col);
        return;
    }
    const unsigned short* p = reinterpret_cast<const unsigned short*>(x);
    unsigned e[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = row < rows && col + i < cols ? p[(size_t)row * cols + col + i] : 0u;
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(e[0] | e[1] << 16, e[2] | e[3] << 16, e[4] | e[5] << 16, e[6] | e[7] << 16);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
    return bf16x2_bits(__floats2bfloat162_rn(lo, hi));
}

// The eight floats at p rounded to bf16, into p's first 16 bytes
__device__ __forceinline__ void round8(float* p) {
    const float4 u = reinterpret_cast<const float4*>(p)[0], v = reinterpret_cast<const float4*>(p)[1];
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf16(u.x, u.y), pack_bf16(u.z, u.w), pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

// Two 8 x 8 bf16 matrices from shared memory, each transposed on load;
// lanes 0-15 name their rows (row lane % 8 of matrix lane / 8)
__device__ __forceinline__ void ldsm_x2_t(const void* row, unsigned (&r)[2]) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(smem_addr(row)));
}

// DxT and Dy are the circulants' (n, n) bf16 heads.
template <int TN, bool EDGE>
__global__ void __launch_bounds__(DB_NT, TN == 64 ? 2 : 4)
deriv_bf16_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ c, float* __restrict__ out,
                  const __nv_bfloat16* __restrict__ DxT, const __nv_bfloat16* __restrict__ Dy,
                  int Ny, int Nx) {
    constexpr int SB = db_sb(TN), FB = db_fb(TN), STAGE = db_stage(TN), NT8 = TN / 32;
    extern __shared__ float4 dense_smem[];
    unsigned char* sm = reinterpret_cast<unsigned char*>(dense_smem);
    const size_t base = (size_t)blockIdx.z * Ny * Nx;
    const int tid = threadIdx.x, lane = tid % 32, wid = tid / 32;
    const int i0 = blockIdx.y * DB_TM, j0 = blockIdx.x * TN;
    const int ncx = a != nullptr ? (Nx + DB_K - 1) / DB_K : 0;
    const int nch = ncx + (b != nullptr ? (Ny + DB_K - 1) / DB_K : 0);   // x chunks, then y chunks
    // the eight-float runs this thread copies and rounds: d_x 2 of a's
    // strip, d_y TN / 16 of b's
    auto issue = [&](int ci) {
        unsigned char* st = sm + (ci % 2) * STAGE;
        const int k0 = (ci < ncx ? ci : ci - ncx) * DB_K;
        if (ci < ncx) {   // a[i0.., k0..] and DxT[k0.., j0..]
            float* A = reinterpret_cast<float*>(st);
            __nv_bfloat16* Bh = reinterpret_cast<__nv_bfloat16*>(st + DB_XA);
#pragma unroll
            for (int h = 0; h < DB_TM * DB_K / 8 / DB_NT; ++h) {
                const int p = tid + h * DB_NT, row = p / (DB_K / 8), kq = p % (DB_K / 8) * 8;
                stage4<EDGE>(A + row * DB_FA + kq, a + base, i0 + row, k0 + kq, Ny, Nx);
                stage4<EDGE>(A + row * DB_FA + kq + 4, a + base, i0 + row, k0 + kq + 4, Ny, Nx);
            }
#pragma unroll
            for (int h = 0; h < DB_K * TN / 8 / DB_NT; ++h) {
                const int p = tid + h * DB_NT, kr = p / (TN / 8), jq = p % (TN / 8) * 8;
                stage8h<EDGE>(Bh + kr * SB + jq, DxT, k0 + kr, j0 + jq, Nx, Nx);
            }
        } else {          // Dy[i0.., k0..] and b[k0.., j0..]
            __nv_bfloat16* Ah = reinterpret_cast<__nv_bfloat16*>(st);
            float* Bf = reinterpret_cast<float*>(st + DB_YA);
#pragma unroll
            for (int h = 0; h < DB_TM * DB_K / 8 / DB_NT; ++h) {
                const int p = tid + h * DB_NT, row = p / (DB_K / 8), kq = p % (DB_K / 8) * 8;
                stage8h<EDGE>(Ah + row * DB_SA + kq, Dy, i0 + row, k0 + kq, Ny, Ny);
            }
#pragma unroll
            for (int h = 0; h < DB_K * TN / 8 / DB_NT; ++h) {
                const int p = tid + h * DB_NT, kr = p / (TN / 8), jq = p % (TN / 8) * 8;
                stage4<EDGE>(Bf + kr * FB + jq, b + base, k0 + kr, j0 + jq, Ny, Nx);
                stage4<EDGE>(Bf + kr * FB + jq + 4, b + base, k0 + kr, j0 + jq + 4, Ny, Nx);
            }
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    // round the FP32 runs this thread staged for chunk ci (its own copies:
    // no barrier before)
    auto to_bf16 = [&](int ci) {
        unsigned char* st = sm + (ci % 2) * STAGE;
        if (ci < ncx) {
            float* A = reinterpret_cast<float*>(st);
#pragma unroll
            for (int h = 0; h < DB_TM * DB_K / 8 / DB_NT; ++h) {
                const int p = tid + h * DB_NT;
                round8(A + p / (DB_K / 8) * DB_FA + p % (DB_K / 8) * 8);
            }
        } else {
            float* Bf = reinterpret_cast<float*>(st + DB_YA);
#pragma unroll
            for (int h = 0; h < DB_K * TN / 8 / DB_NT; ++h) {
                const int p = tid + h * DB_NT;
                round8(Bf + p / (TN / 8) * FB + p % (TN / 8) * 8);
            }
        }
    };
    // mma fragments: g, t4 the C layout's row and pair; the ldmatrix rows
    // this lane names: A (16 x 16, [i][k]) row ar, k ak; B (16 x TN / 4,
    // [k][j], transposed on load) k bk, column bj
    const int g = lane / 4, t4 = lane % 4, wr = (wid / 4) * 16, wc = (wid % 4) * (TN / 4);
    const int ar = (lane & 7) + ((lane >> 3) & 1) * 8, ak = (lane >> 4) * 8;
    const int bk = lane & 15, bj = wc + (NT8 == 2 ? (lane >> 4) * 8 : 0);
    float acc[NT8][4] = {};   // the warp's 16 x 8 tiles, d_x + d_y, in the mma C layout
    LF_CLOCK_START(lf_t);   // the phase probe's phases 0-4 (lenseflow_common.cuh)
    issue(0);
    if (nch > 1) issue(1);
    LF_CLOCK(0, lf_t);   // the loads issued
    for (int ci = 0; ci < nch; ++ci) {
        if (ci + 1 < nch) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        else asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        LF_CLOCK(1, lf_t);   // waiting for the loads
        to_bf16(ci);
        __syncthreads();   // chunk ci is staged and rounded
        LF_CLOCK(4, lf_t);   // rounding and the barrier
        const unsigned char* st = sm + (ci % 2) * STAGE;
        const bool xs = ci < ncx;
        const int nk = min(DB_K, (xs ? Nx : Ny) - (xs ? ci : ci - ncx) * DB_K);
        // A: the rounded a rows (bf16 runs 32 bytes apart) or Dy's; B: DxT's
        // rows or the rounded b rows
        const unsigned char* Ap = st + (xs ? ((wr + ar) * DB_FA + ak) * 4 : ((wr + ar) * DB_SA + ak) * 2);
        const unsigned char* Bp = st + (xs ? DB_XA + (bk * SB + bj) * 2 : DB_YA + (bk * FB + bj) * 4);
        const int sa = xs ? 16 * 4 : 16 * 2, sb = xs ? 16 * SB * 2 : 16 * FB * 4;   // bytes a k-step
#pragma unroll 4
        for (int ks = 0; ks < nk; ks += 16) {   // past nk the staged values are 0
            unsigned af[4];
            ldsm_x4(Ap + (ks / 16) * sa, af);
            if constexpr (NT8 == 2) {
                unsigned bq[4];
                ldsm_x4_t(Bp + (ks / 16) * sb, bq);
                mma_bf16(acc[0], af, bq[0], bq[1]);
                mma_bf16(acc[1], af, bq[2], bq[3]);
            } else {
                unsigned bq[2];
                ldsm_x2_t(Bp + (ks / 16) * sb, bq);
                mma_bf16(acc[0], af, bq[0], bq[1]);
            }
        }
        LF_CLOCK(2, lf_t);   // the products
        if (ci + 2 < nch) {
            __syncthreads();   // every warp has left stage ci % 2
            issue(ci + 2);
        }
    }
    // C layout: (row g + 8 (e / 2), column 2 t4 + e % 2) of n8 tile t
#pragma unroll
    for (int t = 0; t < NT8; ++t) {
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
            const int row = i0 + wr + g + 4 * e, col = j0 + wc + 8 * t + 2 * t4;
            float2 v = make_float2(acc[t][e], acc[t][e + 1]);
            const size_t o = base + (size_t)row * Nx + col;
            if (!EDGE) {
                if (c != nullptr) {
                    const float2 cv = *reinterpret_cast<const float2*>(c + o);
                    v.x += cv.x, v.y += cv.y;
                }
                *reinterpret_cast<float2*>(out + o) = v;
            } else if (row < Ny) {
                if (col < Nx) out[o] = c != nullptr ? v.x + c[o] : v.x;
                if (col + 1 < Nx) out[o + 1] = c != nullptr ? v.y + c[o + 1] : v.y;
            }
        }
    }
    LF_CLOCK(3, lf_t);   // the stores
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


template <int TIER, bool EDGE>
int allow_dense() {
    int rc = allow(velocity_kernel<FORWARD, TIER, EDGE>, dense_smem_bytes(1, TIER));
    if (rc == 0) rc = allow(velocity_kernel<ADJOINT, TIER, EDGE>, dense_smem_bytes(1, TIER));
    if (rc == 0) rc = allow(velocity_kernel<BACKWARD, TIER, EDGE>, dense_smem_bytes(2, TIER));
    if constexpr (TIER == TIER_BF16) {
        if (rc == 0) rc = allow(deriv_bf16_kernel<32, EDGE>, 2 * db_stage(32));
        if (rc == 0) rc = allow(deriv_bf16_kernel<64, EDGE>, 2 * db_stage(64));
    } else {
        if (rc == 0) rc = allow(deriv_kernel<TIER, EDGE>, dense_smem_bytes(1, TIER));
    }
    return rc;
}

template <int TIER, bool EDGE>
int velocity(int kind, const float* y, float* k, const float* phi, const float* p,
             const void* DxT, const void* Dy, int ncomp, int Ny, int Nx, float t,
             cudaStream_t st) {
    const dim3 grid(tiles(Nx), tiles(Ny), kind == BACKWARD ? 1 : ncomp);
    switch (kind) {
        case FORWARD:
            velocity_kernel<FORWARD, TIER, EDGE><<<grid, DNT, dense_smem_bytes(1, TIER), st>>>(
                y, k, phi, p, DxT, Dy, ncomp, Ny, Nx, t);
            break;
        case ADJOINT:
            velocity_kernel<ADJOINT, TIER, EDGE><<<grid, DNT, dense_smem_bytes(1, TIER), st>>>(
                y, k, phi, p, DxT, Dy, ncomp, Ny, Nx, t);
            break;
        case BACKWARD:
            velocity_kernel<BACKWARD, TIER, EDGE><<<grid, DNT, dense_smem_bytes(2, TIER), st>>>(
                y, k, phi, p, DxT, Dy, ncomp, Ny, Nx, t);
            break;
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

template <int TIER, bool EDGE>
int deriv(const float* a, const float* b, const float* c, float* out, const void* DxT,
          const void* Dy, int nplanes, int Ny, int Nx, cudaStream_t st) {
    const dim3 grid(tiles(Nx), tiles(Ny), nplanes);
    deriv_kernel<TIER, EDGE><<<grid, DNT, dense_smem_bytes(1, TIER), st>>>(a, b, c, out, DxT, Dy,
                                                                           Ny, Nx);
    return (int)cudaGetLastError();
}

int g_sms = 0;   // the card's SMs (lf_dense_init)

template <int TN>
int deriv_bf16_tn(const float* a, const float* b, const float* c, float* out,
                  const __nv_bfloat16* DxT, const __nv_bfloat16* Dy, int nplanes, int Ny, int Nx,
                  cudaStream_t st) {
    const dim3 grid((Nx + TN - 1) / TN, (Ny + DB_TM - 1) / DB_TM, nplanes);
    const int nch = (a != nullptr ? (Nx + DB_K - 1) / DB_K : 0) +
                    (b != nullptr ? (Ny + DB_K - 1) / DB_K : 0);
    const size_t smem = (nch > 1 ? 2 : 1) * db_stage(TN);
    if (Ny % DB_TM != 0 || Nx % TN != 0)
        deriv_bf16_kernel<TN, true><<<grid, DB_NT, smem, st>>>(a, b, c, out, DxT, Dy, Ny, Nx);
    else
        deriv_bf16_kernel<TN, false><<<grid, DB_NT, smem, st>>>(a, b, c, out, DxT, Dy, Ny, Nx);
    return (int)cudaGetLastError();
}

// The 'bf16' derivative: 64-column tiles where they give every other SM a
// block at least (they read half the operand strips from the L2), else 32
// (a small plane's few tiles spread over more SMs). On the card the split
// is measured: 64 wins on 3 x 256^2 and 600^2, 32 on 200^2 and 160 x 200
// (scripts/torch_kernel_phases.py).
int deriv_bf16(const float* a, const float* b, const float* c, float* out, const void* DxT,
               const void* Dy, int nplanes, int Ny, int Nx, cudaStream_t st) {
    const long b64 = (long)((Ny + DB_TM - 1) / DB_TM) * ((Nx + 63) / 64) * nplanes;
    const auto* dx = static_cast<const __nv_bfloat16*>(DxT);
    const auto* dy = static_cast<const __nv_bfloat16*>(Dy);
    return 2 * b64 >= g_sms ? deriv_bf16_tn<64>(a, b, c, out, dx, dy, nplanes, Ny, Nx, st)
                      : deriv_bf16_tn<32>(a, b, c, out, dx, dy, nplanes, Ny, Nx, st);
}

}  // namespace

// Let the dense kernels take their stages as dynamic shared memory (the
// 'high' backward kind's 68 KB is above the 48 KB a kernel gets unasked).
// Once, before the first launch.
extern "C" int lf_dense_init() {
    int dev = 0;
    int rc = (int)cudaGetDevice(&dev);
    if (rc == 0) rc = (int)cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == 0) rc = allow_dense<TIER_F32, false>();
    if (rc == 0) rc = allow_dense<TIER_F32, true>();
    if (rc == 0) rc = allow_dense<TIER_HIGH, false>();
    if (rc == 0) rc = allow_dense<TIER_HIGH, true>();
    if (rc == 0) rc = allow_dense<TIER_BF16, false>();
    return rc != 0 ? rc : allow_dense<TIER_BF16, true>();
}

// k <- the velocity of flow `kind` at time t of the (nstate, Ny, Nx) state
// y; phi is (5, Ny, Nx) and p its p(t) planes, (2, Ny, Nx). `tier` picks
// FP32 (0), 'high' (1; DxT and Dy then their (2, n, n) bf16 split) or
// 'bf16' (2; their (n, n) bf16 heads). One launch.
extern "C" int lf_velocity(int tier, int kind, const float* y, float* k, const float* phi,
                           const float* p, const void* DxT, const void* Dy, int ncomp, int Ny,
                           int Nx, float t, void* stream) {
    const auto fn = dense_fn(tier, has_edge(Ny, Nx), velocity<TIER_F32, false>,
                             velocity<TIER_F32, true>, velocity<TIER_HIGH, false>,
                             velocity<TIER_HIGH, true>, velocity<TIER_BF16, false>,
                             velocity<TIER_BF16, true>);
    if (!dense_shape_ok(Ny, Nx, ncomp) || fn == nullptr) return (int)cudaErrorInvalidValue;
    return fn(kind, y, k, phi, p, DxT, Dy, ncomp, Ny, Nx, t, (cudaStream_t)stream);
}

extern "C" int lf_deriv(int tier, const float* a, const float* b, const float* c, float* out,
                        const void* DxT, const void* Dy, int nplanes, int Ny, int Nx,
                        void* stream) {
    if (!dense_shape_ok(Ny, Nx, nplanes)) return (int)cudaErrorInvalidValue;
    if (tier == TIER_BF16)
        return deriv_bf16(a, b, c, out, DxT, Dy, nplanes, Ny, Nx, (cudaStream_t)stream);
    const auto fn = dense_fn<decltype(&deriv<TIER_F32, false>)>(
        tier, has_edge(Ny, Nx), deriv<TIER_F32, false>, deriv<TIER_F32, true>,
        deriv<TIER_HIGH, false>, deriv<TIER_HIGH, true>, nullptr, nullptr);
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    return fn(a, b, c, out, DxT, Dy, nplanes, Ny, Nx, (cudaStream_t)stream);
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
