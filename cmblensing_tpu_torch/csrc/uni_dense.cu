// The universal role-switched LenseFlow velocity kernel (K5) on dense
// circulant operands, for NVIDIA Hopper (sm_90a): FP32 FMA, and the 'high'
// and 'bf16' tiers on the tensor cores (the entry's `tier` argument).
//
// Replaces `_bwdAB_kernel` (cmblensing_tpu/ops/pallas_lenseflow.py:734,
// launched by `_uni_call` :795) where `_run_flow` hands it the dense
// `_make_ddx_ddy` operands (:86; 'bf16' :92, 'high' :102): any size no
// built radix divides, or every size under CMBL_PALLAS_FACT=0. The roles
// are the factored form's (uni.cu):
//
//   role 0  a = f_c, b = delta f_c:
//           out = [p . grad a, div(p b), b d_x a, b d_y a]
//   role 1  a = u_x, b = u_y, t:
//           out = [d_x(a + d_x(t px a) + d_y(t py a))
//                  + d_y(b + d_x(t px b) + d_y(t py b)), 0, 0, 0]
//   role 2  a, b = two components: out = [p . grad a, p . grad b, 0, 0]
//   role 3  a, b = two components: out = [div(p a), div(p b), 0, 0]
//
// Built on `dense_xy` (dense_tile.cuh), the product K2 runs: a block forms
// both derivatives of a 32 x 32 output tile and combines them inside the
// block, so a role is one launch and needs no atomics. Role 0 takes two
// operands a block, a and p b (p along the product's axis: K2's backward
// kind without its sum over components). Roles 2 and 3 take one: an
// entry's two products run on blocks of their own. Role 1 is two stages,
// two launches: the inner stage forms a + d_x(t px a) + d_y(t py a) (the
// load functor multiplies by t p along the product's axis, a is added at
// store) into a scratch plane, one block per entry, plane and tile, and the
// outer stage is K2's derivative d_x(scratch_a) + d_y(scratch_b). Batch x
// entry (x operand, where it splits) rides on the grid's z axis, so the
// line search's 17 trials are one launch a stage. a and b may be strided
// views of a flow state: entry z reads them at (z / nper) * bs +
// (z % nper) * cs elements; px, py are one plane per batch entry; out
// holds 4 planes and the scratch 2 planes per entry. The planes a role
// leaves at zero are written as zero by the block of its first plane;
// nothing is written past a plane (dense_tile.cuh's EDGE guards, chosen at
// launch as K2's, so that planes whose sides are multiples of 32 run the
// unguarded loads).
//
// Tiers: dense_xy's template parameter. 'high' takes the circulants' bf16
// split made on the host and splits the operand as its slab is staged;
// 'bf16' takes their heads and rounds the operand once. Role 1's outer
// stage rounds the inner stage's stored sums, as JAX rounds
// `a + ddx(t px a) + ddy(t py a)`.
//
// What bounds it on this card: as K2 (lenseflow.cu), FP32 FMA in the
// products (2 N^3 a derivative), but at 256^2 a plane is 64 tiles, so a
// launch's occupancy and the shared-memory load rate inside a block set
// the pace; at the reduced tiers the loads, the split and the combine.
//
// Plain C interface, loaded with ctypes. Every launch goes on the caller's
// stream; the entry point returns the first nonzero cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

#include "dense_tile.cuh"

namespace {

__device__ __forceinline__ float4 scale4(float s, float4 v) {
    return make_float4(s * v.x, s * v.y, s * v.z, s * v.w);
}

// One stage of one role's velocity. blockIdx.z is the entry (role 0 and
// role 1's outer stage) or entry * 2 + j, j the operand (a or b) of roles
// 2, 3 and role 1's inner stage. NOP is 2 for role 0 (a, and p b), else 1.
template <int NOP, int TIER, bool EDGE>
__global__ void __launch_bounds__(DNT)
uni_dense_kernel(int role, int stage, const float* __restrict__ a, const float* __restrict__ b,
                 long long a_bs, long long a_cs, long long b_bs, long long b_cs, int nper,
                 const float* __restrict__ px, const float* __restrict__ py,
                 float* __restrict__ out, float* __restrict__ scratch,
                 const void* __restrict__ DxT, const void* __restrict__ Dy, int Ny, int Nx,
                 float t) {
    extern __shared__ float4 dense_smem[];
    float* sm = reinterpret_cast<float*>(dense_smem);
    const size_t plane = (size_t)Ny * Nx;
    const bool inner = role == 1 && stage == 0, outer = role == 1 && stage == 1;
    const bool split = NOP == 1 && !outer;   // an entry's two operands on blocks of their own
    const int z = split ? blockIdx.z / 2 : blockIdx.z, j = split ? blockIdx.z % 2 : 0;
    const int bi = z / nper, ci = z % nper;
    const float* az = a + bi * a_bs + ci * a_cs;
    const float* bz = b + bi * b_bs + ci * b_cs;
    const float* src = j == 0 ? az : bz;
    const float* pxz = px + (size_t)bi * plane;
    const float* pyz = py + (size_t)bi * plane;
    float* o = out + (size_t)z * 4 * plane;
    float* sc = role == 1 ? scratch + (size_t)z * 2 * plane : nullptr;
    const int tid = threadIdx.x;
    // this thread's four output pixels
    const int row = blockIdx.y * DT + tid / 8, col = blockIdx.x * DT + (tid % 8) * 4;
    float4 X[NOP], Y[NOP];
    dense_xy<NOP, TIER, EDGE>(
        DxT, Dy, Ny, Nx, sm, true, true,
        [&](int axis, int op, int r, int cc) {
            // the outer stage differentiates the bracketed plane of its axis
            if (outer) return ldq<EDGE>(sc + axis * plane, r, cc, Ny, Nx);
            const float4 v = ldq<EDGE>(NOP == 2 && op == 0 ? az : (NOP == 2 ? bz : src), r, cc,
                                       Ny, Nx);
            // a as it is (role 0's first operand, role 2); p b (role 0), p a
            // (role 3), (t p) a (role 1's inner stage), p along the product's axis
            if ((NOP == 2 && op == 0) || role == 2) return v;
            const float4 p = ldq<EDGE>(axis == 0 ? pxz : pyz, r, cc, Ny, Nx);
            return mul4(inner ? scale4(t, p) : p, v);
        },
        X, Y);
    if constexpr (NOP == 2) {   // role 0
        const float4 bv = ldq<EDGE>(bz, row, col, Ny, Nx);
        stq<EDGE>(o, row, col, Ny, Nx,
                  add4(mul4(ldq<EDGE>(pxz, row, col, Ny, Nx), X[0]),
                       mul4(ldq<EDGE>(pyz, row, col, Ny, Nx), Y[0])));   // p . grad a
        stq<EDGE>(o + plane, row, col, Ny, Nx, add4(X[1], Y[1]));       // div(p b)
        stq<EDGE>(o + 2 * plane, row, col, Ny, Nx, mul4(bv, X[0]));     // b d_x a
        stq<EDGE>(o + 3 * plane, row, col, Ny, Nx, mul4(bv, Y[0]));     // b d_y a
    } else if (inner) {
        // (a + d_x(t px a)) + d_y(t py a), summed in JAX's order
        stq<EDGE>(sc + j * plane, row, col, Ny, Nx,
                  add4(add4(ldq<EDGE>(src, row, col, Ny, Nx), X[0]), Y[0]));
    } else {
        const float4 v = role == 2 ? add4(mul4(ldq<EDGE>(pxz, row, col, Ny, Nx), X[0]),
                                          mul4(ldq<EDGE>(pyz, row, col, Ny, Nx), Y[0]))
                                   : add4(X[0], Y[0]);   // role 3, role 1's outer stage
        stq<EDGE>(o + j * plane, row, col, Ny, Nx, v);
        if (j == 0) {   // the planes this role leaves at zero
            const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
            if (outer) stq<EDGE>(o + plane, row, col, Ny, Nx, zero);
            stq<EDGE>(o + 2 * plane, row, col, Ny, Nx, zero);
            stq<EDGE>(o + 3 * plane, row, col, Ny, Nx, zero);
        }
    }
}

template <int TIER, bool EDGE>
int allow_uni_dense() {
    const int rc = allow(uni_dense_kernel<1, TIER, EDGE>, dense_smem_bytes(1, TIER));
    return rc != 0 ? rc : allow(uni_dense_kernel<2, TIER, EDGE>, dense_smem_bytes(2, TIER));
}

// One velocity at one tier, with the edge guards or without: a launch a
// stage.
template <int TIER, bool EDGE>
int uni_dense(int role, const float* a, const float* b, long long a_bs, long long a_cs,
              long long b_bs, long long b_cs, const float* px, const float* py, float* out,
              float* scratch, const void* DxT, const void* Dy, int nbatch, int nper, int Ny,
              int Nx, float t, cudaStream_t st) {
    const int ne = nbatch * nper;
    for (int stage = 0; stage < (role == 1 ? 2 : 1); ++stage) {
        const bool split = role != 0 && !(role == 1 && stage == 1);
        const dim3 grid(tiles(Nx), tiles(Ny), split ? 2 * ne : ne);
        if (role == 0)
            uni_dense_kernel<2, TIER, EDGE><<<grid, DNT, dense_smem_bytes(2, TIER), st>>>(
                role, stage, a, b, a_bs, a_cs, b_bs, b_cs, nper, px, py, out, scratch, DxT, Dy,
                Ny, Nx, t);
        else
            uni_dense_kernel<1, TIER, EDGE><<<grid, DNT, dense_smem_bytes(1, TIER), st>>>(
                role, stage, a, b, a_bs, a_cs, b_bs, b_cs, nper, px, py, out, scratch, DxT, Dy,
                Ny, Nx, t);
        const int rc = (int)cudaGetLastError();
        if (rc != 0) return rc;
    }
    return 0;
}

}  // namespace

// Once after loading, before any launch: the kernels' dynamic shared memory
// (role 0's 'high' stages, 68 KB, are above the 48 KB a kernel gets unasked).
extern "C" int lf_uni_dense_init() {
    int rc = allow_uni_dense<TIER_F32, false>();
    if (rc == 0) rc = allow_uni_dense<TIER_F32, true>();
    if (rc == 0) rc = allow_uni_dense<TIER_HIGH, false>();
    if (rc == 0) rc = allow_uni_dense<TIER_HIGH, true>();
    if (rc == 0) rc = allow_uni_dense<TIER_BF16, false>();
    return rc != 0 ? rc : allow_uni_dense<TIER_BF16, true>();
}

// out <- the role's velocity (see the header) of the (nbatch, nper) entries
// of a and b, at time t; px, py are (nbatch, Ny, Nx), out is (nbatch, nper,
// 4, Ny, Nx) and scratch (nbatch, nper, 2, Ny, Nx) (role 1 only; may be
// null otherwise). `tier` picks FP32 (0), 'high' (1; DxT and Dy then their
// (2, n, n) bf16 split) or 'bf16' (2; their (n, n) bf16 heads). One
// launch, two for role 1.
extern "C" int lf_uni_dense_velocity(int tier, int role, const float* a, const float* b,
                                     long long a_bs, long long a_cs, long long b_bs,
                                     long long b_cs, const float* px, const float* py,
                                     float* out, float* scratch, const void* DxT, const void* Dy,
                                     int nbatch, int nper, int Ny, int Nx, float t,
                                     void* stream) {
    const auto fn = dense_fn(tier, has_edge(Ny, Nx), &uni_dense<TIER_F32, false>,
                             &uni_dense<TIER_F32, true>, &uni_dense<TIER_HIGH, false>,
                             &uni_dense<TIER_HIGH, true>, &uni_dense<TIER_BF16, false>,
                             &uni_dense<TIER_BF16, true>);
    if (fn == nullptr || role < 0 || role > 3 || nbatch < 1 || nper < 1 ||
        !dense_shape_ok(Ny, Nx, 2 * nbatch * nper) || (role == 1 && scratch == nullptr))
        return (int)cudaErrorInvalidValue;
    return fn(role, a, b, a_bs, a_cs, b_bs, b_cs, px, py, out, scratch, DxT, Dy, nbatch, nper, Ny,
              Nx, t, (cudaStream_t)stream);
}
