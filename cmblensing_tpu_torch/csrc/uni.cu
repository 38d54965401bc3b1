// The universal role-switched LenseFlow velocity kernel (K5) for NVIDIA
// Hopper (sm_90a) on factored operands: FP32 FMA, and the 'high' and
// 'bf16' tiers on the tensor cores (the entry's `tier` argument). Its
// dense form is uni_dense.cu.
//
// Replaces `_bwdAB_kernel` (cmblensing_tpu/ops/pallas_lenseflow.py, launched
// by `_uni_call`): every velocity of every flow as calls of one kernel,
// with a run-time `role` picking the math on the planes a, b and the
// p(t) planes px, py (computed outside, as the TPU kernel's XLA glue does):
//
//   role 0  a = f_c, b = delta f_c:
//           out = [p . grad a, div(p b), b d_x a, b d_y a]       4 derivatives
//   role 1  a = u_x, b = u_y, s = t:
//           out = [d_x(a + d_x(t px a) + d_y(t py a))
//                  + d_y(b + d_x(t px b) + d_y(t py b)), 0, 0, 0] 6 derivatives
//   role 2  a, b = two components: out = [p . grad a, p . grad b, 0, 0]
//   role 3  a, b = two components: out = [div(p a), div(p b), 0, 0]
//
// Built on the tiled factored derivative `fact_tile` (fact_tile.cuh), as K3
// and K4 are: each role is an x pass that stores and a y pass that adds,
// two launches (a launch a channel group and pass at radix 16 and 32,
// below). Role 1 nests its derivatives, so it is two such stages: the
// inner stage forms the two bracketed planes in a
// scratch buffer (the t p multiply in the load functor, a or b added at
// store), the outer stage differentiates them. One binary serves every role
// and every t. A launch takes up to two derivatives per entry, one
// fact_tile call each on blocks of their own, with the role's load and
// store chosen at run time inside the functors, so the kernel holds one
// fact_tile instantiation per radix and axis; the branches are uniform
// across a block and sit outside the FMA loop.
//
// Batch x entry x derivative rides on the grid's z axis (entry index
// batch * nper + entry): an
// entry is a component (role 0), a component pair (roles 2, 3) or the one
// u pair (role 1), so the line search's 17 trials are one launch per pass.
// a and b may be strided views of a flow state: entry z reads them at
// (z / nper) * bs + (z % nper) * cs elements; px, py are one plane per
// batch; out holds 4 planes and the scratch 2 planes per entry.
//
// What bounds it on this card: FP32 FMA, as K3. At N = 1024, B = 8 a
// derivative is 0.47 GFLOP of block products and 4 planes of butterflies;
// roles 0, 2 and 3 do 4 derivatives, role 1 six, against 8 planes of
// traffic (a, b, px, py in, out). Role 1 also moves its scratch (2 planes
// written, read and re-read). It runs on K1's tile as K3 and K4 do (see
// fact_tile.cuh for what that tile does about the shared-memory load
// rate, butterfly recomputation and latency) and spends nothing on the
// zero planes beyond their stores. At 'high' and 'bf16' the block
// products shrink to a few percent of the tile's time and its other
// phases set the pace, bound by bytes as K3's reduced tiers are
// (fact_tile.cuh).
//
// Tiers: `_bwdAB_kernel` builds its derivatives with `_make_dd_any(...,
// precision, fmeta)`, `_mk_dot('high')` (:225) or `_mk_dot('bf16')` (:218)
// at the reduced tiers; here fact_tile<B, AXIS, TIER> (fact_tile.cuh) runs
// them, the blocks split ([head, residual] bf16, FactoredOps.FXS / FYTS)
// at 'high', their heads at 'bf16', every channel value split or rounded
// as its slab is formed. Role 1's outer stage differentiates the inner
// stage's stored sums, so at a reduced tier it rounds those sums, as JAX
// rounds `a + ddx(t px a) + ddy(t py a)`. The loads, stores and the y
// pass's one add per pixel are the FP32 form's at every tier.
//
// Radix 16 and 32 run fact_tile's channel groups as K1, K3 and K4 do
// (LF_TILE_LAUNCH): a launch a group and pass, in order, g the last
// argument, each adding its partial sum of the derivative. The x pass's
// group 0 stores where the one-group kernel stores and every later launch
// adds, so each later group adds only what is linear in its partial sum:
// role 0's b d_x a and b d_y a, each pass's own plane, are stored by that
// pass's group 0 and added to by its later groups; role 1's "+ a" (or
// "+ b") and the planes a role leaves at zero are written by the x pass's
// group 0 alone. At a reduced tier role 1's outer stage splits or rounds
// the inner sums, which are now also summed over the groups (in the
// launches' fixed order, so the bits are the same every run).
//
// Plain C interface, loaded with ctypes. Every launch goes on the caller's
// stream; the entry point returns the first nonzero cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

#include "fact_tile.cuh"

namespace {

// One pass (AXIS) of one derivative of one stage of the role's velocity:
// blockIdx.z = entry * nder + j, j the stage's derivative (each is one
// fact_tile call, independent of the other, so they ride on the grid).
template <int B, int AXIS, int TIER>
__global__ void __launch_bounds__(tile_threads(B), tile_min_blocks(B))
uni_kernel(int role, int stage, const float* __restrict__ a, const float* __restrict__ b,
           long long a_bs, long long a_cs, long long b_bs, long long b_cs, int nper,
           const float* __restrict__ px, const float* __restrict__ py, float* __restrict__ out,
           float* __restrict__ scratch, const void* __restrict__ Gt,
           const float* __restrict__ bf, int Ny, int Nx, float t, int g) {
    extern __shared__ __align__(16) float smem[];   // tile_smem_bytes(B, TIER)
    load_butterflies<B, TIER>(bf, smem, g);
    const size_t plane = (size_t)Ny * Nx;
    const int nder = role == 1 && stage == 1 ? 1 : 2;
    const int z = blockIdx.z / nder, j = blockIdx.z % nder, bi = z / nper, ci = z % nper;
    const float* az = a + bi * a_bs + ci * a_cs;
    const float* bz = b + bi * b_bs + ci * b_cs;
    const float* pa = (AXIS == AXIS_X ? px : py) + (size_t)bi * plane;   // p along this axis
    float* o = out + (size_t)z * 4 * plane;
    float* sc = role == 1 ? scratch + (size_t)z * 2 * plane : nullptr;
    // the x pass's first channel group stores, every later launch adds
    const bool first = AXIS == AXIS_X && g == 0;
    const bool inner = role == 1 && stage == 0;
    int m0, o0;
    tile_origin<AXIS>(m0, o0);
    // the operand: a or b, or (outer stage) the bracketed plane of this axis
    const float* src = role == 1 && stage == 1 ? sc + AXIS * plane : (j == 0 ? az : bz);
    // multiplied by p (times t in the inner stage) before the derivative
    const bool pre = (role == 0 && j == 1) || inner || role == 3;
    const float scale = inner ? t : 1.f;
    // where the derivative goes: out plane j, or the inner stage's scratch plane j
    float* dst = inner ? sc + j * plane : (role == 1 ? o : o + j * plane);
    // a later launch adds onto the first one's plane with a result-less
    // atomicAdd: one add per pixel, so the sum is that of a load, add and store
    fact_tile<B, AXIS, TIER>(
        Gt, smem, m0, o0, g, Nx,
        [&](int q) {
            const float x = src[q];
            return pre ? scale * pa[q] * x : x;
        },
        [&](int q, float v) {
            if (role == 0 && j == 0) {
                float* bd = o + (2 + AXIS) * plane + q;    // b d_x a, b d_y a: this pass's plane
                if (g == 0) *bd = bz[q] * v;
                else atomicAdd(bd, bz[q] * v);
                v *= pa[q];                                // p . grad a
            } else if (role == 2) {
                v *= pa[q];                                // p . grad of a, b
            }
            if (inner && first) v += src[q];               // a (or b) + d_x(t px a)
            if (first) dst[q] = v;
            else atomicAdd(dst + q, v);
            if (first && j == 0 && role != 0) {
                // the planes this role leaves at zero
                if (role == 1 && stage == 1) o[plane + q] = 0.f;
                if (role != 1 || stage == 1) {
                    o[2 * plane + q] = 0.f;
                    o[3 * plane + q] = 0.f;
                }
            }
        });
}

template <int B, int TIER>
int allow_uni_radix() {
    const int rc = allow_tile_smem(uni_kernel<B, AXIS_X, TIER>, B, TIER);
    return rc != 0 ? rc : allow_tile_smem(uni_kernel<B, AXIS_Y, TIER>, B, TIER);
}

template <int TIER>
int allow_uni() {
    int rc = allow_uni_radix<4, TIER>();
    if (rc == 0) rc = allow_uni_radix<8, TIER>();
    if (rc == 0) rc = allow_uni_radix<16, TIER>();
    return rc != 0 ? rc : allow_uni_radix<32, TIER>();
}

// One velocity at one tier: an x pass and a y pass a stage, a launch a
// channel group each.
template <int TIER>
int uni_velocity(int role, const float* a, const float* b, long long a_bs, long long a_cs,
                 long long b_bs, long long b_cs, const float* px, const float* py, float* out,
                 float* scratch, const void* FX, const void* FYT, const float* bfx,
                 const float* bfy, int Bx, int By, int nbatch, int nper, int Ny, int Nx, float t,
                 cudaStream_t st) {
    for (int stage = 0; stage < (role == 1 ? 2 : 1); ++stage) {
        const int nz = nbatch * nper * (role == 1 && stage == 1 ? 1 : 2);
        LF_WITH_RADIX(Bx, LF_TILE_LAUNCH(uni_kernel, AXIS_X, nz, role, stage, a, b, a_bs, a_cs,
                                         b_bs, b_cs, nper, px, py, out, scratch, FX, bfx, Ny, Nx,
                                         t))
        int rc = (int)cudaGetLastError();
        if (rc != 0) return rc;
        LF_WITH_RADIX(By, LF_TILE_LAUNCH(uni_kernel, AXIS_Y, nz, role, stage, a, b, a_bs, a_cs,
                                         b_bs, b_cs, nper, px, py, out, scratch, FYT, bfy, Ny, Nx,
                                         t))
        rc = (int)cudaGetLastError();
        if (rc != 0) return rc;
    }
    return 0;
}

}  // namespace

// Once after loading, before any launch: the kernel's dynamic shared memory
// at every tier (the 'high' ring is 115 KB at B = 8).
extern "C" int lf_uni_init() {
    int rc = allow_uni<TIER_F32>();
    if (rc == 0) rc = allow_uni<TIER_HIGH>();
    return rc != 0 ? rc : allow_uni<TIER_BF16>();
}

// out <- the role's velocity (see the header) of the (nbatch, nper) entries
// of a and b, at time t; px, py are (nbatch, Ny, Nx), out is (nbatch, nper,
// 4, Ny, Nx) and scratch (nbatch, nper, 2, Ny, Nx) (role 1 only; may be
// null otherwise). `tier` picks FP32 (0), 'high' (1) or 'bf16' (2); FX and
// FYT are the packed blocks, both transposed (fact_tile.cuh): FP32, at
// 'high' their bf16 split (2, B, A, A), at 'bf16' their heads. Two
// launches a channel group (one group up to B = 8, B / 8 from 16), four
// for role 1.
extern "C" int lf_uni_velocity(int tier, int role, const float* a, const float* b,
                               long long a_bs, long long a_cs, long long b_bs, long long b_cs,
                               const float* px, const float* py, float* out, float* scratch,
                               const void* FX, const void* FYT, const float* bfx,
                               const float* bfy, int Bx, int By, int nbatch, int nper, int Ny,
                               int Nx, float t, void* stream) {
    if (!shape_ok(Bx, By, Ny, Nx) || role < 0 || role > 3 || nbatch < 1 || nper < 1 ||
        (role == 1 && scratch == nullptr))
        return (int)cudaErrorInvalidValue;
    const auto fn = tier == TIER_F32    ? &uni_velocity<TIER_F32>
                    : tier == TIER_HIGH ? &uni_velocity<TIER_HIGH>
                    : tier == TIER_BF16 ? &uni_velocity<TIER_BF16>
                                        : nullptr;
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    return fn(role, a, b, a_bs, a_cs, b_bs, b_cs, px, py, out, scratch, FX, FYT, bfx, bfy, Bx, By,
              nbatch, nper, Ny, Nx, t, (cudaStream_t)stream);
}
