// The universal role-switched LenseFlow velocity kernel (K5) for NVIDIA
// Hopper (sm_90a), FP32 FMA.
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
// two launches. Role 1 nests its derivatives, so it is two such stages,
// four launches: the inner stage forms the two bracketed planes in a
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
// zero planes beyond their stores.
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
template <int B, int AXIS>
__global__ void __launch_bounds__(tile_threads(B), tile_min_blocks(B))
uni_kernel(int role, int stage, const float* __restrict__ a, const float* __restrict__ b,
           long long a_bs, long long a_cs, long long b_bs, long long b_cs, int nper,
           const float* __restrict__ px, const float* __restrict__ py, float* __restrict__ out,
           float* __restrict__ scratch, const float* __restrict__ Gt,
           const float* __restrict__ bf, int Ny, int Nx, float t) {
    extern __shared__ __align__(16) float smem[];   // tile_smem_bytes(B)
    load_butterflies<B>(bf, smem);
    const size_t plane = (size_t)Ny * Nx;
    const int nder = role == 1 && stage == 1 ? 1 : 2;
    const int z = blockIdx.z / nder, j = blockIdx.z % nder, bi = z / nper, ci = z % nper;
    const float* az = a + bi * a_bs + ci * a_cs;
    const float* bz = b + bi * b_bs + ci * b_cs;
    const float* pa = (AXIS == AXIS_X ? px : py) + (size_t)bi * plane;   // p along this axis
    float* o = out + (size_t)z * 4 * plane;
    float* sc = role == 1 ? scratch + (size_t)z * 2 * plane : nullptr;
    const bool first = AXIS == AXIS_X;     // the x pass stores, the y pass adds
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
    // the y pass adds onto the x pass's plane with a result-less atomicAdd:
    // one add per pixel, so the sum is that of a load, add and store
    fact_tile<B, AXIS>(
        Gt, smem, m0, o0, Nx,
        [&](int q) {
            const float x = src[q];
            return pre ? scale * pa[q] * x : x;
        },
        [&](int q, float v) {
            if (role == 0 && j == 0) {
                o[(2 + AXIS) * plane + q] = bz[q] * v;     // b d_x a, b d_y a
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

}  // namespace

// Once after loading, before any launch: the kernel's dynamic shared memory.
extern "C" int lf_uni_init() {
    int rc = allow_tile_smem(uni_kernel<4, AXIS_X>, 4);
    if (rc == 0) rc = allow_tile_smem(uni_kernel<4, AXIS_Y>, 4);
    if (rc == 0) rc = allow_tile_smem(uni_kernel<8, AXIS_X>, 8);
    if (rc == 0) rc = allow_tile_smem(uni_kernel<8, AXIS_Y>, 8);
    return rc;
}

// out <- the role's velocity (see the header) of the (nbatch, nper) entries
// of a and b, at time t; px, py are (nbatch, Ny, Nx), out is (nbatch, nper,
// 4, Ny, Nx) and scratch (nbatch, nper, 2, Ny, Nx) (role 1 only; may be
// null otherwise); FX and FYT are the packed blocks, both transposed
// (fact_tile.cuh). Two launches, four for role 1.
extern "C" int lf_uni_velocity(int role, const float* a, const float* b, long long a_bs,
                               long long a_cs, long long b_bs, long long b_cs, const float* px,
                               const float* py, float* out, float* scratch, const float* FX,
                               const float* FYT, const float* bfx, const float* bfy, int Bx,
                               int By, int nbatch, int nper, int Ny, int Nx, float t,
                               void* stream) {
    if (!shape_ok(Bx, By, Ny, Nx) || role < 0 || role > 3 || nbatch < 1 || nper < 1 ||
        (role == 1 && scratch == nullptr))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    for (int stage = 0; stage < (role == 1 ? 2 : 1); ++stage) {
        const int nz = nbatch * nper * (role == 1 && stage == 1 ? 1 : 2);
        LF_WITH_RADIX(Bx, uni_kernel<B, AXIS_X><<<pass_grid<AXIS_X>(Ny, Nx, nz), tile_threads(B),
                                                  tile_smem_bytes(B), st>>>(
                              role, stage, a, b, a_bs, a_cs, b_bs, b_cs, nper, px, py, out,
                              scratch, FX, bfx, Ny, Nx, t))
        int rc = (int)cudaGetLastError();
        if (rc != 0) return rc;
        LF_WITH_RADIX(By, uni_kernel<B, AXIS_Y><<<pass_grid<AXIS_Y>(Ny, Nx, nz), tile_threads(B),
                                                  tile_smem_bytes(B), st>>>(
                              role, stage, a, b, a_bs, a_cs, b_bs, b_cs, nper, px, py, out,
                              scratch, FYT, bfy, Ny, Nx, t))
        rc = (int)cudaGetLastError();
        if (rc != 0) return rc;
    }
    return 0;
}
