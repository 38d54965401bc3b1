// The factored LenseFlow kernels on fact_tile (K1 strict, K3 where
// lenseflow_common.cuh::k3_on_tile puts it: strict at radix 4 and 8,
// 'high' at 8; K4 at every tier) and their host launchers, shared by the
// three sources that instantiate them, one precision tier each:
// factored.cu (FP32, and the C entries), factored_high.cu ('high') and
// factored_bf16.cu ('bf16'), compiled in parallel. K1 at 'high' and
// 'bf16', and K3 everywhere else, run the cluster tile (fact_sm90.cuh:
// fderiv_sm90.cu, fa_sm90.cu).
// See factored.cu for what each kernel replaces and computes.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "fact_tile.cuh"
#include "lenseflow_common.cuh"

namespace {

constexpr int NACC = 5;   // delta-phi accumulator planes of the backward state

// Where a pass adds onto what an earlier pass, component or channel group
// stored, it does so with atomicAdd whose result is unused (a RED at the
// L2), without a load's latency between the tile's stores. Every pixel of
// a launch is stored and added to by one thread only, in program order,
// and launches run in stream order, so the sum and its rounding are those
// of a load, add and store, the same in every run. K1 and K4 at radix 16
// and 32 run fact_tile's channel groups as launches of their own, in order
// (g, every kernel's last argument): group 0 stores where the one-group
// tile stores, and every later group adds; K3 here runs one group (radix
// 4 and 8). (The cluster tile's kernels need none of this: each pixel is
// summed over every channel in one CTA.)

// K1, strict: out = D a (+ c), or out += D a, along AXIS over blockIdx.z
// planes. G: the FP32 blocks (fact_tile.cuh).
template <int B, int AXIS, int TIER>
__global__ void __launch_bounds__(tile_threads(B), tile_min_blocks(B))
fderiv_kernel(const float* __restrict__ a, const float* __restrict__ c, float* __restrict__ out,
              const void* __restrict__ G, const float* __restrict__ bf, int Ny, int Nx,
              int accumulate, int g) {
    extern __shared__ __align__(16) float smem[];   // tile_smem_bytes(B, TIER)
    load_butterflies<B, TIER>(bf, smem, g);
    const size_t base = (size_t)blockIdx.z * Ny * Nx;
    const float* ap = a + base;
    const float* cp = c != nullptr ? c + base : nullptr;
    float* op = out + base;
    int m0, o0;
    tile_origin<AXIS>(m0, o0);
    fact_tile<B, AXIS, TIER>(
        G, smem, m0, o0, g, Nx, [&](int q) { return ap[q]; },
        [&](int q, float v) {
            if (g == 0 && cp != nullptr) v += cp[q];
            if (g == 0 && !accumulate) op[q] = v;
            else atomicAdd(op + q, v);
        });
}

// K3 where it runs this tile (k3_on_tile): one pass of a forward (role 0:
// p . grad y, p multiplied after the derivative) or adjoint (role 1:
// div(p y), p multiplied before) velocity (on the cluster tile:
// fa_sm90.cu).
// The x pass stores p_x d_x y (or d_x(p_x y)), the y pass adds the y term.
// blockIdx.z = batch * ncomp + component; p holds the planes (p_x, p_y) of
// every batch entry, (2, nbatch, Ny, Nx).
template <int B, int AXIS, int TIER>
__global__ void __launch_bounds__(tile_threads(B), tile_min_blocks(B))
fa_kernel(const float* __restrict__ y, float* __restrict__ k, const float* __restrict__ p,
          const void* __restrict__ G, const float* __restrict__ bf, int ncomp, int nbatch,
          int Ny, int Nx, int role, int g) {
    static_assert(tile_groups(B) == 1, "K3 on fact_tile holds every channel in one group");
    extern __shared__ __align__(16) float smem[];   // tile_smem_bytes(B, TIER)
    load_butterflies<B, TIER>(bf, smem, g);
    const size_t plane = (size_t)Ny * Nx;
    const float* yp = y + blockIdx.z * plane;
    float* kp = k + blockIdx.z * plane;
    // p along this axis
    const float* pa = p + ((size_t)(AXIS == AXIS_X ? 0 : nbatch) + blockIdx.z / ncomp) * plane;
    int m0, o0;
    tile_origin<AXIS>(m0, o0);
    fact_tile<B, AXIS, TIER>(
        G, smem, m0, o0, g, Nx, [&](int q) { return role != 0 ? pa[q] * yp[q] : yp[q]; },
        [&](int q, float v) {
            if (role == 0) v *= pa[q];
            if (AXIS == AXIS_X) kp[q] = v;
            else atomicAdd(kp + q, v);
        });
}

// K4: one pass of the backward velocity over the state
// (f_0.., delta f_0.., 5 accumulators) of batch blockIdx.z. The x pass
// stores p_x d_x f_c, d_x(p_x delta f_c) and w_x (held in the first
// accumulator slot); the y pass adds the y terms, accumulates w_y in the
// second slot and then, in its last channel group's launch, writes
// u = M^-1 w and the five integrands. p as K3's; M^-1(t) is rebuilt from phi's 5
// planes per batch at the output pixels.
template <int B, int AXIS, int TIER>
__global__ void __launch_bounds__(tile_threads(B), tile_min_blocks(B))
bv_kernel(const float* __restrict__ y, float* __restrict__ k, const float* __restrict__ phi,
          const float* __restrict__ p, const void* __restrict__ G,
          const float* __restrict__ bf, int ncomp, int nbatch, int Ny, int Nx, float t,
          int g) {
    extern __shared__ __align__(16) float smem[];   // tile_smem_bytes(B, TIER)
    load_butterflies<B, TIER>(bf, smem, g);
    const size_t plane = (size_t)Ny * Nx;
    const size_t nstate = 2 * ncomp + NACC;
    const float* yb = y + blockIdx.z * nstate * plane;
    float* kb = k + blockIdx.z * nstate * plane;
    const float* pa = p + ((size_t)(AXIS == AXIS_X ? 0 : nbatch) + blockIdx.z) * plane;
    float* w = kb + (2 * ncomp + AXIS) * plane;   // w_x (x pass) or w_y (y pass)
    int m0, o0;
    tile_origin<AXIS>(m0, o0);
    const bool store = AXIS == AXIS_X && g == 0;   // else add
    for (int c = 0; c < ncomp; ++c) {
        const float* f = yb + c * plane;
        const float* df = yb + (ncomp + c) * plane;
        float* kf = kb + c * plane;
        float* kdf = kb + (ncomp + c) * plane;
        fact_tile<B, AXIS, TIER>(
            G, smem, m0, o0, g, Nx, [&](int q) { return f[q]; },
            [&](int q, float v) {   // v = d f_c
                const float pv = pa[q] * v, dw = df[q] * v;
                if (store) kf[q] = pv;
                else atomicAdd(kf + q, pv);
                if (c == 0 && g == 0) w[q] = dw;
                else atomicAdd(w + q, dw);
            });
        fact_tile<B, AXIS, TIER>(
            G, smem, m0, o0, g, Nx, [&](int q) { return pa[q] * df[q]; },
            [&](int q, float v) {
                if (store) kdf[q] = v;
                else atomicAdd(kdf + q, v);
            });
    }
    if (AXIS == AXIS_Y && g == tile_groups(B) - 1) {
        // w is complete at this thread's pixels (its own stores and adds,
        // and the x pass's before this launch); read it where the adds
        // were made, at the L2
        __threadfence();
        const float* ph = phi + (size_t)blockIdx.z * 5 * plane;
        float* acc = kb + 2 * ncomp * plane;
        for (int q = 0; q < tile_pixels(B); ++q)
            for (int r = 0; r < B; ++r) {
                const size_t o = out_offset<B, AXIS>(q, r, m0, o0, Nx);
                dphi_integrands(ph, plane, o, t, __ldcg(acc + o), __ldcg(acc + plane + o), acc);
            }
    }
}

template <int B, int TIER>
int allow_smem() {
    int rc = 0;
    if constexpr (TIER == TIER_F32) {   // K1's reduced tiers run fact_sm90.cuh
        rc = allow_tile_smem(fderiv_kernel<B, AXIS_X, TIER>, B, TIER);
        if (rc == 0) rc = allow_tile_smem(fderiv_kernel<B, AXIS_Y, TIER>, B, TIER);
    }
    if constexpr (k3_on_tile(B, TIER)) {   // K3's other forms run fact_sm90.cuh
        if (rc == 0) rc = allow_tile_smem(fa_kernel<B, AXIS_X, TIER>, B, TIER);
        if (rc == 0) rc = allow_tile_smem(fa_kernel<B, AXIS_Y, TIER>, B, TIER);
    }
    if (rc == 0) rc = allow_tile_smem(bv_kernel<B, AXIS_X, TIER>, B, TIER);
    if (rc == 0) rc = allow_tile_smem(bv_kernel<B, AXIS_Y, TIER>, B, TIER);
    return rc;
}

// every radix's kernels at one tier
template <int TIER>
int allow_smem_all() {
    int rc = allow_smem<4, TIER>();
    if (rc == 0) rc = allow_smem<8, TIER>();
    if (rc == 0) rc = allow_smem<16, TIER>();
    return rc != 0 ? rc : allow_smem<32, TIER>();
}

// out = d_x a + d_y b + c over nplanes planes, strict (TIER_F32; the
// reduced tiers are lf_sm90::fderiv, fderiv_sm90.cu); a or b (not both) and
// c may be null; out must not alias a or b. One launch per non-null
// derivative and channel group.
template <int TIER>
int fderiv(const float* a, const float* b, const float* c, float* out, const void* FX,
           const void* FYT, const float* bfx, const float* bfy, int Bx, int By, int nplanes,
           int Ny, int Nx, void* stream) {
    if (!shape_ok(Bx, By, Ny, Nx) || (a == nullptr && b == nullptr))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (a != nullptr) {
        LF_WITH_RADIX(Bx, LF_TILE_LAUNCH(fderiv_kernel, AXIS_X, nplanes, a, c, out, FX, bfx, Ny,
                                         Nx, 0))
        const int rc = (int)cudaGetLastError();
        if (rc != 0) return rc;
    }
    if (b != nullptr) {
        LF_WITH_RADIX(By, LF_TILE_LAUNCH(fderiv_kernel, AXIS_Y, nplanes, b,
                                         a != nullptr ? nullptr : c, out, FYT, bfy, Ny, Nx,
                                         a != nullptr))
    }
    return (int)cudaGetLastError();
}

// One pass (axis 0: x, stores; 1: y, adds) of the forward (role 0) or
// adjoint (role 1) velocity of the (nbatch, ncomp, Ny, Nx) state y into k
// under the p(t) planes p, (2, nbatch, Ny, Nx), on fact_tile at tier TIER
// and radix Bv along the axis where k3_on_tile puts it (one channel group,
// one launch; every other form is refused: the cluster tile runs it,
// fa_sm90.cu). G: the axis' blocks as fact_tile takes them at the tier.
template <int TIER>
int fa_tile(int axis, int Bv, int role, const float* y, float* k, const float* p, const void* G,
            const float* bf, int nbatch, int ncomp, int Ny, int Nx, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int nz = nbatch * ncomp;
    if (axis == AXIS_X) {
        LF_WITH_TILE_RADIX(Bv, k3_on_tile,
                           LF_TILE_LAUNCH(fa_kernel, AXIS_X, nz, y, k, p, G, bf, ncomp, nbatch,
                                          Ny, Nx, role))
    } else {
        LF_WITH_TILE_RADIX(Bv, k3_on_tile,
                           LF_TILE_LAUNCH(fa_kernel, AXIS_Y, nz, y, k, p, G, bf, ncomp, nbatch,
                                          Ny, Nx, role))
    }
    return (int)cudaGetLastError();
}

// k <- the backward velocity at time t of the (nbatch, 2 ncomp + 5, Ny, Nx)
// state y; phi is (nbatch, 5, Ny, Nx), p its p(t) planes (2, nbatch, Ny,
// Nx). Two launches a channel group.
template <int TIER>
int bv_velocity(const float* y, float* k, const float* phi, const float* p, const void* FX,
                const void* FYT, const float* bfx, const float* bfy, int Bx, int By, int nbatch,
                int ncomp, int Ny, int Nx, float t, void* stream) {
    if (!shape_ok(Bx, By, Ny, Nx)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    LF_WITH_RADIX(Bx, LF_TILE_LAUNCH(bv_kernel, AXIS_X, nbatch, y, k, phi, p, FX, bfx, ncomp,
                                     nbatch, Ny, Nx, t))
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    LF_WITH_RADIX(By, LF_TILE_LAUNCH(bv_kernel, AXIS_Y, nbatch, y, k, phi, p, FYT, bfy, ncomp,
                                     nbatch, Ny, Nx, t))
    return (int)cudaGetLastError();
}

}  // namespace

// The reduced tiers' launchers on fact_tile of K3 (where k3_on_tile puts
// it: 'high' at radix 8; lf_bf16::fa_tile builds no kernel and refuses
// every call) and K4 and their shared-memory set-up, each instantiated in
// a source of its own: lf_high in factored_high.cu (fa_tile<TIER_HIGH>,
// ...), lf_bf16 in factored_bf16.cu. K1's reduced tiers, and K3 on the
// cluster tile, are lf_sm90::fderiv and lf_sm90::fa_pass (fderiv_sm90.cu,
// fa_sm90.cu).
#define LF_TIER_ENTRIES(ns)                                                                    \
    namespace ns {                                                                              \
    int fa_tile(int axis, int Bv, int role, const float* y, float* k, const float* p,          \
                const void* G, const float* bf, int nbatch, int ncomp, int Ny, int Nx,          \
                void* stream);                                                                  \
    int bv_velocity(const float* y, float* k, const float* phi, const float* p, const void* FX, \
                    const void* FYT, const float* bfx, const float* bfy, int Bx, int By,        \
                    int nbatch, int ncomp, int Ny, int Nx, float t, void* stream);              \
    int init();                                                                                 \
    }
LF_TIER_ENTRIES(lf_high)
LF_TIER_ENTRIES(lf_bf16)

// Their definitions, in the source that instantiates tier T as namespace ns.
#define LF_TIER_DEFINE(ns, T)                                                                  \
    namespace ns {                                                                              \
    int fa_tile(int axis, int Bv, int role, const float* y, float* k, const float* p,          \
                const void* G, const float* bf, int nbatch, int ncomp, int Ny, int Nx,          \
                void* stream) {                                                                 \
        return ::fa_tile<T>(axis, Bv, role, y, k, p, G, bf, nbatch, ncomp, Ny, Nx, stream);     \
    }                                                                                           \
    int bv_velocity(const float* y, float* k, const float* phi, const float* p, const void* FX, \
                    const void* FYT, const float* bfx, const float* bfy, int Bx, int By,        \
                    int nbatch, int ncomp, int Ny, int Nx, float t, void* stream) {             \
        return ::bv_velocity<T>(y, k, phi, p, FX, FYT, bfx, bfy, Bx, By, nbatch, ncomp, Ny, Nx, \
                                t, stream);                                                     \
    }                                                                                           \
    int init() { return allow_smem_all<T>(); }                                                  \
    }
