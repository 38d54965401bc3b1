// The factored LenseFlow kernels on fact_tile, at radix 4 and 8 where the
// host's table puts them (lenseflow_common.cuh::k3_on_tile, k4_on_tile;
// ops/lenseflow_kernels.py::FORMS): K3, K4; and their host launchers,
// shared by the three sources that instantiate them, one precision tier
// each: factored.cu (FP32, and the C entries), factored_high.cu ('high')
// and factored_bf16.cu ('bf16'), compiled in parallel. Every other form
// runs the cluster tile (fact_sm90.cuh: fa_sm90.cu, bv_sm90.cu), as K1
// does at every tier and radix (fderiv_sm90.cu), and only the form the
// table names is built.
// See factored.cu for what each kernel replaces and computes.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "fact_tile.cuh"
#include "lenseflow_common.cuh"

namespace {

constexpr int NACC = 5;   // delta-phi accumulator planes of the backward state

// Radix 4 and 8 are one channel group (fact_tile.cuh): each output pixel
// of a launch is one thread's. Where a pass adds onto what an earlier pass
// or component stored, that thread does so with an atomicAdd whose result
// is unused (a RED at the L2), without a load's latency between the tile's
// stores; the passes run in stream order, so the sum and its rounding are
// those of a load, add and store, the same in every run.

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
          int Ny, int Nx, int role) {
    extern __shared__ __align__(16) float smem[];   // tile_smem_bytes(B, TIER)
    load_butterflies<B, TIER>(bf, smem, 0);
    const size_t plane = (size_t)Ny * Nx;
    const float* yp = y + blockIdx.z * plane;
    float* kp = k + blockIdx.z * plane;
    // p along this axis
    const float* pa = p + ((size_t)(AXIS == AXIS_X ? 0 : nbatch) + blockIdx.z / ncomp) * plane;
    int m0, o0;
    tile_origin<AXIS>(m0, o0);
    fact_tile<B, AXIS, TIER>(
        G, smem, m0, o0, 0, Nx, [&](int q) { return role != 0 ? pa[q] * yp[q] : yp[q]; },
        [&](int q, float v) {
            if (role == 0) v *= pa[q];
            if (AXIS == AXIS_X) kp[q] = v;
            else atomicAdd(kp + q, v);
        });
}

// K4 where it runs this tile (k4_on_tile; on the cluster tile: bv_sm90.cu):
// one pass of the backward velocity over the state (f_0.., delta f_0.., 5
// accumulators) of batch blockIdx.z. The x pass stores p_x d_x f_c,
// d_x(p_x delta f_c) and w_x (held in the first accumulator slot); the y
// pass adds the y terms, accumulates w_y in the second slot and then
// writes u = M^-1 w and the five integrands. p as K3's; M^-1(t) is rebuilt
// from phi's 5 planes per batch at the output pixels.
template <int B, int AXIS, int TIER>
__global__ void __launch_bounds__(tile_threads(B), tile_min_blocks(B))
bv_kernel(const float* __restrict__ y, float* __restrict__ k, const float* __restrict__ phi,
          const float* __restrict__ p, const void* __restrict__ G,
          const float* __restrict__ bf, int ncomp, int nbatch, int Ny, int Nx, float t) {
    extern __shared__ __align__(16) float smem[];   // tile_smem_bytes(B, TIER)
    load_butterflies<B, TIER>(bf, smem, 0);
    const size_t plane = (size_t)Ny * Nx;
    const size_t nstate = 2 * ncomp + NACC;
    const float* yb = y + blockIdx.z * nstate * plane;
    float* kb = k + blockIdx.z * nstate * plane;
    const float* pa = p + ((size_t)(AXIS == AXIS_X ? 0 : nbatch) + blockIdx.z) * plane;
    float* w = kb + (2 * ncomp + AXIS) * plane;   // w_x (x pass) or w_y (y pass)
    int m0, o0;
    tile_origin<AXIS>(m0, o0);
    constexpr bool store = AXIS == AXIS_X;   // else add
    for (int c = 0; c < ncomp; ++c) {
        const float* f = yb + c * plane;
        const float* df = yb + (ncomp + c) * plane;
        float* kf = kb + c * plane;
        float* kdf = kb + (ncomp + c) * plane;
        fact_tile<B, AXIS, TIER>(
            G, smem, m0, o0, 0, Nx, [&](int q) { return f[q]; },
            [&](int q, float v) {   // v = d f_c
                const float pv = pa[q] * v, dw = df[q] * v;
                if (store) kf[q] = pv;
                else atomicAdd(kf + q, pv);
                if (c == 0) w[q] = dw;
                else atomicAdd(w + q, dw);
            });
        fact_tile<B, AXIS, TIER>(
            G, smem, m0, o0, 0, Nx, [&](int q) { return pa[q] * df[q]; },
            [&](int q, float v) {
                if (store) kdf[q] = v;
                else atomicAdd(kdf + q, v);
            });
    }
    if (AXIS == AXIS_Y) {
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
    if constexpr (k3_on_tile(B, TIER)) {   // else fa_sm90.cu
        if (rc == 0) rc = allow_tile_smem(fa_kernel<B, AXIS_X, TIER>, B, TIER);
        if (rc == 0) rc = allow_tile_smem(fa_kernel<B, AXIS_Y, TIER>, B, TIER);
    }
    if constexpr (k4_on_tile(B, TIER)) {   // else bv_sm90.cu
        if (rc == 0) rc = allow_tile_smem(bv_kernel<B, AXIS_X, TIER>, B, TIER);
        if (rc == 0) rc = allow_tile_smem(bv_kernel<B, AXIS_Y, TIER>, B, TIER);
    }
    return rc;
}

// the kernels of the radices one channel group holds (4 and 8) at one
// tier: those the table puts on this tile
template <int TIER>
int allow_smem_all() {
    const int rc = allow_smem<4, TIER>();
    return rc != 0 ? rc : allow_smem<8, TIER>();
}

// One pass (axis 0: x, stores; 1: y, adds) of the forward (role 0) or
// adjoint (role 1) velocity of the (nbatch, ncomp, Ny, Nx) state y into k
// under the p(t) planes p, (2, nbatch, Ny, Nx), on fact_tile at tier TIER
// and radix Bv along the axis where k3_on_tile puts it (every other form
// is refused: the cluster tile runs it, fa_sm90.cu). G: the axis' blocks
// as fact_tile takes them at the tier.
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

// One pass (axis 0: x, stores; 1: y, adds and writes the integrands) of the
// backward velocity at time t of the (nbatch, 2 ncomp + 5, Ny, Nx) state y
// into k; phi is (nbatch, 5, Ny, Nx), p its p(t) planes (2, nbatch, Ny,
// Nx); on fact_tile where k4_on_tile puts it (every other form is refused:
// bv_sm90.cu runs it).
template <int TIER>
int bv_tile(int axis, int Bv, const float* y, float* k, const float* phi, const float* p,
            const void* G, const float* bf, int nbatch, int ncomp, int Ny, int Nx, float t,
            void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (axis == AXIS_X) {
        LF_WITH_TILE_RADIX(Bv, k4_on_tile,
                           LF_TILE_LAUNCH(bv_kernel, AXIS_X, nbatch, y, k, phi, p, G, bf, ncomp,
                                          nbatch, Ny, Nx, t))
    } else {
        LF_WITH_TILE_RADIX(Bv, k4_on_tile,
                           LF_TILE_LAUNCH(bv_kernel, AXIS_Y, nbatch, y, k, phi, p, G, bf, ncomp,
                                          nbatch, Ny, Nx, t))
    }
    return (int)cudaGetLastError();
}

}  // namespace

// The reduced tiers' launchers on fact_tile of K3 and K4 (where k3_on_tile
// and k4_on_tile put them; where neither does, lf_high / lf_bf16 build no
// kernel and refuse every call) and their shared-memory set-up, each
// instantiated in a source of its own: lf_high in factored_high.cu
// (fa_tile<TIER_HIGH>, ...), lf_bf16 in factored_bf16.cu.
#define LF_TIER_ENTRIES(ns)                                                                    \
    namespace ns {                                                                              \
    int fa_tile(int axis, int Bv, int role, const float* y, float* k, const float* p,          \
                const void* G, const float* bf, int nbatch, int ncomp, int Ny, int Nx,          \
                void* stream);                                                                  \
    int bv_tile(int axis, int Bv, const float* y, float* k, const float* phi, const float* p,  \
                const void* G, const float* bf, int nbatch, int ncomp, int Ny, int Nx, float t, \
                void* stream);                                                                  \
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
    int bv_tile(int axis, int Bv, const float* y, float* k, const float* phi, const float* p,  \
                const void* G, const float* bf, int nbatch, int ncomp, int Ny, int Nx, float t, \
                void* stream) {                                                                 \
        return ::bv_tile<T>(axis, Bv, y, k, phi, p, G, bf, nbatch, ncomp, Ny, Nx, t, stream);   \
    }                                                                                           \
    int init() { return allow_smem_all<T>(); }                                                  \
    }
