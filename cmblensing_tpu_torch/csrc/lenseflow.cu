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
// the combine are the 'high' form's; its stages hold half the bytes.
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
    if (rc == 0) rc = allow(deriv_kernel<TIER, EDGE>, dense_smem_bytes(1, TIER));
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
    deriv_kernel<TIER, EDGE><<<dim3(tiles(Nx), tiles(Ny), nplanes), DNT, dense_smem_bytes(1, TIER),
                              st>>>(a, b, c, out, DxT, Dy, Ny, Nx);
    return (int)cudaGetLastError();
}

}  // namespace

// Let the dense kernels take their stages as dynamic shared memory (the
// 'high' backward kind's 68 KB is above the 48 KB a kernel gets unasked).
// Once, before the first launch.
extern "C" int lf_dense_init() {
    int rc = allow_dense<TIER_F32, false>();
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
    const auto fn = dense_fn(tier, has_edge(Ny, Nx), deriv<TIER_F32, false>,
                             deriv<TIER_F32, true>, deriv<TIER_HIGH, false>,
                             deriv<TIER_HIGH, true>, deriv<TIER_BF16, false>,
                             deriv<TIER_BF16, true>);
    if (!dense_shape_ok(Ny, Nx, nplanes) || fn == nullptr) return (int)cudaErrorInvalidValue;
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
