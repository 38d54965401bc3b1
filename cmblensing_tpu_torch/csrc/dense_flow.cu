// K2, the whole dense LenseFlow flow in one launch, for NVIDIA Hopper
// (sm_90a): FP32 FMA, and the 'high' and 'bf16' tiers on the tensor cores.
//
// Replaces the whole-flow Pallas kernel `_flow_kernel` and its launcher
// `_flow_call` (cmblensing_tpu/ops/pallas_lenseflow.py:472, :703), which
// integrate a whole RK4 flow in one pallas_call: `_rk4_steps` (:371) over
// `_vel_forward`, `_vel_adjoint` and `_vel_backward` (:321-370), with p(t)
// from `_p_of_t` (:303) and the dense in-kernel derivatives of
// `_make_ddx_ddy` (:86). The TPU kernel keeps the flow's state in VMEM. A
// 256^2 f32 plane is 256 KiB, more than a block's 227 KB of shared memory,
// so here the state lives in device memory, where the 50 MB L2 holds it
// (a 768^2 P forward flow, every buffer below and the circulants, is 19
// planes, 45 MB), and one cooperative launch walks the flow's 4 nsteps RK4
// stages with a grid-wide barrier (cooperative_groups' grid.sync(), which
// orders memory) between two stages, and one after the first p(t):
//
//   before stage 0  p(t) of the first stage's time into its p buffer
//   each stage      for every work item of the grid-stride walk, the
//                   velocity at the stage's input and time, k, folded at
//                   the item's own pixels into the RK4 state in the order
//                   of `_rk4_steps` (lenseflow.cu's rk4_kernel, each update
//                   one fused multiply-add): stage 0 acc = y + h/6 k,
//                   s = y + h/2 k; stages 1, 2 acc += h/3 k, s = y + w k;
//                   stage 3 y = acc + h/6 k. k is never written to memory.
//                   After its items, where the stage is the last at its
//                   time (stages 0 and 2 of a step), each block forms p at
//                   the flow's next distinct time for its share of the
//                   (tile, batch entry) items, with p_kernel's arithmetic
//                   (lenseflow_common.cuh::p_of_t), in the other p buffer.
//
// Every tile's products read the stage input at every pixel of its rows or
// columns, while stages 1 and 2 write s: so s has two buffers, a stage
// reads one and writes the other; so has p, which the adjoint and backward
// kinds multiply into the operand at every loaded pixel. Which buffer each
// stage reads and writes, its time and its two weights are the rows of
// the host's stage table (ops/lenseflow_kernels.py::flow_schedule; no
// stage writes a buffer it reads), read from device memory.
//
// Work items, each one 32 x 32 output tile (dense_tile.cuh::dense_xy_at,
// the product the per-stage kernel ran, unchanged, at every tier and any
// plane shape): forward and adjoint (tile, component, batch entry);
// backward (tile, batch entry), whose block walks the components, because
// w = sum_c delta f_c grad f_c sums over them. Item i is tile i % ntile
// (row-major), then component, then entry (tests/test_torch_whole_flow.py
// states the same numbering in Python); block g takes items g, g + grid,
// .... The grid is the card's SMs times the blocks an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, at lf_flow_init), at most
// the items of a stage; the launch is cooperative, so every block is
// resident, and a launch the card refuses returns its error.
//
// Backward kind, delta-phi form. The kernel follows the HOISTED form of
// models/lenseflow.py::_backward_flow_scan_body rather than the per-stage
// form of `_vel_backward`: the state carries, besides (f, delta f), the
// five accumulator planes (u_x, u_y, t p_x u_x, t (p_y u_x + p_x u_y),
// t p_y u_y), whose velocity is their integrand (u = M^-1 w and
// lenseflow_common.cuh::dphi_values at the item's pixels), folded into the
// state with the 2 ncomp others; delta-phi is applied once after the
// flow, d_x(u_x + d_x s_xx + d_y s_xy) + d_y(u_y + d_y s_yy), in three
// lf_deriv launches. The per-stage form needs derivatives of u, which is
// built from derivatives of f: every stage would need a second grid-wide
// pass. Both forms agree up to f32 summation order (the JAX package's
// tests/test_deriv.py::test_backward_dphi_hoisting_exact_f64).
//
// No atomics: every value is formed by one thread in the order the
// per-stage form (a velocity launch, then rk4_kernel and p_kernel) formed
// it, so the flow gives that form's bits.
//
// What bounds a flow on this card: the products. A forward or adjoint
// stage is 2 ncomp dense derivatives (2 N^3 operations each), a backward
// stage 4 ncomp; strict FP32 FMA at 67 TFLOP/s, so a strict forward flow
// at 256^2 P is 28 stages x 0.0020 ms = 0.056 ms; 'high' three bf16
// products a derivative and 'bf16' one, at 989 TFLOP/s on the tensor
// cores (0.0114 and 0.0038 ms). Counted once a flow, the bytes (the
// state in and out, phi's five planes, the circulants) are 2.9 MB at
// 256^2 P, 0.0009 ms at 3.35 TB/s. The per-stage form took 4 nsteps
// velocity launches, 4 nsteps RK4 launches and 2 nsteps + 1 p launches a
// flow (71 at nsteps 7), each a host call through ctypes, on a path the
// host's launches paced (17-29 % busy), and every stage's k, s and p went
// through device memory between launches. Here a flow is one host call;
// the state stays in the L2 between stages, the update and p(t) run in
// the velocity's epilogue, and a batch of flows (the line search's
// trials) is one launch. What a stage costs on the card is still the
// product's (dense_tile.cuh: at 256^2 a plane is 64 tiles, so a stage's
// occupancy and the shared-memory load rate inside a block set the pace)
// plus a grid barrier.
//
// Plain C interface, loaded with ctypes. Every launch goes on the caller's
// stream and the entry returns the launch's error or cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "dense_tile.cuh"

namespace cg = cooperative_groups;

namespace {

enum Kind { FORWARD = 0, ADJOINT = 1, BACKWARD = 2 };
constexpr int NACC = 5;   // the backward flow's delta-phi accumulator planes

// The columns of a row of the stage table (lenseflow_kernels.py::
// flow_table): the velocity's time, the RK4 weights of the accumulator
// and of s, the time of the p(t) the stage forms, the RK4 stage (0-3), the
// state buffer it reads (0 y, 1 s0, 2 s1) and writes (y at stage 3), the
// p buffer it reads and the one it forms p into (-1: none)
enum { FS_T, FS_WACC, FS_WS, FS_TP, FS_RK, FS_SRC, FS_DST, FS_PSRC, FS_PDST, FS_COLS };

struct FlowArgs {
    float* st[3];          // y, s0, s1: (nb, nstate, Ny, Nx) each
    float* acc;            // (nb, nstate, Ny, Nx)
    float* p;              // two buffers of (nb, 2, Ny, Nx)
    const float* phi;      // (nb, 5, Ny, Nx)
    const void* DxT;
    const void* Dy;
    const float* table;    // (nstages, FS_COLS)
    int nstages, nb, ncomp, Ny, Nx;
};

__device__ __forceinline__ float4 fma4(float w, float4 k, float4 a) {
    return make_float4(__fmaf_rn(w, k.x, a.x), __fmaf_rn(w, k.y, a.y), __fmaf_rn(w, k.z, a.z),
                       __fmaf_rn(w, k.w, a.w));
}

// RK4 stage rk of the velocity k at four pixels of one plane, in
// rk4_kernel's order (lenseflow.cu)
template <bool EDGE>
__device__ __forceinline__ void rk4_fold(int rk, float wacc, float ws, float4 k, float* y,
                                         float* acc, float* s, int row, int col, int Ny, int Nx) {
    if (rk == 3) {
        stq<EDGE>(y, row, col, Ny, Nx, fma4(wacc, k, ldq<EDGE>(acc, row, col, Ny, Nx)));
        return;
    }
    const float4 yv = ldq<EDGE>(y, row, col, Ny, Nx);
    stq<EDGE>(acc, row, col, Ny, Nx, fma4(wacc, k, rk == 0 ? yv : ldq<EDGE>(acc, row, col, Ny, Nx)));
    stq<EDGE>(s, row, col, Ny, Nx, fma4(ws, k, yv));
}

// (p_x, p_y)(t) at this thread's four pixels of the tile at (i0, j0), from
// one entry's phi planes into its two p planes
template <bool EDGE>
__device__ __forceinline__ void form_p(const float* __restrict__ phi, float* p, size_t plane,
                                       int Ny, int Nx, int i0, int j0, float t) {
    const int row = i0 + threadIdx.x / 8, col = j0 + (threadIdx.x % 8) * 4;
    if (row >= Ny) return;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        if (EDGE && col + e >= Nx) break;
        const size_t idx = (size_t)row * Nx + col + e;
        float px, py;
        p_of_t(phi, plane, idx, t, px, py);
        p[idx] = px;
        p[plane + idx] = py;
    }
}

// One whole flow of kind KIND over the stage table. The state buffers are
// read and written through plain pointers (no __restrict__, no read-only
// path): a block reads what other blocks wrote before the last barrier.
template <int KIND, int TIER, bool EDGE>
__global__ void __launch_bounds__(DNT) flow_kernel(const FlowArgs a) {
    constexpr int NOP = KIND == BACKWARD ? 2 : 1;
    extern __shared__ float4 dense_smem[];
    float* sm = reinterpret_cast<float*>(dense_smem);
    cg::grid_group grid = cg::this_grid();
    const int Ny = a.Ny, Nx = a.Nx, ncomp = a.ncomp, tid = threadIdx.x;
    const size_t plane = (size_t)Ny * Nx;
    const size_t entry = (size_t)(KIND == BACKWARD ? 2 * ncomp + NACC : ncomp) * plane;
    const int ntx = (Nx + DT - 1) / DT, ntile = ntx * ((Ny + DT - 1) / DT);
    const int nper = KIND == BACKWARD ? 1 : ncomp;
    const int nitem = ntile * nper * a.nb, npitem = ntile * a.nb;
    // p(t) into p buffer `buf` at every (tile, entry) item of this block
    auto p_pass = [&](int buf, float t) {
        float* pbuf = a.p + (size_t)buf * a.nb * 2 * plane;
        for (int it = blockIdx.x; it < npitem; it += gridDim.x) {
            const int tile = it % ntile, b = it / ntile;
            form_p<EDGE>(a.phi + (size_t)b * 5 * plane, pbuf + (size_t)b * 2 * plane, plane, Ny,
                         Nx, (tile / ntx) * DT, (tile % ntx) * DT, t);
        }
    };
    p_pass((int)a.table[FS_PSRC], a.table[FS_T]);
    grid.sync();
    for (int s = 0; s < a.nstages; ++s) {
        const float* row_ = a.table + (size_t)s * FS_COLS;
        const float t = row_[FS_T], wacc = row_[FS_WACC], ws = row_[FS_WS];
        const int rk = (int)row_[FS_RK];
        const int src = (int)row_[FS_SRC], dst = (int)row_[FS_DST];
        // (selected, not indexed: a parameter array indexed at run time goes to local memory)
        const float* yin = src == 0 ? a.st[0] : src == 1 ? a.st[1] : a.st[2];
        float* sout = dst == 0 ? a.st[0] : dst == 1 ? a.st[1] : a.st[2];
        const float* pin = a.p + (size_t)(int)row_[FS_PSRC] * a.nb * 2 * plane;
        for (int it = blockIdx.x; it < nitem; it += gridDim.x) {
            const int tile = it % ntile, rest = it / ntile, b = rest / nper;
            const int i0 = (tile / ntx) * DT, j0 = (tile % ntx) * DT;
            // this thread's four output pixels
            const int row = i0 + tid / 8, col = j0 + (tid % 8) * 4;
            const size_t eo = (size_t)b * entry;
            const float* yb = yin + eo;
            float* y = a.st[0] + eo;
            float* acc = a.acc + eo;
            float* so = sout + eo;
            const float* pb = pin + (size_t)b * 2 * plane;
            const float4 px = ldq<EDGE>(pb, row, col, Ny, Nx);
            const float4 py = ldq<EDGE>(pb + plane, row, col, Ny, Nx);
            if constexpr (KIND != BACKWARD) {
                const int c = rest % nper;
                const float* av = yb + (size_t)c * plane;
                float4 X[NOP], Y[NOP];
                dense_xy_at<NOP, TIER, EDGE>(
                    a.DxT, a.Dy, Ny, Nx, i0, j0, sm, true, true,
                    [&](int axis, int, int r, int cc) {
                        // f_c as it is (forward); p f_c (adjoint)
                        if (KIND == FORWARD) return ldq<EDGE>(av, r, cc, Ny, Nx);
                        return mul4(ldq<EDGE>(pb + axis * plane, r, cc, Ny, Nx),
                                    ldq<EDGE>(av, r, cc, Ny, Nx));
                    },
                    X, Y);
                const float4 k = KIND == ADJOINT ? add4(X[0], Y[0])
                                                 : add4(mul4(px, X[0]), mul4(py, Y[0]));
                const size_t co = (size_t)c * plane;
                rk4_fold<EDGE>(rk, wacc, ws, k, y + co, acc + co, so + co, row, col, Ny, Nx);
            } else {
                float4 wx = make_float4(0.f, 0.f, 0.f, 0.f), wy = wx;
                for (int c = 0; c < ncomp; ++c) {
                    const float* av = yb + (size_t)c * plane;
                    const float* bv = yb + (size_t)(ncomp + c) * plane;   // delta f_c
                    float4 X[NOP], Y[NOP];
                    dense_xy_at<NOP, TIER, EDGE>(
                        a.DxT, a.Dy, Ny, Nx, i0, j0, sm, true, true,
                        [&](int axis, int op, int r, int cc) {
                            // f_c as it is; p delta f_c
                            if (op == 0) return ldq<EDGE>(av, r, cc, Ny, Nx);
                            return mul4(ldq<EDGE>(pb + axis * plane, r, cc, Ny, Nx),
                                        ldq<EDGE>(bv, r, cc, Ny, Nx));
                        },
                        X, Y);
                    const size_t fo = (size_t)c * plane, dfo = (size_t)(ncomp + c) * plane;
                    rk4_fold<EDGE>(rk, wacc, ws, add4(mul4(px, X[0]), mul4(py, Y[0])), y + fo,
                                   acc + fo, so + fo, row, col, Ny, Nx);   // df/dt
                    rk4_fold<EDGE>(rk, wacc, ws, add4(X[1], Y[1]), y + dfo, acc + dfo, so + dfo,
                                   row, col, Ny, Nx);                      // d(delta f)/dt
                    const float4 dfc = ldq<EDGE>(bv, row, col, Ny, Nx);
                    wx = add4(wx, mul4(dfc, X[0]));   // w = sum_c delta f_c grad f_c
                    wy = add4(wy, mul4(dfc, Y[0]));
                }
                // u = M^-1 w and the delta-phi integrands, the state's last NACC planes
                float v[NACC][4] = {};
                if (row < Ny) {
                    const float* ph = a.phi + (size_t)b * 5 * plane;
                    const float wxs[4] = {wx.x, wx.y, wx.z, wx.w}, wys[4] = {wy.x, wy.y, wy.z, wy.w};
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        if (EDGE && col + e >= Nx) continue;
                        const size_t o = (size_t)row * Nx + col + e;
                        const float phv[5] = {ph[o], ph[plane + o], ph[2 * plane + o],
                                              ph[3 * plane + o], ph[4 * plane + o]};
                        float out[NACC];
                        dphi_values(phv, t, wxs[e], wys[e], out);
#pragma unroll
                        for (int i = 0; i < NACC; ++i) v[i][e] = out[i];
                    }
                }
#pragma unroll
                for (int i = 0; i < NACC; ++i) {
                    const size_t o = (size_t)(2 * ncomp + i) * plane;
                    rk4_fold<EDGE>(rk, wacc, ws, make_float4(v[i][0], v[i][1], v[i][2], v[i][3]),
                                   y + o, acc + o, so + o, row, col, Ny, Nx);
                }
            }
        }
        const int pdst = (int)row_[FS_PDST];
        if (pdst >= 0) p_pass(pdst, row_[FS_TP]);
        if (s + 1 < a.nstages) grid.sync();
    }
}

int g_sms = 0;               // the card's SMs (lf_flow_init)
int g_per_sm[3][3][2] = {};  // blocks an SM holds at once, by kind, tier and EDGE

template <int KIND, int TIER>
constexpr size_t flow_smem() {
    return dense_smem_bytes(KIND == BACKWARD ? 2 : 1, TIER);
}

template <int KIND, int TIER, bool EDGE>
int flow_init_one() {
    int rc = allow(flow_kernel<KIND, TIER, EDGE>, flow_smem<KIND, TIER>());
    if (rc == 0)
        rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &g_per_sm[KIND][TIER][EDGE], flow_kernel<KIND, TIER, EDGE>, DNT,
            flow_smem<KIND, TIER>());
    return rc;
}

template <int KIND>
int flow_init_kind() {
    int rc = flow_init_one<KIND, TIER_F32, false>();
    if (rc == 0) rc = flow_init_one<KIND, TIER_F32, true>();
    if (rc == 0) rc = flow_init_one<KIND, TIER_HIGH, false>();
    if (rc == 0) rc = flow_init_one<KIND, TIER_HIGH, true>();
    if (rc == 0) rc = flow_init_one<KIND, TIER_BF16, false>();
    if (rc == 0) rc = flow_init_one<KIND, TIER_BF16, true>();
    return rc;
}

template <int KIND, int TIER, bool EDGE>
int flow_launch(const FlowArgs& a, int grid, cudaStream_t st) {
    FlowArgs args = a;
    void* params[] = {&args};
    const int rc = (int)cudaLaunchCooperativeKernel((const void*)flow_kernel<KIND, TIER, EDGE>,
                                                    dim3(grid), dim3(DNT), params,
                                                    flow_smem<KIND, TIER>(), st);
    if (rc != 0) {
        cudaGetLastError();   // clear it: the error is returned
        return rc;
    }
    return (int)cudaGetLastError();
}

using LaunchFn = int (*)(const FlowArgs&, int, cudaStream_t);

template <int KIND>
LaunchFn flow_fn(int tier, bool edge) {
    return dense_fn<LaunchFn>(tier, edge, flow_launch<KIND, TIER_F32, false>,
                              flow_launch<KIND, TIER_F32, true>, flow_launch<KIND, TIER_HIGH, false>,
                              flow_launch<KIND, TIER_HIGH, true>, flow_launch<KIND, TIER_BF16, false>,
                              flow_launch<KIND, TIER_BF16, true>);
}

// The blocks of a launch: every block the card holds at once, at most the
// items of a stage (its velocity items, or its p items where more); 0 where
// the card holds none or the arguments are out of range
long flow_blocks(int tier, int kind, int nb, int ncomp, int Ny, int Nx) {
    if (tier < 0 || tier > 2 || kind < 0 || kind > 2 || nb <= 0 || ncomp <= 0 || Ny <= 0 ||
        Nx <= 0)
        return 0;
    const long ntile = (long)tiles(Ny) * tiles(Nx);
    const long items = ntile * nb * (kind == BACKWARD ? 1 : ncomp);
    const long cap = (long)g_per_sm[kind][tier][has_edge(Ny, Nx)] * g_sms;
    return items < cap ? items : cap;
}

}  // namespace

// Allow the flow kernels their dynamic shared memory and record how many
// blocks of each an SM holds at once. Once, before the first launch.
extern "C" int lf_flow_init() {
    int dev = 0;
    int rc = (int)cudaGetDevice(&dev);
    if (rc == 0) rc = (int)cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == 0) rc = flow_init_kind<FORWARD>();
    if (rc == 0) rc = flow_init_kind<ADJOINT>();
    return rc != 0 ? rc : flow_init_kind<BACKWARD>();
}

// The blocks one flow launch of these arguments takes (0: none fit).
extern "C" int lf_flow_blocks(int tier, int kind, int nb, int ncomp, int Ny, int Nx) {
    return (int)flow_blocks(tier, kind, nb, ncomp, Ny, Nx);
}

// y <- the flow of `kind` (0 forward, 1 adjoint, 2 backward) of the nb
// entries of the (nb, nstate, Ny, Nx) state y, over the nstages rows of
// the stage table (device memory, (nstages, 9) floats), in one cooperative
// launch; acc, s0, s1 are scratch of y's shape, p scratch of (2, nb, 2, Ny,
// Nx), phi (nb, 5, Ny, Nx). `tier` picks FP32 (0), 'high' (1; DxT and Dy
// then their (2, n, n) bf16 split) or 'bf16' (2; their (n, n) bf16 heads).
extern "C" int lf_flow(int tier, int kind, float* y, float* acc, float* s0, float* s1, float* p,
                       const float* phi, const void* DxT, const void* Dy, const float* table,
                       int nstages, int nb, int ncomp, int Ny, int Nx, void* stream) {
    const long blocks = flow_blocks(tier, kind, nb, ncomp, Ny, Nx);
    const long ntile = (long)tiles(Ny) * tiles(Nx);
    if (tier < 0 || tier > 2 || kind < 0 || kind > 2 || nstages <= 0 || nb <= 0 || ncomp <= 0 ||
        Ny <= 0 || Nx <= 0 || ntile * nb * ncomp > 0x7fffffffL)
        return (int)cudaErrorInvalidValue;
    if (blocks <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
    const FlowArgs a{{y, s0, s1}, acc, p, phi, DxT, Dy, table, nstages, nb, ncomp, Ny, Nx};
    const bool edge = has_edge(Ny, Nx);
    const LaunchFn fn = kind == FORWARD   ? flow_fn<FORWARD>(tier, edge)
                        : kind == ADJOINT ? flow_fn<ADJOINT>(tier, edge)
                                          : flow_fn<BACKWARD>(tier, edge);
    return fn(a, (int)blocks, (cudaStream_t)stream);
}
