// K4 for NVIDIA Hopper (sm_90a) at every tier: one pass of the backward
// velocity on the cluster tile (fact_sm90.cuh), one launch a pass, the
// velocity's 2 ncomp derivatives in turn inside the launch, its clusters
// velocity_ctas: one CTA at radix 8, as K3's and K5's.
//
// Replaces `_bv_kernel` (cmblensing_tpu/ops/pallas_lenseflow.py:581,
// launched by `_bv_call` :604, driven by `_bv_flow` :630) with its
// derivatives strict, `_mk_dot('high')` (:225) and `_mk_dot('bf16')`
// (:218): lf_bv_velocity (factored.cu) runs each pass on the tile the
// host's table names (ops/lenseflow_kernels.py::FORMS;
// lenseflow_common.cuh::k4_on_tile): this kernel at radix 16 and 32 at
// every tier, and at 4 and 8 wherever an A/B in turns did not measure
// bv_kernel on fact_tile (factored_kernels.cuh) more than 2 % faster. Only
// the form FORMS names is built.
//
// The contract is bv_kernel's. The state of batch entry blockIdx.y is
// (2 ncomp + 5, Ny, Nx): f_c, delta f_c and five accumulators; p(t) comes
// as (2, nbatch, Ny, Nx) planes; phi's 5 planes give M^-1(t). The x pass
// stores p_x d_x f_c into k_f, d_x(p_x delta f_c) into k_df and w_x =
// sum_c delta f_c d_x f_c into the first accumulator slot; the y pass adds
// the y terms, sums w_y into the second slot and then writes u = M^-1 w and
// the five delta-phi integrands (dphi_values) into the five slots.
//
// One launch a pass: a cluster runs its tile's 2 ncomp derivatives in
// turn, d f_c then d(p delta f_c) for each component c (operand 2 c, 2 c +
// 1 of fact_sm90_ops, whose ring carries its phase from one to the next,
// each operand's blocks streamed once more). Each pixel pair is one
// thread's in every operand of the launch (fact_sm90.cuh's PairAt), and the
// passes run in stream order, so nothing needs an atomic:
//   k_f, k_df: the store folds the channel groups' partial sums in
//     fact_tile's order (Parts, fold), each product and sum rounded on its
//     own (mul2, add2), as K5 role 0 (uni_sm90.cu) stores its p . grad a
//     and div(p b); so they keep the bits of bv_kernel's ordered launches,
//     and the uni flows' delta f the bits of the kernel backend's.
//   w: the thread that owns a pixel pair adds delta f_c d f_c onto it
//     component by component, by a read, an add and a store of its own
//     pair in the accumulator slot (delta f_c times the folded sum of the
//     derivative); 32 pairs a thread, 64 floats, held in registers across
//     the products would spill (the strict radix-32 tile already holds 167
//     of the 168 registers 9 warps may have).
//   The epilogue: after the last operand's store the same threads read
//     back their w_x (the x pass's, earlier in stream order) and w_y (their
//     own stores), R rows' reads together, and write u and the integrands:
//     no fence, no read of another thread's sums, no launch of its own.
// bv_kernel summed w by channel-group launch, then component; this one by
// component, each the full derivative, so w, u and the delta-phi integrands
// may differ from the parent's in their last bits (PERF.md §2), the same
// bits from run to run.
//
// What bounds it: the tile's (fact_sm90.cuh's header), 4 ncomp derivatives
// a velocity against a pass's planes: the state's 2 ncomp in, p, 2 ncomp
// out, w read and written once a component, phi and the five integrands in
// the y pass. What holds it back: registers. The operand loop keeps more
// live across the products than a one-operand kernel does, and ptxas
// spills 228-692 bytes a thread at radix 32 (K5 role 0 on the same tile,
// its derivatives on the grid, 0-60): 4096^2 'high' takes 5.58 ms cold
// against K5 role 0's 3.83, 0.70x the ordered fact_tile launches it
// replaced (PERF.md §6; NVIDIA H100 80GB HBM3, 700 W).
//
// Why K4 is not K5 role 0 and an epilogue. Role 0 computes the same k_f
// and k_df, bit for bit, and delta f_c d f_c, faster; but it stores each
// component's two w terms as planes of its own (nb, ncomp, 4, Ny, Nx)
// output, so K4 built on it needs another launch that sums them in a fixed
// order, reads phi and writes u and the integrands, and k_f, k_df laid out
// as the backward state has them. This kernel is the form that writes u in
// the y pass's own store, with no launch and no scratch plane of its own;
// the other form, about 0.3 ms of epilogue bytes at 4096^2 beside role 0's
// 3.83 ms, is ROADMAP Queue 2's next step for K4 at every radix, and would
// take fact_sm90_ops (the several-operand loop) out of fact_sm90.cuh.
//
// Plain C++ entry (lf_sm90::bv_pass, called by lf_bv_velocity) and C
// entries for set-up (lf_bv_sm90_init) and the cluster-fit query.

#include "fact_sm90.cuh"

namespace {

constexpr int NACC = 5;   // delta-phi accumulator planes of the backward state
// rows whose reads go out together, in the store and the epilogue: 4 (the
// store's 8 at radix 8 and 16 spilled 120-676 bytes, and ran 2048^2 1.02-
// 1.09x the time of 4)
constexpr int RW = 4;

// what a store reads of a pixel pair before its sums arrive (fetch): p and
// delta f_c (d f_c), what the x pass stored (the y pass), w so far
struct Pre4 {
    float2 p, df, k, w;
};

template <int B, int AXIS, int TIER>
__global__ void __launch_bounds__(NT, 1)
bv_sm90_kernel(const float* __restrict__ y, float* __restrict__ k, const float* __restrict__ phi,
               const float* __restrict__ p, const void* __restrict__ W,
               const float* __restrict__ bf, int ncomp, int nbatch, int Ny, int Nx, float t) {
    constexpr int NC = velocity_ctas(B);
    constexpr bool first = AXIS == AXIS_X;   // the x pass stores, the y pass adds
    const size_t plane = (size_t)Ny * Nx;
    const size_t nstate = 2 * ncomp + NACC;
    const float* yb = y + blockIdx.y * nstate * plane;
    float* kb = k + blockIdx.y * nstate * plane;
    const float* pa = p + ((size_t)(AXIS == AXIS_X ? 0 : nbatch) + blockIdx.y) * plane;
    float* acc = kb + 2 * ncomp * plane;
    float* w = acc + AXIS * plane;   // w_x (x pass) or w_y (y pass)
    // operand op: the derivative of f_c (op = 2 c) or of p delta f_c (2 c + 1),
    // into plane c or ncomp + c of k
    const auto slot = [&](int op) { return (size_t)((op & 1) * ncomp + (op >> 1)) * plane; };
    fact_sm90_ops<B, NC, AXIS, TIER, RW>(
        W, bf, Nx, 2 * ncomp,
        [&](int op, size_t q) {
            const float x = __ldcg(yb + slot(op) + q);
            return op & 1 ? __ldcg(pa + q) * x : x;
        },
        [&](int op, size_t q) {
            const float2 zero = make_float2(0.f, 0.f);
            Pre4 got = {zero, zero, zero, zero};
            if (!(op & 1)) {
                got.p = ld2(pa + q);
                got.df = ld2(yb + slot(op + 1) + q);
                if (op > 0) got.w = ld2(w + q);
            }
            if (!first) got.k = ld2(kb + slot(op) + q);
            return got;
        },
        [&](int op, size_t q, const Parts<sm90_groups(B)>& part, const Pre4& got) {
            // bv_kernel's order: each channel group's sum (times p for k_f),
            // the x pass's first group stored, every later one added
            const auto id = [](float2 g) { return g; };
            float* kp = kb + slot(op) + q;
            if (op & 1) {
                st2(kp, first ? fold(part.g[0], part, 1, id) : fold(got.k, part, 0, id));
                return;
            }
            const float2 pv = got.p;
            const auto byp = [&](float2 g) { return mul2(g, pv); };
            st2(kp, first ? fold(byp(part.g[0]), part, 1, byp) : fold(got.k, part, 0, byp));
            const float2 dw = mul2(got.df, fold(part.g[0], part, 1, id));
            st2(w + q, op == 0 ? dw : add2(got.w, dw));
        });
    if constexpr (!first) {
        const float* ph = phi + (size_t)blockIdx.y * 5 * plane;
        sm90_own_pairs<B, NC, AXIS, RW>(Nx, [&](const size_t (&at)[RW]) {
            float2 wx[RW], wy[RW], v[RW][5];
#pragma unroll
            for (int i = 0; i < RW; ++i) {
                wx[i] = ld2(acc + at[i]);
                wy[i] = ld2(acc + plane + at[i]);
#pragma unroll
                for (int e = 0; e < 5; ++e) v[i][e] = ld2(ph + e * plane + at[i]);
            }
#pragma unroll
            for (int i = 0; i < RW; ++i) {
                const float hx[5] = {v[i][0].x, v[i][1].x, v[i][2].x, v[i][3].x, v[i][4].x};
                const float hy[5] = {v[i][0].y, v[i][1].y, v[i][2].y, v[i][3].y, v[i][4].y};
                float ox[5], oy[5];
                dphi_values(hx, t, wx[i].x, wy[i].x, ox);
                dphi_values(hy, t, wx[i].y, wy[i].y, oy);
#pragma unroll
                for (int e = 0; e < 5; ++e) st2(acc + e * plane + at[i], make_float2(ox[e], oy[e]));
            }
        });
    }
}

// Where K4 is built on this tile: every built tier and radix that does not
// run fact_tile (lenseflow_common.cuh::k4_on_tile).
struct K4Built {
    static constexpr bool on(int B, int tier) { return !k4_on_tile(B, tier); }
};

template <int AXIS>
int pass(int tier, int Bv, const float* y, float* k, const float* phi, const float* p,
         const void* W, const float* bf, int nbatch, int ncomp, int Ny, int Nx, float t,
         cudaStream_t st) {
    return sm90_dispatch<K4Built>(tier, Bv, [&](auto b, auto tv) {
        constexpr int B = decltype(b)::value, TIER = decltype(tv)::value;
        return sm90_launch<B, velocity_ctas(B), TIER>(bv_sm90_kernel<B, AXIS, TIER>,
                                                      sm90_tiles<AXIS>(Ny, Nx), nbatch, st, y, k,
                                                      phi, p, W, bf, ncomp, nbatch, Ny, Nx, t);
    });
}

}  // namespace

namespace lf_sm90 {
// One pass (axis 0: x, stores; 1: y, adds and writes the integrands) of the
// backward velocity at time t of the (nbatch, 2 ncomp + 5, Ny, Nx) state y
// into k, phi (nbatch, 5, Ny, Nx), p its p(t) planes (2, nbatch, Ny, Nx),
// at `tier`, radix Bv along the axis: one launch. W: the axis' blocks
// (strict: FP32 (B, A, A) as fact_tile takes them; 'high' and 'bf16': the
// swizzled split (2, B, A, A) bf16). The y pass runs after the x pass in
// stream order.
int bv_pass(int tier, int axis, int Bv, const float* y, float* k, const float* phi, const float* p,
            const void* W, const float* bf, int nbatch, int ncomp, int Ny, int Nx, float t,
            void* stream) {
    if ((axis == AXIS_X ? Nx : Ny) != Bv * FA || nbatch < 1 || nbatch > 65535 || ncomp < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    return axis == AXIS_X ? pass<AXIS_X>(tier, Bv, y, k, phi, p, W, bf, nbatch, ncomp, Ny, Nx, t, st)
                          : pass<AXIS_Y>(tier, Bv, y, k, phi, p, W, bf, nbatch, ncomp, Ny, Nx, t, st);
}
}  // namespace lf_sm90

LF_SM90_SETUP(bv_sm90_kernel, velocity_ctas, K4Built, lf_bv_sm90_init, lf_bv_sm90_clusters)
