// K3 for NVIDIA Hopper (sm_90a) at every tier: one pass of the forward
// (p . grad y) or adjoint (div(p y)) velocity on the cluster tile
// fact_sm90 (fact_sm90.cuh), one launch a pass at every radix, its
// clusters velocity_ctas: one CTA at radix 8, as K5's.
//
// Replaces `_fa_kernel` (cmblensing_tpu/ops/pallas_lenseflow.py:506,
// launched by `_fa_call` :534) with its derivatives strict, `_mk_dot('high')`
// (:225) and `_mk_dot('bf16')` (:218): lf_fa_velocity (factored.cu) runs
// each pass on the tile the host's table names (ops/lenseflow_kernels.py::
// FORMS; lenseflow_common.cuh::k3_on_tile): this kernel at radix 16 and 32
// at every tier (the strict one in FP32 FMA, the bits of fa_kernel's
// ordered channel-group launches it replaced there) and at 'high' radix 4
// and 'bf16' radix 4 and 8; fa_kernel on fact_tile (factored_kernels.cuh)
// strict at radix 4 and 8 and at 'high' radix 8, where an A/B in turns
// measured it faster. Only these forms are built; the two tiles give the
// same bits.
//
// The role, at run time as in fa_kernel: role 0 (forward) loads y and
// multiplies the derivative by p at store; role 1 (adjoint) loads p y. The
// x pass stores p_x d_x y (or d_x(p_x y)); the y pass reads that, adds
// the y term and stores, from the one thread that owns the pixel pair,
// after the x pass's launch in stream order: no atomics, so the bits are
// the same every run, and the sum is the x term plus the y term, as in
// fa_kernel and the plain version. The store takes the tile's channel
// groups' partial sums and multiplies and adds them in fa_kernel's order,
// each product and sum rounded on its own (mul2, add2: nvcc would
// otherwise fuse them into one FMA), as K5 (uni_sm90.cu) does, so that a
// flow on K3 gives the same bits as the same flow on K5. blockIdx.y = batch * ncomp + component,
// so a batched flow (the line search's trials, each with its own p) is one
// launch a pass.
//
// What bounds it: the tile's (fact_sm90.cuh's header), with one more plane
// read a pass (p) and, in the y pass, the x pass's output read back; the
// adjoint's load reads two planes a value (p and y).
//
// Plain C++ entry (lf_sm90::fa_pass, called by lf_fa_velocity) and C
// entries for set-up (lf_fa_sm90_init) and the cluster-fit query.

#include "fact_sm90.cuh"

namespace {

// One pass (AXIS) of K3 over gridDim.y = nbatch * ncomp planes of y; p
// holds the planes (p_x, p_y) of every batch entry, (2, nbatch, Ny, Nx).
template <int B, int AXIS, int TIER>
__global__ void __launch_bounds__(NT, 1)
fa_sm90_kernel(const float* __restrict__ y, float* __restrict__ k, const float* __restrict__ p,
               const void* __restrict__ W, const float* __restrict__ bf, int ncomp,
               int nbatch, int Ny, int Nx, int role) {
    const size_t plane = (size_t)Ny * Nx;
    const float* yp = y + blockIdx.y * plane;
    float* kp = k + blockIdx.y * plane;
    // p along this axis
    const float* pa = p + ((size_t)(AXIS == AXIS_X ? 0 : nbatch) + blockIdx.y / ncomp) * plane;
    fact_sm90<B, velocity_ctas(B), AXIS, TIER>(
        W, bf, Nx,
        [&](size_t q) {
            const float x = __ldcg(yp + q);
            return role != 0 ? __ldcg(pa + q) * x : x;
        },
        [&](size_t q) {   // the pixel pair's p (role 0) and (y pass) k
            const float2 pv = role == 0 ? ld2(pa + q) : make_float2(0.f, 0.f);
            const float2 kv = AXIS == AXIS_Y ? ld2(kp + q) : make_float2(0.f, 0.f);
            return make_float4(pv.x, pv.y, kv.x, kv.y);
        },
        [&](size_t q, const Parts<sm90_groups(B)>& part, float4 pre) {
            // fa_kernel's order: each channel group's sum times p (role 0),
            // the x pass's first group stored, every later one added
            const float2 pv = make_float2(pre.x, pre.y);
            const auto s = [&](float2 g) { return role == 0 ? mul2(g, pv) : g; };
            st2(kp + q, AXIS == AXIS_X ? fold(s(part.g[0]), part, 1, s)
                                       : fold(make_float2(pre.z, pre.w), part, 0, s));
        });
}

// Where K3 is built on this tile: every built tier and radix that does not
// run fact_tile (lenseflow_common.cuh::k3_on_tile).
struct K3Built {
    static constexpr bool on(int B, int tier) { return !k3_on_tile(B, tier); }
};

template <int AXIS>
int pass(int tier, int Bv, const float* y, float* k, const float* p, const void* W,
         const float* bf, int nbatch, int ncomp, int Ny, int Nx, int role, cudaStream_t st) {
    return sm90_dispatch<K3Built>(tier, Bv, [&](auto b, auto t) {
        constexpr int B = decltype(b)::value, TIER = decltype(t)::value;
        constexpr int NC = velocity_ctas(B);
        return sm90_launch<B, NC, TIER>(fa_sm90_kernel<B, AXIS, TIER>, sm90_tiles<AXIS>(Ny, Nx),
                                    nbatch * ncomp, st, y, k, p, W, bf, ncomp, nbatch, Ny, Nx,
                                    role);
    });
}

}  // namespace

namespace lf_sm90 {
// One pass (axis 0: x, stores; 1: y, adds) of the forward (role 0) or
// adjoint (role 1) velocity of the (nbatch, ncomp, Ny, Nx) state y into k
// under the p(t) planes p, (2, nbatch, Ny, Nx), at `tier`, radix Bv along
// the axis: one launch. W: the axis' blocks (strict: FP32 (B, A, A) as
// fact_tile takes them; 'high' and 'bf16': the swizzled split (2, B, A, A)
// bf16). The y pass runs after the x pass in stream order.
int fa_pass(int tier, int axis, int Bv, int role, const float* y, float* k, const float* p,
            const void* W, const float* bf, int nbatch, int ncomp, int Ny, int Nx, void* stream) {
    if ((axis == AXIS_X ? Nx : Ny) != Bv * FA || (role != 0 && role != 1) || nbatch < 1 ||
        ncomp < 1 || nbatch * ncomp > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    return axis == AXIS_X ? pass<AXIS_X>(tier, Bv, y, k, p, W, bf, nbatch, ncomp, Ny, Nx, role, st)
                          : pass<AXIS_Y>(tier, Bv, y, k, p, W, bf, nbatch, ncomp, Ny, Nx, role, st);
}
}  // namespace lf_sm90

LF_SM90_SETUP(fa_sm90_kernel, velocity_ctas, K3Built, lf_fa_sm90_init, lf_fa_sm90_clusters)

#ifdef LF_CLOCK_PHASES
// the phase probe's entry: both passes of a K3 velocity on this tile
// (lf_fa_velocity lives in factored.cu)
extern "C" int lf_fa_sm90_probe(int tier, int role, const float* y, float* k, const float* p,
                                const void* WX, const void* WYT, const float* bfx,
                                const float* bfy, int Bx, int By, int nbatch, int ncomp, int Ny,
                                int Nx, void* stream) {
    const int rc = lf_sm90::fa_pass(tier, AXIS_X, Bx, role, y, k, p, WX, bfx, nbatch, ncomp, Ny,
                                    Nx, stream);
    return rc != 0 ? rc : lf_sm90::fa_pass(tier, AXIS_Y, By, role, y, k, p, WYT, bfy, nbatch,
                                           ncomp, Ny, Nx, stream);
}
#endif
