// K3 at 'high' and 'bf16' for NVIDIA Hopper (sm_90a): one pass of the
// forward (p . grad y) or adjoint (div(p y)) velocity on the cluster tile
// fact_sm90 (fact_sm90.cuh), one launch a pass at every radix, its
// clusters velocity_ctas: one CTA at radix 8, as K5's.
//
// Replaces, at the tiers 'high' and 'bf16', `_fa_kernel`
// (cmblensing_tpu/ops/pallas_lenseflow.py:506, launched by `_fa_call`
// :534) with its derivatives `_mk_dot('high')` (:225) and `_mk_dot('bf16')`
// (:218): lf_fa_velocity (factored.cu) runs this kernel at TIER_HIGH and
// TIER_BF16 and keeps fa_kernel on fact_tile (factored_kernels.cuh) for
// the strict tier.
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
// Plain C++ entry (lf_sm90::fa_velocity, called by lf_fa_velocity) and C
// entries for set-up (lf_fa_sm90_init) and the cluster-fit query.

#include "fact_sm90.cuh"

namespace {

// One pass (AXIS) of K3 over gridDim.y = nbatch * ncomp planes of y; p
// holds the planes (p_x, p_y) of every batch entry, (2, nbatch, Ny, Nx).
template <int B, int AXIS, int TIER>
__global__ void __launch_bounds__(NT, 1)
fa_sm90_kernel(const float* __restrict__ y, float* __restrict__ k, const float* __restrict__ p,
               const __nv_bfloat16* __restrict__ W, const float* __restrict__ bf, int ncomp,
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
        [&](size_t q, const Parts<sm90_groups(B)>& part) {
            // fa_kernel's order: each channel group's sum times p (role 0),
            // the x pass's first group stored, every later one added
            const float2 pv = role == 0 ? ld2(pa + q) : make_float2(0.f, 0.f);
            const auto s = [&](float2 g) { return role == 0 ? mul2(g, pv) : g; };
            st2(kp + q, AXIS == AXIS_X ? fold(s(part.g[0]), part, 1, s)
                                       : fold(ld2(kp + q), part, 0, s));
        });
}

template <int AXIS>
int pass(int tier, int Bv, const float* y, float* k, const float* p, const void* W,
         const float* bf, int nbatch, int ncomp, int Ny, int Nx, int role, cudaStream_t st) {
    return sm90_dispatch(tier, Bv, [&](auto b, auto t) {
        constexpr int B = decltype(b)::value, TIER = decltype(t)::value;
        constexpr int NC = velocity_ctas(B);
        return sm90_launch<B, NC, TIER>(fa_sm90_kernel<B, AXIS, TIER>, sm90_tiles<AXIS>(Ny, Nx),
                                    nbatch * ncomp, st, y, k, p,
                                    static_cast<const __nv_bfloat16*>(W), bf, ncomp, nbatch, Ny,
                                    Nx, role);
    });
}

}  // namespace

namespace lf_sm90 {
// k <- the forward (role 0) or adjoint (role 1) velocity of the (nbatch,
// ncomp, Ny, Nx) state y under the p(t) planes p, (2, nbatch, Ny, Nx), at
// `tier` ('high' or 'bf16'); WX, WYT: the swizzled split blocks (2, B, A,
// A) bf16 of each axis. Two launches: the x pass stores, the y pass adds.
int fa_velocity(int tier, int role, const float* y, float* k, const float* p, const void* WX,
                const void* WYT, const float* bfx, const float* bfy, int Bx, int By, int nbatch,
                int ncomp, int Ny, int Nx, void* stream) {
    if (Nx != Bx * FA || Ny != By * FA || (role != 0 && role != 1) || nbatch < 1 || ncomp < 1 ||
        nbatch * ncomp > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int rc = pass<AXIS_X>(tier, Bx, y, k, p, WX, bfx, nbatch, ncomp, Ny, Nx, role, st);
    return rc != 0 ? rc : pass<AXIS_Y>(tier, By, y, k, p, WYT, bfy, nbatch, ncomp, Ny, Nx, role, st);
}
}  // namespace lf_sm90

LF_SM90_SETUP(fa_sm90_kernel, velocity_ctas, lf_fa_sm90_init, lf_fa_sm90_clusters)

#ifdef LF_CLOCK_PHASES
// the phase probe's entry to lf_sm90::fa_velocity (lf_fa_velocity lives in
// factored.cu)
extern "C" int lf_fa_sm90_probe(int tier, int role, const float* y, float* k, const float* p,
                                const void* WX, const void* WYT, const float* bfx,
                                const float* bfy, int Bx, int By, int nbatch, int ncomp, int Ny,
                                int Nx, void* stream) {
    return lf_sm90::fa_velocity(tier, role, y, k, p, WX, WYT, bfx, bfy, Bx, By, nbatch, ncomp, Ny,
                                Nx, stream);
}
#endif
