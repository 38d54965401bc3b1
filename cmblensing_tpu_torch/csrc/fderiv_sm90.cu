// K1 for NVIDIA Hopper (sm_90a) at every tier: the radix-B factored
// derivative d_x a or d_y a on the cluster tile fact_sm90 (fact_sm90.cuh),
// one launch a pass.
//
// Replaces the factored in-kernel derivative `_fact_apply` /
// `_make_ddx_ddy_fact` of cmblensing_tpu/ops/pallas_lenseflow.py (:249,
// :273) with its products strict, `_mk_dot('high')` (:225) and
// `_mk_dot('bf16')` (:218): lf_fderiv (factored.cu) runs every pass of K1
// here, at every tier and radix; strict on the cluster tile's FP32 tier,
// FP32 FMA in fact_tile's order, so the bits of the fact_tile kernel it
// replaced (one launch a channel group at radix 16 and 32, one at 4 and
// 8). That form is built no more: the A/B in turns measured this one
// 1.2-1.6x faster at radix 4 and 8, and 1.04x slower at 16 (2048^2, d_x +
// d_y, 0.1687 against 0.1617 ms; PERF.md §6), a cost kept so that K1 has
// one form and fact_tile no channel-group launches. K3 (fa_sm90.cu), K4
// (bv_sm90.cu) and K5 (uni_sm90.cu) run the same tile.
//
// What bounds it, and what the tile does about it: fact_sm90.cuh's header
// (a plane in and out and one axis' blocks; the FP32 butterflies; the
// operand's loads, which still take half of a radix-32 CTA's cycles).
// The load reads the operand through the L2 alone (__ldcg: 0.90x the time
// at 2048^2, the same elsewhere); the store adds c and, in the y pass of
// d_x a + d_y b, what the x pass stored, by a read, an add and a store of
// the pixel pair the thread owns, its channel groups' partial sums added in
// fact_tile's order (at radix 4 and 8 one group: a single sum, as before).
//
// Plain C++ entry (lf_sm90::fderiv_pass, called by lf_fderiv) and C entries
// for set-up (lf_fderiv_sm90_init) and the cluster-fit query; every launch
// goes on the caller's stream and returns its error code: a refused
// cluster launch raises in the wrapper.

#include "fact_sm90.cuh"

namespace {

// K1 along AXIS over gridDim.y planes: out = D a (+ c), or out += D a
// where `accumulate`. W, bf: fact_sm90's operands.
template <int B, int AXIS, int TIER>
__global__ void __launch_bounds__(NT, 1)
fderiv_sm90_kernel(const float* __restrict__ a, const float* __restrict__ c,
                   float* __restrict__ out, const void* __restrict__ W,
                   const float* __restrict__ bf, int Ny, int Nx, int accumulate) {
    const size_t base = (size_t)blockIdx.y * Ny * Nx;
    const float* ap = a + base;
    const float* cp = c != nullptr ? c + base : nullptr;
    float* op = out + base;
    fact_sm90<B, cluster_ctas(B), AXIS, TIER>(
        W, bf, Nx, [&](size_t q) { return __ldcg(ap + q); },
        [&](size_t q) {   // the pixel pair's c and (accumulating) out
            const float2 cv = cp != nullptr ? ld2(cp + q) : make_float2(0.f, 0.f);
            const float2 ov = accumulate ? ld2(op + q) : make_float2(0.f, 0.f);
            return make_float4(cv.x, cv.y, ov.x, ov.y);
        },
        [&](size_t q, const Parts<sm90_groups(B)>& part, float4 pre) {
            // the replaced fact_tile kernel's order: the first group (+ c)
            // stored or added, then each later group added
            float2 v = part.g[0];
            if (cp != nullptr) v = add2(v, make_float2(pre.x, pre.y));
            if (accumulate) v = add2(make_float2(pre.z, pre.w), v);
            st2(op + q, fold(v, part, 1, [](float2 g) { return g; }));
        });
}

// Where K1 is built on this tile: every tier and radix.
struct K1Built {
    static constexpr bool on(int, int) { return true; }
};

template <int AXIS>
int pass(int tier, int Bv, const float* x, const float* c, float* out, const void* W,
         const float* bf, int Ny, int Nx, int nplanes, int accumulate, cudaStream_t st) {
    return sm90_dispatch<K1Built>(tier, Bv, [&](auto b, auto t) {
        constexpr int B = decltype(b)::value, TIER = decltype(t)::value;
        constexpr int NC = cluster_ctas(B);
        return sm90_launch<B, NC, TIER>(fderiv_sm90_kernel<B, AXIS, TIER>, sm90_tiles<AXIS>(Ny, Nx),
                                    nplanes, st, x, c, out, W, bf, Ny, Nx, accumulate);
    });
}

}  // namespace

namespace lf_sm90 {
// One pass (axis 0: x; 1: y) of K1 at `tier`, radix Bv along the axis: out
// = D x (+ c), or out += D x where `accumulate`, over nplanes planes; c may
// be null; out must not alias x. W: the axis' blocks (strict: FP32 (B, A,
// A) as fact_tile takes them; 'high' and 'bf16': the swizzled split (2, B,
// A, A) bf16). One launch; passes that add run after the pass they add
// onto, in stream order.
int fderiv_pass(int tier, int axis, int Bv, const float* x, const float* c, float* out,
                const void* W, const float* bf, int nplanes, int Ny, int Nx, int accumulate,
                void* stream) {
    if ((axis == AXIS_X ? Nx : Ny) != Bv * FA || nplanes < 1 || nplanes > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    return axis == AXIS_X ? pass<AXIS_X>(tier, Bv, x, c, out, W, bf, Ny, Nx, nplanes, accumulate, st)
                          : pass<AXIS_Y>(tier, Bv, x, c, out, W, bf, Ny, Nx, nplanes, accumulate, st);
}
}  // namespace lf_sm90

LF_SM90_SETUP(fderiv_sm90_kernel, cluster_ctas, K1Built, lf_fderiv_sm90_init,
              lf_fderiv_sm90_clusters)

#ifdef LF_CLOCK_PHASES
// the phase probe's entry: out = d_x a + d_y b + c on this tile (a or b may
// be null; lf_fderiv lives in factored.cu)
extern "C" int lf_fderiv_sm90_probe(int tier, const float* a, const float* b, const float* c,
                                    float* out, const void* WX, const void* WYT, const float* bfx,
                                    const float* bfy, int Bx, int By, int nplanes, int Ny, int Nx,
                                    void* stream) {
    int rc = 0;
    if (a != nullptr)
        rc = lf_sm90::fderiv_pass(tier, AXIS_X, Bx, a, c, out, WX, bfx, nplanes, Ny, Nx, 0, stream);
    if (rc == 0 && b != nullptr)
        rc = lf_sm90::fderiv_pass(tier, AXIS_Y, By, b, a != nullptr ? nullptr : c, out, WYT, bfy,
                                  nplanes, Ny, Nx, a != nullptr, stream);
    return rc;
}
#endif
