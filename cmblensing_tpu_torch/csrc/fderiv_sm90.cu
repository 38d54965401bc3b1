// K1 at 'high' and 'bf16' for NVIDIA Hopper (sm_90a): the radix-B factored
// derivative d_x a or d_y a on the cluster tile fact_sm90 (fact_sm90.cuh),
// one launch a pass at every radix.
//
// Replaces, at the tiers 'high' and 'bf16', the factored in-kernel
// derivative `_fact_apply` / `_make_ddx_ddy_fact` of
// cmblensing_tpu/ops/pallas_lenseflow.py (:249, :273) with its products
// `_mk_dot('high')` (:225) and `_mk_dot('bf16')` (:218): lf_fderiv
// (factored.cu) runs this kernel at TIER_HIGH and TIER_BF16 and keeps
// fact_tile (fact_tile.cuh) for the strict tier. K3 (fa_sm90.cu) and K5
// (uni_sm90.cu) run the same tile at every tier where the host's table
// puts them on it (ops/lenseflow_kernels.py::FORMS); K4 runs fact_tile at
// every tier.
//
// What bounds it, and what the tile does about it: fact_sm90.cuh's header
// (a plane in and out and one axis' split blocks; the FP32 butterflies;
// the operand's loads, which still take half of a radix-32 CTA's cycles).
// The load reads the operand through the L2 alone (__ldcg: 0.90x the time
// at 2048^2, the same elsewhere); the store adds c and, in the y pass of
// d_x a + d_y b, what the x pass stored, by a read, an add and a store of
// the pixel pair the thread owns, its channel groups' partial sums added in
// fact_tile's order (at radix 4 and 8 one group: a single sum, as before).
//
// Plain C++ entry (lf_sm90::fderiv, called by lf_fderiv) and C entries
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
            // fderiv_kernel's order: the first group (+ c) stored or added,
            // then each later group added
            float2 v = part.g[0];
            if (cp != nullptr) v = add2(v, make_float2(pre.x, pre.y));
            if (accumulate) v = add2(make_float2(pre.z, pre.w), v);
            st2(op + q, fold(v, part, 1, [](float2 g) { return g; }));
        });
}

// Where K1 is built on this tile: 'high' and 'bf16', every radix (strict
// K1 runs fact_tile).
struct K1Built {
    static constexpr bool on(int, int tier) { return tier != TIER_F32; }
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
// out = d_x a + d_y b + c over nplanes planes at `tier` ('high' or 'bf16');
// a or b (not both) and c may be null; out must not alias a or b. WX, WYT:
// the swizzled split blocks (2, B, A, A) bf16 of each axis. One launch a
// pass: the x pass stores, the y pass adds onto it in stream order.
int fderiv(int tier, const float* a, const float* b, const float* c, float* out, const void* WX,
           const void* WYT, const float* bfx, const float* bfy, int Bx, int By, int nplanes,
           int Ny, int Nx, void* stream) {
    if (Nx != Bx * FA || Ny != By * FA || (a == nullptr && b == nullptr) || nplanes < 1 ||
        nplanes > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (a != nullptr) {
        const int rc = pass<AXIS_X>(tier, Bx, a, c, out, WX, bfx, Ny, Nx, nplanes, 0, st);
        if (rc != 0 || b == nullptr) return rc;
    }
    return pass<AXIS_Y>(tier, By, b, a != nullptr ? nullptr : c, out, WYT, bfy, Ny, Nx, nplanes,
                        a != nullptr, st);
}
}  // namespace lf_sm90

LF_SM90_SETUP(fderiv_sm90_kernel, cluster_ctas, K1Built, lf_fderiv_sm90_init,
              lf_fderiv_sm90_clusters)

#ifdef LF_CLOCK_PHASES
// the phase probe's entry to lf_sm90::fderiv (lf_fderiv lives in factored.cu)
extern "C" int lf_fderiv_sm90_probe(int tier, const float* a, const float* b, const float* c,
                                    float* out, const void* WX, const void* WYT, const float* bfx,
                                    const float* bfy, int Bx, int By, int nplanes, int Ny, int Nx,
                                    void* stream) {
    return lf_sm90::fderiv(tier, a, b, c, out, WX, WYT, bfx, bfy, Bx, By, nplanes, Ny, Nx, stream);
}
#endif
