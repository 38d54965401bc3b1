// K5 for NVIDIA Hopper (sm_90a) on factored operands at every tier: the
// universal role-switched velocity kernel on the cluster tile fact_sm90
// (fact_sm90.cuh), one launch a pass and stage at every radix, its
// clusters velocity_ctas: one CTA at radix 8, as K3's.
//
// Replaces `_bwdAB_kernel` (cmblensing_tpu/ops/pallas_lenseflow.py:734,
// launched by `_uni_call` :795) with its derivatives strict,
// `_mk_dot('high')` (:225) and `_mk_dot('bf16')` (:218): lf_uni_velocity
// (uni.cu) runs each pass on the tile the host's table names
// (ops/lenseflow_kernels.py::FORMS; lenseflow_common.cuh::k5_on_tile):
// this kernel at radix 16 and 32 at every tier (the strict one in FP32
// FMA, the bits of uni_kernel's ordered channel-group launches it replaced
// there) and at radix 4 at 'high' and 'bf16'; uni_kernel on fact_tile
// strict at radix 4 and 8 and at every tier at 8, where an A/B in turns
// measured it faster. Only these forms are built; the two tiles give the
// same bits. The dense K5 is uni_dense.cu.
//
// The contract is uni_kernel's (uni.cu's header has the roles in full):
// roles 0-3 at run time, role 1 as two stages (the inner stage forms the
// two bracketed planes in the scratch, the outer one differentiates them),
// a and b strided views of a flow state (entry z reads them at (z / nper)
// * bs + (z % nper) * cs elements), px and py one plane a batch entry, out
// 4 planes and the scratch 2 planes an entry, entry x derivative on the
// grid's y axis (blockIdx.y = entry * nder + j), so the line search's 17
// trials are one launch a pass.
//
// Stores. Each output pixel pair is one thread's, after the tile's second
// cluster barrier, and the passes and stages run in stream order, so no
// store needs an atomic and the bits are the same every run: role 0's
// b d_x a and b d_y a are each one pass's own plane (2, 3), which that
// pass stores once; every other output plane is stored by the x pass and
// read, added to and stored by the y pass (x term plus y term, as in
// uni_kernel and the plain version); the x pass alone writes role 1's
// "+ a" (a plus d_x(t px a), the order of uni_kernel's add) and the planes
// a role leaves at zero, exact zeros. The store takes the tile's channel
// groups' partial sums and multiplies and adds them in uni_kernel's order,
// each product and sum rounded on its own (mul2, add2: never fused into an
// FMA), so that the uni flows give the bits of the kernel backend's: K3's
// (fa_sm90.cu) and K4's delta f (bv_sm90.cu). Role 1's inner stage finishes both
// passes before the outer stage reads the scratch (stream order), and the
// outer stage forms its channels from those FP32 sums and rounds them at
// the tier, as JAX rounds `a + ddx(t px a) + ddy(t py a)`. The role's
// branches are uniform across the grid and lie in the functors, outside
// the tile's loops.
//
// The pixel pairs are read and written as float2: b and the operand (the
// "+ a" of role 1) at their strided offsets, so a, b and their strides
// must keep 8-byte alignment (ops/lenseflow_kernels.py checks it and
// raises; a flow state's planes always do).
//
// What bounds it: the tile's (fact_sm90.cuh's header); role 0 does four
// derivatives and role 1 six (two launches a stage), against 8 planes of
// traffic (a, b, px, py in, out) and role 1's scratch.
//
// Plain C++ entry (lf_sm90::uni_pass, called by lf_uni_velocity) and C
// entries for set-up (lf_uni_sm90_init) and the cluster-fit query.

#include "fact_sm90.cuh"

namespace {

// what a store reads of a pixel pair before its sums arrive (fetch)
struct Pre3 {
    float2 b, p, d;
};

// One pass (AXIS) of one derivative of one stage of the role's velocity.
template <int B, int AXIS, int TIER>
__global__ void __launch_bounds__(NT, 1)
uni_sm90_kernel(int role, int stage, const float* __restrict__ a, const float* __restrict__ b,
                long long a_bs, long long a_cs, long long b_bs, long long b_cs, int nper,
                const float* __restrict__ px, const float* __restrict__ py,
                float* __restrict__ out, float* __restrict__ scratch,
                const void* __restrict__ W, const float* __restrict__ bf, int Ny,
                int Nx, float t) {
    const size_t plane = (size_t)Ny * Nx;
    const int nder = role == 1 && stage == 1 ? 1 : 2;
    const int z = blockIdx.y / nder, j = blockIdx.y % nder, bi = z / nper, ci = z % nper;
    const float* az = a + bi * a_bs + ci * a_cs;
    const float* bz = b + bi * b_bs + ci * b_cs;
    const float* pa = (AXIS == AXIS_X ? px : py) + (size_t)bi * plane;   // p along this axis
    float* o = out + (size_t)z * 4 * plane;
    float* sc = role == 1 ? scratch + (size_t)z * 2 * plane : nullptr;
    constexpr bool first = AXIS == AXIS_X;   // the x pass stores, the y pass adds
    const bool inner = role == 1 && stage == 0;
    // the operand: a or b, or (outer stage) the bracketed plane of this axis
    const float* src = role == 1 && stage == 1 ? sc + AXIS * plane : (j == 0 ? az : bz);
    // multiplied by p (times t in the inner stage) before the derivative
    const bool pre = (role == 0 && j == 1) || inner || role == 3;
    const float scale = inner ? t : 1.f;
    // where the derivative goes: out plane j, or the inner stage's scratch plane j
    float* dst = inner ? sc + j * plane : (role == 1 ? o : o + j * plane);
    const bool mul = (role == 0 && j == 0) || role == 2;   // p . grad: p multiplied at store
    fact_sm90<B, velocity_ctas(B), AXIS, TIER>(
        W, bf, Nx,
        [&](size_t q) {
            const float x = __ldcg(src + q);
            return pre ? scale * __ldcg(pa + q) * x : x;
        },
        [&](size_t q) {
            // the pixel pair's b (role 0's b d a), p (p . grad), and the
            // operand (the inner stage's "+ a") or the x pass's plane (the
            // y pass)
            Pre3 got = {make_float2(0.f, 0.f), make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
            if (role == 0 && j == 0) got.b = ld2(bz + q);
            if (mul) got.p = ld2(pa + q);
            if (!first) got.d = ld2(dst + q);
            else if (inner) got.d = ld2(src + q);
            return got;
        },
        [&](size_t q, const Parts<sm90_groups(B)>& part, const Pre3& got) {
            // uni_kernel's order: each channel group's sum through the role's
            // product, the pass's first group stored (the y pass: added onto
            // the x pass's plane), every later one added
            const auto id = [](float2 g) { return g; };
            const float2 pv = got.p;
            const auto byp = [&](float2 g) { return mul2(g, pv); };
            if (role == 0 && j == 0) {   // b d_x a, b d_y a: this pass's plane
                const float2 bv = got.b;
                const auto byb = [&](float2 g) { return mul2(bv, g); };
                st2(o + (2 + AXIS) * plane + q, fold(byb(part.g[0]), part, 1, byb));
            }
            if (first) {
                float2 v = mul ? byp(part.g[0]) : part.g[0];
                if (inner) v = add2(v, got.d);   // a (or b) + d_x(t px a)
                st2(dst + q, mul ? fold(v, part, 1, byp) : fold(v, part, 1, id));
                if (j == 0 && role != 0) {   // the planes this role leaves at zero
                    const float2 zero = make_float2(0.f, 0.f);
                    if (role == 1 && stage == 1) st2(o + plane + q, zero);
                    if (role != 1 || stage == 1) {
                        st2(o + 2 * plane + q, zero);
                        st2(o + 3 * plane + q, zero);
                    }
                }
            } else {
                st2(dst + q, mul ? fold(got.d, part, 0, byp) : fold(got.d, part, 0, id));
            }
        });
}

// Where K5 is built on this tile: every built tier and radix that does not
// run fact_tile (lenseflow_common.cuh::k5_on_tile).
struct K5Built {
    static constexpr bool on(int B, int tier) { return !k5_on_tile(B, tier); }
};

template <int AXIS>
int pass(int tier, int Bv, int role, int stage, const float* a, const float* b, long long a_bs,
         long long a_cs, long long b_bs, long long b_cs, int nper, const float* px,
         const float* py, float* out, float* scratch, const void* W, const float* bf, int nz,
         int Ny, int Nx, float t, cudaStream_t st) {
    return sm90_dispatch<K5Built>(tier, Bv, [&](auto bv, auto tv) {
        constexpr int B = decltype(bv)::value, TIER = decltype(tv)::value;
        constexpr int NC = velocity_ctas(B);
        return sm90_launch<B, NC, TIER>(uni_sm90_kernel<B, AXIS, TIER>, sm90_tiles<AXIS>(Ny, Nx), nz,
                                    st, role, stage, a, b, a_bs, a_cs, b_bs, b_cs, nper, px, py,
                                    out, scratch, W, bf, Ny, Nx, t);
    });
}

}  // namespace

namespace lf_sm90 {
// One pass (axis 0: x, stores; 1: y, adds) of stage `stage` of the role's
// velocity of the (nbatch, nper) entries of a and b at time t, as
// lf_uni_velocity (uni.cu) takes it, at `tier`, radix Bv along the axis:
// one launch. W: the axis' blocks (strict: FP32 (B, A, A) as fact_tile
// takes them; 'high' and 'bf16': the swizzled split (2, B, A, A) bf16). a,
// b and their strides must keep 8-byte alignment. The passes and stages
// run in stream order.
int uni_pass(int tier, int axis, int Bv, int role, int stage, const float* a, const float* b,
             long long a_bs, long long a_cs, long long b_bs, long long b_cs, const float* px,
             const float* py, float* out, float* scratch, const void* W, const float* bf,
             int nbatch, int nper, int Ny, int Nx, float t, void* stream) {
    if ((axis == AXIS_X ? Nx : Ny) != Bv * FA || nbatch * nper * 2 > 65535 ||
        ((reinterpret_cast<size_t>(a) | reinterpret_cast<size_t>(b)) & 7) ||
        ((a_bs | a_cs | b_bs | b_cs) & 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int nz = nbatch * nper * (role == 1 && stage == 1 ? 1 : 2);
    return axis == AXIS_X ? pass<AXIS_X>(tier, Bv, role, stage, a, b, a_bs, a_cs, b_bs, b_cs, nper,
                                         px, py, out, scratch, W, bf, nz, Ny, Nx, t, st)
                          : pass<AXIS_Y>(tier, Bv, role, stage, a, b, a_bs, a_cs, b_bs, b_cs, nper,
                                         px, py, out, scratch, W, bf, nz, Ny, Nx, t, st);
}
}  // namespace lf_sm90

LF_SM90_SETUP(uni_sm90_kernel, velocity_ctas, K5Built, lf_uni_sm90_init, lf_uni_sm90_clusters)
