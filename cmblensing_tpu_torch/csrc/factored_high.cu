// The 'high' tier of the factored LenseFlow kernels (factored_kernels.cuh,
// HIGH = true: the block products as mma.sync bf16 products of the split
// operands), in a source of its own so that nvcc builds it beside the FP32
// tier's (factored.cu), which holds the C entries.

#include "factored_kernels.cuh"

namespace lf_high {

int fderiv(const float* a, const float* b, const float* c, float* out, const void* FX,
           const void* FYT, const float* bfx, const float* bfy, int Bx, int By, int nplanes,
           int Ny, int Nx, void* stream) {
    return ::fderiv<true>(a, b, c, out, FX, FYT, bfx, bfy, Bx, By, nplanes, Ny, Nx, stream);
}

int fa_velocity(int role, const float* y, float* k, const float* p, const void* FX,
                const void* FYT, const float* bfx, const float* bfy, int Bx, int By, int nbatch,
                int ncomp, int Ny, int Nx, void* stream) {
    return ::fa_velocity<true>(role, y, k, p, FX, FYT, bfx, bfy, Bx, By, nbatch, ncomp, Ny, Nx,
                               stream);
}

int bv_velocity(const float* y, float* k, const float* phi, const float* p, const void* FX,
                const void* FYT, const float* bfx, const float* bfy, int Bx, int By, int nbatch,
                int ncomp, int Ny, int Nx, float t, void* stream) {
    return ::bv_velocity<true>(y, k, phi, p, FX, FYT, bfx, bfy, Bx, By, nbatch, ncomp, Ny, Nx, t,
                               stream);
}

int init() {
    int rc = allow_smem<4, true>();
    if (rc == 0) rc = allow_smem<8, true>();
    if (rc == 0) rc = allow_smem<16, true>();
    return rc != 0 ? rc : allow_smem<32, true>();
}

}  // namespace lf_high
