// The 'high' tier of the factored LenseFlow kernels on fact_tile, K3 and K4
// where FORMS puts them on it (factored_kernels.cuh, TIER_HIGH: the block
// products as mma.sync bf16 products of the split operands; every other
// form runs the cluster tile, fa_sm90.cu and bv_sm90.cu, and K1 at 'high'
// fderiv_sm90.cu), in a source of its own so that
// nvcc builds it beside the FP32 tier's (factored.cu, which holds the C
// entries) and the 'bf16' tier's (factored_bf16.cu).

#include "factored_kernels.cuh"

LF_TIER_DEFINE(lf_high, TIER_HIGH)
