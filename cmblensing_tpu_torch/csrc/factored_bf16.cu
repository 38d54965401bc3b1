// The 'bf16' tier of the factored LenseFlow kernels on fact_tile, K3 and K4
// where FORMS puts them on it (factored_kernels.cuh, TIER_BF16: each block
// product one mma.sync bf16 product of the blocks' heads and the channel
// values rounded to nearest even, `_mk_dot('bf16')` of
// cmblensing_tpu/ops/pallas_lenseflow.py:218; every other form runs the
// cluster tile, fa_sm90.cu and bv_sm90.cu, and K1 at 'bf16'
// fderiv_sm90.cu), in a source of its own so that nvcc builds it beside the
// FP32 (factored.cu, which holds the C entries) and 'high'
// (factored_high.cu) tiers.

#include "factored_kernels.cuh"

LF_TIER_DEFINE(lf_bf16, TIER_BF16)
