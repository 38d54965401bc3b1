// Device helpers shared by the dense (lenseflow.cu) and factored
// (factored.cu) LenseFlow kernels.
#pragma once

#include <stddef.h>

// p(t) = (I + t Hess phi)^-1 grad phi at pixel idx; phi holds the planes
// (gx, gy, hxx, hxy, hyy) with stride `plane`.
__device__ __forceinline__ void p_of_t(const float* __restrict__ phi, size_t plane,
                                       size_t idx, float t, float& px, float& py) {
    const float gx = phi[idx], gy = phi[plane + idx];
    const float a = 1.f + t * phi[2 * plane + idx];
    const float b = t * phi[3 * plane + idx];
    const float d = 1.f + t * phi[4 * plane + idx];
    const float idet = 1.f / (a * d - b * b);
    px = (d * gx - b * gy) * idet;
    py = (-b * gx + a * gy) * idet;
}

// The five hoisted delta-phi integrands of the backward flow at pixel o,
// from w = sum_c delta f_c grad f_c: u = M^-1(t) w, then
// (u_x, u_y, t p_x u_x, t (p_y u_x + p_x u_y), t p_y u_y), written to the
// planes acc[0..4] (stride `plane`).
__device__ __forceinline__ void dphi_integrands(const float* __restrict__ phi, size_t plane,
                                                size_t o, float t, float wx, float wy,
                                                float* __restrict__ acc) {
    const float gx = phi[o], gy = phi[plane + o];
    const float a = 1.f + t * phi[2 * plane + o];
    const float b = t * phi[3 * plane + o];
    const float d = 1.f + t * phi[4 * plane + o];
    const float idet = 1.f / (a * d - b * b);
    const float px = (d * gx - b * gy) * idet, py = (-b * gx + a * gy) * idet;
    const float m11 = d * idet, m12 = -b * idet, m22 = a * idet;
    const float ux = m11 * wx + m12 * wy;
    const float uy = m12 * wx + m22 * wy;
    acc[o] = ux;
    acc[plane + o] = uy;
    acc[2 * plane + o] = t * px * ux;
    acc[3 * plane + o] = t * (py * ux + px * uy);
    acc[4 * plane + o] = t * py * uy;
}
