"""LenseFlow: ODE-based lensing (Millea, Anderes & Wandelt 2019).

Counterpart of ``cmblensing_tpu/models/lenseflow.py``. The lensing
operator L(phi) transports a field along the velocity

    df/dt = p(t) . grad(f),    p(t) = (I + t Hess(phi))^-1 grad(phi)

integrated t: 0 -> 1 with RK4; p(t) and M^-1(t) are rebuilt at every
stage from grad(phi) and Hess(phi). Gradients come from two
``torch.autograd.Function``s implementing the continuous-adjoint
transpose-delta flow, which integrates the coupled (f, delta f, delta
phi) system t: 1 -> 0, re-evolving f backward on the fly.

Four integration backends, chosen with `set_lenseflow_backend` or
`lenseflow_backend_ctx`:

  'kernel' — ops/lenseflow_kernels.py: the hand-written CUDA flow
             kernels on a CUDA tensor, their plain matmul versions on the
             CPU; dense below the factored-derivative threshold, factored
             above it (whatever ops/deriv.py::deriv_ops returns).
  'uni'    — the same module's per-velocity "uni" granularity: every
             velocity of every flow is a call of the universal
             role-switched kernel (K5), the backward flow integrates
             delta phi in its state; the JAX package's CMBL_FORCE_UNI=1
             CMBL_NO_FA=1. K5 takes the operands `deriv_ops` gives, at
             every tier: factored at 512^2 to 4096^2 (radix 4 to 32, in
             channel groups from 16), dense at every other size (256^2,
             200^2, 768^2). On the CPU its plain version takes either
             form.
  'matmul' — the 'kernel' flows on their plain matmul leaves on any
             device (`flow_apply_plain`, `flow_bwd_plain`): on the card,
             the reference the kernels are held to at either precision.
  'plain'  — RK4 over torch ops with FFT derivatives (ops/deriv.py), the
             backward flow with its delta-phi accumulation hoisted out of
             the time loop, its (f, delta f) state in bfloat16 under
             CMBL_BWD_STATE_DTYPE=bf16 (`_backward_flow_scan`).

The 'kernel', 'matmul' and 'uni' flows run at the matmul precision in
force when the operator is applied (ops/deriv.py::precision_ctx: 'f32',
'high' or 'bf16' on each); phi's planes come from the kernel path's
`gradhess` at the tier's PLANES_PRECISION on every backend; the autograd
Functions record it at forward time and run their backward at it,
wherever `.backward()` is called.
The 'plain' backend's FFT derivatives ignore it.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from ..core.basis import lense_basis
from ..core.field import Field
from ..ops import deriv as _deriv
from ..ops import lenseflow_kernels as _lfk

_BACKEND = "kernel"
BACKENDS = ("kernel", "uni", "matmul", "plain")


def set_lenseflow_backend(backend):
    """'kernel', 'uni', 'matmul' or 'plain' (see the module docstring)."""
    global _BACKEND
    if backend not in BACKENDS:
        raise ValueError(f"unknown LenseFlow backend {backend!r}")
    _BACKEND = backend


def get_lenseflow_backend():
    return _BACKEND


@contextlib.contextmanager
def lenseflow_backend_ctx(backend):
    prev = _BACKEND
    set_lenseflow_backend(backend)
    try:
        yield
    finally:
        set_lenseflow_backend(prev)


# =========================================================================
# plain backend: RK4 over torch ops with FFT derivatives
# =========================================================================

def _gradhess_phi(phi_map, proj):
    """grad(phi) (2 planes) and Hess(phi) (3 planes: xx, xy, yy) in map
    space, from a (..., 1, Ny, Nx) map."""
    return _deriv.gradhess(phi_map, proj)


def _p_t(t, g, h):
    """p(t) = M^-1(t) grad(phi), M(t) = I + t Hess(phi) (2x2 symmetric
    inverse in closed form)."""
    gx, gy = g
    hxx, hxy, hyy = h
    a = 1 + t * hxx
    b = t * hxy
    d = 1 + t * hyy
    det = a * d - b * b
    return (d * gx - b * gy) / det, (-b * gx + a * gy) / det


def _Minv_t(t, h):
    hxx, hxy, hyy = h
    a = 1 + t * hxx
    b = t * hxy
    d = 1 + t * hyy
    det = a * d - b * b
    return d / det, -b / det, a / det


def _velocity(t, f_map, g, h, proj):
    """df/dt = p(t) . grad(f)."""
    px, py = _p_t(t, g, h)
    fx, fy = _deriv.grad_xy(f_map, proj)
    return px[..., None, :, :] * fx + py[..., None, :, :] * fy


def _velocity_adj(t, f_map, g, h, proj):
    """Adjoint-flow velocity div(p f)."""
    px, py = _p_t(t, g, h)
    return _deriv.div_xy(px[..., None, :, :] * f_map, py[..., None, :, :] * f_map, proj)


def _rk4(F, y, t0, t1, nsteps):
    h = (t1 - t0) / nsteps
    for i in range(nsteps):
        t = t0 + i * h
        k1 = F(t, y)
        k2 = F(t + h / 2, y + (h / 2) * k1)
        k3 = F(t + h / 2, y + (h / 2) * k2)
        k4 = F(t + h, y + h * k3)
        y = y + (h / 6) * (k1 + 2 * (k2 + k3) + k4)
    return y


def _backward_velocity(t, state, g, h, proj):
    """Velocity of the coupled transpose-delta system with delta phi in
    the state, not hoisted (reference negδvelocityᴴ,
    src/lenseflow.jl:176-214): the form the 'uni' backward flow
    integrates. state is (..., 2 ncomp + 1, Ny, Nx) = [f, delta f, delta
    phi], and so is the velocity."""
    ncomp = (state.shape[-3] - 1) // 2
    f, df = state[..., :ncomp, :, :], state[..., ncomp:2 * ncomp, :, :]
    px, py = _p_t(t, g, h)
    m11, m12, m22 = _Minv_t(t, h)
    pxe, pye = px[..., None, :, :], py[..., None, :, :]
    ddf = _deriv.div_xy(pxe * df, pye * df, proj)          # div(p delta f)
    fx, fy = _deriv.grad_xy(f, proj)
    dfdt = pxe * fx + pye * fy                             # p . grad f
    wx = torch.sum(df * fx, dim=-3)
    wy = torch.sum(df * fy, dim=-3)
    ux = m11 * wx + m12 * wy
    uy = m12 * wx + m22 * wy
    # div(u) + sum_ij d_i d_j (t p_j u_i)
    ddphi = _deriv.div_plus_dij(ux, uy, t * px * ux, t * py * ux, t * px * uy, t * py * uy, proj)
    return torch.cat([dfdt, ddf, ddphi[..., None, :, :]], dim=-3)


def _backward_flow_scan(f1, dy, g, h, proj, t1, t0, nsteps):
    """Transpose-delta backward flow from t1 to t0; returns (df0, dphi).
    The delta-phi accumulation is linear in the time-local integrands u
    and s_ij = t p_j u_i, so the five integrand planes (u_x, u_y, s_xx,
    s_yx + s_xy, s_yy) are accumulated with the RK4 weights and
    `div_plus_dij5` is applied once after the loop.

    CMBL_BWD_STATE_DTYPE=bf16 (read at each call, as the JAX package
    reads it at trace time; the plain backend's flow alone, as there the
    scan's alone): the (f, delta f) state is rounded to bfloat16 wherever
    the JAX package stores it (each RK4 stage's input and each step's
    result), the delta-phi accumulators stay float32."""
    hstep = (t0 - t1) / nsteps
    if os.environ.get("CMBL_BWD_STATE_DTYPE") == "bf16":
        rnd = lambda x: x.to(torch.bfloat16).to(x.dtype)
    else:
        rnd = lambda x: x

    def integrands(t, f, df):
        px, py = _p_t(t, g, h)
        m11, m12, m22 = _Minv_t(t, h)
        pxe = px[..., None, :, :]
        pye = py[..., None, :, :]
        fx, fy, ddf = _deriv.bwd_stage_derivs(f, pxe * df, pye * df, proj)
        dfdt = pxe * fx + pye * fy
        wx = torch.sum(df * fx, dim=-3)
        wy = torch.sum(df * fy, dim=-3)
        ux = m11 * wx + m12 * wy
        uy = m12 * wx + m22 * wy
        acc = (ux, uy, t * px * ux, t * (py * ux + px * uy), t * py * uy)
        return (dfdt, ddf), acc

    batch = torch.broadcast_shapes(f1.shape[:-3], dy.shape[:-3], g[0].shape[:-2])
    f = rnd(f1.expand(batch + f1.shape[-3:]))
    df = rnd(dy.expand(batch + dy.shape[-3:]))
    zplane = torch.zeros(batch + f1.shape[-2:], dtype=f1.dtype, device=f1.device)
    acc = (zplane,) * 5
    for i in range(nsteps):
        t = t1 + i * hstep
        k1, a1 = integrands(t, f, df)
        k2, a2 = integrands(t + hstep / 2, rnd(f + (hstep / 2) * k1[0]),
                            rnd(df + (hstep / 2) * k1[1]))
        k3, a3 = integrands(t + hstep / 2, rnd(f + (hstep / 2) * k2[0]),
                            rnd(df + (hstep / 2) * k2[1]))
        k4, a4 = integrands(t + hstep, rnd(f + hstep * k3[0]), rnd(df + hstep * k3[1]))
        f = rnd(f + (hstep / 6) * (k1[0] + 2 * (k2[0] + k3[0]) + k4[0]))
        df = rnd(df + (hstep / 6) * (k1[1] + 2 * (k2[1] + k3[1]) + k4[1]))
        acc = tuple(a + (hstep / 6) * (i1 + 2 * (i2 + i3) + i4)
                    for a, i1, i2, i3, i4 in zip(acc, a1, a2, a3, a4))
    dphi = _deriv.div_plus_dij5(*acc, proj)[..., None, :, :]
    return df, dphi


# =========================================================================
# the two flows and the transpose-delta flow, per backend
# =========================================================================

# backend -> (grad/Hess phi, forward/adjoint flow, transpose-delta flow)
_FLOWS = {"kernel": (_lfk.gradhess, _lfk.flow_apply, _lfk.flow_bwd),
          "uni": (_lfk.gradhess, _lfk.uni_flow_apply, _lfk.uni_flow_bwd),
          "matmul": (_lfk.gradhess_plain, _lfk.flow_apply_plain, _lfk.flow_bwd_plain)}


def _apply(phi_map, f_map, t0, t1, nsteps, proj, backend, precision=None, kind="forward"):
    """Forward flow t0 -> t1, or (kind='adjoint') the adjoint flow
    t1 -> t0, the matmul flows at `precision` (None: the one in force)."""
    if backend in _FLOWS:
        gradhess, flow, _ = _FLOWS[backend]
        mats = _deriv.deriv_ops(proj)
        phi = gradhess(phi_map, mats, precision)
        if kind == "forward":
            return flow(f_map, phi, mats, t0, t1, nsteps, "forward", precision)
        return flow(f_map, phi, mats, t1, t0, nsteps, "adjoint", precision)
    g, h = _gradhess_phi(phi_map, proj)
    if kind == "forward":
        return _rk4(lambda t, y: _velocity(t, y, g, h, proj), f_map, t0, t1, nsteps)
    return _rk4(lambda t, y: _velocity_adj(t, y, g, h, proj), f_map, t1, t0, nsteps)


def _bwd(phi_map, f1, dy, t0, t1, nsteps, proj, backend, precision=None):
    """Continuous adjoint of the forward flow t0 -> t1: integrate the
    coupled (f, delta f, delta phi) system from (f(t1), dy, 0) back to
    t0, the matmul flows at `precision`. Returns (dphi, df0)."""
    dy = dy.contiguous()
    if backend in _FLOWS:
        gradhess, _, flow = _FLOWS[backend]
        mats = _deriv.deriv_ops(proj)
        phi = gradhess(phi_map, mats, precision)
        return flow(dy, f1, phi, mats, t0, t1, nsteps, precision)
    g, h = _gradhess_phi(phi_map, proj)
    df0, dphi = _backward_flow_scan(f1, dy, g, h, proj, t1, t0, nsteps)
    return dphi, df0


class _LenseflowApply(torch.autograd.Function):
    """out = flow of f_map from t0 to t1 under phi; the VJP is the
    transpose-delta flow, at the precision the forward ran at (ctx.args:
    backward may be called outside the caller's precision_ctx)."""

    @staticmethod
    def forward(ctx, phi_map, f_map, t0, t1, nsteps, proj, backend, precision):
        out = _apply(phi_map, f_map, t0, t1, nsteps, proj, backend, precision)
        ctx.save_for_backward(phi_map, out)
        ctx.args = (t0, t1, nsteps, proj, backend, precision)
        return out

    @staticmethod
    def backward(ctx, dy):
        phi_map, f1 = ctx.saved_tensors
        dphi, df0 = _bwd(phi_map, f1, dy, *ctx.args)
        return dphi, df0, None, None, None, None, None, None


class _LenseflowApplyAdjoint(torch.autograd.Function):
    """out = L(phi)^H f_map (the adjoint flow from t1 to t0). Its VJP
    follows <u, L^H f> = <L u, f>: the f-cotangent is the forward apply
    of u, and the phi-cotangent is the transpose-delta flow with primal
    L u and cotangent f."""

    @staticmethod
    def forward(ctx, phi_map, f_map, t0, t1, nsteps, proj, backend, precision):
        out = _apply(phi_map, f_map, t0, t1, nsteps, proj, backend, precision, kind="adjoint")
        ctx.save_for_backward(phi_map, f_map)
        ctx.args = (t0, t1, nsteps, proj, backend, precision)
        return out

    @staticmethod
    def backward(ctx, u):
        phi_map, f_map = ctx.saved_tensors
        t0, t1, nsteps, proj, backend, precision = ctx.args
        Lu = _apply(phi_map, u.contiguous(), t0, t1, nsteps, proj, backend, precision)
        dphi, _ = _bwd(phi_map, Lu, f_map, *ctx.args)
        return dphi, Lu, None, None, None, None, None, None


# =========================================================================
# public operator
# =========================================================================

class LenseFlow:
    """LenseFlow lensing operator L(phi).

    L @ f          lense (t: 0 -> 1)
    L.solve(f)     inverse lense (t: 1 -> 0)
    L.H @ f        adjoint
    L.H.solve(f)   inverse adjoint
    """

    __slots__ = ("phi", "nsteps", "t0", "t1", "_adjoint")

    def __init__(self, phi: Field, nsteps: int = 7, t0=0.0, t1=1.0, _adjoint=False):
        self.phi = phi
        self.nsteps = nsteps
        self.t0 = t0
        self.t1 = t1
        self._adjoint = _adjoint

    def __call__(self, phi_or_theta):
        """L(phi') re-binds phi; L(theta-dict) is a no-op."""
        if isinstance(phi_or_theta, Field):
            return LenseFlow(phi_or_theta, self.nsteps, self.t0, self.t1, self._adjoint)
        return self

    @property
    def H(self):
        return LenseFlow(self.phi, self.nsteps, self.t0, self.t1, not self._adjoint)

    def _go(self, f: Field, t0, t1):
        B = f.basis
        fl = f.to(lense_basis(B))
        phi_map = self.phi.to(self.phi.basis.with_space("map")).arr
        farr = fl.arr
        # broadcast phi and f to a common batch OUTSIDE the autograd
        # Function, so that autograd sums the cotangents over the
        # broadcast axes
        if phi_map.shape[:-3] != farr.shape[:-3]:
            batch = torch.broadcast_shapes(phi_map.shape[:-3], farr.shape[:-3])
            phi_map = phi_map.expand(batch + phi_map.shape[-3:])
            farr = farr.expand(batch + farr.shape[-3:])
        fn = _LenseflowApplyAdjoint if self._adjoint else _LenseflowApply
        out = fn.apply(phi_map, farr, float(t0), float(t1), int(self.nsteps), f.proj,
                       _BACKEND, _deriv.matmul_precision())
        return Field(out, fl.basis, f.proj).to(B)

    def __matmul__(self, f: Field) -> Field:
        return self._go(f, self.t0, self.t1)

    def solve(self, f: Field) -> Field:
        return self._go(f, self.t1, self.t0)

    def __repr__(self):
        return f"LenseFlow(nsteps={self.nsteps}{', adjoint' if self._adjoint else ''})"



def lense(phi: Field, f: Field, nsteps: int = 7) -> Field:
    """f lensed by phi: LenseFlow(phi, nsteps) @ f."""
    return LenseFlow(phi, nsteps) @ f


def _hessian_planes(phi: Field):
    """(phi_xx, phi_xy, phi_yy) of a spin-0 phi as float64 map tensors, by
    Fourier derivatives on the whole lx, ly grids (Nyquist lines included,
    as the JAX package's core/ops.py::gradhess)."""
    proj = phi.proj
    arr = phi.to(phi.basis.with_space("map")).arr.double()
    F = torch.fft.rfft2(arr)
    ilx = torch.as_tensor(1j * proj.lx.astype(np.float64), device=F.device)[None, :]
    ily = torch.as_tensor(1j * proj.ly.astype(np.float64), device=F.device)[:, None]
    gx, gy = F * ilx, F * ily
    return tuple(torch.fft.irfft2(h, s=(proj.Ny, proj.Nx)) for h in (gx * ilx, gx * ily, gy * ily))


def get_max_lensing_step(phi: Field, eta: Field):
    """The largest alpha for which I + Hess(phi + alpha eta) keeps a
    positive determinant everywhere (the weak-lensing guard of reference
    src/lenseflow.jl:232-256): the least positive root, over the pixels, of
    det(I + Hess phi + alpha Hess eta) = a alpha^2 + b alpha + c, a 0-d
    tensor in phi's precision (inf when no root is positive). The planes
    and roots are computed in float64: in float32 the FFTs' rounding at
    high l, amplified by l^2 in the Hessians, moves the root by ~3e-5
    relative, and would make the card's and the CPU's answers differ by
    as much."""
    pxx, pxy, pyy = _hessian_planes(phi)
    exx, exy, eyy = _hessian_planes(eta)
    a = exx * eyy - exy ** 2
    b = exx * (1 + pyy) + eyy * (1 + pxx) - 2 * exy * pxy
    c = (1 + pxx) * (1 + pyy) - pxy ** 2
    disc = torch.sqrt(b ** 2 - 4 * a * c)
    big = torch.tensor(float("inf"), dtype=a.dtype, device=a.device)
    pos_min = lambda x: torch.min(torch.where(x > 0, x, big))
    out = torch.minimum(pos_min((-b + disc) / (2 * a)), pos_min((-b - disc) / (2 * a)))
    return out.to(phi.dtype)
