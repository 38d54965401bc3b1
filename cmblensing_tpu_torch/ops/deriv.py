"""Spectral derivatives on the flat torus.

Counterpart of ``cmblensing_tpu/ops/deriv.py``. Three forms of the same
linear operator:

  fft      — rfft2 -> (i l) multiply -> irfft2 on ``torch.fft``: the
             plain LenseFlow backend's derivatives (functions below).
  dense    — real n x n circulant matrices (``_deriv_matrix``):
                 d/dx f = f @ Dx^T ,  d/dy f = Dy @ f
             the operands of the dense flow kernels
             (ops/lenseflow_kernels.py) and their plain version.
  factored — the same circulants block-diagonalized at radix B
             (ops/factored_deriv.py), the operands of the factored flow
             kernels where a radix pays (``deriv_ops``).

All zero the Nyquist line of the first derivative (an odd operator:
the self-aliased Nyquist mode's derivative is identically zero), so the
forms are the same operator.

The dense and factored products run at the matmul precision in force
(``set_matmul_precision``, ``precision_ctx``), as the JAX package's do:
'f32' strict float32 (the default); 'high' the bf16 head/residual split,
three bf16 x bf16 products summed in float32; 'bf16' one product of the
operands rounded to bf16, summed in float32 (~1e-3 relative).
The FFT forms ignore it. The switch touches neither TF32 pin of
``torch.backends``.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import fft as _fft
from .factored_deriv import FactoredOps, apply_x, apply_y, dot_bf16, dot_high, factored_ops

# Block size of the factored derivative. Provisional rule, to be set
# from H100 measurements: radix B = n / FACTOR_A where that is a radix the
# factored kernels are built for, else the dense circulant.
FACTOR_A = 128
# The radices the factored kernels are built for (csrc/fact_sm90.cuh::
# sm90_radix; fact_tile at 4 and 8): 512^2 to 4096^2. The kernel wrappers refuse any
# other (ops/lenseflow_kernels.py::_check_factored).
BUILT_RADICES = (4, 8, 16, 32)


def radix_groups(B: int) -> int:
    """The channel groups fact_tile's block would hold at radix B
    (csrc/fact_tile.cuh::tile_groups: at most 8 channels a block): one at
    radix 4 and 8, the only radices a kernel runs fact_tile at
    (ops/lenseflow_kernels.py::FORMS); at 16 and 32 every kernel runs the
    cluster tile (csrc/fact_sm90.cuh), whose channel groups are the CTAs of
    one cluster, one launch a pass (pass_launches)."""
    return max(1, B // 8)


PRECISIONS = ("f32", "high", "bf16")
_PRECISION = "f32"


def set_matmul_precision(p):
    """The precision of the circulant-derivative products: 'f32',
    'high' or 'bf16' (see the module docstring)."""
    global _PRECISION
    if p not in PRECISIONS:
        raise ValueError(f"matmul precision {p!r}: one of {PRECISIONS}")
    _PRECISION = p


def matmul_precision():
    """The precision in force (what the LenseFlow flows read)."""
    return _PRECISION


@contextlib.contextmanager
def precision_ctx(p):
    """Run the block at matmul precision p, then restore the previous one."""
    prev = _PRECISION
    set_matmul_precision(p)
    try:
        yield
    finally:
        set_matmul_precision(prev)


def radix(n: int) -> int:
    """Radix B of the factored derivative along an axis of length n: n /
    FACTOR_A where that is one of BUILT_RADICES, else 1, the dense
    circulant (which takes any n)."""
    B, r = divmod(n, FACTOR_A)
    return B if r == 0 and B in BUILT_RADICES else 1


def deriv_ops(proj):
    """The flow kernels' derivative operands for `proj`: packed
    FactoredOps where a radix pays along both axes, else the dense
    (DxT, Dy) of `deriv_mats`."""
    Bx, By = radix(proj.Nx), radix(proj.Ny)
    if Bx > 1 and By > 1:
        return factored_ops(proj, Bx, By)
    return deriv_mats(proj)


def _deriv_matrix(n: int, delta: float, dtype_str: str):
    """Real n x n circulant matrix D applying d/dx along an axis with
    grid spacing delta (D[:, j] = derivative of e_j), Nyquist zeroed."""
    lx_full = np.fft.fftfreq(n, d=delta) * 2 * np.pi
    if n % 2 == 0:
        lx_full[n // 2] = 0.0
    F = np.fft.fft(np.eye(n), axis=0)
    return np.real(np.fft.ifft((1j * lx_full)[:, None] * F, axis=0)).astype(np.dtype(dtype_str))


def deriv_mats(proj):
    """(DxT, Dy) first-derivative circulants on the projection's device:
    d/dx a = a @ DxT, d/dy a = Dy @ a."""
    key = "_deriv_mats"
    m = proj._tensors.get(key)
    if m is None:
        d = float(proj.deltax)
        Dx1 = _deriv_matrix(proj.Nx, d, proj.T.str)
        Dy1 = _deriv_matrix(proj.Ny, d, proj.T.str)
        m = (torch.as_tensor(np.ascontiguousarray(Dx1.T), device=proj.device),
             torch.as_tensor(np.ascontiguousarray(Dy1), device=proj.device))
        proj._tensors[key] = m
    return m


def ddx_ddy(mats, precision="f32"):
    """(d/dx, d/dy) over (..., Ny, Nx) planes through the kernels'
    operands, dense (DxT, Dy) circulants or FactoredOps, at 'f32', 'high'
    or 'bf16'."""
    if precision not in PRECISIONS:
        raise ValueError(f"derivative products at {precision!r}: one of {PRECISIONS}")
    if isinstance(mats, FactoredOps):
        if precision != "f32" and mats.FXS is None:
            raise ValueError(f"{precision!r} factored derivatives need the split blocks "
                             "(FactoredOps.FXS, FYTS) that factored_ops makes")
        FXS, FYS = ((mats.FXS, mats.FYTS.transpose(-1, -2)) if precision != "f32"
                    else (None, None))
        return ((lambda a: apply_x(a, mats.FX, mats.bfx, FXS, precision)),
                (lambda a: apply_y(a, mats.FY, mats.bfy, FYS, precision)))
    DxT, Dy = mats
    if precision == "high":
        return (lambda a: dot_high(DxT, a, True)), (lambda a: dot_high(Dy, a, False))
    if precision == "bf16":
        return (lambda a: dot_bf16(DxT, a, True)), (lambda a: dot_bf16(Dy, a, False))
    return (lambda a: a @ DxT), (lambda a: Dy @ a)


def _grids(proj):
    """(i lx) of shape (1, Nx//2+1) and (i ly) of shape (Ny, 1), Nyquist
    lines zeroed, on the projection's device."""
    key = "_deriv_grids"
    g = proj._tensors.get(key)
    if g is None:
        lx = np.asarray(proj.lx, dtype=np.float64).copy()
        ly = np.asarray(proj.ly, dtype=np.float64).copy()
        if proj.Nx % 2 == 0:
            lx[-1] = 0.0
        if proj.Ny % 2 == 0:
            ly[proj.Ny // 2] = 0.0
        cdt = proj.complex_T
        g = (torch.as_tensor((1j * lx).astype(cdt)[None, :], device=proj.device),
             torch.as_tensor((1j * ly).astype(cdt)[:, None], device=proj.device))
        proj._tensors[key] = g
    return g


# --- public primitives (operate on (..., ncomp, Ny, Nx) map tensors) -----

def grad_xy(f_map, proj):
    """(df/dx, df/dy) of each component."""
    ilx, ily = _grids(proj)
    F = _fft.rfft2(f_map)
    out = _fft.irfft2(torch.cat([F * ilx, F * ily], dim=-3), proj.Nx)
    n = f_map.shape[-3]
    return out[..., :n, :, :], out[..., n:, :, :]


def div_xy(vx, vy, proj):
    """d/dx vx + d/dy vy."""
    ilx, ily = _grids(proj)
    V = _fft.rfft2(torch.cat([vx, vy], dim=-3))
    n = vx.shape[-3]
    return _fft.irfft2(V[..., :n, :, :] * ilx + V[..., n:, :, :] * ily, proj.Nx)


def gradhess(phi_map, proj):
    """((gx, gy), (hxx, hxy, hyy)) of a (..., 1, Ny, Nx) map, each
    (..., Ny, Nx)."""
    ilx, ily = _grids(proj)
    PHI = _fft.rfft2(phi_map)
    gx_f = PHI * ilx
    gy_f = PHI * ily
    out = _fft.irfft2(torch.cat([gx_f, gy_f, gx_f * ilx, gx_f * ily, gy_f * ily], dim=-3),
                      proj.Nx)
    gx, gy, hxx, hxy, hyy = (out[..., i, :, :] for i in range(5))
    return (gx, gy), (hxx, hxy, hyy)


def div_plus_dij5(ux, uy, sxx, sxy, syy, proj):
    """d_x ux + d_y uy + d_x d_x sxx + d_x d_y sxy + d_y d_y syy for
    (..., Ny, Nx) planes: the delta-phi of the LenseFlow backward flow
    from its five accumulated integrands (sxy holds s_yx + s_xy, which
    only ever enter through the commuting d_x d_y)."""
    ilx, ily = _grids(proj)
    S = _fft.rfft2(torch.stack([ux, uy, sxx, sxy, syy], dim=-3))
    D = (S[..., 0, :, :] * ilx + S[..., 1, :, :] * ily + S[..., 2, :, :] * ilx * ilx
         + S[..., 3, :, :] * ilx * ily + S[..., 4, :, :] * ily * ily)
    return _fft.irfft2(D, proj.Nx)


def bwd_stage_derivs(f, pxdf, pydf, proj):
    """The derivative bundle of one backward-flow velocity:
    (fx, fy, ddf) = (d_x f, d_y f, d_x pxdf + d_y pydf) for (..., ncomp,
    Ny, Nx) stacks, as one rfft2/irfft2 pair."""
    n = f.shape[-3]
    ilx, ily = _grids(proj)
    F = _fft.rfft2(torch.cat([f, pxdf, pydf], dim=-3))
    Ff = F[..., :n, :, :]
    out = torch.cat([Ff * ilx, Ff * ily,
                     F[..., n:2 * n, :, :] * ilx + F[..., 2 * n:, :, :] * ily], dim=-3)
    o = _fft.irfft2(out, proj.Nx)
    return o[..., :n, :, :], o[..., n:2 * n, :, :], o[..., 2 * n:, :, :]


def dij_sum(s, proj, mats=None):
    """sum_ij d_i d_j s_ij for s stacked (..., 4, Ny, Nx) in the order
    (xx, yx, xy, yy): s[0] takes d_x d_x, s[1] d_x d_y, s[2] d_y d_x,
    s[3] d_y d_y. Returns (..., 1, Ny, Nx). With `mats` (dense or
    factored) the derivatives are their products, else FFTs on `proj`."""
    if mats is not None:
        dx, dy = ddx_ddy(mats)
        s0, s1, s2, s3 = s.unbind(-3)
        return (dx(dx(s0)) + dx(dy(s1)) + dy(dx(s2)) + dy(dy(s3)))[..., None, :, :]
    ilx, ily = _grids(proj)
    S = _fft.rfft2(s)
    D = (S[..., 0, :, :] * ilx * ilx + S[..., 1, :, :] * ilx * ily
         + S[..., 2, :, :] * ily * ilx + S[..., 3, :, :] * ily * ily)
    return _fft.irfft2(D[..., None, :, :], proj.Nx)


def div_plus_dij(ux, uy, s0, s1, s2, s3, proj, mats=None):
    """d_x ux + d_y uy + sum_ij d_i d_j s_ij for (..., Ny, Nx) planes, s
    in the order of `dij_sum`: the delta-phi velocity of the LenseFlow
    backward flow. With `mats` (dense or factored; `proj` unused) it is
    regrouped into 6 derivative products,

        d_x(ux + d_x s0 + d_y s1) + d_y(uy + d_x s2 + d_y s3),

    the plain version of the universal kernel's role 1; else one FFT
    pair on `proj`."""
    if mats is not None:
        dx, dy = ddx_ddy(mats)
        return dx(ux + dx(s0) + dy(s1)) + dy(uy + dx(s2) + dy(s3))
    ilx, ily = _grids(proj)
    S = _fft.rfft2(torch.stack([ux, uy, s0, s1, s2, s3], dim=-3))
    D = (S[..., 0, :, :] * ilx + S[..., 1, :, :] * ily + S[..., 2, :, :] * ilx * ilx
         + S[..., 3, :, :] * ilx * ily + S[..., 4, :, :] * ily * ilx
         + S[..., 5, :, :] * ily * ily)
    return _fft.irfft2(D, proj.Nx)
