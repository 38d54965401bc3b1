"""LenseFlow flows on the hand-written Hopper kernels, and their plain
PyTorch version.

Replaces ``_flow_call`` / ``_flow_kernel`` of
``cmblensing_tpu/ops/pallas_lenseflow.py`` with dense in-kernel
derivatives (``_make_ddx_ddy``), the form that runs at 256^2. Three
flows, as there:

  forward   df/dt = p(t) . grad f
  adjoint   df/dt = div(p(t) f)
  backward  the coupled (f, delta f, delta phi) transpose-delta flow,
            with the delta-phi derivatives hoisted out of the time loop
            (see csrc/lenseflow.cu for why)

A flow is a host loop of 4*nsteps RK4 stages over three leaf operations:
a velocity evaluation, an RK4 accumulator update and a derivative
``d_x a + d_y b + c``. Each leaf has a CUDA kernel (csrc/lenseflow.cu,
built by ops/_build.py) and a plain PyTorch version (dense circulant
products with torch.matmul, same stage order). The public functions
take the plain version for a CPU tensor and launch the kernel for a
CUDA tensor, or raise; the ``*_plain`` functions run the plain version
on any device, for comparing the two on the card.

phi enters as a (5, Ny, Nx) tensor of planes (gx, gy, hxx, hxy, hyy);
mats is (DxT, Dy) from ops/deriv.py::deriv_mats.
"""
from __future__ import annotations

import ctypes

import torch

TILE = 16
KINDS = {"forward": 0, "adjoint": 1, "backward": 2}
NACC = 5   # delta-phi accumulator planes carried by the backward flow

# kernel launches per kernel, counted where each wrapper launches
LAUNCHES = {"velocity_forward": 0, "velocity_adjoint": 0, "velocity_backward": 0,
            "rk4_update": 0, "deriv": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# =========================================================================
# plain PyTorch leaves
# =========================================================================

def _p_of_t(t, phi):
    gx, gy, hxx, hxy, hyy = phi
    a = 1.0 + t * hxx
    b = t * hxy
    d = 1.0 + t * hyy
    idet = 1.0 / (a * d - b * b)
    return (d * gx - b * gy) * idet, (-b * gx + a * gy) * idet


def _minv_of_t(t, phi):
    _, _, hxx, hxy, hyy = phi
    a = 1.0 + t * hxx
    b = t * hxy
    d = 1.0 + t * hyy
    idet = 1.0 / (a * d - b * b)
    return d * idet, -b * idet, a * idet


def velocity_plain(kind, y, k, phi, DxT, Dy, ncomp, t):
    """k <- the velocity of flow `kind` at state y, time t."""
    px, py = _p_of_t(t, phi)
    if kind == "forward":
        k.copy_(px * (y @ DxT) + py * (Dy @ y))
    elif kind == "adjoint":
        k.copy_((px * y) @ DxT + Dy @ (py * y))
    elif kind == "backward":
        f, df = y[:ncomp], y[ncomp:2 * ncomp]
        fx, fy = f @ DxT, Dy @ f
        k[:ncomp] = px * fx + py * fy
        k[ncomp:2 * ncomp] = (px * df) @ DxT + Dy @ (py * df)
        wx = torch.sum(df * fx, dim=0)
        wy = torch.sum(df * fy, dim=0)
        m11, m12, m22 = _minv_of_t(t, phi)
        ux = m11 * wx + m12 * wy
        uy = m12 * wx + m22 * wy
        k[2 * ncomp:] = torch.stack([ux, uy, t * px * ux, t * (py * ux + px * uy),
                                     t * py * uy])
    else:
        raise ValueError(kind)


def rk4_update_plain(y, k, acc, s, stage, wacc, ws):
    """Fold RK4 stage `stage` (0-3) into the accumulator, in the order of
    the TPU kernel's `_rk4_steps`."""
    if stage == 0:
        torch.add(y, k, alpha=wacc, out=acc)
        torch.add(y, k, alpha=ws, out=s)
    elif stage < 3:
        acc.add_(k, alpha=wacc)
        torch.add(y, k, alpha=ws, out=s)
    else:
        torch.add(acc, k, alpha=wacc, out=y)


def deriv_plain(a, b, c, out, DxT, Dy):
    """out <- d_x a + d_y b + c (a, b or c may be None)."""
    v = torch.zeros_like(out)
    if a is not None:
        v = v + a @ DxT
    if b is not None:
        v = v + Dy @ b
    if c is not None:
        v = v + c
    out.copy_(v)


# =========================================================================
# CUDA kernel leaves
# =========================================================================

def _check_cuda(name, tensors, Ny, Nx):
    dev = tensors[0].device
    for x in tensors:
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if Ny % TILE or Nx % TILE:
        raise ValueError(f"{name}: Ny={Ny} and Nx={Nx} must be multiples of {TILE}")


def _ptr(x):
    return None if x is None else ctypes.c_void_p(x.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")


def velocity_cuda(kind, y, k, phi, DxT, Dy, ncomp, t):
    from . import _build
    Ny, Nx = y.shape[-2:]
    _check_cuda("lf_velocity", [y, k, phi, DxT, Dy], Ny, Nx)
    if DxT.shape != (Nx, Nx) or Dy.shape != (Ny, Ny) or phi.shape != (5, Ny, Nx):
        raise ValueError("lf_velocity: derivative matrices or phi planes mis-shaped")
    nstate = {"backward": 2 * ncomp + NACC}.get(kind, ncomp)
    if y.shape != (nstate, Ny, Nx) or k.shape != y.shape:
        raise ValueError(f"lf_velocity: state {tuple(y.shape)} does not fit kind {kind}")
    rc = _build.load().lf_velocity(KINDS[kind], _ptr(y), _ptr(k), _ptr(phi), _ptr(DxT),
                                   _ptr(Dy), ncomp, Ny, Nx, float(t), _stream())
    _raise_on(rc, "lf_velocity")
    LAUNCHES["velocity_" + kind] += 1


def rk4_update_cuda(y, k, acc, s, stage, wacc, ws):
    from . import _build
    Ny, Nx = y.shape[-2:]
    _check_cuda("lf_rk4_update", [y, k, acc, s], Ny, Nx)
    if not (y.shape == k.shape == acc.shape == s.shape):
        raise ValueError("lf_rk4_update: shapes differ")
    rc = _build.load().lf_rk4_update(_ptr(y), _ptr(k), _ptr(acc), _ptr(s), y.numel(),
                                     int(stage), float(wacc), float(ws), _stream())
    _raise_on(rc, "lf_rk4_update")
    LAUNCHES["rk4_update"] += 1


def deriv_cuda(a, b, c, out, DxT, Dy):
    from . import _build
    Ny, Nx = out.shape[-2:]
    given = [x for x in (a, b, c) if x is not None]
    _check_cuda("lf_deriv", [out, DxT, Dy, *given], Ny, Nx)
    if any(x.shape != out.shape for x in given):
        raise ValueError("lf_deriv: operand shapes differ from the output's")
    nplanes = out.numel() // (Ny * Nx)
    rc = _build.load().lf_deriv(_ptr(a), _ptr(b), _ptr(c), _ptr(out), _ptr(DxT), _ptr(Dy),
                                nplanes, Ny, Nx, _stream())
    _raise_on(rc, "lf_deriv")
    LAUNCHES["deriv"] += 1


class _Leaves:
    def __init__(self, velocity, rk4_update, deriv):
        self.velocity = velocity
        self.rk4_update = rk4_update
        self.deriv = deriv


PLAIN = _Leaves(velocity_plain, rk4_update_plain, deriv_plain)
KERNEL = _Leaves(velocity_cuda, rk4_update_cuda, deriv_cuda)


def _leaves_for(x):
    """The plain version for a CPU tensor, the kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return PLAIN
    if x.device.type == "cuda":
        return KERNEL
    raise ValueError(f"no LenseFlow kernel for device {x.device}")


# =========================================================================
# flows
# =========================================================================

def _integrate(leaves, kind, y, phi, mats, ncomp, nsteps, t0, t1):
    """Classical RK4 of flow `kind` from t0 to t1 over a (nstate, Ny, Nx)
    state, stages folded into a running accumulator as in `_rk4_steps`."""
    DxT, Dy = mats
    y = y.contiguous().clone()
    k, acc, s = torch.empty_like(y), torch.empty_like(y), torch.empty_like(y)
    h = (t1 - t0) / nsteps
    for i in range(nsteps):
        t = t0 + i * h
        leaves.velocity(kind, y, k, phi, DxT, Dy, ncomp, t)
        leaves.rk4_update(y, k, acc, s, 0, h / 6, h / 2)
        leaves.velocity(kind, s, k, phi, DxT, Dy, ncomp, t + h / 2)
        leaves.rk4_update(y, k, acc, s, 1, h / 3, h / 2)
        leaves.velocity(kind, s, k, phi, DxT, Dy, ncomp, t + h / 2)
        leaves.rk4_update(y, k, acc, s, 2, h / 3, h)
        leaves.velocity(kind, s, k, phi, DxT, Dy, ncomp, t + h)
        leaves.rk4_update(y, k, acc, s, 3, h / 6, 0.0)
    return y


def _per_batch(fn, *xs):
    """Run fn over the flattened leading batch axes of its tensor
    arguments (already broadcast to one batch shape)."""
    lead = xs[0].shape[:-3]
    if not lead:
        return fn(*xs)
    flat = [x.reshape((-1,) + tuple(x.shape[-3:])) for x in xs]
    outs = [fn(*(x[b] for x in flat)) for b in range(flat[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o).reshape(lead + o[0].shape) for o in zip(*outs))
    return torch.stack(outs).reshape(lead + outs[0].shape)


def _gradhess(leaves, phi_map, mats):
    """(5, Ny, Nx) planes (gx, gy, hxx, hxy, hyy) of a (1, Ny, Nx) map.
    The Hessian is two first-derivative products: in float32 that is as
    accurate as the FFT and more accurate than the dense second-derivative
    circulant, whose entries of order l_max^2 cancel."""
    DxT, Dy = mats
    p = phi_map.contiguous()
    out = torch.empty((5,) + tuple(p.shape[-2:]), dtype=p.dtype, device=p.device)
    gx, gy = out[0:1], out[1:2]
    leaves.deriv(p, None, None, gx, DxT, Dy)
    leaves.deriv(None, p, None, gy, DxT, Dy)
    leaves.deriv(gx, None, None, out[2:3], DxT, Dy)
    leaves.deriv(None, gx, None, out[3:4], DxT, Dy)
    leaves.deriv(None, gy, None, out[4:5], DxT, Dy)
    return out


def _flow_apply(leaves, f_map, phi, mats, t0, t1, nsteps, kind):
    return _per_batch(
        lambda f, p: _integrate(leaves, kind, f, p, mats, f.shape[0], int(nsteps),
                                float(t0), float(t1)),
        f_map, phi)


def _flow_bwd(leaves, dy, f1, phi, mats, t0, t1, nsteps):
    DxT, Dy = mats

    def one(dy, f1, p):
        ncomp = f1.shape[0]
        zero = torch.zeros((NACC,) + tuple(f1.shape[-2:]), dtype=f1.dtype, device=f1.device)
        state = torch.cat([f1, dy, zero], dim=0)
        y = _integrate(leaves, "backward", state, p, mats, ncomp, int(nsteps),
                       float(t1), float(t0))
        ux, uy, sxx, sxy, syy = (y[2 * ncomp + i:2 * ncomp + i + 1] for i in range(NACC))
        X, Y, dphi = torch.empty_like(ux), torch.empty_like(ux), torch.empty_like(ux)
        leaves.deriv(sxx, sxy, ux, X, DxT, Dy)     # u_x + d_x s_xx + d_y s_xy
        leaves.deriv(None, syy, uy, Y, DxT, Dy)    # u_y + d_y s_yy
        leaves.deriv(X, Y, None, dphi, DxT, Dy)
        return dphi, y[ncomp:2 * ncomp].clone()

    return _per_batch(one, dy, f1, phi)


def gradhess(phi_map, mats):
    """(..., 5, Ny, Nx) planes (gx, gy, hxx, hxy, hyy) of a (..., 1, Ny,
    Nx) map through the derivative kernel (plain version on the CPU)."""
    leaves = _leaves_for(phi_map)
    return _per_batch(lambda p: _gradhess(leaves, p, mats), phi_map)


def flow_apply(f_map, phi, mats, t0, t1, nsteps, kind="forward"):
    """Integrate the forward or adjoint flow of the (..., ncomp, Ny, Nx)
    map f_map from t0 to t1; phi (..., 5, Ny, Nx) from `gradhess`."""
    if kind not in ("forward", "adjoint"):
        raise ValueError(kind)
    return _flow_apply(_leaves_for(f_map), f_map, phi, mats, t0, t1, nsteps, kind)


def flow_bwd(dy, f1, phi, mats, t0, t1, nsteps):
    """Integrate the transpose-delta system from t1 back to t0, starting
    at (f1, dy, 0); returns (dphi (..., 1, Ny, Nx), df0)."""
    return _flow_bwd(_leaves_for(f1), dy, f1, phi, mats, t0, t1, nsteps)


def gradhess_plain(phi_map, mats):
    return _per_batch(lambda p: _gradhess(PLAIN, p, mats), phi_map)


def flow_apply_plain(f_map, phi, mats, t0, t1, nsteps, kind="forward"):
    return _flow_apply(PLAIN, f_map, phi, mats, t0, t1, nsteps, kind)


def flow_bwd_plain(dy, f1, phi, mats, t0, t1, nsteps):
    return _flow_bwd(PLAIN, dy, f1, phi, mats, t0, t1, nsteps)
