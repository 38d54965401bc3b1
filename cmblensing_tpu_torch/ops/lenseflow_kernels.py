"""LenseFlow flows on the hand-written Hopper kernels, and their plain
PyTorch version.

Two kernel families, chosen by the derivative operands the flow is
given (``ops/deriv.py::deriv_ops``), and a third granularity that the
'uni' LenseFlow backend picks (``uni_flow_*``):

  dense     (DxT, Dy) circulants: csrc/lenseflow.cu, replacing
            ``_flow_call`` / ``_flow_kernel`` of
            ``cmblensing_tpu/ops/pallas_lenseflow.py`` with the dense
            in-kernel derivatives (``_make_ddx_ddy``), the form that runs
            at 256^2. A batched flow loops over its batch entries.
  factored  FactoredOps (ops/factored_deriv.py), where a radix pays
            (512^2 and up): csrc/factored.cu, replacing ``_fa_kernel``
            (forward/adjoint velocity), ``_bv_kernel`` (backward velocity)
            and the factored derivative ``_fact_apply``. Batch x
            component rides on the kernels' grid, so a batched flow is
            one launch per pass.
  uni       the per-velocity "uni" granularity of ``_uni_call``: every
            velocity of every flow as calls of the universal role-switched
            kernel ``_bwdAB_kernel`` (K5: csrc/uni.cu on factored operands
            at every built radix, csrc/uni_dense.cu on dense ones at any
            plane shape), with M^-1(t) and u = M^-1 w as torch elementwise
            glue, and the backward flow carrying delta phi in its state,
            not hoisted. Batch x entry rides on K5's grid in either form.

Three flows, as there:

  forward   df/dt = p(t) . grad f
  adjoint   df/dt = div(p(t) f)
  backward  the coupled (f, delta f, delta phi) transpose-delta flow,
            with the delta-phi derivatives hoisted out of the time loop
            (see csrc/lenseflow.cu for why)

A flow is a host loop of 4*nsteps RK4 stages over four leaf operations:
the planes of p(t) = (I + t Hess phi)^-1 grad phi (formed once for each
of the flow's 2*nsteps + 1 distinct times, not once per velocity: the two
middle stages of a step share their time, and a step's last time is the
next one's first), a velocity evaluation at those planes, an RK4
accumulator update and a derivative ``d_x a + d_y b + c``. Each leaf has
a CUDA kernel (csrc/, built by
ops/_build.py) and a plain PyTorch version (the same circulant products
with torch.matmul, dense or factored, same stage order). The public
functions take the plain version for a CPU tensor and launch the kernel
for a CUDA tensor, or raise; the ``*_plain`` functions run the plain
version on any device, for comparing the two on the card. Each kernel
wrapper is a launcher maker (``*_launcher``: checks and pointer
conversions, once) and a call of the launcher it returns; a flow makes
its launchers once and calls them at every stage.

phi enters as a (..., 5, Ny, Nx) tensor of planes (gx, gy, hxx, hxy,
hyy), p(t) as pt, (2, ..., Ny, Nx) planes (p_x, p_y); mats is what
ops/deriv.py::deriv_ops returns.

Precision: the public flows and `gradhess` run at the matmul precision
in force (ops/deriv.py) unless given one. 'f32' is the kernels above;
'high' (the JAX package's bf16 head/residual split, `_mk_dot('high')` /
`_make_ddx_ddy` 'high') and 'bf16' (one product of the operands rounded
to bf16, `_mk_dot('bf16')` / `_make_ddx_ddy` 'bf16') run the kernels'
tensor-core tiers (the `tier` argument, the index in PRECISIONS, of
lf_velocity and lf_deriv, csrc/lenseflow.cu, of lf_fderiv,
lf_fa_velocity and lf_bv_velocity, csrc/factored.cu, and of
lf_uni_velocity and lf_uni_dense_velocity, K5) and, for a CPU tensor,
the plain leaves at that precision, dense or factored; at 'bf16' phi's
planes are formed strict (PLANES_PRECISION). The uni granularity runs
every tier, dense and at every built radix. The factored kernels run
one of two tiles, as FORMS names it for each kernel, tier and radix: the
cluster tile (csrc/fact_sm90.cuh; every kernel at radix 16 and 32) or
fact_tile (csrc/fact_tile.cuh; radix 4 and 8 only); either takes one
launch a pass (pass_launches).

The dense kernels take any plane shape (their edge tiles are guarded);
the factored ones a radix they are built for (ops/deriv.py::deriv_ops).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import deriv as _deriv
from .deriv import BUILT_RADICES, FACTOR_A
from .factored_deriv import FactoredOps, fyt, split_bf16

KINDS = {"forward": 0, "adjoint": 1, "backward": 2}
ROLES = {"forward": 0, "adjoint": 1}   # the factored kernel's role argument
ROLES_UNI = {"forward": 2, "adjoint": 3}   # the universal kernel's roles for the applies
NACC = 5   # delta-phi accumulator planes carried by the backward flow
CUDA_ERROR_INVALID_VALUE = 1   # what a kernel's C entry returns for arguments it does not take

# kernel launches per kernel, counted where each wrapper launches (the
# factored velocities launch twice per call, an x pass and a y pass;
# pass_launches says how many launches a pass takes)
LAUNCHES = {"velocity_forward": 0, "velocity_adjoint": 0, "velocity_backward": 0,
            "rk4_update": 0, "p_planes": 0, "deriv": 0, "fderiv": 0, "fa_velocity_forward": 0,
            "fa_velocity_adjoint": 0, "bv_velocity": 0, "fderiv_high": 0,
            "fa_velocity_forward_high": 0,
            "fa_velocity_adjoint_high": 0, "bv_velocity_high": 0, "velocity_forward_high": 0,
            "velocity_adjoint_high": 0, "velocity_backward_high": 0, "deriv_high": 0,
            "fderiv_bf16": 0, "fa_velocity_forward_bf16": 0, "fa_velocity_adjoint_bf16": 0,
            "bv_velocity_bf16": 0, "velocity_forward_bf16": 0, "velocity_adjoint_bf16": 0,
            "velocity_backward_bf16": 0, "deriv_bf16": 0}
# K5 at every tier, factored (uni_role*: two passes a call, four for role
# 1, pass_launches each) and dense (uni_dense_role*: one launch a call,
# two for role 1)
LAUNCHES.update({f"uni{form}_role{r}{sfx}": 0 for form in ("", "_dense") for r in range(4)
                 for sfx in ("", "_high", "_bf16")})
# the tiers the flows are ported at, in the order of the C entries' `tier`
# argument (csrc/lenseflow_common.cuh::Tier)
PRECISIONS = ("f32", "high", "bf16")


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# =========================================================================
# plain PyTorch leaves
# =========================================================================

def _p_of_t(t, phi):
    gx, gy, hxx, hxy, hyy = phi.unbind(-3)
    a = 1.0 + t * hxx
    b = t * hxy
    d = 1.0 + t * hyy
    idet = 1.0 / (a * d - b * b)
    return (d * gx - b * gy) * idet, (-b * gx + a * gy) * idet


def _minv_of_t(t, phi):
    _, _, hxx, hxy, hyy = phi.unbind(-3)
    a = 1.0 + t * hxx
    b = t * hxy
    d = 1.0 + t * hyy
    idet = 1.0 / (a * d - b * b)
    return d * idet, -b * idet, a * idet


def p_planes_plain(t, phi, out):
    """out (2, ..., Ny, Nx) <- the planes (p_x, p_y) of p(t) from phi
    (..., 5, Ny, Nx)."""
    px, py = _p_of_t(t, phi)
    out[0].copy_(px)
    out[1].copy_(py)


def velocity_plain(kind, y, k, phi, pt, mats, ncomp, t, precision="f32"):
    """k <- the velocity of flow `kind` at state y (..., nstate, Ny, Nx),
    time t, phi (..., 5, Ny, Nx), pt its p(t) planes (2, ..., Ny, Nx);
    dense (DxT, Dy) or factored operands, derivatives at `precision`."""
    dx, dy = _deriv.ddx_ddy(mats, precision)
    px, py = pt[0].unsqueeze(-3), pt[1].unsqueeze(-3)
    if kind == "forward":
        k.copy_(px * dx(y) + py * dy(y))
    elif kind == "adjoint":
        k.copy_(dx(px * y) + dy(py * y))
    elif kind == "backward":
        f, df = y[..., :ncomp, :, :], y[..., ncomp:2 * ncomp, :, :]
        fx, fy = dx(f), dy(f)
        k[..., :ncomp, :, :] = px * fx + py * fy
        k[..., ncomp:2 * ncomp, :, :] = dx(px * df) + dy(py * df)
        wx = torch.sum(df * fx, dim=-3)
        wy = torch.sum(df * fy, dim=-3)
        m11, m12, m22 = _minv_of_t(t, phi)
        px, py = px.squeeze(-3), py.squeeze(-3)
        ux = m11 * wx + m12 * wy
        uy = m12 * wx + m22 * wy
        k[..., 2 * ncomp:, :, :] = torch.stack(
            [ux, uy, t * px * ux, t * (py * ux + px * uy), t * py * uy], dim=-3)
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


def deriv_plain(a, b, c, out, mats, precision="f32"):
    """out <- d_x a + d_y b + c (a, b or c may be None), dense or
    factored, at `precision`."""
    dx, dy = _deriv.ddx_ddy(mats, precision)
    v = torch.zeros_like(out)
    if a is not None:
        v = v + dx(a)
    if b is not None:
        v = v + dy(b)
    if c is not None:
        v = v + c
    out.copy_(v)


# the factored leaves' plain versions: the same functions (batched state)
fvelocity_plain, fderiv_plain = velocity_plain, deriv_plain


def uni_velocity_plain(role, a, b, px, py, out, mats, t, precision="f32"):
    """out <- what the universal kernel `_bwdAB_kernel` writes for `role`
    (csrc/uni.cu, csrc/uni_dense.cu), dense or factored, its derivatives
    at `precision`: a, b (..., Ny, Nx) operands, px, py p(t) planes
    broadcastable to them, out (..., 4, Ny, Nx). Role 1 nests its
    derivatives as the kernel does, d_x(a + d_x(t px a) + d_y(t py a)) +
    d_y(b + ...): six products, each operand rounded at the tier, the
    outer ones the rounded sums."""
    dx, dy = _deriv.ddx_ddy(mats, precision)
    zero = torch.zeros_like(a)
    if role == 0:
        fx, fy = dx(a), dy(a)
        planes = (px * fx + py * fy, dx(px * b) + dy(py * b), b * fx, b * fy)
    elif role == 1:
        inner = [x + dx(t * px * x) + dy(t * py * x) for x in (a, b)]
        planes = (dx(inner[0]) + dy(inner[1]), zero, zero, zero)
    elif role == 2:
        planes = (px * dx(a) + py * dy(a), px * dx(b) + py * dy(b), zero, zero)
    elif role == 3:
        planes = (dx(px * a) + dy(py * a), dx(px * b) + dy(py * b), zero, zero)
    else:
        raise ValueError(f"role {role}")
    out.copy_(torch.stack(planes, dim=-3))


# =========================================================================
# CUDA kernel leaves
# =========================================================================

def _check_cuda(name, tensors, strided=(), dtype=torch.float32):
    """Device, type and contiguity of a kernel's tensors, and the 16-byte
    alignment its vector loads need where a row holds a multiple of 16
    bytes; those in `strided` are checked for device and type only."""
    dev = (*tensors, *strided)[0].device
    for x in (*tensors, *strided):
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if x.dtype != dtype:
            raise TypeError(f"{name}: the kernel takes {dtype}, got {x.dtype}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    if any(x.data_ptr() % 16 for x in tensors if (x.shape[-1] * x.element_size()) % 16 == 0):
        raise ValueError(f"{name}: tensors whose rows are whole 16-byte words must be 16-byte "
                         "aligned")


def _ptr(x):
    return None if x is None else ctypes.c_void_p(x.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


_OPERANDS = {}   # (id(mats), precision, forms) -> (mats, tensors, pointers): sets already checked


def _operands(name, mats, like, precision="f32", forms=0):
    """The derivative operands a kernel reads from `mats`: (DxT, Dy) (at
    'high' their (2, n, n) bfloat16 splits [head, residual], at 'bf16'
    their (n, n) bfloat16 heads, made here once per operand set) or a
    FactoredOps' blocks of each pass on the form `forms` names for it and
    its butterflies (`_fops`), as tensors and ready ctypes pointers.
    Device, type and contiguity are checked the first time an operand set
    is seen (a flow hands the same set to every launch); that it lies on
    `like`'s device, every time."""
    hit = _OPERANDS.get((id(mats), precision, forms))
    if hit is None or hit[0] is not mats:
        if isinstance(mats, FactoredOps):
            tensors = _fops(mats, precision, forms)
        elif precision == "high":
            _check_cuda(name, mats)
            tensors = tuple(torch.stack(split_bf16(M)) for M in mats)
        elif precision == "bf16":
            _check_cuda(name, mats)
            tensors = tuple(M.to(torch.bfloat16) for M in mats)
        else:
            tensors = tuple(mats)
        rest = tensors
        if precision != "f32":   # the bf16 operands come first
            if tensors[0] is None or tensors[1] is None:
                raise ValueError(f"{name}: {precision!r} needs the split blocks that factored_ops "
                                 "makes")
            _check_cuda(name, tensors[:2], dtype=torch.bfloat16)
            rest = tensors[2:]
        if rest:
            _check_cuda(name, rest)
        if tensors[0].device != tensors[-1].device:
            raise ValueError(f"{name}: all operands must be on one CUDA device")
        if len(_OPERANDS) >= 8:
            _OPERANDS.clear()
        hit = _OPERANDS[(id(mats), precision, forms)] = (mats, tensors, tuple(map(_ptr, tensors)))
    if hit[1][0].device != like.device:
        raise ValueError(f"{name}: all tensors must be on one CUDA device")
    return hit[1], hit[2]


def _raise_on(rc, name):
    if rc == CUDA_ERROR_INVALID_VALUE:
        raise RuntimeError(f"{name}: the kernel refused its arguments (a shape, or a radix it "
                           "is not built for)")
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")


def _launcher(fn, name, counter, nlaunch, args):
    """launch(*late): call the C entry `fn` on the checked, ready arguments
    `args`, then the late ones (a time, RK4 weights) and the current
    stream; raise on its error code; count its launches. A flow builds one
    per kernel and buffer set and calls it at every stage, so that the
    checks and pointer conversions are paid once per flow, not per launch."""
    def launch(*late):
        rc = fn(*args, *late, _stream())
        if rc != 0:
            _raise_on(rc, name)
        LAUNCHES[counter] += nlaunch
    return launch


def p_planes_launcher(phi, out):
    """launch(t): out (2, ..., Ny, Nx) <- the planes of p(t) from phi."""
    from . import _build
    Ny, Nx = phi.shape[-2:]
    _check_cuda("lf_p_planes", [phi, out])
    if phi.shape[-3] != 5 or out.shape != (2,) + phi.shape[:-3] + (Ny, Nx):
        raise ValueError(f"lf_p_planes: phi {tuple(phi.shape)} and out {tuple(out.shape)} do not "
                         "fit (..., 5, Ny, Nx) and (2, ..., Ny, Nx)")
    return _launcher(_build.load().lf_p_planes, "lf_p_planes", "p_planes", 1,
                     (_ptr(phi), _ptr(out), phi.numel() // (5 * Ny * Nx), Ny * Nx))


def p_planes_cuda(t, phi, out):
    p_planes_launcher(phi, out)(float(t))


def velocity_launcher(kind, y, k, phi, pt, mats, ncomp, precision="f32"):
    """launch(t): k <- the dense velocity kernel (K2) of flow `kind` at y,
    at `precision` ('f32', 'high' or 'bf16')."""
    from . import _build
    Ny, Nx = y.shape[-2:]
    tier = _tier_arg(precision)
    _, mptrs = _operands("lf_velocity", mats, y, precision)
    _check_cuda("lf_velocity", [y, k, phi, pt])
    DxT, Dy = mats
    if (DxT.shape != (Nx, Nx) or Dy.shape != (Ny, Ny) or phi.shape != (5, Ny, Nx)
            or pt.shape != (2, Ny, Nx)):
        raise ValueError("lf_velocity: derivative matrices, phi or p(t) planes mis-shaped")
    nstate = {"backward": 2 * ncomp + NACC}.get(kind, ncomp)
    if y.shape != (nstate, Ny, Nx) or k.shape != y.shape:
        raise ValueError(f"lf_velocity: state {tuple(y.shape)} does not fit kind {kind}")
    return _launcher(_build.load().lf_velocity, "lf_velocity", "velocity_" + kind + _SUFFIX[tier],
                     1, (tier, KINDS[kind], _ptr(y), _ptr(k), _ptr(phi), _ptr(pt), *mptrs, ncomp,
                         Ny, Nx))


def velocity_cuda(kind, y, k, phi, pt, mats, ncomp, t, precision="f32"):
    velocity_launcher(kind, y, k, phi, pt, mats, ncomp, precision)(float(t))


def rk4_update_launcher(y, k, acc, s):
    """launch(stage, wacc, ws): fold a stage into the RK4 accumulator."""
    from . import _build
    _check_cuda("lf_rk4_update", [y, k, acc, s])
    if not (y.shape == k.shape == acc.shape == s.shape):
        raise ValueError("lf_rk4_update: shapes differ")
    return _launcher(_build.load().lf_rk4_update, "lf_rk4_update", "rk4_update", 1,
                     (_ptr(y), _ptr(k), _ptr(acc), _ptr(s), y.numel()))


def rk4_update_cuda(y, k, acc, s, stage, wacc, ws):
    rk4_update_launcher(y, k, acc, s)(int(stage), float(wacc), float(ws))


def deriv_cuda(a, b, c, out, mats, precision="f32"):
    """K2's derivative: out <- d_x a + d_y b + c through the dense kernel at
    `precision` ('f32', 'high' or 'bf16'), one launch."""
    from . import _build
    Ny, Nx = out.shape[-2:]
    given = [x for x in (a, b, c) if x is not None]
    tier = _tier_arg(precision)
    _, mptrs = _operands("lf_deriv", mats, out, precision)
    _check_cuda("lf_deriv", [out, *given])
    if mats[0].shape != (Nx, Nx) or mats[1].shape != (Ny, Ny):
        raise ValueError("lf_deriv: derivative matrices mis-shaped")
    if any(x.shape != out.shape for x in given):
        raise ValueError("lf_deriv: operand shapes differ from the output's")
    nplanes = out.numel() // (Ny * Nx)
    rc = _build.load().lf_deriv(tier, _ptr(a), _ptr(b), _ptr(c), _ptr(out), *mptrs, nplanes, Ny,
                                Nx, _stream())
    _raise_on(rc, "lf_deriv")
    LAUNCHES["deriv" + _SUFFIX[tier]] += 1


# The tile each factored kernel runs a pass on, by (kernel, precision,
# radix), and so the one form csrc/ builds of it there (the build passes
# the entries at radix 4 and 8 to nvcc, ops/_build.py::form_flags, and the
# C entries refuse the other form): "tile", fact_tile (csrc/fact_tile.cuh:
# radix 4 and 8, one channel group) or "cluster", the cluster tile
# (csrc/fact_sm90.cuh: the channels split over the CTAs of one
# thread-block cluster). Either is a launch a pass, and both give the same
# bits at a tier (K4's delta-phi integrands aside: PERF.md §2). Every
# kernel ('fderiv' K1, 'fa' K3, 'bv' K4, 'uni' K5) runs the cluster tile at
# radix 16 and 32, K1 at every radix (strict it won its A/B at 4 and 8,
# PERF.md §6, and its fact_tile form went); at 4 and 8 each other kernel
# runs fact_tile only where an A/B in turns measured it more than 2 %
# faster (twice the largest difference between two runs of the same sum,
# 1.1 %; a tie stays on the cluster tile, which the tier runs at 16 and 32):
# the mean cold ms of four rounds, summed over K3's two roles or K5's
# four, and K4's call, at the batches the main path runs the
# tier at (K3 and K5 strict: 1 and 17, the grid line search's trials being
# strict; else 1), 512^2 (radix 4) and 1024^2 (radix 8), fact_tile against
# the cluster tile (PERF.md §6, NVIDIA H100 80GB HBM3, 700 W):
_TILE_AT_4_8 = {   # (kernel, precision, radix): (fact_tile ms, cluster tile ms)
    ("fa", "f32", 4): (0.5830, 0.8014), ("fa", "f32", 8): (2.4684, 3.0015),
    ("fa", "high", 4): (0.0595, 0.0542), ("fa", "high", 8): (0.1221, 0.1308),
    ("fa", "bf16", 4): (0.0462, 0.0463), ("fa", "bf16", 8): (0.0928, 0.0935),
    ("uni", "f32", 4): (1.7422, 2.7891), ("uni", "f32", 8): (7.2594, 8.6492),
    ("uni", "high", 4): (0.1526, 0.1454), ("uni", "high", 8): (0.3624, 0.4072),
    ("uni", "bf16", 4): (0.1153, 0.1109), ("uni", "bf16", 8): (0.2860, 0.3035),
    # K4: one call; batch 1
    ("bv", "f32", 4): (0.1637, 0.1121), ("bv", "f32", 8): (0.3522, 0.3918),
    ("bv", "high", 4): (0.1276, 0.0975), ("bv", "high", 8): (0.2510, 0.3179),
    ("bv", "bf16", 4): (0.1026, 0.0800), ("bv", "bf16", 8): (0.2104, 0.2383)}
FORMS = {**{(k, p, B): "cluster" for k in ("fderiv", "fa", "bv", "uni") for p in PRECISIONS
            for B in BUILT_RADICES},
         **{key: "tile" if tile * 1.02 < cluster else "cluster"
            for key, (tile, cluster) in _TILE_AT_4_8.items()}}


def pass_launches(B, precision, kernel):
    """The launches of one pass of a factored kernel at radix B and
    `precision`: one on the cluster tile, one a channel group on fact_tile
    (ops/deriv.py::radix_groups: one at radix 4 and 8, the only radices
    FORMS puts on it), as FORMS puts the pass. Refuses a kernel, tier or
    radix that no factored kernel runs."""
    form = FORMS.get((kernel, precision, B))
    if form is None:
        raise ValueError(f"pass_launches: no factored kernel {kernel!r} at {precision!r}, "
                         f"radix {B}")
    return 1 if form == "cluster" else _deriv.radix_groups(B)


def _forms(kernel, precision, Bx, By):
    """The C entries' `forms` argument: bit 0 (the x pass) and bit 1 (the
    y pass) set where FORMS puts that pass on the cluster tile."""
    for B in (Bx, By):
        pass_launches(B, precision, kernel)
    return sum((FORMS[kernel, precision, B] == "cluster") << axis
               for axis, B in enumerate((Bx, By)))


def _check_factored(name, ops, Ny, Nx):
    """The radices of `ops`, after checking that they fit this plane
    shape and that the kernels are built for them (ops/deriv.py::
    BUILT_RADICES; csrc/factored.cu refuses any other as well)."""
    Bx, By = ops.FX.shape[0], ops.FY.shape[0]
    if ops.FX.shape[-1] != FACTOR_A or ops.FY.shape[-1] != FACTOR_A:
        raise ValueError(f"{name}: the kernel takes blocks of {FACTOR_A}, got "
                         f"{tuple(ops.FX.shape)}, {tuple(ops.FY.shape)}")
    if Nx != Bx * FACTOR_A or Ny != By * FACTOR_A:
        raise ValueError(f"{name}: a {Ny}x{Nx} plane does not fit radix ({Bx}, {By})")
    if Bx not in BUILT_RADICES or By not in BUILT_RADICES:
        raise ValueError(f"{name}: radix ({Bx}, {By}): the factored kernels are built for "
                         f"{BUILT_RADICES}")
    return Bx, By


def _fops(ops, precision="f32", forms=0):
    """The operands the factored kernels read: the x blocks and the
    transposed y blocks, each as its pass's form takes them (bit 0 of
    `forms` the x pass's, bit 1 the y pass's: 1 the cluster tile, 0
    fact_tile), and the two butterflies. Strict, either form: FX and FYT,
    FP32 (B, A, A), contiguous; at 'high' and 'bf16' fact_tile takes the
    split blocks (FXS, FYTS) or their heads, the cluster tile the split
    blocks swizzled (FXW, FYTW), whose heads 'bf16' reads."""
    def blocks(axis):
        if precision == "f32":
            return ops.FX if axis == 0 else fyt(ops)
        if forms >> axis & 1:
            return ops.FXW if axis == 0 else ops.FYTW
        S = ops.FXS if axis == 0 else ops.FYTS
        return S if precision == "high" or S is None else S[0]
    return blocks(0), blocks(1), ops.bfx, ops.bfy


_SUFFIX = ("", "_high", "_bf16")   # a launch's counter suffix, by the C entries' `tier`


def _tier_arg(precision):
    """The C entries' `tier` argument for `precision`."""
    if precision not in PRECISIONS:
        raise ValueError(f"LenseFlow kernels at precision {precision!r}: one of {PRECISIONS}")
    return PRECISIONS.index(precision)


def fderiv_cuda(a, b, c, out, ops, precision="f32"):
    """K1: out <- d_x a + d_y b + c through the factored derivative
    kernel at `precision` ('f32', 'high' or 'bf16'); out must not alias a
    or b. One launch per derivative given, on the cluster tile at every
    tier and radix (csrc/fderiv_sm90.cu; at 'high' and 'bf16' it reads the
    swizzled split blocks)."""
    from . import _build
    Ny, Nx = out.shape[-2:]
    given = [x for x in (a, b, c) if x is not None]
    tier = _tier_arg(precision)
    _check_cuda("lf_fderiv", [out, *given])
    Bx, By = _check_factored("lf_fderiv", ops, Ny, Nx)
    _, fptrs = _operands("lf_fderiv", ops, out, precision, _forms("fderiv", precision, Bx, By))
    if a is None and b is None:
        raise ValueError("lf_fderiv: needs a or b")
    if any(x.shape != out.shape for x in given):
        raise ValueError("lf_fderiv: operand shapes differ from the output's")
    if any(x is not None and x.data_ptr() == out.data_ptr() for x in (a, b)):
        raise ValueError("lf_fderiv: out must not alias a or b")
    nplanes = out.numel() // (Ny * Nx)
    rc = _build.load().lf_fderiv(tier, _ptr(a), _ptr(b), _ptr(c), _ptr(out), *fptrs, Bx, By,
                                 nplanes, Ny, Nx, _stream())
    _raise_on(rc, "lf_fderiv")
    LAUNCHES["fderiv" + _SUFFIX[tier]] += ((a is not None) * pass_launches(Bx, precision, "fderiv")
                                           + (b is not None) * pass_launches(By, precision, "fderiv"))


def _check_batched_state(name, y, k, phi, pt, nstate):
    nb, Ny, Nx = y.shape[0], y.shape[-2], y.shape[-1]
    if (y.shape != (nb, nstate, Ny, Nx) or k.shape != y.shape or phi.shape != (nb, 5, Ny, Nx)
            or pt.shape != (2, nb, Ny, Nx)):
        raise ValueError(f"{name}: state {tuple(y.shape)}, velocity {tuple(k.shape)}, phi "
                         f"{tuple(phi.shape)} and p(t) {tuple(pt.shape)} do not fit "
                         f"(nb, {nstate}, Ny, Nx)")
    return nb


def fvelocity_launcher(kind, y, k, phi, pt, ops, ncomp, precision="f32"):
    """launch(t): K3 (forward, adjoint) or K4 (backward) at `precision`
    ('f32', 'high' or 'bf16'), k <- the velocity of flow `kind` at the batched (nb,
    nstate, Ny, Nx) state y; phi is (nb, 5, Ny, Nx), pt its p(t) planes
    (2, nb, Ny, Nx). An x pass and a y pass (pass_launches each), each
    on the tile FORMS names: the cluster tile (csrc/fa_sm90.cu,
    csrc/bv_sm90.cu; at 'high' and 'bf16' it reads the swizzled split
    blocks) or fact_tile (csrc/factored_kernels.cuh). K4's y pass ends by
    writing u = M^-1 w and the five delta-phi integrands."""
    from . import _build
    Ny, Nx = y.shape[-2:]
    lib = _build.load()
    tier = _tier_arg(precision)
    kernel = "bv" if kind == "backward" else "fa"
    name = f"lf_{kernel}_velocity"
    _check_cuda(name, [y, k, phi, pt])
    Bx, By = _check_factored(name, ops, Ny, Nx)
    forms = _forms(kernel, precision, Bx, By)
    _, fptrs = _operands(name, ops, y, precision, forms)
    nlaunch = pass_launches(Bx, precision, kernel) + pass_launches(By, precision, kernel)
    if kind == "backward":
        nb = _check_batched_state(name, y, k, phi, pt, 2 * ncomp + NACC)
        return _launcher(lib.lf_bv_velocity, name, "bv_velocity" + _SUFFIX[tier], nlaunch,
                         (tier, forms, _ptr(y), _ptr(k), _ptr(phi), _ptr(pt), *fptrs, Bx, By, nb,
                          ncomp, Ny, Nx))
    nb = _check_batched_state(name, y, k, phi, pt, ncomp)
    fa = _launcher(lib.lf_fa_velocity, name, "fa_velocity_" + kind + _SUFFIX[tier], nlaunch,
                   (tier, forms, ROLES[kind], _ptr(y), _ptr(k), _ptr(pt), *fptrs, Bx, By, nb, ncomp,
                    Ny, Nx))
    return lambda t: fa()   # K3 takes no time: p(t) reaches it as planes


def fvelocity_cuda(kind, y, k, phi, pt, ops, ncomp, t, precision="f32"):
    fvelocity_launcher(kind, y, k, phi, pt, ops, ncomp, precision)(float(t))


def _plane_strides(name, x, Ny, Nx):
    """(batch, entry) strides of a (nb, nper, Ny, Nx) operand whose planes
    are contiguous (a strided view of a flow state is taken as it is)."""
    if x.dim() != 4 or x.shape[-2:] != (Ny, Nx) or x.stride(-1) != 1 or x.stride(-2) != Nx:
        raise ValueError(f"{name}: operands must be (nb, nper, Ny, Nx) with contiguous planes, "
                         f"got {tuple(x.shape)} strides {x.stride()}")
    return x.stride(0), x.stride(1)


def _uni_check_dense(name, mats, a, b, Ny, Nx):
    """The dense K5's operands: circulants of this plane shape, and a and
    b 16-byte aligned, with strides of whole 16-byte words, where the
    kernel reads their rows four floats at a time (Nx a multiple of 4)."""
    DxT, Dy = mats
    if DxT.shape != (Nx, Nx) or Dy.shape != (Ny, Ny):
        raise ValueError(f"{name}: derivative matrices {tuple(DxT.shape)}, {tuple(Dy.shape)} do "
                         f"not fit a {Ny}x{Nx} plane")
    if Nx % 4 == 0 and any(x.data_ptr() % 16 or x.stride(0) % 4 or x.stride(1) % 4
                           for x in (a, b)):
        raise ValueError(f"{name}: a and b must be 16-byte aligned with strides of whole 16-byte "
                         "words")


def uni_velocity_launcher(role, a, b, px, py, out, mats, precision="f32"):
    """launch(t): K5, out <- the universal kernel's planes for `role` (see
    csrc/uni.cu) over the (nb, nper) entries of a and b, (nb, nper, Ny, Nx)
    views with contiguous planes; px, py (nb, 1, Ny, Nx) and out (nb, nper,
    4, Ny, Nx) contiguous; at `precision` ('f32', 'high' or 'bf16').
    Factored operands (every built radix): an x pass and a y pass a stage
    (pass_launches each), two stages for role 1, each pass on the tile
    FORMS names: fact_tile (csrc/uni.cu) or the cluster tile
    (csrc/uni_sm90.cu), which reads the pixel pairs of a and b as float2,
    so their data and strides must keep 8-byte alignment; dense ones (csrc/uni_dense.cu, any plane shape): one
    launch, two for role 1. Checks, pointers and role 1's scratch are made
    here once; a flow makes one launcher per K5 call of its velocity."""
    from . import _build
    Ny, Nx = out.shape[-2:]
    factored = isinstance(mats, FactoredOps)
    name = "lf_uni_velocity" if factored else "lf_uni_dense_velocity"
    tier = _tier_arg(precision)
    _check_cuda(name, [px, py, out], strided=(a, b))
    if role not in (0, 1, 2, 3):
        raise ValueError(f"{name}: role {role}")
    forms = 0
    if factored:
        Bx, By = _check_factored(name, mats, Ny, Nx)
        forms = _forms("uni", precision, Bx, By)
    _, mptrs = _operands(name, mats, out, precision, forms)
    strides = [*_plane_strides(name, a, Ny, Nx), *_plane_strides(name, b, Ny, Nx)]
    nb, nper = out.shape[0], out.shape[1]
    if (a.shape[:2] != (nb, nper) or b.shape[:2] != (nb, nper) or out.shape[2] != 4
            or px.shape != (nb, 1, Ny, Nx) or py.shape != px.shape):
        raise ValueError(f"{name}: a {tuple(a.shape)}, b {tuple(b.shape)}, px "
                         f"{tuple(px.shape)} and out {tuple(out.shape)} do not fit "
                         "(nb, nper, [4,] Ny, Nx)")
    if any(x.untyped_storage().data_ptr() == out.untyped_storage().data_ptr()
           for x in (a, b, px, py)):
        raise ValueError(f"{name}: out must not share storage with an operand")
    if not factored:
        _uni_check_dense(name, mats, a, b, Ny, Nx)
    elif forms and any(x.data_ptr() % 8 or x.stride(0) % 2 or x.stride(1) % 2 for x in (a, b)):
        raise ValueError(f"{name}: on the cluster tile (radix {Bx}, {By} at {precision!r}) a and "
                         "b must be 8-byte aligned with even strides (the kernel reads their "
                         "pixel pairs as float2)")
    scratch = torch.empty((nb, nper, 2, Ny, Nx), dtype=out.dtype, device=out.device) \
        if role == 1 else None
    lib = _build.load()
    tail = (_ptr(a), _ptr(b), *strides, _ptr(px), _ptr(py), _ptr(out), _ptr(scratch), *mptrs)
    if factored:
        nlaunch = (2 if role == 1 else 1) * (pass_launches(Bx, precision, "uni")
                                             + pass_launches(By, precision, "uni"))
        return _launcher(lib.lf_uni_velocity, name, f"uni_role{role}{_SUFFIX[tier]}", nlaunch,
                         (tier, forms, role, *tail, Bx, By, nb, nper, Ny, Nx))
    return _launcher(lib.lf_uni_dense_velocity, name, f"uni_dense_role{role}{_SUFFIX[tier]}",
                     2 if role == 1 else 1, (tier, role, *tail, nb, nper, Ny, Nx))


def uni_velocity_cuda(role, a, b, px, py, out, mats, t, precision="f32"):
    uni_velocity_launcher(role, a, b, px, py, out, mats, precision)(float(t))


def uni_velocity_plain_launcher(role, a, b, px, py, out, mats, precision="f32"):
    """launch(t): `uni_velocity_plain` on these buffers."""
    return lambda t: uni_velocity_plain(role, a, b, px, py, out, mats, t, precision)


class _Leaves:
    """One set of leaf operations; `batched` when its velocity takes a
    leading batch axis (the factored kernels), else a batched flow loops
    over its entries."""

    def __init__(self, velocity, rk4_update, deriv, p_planes, batched, launchers=None):
        self.velocity = velocity
        self.rk4_update = rk4_update
        self.deriv = deriv
        self.p_planes = p_planes
        self.batched = batched
        # (velocity, rk4_update, p_planes) launcher makers of the kernel leaves
        self.launchers = launchers


def _uni_flow_velocity_launcher(uni, kind, y, k, phi, pt, mats, ncomp, precision="f32"):
    """launch(t): k <- the velocity of flow `kind` at the batched (nb,
    nstate, Ny, Nx) state y as calls of the universal leaf's launchers
    `uni` (made here once, on buffers made here once), in the order of
    `_uni_call`: forward and adjoint (roles 2, 3) over component pairs,
    the last pair repeating its component when ncomp is odd; backward over
    the state (f, delta f, delta phi): role 0 on every component at once,
    u = M^-1 sum_c w_c, then role 1 for delta phi."""
    nb, Ny, Nx = y.shape[0], y.shape[-2], y.shape[-1]
    px, py = pt[0].unsqueeze(1), pt[1].unsqueeze(1)
    new = lambda n: torch.empty((nb, n, 4, Ny, Nx), dtype=y.dtype, device=y.device)
    if kind in ("forward", "adjoint"):
        out = new(1)
        pairs = [(c0, min(c0 + 1, ncomp - 1)) for c0 in range(0, ncomp, 2)]
        calls = [(uni(ROLES_UNI[kind], y[:, c0:c0 + 1], y[:, c1:c1 + 1], px, py, out, mats,
                      precision), c0, c1) for c0, c1 in pairs]

        def launch(t):
            for call, c0, c1 in calls:
                call(t)
                k[:, c0:c1 + 1] = out[:, 0, :c1 - c0 + 1]
        return launch
    if kind != "backward":
        raise ValueError(kind)
    out, out1 = new(ncomp), new(1)
    u = torch.empty((nb, 2, Ny, Nx), dtype=y.dtype, device=y.device)
    role0 = uni(0, y[:, :ncomp], y[:, ncomp:2 * ncomp], px, py, out, mats, precision)
    role1 = uni(1, u[:, :1], u[:, 1:], px, py, out1, mats, precision)

    def launch(t):
        role0(t)
        k[:, :2 * ncomp] = out[:, :, :2].transpose(1, 2).reshape(nb, 2 * ncomp, Ny, Nx)
        wx, wy = out[:, :, 2].sum(dim=1), out[:, :, 3].sum(dim=1)
        m11, m12, m22 = _minv_of_t(t, phi)
        u[:, 0] = m11 * wx + m12 * wy
        u[:, 1] = m12 * wx + m22 * wy
        role1(t)
        k[:, 2 * ncomp] = out1[:, 0, 0]
    return launch


def _uni_flow_velocity(uni, kind, y, k, phi, pt, mats, ncomp, t, precision="f32"):
    _uni_flow_velocity_launcher(uni, kind, y, k, phi, pt, mats, ncomp, precision)(t)


PLAIN = _Leaves(velocity_plain, rk4_update_plain, deriv_plain, p_planes_plain, False)
KERNEL = _Leaves(velocity_cuda, rk4_update_cuda, deriv_cuda, p_planes_cuda, False,
                 (velocity_launcher, rk4_update_launcher, p_planes_launcher))
FPLAIN = _Leaves(fvelocity_plain, rk4_update_plain, fderiv_plain, p_planes_plain, True)
FKERNEL = _Leaves(fvelocity_cuda, rk4_update_cuda, fderiv_cuda, p_planes_cuda, True,
                  (fvelocity_launcher, rk4_update_launcher, p_planes_launcher))
# 'high': the plain leaves' derivatives split, the factored kernels' tensor-core tier
_high = functools.partial(functools.partial, precision="high")
PLAIN_HIGH = _Leaves(_high(velocity_plain), rk4_update_plain, _high(deriv_plain), p_planes_plain,
                     False)
FPLAIN_HIGH = _Leaves(_high(fvelocity_plain), rk4_update_plain, _high(fderiv_plain),
                      p_planes_plain, True)
KERNEL_HIGH = _Leaves(_high(velocity_cuda), rk4_update_cuda, _high(deriv_cuda), p_planes_cuda,
                      False, (_high(velocity_launcher), rk4_update_launcher, p_planes_launcher))
FKERNEL_HIGH = _Leaves(_high(fvelocity_cuda), rk4_update_cuda, _high(fderiv_cuda), p_planes_cuda,
                       True, (_high(fvelocity_launcher), rk4_update_launcher, p_planes_launcher))
# 'bf16': the plain leaves' one rounded product, the kernels' 'bf16' tier
_bf16 = functools.partial(functools.partial, precision="bf16")
PLAIN_BF16 = _Leaves(_bf16(velocity_plain), rk4_update_plain, _bf16(deriv_plain), p_planes_plain,
                     False)
FPLAIN_BF16 = _Leaves(_bf16(fvelocity_plain), rk4_update_plain, _bf16(fderiv_plain),
                      p_planes_plain, True)
KERNEL_BF16 = _Leaves(_bf16(velocity_cuda), rk4_update_cuda, _bf16(deriv_cuda), p_planes_cuda,
                      False, (_bf16(velocity_launcher), rk4_update_launcher, p_planes_launcher))
FKERNEL_BF16 = _Leaves(_bf16(fvelocity_cuda), rk4_update_cuda, _bf16(fderiv_cuda), p_planes_cuda,
                       True, (_bf16(fvelocity_launcher), rk4_update_launcher, p_planes_launcher))
# (device type, factored, precision) -> leaves
_LEAVES = {("cpu", False, "f32"): PLAIN, ("cpu", True, "f32"): FPLAIN,
           ("cuda", False, "f32"): KERNEL, ("cuda", True, "f32"): FKERNEL,
           ("cpu", False, "high"): PLAIN_HIGH, ("cpu", True, "high"): FPLAIN_HIGH,
           ("cuda", False, "high"): KERNEL_HIGH, ("cuda", True, "high"): FKERNEL_HIGH,
           ("cpu", False, "bf16"): PLAIN_BF16, ("cpu", True, "bf16"): FPLAIN_BF16,
           ("cuda", False, "bf16"): KERNEL_BF16, ("cuda", True, "bf16"): FKERNEL_BF16}
# the uni granularity: no derivative leaf (phi's planes come from the
# kernel path's `gradhess`, delta phi from role 1); K5 at each tier
_uplain = functools.partial(_uni_flow_velocity, uni_velocity_plain_launcher)
_ukernel = functools.partial(_uni_flow_velocity, uni_velocity_launcher)
_ulaunchers = functools.partial(_uni_flow_velocity_launcher, uni_velocity_launcher)
UPLAIN = _Leaves(_uplain, rk4_update_plain, None, p_planes_plain, True)
UKERNEL = _Leaves(_ukernel, rk4_update_cuda, None, p_planes_cuda, True,
                  (_ulaunchers, rk4_update_launcher, p_planes_launcher))
UPLAIN_HIGH = _Leaves(_high(_uplain), rk4_update_plain, None, p_planes_plain, True)
UKERNEL_HIGH = _Leaves(_high(_ukernel), rk4_update_cuda, None, p_planes_cuda, True,
                       (_high(_ulaunchers), rk4_update_launcher, p_planes_launcher))
UPLAIN_BF16 = _Leaves(_bf16(_uplain), rk4_update_plain, None, p_planes_plain, True)
UKERNEL_BF16 = _Leaves(_bf16(_ukernel), rk4_update_cuda, None, p_planes_cuda, True,
                       (_bf16(_ulaunchers), rk4_update_launcher, p_planes_launcher))
# (device type, precision) -> uni leaves, dense or factored alike
_ULEAVES = {("cpu", "f32"): UPLAIN, ("cuda", "f32"): UKERNEL,
            ("cpu", "high"): UPLAIN_HIGH, ("cuda", "high"): UKERNEL_HIGH,
            ("cpu", "bf16"): UPLAIN_BF16, ("cuda", "bf16"): UKERNEL_BF16}


def _precision(precision):
    """The precision asked for, or the one in force."""
    p = _deriv.matmul_precision() if precision is None else precision
    if p not in PRECISIONS:
        raise ValueError(f"LenseFlow flows at precision {p!r}: one of {PRECISIONS}")
    return p


def _leaves_for(x, mats, precision=None):
    """The plain version for a CPU tensor, the kernel for a CUDA tensor;
    factored or dense by the operands; at `precision` (the one in force
    when None)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no LenseFlow kernel for device {x.device}")
    return _LEAVES[(x.device.type, isinstance(mats, FactoredOps), _precision(precision))]


def _plain_for(mats, precision=None):
    return _LEAVES[("cpu", isinstance(mats, FactoredOps), _precision(precision))]


def _uni_leaves_for(x, precision=None):
    """The uni leaves: K5's plain version for a CPU tensor, the kernel for
    a CUDA tensor, at `precision` (the one in force when None)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no LenseFlow kernel for device {x.device}")
    return _ULEAVES[(x.device.type, _precision(precision))]


# =========================================================================
# flows
# =========================================================================

def flow_times(nsteps, t0, t1):
    """The 2*nsteps + 1 distinct times at which an RK4 flow from t0 to t1
    evaluates its velocity: step i uses times 2i (stage 0), 2i + 1 (the two
    middle stages) and 2i + 2 (the last stage, and the next step's first)."""
    half = (t1 - t0) / nsteps / 2
    return [t0 + j * half for j in range(2 * nsteps + 1)]


def _stages(leaves, kind, y, s, k, acc, phi, pt, mats, ncomp):
    """(velocity at y, velocity at s, rk4_update, p_planes) of one flow over
    its fixed buffers, as calls of (t), (t), (stage, wacc, ws) and (t): the
    kernel leaves' launchers, built once, or the leaves themselves."""
    made = getattr(leaves, "launchers", None)
    if made is not None:
        velocity, rk4_update, p_planes = made
        return (velocity(kind, y, k, phi, pt, mats, ncomp),
                velocity(kind, s, k, phi, pt, mats, ncomp), rk4_update(y, k, acc, s),
                p_planes(phi, pt))
    return (lambda t: leaves.velocity(kind, y, k, phi, pt, mats, ncomp, t),
            lambda t: leaves.velocity(kind, s, k, phi, pt, mats, ncomp, t),
            lambda stage, wacc, ws: leaves.rk4_update(y, k, acc, s, stage, wacc, ws),
            lambda t: leaves.p_planes(t, phi, pt))


def _integrate(leaves, kind, y, phi, mats, ncomp, nsteps, t0, t1):
    """Classical RK4 of flow `kind` from t0 to t1 over a (..., nstate, Ny,
    Nx) state, stages folded into a running accumulator as in
    `_rk4_steps`; p(t) is formed once per time of `flow_times`."""
    y = y.contiguous().clone()
    k, acc, s = torch.empty_like(y), torch.empty_like(y), torch.empty_like(y)
    pt = torch.empty((2,) + tuple(phi.shape[:-3]) + tuple(phi.shape[-2:]), dtype=phi.dtype,
                     device=phi.device)
    vel_y, vel_s, rk4, p_planes = _stages(leaves, kind, y, s, k, acc, phi, pt, mats, ncomp)
    h = (t1 - t0) / nsteps
    times = flow_times(nsteps, t0, t1)
    p_planes(times[0])
    for i in range(nsteps):
        t, tmid, tend = times[2 * i:2 * i + 3]
        vel_y(t)
        rk4(0, h / 6, h / 2)
        p_planes(tmid)
        vel_s(tmid)
        rk4(1, h / 3, h / 2)
        vel_s(tmid)
        rk4(2, h / 3, h)
        p_planes(tend)
        vel_s(tend)
        rk4(3, h / 6, 0.0)
    return y


def _over_batch(leaves, fn, *xs):
    """fn over the leading batch axes of its tensor arguments (already
    broadcast to one batch shape): in one call on a (nb, ...) flattening
    for batched leaves, entry by entry for the others."""
    lead = xs[0].shape[:-3]
    if leaves.batched:
        flat = [x.reshape((-1,) + tuple(x.shape[-3:])).contiguous() for x in xs]
        outs = fn(*flat)
        if isinstance(outs, tuple):
            return tuple(o.reshape(lead + o.shape[1:]) for o in outs)
        return outs.reshape(lead + outs.shape[1:])
    if not lead:
        return fn(*xs)
    flat = [x.reshape((-1,) + tuple(x.shape[-3:])) for x in xs]
    outs = [fn(*(x[b] for x in flat)) for b in range(flat[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o).reshape(lead + o[0].shape) for o in zip(*outs))
    return torch.stack(outs).reshape(lead + outs[0].shape)


def _gradhess(leaves, phi_map, mats):
    """(..., 5, Ny, Nx) planes (gx, gy, hxx, hxy, hyy) of a (..., 1, Ny,
    Nx) map. The Hessian is two first-derivative products: in float32
    that is as accurate as the FFT and more accurate than the dense
    second-derivative circulant, whose entries of order l_max^2
    cancel."""
    p = phi_map.contiguous()
    out = torch.empty((5,) + tuple(p.shape), dtype=p.dtype, device=p.device)
    gx, gy = out[0], out[1]
    leaves.deriv(p, None, None, gx, mats)
    leaves.deriv(None, p, None, gy, mats)
    leaves.deriv(gx, None, None, out[2], mats)
    leaves.deriv(None, gx, None, out[3], mats)
    leaves.deriv(None, gy, None, out[4], mats)
    return torch.movedim(out.squeeze(-3), 0, -3).contiguous()


def _flow_apply(leaves, f_map, phi, mats, t0, t1, nsteps, kind):
    return _over_batch(
        leaves,
        lambda f, p: _integrate(leaves, kind, f, p, mats, f.shape[-3], int(nsteps),
                                float(t0), float(t1)),
        f_map, phi)


def _flow_bwd(leaves, dy, f1, phi, mats, t0, t1, nsteps):

    def one(dy, f1, p):
        ncomp = f1.shape[-3]
        zero = torch.zeros(f1.shape[:-3] + (NACC,) + f1.shape[-2:], dtype=f1.dtype,
                           device=f1.device)
        state = torch.cat([f1, dy, zero], dim=-3)
        y = _integrate(leaves, "backward", state, p, mats, ncomp, int(nsteps),
                       float(t1), float(t0))
        ux, uy, sxx, sxy, syy = (y[..., 2 * ncomp + i:2 * ncomp + i + 1, :, :].contiguous()
                                 for i in range(NACC))
        X, Y, dphi = torch.empty_like(ux), torch.empty_like(ux), torch.empty_like(ux)
        leaves.deriv(sxx, sxy, ux, X, mats)     # u_x + d_x s_xx + d_y s_xy
        leaves.deriv(None, syy, uy, Y, mats)    # u_y + d_y s_yy
        leaves.deriv(X, Y, None, dphi, mats)
        return dphi, y[..., ncomp:2 * ncomp, :, :].clone()

    return _over_batch(leaves, one, dy, f1, phi)


# The precision of phi's planes for a flow at each tier. At 'bf16' they
# are formed strict, where the JAX package forms them at the tier: the
# Hessian differentiates phi's bf16 rounding (2^-9 of a field whose power
# lies at low l) twice, so on a Cphi-drawn phi its error exceeds the
# Hessian itself (1.3 against a largest |hxx| of 0.38 at 256^2, 2.4
# against 0.41 at 1024^2, 6.1 against 0.45 at 2048^2), det(I + t Hess phi)
# turns negative and p(t) blows up: L @ f reached 3.5e8 against 21.6 at
# 1024^2, and one MAP_joint(precision="bf16") step at 2048^2 P went to a
# NaN logpdf (scripts/torch_bf16_planes.py on an NVIDIA H100; ROADMAP
# Queue 3). The five planes are a flow's only derivatives of phi, five K1
# / K2 launches against its velocities' hundreds.
PLANES_PRECISION = {"f32": "f32", "high": "high", "bf16": "f32"}


def gradhess(phi_map, mats, precision=None):
    """(..., 5, Ny, Nx) planes (gx, gy, hxx, hxy, hyy) of a (..., 1, Ny,
    Nx) map through the derivative kernel (plain version on the CPU), at
    the planes' precision for the tier asked for (PLANES_PRECISION)."""
    p = PLANES_PRECISION[_precision(precision)]
    return _gradhess(_leaves_for(phi_map, mats, p), phi_map, mats)


def flow_apply(f_map, phi, mats, t0, t1, nsteps, kind="forward", precision=None):
    """Integrate the forward or adjoint flow of the (..., ncomp, Ny, Nx)
    map f_map from t0 to t1; phi (..., 5, Ny, Nx) from `gradhess`."""
    if kind not in ("forward", "adjoint"):
        raise ValueError(kind)
    return _flow_apply(_leaves_for(f_map, mats, precision), f_map, phi, mats, t0, t1, nsteps,
                       kind)


def flow_bwd(dy, f1, phi, mats, t0, t1, nsteps, precision=None):
    """Integrate the transpose-delta system from t1 back to t0, starting
    at (f1, dy, 0); returns (dphi (..., 1, Ny, Nx), df0). The three delta
    phi derivatives after the loop run at the same precision."""
    return _flow_bwd(_leaves_for(f1, mats, precision), dy, f1, phi, mats, t0, t1, nsteps)


def gradhess_plain(phi_map, mats, precision=None):
    return _gradhess(_plain_for(mats, PLANES_PRECISION[_precision(precision)]), phi_map, mats)


def flow_apply_plain(f_map, phi, mats, t0, t1, nsteps, kind="forward", precision=None):
    return _flow_apply(_plain_for(mats, precision), f_map, phi, mats, t0, t1, nsteps, kind)


def flow_bwd_plain(dy, f1, phi, mats, t0, t1, nsteps, precision=None):
    return _flow_bwd(_plain_for(mats, precision), dy, f1, phi, mats, t0, t1, nsteps)


def _uni_flow_bwd(leaves, dy, f1, phi, mats, t0, t1, nsteps):
    """The transpose-delta system with delta phi in the state: RK4 of the
    (f, delta f, delta phi) state, 2 ncomp + 1 planes, from t1 back to t0."""

    def one(dy, f1, p):
        ncomp = f1.shape[-3]
        state = torch.cat([f1, dy, torch.zeros_like(f1[:, :1])], dim=-3)
        y = _integrate(leaves, "backward", state, p, mats, ncomp, int(nsteps), float(t1),
                       float(t0))
        return y[:, 2 * ncomp:].clone(), y[:, ncomp:2 * ncomp].clone()

    return _over_batch(leaves, one, dy, f1, phi)


def uni_flow_apply(f_map, phi, mats, t0, t1, nsteps, kind="forward", precision=None):
    """`flow_apply` at the uni granularity: every velocity through the
    universal kernel (roles 2, 3), its plain version on the CPU, at
    `precision` (the one in force when None)."""
    if kind not in ("forward", "adjoint"):
        raise ValueError(kind)
    return _flow_apply(_uni_leaves_for(f_map, precision), f_map, phi, mats, t0, t1, nsteps, kind)


def uni_flow_bwd(dy, f1, phi, mats, t0, t1, nsteps, precision=None):
    """`flow_bwd` at the uni granularity (roles 0, 1), delta phi integrated
    in the state by role 1 at `precision`, as `_uni_call` integrates it;
    returns (dphi (..., 1, Ny, Nx), df0)."""
    return _uni_flow_bwd(_uni_leaves_for(f1, precision), dy, f1, phi, mats, t0, t1, nsteps)


def uni_flow_apply_plain(f_map, phi, mats, t0, t1, nsteps, kind="forward", precision=None):
    return _flow_apply(_ULEAVES["cpu", _precision(precision)], f_map, phi, mats, t0, t1, nsteps,
                       kind)


def uni_flow_bwd_plain(dy, f1, phi, mats, t0, t1, nsteps, precision=None):
    return _uni_flow_bwd(_ULEAVES["cpu", _precision(precision)], dy, f1, phi, mats, t0, t1,
                         nsteps)
