"""Spatially sharded LenseFlow: maps split over ranks by rows.

Counterpart of ``cmblensing_tpu/parallel/spatial.py``. The Ny axis of f
and phi is split over the ranks of the mesh dimension "sp"; each rank
holds a (..., Ny/P, Nx) block and the flows run on the blocks:

  * every elementwise step (velocity algebra, M^-1(t), p(t), the RK4
    updates) touches the local block alone;
  * d_x is local: the block's rows hold every column;
  * d_y is the pencil transpose (parallel/sharded_fft.py::y_to_x, one
    all_to_all) to (..., Ny, Nx/P), the full-Ny derivative there, and
    the transpose back.

The JAX package routes its derivatives through a trace-time global
(``ops/deriv.py::shard_ctx``); here the pair is explicit:
`ShardedDerivs.ddx_ddy` returns it in the form ``ops/deriv.py::ddx_ddy``
returns, and the kernel path's flows take it as their derivative
operands (ops/lenseflow_kernels.py: the stage table walked by `_walk`,
the continuous-adjoint backward flow `_flow_bwd`, phi's planes
`_gradhess`), so the sharded flows are the unsharded kernel path's
stages in the same order. On the card the leaves are kernels: each local
derivative is K1 (``fderiv_cuda``, the cluster tile) where the block's
rows and columns each fit a built radix (ops/deriv.py::deriv_ops of a
projection of the block's shape: (Ny/P, Nx) before the transpose, (Ny,
Nx/P) after it), else K2's derivative (``deriv_cuda``) with circulants
sized to the block; the RK4 update and p(t) are ``rk4_update_cuda`` and
``p_planes_cuda``; the velocity glue is elementwise torch. On the CPU
they are the plain versions. The one-launch dense flow
(csrc/dense_flow.cu) and the fused factored velocities (K3, K4, K5)
cannot cross a transpose inside their launch, so they are not used here.

Gradients: `ShardedLenseFlow` applies through torch.autograd.Functions
whose backward is the continuous-adjoint transpose-delta flow on the
blocks, as models/lenseflow.py's are.
"""
from __future__ import annotations

import functools

import torch

from ..core.basis import lense_basis
from ..core.field import Field
from ..core.proj import ProjLambert
from ..ops import deriv as _deriv
from ..ops import lenseflow_kernels as _lfk
from ..ops.factored_deriv import FactoredOps
from .mesh import BatchSharding, _device_mesh, all_gather, axis_rank, axis_size, make_mesh
from .sharded_fft import x_to_y, y_to_x


def spatial_mesh(n_devices=None, axis_name="sp", device="cuda", backend=None, nbatch=None,
                 batch_axis="batch"):
    """A 1-D mesh over the map's rows, or with nbatch a 2-D (batch_axis,
    axis_name) mesh: nbatch groups of ranks take the batch entries, the
    ranks of a group each map's rows."""
    if nbatch is None:
        return make_mesh(n_devices=n_devices, axis_name=axis_name, device=device, backend=backend)
    import torch.distributed as dist
    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    if n % nbatch:
        raise ValueError(f"{n} devices not divisible by nbatch={nbatch}")
    return _device_mesh((nbatch, n // nbatch), (batch_axis, axis_name), device, backend)


def _rows(n, mesh, axis_name):
    P, r = axis_size(mesh, axis_name), axis_rank(mesh, axis_name)
    k = n // P
    return slice(r * k, (r + 1) * k)


def shard_spatial(f: Field, mesh, axis_name="sp", batch_axis=None) -> Field:
    """This rank's rows of a whole map-basis Field (and its batch entries
    over batch_axis, when given, for a batched Field)."""
    arr = f.arr[..., _rows(f.arr.shape[-2], mesh, axis_name), :]
    if batch_axis is not None and arr.ndim >= 4:
        arr = arr[BatchSharding(mesh, batch_axis).slice(arr.shape[0])]
    return Field(arr.contiguous(), f.basis, f.proj)


def gather_spatial(f, mesh, axis_name="sp", batch_axis=None):
    """The whole map of a y-sharded Field or tensor, on every rank (and
    every batch entry, with batch_axis)."""
    arr = f.arr if isinstance(f, Field) else f
    arr = all_gather(arr.contiguous(), mesh, axis_name, dim=-2)
    if batch_axis is not None and arr.ndim >= 4:
        arr = all_gather(arr.contiguous(), mesh, batch_axis, dim=0)
    return Field(arr, f.basis, f.proj) if isinstance(f, Field) else arr


def _check_divisible(proj, mesh, axis_name):
    nsp = axis_size(mesh, axis_name)
    if proj.Ny % nsp or proj.Nx % nsp:
        raise ValueError(
            f"spatial sharding needs Ny ({proj.Ny}) and Nx ({proj.Nx}) divisible by the "
            f"spatial mesh axis size ({nsp}) for the pencil all_to_all transposes")


# =========================================================================
# the local derivative pair
# =========================================================================

def _block_ops(proj, ny, nx):
    """Derivative operands for an (ny, nx) block of proj's pixels: those
    of a projection of that shape and spacing (only the axis a block is
    whole along is differentiated)."""
    return _deriv.deriv_ops(ProjLambert(ny, nx, proj.thetapix, proj.T, device=proj.device))


def _block_deriv(a, b, mats, precision):
    """d_x a or d_y b of whole-axis blocks: K1 on factored operands, K2's
    derivative on dense ones, on the card; the plain version on the CPU."""
    x = (a if a is not None else b).contiguous()
    a, b = (x, None) if a is not None else (None, x)
    out = torch.empty_like(x)
    if x.device.type == "cuda":
        fn = _lfk.fderiv_cuda if isinstance(mats, FactoredOps) else _lfk.deriv_cuda
    else:
        fn = _lfk.deriv_plain
    fn(a, b, None, out, mats, precision)
    return out


class ShardedDerivs:
    """(d/dx, d/dy) on this rank's (..., Ny/P, Nx) rows of a map whose Ny
    axis is split over the mesh dimension: d_x on the block as it is, d_y
    = x_to_y . d_y . y_to_x on (..., Ny, Nx/P). The kernel path's flows
    take it as their derivative operands (ops/deriv.py::ddx_ddy calls
    `ddx_ddy`)."""

    def __init__(self, proj, mesh, axis_name="sp"):
        _check_divisible(proj, mesh, axis_name)
        P = axis_size(mesh, axis_name)
        self.proj, self.mesh, self.axis_name = proj, mesh, axis_name
        self.pre = _block_ops(proj, proj.Ny // P, proj.Nx)
        self.post = _block_ops(proj, proj.Ny, proj.Nx // P)

    def ddx_ddy(self, precision="f32"):
        mesh, ax = self.mesh, self.axis_name

        def dx(a):
            return _block_deriv(a, None, self.pre, precision)

        def dy(a):
            return x_to_y(_block_deriv(None, y_to_x(a.contiguous(), mesh, ax), self.post,
                                       precision), mesh, ax)

        return dx, dy


_DERIVS = {}


def sharded_derivs(proj, mesh, axis_name="sp"):
    """The ShardedDerivs of proj on this mesh dimension (made once)."""
    key = (proj, id(mesh), axis_name)
    d = _DERIVS.get(key)
    if d is None or d.mesh is not mesh:
        d = _DERIVS[key] = ShardedDerivs(proj, mesh, axis_name)
    return d


def _leaves(device_type, precision):
    """The kernel path's flow leaves over sharded operands: the velocity and
    derivative glue around the pair, the RK4 update and p(t) kernels on
    the card, the plain versions on the CPU."""
    vel = functools.partial(_lfk.velocity_plain, precision=precision)
    der = functools.partial(_lfk.deriv_plain, precision=precision)
    if device_type == "cuda":
        return _lfk._Leaves(vel, _lfk.rk4_update_cuda, der, _lfk.p_planes_cuda, True)
    return _lfk._Leaves(vel, _lfk.rk4_update_plain, der, _lfk.p_planes_plain, True)


def _planes(phi_map, smats, precision):
    p = _lfk.PLANES_PRECISION[precision]
    return _lfk._gradhess(_leaves(phi_map.device.type, p), phi_map, smats)


def _apply(phi_map, f_map, t0, t1, nsteps, smats, precision, kind="forward"):
    """The forward flow t0 -> t1, or the adjoint flow t1 -> t0, on blocks."""
    leaves = _leaves(f_map.device.type, precision)
    phi = _planes(phi_map, smats, precision)
    if kind == "forward":
        return _lfk._flow_apply(leaves, f_map, phi, smats, t0, t1, nsteps, "forward")
    return _lfk._flow_apply(leaves, f_map, phi, smats, t1, t0, nsteps, "adjoint")


def _bwd(phi_map, f1, dy, t0, t1, nsteps, smats, precision):
    """The transpose-delta flow of the forward flow t0 -> t1 on blocks:
    (dphi, df0)."""
    leaves = _leaves(f1.device.type, precision)
    phi = _planes(phi_map, smats, precision)
    return _lfk._flow_bwd(leaves, dy.contiguous(), f1, phi, smats, t0, t1, nsteps)


class _ShardedFlow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, phi_map, f_map, t0, t1, nsteps, smats, precision):
        out = _apply(phi_map, f_map, t0, t1, nsteps, smats, precision)
        ctx.save_for_backward(phi_map, out)
        ctx.args = (t0, t1, nsteps, smats, precision)
        return out

    @staticmethod
    def backward(ctx, dy):
        phi_map, f1 = ctx.saved_tensors
        dphi, df0 = _bwd(phi_map, f1, dy, *ctx.args)
        return dphi, df0, None, None, None, None, None


class _ShardedFlowAdjoint(torch.autograd.Function):
    """L(phi)^H on blocks; its VJP by <u, L^H f> = <L u, f>."""

    @staticmethod
    def forward(ctx, phi_map, f_map, t0, t1, nsteps, smats, precision):
        out = _apply(phi_map, f_map, t0, t1, nsteps, smats, precision, kind="adjoint")
        ctx.save_for_backward(phi_map, f_map)
        ctx.args = (t0, t1, nsteps, smats, precision)
        return out

    @staticmethod
    def backward(ctx, u):
        phi_map, f_map = ctx.saved_tensors
        t0, t1, nsteps, smats, precision = ctx.args
        Lu = _apply(phi_map, u.contiguous(), t0, t1, nsteps, smats, precision)
        dphi, _ = _bwd(phi_map, Lu, f_map, *ctx.args)
        return dphi, Lu, None, None, None, None, None


# =========================================================================
# public operator
# =========================================================================

class ShardedLenseFlow:
    """LenseFlow over a map whose rows are split over the mesh dimension
    `axis_name`: the FlowOp surface of models/lenseflow.py::LenseFlow
    (L @ f, L.H @ f, L.solve, L.H.solve, L(phi')), f and phi this rank's
    y-sharded blocks (shard_spatial) in their map basis, batch entries
    this rank's over batch_axis on a 2-D mesh. The flows run at the matmul
    precision in force (ops/deriv.py), recorded for the backward pass."""

    __slots__ = ("phi", "nsteps", "mesh", "axis_name", "t0", "t1", "_adjoint", "batch_axis")

    def __init__(self, phi: Field, nsteps: int = 7, mesh=None, axis_name="sp", t0=0.0, t1=1.0,
                 _adjoint=False, batch_axis=None):
        if mesh is None:
            mesh = spatial_mesh(axis_name=axis_name, device=phi.device.type)
        _check_divisible(phi.proj, mesh, axis_name)
        self.phi = phi
        self.nsteps = nsteps
        self.mesh = mesh
        self.axis_name = axis_name
        self.t0 = t0
        self.t1 = t1
        self._adjoint = _adjoint
        self.batch_axis = batch_axis

    def _with(self, **kw):
        args = dict(phi=self.phi, nsteps=self.nsteps, mesh=self.mesh, axis_name=self.axis_name,
                    t0=self.t0, t1=self.t1, _adjoint=self._adjoint, batch_axis=self.batch_axis)
        args.update(kw)
        return ShardedLenseFlow(**args)

    def __call__(self, phi_or_theta):
        if isinstance(phi_or_theta, Field):
            return self._with(phi=phi_or_theta)
        return self

    @property
    def H(self):
        return self._with(_adjoint=not self._adjoint)

    def inv(self):
        return self._with(t0=self.t1, t1=self.t0)

    pinv = inv

    def _go(self, f: Field, t0, t1):
        B = f.basis
        if lense_basis(B) != B:
            # a basis conversion of a sharded field would FFT the whole map
            # across the ranks, outside the pencil scheme
            raise ValueError(
                f"ShardedLenseFlow needs fields in their lense basis (e.g. QU map); got {B}. "
                f"Convert with f.to_lense() BEFORE shard_spatial(): converting a sharded field "
                f"would FFT the full map across devices.")
        if not self.phi.basis.is_map:
            raise ValueError(f"ShardedLenseFlow needs phi's y-sharded map basis; got "
                             f"{self.phi.basis}")
        phi_map, farr = self.phi.arr, f.arr
        if phi_map.shape[:-3] != farr.shape[:-3]:
            batch = torch.broadcast_shapes(phi_map.shape[:-3], farr.shape[:-3])
            phi_map = phi_map.expand(batch + phi_map.shape[-3:])
            farr = farr.expand(batch + farr.shape[-3:])
        smats = sharded_derivs(f.proj, self.mesh, self.axis_name)
        fn = _ShardedFlowAdjoint if self._adjoint else _ShardedFlow
        out = fn.apply(phi_map, farr, float(t0), float(t1), int(self.nsteps), smats,
                       _deriv.matmul_precision())
        return Field(out, B, f.proj)

    def __matmul__(self, f: Field) -> Field:
        return self._go(f, self.t0, self.t1)

    def solve(self, f: Field) -> Field:
        return self._go(f, self.t1, self.t0)

    def __repr__(self):
        return (f"ShardedLenseFlow(nsteps={self.nsteps}, mesh={tuple(self.mesh.shape)}"
                f"{', adjoint' if self._adjoint else ''})")


def lense_sharded(phi: Field, f: Field, nsteps: int = 7, mesh=None, axis_name="sp",
                  batch_axis=None) -> Field:
    """f lensed by phi, both y-sharded over the mesh's spatial dimension."""
    return ShardedLenseFlow(phi, nsteps, mesh, axis_name, batch_axis=batch_axis) @ f
