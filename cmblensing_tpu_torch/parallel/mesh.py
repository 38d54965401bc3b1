"""Device meshes over torch.distributed ranks, and batch sharding.

Counterpart of ``cmblensing_tpu/parallel/mesh.py``. The JAX package runs
one controller over sharded global arrays; the port runs SPMD: one
process a rank, each holding its block, the mesh a
``torch.distributed.device_mesh.DeviceMesh`` whose dimensions are named
as the JAX package's mesh axes ("batch", "sp", or both). A function the
JAX package returns as a global array returns this rank's block here;
`gather_batch` (and parallel/spatial.py::gather_spatial) assemble the
whole for callers and tests.

Backends: NCCL on "cuda", gloo on "cpu"; gloo on "cuda" only when the
caller names it. NCCL refuses two ranks on one card ("Duplicate GPU
detected"), so `make_mesh` raises for that rather than switch backend.
Several ranks sharing one card go over gloo, which takes CUDA tensors
for every collective used here and moves them through the host: a check
of the decomposition, not a multi-card time.

The collectives (`all_reduce`, `all_gather`, `all_to_all_single`,
`broadcast`) count the bytes each kind sends from this rank in
COLLECTIVE_BYTES.

Ensembles: `batch_shard` gives this rank's slice of a batch of sims or
chains (core/shard.py); MAP_marg, sample_joint and muse take ``mesh=``
and run their ensembles through it.
"""
from __future__ import annotations

import datetime
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from ..core import shard as _shard
from ..core.field import Field

# bytes each kind of collective sent from this rank (counted where it is called)
COLLECTIVE_BYTES = {"all_to_all": 0, "all_reduce": 0, "all_gather": 0, "broadcast": 0}


def reset_collective_bytes():
    for k in COLLECTIVE_BYTES:
        COLLECTIVE_BYTES[k] = 0


def _default_backend(device_type):
    return "nccl" if device_type == "cuda" else "gloo"


def distributed_initialize(coordinator_address=None, num_processes=None, process_id=None,
                           initialization_timeout=None, backend=None):
    """Join this process to a torch.distributed world (the JAX package's
    jax.distributed.initialize): coordinator_address "host:port" (rank
    0's TCP store), num_processes ranks, this one process_id; without
    them the torchrun variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
    RANK). backend: "nccl" when a card is present, else "gloo", unless
    given. A no-op when already initialized or when nothing multi-process
    was asked for; a requested setup that cannot connect raises (within
    initialization_timeout seconds when given)."""
    requested = (coordinator_address is not None or num_processes is not None
                 or process_id is not None or bool(os.environ.get("MASTER_ADDR")))
    if dist.is_initialized() or not requested:
        return
    if backend is None:
        backend = _default_backend("cuda" if torch.cuda.is_available() else "cpu")
    kw = {}
    if initialization_timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(initialization_timeout))
    init = f"tcp://{coordinator_address}" if coordinator_address is not None else "env://"
    world = int(num_processes if num_processes is not None else os.environ["WORLD_SIZE"])
    rank = int(process_id if process_id is not None else os.environ["RANK"])
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank, **kw)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


_MESHES = {}


def _device_mesh(shape, names, device, backend):
    """The DeviceMesh of `shape` over every rank of the world, made once
    per (shape, names, device type). One process with no world joins a
    world of one rank first."""
    device = torch.device(device)
    backend = backend or _default_backend(device.type)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the NCCL backend takes CUDA tensors: pass device='cuda' or "
                         "backend='gloo'")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=f"tcp://localhost:{_free_port()}",
                                world_size=1, rank=0)
    elif dist.get_backend() != backend:
        raise ValueError(f"this world runs {dist.get_backend()!r}; a {backend!r} mesh needs a "
                         f"world initialized with it (distributed_initialize(backend=...))")
    world = dist.get_world_size()
    n = int(np.prod(shape))
    if n != world:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {n} ranks; this world has {world}")
    if backend == "nccl" and world > torch.cuda.device_count():
        raise ValueError(f"NCCL does not accept two ranks on one device ('Duplicate GPU "
                         f"detected'): {world} ranks on {torch.cuda.device_count()} card(s); "
                         "share a card over backend='gloo'")
    key = (tuple(shape), tuple(names), device.type)
    mesh = _MESHES.get(key)
    if mesh is None:
        from torch.distributed.device_mesh import init_device_mesh
        mesh = _MESHES[key] = init_device_mesh(device.type, tuple(shape),
                                               mesh_dim_names=tuple(names))
    return mesh


def make_mesh(n_devices=None, axis_name="batch", device="cuda", backend=None):
    """A 1-D mesh named `axis_name` over the world's ranks (n_devices of
    them: the world's size, which it must equal when given); NCCL on
    "cuda", gloo on "cpu", or `backend`."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return _device_mesh((n_devices or world,), (axis_name,), device, backend)


def local_mesh(axis_name="batch", device="cuda", backend=None):
    return make_mesh(axis_name=axis_name, device=device, backend=backend)


# =========================================================================
# collectives over one mesh dimension
# =========================================================================

def axis_size(mesh, axis_name):
    return dist.get_world_size(mesh.get_group(axis_name))


def axis_rank(mesh, axis_name):
    return dist.get_rank(mesh.get_group(axis_name))


def all_reduce(t, mesh, axis_name, op="sum"):
    """t summed ('sum') or maximized ('max') over the ranks of the mesh
    dimension; a new tensor (t is not written)."""
    group = mesh.get_group(axis_name)
    if dist.get_world_size(group) == 1:
        return t
    COLLECTIVE_BYTES["all_reduce"] += t.numel() * t.element_size()
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    buf = t.detach().clone()
    dist.all_reduce(buf, op=rop, group=group)
    return buf


def all_gather(t, mesh, axis_name, dim=0):
    """Every rank's t of the mesh dimension, concatenated along `dim` in
    rank order."""
    group = mesh.get_group(axis_name)
    P = dist.get_world_size(group)
    if P == 1:
        return t
    COLLECTIVE_BYTES["all_gather"] += t.numel() * t.element_size()
    src = t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(P)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def all_to_all_single(buf, mesh, axis_name):
    """The tiled all_to_all of a contiguous (P, ...) real buffer: block j
    goes to rank j, and block j of the result came from rank j."""
    group = mesh.get_group(axis_name)
    if dist.get_world_size(group) == 1:
        return buf
    COLLECTIVE_BYTES["all_to_all"] += buf.numel() * buf.element_size()
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf.contiguous(), group=group)
    return out


def broadcast(t, mesh, axis_name):
    """t of the dimension's rank 0 on every rank of it."""
    group = mesh.get_group(axis_name)
    if dist.get_world_size(group) == 1:
        return t
    COLLECTIVE_BYTES["broadcast"] += t.numel() * t.element_size()
    src = dist.get_global_rank(group, 0)
    buf = t.detach().clone().contiguous()
    dist.broadcast(buf, src=src, group=group)
    return buf


def barrier(mesh):
    """Return once every rank of the mesh has called it (a zero summed
    over each dimension)."""
    dev = "cuda" if mesh.device_type == "cuda" else "cpu"
    for name in mesh.mesh_dim_names:
        all_reduce(torch.zeros(1, device=dev), mesh, name)


# =========================================================================
# batch sharding
# =========================================================================

class BatchSharding:
    """This rank's contiguous slice of a batch axis split over the mesh
    dimension `axis_name` (the JAX package's NamedSharding(mesh,
    P(axis_name))): `slice(n)` for a batch of n, the whole batch where n
    does not divide over the ranks (replicated)."""

    def __init__(self, mesh, axis_name="batch"):
        self.mesh, self.axis_name = mesh, axis_name
        self.size, self.rank = axis_size(mesh, axis_name), axis_rank(mesh, axis_name)

    def divides(self, n):
        return n % self.size == 0

    def slice(self, n):
        if not self.divides(n):
            return slice(None)
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)


def batch_sharding(mesh, axis_name="batch"):
    return BatchSharding(mesh, axis_name)


def shard_batch(f, mesh=None, axis_name="batch", batch_size=None):
    """This rank's slice of the leading (batch) axis of a batched Field.
    An unbatched Field, or one whose batch does not divide over the mesh
    dimension, is replicated (returned whole). In dicts, lists and tuples
    only Field leaves are sharded, and a tensor leaf only when batch_size
    is given and its leading dimension equals it: a bare (Ny, Nx) mask or
    (ncomp, Ny, Nx) plane is never cut along a spatial or component axis."""
    if mesh is None:
        mesh = make_mesh(axis_name=axis_name)
    sh = BatchSharding(mesh, axis_name)

    def one(x):
        if isinstance(x, Field):
            if not x.batch_shape:
                return x
            return Field(x.arr[sh.slice(x.batch_shape[0])], x.basis, x.proj)
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(one(v) for v in x)
        if (batch_size is not None and isinstance(x, torch.Tensor) and x.ndim >= 1
                and x.shape[0] == batch_size):
            return x[sh.slice(batch_size)]
        return x

    return one(f)


def gather_batch(f, mesh, axis_name="batch"):
    """The whole batch of a batch-sharded Field or tensor, on every rank
    (the JAX package's implicit gather of a sharded array)."""
    if isinstance(f, Field):
        return Field(all_gather(f.arr, mesh, axis_name, 0), f.basis, f.proj)
    return all_gather(f, mesh, axis_name, 0)


def replicate(x, mesh=None, axis_name="batch"):
    """x as mesh coordinate 0 holds it, on every rank (tensor and Field
    leaves of dicts, lists and tuples broadcast along each dimension)."""
    if mesh is None:
        mesh = make_mesh(axis_name=axis_name)

    def one(v):
        if isinstance(v, Field):
            return Field(one(v.arr), v.basis, v.proj)
        if isinstance(v, dict):
            return {k: one(w) for k, w in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(one(w) for w in v)
        if isinstance(v, torch.Tensor):
            for name in mesh.mesh_dim_names:
                v = broadcast(v, mesh, name)
        return v

    return one(x)


def batch_shard(mesh, total, axis_name="batch"):
    """The core/shard.py::BatchShard of this rank for a batch of `total`
    split over the mesh dimension, or None where it does not divide (the
    batch then runs whole on every rank)."""
    P, r = axis_size(mesh, axis_name), axis_rank(mesh, axis_name)
    if P == 1 or total % P:
        return None
    n = total // P
    return _shard.BatchShard(r * n, n, total,
                             lambda t, op: all_reduce(t, mesh, axis_name, op),
                             lambda t: all_gather(t, mesh, axis_name, 0))


def proc_info():
    """This process's place in the world (the JAX package's keys)."""
    init = dist.is_initialized()
    return dict(process_index=dist.get_rank() if init else 0,
                process_count=dist.get_world_size() if init else 1,
                local_device_count=torch.cuda.device_count(),
                device_count=dist.get_world_size() if init else 1)
