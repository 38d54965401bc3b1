"""ODE and linear solvers.

Counterpart of ``cmblensing_tpu/ops/solvers.py`` (reference
src/numerical_algorithms.jl): fixed-step RK4 over tuples of Fields or
tensors, preconditioned conjugate gradient (and a host-stepped variant
that records a history), GMRES, and the inner product they run on. The
JAX ``while_loop`` / ``scan`` becomes a host loop. With ``fixed_iters``
CG runs exactly ``nsteps`` iterations and never reads a device value
back, so the iterations queue on the device without a host sync;
otherwise each iteration reads the residual to decide whether to go on.
"""
from __future__ import annotations

import time

import torch

from ..core import shard as _shard
from ..core.field import Field, dot as field_dot
from ..core.proj_equirect import EquiRectField, coef_dot


def _tmap(fn, *trees):
    """fn over the leaves (Fields or tensors) of tuples and lists."""
    t = trees[0]
    if isinstance(t, (tuple, list)):
        return type(t)(_tmap(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def tree_dot(a, b):
    """Inner product summed over the leaves of a and b: the field dot
    for Fields (per batch entry for batched Fields), the coefficient dot
    (proj_equirect.coef_dot, per batch entry) for EquiRectFields, the real
    part of the conjugate product's sum for tensors."""
    tot = None
    for xa, xb in zip(_leaves(a), _leaves(b)):
        if isinstance(xa, Field):
            d = field_dot(xa, xb)
        elif isinstance(xa, EquiRectField):
            d = coef_dot(xa, xb)
        else:
            d = torch.sum(torch.real(torch.conj(xa) * xb))
        tot = d if tot is None else tot + d
    return tot


def _bb(s, leaf):
    """A per-batch scalar s shaped to broadcast against the leaf's array."""
    arr = getattr(leaf, "arr", leaf)
    if not isinstance(s, torch.Tensor) or s.ndim == 0:
        return s
    return s.reshape(s.shape + (1,) * (arr.ndim - s.ndim))


def tree_axpy(a, x, y):
    """y + a x over the leaves (Fields or tensors) of tuples and lists; a
    a scalar, or a tensor with one value a batch entry."""
    return _tmap(lambda xi, yi: yi + xi * _bb(a, xi), x, y)


def _where(cond, a, b):
    """a where cond, else b, cond per batch entry."""
    def one(ai, bi):
        if hasattr(ai, "arr"):
            bi = bi.to(ai.basis)
            return type(ai)(torch.where(_bb(cond, ai), ai.arr, bi.arr), ai.basis, ai.proj)
        return torch.where(_bb(cond, ai), ai, bi)
    return _tmap(one, a, b)


def _zeros_like(tree):
    return _tmap(lambda t: type(t)(torch.zeros_like(t.arr), t.basis, t.proj)
                 if hasattr(t, "arr") else torch.zeros_like(t), tree)


def rk4_integrate(F, y0, t0, t1, nsteps: int):
    """y(t1) of dy/dt = F(t, y), y(t0) = y0, by nsteps RK4 steps; y a
    Field, a tensor, or a tuple or list of them."""
    h = (t1 - t0) / nsteps
    y = y0
    for i in range(nsteps):
        t = t0 + i * h
        k1 = F(t, y)
        k2 = F(t + h / 2, tree_axpy(h / 2, k1, y))
        k3 = F(t + h / 2, tree_axpy(h / 2, k2, y))
        k4 = F(t + h, tree_axpy(h, k3, y))
        y = _tmap(lambda yi, a, b, c, d: yi + (a + 2 * (b + c) + d) * (h / 6), y, k1, k2, k3, k4)
    return y


def _apply(op, x):
    return op(x) if callable(op) and not hasattr(op, "solve") else op @ x


def _solve(op, x):
    return op(x) if callable(op) and not hasattr(op, "solve") else op.solve(x)


def conjugate_gradient(M, A, b, x0=None, nsteps=500, tol=1e-1, fixed_iters=False,
                       record_history=False, dot=tree_dot, shard=None):
    """Solve A x = b (A positive definite) by preconditioned CG.

    M is an operator like A whose ``solve`` applies the preconditioner
    (or a plain callable that does); A is an operator or a callable.
    Stops when the per-batch residual dot(r, M^-1 r) is below tol for
    every batch entry, or after nsteps; with fixed_iters it runs all
    nsteps. Returns (bestx, info): the iterate of smallest residual per
    batch entry, and info with "iterations", "res" (that residual) and
    "res0". record_history=True adds "res_history", the (nsteps+1, ...)
    residual trace, NaN past the last iteration; record_history may also
    be a tuple of keys from ("res", "x", "r"), and "x" and "r" add
    "x_history" and "r_history", the iterates and residuals stacked the
    same way along a leading axis (Fields in the first one's basis);
    they hold nsteps + 1 states, so keep nsteps small. `dot` is the inner
    product (per batch entry): a sharded solve passes one that sums over
    the ranks. The stop test reads every entry's residual, with `shard`
    (core/shard.py::BatchShard) every rank's."""
    keys = (("res",) if record_history is True else (record_history,)
            if isinstance(record_history, str) else tuple(record_history or ()))
    unknown = set(keys) - {"res", "x", "r"}
    if unknown:
        raise ValueError(f"record_history keys {sorted(unknown)}: one of 'res', 'x', 'r'")
    if x0 is None:
        x0 = _zeros_like(b)
    r = _tmap(lambda bi, axi: bi - axi, b, _apply(A, x0))
    z = _solve(M, r)
    p = z
    res = res0 = dot(r, z)
    x, bestx, bestres = x0, x0, res0
    hist = {"res": [res0], "x": [x0], "r": [r]}
    i = 0
    while i < nsteps:
        if not fixed_iters and not _shard.any_(shard, res > tol):
            break
        Ap = _apply(A, p)
        pAp = dot(p, Ap)
        # guarded divisions: in fixed-iteration mode the loop runs past
        # convergence, where res and pAp underflow to 0
        alpha = torch.where(pAp != 0, res / torch.where(pAp != 0, pAp, torch.ones_like(pAp)),
                            torch.zeros_like(pAp))
        x = tree_axpy(alpha, p, x)
        r = tree_axpy(-alpha, Ap, r)
        z = _solve(M, r)
        res_new = dot(r, z)
        beta = torch.where(res != 0, res_new / torch.where(res != 0, res, torch.ones_like(res)),
                           torch.zeros_like(res))
        p = tree_axpy(beta, p, z)
        better = res_new < bestres
        bestx = _where(better, x, bestx)
        bestres = torch.where(better, res_new, bestres)
        res = res_new
        for key, val in (("res", res), ("x", x), ("r", r)):
            if key in keys:
                hist[key].append(val)
        i += 1
    info = {"iterations": i, "res": bestres, "res0": res0}
    for key in keys:
        info[f"{key}_history"] = _tmap(lambda *xs: _stack_nan(xs, nsteps + 1), *hist[key])
    return bestx, info


def _stack_nan(xs, n):
    """Tensors or fields xs stacked along a new leading axis, padded with
    NaN to n entries (fields in the first one's basis)."""
    if hasattr(xs[0], "arr"):
        f0 = xs[0]
        arr = _stack_nan([x.to(f0.basis).arr for x in xs], n)
        return type(f0)(arr, f0.basis, f0.proj)
    pad = [torch.full_like(xs[0], float("nan"))] * (n - len(xs))
    return torch.stack(list(xs) + pad)


def conjugate_gradient_with_history(M, A, b, x0=None, nsteps=100, tol=1e-1,
                                    history_keys=("i", "res")):
    """CG that reads every iteration's residual on the host and records a
    history of dicts with the keys asked for, of "i", "res", "x", "r" and
    "t" (seconds since the start). Stops once every batch entry's
    residual is below tol, or after nsteps. Returns (bestx, history), bestx
    the iterate of smallest residual (all entries at once). For
    diagnostics: `conjugate_gradient` is the solver."""
    t0 = time.time()
    if x0 is None:
        x0 = _zeros_like(b)
    x = x0
    r = _tmap(lambda bi, ai: bi - ai, b, _apply(A, x))
    z = _solve(M, r)
    p = z
    res = tree_dot(r, z)
    bestres, bestx = res, x
    history = []

    def rec(i):
        vals = dict(i=i, res=res, x=x, r=r, t=time.time() - t0)
        history.append({k: vals[k] for k in history_keys if k in vals})

    rec(0)
    for i in range(1, nsteps + 1):
        Ap = _apply(A, p)
        alpha = res / tree_dot(p, Ap)
        x = tree_axpy(alpha, p, x)
        r = tree_axpy(-alpha, Ap, r)
        z = _solve(M, r)
        res_new = tree_dot(r, z)
        p = tree_axpy(res_new / res, p, z)
        res = res_new
        if bool(torch.all(res < bestres)):
            bestres, bestx = res, x
        rec(i)
        if bool(torch.all(res < tol)):
            break
    return bestx, history


def _flat(tree):
    """(the leaves of a tree of tensors as one flat vector, the function
    back from such a vector to the tree)."""
    leaves = _leaves(tree)

    def back(v):
        parts = iter(v.split([t.numel() for t in leaves]))
        return _tmap(lambda t: next(parts).reshape(t.shape), tree)

    return torch.cat([t.reshape(-1) for t in leaves]), back


def gmres(A, b, maxiter, Pl=None, method="arnoldi"):
    """x of A x = b by GMRES of `maxiter` Krylov vectors from x0 = 0, left
    preconditioned by Pl (solving Pl A x = Pl b); b and A's values tensors
    or tuples or lists of them. method="arnoldi" (the default): a basis
    orthonormalized by modified Gram-Schmidt, a dead direction (happy
    breakdown) zeroed, y the least-squares solution of the (maxiter + 1,
    maxiter) Hessenberg system by its pseudo-inverse. method="power": the
    reference's scheme, the unorthogonalized basis (Pl A)^i Pl b solved by
    least squares; its columns become dependent past ~10 iterations. Every
    step is a torch op, so autograd differentiates through the solve."""
    if method not in ("arnoldi", "power"):
        raise ValueError(f"method={method!r}: 'arnoldi' or 'power'")
    bv, back = _flat(b)
    flat = lambda t: _flat(t)[0]
    apply_A = lambda v: flat(A(back(v)))
    apply_P = (lambda v: v) if Pl is None else (lambda v: flat(Pl(back(v))))
    n = maxiter
    bv = apply_P(bv)
    if method == "power":
        if maxiter > 12:
            import warnings
            warnings.warn("gmres: the unorthogonalized power-Krylov basis degenerates beyond "
                          "~10 iterations (use method='arnoldi')", stacklevel=2)
        K = [bv]
        for _ in range(n):
            K.append(apply_P(apply_A(K[-1])))
        alpha = torch.linalg.pinv(torch.stack(K[1:], dim=1)) @ K[0]
        return back(torch.stack(K[:n], dim=1) @ alpha)
    eps = torch.finfo(bv.dtype).tiny ** 0.5
    beta = torch.linalg.vector_norm(bv)
    V = [bv / torch.clamp(beta, min=eps)]
    cols = []
    for j in range(n):
        w = apply_P(apply_A(V[j]))
        hj = []
        for i in range(j + 1):
            h = torch.dot(V[i], w)
            w = w - h * V[i]
            hj.append(h)
        hnext = torch.linalg.vector_norm(w)
        hj.append(hnext)
        live = hnext > eps * torch.clamp(beta, min=1.0)
        V.append(torch.where(live, w / torch.clamp(hnext, min=eps), torch.zeros_like(w)))
        cols.append(torch.cat([torch.stack(hj), bv.new_zeros(n - 1 - j)]))
    H = torch.stack(cols, dim=1)   # (n + 1, n), upper Hessenberg
    e1 = torch.cat([beta.reshape(1), bv.new_zeros(n)])
    y = torch.linalg.pinv(H) @ e1
    return back(torch.stack(V[:n], dim=1) @ y)
