"""Linear solvers.

Counterpart of ``cmblensing_tpu/ops/solvers.py`` (reference
src/numerical_algorithms.jl): preconditioned conjugate gradient and the
inner product it runs on. The JAX ``while_loop`` / ``scan`` becomes a
host loop. With ``fixed_iters`` it runs exactly ``nsteps`` iterations
and never reads a device value back, so the iterations queue on the
device without a host sync; otherwise each iteration reads the residual
to decide whether to go on.
"""
from __future__ import annotations

import torch

from ..core.field import Field, dot as field_dot


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
    for Fields (per batch entry for batched Fields), the real part of the
    conjugate product's sum for tensors."""
    tot = None
    for xa, xb in zip(_leaves(a), _leaves(b)):
        d = field_dot(xa, xb) if isinstance(xa, Field) else torch.sum(torch.real(torch.conj(xa) * xb))
        tot = d if tot is None else tot + d
    return tot


def _bb(s, leaf):
    """A per-batch scalar s shaped to broadcast against the leaf's array."""
    arr = leaf.arr if isinstance(leaf, Field) else leaf
    if not isinstance(s, torch.Tensor) or s.ndim == 0:
        return s
    return s.reshape(s.shape + (1,) * (arr.ndim - s.ndim))


def _axpy(a, x, y):
    """y + a x, a per batch entry."""
    return _tmap(lambda xi, yi: yi + xi * _bb(a, xi), x, y)


def _where(cond, a, b):
    """a where cond, else b, cond per batch entry."""
    def one(ai, bi):
        if isinstance(ai, Field):
            bi = bi.to(ai.basis)
            return Field(torch.where(_bb(cond, ai), ai.arr, bi.arr), ai.basis, ai.proj)
        return torch.where(_bb(cond, ai), ai, bi)
    return _tmap(one, a, b)


def _apply(op, x):
    return op(x) if callable(op) and not hasattr(op, "solve") else op @ x


def _solve(op, x):
    return op(x) if callable(op) and not hasattr(op, "solve") else op.solve(x)


def conjugate_gradient(M, A, b, x0=None, nsteps=500, tol=1e-1, fixed_iters=False,
                       record_history=False):
    """Solve A x = b (A positive definite) by preconditioned CG.

    M is an operator like A whose ``solve`` applies the preconditioner
    (or a plain callable that does); A is an operator or a callable.
    Stops when the per-batch residual dot(r, M^-1 r) is below tol for
    every batch entry, or after nsteps; with fixed_iters it runs all
    nsteps. Returns (bestx, info): the iterate of smallest residual per
    batch entry, and info with "iterations", "res" (that residual) and
    "res0". record_history=True (or "res") adds "res_history", the
    (nsteps+1, ...) residual trace, NaN past the last iteration."""
    if record_history not in (False, None, True, "res", ("res",)):
        raise NotImplementedError(f"record_history={record_history!r}: only the residual "
                                  "trace is ported")
    if x0 is None:
        x0 = _tmap(lambda bi: Field(torch.zeros_like(bi.arr), bi.basis, bi.proj)
                   if isinstance(bi, Field) else torch.zeros_like(bi), b)
    r = _tmap(lambda bi, axi: bi - axi, b, _apply(A, x0))
    z = _solve(M, r)
    p = z
    res = res0 = tree_dot(r, z)
    x, bestx, bestres = x0, x0, res0
    hist = [res0]
    i = 0
    while i < nsteps:
        if not fixed_iters and not bool(torch.any(res > tol)):
            break
        Ap = _apply(A, p)
        pAp = tree_dot(p, Ap)
        # guarded divisions: in fixed-iteration mode the loop runs past
        # convergence, where res and pAp underflow to 0
        alpha = torch.where(pAp != 0, res / torch.where(pAp != 0, pAp, torch.ones_like(pAp)),
                            torch.zeros_like(pAp))
        x = _axpy(alpha, p, x)
        r = _axpy(-alpha, Ap, r)
        z = _solve(M, r)
        res_new = tree_dot(r, z)
        beta = torch.where(res != 0, res_new / torch.where(res != 0, res, torch.ones_like(res)),
                           torch.zeros_like(res))
        p = _axpy(beta, p, z)
        better = res_new < bestres
        bestx = _where(better, x, bestx)
        bestres = torch.where(better, res_new, bestres)
        res = res_new
        hist.append(res)
        i += 1
    info = {"iterations": i, "res": bestres, "res0": res0}
    if record_history:
        pad = [torch.full_like(res0, float("nan"))] * (nsteps + 1 - len(hist))
        info["res_history"] = torch.stack(hist + pad)
    return bestx, info
