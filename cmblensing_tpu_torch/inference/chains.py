"""Chain containers, loading, and statistics (reference src/chains.jl).

The port's own copy of ``cmblensing_tpu/inference/chains.py``: the
statistics are numpy; a chain's fields are Fields on the host (torch CPU
tensors), its per-chain scalars (logpdf, accept, dH) CPU tensors.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..core.field import Field, batch_index


class Chain(list):
    """One chain: a list of state dicts, with recursive key indexing:
    chain['phi'] returns the list of phi samples (reference Chain,
    src/chains.jl:90-111)."""

    def __getitem__(self, k):
        if isinstance(k, str):
            return [state.get(k) for state in self]
        return super().__getitem__(k)

    def last(self, k):
        for state in reversed(self):
            if k in state and state[k] is not None:
                return state[k]
        return None


class Chains(list):
    """A list of Chain (src/chains.jl:113-138)."""

    def __init__(self, chains):
        super().__init__([c if isinstance(c, Chain) else Chain(c) for c in chains])

    def __getitem__(self, k):
        if isinstance(k, str):
            return [c[k] for c in self]
        return super().__getitem__(k)


def load_chains(filename, burnin=0, thin=1, join=False, unbatch_chains=True):
    """Reassemble chains from the checkpoint record file written by
    sample_joint (reference load_chains, src/chains.jl:45-86)."""
    from ..native import read_records
    path = f"{filename}.ckpt"
    if not os.path.exists(path):
        raise FileNotFoundError(f"no chain checkpoint at {path}")
    chunks = [pickle.loads(r)["chunk"] for r in read_records(path)]
    if not chunks:
        raise FileNotFoundError(f"no valid records in {path}")
    chain = [s for ch in chunks for s in ch]
    chain = chain[burnin::thin]

    # a batched chain (leading chain axis on fields) unbatches into
    # per-chain Chains (src/chains.jl:151-177)
    if unbatch_chains:
        nb = 1
        for s in chain:
            for v in s.values():
                if isinstance(v, Field) and v.batch_shape:
                    nb = max(nb, v.batch_shape[0])
        if nb > 1:
            out = []
            for b in range(nb):
                cb = []
                for s in chain:
                    sb = {}
                    for k, v in s.items():
                        if isinstance(v, Field) and v.batch_shape:
                            sb[k] = batch_index(v, b)
                        elif (isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim >= 1
                              and v.shape[0] == nb):
                            sb[k] = v[b]
                        else:
                            sb[k] = v
                    cb.append(sb)
                out.append(cb)
            chains = Chains(out)
        else:
            chains = Chains([chain])
    else:
        chains = Chains([chain])
    if join:
        joined = Chain([s for c in chains for s in c])
        return Chains([joined])
    return chains


def effective_sample_size(x):
    """ESS via the initial-positive-sequence autocorrelation estimator."""
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    if n < 4:
        return float(n)
    x = x - x.mean()
    acf = np.correlate(x, x, mode="full")[n - 1:] / (np.arange(n, 0, -1) * (x.var() + 1e-300))
    # sum pairs until a pair goes negative (Geyer)
    tau = 1.0
    for k in range(1, n // 2):
        pair = acf[2 * k - 1] + acf[2 * k] if 2 * k < n else acf[2 * k - 1]
        if pair < 0:
            break
        tau += 2 * pair
    return float(n / max(tau, 1.0))


def mean_std_and_errors(samples, nbootstrap=200, seed=0):
    """Mean/std with bootstrap + ESS uncertainties on each
    (reference mean_std_and_errors, src/chains.jl:188-200)."""
    x = np.asarray(samples, dtype=np.float64)
    ess = effective_sample_size(x)
    rng = np.random.default_rng(seed)
    means, stds = [], []
    n = len(x)
    block = max(1, int(n / max(ess, 1)))
    nblocks = n // block
    for _ in range(nbootstrap):
        idx = rng.integers(0, nblocks, nblocks)
        resampled = np.concatenate([x[i * block:(i + 1) * block] for i in idx])
        means.append(resampled.mean())
        stds.append(resampled.std())
    return dict(mean=float(x.mean()), std=float(x.std()),
                mean_err=float(np.std(means)), std_err=float(np.std(stds)),
                ess=ess)


def _norm_pdf(u):
    return np.exp(-0.5 * u * u) / np.sqrt(2 * np.pi)


def _norm_cdf(u):
    from scipy.special import ndtr
    return ndtr(u)


def _partial_moments(x, lo, hi, h):
    """(a0, a1, a2): partial Gaussian-kernel moments over the allowed
    offsets u with x - u*h inside [lo, hi] (closed forms)."""
    a = np.full_like(x, -np.inf) if hi is None else (x - hi) / h
    b = np.full_like(x, np.inf) if lo is None else (x - lo) / h
    Phi = _norm_cdf(b) - _norm_cdf(a)
    # guard the infinite endpoints BEFORE the multiply (inf * 0 emits a
    # RuntimeWarning even when the result is masked afterward)
    af = np.where(np.isfinite(a), a, 0.0)
    bf = np.where(np.isfinite(b), b, 0.0)
    pa = _norm_pdf(af) * np.isfinite(a)
    pb = _norm_pdf(bf) * np.isfinite(b)
    a0 = Phi
    a1 = pa - pb
    a2 = Phi + af * pa - bf * pb
    return a0, a1, a2


def _bandwidth(x, bw_scale):
    """Scott's rule (scipy.gaussian_kde default) times bw_scale."""
    n = x.shape[0]
    return float(np.std(x) * n ** (-1.0 / 5.0) * bw_scale) or 1e-12


def _kernel_matrix_corrected(grid, xcol, h, boundary):
    """(len(grid), n) Gaussian kernel matrix, with the getdist-style
    LINEAR boundary kernel applied when `boundary` is given
    (chains.jl:236-260 uses getdist's boundary-corrected KDEs): the
    kernel K(u) is replaced by K(u) (alpha + beta u) with
    alpha = a2/(a0 a2 - a1^2), beta = -a1/(a0 a2 - a1^2), which removes
    both the mass loss AND the O(h) slope bias at a hard prior edge."""
    u = (grid[:, None] - xcol[None, :]) / h
    K = _norm_pdf(u)
    if boundary is None:
        return K
    a0, a1, a2 = _partial_moments(grid, boundary[0], boundary[1], h)
    den = np.maximum(a0 * a2 - a1 ** 2, 1e-30)
    return K * ((a2 / den)[:, None] + (-a1 / den)[:, None] * u)


def _inside_mask(grid, boundary):
    inside = np.ones_like(grid, dtype=bool)
    if boundary is not None:
        if boundary[0] is not None:
            inside &= grid >= boundary[0]
        if boundary[1] is not None:
            inside &= grid <= boundary[1]
    return inside


def _kde1d_corrected(x, grid, h, boundary):
    K = _kernel_matrix_corrected(grid, x, h, boundary)
    f = np.maximum(K.sum(axis=1), 0.0) / (x.shape[0] * h)
    if boundary is not None:
        f = np.where(_inside_mask(grid, boundary), f, 0.0)
    return f


def _kde2d_linear_boundary(gx, gy, x, hx, hy, bx, by):
    """Exact 2-D linear boundary kernel (what getdist's 2-D
    boundary-corrected KDE computes, src/chains.jl:236-260): at each
    grid point the Gaussian kernel is replaced by
    K(u,v) (alpha + beta u + gamma v) with (alpha, beta, gamma) solving
    the local moment system

        [M00 M10 M01] [alpha]   [1]
        [M10 M20 M11] [beta ] = [0]
        [M01 M11 M02] [gamma]   [0]

    over the ALLOWED offsets only. For a rectangular prior region the
    partial moments factor per axis, Mpq = a_p^x a_q^y, so the system
    is built from the same closed-form 1-D partial moments as the 1-D
    kernel. Along a single active edge this reduces to the separable
    per-axis correction; near a CORNER (both a1x and a1y nonzero) the
    separable form's forced bilinear u*v term biases the estimate —
    this solve is the difference (tests/test_inference.py::
    test_kde2d_corner_exact)."""
    a0x, a1x, a2x = _partial_moments(gx, bx[0] if bx else None,
                                     bx[1] if bx else None, hx)
    a0y, a1y, a2y = _partial_moments(gy, by[0] if by else None,
                                     by[1] if by else None, hy)
    # moment matrices as (gy, gx) grids via outer products
    M00 = a0y[:, None] * a0x[None, :]
    M10 = a0y[:, None] * a1x[None, :]
    M01 = a1y[:, None] * a0x[None, :]
    M20 = a0y[:, None] * a2x[None, :]
    M02 = a2y[:, None] * a0x[None, :]
    M11 = a1y[:, None] * a1x[None, :]
    # closed-form 3x3 symmetric solve for [alpha, beta, gamma] =
    # Minv @ [1, 0, 0]: only the first column of the inverse is needed
    det = (M00 * (M20 * M02 - M11 * M11)
           - M10 * (M10 * M02 - M11 * M01)
           + M01 * (M10 * M11 - M20 * M01))
    det = np.where(np.abs(det) > 1e-30, det, np.inf)
    alpha = (M20 * M02 - M11 * M11) / det
    beta = -(M10 * M02 - M11 * M01) / det
    gamma = (M10 * M11 - M20 * M01) / det

    ux = (gx[:, None] - x[None, :, 0]) / hx          # (gx, n)
    vy = (gy[:, None] - x[None, :, 1]) / hy          # (gy, n)
    Kx0 = _norm_pdf(ux)
    Ky0 = _norm_pdf(vy)
    A = Ky0 @ Kx0.T                                   # (gy, gx)
    B = Ky0 @ (Kx0 * ux).T
    C = (Ky0 * vy) @ Kx0.T
    return alpha * A + beta * B + gamma * C


def kde(samples, grid=None, bw_scale=1.0, boundary=None):
    """1-D or 2-D KDE of samples, with optional hard-boundary
    correction (the reference delegates to getdist's boundary-corrected
    KDEs, src/chains.jl:236-260; here first-party).

    boundary: 1-D — (lo, hi), either side None for unbounded; the
    estimate uses a linear boundary kernel (publication-grade at prior
    edges, e.g. r >= 0 or Aphi >= 0). 2-D — ((lox, hix), (loy, hiy));
    the exact 2-D linear boundary kernel (local 3x3 moment solve, see
    _kde2d_linear_boundary), correct along edges AND at corners of a
    doubly-bounded posterior."""
    x = np.asarray(samples, dtype=np.float64)
    if x.ndim == 1:
        h = _bandwidth(x, bw_scale)
        if grid is None:
            lo = x.min() if boundary is None or boundary[0] is None else max(x.min() - 3 * h, boundary[0])
            hi = x.max() if boundary is None or boundary[1] is None else min(x.max() + 3 * h, boundary[1])
            grid = np.linspace(lo, hi, 200)
        return grid, _kde1d_corrected(x, np.asarray(grid, np.float64), h, boundary)

    hx = _bandwidth(x[:, 0], bw_scale)
    hy = _bandwidth(x[:, 1], bw_scale)
    bx, by = (boundary if boundary is not None else (None, None))
    if grid is None:
        gx = np.linspace(x[:, 0].min(), x[:, 0].max(), 100)
        gy = np.linspace(x[:, 1].min(), x[:, 1].max(), 100)
    else:
        gx, gy = (np.asarray(g, np.float64) for g in grid)
    if boundary is None:
        Kx = _kernel_matrix_corrected(gx, x[:, 0], hx, None)   # (gx, n)
        Ky = _kernel_matrix_corrected(gy, x[:, 1], hy, None)   # (gy, n)
        F = np.maximum(Ky @ Kx.T, 0.0) / (x.shape[0] * hx * hy)
        return gx, gy, F
    F = _kde2d_linear_boundary(gx, gy, x, hx, hy, bx, by)
    F = np.maximum(F, 0.0) / (x.shape[0] * hx * hy)
    F = np.where(_inside_mask(gx, bx)[None, :]
                 & _inside_mask(gy, by)[:, None], F, 0.0)
    return gx, gy, F
