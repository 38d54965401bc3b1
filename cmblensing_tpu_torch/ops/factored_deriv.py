"""Radix-B factored circulant derivatives.

Counterpart of ``cmblensing_tpu/ops/factored_deriv.py`` (the host-side
construction) and of the in-kernel ``_fact_apply`` /
``_pack_factored`` of ``cmblensing_tpu/ops/pallas_lenseflow.py``,
without JAX. A circulant D of size N = B * A commutes with the shift
by A, so the radix-B DFT along the slow index r (n = r*A + m)
block-diagonalizes it:

    D = (F_B^H x I_A) diag_k(G_k) (F_B x I_A)

with B dense A x A blocks G_k (G_{B-k} = conj(G_k); G_0 and G_{B/2}
real). Applying D along an axis is a real butterfly over the B
channels, 2 real + (B/2 - 1) complex A x A block products, and the
inverse butterfly: (2B - 2) A x A x N products instead of one N x N x N.

The blocks are built from the same dense circulant as the kernels'
dense operands (``ops/deriv.py::_deriv_matrix``, Nyquist zeroed), so
both forms are one operator up to f32 rounding.

Packed layout, per axis: (C, A, A) with C = 2 + 2(B/2 - 1) = B, rows
[G_0, G_{B/2}, Re G_1..Re G_{B/2-1}, Im G_1..Im G_{B/2-1}]; the x-axis
blocks are stored transposed, so that d/dx is a right product. The
butterflies travel as a (2, B, B) tensor [Rf, Ri]. The y-axis blocks
also travel transposed (FYT), the layout the CUDA tile stages for both
axes (csrc/fact_tile.cuh). For the 'high' precision the blocks travel
split as well, (2, B, A, A) bfloat16 [head, residual] of FX and FYT
(FXS, FYTS), split once per operator.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch


# =========================================================================
# host-side construction (numpy)
# =========================================================================

def _block_diagonalize(D, B):
    """Split the circulant (N x N) D into its B diagonal blocks in the
    radix-B DFT domain along the slow index. Returns complex (B, A, A);
    raises if D is not shift-by-A invariant."""
    N = D.shape[0]
    if N % B:
        raise ValueError(f"radix {B} does not divide {N}")
    A = N // B
    W = np.exp(-2j * np.pi * np.outer(np.arange(B), np.arange(B)) / B)
    D4 = D.reshape(B, A, B, A)
    # the JAX package's single einsum (so its blocks, bit for bit) while
    # its B^4 A^2 multiply-adds are cheap; beyond, two contractions of
    # B^3 A^2 each, the same sums in another order (the single one takes
    # seconds at 2048 = 16 x 128 and over a minute at 4096 = 32 x 128)
    Ghat = np.einsum("rk,rasb,sl->kalb", W, D4, np.conj(W),
                     optimize=B ** 4 * A ** 2 > 2 ** 28) / B
    G = np.einsum("kakb->kab", Ghat)
    off = Ghat - np.einsum("kab,kl->kalb", G, np.eye(B))
    if not np.max(np.abs(off)) < 1e-9 * max(np.max(np.abs(G)), 1e-30):
        raise ValueError("operator is not circulant at stride A")
    return G


def _real_butterfly_mats(B):
    """(Rf, Ri): real (B x B) forward/inverse transforms mapping the B
    real r-values to the B real DOF of the Hermitian radix-B spectrum
    [u_0, Re u_1, Im u_1, ..., Re u_{B/2-1}, Im u_{B/2-1}, u_{B/2}]."""
    if B % 2:
        raise ValueError(f"radix {B} must be even")
    W = np.exp(-2j * np.pi * np.outer(np.arange(B), np.arange(B)) / B)
    rows = [np.real(W[:, 0])]
    for k in range(1, B // 2):
        rows.append(np.real(W[:, k]))
        rows.append(np.imag(W[:, k]))
    rows.append(np.real(W[:, B // 2]))
    Rf = np.stack(rows)
    return Rf, np.linalg.inv(Rf)


class FactoredOp:
    """One factored circulant as real block arrays (numpy)."""

    __slots__ = ("B", "A", "Rf", "Ri", "Gre", "Gar", "Gai")

    def __init__(self, D, B, dtype):
        G = _block_diagonalize(np.asarray(D, np.float64), B)
        self.B, self.A = B, D.shape[0] // B
        Rf, Ri = _real_butterfly_mats(B)
        self.Rf, self.Ri = Rf.astype(dtype), Ri.astype(dtype)
        kcx = range(1, B // 2)
        self.Gre = np.stack([np.real(G[0]), np.real(G[B // 2])]).astype(dtype)
        self.Gar = np.stack([np.real(G[k]) for k in kcx]).astype(dtype) if B > 2 else None
        self.Gai = np.stack([np.imag(G[k]) for k in kcx]).astype(dtype) if B > 2 else None

    def packed(self, transpose):
        """(C, A, A) blocks [G_0, G_{B/2}, Ar..., Ai...], each transposed
        when `transpose` (the x-axis layout)."""
        blocks = list(self.Gre)
        if self.Gar is not None:
            blocks += list(self.Gar) + list(self.Gai)
        return np.stack([b.T if transpose else b for b in blocks])


@functools.lru_cache(maxsize=None)
def factored_op(n, delta, dtype_str, B):
    """The first-derivative circulant of an axis of length n and grid
    spacing delta as a radix-B FactoredOp."""
    from .deriv import _deriv_matrix
    return FactoredOp(_deriv_matrix(n, delta, dtype_str), B, np.dtype(dtype_str))


# =========================================================================
# packed operands on a device
# =========================================================================

class FactoredOps(NamedTuple):
    """The factored first derivatives of a projection, packed:
    FX (Bx, A, A) x-axis blocks (transposed), FY (By, A, A) y-axis
    blocks, bfx (2, Bx, Bx) and bfy (2, By, By) butterflies [Rf, Ri], and
    FYT, FY with each block transposed (what the CUDA kernels read; the
    plain apply does not use it, and `fyt` makes it where it is missing);
    FXS and FYTS, FX and FYT split into bfloat16 [head, residual]
    (2, B, A, A) for the 'high' precision, made by `factored_ops`; the
    'high' apply and kernels take them as given."""
    FX: torch.Tensor
    FY: torch.Tensor
    bfx: torch.Tensor
    bfy: torch.Tensor
    FYT: torch.Tensor = None
    FXS: torch.Tensor = None
    FYTS: torch.Tensor = None


def fyt(ops):
    """The y-axis blocks of `ops`, each transposed."""
    return ops.FYT if ops.FYT is not None else ops.FY.transpose(-1, -2).contiguous()


def factored_ops(proj, Bx, By):
    """FactoredOps of `proj` at radix Bx along x and By along y, on the
    projection's device (cached on the projection)."""
    key = ("_factored_ops", Bx, By)
    ops = proj._tensors.get(key)
    if ops is None:
        d, dts = float(proj.deltax), proj.T.str
        opx = factored_op(proj.Nx, d, dts, Bx)
        opy = factored_op(proj.Ny, d, dts, By)
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=proj.device)
        FX, FYT = t(opx.packed(True)), t(opy.packed(True))
        ops = FactoredOps(FX, t(opy.packed(False)), t(np.stack([opx.Rf, opx.Ri])),
                          t(np.stack([opy.Rf, opy.Ri])), FYT, torch.stack(split_bf16(FX)),
                          torch.stack(split_bf16(FYT)))
        proj._tensors[key] = ops
    return ops


# =========================================================================
# plain PyTorch apply
# =========================================================================

def _blocks(u, G, dot):
    """The channel-wise block products of `_fact_apply`: u is the list
    of B butterfly channels, G the packed blocks."""
    B = len(u)
    nc = B // 2 - 1
    y = [None] * B
    y[0] = dot(G[0], u[0])
    y[B - 1] = dot(G[1], u[B - 1])
    for i in range(nc):
        ur, ui = u[2 * i + 1], u[2 * i + 2]
        Ar, Ai = G[2 + i], G[2 + nc + i]
        y[2 * i + 1] = dot(Ar, ur) - dot(Ai, ui)
        y[2 * i + 2] = dot(Ai, ur) + dot(Ar, ui)
    return y


def _butterfly(planes, R):
    """[sum_r R[c, r] planes[r] for each c]."""
    return [sum(R[c, r] * planes[r] for r in range(len(planes))) for c in range(R.shape[0])]


def split_bf16(x):
    """(head, residual) of a float tensor as bfloat16, each rounded to
    nearest even: head = bf16(x), residual = bf16(x - head)."""
    h = x.to(torch.bfloat16)
    return h, (x - h.to(x.dtype)).to(torch.bfloat16)


def dot_high(M, v, right, Ms=None):
    """M v (v M when `right`) at the 'high' precision, as the JAX
    package's ``_mk_dot('high')``: operands split into bfloat16 head and
    residual, the three significant products (hh, lh, hl) each exact in
    float32 and summed in float32 in its order, (hh + hl) + lh. Ms is
    M's split when the caller holds it."""
    Mh, Ml = (t.float() for t in (Ms if Ms is not None else split_bf16(M)))
    vh, vl = (t.float() for t in split_bf16(v))
    if right:
        return (vh @ Mh + vh @ Ml) + vl @ Mh
    return (Mh @ vh + Ml @ vh) + Mh @ vl


def _blocks_and_dot(G, right, S):
    """What `_blocks` takes for one axis: the blocks and their product, in
    FP32 (S None) or at 'high', where each block travels with its split, S
    the axis' split blocks (2, B, A, A) in G's layout."""
    if S is None:
        return G, (lambda M, v: v @ M) if right else torch.matmul
    return ([(G[c], (S[0, c], S[1, c])) for c in range(G.shape[0])],
            lambda Mp, v: dot_high(Mp[0], v, right, Mp[1]))


def apply_x(x, FX, bf, split=None):
    """d/dx of (..., Ny, Nx) through the packed factored x operator, in
    FP32, or at 'high' given FX's split blocks `split` (FactoredOps.FXS)."""
    B, A = FX.shape[0], FX.shape[-1]
    xr = x.reshape(x.shape[:-1] + (B, A))
    u = _butterfly([xr[..., r, :] for r in range(B)], bf[0])
    y = _blocks(u, *_blocks_and_dot(FX, True, split))
    return torch.stack(_butterfly(y, bf[1]), dim=-2).reshape(x.shape)


def apply_y(x, FY, bf, split=None):
    """d/dy of (..., Ny, Nx) through the packed factored y operator, in
    FP32, or at 'high' given FY's split blocks `split` (FactoredOps.FYTS
    with each block transposed back)."""
    B, A = FY.shape[0], FY.shape[-1]
    xr = x.reshape(x.shape[:-2] + (B, A, x.shape[-1]))
    u = _butterfly([xr[..., r, :, :] for r in range(B)], bf[0])
    y = _blocks(u, *_blocks_and_dot(FY, False, split))
    return torch.stack(_butterfly(y, bf[1]), dim=-3).reshape(x.shape)
