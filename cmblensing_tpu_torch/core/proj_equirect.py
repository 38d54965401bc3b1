"""EquiRect (ring-pixelized) curved-sky band fields and their covariances.

Counterpart of ``cmblensing_tpu/core/proj_equirect.py`` (reference
src/proj_equirect.jl): fields on an equirectangular (theta, phi) grid with
azimuthal-FFT bases ('az' and 'qu_az'), and isotropic covariances
block-diagonal in the azimuthal order m: one n x n block per m, n = Ny
rings at spin 0 and 2 Ny at spin 2.

The block products are torch matmuls over the stacked (m, p, q) axis in
strict FP32 (TF32 is off); a real block against a complex operand runs as
one real product on the operand's real and imaginary parts side by side.
An operator keeps one SVD, which `sqrt` and `pinv` share (in float64;
for Hermitian blocks, covariances, from their eigendecomposition), and one LU
factorization, which `solve` and `logdet` share (the JAX package takes an
SVD for each and factors at every solve; the functions are the same). A block matrix whose
off-diagonal entries are all zero (white noise) takes its square root,
pseudo-inverse, solve and log-determinant entry by entry, as the SVD and
LU of a diagonal matrix give them.

`Cl_to_Cov_EquiRect` forms the blocks from spin-weighted harmonics,

    block_m[t1, t2] = nphi sum_alias sum_l C_l lam_{l m}(t1) lam_{l m}(t2),

in float64 on the projection's device: the Wigner-d recurrence in l runs
for every order m + j nphi and both spins at once, and each chunk of l
folds into the blocks as one (nT x L)(L x nT) product per m, its aliases
stacked along L. The recurrence's start value d^{l0}_{m s} is formed in
log space, sqrt((2 l0)! / ((l0+s)! (l0-s)!)) cos(t/2)^(l0+s) sin(t/2)^(l0-s)
with its sign kept apart; the JAX package forms exp(lnc) * c**(l0+s) *
(-sn)**(l0-s), whose exp(lnc) overflows to inf once |m| > 1024, so every
block of an lmax above 1024 is inf or NaN there and finite here (a
deliberate difference, ROADMAP Queue 3). Below that the two agree.
"""
from __future__ import annotations

from math import lgamma

import numpy as np
import torch

from .proj import _TORCH_DTYPES, resolve_device

_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}
# blocks this close to Hermitian (relative to their largest entry) are
# decomposed by eigh; a float32 covariance is Hermitian to its rounding
_HERMITIAN_RTOL = 1e-6


class ProjEquiRect:
    """EquiRect projection metadata: Ny rings of Nx pixels, theta_span and
    phi_span in radians, on `device` (the CUDA card unless named; one
    instance per parameter set and device)."""

    _cache = {}

    def __new__(cls, Ny=None, Nx=None, theta_span=None, phi_span=None, T=np.float32,
                device=None):
        T = np.dtype(T)
        device = resolve_device(device)
        key = (int(Ny), int(Nx), tuple(sorted(theta_span)), tuple(sorted(phi_span)), T.str,
               str(device))
        if key in cls._cache:
            return cls._cache[key]
        self = super().__new__(cls)
        self._init(key[0], key[1], key[2], key[3], T, device)
        cls._cache[key] = self
        return self

    def _init(self, Ny, Nx, theta_span, phi_span, T, device):
        self.Ny = Ny
        self.Nx = Nx
        self.theta_span = theta_span
        self.phi_span = phi_span
        self.T = T
        self.complex_T = (np.dtype(np.complex64) if T == np.dtype(np.float32)
                          else np.dtype(np.complex128))
        self.torch_T = _TORCH_DTYPES[T]
        self.device = device
        # pixel centers and edges
        self.phi_edges = np.mod(np.linspace(phi_span[0], phi_span[1], Nx + 1), 2 * np.pi)
        self.phi = np.mod(np.linspace(phi_span[0], phi_span[1], 2 * Nx + 1)[1::2], 2 * np.pi)
        self.theta_edges = np.linspace(theta_span[0], theta_span[1], Ny + 1)
        self.theta = np.linspace(theta_span[0], theta_span[1], 2 * Ny + 1)[1::2]
        # each ring's pixel area
        dphi = np.mod(self.phi_edges[1] - self.phi_edges[0], 2 * np.pi)
        self.Omega = (dphi * np.diff(-np.cos(self.theta_edges))).astype(np.float64)
        self.phi_full_circle = abs(abs(phi_span[1] - phi_span[0]) - 2 * np.pi) < 1e-8

    def __hash__(self):
        return hash((ProjEquiRect, self.Ny, self.Nx, self.theta_span, self.phi_span, self.T.str,
                     str(self.device)))

    def __reduce__(self):
        # pickled by its parameters: unpickling gives the memoized instance
        return (ProjEquiRect, (self.Ny, self.Nx, self.theta_span, self.phi_span, self.T,
                               str(self.device)))

    def __eq__(self, other):
        return self is other

    def __repr__(self):
        return f"ProjEquiRect(Ny={self.Ny}, Nx={self.Nx}, device={self.device})"


def _irfft_az(arr, n):
    """irfft along the last axis of the Hermitian part of the m = 0 (and, n
    even, Nyquist) column: their imaginary parts are no part of a real
    signal's transform, and a real inverse transform drops them (pocketfft
    does; they are zeroed here so that cuFFT does the same)."""
    arr = arr.clone()
    arr[..., 0].imag.zero_()
    if n % 2 == 0:
        arr[..., n // 2].imag.zero_()
    return torch.fft.irfft(arr, n=n, dim=-1)


class EquiRectField:
    """A field on an EquiRect grid.

    bases: 'map' (..., nT, nP) real | 'az' (..., nT, nP//2+1) complex
           'qu_map' (..., 2, nT, nP) real | 'qu_az' (..., 2nT, nP//2+1) complex
    The qu_az layout stacks [P_m(theta); conj(P_{-m})(theta)], P = Q + iU.
    Gradients are taken with respect to the map-basis pixels, as for
    Lambert fields."""

    __slots__ = ("arr", "basis", "proj")

    def __init__(self, arr, basis, proj):
        self.arr = arr
        self.basis = basis
        self.proj = proj

    def __repr__(self):
        return f"EquiRectField({self.basis}, {tuple(self.arr.shape)}, {self.arr.device})"

    @property
    def dtype(self):
        return self.arr.dtype

    @property
    def device(self):
        return self.arr.device

    @property
    def batch_shape(self):
        """The leading batch axes."""
        ncore = 3 if self.basis == "qu_map" else 2
        return tuple(self.arr.shape[: self.arr.ndim - ncore])

    # --- conversions ----------------------------------------------------
    def to(self, basis):
        if basis == self.basis:
            return self
        nP, nT = self.proj.Nx, self.proj.Ny
        rsq = float(np.sqrt(nP))
        if self.basis == "map" and basis == "az":
            return EquiRectField(torch.fft.rfft(self.arr, dim=-1) / rsq, "az", self.proj)
        if self.basis == "az" and basis == "map":
            return EquiRectField(_irfft_az(self.arr, nP) * rsq, "map", self.proj)
        if self.basis in ("qu_map", "qu_az") and nP % 2:
            raise NotImplementedError("qu_map <-> qu_az needs an even Nx (the m-column "
                                      "folding assumes it); spin-0 'az' takes an odd Nx")
        idx = torch.as_tensor(np.concatenate([[0], np.arange(nP - 1, nP // 2 - 1, -1)]),
                              device=self.arr.device)
        if self.basis == "qu_map" and basis == "qu_az":
            P = torch.complex(self.arr[..., 0, :, :], self.arr[..., 1, :, :])
            F = torch.fft.fft(P, dim=-1) / rsq
            top = F[..., :, : nP // 2 + 1]
            bot = torch.conj(F[..., :, idx])   # conj(P_{-m}), m = 0 .. nP//2
            return EquiRectField(torch.cat([top, bot], dim=-2), "qu_az", self.proj)
        if self.basis == "qu_az" and basis == "qu_map":
            top, bot = self.arr[..., :nT, :], self.arr[..., nT:, :]
            F = torch.zeros(self.arr.shape[:-2] + (nT, nP), dtype=self.arr.dtype,
                            device=self.arr.device)
            F[..., :, : nP // 2 + 1] = top
            F[..., :, idx] = torch.conj(bot)   # m = 0 and nP//2 from the lower half
            P = torch.fft.ifft(F, dim=-1) * rsq
            return EquiRectField(torch.stack([P.real, P.imag], dim=-3), "qu_map", self.proj)
        raise ValueError(f"no conversion {self.basis} -> {basis}")

    # --- algebra --------------------------------------------------------
    def _binop(self, other, op, reverse=False):
        o = other.to(self.basis).arr if isinstance(other, EquiRectField) else other
        a, b = (o, self.arr) if reverse else (self.arr, o)
        return EquiRectField(op(a, b), self.basis, self.proj)

    def __add__(self, o):
        return self._binop(o, torch.add)

    def __radd__(self, o):
        return self._binop(o, torch.add, reverse=True)

    def __sub__(self, o):
        return self._binop(o, torch.sub)

    def __rsub__(self, o):
        return self._binop(o, torch.sub, reverse=True)

    def __mul__(self, o):
        return self._binop(o, torch.mul)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, torch.div)

    def __neg__(self):
        return EquiRectField(-self.arr, self.basis, self.proj)


def _map_basis(basis):
    return "map" if basis in ("map", "az") else "qu_map"


def er_dot(a: EquiRectField, b: EquiRectField):
    """The pixel-space dot product, per batch entry."""
    am = a.to(_map_basis(a.basis))
    bm = b.to(am.basis)
    nred = 2 if am.basis == "map" else 3
    return torch.sum(am.arr * bm.arr, dim=tuple(range(-nred, 0)))


def coef_dot(a: EquiRectField, b: EquiRectField):
    """sum Re(conj(a) b) over a's stored coefficients, in a's basis, per
    batch entry: the inner product CG runs on for these fields (the JAX
    package's tree_dot over the array; an operator block-diagonal in m
    with Hermitian blocks is self-adjoint under it)."""
    bb = b.to(a.basis)
    ncore = 3 if a.basis == "qu_map" else 2
    return torch.sum(torch.real(torch.conj(a.arr) * bb.arr), dim=tuple(range(-ncore, 0)))


def white_noise(generator, proj: ProjEquiRect, basis, batch_shape=()):
    """Standard-normal white noise in the map basis of `basis` ('map' for
    'az', 'qu_map' for 'qu_az'), drawn from `generator`."""
    b = _map_basis(basis)
    shape = tuple(batch_shape) + ((proj.Ny, proj.Nx) if b == "map" else (2, proj.Ny, proj.Nx))
    return EquiRectField(torch.randn(shape, generator=generator, dtype=proj.torch_T,
                                     device=proj.device), b, proj)


# =========================================================================
# BlockDiagEquiRect
# =========================================================================

def _bmm(A, X):
    """A @ X batched over the leading axis; a real A against a complex X as
    one real product over X's real and imaginary parts."""
    if A.is_complex() or not X.is_complex():
        return A @ X.to(A.dtype)
    m, n, k = X.shape
    Y = A @ torch.view_as_real(X.contiguous()).reshape(m, n, 2 * k)
    return torch.view_as_complex(Y.contiguous().reshape(m, A.shape[1], k, 2))


def _as_columns(arr):
    """(..., n, m) -> (m, n, B), B the batch entries, and the batch shape."""
    bs = tuple(arr.shape[:-2])
    n, nm = arr.shape[-2:]
    return arr.reshape((-1, n, nm)).permute(2, 1, 0), bs


def _from_columns(cols, bs):
    """The inverse of _as_columns."""
    nm, n, _ = cols.shape
    return cols.permute(2, 1, 0).reshape(bs + (n, nm))


class BlockDiagEquiRect:
    """An operator block-diagonal in azimuthal m: blocks (nm, n, n), n = nT
    (spin 0, basis 'az') or 2 nT (spin 2, basis 'qu_az'), on the
    projection's device."""

    __slots__ = ("blocks", "basis", "proj", "_svd", "_lu", "_diag")

    def __init__(self, blocks, basis, proj):
        self.blocks = blocks
        self.basis = basis
        self.proj = proj
        self._svd = self._lu = self._diag = None

    def __repr__(self):
        return f"BlockDiagEquiRect({self.basis}, {tuple(self.blocks.shape)})"

    def _cacheable(self):
        return not (torch.is_grad_enabled() and self.blocks.requires_grad)

    def _diagonal(self):
        """The blocks' diagonals (nm, n) when every off-diagonal entry is
        zero, else None."""
        if self._diag is None:
            B = self.blocks
            nm, n, _ = B.shape
            off = B.reshape(nm, n * n)[:, 1:].reshape(nm, n - 1, n + 1)[:, :, :n] if n > 1 else None
            self._diag = (False if off is not None and bool(torch.any(off != 0))
                          else torch.diagonal(B, dim1=-2, dim2=-1))
        return self._diag if self._diag is not False else None

    def _matrix(self):
        """The blocks, as real matrices where their imaginary parts are all
        zero (the covariances Cl_to_Cov_EquiRect forms at P)."""
        B = self.blocks
        if B.is_complex() and not bool(torch.any(B.imag != 0)):
            B = B.real
        return B

    def svd(self):
        """(U, S, Vh) of every block, in float64 (complex128), computed once.
        Hermitian blocks (to _HERMITIAN_RTOL of their largest entry:
        covariances) take it from their eigendecomposition Q diag(lam) Q^H,
        U = Q, S = |lam|, V = Q sign(lam); other blocks from
        torch.linalg.svd. Float64 because a float32 decomposition of a
        near-singular block misses: S S lay 2.6e-4 (SVD) and 7.5e-4 (eigh)
        of C's largest entry from C for the 512^2 P blocks at lmax 2000,
        and cuSOLVER's float64 eigh took a third of the float32 one's time
        there (an H100)."""
        if self._svd is not None:
            return self._svd
        B = self._matrix()
        B = B.to(torch.complex128 if B.is_complex() else torch.float64)
        if bool((B - B.mH).abs().amax() <= _HERMITIAN_RTOL * B.abs().amax()):
            lam, Q = torch.linalg.eigh(B)
            out = (Q, lam.abs(), torch.sgn(lam).unsqueeze(-1).to(Q.dtype) * Q.mH)
        else:
            out = torch.linalg.svd(B)
        if self._cacheable():
            self._svd = out
        return out

    def _lu_factors(self):
        if self._lu is not None:
            return self._lu
        out = torch.linalg.lu_factor(self._matrix())
        if self._cacheable():
            self._lu = out
        return out

    def __matmul__(self, f: EquiRectField) -> EquiRectField:
        X, bs = _as_columns(f.to(self.basis).arr)
        return EquiRectField(_from_columns(_bmm(self.blocks, X), bs), self.basis, self.proj)

    @property
    def H(self):
        return BlockDiagEquiRect(torch.conj(self.blocks.transpose(-1, -2)), self.basis, self.proj)

    def __mul__(self, other):
        if isinstance(other, BlockDiagEquiRect):
            return BlockDiagEquiRect(self.blocks @ other.blocks, self.basis, self.proj)
        return BlockDiagEquiRect(other * self.blocks, self.basis, self.proj)

    __rmul__ = __mul__

    def __add__(self, other):
        if isinstance(other, BlockDiagEquiRect):
            return BlockDiagEquiRect(self.blocks + other.blocks, self.basis, self.proj)
        return NotImplemented

    def __sub__(self, other):
        if isinstance(other, BlockDiagEquiRect):
            return BlockDiagEquiRect(self.blocks - other.blocks, self.basis, self.proj)
        return NotImplemented

    def _of_diag(self, d):
        return BlockDiagEquiRect(torch.diag_embed(d), self.basis, self.proj)

    def sqrt(self):
        """U sqrt(S) V^H of each block's SVD U S V^H."""
        d = self._diagonal()
        if d is not None:
            a = torch.abs(d)
            return self._of_diag(torch.where(a > 0, d / torch.sqrt(torch.where(a > 0, a, 1)), 0))
        U, S, Vh = self.svd()
        s = torch.sqrt(torch.clamp(S, min=0))
        return self._of_factors((U * s.unsqueeze(-2).to(U.dtype)) @ Vh)

    def pinv(self, rtol=1e-6):
        """V S^+ U^H of each block's SVD, singular values at or below rtol
        times the block's largest dropped."""
        d = self._diagonal()
        if d is not None:
            a = torch.abs(d)
            keep = a > rtol * torch.amax(a, dim=-1, keepdim=True)
            return self._of_diag(torch.where(keep, 1 / torch.where(keep, d, 1), 0))
        U, S, Vh = self.svd()
        smax = torch.amax(S, dim=-1, keepdim=True)
        sinv = torch.where(S > rtol * smax, 1 / S, 0)
        return self._of_factors(Vh.mH @ (sinv.unsqueeze(-1).to(U.dtype) * U.mH))

    inv = pinv

    def _of_factors(self, M):
        """An operator of float64 blocks M, cast once to this one's dtype."""
        return BlockDiagEquiRect(M.to(self.blocks.dtype), self.basis, self.proj)

    def solve(self, f: EquiRectField) -> EquiRectField:
        """The solution of each block's linear system (LU)."""
        g = f.to(self.basis)
        X, bs = _as_columns(g.arr)
        d = self._diagonal()
        if d is not None:
            Y = X / d.unsqueeze(-1)
        else:
            LU, piv = self._lu_factors()
            if LU.is_complex() or not X.is_complex():
                Y = torch.linalg.lu_solve(LU, piv, X.to(LU.dtype))
            else:
                m, n, k = X.shape
                R = torch.linalg.lu_solve(LU, piv, torch.view_as_real(X.contiguous()).reshape(
                    m, n, 2 * k))
                Y = torch.view_as_complex(R.contiguous().reshape(m, n, k, 2))
        return EquiRectField(_from_columns(Y, bs), self.basis, self.proj)

    def logabsdet(self):
        """(sum over blocks of log|det|, the product of their signs), from
        the LU factors solve keeps."""
        d = self._diagonal()
        if d is None:
            LU, piv = self._lu_factors()
            d = torch.diagonal(LU, dim1=-2, dim2=-1)
            n = d.shape[-1]
            swaps = (piv != torch.arange(1, n + 1, device=piv.device, dtype=piv.dtype)).sum(-1)
            parity = (1 - 2 * (swaps % 2)).to(d.dtype)
        else:
            parity = 1
        a = torch.abs(d)
        phase = torch.where(a > 0, d / torch.where(a > 0, a, 1), 0)
        return torch.sum(torch.log(a)), torch.prod(torch.prod(phase, dim=-1) * parity)

    def logdet(self):
        """The sum over blocks of log|det| (a negative determinant is no
        NaN here)."""
        return self.logabsdet()[0]

    def zero_field(self, batch_shape=()):
        """A zero field in the map basis of this operator's domain: the
        starting point argmaxf_logpdf takes for curved-sky fields."""
        proj = self.proj
        b = _map_basis(self.basis)
        sh = tuple(batch_shape) + ((proj.Ny, proj.Nx) if b == "map" else (2, proj.Ny, proj.Nx))
        return EquiRectField(torch.zeros(sh, dtype=proj.torch_T, device=proj.device), b, proj)

    def simulate(self, key=None, batch_shape=()):
        """sqrt(M) @ white map noise, drawn from `key`: a torch.Generator,
        or a seed (None: seed 0), as models/dataset.py::as_generator takes
        it; batch_shape adds leading batch axes."""
        from ..models.dataset import as_generator
        g = as_generator(key, self.proj.device)
        return self.sqrt() @ white_noise(g, self.proj, self.basis, batch_shape)


def mapblocks(fun, M: BlockDiagEquiRect, f: EquiRectField):
    """fun(block, vector) for each m (torch.vmap over m); the blocks are
    handed to fun in the vector's dtype where that is wider (a real block
    and a complex vector)."""
    x = f.to(M.basis).arr.movedim(-1, 0)      # (m, ..., n)
    B = M.blocks.to(torch.promote_types(M.blocks.dtype, x.dtype))
    out = torch.vmap(fun)(B, x)
    return EquiRectField(out.movedim(0, -1), M.basis, M.proj)


# =========================================================================
# the covariance from spin-weighted harmonics
# =========================================================================

def _parity(k):
    return 1 if k % 2 == 0 else -1


def _start_terms(m, s):
    """(l0, lnc, ec, es, sign): d^{l0}_{m s}(t) = sign exp(lnc) cos(t/2)^ec
    sin(t/2)^es at l0 = max(|m|, |s|), by the symmetries d_{m s} =
    (-1)^(m-s) d_{-m -s} = (-1)^(m-s) d_{s m}."""
    sign = 1
    while True:
        if abs(m) >= abs(s):
            if m >= 0:
                l = m
                lnc = 0.5 * (lgamma(2 * l + 1) - lgamma(l + s + 1) - lgamma(l - s + 1))
                return l, lnc, l + s, l - s, sign * _parity(l - s)
            sign *= _parity(m - s)
            m, s = -m, -s
        else:
            sign *= _parity(m - s)
            m, s = s, m


def _alias_ms(m, nphi, lmax):
    """The aliased azimuthal orders m + j nphi with |.| <= lmax."""
    ms = []
    j = 0
    while True:
        hit = False
        for mm in ({m} if j == 0 else {m + j * nphi, m - j * nphi}):
            if abs(mm) <= lmax:
                ms.append(mm)
                hit = True
        if not hit:
            break
        j += 1
    return ms


# bytes of one chunk of harmonics (all columns, L values of l)
_CHUNK_BYTES = 1 << 29


def _harmonic_blocks(theta, nphi, lmax, spins, weights, device):
    """The float64 sums  sum_alias sum_l w_l lam_{l m s1}(t1) lam_{l m s2}(t2)
    for m = 0 .. nphi//2, one (nm, nT, nT) tensor for each (s1, s2, w) in
    `weights` (spins indexing `spins`), where lam_{l m s}(t) = sqrt((2l+1) /
    4 pi) (-1)^m d^l_{-m, s}(t).

    Columns are (spin, m, alias slot); the recurrence in l runs over all of
    them at once, and every chunk of l is folded in with one batched
    product a weight."""
    f64 = torch.float64
    nT = len(theta)
    nm = nphi // 2 + 1
    aliases = [_alias_ms(m, nphi, lmax) for m in range(nm)]
    A = max(len(a) for a in aliases)
    ns = len(spins)
    # per-column start terms; empty alias slots never start
    l0 = np.full((ns, nm, A), lmax + 1, np.int64)
    lnc, ec, es = (np.zeros((ns, nm, A)) for _ in range(3))
    sgn = np.zeros((ns, nm, A))
    mp = np.zeros((ns, nm, A))
    ss = np.zeros((ns, nm, A))
    for i, s in enumerate(spins):
        for m, als in enumerate(aliases):
            for a, mm in enumerate(als):
                l0[i, m, a], lnc[i, m, a], ec[i, m, a], es[i, m, a], sg = _start_terms(-mm, s)
                sgn[i, m, a] = sg * _parity(mm)
                mp[i, m, a], ss[i, m, a] = -mm, s
    C = ns * nm * A
    t = lambda a: torch.as_tensor(a.reshape(C, 1), dtype=f64, device=device)
    l0_t = torch.as_tensor(l0.reshape(C, 1), device=device)
    x = torch.as_tensor(np.cos(np.asarray(theta, np.float64)), device=device)[None, :]
    th = torch.arccos(x)
    lc, lsn = torch.log(torch.cos(th / 2)), torch.log(torch.sin(th / 2))
    start = t(sgn) * torch.exp(t(lnc) + t(ec) * lc + t(es) * lsn)          # (C, nT)
    ms = t(mp) * t(ss)
    mp2, s2 = t(mp) ** 2, t(ss) ** 2

    Lc = max(1, min(lmax + 1, _CHUNK_BYTES // (C * nT * 8)))
    buf = torch.zeros((ns, nm, A, Lc, nT), dtype=f64, device=device)
    out = [torch.zeros((nm, nT, nT), dtype=f64, device=device) for _ in weights]
    w_t = [torch.as_tensor(np.asarray(w, np.float64), device=device) for _, _, w in weights]

    def fold(l_lo, nl):
        for o, (i1, i2, _), w in zip(out, weights, w_t):
            b1 = buf[i1, :, :, :nl]
            b2 = buf[i2, :, :, :nl]
            lhs = (b1 * w[l_lo:l_lo + nl, None]).reshape(nm, A * nl, nT)
            o += lhs.transpose(1, 2) @ b2.reshape(nm, A * nl, nT)

    d_prev = torch.zeros((C, nT), dtype=f64, device=device)
    d_cur = torch.where(l0_t == 0, start, 0)
    norm = np.sqrt((2 * np.arange(lmax + 1) + 1) / (4 * np.pi))
    j, l_lo = 0, 0
    for l in range(lmax + 1):
        buf[:, :, :, j] = (norm[l] * d_cur).view(ns, nm, A, nT)
        j += 1
        if j == Lc or l == lmax:
            fold(l_lo, j)
            l_lo, j = l + 1, 0
        if l == lmax:
            break
        if l == 0:
            d_next = x * d_cur
        else:
            # (a d_l - b d_{l-1}) / c, the three-term recurrence in l
            a = (2 * l + 1) * (l * (l + 1) * x - ms)
            b = (l + 1) * torch.sqrt(torch.clamp(l * l - mp2, min=0) * torch.clamp(l * l - s2, min=0))
            c = l * torch.sqrt(torch.clamp(((l + 1) ** 2 - mp2) * ((l + 1) ** 2 - s2), min=0))
            d_next = (a * d_cur - b * d_prev) / torch.where(c > 0, c, 1)
        d_next = torch.where(l0_t == l + 1, start, d_next)
        d_prev, d_cur = d_cur, d_next
    return out


def Cl_to_Cov_EquiRect(pol, proj: ProjEquiRect, *Cls, lmax=3000, units=1):
    """The exact isotropic covariance, block-diagonal in m:

        Cl_to_Cov_EquiRect('I', proj, ClTT)
        Cl_to_Cov_EquiRect('P', proj, ClEE, ClBB)

    Needs a full circle in phi. Built in float64 on proj's device and cast
    once to proj's dtype (complex at P)."""
    if not proj.phi_full_circle:
        raise ValueError("Cl_to_Cov_EquiRect needs a phi span of 2 pi")
    nT, nP = proj.Ny, proj.Nx
    ell = np.arange(lmax + 1)
    dev = proj.device
    if pol == "I":
        (Cl,) = Cls
        (acc,) = _harmonic_blocks(proj.theta, nP, lmax, (0,),
                                  [(0, 0, np.nan_to_num(Cl(ell)) * units)], dev)
        return BlockDiagEquiRect((acc * nP).to(proj.torch_T), "az", proj)
    if pol == "P":
        ClEE, ClBB = Cls
        CE = np.nan_to_num(ClEE(ell)) * units
        CB = np.nan_to_num(ClBB(ell)) * units
        # rows [P_m; conj(P_{-m})]: <P P^H> from spin +2, <P P(-m)> across
        # the spins with CE - CB, the lower diagonal block from spin -2
        gam, xi, gamc = _harmonic_blocks(proj.theta, nP, lmax, (2, -2),
                                         [(0, 0, CE + CB), (0, 1, CE - CB), (1, 1, CE + CB)], dev)
        nm = nP // 2 + 1
        # the operator is half the P covariance: white QU map noise has
        # <xi xi^H> = 2 I in P = Q + iU, and simulate draws through it
        h = nP / 2
        blocks = torch.empty((nm, 2 * nT, 2 * nT), dtype=_COMPLEX[proj.torch_T], device=dev)
        blocks[:, :nT, :nT] = gam * h
        blocks[:, :nT, nT:] = xi * h
        blocks[:, nT:, :nT] = xi.transpose(1, 2) * h
        blocks[:, nT:, nT:] = gamc * h
        return BlockDiagEquiRect(blocks, "qu_az", proj)
    raise ValueError(pol)


def Cl_to_Beam_EquiRect(pol, proj: ProjEquiRect, Cl, lmax=3000, units=1):
    """The beam operator: the covariance of Cl with each column scaled by
    its ring's pixel area."""
    blocks = Cl_to_Cov_EquiRect("I", proj, Cl, lmax=lmax, units=units).blocks
    Om = torch.as_tensor(proj.Omega.astype(proj.T), device=proj.device)
    if pol == "I":
        return BlockDiagEquiRect(blocks * Om[None, None, :], "az", proj)
    if pol == "P":
        Z = torch.zeros_like(blocks)
        big = torch.cat([torch.cat([blocks, Z], dim=-1), torch.cat([Z, blocks], dim=-1)], dim=-2)
        return BlockDiagEquiRect((big * torch.cat([Om, Om])[None, None, :]).to(
            _COMPLEX[proj.torch_T]), "qu_az", proj)
    raise ValueError(pol)
