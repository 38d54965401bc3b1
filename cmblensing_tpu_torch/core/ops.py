"""Linear operators on fields.

Counterpart of ``cmblensing_tpu/core/ops.py``: the identity, diagonal
and T/E/B block operators, scaled and lazily composed operators, operators
of functions (FuncOp), parameter-dependent operators, the pass filters,
the gradient operators, logdet, trace and simulation.
Operator protocol (duck-typed):

    op @ f        apply
    op.solve(f)   apply the inverse (pinv-like, 0 on singular modes)
    op.H          adjoint
    op.sqrt()     operator square root
    op.pinv()     pseudo-inverse operator
    logdet(op)    log-determinant (per batch)
    op(theta)     evaluate at parameters (no-op unless ParamDependentOp)
"""
from __future__ import annotations

import numpy as np
import torch

from .basis import Basis, EB_FOURIER, FOURIER, IEB_FOURIER
from .field import Field, batch_broadcast, white_noise_like
from .proj import ProjLambert


def nan2zero(x):
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def safe_divide(num, den):
    """num/den with 0 where den == 0, with no inf*0 leaking into
    gradients."""
    ok = den != 0
    den_safe = torch.where(ok, den, torch.ones_like(den))
    q = num / den_safe
    return torch.where(ok, q, torch.zeros_like(q))


def safe_reciprocal(den):
    ok = den != 0
    den_safe = torch.where(ok, den, torch.ones_like(den))
    return torch.where(ok, 1.0 / den_safe, torch.zeros_like(den))


def safe_log_abs(x):
    """log|x| with 0 where x == 0."""
    ok = x != 0
    x_safe = torch.where(ok, x, torch.ones_like(x))
    return torch.where(ok, torch.log(torch.abs(x_safe)), torch.zeros_like(torch.abs(x)))


# =========================================================================
# Identity
# =========================================================================

def _is_scalar(x):
    """A number, or a 0- or 1-d tensor (a per-batch scalar)."""
    return (isinstance(x, (int, float, np.floating, np.integer))
            or (isinstance(x, torch.Tensor) and x.ndim in (0, 1)))


def _as_op(x):
    """x as an operator: a number becomes x times the identity."""
    if isinstance(x, (int, float)):
        return Scaled(x, Id)
    return x


class OpAlgebra:
    """Base of the field operators: sums, differences and products with
    other operators are lazy (LazyOp), with numbers they scale (Scaled);
    evaluating one at parameters is a no-op unless it is a
    ParamDependentOp."""

    def __add__(self, other):
        return LazyOp("+", self, _as_op(other))

    def __radd__(self, other):
        return LazyOp("+", _as_op(other), self)

    def __sub__(self, other):
        return LazyOp("-", self, _as_op(other))

    def __rsub__(self, other):
        return LazyOp("-", _as_op(other), self)

    def __mul__(self, other):
        if _is_scalar(other):
            return Scaled(other, self)
        if isinstance(other, Field):
            raise TypeError("operators apply to Fields with '@' (op @ f); '*' composes operators")
        return LazyOp("*", self, other)

    def __rmul__(self, other):
        if _is_scalar(other):
            return Scaled(other, self)
        if isinstance(other, Field):
            raise TypeError("operators apply to Fields with '@' (op @ f); '*' composes operators")
        return LazyOp("*", other, self)

    def __truediv__(self, other):
        if isinstance(other, (int, float)):
            return Scaled(1.0 / other, self)
        return NotImplemented

    def __neg__(self):
        return Scaled(-1.0, self)

    def __pow__(self, n: int):
        if not isinstance(n, int):
            raise TypeError("an operator's power is an int")
        if n == 0:
            return Id
        base = self if n > 0 else self.pinv()
        out = base
        for _ in range(abs(n) - 1):
            out = LazyOp("*", out, base)
        return out

    def __call__(self, theta=None, **kw):
        return self


class _Identity(OpAlgebra):
    """Singleton identity operator."""

    def __matmul__(self, f):
        return f

    def solve(self, f):
        return f

    @property
    def H(self):
        return self

    def sqrt(self):
        return self

    def pinv(self):
        return self

    inv = pinv

    def __mul__(self, other):
        if _is_scalar(other):
            return Scaled(other, self)
        return other

    __rmul__ = __mul__

    def __repr__(self):
        return "Id"


Identity = _Identity
Id = _Identity()



# =========================================================================
# Diag
# =========================================================================

class Diag(OpAlgebra):
    """Diagonal operator: multiply in the basis of its diagonal field
    after converting the operand to that basis."""

    __slots__ = ("diag",)

    def __init__(self, diag: Field):
        self.diag = diag

    @property
    def basis(self):
        return self.diag.basis

    @property
    def proj(self):
        return self.diag.proj

    def __matmul__(self, f):
        if isinstance(f, Field):
            g = f.to(self.basis)
            return Field(self.diag.arr * g.arr, self.basis, g.proj)
        return NotImplemented

    def solve(self, f: Field) -> Field:
        g = f.to(self.basis)
        return Field(safe_divide(g.arr, self.diag.arr), self.basis, g.proj)

    @property
    def H(self):
        return Diag(self.diag.conj())

    def sqrt(self):
        return Diag(Field(torch.sqrt(self.diag.arr), self.basis, self.proj))

    def pinv(self):
        return Diag(Field(safe_reciprocal(self.diag.arr), self.basis, self.proj))

    inv = pinv

    def __mul__(self, other):
        """The product of two Diags in one basis; a BlockDiagIEB forms its
        own (its __rmul__), anything else composes lazily."""
        if isinstance(other, Diag) and other.basis == self.basis:
            return Diag(Field(self.diag.arr * other.diag.arr, self.basis, self.proj))
        if isinstance(other, BlockDiagIEB):
            return NotImplemented
        return super().__mul__(other)

    def __add__(self, other):
        """The sum of two Diags in one basis; a BlockDiagIEB forms its own
        (its __radd__), anything else sums lazily."""
        if isinstance(other, Diag) and other.basis == self.basis:
            return Diag(Field(self.diag.arr + other.diag.arr, self.basis, self.proj))
        if isinstance(other, BlockDiagIEB):
            return NotImplemented
        return super().__add__(other)

    def __sub__(self, other):
        if isinstance(other, Diag) and other.basis == self.basis:
            return Diag(Field(self.diag.arr - other.diag.arr, self.basis, self.proj))
        return super().__sub__(other)

    def __getitem__(self, k):
        return Diag(self.diag[k])

    def __repr__(self):
        return f"Diag({self.diag!r})"


# =========================================================================
# BlockDiagIEB
# =========================================================================

class BlockDiagIEB(OpAlgebra):
    """A T/E/B operator with TE coupling, per Fourier mode

        [ TT TE  .
          ET EE  .
           .  . BB ]

    stored as spin-0 Fourier fields (TT, TE, EE, BB, ET), each (..., 1, Ny,
    Nx//2+1). A covariance is symmetric (ET = TE, the default); a product
    of two such operators is not, so the class carries ET apart where it
    differs (e.g. the mixing matrix D of an IP dataset)."""

    __slots__ = ("TT", "TE", "EE", "BB", "ET")

    def __init__(self, TT: Field, TE: Field, EE: Field, BB: Field, ET=None):
        self.TT, self.TE, self.EE, self.BB = TT, TE, EE, BB
        self.ET = TE if ET is None else ET

    @property
    def proj(self):
        return self.TT.proj

    def _blocks(self):
        return self.TT.arr, self.TE.arr, self.ET.arr, self.EE.arr, self.BB.arr

    def _field(self, a):
        return Field(a, FOURIER, self.proj)

    def _of(self, tt, te, ee, bb, et):
        F = self._field
        return BlockDiagIEB(F(tt), F(te), F(ee), F(bb), F(et))

    @staticmethod
    def _apply(g, tt, te, et, ee, bb):
        i = g.arr[..., 0, :, :] * tt[..., 0, :, :] + g.arr[..., 1, :, :] * te[..., 0, :, :]
        e = g.arr[..., 0, :, :] * et[..., 0, :, :] + g.arr[..., 1, :, :] * ee[..., 0, :, :]
        b = g.arr[..., 2, :, :] * bb[..., 0, :, :]
        return Field(torch.stack([i, e, b], dim=-3), IEB_FOURIER, g.proj)

    def __matmul__(self, f):
        if isinstance(f, Field):
            return self._apply(f.to(IEB_FOURIER), *self._blocks())
        return NotImplemented

    def _inv_blocks(self):
        tt, te, et, ee, bb = self._blocks()
        det = tt * ee - te * et
        return (safe_divide(ee, det), safe_divide(-te, det), safe_divide(-et, det),
                safe_divide(tt, det), safe_reciprocal(bb))

    def solve(self, f):
        return self._apply(f.to(IEB_FOURIER), *self._inv_blocks())

    def pinv(self):
        itt, ite, iet, iee, ibb = self._inv_blocks()
        return self._of(itt, ite, iee, ibb, iet)

    @property
    def H(self):
        if self.ET is self.TE:
            return self
        return BlockDiagIEB(self.TT, self.ET, self.EE, self.BB, self.TE)

    def sqrt(self):
        """The square root of each mode's 2 x 2 TE block by Cayley-Hamilton
        (for a block with no negative real eigenvalue): sqrt(A) = (A +
        sqrt(det A) I) / sqrt(tr A + 2 sqrt(det A))."""
        tt, te, et, ee, bb = self._blocks()
        s = torch.sqrt(torch.clamp(tt * ee - te * et, min=0.0))
        t = torch.sqrt(tt + ee + 2 * s)
        return self._of(safe_divide(tt + s, t), safe_divide(te, t), safe_divide(ee + s, t),
                        torch.sqrt(bb), safe_divide(et, t))

    def diag(self) -> Field:
        return Field(torch.cat([self.TT.arr, self.EE.arr, self.BB.arr], dim=-3), IEB_FOURIER,
                     self.proj)

    def __getitem__(self, k):
        if k == "IP":
            return self
        if k in ("I", "E", "B"):
            return Diag({"I": self.TT, "E": self.EE, "B": self.BB}[k])
        if k == "P":
            return Diag(Field(torch.cat([self.EE.arr, self.BB.arr], dim=-3), EB_FOURIER,
                              self.proj))
        raise KeyError(k)

    def _ieb(self, other):
        """other's (TT, TE, ET, EE, BB) blocks if it is a BlockDiagIEB or a
        Diag on IEB fourier (TE = ET = 0), else None."""
        if isinstance(other, BlockDiagIEB):
            return other._blocks()
        if isinstance(other, Diag) and other.basis == IEB_FOURIER:
            d = other.diag.arr
            zero = torch.zeros_like(d[..., 0:1, :, :])
            return d[..., 0:1, :, :], zero, zero, d[..., 1:2, :, :], d[..., 2:3, :, :]
        return None

    def __mul__(self, other):
        """The product of each mode's blocks with a BlockDiagIEB or an IEB
        fourier Diag (not symmetric unless the blocks commute); with another
        operator a lazy product, with the identity this operator."""
        o = self._ieb(other)
        if o is not None:
            tt, te, et, ee, bb = self._blocks()
            ott, ote, oet, oee, obb = o
            return self._of(tt * ott + te * oet, tt * ote + te * oee, et * ote + ee * oee,
                            bb * obb, et * ott + ee * oet)
        if isinstance(other, _Identity):
            return self
        if isinstance(other, OpAlgebra):
            return LazyOp("*", self, other)
        if _is_scalar(other):
            return Scaled(other, self)
        return NotImplemented

    def __rmul__(self, other):
        o = self._ieb(other)
        if o is not None:   # only a Diag reaches here: it has no product with this class
            return BlockDiagIEB(*(self._field(x) for x in (o[0], o[1], o[3], o[4], o[2]))) * self
        if isinstance(other, _Identity):
            return self
        if isinstance(other, OpAlgebra):
            return LazyOp("*", other, self)
        if _is_scalar(other):
            return Scaled(other, self)
        return NotImplemented

    def __add__(self, other):
        """The blockwise sum with a BlockDiagIEB or an IEB fourier Diag; with
        another operator or the identity a lazy sum."""
        o = self._ieb(other)
        if o is not None:
            tt, te, et, ee, bb = (a + b for a, b in zip(self._blocks(), o))
            return self._of(tt, te, ee, bb, et)
        if isinstance(other, (OpAlgebra, int, float)):
            return LazyOp("+", self, _as_op(other))
        return NotImplemented

    def __radd__(self, other):
        if self._ieb(other) is not None:
            return self + other
        if isinstance(other, (OpAlgebra, int, float)):
            return LazyOp("+", _as_op(other), self)
        return NotImplemented

    def __repr__(self):
        return f"BlockDiagIEB({self.TT!r})"


# =========================================================================
# Scaled (scalar * op), supporting batched scalars
# =========================================================================

class Scaled(OpAlgebra):
    __slots__ = ("scalar", "op")

    def __init__(self, scalar, op):
        self.scalar = scalar
        self.op = op

    def __matmul__(self, f):
        g = self.op @ f
        if isinstance(g, Field):
            return Field(batch_broadcast(self.scalar, g) * g.arr, g.basis, g.proj)
        return self.scalar * g

    def solve(self, f):
        g = self.op.solve(f)
        if isinstance(g, Field):
            return Field(g.arr / batch_broadcast(self.scalar, g), g.basis, g.proj)
        return g / self.scalar

    @property
    def H(self):
        s = self.scalar
        return Scaled(torch.conj(s) if isinstance(s, torch.Tensor) else s, self.op.H)

    def sqrt(self):
        s = self.scalar
        return Scaled(torch.sqrt(s) if isinstance(s, torch.Tensor) else float(np.sqrt(s)),
                      self.op.sqrt())

    def pinv(self):
        return Scaled(1.0 / self.scalar, self.op.pinv())

    inv = pinv

    def __repr__(self):
        return f"({self.scalar} * {self.op!r})"


# =========================================================================
# LazyOp
# =========================================================================

class LazyOp(OpAlgebra):
    """Lazy binary composition of operators: (+, -, *)."""

    __slots__ = ("kind", "X", "Y")

    def __init__(self, kind, X, Y):
        self.kind = kind
        self.X = X
        self.Y = Y

    def __matmul__(self, f):
        if self.kind == "+":
            return (self.X @ f) + (self.Y @ f)
        if self.kind == "-":
            return (self.X @ f) - (self.Y @ f)
        if self.kind == "*":
            return self.X @ (self.Y @ f)
        raise ValueError(self.kind)

    def solve(self, f):
        if self.kind == "*":
            return self.Y.solve(self.X.solve(f))
        raise ValueError(f"can't invert lazy '{self.kind}' op")

    @property
    def H(self):
        if self.kind == "*":
            return LazyOp("*", self.Y.H, self.X.H)
        return LazyOp(self.kind, self.X.H, self.Y.H)

    def pinv(self):
        if self.kind == "*":
            return LazyOp("*", self.Y.pinv(), self.X.pinv())
        raise ValueError(f"can't invert lazy '{self.kind}' op")

    inv = pinv

    def __repr__(self):
        return f"({self.X!r} {self.kind} {self.Y!r})"


# =========================================================================
# FuncOp
# =========================================================================

class FuncOp(OpAlgebra):
    """An operator given by functions: op (apply), opH (the adjoint), opinv
    (the inverse) and opinvH (the inverse's adjoint), each optional."""

    def __init__(self, op=None, opH=None, opinv=None, opinvH=None):
        self.op = op
        self.opH = opH
        self.opinv = opinv
        self.opinvH = opinvH

    def __matmul__(self, f):
        if self.op is None:
            raise ValueError("op @ f not implemented")
        return self.op(f)

    def solve(self, f):
        if self.opinv is None:
            raise ValueError("op.solve(f) not implemented")
        return self.opinv(f)

    @property
    def H(self):
        return FuncOp(self.opH, self.op, self.opinvH, self.opinv)

    def inv(self):
        return FuncOp(self.opinv, self.opinvH, self.op, self.opH)

    pinv = inv


def SymmetricFuncOp(op=None, opinv=None):
    """A self-adjoint FuncOp."""
    return FuncOp(op, op, opinv, opinv)


# =========================================================================
# ParamDependentOp
# =========================================================================

class ParamDependentOp(OpAlgebra):
    """An operator depending on parameters theta, with its dependencies
    held explicitly: ``fn(deps, **theta)`` builds the operator. Calling
    op(theta) evaluates; using the op directly applies it at the
    fiducial parameters."""

    __slots__ = ("params", "fn", "deps")

    def __init__(self, params, fn, deps=()):
        self.params = tuple(params)
        self.fn = fn
        self.deps = tuple(deps)

    def __call__(self, theta=None, **kw):
        theta = dict(theta or {})
        theta.update(kw)
        relevant = ({k: v for k, v in theta.items() if k in self.params}
                    if self.params else dict(theta))
        if not relevant:
            return self.fiducial
        return self.fn(self.deps, **relevant)

    @property
    def fiducial(self):
        return self.fn(self.deps)

    def depends_on(self, theta):
        keys = theta.keys() if hasattr(theta, "keys") else theta
        return (not self.params) or any(k in self.params for k in keys)

    def __matmul__(self, f):
        return self.fiducial @ f

    def solve(self, f):
        return self.fiducial.solve(f)

    @property
    def H(self):
        return self.fiducial.H

    def sqrt(self):
        return self.fiducial.sqrt()

    def pinv(self):
        return self.fiducial.pinv()

    inv = pinv

    def __getitem__(self, k):
        return self.fiducial[k]


def evaluate_at(op, theta):
    """op(theta) for any operator, recursing through Scaled and LazyOp
    compositions; parameter-independent operators come back as they
    are."""
    if isinstance(op, ParamDependentOp):
        return op(theta)
    if isinstance(op, Scaled):
        inner = evaluate_at(op.op, theta)
        return op if inner is op.op else Scaled(op.scalar, inner)
    if isinstance(op, LazyOp):
        X = evaluate_at(op.X, theta)
        Y = evaluate_at(op.Y, theta)
        return op if (X is op.X and Y is op.Y) else LazyOp(op.kind, X, Y)
    return op


def depends_on(op, theta):
    if isinstance(op, ParamDependentOp):
        return op.depends_on(theta)
    if isinstance(op, Scaled):
        return depends_on(op.op, theta)
    if isinstance(op, LazyOp):
        return depends_on(op.X, theta) or depends_on(op.Y, theta)
    return False


# =========================================================================
# BandPass ops
# =========================================================================

def _bandpass_2d(ell, Wl, proj: ProjLambert):
    W = np.interp(np.asarray(proj.lmag, dtype=np.float64).ravel(),
                  np.asarray(ell, dtype=np.float64),
                  np.asarray(Wl, dtype=np.float64),
                  left=0.0, right=0.0).reshape(proj.shape_fourier)
    return W.astype(proj.T)


class BandPass:
    """An ell-space filter (ell, Wl), realized as a real Fourier Diag on
    a projection by .on(proj, pol)."""

    def __init__(self, ell, Wl):
        self.ell = np.asarray(ell, dtype=np.float64)
        self.Wl = np.asarray(Wl, dtype=np.float64)

    def on(self, proj: ProjLambert, pol="I") -> Diag:
        W = _bandpass_2d(self.ell, self.Wl, proj)
        b = Basis(pol, "fourier")
        arr = np.broadcast_to(W[None], (b.ncomp,) + W.shape).copy()
        return Diag(Field(torch.as_tensor(arr, device=proj.device), b, proj))

    def __call__(self, ell):
        return np.interp(np.asarray(ell, dtype=np.float64), self.ell, self.Wl, left=0.0, right=0.0)



def _cos_ramp_up(n):
    return (np.cos(np.linspace(np.pi, 0, n)) + 1) / 2


def _cos_ramp_down(n):
    return 1 - _cos_ramp_up(n)


def HighPass(ell, dl=50):
    """1 above ell + dl, a cosine ramp from 0 at ell up to it."""
    return BandPass(np.arange(ell, 20001),
                    np.concatenate([_cos_ramp_up(dl), np.ones(20000 - ell - dl + 1)]))


def LowPass(ell, dl=50):
    """1 below ell - dl, a cosine ramp down to 0 at ell."""
    return BandPass(np.arange(0, ell + 1),
                    np.concatenate([np.ones(ell - dl + 1), _cos_ramp_down(dl)]))


def MidPass(lmin, lmax, dl=50):
    """1 between lmin + dl and lmax - dl, cosine ramps to 0 at both ends."""
    return BandPass(np.arange(lmin, lmax + 1),
                    np.concatenate([_cos_ramp_up(dl), np.ones(lmax - lmin - 2 * dl + 1),
                                    _cos_ramp_down(dl)]))


def MidPasses(ledges, dl=10):
    """A MidPass for each bin of `ledges`, widened by dl / 2 each side."""
    return [MidPass(lo - dl // 2, hi + dl // 2, dl=dl) for lo, hi in zip(ledges[:-1], ledges[1:])]


# =========================================================================
# Derivative operators
# =========================================================================

def _ilx(proj):
    return (1j * proj.tensor("lx"))[None, :]


def _ily(proj):
    return (1j * proj.tensor("ly"))[:, None]


def grad_x(f: Field) -> Field:
    """d/dx, in the derivative basis."""
    g = f.to_deriv()
    return Field(g.arr * _ilx(g.proj), g.basis, g.proj)


def grad_y(f: Field) -> Field:
    """d/dy, in the derivative basis."""
    g = f.to_deriv()
    return Field(g.arr * _ily(g.proj), g.basis, g.proj)


def _neg_grad_x(f):
    return -grad_x(f)


def _neg_grad_y(f):
    return -grad_y(f)


_GRADIENT_OPS = (FuncOp(op=grad_x, opH=_neg_grad_x), FuncOp(op=grad_y, opH=_neg_grad_y))


def gradient_ops(proj=None):
    """(d/dx, d/dy) as FuncOps; the adjoint of each is its negative."""
    return _GRADIENT_OPS


def gradient(f: Field):
    """(df/dx, df/dy) in the derivative basis."""
    g = f.to_deriv()
    return (Field(g.arr * _ilx(g.proj), g.basis, g.proj),
            Field(g.arr * _ily(g.proj), g.basis, g.proj))


def gradhess(f: Field):
    """((gx, gy), ((gxx, gxy), (gxy, gyy))), Fields in the derivative
    basis."""
    g = f.to_deriv()
    ilx, ily = _ilx(g.proj), _ily(g.proj)
    gx = Field(g.arr * ilx, g.basis, g.proj)
    gy = Field(g.arr * ily, g.basis, g.proj)
    gxx = Field(gx.arr * ilx, g.basis, g.proj)
    gxy = Field(gx.arr * ily, g.basis, g.proj)
    gyy = Field(gy.arr * ily, g.basis, g.proj)
    return (gx, gy), ((gxx, gxy), (gxy, gyy))


def laplacian(f: Field) -> Field:
    g = f.to_deriv()
    l2 = g.proj.tensor("lx")[None, :] ** 2 + g.proj.tensor("ly")[:, None] ** 2
    return Field(-g.arr * l2, g.basis, g.proj)


# =========================================================================
# logdet / simulate
# =========================================================================

def logdet(op):
    """Log-determinant, per batch, with rfft degeneracy weights."""
    if isinstance(op, _Identity):
        return 0.0
    if isinstance(op, ParamDependentOp):
        return logdet(op.fiducial)
    if isinstance(op, Scaled):
        # logdet(s*A) = n_nonzero * log|s| + logdet(A), counting only
        # the nonzero modes of A (the pseudo-logdet convention)
        s = op.scalar
        logs = torch.log(torch.abs(s)) if isinstance(s, torch.Tensor) else float(np.log(abs(s)))
        return logdet(op.op) + _op_nonzero_dim(op.op) * logs
    if isinstance(op, BlockDiagIEB):
        tt, te, et, ee, bb = op._blocks()
        v = (safe_log_abs(tt * ee - te * et) + safe_log_abs(bb)) * op.proj.tensor("lam_rfft")
        return torch.sum(v, dim=(-1, -2, -3))
    if isinstance(op, Diag):
        d = op.diag
        if d.basis.is_fourier:
            v = safe_log_abs(d.arr) * d.proj.tensor("lam_rfft")
            return torch.sum(v, dim=(-1, -2, -3))
        return torch.sum(safe_log_abs(d.arr), dim=(-1, -2, -3))
    raise TypeError(f"logdet not implemented for {type(op)}")


def _op_nonzero_dim(op):
    """Number of nonzero modes of a Diag or BlockDiagIEB (a nonsingular TE
    block counts two), with rfft degeneracy weights."""
    if isinstance(op, BlockDiagIEB):
        tt, te, et, ee, bb = op._blocks()
        nz = ((tt * ee - te * et != 0) * 2 + (bb != 0)).to(op.proj.torch_T)
        return torch.sum(nz * op.proj.tensor("lam_rfft"), dim=(-1, -2, -3))
    if isinstance(op, Diag):
        d = op.diag
        nz = (d.arr != 0).to(d.proj.torch_T)
        if d.basis.is_fourier:
            nz = nz * d.proj.tensor("lam_rfft")
        return torch.sum(nz, dim=(-1, -2, -3))
    raise TypeError(f"logdet of Scaled({type(op).__name__}) needs a Diag or BlockDiagIEB inside")


def logdet_rel(op, theta):
    """logdet(op(theta)) - logdet(op(fiducial)) if op depends on theta,
    else 0."""
    if depends_on(op, theta):
        fid = op.fiducial if isinstance(op, ParamDependentOp) else evaluate_at(op, {})
        return logdet(evaluate_at(op, theta)) - logdet(fid)
    return 0.0


def _diag_field_of(op):
    if isinstance(op, Diag):
        return op.diag
    if isinstance(op, BlockDiagIEB):
        return op.diag()
    if isinstance(op, ParamDependentOp):
        return _diag_field_of(op.fiducial)
    if isinstance(op, Scaled):
        f = _diag_field_of(op.op)
        return Field(batch_broadcast(op.scalar, f) * f.arr, f.basis, f.proj)
    raise TypeError(type(op))


def tr(op):
    """The trace of a Diag, per batch (rfft degeneracy weights in
    Fourier)."""
    if isinstance(op, Diag):
        d = op.diag
        if d.basis.is_fourier:
            return torch.sum(torch.real(d.arr * d.proj.tensor("lam_rfft")), dim=(-1, -2, -3))
        return torch.sum(d.arr, dim=(-1, -2, -3))
    raise TypeError(type(op))


def diag_field(op):
    """The diagonal of a Diag, BlockDiagIEB, ParamDependentOp or Scaled
    operator, as a Field."""
    return _diag_field_of(op)


def simulate_op(generator, op, batch_shape=()):
    """Draw xi with <xi xi'> = op: sqrt(op) @ white noise of batch shape
    `batch_shape` drawn from `generator`."""
    xi = white_noise_like(generator, _diag_field_of(op), batch_shape=batch_shape)
    if isinstance(op, ParamDependentOp):
        op = op.fiducial
    return op.sqrt() @ xi
