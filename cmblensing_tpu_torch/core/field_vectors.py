"""Small vectors and matrices of fields and diagonal operators.

Counterpart of ``cmblensing_tpu/core/field_vectors.py`` (reference
src/field_vectors.jl): 2-vectors of fields (gradients), 2 x 2 matrices of
fields or Diag operators (lensing magnification matrices), with the
closed-form 2 x 2 determinant, inverse and square root. LenseFlow does not
use them: its kernels form the 2 x 2 inverse pixel by pixel.
"""
from __future__ import annotations

import torch

from .field import Field, dot as field_dot
from .ops import Diag, gradient, gradhess


class FieldVector:
    """A vector of fields: v = [vx, vy, ...]."""

    __slots__ = ("components",)

    def __init__(self, *components):
        if len(components) == 1 and isinstance(components[0], (list, tuple)):
            components = tuple(components[0])
        self.components = tuple(components)

    def __len__(self):
        return len(self.components)

    def __iter__(self):
        return iter(self.components)

    def __getitem__(self, i):
        return self.components[i]

    def _zip(self, other, op):
        if isinstance(other, FieldVector):
            if len(other) != len(self):
                raise ValueError(f"vectors of {len(self)} and {len(other)} fields")
            return FieldVector(*(op(a, b) for a, b in zip(self, other)))
        return FieldVector(*(op(a, other) for a in self))

    def __add__(self, o):
        return self._zip(o, lambda a, b: a + b)

    def __sub__(self, o):
        return self._zip(o, lambda a, b: a - b)

    def __mul__(self, o):
        return self._zip(o, lambda a, b: a * b)

    __rmul__ = __mul__

    def __neg__(self):
        return FieldVector(*(-a for a in self))

    def dot(self, other: "FieldVector"):
        """v' w = sum_i <v_i, w_i> (per batch)."""
        tot = None
        for a, b in zip(self, other):
            d = field_dot(a, b)
            tot = d if tot is None else tot + d
        return tot

    def outer(self, other: "FieldVector"):
        """v w' as a matrix of pointwise products."""
        return FieldMatrix(tuple(tuple(a * b for b in other) for a in self))

    def pointwise_dot(self, other: "FieldVector") -> Field:
        """sum_i v_i * w_i as a field (pointwise, e.g. p . grad f)."""
        out = None
        for a, b in zip(self, other):
            p = a * b
            out = p if out is None else out + p
        return out

    def norm2(self) -> Field:
        """|v|^2, pointwise."""
        return self.pointwise_dot(self)

    def __repr__(self):
        return f"FieldVector({len(self)} components)"


class FieldMatrix:
    """An n x n matrix of fields or Diag-like operators (anything with +,
    * and @), with the closed-form 2 x 2 det, pinv and sqrt."""

    __slots__ = ("rows",)

    def __init__(self, rows):
        self.rows = tuple(tuple(r) for r in rows)

    @property
    def shape(self):
        return (len(self.rows), len(self.rows[0]))

    def __getitem__(self, ij):
        i, j = ij
        return self.rows[i][j]

    @staticmethod
    def _apply_entry(e, f):
        return e @ f if hasattr(e, "__matmul__") and not isinstance(e, Field) else e * f

    def __matmul__(self, v):
        if isinstance(v, FieldVector):
            out = []
            for row in self.rows:
                acc = None
                for e, c in zip(row, v):
                    t = self._apply_entry(e, c)
                    acc = t if acc is None else acc + t
                out.append(acc)
            return FieldVector(*out)
        if isinstance(v, FieldMatrix):
            n, m = self.shape
            p = v.shape[1]
            rows = []
            for i in range(n):
                row = []
                for j in range(p):
                    acc = None
                    for k in range(m):
                        t = self.rows[i][k] * v.rows[k][j]
                        acc = t if acc is None else acc + t
                    row.append(acc)
                rows.append(tuple(row))
            return FieldMatrix(rows)
        return NotImplemented

    def __add__(self, o):
        if not (isinstance(o, FieldMatrix) and o.shape == self.shape):
            raise ValueError("FieldMatrix + takes a FieldMatrix of the same shape")
        return FieldMatrix(tuple(tuple(a + b for a, b in zip(r1, r2))
                                 for r1, r2 in zip(self.rows, o.rows)))

    def __mul__(self, s):
        return FieldMatrix(tuple(tuple(s * e for e in r) for r in self.rows))

    __rmul__ = __mul__

    @property
    def T(self):
        n, m = self.shape
        return FieldMatrix(tuple(tuple(self.rows[j][i] for j in range(n)) for i in range(m)))

    def _two(self):
        if self.shape != (2, 2):
            raise ValueError(f"a 2 x 2 FieldMatrix, not {self.shape}")
        return self.rows

    def det(self):
        """The 2 x 2 determinant (a field or an operator)."""
        (a, b), (c, d) = self._two()
        return a * d - b * c

    def pinv(self):
        """The closed-form 2 x 2 inverse."""
        (a, b), (c, d) = self._two()
        idet = _entrywise(self.det(), lambda x: 1.0 / x)
        return FieldMatrix(((idet * d, idet * (-1 * b)), (idet * (-1 * c), idet * a)))

    def sqrt(self):
        """The principal square root of a symmetric positive definite 2 x 2
        matrix, by sqrt(M) = (M + sqrt(det) I) / sqrt(tr + 2 sqrt(det))."""
        (a, b), (c, d) = self._two()
        s = _entrywise(self.det(), _sqrt)
        t = _entrywise(a + d + s + s, lambda x: 1.0 / _sqrt(x))
        return FieldMatrix(((t * (a + s), t * b), (t * c, t * (d + s))))

    def __repr__(self):
        return f"FieldMatrix({self.shape})"


def _sqrt(x):
    return torch.sqrt(x) if isinstance(x, torch.Tensor) else x ** 0.5


def _entrywise(x, fn):
    """fn on the values of a Diag or a Field, or on a number."""
    if isinstance(x, Diag):
        return Diag(Field(fn(x.diag.arr), x.diag.basis, x.diag.proj))
    if isinstance(x, Field):
        return Field(fn(x.arr), x.basis, x.proj)
    return fn(x)


def _to_map(x):
    return x.to(x.basis.with_space("map"))


def gradient_vector(f: Field) -> FieldVector:
    """grad f as a FieldVector of map-basis fields (the vector and matrix
    algebra is pointwise in pixel space)."""
    return FieldVector(*(_to_map(g) for g in gradient(f)))


def hessian_matrix(f: Field) -> FieldMatrix:
    """grad grad f as a 2 x 2 FieldMatrix of map-basis fields."""
    _, H = gradhess(f)
    return FieldMatrix(tuple(tuple(_to_map(e) for e in row) for row in H))


def magnification_matrix(phi: Field, t=1.0) -> FieldMatrix:
    """M(t) = I + t grad grad phi, a FieldMatrix of map-basis fields."""
    _, H = gradhess(phi)
    h00 = _to_map(H[0][0])
    one = Field(torch.ones_like(h00.arr), h00.basis, phi.proj)
    return FieldMatrix(((one + t * h00, t * _to_map(H[0][1])),
                        (t * _to_map(H[1][0]), one + t * _to_map(H[1][1]))))
