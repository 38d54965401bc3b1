"""FieldTuple: named fields acting as one field.

Counterpart of ``cmblensing_tpu/core/field_tuple.py`` (reference
src/field_tuples.jl): componentwise arithmetic and basis conversion, the
summed dot product, and the block-diagonal operator over the components.
"""
from __future__ import annotations

import operator

import torch

from .field import Field, dot as field_dot


class FieldTuple:
    __slots__ = ("fields",)

    def __init__(self, **fields):
        self.fields = dict(fields)

    @classmethod
    def from_dict(cls, d):
        ft = cls()
        ft.fields.update(d)
        return ft

    def __getitem__(self, k):
        return self.fields[k]

    def __getattr__(self, k):
        try:
            return self.fields[k]
        except KeyError:
            raise AttributeError(k) from None

    def keys(self):
        return self.fields.keys()

    def items(self):
        return self.fields.items()

    def _binop(self, other, op):
        if isinstance(other, FieldTuple):
            return FieldTuple.from_dict({k: op(v, other.fields[k]) for k, v in self.fields.items()})
        return FieldTuple.from_dict({k: op(v, other) for k, v in self.fields.items()})

    def __add__(self, o):
        return self._binop(o, operator.add)

    def __sub__(self, o):
        return self._binop(o, operator.sub)

    def __mul__(self, o):
        return self._binop(o, operator.mul)

    def __rmul__(self, o):
        return self._binop(o, lambda a, b: b * a)

    def __neg__(self):
        return FieldTuple.from_dict({k: -v for k, v in self.fields.items()})

    def to(self, basis):
        """Each Field component converted to `basis`; other components as
        they are."""
        return FieldTuple.from_dict({k: (v.to(basis) if isinstance(v, Field) else v)
                                     for k, v in self.fields.items()})

    def __repr__(self):
        return f"FieldTuple({', '.join(self.fields)})"


def ft_dot(a: FieldTuple, b: FieldTuple):
    """The sum over the components of their dot products (a tensor
    component's: the sum of its elementwise product)."""
    tot = None
    for k in a.fields:
        x, y = a.fields[k], b.fields[k]
        d = field_dot(x, y) if isinstance(x, Field) else torch.sum(x * y)
        tot = d if tot is None else tot + d
    return tot


class DiagFieldTuple:
    """A block-diagonal operator over a FieldTuple: one operator a
    component (components without one pass through)."""

    def __init__(self, **ops):
        self.ops = dict(ops)

    def __matmul__(self, ft: FieldTuple):
        return FieldTuple.from_dict({k: (self.ops[k] @ v if k in self.ops else v)
                                     for k, v in ft.fields.items()})

    def solve(self, ft: FieldTuple):
        return FieldTuple.from_dict({k: (self.ops[k].solve(v) if k in self.ops else v)
                                     for k, v in ft.fields.items()})

    @property
    def H(self):
        return DiagFieldTuple(**{k: op.H for k, op in self.ops.items()})

    def pinv(self):
        return DiagFieldTuple(**{k: op.pinv() for k, op in self.ops.items()})
