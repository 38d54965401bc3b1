"""Gaussian distributions over fields.

logpdf(MvNormal(mu, Sigma), f) = -( (f-mu)' Sigma^-1 (f-mu) + logdet Sigma ) / 2
sample = mu + sqrt(Sigma) @ white noise

Lambert fields with Fourier-diagonal covariances, and EquiRect fields with
BlockDiagEquiRect covariances.
"""
from __future__ import annotations

from ..core.field import dot as field_dot
from ..core.ops import logdet as op_logdet, simulate_op
from ..core.proj_equirect import BlockDiagEquiRect, EquiRectField, er_dot


def _dot(a, b):
    return er_dot(a, b) if isinstance(a, EquiRectField) else field_dot(a, b)


def _logdet(op):
    return op.logabsdet()[0] if isinstance(op, BlockDiagEquiRect) else op_logdet(op)


def _simulate(generator, op, batch_shape=()):
    if isinstance(op, BlockDiagEquiRect):
        return op.simulate(generator, batch_shape=batch_shape)
    return simulate_op(generator, op, batch_shape=batch_shape)


class MvNormal:
    """Gaussian over fields with a field-operator covariance."""

    def __init__(self, mu, Sigma):
        self.mu = mu          # field or 0
        self.Sigma = Sigma    # operator

    def sample(self, generator, batch_shape=()):
        xi = _simulate(generator, self.Sigma, batch_shape=batch_shape)
        if not isinstance(self.mu, (int, float)):
            return self.mu + xi
        return xi

    def logpdf(self, f):
        z = f - self.mu if not isinstance(self.mu, (int, float)) else f
        return -(_dot(z, self.Sigma.solve(z)) + _logdet(self.Sigma)) / 2
