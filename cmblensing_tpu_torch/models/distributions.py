"""Gaussian distributions over fields.

logpdf(MvNormal(mu, Sigma), f) = -( (f-mu)' Sigma^-1 (f-mu) + logdet Sigma ) / 2
sample = mu + sqrt(Sigma) @ white noise
"""
from __future__ import annotations

from ..core.field import dot
from ..core.ops import logdet, simulate_op


class MvNormal:
    """Gaussian over fields with a field-operator covariance."""

    def __init__(self, mu, Sigma):
        self.mu = mu          # field or 0
        self.Sigma = Sigma    # operator

    def sample(self, generator, batch_shape=()):
        xi = simulate_op(generator, self.Sigma, batch_shape=batch_shape)
        if not isinstance(self.mu, (int, float)):
            return self.mu + xi
        return xi

    def logpdf(self, f):
        z = f - self.mu if not isinstance(self.mu, (int, float)) else f
        return -(dot(z, self.Sigma.solve(z)) + logdet(self.Sigma)) / 2
