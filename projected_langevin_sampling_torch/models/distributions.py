"""Predictive-distribution containers (counterpart of
``projected_langevin_sampling_tpu/models/distributions.py``): plain dataclasses
of tensors with the log-densities and NLLs the metrics read."""

from __future__ import annotations

import dataclasses
import math

import torch


def student_t_log_normalizer(df: float) -> float:
    """``log Gamma((df+1)/2) - log Gamma(df/2) - 0.5 log(df pi)`` on the host
    in fp64.

    The two lgammas grow like ``df log df`` while their difference stays
    O(log df), so evaluating them in the working dtype cancels badly for the
    huge df a Student-T fit returns on near-Gaussian residuals. For
    df > 1e6 even fp64 loses the difference, and the asymptote
    ``-0.5 log(2 pi) - 1/(4 df)`` (from ``log Gamma(x + 1/2) - log Gamma(x)
    = 0.5 log x - 1/(8x) + O(x^-2)``, x = df/2) takes over."""
    df = float(df)
    if df > 1e6:
        return -0.5 * math.log(2.0 * math.pi) - 1.0 / (4.0 * df)
    return math.lgamma((df + 1.0) / 2.0) - math.lgamma(df / 2.0) - 0.5 * math.log(df * math.pi)


@dataclasses.dataclass(frozen=True)
class MultivariateNormal:
    """Moment-matched Gaussian predictive with diagonal covariance
    (reference ``costs/gaussian.py:40-52``)."""

    mean: torch.Tensor  # (N,)
    variance: torch.Tensor  # (N,)

    @property
    def covariance_matrix(self) -> torch.Tensor:
        return torch.diag(self.variance)

    @property
    def stddev(self) -> torch.Tensor:
        return torch.sqrt(self.variance)

    def log_prob_marginals(self, y: torch.Tensor) -> torch.Tensor:
        """Per-point Gaussian log-density (N,)."""
        var = self.variance
        return -0.5 * (torch.log(2.0 * math.pi * var) + torch.square(y - self.mean) / var)

    def negative_log_likelihood(self, y: torch.Tensor) -> torch.Tensor:
        """Mean marginal NLL."""
        return -torch.mean(self.log_prob_marginals(y))


@dataclasses.dataclass(frozen=True)
class Bernoulli:
    probs: torch.Tensor  # (N,)

    @property
    def mean(self) -> torch.Tensor:
        return self.probs

    def log_prob(self, y: torch.Tensor) -> torch.Tensor:
        p = self.probs
        return y * torch.log(p) + (1.0 - y) * torch.log1p(-p)

    def negative_log_likelihood(self, y: torch.Tensor) -> torch.Tensor:
        return -torch.mean(self.log_prob(y))


@dataclasses.dataclass(frozen=True)
class Poisson:
    rate: torch.Tensor  # (N,)

    @property
    def mean(self) -> torch.Tensor:
        return self.rate

    def log_prob(self, y: torch.Tensor) -> torch.Tensor:
        return y * torch.log(self.rate) - self.rate - torch.lgamma(y + 1.0)

    def negative_log_likelihood(self, y: torch.Tensor) -> torch.Tensor:
        return -torch.mean(self.log_prob(y))


@dataclasses.dataclass(frozen=True)
class StudentTMarginals:
    """Per-point Student-T marginals with shared degrees of freedom
    (reference ``src/distributions.py:8-42``, vectorised)."""

    df: float
    loc: torch.Tensor  # (N,)
    scale: torch.Tensor  # (N,)

    @property
    def mean(self) -> torch.Tensor:
        return self.loc

    @property
    def variance(self) -> torch.Tensor:
        """scale^2 df / (df - 2) for df > 2, else scale^2 (a finite fallback)."""
        if self.df > 2:
            return torch.square(self.scale) * (self.df / (self.df - 2.0))
        return torch.square(self.scale)

    @property
    def covariance_matrix(self) -> torch.Tensor:
        return torch.diag(self.variance)

    def log_prob(self, y: torch.Tensor) -> torch.Tensor:
        df = float(self.df)
        z = (y - self.loc) / self.scale
        return (
            student_t_log_normalizer(df)
            - torch.log(self.scale)
            - ((df + 1.0) / 2.0) * torch.log1p(torch.square(z) / df)
        )

    def negative_log_likelihood(self, y: torch.Tensor) -> torch.Tensor:
        return -torch.mean(self.log_prob(y))
