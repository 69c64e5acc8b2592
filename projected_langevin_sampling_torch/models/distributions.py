"""Predictive-distribution containers (the ``MultivariateNormal`` part of
``projected_langevin_sampling_tpu/models/distributions.py:49-77``)."""

from __future__ import annotations

import dataclasses
import math

import torch


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
