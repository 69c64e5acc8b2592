"""Gaussian (regression) cost (counterpart of
``projected_langevin_sampling_tpu/models/costs/gaussian.py``; reference
``costs/gaussian.py:11-110``)."""

from __future__ import annotations

import dataclasses

import torch

from projected_langevin_sampling_torch.models.costs.base import PLSCostMixin
from projected_langevin_sampling_torch.models.distributions import MultivariateNormal
from projected_langevin_sampling_torch.models.link_functions import (
    IdentityLinkFunction,
    PLSLinkFunction,
)


@dataclasses.dataclass(frozen=True)
class GaussianCost(PLSCostMixin):
    y_train: torch.Tensor  # (N,)
    observation_noise: torch.Tensor  # scalar, the noise *variance* in the NLL
    link_function: PLSLinkFunction = IdentityLinkFunction()

    def replace(self, **changes) -> GaussianCost:
        return dataclasses.replace(self, **changes)

    def predict(self, prediction_samples: torch.Tensor) -> MultivariateNormal:
        """Moment-match over particles; unbiased (ddof=1) variance."""
        return MultivariateNormal(
            mean=torch.mean(prediction_samples, dim=1),
            variance=torch.var(prediction_samples, dim=1, correction=1),
        )

    def calculate_cost(self, untransformed_train_prediction_samples: torch.Tensor) -> torch.Tensor:
        """(1 / (2 sigma^2)) ||link(F) - y||^2 per particle."""
        pred = self.link_function(untransformed_train_prediction_samples)
        errors = pred - self.y_train[:, None]
        return (0.5 / self.observation_noise) * torch.sum(torch.square(errors), dim=0)

    def calculate_cost_derivative(
        self, untransformed_train_prediction_samples: torch.Tensor, force_autograd: bool = False
    ) -> torch.Tensor:
        if isinstance(self.link_function, IdentityLinkFunction) and not force_autograd:
            pred = self.link_function(untransformed_train_prediction_samples)
            return (pred - self.y_train[:, None]) / self.observation_noise
        return self._calculate_cost_derivative_autograd(untransformed_train_prediction_samples)
