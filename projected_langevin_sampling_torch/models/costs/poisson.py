"""Poisson (count regression) cost (counterpart of
``projected_langevin_sampling_tpu/models/costs/poisson.py``; reference
``costs/poisson.py:10-104``)."""

from __future__ import annotations

import dataclasses

import torch

from projected_langevin_sampling_torch.models.costs.base import PLSCostMixin
from projected_langevin_sampling_torch.models.distributions import Poisson
from projected_langevin_sampling_torch.models.link_functions import (
    PLSLinkFunction,
    SquareLinkFunction,
)


@dataclasses.dataclass(frozen=True)
class PoissonCost(PLSCostMixin):
    y_train: torch.Tensor  # (N,) counts
    link_function: PLSLinkFunction = SquareLinkFunction()
    observation_noise: None = None

    def replace(self, **changes) -> PoissonCost:
        return dataclasses.replace(self, **changes)

    def predict(self, prediction_samples: torch.Tensor) -> Poisson:
        return Poisson(rate=torch.mean(prediction_samples, dim=1))

    def calculate_cost(self, untransformed_train_prediction_samples: torch.Tensor) -> torch.Tensor:
        """sum_n (-2 y log|f| + link(f)) per particle (``poisson.py:47-66``)."""
        f = untransformed_train_prediction_samples
        rate = self.link_function(f)
        return torch.sum(-2.0 * self.y_train[:, None] * torch.log(torch.abs(f)) + rate, dim=0)

    def calculate_cost_derivative(
        self, untransformed_train_prediction_samples: torch.Tensor, force_autograd: bool = False
    ) -> torch.Tensor:
        """Closed form for the square link, -2 y / f + 2 f (``poisson.py:68-82``)."""
        if isinstance(self.link_function, SquareLinkFunction) and not force_autograd:
            f = untransformed_train_prediction_samples
            return -2.0 * self.y_train[:, None] / f + 2.0 * f
        return self._calculate_cost_derivative_autograd(untransformed_train_prediction_samples)
