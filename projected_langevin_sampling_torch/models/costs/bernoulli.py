"""Bernoulli (binary classification) cost (counterpart of
``projected_langevin_sampling_tpu/models/costs/bernoulli.py``; reference
``costs/bernoulli.py:10-99``)."""

from __future__ import annotations

import dataclasses

import torch

from projected_langevin_sampling_torch.models.costs.base import PLSCostMixin
from projected_langevin_sampling_torch.models.distributions import Bernoulli
from projected_langevin_sampling_torch.models.link_functions import (
    PLSLinkFunction,
    SigmoidLinkFunction,
)


@dataclasses.dataclass(frozen=True)
class BernoulliCost(PLSCostMixin):
    y_train: torch.Tensor  # (N,) in {0, 1}
    link_function: PLSLinkFunction = SigmoidLinkFunction()
    observation_noise: None = None

    def replace(self, **changes) -> BernoulliCost:
        return dataclasses.replace(self, **changes)

    def predict(self, prediction_samples: torch.Tensor) -> Bernoulli:
        return Bernoulli(probs=torch.mean(prediction_samples, dim=1))

    def calculate_cost(self, untransformed_train_prediction_samples: torch.Tensor) -> torch.Tensor:
        """Cross-entropy per particle (``bernoulli.py:48-62``)."""
        p = self.link_function(untransformed_train_prediction_samples)  # (N, J)
        y = self.y_train[:, None]
        return -torch.sum(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p), dim=0)

    def calculate_cost_derivative(
        self, untransformed_train_prediction_samples: torch.Tensor, force_autograd: bool = False
    ) -> torch.Tensor:
        """Closed form for the sigmoid link, -y (1 - p) + (1 - y) p
        (``bernoulli.py:64-77``); autograd for any other link."""
        if isinstance(self.link_function, SigmoidLinkFunction) and not force_autograd:
            p = self.link_function(untransformed_train_prediction_samples)
            y = self.y_train[:, None]
            return -y * (1.0 - p) + (1.0 - y) * p
        return self._calculate_cost_derivative_autograd(untransformed_train_prediction_samples)
