"""Student-T (heavy-tailed regression) cost (counterpart of
``projected_langevin_sampling_tpu/models/costs/student_t.py``; reference
``costs/student_t.py:11-110``). ``degrees_of_freedom`` and ``scale`` are
Python floats, as in the JAX package."""

from __future__ import annotations

import dataclasses

import torch

from projected_langevin_sampling_torch.models.costs.base import PLSCostMixin
from projected_langevin_sampling_torch.models.distributions import StudentTMarginals
from projected_langevin_sampling_torch.models.link_functions import (
    IdentityLinkFunction,
    PLSLinkFunction,
)


@dataclasses.dataclass(frozen=True)
class StudentTCost(PLSCostMixin):
    y_train: torch.Tensor  # (N,)
    degrees_of_freedom: float
    scale: float = 1.0
    link_function: PLSLinkFunction = IdentityLinkFunction()
    observation_noise: None = None

    def replace(self, **changes) -> StudentTCost:
        return dataclasses.replace(self, **changes)

    def predict(self, prediction_samples: torch.Tensor) -> StudentTMarginals:
        """loc = mean of link(samples), the shared fitted scale
        (``student_t.py:40-53``)."""
        loc = torch.mean(self.link_function(prediction_samples), dim=1)
        return StudentTMarginals(
            df=self.degrees_of_freedom, loc=loc, scale=self.scale * torch.ones_like(loc)
        )

    def calculate_cost(self, untransformed_train_prediction_samples: torch.Tensor) -> torch.Tensor:
        """0.5 (df + 1) sum_n log(1 + e^2 / (df scale^2)) per particle
        (``student_t.py:55-72``)."""
        pred = self.link_function(untransformed_train_prediction_samples)
        errors = pred - self.y_train[:, None]
        df, s2 = self.degrees_of_freedom, self.scale**2
        return 0.5 * (df + 1.0) * torch.sum(torch.log1p(torch.square(errors) / (df * s2)), dim=0)

    def calculate_cost_derivative(
        self, untransformed_train_prediction_samples: torch.Tensor, force_autograd: bool = False
    ) -> torch.Tensor:
        """Closed form for the identity link, (df + 1) e / (df scale^2 + e^2)
        (``student_t.py:74-88``)."""
        if isinstance(self.link_function, IdentityLinkFunction) and not force_autograd:
            pred = self.link_function(untransformed_train_prediction_samples)
            errors = pred - self.y_train[:, None]
            df, s2 = self.degrees_of_freedom, self.scale**2
            return (df + 1.0) * errors / (df * s2 + torch.square(errors))
        return self._calculate_cost_derivative_autograd(untransformed_train_prediction_samples)
