"""Bimodal Gaussian-mixture cost (counterpart of
``projected_langevin_sampling_tpu/models/costs/multimodal.py``; reference
``costs/multimodal.py:7-91``).

The two modes are the data likelihood shifted by ``shift``, with mixture
weights (bernoulli_noise, 1 - bernoulli_noise); the per-particle NLL is a
logsumexp over modes. The derivative is always autograd, as in the reference
(``multimodal.py:79-91``); only the general kernel has the closed form.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from projected_langevin_sampling_torch.models.costs.base import PLSCostMixin
from projected_langevin_sampling_torch.models.link_functions import (
    IdentityLinkFunction,
    PLSLinkFunction,
)


@dataclasses.dataclass(frozen=True)
class MultiModalCost(PLSCostMixin):
    y_train: torch.Tensor  # (N,)
    observation_noise: torch.Tensor  # scalar sigma (a std, squared in the density)
    shift: float
    bernoulli_noise: float
    link_function: PLSLinkFunction = IdentityLinkFunction()

    def replace(self, **changes) -> MultiModalCost:
        return dataclasses.replace(self, **changes)

    def predict(self, prediction_samples: torch.Tensor) -> None:
        """Left unimplemented, as in the reference (``multimodal.py:31-35``):
        mixture experiments read the raw samples."""
        return None

    def calculate_cost(self, untransformed_train_prediction_samples: torch.Tensor) -> torch.Tensor:
        pred = self.link_function(untransformed_train_prediction_samples)
        y = self.y_train[:, None]
        sigma2 = torch.square(self.observation_noise)
        log_norm = 0.5 * torch.log(2.0 * math.pi * sigma2)

        errors_mode_1 = y - pred + self.shift
        errors_mode_2 = y - pred
        log_lik_1 = -0.5 * torch.square(errors_mode_1) / sigma2 - log_norm
        log_lik_2 = -0.5 * torch.square(errors_mode_2) / sigma2 - log_norm

        stacked = torch.stack(
            [
                math.log(self.bernoulli_noise) + log_lik_1,
                math.log(1.0 - self.bernoulli_noise) + log_lik_2,
            ]
        )  # (2, N, J)
        return -torch.sum(torch.logsumexp(stacked, dim=0), dim=0)

    def calculate_cost_derivative(
        self, untransformed_train_prediction_samples: torch.Tensor, force_autograd: bool = False
    ) -> torch.Tensor:
        return self._calculate_cost_derivative_autograd(untransformed_train_prediction_samples)
