"""Variance tempering (counterpart of
``projected_langevin_sampling_tpu/models/temper/base.py``; reference
``temper/base.py:7-62``): the NLL-minimising factor

    scale = (2/N) sum_i (y_i - m(x_i))^2 / sigma_i^2

on a held-out split multiplies the predictive variance. Regression only.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import torch

from projected_langevin_sampling_torch.models.distributions import MultivariateNormal


class TemperBase(ABC):
    def __init__(self, x_calibration: torch.Tensor, y_calibration: torch.Tensor, **noise):
        self.scale = self._calculate_scale(x_calibration, y_calibration, **noise)

    def _calculate_scale(self, x_calibration, y_calibration, **noise) -> float:
        prediction = self._untempered_predict(x_calibration, **noise)
        return float(
            2.0 * torch.mean(torch.square(y_calibration - prediction.mean) / prediction.variance)
        )

    @abstractmethod
    def _untempered_predict(self, x: torch.Tensor, **noise) -> MultivariateNormal:
        raise NotImplementedError

    def predict(self, x: torch.Tensor, **noise) -> MultivariateNormal:
        prediction = self._untempered_predict(x, **noise)
        return MultivariateNormal(mean=prediction.mean, variance=prediction.variance * self.scale)

    def __call__(self, x: torch.Tensor, **noise) -> MultivariateNormal:
        return self.predict(x, **noise)
