"""Tempered GP (counterpart of
``projected_langevin_sampling_tpu/models/temper/gp.py``; reference
``temper/gp.py:11-40``)."""

from __future__ import annotations

import torch

from projected_langevin_sampling_torch.models.distributions import (
    MultivariateNormal,
    StudentTMarginals,
)
from projected_langevin_sampling_torch.models.temper.base import TemperBase


class TemperGP(TemperBase):
    """Temper the predictive variance of an ExactGP or SVGP (the reference's
    ``gp.likelihood(gp(x))`` is ``gp.predict_y``). Student-T marginals are
    moment-matched to a Gaussian, as the reference tempers a gpytorch
    StudentTLikelihood marginal through its mean and covariance."""

    def __init__(self, gp, x_calibration: torch.Tensor, y_calibration: torch.Tensor):
        self.gp = gp
        super().__init__(x_calibration, y_calibration)

    def _untempered_predict(self, x: torch.Tensor) -> MultivariateNormal:
        prediction = self.gp.predict_y(x)
        if isinstance(prediction, StudentTMarginals):
            return MultivariateNormal(mean=prediction.mean, variance=prediction.variance)
        if not isinstance(prediction, MultivariateNormal):
            raise TypeError(f"tempering needs a Gaussian or Student-T prediction, got "
                            f"{type(prediction).__name__}")
        return prediction
