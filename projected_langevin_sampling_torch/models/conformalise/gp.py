"""Conformalised GP (counterpart of
``projected_langevin_sampling_tpu/models/conformalise/gp.py``; reference
``conformalise/gp.py:12-64``): the raw bounds are Gaussian predictive
intervals."""

from __future__ import annotations

import scipy.stats
import torch

from projected_langevin_sampling_torch.models.conformalise.base import ConformaliseBase
from projected_langevin_sampling_torch.models.distributions import (
    MultivariateNormal,
    StudentTMarginals,
)


class ConformaliseGP(ConformaliseBase):
    def __init__(self, gp, x_calibration: torch.Tensor, y_calibration: torch.Tensor):
        self.gp = gp
        super().__init__(x_calibration, y_calibration)

    @property
    def likelihood(self):
        return getattr(self.gp, "likelihood", None)

    def _predict_uncalibrated_coverage(
        self, x: torch.Tensor, coverage: float
    ) -> tuple[torch.Tensor, torch.Tensor]:
        prediction = self.gp.predict_y(x)
        z = float(scipy.stats.norm.interval(coverage)[1])
        if isinstance(prediction, (MultivariateNormal, StudentTMarginals)):
            # a Student-T marginal's Gaussian interval on its first two moments
            # (the reference averages gpytorch's sampled marginals,
            # conformalise/gp.py:50-53)
            loc, std = prediction.mean, torch.sqrt(prediction.variance)
        else:
            raise ValueError(f"Unknown predictive type: {type(prediction)=}")
        return loc - z * std, loc + z * std

    def predict_median(self, x: torch.Tensor) -> torch.Tensor:
        return self.gp(x).mean
