"""Tempered PLS (counterpart of
``projected_langevin_sampling_tpu/models/temper/pls.py``; reference
``temper/pls.py:9-52``)."""

from __future__ import annotations

import torch

from projected_langevin_sampling_torch.models.costs.gaussian import GaussianCost
from projected_langevin_sampling_torch.models.distributions import MultivariateNormal
from projected_langevin_sampling_torch.models.pls import PLS
from projected_langevin_sampling_torch.models.temper.base import TemperBase
from projected_langevin_sampling_torch.utils.prng import GeneratorLike, as_generator


class TemperPLS(TemperBase):
    """Temper a PLS model's predictive variance; needs a Gaussian cost
    (regression) unless ``debug``.

    Every predict call draws fresh noise from one generator made from
    ``generator``, so a run is reproducible from it. ``predictive_noise`` and
    ``observation_noise`` inject the calibration call's noise (the parity
    hook); ``predict`` takes the same keywords."""

    def __init__(
        self,
        x_calibration: torch.Tensor,
        y_calibration: torch.Tensor,
        pls: PLS,
        particles: torch.Tensor,
        debug: bool = False,
        generator: GeneratorLike = None,
        predictive_noise: torch.Tensor | None = None,
        observation_noise: torch.Tensor | None = None,
    ):
        self.debug = debug
        if not self.debug and not isinstance(pls.cost, GaussianCost):
            raise TypeError("TemperPLS needs a GaussianCost (regression) unless debug")
        self.pls = pls
        self.particles = particles
        self._generator = as_generator(generator, device=particles.device)
        super().__init__(
            x_calibration,
            y_calibration,
            predictive_noise=predictive_noise,
            observation_noise=observation_noise,
        )

    def _untempered_predict(
        self,
        x: torch.Tensor,
        predictive_noise: torch.Tensor | None = None,
        observation_noise: torch.Tensor | None = None,
    ) -> MultivariateNormal:
        prediction = self.pls(
            x=x,
            particles=self.particles,
            predictive_noise=predictive_noise,
            observation_noise=observation_noise,
            generator=self._generator,
        )
        if not self.debug and not isinstance(prediction, MultivariateNormal):
            raise TypeError("tempering needs a MultivariateNormal prediction")
        return prediction
