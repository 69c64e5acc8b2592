"""Conformalised PLS (counterpart of
``projected_langevin_sampling_tpu/models/conformalise/pls.py``; reference
``conformalise/pls.py:9-62``): the raw bounds are quantiles of the particle
samples."""

from __future__ import annotations

import torch

from projected_langevin_sampling_torch.models.conformalise.base import ConformaliseBase, quantile
from projected_langevin_sampling_torch.models.pls import PLS
from projected_langevin_sampling_torch.utils.prng import GeneratorLike, as_generator


class ConformalisePLS(ConformaliseBase):
    """Every draw of samples takes fresh noise from one generator made from
    ``generator``, so a run is reproducible from it. ``predictive_noise`` and
    ``observation_noise`` inject the calibration draws' noise (the parity
    hook, as ``TemperPLS``'s); the predict methods take the same keywords
    for the draws on their ``x``."""

    def __init__(
        self,
        x_calibration: torch.Tensor,
        y_calibration: torch.Tensor,
        pls: PLS,
        particles: torch.Tensor,
        generator: GeneratorLike = None,
        predictive_noise: torch.Tensor | None = None,
        observation_noise: torch.Tensor | None = None,
    ):
        self.pls = pls
        self.particles = particles
        self._generator = as_generator(generator, device=particles.device)
        super().__init__(
            x_calibration,
            y_calibration,
            predictive_noise=predictive_noise,
            observation_noise=observation_noise,
        )

    def _samples(self, x, predictive_noise=None, observation_noise=None) -> torch.Tensor:
        return self.pls.predict_samples(
            particles=self.particles,
            x=x,
            predictive_noise=predictive_noise,
            observation_noise=observation_noise,
            generator=self._generator,
        )

    def _predict_uncalibrated_coverage(
        self, x: torch.Tensor, coverage: float, **noise
    ) -> tuple[torch.Tensor, torch.Tensor]:
        samples = self._samples(x, **noise)
        return (
            quantile(samples, 0.5 - coverage / 2.0, dim=1),
            quantile(samples, 0.5 + coverage / 2.0, dim=1),
        )

    def predict_median(self, x: torch.Tensor, **noise) -> torch.Tensor:
        return quantile(self._samples(x, **noise), 0.5, dim=1)
