"""Spread-tempered PLS classification predictive (counterpart of
``projected_langevin_sampling_tpu/models/temper/pls_classification.py``; the
reference's temper layer is regression-only).

The latent particle cloud is contracted or expanded about its mean,

    f_j(x)  ->  f_bar(x) + s (f_j(x) - f_bar(x)),        j = 1..J,

with ``s`` picked on a calibration split by grid search on the Bernoulli NLL
of the sample-averaged link probabilities. s = 1 is in the grid, so
tempering never loses on the calibration split; the latent mean is
untouched.
"""

from __future__ import annotations

import numpy as np
import torch

from projected_langevin_sampling_torch.models.pls import PLS
from projected_langevin_sampling_torch.utils.prng import GeneratorLike, as_generator

# a 0.05x .. 3x contraction/expansion grid, with s = 1 included exactly
DEFAULT_SCALE_GRID = tuple(
    float(s) for s in np.sort(np.append(np.geomspace(0.05, 3.0, 61), 1.0))
)


def _bernoulli_nll(probs: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    # the 1e-7 floor is representable in fp32 on both sides (1 - 1e-7 != 1)
    p = torch.clamp(probs, 1e-7, 1.0 - 1e-7)
    return -torch.mean(y * torch.log(p) + (1.0 - y) * torch.log1p(-p))


class TemperPLSClassification:
    """Validation-calibrated latent-spread temper for a trained PLS
    classifier (any link with a ``transform`` into probabilities).

    Every draw of latent samples takes fresh predictive noise from one
    generator made from ``generator``. ``predictive_noise`` injects the
    calibration draw's noise (the parity hook, as ``TemperPLS``'s);
    ``predict_probs`` takes the same keyword."""

    def __init__(
        self,
        x_calibration: torch.Tensor,
        y_calibration: torch.Tensor,
        pls: PLS,
        particles: torch.Tensor,
        generator: GeneratorLike = None,
        scale_grid: tuple[float, ...] = DEFAULT_SCALE_GRID,
        predictive_noise: torch.Tensor | None = None,
    ):
        self.pls = pls
        self.particles = particles
        self._generator = as_generator(generator, device=particles.device)
        self.scale_grid = scale_grid
        f_cal = self._latent_samples(x_calibration, predictive_noise)
        y_cal = torch.as_tensor(y_calibration, dtype=f_cal.dtype, device=f_cal.device)
        nlls = [float(_bernoulli_nll(self._tempered_probs(f_cal, s), y_cal)) for s in scale_grid]
        self.scale = float(scale_grid[int(np.argmin(nlls))])
        self.calibration_nll = float(min(nlls))

    def _latent_samples(self, x: torch.Tensor, predictive_noise=None) -> torch.Tensor:
        return self.pls.predict_untransformed_samples(
            particles=self.particles, x=x, noise=predictive_noise, generator=self._generator
        )

    def _tempered_probs(self, f_samples: torch.Tensor, s: float) -> torch.Tensor:
        f_bar = torch.mean(f_samples, dim=1, keepdim=True)
        f = f_bar + s * (f_samples - f_bar)
        return torch.mean(self.pls.cost.link_function.transform(f), dim=1)

    def predict_probs(self, x: torch.Tensor, predictive_noise=None) -> torch.Tensor:
        """Tempered class-1 probabilities, shape (N,)."""
        return self._tempered_probs(self._latent_samples(x, predictive_noise), self.scale)

    def __call__(self, x: torch.Tensor, predictive_noise=None) -> torch.Tensor:
        return self.predict_probs(x, predictive_noise)
